// Fused block-Hadamard rotation + per-token asymmetric integer quantisation.
//
// One thread block owns one row of x [M, D]. The row is staged in shared
// memory as f32, rotated there by I (x) H_b / sqrt(b), reduced to its min and
// max, and written out as int8 codes plus one (scale, zero) pair. The rotated
// row never reaches device memory.
//
//   s     = max((max - min) * (1 / (2^bits - 1)), FLT_MIN)
//   z     = rint(min / s)
//   codes = clip(rint(y / s) - z, 0, 2^bits - 1)
//
// Rotation: a power-of-two b runs a log2(b)-stage add/sub butterfly in
// shared memory (Sylvester order) and scales by 1/sqrt(b); any other order
// multiplies each block by the dense operand `h` (already scaled) that the
// caller passes in. b == 1 skips the rotation.
//
// Rounding is half-to-even (rintf) and every quotient is a true IEEE
// division, as in the reference arithmetic. min/max propagate NaN so that a
// poisoned row stays visible downstream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// NaN-propagating min / max (fminf / fmaxf drop NaNs).
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__global__ void hadamard_quant_kernel(const T* __restrict__ x,
                                      const float* __restrict__ h,
                                      int8_t* __restrict__ codes,
                                      float* __restrict__ scale,
                                      float* __restrict__ zero,
                                      int d, int b, int levels,
                                      float inv_sqrt_b) {
  extern __shared__ float smem[];
  __shared__ float red_mn[32];
  __shared__ float red_mx[32];
  float* row = smem;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* xr = x + (size_t)r * d;

  for (int i = tid; i < d; i += nt) row[i] = to_f32<T>(xr[i]);
  __syncthreads();

  if (b > 1) {
    if (h == nullptr) {
      const int half = d >> 1;
      for (int stride = 1; stride < b; stride <<= 1) {
        for (int i = tid; i < half; i += nt) {
          const int j = ((i / stride) * (stride << 1)) + (i % stride);
          const float a = row[j];
          const float c = row[j + stride];
          row[j] = a + c;
          row[j + stride] = a - c;
        }
        __syncthreads();
      }
      for (int i = tid; i < d; i += nt) row[i] = __fmul_rn(row[i], inv_sqrt_b);
      __syncthreads();
    } else {
      float* tmp = smem + d;
      for (int i = tid; i < d; i += nt) {
        const int blk = i / b;
        const int j = i - blk * b;
        const float* xb = row + blk * b;
        float acc = 0.0f;
        for (int k = 0; k < b; ++k) acc = fmaf(xb[k], h[(size_t)k * b + j], acc);
        tmp[i] = acc;
      }
      __syncthreads();
      row = tmp;
    }
  }

  float mn = row[0];
  float mx = row[0];
  for (int i = tid; i < d; i += nt) {
    const float v = row[i];
    mn = nmin(mn, v);
    mx = nmax(mx, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    mn = nmin(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = nmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = (nt + 31) >> 5;
  if (lane == 0) {
    red_mn[warp] = mn;
    red_mx[warp] = mx;
  }
  __syncthreads();
  mn = red_mn[0];
  mx = red_mx[0];
  for (int w = 1; w < nwarps; ++w) {
    mn = nmin(mn, red_mn[w]);
    mx = nmax(mx, red_mx[w]);
  }

  const float lv = (float)levels;
  // range * (1 / levels): the reference's compiled form of the division by
  // the level count; the quotients below are true divisions
  const float s = nmax(__fmul_rn(__fsub_rn(mx, mn), __fdiv_rn(1.0f, lv)), FLT_MIN);
  const float z = rintf(__fdiv_rn(mn, s));
  if (tid == 0) {
    scale[r] = s;
    zero[r] = z;
  }
  int8_t* cr = codes + (size_t)r * d;
  for (int i = tid; i < d; i += nt) {
    float c = __fsub_rn(rintf(__fdiv_rn(row[i], s)), z);
    c = fminf(fmaxf(c, 0.0f), lv);
    cr[i] = (int8_t)(int)fminf(c, 127.0f);  // int8 storage saturates
  }
}

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
cudaError_t raise_smem_limit(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. `h` is the dense [b, b] operand
// H_b / sqrt(b) for orders that are not a power of two, else null.
extern "C" int hadamard_quant_launch(const void* x, int x_dtype, const void* h,
                                     void* codes, void* scale, void* zero,
                                     int m, int d, int b, int bits,
                                     void* stream) {
  if (m <= 0) return 0;
  int threads = 128;
  while (threads < 1024 && threads * 8 < d) threads <<= 1;
  const size_t smem = (size_t)d * sizeof(float) * (h != nullptr ? 2 : 1);
  const int levels = (1 << bits) - 1;
  const float inv = 1.0f / sqrtf((float)b);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (x_dtype == 0) {
    auto kern = hadamard_quant_kernel<float>;
    err = raise_smem_limit(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<m, threads, smem, st>>>((const float*)x, (const float*)h, (int8_t*)codes,
                                   (float*)scale, (float*)zero, d, b, levels, inv);
  } else if (x_dtype == 1) {
    auto kern = hadamard_quant_kernel<__nv_bfloat16>;
    err = raise_smem_limit(kern, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<m, threads, smem, st>>>((const __nv_bfloat16*)x, (const float*)h, (int8_t*)codes,
                                   (float*)scale, (float*)zero, d, b, levels, inv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
