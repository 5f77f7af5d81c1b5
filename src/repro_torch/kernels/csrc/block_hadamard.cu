// Online block-Hadamard rotation  y = x (I_n (x) H_b) / sqrt(b)  over the last
// axis of x [M, D].
//
// One thread block owns one row. The row is staged once in shared memory as
// f32, rotated there, and written once in x's dtype (f32, or bf16 rounded to
// nearest even), so every element crosses device memory exactly twice.
//
// Rotation, as in hadamard_quant.cu: a power-of-two b runs a log2(b)-stage
// add/sub butterfly in shared memory (Sylvester order) and scales by
// 1/sqrt(b) on the way out; any other order (the Paley orders, e.g. 12)
// multiplies each block by the dense operand `h` = H_b / sqrt(b) that the
// caller passes in, each thread writing its dot products straight out.
// b == 1 is the identity. Any b that divides D works, up to b == D. The adds
// propagate NaN, so a poisoned row comes out poisoned.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void block_hadamard_kernel(const T* __restrict__ x,
                                      const float* __restrict__ h,
                                      T* __restrict__ y,
                                      int d, int b, float inv_sqrt_b) {
  extern __shared__ float row[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* xr = x + (size_t)blockIdx.x * d;
  T* yr = y + (size_t)blockIdx.x * d;

  for (int i = tid; i < d; i += nt) row[i] = to_f32<T>(xr[i]);
  __syncthreads();

  if (h != nullptr) {
    for (int i = tid; i < d; i += nt) {
      const int blk = i / b;
      const int j = i - blk * b;
      const float* xb = row + blk * b;
      float acc = 0.0f;
      for (int k = 0; k < b; ++k) acc = fmaf(xb[k], h[(size_t)k * b + j], acc);
      yr[i] = from_f32<T>(acc);
    }
    return;
  }
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
  for (int i = tid; i < d; i += nt) yr[i] = from_f32<T>(__fmul_rn(row[i], inv_sqrt_b));
}

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
cudaError_t raise_smem_limit(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch(const void* x, const void* h, void* y, int m, int d, int b,
                   cudaStream_t st) {
  int threads = 128;
  while (threads < 1024 && threads * 8 < d) threads <<= 1;
  const size_t smem = (size_t)d * sizeof(float);
  auto kern = block_hadamard_kernel<T>;
  cudaError_t err = raise_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<m, threads, smem, st>>>((const T*)x, (const float*)h, (T*)y, d, b,
                                 1.0f / sqrtf((float)b));
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; y has x's dtype and shape. `h` is the
// dense [b, b] operand H_b / sqrt(b) for orders that are not a power of two,
// else null.
extern "C" int block_hadamard_launch(const void* x, int x_dtype, const void* h,
                                     void* y, int m, int d, int b, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0) return (int)launch<float>(x, h, y, m, d, b, st);
  if (x_dtype == 1) return (int)launch<__nv_bfloat16>(x, h, y, m, d, b, st);
  return (int)cudaErrorInvalidValue;
}
