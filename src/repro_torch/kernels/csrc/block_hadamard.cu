// Online block-Hadamard rotation  y = x (I_n (x) H_b) / sqrt(b)  over the last
// axis of x [M, D], for an H100.
//
// Replaces the TPU kernel `repro/kernels/block_hadamard.py::block_hadamard`.
// Bound on the card: bytes (every element read once and written once; the
// rotation adds log2(b) adds per element). At the probe's sizes (0.1-1 MB)
// what remains is latency, so the design keeps every element in registers
// between its one load and its one store and spreads the rows over the grid:
//
//  * warp kernel (power-of-two b <= 32 * E): x is taken as one flat array of
//    M*D elements (rows are contiguous and b divides D, so no b-block crosses
//    a row). Each thread loads E contiguous elements with 16-byte vector
//    loads, runs the butterfly's first log2(E) stages in registers and the
//    next log2(b/E) with __shfl_xor_sync inside the warp - no shared memory,
//    no barrier - and stores the scaled result. The grid runs over (rows x
//    column chunks): x[4, 8192] f32 is 128 warps, not 4 blocks.
//  * block kernel (power-of-two b > 32 * E): one thread block owns one
//    b-block. Registers, then shuffles, then rounds through shared memory,
//    each round bringing log2(E) more index bits into the registers: one
//    barrier pair per round, not one barrier per stage.
//  * dense kernel (any other order, the Paley ones: 12, 20, ...): each thread
//    computes E neighbouring outputs of one b-block as b-wide dot products
//    against the dense operand `h` = H_b / sqrt(b) (read through L1), on the
//    same flat grid.
//
// Semantics kept from the reference: f32 arithmetic; 1/sqrt(b) applied once
// with __fmul_rn; bf16 output rounded to nearest even; b == 1 the identity;
// a NaN poisons exactly its own b-block (the adds mix nothing across blocks).
//
// The launch plan (kernel kind, E, threads per block, grid, shared memory)
// comes from `kernels/block_hadamard.py::hadamard_plan`; the C launch
// refuses a plan that does not match its own geometry (`plan_check.h`).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "plan_check.h"

namespace {

constexpr int KIND_WARP = plan::BH_WARP;
constexpr int KIND_DENSE = plan::BH_DENSE;

// ---- E contiguous elements <-> f32 registers (E * sizeof(T) bytes aligned)

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // .x = a (low), RNE both
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int E>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[E]) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = r.x; v[4 * i + 1] = r.y; v[4 * i + 2] = r.z; v[4 * i + 3] = r.w;
    }
  } else if constexpr (E == 2) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = r.x; v[1] = r.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int E>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p,
                                         float (&v)[E]) {
  if constexpr (E >= 8) {
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p) + i);
      unpack_bf16x2(r.x, v + 8 * i); unpack_bf16x2(r.y, v + 8 * i + 2);
      unpack_bf16x2(r.z, v + 8 * i + 4); unpack_bf16x2(r.w, v + 8 * i + 6);
    }
  } else if constexpr (E == 4) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    unpack_bf16x2(r.x, v); unpack_bf16x2(r.y, v + 2);
  } else if constexpr (E == 2) {
    unpack_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(p)), v);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int E>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float (&v)[E]) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int E>
__device__ __forceinline__ void store_vec(__nv_bfloat16* __restrict__ p,
                                          const float (&v)[E]) {
  if constexpr (E >= 8) {
#pragma unroll
    for (int i = 0; i < E / 8; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(
          pack_bf16x2(v[8 * i], v[8 * i + 1]), pack_bf16x2(v[8 * i + 2], v[8 * i + 3]),
          pack_bf16x2(v[8 * i + 4], v[8 * i + 5]), pack_bf16x2(v[8 * i + 6], v[8 * i + 7]));
  } else if constexpr (E == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  } else if constexpr (E == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v[0], v[1]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

template <typename T> __device__ __forceinline__ void store_one(T* p, float v);
template <> __device__ __forceinline__ void store_one<float>(float* p, float v) { *p = v; }
template <> __device__ __forceinline__ void store_one<__nv_bfloat16>(__nv_bfloat16* p,
                                                                    float v) {
  *p = __float2bfloat16_rn(v);
}

// Butterfly stages whose stride lies inside a thread's E registers: register
// j pairs with j ^ s; the one whose bit is clear keeps a + c, the other a - c
// (Sylvester order). `lo` skips the strides below it.
template <int E>
__device__ __forceinline__ void register_stages(float (&v)[E], int b, int lo = 1) {
#pragma unroll
  for (int s = 1; s < E; s <<= 1) {
    if (s < lo || s >= b) continue;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j & s) continue;
      const float a = v[j], c = v[j + s];
      v[j] = a + c;
      v[j + s] = a - c;
    }
  }
}

// Stages whose stride spans lanes of the warp: lane l pairs with l ^ s.
template <int E>
__device__ __forceinline__ void shuffle_stages(float (&v)[E], int lanes) {
  const int lane = threadIdx.x & 31;
  for (int s = 1; s < lanes; s <<= 1) {
    const bool upper = lane & s;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float p = __shfl_xor_sync(0xFFFFFFFFu, v[j], s);
      v[j] = upper ? p - v[j] : v[j] + p;
    }
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(256) bh_warp_kernel(const T* __restrict__ x,
                                                      T* __restrict__ y, long long chunks,
                                                      int b, float inv_sqrt_b) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < chunks;
  float v[E];
  if (live) {
    load_vec<E>(x + c * E, v);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = 0.0f;   // whole b-blocks of dead lanes
  }
  register_stages<E>(v, b);
  if (b > E) shuffle_stages<E>(v, b / E);
  if (!live) return;
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = __fmul_rn(v[j], inv_sqrt_b);
  store_vec<E>(y + c * E, v);
}

// Register j of thread t holds element idx(t, j) of its b-block: j's bits sit
// at bit position g of the index, t's bits around them.
__device__ __forceinline__ int spread(int t, int j, int g, int e) {
  return (t & ((1 << g) - 1)) | (j << g) | ((t >> g) << (g + e));
}

template <typename T, int E>
__global__ void __launch_bounds__(1024) bh_block_kernel(const T* __restrict__ x,
                                                        T* __restrict__ y, int b,
                                                        float inv_sqrt_b) {
  extern __shared__ float buf[];
  constexpr int e = (E == 8) ? 3 : (E == 16) ? 4 : 5;
  const int t = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * b;
  float v[E];
  load_vec<E>(x + base + (size_t)t * E, v);
  register_stages<E>(v, b);
  shuffle_stages<E>(v, 32);
  const int levels = 31 - __clz(b);
  int g = 0;               // registers hold index bits [g, g + e): t * E + j
  for (int lo = e + 5; lo < levels; lo += e) {
#pragma unroll
    for (int j = 0; j < E; ++j) buf[spread(t, j, g, e)] = v[j];
    __syncthreads();
    g = min(lo, levels - e);
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = buf[spread(t, j, g, e)];
    register_stages<E>(v, E, 1 << (lo - g));
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < E; ++j)
    store_one<T>(y + base + spread(t, j, g, e), __fmul_rn(v[j], inv_sqrt_b));
}

template <typename T, int E>
__global__ void __launch_bounds__(256) bh_dense_kernel(const T* __restrict__ x,
                                                       const float* __restrict__ h,
                                                       T* __restrict__ y, long long chunks,
                                                       int b) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const long long i0 = c * E;
  const long long blk = i0 / b;
  const int j0 = (int)(i0 - blk * b);
  const T* xb = x + blk * b;
  float acc[E];
#pragma unroll
  for (int j = 0; j < E; ++j) acc[j] = 0.0f;
  for (int k = 0; k < b; ++k) {
    float xk[1];
    load_vec<1>(xb + k, xk);
    float hk[E];
    load_vec<E>(h + (size_t)k * b + j0, hk);
#pragma unroll
    for (int j = 0; j < E; ++j) acc[j] = fmaf(xk[0], hk[j], acc[j]);
  }
  store_vec<E>(y + i0, acc);
}

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
cudaError_t raise_smem_limit(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int E>
cudaError_t launch_e(int kind, const void* x, const void* h, void* y, long long chunks,
                     int b, int threads, int grid, int smem, cudaStream_t st) {
  const float inv_sqrt_b = 1.0f / sqrtf((float)b);
  if (kind == KIND_WARP) {
    bh_warp_kernel<T, E><<<grid, threads, 0, st>>>((const T*)x, (T*)y, chunks, b,
                                                    inv_sqrt_b);
  } else if (kind == KIND_DENSE) {
    if constexpr (E <= 4)
      bh_dense_kernel<T, E><<<grid, threads, 0, st>>>((const T*)x, (const float*)h,
                                                       (T*)y, chunks, b);
    else
      return cudaErrorInvalidValue;
  } else {
    if constexpr (E >= 8) {
      auto kern = bh_block_kernel<T, E>;
      cudaError_t err = raise_smem_limit(kern, (size_t)smem);
      if (err != cudaSuccess) return err;
      kern<<<grid, threads, smem, st>>>((const T*)x, (T*)y, b, inv_sqrt_b);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int kind, int e, const void* x, const void* h, void* y, long long chunks,
                   int b, int threads, int grid, int smem, cudaStream_t st) {
  switch (e) {
    case 1: return launch_e<T, 1>(kind, x, h, y, chunks, b, threads, grid, smem, st);
    case 2: return launch_e<T, 2>(kind, x, h, y, chunks, b, threads, grid, smem, st);
    case 4: return launch_e<T, 4>(kind, x, h, y, chunks, b, threads, grid, smem, st);
    case 8: return launch_e<T, 8>(kind, x, h, y, chunks, b, threads, grid, smem, st);
    case 16: return launch_e<T, 16>(kind, x, h, y, chunks, b, threads, grid, smem, st);
    case 32: return launch_e<T, 32>(kind, x, h, y, chunks, b, threads, grid, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; y has x's dtype and shape; x and y are
// contiguous and 16-byte aligned. `h` is the dense [b, b] operand
// H_b / sqrt(b) for orders that are not a power of two, else null. The plan
// (kind, elems per thread, threads per block, grid, shared-memory bytes) is
// `hadamard_plan`'s; a plan that does not match returns cudaErrorInvalidValue.
extern "C" int block_hadamard_launch(const void* x, int x_dtype, const void* h, void* y,
                                     int m, int d, int b, int kind, int elems,
                                     int threads, int grid, int smem, void* stream) {
  if (m <= 0) return 0;
  if (!plan::hadamard_plan_ok(m, d, b, h != nullptr, kind, elems, threads, grid, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long chunks = (long long)m * d / elems;
  if (x_dtype == 0)
    return (int)launch<float>(kind, elems, x, h, y, chunks, b, threads, grid, smem, st);
  if (x_dtype == 1)
    return (int)launch<__nv_bfloat16>(kind, elems, x, h, y, chunks, b, threads, grid, smem,
                                      st);
  return (int)cudaErrorInvalidValue;
}
