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

#include "hadamard_stages.h"
#include "plan_check.h"

namespace {

constexpr int KIND_WARP = plan::BH_WARP;
constexpr int KIND_DENSE = plan::BH_DENSE;

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
  const int g = block_rounds<E>(v, buf, t, b);
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
