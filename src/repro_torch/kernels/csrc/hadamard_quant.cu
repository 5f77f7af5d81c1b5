// Fused block-Hadamard rotation + per-token asymmetric integer quantisation,
// for an H100.
//
// Replaces the TPU kernel `repro/kernels/hadamard_quant.py::hadamard_quant`
// (body `_kernel`); at b = 1 it is also `ops.quantize_act`. Per row of
// x [M, D]:
//
//   y     = x (I (x) H_b) / sqrt(b)
//   s     = max((max(y) - min(y)) * f32(1 / (2^bits - 1)), FLT_MIN)
//   z     = rint(min(y) / s)
//   codes = clip(rint(y / s) - z, 0, 2^bits - 1)      (int8, saturating at 127)
//
// Bound on the card: bytes (D activations read, D one-byte codes and two
// floats written per row; the rotation adds log2(b) adds per element). At
// the serve path's sizes (4-32 rows) what remains is latency, so the design
// keeps every element in registers from its one load to its one code store
// and spreads each row over several SMs:
//
//  * A row is cut into `c` slices of whole b-blocks and whole E-chunks
//    (c in 1, 2, 4, 8), one thread block each; the c blocks of a row are one
//    thread-block cluster, so x[4, 8192] is 32 blocks, not 4. Each thread
//    loads E contiguous elements with 16-byte vector loads.
//  * The rotation is `hadamard_stages.h`'s butterfly, the one block_hadamard.cu
//    runs: registers, then warp shuffles (power-of-two b <= 32 * E, no shared
//    memory, no barrier), then rounds through shared memory for a larger b
//    (whose b-blocks then lie in one slice); the Paley orders (12, 20, ...)
//    take E outputs a thread as dot products against the dense operand `h` =
//    H_b / sqrt(b).
//  * The row's min / max: each thread's registers, then a __shfl_xor_sync
//    tree per warp; lane 0 of every warp pushes its (min, max) into every
//    block of the cluster with st.async onto that block's mbarrier, which
//    completes when all c * warps partials have landed. The only cluster
//    barrier is the one that makes sure every block has started (arrived at
//    the top, waited on just before the first remote store), so it hides
//    behind the load and the butterfly; no block reads another's shared
//    memory, so none waits for the others before it exits. Every block then
//    merges the same partials - min and max are exact in any order - and
//    computes the same s and z. (Reading the partials through
//    cluster.map_shared_rank between two cluster.sync()s cost ~1 us more on
//    an H100.) One slice a row is a plain launch with __syncthreads.
//  * Codes come from the registers and leave as one E-byte store per thread;
//    rank 0 writes s and z. The rotated row never reaches device memory.
//
// Arithmetic kept from the reference (and the earlier kernel): f32 throughout;
// 1/sqrt(b) applied once with __fmul_rn; the range times the f32 reciprocal
// of the level count (the reference's compiled form); true IEEE divisions
// y / s and min / s; rintf (half to even); NaN-propagating min / max, so a
// poisoned row has a NaN scale (and only that row: a cluster is one row).
//
// The launch plan (kind, E, threads, cluster size, grid, shared memory) comes
// from `kernels/hadamard_quant.py::hadamard_quant_plan`; the C launch refuses
// a plan that does not match its own geometry (`plan_check.h`).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hadamard_stages.h"
#include "plan_check.h"

namespace cg = cooperative_groups;

namespace {

constexpr int KIND_WARP = plan::BH_WARP;
constexpr int KIND_BLOCK = plan::BH_BLOCK;
constexpr int KIND_DENSE = plan::BH_DENSE;

// NaN-propagating min / max (fminf / fmaxf drop NaNs).
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// clip(rint(y / s) - z, 0, levels) as an int8 code (saturating at 127).
__device__ __forceinline__ uint32_t code_of(float y, float s, float z, float lv) {
  float c = __fsub_rn(rintf(__fdiv_rn(y, s)), z);
  c = fminf(fmaxf(c, 0.0f), lv);
  return (uint32_t)(int)fminf(c, 127.0f);
}

// The codes of E contiguous elements as one E-byte store (E-byte aligned).
template <int E>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ p, const float (&v)[E],
                                            float s, float z, float lv) {
  if constexpr (E >= 4) {
    uint32_t w[E / 4];
#pragma unroll
    for (int i = 0; i < E / 4; ++i)
      w[i] = code_of(v[4 * i], s, z, lv) | code_of(v[4 * i + 1], s, z, lv) << 8 |
             code_of(v[4 * i + 2], s, z, lv) << 16 | code_of(v[4 * i + 3], s, z, lv) << 24;
    if constexpr (E >= 16) {
#pragma unroll
      for (int i = 0; i < E / 16; ++i)
        reinterpret_cast<uint4*>(p)[i] =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    } else if constexpr (E == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  } else if constexpr (E == 2) {
    *reinterpret_cast<uint16_t*>(p) =
        (uint16_t)(code_of(v[0], s, z, lv) | code_of(v[1], s, z, lv) << 8);
  } else {
    *p = (int8_t)code_of(v[0], s, z, lv);
  }
}

// Shared-memory addresses and the cluster's mbarrier / st.async, in PTX.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The same shared-memory address in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

template <typename T, int E, int KIND, bool CLUSTER>
__global__ void __launch_bounds__(1024) hq_cluster_kernel(
    const T* __restrict__ x, const float* __restrict__ h, int8_t* __restrict__ codes,
    float* __restrict__ scale, float* __restrict__ zero, int d, int b, int unit,
    float lv, float inv_sqrt_b) {
  extern __shared__ float buf[];       // the shared-memory kind: the slice in f32
  // (min, max) of every warp of the row's blocks, rank-major; a cluster's
  // blocks each write theirs into every block's copy
  __shared__ float2 part[plan::HQ_MAX_CLUSTER * 32];
  __shared__ __align__(8) uint64_t landed;   // completes when all of them are in
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int nw = blockDim.x >> 5;
  int c = 1, rank = 0;
  if constexpr (CLUSTER) {
    c = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
    if (t == 0) {
      const uint32_t bar = smem_addr(&landed);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(8 * c * nw) : "memory");
    }
    // every block of the cluster has started and set up `landed` once all
    // have arrived; the wait is just before the first remote store
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  }
  const int row = blockIdx.x / c;
  // balanced slices of whole units: the first (units % c) hold one more
  const int units = d / unit;
  const int q = units / c, extra = units % c;
  const int start = (rank * q + min(rank, extra)) * unit;
  const int len = (q + (rank < extra ? 1 : 0)) * unit;
  const bool live = t * E < len;
  const size_t row0 = (size_t)row * d;
  const size_t off = row0 + start + (size_t)t * E;

  float v[E];
  int g = 0;
  if constexpr (KIND == KIND_DENSE) {
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = 0.0f;
    if (live) {
      const int i0 = start + t * E;
      const int blk = i0 / b;
      const int j0 = i0 - blk * b;
      const T* xb = x + row0 + (size_t)blk * b;
      for (int k = 0; k < b; ++k) {
        float xk[1];
        load_vec<1>(xb + k, xk);
        float hk[E];
        load_vec<E>(h + (size_t)k * b + j0, hk);
#pragma unroll
        for (int j = 0; j < E; ++j) v[j] = fmaf(xk[0], hk[j], v[j]);
      }
    }
  } else {
    if (live) {
      load_vec<E>(x + off, v);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = 0.0f;   // whole b-blocks of dead lanes
    }
    if (b > 1) {
      register_stages<E>(v, b);
      if constexpr (KIND == KIND_BLOCK) {
        shuffle_stages<E>(v, 32);
        // thread t is thread t % (b / E) of the slice's b-block t / (b / E)
        const int per = b / E;
        g = block_rounds<E>(v, buf + (t / per) * b, t % per, b);
      } else if (b > E) {
        shuffle_stages<E>(v, b / E);
      }
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = __fmul_rn(v[j], inv_sqrt_b);
    }
  }

  // each warp's min / max: registers, then a shuffle tree
  float mn = INFINITY, mx = -INFINITY;
  if (live) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      mn = nmin(mn, v[j]);
      mx = nmax(mx, v[j]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = nmin(mn, __shfl_xor_sync(0xFFFFFFFFu, mn, o));
    mx = nmax(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  }
  // every warp's partial to every block of the row
  const int n = c * nw;
  if constexpr (CLUSTER) {
    asm volatile("barrier.cluster.wait;" ::: "memory");
    if (lane == 0) {
      const uint32_t slot = smem_addr(&part[rank * nw + (t >> 5)]);
      const uint32_t bar = smem_addr(&landed);
      for (int r = 0; r < c; ++r)
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
            :: "r"(cluster_addr(slot, r)), "f"(mn), "f"(mx), "r"(cluster_addr(bar, r))
            : "memory");
    }
    asm volatile(
        "{\n\t.reg .pred done;\n\tWAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n\t"
        "@!done bra WAIT;\n\t}" :: "r"(smem_addr(&landed)) : "memory");
  } else {
    if (lane == 0) part[t >> 5] = make_float2(mn, mx);
    __syncthreads();
  }
  // the row's: lane l reads the partials at l mod p (p, the power of two
  // >= n up to 32, so each aligned group of p lanes holds all n) and
  // shuffles within p lanes; min and max are exact in any order
  int p = 1;
  while (p < n && p < 32) p <<= 1;
  mn = INFINITY;
  mx = -INFINITY;
  for (int i = lane & (p - 1); i < n; i += p) {
    const float2 w = part[i];
    mn = nmin(mn, w.x);
    mx = nmax(mx, w.y);
  }
  for (int o = 1; o < p; o <<= 1) {
    mn = nmin(mn, __shfl_xor_sync(0xFFFFFFFFu, mn, o));
    mx = nmax(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  }

  const float s = nmax(__fmul_rn(__fsub_rn(mx, mn), __fdiv_rn(1.0f, lv)), FLT_MIN);
  const float z = rintf(__fdiv_rn(mn, s));
  if (rank == 0 && t == 0) {
    scale[row] = s;
    zero[row] = z;
  }
  if (live) {
    if constexpr (KIND == KIND_BLOCK) {
      constexpr int e = (E == 8) ? 3 : (E == 16) ? 4 : 5;
      const int per = b / E;
      int8_t* cb = codes + row0 + start + (size_t)(t / per) * b;
#pragma unroll
      for (int j = 0; j < E; ++j)
        cb[spread(t % per, j, g, e)] = (int8_t)code_of(v[j], s, z, lv);
    } else {
      store_codes<E>(codes + off, v, s, z, lv);
    }
  }
}

// A cluster of c > 1 slices goes through cudaLaunchKernelEx with the
// cluster dimension; one slice a row is a plain launch.
template <typename T, int E, int KIND>
cudaError_t launch_one(const void* x, const void* h, void* codes, void* scale, void* zero,
                       int d, int b, int unit, float lv, float inv_sqrt_b, int threads,
                       int cluster, int grid, int smem, cudaStream_t st) {
  if (cluster == 1) {
    auto kern = hq_cluster_kernel<T, E, KIND, false>;
    cudaError_t err = raise_smem_limit(kern, (size_t)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, threads, smem, st>>>((const T*)x, (const float*)h, (int8_t*)codes,
                                      (float*)scale, (float*)zero, d, b, unit, lv,
                                      inv_sqrt_b);
    return cudaGetLastError();
  }
  auto kern = hq_cluster_kernel<T, E, KIND, true>;
  cudaError_t err = raise_smem_limit(kern, (size_t)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, (const T*)x, (const float*)h, (int8_t*)codes,
                           (float*)scale, (float*)zero, d, b, unit, lv, inv_sqrt_b);
  const cudaError_t last = cudaGetLastError();   // clear it either way
  return err != cudaSuccess ? err : last;
}

#define HQ_ARGS x, h, codes, scale, zero, d, b, unit, lv, inv, threads, cluster, grid, smem, st

template <typename T>
cudaError_t launch(int kind, int e, const void* x, const void* h, void* codes, void* scale,
                   void* zero, int d, int b, int unit, float lv, float inv, int threads,
                   int cluster, int grid, int smem, cudaStream_t st) {
  if (kind == KIND_WARP) {
    switch (e) {
      case 1: return launch_one<T, 1, KIND_WARP>(HQ_ARGS);
      case 2: return launch_one<T, 2, KIND_WARP>(HQ_ARGS);
      case 4: return launch_one<T, 4, KIND_WARP>(HQ_ARGS);
      case 8: return launch_one<T, 8, KIND_WARP>(HQ_ARGS);
      case 16: return launch_one<T, 16, KIND_WARP>(HQ_ARGS);
      case 32: return launch_one<T, 32, KIND_WARP>(HQ_ARGS);
    }
  } else if (kind == KIND_BLOCK) {
    switch (e) {
      case 8: return launch_one<T, 8, KIND_BLOCK>(HQ_ARGS);
      case 16: return launch_one<T, 16, KIND_BLOCK>(HQ_ARGS);
      case 32: return launch_one<T, 32, KIND_BLOCK>(HQ_ARGS);
    }
  } else if (kind == KIND_DENSE) {
    switch (e) {
      case 1: return launch_one<T, 1, KIND_DENSE>(HQ_ARGS);
      case 2: return launch_one<T, 2, KIND_DENSE>(HQ_ARGS);
      case 4: return launch_one<T, 4, KIND_DENSE>(HQ_ARGS);
    }
  }
  return cudaErrorInvalidValue;
}

#undef HQ_ARGS

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; x [m, d] contiguous and 16-byte
// aligned; codes int8 [m, d], scale and zero f32 [m]. `h` is the dense
// [b, b] operand H_b / sqrt(b) for orders that are not a power of two, else
// null. The plan (kind, elems per thread, threads per block, cluster size,
// grid, dynamic shared-memory bytes) is `hadamard_quant_plan`'s; a plan that
// does not match returns cudaErrorInvalidValue.
extern "C" int hadamard_quant_launch(const void* x, int x_dtype, const void* h,
                                     void* codes, void* scale, void* zero,
                                     int m, int d, int b, int bits, int kind, int elems,
                                     int threads, int cluster, int grid, int smem,
                                     void* stream) {
  if (m <= 0) return 0;
  if (bits < 1 || bits > 8 ||
      !plan::hadamard_quant_plan_ok(m, d, b, h != nullptr, kind, elems, threads, cluster,
                                    grid, smem))
    return (int)cudaErrorInvalidValue;
  const int unit = (int)plan::hq_unit(b, elems, kind);
  const float lv = (float)((1 << bits) - 1);
  const float inv = 1.0f / sqrtf((float)b);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0)
    return (int)launch<float>(kind, elems, x, h, codes, scale, zero, d, b, unit, lv, inv,
                              threads, cluster, grid, smem, st);
  if (x_dtype == 1)
    return (int)launch<__nv_bfloat16>(kind, elems, x, h, codes, scale, zero, d, b, unit,
                                      lv, inv, threads, cluster, grid, smem, st);
  return (int)cudaErrorInvalidValue;
}
