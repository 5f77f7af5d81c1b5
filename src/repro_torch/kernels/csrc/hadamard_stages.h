// The block-Hadamard butterfly in registers, warp shuffles and shared
// memory, shared by block_hadamard.cu and hadamard_quant.cu so that both run
// the same f32 adds in the same (Sylvester) stage order: stride 1 first, each
// pair (a, c) becoming (a + c, a - c). Any split of the stages between
// registers, shuffles and shared-memory rounds gives the same bits.
//
// Included by the .cu files only (it needs CUDA's headers); the `.h` suffix
// puts it in `_build.py`'s source hash.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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


// Register j of thread t holds element idx(t, j) of its b-block: j's bits sit
// at bit position g of the index, t's bits around them.
__device__ __forceinline__ int spread(int t, int j, int g, int e) {
  return (t & ((1 << g) - 1)) | (j << g) | ((t >> g) << (g + e));
}

// The stages of a power-of-two b-block above one warp (b > 32 * E), after
// register_stages and shuffle_stages(v, 32): rounds through `buf` (the
// b-block's b floats of shared memory), each bringing log2(E) more index bits
// into the registers - one barrier pair per round. Thread t is the b-block's
// t-th of b / E threads, and every thread of the block must call it. Returns
// g: register j then holds element spread(t, j, g, log2(E)) of the b-block.
template <int E>
__device__ __forceinline__ int block_rounds(float (&v)[E], float* buf, int t, int b) {
  constexpr int e = (E == 8) ? 3 : (E == 16) ? 4 : 5;
  static_assert(E == 8 || E == 16 || E == 32, "block rounds take E = 8, 16 or 32");
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
  return g;
}

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
cudaError_t raise_smem_limit(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
