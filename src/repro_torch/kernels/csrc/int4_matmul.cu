// W4A4 integer GEMM with in-kernel nibble unpack, for an H100.
//
//   out[m, n] = (s_a[m] * s_w[n]) * (float(q_a[m, :] . q_w[:, n]) + z_a[m] * float(colsum[n]))
//
// q_a   int8 [M, K]    activation codes
// w     uint8 [K/2, N] two weight rows per byte: row 2k in the low nibble,
//                      row 2k+1 in the high nibble, each a signed int4
//
// Replaces the TPU kernel `repro/kernels/int4_matmul.py::int4_matmul`.
// Bound on the card: bytes at decode (the packed weight, half a byte per
// element, is read once and dwarfs everything else) and, at the serve path's
// 32-row prefill chunks, still bytes against the int8 tensor cores' rate.
//
// Unpack. Both the dp4a and the tensor-core product sum over K, so K may be
// taken in any order that is the same for both operands. The kernels take K
// in groups of 8 (4 packed rows): the 4 packed bytes of one column are
// gathered into one word by a byte transpose (__byte_perm), whose low nibbles
// are K 0,2,4,6 and high nibbles K 1,3,5,7; the activation codes are staged
// in the same even/odd order. A nibble n is the code w = n - 16 [n >= 8], and
// n ^ 8 = w + 8 lies in [0, 15], so one mask-and-xor per word gives offset
// codes that are valid s8 operands; the product is then
//     q_a . w = q_a . (w + 8) - 8 * rowsum(q_a),
// with rowsum taken over the same K, exact in int32.
//
// The kernel: int8 tensor cores, mma.sync m16n8k32 s8 x s8 -> s32. A block
// computes a 32- or 64-row by 128-column tile; cp.async copies the raw
// activation rows and packed weight rows of 128 K into a ring of 4 stages
// (weight rows XOR-swizzled in 16-byte chunks so that the fragment reads
// hit 32 distinct banks); each warp builds its A fragments from the even/odd
// bytes of the activation rows and its B fragments from the byte transpose
// above, for 4 n8 tiles whose columns are interleaved (tile j holds columns
// 4i + j), so that one 32-bit read per packed row feeds all four. One extra
// mma against ones gives the row sums. The C tile leaves through shared
// memory, row by row, so its stores and atomics are coalesced. The same
// kernel serves decode (M = 4: the tile's other rows are zero, and the
// tensor cores' spare rate costs nothing against the weight stream) and
// prefill; a streaming __dp4a GEMV for M <= 16 measured no faster at any
// serve-path shape (PERF.md).
//
// Split K. The kernel cuts K over grid.y, which decode needs to spread the
// weight stream over the SMs. The splits add their int32 sums into a
// workspace with atomicAdd (exact, in any order); the last split to finish
// a tile (a counter per tile) reads the sums back, zeroes the workspace,
// resets the counter and runs the epilogue. So one launch does the whole
// call, and the workspace and counters are zero again when it ends: the
// call can be captured in a CUDA graph and replayed. With one split the
// epilogue runs in place.
//
// The epilogue keeps the reference's operation order with explicit
// round-to-nearest multiplies and adds, so no FMA contraction changes a bit.
// Ragged M, N and K edges are masked, not padded. The C launch refuses a
// plan that does not match the kernel's geometry (`plan_check.h`).
#include <cuda_runtime.h>
#include <stdint.h>

#include "plan_check.h"

namespace {

using plan::MMA_A_PITCH;
using plan::MMA_B_STAGE;
using plan::MMA_COLS;
using plan::MMA_K_ROWS;
using plan::MMA_STAGES;

__device__ __forceinline__ float epilogue(int32_t acc, float sa, float za, float sw,
                                          int32_t cs) {
  return __fmul_rn(__fmul_rn(sa, sw),
                   __fadd_rn((float)acc, __fmul_rn(za, (float)cs)));
}

// Byte transpose: r[q] holds byte c of packed row q for columns c = 0..3;
// col[c] gets column c's bytes of rows 0..3.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2,
                                           uint32_t r3, uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

// One column's 4 packed bytes -> offset codes w + 8 of K 0,2,4,6 (even) and
// K 1,3,5,7 (odd) of its group.
__device__ __forceinline__ void unpack8(uint32_t u, uint32_t& even, uint32_t& odd) {
  even = (u & 0x0F0F0F0Fu) ^ 0x08080808u;
  odd = ((u >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// 8 activation codes K 0..7 (lo: 0-3, hi: 4-7) -> even and odd words
__device__ __forceinline__ uint32_t even_bytes(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x6420);
}
__device__ __forceinline__ uint32_t odd_bytes(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7531);
}

// The last of `splits` blocks to finish a tile: the splits' atomics are
// ordered before the counter's by the fence; the counter is reset for the
// next launch.
__device__ __forceinline__ bool last_arrival(int* __restrict__ cnt, int tile, int splits) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(cnt + tile, 1) == splits - 1;
    if (s_last) cnt[tile] = 0;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// The epilogue of a rows x cols tile from the workspace, zeroing it. Every
// split's atomics are ordered before these reads by last_arrival's fences,
// and no other block touches the tile any more, so the sums are read with
// plain L2 loads (ld.global.cg), four neighbouring columns at a time and `U`
// such reads issued before any is used (one round trip for a whole tile at
// the plans' sizes), and zeroed with plain stores.
__device__ __forceinline__ void finish_tile(int32_t* __restrict__ ws, const float* sa,
                                            const float* za, const float* sw,
                                            const int32_t* cs, float* __restrict__ out,
                                            int m, int n, int m0, int n0, int rows, int cols) {
  constexpr int U = 8;
  const bool vec = (n & 3) == 0;          // rows of ws start 16-byte aligned
  const int quads = rows * cols / 4;      // cols is a multiple of 4
  for (int q0 = threadIdx.x; q0 < quads; q0 += U * blockDim.x) {
    int4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = 4 * (q0 + u * blockDim.x);
      const int mm = m0 + e / cols, nn = n0 + e % cols;
      v[u] = make_int4(0, 0, 0, 0);
      if (e >= 4 * quads || mm >= m || nn >= n) continue;
      const int32_t* p = ws + (size_t)mm * n + nn;
      if (vec) {
        v[u] = __ldcg(reinterpret_cast<const int4*>(p));
      } else {
        v[u].x = __ldcg(p);
        if (nn + 1 < n) v[u].y = __ldcg(p + 1);
        if (nn + 2 < n) v[u].z = __ldcg(p + 2);
        if (nn + 3 < n) v[u].w = __ldcg(p + 3);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = 4 * (q0 + u * blockDim.x);
      const int mm = m0 + e / cols, nn = n0 + e % cols;
      if (e >= 4 * quads || mm >= m || nn >= n) continue;
      const size_t at = (size_t)mm * n + nn;
      const int32_t acc[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      if (vec) *reinterpret_cast<int4*>(ws + at) = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nn + j >= n) break;
        if (!vec) ws[at + j] = 0;
        out[at + j] = epilogue(acc[j], sa[mm], za[mm], sw[nn + j], cs[nn + j]);
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes into shared memory: `valid` of them from `src`, the rest zero. The
// aligned case (valid is 0 or 16) goes through cp.async; the ragged one is
// copied by the thread.
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src, int valid, bool vec,
                                       const void* safe) {
  if (vec) {
    cp_async16(dst, valid > 0 ? (const void*)src : safe, valid > 0 ? 16 : 0);
    return;
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < valid; ++j) v[j >> 2] |= (uint32_t)src[j] << (8 * (j & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk `ch` of packed row `r` in a weight stage
__device__ __forceinline__ int b_chunk(int r, int ch) {
  return r * MMA_COLS + ((ch ^ (((r >> 2) & 3) << 1)) << 4);
}

template <int BM>
__global__ void __launch_bounds__(4 * BM)
i4_mma_kernel(const int8_t* __restrict__ qa, const uint8_t* __restrict__ w,
              int32_t* __restrict__ ws, int* __restrict__ cnt,
              const float* __restrict__ sa, const float* __restrict__ za,
              const float* __restrict__ sw, const int32_t* __restrict__ cs,
              float* __restrict__ out, int m, int n, int k, int k_rows) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int NT = 4 * BM;
  constexpr int STAGES = MMA_STAGES;
  constexpr int STAGE = MMA_B_STAGE + BM * MMA_A_PITCH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp & 3, wm = warp >> 2;       // 32 columns, 32 rows per warp
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.z * BM, nt0 = blockIdx.x * MMA_COLS;
  const int k2 = k >> 1;
  const long long kr0 = (long long)blockIdx.y * k_rows;
  const int nrows = (int)min((long long)k_rows, k2 - kr0);
  const long long kend = 2 * (kr0 + nrows);      // end of this split, in K
  const int kt_n = (nrows + MMA_K_ROWS - 1) / MMA_K_ROWS;
  const bool vec = (n & 15) == 0 && (k & 15) == 0;

  auto load_stage = [&](int s, int kt) {
    uint8_t* bs = smem + s * STAGE;
    uint8_t* as = bs + MMA_B_STAGE;
    const long long rbase = kr0 + (long long)kt * MMA_K_ROWS;
    for (int e = tid; e < MMA_K_ROWS * 8; e += NT) {
      const int r = e >> 3, ch = e & 7;
      const long long row = rbase + r;
      const int col = nt0 + ch * 16;
      const int valid = (row < kr0 + nrows) ? max(0, min(16, n - col)) : 0;
      copy16(bs + b_chunk(r, ch), w + row * n + col, valid, vec, w);
    }
    for (int e = tid; e < BM * 8; e += NT) {
      const int r = e >> 3, ch = e & 7;
      const int mm = m0 + r;
      const long long kk = 2 * rbase + ch * 16;
      const int valid = mm < m ? (int)max(0LL, min(16LL, kend - kk)) : 0;
      copy16(as + r * MMA_A_PITCH + ch * 16, (const uint8_t*)qa + (size_t)mm * k + kk,
             valid, vec, qa);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load_stage(s, s);
    cp_async_commit();
  }
  int32_t acc[2][4][4];
  int32_t rs[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      rs[mt][v] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][j][v] = 0;
    }

  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < kt_n) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const uint8_t* bs = smem + (kt % STAGES) * STAGE;
    const uint8_t* as = bs + MMA_B_STAGE;
#pragma unroll
    for (int ks = 0; ks < MMA_K_ROWS / 16; ++ks) {
      const int grp = ks * 4 + t;               // this thread's group of 8 K
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        const uint2 lo = *reinterpret_cast<const uint2*>(as + r * MMA_A_PITCH + 8 * grp);
        const uint2 hi =
            *reinterpret_cast<const uint2*>(as + (r + 8) * MMA_A_PITCH + 8 * grp);
        a[mt][0] = even_bytes(lo.x, lo.y);
        a[mt][1] = even_bytes(hi.x, hi.y);
        a[mt][2] = odd_bytes(lo.x, lo.y);
        a[mt][3] = odd_bytes(hi.x, hi.y);
      }
      uint32_t rw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rw[q] = *reinterpret_cast<const uint32_t*>(
            bs + b_chunk(4 * grp + q, 2 * wn + (g >> 2)) + 4 * (g & 3));
      uint32_t col[4];
      transpose4(rw[0], rw[1], rw[2], rw[3], col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ev, od;
        unpack8(col[j], ev, od);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][j], a[mt], ev, od);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(rs[mt], a[mt], 0x01010101u, 0x01010101u);
    }
  }
  // The C fragments (rows g, g + 8; interleaved columns) go through shared
  // memory, reusing the stage ring, so that the output or the split's
  // atomics leave the block row by row, coalesced. Row pitch 129 words:
  // a fragment store's 8 rows x 4 column pairs hit 32 distinct banks.
  constexpr int C_PITCH = MMA_COLS + 1;
  static_assert(BM * C_PITCH * 4 <= STAGES * STAGE, "C tile exceeds the stage ring");
  cp_async_wait<0>();
  __syncthreads();
  int32_t* ct = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ct[(wm * 32 + mt * 16 + g + 8 * h) * C_PITCH + wn * 32 + 4 * (2 * t + i) + j] =
              acc[mt][j][2 * h + i] - 8 * rs[mt][2 * h];
  __syncthreads();

  const bool single = gridDim.y == 1;
  for (int e = tid; e < BM * MMA_COLS; e += NT) {
    const int r = e / MMA_COLS, c = e % MMA_COLS;
    const int mm = m0 + r, nn = nt0 + c;
    if (mm >= m || nn >= n) continue;
    const int32_t v = ct[r * C_PITCH + c];
    if (single)
      out[(size_t)mm * n + nn] = epilogue(v, sa[mm], za[mm], sw[nn], cs[nn]);
    else
      atomicAdd(ws + (size_t)mm * n + nn, v);
  }
  if (single) return;
  if (last_arrival(cnt, blockIdx.z * gridDim.x + blockIdx.x, gridDim.y))
    finish_tile(ws, sa, za, sw, cs, out, m, n, m0, nt0, BM, MMA_COLS);
}

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
cudaError_t launch_kernel(K kern, dim3 grid, int threads, size_t smem, cudaStream_t st,
                          const void* qa, const void* w, void* ws, void* cnt, const void* sa,
                          const void* za, const void* sw, const void* cs, void* out, int m,
                          int n, int k, int k_rows) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, threads, smem, st>>>((const int8_t*)qa, (const uint8_t*)w, (int32_t*)ws,
                                    (int*)cnt, (const float*)sa, (const float*)za,
                                    (const float*)sw, (const int32_t*)cs, (float*)out, m, n,
                                    k, k_rows);
  return cudaGetLastError();
}

}  // namespace

// The plan (rows, k_rows, splits, threads, grid, smem) is
// `int4_plan`'s; a plan that does not match returns cudaErrorInvalidValue.
// `ws` is int32 [M, N] and `cnt` int32 [grid_x * grid_z], both zero on entry
// and left zero; they may be null when splits == 1. q_a and w are 16-byte
// aligned.
extern "C" int int4_matmul_launch(const void* qa, const void* w, void* ws, void* cnt,
                                  const void* sa, const void* za, const void* sw,
                                  const void* colsum, void* out, int m, int n, int k,
                                  int rows, int k_rows, int splits, int threads, int gx,
                                  int gy, int gz, int smem, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (!plan::int4_plan_ok(m, n, k, rows, k_rows, splits, threads, gx, gy, gz, smem,
                          ws != nullptr && cnt != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(gx, gy, gz);
#define ARGS grid, threads, (size_t)smem, st, qa, w, ws, cnt, sa, za, sw, colsum, out, m, n, k, k_rows
  if (rows == 32) return (int)launch_kernel(i4_mma_kernel<32>, ARGS);
  return (int)launch_kernel(i4_mma_kernel<64>, ARGS);
#undef ARGS
}
