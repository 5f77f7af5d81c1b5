// Block-table-native causal GQA attention over one layer's KV page pool,
// with the log-sum-exp merge of split partials folded into the same launch.
//
// Replaces src/repro/kernels/paged_attention.py::paged_attention (body
// `_kernel`, with `dequant_page`, `rope_page`, `page_update`, `finalize`)
// and ::_combine_kernel (arithmetic `combine_partials`).
//
// Bound on an H100: bytes. Each live K/V page row is read once per query
// group; at decode the queries and outputs are a few kilobytes beside them,
// and at a 32-token prefill chunk the products are still far below the
// tensor cores' rate. So the design keeps the walk's latency short: few
// round trips to device memory, few barriers, all threads busy.
//
// Grid: (query block * splits + split, KV head, batch row). A block owns
// `q_rows` query positions of the G heads that share one KV head; block row
// r is (head kh * G + r / q_rows, query qb * q_rows + r % q_rows). Rows past
// the group (or past S) are padding: fully masked, never written. The launch
// plan - query rows per block, row warps, pages per tile, shared-memory
// bytes - comes from `kernels/paged_attention.py::attention_plan`, and the
// entry point below checks it against its own layout.
//
// Per split the block walks its live table columns in tiles of several pages
// (64 keys at decode, so at T = 16 a decode split is one tile; 128 at
// prefill):
//   1. Copy. The K and V rows of a tile (stored type: f32, bf16 or int8
//      codes) and, for integer pages, their f32 scale/zero rows are staged by
//      `cp.async` (16 bytes where rows and pointers allow) into a ring of two
//      raw tiles; the copy of tile i+1 is issued before tile i is computed.
//      Page ids are read from the block table by the issuing threads; columns
//      at or past `used = ceil(len / T)` are never read.
//   2. Convert. One pass turns the raw tile into f32 K and V tiles: integer
//      pages are dequantised as scale * (code + offset + zero) and K rotated
//      (RoPE, half-split layout) at the absolute position of each key; float
//      pages are widened. Keys of the tile past the live columns are zero.
//      Two block-wide barriers per tile: after the copy wait (the raw tile is
//      in, and every warp is done with the previous f32 tile) and after this
//      pass.
//   3. Products. A warp owns 16 block rows and, of each tile, every
//      key_warps-th 8-key n-tile, so all warps of the block compute (a decode
//      block has 4 rows and 4 warps, each taking 16 of the tile's 64 keys).
//      S = Q K^T and O += P V run on the tensor cores as mma.sync m16n8k8
//      TF32 in the 3xTF32 split (x = hi + lo, a b ~ a_hi b_hi + a_hi b_lo +
//      a_lo b_hi, f32 accumulators), which keeps f32 accuracy; a bf16
//      operand is exact in TF32 and skips its lo term. wgmma is not used: a
//      block has 1-32 query rows per KV head under the default plan (G at
//      decode), below wgmma's 64-row warpgroup tile, and TF32 wgmma wants
//      swizzled K-major shared layouts - the products are far below the
//      tensor cores' rate either way.
//   4. Softmax on the fragments, per chunk of up to 8 of a warp's n-tiles:
//      causal mask (masked live keys -1e30 as in the reference walk, keys
//      past the live columns -inf so they never count), row max and sum over
//      the quad by __shfl_xor_sync, O rescaled in registers, P written to a
//      per-warp scratch and reloaded in the A layout for P V.
//   5. After the walk the key warps of a row group merge their (m, l, O) by
//      log-sum-exp through shared memory, once per block.
// With one split the block writes acc / max(l, 1e-30). With more it writes
// its (m, l, acc) partial rows, then arrives at an int32 counter of its tile
// (batch row, KV head, query block); the last split of the tile to arrive
// merges the tile (`merge_tile`) and resets the counter, so one launch does
// the whole call and the counters are zero again when it ends: the call can
// be captured in a CUDA graph and replayed. The merge reads the partials in
// split order 0..KS-1 whatever the arrival order, so its output does not
// depend on scheduling. A split with no live column writes m = -inf, l = 0,
// acc = 0 (and arrives like any other); a row of length 0 comes out as zeros.
//
// Against the plain walk (one online-softmax step per page, einsum products)
// the softmax here updates per chunk of up to 64 keys of one warp, merges
// the warps' states at the end and sums in another order; both are f32 with
// full-precision expf / sincosf, and the results agree within 2e-5 absolute.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "plan_check.h"

namespace {

constexpr float MASK_VALUE = -1e30f;
constexpr int CHUNK_KEYS = 64;     // keys per softmax update (S registers)
constexpr int MAX_THREADS = 256;   // 8 warps: up to 128 rows per block
constexpr size_t SMEM_LIMIT = 232448;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) { return (float)v; }

// ---- TF32 tensor-core products -------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with both parts TF32 values (lo is 0 when x is a TF32 value)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in the 3xTF32 split; an operand known to be a TF32 value (bf16
// data) has lo = 0 and its cross term is skipped
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  if (!A_EXACT) mma_tf32(d, al, bh0, bh1);
  if (!B_EXACT) mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// A fragment of m16n8k8 (row major, `stride` floats per row) at column k0:
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
__device__ __forceinline__ void load_a(const float* base, int stride, int k0, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* p = base + g * stride + k0 + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * stride], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * stride + 4], hi[3], lo[3]);
}

// ---- asynchronous copies ---------------------------------------------------

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- shared-memory layout (mirrored by attention_plan in Python) ----------

__host__ __device__ __forceinline__ size_t al16(size_t x) { return (x + 15) & ~(size_t)15; }

struct Layout {
  int keys;      // keys per tile = pages per tile * T
  int kpad;      // keys rounded up to 8
  int ks;        // row stride (floats) of the f32 K tile and of Q: dh + 4
  int vs;        // row stride of the f32 V tile: conflict-free B fragments
  int ps;        // row stride of a warp's P scratch
  int rows_pad;  // row warps * 16
  int cwarps;    // computing warps: row warps * key warps
  size_t raw_kv, raw_aux, stage;
  size_t off_kf, off_vf, off_q, off_p, off_freq, off_qpos, off_used, total;
};

__host__ __device__ __forceinline__ Layout make_layout(int dh, int t, int ppt, int warps,
                                                       int key_warps, int esize, int ng) {
  Layout L;
  L.keys = ppt * t;
  L.kpad = (L.keys + 7) & ~7;
  L.ks = dh + 4;
  L.vs = dh + (((dh / 8) % 2 == 0) ? 8 : 0);
  L.ps = (L.kpad < CHUNK_KEYS ? L.kpad : CHUNK_KEYS) + 4;
  L.rows_pad = warps * 16;
  L.cwarps = warps * key_warps;
  L.raw_kv = al16((size_t)L.keys * dh * esize);
  L.raw_aux = al16((size_t)L.keys * ng * 4);
  L.stage = 2 * L.raw_kv + 4 * L.raw_aux;
  L.off_kf = 2 * L.stage;
  L.off_vf = L.off_kf + al16((size_t)L.kpad * L.ks * 4);
  const size_t tiles_end = L.off_vf + al16((size_t)L.kpad * L.vs * 4);
  // after the walk the key warps' (m, l, O) rows are merged through [0, ..)
  const size_t merge = al16((size_t)L.cwarps * 16 * L.ks * 4);
  L.off_q = tiles_end > merge ? tiles_end : merge;
  L.off_p = L.off_q + al16((size_t)L.rows_pad * L.ks * 4);
  L.off_freq = L.off_p + al16((size_t)L.cwarps * 16 * L.ps * 4);
  L.off_qpos = L.off_freq + al16((size_t)(dh / 2) * 4);
  L.off_used = L.off_qpos + al16((size_t)L.rows_pad * 4);
  L.total = L.off_used + 16;  // used columns, merge flag; all of the shared memory
  return L;
}

// (r, c) = divmod(e, width) for e = start, start + stride, ... without a
// division per step
struct Walk2 {
  int r, c, dr, dc, width;
  __device__ __forceinline__ Walk2(int start, int stride, int w) : width(w) {
    r = start / w;
    c = start - r * w;
    dr = stride / w;
    dc = stride - dr * w;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    r += dr;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
};

struct PagedArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* k_zero;
  const float* v_scale;
  const float* v_zero;
  const float* freqs;      // [Dh / 2] or null (no in-walk rotation)
  const int32_t* bt;       // [B, n_cols]
  const int32_t* qpos;     // [B, S]
  const int32_t* seqlens;  // [B] or null
  float* out;              // [B, S, H, Dh]
  float* m_p;              // [B, splits, H, S]
  float* l_p;              // [B, splits, H, S]
  float* acc_p;            // [B, splits, H, S, Dh]
  int* counters;           // [B * KH * query blocks] or more, zero on entry
  int b, s, h, kh, dh, t, n_cols, splits, split_cols, group;
  int q_rows, warps, key_warps, threads, ppt, ng, chunk;
  float code_off, sm_scale;
};

// The merge of one tile by its last-arriving split: every output pair (row
// r of the block, d and d + 1) of the tile's live rows, one pair per thread
// in turn, from the partials of splits 0..KS-1 in that order - op for op
// the arithmetic of the reference's combine (`combine_partials`): the max of
// the m's, weights exp(m - max) (exactly 0 for a split with m = -inf),
// round-to-nearest products and sums, a denominator of at least 1e-30. The
// merge sits on the launch's critical path, in one block on one SM whose
// instruction cache has not seen this code since the last launch (every
// other block exits before it): its time grows with its code as much as with
// its round trips to L2. So a thread issues the loads of MERGE_CHUNK splits'
// (m, l, acc) together before it uses any, and the chunk stays small: a
// chunk of 2 was faster inside the decode step than chunks of 1, 4 and 8
// (PERF.md). The other splits' partials were written by other SMs:
// last_arrival's fences order them before these reads, which go to L2
// (ld.global.cg) since L1 is not coherent across SMs. Rows past the group or
// past S are not written.
constexpr int MERGE_CHUNK = 2;

__device__ __forceinline__ void merge_tile(const PagedArgs& a, int bi, int kh, int qb) {
  const int g = a.h / a.kh;
  const int ks = a.splits;
  const size_t split_stride = (size_t)a.h * a.s;   // between one split's rows and the next's
  for (Walk2 it(threadIdx.x, blockDim.x, a.dh / 2); it.r < g * a.q_rows; it.next()) {
    const int gi = it.r / a.q_rows;
    const int si = qb * a.q_rows + (it.r - gi * a.q_rows);
    if (si >= a.s) continue;
    const int hi = kh * g + gi;
    const size_t row0 = ((size_t)bi * ks * a.h + hi) * a.s + si;
    float mc[MERGE_CHUNK], lc[MERGE_CHUNK];
    float2 ac[MERGE_CHUNK];
    auto load = [&](int k0) {
#pragma unroll
      for (int k = 0; k < MERGE_CHUNK; ++k) {
        if (k0 + k < ks) {
          const size_t row = row0 + (size_t)(k0 + k) * split_stride;
          mc[k] = __ldcg(a.m_p + row);
          lc[k] = __ldcg(a.l_p + row);
          ac[k] = __ldcg(reinterpret_cast<const float2*>(a.acc_p + row * a.dh) + it.c);
        }
      }
    };
    load(0);   // the first chunk's l and acc arrive while the max is taken
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < MERGE_CHUNK; ++k)
      if (k < ks) mx = fmaxf(mx, mc[k]);
#pragma unroll 8
    for (int k = MERGE_CHUNK; k < ks; ++k)   // the other m's: one round trip for up to 10
      mx = fmaxf(mx, __ldcg(a.m_p + row0 + (size_t)k * split_stride));
    float l_tot = 0.0f;
    float2 acc = make_float2(0.0f, 0.0f);
    for (int k0 = 0; k0 < ks; k0 += MERGE_CHUNK) {
      if (k0 > 0) load(k0);
#pragma unroll
      for (int k = 0; k < MERGE_CHUNK; ++k) {
        if (k0 + k < ks) {
          const float m = mc[k];
          const float w = (isinf(m) && m < 0.0f) ? 0.0f : expf(m - mx);
          l_tot = __fadd_rn(l_tot, __fmul_rn(lc[k], w));
          acc.x = __fadd_rn(acc.x, __fmul_rn(ac[k].x, w));
          acc.y = __fadd_rn(acc.y, __fmul_rn(ac[k].y, w));
        }
      }
    }
    const float den = fmaxf(l_tot, 1e-30f);
    reinterpret_cast<float2*>(a.out + (((size_t)bi * a.s + si) * a.h + hi) * a.dh)[it.c] =
        make_float2(__fdiv_rn(acc.x, den), __fdiv_rn(acc.y, den));
  }
}

// Whether this block is the last of its tile's splits to arrive: each
// thread's partial writes are ordered before the counter's atomic by the
// fence; the last arrival resets the counter for the next launch. `flag` is
// a word of the block's shared memory.
__device__ __forceinline__ bool last_arrival(int* __restrict__ cnt, int tile, int splits,
                                             int& flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    flag = atomicAdd(cnt + tile, 1) == splits - 1;
    if (flag) cnt[tile] = 0;
  }
  __syncthreads();
  const bool last = flag;
  if (last) __threadfence();
  return last;
}

template <typename TQ, typename TP, int DMAX>
__global__ void __launch_bounds__(MAX_THREADS) paged_attention_kernel(PagedArgs a) {
  constexpr bool QUANT = std::is_same<TP, int8_t>::value;
  constexpr bool Q_EXACT = std::is_same<TQ, __nv_bfloat16>::value;
  constexpr bool KV_EXACT = std::is_same<TP, __nv_bfloat16>::value;
  constexpr int NTD = DMAX / 8;  // n-tiles of the head dimension
  constexpr int NT = CHUNK_KEYS / 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // thread in the quad
  const int ks = blockIdx.x % a.splits;
  const int qb = blockIdx.x / a.splits;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = a.h / a.kh;
  const int rows = g * a.q_rows;
  const int dh = a.dh;
  const int half = dh >> 1;
  const int t = a.t;
  const int esize = (int)sizeof(TP);
  const int kw = a.key_warps;
  const Layout L = make_layout(dh, t, a.ppt, a.warps, kw, esize, a.ng);
  // warp = wk * row warps + wr: rows wr * 16 .., every kw-th n-tile from wk
  const int wr = warp % a.warps;
  const int wk = warp / a.warps;
  const bool computes = warp < L.cwarps;

  float* kf = reinterpret_cast<float*>(smem + L.off_kf);
  float* vf = reinterpret_cast<float*>(smem + L.off_vf);
  float* q_s = reinterpret_cast<float*>(smem + L.off_q);
  float* p_s = reinterpret_cast<float*>(smem + L.off_p);
  float* freq_s = reinterpret_cast<float*>(smem + L.off_freq);
  int* qpos_s = reinterpret_cast<int*>(smem + L.off_qpos);
  int& used_s = *reinterpret_cast<int*>(smem + L.off_used);
  const unsigned char* kbytes = static_cast<const unsigned char*>(a.k);
  const unsigned char* vbytes = static_cast<const unsigned char*>(a.v);
  const TQ* q = static_cast<const TQ*>(a.q);

  if (tid == 0) {
    int len;
    if (a.seqlens != nullptr) {
      len = a.seqlens[bi];
    } else {
      int mx = a.qpos[(size_t)bi * a.s];
      for (int i = 1; i < a.s; ++i) mx = max(mx, a.qpos[(size_t)bi * a.s + i]);
      len = mx + 1;
    }
    const int u = len <= 0 ? 0 : (len + t - 1) / t;
    used_s = min(max(u, 0), a.n_cols);
  }
  for (Walk2 it(tid, nthr, dh); it.r < L.rows_pad; it.next()) {
    const int gi = it.r / a.q_rows;
    const int si = qb * a.q_rows + (it.r - gi * a.q_rows);
    float x = 0.0f;
    if (it.r < rows && si < a.s)
      x = to_f32<TQ>(q[(((size_t)bi * a.s + si) * a.h + kh * g + gi) * dh + it.c]);
    q_s[it.r * L.ks + it.c] = x;
  }
  for (int r = tid; r < L.rows_pad; r += nthr) {
    const int gi = r / a.q_rows;
    const int si = qb * a.q_rows + (r - gi * a.q_rows);
    // a padding row sees every key masked; it is computed and never written
    qpos_s[r] = (r < rows && si < a.s) ? a.qpos[(size_t)bi * a.s + si] : -1;
  }
  if (QUANT && a.freqs != nullptr)
    for (int i = tid; i < half; i += nthr) freq_s[i] = a.freqs[i];
  __syncthreads();

  const int used = used_s;
  const int col_beg = ks * a.split_cols;
  const int col_end = min(min(col_beg + a.split_cols, a.n_cols), used);
  const int n_tiles = col_end > col_beg ? (col_end - col_beg + a.ppt - 1) / a.ppt : 0;
  const int row_bytes = dh * esize;

  // stage the live rows of tile `tile` into ring slot tile & 1
  auto issue = [&](int tile) {
    unsigned char* st = smem + (size_t)(tile & 1) * L.stage;
    const int c0 = col_beg + tile * a.ppt;
    const int nk = min(a.ppt, col_end - c0) * t;
    const int cpr = row_bytes / a.chunk;
    for (int e = tid; e < nk * cpr; e += nthr) {
      const int kk = e / cpr;
      const int c = e - kk * cpr;
      const int cl = kk / t;
      const size_t row =
          ((size_t)a.bt[(size_t)bi * a.n_cols + c0 + cl] * t + (kk - cl * t)) * a.kh + kh;
      const size_t src = row * row_bytes + (size_t)c * a.chunk;
      const size_t dst = (size_t)kk * row_bytes + (size_t)c * a.chunk;
      cp_async(st + dst, kbytes + src, a.chunk);
      cp_async(st + L.raw_kv + dst, vbytes + src, a.chunk);
    }
    if (QUANT) {
      float* aux = reinterpret_cast<float*>(st + 2 * L.raw_kv);
      const size_t n4 = L.raw_aux / 4;
      for (int e = tid; e < nk * a.ng; e += nthr) {
        const int kk = e / a.ng;
        const int j = e - kk * a.ng;
        const int cl = kk / t;
        const size_t row =
            ((size_t)a.bt[(size_t)bi * a.n_cols + c0 + cl] * t + (kk - cl * t)) * a.kh + kh;
        const size_t src = row * a.ng + j;
        cp_async(aux + e, a.k_scale + src, 4);
        cp_async(aux + n4 + e, a.k_zero + src, 4);
        cp_async(aux + 2 * n4 + e, a.v_scale + src, 4);
        cp_async(aux + 3 * n4 + e, a.v_zero + src, 4);
      }
    }
    cp_async_commit();
  };

  // per-warp state: rows gq and gq + 8 of the warp's 16
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float o[NTD][4];
#pragma unroll
  for (int j = 0; j < NTD; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  const int r0 = wr * 16 + gq;
  const int qp0 = qpos_s[r0];
  const int qp1 = qpos_s[r0 + 8];
  const float* qw = q_s + (size_t)wr * 16 * L.ks;
  float* pw = p_s + (size_t)(computes ? warp : 0) * 16 * L.ps;

  if (n_tiles > 0) issue(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      issue(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int c0 = col_beg + tile * a.ppt;
    const int nk = min(a.ppt, col_end - c0) * t;  // live keys of this tile
    const int kpos0 = c0 * t;                      // absolute position of key 0
    const unsigned char* st = smem + (size_t)(tile & 1) * L.stage;
    const TP* rk = reinterpret_cast<const TP*>(st);
    const TP* rv = reinterpret_cast<const TP*>(st + L.raw_kv);

    if (QUANT) {
      const float* aux = reinterpret_cast<const float*>(st + 2 * L.raw_kv);
      const size_t n4 = L.raw_aux / 4;
      const float* sk = aux;
      const float* zk = aux + n4;
      const float* sv = aux + 2 * n4;
      const float* zv = aux + 3 * n4;
      for (Walk2 it(tid, nthr, half); it.r < L.kpad; it.next()) {
        const int kk = it.r;
        const int i = it.c;
        float* kr = kf + kk * L.ks;
        if (kk >= nk) {
          kr[i] = 0.0f;
          kr[i + half] = 0.0f;
          continue;
        }
        const int g1 = kk * a.ng + (a.ng == 1 ? 0 : i / a.group);
        const int g2 = kk * a.ng + (a.ng == 1 ? 0 : (i + half) / a.group);
        const float x1 = __fmul_rn(sk[g1], __fadd_rn(__fadd_rn(to_f32<TP>(rk[kk * dh + i]),
                                                               a.code_off), zk[g1]));
        const float x2 = __fmul_rn(
            sk[g2], __fadd_rn(__fadd_rn(to_f32<TP>(rk[kk * dh + i + half]), a.code_off),
                              zk[g2]));
        if (a.freqs != nullptr) {
          const float ang = __fmul_rn((float)(kpos0 + kk), freq_s[i]);
          float sn, cs;
          sincosf(ang, &sn, &cs);
          kr[i] = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
          kr[i + half] = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
        } else {
          kr[i] = x1;
          kr[i + half] = x2;
        }
      }
      for (Walk2 it(tid, nthr, dh); it.r < L.kpad; it.next()) {
        const int kk = it.r;
        const int d = it.c;
        float x = 0.0f;
        if (kk < nk) {
          const int gi = kk * a.ng + (a.ng == 1 ? 0 : d / a.group);
          x = __fmul_rn(sv[gi], __fadd_rn(__fadd_rn(to_f32<TP>(rv[kk * dh + d]), a.code_off),
                                          zv[gi]));
        }
        vf[kk * L.vs + d] = x;
      }
    } else {
      for (Walk2 it(tid, nthr, dh); it.r < L.kpad; it.next()) {
        const int kk = it.r;
        const int d = it.c;
        float xk = 0.0f, xv = 0.0f;
        if (kk < nk) {
          xk = to_f32<TP>(rk[kk * dh + d]);
          xv = to_f32<TP>(rv[kk * dh + d]);
        }
        kf[kk * L.ks + d] = xk;
        vf[kk * L.vs + d] = xv;
      }
    }
    __syncthreads();

    if (computes) {
      // this warp's n-tiles of the tile: wk, wk + kw, ..., up to NT per chunk
      const int ntl = (nk + 7) >> 3;
      for (int u0 = wk; u0 < ntl; u0 += NT * kw) {
        const int nkt = min(NT, (ntl - u0 + kw - 1) / kw);
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        // S = Q K^T over the head dimension, 8 at a time
        for (int kd = 0; kd < dh; kd += 8) {
          uint32_t ah[4], al[4];
          load_a(qw, L.ks, kd, gq, tq, ah, al);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (j < nkt) {
              // B (k = d, n = key): b0 (t, g), b1 (t + 4, g) = K[key][d]
              const float* kb = kf + ((u0 + j * kw) * 8 + gq) * L.ks + kd + tq;
              uint32_t bh0, bh1, bl0, bl1;
              split_tf32(kb[0], bh0, bl0);
              split_tf32(kb[4], bh1, bl1);
              mma_3xtf32<Q_EXACT, KV_EXACT>(s[j], ah, al, bh0, bh1, bl0, bl1);
            }
          }
        }
        // causal mask and scale; C layout: (gq, 2tq + e) for e < 2, then row gq + 8
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nkt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = (u0 + j * kw) * 8 + 2 * tq + (e & 1);
              const int qp = e < 2 ? qp0 : qp1;
              const float x = key >= nk ? -INFINITY
                              : (kpos0 + key <= qp ? __fmul_rn(s[j][e], a.sm_scale)
                                                   : MASK_VALUE);
              s[j][e] = x;
              if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
            }
          }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0);
        const float mn1 = fmaxf(m1, mx1);
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nkt) {
            s[j][0] = expf(s[j][0] - mn0);
            s[j][1] = expf(s[j][1] - mn0);
            s[j][2] = expf(s[j][2] - mn1);
            s[j][3] = expf(s[j][3] - mn1);
            sum0 += s[j][0] + s[j][1];
            sum1 += s[j][2] + s[j][3];
            *reinterpret_cast<float2*>(pw + gq * L.ps + j * 8 + 2 * tq) =
                make_float2(s[j][0], s[j][1]);
            *reinterpret_cast<float2*>(pw + (gq + 8) * L.ps + j * 8 + 2 * tq) =
                make_float2(s[j][2], s[j][3]);
          }
        }
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
        const float corr0 = expf(m0 - mn0);
        const float corr1 = expf(m1 - mn1);
        l0 = l0 * corr0 + sum0;
        l1 = l1 * corr1 + sum1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int j = 0; j < NTD; ++j) {
          o[j][0] *= corr0;
          o[j][1] *= corr0;
          o[j][2] *= corr1;
          o[j][3] *= corr1;
        }
        __syncwarp();
        // O += P V: P from the scratch in the A layout, V (k = key, n = d)
        for (int kt = 0; kt < nkt; ++kt) {
          uint32_t ah[4], al[4];
          load_a(pw, L.ps, kt * 8, gq, tq, ah, al);
          const float* vb = vf + ((u0 + kt * kw) * 8 + tq) * L.vs + gq;
#pragma unroll
          for (int j = 0; j < NTD; ++j) {
            if (j * 8 < dh) {
              uint32_t bh0, bh1, bl0, bl1;
              split_tf32(vb[j * 8], bh0, bl0);
              split_tf32(vb[4 * L.vs + j * 8], bh1, bl1);
              mma_3xtf32<false, KV_EXACT>(o[j], ah, al, bh0, bh1, bl0, bl1);
            }
          }
        }
        __syncwarp();
      }
    }
  }

  // merge the key warps' states by log-sum-exp; a warp that saw no key of
  // a row carries m = -inf and weighs exactly zero
  if (kw > 1) {
    __syncthreads();  // every warp is past its last tile: the tile area is free
    float* mg = reinterpret_cast<float*>(smem);  // [cwarps * 16][ks]
    if (computes && wk > 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* row = mg + ((size_t)warp * 16 + gq + 8 * hr) * L.ks;
#pragma unroll
        for (int j = 0; j < NTD; ++j)
          if (j * 8 < dh)
            *reinterpret_cast<float2*>(row + j * 8 + 2 * tq) =
                make_float2(o[j][2 * hr], o[j][2 * hr + 1]);
        if (tq == 0) {
          row[dh] = hr ? m1 : m0;
          row[dh + 1] = hr ? l1 : l0;
        }
      }
    }
    __syncthreads();
    if (computes && wk == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float mo = hr ? m1 : m0;
        float mx = mo;
        for (int k = 1; k < kw; ++k)
          mx = fmaxf(mx, mg[((size_t)(k * a.warps + wr) * 16 + gq + 8 * hr) * L.ks + dh]);
        const float wo = mo == -INFINITY ? 0.0f : expf(mo - mx);
        float l = (hr ? l1 : l0) * wo;
#pragma unroll
        for (int j = 0; j < NTD; ++j) {
          o[j][2 * hr] *= wo;
          o[j][2 * hr + 1] *= wo;
        }
        for (int k = 1; k < kw; ++k) {
          const float* row = mg + ((size_t)(k * a.warps + wr) * 16 + gq + 8 * hr) * L.ks;
          const float mk = row[dh];
          const float w = mk == -INFINITY ? 0.0f : expf(mk - mx);
          l += row[dh + 1] * w;
#pragma unroll
          for (int j = 0; j < NTD; ++j) {
            if (j * 8 < dh) {
              const float2 v = *reinterpret_cast<const float2*>(row + j * 8 + 2 * tq);
              o[j][2 * hr] += v.x * w;
              o[j][2 * hr + 1] += v.y * w;
            }
          }
        }
        if (hr) {
          m1 = mx;
          l1 = l;
        } else {
          m0 = mx;
          l0 = l;
        }
      }
    }
  }

  if (computes && wk == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + 8 * hr;
      const int gi = r / a.q_rows;
      const int si = qb * a.q_rows + (r - gi * a.q_rows);
      if (r >= rows || si >= a.s) continue;
      const int hi = kh * g + gi;
      const float l = hr ? l1 : l0;
      if (a.splits == 1) {
        float* dst = a.out + (((size_t)bi * a.s + si) * a.h + hi) * dh + 2 * tq;
        const float den = fmaxf(l, 1e-30f);
#pragma unroll
        for (int j = 0; j < NTD; ++j)
          if (j * 8 < dh)
            *reinterpret_cast<float2*>(dst + j * 8) =
                make_float2(__fdiv_rn(o[j][2 * hr], den), __fdiv_rn(o[j][2 * hr + 1], den));
      } else {
        const size_t row = (((size_t)bi * a.splits + ks) * a.h + hi) * a.s + si;
        float* dst = a.acc_p + row * dh + 2 * tq;
#pragma unroll
        for (int j = 0; j < NTD; ++j)
          if (j * 8 < dh)
            *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[j][2 * hr], o[j][2 * hr + 1]);
        if (tq == 0) {
          a.m_p[row] = hr ? m1 : m0;
          a.l_p[row] = l;
        }
      }
    }
  }

  // every block of a split launch arrives, a split with no live column too
  if (a.splits > 1) {
    const int n_qblocks = gridDim.x / a.splits;
    int& flag = *reinterpret_cast<int*>(smem + L.off_used + 4);
    if (last_arrival(a.counters, (bi * a.kh + kh) * n_qblocks + qb, a.splits, flag))
      merge_tile(a, bi, kh, qb);
  }
}

template <typename TQ, typename TP, int DMAX>
int launch_paged(const PagedArgs& a, size_t smem, cudaStream_t st) {
  auto kern = paged_attention_kernel<TQ, TP, DMAX>;
  if (smem > 48 * 1024) {  // above 48 KB the limit has to be raised per kernel
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(((a.s + a.q_rows - 1) / a.q_rows) * a.splits, a.kh, a.b);
  kern<<<grid, a.threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TP>
int launch_dh(const PagedArgs& a, size_t smem, cudaStream_t st) {
  return a.dh <= 64 ? launch_paged<TQ, TP, 64>(a, smem, st)
                    : launch_paged<TQ, TP, 128>(a, smem, st);
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. page_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 codes (then the four scale/zero pools and `group` are required and
// `bits` gives the code offset 2^(bits-1); `freqs` non-null rotates K).
// The launch plan (`q_rows`, `row_warps`, `key_warps`, `threads`,
// `pages_per_tile`, `smem_bytes`)
// comes from `attention_plan`; it is refused unless it covers every row and
// its byte count is this file's layout. With `splits` > 1 the partials
// `m_p`, `l_p`, `acc_p` and `n_counters` int32 tile counters, zero on entry
// and left zero, are required (plan::attention_merge_ok).
extern "C" int paged_attention_launch(
    const void* q, int q_dtype, const void* k, const void* v, int page_dtype,
    const void* k_scale, const void* k_zero, const void* v_scale, const void* v_zero,
    const void* freqs, const void* bt, const void* qpos, const void* seqlens, void* out,
    void* m_p, void* l_p, void* acc_p, void* counters, int n_counters, int b, int s, int h,
    int kh, int dh, int t,
    int n_cols, int q_block, int splits, int split_cols, int group, int bits, int q_rows,
    int row_warps, int key_warps, int threads, int pages_per_tile, int smem_bytes,
    void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (q_block <= 0 || s % q_block != 0 || kh <= 0 || h % kh != 0 || dh % 8 != 0 ||
      dh <= 0 || dh > 128 || t <= 0 || splits < 1 || q_rows < 1 || row_warps < 1 ||
      key_warps < 1 || threads % 32 != 0 || threads > MAX_THREADS ||
      threads < row_warps * key_warps * 32 || row_warps * 16 < (h / kh) * q_rows ||
      pages_per_tile < 1 || page_dtype < 0 || page_dtype > 2 ||
      !plan::attention_merge_ok(b, kh, s, q_rows, splits,
                                m_p && l_p && acc_p && counters,
                                counters ? n_counters : 0))
    return (int)cudaErrorInvalidValue;
  const int esize = page_dtype == 0 ? 4 : (page_dtype == 1 ? 2 : 1);
  const int grp = group > 0 ? group : dh;
  if (page_dtype == 2 && (dh % grp != 0 || k_scale == nullptr || k_zero == nullptr ||
                          v_scale == nullptr || v_zero == nullptr))
    return (int)cudaErrorInvalidValue;
  const int ng = page_dtype == 2 ? dh / grp : 0;
  const Layout L = make_layout(dh, t, pages_per_tile, row_warps, key_warps, esize, ng);
  if (L.total != (size_t)smem_bytes || L.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // widest copy that divides a page row and both pools' addresses
  const int row_bytes = dh * esize;
  int chunk = 0;
  for (int c = 16; c >= 4 && chunk == 0; c >>= 1)
    if (row_bytes % c == 0 && (uintptr_t)k % c == 0 && (uintptr_t)v % c == 0) chunk = c;
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  PagedArgs a;
  a.q = q; a.k = k; a.v = v;
  a.k_scale = (const float*)k_scale; a.k_zero = (const float*)k_zero;
  a.v_scale = (const float*)v_scale; a.v_zero = (const float*)v_zero;
  a.freqs = (const float*)freqs;
  a.bt = (const int32_t*)bt; a.qpos = (const int32_t*)qpos;
  a.seqlens = (const int32_t*)seqlens;
  a.out = (float*)out; a.m_p = (float*)m_p; a.l_p = (float*)l_p; a.acc_p = (float*)acc_p;
  a.counters = (int*)counters;
  a.b = b; a.s = s; a.h = h; a.kh = kh; a.dh = dh; a.t = t; a.n_cols = n_cols;
  a.splits = splits; a.split_cols = split_cols; a.group = grp;
  a.q_rows = q_rows; a.warps = row_warps; a.key_warps = key_warps; a.threads = threads;
  a.ppt = pages_per_tile; a.ng = ng; a.chunk = chunk;
  a.code_off = page_dtype == 2 ? (float)(1 << (bits - 1)) : 0.0f;
  a.sm_scale = 1.0f / sqrtf((float)dh);
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = L.total;
  if (page_dtype == 2) {
    if (q_dtype == 0) return launch_dh<float, int8_t>(a, smem, st);
    if (q_dtype == 1) return launch_dh<__nv_bfloat16, int8_t>(a, smem, st);
  } else if (page_dtype == 0) {
    if (q_dtype == 0) return launch_dh<float, float>(a, smem, st);
    if (q_dtype == 1) return launch_dh<__nv_bfloat16, float>(a, smem, st);
  } else {
    if (q_dtype == 0) return launch_dh<float, __nv_bfloat16>(a, smem, st);
    if (q_dtype == 1) return launch_dh<__nv_bfloat16, __nv_bfloat16>(a, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}
