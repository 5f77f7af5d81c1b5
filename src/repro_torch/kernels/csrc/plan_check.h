// Launch-plan checks of block_hadamard.cu, hadamard_quant.cu, int4_matmul.cu
// and of paged_attention.cu's split merge.
//
// The plans are computed in Python (`kernels/block_hadamard.py::hadamard_plan`,
// `kernels/hadamard_quant.py::hadamard_quant_plan`,
// `kernels/int4_matmul.py::int4_plan`, `kernels/paged_attention.py::merge_tiles`);
// each C launch calls the check below
// first and refuses (cudaErrorInvalidValue) a plan that does not match the
// geometry its kernels are written for. Plain C++ with no CUDA header, so the
// CPU tests compile this file with the host compiler and hold every Python
// plan against it.
#pragma once

namespace plan {

inline bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }
inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// ---- block_hadamard ---------------------------------------------------------

constexpr int BH_WARP = 0;     // power-of-two b <= 32 * E: registers + shuffles
constexpr int BH_BLOCK = 1;    // power-of-two b > 32 * E: one block per b-block
constexpr int BH_DENSE = 2;    // any other order: dense operand, E outputs a thread

// x [m, d], block size b, `dense_operand` whether H_b / sqrt(b) is passed;
// e elements per thread, `threads` per block, `grid` blocks, `smem` bytes.
inline bool hadamard_plan_ok(long long m, long long d, long long b, bool dense_operand,
                             int kind, int e, int threads, long long grid, long long smem) {
  if (m <= 0 || d <= 0 || b <= 0 || d % b || !pow2(e) || d % e || threads <= 0 ||
      threads % 32 || grid <= 0)
    return false;
  const long long chunks = m * d / e;
  const long long cover = grid * threads;
  if (kind == BH_WARP)
    return pow2(b) && !dense_operand && e <= 32 && b <= 32LL * e && threads <= 256 &&
           smem == 0 && cover >= chunks && cover - threads < chunks;
  if (kind == BH_BLOCK)
    return pow2(b) && !dense_operand && (e == 8 || e == 16 || e == 32) && b > 32LL * e &&
           (long long)threads * e == b && threads <= 1024 && grid == m * d / b &&
           smem == 4 * b && smem <= 232448;
  if (kind == BH_DENSE)
    return !pow2(b) && dense_operand && e <= 4 && b % e == 0 && threads <= 256 &&
           smem == 0 && cover >= chunks && cover - threads < chunks;
  return false;
}

// ---- hadamard_quant -----------------------------------------------------------

// One row of x [m, d] is cut into `cluster` slices, one thread block each, the
// row's blocks one thread-block cluster. A slice holds whole units: a unit is
// b elements for the dense kind (e divides b) and max(b, e) for a power of two
// (whole b-blocks and whole E-chunks). The first (d / unit) % cluster slices
// hold one unit more than the rest; every slice holds at least one.
constexpr int HQ_MAX_CLUSTER = 8;               // the portable cluster size
constexpr long long HQ_SMEM_LIMIT = 232448 - 4096;   // dynamic; the rest is static

inline long long hq_unit(long long b, int e, int kind) {
  return kind == BH_DENSE ? b : (b > e ? b : e);
}

// kind as for block_hadamard (registers + shuffles, shared-memory rounds,
// dense operand), e elements per thread, `threads` per block (the widest
// slice's chunks, in whole warps), `grid` = m * cluster blocks, `smem`
// dynamic bytes (the widest slice in f32 for the shared-memory kind).
inline bool hadamard_quant_plan_ok(long long m, long long d, long long b,
                                   bool dense_operand, int kind, int e, int threads,
                                   int cluster, long long grid, long long smem) {
  if (m <= 0 || d <= 0 || b <= 0 || d % b || !pow2(e) || e > 32 || threads <= 0 ||
      threads % 32 || threads > 1024 || !pow2(cluster) || cluster > HQ_MAX_CLUSTER ||
      grid != m * cluster)
    return false;
  const long long unit = hq_unit(b, e, kind);
  if (unit % e || d % unit || d / unit < cluster) return false;
  const long long slice = cdiv(d / unit, cluster) * unit;   // the widest slice
  if (threads != cdiv(slice / e, 32) * 32) return false;
  if (kind == BH_WARP)
    return pow2(b) && !dense_operand && b <= 32LL * e && smem == 0;
  if (kind == BH_BLOCK)
    return pow2(b) && !dense_operand && (e == 8 || e == 16 || e == 32) && b > 32LL * e &&
           smem == 4 * slice && smem <= HQ_SMEM_LIMIT;
  if (kind == BH_DENSE)
    return !pow2(b) && dense_operand && e <= 4 && smem == 0;
  return false;
}

// ---- int4_matmul ------------------------------------------------------------

constexpr int MMA_COLS = 128;       // 4 warps across N, 32 columns each
constexpr int MMA_K_ROWS = 64;      // packed rows (128 K) per pipeline stage
constexpr int MMA_B_STAGE = MMA_K_ROWS * MMA_COLS;   // bytes of packed weights
constexpr int MMA_A_PITCH = 2 * MMA_K_ROWS + 32;     // bytes per activation row
constexpr int MMA_STAGES = 4;       // cp.async ring depth

inline long long mma_smem(int rows) {
  return (long long)MMA_STAGES * (MMA_B_STAGE + (long long)rows * MMA_A_PITCH);
}

// q_a [m, k] x packed w [k/2, n]; the plan: activation rows per block,
// packed rows per K split, splits, threads per block, grid, dynamic
// shared-memory bytes; `workspace` whether the int32 split workspace
// and its tile counters are passed.
inline bool int4_plan_ok(long long m, long long n, long long k, int rows, long long k_rows,
                         int splits, int threads, long long gx, long long gy, long long gz,
                         long long smem, bool workspace) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 2 || splits < 1 || k_rows <= 0 || gy != splits)
    return false;
  const long long k2 = k / 2;
  if (k_rows * splits < k2 || k_rows * (splits - 1) >= k2) return false;
  if (splits > 1 && !workspace) return false;
  return (rows == 32 || rows == 64) && threads == 4 * rows && k_rows % MMA_K_ROWS == 0 &&
         gx == cdiv(n, MMA_COLS) && gz == cdiv(m, rows) && smem == mma_smem(rows) &&
         smem <= 232448;
}

// ---- paged_attention's split merge -------------------------------------------

// A block holds `q_rows` query positions of one (batch row, KV head); with
// `splits` > 1 the splits of such a tile arrive at one int32 counter and the
// last to arrive merges the tile. The launch needs the (m, l, acc) partials
// (`partials`) and at least one counter per tile (`counters` of them).
inline long long attention_tiles(long long b, long long kh, long long s, long long q_rows) {
  return b * kh * cdiv(s, q_rows);
}

inline bool attention_merge_ok(long long b, long long kh, long long s, long long q_rows,
                               int splits, bool partials, long long counters) {
  if (b <= 0 || kh <= 0 || s <= 0 || q_rows < 1 || splits < 1) return false;
  return splits == 1 || (partials && counters >= attention_tiles(b, kh, s, q_rows));
}

}  // namespace plan
