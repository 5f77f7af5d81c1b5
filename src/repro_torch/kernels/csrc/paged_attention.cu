// Block-table-native causal GQA attention over one layer's KV page pool,
// plus the log-sum-exp combine of split partials.
//
// Grid: (q_block index * splits + split, kv head, batch row). One block owns
// the G * q_block query rows that share one KV head and walks only the live
// table columns of its split: page ids are read from the block table inside
// the loop, and columns at or past `used = ceil(len / T)` are never touched.
// Per page the block stages K and V rows in shared memory as f32 - integer
// pages are dequantised as scale * (code + offset + zero) and K is rotated
// (RoPE, half-split layout) at the absolute position of each page row - then
// runs one online-softmax step in f32. With one split it writes the output
// tile; with more it writes (m, l, acc) partials for the combine kernel.
//
// Masked logits are -1e30 while the running max starts at -inf, exactly as
// in the reference walk; a row that saw no live page ends with l = 0 and
// comes out as exact zeros. expf / sincosf are the full-precision versions.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASK_VALUE = -1e30f;
constexpr int NTHREADS = 128;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) { return (float)v; }

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
  int b, s, h, kh, dh, t, n_cols, q_block, splits, split_cols, group;
  float code_off, sm_scale;
};

template <typename TQ, typename TP, bool QUANT>
__global__ void paged_attention_kernel(PagedArgs a) {
  extern __shared__ float smem[];
  __shared__ int used_s;

  const int tid = threadIdx.x;
  const int ks = blockIdx.x % a.splits;
  const int qb = blockIdx.x / a.splits;
  const int kh = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = a.h / a.kh;
  const int rows = g * a.q_block;
  const int dh = a.dh;
  const int half = dh >> 1;
  const int t = a.t;
  const int kstride = dh + 1;  // padded K rows: conflict-free column reads

  float* q_s = smem;                       // [rows, dh]
  float* k_s = q_s + rows * dh;            // [t, dh + 1]
  float* v_s = k_s + t * kstride;          // [t, dh]
  float* p_s = v_s + t * dh;               // [rows, t]
  float* acc_s = p_s + rows * t;           // [rows, dh]
  float* m_s = acc_s + rows * dh;          // [rows]
  float* l_s = m_s + rows;                 // [rows]
  float* c_s = l_s + rows;                 // [rows]
  int* qpos_s = reinterpret_cast<int*>(c_s + rows);  // [rows]

  const TQ* q = static_cast<const TQ*>(a.q);
  const TP* kp = static_cast<const TP*>(a.k);
  const TP* vp = static_cast<const TP*>(a.v);

  if (tid == 0) {
    int len;
    if (a.seqlens != nullptr) {
      len = a.seqlens[bi];
    } else {
      int mx = a.qpos[(size_t)bi * a.s];
      for (int i = 1; i < a.s; ++i) mx = max(mx, a.qpos[(size_t)bi * a.s + i]);
      len = mx + 1;
    }
    int u = len <= 0 ? 0 : (len + t - 1) / t;
    used_s = min(max(u, 0), a.n_cols);
  }
  // row r = gi * q_block + sl  <->  query (s = qb * q_block + sl, head kh * g + gi)
  for (int e = tid; e < rows * dh; e += NTHREADS) {
    const int r = e / dh;
    const int d = e - r * dh;
    const int gi = r / a.q_block;
    const int sl = r - gi * a.q_block;
    const int si = qb * a.q_block + sl;
    const int hi = kh * g + gi;
    q_s[e] = to_f32<TQ>(q[(((size_t)bi * a.s + si) * a.h + hi) * dh + d]);
    acc_s[e] = 0.0f;
  }
  for (int r = tid; r < rows; r += NTHREADS) {
    const int sl = r % a.q_block;
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
    qpos_s[r] = a.qpos[(size_t)bi * a.s + qb * a.q_block + sl];
  }
  __syncthreads();

  const int used = used_s;
  const int col_beg = ks * a.split_cols;
  const int col_end = min(min(col_beg + a.split_cols, a.n_cols), used);
  const int ng = QUANT ? dh / a.group : 1;

  for (int col = col_beg; col < col_end; ++col) {
    const int page = a.bt[(size_t)bi * a.n_cols + col];
    const size_t row0 = (size_t)page * t;  // first pool row of this page

    if (QUANT) {
      for (int e = tid; e < t * half; e += NTHREADS) {
        const int ti = e / half;
        const int i = e - ti * half;
        const size_t base = ((row0 + ti) * a.kh + kh);
        const size_t cb = base * dh;
        const size_t sb = base * ng;
        const float s1 = a.k_scale[sb + i / a.group];
        const float z1 = a.k_zero[sb + i / a.group];
        const float s2 = a.k_scale[sb + (i + half) / a.group];
        const float z2 = a.k_zero[sb + (i + half) / a.group];
        const float x1 = __fmul_rn(s1, __fadd_rn(__fadd_rn(to_f32<TP>(kp[cb + i]), a.code_off), z1));
        const float x2 = __fmul_rn(s2, __fadd_rn(__fadd_rn(to_f32<TP>(kp[cb + i + half]), a.code_off), z2));
        if (a.freqs != nullptr) {
          const float ang = __fmul_rn((float)(col * t + ti), a.freqs[i]);
          float sn, cs;
          sincosf(ang, &sn, &cs);
          k_s[ti * kstride + i] = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
          k_s[ti * kstride + i + half] = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
        } else {
          k_s[ti * kstride + i] = x1;
          k_s[ti * kstride + i + half] = x2;
        }
      }
      for (int e = tid; e < t * dh; e += NTHREADS) {
        const int ti = e / dh;
        const int d = e - ti * dh;
        const size_t base = ((row0 + ti) * a.kh + kh);
        const float sc = a.v_scale[base * ng + d / a.group];
        const float zr = a.v_zero[base * ng + d / a.group];
        v_s[e] = __fmul_rn(sc, __fadd_rn(__fadd_rn(to_f32<TP>(vp[base * dh + d]), a.code_off), zr));
      }
    } else {
      for (int e = tid; e < t * dh; e += NTHREADS) {
        const int ti = e / dh;
        const int d = e - ti * dh;
        const size_t idx = ((row0 + ti) * a.kh + kh) * dh + d;
        k_s[ti * kstride + d] = to_f32<TP>(kp[idx]);
        v_s[e] = to_f32<TP>(vp[idx]);
      }
    }
    __syncthreads();

    // logits for every (query row, page row) pair, causal mask applied
    for (int e = tid; e < rows * t; e += NTHREADS) {
      const int r = e / t;
      const int ti = e - r * t;
      const float* qr = q_s + r * dh;
      const float* kr = k_s + ti * kstride;
      float dot = 0.0f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int kpos = col * t + ti;
      p_s[e] = (kpos <= qpos_s[r]) ? __fmul_rn(dot, a.sm_scale) : MASK_VALUE;
    }
    __syncthreads();

    // one online-softmax step per query row
    for (int r = tid; r < rows; r += NTHREADS) {
      float* pr = p_s + r * t;
      const float m_old = m_s[r];
      float m_new = m_old;
      for (int ti = 0; ti < t; ++ti) m_new = fmaxf(m_new, pr[ti]);
      float sum = 0.0f;
      for (int ti = 0; ti < t; ++ti) {
        const float p = expf(pr[ti] - m_new);
        pr[ti] = p;
        sum += p;
      }
      const float corr = expf(m_old - m_new);
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();

    for (int e = tid; e < rows * dh; e += NTHREADS) {
      const int r = e / dh;
      const int d = e - r * dh;
      const float* pr = p_s + r * t;
      float pv = 0.0f;
      for (int ti = 0; ti < t; ++ti) pv = fmaf(pr[ti], v_s[ti * dh + d], pv);
      acc_s[e] = acc_s[e] * c_s[r] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows * dh; e += NTHREADS) {
    const int r = e / dh;
    const int d = e - r * dh;
    const int gi = r / a.q_block;
    const int sl = r - gi * a.q_block;
    const int si = qb * a.q_block + sl;
    const int hi = kh * g + gi;
    if (a.splits == 1) {
      a.out[(((size_t)bi * a.s + si) * a.h + hi) * dh + d] =
          __fdiv_rn(acc_s[e], fmaxf(l_s[r], 1e-30f));
    } else {
      const size_t row = (((size_t)bi * a.splits + ks) * a.h + hi) * a.s + si;
      a.acc_p[row * dh + d] = acc_s[e];
      if (d == 0) {
        a.m_p[row] = m_s[r];
        a.l_p[row] = l_s[r];
      }
    }
  }
}

// One warp per output row (b, h, s): merge `ks` partials by log-sum-exp.
// A split that saw no live page carries m = -inf and weighs exactly zero.
__global__ void combine_partials_kernel(const float* __restrict__ m_p,
                                        const float* __restrict__ l_p,
                                        const float* __restrict__ acc_p,
                                        float* __restrict__ out, int b, int ks, int h,
                                        int s, int dh) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= b * h * s) return;
  const int si = warp % s;
  const int hi = (warp / s) % h;
  const int bi = warp / (s * h);
  float mx = -INFINITY;
  for (int k = 0; k < ks; ++k)
    mx = fmaxf(mx, m_p[(((size_t)bi * ks + k) * h + hi) * s + si]);
  float l_tot = 0.0f;
  for (int k = 0; k < ks; ++k) {
    const size_t row = (((size_t)bi * ks + k) * h + hi) * s + si;
    const float m = m_p[row];
    const float w = (isinf(m) && m < 0.0f) ? 0.0f : expf(m - mx);
    l_tot = __fadd_rn(l_tot, __fmul_rn(l_p[row], w));
  }
  const float denom = fmaxf(l_tot, 1e-30f);
  for (int d = lane; d < dh; d += 32) {
    float acc = 0.0f;
    for (int k = 0; k < ks; ++k) {
      const size_t row = (((size_t)bi * ks + k) * h + hi) * s + si;
      const float m = m_p[row];
      const float w = (isinf(m) && m < 0.0f) ? 0.0f : expf(m - mx);
      acc = __fadd_rn(acc, __fmul_rn(acc_p[row * dh + d], w));
    }
    out[(((size_t)bi * s + si) * h + hi) * dh + d] = __fdiv_rn(acc, denom);
  }
}

template <typename TQ, typename TP, bool QUANT>
int launch_paged(const PagedArgs& a, cudaStream_t st) {
  const int g = a.h / a.kh;
  const int rows = g * a.q_block;
  const size_t floats = (size_t)rows * a.dh * 2 + (size_t)a.t * (a.dh + 1) +
                        (size_t)a.t * a.dh + (size_t)rows * a.t + (size_t)rows * 4;
  const size_t smem = floats * sizeof(float);
  auto kern = paged_attention_kernel<TQ, TP, QUANT>;
  if (smem > 48 * 1024) {  // above 48 KB the limit has to be raised per kernel
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((a.s / a.q_block) * a.splits, a.kh, a.b);
  kern<<<grid, NTHREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. page_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 codes (then the four scale/zero pools and `group` are required and
// `bits` gives the code offset 2^(bits-1); `freqs` non-null rotates K).
extern "C" int paged_attention_launch(
    const void* q, int q_dtype, const void* k, const void* v, int page_dtype,
    const void* k_scale, const void* k_zero, const void* v_scale, const void* v_zero,
    const void* freqs, const void* bt, const void* qpos, const void* seqlens, void* out,
    void* m_p, void* l_p, void* acc_p, int b, int s, int h, int kh, int dh, int t,
    int n_cols, int q_block, int splits, int split_cols, int group, int bits,
    void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (q_block <= 0 || s % q_block != 0 || kh <= 0 || h % kh != 0 || (dh & 1) != 0 ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  PagedArgs a;
  a.q = q; a.k = k; a.v = v;
  a.k_scale = (const float*)k_scale; a.k_zero = (const float*)k_zero;
  a.v_scale = (const float*)v_scale; a.v_zero = (const float*)v_zero;
  a.freqs = (const float*)freqs;
  a.bt = (const int32_t*)bt; a.qpos = (const int32_t*)qpos;
  a.seqlens = (const int32_t*)seqlens;
  a.out = (float*)out; a.m_p = (float*)m_p; a.l_p = (float*)l_p; a.acc_p = (float*)acc_p;
  a.b = b; a.s = s; a.h = h; a.kh = kh; a.dh = dh; a.t = t; a.n_cols = n_cols;
  a.q_block = q_block; a.splits = splits; a.split_cols = split_cols;
  a.group = group > 0 ? group : dh;
  a.code_off = page_dtype == 2 ? (float)(1 << (bits - 1)) : 0.0f;
  a.sm_scale = 1.0f / sqrtf((float)dh);
  cudaStream_t st = (cudaStream_t)stream;
  if (page_dtype == 2) {
    if (k_scale == nullptr || k_zero == nullptr || v_scale == nullptr || v_zero == nullptr ||
        dh % a.group != 0)
      return (int)cudaErrorInvalidValue;
    if (q_dtype == 0) return launch_paged<float, int8_t, true>(a, st);
    if (q_dtype == 1) return launch_paged<__nv_bfloat16, int8_t, true>(a, st);
  } else if (page_dtype == 0) {
    if (q_dtype == 0) return launch_paged<float, float, false>(a, st);
    if (q_dtype == 1) return launch_paged<__nv_bfloat16, float, false>(a, st);
  } else if (page_dtype == 1) {
    if (q_dtype == 0) return launch_paged<float, __nv_bfloat16, false>(a, st);
    if (q_dtype == 1) return launch_paged<__nv_bfloat16, __nv_bfloat16, false>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int combine_partials_launch(const void* m_p, const void* l_p, const void* acc_p,
                                       void* out, int b, int ks, int h, int s, int dh,
                                       void* stream) {
  const long long rows = (long long)b * h * s;
  if (rows <= 0) return 0;
  const int threads = 128;  // four warps, one output row each
  const long long blocks = (rows * 32 + threads - 1) / threads;
  combine_partials_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)m_p, (const float*)l_p, (const float*)acc_p, (float*)out, b, ks, h, s,
      dh);
  return (int)cudaGetLastError();
}
