// W4A4 integer GEMM with in-kernel nibble unpack.
//
//   out[m, n] = (s_a[m] * s_w[n]) * (float(q_a[m, :] . q_w[:, n]) + z_a[m] * float(colsum[n]))
//
// q_a   int8 [M, K]    activation codes (unsigned range, int8 storage)
// w     uint8 [K/2, N] two weight rows per byte: row 2k in the low nibble,
//                      row 2k+1 in the high nibble, each a signed int4
// The product accumulates exactly in int32 through __dp4a: four consecutive
// K entries of one activation row against four consecutive K entries of one
// weight column, the latter assembled from two packed bytes in registers.
//
// Each thread owns TN = 4 neighbouring output columns (one 32-bit load
// covers them for one packed row) and BM activation rows; a block of NT
// threads covers NT * TN columns. The K axis is cut into `splits` slices
// (grid.y) so that a decode-sized call (M <= 16) still spreads the packed
// weight stream over every SM; slices write int32 partials that a second
// small kernel sums before the float epilogue. With one slice the epilogue
// runs in the GEMM kernel. Ragged M, N and K edges are masked, not padded.
//
// The epilogue keeps the reference's operation order with explicit
// round-to-nearest multiplies and adds, so no FMA contraction changes a bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 4;     // output columns per thread
constexpr int NT = 64;    // threads per block
constexpr int BN = NT * TN;
constexpr int KS = 256;   // K entries staged in shared memory per pass

// signed int4 nibble -> its int8 bit pattern (as the low byte of a word)
__device__ __forceinline__ uint32_t sx4(uint32_t nib) {
  return ((nib ^ 8u) - 8u) & 0xFFu;
}

// four packed bytes of row k2, columns n0 .. n0+3 (zero outside the matrix)
__device__ __forceinline__ uint32_t load_w4(const uint8_t* __restrict__ w, int k2,
                                            int n0, int n, int k2_total, bool vec) {
  if (k2 >= k2_total) return 0u;
  const uint8_t* p = w + (size_t)k2 * n + n0;
  if (vec && n0 + TN <= n) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0u;
#pragma unroll
  for (int c = 0; c < TN; ++c)
    if (n0 + c < n) v |= (uint32_t)p[c] << (8 * c);
  return v;
}

__device__ __forceinline__ float epilogue(int32_t acc, float sa, float za, float sw,
                                          int32_t cs) {
  return __fmul_rn(__fmul_rn(sa, sw),
                   __fadd_rn((float)acc, __fmul_rn(za, (float)cs)));
}

template <int BM>
__global__ void int4_matmul_kernel(const int8_t* __restrict__ qa,
                                   const uint8_t* __restrict__ w,
                                   int32_t* __restrict__ part,
                                   const float* __restrict__ sa,
                                   const float* __restrict__ za,
                                   const float* __restrict__ sw,
                                   const int32_t* __restrict__ colsum,
                                   float* __restrict__ out,
                                   int m, int n, int k, int kc) {
  __shared__ int32_t a_s[BM][KS / 4];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN + tid * TN;
  const int m0 = blockIdx.z * BM;
  const int kbeg = blockIdx.y * kc;
  const int kend = min(k, kbeg + kc);
  const int k2_total = k >> 1;
  const bool vec_w = (n & 3) == 0;
  const bool vec_a = (k & 3) == 0;

  int32_t acc[BM][TN];
#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += KS) {
    // stage BM x KS activation codes as 32-bit words (zero past the edges)
    for (int e = tid; e < BM * (KS / 4); e += NT) {
      const int mi = e / (KS / 4);
      const int kw = e - mi * (KS / 4);
      const int mm = m0 + mi;
      const int kk = k0 + 4 * kw;
      int32_t word = 0;
      if (mm < m && kk < kend) {
        const int8_t* p = qa + (size_t)mm * k + kk;
        if (vec_a && kk + 4 <= kend) {
          word = *reinterpret_cast<const int32_t*>(p);
        } else {
          uint32_t u = 0u;
          for (int j = 0; j < 4; ++j)
            if (kk + j < kend) u |= ((uint32_t)(uint8_t)p[j]) << (8 * j);
          word = (int32_t)u;
        }
      }
      a_s[mi][kw] = word;
    }
    __syncthreads();

    const int klim = min(KS, kend - k0);
    if (n0 < n) {
      for (int kk = 0; kk < klim; kk += 4) {
        const int k2 = (k0 + kk) >> 1;
        const uint32_t r0 = load_w4(w, k2, n0, n, k2_total, vec_w);
        const uint32_t r1 = load_w4(w, k2 + 1, n0, n, k2_total, vec_w);
        int32_t wv[TN];
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const uint32_t b0 = (r0 >> (8 * c)) & 0xFFu;
          const uint32_t b1 = (r1 >> (8 * c)) & 0xFFu;
          wv[c] = (int32_t)(sx4(b0 & 15u) | (sx4(b0 >> 4) << 8) |
                            (sx4(b1 & 15u) << 16) | (sx4(b1 >> 4) << 24));
        }
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          const int32_t a = a_s[i][kk >> 2];
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[i][c] = __dp4a(a, wv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();
  }

  if (n0 >= n) return;
  const bool single = gridDim.y == 1;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int mm = m0 + i;
    if (mm >= m) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int nn = n0 + c;
      if (nn >= n) continue;
      if (single) {
        out[(size_t)mm * n + nn] = epilogue(acc[i][c], sa[mm], za[mm], sw[nn], colsum[nn]);
      } else {
        part[((size_t)blockIdx.y * m + mm) * n + nn] = acc[i][c];
      }
    }
  }
}

__global__ void int4_epilogue_kernel(const int32_t* __restrict__ part, int splits,
                                     const float* __restrict__ sa,
                                     const float* __restrict__ za,
                                     const float* __restrict__ sw,
                                     const int32_t* __restrict__ colsum,
                                     float* __restrict__ out, int m, int n) {
  const size_t total = (size_t)m * n;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int32_t acc = 0;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * total + idx];
  const int mm = (int)(idx / n);
  const int nn = (int)(idx - (size_t)mm * n);
  out[idx] = epilogue(acc, sa[mm], za[mm], sw[nn], colsum[nn]);
}

}  // namespace

// `kc` is the K extent of one slice (a multiple of 4), `splits` the number of
// slices; `part` is int32 scratch [splits, M, N], unused when splits == 1.
extern "C" int int4_matmul_launch(const void* qa, const void* w, void* part,
                                  const void* sa, const void* za, const void* sw,
                                  const void* colsum, void* out, int m, int n, int k,
                                  int kc, int splits, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (kc <= 0 || (kc & 3) != 0 || splits < 1 || (long long)kc * splits < k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int bm = m <= 4 ? 4 : (m <= 8 ? 8 : 16);
  dim3 grid((n + BN - 1) / BN, splits, (m + bm - 1) / bm);
#define LAUNCH(BM_)                                                                   \
  int4_matmul_kernel<BM_><<<grid, NT, 0, st>>>(                                       \
      (const int8_t*)qa, (const uint8_t*)w, (int32_t*)part, (const float*)sa,         \
      (const float*)za, (const float*)sw, (const int32_t*)colsum, (float*)out, m, n,  \
      k, kc)
  if (bm == 4) LAUNCH(4);
  else if (bm == 8) LAUNCH(8);
  else LAUNCH(16);
#undef LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t total = (size_t)m * n;
  const int threads = 256;
  int4_epilogue_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const int32_t*)part, splits, (const float*)sa, (const float*)za, (const float*)sw,
      (const int32_t*)colsum, (float*)out, m, n);
  return (int)cudaGetLastError();
}
