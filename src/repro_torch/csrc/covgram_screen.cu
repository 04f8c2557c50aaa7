// covgram_screen: fused centered-Gram tile + strict threshold + edge count +
// tile statistics, per scheduled tile pair, in float64.
//
// Replaces the TPU kernel
// src/repro/kernels/covgram_screen/covgram_screen.py (`_kernel`, launched by
// `covgram_screen_pallas`).
//
// For each pair t with column tiles I = i_idx[t], J = j_idx[t] of width bp:
//     S_IJ      = (X_I - mu_I)' (X_J - mu_J) / n_true
//     valid_rc  = row < p_true && col < p_true && row != col   (global ids)
//     edge_rc   = valid_rc && |S_rc| > lam                     (strict, eq. 4)
//     vals[t]   = edge ? S : 0                                  (bp, bp)
//     counts[t] = number of edges
//     stats[t]  = [max valid |S|, max valid non-edge |S|]       (0 if none)
// Unlike the reference's wrapper, nothing is cast to float32: the product,
// the threshold and the outputs are float64, so on exactly representable
// data `vals` equals the float64 oracle bit for bit.
//
// Bound on the H100: the larger of the operations, 2 N bp^2 per pair at the
// FP64 tensor-core peak (67 TFLOP/s), and the bytes, vals written once plus
// X read once (3.35 TB/s); at n = 192 the two are of one order.  Design:
// one thread block per (tile pair, 64 x 64 output sub-tile); the blocks of
// a pair run in parallel (the TPU kernel's sequential grid carried a VMEM
// accumulator over the row chunks; here a loop inside the block takes that
// place).  The block walks the rows in 32-row slabs: it stages the centered
// slices (x - mu) of its 64 I columns and 64 J columns in shared memory
// (centering before the product, as the oracle does) and each of its 256
// threads accumulates a 4 x 4 patch with FP64 FMA.  The epilogue divides by
// n_true after the sum, masks, writes vals and reduces the count and both
// maxima over the block with warp shuffles; blocks of one pair combine with
// atomics (atomicAdd for the count; atomicMax on the int64 bit patterns for
// the maxima, which orders non-negative doubles as numbers — fabs never
// yields -0.0, and an all-masked tile leaves the zero the wrapper wrote).

#include <cuda_runtime.h>

namespace {

constexpr int kSub = 64;      // output sub-tile edge
constexpr int kSlab = 32;     // rows staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
covgram_screen_kernel(const double* __restrict__ x,
                      const double* __restrict__ mu,
                      const int* __restrict__ i_idx,
                      const int* __restrict__ j_idx,
                      double* __restrict__ vals, int* __restrict__ counts,
                      long long* __restrict__ stats, int N, int P, int bp,
                      int n_true, int p_true, double lam, int sub_per_row) {
  __shared__ double As[kSlab][kSub];
  __shared__ double Bs[kSlab][kSub];
  __shared__ int cnt_s[kWarps];
  __shared__ double m0_s[kWarps];
  __shared__ double m1_s[kWarps];

  const int t = blockIdx.x;  // tile pair
  const int r0 = (blockIdx.y / sub_per_row) * kSub;  // rows within tile I
  const int c0 = (blockIdx.y % sub_per_row) * kSub;  // cols within tile J
  const long long baseI = (long long)i_idx[t] * bp;
  const long long baseJ = (long long)j_idx[t] * bp;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  double acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[k][m] = 0.0;

  for (int k0 = 0; k0 < N; k0 += kSlab) {
    for (int e = threadIdx.x; e < kSlab * kSub; e += kThreads) {
      const int rr = e / kSub;
      const int cc = e % kSub;
      const long long row = k0 + rr;
      double a = 0.0, b = 0.0;
      if (row < N) {
        if (r0 + cc < bp) {
          const long long col = baseI + r0 + cc;
          a = x[row * P + col] - mu[col];
        }
        if (c0 + cc < bp) {
          const long long col = baseJ + c0 + cc;
          b = x[row * P + col] - mu[col];
        }
      }
      As[rr][cc] = a;
      Bs[rr][cc] = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kSlab; ++rr) {
      double av[4], bv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) av[k] = As[rr][ty + 16 * k];
#pragma unroll
      for (int m = 0; m < 4; ++m) bv[m] = Bs[rr][tx + 16 * m];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[k][m] = fma(av[k], bv[m], acc[k][m]);
    }
    __syncthreads();
  }

  int cnt = 0;
  double m0 = 0.0, m1 = 0.0;
  double* vt = vals + (long long)t * bp * bp;
  const double n = (double)n_true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = r0 + ty + 16 * k;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = c0 + tx + 16 * m;
      if (r < bp && c < bp) {
        const long long gr = baseI + r;
        const long long gc = baseJ + c;
        const double s = acc[k][m] / n;
        const double as = fabs(s);
        const bool valid = gr < p_true && gc < p_true && gr != gc;
        const bool edge = valid && as > lam;
        vt[(long long)r * bp + c] = edge ? s : 0.0;
        if (valid) {
          m0 = fmax(m0, as);
          if (!edge) m1 = fmax(m1, as);
        }
        cnt += edge ? 1 : 0;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    m0 = fmax(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmax(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    cnt_s[warp] = cnt;
    m0_s[warp] = m0;
    m1_s[warp] = m1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      cnt += cnt_s[w];
      m0 = fmax(m0, m0_s[w]);
      m1 = fmax(m1, m1_s[w]);
    }
    if (cnt) atomicAdd(counts + t, cnt);
    if (m0 > 0.0) atomicMax(stats + 2 * t, __double_as_longlong(m0));
    if (m1 > 0.0) atomicMax(stats + 2 * t + 1, __double_as_longlong(m1));
  }
}

}  // namespace

// x: (N, P) padded, mu: (P,), i_idx/j_idx: (npairs,) int32 tile indices;
// vals: (npairs, bp, bp); counts: (npairs,) int32 and stats: (npairs, 2)
// float64, both zero-filled by the caller.
extern "C" int covgram_screen_launch(const void* x, const void* mu,
                                     const void* i_idx, const void* j_idx,
                                     void* vals, void* counts, void* stats,
                                     int npairs, int N, int P, int bp,
                                     int n_true, int p_true, double lam,
                                     void* stream) {
  if (npairs <= 0 || bp <= 0) return 0;
  const int sub_per_row = (bp + kSub - 1) / kSub;
  const long long subs = (long long)sub_per_row * sub_per_row;
  if (subs > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)npairs, (unsigned)subs);
  covgram_screen_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)x, (const double*)mu, (const int*)i_idx,
      (const int*)j_idx, (double*)vals, (int*)counts, (long long*)stats, N, P,
      bp, n_true, p_true, lam, sub_per_row);
  return (int)cudaGetLastError();
}
