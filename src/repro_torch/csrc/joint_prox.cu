// joint_prox: the fused K-way prox step of the joint multi-class ADMM over a
// bucket of lanes, float64.
//
// Replaces the TPU kernel src/repro/kernels/joint_prox/joint_prox.py
// (`_kernel`, launched by `joint_prox_pallas`), which handled one (K, b, b)
// block per call; here one launch covers the (n, K, b, b) bucket stack, each
// lane with its own t = [lam1/rho, lam2/rho].
//
// Computes, per lane and entry (i, j), on the K class values:
//     a      = theta + u
//     z_new  = soft(a, t1)                          on the diagonal (i == j)
//            = group: v = soft(a, t1), v * max(1 - t2/||v||, 0)
//              fused: soft(tv_complete_prox(a, t2), t1)   off the diagonal
//     u_new  = a - z_new
// and per lane rp2 = sum (theta - z_new)^2, rd2 = sum (z_new - z_old)^2.
// The fused prox is the reference's sort-free sequence, operation for
// operation: stable ranks, order statistics, the shift a_(r) - t(2r-K+1),
// prefix sums, segment means num / length and the minimax isotonic fit
// y_r = max_{j<=r} min_{l>=r} mean(b_j..b_l), gathered back by rank.  Every
// product that the plain version rounds before an add is an explicitly
// rounded __dmul_rn here, so nothing contracts into a fused multiply-add.
//
// Bound on the H100: memory.  The work is O(K^2) flops per entry for
// K <= 16, so the least time is one read of theta, u, z_old and one write
// of z_new, u_new: 40 n K b^2 bytes at 3.35 TB/s.  Design: one thread per
// (lane, i, j) entry holds its K class values in registers (K is a template
// parameter, 1..16, so every per-class loop unrolls and no array index is
// dynamic); a block covers 256 consecutive entries of one lane, so each
// class plane is read and written coalesced along j.  Both residual
// partials are reduced per block with warp shuffles and shared memory into a
// per-(lane, block) buffer, and a second kernel sums each lane's partials in
// a fixed order: no atomics, so the sums, which decide convergence, are
// the same from run to run.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 16;

__device__ __forceinline__ double soft(double x, double t) {
  double m = fabs(x) - t;
  m = m > 0.0 ? m : 0.0;
  return x > 0.0 ? m : (x < 0.0 ? -m : 0.0);
}

// z = prox of t1*l1 + t2*l2 over the class vector a
template <int K>
__device__ __forceinline__ void group_prox(const double (&a)[K], double t1,
                                           double t2, double (&z)[K]) {
  double ss = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    z[k] = soft(a[k], t1);
    ss = __dadd_rn(ss, __dmul_rn(z[k], z[k]));
  }
  const double nrm = sqrt(ss);
  double scale = 0.0;
  if (nrm > 0.0) {
    scale = 1.0 - t2 / nrm;
    scale = scale > 0.0 ? scale : 0.0;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) z[k] = z[k] * scale;
}

// z = soft(prox of t2 * TV_complete, t1) over the class vector a
template <int K>
__device__ __forceinline__ void fused_prox(const double (&a)[K], double t1,
                                           double t2, double (&z)[K]) {
  if (K == 1) {
    z[0] = soft(a[0], t1);
    return;
  }
  // stable rank: #(strictly smaller) + #(equal with smaller class index)
  int rank[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int r = 0;
#pragma unroll
    for (int q = 0; q < K; ++q)
      r += (a[q] < a[k]) || (a[q] == a[k] && q < k);
    rank[k] = r;
  }
  // s[r] = a_(r) - t2 (2r - K + 1): the order statistics, shifted
  double s[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    double v = 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) v = rank[k] == r ? a[k] : v;
    s[r] = v - __dmul_rn(t2, (double)(2 * r - (K - 1)));
  }
  double prefix[K + 1];
  prefix[0] = 0.0;
#pragma unroll
  for (int r = 0; r < K; ++r) prefix[r + 1] = prefix[r] + s[r];
  // isotonic fit: y_r = max_{j<=r} min_{l>=r} (P[l+1] - P[j]) / (l - j + 1);
  // for each j, a running min over l from the top serves every r >= j
#pragma unroll
  for (int r = 0; r < K; ++r) s[r] = -CUDART_INF;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    double run = CUDART_INF;
#pragma unroll
    for (int r = K - 1; r >= j; --r) {
      const double m = (prefix[r + 1] - prefix[j]) / (double)(r - j + 1);
      run = m < run ? m : run;
      s[r] = run > s[r] ? run : s[r];
    }
  }
  // gather back by rank, then the l1 piece
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double y = 0.0;
#pragma unroll
    for (int r = 0; r < K; ++r) y = rank[k] == r ? s[r] : y;
    z[k] = soft(y, t1);
  }
}

template <int K, bool kFused>
__global__ void __launch_bounds__(kThreads)
    joint_prox_kernel(const double* __restrict__ theta,
                      const double* __restrict__ u,
                      const double* __restrict__ z_old,
                      const double* __restrict__ t,
                      double* __restrict__ z_new, double* __restrict__ u_new,
                      double* __restrict__ partial, int b, int tiles) {
  const int lane = blockIdx.x / tiles;
  const int tile = blockIdx.x - lane * tiles;
  const long long bb = (long long)b * b;
  const long long e = (long long)tile * kThreads + threadIdx.x;
  double rp = 0.0, rd = 0.0;
  if (e < bb) {
    const double t1 = t[2 * lane];
    const double t2 = t[2 * lane + 1];
    const long long base = (long long)lane * K * bb + e;
    double a[K], z[K];
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = theta[base + k * bb] + u[base + k * bb];
    const long long i = e / b;
    if (i == e - i * b) {  // diagonal: the l1 piece only
#pragma unroll
      for (int k = 0; k < K; ++k) z[k] = soft(a[k], t1);
    } else if (kFused) {
      fused_prox<K>(a, t1, t2, z);
    } else {
      group_prox<K>(a, t1, t2, z);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long at = base + k * bb;
      z_new[at] = z[k];
      u_new[at] = a[k] - z[k];
      const double dp = theta[at] - z[k];
      const double dd = z[k] - z_old[at];
      rp = __dadd_rn(rp, __dmul_rn(dp, dp));
      rd = __dadd_rn(rd, __dmul_rn(dd, dd));
    }
  }
  // block partials: shuffles within each warp, then the warps in order
  for (int off = 16; off > 0; off >>= 1) {
    rp += __shfl_down_sync(0xffffffffu, rp, off);
    rd += __shfl_down_sync(0xffffffffu, rd, off);
  }
  __shared__ double warp_sums[kThreads / 32][2];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    warp_sums[warp][0] = rp;
    warp_sums[warp][1] = rd;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double p = 0.0, d = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) {
      p += warp_sums[w][0];
      d += warp_sums[w][1];
    }
    partial[2 * (long long)blockIdx.x] = p;
    partial[2 * (long long)blockIdx.x + 1] = d;
  }
}

// acc[lane] = [rp2, rd2]: each lane's block partials summed in block order
__global__ void joint_prox_sum_kernel(const double* __restrict__ partial,
                                      double* __restrict__ acc, int n,
                                      int tiles) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const double* pl = partial + 2 * (long long)lane * tiles;
  double p = 0.0, d = 0.0;
  for (int k = 0; k < tiles; ++k) {
    p += pl[2 * k];
    d += pl[2 * k + 1];
  }
  acc[2 * lane] = p;
  acc[2 * lane + 1] = d;
}

template <int K>
void launch_k(bool fused, unsigned grid, cudaStream_t stream,
              const double* theta, const double* u, const double* z_old,
              const double* t, double* z_new, double* u_new, double* partial,
              int b, int tiles) {
  if (fused)
    joint_prox_kernel<K, true><<<grid, kThreads, 0, stream>>>(
        theta, u, z_old, t, z_new, u_new, partial, b, tiles);
  else
    joint_prox_kernel<K, false><<<grid, kThreads, 0, stream>>>(
        theta, u, z_old, t, z_new, u_new, partial, b, tiles);
}

int tiles_for(int b) {
  const long long bb = (long long)b * b;
  return (int)((bb + kThreads - 1) / kThreads);
}

}  // namespace

// doubles of scratch the launcher needs for n lanes of (b, b)
extern "C" long long joint_prox_scratch_doubles(int n, int b) {
  return 2LL * n * tiles_for(b);
}

extern "C" int joint_prox_launch(const void* theta, const void* u,
                                 const void* z_old, const void* t, void* z_new,
                                 void* u_new, void* partial, void* acc, int n,
                                 int K, int b, int fused, void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (K < 1 || K > kMaxClasses) return (int)cudaErrorInvalidValue;
  const int tiles = tiles_for(b);
  const long long grid = (long long)n * tiles;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const double* th = (const double*)theta;
  const double* uu = (const double*)u;
  const double* zo = (const double*)z_old;
  const double* tt = (const double*)t;
  double* zn = (double*)z_new;
  double* un = (double*)u_new;
  double* pt = (double*)partial;
  const bool f = fused != 0;
  const unsigned g = (unsigned)grid;
  switch (K) {
#define JOINT_PROX_CASE(KK) \
  case KK:                  \
    launch_k<KK>(f, g, s, th, uu, zo, tt, zn, un, pt, b, tiles); \
    break;
    JOINT_PROX_CASE(1) JOINT_PROX_CASE(2) JOINT_PROX_CASE(3)
    JOINT_PROX_CASE(4) JOINT_PROX_CASE(5) JOINT_PROX_CASE(6)
    JOINT_PROX_CASE(7) JOINT_PROX_CASE(8) JOINT_PROX_CASE(9)
    JOINT_PROX_CASE(10) JOINT_PROX_CASE(11) JOINT_PROX_CASE(12)
    JOINT_PROX_CASE(13) JOINT_PROX_CASE(14) JOINT_PROX_CASE(15)
    JOINT_PROX_CASE(16)
#undef JOINT_PROX_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  joint_prox_sum_kernel<<<(n + 127) / 128, 128, 0, s>>>(
      pt, (double*)acc, n, tiles);
  return (int)cudaGetLastError();
}
