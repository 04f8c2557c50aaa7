// shard_prox: the fused prox tail of the ADMM solvers, float64.
//
// Replaces the TPU kernel src/repro/kernels/shard_prox/shard_prox.py
// (`_kernel`, launched by `fused_prox_pallas`), which ran over one (rl, b)
// row shard with a sequential grid of row tiles, carrying both residual
// sums in one (1, 2) output block from grid step to grid step.  Here one
// launch covers N lanes of `entries` values each (the sharded solver's one
// (bp, bp) shard, or the dense ADMM's (N, b, b) bucket), each lane with its
// own threshold t.
//
// Computes, per lane n and entry e:
//     a      = x_new + u
//     z_new  = sign(a) * max(|a| - t[n], 0)
//     u_new  = a - z_new
// and per lane rp2 = sum (x_new - z_new)^2, rd2 = sum (z_new - z_old)^2.
// z_new and u_new equal the plain PyTorch version bit for bit; the squares
// are explicitly rounded (__dmul_rn) and added with __dadd_rn so nothing
// contracts into a fused multiply-add, and only the order of the sums
// differs from the plain version.
//
// Bound on the H100: memory.  A few flops an entry against 40 bytes (read
// x_new, u, z_old; write z_new, u_new), so the least time is 40 N entries
// bytes at 3.35 TB/s.  Design: one thread per entry, a block of 256
// consecutive entries of one lane, so every operand is read and written
// coalesced.  Hopper's blocks run in parallel and in no order, so the
// TPU's carried (1, 2) accumulator becomes per-block partials: warp
// shuffles, then the block's warps in order, into a per-(lane, block)
// buffer; a second kernel, one block per lane, has each thread sum a fixed
// stride of that lane's partials in order and then reduces the threads in
// a fixed tree.  No atomics: the sums decide the ADMM's convergence and are
// the same from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void block_sum2(double& p, double& d,
                                           double (*warp_sums)[2]) {
  for (int off = 16; off > 0; off >>= 1) {
    p += __shfl_down_sync(0xffffffffu, p, off);
    d += __shfl_down_sync(0xffffffffu, d, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    warp_sums[warp][0] = p;
    warp_sums[warp][1] = d;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    p = 0.0;
    d = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) {
      p += warp_sums[w][0];
      d += warp_sums[w][1];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    shard_prox_kernel(const double* __restrict__ x,
                      const double* __restrict__ u,
                      const double* __restrict__ z_old,
                      const double* __restrict__ t,
                      double* __restrict__ z_new, double* __restrict__ u_new,
                      double* __restrict__ partial, long long entries,
                      int tiles) {
  const int lane = blockIdx.x / tiles;
  const int tile = blockIdx.x - lane * tiles;
  const long long e = (long long)tile * kThreads + threadIdx.x;
  double rp = 0.0, rd = 0.0;
  if (e < entries) {
    const long long at = (long long)lane * entries + e;
    const double xv = x[at];
    const double a = xv + u[at];
    double m = fabs(a) - t[lane];
    m = m > 0.0 ? m : 0.0;
    // sign(a) * m: a * m keeps the sign of a zero and propagates a NaN
    const double z = a > 0.0 ? m : (a < 0.0 ? -m : a * m);
    z_new[at] = z;
    u_new[at] = a - z;
    const double dp = xv - z;
    const double dd = z - z_old[at];
    rp = __dmul_rn(dp, dp);
    rd = __dmul_rn(dd, dd);
  }
  __shared__ double warp_sums[kThreads / 32][2];
  block_sum2(rp, rd, warp_sums);
  if (threadIdx.x == 0) {
    partial[2 * (long long)blockIdx.x] = rp;
    partial[2 * (long long)blockIdx.x + 1] = rd;
  }
}

// acc[lane] = [rp2, rd2]: thread k sums partials k, k + 256, ... in order,
// then the threads reduce in a fixed tree
__global__ void __launch_bounds__(kThreads)
    shard_prox_sum_kernel(const double* __restrict__ partial,
                          double* __restrict__ acc, int tiles) {
  const int lane = blockIdx.x;
  const double* pl = partial + 2 * (long long)lane * tiles;
  double p = 0.0, d = 0.0;
  for (int k = threadIdx.x; k < tiles; k += kThreads) {
    p = __dadd_rn(p, pl[2 * k]);
    d = __dadd_rn(d, pl[2 * k + 1]);
  }
  __shared__ double warp_sums[kThreads / 32][2];
  block_sum2(p, d, warp_sums);
  if (threadIdx.x == 0) {
    acc[2 * lane] = p;
    acc[2 * lane + 1] = d;
  }
}

int tiles_for(long long entries) {
  return (int)((entries + kThreads - 1) / kThreads);
}

}  // namespace

// doubles of scratch the launcher needs for n lanes of `entries` values
extern "C" long long shard_prox_scratch_doubles(int n, long long entries) {
  return 2LL * n * tiles_for(entries);
}

extern "C" int shard_prox_launch(const void* x_new, const void* u,
                                 const void* z_old, const void* t, void* z_new,
                                 void* u_new, void* partial, void* acc, int n,
                                 long long entries, void* stream) {
  if (n <= 0 || entries <= 0) return 0;
  const long long tiles = (entries + kThreads - 1) / kThreads;
  const long long grid = (long long)n * tiles;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  shard_prox_kernel<<<(unsigned)grid, kThreads, 0, s>>>(
      (const double*)x_new, (const double*)u, (const double*)z_old,
      (const double*)t, (double*)z_new, (double*)u_new, (double*)partial,
      entries, (int)tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  shard_prox_sum_kernel<<<n, kThreads, 0, s>>>((const double*)partial,
                                               (double*)acc, (int)tiles);
  return (int)cudaGetLastError();
}
