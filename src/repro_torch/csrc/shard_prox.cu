// shard_prox: the fused prox tail of the ADMM solvers, with a float64 and a
// float32 instance of one template body (sums in the operands' dtype).
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
// are explicitly rounded (mul_rn) and added with add_rn so nothing
// contracts into a fused multiply-add, and only the order of the sums
// differs from the plain version.
//
// Bound on the H100: memory.  A few flops an entry against 5 itemsize bytes
// (read x_new, u, z_old; write z_new, u_new), so the least time is
// 5 N entries itemsize bytes at 3.35 TB/s.  Design: one thread per entry, a block of 256
// consecutive entries of one lane, so every operand is read and written
// coalesced.  Hopper's blocks run in parallel and in no order, so the
// TPU's carried (1, 2) accumulator becomes per-block partials: warp
// shuffles, then the block's warps in order, into a per-(lane, block)
// buffer; a second kernel, one block per lane, has each thread sum a fixed
// stride of that lane's partials in order and then reduces the threads in
// a fixed tree.  No atomics: the sums decide the ADMM's convergence and are
// the same from run to run.

#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void block_sum2(T& p, T& d, T (*warp_sums)[2]) {
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
    p = T(0);
    d = T(0);
    for (int w = 0; w < kThreads / 32; ++w) {
      p += warp_sums[w][0];
      d += warp_sums[w][1];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    shard_prox_kernel(const T* __restrict__ x, const T* __restrict__ u,
                      const T* __restrict__ z_old, const T* __restrict__ t,
                      T* __restrict__ z_new, T* __restrict__ u_new,
                      T* __restrict__ partial, long long entries, int tiles) {
  const int lane = blockIdx.x / tiles;
  const int tile = blockIdx.x - lane * tiles;
  const long long e = (long long)tile * kThreads + threadIdx.x;
  T rp = T(0), rd = T(0);
  if (e < entries) {
    const long long at = (long long)lane * entries + e;
    const T xv = x[at];
    const T a = xv + u[at];
    T m = abs_t(a) - t[lane];
    m = m > T(0) ? m : T(0);
    // sign(a) * m: a * m keeps the sign of a zero and propagates a NaN
    const T z = a > T(0) ? m : (a < T(0) ? -m : a * m);
    z_new[at] = z;
    u_new[at] = a - z;
    const T dp = xv - z;
    const T dd = z - z_old[at];
    rp = mul_rn(dp, dp);
    rd = mul_rn(dd, dd);
  }
  __shared__ T warp_sums[kThreads / 32][2];
  block_sum2(rp, rd, warp_sums);
  if (threadIdx.x == 0) {
    partial[2 * (long long)blockIdx.x] = rp;
    partial[2 * (long long)blockIdx.x + 1] = rd;
  }
}

// acc[lane] = [rp2, rd2]: thread k sums partials k, k + 256, ... in order,
// then the threads reduce in a fixed tree
template <typename T>
__global__ void __launch_bounds__(kThreads)
    shard_prox_sum_kernel(const T* __restrict__ partial, T* __restrict__ acc,
                          int tiles) {
  const int lane = blockIdx.x;
  const T* pl = partial + 2 * (long long)lane * tiles;
  T p = T(0), d = T(0);
  for (int k = threadIdx.x; k < tiles; k += kThreads) {
    p = add_rn(p, pl[2 * k]);
    d = add_rn(d, pl[2 * k + 1]);
  }
  __shared__ T warp_sums[kThreads / 32][2];
  block_sum2(p, d, warp_sums);
  if (threadIdx.x == 0) {
    acc[2 * lane] = p;
    acc[2 * lane + 1] = d;
  }
}

int tiles_for(long long entries) {
  return (int)((entries + kThreads - 1) / kThreads);
}

template <typename T>
int launch(const void* x_new, const void* u, const void* z_old, const void* t,
           void* z_new, void* u_new, void* partial, void* acc, int n,
           long long entries, void* stream) {
  if (n <= 0 || entries <= 0) return 0;
  const long long tiles = (entries + kThreads - 1) / kThreads;
  const long long grid = (long long)n * tiles;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  shard_prox_kernel<T><<<(unsigned)grid, kThreads, 0, s>>>(
      (const T*)x_new, (const T*)u, (const T*)z_old, (const T*)t, (T*)z_new,
      (T*)u_new, (T*)partial, entries, (int)tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  shard_prox_sum_kernel<T><<<n, kThreads, 0, s>>>((const T*)partial, (T*)acc,
                                                  (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// values of scratch (of the operands' dtype) the launcher needs for n lanes
// of `entries` values
extern "C" long long shard_prox_scratch_values(int n, long long entries) {
  return 2LL * n * tiles_for(entries);
}

extern "C" int shard_prox_launch_f64(const void* x_new, const void* u,
                                     const void* z_old, const void* t,
                                     void* z_new, void* u_new, void* partial,
                                     void* acc, int n, long long entries,
                                     void* stream) {
  return launch<double>(x_new, u, z_old, t, z_new, u_new, partial, acc, n,
                        entries, stream);
}

extern "C" int shard_prox_launch_f32(const void* x_new, const void* u,
                                     const void* z_old, const void* t,
                                     void* z_new, void* u_new, void* partial,
                                     void* acc, int n, long long entries,
                                     void* stream) {
  return launch<float>(x_new, u, z_old, t, z_new, u_new, partial, acc, n,
                       entries, stream);
}
