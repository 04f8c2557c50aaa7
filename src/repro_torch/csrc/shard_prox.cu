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
// 5 N entries itemsize bytes at 3.35 TB/s.  Design: one thread per entry;
// 256 consecutive entries of one lane make a tile, so every operand is read
// and written coalesced.  Hopper's blocks run in parallel and in no order,
// so the TPU's carried (1, 2) accumulator becomes per-tile partials: warp
// shuffles, then the tile's 8 warps in order, into a per-(lane, tile)
// buffer.  One launch a call: just enough 256-thread blocks to fill the
// card once (the occupancy calculator's count: 8 an SM), each walking the
// tiles of its lane with a stride.  After writing its partials and a
// __threadfence(), a block takes a ticket from its lane's counter — one
// fence and one atomic a block, not a tile — and the block that takes the
// lane's last ticket sums that lane's partials (thread k takes partials k,
// k + 256, ... in order, then the same fixed tree), writes its rp2/rd2 and
// resets the counter to 0 for the next call.  The atomic only counts; no
// value is added atomically, so the sums are the same from run to run, and
// bit-identical to a 256-thread block a tile and a second kernel over the
// partials.  The threshold t is read through a pointer and a lane stride
// (0 for one value, 1 for per-lane values), or passed by value when the
// pointer is null, so the wrapper copies nothing; the partials and
// counters are the wrapper's cached scratch (the counters zeroed once, when
// allocated).

#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;      // a block, and the entries of a tile
constexpr int kBlocksPerSM = 8;    // 2048 threads an SM: 32 registers a thread

// the block's (p, d) summed in a fixed tree: warp shuffles, then the warps
// in order; thread 0 holds the sum
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
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    shard_prox_kernel(const T* __restrict__ x, const T* __restrict__ u,
                      const T* __restrict__ z_old, const T* __restrict__ t,
                      long long t_stride, T t_value, T* __restrict__ z_new,
                      T* __restrict__ u_new, T* __restrict__ rp2, T* __restrict__ rd2,
                      T* __restrict__ partial, unsigned int* __restrict__ tickets,
                      long long entries, int tiles, int blocks) {
  const int lane = blockIdx.x / blocks;
  const T tl = t != nullptr ? t[lane * t_stride] : t_value;
  T* pl = partial + 2 * (long long)lane * tiles;
  // two buffers, so a tile's warp sums never overwrite the last tile's
  // before thread 0 has read them
  __shared__ T warp_sums[2][kThreads / 32][2];
  __shared__ bool last;
  int parity = 0;
  for (int tile = blockIdx.x - lane * blocks; tile < tiles; tile += blocks) {
    const long long e = (long long)tile * kThreads + threadIdx.x;
    T rp = T(0), rd = T(0);
    if (e < entries) {
      const long long at = (long long)lane * entries + e;
      const T xv = x[at];
      const T a = xv + u[at];
      T m = abs_t(a) - tl;
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
    block_sum2(rp, rd, warp_sums[parity]);
    parity ^= 1;
    if (threadIdx.x == 0) {
      pl[2 * tile] = rp;
      pl[2 * tile + 1] = rd;
    }
  }
  if (threadIdx.x == 0) {
    __threadfence();  // the partials are visible before the ticket is taken
    last = atomicAdd(&tickets[lane], 1u) == (unsigned int)(blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // rp2[lane], rd2[lane]: thread k sums partials k, k + 256, ... in order
  // (read past L1: other blocks wrote them), then the fixed tree
  T p = T(0), d = T(0);
#pragma unroll 8
  for (int k = threadIdx.x; k < tiles; k += kThreads) {
    p = add_rn(p, __ldcg(pl + 2 * k));
    d = add_rn(d, __ldcg(pl + 2 * k + 1));
  }
  block_sum2(p, d, warp_sums[parity]);
  if (threadIdx.x == 0) {
    rp2[lane] = p;
    rd2[lane] = d;
    tickets[lane] = 0u;
  }
}

// resident blocks of the kernel the current device holds at once (SMs x
// blocks an SM, from the occupancy calculator), looked up once a device
template <typename T>
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shard_prox_kernel<T>,
                                                      kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <typename T>
int launch(const void* x_new, const void* u, const void* z_old, const void* t,
           long long t_stride, double t_value, void* z_new, void* u_new, void* rp2,
           void* rd2, void* partial, void* tickets, int n, long long entries,
           void* stream) {
  if (n <= 0 || entries <= 0) return 0;
  const long long tiles = (entries + kThreads - 1) / kThreads;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  // enough blocks to fill the card once, each walking its lane's tiles
  const int resident = resident_blocks<T>();
  if (resident <= 0) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorUnknown);
  }
  const long long fill = (resident + n - 1) / n;
  const long long blocks = tiles < fill ? tiles : fill;
  if ((long long)n * blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  shard_prox_kernel<T><<<(unsigned)(n * blocks), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x_new, (const T*)u, (const T*)z_old, (const T*)t, t_stride, (T)t_value,
      (T*)z_new, (T*)u_new, (T*)rp2, (T*)rd2, (T*)partial, (unsigned int*)tickets,
      entries, (int)tiles, (int)blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// n lanes of `entries` values each.  t: per-lane thresholds read at
// t[lane * t_stride], or t_value for every lane when t is null.  rp2, rd2:
// n values each.  partial:
// 2 n ceil(entries / 256) values of the operands' dtype; tickets: n
// unsigned ints, all 0 on entry and left 0.
extern "C" int shard_prox_launch_f64(const void* x_new, const void* u,
                                     const void* z_old, const void* t,
                                     long long t_stride, double t_value,
                                     void* z_new, void* u_new, void* rp2,
                                     void* rd2, void* partial, void* tickets,
                                     int n, long long entries, void* stream) {
  return launch<double>(x_new, u, z_old, t, t_stride, t_value, z_new, u_new, rp2,
                        rd2, partial, tickets, n, entries, stream);
}

extern "C" int shard_prox_launch_f32(const void* x_new, const void* u,
                                     const void* z_old, const void* t,
                                     long long t_stride, double t_value,
                                     void* z_new, void* u_new, void* rp2,
                                     void* rd2, void* partial, void* tickets,
                                     int n, long long entries, void* stream) {
  return launch<float>(x_new, u, z_old, t, t_stride, t_value, z_new, u_new, rp2,
                       rd2, partial, tickets, n, entries, stream);
}
