// joint_prox: the fused K-way prox step of the joint multi-class ADMM over a
// bucket of lanes, with a float64 and a float32 instance of one template
// body (every value and sum in the operands' dtype).
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
// rounded mul_rn here, so nothing contracts into a fused multiply-add.
//
// Bound on the H100: memory.  The work is O(K^2) flops per entry for
// moderate K, so the least time is one read of theta, u, z_old and one write
// of z_new, u_new: 5 n K b^2 itemsize bytes at 3.35 TB/s.
//
// Two shapes.  The register shape (K <= 16): one thread per (lane, i, j)
// entry holds its K class values in registers (K is a template parameter,
// 1..16, so every per-class loop unrolls and no array index is dynamic); a
// block covers 256 consecutive entries of one lane, so each class plane is
// read and written coalesced along j.  The shared-memory shape (any K, the
// wrapper picks it above 16): K is a runtime value, and each thread keeps
// its entry's class values, order statistics and prefix sums in shared
// memory, laid out slot-major ([slot][thread]) so a warp's accesses to one
// slot hit consecutive banks; a block covers 64 entries.  When even that
// does not fit a block's shared memory (K above 113 in float64, 226 in
// float32), the same layout lives in a per-block region of device scratch
// the wrapper allocates.  Both shapes run the same per-entry arithmetic in
// the same order, so their z_new and u_new agree bit for bit; only the
// residual sums group differently.  Both residual partials are reduced per
// block with warp shuffles and shared memory into a per-(lane, block)
// buffer.  A call is one launch: after writing its partials and a
// __threadfence(), a block takes a ticket from its lane's counter, and the
// block that takes the lane's last ticket sums the lane's partials one by
// one in block order (the order of the second kernel that did it before),
// writes rp2 and rd2 and resets the counter to 0 for the next call.  The
// atomic only counts; no value is added atomically, so the sums, which
// decide convergence, are the same from run to run.  The partials, the work
// region and the counters are the wrapper's cached scratch (the counters
// zeroed once, when allocated).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "precision.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;      // register shape: entries per block
constexpr int kSmemThreads = 64;   // shared-memory shape: entries per block
constexpr int kMaxClasses = 16;    // register shape: largest K
// largest dynamic shared memory a block may opt in to on sm_90
constexpr size_t kMaxSmem = 232448;

template <typename T>
__device__ __forceinline__ T inf_t();
template <>
__device__ __forceinline__ double inf_t<double>() { return CUDART_INF; }
template <>
__device__ __forceinline__ float inf_t<float>() { return CUDART_INF_F; }

template <typename T>
__device__ __forceinline__ T soft(T x, T t) {
  T m = abs_t(x) - t;
  m = m > T(0) ? m : T(0);
  return x > T(0) ? m : (x < T(0) ? -m : T(0));
}

// z = prox of t1*l1 + t2*l2 over the class vector a
template <typename T, int K>
__device__ __forceinline__ void group_prox(const T (&a)[K], T t1, T t2,
                                           T (&z)[K]) {
  T ss = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    z[k] = soft(a[k], t1);
    ss = add_rn(ss, mul_rn(z[k], z[k]));
  }
  const T nrm = sqrt_t(ss);
  T scale = T(0);
  if (nrm > T(0)) {
    scale = T(1) - t2 / nrm;
    scale = scale > T(0) ? scale : T(0);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) z[k] = z[k] * scale;
}

// z = soft(prox of t2 * TV_complete, t1) over the class vector a
template <typename T, int K>
__device__ __forceinline__ void fused_prox(const T (&a)[K], T t1, T t2,
                                           T (&z)[K]) {
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
  T s[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    T v = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) v = rank[k] == r ? a[k] : v;
    s[r] = v - mul_rn(t2, (T)(2 * r - (K - 1)));
  }
  T prefix[K + 1];
  prefix[0] = T(0);
#pragma unroll
  for (int r = 0; r < K; ++r) prefix[r + 1] = prefix[r] + s[r];
  // isotonic fit: y_r = max_{j<=r} min_{l>=r} (P[l+1] - P[j]) / (l - j + 1);
  // for each j, a running min over l from the top serves every r >= j
#pragma unroll
  for (int r = 0; r < K; ++r) s[r] = -inf_t<T>();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T run = inf_t<T>();
#pragma unroll
    for (int r = K - 1; r >= j; --r) {
      const T m = (prefix[r + 1] - prefix[j]) / (T)(r - j + 1);
      run = m < run ? m : run;
      s[r] = run > s[r] ? run : s[r];
    }
  }
  // gather back by rank, then the l1 piece
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T y = T(0);
#pragma unroll
    for (int r = 0; r < K; ++r) y = rank[k] == r ? s[r] : y;
    z[k] = soft(y, t1);
  }
}

// a block's two partial sums, warps in order, into partial[blockIdx.x];
// the lane's last block (by ticket) then sums the lane's `tiles` partials in
// block order into rp2[lane], rd2[lane] and resets the lane's counter
template <typename T, int NT>
__device__ __forceinline__ void block_partials(T rp, T rd, T* __restrict__ partial,
                                               int lane, int tiles, T* __restrict__ rp2,
                                               T* __restrict__ rd2,
                                               unsigned int* __restrict__ tickets) {
  for (int off = 16; off > 0; off >>= 1) {
    rp += __shfl_down_sync(0xffffffffu, rp, off);
    rd += __shfl_down_sync(0xffffffffu, rd, off);
  }
  __shared__ T warp_sums[NT / 32][2];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    warp_sums[warp][0] = rp;
    warp_sums[warp][1] = rd;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T p = T(0), d = T(0);
    for (int w = 0; w < NT / 32; ++w) {
      p += warp_sums[w][0];
      d += warp_sums[w][1];
    }
    partial[2 * (long long)blockIdx.x] = p;
    partial[2 * (long long)blockIdx.x + 1] = d;
    __threadfence();  // the partials are visible before the ticket is taken
    if (atomicAdd(&tickets[lane], 1u) == (unsigned int)(tiles - 1)) {
      __threadfence();
      // read past L1: other blocks wrote them
      const T* pl = partial + 2 * (long long)lane * tiles;
      T sp = T(0), sd = T(0);
      for (int k = 0; k < tiles; ++k) {
        sp += __ldcg(pl + 2 * k);
        sd += __ldcg(pl + 2 * k + 1);
      }
      rp2[lane] = sp;
      rd2[lane] = sd;
      tickets[lane] = 0u;
    }
  }
}

template <typename T, int K, bool kFused>
__global__ void __launch_bounds__(kThreads)
    joint_prox_kernel(const T* __restrict__ theta, const T* __restrict__ u,
                      const T* __restrict__ z_old, const T* __restrict__ t,
                      T* __restrict__ z_new, T* __restrict__ u_new,
                      T* __restrict__ rp2, T* __restrict__ rd2,
                      T* __restrict__ partial, unsigned int* __restrict__ tickets,
                      int b, int tiles) {
  const int lane = blockIdx.x / tiles;
  const int tile = blockIdx.x - lane * tiles;
  const long long bb = (long long)b * b;
  const long long e = (long long)tile * kThreads + threadIdx.x;
  T rp = T(0), rd = T(0);
  if (e < bb) {
    const T t1 = t[2 * lane];
    const T t2 = t[2 * lane + 1];
    const long long base = (long long)lane * K * bb + e;
    T a[K], z[K];
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = theta[base + k * bb] + u[base + k * bb];
    const long long i = e / b;
    if (i == e - i * b) {  // diagonal: the l1 piece only
#pragma unroll
      for (int k = 0; k < K; ++k) z[k] = soft(a[k], t1);
    } else if (kFused) {
      fused_prox<T, K>(a, t1, t2, z);
    } else {
      group_prox<T, K>(a, t1, t2, z);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long at = base + k * bb;
      z_new[at] = z[k];
      u_new[at] = a[k] - z[k];
      const T dp = theta[at] - z[k];
      const T dd = z[k] - z_old[at];
      rp = add_rn(rp, mul_rn(dp, dp));
      rd = add_rn(rd, mul_rn(dd, dd));
    }
  }
  block_partials<T, kThreads>(rp, rd, partial, lane, tiles, rp2, rd2, tickets);
}

// values a thread of the shared-memory shape keeps: a[K], s[K] (the order
// statistics, then the isotonic fit), prefix[K + 1] and rank[K]
__host__ __device__ __forceinline__ long long work_slots(int K) {
  return 4LL * K + 1;
}

// The shared-memory shape: the arithmetic of joint_prox_kernel with K a
// runtime value and the per-entry arrays in `work` (slot-major).
template <typename T, bool kFused>
__global__ void __launch_bounds__(kSmemThreads)
    joint_prox_smem_kernel(const T* __restrict__ theta,
                           const T* __restrict__ u,
                           const T* __restrict__ z_old,
                           const T* __restrict__ t, T* __restrict__ z_new,
                           T* __restrict__ u_new, T* __restrict__ rp2,
                           T* __restrict__ rd2, T* __restrict__ partial,
                           unsigned int* __restrict__ tickets,
                           T* __restrict__ scratch, int K, int b, int tiles,
                           int use_smem) {
  constexpr int nt = kSmemThreads;
  T* work = use_smem ? dynamic_smem<T>()
                     : scratch + (long long)blockIdx.x * nt * work_slots(K);
  const int tid = threadIdx.x;
  T* a = work + tid;                     // a[k]      = a[k * nt]
  T* s = a + (long long)K * nt;          // s[r]      = s[r * nt]
  T* prefix = s + (long long)K * nt;     // prefix[r] = prefix[r * nt]
  T* rank = prefix + (long long)(K + 1) * nt;  // integer ranks, exact in T
  const int lane = blockIdx.x / tiles;
  const int tile = blockIdx.x - lane * tiles;
  const long long bb = (long long)b * b;
  const long long e = (long long)tile * nt + tid;
  T rp = T(0), rd = T(0);
  if (e < bb) {
    const T t1 = t[2 * lane];
    const T t2 = t[2 * lane + 1];
    const long long base = (long long)lane * K * bb + e;
    for (int k = 0; k < K; ++k)
      a[k * nt] = theta[base + k * bb] + u[base + k * bb];
    const long long i = e / b;
    const bool diag = i == e - i * b;
    T scale = T(0);
    if (diag || K == 1) {
      // the l1 piece only (K == 1: the fused prox is the identity first)
    } else if (kFused) {
      for (int k = 0; k < K; ++k) {
        const T ak = a[k * nt];
        int r = 0;
        for (int q = 0; q < K; ++q) {
          const T aq = a[q * nt];
          r += (aq < ak) || (aq == ak && q < k);
        }
        rank[k * nt] = (T)r;
        s[r * nt] = ak - mul_rn(t2, (T)(2 * r - (K - 1)));
      }
      prefix[0] = T(0);
      for (int r = 0; r < K; ++r)
        prefix[(r + 1) * nt] = prefix[r * nt] + s[r * nt];
      for (int r = 0; r < K; ++r) s[r * nt] = -inf_t<T>();
      for (int j = 0; j < K; ++j) {
        T run = inf_t<T>();
        const T pj = prefix[j * nt];
        for (int r = K - 1; r >= j; --r) {
          const T m = (prefix[(r + 1) * nt] - pj) / (T)(r - j + 1);
          run = m < run ? m : run;
          s[r * nt] = run > s[r * nt] ? run : s[r * nt];
        }
      }
    } else {
      T ss = T(0);
      for (int k = 0; k < K; ++k) {
        const T v = soft(a[k * nt], t1);
        ss = add_rn(ss, mul_rn(v, v));
      }
      const T nrm = sqrt_t(ss);
      if (nrm > T(0)) {
        scale = T(1) - t2 / nrm;
        scale = scale > T(0) ? scale : T(0);
      }
    }
    for (int k = 0; k < K; ++k) {
      const T ak = a[k * nt];
      T z;
      if (diag || K == 1)
        z = soft(ak, t1);
      else if (kFused)
        z = soft(s[(int)rank[k * nt] * nt], t1);
      else
        z = soft(ak, t1) * scale;
      const long long at = base + k * bb;
      z_new[at] = z;
      u_new[at] = ak - z;
      const T dp = theta[at] - z;
      const T dd = z - z_old[at];
      rp = add_rn(rp, mul_rn(dp, dp));
      rd = add_rn(rd, mul_rn(dd, dd));
    }
  }
  block_partials<T, nt>(rp, rd, partial, lane, tiles, rp2, rd2, tickets);
}

template <typename T, int K>
void launch_k(bool fused, unsigned grid, cudaStream_t stream, const T* theta,
              const T* u, const T* z_old, const T* t, T* z_new, T* u_new, T* rp2,
              T* rd2, T* partial, unsigned int* tickets, int b, int tiles) {
  if (fused)
    joint_prox_kernel<T, K, true><<<grid, kThreads, 0, stream>>>(
        theta, u, z_old, t, z_new, u_new, rp2, rd2, partial, tickets, b, tiles);
  else
    joint_prox_kernel<T, K, false><<<grid, kThreads, 0, stream>>>(
        theta, u, z_old, t, z_new, u_new, rp2, rd2, partial, tickets, b, tiles);
}

int tiles_for(int b, int per_block) {
  const long long bb = (long long)b * b;
  return (int)((bb + per_block - 1) / per_block);
}

size_t smem_bytes(int K, size_t itemsize) {
  return itemsize * (size_t)kSmemThreads * (size_t)work_slots(K);
}

// scratch values: the (n, tiles, 2) partials, then, for the shared-memory
// shape whose work arrays do not fit shared memory, one work region a block
long long scratch_values(int n, int K, int b, int smem_shape, size_t itemsize) {
  if (!smem_shape) return 2LL * n * tiles_for(b, kThreads);
  const long long tiles = tiles_for(b, kSmemThreads);
  long long v = 2LL * n * tiles;
  if (smem_bytes(K, itemsize) > kMaxSmem)
    v += (long long)n * tiles * kSmemThreads * work_slots(K);
  return v;
}

template <typename T>
int launch(const void* theta, const void* u, const void* z_old, const void* t,
           void* z_new, void* u_new, void* rp2, void* rd2, void* scratch,
           void* tickets, int n, int K, int b, int fused, int smem_shape,
           void* stream) {
  if (n <= 0 || b <= 0 || K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const T* th = (const T*)theta;
  const T* uu = (const T*)u;
  const T* zo = (const T*)z_old;
  const T* tt = (const T*)t;
  T* zn = (T*)z_new;
  T* un = (T*)u_new;
  T* r2p = (T*)rp2;
  T* r2d = (T*)rd2;
  T* pt = (T*)scratch;
  unsigned int* tk = (unsigned int*)tickets;
  const bool f = fused != 0;
  int tiles;
  if (smem_shape) {
    tiles = tiles_for(b, kSmemThreads);
    const long long grid = (long long)n * tiles;
    if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
    size_t smem = smem_bytes(K, sizeof(T));
    const int use_smem = smem <= kMaxSmem;
    if (!use_smem) smem = 0;
    T* work = pt + 2LL * n * tiles;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          f ? joint_prox_smem_kernel<T, true> : joint_prox_smem_kernel<T, false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    if (f)
      joint_prox_smem_kernel<T, true><<<(unsigned)grid, kSmemThreads, smem, s>>>(
          th, uu, zo, tt, zn, un, r2p, r2d, pt, tk, work, K, b, tiles, use_smem);
    else
      joint_prox_smem_kernel<T, false><<<(unsigned)grid, kSmemThreads, smem, s>>>(
          th, uu, zo, tt, zn, un, r2p, r2d, pt, tk, work, K, b, tiles, use_smem);
  } else {
    if (K > kMaxClasses) return (int)cudaErrorInvalidValue;
    tiles = tiles_for(b, kThreads);
    const long long grid = (long long)n * tiles;
    if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
    const unsigned g = (unsigned)grid;
    switch (K) {
#define JOINT_PROX_CASE(KK) \
  case KK:                  \
    launch_k<T, KK>(f, g, s, th, uu, zo, tt, zn, un, r2p, r2d, pt, tk, b, tiles); \
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
  }
  return (int)cudaGetLastError();
}

}  // namespace

// values of scratch (of the operands' dtype) the launcher needs for n lanes
// of (K, b, b) in the register (smem_shape 0) or shared-memory shape
extern "C" long long joint_prox_scratch_values(int n, int K, int b,
                                               int smem_shape, int itemsize) {
  return scratch_values(n, K, b, smem_shape, (size_t)itemsize);
}

// rp2, rd2: n values each.  scratch: joint_prox_scratch_values(...) values
// of the operands' dtype; tickets: n unsigned ints, all 0 on entry and left 0.
extern "C" int joint_prox_launch_f64(const void* theta, const void* u,
                                     const void* z_old, const void* t,
                                     void* z_new, void* u_new, void* rp2,
                                     void* rd2, void* scratch, void* tickets,
                                     int n, int K, int b, int fused,
                                     int smem_shape, void* stream) {
  return launch<double>(theta, u, z_old, t, z_new, u_new, rp2, rd2, scratch,
                        tickets, n, K, b, fused, smem_shape, stream);
}

extern "C" int joint_prox_launch_f32(const void* theta, const void* u,
                                     const void* z_old, const void* t,
                                     void* z_new, void* u_new, void* rp2,
                                     void* rd2, void* scratch, void* tickets,
                                     int n, int K, int b, int fused,
                                     int smem_shape, void* stream) {
  return launch<float>(theta, u, z_old, t, z_new, u_new, rp2, rd2, scratch,
                       tickets, n, K, b, fused, smem_shape, stream);
}
