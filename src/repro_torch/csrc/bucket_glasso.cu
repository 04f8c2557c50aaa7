// bucket_glasso: the whole BCD glasso solve of every lane of a (N, b, b)
// stack in one launch, with a float64 and a float32 instance of one template
// body (every value, sum and threshold in the stack's own dtype).
//
// Replaces the TPU kernel src/repro/kernels/bucket_glasso/bucket_glasso.py
// (`_make_kernel`, launched by `fused_bcd_pallas`), whose body is
// `ref.fused_bcd_single`: GLASSO block coordinate descent from a warm pair
// (W0, T0) with an injected convergence scale — outer row/column sweeps,
// the inner lasso coordinate descent, the eq.-(10) node screen, and the
// column-wise Theta recovery with a final 0.5 (Theta + Theta^T).
//
// Bound on the H100: neither bandwidth nor flops.  Inputs and outputs are
// 4 (b, b) tiles per lane, read or written once; the flops are about
// 2 b^2 per coordinate-descent sweep of one column plus 2 b^2 per column
// matvec, far below the FP64 and FP32 rates.  What bounds a lane is its
// serial chain: sweeps x b x (cd sweeps) x b coordinate updates, each
// needing the one before it.  The design makes the chain's links short and
// takes the coordinates that do not move out of it.
//
// Design: one thread block of one warp per lane; each lane leaves its own
// sweep loop when it converges.  Within one column's lasso W is constant,
// so the kernel carries g = W beta instead of forming each update's dot
// product afresh (covariance-update coordinate descent): lane l owns rows
// m = l + 32 c of g and beta, in registers for b <= 256 (the chunk count c
// is a template argument, so every index is known at compile time) and in
// shared memory above.  A coordinate whose beta is 0 and whose |r| <= lam
// stays 0 and leaves g as it is, so a step takes every row from the
// current position on at once: each lane computes r for the rows it owns,
// a ballot names the first coordinate k that moves, and only that one is
// updated.  Coordinate k takes r_k, beta_k and W_kk from their owner by
// `__shfl_sync`; every lane then computes soft(r, lam) / W_kk (a true
// division, skipped only where the result is exactly 0) and d = beta_k' -
// beta_k from the same bits, so all lanes take the same branches, and adds
// d W[m, k] to the g[m] it owns.  No reduction and no barrier sit on the
// chain, and a sweep costs one step per coordinate that moves; every value
// is the one the coordinate-by-coordinate order computes.  g is recomputed
// exactly at the start of every inner sweep (one row a lane, off the
// chain, as the column's w12 = W beta is), so rounding drift never
// outlasts a sweep.  W is read by row (W[m, k]), never transposed: a warm
// W0 need not be exactly symmetric.
//
// Shared memory, pitch b + 1 (row-strided lane accesses hit distinct
// banks): all four (b, b) tiles S, W, B^T and W_old for b <= 84 (float32
// b <= 119); W alone up to b = 168 (float32 239), with S read from the
// input and B^T and W_old in per-lane device scratch (they are read off the
// chain: the node screen, the column's start, the sweep's delta); above
// that W goes to device scratch too.  `smem_bytes` and `scratch_values`
// give the exact split.  Column j of S is copied to shared memory once, at
// the column's start.  B is kept transposed so beta_j is a contiguous row.
//
// Scalar formulas round each product explicitly (mul_rn), as the plain
// PyTorch version does; g's updates and sums take another order than the
// plain version's dot products, so results agree to rounding, not bitwise.

#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// largest dynamic shared memory a block may opt in to on sm_90
constexpr size_t kMaxSmem = 232448;
// rows a lane keeps in registers: b <= kWarp * kMaxChunks
constexpr int kMaxChunks = 8;

// NaN-propagating max, as jnp.max / jnp.maximum
template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  return (b > a || b != b) ? b : a;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = pmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// sign(x) * max(|x| - t, 0)
template <typename T>
__device__ __forceinline__ T soft(T x, T t) {
  const T m = pmax(T(0), abs_t(x) - t);
  return x > T(0) ? m : (x < T(0) ? -m : T(0) * m);
}

template <typename T>
struct Lane {
  const T* S;  // (b, b) input, pitch ld
  T* W;        // covariance iterate, pitch ldw
  T* Bt;       // Bt[j, :] = beta of column j, pitch ld
  T* Wold;     // W at the start of the sweep, pitch ld
  T* beta;     // (b,) shared: the column's beta, published for the matvec
  T* scol;     // (b,) shared: column j of S, 0 at j
  T* g;        // (b,) shared: g when a lane's rows are not in registers
  int b, ld, ldw, lane, chunks;
  T lam, thr;
};

// The rows m = lane + 32 c (c < chunks) of beta and g = W beta a lane
// owns, with the current column's s_m = S[m, j] (0 at m = j) and W_mm: in
// registers when NC > 0 (NC chunks), in shared memory when NC = 0.
template <typename T, int NC>
struct Owned {
  T g[NC], beta[NC], s[NC], wd[NC];
  __device__ __forceinline__ Owned(const Lane<T>&) {}
  __device__ __forceinline__ T& G(int c) { return g[c]; }
  __device__ __forceinline__ T& Beta(int c) { return beta[c]; }
  __device__ __forceinline__ T S(int c) const { return s[c]; }
  __device__ __forceinline__ T Wd(int c) const { return wd[c]; }
  // s and W_mm of the column (W is constant through its lasso)
  __device__ __forceinline__ void load_column(const Lane<T>& L) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int m = c * kWarp + L.lane;
      s[c] = m < L.b ? L.scol[m] : T(0);
      wd[c] = m < L.b ? L.W[(size_t)m * L.ldw + m] : T(1);
    }
  }
};

template <typename T>
struct Owned<T, 0> {
  T* gs;
  T* bs;
  const T* scol;
  const T* W;
  int lane, ldw;
  __device__ __forceinline__ Owned(const Lane<T>& L)
      : gs(L.g), bs(L.beta), scol(L.scol), W(L.W), lane(L.lane), ldw(L.ldw) {}
  __device__ __forceinline__ T& G(int c) { return gs[c * kWarp + lane]; }
  __device__ __forceinline__ T& Beta(int c) { return bs[c * kWarp + lane]; }
  __device__ __forceinline__ T S(int c) const { return scol[c * kWarp + lane]; }
  __device__ __forceinline__ T Wd(int c) const {
    const int m = c * kWarp + lane;
    return W[(size_t)m * ldw + m];
  }
  __device__ __forceinline__ void load_column(const Lane<T>&) {}
};

// g = W beta, exactly, for the rows a lane owns (one row a lane): beta is
// published to shared memory first.  A row's sum runs in kParts
// interleaved partial sums (independent FMA chains) when a lane owns fewer
// than four rows.
template <typename T, int NC>
__device__ void refresh(const Lane<T>& L, Owned<T, NC>& o) {
  const int b = L.b, lane = L.lane;
  __syncwarp();
  if constexpr (NC > 0) {
    constexpr int kParts = NC >= 4 ? 1 : (NC == 1 ? 4 : 2);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int m = c * kWarp + lane;
      if (m < b) L.beta[m] = o.Beta(c);
    }
    __syncwarp();
    T acc[kParts][NC];
#pragma unroll
    for (int q = 0; q < kParts; ++q)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[q][c] = T(0);
    int l = 0;
    for (; l + kParts <= b; l += kParts) {
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        const T bl = L.beta[l + q];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int m = c * kWarp + lane;
          if (m < b) acc[q][c] = fma_rn(L.W[(size_t)m * L.ldw + l + q], bl, acc[q][c]);
        }
      }
    }
    for (; l < b; ++l) {
      const T bl = L.beta[l];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int m = c * kWarp + lane;
        if (m < b) acc[0][c] = fma_rn(L.W[(size_t)m * L.ldw + l], bl, acc[0][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T sum = acc[0][c];
#pragma unroll
      for (int q = 1; q < kParts; ++q) sum += acc[q][c];
      o.G(c) = sum;
    }
  } else {
    for (int c = 0; c < L.chunks; ++c) {
      const int m = c * kWarp + lane;
      if (m < b) {
        T acc = T(0);
        for (int l = 0; l < b; ++l) acc = fma_rn(L.W[(size_t)m * L.ldw + l], L.beta[l], acc);
        o.G(c) = acc;
      }
    }
  }
}

// Inner lasso (paper eq. (9)) on column j by cyclic coordinate descent,
// starting from the owned beta (beta[j] already 0): one sweep always, then
// more while the sweep's largest update exceeds thr and fewer than n_cd
// ran.  Returns the number of sweeps run.
//
// A coordinate k with beta_k = 0 and |r_k| <= lam (over W_kk > 0), or k =
// j, keeps beta_k = 0 and leaves g as it is, so the coordinates after it
// see the same g.  Each step therefore takes every owned row m >= pos in
// one go, finds by ballot the first whose update is not exactly 0, and
// updates only that one: a sweep costs one step per coordinate that moves,
// and every value it computes is the one the coordinate-by-coordinate
// order computes.
template <typename T, int NC>
__device__ int lasso_cd(const Lane<T>& L, Owned<T, NC>& o, int j, int n_cd) {
  const int b = L.b, lane = L.lane, ldw = L.ldw;
  const int nc = NC > 0 ? NC : L.chunks;
  o.load_column(L);
  int it = 0;
  T delta;
  do {
    refresh(L, o);
    delta = T(0);
    int pos = 0;
    bool moved;
    do {
      moved = false;
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        if (moved || (c + 1) * kWarp <= pos) continue;
        const int m = c * kWarp + lane;
        T r = T(0), bm = T(0), wm = T(1);
        bool move = false;
        if (m >= pos && m < b && m != j) {
          bm = o.Beta(c);
          wm = o.Wd(c);
          r = o.S(c) - (o.G(c) - mul_rn(wm, bm));
          move = !(bm == T(0) && abs_t(r) <= L.lam && wm > T(0));
        }
        const unsigned ballot = __ballot_sync(kFull, move);
        if (ballot == 0u) continue;
        // coordinate k: r, beta_k and W_kk from its owner, then the new
        // beta_k and d = beta_k' - beta_k, the same bits in every lane
        moved = true;
        const int kk = __ffs(ballot) - 1;
        const int k = c * kWarp + kk;
        const T rk = __shfl_sync(kFull, r, kk);
        const T bk = __shfl_sync(kFull, bm, kk);
        const T wkk = __shfl_sync(kFull, wm, kk);
        // soft(r, lam) / W_kk, the division skipped only where the result
        // is exactly 0 (a NaN r takes it and propagates)
        T nw = T(0);
        if (!(abs_t(rk) <= L.lam && wkk > T(0))) nw = soft(rk, L.lam) / wkk;
        const T d = nw - bk;
        delta = pmax(delta, abs_t(d));
        if (lane == kk) o.Beta(c) = nw;
        // g += d W[:, k]
#pragma unroll
        for (int i = 0; i < nc; ++i) {
          const int mi = i * kWarp + lane;
          if (mi < b) o.G(i) = fma_rn(d, L.W[(size_t)mi * ldw + k], o.G(i));
        }
        pos = k + 1;
      }
    } while (moved && pos < b);
    ++it;
  } while (delta > L.thr && it < n_cd);
  return it;
}

// One outer sweep over every column (Gauss-Seidel); returns max |W - W_old|
// and adds the inner sweeps it ran to cd_total.
template <typename T, int NC>
__device__ T sweep(const Lane<T>& L, Owned<T, NC>& o, int n_cd, bool node_screen,
                   long long& cd_total) {
  const int b = L.b, ld = L.ld, ldw = L.ldw, lane = L.lane;
  const int nc = NC > 0 ? NC : L.chunks;
  for (int i = 0; i < b; ++i)
    for (int m = lane; m < b; m += kWarp)
      L.Wold[(size_t)i * ld + m] = L.W[(size_t)i * ldw + m];
  for (int j = 0; j < b; ++j) {
    // column j of S, once; eq. (10) node screen on it:
    // max_k!=j |S_kj| <= lam  =>  beta_j = 0
    T mx = T(0);
    for (int k = lane; k < b; k += kWarp) {
      const T s = k == j ? T(0) : L.S[(size_t)k * ld + j];
      L.scol[k] = s;
      mx = pmax(mx, abs_t(s));
    }
    mx = warp_max(mx);
    const bool screened = node_screen && mx <= L.lam;
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int m = c * kWarp + lane;
      const T v = (screened || m == j || m >= b) ? T(0) : L.Bt[(size_t)j * ld + m];
      if (NC > 0 || m < b) o.Beta(c) = v;
    }
    __syncwarp();
    if (!screened) cd_total += lasso_cd(L, o, j, n_cd);
    // w12 = W beta with the W from before column j's update
    refresh(L, o);
    __syncwarp();  // every row of W read before any lane writes
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int m = c * kWarp + lane;
      if (m < b) {
        if (m != j) {
          L.W[(size_t)m * ldw + j] = o.G(c);
          L.W[(size_t)j * ldw + m] = o.G(c);
        }
        L.Bt[(size_t)j * ld + m] = o.Beta(c);
      }
    }
    __syncwarp();
  }
  T delta = T(0);
  for (int i = 0; i < b; ++i)
    for (int m = lane; m < b; m += kWarp)
      delta = pmax(delta, abs_t(L.W[(size_t)i * ldw + m] - L.Wold[(size_t)i * ld + m]));
  return warp_max(delta);
}

// where a lane's tiles live: `shared` tiles in shared memory (4: S, W, B^T,
// W_old; 1: W; 0: none), `smem` bytes of shared memory, `scratch` values
// of device scratch
struct Layout {
  int shared;
  size_t smem;
  long long scratch;
};

Layout layout(int b, size_t itemsize) {
  const size_t tile = (size_t)b * (b + 1), vecs = 3 * (size_t)b;
  const long long bb = (long long)b * b;
  if (itemsize * (4 * tile + vecs) <= kMaxSmem) return {4, itemsize * (4 * tile + vecs), 0};
  if (itemsize * (tile + vecs) <= kMaxSmem) return {1, itemsize * (tile + vecs), 2 * bb};
  return {0, itemsize * vecs, 3 * bb};
}

template <typename T, int NC>
__global__ void bucket_glasso_kernel(
    const T* __restrict__ S_in, const T* __restrict__ lam_in,
    const T* __restrict__ scale_in, const T* __restrict__ W0,
    const T* __restrict__ T0, T* __restrict__ theta,
    int* __restrict__ sweeps_out, long long* __restrict__ cd_out,
    T* __restrict__ scratch, int b, int max_sweeps, int n_cd, double tol,
    int node_screen, int shared) {
  T* smem = dynamic_smem<T>();
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t bb = (size_t)b * b;
  const T* Sg = S_in + n * bb;
  const T* W0g = W0 + n * bb;
  const T* T0g = T0 + n * bb;

  Lane<T> L;
  L.b = b;
  L.lane = lane;
  L.chunks = (b + kWarp - 1) / kWarp;
  L.lam = lam_in[n];
  // tol * scale in the stack's dtype, as the plain version computes it
  L.thr = T(tol) * scale_in[n];
  const size_t tile = (size_t)b * (b + 1);
  T* vecs = smem + shared * tile;
  L.beta = vecs;
  L.scol = vecs + b;
  L.g = vecs + 2 * b;
  if (shared == 4) {
    T* S_s = smem;
    for (size_t e = lane; e < bb; e += kWarp) S_s[(e / b) * (b + 1) + e % b] = Sg[e];
    L.S = S_s;
    L.ld = L.ldw = b + 1;
    L.W = S_s + tile;
    L.Bt = L.W + tile;
    L.Wold = L.Bt + tile;
  } else {
    L.S = Sg;
    L.ld = b;
    T* own = scratch + (shared == 1 ? 2 : 3) * n * bb;
    if (shared == 1) {
      L.W = smem;
      L.ldw = b + 1;
    } else {
      L.W = own;
      own += bb;
      L.ldw = b;
    }
    L.Bt = own;
    L.Wold = own + bb;
  }
  const int ld = L.ld, ldw = L.ldw;

  // W = diag(S) + lam on the diagonal, W0 off it;
  // B[i, j] = -T0[i, j] / d_j off the diagonal, d = diag(T0) (1 where <= 0)
  for (size_t e = lane; e < bb; e += kWarp) {
    const int i = (int)(e / b), j = (int)(e % b);
    if (i == j) {
      L.W[(size_t)i * ldw + i] = Sg[e] + L.lam;
      L.Bt[(size_t)i * ld + i] = T(0);
    } else {
      T dj = T0g[(size_t)j * b + j];
      dj = dj > T(0) ? dj : T(1);
      L.W[(size_t)i * ldw + j] = W0g[e];
      L.Bt[(size_t)j * ld + i] = -(T0g[e] / dj);
    }
  }
  __syncwarp();

  Owned<T, NC> o(L);
  int it = 0;
  long long cd_total = 0;
  T delta;
  do {
    delta = sweep(L, o, n_cd, node_screen != 0, cd_total);
    ++it;
  } while (delta > L.thr && it < max_sweeps);

  // Theta column j: t22 = 1 / (W_jj - w12 . beta_j), col = -beta_j t22
  for (int j = 0; j < b; ++j) {
    T part = T(0);
    for (int m = lane; m < b; m += kWarp)
      if (m != j) part += L.W[(size_t)m * ldw + j] * L.Bt[(size_t)j * ld + m];
    const T dot = warp_sum(part);
    if (lane == 0) L.beta[j] = T(1) / (L.W[(size_t)j * ldw + j] - dot);
  }
  __syncwarp();
  T* out = theta + n * bb;
  for (size_t e = lane; e < bb; e += kWarp) {
    const int i = (int)(e / b), j = (int)(e % b);
    T tij, tji;
    if (i == j) {
      tij = tji = L.beta[i];
    } else {
      tij = mul_rn(-L.Bt[(size_t)j * ld + i], L.beta[j]);
      tji = mul_rn(-L.Bt[(size_t)i * ld + j], L.beta[i]);
    }
    out[e] = T(0.5) * (tij + tji);
  }
  if (lane == 0) {
    sweeps_out[n] = it;
    if (cd_out != nullptr) cd_out[n] = cd_total;
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*, T*, int*,
                        long long*, T*, int, int, int, double, int, int);

// the instance that keeps a lane's rows in registers (ceil(b / 32) chunks),
// or in shared memory above kMaxChunks chunks
template <typename T>
Kernel<T> instance_for(int b) {
  switch ((b + kWarp - 1) / kWarp) {
    case 1: return bucket_glasso_kernel<T, 1>;
    case 2: return bucket_glasso_kernel<T, 2>;
    case 3: return bucket_glasso_kernel<T, 3>;
    case 4: return bucket_glasso_kernel<T, 4>;
    case 5: return bucket_glasso_kernel<T, 5>;
    case 6: return bucket_glasso_kernel<T, 6>;
    case 7: return bucket_glasso_kernel<T, 7>;
    case 8: return bucket_glasso_kernel<T, kMaxChunks>;
    default: return bucket_glasso_kernel<T, 0>;
  }
}

template <typename T>
int launch(const void* S, const void* lam, const void* scale, const void* W0,
           const void* T0, void* theta, void* sweeps, void* cd_sweeps,
           void* scratch, int N, int b, int max_sweeps, int n_cd, double tol,
           int node_screen, void* stream) {
  if (N <= 0 || b <= 0) return 0;
  const Layout lay = layout(b, sizeof(T));
  if (lay.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const Kernel<T> kernel = instance_for<T>(b);
  if (lay.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<N, kWarp, lay.smem, (cudaStream_t)stream>>>(
      (const T*)S, (const T*)lam, (const T*)scale, (const T*)W0, (const T*)T0,
      (T*)theta, (int*)sweeps, (long long*)cd_sweeps, (T*)scratch, b, max_sweeps,
      n_cd, tol, node_screen, lay.shared);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one lane of `itemsize`-byte values.
extern "C" size_t bucket_glasso_smem_bytes(int b, int itemsize) {
  return layout(b, (size_t)itemsize).smem;
}

// Device scratch values one lane needs: 0 when its four tiles fit shared
// memory, 2 b^2 (B^T, W_old) when W alone does, else 3 b^2.
extern "C" long long bucket_glasso_scratch_values(int b, int itemsize) {
  return layout(b, (size_t)itemsize).scratch;
}

// scratch: N * bucket_glasso_scratch_values(b, itemsize) values (unused
// when that is 0).  cd_sweeps: null, or (N,) int64 receiving each lane's
// count of inner sweeps.
extern "C" int bucket_glasso_launch_f64(const void* S, const void* lam,
                                        const void* scale, const void* W0,
                                        const void* T0, void* theta,
                                        void* sweeps, void* cd_sweeps,
                                        void* scratch, int N, int b,
                                        int max_sweeps, int n_cd, double tol,
                                        int node_screen, void* stream) {
  return launch<double>(S, lam, scale, W0, T0, theta, sweeps, cd_sweeps,
                        scratch, N, b, max_sweeps, n_cd, tol, node_screen,
                        stream);
}

extern "C" int bucket_glasso_launch_f32(const void* S, const void* lam,
                                        const void* scale, const void* W0,
                                        const void* T0, void* theta,
                                        void* sweeps, void* cd_sweeps,
                                        void* scratch, int N, int b,
                                        int max_sweeps, int n_cd, double tol,
                                        int node_screen, void* stream) {
  return launch<float>(S, lam, scale, W0, T0, theta, sweeps, cd_sweeps,
                       scratch, N, b, max_sweeps, n_cd, tol, node_screen,
                       stream);
}
