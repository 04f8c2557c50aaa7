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
// matvec, far below the FP64 and FP32 rates.  What bounds a lane is its serial chain:
// every coordinate update needs the dot product with the previous update's
// result, so a lane runs sweeps x b x (cd sweeps) x b dependent steps, each
// a length-b dot product and a reduction.
//
// Design: one thread block of one warp per lane.  The dot product of a
// coordinate update is spread over the 32 lanes and reduced with xor
// shuffles — every lane ends with the bitwise same sum (each butterfly step
// adds the same two values in either order), so all lanes take the same
// branches and no block-wide barrier sits on the serial chain.  Each lane
// leaves its own sweep loop when it converges.  For b <= 84 (every
// power-of-two bucket up to 64) the four (b, b) tiles S, W, B^T and W_old
// live in shared memory with a row pitch of b + 1 (row-strided lane
// accesses hit distinct banks; float32 fits b <= 119); above that they live
// in per-lane device scratch the wrapper allocates, and only the beta and
// result vectors stay in shared memory.  B is kept transposed so beta_j is a
// contiguous row.
//
// Scalar formulas round each product explicitly (mul_rn), as the plain
// PyTorch version does; dot products and the reductions sum in another
// order than the plain version, so results agree to rounding, not bitwise.

#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarp = 32;
// largest dynamic shared memory a block may opt in to on sm_90
constexpr size_t kMaxSmem = 232448;

// NaN-propagating max, as jnp.max / jnp.maximum
template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  return (b > a || b != b) ? b : a;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = pmax(v, __shfl_xor_sync(0xffffffffu, v, off));
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
  T* W;        // covariance iterate, pitch ld
  T* Bt;       // Bt[j, :] = beta of column j, pitch ld
  T* Wold;     // W at the start of the sweep, pitch ld
  T* beta;     // (b,) current column's coefficients
  T* vec;      // (b,) matvec result / t22
  int b, ld, lane;
  T lam, thr;
};

// Inner lasso (paper eq. (9)) on column j by cyclic coordinate descent,
// starting from beta (beta[j] already 0): one sweep always, then more while
// the sweep's largest update exceeds thr and fewer than n_cd ran.  Returns
// the number of sweeps run.
template <typename T>
__device__ int lasso_cd(const Lane<T>& L, int j, int n_cd) {
  const int b = L.b, ld = L.ld;
  int it = 0;
  T delta;
  do {
    delta = T(0);
    for (int k = 0; k < b; ++k) {
      const T* wk = L.W + (size_t)k * ld;
      T part = T(0);
      for (int m = L.lane; m < b; m += kWarp) part += wk[m] * L.beta[m];
      const T dot = warp_sum(part);
      const T bk = L.beta[k];
      const T wkk = wk[k];
      const T s12k = k == j ? T(0) : L.S[(size_t)k * ld + j];
      const T r = s12k - (dot - mul_rn(wkk, bk));
      const T nw = k == j ? T(0) : soft(r, L.lam) / wkk;
      delta = pmax(delta, abs_t(nw - bk));
      __syncwarp();
      if (L.lane == 0) L.beta[k] = nw;
      __syncwarp();
    }
    ++it;
  } while (delta > L.thr && it < n_cd);
  return it;
}

// One outer sweep over every column (Gauss-Seidel); returns max |W - W_old|
// and adds the inner sweeps it ran to cd_total.
template <typename T>
__device__ T sweep(const Lane<T>& L, int n_cd, bool node_screen,
                   long long& cd_total) {
  const int b = L.b, ld = L.ld, lane = L.lane;
  for (int i = 0; i < b; ++i)
    for (int m = lane; m < b; m += kWarp)
      L.Wold[(size_t)i * ld + m] = L.W[(size_t)i * ld + m];
  for (int j = 0; j < b; ++j) {
    // eq. (10) node screen: max_k!=j |S_kj| <= lam  =>  beta_j = 0
    T mx = T(0);
    for (int k = lane; k < b; k += kWarp)
      if (k != j) mx = pmax(mx, abs_t(L.S[(size_t)k * ld + j]));
    mx = warp_max(mx);
    const bool screened = node_screen && mx <= L.lam;
    for (int k = lane; k < b; k += kWarp)
      L.beta[k] = (screened || k == j) ? T(0) : L.Bt[(size_t)j * ld + k];
    __syncwarp();
    if (!screened) cd_total += lasso_cd(L, j, n_cd);
    // w12 = W beta with the W from before column j's update, one row a lane
    for (int i = lane; i < b; i += kWarp) {
      const T* wi = L.W + (size_t)i * ld;
      T acc = T(0);
      for (int m = 0; m < b; ++m) acc += wi[m] * L.beta[m];
      L.vec[i] = acc;
    }
    __syncwarp();
    for (int i = lane; i < b; i += kWarp) {
      if (i != j) {
        L.W[(size_t)i * ld + j] = L.vec[i];
        L.W[(size_t)j * ld + i] = L.vec[i];
      }
      L.Bt[(size_t)j * ld + i] = L.beta[i];
    }
    __syncwarp();
  }
  T delta = T(0);
  for (int i = 0; i < b; ++i)
    for (int m = lane; m < b; m += kWarp)
      delta = pmax(delta, abs_t(L.W[(size_t)i * ld + m] -
                                L.Wold[(size_t)i * ld + m]));
  return warp_max(delta);
}

template <typename T>
__global__ void bucket_glasso_kernel(
    const T* __restrict__ S_in, const T* __restrict__ lam_in,
    const T* __restrict__ scale_in, const T* __restrict__ W0,
    const T* __restrict__ T0, T* __restrict__ theta,
    int* __restrict__ sweeps_out, long long* __restrict__ cd_out,
    T* __restrict__ scratch, int b,
    int max_sweeps, int n_cd, double tol, int node_screen, int use_smem) {
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
  L.lam = lam_in[n];
  // tol * scale in the stack's dtype, as the plain version computes it
  L.thr = T(tol) * scale_in[n];
  if (use_smem) {
    L.ld = b + 1;
    const size_t tile = (size_t)b * L.ld;
    T* S_s = smem;
    L.W = S_s + tile;
    L.Bt = L.W + tile;
    L.Wold = L.Bt + tile;
    L.beta = L.Wold + tile;
    L.vec = L.beta + b;
    for (size_t e = lane; e < bb; e += kWarp)
      S_s[(e / b) * L.ld + e % b] = Sg[e];
    L.S = S_s;
  } else {
    L.ld = b;
    L.S = Sg;
    L.W = scratch + 3 * n * bb;
    L.Bt = L.W + bb;
    L.Wold = L.Bt + bb;
    L.beta = smem;
    L.vec = smem + b;
  }
  const int ld = L.ld;

  // W = diag(S) + lam on the diagonal, W0 off it;
  // B[i, j] = -T0[i, j] / d_j off the diagonal, d = diag(T0) (1 where <= 0)
  for (size_t e = lane; e < bb; e += kWarp) {
    const int i = (int)(e / b), j = (int)(e % b);
    if (i == j) {
      L.W[(size_t)i * ld + i] = Sg[e] + L.lam;
      L.Bt[(size_t)i * ld + i] = T(0);
    } else {
      T dj = T0g[(size_t)j * b + j];
      dj = dj > T(0) ? dj : T(1);
      L.W[(size_t)i * ld + j] = W0g[e];
      L.Bt[(size_t)j * ld + i] = -(T0g[e] / dj);
    }
  }
  __syncwarp();

  int it = 0;
  long long cd_total = 0;
  T delta;
  do {
    delta = sweep(L, n_cd, node_screen != 0, cd_total);
    ++it;
  } while (delta > L.thr && it < max_sweeps);

  // Theta column j: t22 = 1 / (W_jj - w12 . beta_j), col = -beta_j t22
  for (int j = 0; j < b; ++j) {
    T part = T(0);
    for (int m = lane; m < b; m += kWarp)
      if (m != j) part += L.W[(size_t)m * ld + j] * L.Bt[(size_t)j * ld + m];
    const T dot = warp_sum(part);
    if (lane == 0) L.vec[j] = T(1) / (L.W[(size_t)j * ld + j] - dot);
  }
  __syncwarp();
  T* out = theta + n * bb;
  for (size_t e = lane; e < bb; e += kWarp) {
    const int i = (int)(e / b), j = (int)(e % b);
    T tij, tji;
    if (i == j) {
      tij = tji = L.vec[i];
    } else {
      tij = mul_rn(-L.Bt[(size_t)j * ld + i], L.vec[j]);
      tji = mul_rn(-L.Bt[(size_t)i * ld + j], L.vec[i]);
    }
    out[e] = T(0.5) * (tij + tji);
  }
  if (lane == 0) {
    sweeps_out[n] = it;
    if (cd_out != nullptr) cd_out[n] = cd_total;
  }
}

size_t smem_bytes(int b, size_t itemsize) {
  const size_t tiles = itemsize * (4 * (size_t)b * (b + 1) + 2 * (size_t)b);
  return tiles <= kMaxSmem ? tiles : 0;
}

template <typename T>
int launch(const void* S, const void* lam, const void* scale, const void* W0,
           const void* T0, void* theta, void* sweeps, void* cd_sweeps,
           void* scratch, int N, int b, int max_sweeps, int n_cd, double tol,
           int node_screen, void* stream) {
  if (N <= 0 || b <= 0) return 0;
  size_t smem = smem_bytes(b, sizeof(T));
  const int use_smem = smem > 0;
  if (!use_smem) smem = sizeof(T) * 2 * (size_t)b;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bucket_glasso_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bucket_glasso_kernel<T><<<N, kWarp, smem, (cudaStream_t)stream>>>(
      (const T*)S, (const T*)lam, (const T*)scale, (const T*)W0,
      (const T*)T0, (T*)theta, (int*)sweeps, (long long*)cd_sweeps,
      (T*)scratch, b, max_sweeps, n_cd, tol, node_screen, use_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one lane of `itemsize`-byte values, or 0 when its
// tiles go to device scratch.
extern "C" size_t bucket_glasso_smem_bytes(int b, int itemsize) {
  return smem_bytes(b, (size_t)itemsize);
}

// scratch: 3 N b^2 values, used only when bucket_glasso_smem_bytes is 0.
// cd_sweeps: null, or (N,) int64 receiving each lane's count of inner sweeps.
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
