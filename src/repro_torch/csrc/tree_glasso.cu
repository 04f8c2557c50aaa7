// tree_glasso: batched closed-form forest glasso over a (B, b, b) stack, with
// a float64 and a float32 instance of one template body.
//
// Replaces the TPU kernel src/repro/kernels/tree_glasso/tree_glasso.py
// (`_kernel`, launched by `glasso_forest_pallas`).
//
// Computes, per block n with lam = lam[n], on the strict support
// |S_ij| > lam, i != j:
//     a_ij     = sign(S_ij) (|S_ij| - lam),   d_i = S_ii + lam
//     Theta_ij = -a_ij / (d_i d_j - a_ij^2)
//     Theta_ii = 1/d_i + sum_j a_ij^2 / (d_i (d_i d_j - a_ij^2))
// and Theta_ij = 0 off the support.
//
// Bound on the H100: memory.  The work is a few flops per element, so the
// least time is one read of S and one write of Theta, 2 B b^2 itemsize bytes at
// 3.35 TB/s.  Design: one program per (block, row tile) — for b <= 32 a
// program takes several whole blocks, above that a 32-row tile of one
// block.  The program loads the diagonal vector d of its blocks into shared
// memory once, so each S element is read once from device memory; rows are
// reduced by a group of G = min(32, next_pow2(b)) lanes with warp shuffles,
// so neighbouring lanes read neighbouring elements of a row.
//
// The elementwise formulas use explicitly rounded products (mul_rn:
// __dmul_rn / __fmul_rn) so that no multiply-add is contracted: each element
// then rounds exactly as the plain PyTorch version does in the same dtype;
// only the row sum's order differs.

#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;
// b <= kSmallB: a program covers whole blocks; above, a kRowTile-row tile.
constexpr int kSmallB = 32;
constexpr int kRowTile = 32;
// element count a small-b program aims for
constexpr int kSmallElems = 2048;

template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, width);
  return v;
}

template <typename T>
__global__ void tree_glasso_kernel(const T* __restrict__ S,
                                   const T* __restrict__ lam,
                                   T* __restrict__ out, int B, int b,
                                   int blocks_per_prog, int tiles_per_block,
                                   int G) {
  T* d_s = dynamic_smem<T>();
  const long long bb = (long long)b * b;

  // which blocks [n0, n1) and rows [r0, r1) this program covers
  int n0, n1, r0, r1;
  if (b <= kSmallB) {
    n0 = blockIdx.x * blocks_per_prog;
    n1 = min(B, n0 + blocks_per_prog);
    r0 = 0;
    r1 = b;
  } else {
    n0 = blockIdx.x / tiles_per_block;
    n1 = n0 + 1;
    r0 = (blockIdx.x % tiles_per_block) * kRowTile;
    r1 = min(b, r0 + kRowTile);
  }
  const int nblk = n1 - n0;

  // d = diag(S) + lam for every covered block, read once
  for (int t = threadIdx.x; t < nblk * b; t += blockDim.x) {
    const int nn = n0 + t / b;
    const int i = t % b;
    d_s[t] = S[nn * bb + (long long)i * b + i] + lam[nn];
  }
  __syncthreads();

  const int rows = r1 - r0;
  const int total = nblk * rows;
  const int n_groups = blockDim.x / G;
  const int group = threadIdx.x / G;
  const int lg = threadIdx.x % G;

  // uniform trip count across the block: every lane reaches the shuffles
  for (int t0 = 0; t0 < total; t0 += n_groups) {
    const int t = t0 + group;
    const bool valid = t < total;
    T part = T(0);
    int nn = 0, i = 0;
    if (valid) {
      const int k = t / rows;
      nn = n0 + k;
      i = r0 + t % rows;
      const T lm = lam[nn];
      const T* dk = d_s + k * b;
      const T di = dk[i];
      const T* srow = S + nn * bb + (long long)i * b;
      T* orow = out + nn * bb + (long long)i * b;
      for (int j = lg; j < b; j += G) {
        if (j == i) continue;
        const T s = srow[j];
        const T abss = abs_t(s);
        T theta = T(0);
        if (abss > lm) {
          const T m = abss - lm;
          const T a = s > T(0) ? m : -m;
          const T aa = mul_rn(a, a);
          const T den = sub_rn(mul_rn(di, dk[j]), aa);
          theta = -a / den;
          part += aa / mul_rn(di, den);
        }
        orow[j] = theta;
      }
    }
    const T sum = group_sum(part, G);
    if (valid && lg == 0) {
      const T di = d_s[(nn - n0) * b + i];
      out[nn * bb + (long long)i * b + i] = T(1) / di + sum;
    }
  }
}

template <typename T>
int launch(const void* S, const void* lam, void* out, int B, int b,
           void* stream) {
  if (B <= 0 || b <= 0) return 0;
  int blocks_per_prog = 1, tiles_per_block = 1, G = 32;
  long long grid;
  size_t smem;
  if (b <= kSmallB) {
    blocks_per_prog = kSmallElems / (b * b);
    if (blocks_per_prog < 1) blocks_per_prog = 1;
    G = 1;
    while (G < b) G <<= 1;
    grid = (B + blocks_per_prog - 1) / blocks_per_prog;
    smem = sizeof(T) * (size_t)blocks_per_prog * b;
  } else {
    tiles_per_block = (b + kRowTile - 1) / kRowTile;
    grid = (long long)B * tiles_per_block;
    smem = sizeof(T) * (size_t)b;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tree_glasso_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tree_glasso_kernel<T><<<(unsigned)grid, kThreads, smem,
                          (cudaStream_t)stream>>>(
      (const T*)S, (const T*)lam, (T*)out, B, b, blocks_per_prog,
      tiles_per_block, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tree_glasso_launch_f64(const void* S, const void* lam, void* out,
                                      int B, int b, void* stream) {
  return launch<double>(S, lam, out, B, b, stream);
}

extern "C" int tree_glasso_launch_f32(const void* S, const void* lam, void* out,
                                      int B, int b, void* stream) {
  return launch<float>(S, lam, out, B, b, stream);
}
