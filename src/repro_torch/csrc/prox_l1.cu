// prox_l1: the proximal-gradient step of the batched `pg` solver, with a
// float64 and a float32 instance of one template body.
//
// Replaces the TPU kernel src/repro/kernels/prox_l1/prox_l1.py (`_kernel`,
// launched by `prox_step_pallas`), which took one scalar step t and lam as
// (1, 1) blocks; here one launch covers a (B, b, b) stack of blocks, each
// lane with its own t and lam (the port's batched line search tries a
// different step per lane).
//
// Computes, per lane n and entry e of its (b, b) block:
//     z   = theta - t[n] * grad
//     out = sign(z) * max(|z| - t[n] * lam[n], 0)
// Both products are explicitly rounded (mul_rn: __dmul_rn / __fmul_rn) and
// the difference too (sub_rn), so nothing contracts into a fused
// multiply-add: the kernel equals the plain PyTorch version bit for bit in
// either dtype, sign(0) = 0 included.
//
// Bound on the H100: memory.  Three flops an entry against 3 itemsize bytes
// (read theta and grad, write out), so the least time is 3 B b^2 itemsize
// bytes at 3.35 TB/s.  Design: one thread per entry over the flattened stack, so
// neighbouring threads touch neighbouring addresses of every operand
// (coalesced along the last axis); a block of 256 threads covers 256
// consecutive entries, t and lam are read per entry from the (B,) vectors
// (one cached load per warp when the warp lies in one lane).

#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    prox_l1_kernel(const T* __restrict__ theta, const T* __restrict__ grad,
                   const T* __restrict__ t, const T* __restrict__ lam,
                   T* __restrict__ out, long long bb, long long total) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long lane = e / bb;
  const T tl = t[lane];
  const T z = sub_rn(theta[e], mul_rn(tl, grad[e]));
  const T thr = mul_rn(tl, lam[lane]);
  T m = abs_t(z) - thr;
  m = m > T(0) ? m : T(0);
  // sign(z) * m: z * m keeps the sign of a zero and propagates a NaN
  out[e] = z > T(0) ? m : (z < T(0) ? -m : z * m);
}

template <typename T>
int launch(const void* theta, const void* grad, const void* t,
           const void* lam, void* out, int B, int b, void* stream) {
  if (B <= 0 || b <= 0) return 0;
  const long long bb = (long long)b * b;
  const long long total = bb * B;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  prox_l1_kernel<T><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)theta, (const T*)grad, (const T*)t, (const T*)lam, (T*)out,
      bb, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prox_l1_launch_f64(const void* theta, const void* grad,
                                  const void* t, const void* lam, void* out,
                                  int B, int b, void* stream) {
  return launch<double>(theta, grad, t, lam, out, B, b, stream);
}

extern "C" int prox_l1_launch_f32(const void* theta, const void* grad,
                                  const void* t, const void* lam, void* out,
                                  int B, int b, void* stream) {
  return launch<float>(theta, grad, t, lam, out, B, b, stream);
}
