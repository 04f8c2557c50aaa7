// threshold_cc: one fused threshold + min-label "hook" step of connected
// components over a dense (p, p) S, in S's own dtype (float32 or float64).
//
// Replaces the TPU kernel src/repro/kernels/threshold_cc/threshold_cc.py
// (`_kernel`, launched by `labelprop_step_pallas`).
//
// Computes, for every row i:
//     out_i = min(labels_i, min over j != i, j < p, |S_ij| > lam of labels_j)
// Ties |S_ij| == lam are not edges (strict eq. (4)).  Unlike the reference's
// wrapper, nothing is cast to float32: a float64 S is compared in float64.
//
// Bound on the H100: memory.  A step reads S once (p^2 elements) and does one
// compare per element, so the least time is p^2 * sizeof(T) at 3.35 TB/s.
// Design: one warp per row.  Lanes stride over the columns, so each warp
// load reads 32 neighbouring elements of the row (coalesced); a lane reads
// labels_j only where the predicate holds, so the label vector costs
// nothing on sparse rows and stays in cache on dense ones.  The row minimum
// is a warp-shuffle reduction; no shared memory, no padding (columns are
// masked by j < p, as the reference masks cols < p).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 rows per thread block

__device__ __forceinline__ float abs_of(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_of(double v) { return fabs(v); }

template <typename T>
__global__ void threshold_cc_step_kernel(const T* __restrict__ S,
                                         const int* __restrict__ labels,
                                         int* __restrict__ out, long long p,
                                         T lam) {
  const int lane = threadIdx.x & 31;
  const long long i =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (i >= p) return;  // the whole warp leaves together
  const T* row = S + i * p;
  int m = INT_MAX;
#pragma unroll 4
  for (long long j = lane; j < p; j += 32) {
    if (abs_of(row[j]) > lam && j != i) m = min(m, labels[j]);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[i] = min(labels[i], m);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  lam is rounded to S's dtype first, as a
// PyTorch comparison of a float32 tensor with a Python float rounds it.
extern "C" int threshold_cc_step_launch(const void* S, const void* labels,
                                        void* out, long long p, double lam,
                                        int dtype, void* stream) {
  if (p <= 0) return 0;
  const long long grid = (p + kThreads / 32 - 1) / (kThreads / 32);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    threshold_cc_step_kernel<float><<<(unsigned)grid, kThreads, 0, st>>>(
        (const float*)S, (const int*)labels, (int*)out, p, (float)lam);
  } else if (dtype == 1) {
    threshold_cc_step_kernel<double><<<(unsigned)grid, kThreads, 0, st>>>(
        (const double*)S, (const int*)labels, (int*)out, p, lam);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
