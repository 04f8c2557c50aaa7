// threshold_cc: one fused threshold + min-label "hook" step of connected
// components over a row slab of a dense (pp, pp) S, in S's own dtype
// (float32 or float64).
//
// Replaces the TPU kernel src/repro/kernels/threshold_cc/threshold_cc.py
// (`_kernel`, launched by `labelprop_step_pallas`), and the row-local hook of
// the reference's sharded screen (src/repro/core/distributed.py,
// `distributed_components`: each device's masked min-reduce over its own
// rows).
//
// Computes, for every slab row r < rows, global row i = row0 + r:
//     out_r = min(labels_i, min over j != i, j < pp, |S_rj| > lam of labels_j)
// where the slab holds S's rows [row0, row0 + rows) as a (rows, pp) matrix
// and `labels` is the full (pp,) label vector.  The square step is the
// row0 = 0, rows = pp case.  Ties |S_ij| == lam are not edges (strict
// eq. (4)).  Unlike the reference's wrapper, nothing is cast to float32: a
// float64 S is compared in float64.
//
// Bound on the H100: memory.  A step reads the slab once (rows * pp
// elements) and does one compare per element, so the least time is
// rows * pp * sizeof(T) at 3.35 TB/s.  Design: one warp per row.  Lanes
// stride over the columns, so each warp load reads 32 neighbouring elements
// of the row (coalesced); a lane reads labels_j only where the predicate
// holds, so the label vector costs nothing on sparse rows and stays in cache
// on dense ones.  The row minimum is a warp-shuffle reduction; no shared
// memory, no padding (columns are masked by j < pp, as the reference masks
// cols < p).  The diagonal is masked by global row (j != row0 + r), as the
// sharded screen masks it.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 rows per thread block

__device__ __forceinline__ float abs_of(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_of(double v) { return fabs(v); }

template <typename T>
__global__ void threshold_cc_rows_kernel(const T* __restrict__ S,
                                         const int* __restrict__ labels,
                                         int* __restrict__ out, long long rows,
                                         long long pp, long long row0, T lam) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp leaves together
  const long long i = row0 + r;
  const T* row = S + r * pp;
  int m = INT_MAX;
#pragma unroll 4
  for (long long j = lane; j < pp; j += 32) {
    if (abs_of(row[j]) > lam && j != i) m = min(m, labels[j]);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[r] = min(labels[i], m);
}

}  // namespace

// S: the (rows, pp) slab of rows [row0, row0 + rows), row-major; labels: the
// (pp,) int32 vector; out: (rows,) int32.  dtype: 0 = float32, 1 = float64.
// lam is rounded to S's dtype first, as a PyTorch comparison of a float32
// tensor with a Python float rounds it.
extern "C" int threshold_cc_rows_launch(const void* S, const void* labels,
                                        void* out, long long rows, long long pp,
                                        long long row0, double lam, int dtype,
                                        void* stream) {
  if (rows <= 0) return 0;
  if (row0 < 0 || row0 + rows > pp) return (int)cudaErrorInvalidValue;
  const long long grid = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    threshold_cc_rows_kernel<float><<<(unsigned)grid, kThreads, 0, st>>>(
        (const float*)S, (const int*)labels, (int*)out, rows, pp, row0,
        (float)lam);
  } else if (dtype == 1) {
    threshold_cc_rows_kernel<double><<<(unsigned)grid, kThreads, 0, st>>>(
        (const double*)S, (const int*)labels, (int*)out, rows, pp, row0, lam);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
