// flash_attention: blockwise online-softmax attention, causal or full, with
// grouped K/V heads (GQA), for float32 or bf16 q/k/v; float32 arithmetic
// and the output in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (`_kernel`, launched by `flash_attention_pallas`).  That kernel ran a grid
// (bh, iq, ik) whose innermost axis walked the key blocks in order, carrying
// the running (m, l, acc) of a query block in VMEM scratch from one grid
// step to the next.  Hopper's blocks run in parallel and in no order, so
// the walk over key blocks is a loop inside one block, with (m, l, acc) in
// registers.
//
// Computes, per query row (the reference's `_kernel`):
//   s   = (q . k) * scale over each key tile, float32;
//   s   = NEG_INF (-1e30) for keys at or past Skv and, when causal, for
//         kpos > qpos (aligned top-left: both count from 0);
//   m'  = max(m, max s);  p = exp(s - m');  alpha = exp(m - m');
//   l   = l alpha + sum p;  acc = acc alpha + p v;  m = m'  (m from NEG_INF);
//   out = acc / max(l, 1e-30), cast to q's dtype.
// With causal, key tiles wholly above the diagonal of the query block are
// skipped.  Query head bh reads K/V head bh / group, so no repeated K/V
// exists in memory.  Sq and Skv need not be multiples of the tiles: rows
// and keys past them are masked here, no padded copy exists.  bf16 input is
// upcast to float32 as it is staged.
//
// Bound on the H100: 4 B Hq Sq Skv d flops (halved when causal) at the
// float32 rate outside the tensor cores (67 TFLOP/s) for the float32
// instance, at the bf16 tensor-core rate (989 TFLOP/s) for bf16; the bytes
// of q, k, v and o at 3.35 TB/s are far below either at S = 2048, d = 128.
// This first kernel runs float32 FMAs for both instances, so bf16 is as
// slow as float32 (PERF.md); wgmma and TMA are later work.
//
// Design: one block of 128 threads per (bh, 64-row query block); the
// longest causal blocks are numbered first.  The query block is staged once
// in shared memory; each 64-key tile of K, then of V, is staged in one
// buffer after it (rows of pitch d + 1, so the column reads below hit
// distinct banks).  Thread (ty, tx), ty < 16, tx < 8, owns query rows
// 4 ty .. 4 ty + 3: it computes their scores against keys tx + 8 j (j < 8),
// a 4 x 8 register tile; the row max and row sum reduce over the 8 threads
// of the row group by warp shuffles, so every thread of the group holds the
// row's (m, l); p goes through shared memory, and the thread accumulates its
// rows' output columns tx + 8 j.  Shared memory: (2 * 64 (d + 1) + 64 * 65)
// floats, 82,688 bytes at d = 128, so two blocks fit an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows a block
constexpr int kBK = 64;                 // keys a tile
constexpr int kTX = 8;                  // threads of a row group
constexpr int kTY = 16;                 // row groups
constexpr int kRows = kBQ / kTY;        // 4 query rows a thread
constexpr int kKeys = kBK / kTX;        // 8 keys a thread
constexpr int kThreads = kTX * kTY;     // 128
constexpr int kPPitch = kBK + 1;        // padded row of the p tile
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBQ * kPPitch) * sizeof(float);
}

// rows r0 .. r0 + R - 1 of a (len, D) row-major matrix into tile[R][D + 1]
// as float32, zero past len
template <int D, int R, typename T>
__device__ __forceinline__ void stage(float* tile, const T* __restrict__ src,
                                      int r0, int len) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    tile[r * (D + 1) + c] =
        row < len ? to_f32(src[(long long)row * D + c]) : 0.0f;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int group, int sq, int skv, float scale,
                           int causal) {
  constexpr int kPitch = D + 1;
  constexpr int kDims = (D + kTX - 1) / kTX;  // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBQ][kPitch]
  float* KVs = Qs + kBQ * kPitch;     // [kBK][kPitch]: the tile's K, then V
  float* Ps = KVs + kBK * kPitch;     // [kBQ][kPPitch]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qh = q + (long long)bh * sq * D;
  const T* kh = k + (long long)(bh / group) * skv * D;
  const T* vh = v + (long long)(bh / group) * skv * D;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int r_base = kRows * ty;

  stage<D, kBQ>(Qs, qh, q0, sq);

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.0f;
  }

  int nk = (skv + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the last tile's V reads (and the Q stage) are done
    stage<D, kBK>(KVs, kh, k0, skv);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(r_base + i) * kPitch + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = KVs[(tx + kTX * j) * kPitch + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r_base + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + tx + kTX * j;
        const bool keep = kpos < skv && (!causal || kpos <= qpos);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads of a row group are 8 consecutive lanes
#pragma unroll
      for (int w = 1; w < kTX; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(r_base + i) * kPPitch + tx + kTX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < kTX; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();  // every score read of K done, the p tile written
    stage<D, kBK>(KVs, vh, k0, skv);
    __syncthreads();

    const int keys = min(kBK, skv - k0);
#pragma unroll 4
    for (int j = 0; j < keys; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(r_base + i) * kPPitch + j];
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const int col = tx + kTX * c;
        if (D % kTX == 0 || col < D) {
          const float vv = KVs[j * kPitch + col];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r_base + i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + ((long long)bh * sq + row) * D;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int col = tx + kTX * c;
      if (D % kTX == 0 || col < D) store(out + col, acc[i][c] / den);
    }
  }
}

template <int D, typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int bh,
             int group, int sq, int skv, float scale, int causal,
             void* stream) {
  const size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)bh, (unsigned)((sq + kBQ - 1) / kBQ));
  flash_attention_kernel<D, T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, group, sq, skv, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int group, int sq, int skv, int d, float scale, int causal,
           void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (group <= 0 || skv < 0 || (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 4: return launch_d<4, T>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 8: return launch_d<8, T>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 16: return launch_d<16, T>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 32: return launch_d<32, T>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 64: return launch_d<64, T>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 128: return launch_d<128, T>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (bh, sq, d) row-major; k, v: (bh / group, skv, d) row-major; all
// float32.  d in {4, 8, 16, 32, 64, 128}.
extern "C" int flash_attention_launch_f32(const void* q, const void* k,
                                          const void* v, void* o, int bh,
                                          int group, int sq, int skv, int d,
                                          float scale, int causal,
                                          void* stream) {
  return launch<float>(q, k, v, o, bh, group, sq, skv, d, scale, causal, stream);
}

// the same layout in bf16, upcast per element as staged; o in bf16
extern "C" int flash_attention_launch_bf16(const void* q, const void* k,
                                           const void* v, void* o, int bh,
                                           int group, int sq, int skv, int d,
                                           float scale, int causal,
                                           void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, group, sq, skv, d, scale,
                               causal, stream);
}
