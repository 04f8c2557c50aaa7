// covgram_screen: fused centered-Gram tile + strict threshold + edge count +
// tile statistics, per scheduled tile pair, in float64 or float32 (one body
// each; the float32 body is described after the float64 one).
//
// Replaces the TPU kernel
// src/repro/kernels/covgram_screen/covgram_screen.py (`_kernel`, launched by
// `covgram_screen_pallas`).
//
// For each pair t with column tiles I = i_idx[t], J = j_idx[t] of width bp:
//     S_IJ      = (X_I - mu_I)' (X_J - mu_J) / n_true
//     valid_rc  = row < p_true && col < p_true && row != col   (global ids)
//     edge_rc   = valid_rc && |S_rc| > lam                     (strict, eq. 4)
//     vals[t]   = edge ? S : 0                                  (bp, bp)
//     counts[t] = number of edges
//     stats[t]  = [max valid |S|, max valid non-edge |S|]       (0 if none)
// Unlike the reference's wrapper, nothing is cast: the product, the
// threshold and the outputs are in X's dtype (float64 or float32), so on
// exactly representable data `vals` equals the oracle in that dtype bit for
// bit.
//
// Bound on the H100: the larger of the operations, 2 N bp^2 per pair at the
// FP64 tensor-core peak (67 TFLOP/s), and the bytes, vals written once plus
// X read once (3.35 TB/s); at n = 192 the two are of one order.
//
// Design.  The products run on the FP64 tensor cores (`mma.sync` on .f64
// operands; wgmma has no f64 form).  One block of 16 warps computes a
// 128 x 128 output sub-tile of one pair, each warp a 32 x 32 patch of mma
// fragments (128 registers a thread, so one block fills an SM's register
// file); the blocks of a pair run in parallel (the TPU kernel's
// sequential grid carried a VMEM accumulator over the row chunks; here the
// K loop inside the block takes that place).  Slabs of 16 rows of X (the
// block's 128 I columns and 128 J columns) go through a ring of three
// shared-memory stages filled by cp.async, so slab k + 2 loads while slab k
// multiplies.  Rows are padded to a stride of 132 values (4 mod 16), so a
// warp's fragment loads (ld.shared: ldmatrix has no 64-bit form) hit every
// bank once.  Centering happens as a fragment is built: a thread's fragment
// columns are fixed for the whole K loop, so it holds their mu in registers
// and subtracts it from each loaded value — the same (x - mu) rounding as
// the plain version, with no centered copy of X.  Rows past N are staged as
// mu (they centre to exactly zero), columns past bp as zero.  The mma
// shape is m16n8k8, one of those PTX adds for sm_90: sm_80's m8n8k4 in the
// same body measured 1.3x slower on the H100, m16n8k4 and m16n8k16 level
// or slower.
//
// The epilogue divides by n_true after the sum, masks, and stores each
// fragment's two adjacent values as one 16-byte store, so a quad of lanes
// writes 64 contiguous bytes of a `vals` row: whole 32-byte sectors, the
// unit the memory system writes (staging the patch in shared memory for
// full 256-byte rows measured slower on the H100).  The 128 x 128 tile
// keeps the X slabs read from L2 at (128 + 128) N values a block for
// 128 x 128 outputs.  The count and both maxima are reduced over the block
// with warp shuffles and combined across the pair's blocks with atomics on
// a per-pair accumulator in the wrapper's cached scratch (atomicAdd for the
// count; atomicMax on the bit patterns for the maxima, which orders
// non-negative doubles as numbers — fabs never yields -0.0); results that
// do not depend on order.  The pair's last block (a ticket after a
// __threadfence) moves them into counts and stats and zeroes the
// accumulator, so a call is this one launch and needs no zero-filled
// outputs.

#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

constexpr int kBM = 128;              // sub-tile rows (columns of tile I)
constexpr int kBN = 128;              // sub-tile columns (columns of tile J)
constexpr int kBK = 16;               // rows of X a stage holds
constexpr int kStages = 3;
constexpr int kThreads = 512;         // 16 warps: 4 (rows) x 4 (columns)
constexpr int kWarps = kThreads / 32;
constexpr int kWM = 32;               // a warp's patch
constexpr int kWN = 32;
constexpr int kLd = kBM + 4;          // stage row stride (values)
constexpr int kStageValues = 2 * kBK * kLd;
constexpr size_t kSmemBytes = sizeof(double) * kStages * kStageValues;
static_assert(kBM == kBN, "one stride serves both operands");
static_assert((kBM / kWM) * (kBN / kWN) == kWarps, "warps cover the sub-tile");

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// c += a b on one 16 x 8 x 8 fragment (row-major A, column-major B), f64
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Fragment layouts (lane = 4 g + q): A value i sits at row g + 8 (i % 2),
// column q + 4 (i / 2); B value i at row q + 4 i, column g; C value i at
// row g + 8 (i / 2), column 2 q + i % 2.
__global__ void __launch_bounds__(kThreads, 1)
    covgram_screen_kernel(const double* __restrict__ x, const double* __restrict__ mu,
                          const int* __restrict__ i_idx, const int* __restrict__ j_idx,
                          double* __restrict__ vals, int* __restrict__ counts,
                          double* __restrict__ stats, unsigned long long* __restrict__ acc,
                          int N, int P, int bp, int n_true, int p_true, double lam,
                          int sub_per_row) {
  constexpr int M = 16;           // the mma shape, m16n8k8
  constexpr int K = 8;
  constexpr int MT = kWM / M;     // fragments down a warp's patch
  constexpr int NT = kWN / 8;     // fragments across it
  constexpr int AV = M * K / 32;  // A values a thread holds a fragment
  constexpr int BV = K / 4;
  constexpr int CV = M / 4;
  constexpr int AH = M / 8;       // distinct A rows a thread holds a fragment
  double* smem = repro_torch::dynamic_smem<double>();
  __shared__ int cnt_s[kWarps];
  __shared__ double m0_s[kWarps];
  __shared__ double m1_s[kWarps];

  const int t = blockIdx.x;  // tile pair
  const int r0 = (blockIdx.y / sub_per_row) * kBM;  // rows within tile I
  const int c0 = (blockIdx.y % sub_per_row) * kBN;  // cols within tile J
  const long long baseI = (long long)i_idx[t] * bp;
  const long long baseJ = (long long)j_idx[t] * bp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wm = (warp / (kBN / kWN)) * kWM;
  const int wn = (warp % (kBN / kWN)) * kWN;
  const bool pairs = ((P | bp) & 1) == 0;  // 16-byte copies and stores

  // the mu of this thread's fragment columns, for the whole K loop
  double muA[MT][AH];
  double muB[NT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < AH; ++h) {
      const int r = r0 + wm + mt * M + g + 8 * h;
      muA[mt][h] = r < bp ? mu[baseI + r] : 0.0;
    }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = c0 + wn + nt * 8 + g;
    muB[nt] = c < bp ? mu[baseJ + c] : 0.0;
  }

  // stage `slab` (rows slab * kBK ...) into ring slot `slot`: kBK rows of
  // the I columns, then kBK rows of the J columns.  A thread copies the same
  // two adjacent columns of each side in every slab (rows lrr, lrr + 8), so
  // its sources, destinations and bounds are fixed before the K loop.
  constexpr int kRowsPass = kThreads / (kBM / 2);
  static_assert(kBK % kRowsPass == 0, "whole passes a stage");
  const int lcc = 2 * (threadIdx.x % (kBM / 2));
  const int lrr = threadIdx.x / (kBM / 2);
  const int colA = r0 + lcc;  // within the tiles
  const int colB = c0 + lcc;
  const double* const srcA = x + baseI + colA;
  const double* const srcB = x + baseJ + colB;
  const bool vecA = pairs && colA < bp;
  const bool vecB = pairs && colB < bp;
  auto load = [&](int slot, int slab) {
    double* const stage = smem + slot * kStageValues;
    const int k0 = slab * kBK;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int col = side ? colB : colA;
      const double* const src = side ? srcB : srcA;
      const bool vec = side ? vecB : vecA;
#pragma unroll
      for (int pass = 0; pass < kBK / kRowsPass; ++pass) {
        const int rr = lrr + pass * kRowsPass;
        const long long row = k0 + rr;
        double* const dst = stage + (side * kBK + rr) * kLd + lcc;
        if (row >= N) {  // past the data: mu, which centres to exactly zero
          const double* const m = mu + (side ? baseJ : baseI) + col;
          dst[0] = col < bp ? m[0] : 0.0;
          dst[1] = col + 1 < bp ? m[1] : 0.0;
        } else if (vec) {
          cp_async16(dst, src + row * P);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (col + h < bp)
              cp_async8(dst + h, src + row * P + h);
            else
              dst[h] = 0.0;
          }
        }
      }
    }
  };

  double c[MT][NT][CV];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < CV; ++i) c[mt][nt][i] = 0.0;

  auto compute = [&](int slot) {
    const double* const As = smem + slot * kStageValues;
    const double* const Bs = As + kBK * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += K) {
      double a[MT][AV];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < AV; ++i) {
          const int h = i & 1;
          const int k = kk + q + 4 * (i >> 1);
          a[mt][i] = As[k * kLd + wm + mt * M + g + 8 * h] - muA[mt][h];
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        double b[BV];
#pragma unroll
        for (int i = 0; i < BV; ++i)
          b[i] = Bs[(kk + q + 4 * i) * kLd + wn + nt * 8 + g] - muB[nt];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_f64(c[mt][nt], a[mt], b);
      }
    }
  };

  const int slabs = (N + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kStages - 2>();  // slab s has landed
    __syncthreads();               // ... for every thread; slot s - 1 is free
    const int next = s + kStages - 1;
    if (next < slabs) load(next % kStages, next);
    cp_async_commit();
    compute(s % kStages);
  }

  int cnt = 0;
  double m0 = 0.0, m1 = 0.0;
  double* const vt = vals + (long long)t * bp * bp;
  const double n = (double)n_true;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < CV; i += 2) {
        const int r = r0 + wm + mt * M + g + 8 * (i >> 1);
        const int col = c0 + wn + nt * 8 + 2 * q;  // the first of two columns
        double out[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long gr = baseI + r;
          const long long gc = baseJ + col + h;
          const double s = c[mt][nt][i + h] / n;
          const double as = fabs(s);
          const bool valid = r < bp && col + h < bp && gr < p_true && gc < p_true && gr != gc;
          const bool edge = valid && as > lam;
          out[h] = edge ? s : 0.0;
          if (valid) {
            m0 = fmax(m0, as);
            if (!edge) m1 = fmax(m1, as);
          }
          cnt += edge ? 1 : 0;
        }
        if (r < bp) {
          double* const dst = vt + (long long)r * bp + col;
          if (pairs && col < bp) {
            *reinterpret_cast<double2*>(dst) = make_double2(out[0], out[1]);
          } else {
            if (col < bp) dst[0] = out[0];
            if (col + 1 < bp) dst[1] = out[1];
          }
        }
      }

  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    m0 = fmax(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmax(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  if (lane == 0) {
    cnt_s[warp] = cnt;
    m0_s[warp] = m0;
    m1_s[warp] = m1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      cnt += cnt_s[w];
      m0 = fmax(m0, m0_s[w]);
      m1 = fmax(m1, m1_s[w]);
    }
    unsigned long long* const a = acc + 4 * (long long)t;  // count, m0, m1, ticket
    if (cnt) atomicAdd(a, (unsigned long long)cnt);
    if (m0 > 0.0) atomicMax(a + 1, (unsigned long long)__double_as_longlong(m0));
    if (m1 > 0.0) atomicMax(a + 2, (unsigned long long)__double_as_longlong(m1));
    __threadfence();  // this block's share lands before its ticket
    if (atomicAdd(a + 3, 1ull) == (unsigned long long)(gridDim.y - 1)) {
      __threadfence();
      counts[t] = (int)atomicExch(a, 0ull);
      stats[2 * t] = __longlong_as_double((long long)atomicExch(a + 1, 0ull));
      stats[2 * t + 1] = __longlong_as_double((long long)atomicExch(a + 2, 0ull));
      atomicExch(a + 3, 0ull);
    }
  }
}


// ------------------------------------------------------------ float32 body
//
// The same contract on float32 X, with float32 sums, threshold (lam rounded
// to float32, as the plain version compares) and outputs.  The products are
// FP32 FMAs on the CUDA cores: TF32 `mma` would round X to a 10-bit
// mantissa and move edges near lam, whereas the plain version is true
// float32.  Bound: 2 N bp^2 operations a pair at the FP32 rate outside the
// tensor cores (67 TFLOP/s), or the bytes of vals and X.
//
// Design: the float64 body's tiling with the mma fragments replaced by a
// register tile.  One block of 256 threads computes a 128 x 128 sub-tile
// of one pair (one block an SM: the launch bound of two blocks, 128
// registers a thread, spilled the mu registers); thread
// (ty, tx) = (tid / 16, tid % 16) owns rows
// 4 ty .. 4 ty + 3 and 64 + 4 ty .. 64 + 4 ty + 3 and the same pattern of
// columns with tx: an 8 x 8 accumulator.  A k-step reads two float4 of
// each operand from shared memory (the two ty of a warp: a broadcast; its
// 16 tx: 256 contiguous bytes) for 64 FMAs.  Slabs of 16 rows of X go
// through the same three-stage cp.async ring (16-byte copies where P and bp
// are multiples of 4, 4-byte ones otherwise), rows past N staged as mu and
// columns past bp as zero; each thread subtracts its rows' and columns' mu
// (held in registers) as it loads the operands, so the (x - mu) rounding is
// the plain version's.  Each accumulator sums its products in row order by
// fmaf.  The epilogue is the float64 body's: divide by n_true, mask,
// float4 stores where bp is a multiple of 4, warp and block reductions,
// and the pair's accumulators (the maxima as the bit patterns of
// non-negative floats, which order as integers).
namespace f32 {

constexpr int kBM = 128;
constexpr int kBK = 16;
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageValues = 2 * kBK * kBM;  // I rows, then J rows
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageValues;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// local row (or column) of a thread's register index i (0..7)
__device__ __forceinline__ int local_of(int t, int i) {
  return (i < 4 ? 0 : 64) + 4 * t + (i & 3);
}

__global__ void __launch_bounds__(kThreads, 1)
    covgram_screen_f32_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                              const int* __restrict__ i_idx, const int* __restrict__ j_idx,
                              float* __restrict__ vals, int* __restrict__ counts,
                              float* __restrict__ stats, unsigned long long* __restrict__ acc,
                              int N, int P, int bp, int n_true, int p_true, float lam,
                              int sub_per_row) {
  float* smem = repro_torch::dynamic_smem<float>();
  __shared__ int cnt_s[kWarps];
  __shared__ float m0_s[kWarps];
  __shared__ float m1_s[kWarps];

  const int t = blockIdx.x;
  const int r0 = (blockIdx.y / sub_per_row) * kBM;
  const int c0 = (blockIdx.y % sub_per_row) * kBM;
  const long long baseI = (long long)i_idx[t] * bp;
  const long long baseJ = (long long)j_idx[t] * bp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const bool quads = ((P | bp) & 3) == 0;  // 16-byte copies and stores

  float muA[8], muB[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + local_of(ty, i);
    const int c = c0 + local_of(tx, i);
    muA[i] = r < bp ? mu[baseI + r] : 0.0f;
    muB[i] = c < bp ? mu[baseJ + c] : 0.0f;
  }

  // a thread stages 4 adjacent columns (chunk lc) of rows lr and lr + 8 of
  // each side in every slab
  const int lc = 4 * (threadIdx.x % 32);
  const int lr = threadIdx.x / 32;
  const int colA = r0 + lc;
  const int colB = c0 + lc;
  auto load = [&](int slot, int slab) {
    float* const stage = smem + slot * kStageValues;
    const int k0 = slab * kBK;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int col = side ? colB : colA;
      const long long base = side ? baseJ : baseI;
#pragma unroll
      for (int pass = 0; pass < kBK / 8; ++pass) {
        const int rr = lr + 8 * pass;
        const long long row = k0 + rr;
        float* const dst = stage + (side * kBK + rr) * kBM + lc;
        if (row >= N) {  // past the data: mu, which centres to exactly zero
#pragma unroll
          for (int h = 0; h < 4; ++h) dst[h] = col + h < bp ? mu[base + col + h] : 0.0f;
        } else if (quads && col < bp) {
          cp_async16(dst, x + row * P + base + col);
        } else {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            if (col + h < bp)
              cp_async4(dst + h, x + row * P + base + col + h);
            else
              dst[h] = 0.0f;
          }
        }
      }
    }
  };

  float c[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.0f;

  auto compute = [&](int slot) {
    const float* const As = smem + slot * kStageValues;
    const float* const Bs = As + kBK * kBM;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 av = *reinterpret_cast<const float4*>(As + k * kBM + 64 * h + 4 * ty);
        const float4 bv = *reinterpret_cast<const float4*>(Bs + k * kBM + 64 * h + 4 * tx);
        a[4 * h] = av.x - muA[4 * h];
        a[4 * h + 1] = av.y - muA[4 * h + 1];
        a[4 * h + 2] = av.z - muA[4 * h + 2];
        a[4 * h + 3] = av.w - muA[4 * h + 3];
        b[4 * h] = bv.x - muB[4 * h];
        b[4 * h + 1] = bv.y - muB[4 * h + 1];
        b[4 * h + 2] = bv.z - muB[4 * h + 2];
        b[4 * h + 3] = bv.w - muB[4 * h + 3];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  };

  const int slabs = (N + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < slabs) load(next % kStages, next);
    cp_async_commit();
    compute(s % kStages);
  }
  cp_async_wait<0>();

  int cnt = 0;
  float m0 = 0.0f, m1 = 0.0f;
  float* const vt = vals + (long long)t * bp * bp;
  const float n = (float)n_true;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + local_of(ty, i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + 64 * h + 4 * tx;  // the first of four columns
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long gr = baseI + r;
        const long long gc = baseJ + col + e;
        const float s = c[i][4 * h + e] / n;
        const float as = fabsf(s);
        const bool valid = r < bp && col + e < bp && gr < p_true && gc < p_true && gr != gc;
        const bool edge = valid && as > lam;
        out[e] = edge ? s : 0.0f;
        if (valid) {
          m0 = fmaxf(m0, as);
          if (!edge) m1 = fmaxf(m1, as);
        }
        cnt += edge ? 1 : 0;
      }
      if (r < bp) {
        float* const dst = vt + (long long)r * bp + col;
        if (quads && col < bp) {
          *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < bp) dst[e] = out[e];
        }
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  if (lane == 0) {
    cnt_s[warp] = cnt;
    m0_s[warp] = m0;
    m1_s[warp] = m1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      cnt += cnt_s[w];
      m0 = fmaxf(m0, m0_s[w]);
      m1 = fmaxf(m1, m1_s[w]);
    }
    unsigned long long* const a = acc + 4 * (long long)t;  // count, m0, m1, ticket
    if (cnt) atomicAdd(a, (unsigned long long)cnt);
    if (m0 > 0.0f) atomicMax(a + 1, (unsigned long long)__float_as_uint(m0));
    if (m1 > 0.0f) atomicMax(a + 2, (unsigned long long)__float_as_uint(m1));
    __threadfence();
    if (atomicAdd(a + 3, 1ull) == (unsigned long long)(gridDim.y - 1)) {
      __threadfence();
      counts[t] = (int)atomicExch(a, 0ull);
      stats[2 * t] = __uint_as_float((unsigned)atomicExch(a + 1, 0ull));
      stats[2 * t + 1] = __uint_as_float((unsigned)atomicExch(a + 2, 0ull));
      atomicExch(a + 3, 0ull);
    }
  }
}

}  // namespace f32

}  // namespace

// x: (N, P) padded, mu: (P,), i_idx/j_idx: (npairs,) int32 tile indices;
// vals: (npairs, bp, bp); counts: (npairs,) int32 and stats: (npairs, 2)
// float64, written whole by the launch.  acc: 4 npairs zeroed values, left
// zeroed.
extern "C" int covgram_screen_launch(const void* x, const void* mu, const void* i_idx,
                                     const void* j_idx, void* vals, void* counts,
                                     void* stats, void* acc, int npairs, int N, int P,
                                     int bp, int n_true, int p_true, double lam,
                                     void* stream) {
  if (npairs <= 0 || bp <= 0) return 0;
  const int sub_per_row = (bp + kBM - 1) / kBM;
  const long long subs = (long long)sub_per_row * sub_per_row;
  if (subs > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      covgram_screen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  covgram_screen_kernel<<<dim3((unsigned)npairs, (unsigned)subs), kThreads, kSmemBytes,
                          (cudaStream_t)stream>>>(
      (const double*)x, (const double*)mu, (const int*)i_idx, (const int*)j_idx,
      (double*)vals, (int*)counts, (double*)stats, (unsigned long long*)acc, N, P, bp,
      n_true, p_true, lam, sub_per_row);
  return (int)cudaGetLastError();
}

// The float32 body: the same layout and accumulators, float32 x, mu, vals
// and stats, lam already rounded to float32.
extern "C" int covgram_screen_launch_f32(const void* x, const void* mu, const void* i_idx,
                                         const void* j_idx, void* vals, void* counts,
                                         void* stats, void* acc, int npairs, int N, int P,
                                         int bp, int n_true, int p_true, float lam,
                                         void* stream) {
  if (npairs <= 0 || bp <= 0) return 0;
  const int sub_per_row = (bp + f32::kBM - 1) / f32::kBM;
  const long long subs = (long long)sub_per_row * sub_per_row;
  if (subs > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(f32::covgram_screen_f32_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f32::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  f32::covgram_screen_f32_kernel<<<dim3((unsigned)npairs, (unsigned)subs), f32::kThreads,
                                   f32::kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)mu, (const int*)i_idx, (const int*)j_idx,
      (float*)vals, (int*)counts, (float*)stats, (unsigned long long*)acc, N, P, bp, n_true,
      p_true, lam, sub_per_row);
  return (int)cudaGetLastError();
}
