// flash_attention: blockwise online-softmax attention, causal or full, with
// grouped K/V heads (GQA), for float32 or bf16 q/k/v; float32 sums and the
// output in q's dtype.  Two hand-written bodies, chosen by dtype and head
// dim in the wrapper (kernels/flash_attention/ops.py):
//   - the SIMT body: float32 at every d, bf16 at d in {4, 8};
//   - the wgmma body: bf16 at d in {16, 32, 64, 128} (wgmma's depth is 16).
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
// and keys past them are masked here, no padded copy exists.
//
// Bound on the H100: 4 B Hq Sq Skv d flops (halved when causal) at the
// float32 rate outside the tensor cores (67 TFLOP/s) for the float32
// instance, at the bf16 tensor-core rate (989 TFLOP/s) for bf16; the bytes
// of q, k, v and o at 3.35 TB/s are far below either at S = 2048, d = 128.
//
// SIMT body: one block of 128 threads per (bh, 64-row query block); the
// longest causal blocks are numbered first.  The query block is staged once
// in shared memory, upcast to float32; each 64-key tile of K, then of V, is
// staged in one buffer after it (rows of pitch d + 1, so the column reads
// below hit distinct banks).  Thread (ty, tx), ty < 16, tx < 8, owns query
// rows 4 ty .. 4 ty + 3: it computes their scores against keys tx + 8 j
// (j < 8), a 4 x 8 register tile of float32 FMAs; the row max and row sum
// reduce over the 8 threads of the row group by warp shuffles, so every
// thread of the group holds the row's (m, l); p goes through shared memory,
// and the thread accumulates its rows' output columns tx + 8 j.  Shared
// memory: (2 * 64 (d + 1) + 64 * 65) floats, 82,688 bytes at d = 128, so
// two blocks fit an SM.  Float32 must stay float32 (no TF32), so this body
// keeps the float32 instance off the tensor cores.
//
// wgmma body (bf16): a block of two warpgroups (256 threads) per (bh,
// 128-row query block), longest causal blocks first, each warpgroup owning
// 64 query rows; both walk the block's 64-key tiles, which they share (a
// warpgroup past its own diagonal skips the tile):
//   - S = Q K^T on wgmma m64n64k16, both operands in shared memory, K
//     K-major as stored (d contiguous), float32 accumulators in registers;
//   - the online softmax in those registers, in base 2 (the scale folded
//     with log2 e, 2^x by ex2.approx): a row's 64 scores sit on the 4
//     threads of a quad, so its max and sum reduce by two shuffles; the
//     mask is applied only on the diagonal and ragged tiles;
//   - O += P V on wgmma m64n{d}k16 with P as the register A operand: the
//     accumulator's fragment of S is the A fragment's layout, so P is
//     rounded to bf16 in place, no shuffle; V (keys x d, d contiguous) is
//     the B operand with the transpose bit; O stays float32 in registers.
//   P is rounded to bf16 before P V (the reference multiplies float32 p by
//   upcast v); the result is held to the reference's bf16 tolerance.
//   Memory: Q staged once by TMA; K and V tiles through a ring of 2 stages,
//   each filled by TMA and tracked by an mbarrier, so tile kb + 1's load is
//   in flight while tile kb's products run; one K/V tile feeds 128 query
//   rows, and four warpgroups an SM hide each other's softmax.  Tiles are
//   64 rows of d values in the TMA's swizzled layout (128-byte swizzle at
//   d >= 64, 64 at 32, 32 at 16), which the wgmma descriptors read as it
//   lies: d = 128 is two 64-column swizzle atoms.  3-D tensor maps over
//   (bh, S, d) stop a box at S, and TMA zero-fills the rows past it; the
//   score mask still decides.  Shared memory: 6 tiles of 64 x d bf16 (97 KB
//   at d = 128), so two blocks (four warpgroups) fit an SM.  The driver's
//   cuTensorMapEncodeTiled is taken through
//   cudaGetDriverEntryPointByVersion, so the library links without -lcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include <cute/arch/mma_sm90_desc.hpp>  // cute::GmmaDescriptor

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


// ----------------------------------------------------------- the wgmma body

namespace {

constexpr int kStages = 2;               // K/V ring
constexpr int kWG = 2;                   // warpgroups a block, 64 query rows each
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory geometry of one 64-row bf16 tile of d values
template <int D>
struct Tile {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kSwizzle = kRowBytes < 128 ? kRowBytes : 128;  // bytes
  static constexpr int kAtomCols = kSwizzle / 2;      // d values a TMA box
  static constexpr int kAtoms = kRowBytes / kSwizzle; // boxes across d
  static constexpr int kAtomBytes = 64 * kSwizzle;    // 64 rows of one box
  static constexpr int kBytes = 64 * kRowBytes;
  // wgmma descriptor layout type (cute::GmmaDescriptor: 128B = 1, 64B = 2,
  // 32B = 3) and TMA swizzle of the same width
  static constexpr uint8_t kLayout = kSwizzle == 128 ? 1 : (kSwizzle == 64 ? 2 : 3);
  static_assert(D % 16 == 0 && D <= 128, "wgmma body: d in {16, 32, 64, 128}");
};

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // kWG Q tiles and kStages (K, V) pairs, and 1 KB to align the base to
  // the 128-byte swizzle's 1024-byte period
  return (size_t)(kWG + 2 * kStages) * Tile<D>::kBytes + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase differs from `parity`; a load that never
// lands (~8 s at the card's clock) traps, so a fault is an error, not a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// one TMA box of a 3-D map, coordinates innermost first, onto `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows [r0, r0 + 64) of head `h` into a tile: one box per swizzle atom
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int r0, int h) {
#pragma unroll
  for (int a = 0; a < Tile<D>::kAtoms; ++a)
    tma_load(dst + a * Tile<D>::kAtomBytes, map, bar, a * Tile<D>::kAtomCols, r0, h);
}

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint8_t layout) {
  cute::GmmaDescriptor d;
  d.bitfield.start_address_ = (uint16_t)(addr >> 4);
  d.bitfield.leading_byte_offset_ = (uint16_t)(lbo >> 4);
  d.bitfield.stride_byte_offset_ = (uint16_t)(sbo >> 4);
  d.bitfield.base_offset_ = 0;  // every atom starts on its swizzle period
  d.bitfield.layout_type_ = layout;
  return d.desc_;
}

// K-major operand (Q as A, K as B): depth step k is 16 d values = 32 bytes
// of each row, inside atom (32 k) / swizzle; 8-row groups lie 8 rows of the
// swizzle apart (SBO); LBO is unused by swizzled K-major layouts (1)
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int k) {
  using T = Tile<D>;
  const uint32_t at = tile + (32 * k / T::kSwizzle) * T::kAtomBytes + (32 * k) % T::kSwizzle;
  return gmma_desc(at, 16, 8 * T::kSwizzle, T::kLayout);
}

// MN-major operand (V as B, keys x d with d contiguous, the transpose bit):
// depth step kk is keys 16 kk .. 16 kk + 15; LBO steps between swizzle
// atoms across d, SBO between 8-key groups
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using T = Tile<D>;
  return gmma_desc(tile + 16 * kk * T::kSwizzle, T::kAtomBytes, 8 * T::kSwizzle, T::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of registers an in-flight wgmma
// owns across the fence / wait that brackets it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x by the SFU's ex2.approx (flushing denormals; ~2 ulp, far inside the
// bf16 output's rounding), where exp2f adds range handling around it
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b);

// S (64 x 64, float32) += A (64 x 16) B (16 x 64), both bf16 from shared
// memory through their descriptors, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int D>
__global__ void __launch_bounds__(kWG * 128, 2)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 __nv_bfloat16* __restrict__ o, int group, int sq,
                                 int skv, float scale_log2, int causal) {
  using T = Tile<D>;
  constexpr int kS = kBK / 2;  // score accumulators a thread (m64n64)
  constexpr int kO = D / 2;    // output accumulators a thread (m64n{D})
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];  // Q, then the ring's

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + kWG * T::kBytes;  // stage s: K, then V
  const int bh = blockIdx.x;
  const int hkv = bh / group;
  const int q_block = (gridDim.y - 1 - blockIdx.y) * kBQ * kWG;
  const int tid = threadIdx.x;
  const int wg = tid / 128;                      // this warpgroup's 64 rows
  const int q0 = q_block + wg * kBQ;
  const uint32_t q_tile = base + wg * T::kBytes;
  const int warp = tid % 128 / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int row0 = q0 + 16 * warp + lane / 4;  // rows row0 and row0 + 8

  int nk = (skv + kBK - 1) / kBK;  // the block's key tiles, and the group's
  if (causal) nk = min(nk, (q_block + kWG * kBQ - 1) / kBK + 1);
  int nk_wg = q0 < sq ? nk : 0;
  if (causal) nk_wg = min(nk_wg, (q0 + kBQ - 1) / kBK + 1);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(smem_u32(&bars[0]), kWG * T::kBytes);
    for (int w = 0; w < kWG; ++w)
      load_tile<D>(base + w * T::kBytes, &q_map, smem_u32(&bars[0]), q_block + w * kBQ, bh);
    for (int s = 0; s < kStages && s < nk; ++s) {
      const uint32_t bar = smem_u32(&bars[1 + s]);
      mbar_expect_tx(bar, 2 * T::kBytes);
      load_tile<D>(ring + 2 * s * T::kBytes, &k_map, bar, s * kBK, hkv);
      load_tile<D>(ring + (2 * s + 1) * T::kBytes, &v_map, bar, s * kBK, hkv);
    }
  }

  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // log2 units
  float l[2] = {0.0f, 0.0f};        // this thread's columns only, until the end

  mbar_wait(smem_u32(&bars[0]), 0);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % kStages;
    const int k0 = kb * kBK;
    const uint32_t k_tile = ring + 2 * s * T::kBytes;
    const uint32_t v_tile = k_tile + T::kBytes;
    mbar_wait(smem_u32(&bars[1 + s]), (kb / kStages) & 1);
    if (kb < nk_wg) {  // uniform across the warpgroup
      float sc[kS];  // written by the first product (scale-d 0)
#pragma unroll
      for (int i = 0; i < kS; ++i) sc[i] = 0.0f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss_n64(sc, kmajor_desc<D>(q_tile, k), kmajor_desc<D>(k_tile, k), k > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // sc[4 j + e]: row row0 + 8 (e / 2), key k0 + 8 j + 2 quad + e % 2
      const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > q0);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * quad + (e & 1);
            const int qpos = row0 + 8 * (e >> 1);
            const bool keep = kpos < skv && (!causal || kpos <= qpos);
            sc[4 * j + e] = keep ? sc[4 * j + e] * scale_log2 : kNegInf;
          }
      } else {
#pragma unroll
        for (int i = 0; i < kS; ++i) sc[i] *= scale_log2;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        sc[i] = fast_exp2(sc[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // the S fragment of keys 16 kk .. 16 kk + 15 is the A fragment of depth
      // step kk: registers {a0 a1}, {a2 a3}, {a4 a5}, {a6 a7} of mma's layout
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], mnmajor_desc<D>(v_tile, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }

    __syncthreads();  // both warpgroups' reads of stage s are done
    if (tid == 0 && kb + kStages < nk) {
      const uint32_t bar = smem_u32(&bars[1 + s]);
      mbar_expect_tx(bar, 2 * T::kBytes);
      load_tile<D>(k_tile, &k_map, bar, (kb + kStages) * kBK, hkv);
      load_tile<D>(v_tile, &v_map, bar, (kb + kStages) * kBK, hkv);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* out = o + ((long long)bh * sq + row) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once; null if missing
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 3-D map over a (heads, rows, D) bf16 tensor whose box is 64 rows of one
// swizzle atom of one head; rows past `rows` read as zeros
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int heads, int rows) {
  using T = Tile<D>;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)T::kRowBytes, (cuuint64_t)rows * T::kRowBytes};
  const cuuint32_t box[3] = {(cuuint32_t)T::kAtomCols, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : (T::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma_d(const void* q, const void* k, const void* v, void* o, int bh,
                   int group, int sq, int skv, float scale, int causal, void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[3];
  const int kv_rows = skv > 0 ? skv : 1;  // a map needs one row; nk = 0 reads none
  if (!make_map<D>(encode, &maps[0], q, bh, sq) ||
      !make_map<D>(encode, &maps[1], k, bh / group, kv_rows) ||
      !make_map<D>(encode, &maps[2], v, bh / group, kv_rows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)bh, (unsigned)((sq + kWG * kBQ - 1) / (kWG * kBQ)));
  flash_attention_wgmma_kernel<D><<<grid, kWG * 128, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)o, group, sq, skv, scale * kLog2e,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (bh, sq, d) row-major; k, v: (bh / group, skv, d) row-major; all
// float32.  d in {4, 8, 16, 32, 64, 128}.  The SIMT body.
extern "C" int flash_attention_launch_f32(const void* q, const void* k,
                                          const void* v, void* o, int bh,
                                          int group, int sq, int skv, int d,
                                          float scale, int causal,
                                          void* stream) {
  return launch<float>(q, k, v, o, bh, group, sq, skv, d, scale, causal, stream);
}

// the same layout in bf16 through the SIMT body, upcast per element as
// staged; o in bf16.  The wrapper sends d in {4, 8} here.
extern "C" int flash_attention_launch_bf16(const void* q, const void* k,
                                           const void* v, void* o, int bh,
                                           int group, int sq, int skv, int d,
                                           float scale, int causal,
                                           void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, group, sq, skv, d, scale,
                               causal, stream);
}

// the same layout in bf16 through the wgmma body, d in {16, 32, 64, 128};
// every pointer 16-byte aligned (TMA)
extern "C" int flash_attention_wgmma_launch_bf16(const void* q, const void* k,
                                                 const void* v, void* o, int bh,
                                                 int group, int sq, int skv, int d,
                                                 float scale, int causal,
                                                 void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (group <= 0 || bh % group != 0 || skv < 0 || (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_wgmma_d<16>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 32: return launch_wgmma_d<32>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 64: return launch_wgmma_d<64>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 128: return launch_wgmma_d<128>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
