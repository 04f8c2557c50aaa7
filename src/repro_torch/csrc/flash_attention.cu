// flash_attention: blockwise online-softmax attention, causal or full, with
// grouped K/V heads (GQA), for float32 or bf16 q/k/v; float32 sums and the
// output in q's dtype.  One hand-written body per dtype, chosen by dtype in
// the wrapper (kernels/flash_attention/ops.py), each with instances at a few
// head dims:
//   - the float32 body (register-tiled FP32 FMAs): d in {32, 64, 96, 128};
//   - the wgmma body (bf16 tensor cores): d in {16, 32, 64, 128} (wgmma's
//     depth is 16 bf16 values).
// The wrapper pads any other d <= 128 with zero columns of q, k and v up to
// the next instance (a zero column adds nothing to q . k, and the output
// columns it adds are sliced away), keeping the unpadded d's scale: in
// float32, d < 32 runs the d = 32 instance and d = 80 the d = 96 one; in
// bf16, d < 16 runs d = 16 and d = 80 and 96 run d = 128.  The float32 body
// takes any multiple of 32 cheaply (d = 96, Phi-3-mini's, runs without a
// padded copy); it has no d = 16 instance, where a lane would own one
// output column.
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
// Both bodies take exp in base 2: s is scaled by scale * log2 e and
// exp(x) is 2^x by ex2.approx, the same function within float32 rounding.
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
// float32 body: one block of 128 threads per (bh, 64-row query block), the
// longest causal blocks first.  The threads are 8 row groups of 16 lanes;
// lane t of row group g owns query rows 8 g .. 8 g + 7, and
//   - in S = Q K^T, keys t + 16 j (j < 4) of each 64-key tile: an 8 x 4
//     register tile.  A step over 4 values of d reads 8 float4 of Q (one
//     address across the row group: a broadcast) and 4 float4 of K, for
//     128 FMAs: 10.7 FMAs a shared load;
//   - in O += P V, output columns 4 (t + 16 u) .. 4 (t + 16 u) + 3
//     (u < d / 64), and 64 (d / 64) + 2 t, + 1 where d is an odd multiple
//     of 32: an 8 x d/16 register tile.  A key reads two float4 of P (the 8
//     rows: a broadcast) and d/64 float4 (and a float2) of V, for 8 d/16
//     FMAs: 16 FMAs a shared load at d = 128.
// Q (staged once), one K tile, one V tile and P (stored key-major, P^T)
// lie in shared memory.  Q, K and V are filled by 16-byte cp.async.cg
// copies: each thread copies one fixed 16-byte chunk of each 32-column
// group of every 16th row, so no copy divides an index, and rows past Sq
// or Skv are zero-filled by the copy itself (src-size 0).  An XOR swizzle takes the place of a
// padded pitch: K's chunk c of row r lies at chunk c ^ (r & 7), P^T's
// chunk c of key j at c ^ (j & 7) and Q's chunk c of row r at
// c ^ ((r / 8) & 7), so the float4 reads of K by 8 consecutive keys, the
// float4 writes of P and the two row groups' reads of Q in a warp each
// land on distinct banks; V is read as it lies, by consecutive chunks.
// K and V have buffers of their own and take turns as a two-slot ring:
// V(kb) is copied while S(kb) and its softmax run, K(kb + 1) while
// P(kb) V(kb) runs, so each half of a tile waits for one copy
// (cp.async.wait_group 0) and meets one barrier.  The online softmax stays
// in registers: a row's max reduces over its 16 lanes by 4 shuffles, its
// sum stays per lane until the end; the mask runs only on diagonal and
// ragged tiles.  Shared memory: (3 * 64 d + 64 * 64) floats, 112 KB at
// d = 128, so two blocks (8 warps) fit an SM at d >= 96 and three below, with the carveout set to
// its maximum; two blocks of 128 threads leave up to 255 registers a
// thread, and a thread's 64 output and 32 score accumulators give each
// warp independent FMAs enough to cover the FMA pipe's latency.  Float32
// stays float32 FMAs: no TF32 and no tensor cores.
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

constexpr int kBQ = 64;                 // query rows a block (a warpgroup's, in wgmma)
constexpr int kBK = 64;                 // keys a tile
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF

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


// --------------------------------------------------------- the float32 body

namespace {

constexpr int kLanes = 16;                          // lanes of a row group
constexpr int kRowsT = 8;                           // query rows a thread
constexpr int kKeysT = kBK / kLanes;                // keys a thread in S: 4
constexpr int kF32Threads = kBQ / kRowsT * kLanes;  // 128
static_assert(kBQ == kBK, "copy_tile stages 64-row tiles of Q, K and V alike");

template <int D>
constexpr size_t f32_smem_bytes() {
  return (size_t)(3 * kBK * D + kBK * kBQ) * sizeof(float);  // Q, K, V, P^T
}

// 16 bytes from global to shared memory, of which the first `bytes` (16 or
// 0) are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// where chunk c of a tile's row r lies: as it is (V), at c ^ (r & 7) (K:
// 8 consecutive keys read one chunk each), or at c ^ ((r / 8) & 7) (Q: the
// two row groups of a warp read one chunk of rows 8 apart)
enum Swizzle { kPlain, kByRow, kByRowGroup };

template <Swizzle kSw>
__device__ __forceinline__ int chunk_at(int c, int r) {
  return kSw == kPlain ? c : (kSw == kByRow ? c ^ (r & 7) : c ^ ((r >> 3) & 7));
}

// rows r0 .. r0 + 63 of a (len, D) row-major float32 matrix into the 64 x D
// tile at `dst`, zero past len.  Thread x copies 16-byte chunk x % 8 of
// each 32-column group of rows x / 8 + 16 i (8 threads a 128-byte line).
template <int D, Swizzle kSw>
__device__ __forceinline__ void copy_tile(uint32_t dst, const float* __restrict__ src,
                                          int r0, int len) {
  constexpr int kRowStep = kF32Threads / 8;
  const int c = threadIdx.x % 8;
  const int r = threadIdx.x / 8;
#pragma unroll
  for (int i = 0; i < kBK / kRowStep; ++i) {
    const int row = r + kRowStep * i;
    const bool in = r0 + row < len;
    const float* from = src + (long long)(in ? r0 + row : 0) * D + 4 * c;
#pragma unroll
    for (int grp = 0; grp < D / 32; ++grp)
      cp_async16(dst + (uint32_t)(row * D + 4 * chunk_at<kSw>(c + 8 * grp, row)) * 4u,
                 from + 32 * grp, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 2)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ o,
                               int group, int sq, int skv, float scale_log2, int causal) {
  static_assert(D % 32 == 0 && D <= 128, "float32 body: d in {32, 64, 96, 128}");
  // a lane's output columns: 4 (t + 16 u) .. + 3 for u < kVec4, then
  // 64 kVec4 + 2 t and + 1 when d is an odd multiple of 32
  constexpr int kVec4 = D / 64;
  constexpr bool kVec2 = D % 64 != 0;
  constexpr int kColsT = 4 * kVec4 + 2 * kVec2;  // D / 16
  constexpr int kTile = kBK * D;                 // floats of a Q, K or V tile
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;
  float* Ks = Qs + kTile;
  float* Vs = Ks + kTile;
  float* Ps = Vs + kTile;  // P^T: [key][query row], chunks swizzled by key

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qh = q + (long long)bh * sq * D;
  const float* kh = k + (long long)(bh / group) * skv * D;
  const float* vh = v + (long long)(bh / group) * skv * D;
  const int t = threadIdx.x % kLanes;
  const int g = threadIdx.x / kLanes;
  const int sw = t & 7;  // key & 7 of every key t + 16 j this lane owns in S
  const float* q_rows = Qs + kRowsT * g * D;
  const float* k_rows = Ks + t * D;

  int nk = (skv + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);

  copy_tile<D, kByRowGroup>(smem_u32(Qs), qh, q0, sq);
  if (nk > 0) copy_tile<D, kByRow>(smem_u32(Ks), kh, 0, skv);
  cp_async_commit();

  float acc[kRowsT][kColsT], m[kRowsT], l[kRowsT];  // m in log2 units
#pragma unroll
  for (int i = 0; i < kRowsT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;  // this lane's keys only, until the end
#pragma unroll
    for (int c = 0; c < kColsT; ++c) acc[i][c] = 0.0f;
  }

  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBK;
    cp_async_wait_all();
    __syncthreads();  // K(kb) (and Q) in place; every read of V(kb - 1) and P done
    copy_tile<D, kPlain>(smem_u32(Vs), vh, k0, skv);
    cp_async_commit();

    float s[kRowsT][kKeysT];
#pragma unroll
    for (int i = 0; i < kRowsT; ++i)
#pragma unroll
      for (int j = 0; j < kKeysT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      const int q_at = 4 * (c ^ (g & 7)), k_at = 4 * (c ^ sw);
      float4 qv[kRowsT];
#pragma unroll
      for (int i = 0; i < kRowsT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_rows + i * D + q_at);
#pragma unroll
      for (int j = 0; j < kKeysT; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(k_rows + kLanes * j * D + k_at);
#pragma unroll
        for (int i = 0; i < kRowsT; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int i = 0; i < kRowsT; ++i) {
      const int qpos = q0 + kRowsT * g + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kKeysT; ++j) {
        const int kpos = k0 + t + kLanes * j;
        const bool keep = !edge || (kpos < skv && (!causal || kpos <= qpos));
        s[i][j] = keep ? s[i][j] * scale_log2 : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row group are one half of a warp
#pragma unroll
      for (int w = 1; w < kLanes; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float alpha = fast_exp2(m[i] - mx);
      m[i] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeysT; ++j) {
        s[i][j] = fast_exp2(s[i][j] - mx);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kColsT; ++c) acc[i][c] *= alpha;
    }
    // p of rows 8 g .. 8 g + 7 are row chunks 2 g and 2 g + 1 of key row j
#pragma unroll
    for (int j = 0; j < kKeysT; ++j) {
      float* p_row = Ps + (t + kLanes * j) * kBQ;
      *reinterpret_cast<float4*>(p_row + 4 * ((2 * g) ^ sw)) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(p_row + 4 * ((2 * g + 1) ^ sw)) =
          make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }

    cp_async_wait_all();
    __syncthreads();  // V(kb) and P in place; every read of K(kb) done
    if (kb + 1 < nk) copy_tile<D, kByRow>(smem_u32(Ks), kh, k0 + kBK, skv);
    cp_async_commit();

    // keys past Skv have p = 0 and zero-filled V rows, so every tile runs
    // all 64 keys
#pragma unroll 8
    for (int j = 0; j < kBK; ++j) {
      const float* p_row = Ps + j * kBQ;
      const float4 p_lo = *reinterpret_cast<const float4*>(p_row + 4 * ((2 * g) ^ (j & 7)));
      const float4 p_hi = *reinterpret_cast<const float4*>(p_row + 4 * ((2 * g + 1) ^ (j & 7)));
      const float p[kRowsT] = {p_lo.x, p_lo.y, p_lo.z, p_lo.w, p_hi.x, p_hi.y, p_hi.z, p_hi.w};
      const float* v_row = Vs + j * D;
      float vv[kColsT];
#pragma unroll
      for (int u = 0; u < kVec4; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(v_row + 4 * (t + kLanes * u));
        vv[4 * u] = x.x;
        vv[4 * u + 1] = x.y;
        vv[4 * u + 2] = x.z;
        vv[4 * u + 3] = x.w;
      }
      if constexpr (kVec2) {
        const float2 x = *reinterpret_cast<const float2*>(v_row + 64 * kVec4 + 2 * t);
        vv[4 * kVec4] = x.x;
        vv[4 * kVec4 + 1] = x.y;
      }
#pragma unroll
      for (int i = 0; i < kRowsT; ++i)
#pragma unroll
        for (int c = 0; c < kColsT; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
  cp_async_wait_all();  // nothing in flight at exit (nk = 0 leaves Q's copy)

#pragma unroll
  for (int i = 0; i < kRowsT; ++i) {
#pragma unroll
    for (int w = 1; w < kLanes; w <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
  }
#pragma unroll
  for (int i = 0; i < kRowsT; ++i) {
    const int row = q0 + kRowsT * g + i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* out = o + ((long long)bh * sq + row) * D;
#pragma unroll
    for (int u = 0; u < kVec4; ++u)
      *reinterpret_cast<float4*>(out + 4 * (t + kLanes * u)) =
          make_float4(acc[i][4 * u] / den, acc[i][4 * u + 1] / den, acc[i][4 * u + 2] / den,
                      acc[i][4 * u + 3] / den);
    if constexpr (kVec2)
      *reinterpret_cast<float2*>(out + 64 * kVec4 + 2 * t) =
          make_float2(acc[i][4 * kVec4] / den, acc[i][4 * kVec4 + 1] / den);
  }
}

// the dynamic shared memory an instance needs, and the carveout that lets
// two blocks share an SM
template <int D>
cudaError_t f32_attributes() {
  cudaError_t e = cudaFuncSetAttribute(flash_attention_f32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)f32_smem_bytes<D>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_attention_f32_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

template <int D>
int launch_f32_d(const void* q, const void* k, const void* v, void* o, int bh, int group,
                 int sq, int skv, float scale, int causal, void* stream) {
  const cudaError_t e = f32_attributes<D>();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)bh, (unsigned)((sq + kBQ - 1) / kBQ));
  flash_attention_f32_kernel<D><<<grid, kF32Threads, f32_smem_bytes<D>(),
                                  (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, group, sq, skv,
      scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

// registers and local bytes a thread, dynamic shared bytes, and resident
// blocks an SM, as the runtime reports them for `kernel`
template <typename Kernel>
int instance_info(Kernel kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)smem;
  info[3] = blocks;
  return 0;
}

template <int D>
int f32_info(int* info) {
  const cudaError_t e = f32_attributes<D>();
  if (e != cudaSuccess) return (int)e;
  return instance_info(flash_attention_f32_kernel<D>, kF32Threads, f32_smem_bytes<D>(), info);
}

template <int D>
int wgmma_info(int* info) {
  const cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)wgmma_smem_bytes<D>());
  if (e != cudaSuccess) return (int)e;
  return instance_info(flash_attention_wgmma_kernel<D>, kWG * 128, wgmma_smem_bytes<D>(),
                       info);
}

}  // namespace

// q, o: (bh, sq, d) row-major; k, v: (bh / group, skv, d) row-major; all
// float32 and 16-byte aligned (cp.async).  d in {32, 64, 96, 128}: the
// float32 body.
extern "C" int flash_attention_launch_f32(const void* q, const void* k,
                                          const void* v, void* o, int bh,
                                          int group, int sq, int skv, int d,
                                          float scale, int causal,
                                          void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (group <= 0 || bh % group != 0 || skv < 0 || (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  switch (d) {
    case 32: return launch_f32_d<32>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 64: return launch_f32_d<64>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 96: return launch_f32_d<96>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    case 128: return launch_f32_d<128>(q, k, v, o, bh, group, sq, skv, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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

// one instance's resources as the runtime reports them: info[0] registers
// a thread, info[1] local (spill and stack) bytes a thread, info[2] dynamic
// shared bytes a block, info[3] resident blocks an SM.  body 0 is the
// float32 body, 1 the wgmma body; an instance that does not exist returns
// cudaErrorInvalidValue.
extern "C" int flash_attention_instance_info(int body, int d, int* info) {
  switch (body * 1000 + d) {
    case 32: return f32_info<32>(info);
    case 64: return f32_info<64>(info);
    case 96: return f32_info<96>(info);
    case 128: return f32_info<128>(info);
    case 1016: return wgmma_info<16>(info);
    case 1032: return wgmma_info<32>(info);
    case 1064: return wgmma_info<64>(info);
    case 1128: return wgmma_info<128>(info);
    default: return (int)cudaErrorInvalidValue;
  }
}
