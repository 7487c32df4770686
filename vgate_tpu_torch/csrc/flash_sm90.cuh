// The Hopper tile pipeline shared by the flash-prefill kernel
// (flash_prefill.cu, K2) and the bf16 path of the paged multi-token
// kernel (paged_multitok.cu, K3).
//
// One CTA owns 128 query rows of one (batch row, head) and walks the live
// key tiles of kN keys (128 at head dims 64 and 128, 64 at 256, where the
// output accumulator alone takes 128 registers a thread):
//  * 3 warpgroups (384 threads).  Warpgroup 0 is the producer: it gives
//    registers back (setmaxnreg.dec 40) and one warp of it issues the
//    copies (TMA) into a ring of stages, each with full and empty barriers
//    (mbarriers) for K and for V.  Warpgroups 1 and 2 are the consumers
//    (setmaxnreg.inc 232), each owning 64 query rows.
//  * S = Q K^T: one wgmma m64n{kN}k16 per 16 head dims, both operands in
//    128-byte-swizzled shared memory (K stored [key][d] is the K-major B
//    operand).  The online softmax runs on the accumulator registers: a
//    row's values sit in one quad of threads, two shuffles give its max,
//    the row sums stay per thread until the epilogue.  Base 2, log2(e)
//    folded into the scale.  The causal, length and window masks run only
//    on tiles that cross the diagonal, seq_len or the window's edge.
//  * O += P V: P, converted to bf16 in registers, is the A operand of an
//    RS-form wgmma m64n{hd}k16 (a 16-key slice of the accumulator's layout
//    is the A fragment's layout), V the MN-major B operand (transpose
//    bit).  O stays in registers, is rescaled there, and the epilogue
//    normalises it and writes bf16.
// Shared memory: Q (128 x hd) and the stages' K and V (kN x hd each), all
// as 64-column blocks of 128-byte rows, the TMA box and the wgmma swizzle
// atom: 160-224 KB, one CTA an SM.
//
// The two kernels schedule the pipeline differently (Cfg), as measured on
// the card (PERF.md).  K2's causal query tiles differ in work (1 to
// S / 128 key tiles) and its K and V fit in L2: its CTAs start longest
// rows first across the grid, the ring has 3 stages where shared memory
// allows (hd <= 128), the consumers take turns issuing S = Q K^T (named
// barriers: one's softmax runs under the other's products), and K's stage
// is freed before V's.  K3's query tiles carry near-equal work (the
// prefix dominates) and its K and V outgrow L2 at long contexts: its CTAs
// keep the query tiles and heads of one (slot, kv head) adjacent, with 2
// stages freed whole and each page's K and V boxes issued together.
//
// Masked scores take the reference's -1e30 sentinel and the output divides
// by max(l, 1e-30), so a fully masked row yields finite garbage, never
// NaN, as the TPU kernels do.  The softcap uses the precise tanhf.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vgt_sm90 {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;     // query rows a CTA: two consumers of 64
constexpr int kThreads = 384;  // the producer warpgroup and two consumers
constexpr int kMaxStages = 3;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The tile sizes, the shared-memory layout and the schedule of one kernel:
// kPaged for K3 (K and V through a page table), else K2.
template <int HD, bool kPaged>
struct Cfg {
  static_assert(HD == 64 || HD == 128 || HD == 256, "head dim");
  static constexpr int kHD = HD;
  static constexpr int kN = HD == 256 ? 64 : 128;  // keys a tile
  static constexpr int kBlocks = HD / 64;          // 64-column blocks
  static constexpr uint32_t kQBlock = kRows * 128;  // bytes of a Q block
  static constexpr uint32_t kKVBlock = kN * 128;    // of a K or V block
  static constexpr uint32_t kQBytes = kBlocks * kQBlock;
  static constexpr uint32_t kKVBytes = kBlocks * kKVBlock;
  // the schedule (see the note at the top)
  static constexpr int kStages = kPaged || HD == 256 ? 2 : 3;
  static constexpr bool kTurns = !kPaged && kStages >= 3;
  static constexpr bool kJointRelease = kPaged;  // K and V freed together
  static constexpr bool kLongestFirst = !kPaged;
  // V rows at or past seq_len of a paged tile may be stale or never
  // copied: zero them before P V, so 0 x garbage cannot make a NaN
  static constexpr bool kZeroTail = kPaged;
  // offsets from the 1024-aligned base of the dynamic shared memory
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + kQBytes;
  static constexpr uint32_t v = k + kStages * kKVBytes;
  static constexpr uint32_t bar = v + kStages * kKVBytes;
  static constexpr uint32_t bytes = bar + 128 + 1024;  // barriers, alignment
  static_assert(bytes <= 232448, "shared memory of a block");
};

// barriers at Cfg::bar: full Q, then a stage's full K, full V, empty K and
// empty V (with kJointRelease, empty V frees the whole stage)
__device__ __forceinline__ uint32_t full_q(uint32_t bar) { return bar; }
__device__ __forceinline__ uint32_t full_k(uint32_t bar, int s) {
  return bar + 8 + 8 * s;
}
__device__ __forceinline__ uint32_t full_v(uint32_t bar, int s) {
  return bar + 8 + 8 * kMaxStages + 8 * s;
}
__device__ __forceinline__ uint32_t empty_k(uint32_t bar, int s) {
  return bar + 8 + 16 * kMaxStages + 8 * s;
}
__device__ __forceinline__ uint32_t empty_v(uint32_t bar, int s) {
  return bar + 8 + 24 * kMaxStages + 8 * s;
}

// The CTA's (query tile, head, batch row) on a grid (query tiles, heads,
// batch rows).  kLongestFirst: the query tile varies slowest in launch
// order, last tile first, so the longest causal rows start first across
// the whole grid (the heads of one kv head still run side by side).  Else
// the query tiles of one (head, batch row) are adjacent, last first.
template <bool kLongestFirst>
__device__ __forceinline__ void tile_coords(int& qt, int& h, int& b) {
  if constexpr (kLongestFirst) {
    const int heads_rows = gridDim.y * gridDim.z;
    const int linear =
        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    qt = gridDim.x - 1 - linear / heads_rows;
    h = linear % heads_rows % gridDim.y;
    b = linear % heads_rows / gridDim.y;
  } else {
    qt = gridDim.x - 1 - blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
  }
}

// What one CTA attends, in global positions: tile row r sits at q_start +
// r and sees key t when t <= q_start + r, t < seq_len and, with window >
// 0, q_start + r - t < window.
struct Tile {
  int q_start;
  int n_rows;   // rows to write (the rest of the 128 are past the input)
  int n_live;   // rows worth computing (<= n_rows); a consumer with none
                // writes zeros
  int seq_len;
  int window;
  int kt_lo, kt_hi;  // live key tiles (none when kt_hi < kt_lo)
};

// live key tiles: causal to the last live row, below seq_len, and not
// wholly below the window of the first row
template <class C>
__device__ __forceinline__ void key_tiles(Tile& t) {
  constexpr int kN = C::kN;
  const int end = min(t.q_start + t.n_live, t.seq_len);  // keys < end
  t.kt_hi = end > 0 ? (end - 1) / kN : -1;
  t.kt_lo = t.window > 0 ? max(0, t.q_start - t.window + 1) / kN : 0;
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits for the phase of `parity` to complete.  A wait of more than ~2^34
// cycles (seconds) means an arrival was lost: trap, so the launch fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving register reads or writes across an
// asynchronous wgmma that owns these registers
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory matrix descriptors, 128-byte swizzle (layout type 1).  A
// 64-column block holds 128-byte rows; 8 rows (1024 bytes) are one
// swizzle atom.
__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return static_cast<uint64_t>((bytes & 0x3FFFF) >> 4);
}
// K-major (Q as A, K as B): the 16 k-values of an instruction lie inside
// one 128-byte row, so a k-step adds 32 bytes to the start; 8-row groups
// are 1024 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_field(addr) | desc_field(16) << 16 | desc_field(1024) << 32 |
         1ull << 62;
}
// MN-major (V as B, keys along k): 8 keys are one atom, the next 8 keys
// 1024 bytes on (stride byte offset), the next 64 head dims one column
// block on (leading byte offset)
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t block_bytes) {
  return desc_field(addr) | desc_field(block_bytes) << 16 |
         desc_field(1024) << 32 | 1ull << 62;
}

// ------------------------------------------------------------------ wgmma

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared
// memory (descriptors); scale_d 0 overwrites D
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared
// memory (descriptors); scale_d 0 overwrites D
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a,
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the fragment
// layout of a 64 x 16 slice of the accumulator), B MN-major in shared
// memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (the fragment
// layout of a 64 x 16 slice of the accumulator), B MN-major in shared
// memory
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A in registers (the fragment
// layout of a 64 x 16 slice of the accumulator), B MN-major in shared
// memory
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// --------------------------------------------------------------- consumer

constexpr int kTurnBar = 3;  // named barriers 3 and 4: the consumers' turns

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// S = Q K^T of this warpgroup's 64 rows and one key tile
template <class C>
__device__ __forceinline__ void issue_qk(float (&s)[C::kN / 2],
                                         uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < C::kHD / 16; ++kk)
    mma_ss(s, desc_kmajor(q_base + (kk >> 2) * C::kQBlock + (kk & 3) * 32),
           desc_kmajor(k_base + (kk >> 2) * C::kKVBlock + (kk & 3) * 32),
           kk > 0);
}

// O += P V over one key tile, P the bf16 A fragments in registers
template <class C>
__device__ __forceinline__ void issue_pv(float (&o)[C::kHD / 2],
                                         uint32_t (&p)[C::kN / 4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < C::kN / 16; ++kk)
    mma_rs(o, &p[4 * kk], desc_mnmajor(v_base + kk * 2048, C::kKVBlock));
}

// One consumer warpgroup (c = 0 or 1): rows 64c..64c+63 of the CTA's tile.
// Per key tile: S = Q K^T (K's stage released once it is done, unless
// Cfg::kJointRelease), the online softmax on the accumulators, O += P V
// (then V's stage, or the whole stage, released).  With Cfg::kTurns the
// two consumers issue their S products in turn (named barriers), so one's
// softmax runs under the other's products.  With Cfg::kZeroTail the V
// rows at or past seq_len are zeroed before P V.
template <class C>
__device__ __forceinline__ void consume(const Tile& t, int c, uint32_t base,
                                        unsigned char* gbase, float qk_scale,
                                        float cap_log2, bf16* out,
                                        size_t out_stride) {
  constexpr int HD = C::kHD;
  constexpr int kN = C::kN;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // accumulator layout: element i of a thread is row `row + 8 * ((i >> 1)
  // & 1)`, column 8 * (i >> 2) + quad_col + (i & 1)
  const int row = 64 * c + 16 * warp + (lane >> 2);
  const int quad_col = 2 * (lane & 3);
  const uint32_t bar = base + C::bar;

  if (64 * c >= t.n_live) {  // no live row: finite zeros, nothing read
    for (int i = tid; i < 64 * (HD / 8); i += 128) {
      const int r = 64 * c + i / (HD / 8);
      if (r < t.n_rows)
        *reinterpret_cast<uint4*>(out + (size_t)r * out_stride +
                                  (i % (HD / 8)) * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int q_lo = t.q_start + 64 * c;  // this warpgroup's first position
  const int q_hi = q_lo + min(64, t.n_live - 64 * c) - 1;
  const int pos = t.q_start + row;  // the thread's first row; second +8
  const uint32_t q_base = base + C::q + c * 64 * 128;
  const int n = t.kt_hi - t.kt_lo + 1;
  // turns: the S product of tile i by consumer 0, then by consumer 1,
  // then tile i + 1 ...; consumer 1 opens the first turn and does not
  // pass on after the last tile
  const bool turns = C::kTurns && t.n_live > 64;
  if (turns && c == 1 && n > 0) bar_arrive(kTurnBar, 256);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  mbar_wait(full_q(bar), 0);
  int st = 0;
  uint32_t ph = 0;  // stage and phase of tile i
  for (int i = 0; i < n; ++i) {
    const int k_start = (t.kt_lo + i) * kN;
    // a tile none of this warpgroup's rows sees: no product, no softmax
    const bool live =
        !(k_start > q_hi ||
          (t.window > 0 && k_start + kN - 1 <= q_lo - t.window));
    float s[kN / 2];
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) s[j] = 0.f;
    mbar_wait(full_k(bar, st), ph);
    if (turns) bar_sync(kTurnBar + c, 256);
    fence_regs(s);
    wg_fence();
    if (live) issue_qk<C>(s, q_base, base + C::k + st * C::kKVBytes);
    wg_commit();
    if (turns && !(c == 1 && i == n - 1))
      bar_arrive(kTurnBar + (c ^ 1), 256);
    wg_wait_all();
    fence_regs(s);
    if (!C::kJointRelease) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k(bar, st));  // this warp is done
    }

    uint32_t p[kN / 4];
    if (live) {
      // scores to base 2: s * scale * log2(e), or the softcap's
      // cap * tanh(s * scale / cap) * log2(e)
      if (cap_log2 > 0.f) {
#pragma unroll
        for (int j = 0; j < kN / 2; ++j)
          s[j] = cap_log2 * tanhf(s[j] * qk_scale);
      } else {
#pragma unroll
        for (int j = 0; j < kN / 2; ++j) s[j] *= qk_scale;
      }
      // masks only where the tile crosses the diagonal, seq_len or the
      // window's edge for some row of this warpgroup
      const bool edge = k_start + kN - 1 > q_lo ||
                        k_start + kN > t.seq_len ||
                        (t.window > 0 && q_hi - k_start >= t.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kN / 2; ++j) {
          const int q_pos = pos + ((j >> 1) & 1) * 8;
          const int k_pos = k_start + 8 * (j >> 2) + quad_col + (j & 1);
          bool ok = k_pos <= q_pos && k_pos < t.seq_len;
          if (t.window > 0) ok = ok && q_pos - k_pos < t.window;
          s[j] = ok ? s[j] : kNeg;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = ex2(m0 - mx0);
      const float a1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        s[4 * j] = ex2(s[4 * j] - mx0);
        s[4 * j + 1] = ex2(s[4 * j + 1] - mx0);
        s[4 * j + 2] = ex2(s[4 * j + 2] - mx1);
        s[4 * j + 3] = ex2(s[4 * j + 3] - mx1);
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;  // the unrounded p; P V takes it in bf16
      l1 = l1 * a1 + sum1;
      // the A fragment of keys 16kk..16kk+15 is elements 8kk..8kk+7
#pragma unroll
      for (int j = 0; j < kN / 4; ++j)
        p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
    }

    mbar_wait(full_v(bar, st), ph);
    if (live) {
      if constexpr (C::kZeroTail) {
        if (k_start + kN > t.seq_len) {
          const int r0 = max(t.seq_len - k_start, 0);
          for (int e = tid; e < (kN - r0) * 8 * C::kBlocks; e += 128) {
            const int blk = e / ((kN - r0) * 8);
            const int rem = e % ((kN - r0) * 8);
            *reinterpret_cast<uint4*>(gbase + C::v + st * C::kKVBytes +
                                      blk * C::kKVBlock +
                                      (r0 + rem / 8) * 128 + (rem % 8) * 16) =
                make_uint4(0, 0, 0, 0);
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          bar_sync(1 + c, 128);
        }
      }
      fence_regs(p);
      fence_regs(o);
      wg_fence();
      issue_pv<C>(o, p, base + C::v + st * C::kKVBytes);
      wg_commit();
      wg_wait_all();
      fence_regs(o);
      fence_regs(p);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_v(bar, st));
    if (++st == C::kStages) {
      st = 0;
      ph ^= 1;
    }
  }

  // the row sums of the quad, then normalise and write the rows < n_rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (row < t.n_rows) {
    bf16* dst = out + (size_t)row * out_stride + quad_col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
  }
  if (row + 8 < t.n_rows) {
    bf16* dst = out + (size_t)(row + 8) * out_stride + quad_col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// --------------------------------------------------------------- producer

// One warp: lane 0 issues Q, then each key tile's K and V into the ring as
// the consumers free its stages.  `Loader` says where the rows come from:
// ids(kt, lane) is a per-lane value read one tile ahead (K3: the page id of
// the tile's lane-th box); load_kv(kt, ids, ...) waits for the stage's K
// (then V) to be released (`parity` of its empty barriers; with
// Cfg::kJointRelease the empty V barrier frees both), arms the full
// barrier and issues the copies.
template <class C, typename Loader>
__device__ __forceinline__ void produce(const Loader& ld, const Tile& t,
                                        uint32_t base) {
  const int lane = threadIdx.x & 31;
  const uint32_t bar = base + C::bar;
  if (lane == 0) {
    ld.prefetch();
    mbar_expect_tx(full_q(bar), C::kQBytes);
    for (int cb = 0; cb < C::kBlocks; ++cb)
      ld.load_q(base + C::q + cb * C::kQBlock, full_q(bar), cb);
  }
  const int n_tiles = t.kt_hi - t.kt_lo + 1;
  int ids = n_tiles > 0 ? ld.ids(t.kt_lo, lane) : 0;
  int st = 0;
  uint32_t ph = 1;  // the first round of empty barriers passes at once
  for (int i = 0; i < n_tiles; ++i) {
    const int next = i + 1 < n_tiles ? ld.ids(t.kt_lo + i + 1, lane) : 0;
    ld.load_kv(t.kt_lo + i, ids, lane, base + C::k + st * C::kKVBytes,
               base + C::v + st * C::kKVBytes, full_k(bar, st),
               full_v(bar, st), empty_k(bar, st), empty_v(bar, st), ph);
    ids = next;
    if (++st == C::kStages) {
      st = 0;
      ph ^= 1;
    }
  }
}

// The whole CTA: barriers, then the producer warpgroup and the two
// consumers on their own paths to the end (setmaxnreg needs paths that
// never reconverge).  `out` is the tile's row 0, rows out_stride apart.
template <class C, typename Loader>
__device__ __forceinline__ void attend(const Loader& ld, const Tile& t,
                                       unsigned char* smem, float scale,
                                       float softcap, bf16* out,
                                       size_t out_stride) {
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle atom's
  unsigned char* gbase = smem + (base - raw);
  const uint32_t bar = base + C::bar;
  const int wg = threadIdx.x >> 7;
  const int n_cons = t.n_live > 64 ? 2 : 1;  // consumers with live rows
  if (threadIdx.x == 0) {
    mbar_init(full_q(bar), 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full_k(bar, s), 1);
      mbar_init(full_v(bar, s), 1);
      // one arrival a warp
      if (!C::kJointRelease) mbar_init(empty_k(bar, s), 4 * n_cons);
      mbar_init(empty_v(bar, s), 4 * n_cons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) produce<C>(ld, t, base);
  } else {
    setmaxnreg_inc<232>();
    const float qk_scale = softcap > 0.f ? scale / softcap : scale * kLog2e;
    const float cap_log2 = softcap > 0.f ? softcap * kLog2e : 0.f;
    consume<C>(t, wg - 1, base, gbase, qk_scale, cap_log2, out, out_stride);
  }
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 tensor map with 128-byte swizzle.  dims and box innermost first
// (dim 0 the contiguous head dim, its box 64 columns); strides in bytes of
// dims 1..rank-1.  Rows past a dim read as zeros.  False on failure.
inline bool bf16_map(CUtensorMap* map, const void* ptr, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the 4-D map of a [B, S, heads, HD] bf16 tensor, boxes of `rows` rows of
// one head
template <int HD>
inline bool rows_map(CUtensorMap* map, const void* ptr, int B, int S,
                     int heads, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)S * heads * HD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return bf16_map(map, ptr, 4, dims, strides, box);
}

// Set the dynamic shared-memory limit of `kern` once, then launch.
template <class C, typename Kernel, typename... Args>
cudaError_t launch_sm90(Kernel kern, bool& configured, dim3 grid,
                        cudaStream_t stream, Args... args) {
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kern<<<grid, kThreads, C::bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace vgt_sm90
