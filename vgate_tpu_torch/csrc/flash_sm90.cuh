// The Hopper tile pipeline shared by the flash-prefill kernel
// (flash_prefill.cu, K2) and both modes of the paged multi-token kernel
// (paged_multitok.cu, K3 on bf16 pools and K3-int8 on int8 pools), and the
// int8 -> bf16 widening stage that K3-int8 and the dequant matmul
// (dequant_matmul.cu, K4) share, with its int4 variant (K5).
//
// One CTA owns 128 query rows of one (batch row, head) and walks the live
// key tiles of kN keys (128 at head dims 64 and 128, 64 at 256, where the
// output accumulator alone takes 128 registers a thread):
//  * 3 warpgroups (384 threads).  Warpgroup 0 is the producer: it gives
//    registers back (setmaxnreg.dec 40; 56 in the int8 mode, where it
//    widens) and one warp of it issues the copies (TMA) into a ring of
//    stages, each with full and empty barriers (mbarriers) for K and for
//    V.  Warpgroups 1 and 2 are the consumers (setmaxnreg.inc 232; 224),
//    each owning 64 query rows.
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
// The int8 mode (Cfg kInt8, K3-int8): each page's int8 K and V rows and
// their bf16 per-token scales come by bulk copy (cp.async.bulk, one
// contiguous run of rows a page) into an int8 staging ring; the producer
// warpgroup's other three warps widen each staged tile to bf16 (exact,
// unscaled) into the same swizzled K and V stages the bf16 mode fills by
// TMA, and the scales to fp32 beside them (0 at or past seq_len), and
// arrive on the stage's full K / full V barriers themselves.  The
// consumers run the same products; they multiply each score column by its
// key's K scale before the softcap and the mask, and the softmax weights
// by the V scale after the row sum l has taken them (l stays unweighted),
// as the TPU kernel folds them.  int8 rows are always finite and scales
// past seq_len are 0, so no V row needs zeroing.
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
//
// The partial mode (kPartial; K2-ring and K3-sp, the sequence-parallel
// prompt and suffix passes): the consumers write each row's unnormalised
// fp32 state instead of the bf16 row, acc [.., HD], m (in natural units,
// the reference's: the kernel's are base 2) and l, which merge by
// log-sum-exp over the sp ranks; a row that saw no key has its weights
// zeroed rather than taking p = 1 at the sentinel, so it comes out acc = 0,
// m = -1e30, l = 0.  K3-sp also masks the keys of pages another sp rank
// owns (PartialOut::shard; the loader reads the rank's local page 0, which
// holds zeros, in their place).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace vgt_sm90 {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;     // query rows a CTA: two consumers of 64
constexpr int kThreads = 384;  // the producer warpgroup and two consumers
constexpr int kMaxStages = 3;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The tile sizes, the shared-memory layout and the schedule of one kernel:
// kPaged for K3 (K and V through a page table), else K2; kInt8 for K3's
// int8 mode (int8 K and V widened in shared memory).
template <int HD, bool kPaged, bool kInt8 = false>
struct Cfg {
  static_assert(HD == 64 || HD == 128 || HD == 256, "head dim");
  static_assert(kPaged || !kInt8, "the int8 mode is K3's");
  static constexpr int kHD = HD;
  static constexpr bool kI8 = kInt8;
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
  // copied: zero them before P V, so 0 x garbage cannot make a NaN (the
  // int8 mode zeroes their scales instead)
  static constexpr bool kZeroTail = kPaged && !kInt8;
  // the int8 mode: a stage's fp32 K and V scales (kN each) beside the
  // widened tiles, and a staging ring of int8 K, V and bf16 scales
  static constexpr uint32_t kScBytes = kInt8 ? 8 * kN : 0;
  static constexpr int kStages8 = kInt8 ? (HD == 64 ? 2 : 1) : 0;
  static constexpr uint32_t kKV8Bytes = kN * HD;  // an int8 K or V tile
  static constexpr uint32_t kStage8Bytes = 2 * kKV8Bytes + 4 * kN;
  static constexpr int kWidenThreads = 96;  // the producer's warps 1-3
  // registers a thread after setmaxnreg (128 x producer + 256 x consumer
  // within the 384 x 168 the CTA starts with): the widening needs more
  // than the copy warp's 40
  static constexpr int kProducerRegs = kInt8 ? 56 : 40;
  static constexpr int kConsumerRegs = kInt8 ? 224 : 232;
  // offsets from the 1024-aligned base of the dynamic shared memory
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + kQBytes;
  static constexpr uint32_t v = k + kStages * kKVBytes;
  static constexpr uint32_t sc = v + kStages * kKVBytes;
  static constexpr uint32_t s8 = sc + kStages * kScBytes;
  static constexpr uint32_t bar = s8 + kStages8 * kStage8Bytes;
  static constexpr uint32_t bytes = bar + 256 + 1024;  // barriers, alignment
  static_assert(bytes <= 232448, "shared memory of a block");
};

// barriers at Cfg::bar: full Q, then a stage's full K, full V, empty K and
// empty V (with kJointRelease, empty V frees the whole stage), then the
// int8 staging ring's full and empty barriers, K and V apart (index 2 *
// stage + 0 for K, + 1 for V)
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
__device__ __forceinline__ uint32_t full_8(uint32_t bar, int i) {
  return bar + 8 + 32 * kMaxStages + 8 * i;
}
__device__ __forceinline__ uint32_t empty_8(uint32_t bar, int i) {
  return bar + 8 + 48 * kMaxStages + 8 * i;
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

// The partial mode's outputs (see the note at the top): the tensors acc
// [B, S, H, HD], m and l [B, S, H] in fp32, and for K3-sp the slot's
// page-table row and this rank's pages [base, base + shard) (shard 0:
// every key is the rank's).
struct PartialOut {
  float* acc;
  float* m;
  float* l;
  size_t acc_stride, ml_stride;  // between a tile's rows (set by at())
  const int* pt_row;
  int ps, base, shard;

  // the outputs of query tile row0 of (batch row b, head h)
  __device__ PartialOut at(int b, int S, int row0, int H, int h,
                           int HD) const {
    PartialOut p = *this;
    const size_t r = ((size_t)b * S + row0) * H + h;
    p.acc = acc + r * HD;
    p.m = m + r;
    p.l = l + r;
    p.acc_stride = (size_t)H * HD;
    p.ml_stride = H;
    return p;
  }
  // rows [r0, r1) of the tile saw no key
  template <int HD>
  __device__ void empty_rows(int r0, int r1, int tid, int threads) const {
    for (int i = tid; i < (r1 - r0) * HD; i += threads) {
      const int r = r0 + i / HD;
      acc[r * acc_stride + i % HD] = 0.f;
      if (i % HD == 0) {
        m[r * ml_stride] = kNeg;
        l[r * ml_stride] = 0.f;
      }
    }
  }
  // whether key position k_pos (below seq_len) lies on this rank's pages
  __device__ bool owns(int k_pos) const {
    if (shard == 0) return true;
    const int pg = pt_row[k_pos / ps] - base;
    return pg >= 0 && pg < shard;
  }
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

// one contiguous run of `bytes` (a multiple of 16; both addresses on 16
// bytes) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy writes to shared memory (the widening) made visible to
// the async proxy (wgmma, TMA) before the barrier that publishes them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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
// all but the newest committed group done
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
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

// ------------------------------------------------ int8 -> bf16 widening

// two int8 values (the bytes of u that `sel` picks) as a bf16 pair,
// exactly, in four instructions: with byte y of b in a bf16 lane 0x43yy,
// m = 0x4300 | (y & 0x7F) is 128 + (y & 0x7F) and s = 0x4300 | (y & 0x80)
// is 128 (b >= 0) or 256 (b < 0), and m - s is b (exact: an integer of
// at most 8 bits)
__device__ __forceinline__ uint32_t widen_pair(uint32_t u, uint32_t sel) {
  const uint32_t t = __byte_perm(u, 0x43434343u, sel);  // 0x43yy 0x43yy
  const uint32_t m = t & 0xFF7FFF7Fu;
  const uint32_t s = t & 0xFF80FF80u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                                   *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// 8 int8 values -> 8 bf16 (16 bytes), in order
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  return make_uint4(widen_pair(raw.x, 0x5140), widen_pair(raw.x, 0x5342),
                    widen_pair(raw.y, 0x5140), widen_pair(raw.y, 0x5342));
}

// The two bf16 chunks 2j and 2j + 1 (lo, hi) of row r of a tile of
// BLOCK_ROWS-row 64-column blocks with the 128-byte swizzle (see
// widen_tile): chunk c = 2j + h sits in block c >> 3 at position
// (c & 7) ^ (r & 7); the odd one is stored first where (j >> 2) is odd
template <int BLOCK_ROWS>
__device__ __forceinline__ void store_chunk_pair(unsigned char* dst, int r,
                                                 int j, uint4 lo, uint4 hi) {
  unsigned char* row = dst + (j >> 2) * (BLOCK_ROWS * 128) + r * 128;
  const int c0 = (2 * j) & 7;
  const int odd_first = (j >> 2) & 1;
  const int s0 = ((c0 + odd_first) ^ (r & 7)) << 4;
  const int s1 = ((c0 + 1 - odd_first) ^ (r & 7)) << 4;
  *reinterpret_cast<uint4*>(row + s0) = odd_first ? hi : lo;
  *reinterpret_cast<uint4*>(row + s1) = odd_first ? lo : hi;
}

// Chunk i of a dense int8 tile of ROWS rows of COLS values (16 values of
// row i / (COLS / 16)) widened into the bf16 tile at dst (see widen_tile)
template <int ROWS, int COLS>
__device__ __forceinline__ void widen_chunk(unsigned char* dst,
                                            const unsigned char* src,
                                            int i) {
  constexpr int CH = COLS / 16;  // 16-byte int8 chunks a row
  const int r = i / CH;
  const int j = i % CH;
  const uint4 raw = *reinterpret_cast<const uint4*>(src + r * COLS + j * 16);
  store_chunk_pair<ROWS>(dst, r, j, widen8(make_uint2(raw.x, raw.y)),
                         widen8(make_uint2(raw.z, raw.w)));
}

// The widening stage: a dense int8 tile of ROWS rows of COLS values (row r
// at src + r * COLS) -> bf16 in 64-column blocks of ROWS 128-byte rows
// with the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)
// of the row), the layout a TMA box lands in and both wgmma descriptor
// forms read: K-major for K3's K ([key][d]), MN-major for K3's V and K4's
// weight ([k][n]).  Thread `tid` of NT threads (a multiple of 8): a thread
// reads 16 int8 values and writes the two bf16 chunks 2j and 2j + 1 they
// become, the odd one first where (j >> 2) is odd, so a warp reads 512
// contiguous bytes and the 8 threads of each store phase hit 8 distinct
// chunk positions of a 128-byte row (no bank conflicts).  UNROLL 0
// unrolls the loop whole, so a thread's loads are all in flight at once
// (where registers allow).  dst on 1024 bytes, src on 16.
template <int ROWS, int COLS, int NT, int UNROLL>
__device__ __forceinline__ void widen_tile(unsigned char* dst,
                                           const unsigned char* src,
                                           int tid) {
  constexpr int kChunks = ROWS * COLS / 16;
  if constexpr (UNROLL == 0) {
#pragma unroll
    for (int it = 0; it < (kChunks + NT - 1) / NT; ++it) {
      const int i = tid + it * NT;
      if (kChunks % NT == 0 || i < kChunks)
        widen_chunk<ROWS, COLS>(dst, src, i);
    }
  } else {
#pragma unroll UNROLL
    for (int i = tid; i < kChunks; i += NT)
      widen_chunk<ROWS, COLS>(dst, src, i);
  }
}

// ------------------------------------------------ int4 -> bf16 widening

// The four columns of a word u of half-split packed bytes (byte c: the
// low nibble a value of the first half of k, the high nibble one of the
// second) as two bf16 pairs of each plane, exactly: with a nibble n as
// the byte y = n ^ 8 in a bf16 lane 0x43yy, the lane is 128 + (n ^ 8) =
// 136 + v for the two's-complement value v of n, and subtracting 136
// (0x4308) leaves v.  The xor with 8 is folded into the mask (one lop3 a
// plane), the shift by 4 gives the high plane from the same word, and a
// __byte_perm places the bytes of two adjacent columns in the two lanes:
// 11 instructions for 8 values.
__device__ __forceinline__ uint32_t sub136(uint32_t t) {
  const uint32_t k = 0x43084308u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
              *reinterpret_cast<const __nv_bfloat162*>(&k));
  return *reinterpret_cast<const uint32_t*>(&d);
}
__device__ __forceinline__ void widen_nibbles(uint32_t u, uint2& lo,
                                              uint2& hi) {
  const uint32_t l = (u & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = ((u >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  lo = make_uint2(sub136(__byte_perm(l, 0x43434343u, 0x5140)),
                  sub136(__byte_perm(l, 0x43434343u, 0x5342)));
  hi = make_uint2(sub136(__byte_perm(h, 0x43434343u, 0x5140)),
                  sub136(__byte_perm(h, 0x43434343u, 0x5342)));
}

// The int4 widening stage: a dense tile of ROWS packed rows of COLS bytes
// (row r at src + r * COLS) -> the bf16 tile of 2 ROWS k rows that
// widen_tile would write for the unpacked int8 tile: packed row r's low
// nibbles become k row r and its high nibbles k row ROWS + r (the step's
// k values are the first half's ROWS, then the second half's).  Thread
// `tid` of NT threads reads 16 packed bytes and writes four bf16 chunks:
// 2j and 2j + 1 of row r and of row ROWS + r (the same swizzle positions,
// since ROWS is a multiple of 8), with widen_tile's store order, so the
// reads are contiguous and the stores free of bank conflicts.  The loop
// is unrolled whole.  dst on 1024 bytes, src on 16.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void widen_tile_i4(unsigned char* dst,
                                              const unsigned char* src,
                                              int tid) {
  static_assert(ROWS % 8 == 0, "whole swizzle atoms");
  constexpr int CH = COLS / 16;  // 16-byte packed chunks a row
  constexpr int kChunks = ROWS * CH;
#pragma unroll
  for (int it = 0; it < (kChunks + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (kChunks % NT != 0 && i >= kChunks) break;
    const int r = i / CH;
    const int j = i % CH;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + r * COLS + j * 16);
    uint2 l0, h0, l1, h1, l2, h2, l3, h3;
    widen_nibbles(raw.x, l0, h0);
    widen_nibbles(raw.y, l1, h1);
    widen_nibbles(raw.z, l2, h2);
    widen_nibbles(raw.w, l3, h3);
    store_chunk_pair<2 * ROWS>(dst, r, j, make_uint4(l0.x, l0.y, l1.x, l1.y),
                               make_uint4(l2.x, l2.y, l3.x, l3.y));
    store_chunk_pair<2 * ROWS>(dst, ROWS + r, j,
                               make_uint4(h0.x, h0.y, h1.x, h1.y),
                               make_uint4(h2.x, h2.y, h3.x, h3.y));
  }
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
// K-major with the 64-byte swizzle (layout type 2): 64-byte rows, 8 rows
// (512 bytes) an atom; a k-step of 16 values adds 32 bytes to the start
__device__ __forceinline__ uint64_t desc_kmajor64(uint32_t addr) {
  return desc_field(addr) | desc_field(16) << 16 | desc_field(512) << 32 |
         2ull << 62;
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

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A K-major in shared memory
// (descriptors), B K-major or, with TB 1, MN-major; scale_d 0 overwrites D
template <int TB = 0>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], as above
template <int TB = 0>
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
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], as above
template <int TB = 0>
__device__ __forceinline__ void mma_ss(float (&d)[128], uint64_t a,
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
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
// rows at or past seq_len are zeroed before P V.  With Cfg::kI8 the
// scores take the stage's K scales and P its V scales (after l).
// kPartial: the partial mode's masks and outputs (`po`, at the tile's
// row 0).
template <class C, bool kPartial = false>
__device__ __forceinline__ void consume(const Tile& t, int c, uint32_t base,
                                        unsigned char* gbase, float qk_scale,
                                        float cap_log2, bf16* out,
                                        size_t out_stride,
                                        const PartialOut& po) {
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
    if constexpr (kPartial) {
      po.empty_rows<HD>(64 * c, min(64 * c + 64, t.n_rows), tid, 128);
      return;
    }
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
    // the int8 mode's fp32 scales of this stage's keys: K, then V
    const float* ks =
        reinterpret_cast<const float*>(gbase + C::sc + st * C::kScBytes);
    if (live) {
      if constexpr (C::kI8) {
        // the per-key K scale multiplies the raw score (column
        // 8 (j >> 2) + quad_col + (j & 1))
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const float2 f = *reinterpret_cast<const float2*>(ks + 8 * j +
                                                             quad_col);
          s[4 * j] *= f.x;
          s[4 * j + 1] *= f.y;
          s[4 * j + 2] *= f.x;
          s[4 * j + 3] *= f.y;
        }
      }
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
                        (t.window > 0 && q_hi - k_start >= t.window) ||
                        (kPartial && po.shard > 0);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kN / 2; ++j) {
          const int q_pos = pos + ((j >> 1) & 1) * 8;
          const int k_pos = k_start + 8 * (j >> 2) + quad_col + (j & 1);
          bool ok = k_pos <= q_pos && k_pos < t.seq_len;
          if (t.window > 0) ok = ok && q_pos - k_pos < t.window;
          if constexpr (kPartial) ok = ok && po.owns(k_pos);
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
      // the partial mode: a row that has seen no key keeps p = 0, where
      // its sentinel max would give the masked keys p = 1
      const float live0 = kPartial && mx0 == kNeg ? 0.f : 1.f;
      const float live1 = kPartial && mx1 == kNeg ? 0.f : 1.f;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        s[4 * j] = live0 * ex2(s[4 * j] - mx0);
        s[4 * j + 1] = live0 * ex2(s[4 * j + 1] - mx0);
        s[4 * j + 2] = live1 * ex2(s[4 * j + 2] - mx1);
        s[4 * j + 3] = live1 * ex2(s[4 * j + 3] - mx1);
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + sum0;  // the unrounded p; P V takes it in bf16
      l1 = l1 * a1 + sum1;
      // the A fragment of keys 16kk..16kk+15 is elements 8kk..8kk+7
      if constexpr (C::kI8) {
        // P weighted by the V scale of each key (l stays unweighted); V's
        // stage is widened by now in steady state (the widening runs a
        // tile ahead), and waiting here keeps s from living across it
        mbar_wait(full_v(bar, st), ph);
        const float* vs = ks + kN;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const float2 f = *reinterpret_cast<const float2*>(vs + 8 * j +
                                                             quad_col);
          p[2 * j] = pack_bf16(s[4 * j] * f.x, s[4 * j + 1] * f.y);
          p[2 * j + 1] = pack_bf16(s[4 * j + 2] * f.x, s[4 * j + 3] * f.y);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kN / 4; ++j)
          p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      }
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
  if constexpr (kPartial) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r >= t.n_rows) continue;
      float* dst = po.acc + (size_t)r * po.acc_stride + quad_col;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
      if ((lane & 3) == 0) {
        const float lr = half ? l1 : l0;
        const float mr = half ? m1 : m0;
        po.l[(size_t)r * po.ml_stride] = lr;
        po.m[(size_t)r * po.ml_stride] = lr > 0.f ? mr / kLog2e : kNeg;
      }
    }
    return;
  }
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

// The int8 mode's copy warp: lane 0 issues Q, then each key tile's int8
// K rows and scales, then its V rows and scales, into the staging ring as
// the widening frees each half of a stage (ld.load_kv8 waits, arms the
// half's full barrier, issues the bulk copies), so the next tile's K
// copy runs under the widening of this tile's V.  Page ids as in produce.
template <class C, typename Loader>
__device__ __forceinline__ void produce8(const Loader& ld, const Tile& t,
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
#pragma unroll
    for (int kv = 0; kv < 2; ++kv)
      ld.load_kv8(t.kt_lo + i, ids, lane, kv,
                  base + C::s8 + st * C::kStage8Bytes,
                  full_8(bar, 2 * st + kv), empty_8(bar, 2 * st + kv), ph);
    ids = next;
    if (++st == C::kStages8) {
      st = 0;
      ph ^= 1;
    }
  }
}

// The int8 mode's widening warps (tid 0..95): each staged tile, once its
// bf16 stage is free, widened into the stage, K then V, each half once
// its copies landed; the scales to fp32 beside it (0 at or past seq_len,
// whose rows may be stale or never copied); each half published by its
// full barrier after a proxy fence, and its staging half freed.
template <class C>
__device__ __forceinline__ void widen_tiles(const Tile& t, uint32_t base,
                                            unsigned char* gbase, int tid) {
  constexpr int kN = C::kN;
  const uint32_t bar = base + C::bar;
  const int n_tiles = t.kt_hi - t.kt_lo + 1;
  int s8 = 0, st = 0;
  uint32_t ph8 = 0, ph = 1;
  for (int i = 0; i < n_tiles; ++i) {
    const int k_start = (t.kt_lo + i) * kN;
    const unsigned char* src = gbase + C::s8 + s8 * C::kStage8Bytes;
    const bf16* scales = reinterpret_cast<const bf16*>(src + 2 * C::kKV8Bytes);
    float* sc = reinterpret_cast<float*>(gbase + C::sc + st * C::kScBytes);
    mbar_wait(empty_v(bar, st), ph);
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      mbar_wait(full_8(bar, 2 * s8 + kv), ph8);
      widen_tile<kN, C::kHD, C::kWidenThreads, 2>(
          gbase + (kv ? C::v : C::k) + st * C::kKVBytes,
          src + kv * C::kKV8Bytes, tid);
      for (int r = tid; r < kN; r += C::kWidenThreads)
        sc[kv * kN + r] = k_start + r < t.seq_len
                              ? __bfloat162float(scales[kv * kN + r])
                              : 0.f;
      fence_async_smem();
      mbar_arrive(empty_8(bar, 2 * s8 + kv));
      mbar_arrive(kv ? full_v(bar, st) : full_k(bar, st));
    }
    if (++s8 == C::kStages8) {
      s8 = 0;
      ph8 ^= 1;
    }
    if (++st == C::kStages) {
      st = 0;
      ph ^= 1;
    }
  }
}

// The whole CTA: barriers, then the producer warpgroup and the two
// consumers on their own paths to the end (setmaxnreg needs paths that
// never reconverge).  `out` is the tile's row 0, rows out_stride apart;
// kPartial: `po` (at the tile's row 0) instead.
template <class C, bool kPartial = false, typename Loader>
__device__ __forceinline__ void attend(const Loader& ld, const Tile& t,
                                       unsigned char* smem, float scale,
                                       float softcap, bf16* out,
                                       size_t out_stride,
                                       const PartialOut& po = PartialOut{}) {
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle atom's
  unsigned char* gbase = smem + (base - raw);
  const uint32_t bar = base + C::bar;
  const int wg = threadIdx.x >> 7;
  const int n_cons = t.n_live > 64 ? 2 : 1;  // consumers with live rows
  if (threadIdx.x == 0) {
    mbar_init(full_q(bar), 1);
    for (int s = 0; s < C::kStages; ++s) {
      // the copy's one arrival, or one a widening thread
      mbar_init(full_k(bar, s), C::kI8 ? C::kWidenThreads : 1);
      mbar_init(full_v(bar, s), C::kI8 ? C::kWidenThreads : 1);
      // one arrival a warp
      if (!C::kJointRelease) mbar_init(empty_k(bar, s), 4 * n_cons);
      mbar_init(empty_v(bar, s), 4 * n_cons);
    }
    for (int i = 0; i < 2 * C::kStages8; ++i) {
      mbar_init(full_8(bar, i), 1);
      mbar_init(empty_8(bar, i), C::kWidenThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wg == 0) {
    setmaxnreg_dec<C::kProducerRegs>();
    if constexpr (C::kI8) {
      if (threadIdx.x < 32)
        produce8<C>(ld, t, base);
      else
        widen_tiles<C>(t, base, gbase, threadIdx.x - 32);
    } else if (threadIdx.x < 32) {
      produce<C>(ld, t, base);
    }
  } else {
    setmaxnreg_inc<C::kConsumerRegs>();
    const float qk_scale = softcap > 0.f ? scale / softcap : scale * kLog2e;
    const float cap_log2 = softcap > 0.f ? softcap * kLog2e : 0.f;
    consume<C, kPartial>(t, wg - 1, base, gbase, qk_scale, cap_log2, out,
                         out_stride, po);
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

// A tensor map: dims and box innermost first, strides in bytes of dims
// 1..rank-1.  Rows past a dim read as zeros.  False on failure.
inline bool tiled_map(CUtensorMap* map, CUtensorMapDataType type,
                      CUtensorMapSwizzle swizzle, const void* ptr, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor map with 128-byte swizzle (dim 0 the contiguous one, its
// box 64 columns: one 128-byte swizzle span)
inline bool bf16_map(CUtensorMap* map, const void* ptr, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box) {
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   CU_TENSOR_MAP_SWIZZLE_128B, ptr, rank, dims, strides, box);
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

// A 2-D map, encoded once per (address, shape, box, type, swizzle) and
// kept: a map holds nothing but those, so it stays right for whatever
// tensor lies there later.  The weights and the KV pools are static and
// the activations' addresses repeat from step to step (the caching
// allocator), so calls after the first skip the encoding.  The cache is emptied past 4096 maps.
inline bool cached_map(CUtensorMap* map, CUtensorMapDataType type,
                       CUtensorMapSwizzle swizzle, const void* ptr, int rows,
                       int cols, int elem_bytes, int box_rows, int box_cols) {
  using Key = std::tuple<const void*, int, int, int, int, int, int>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> maps;
  const Key key{ptr, rows, cols, box_rows, box_cols, (int)type,
                (int)swizzle};
  std::lock_guard<std::mutex> lock(mu);
  auto it = maps.find(key);
  if (it == maps.end()) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    CUtensorMap m;
    if (!tiled_map(&m, type, swizzle, ptr, 2, dims, strides, box))
      return false;
    if (maps.size() >= 4096) maps.clear();
    it = maps.emplace(key, m).first;
  }
  *map = it->second;
  return true;
}

// Whether a kernel's dynamic shared-memory limit is set, one flag a
// device: the limit is an attribute of the kernel on one device, and one
// process may launch on several cards (data-parallel replicas), the
// launching thread's current device being the one launched on.
class PerDevice {
 public:
  bool& flag() {
    int dev = 0;
    cudaGetDevice(&dev);
    return set_[dev & (kDevices - 1)];
  }

 private:
  static constexpr int kDevices = 64;
  bool set_[kDevices] = {};
};

// Set the dynamic shared-memory limit of `kern` once a device, then
// launch.
template <class C, int kBlockThreads = kThreads, typename Kernel,
          typename... Args>
cudaError_t launch_sm90(Kernel kern, PerDevice& configured, dim3 grid,
                        cudaStream_t stream, Args... args) {
  bool& done = configured.flag();
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
    if (err != cudaSuccess) return err;
    done = true;
  }
  kern<<<grid, kBlockThreads, C::bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace vgt_sm90
