// Paged decode attention for Hopper (sm_90a): K1 on bf16 pools and on
// int8 pools with bf16 scales (kv_cache.dtype: int8), and K6, the
// page-split decode with block_slots slots a unit, on bf16 or f32 pools.
//
// Replaces two TPU kernels of vgate_tpu/ops/pallas/paged_attention.py:
//  * K1, paged_decode_attention_pallas (body _kernel), in its plain and its
//    int8 mode (vgt_paged_decode): paged_decode_tc_kernel below, a
//    page-split decode with both products on the tensor cores;
//  * K6, paged_decode_attention_pallas_blocked (body _blocked_kernel),
//    the same function with block_slots slots a program
//    (vgt_paged_decode_blocked): paged_decode_split_kernel below, fp32 on
//    the CUDA cores.  K1's wrapper also sends f32 pools here, at
//    block_slots 1 (ops/kernels/paged_decode.py).
// Both compute one function: one query token per slot attends the slot's
// live KV pages through its page-table row, with an online softmax; GQA,
// sliding window, logit softcap and a query scale.
// Semantic spec: vgate_tpu_torch/ops/attention.py paged_decode_attention
// (int8 pools dequantized by ops/kv_quant.py gather_pages).
//
// What bounds both on an H100: bytes.  A decode step reads every live K
// and V token once (sum(seq_len) * KV * hd * 2 tensors * 2 bytes per layer
// in bf16, half that and the scales in int8) and does ~4 flops per byte,
// far below the ~295 flop/byte ridge, so the limit is the 3.35 TB/s of HBM.
//
// The split (both kernels, flash-decoding):
//  * A slot's live range (window start to seq_len) is cut into tiles of T
//    rows of one page (T = ps, or a divisor of it where a stage would not
//    hold the tile) and the tiles into chunks.  A unit of work is (a block
//    of block_slots slots, kv head, chunk c): the CTA walks chunk c of each
//    slot of the block in turn (a slot with fewer chunks is skipped).  Each
//    CTA counts the chunks of every block from seq_lens itself
//    (chunk_prefix), so only live units exist; the grid is persistent, one
//    CTA an SM, sized on the host from the SMs and the live-range bound
//    (ops/kernels/paged_decode.py decode_plan for K1, split_plan for K6),
//    and walks the units blockIdx.x, + gridDim.x, ...
//  * A CTA is a copy warpgroup (one warp copies, three leave after
//    setmaxnreg) and 8 compute warps at up to 224 registers.  The copy
//    warp streams each tile's K and V into a ring of stages with full and
//    empty mbarriers, and each unit's G query rows (contiguous in
//    [B, H, hd]) by bulk copy into one of four query buffers; its copies
//    run on across units, so no compute warp waits on a global load.  It
//    reads page-table entries only below the live count, 32 at a time by
//    its lanes.
//  * The compute warps merge their softmax states through shared memory in
//    warp order.  A slot whose live range is one chunk writes its output
//    directly; otherwise each unit writes (m, l, acc[hd]) per query head in
//    fp32 to the wrapper's cached workspace, and a second launch merges a
//    slot's chunks in chunk order (merge_chunks: merge_kernel for K6,
//    tc_merge_kernel for K1), so the result is the same from run to run.
//    (For K1, a merge by the slot's last unit to finish, after an atomic
//    ticket, measured slower than the second launch: PERF.md.)
//  * K1's invariants hold in both: no table entry at or past the live
//    count; seq_len clamped to pps * ps on the device; a window start
//    mid-page masks the page's earlier rows; -1e30 / max(l, 1e-30), so an
//    idle slot comes out finite; the precise tanhf softcap after the score,
//    before the mask.
//
// K1's design (paged_decode_tc_kernel, block_slots 1):
//  * Chunks are sized to fill the card (decode_plan: chunk_tiles tiles, at
//    least two units a CTA at the live-range bound, and no more tiles than
//    stages); a slot of one chunk writes its output directly.
//  * The copy warp brings each tile's K and V by TMA from 2-D tensor maps
//    over the layer view [KV * P * ps, hd] (encoded once per address and
//    kept, cached_map), in boxes of T rows x 128 bytes with the 128-byte
//    swizzle (64 bytes and the 64-byte swizzle for int8 rows at hd 64), so
//    the ldmatrix reads below hit 8 distinct bank groups; each box on 1024
//    bytes, T rounded up to whole m16 steps (the padding rows zeroed once).
//    int8 pools: each tile's K and V scale rows (bf16) come beside them by
//    bulk copy, or, where a page's scale row is not a multiple of 16 bytes
//    (ps % 8 != 0), by the copy warp's own loads.  Up to 12 stages.
//  * Compute: a unit's tiles go to the 8 warps in turn; each warp keeps its
//    own online softmax over its tiles, in base 2, and runs both products
//    with mma.sync m16n8k16 (bf16 in, fp32 accumulate), 16 tokens a step:
//      S^T [16 tokens x 8 heads] = K_tile . Q^T: the G <= 8 query heads of
//      the kv head on n (G 1..7 padded with zero columns), K from the stage
//      by ldmatrix, Q^T's fragment loaded once a unit;
//      O^T [hd x 8 heads] += V^T . P^T: V^T by ldmatrix.trans, P^T the
//      softmax of S^T's accumulators in bf16, transposed in registers by
//      movmatrix.
//    A lane holds the scores of two tokens for two heads, and O^T's
//    columns for the same two heads, so a step's column max takes three
//    shuffles a head pair, the row sum l stays a lane partial until the
//    unit ends, and O^T is rescaled in place.  P is rounded to bf16 before
//    the product, as in K2 and K3.
//  * int8 (K1-int8): the same kernel and ring.  The compute warps widen
//    int8 to bf16 in registers, exactly, with the byte-permute trick of
//    widen_pair (flash_sm90.cuh): ldmatrix of an int8 tile hands a lane 4
//    bytes of one row, so a dot over hd takes hd in the order of those
//    pieces (Q^T's fragment reads q in the same order), and ldmatrix.trans
//    hands it two hd values of two tokens, so O^T's rows come in the order
//    (2i, 2i + 1) of each 16 (the output store follows it).  Scales fold as
//    the TPU kernel folds them: the K scale multiplies the score before the
//    softcap and the mask, the V scale multiplies p after l took the
//    unweighted p.  No dequantized K or V exists anywhere.
//  * Rows past seq_len, before the window start, or past the tile never
//    reach the result: scores are masked by select, a bf16 tile's rows
//    outside the live range are zeroed in the stage before P V (0 x NaN is
//    NaN), and an int8 row's weight is selected to 0 rather than multiplied
//    by its scale (a stale scale may hold anything).
//
// K6's design (paged_decode_split_kernel): chunks of about 256 KB of a
// slot's K and V whatever block_slots is (shorter chunks at 8 slots a CTA
// measured slower: each chunk ends in a merge); the copy warp brings each
// tile's K and V by one cp.async.bulk each (a tile is contiguous inside
// [KV, P, ps, hd]) into a ring of up to 8 stages; the 8 compute warps split
// each tile's rows on the CUDA cores (fp32 FMAs; a lane holds EPL values
// of a token's row for each of the G heads, the state instantiated for G
// in {1, 2, 4, 8}, LPT = hd / EPL lanes a token, interleaved 16-byte
// pieces), with the online softmax updated once for each pair of tokens a
// lane group takes and acc rescaled only when some lane's max moved.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launches on the caller's stream (cudaErrorInvalidValue for a shape or
// plan the kernels do not take or a map that cannot be encoded); the
// kernels allocate nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_sm90.cuh"  // mbarriers, bulk and TMA copies, tensor maps

namespace {

constexpr float kNeg = -1e30f;  // masked / initial max, as the reference

namespace split {

using vgt_sm90::bulk_load;
using vgt_sm90::ex2;
using vgt_sm90::kLog2e;
using vgt_sm90::mbar_arrive;
using vgt_sm90::mbar_expect_tx;
using vgt_sm90::mbar_init;
using vgt_sm90::mbar_wait;
using vgt_sm90::setmaxnreg_dec;
using vgt_sm90::setmaxnreg_inc;
using vgt_sm90::smem_u32;
// A CTA: the copy warpgroup (warp 0 copies, warps 1-3 give their
// registers back and leave) and 8 compute warps, which take up to 224
// registers a thread after setmaxnreg (a CTA of 9 warps would be held to
// 168: three of its warps share one of the SM's four register files).
// 12 compute warps at 152 registers measured slower (PERF.md).
constexpr int kWarps = 8;  // compute warps
constexpr int kThreads = 128 + kWarps * 32;
constexpr int kCopyRegs = 56;
constexpr int kComputeRegs = 224;
constexpr int kMaxStages = 8;
// query buffers: the copy warp runs up to kQBufs - 1 slot-chunks ahead of
// the compute warps (a chunk at 8 slots a CTA may be 2 tiles)
constexpr int kQBufs = 4;
constexpr int kU = 2;  // tokens a lane group takes between softmax updates
constexpr int kMergeThreads = 256;
constexpr int kMaxSmem = 232448;

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The per-lane layout of one instantiation: T the pool type, GM the
// query heads a kv head the state holds (G rounded up to 1, 2, 4, 8).
template <typename T, int HD, int GM>
struct SCfg {
  static constexpr int kES = sizeof(T);
  // values a lane holds of a token's row: 32 / GM keeps q and acc at 64
  // registers; at least 4 (a paired load) and hd / 32 (a token <= 32 lanes)
  static constexpr int kEPL = cmax(cmax(32 / GM, 4), HD / 32);
  static constexpr int kLPT = HD / kEPL;  // lanes a token
  static constexpr int kTPW = 32 / kLPT;  // tokens a warp step
  static constexpr int kPB = cmin(16, kEPL * kES);  // bytes a piece
  static constexpr int kPE = kPB / kES;             // values a piece
  static constexpr int kNP = kEPL / kPE;            // pieces a lane
  static_assert(kLPT >= 1 && kLPT <= 32 && 32 % kLPT == 0, "lanes a token");
  static_assert(kNP * kPE == kEPL, "whole pieces");
};

// PE values of type T at p (PE * sizeof(T) bytes, aligned) -> fp32
template <typename T, int PE>
__device__ __forceinline__ void load_piece(const T* p, float* out) {
  if constexpr (sizeof(T) == 4) {
    static_assert(PE == 4, "f32 pieces are 16 bytes");
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (PE == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    static_assert(PE == 4, "bf16 pieces are 8 or 16 bytes");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// What the kernels know of the launch.  partial (K1-sp, K1's kernel
// only): the pools are one sp rank's shard, global pages [base, base + P)
// at local index page - base; tiles of other pages are neither copied nor
// read, and every slot's chunks merge into its unnormalised partial.
struct Geo {
  int B, H, KV, P, ps, pps, G, window;
  float scale, softcap;
  int block_slots, tile_rows, stages, chunk_tiles, max_chunks;
  int base, partial;
};

// A slot's live tiles [t0, t0 + n) and its chunk length in tiles (a slot
// with more tiles than max_chunks * chunk_tiles takes longer chunks, so
// its chunks never outnumber the workspace's).  seq_len is clamped to the
// table's width.
struct Slot {
  int sl, lo, t0, n, ct, chunks;
};
__device__ __forceinline__ Slot slot_of(const Geo& g, const int* seq_lens,
                                        int b) {
  Slot s;
  s.sl = min(max(seq_lens[b], 0), g.pps * g.ps);
  s.lo = g.window > 0 ? max(s.sl - g.window, 0) : 0;
  s.t0 = s.lo / g.tile_rows;
  s.n = s.sl > 0 ? (s.sl + g.tile_rows - 1) / g.tile_rows - s.t0 : 0;
  s.ct = max(g.chunk_tiles, (s.n + g.max_chunks - 1) / g.max_chunks);
  s.chunks = max(1, (s.n + s.ct - 1) / s.ct);  // an empty slot: one unit
  return s;
}

// The chunk units of one launch, counted on the card by the kNT threads of
// the CTA: pre[grp] becomes block grp's first unit (a block's chunk count
// is the most of its slots'), pre[n_groups] their total.  Two
// __syncthreads inside, so what thread 0 did before the call (the barriers'
// init) is visible after it.  Returns the units, kv heads included.
template <int kNT>
__device__ __forceinline__ int chunk_prefix(const Geo& geo,
                                            const int* seq_lens, int* pre) {
  const int n_groups = geo.B / geo.block_slots;
  for (int grp = threadIdx.x; grp < n_groups; grp += kNT) {
    int n = 1;
    for (int j = 0; j < geo.block_slots; ++j)
      n = max(n, slot_of(geo, seq_lens, grp * geo.block_slots + j).chunks);
    pre[grp + 1] = n;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (n_groups + 31) / 32;
    const int a = min(lane * per, n_groups), e = min(a + per, n_groups);
    int sum = 0;
    for (int i = a; i < e; ++i) sum += pre[i + 1];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - sum;
    for (int i = a; i < e; ++i) {
      run += pre[i + 1];
      pre[i + 1] = run;
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();
  return pre[n_groups] * geo.KV;
}

// unit u -> (block grp, kv head g, chunk c): kv heads vary fastest
__device__ __forceinline__ void unit_of(const int* pre, int n_groups, int KV,
                                        int u, int& grp, int& g, int& c) {
  const int gc = u / KV;
  g = u % KV;
  int lo = 0, hi = n_groups;  // the last block with pre[grp] <= gc
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= gc) lo = mid; else hi = mid;
  }
  grp = lo;
  c = gc - pre[lo];
}

// barriers: a stage's full and empty, then the query buffers' full and
// empty
constexpr int kBarBytes = 8 * 2 * (kMaxStages + kQBufs);
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) {
  return bars + 8 * s;
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (kMaxStages + s);
}
__device__ __forceinline__ uint32_t qfull_bar(uint32_t bars, int i) {
  return bars + 8 * (2 * kMaxStages + i);
}
__device__ __forceinline__ uint32_t qempty_bar(uint32_t bars, int i) {
  return bars + 8 * (2 * kMaxStages + kQBufs + i);
}

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_split_kernel(const T* __restrict__ q,        // [B, H, HD]
                          const T* __restrict__ k_pages,  // [KV, P, ps, HD]
                          const T* __restrict__ v_pages,
                          const int* __restrict__ page_tables,  // [B, pps]
                          const int* __restrict__ seq_lens,     // [B]
                          T* __restrict__ out,                  // [B, H, HD]
                          float* __restrict__ ws_ml,  // [B, KV, MC, G, 2]
                          float* __restrict__ ws_acc,  // [B, KV, MC, G, HD]
                          const Geo geo) {
  using C = SCfg<T, HD, GM>;
  constexpr int EPL = C::kEPL, LPT = C::kLPT, TPW = C::kTPW;
  constexpr int PE = C::kPE, NP = C::kNP;
  constexpr int kMergeStride = HD + 2;  // a warp's head: m, l, acc
  extern __shared__ __align__(128) unsigned char split_smem[];
  const int T_ = geo.tile_rows;
  const uint32_t tile_bytes = (uint32_t)T_ * HD * sizeof(T);
  const uint32_t stage_bytes = 2 * tile_bytes;
  const uint32_t q_bytes = (uint32_t)geo.G * HD * sizeof(T);
  const uint32_t bars = smem_u32(split_smem);
  unsigned char* ring = split_smem + kBarBytes;
  // the buffers of a slot's G query rows, then the warps' merge buffer
  T* qbuf = reinterpret_cast<T*>(ring + geo.stages * stage_bytes);
  float* mbuf = reinterpret_cast<float*>(qbuf + kQBufs * GM * HD);
  int* pre = reinterpret_cast<int*>(mbuf + kWarps * GM * kMergeStride);
  const int n_groups = geo.B / geo.block_slots;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), kWarps);
    }
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(qfull_bar(bars, i), 1);
      mbar_init(qempty_bar(bars, i), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int units = chunk_prefix<kThreads>(geo, seq_lens, pre);

  if (warp < 4) {  // the copy warpgroup
    setmaxnreg_dec<kCopyRegs>();
    if (warp != 0) return;
    int s = 0, qs = 0;
    uint32_t ph = 1, qph = 1;  // the first round of empty barriers passes
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int grp, g, c;
      unit_of(pre, n_groups, geo.KV, u, grp, g, c);
      for (int j = 0; j < geo.block_slots; ++j) {
        const int b = grp * geo.block_slots + j;
        const Slot sl = slot_of(geo, seq_lens, b);
        if (c >= sl.chunks) continue;
        const int i0 = sl.t0 + c * sl.ct;
        const int i1 = sl.t0 + min(sl.n, (c + 1) * sl.ct);
        const int* pt_row = page_tables + (size_t)b * geo.pps;
        if (lane == 0) {  // the slot's query rows (contiguous)
          mbar_wait(qempty_bar(bars, qs), qph);
          mbar_expect_tx(qfull_bar(bars, qs), q_bytes);
          bulk_load(smem_u32(qbuf + qs * GM * HD),
                    q + ((size_t)b * geo.H + g * geo.G) * HD, q_bytes,
                    qfull_bar(bars, qs));
        }
        if (++qs == kQBufs) {
          qs = 0;
          qph ^= 1;
        }
        for (int ib = i0; ib < i1; ib += 32) {
          const int ti = ib + lane;
          // only below the live count: ti < i1 <= ceil(seq_len / T)
          const int page = ti < i1 ? pt_row[ti * T_ / geo.ps] : 0;
          const int n = min(32, i1 - ib);
          for (int k = 0; k < n; ++k) {
            const int pg = __shfl_sync(0xffffffffu, page, k);
            if (lane == 0) {
              const int row0 = (ib + k) * T_ % geo.ps;
              const size_t off =
                  (((size_t)g * geo.P + pg) * geo.ps + row0) * HD;
              const uint32_t dst = smem_u32(ring + s * stage_bytes);
              mbar_wait(empty_bar(bars, s), ph);
              mbar_expect_tx(full_bar(bars, s), stage_bytes);
              bulk_load(dst, k_pages + off, tile_bytes, full_bar(bars, s));
              bulk_load(dst + tile_bytes, v_pages + off, tile_bytes,
                        full_bar(bars, s));
            }
            if (++s == geo.stages) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // the compute warps
  setmaxnreg_inc<kComputeRegs>();
  const int cw = warp - 4;    // compute warp
  const int ctid = threadIdx.x - 128;
  const int tg = lane / LPT;  // token group
  const int li = lane % LPT;  // the lane's place in its token
  const int G = geo.G;
  int s = 0, qs = 0;
  uint32_t ph = 0, qph = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int grp, g, c;
    unit_of(pre, n_groups, geo.KV, u, grp, g, c);
    for (int j = 0; j < geo.block_slots; ++j) {
      const int b = grp * geo.block_slots + j;
      const Slot sl = slot_of(geo, seq_lens, b);
      if (c >= sl.chunks) continue;  // uniform across the CTA
      const int i0 = sl.t0 + c * sl.ct;
      const int i1 = sl.t0 + min(sl.n, (c + 1) * sl.ct);

      // this lane's values of the G query rows, scaled: piece n of lane li
      // is values (n LPT + li) PE ... + PE
      float qr[GM][EPL];
      mbar_wait(qfull_bar(bars, qs), qph);
      const T* q_rows = qbuf + qs * GM * HD;
#pragma unroll
      for (int h = 0; h < GM; ++h) {
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          if (h < G) {
            load_piece<T, PE>(q_rows + h * HD + (n * LPT + li) * PE,
                              qr[h] + n * PE);
#pragma unroll
            for (int e = 0; e < PE; ++e) qr[h][n * PE + e] *= geo.scale;
          } else {
#pragma unroll
            for (int e = 0; e < PE; ++e) qr[h][n * PE + e] = 0.f;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(qempty_bar(bars, qs));
      if (++qs == kQBufs) {
        qs = 0;
        qph ^= 1;
      }
      float m[GM], l[GM], acc[GM][EPL];
#pragma unroll
      for (int h = 0; h < GM; ++h) {
        m[h] = kNeg;
        l[h] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h][e] = 0.f;
      }

      for (int i = i0; i < i1; ++i) {
        mbar_wait(full_bar(bars, s), ph);
        const T* kt = reinterpret_cast<const T*>(ring + s * stage_bytes);
        const T* vt = kt + T_ * HD;
        // the tile's live rows [ra, re)
        const int pos0 = i * T_;
        const int ra = max(sl.lo - pos0, 0);
        const int re = min(sl.sl - pos0, T_);
        // warp-uniform bounds: every lane reaches the shuffles together
        for (int r0 = cw * TPW; r0 < re; r0 += kWarps * TPW * kU) {
          float sc[kU][GM];
          bool valid[kU];
#pragma unroll
          for (int uu = 0; uu < kU; ++uu) {
            const int r = r0 + uu * kWarps * TPW + tg;
            valid[uu] = r >= ra && r < re;
            if (r0 + uu * kWarps * TPW >= re) {  // the warp's rows all past
#pragma unroll
              for (int h = 0; h < GM; ++h) sc[uu][h] = kNeg;
              continue;
            }
            float kf[EPL];
#pragma unroll
            for (int n = 0; n < NP; ++n) {
              if (valid[uu]) {
                load_piece<T, PE>(kt + r * HD + (n * LPT + li) * PE,
                                  kf + n * PE);
              } else {
#pragma unroll
                for (int e = 0; e < PE; ++e) kf[n * PE + e] = 0.f;
              }
            }
#pragma unroll
            for (int h = 0; h < GM; ++h) {
              float d = 0.f;
              if (h < G) {  // uniform
#pragma unroll
                for (int e = 0; e < EPL; ++e) d = fmaf(qr[h][e], kf[e], d);
#pragma unroll
                for (int o = LPT / 2; o > 0; o >>= 1)
                  d += __shfl_xor_sync(0xffffffffu, d, o);
                if (geo.softcap > 0.f) d = tanhf(d / geo.softcap) * geo.softcap;
              }
              // base 2 from here on (ex2 below)
              sc[uu][h] = valid[uu] ? d * kLog2e : kNeg;
            }
          }
          float p[kU][GM];
#pragma unroll
          for (int h = 0; h < GM; ++h) {
            if (h >= G) continue;
            float m_new = m[h];
#pragma unroll
            for (int uu = 0; uu < kU; ++uu) m_new = fmaxf(m_new, sc[uu][h]);
            const float alpha = ex2(m[h] - m_new);
            float lsum = 0.f;
#pragma unroll
            for (int uu = 0; uu < kU; ++uu) {
              p[uu][h] = valid[uu] ? ex2(sc[uu][h] - m_new) : 0.f;
              lsum += p[uu][h];
            }
            l[h] = l[h] * alpha + lsum;
            // rescale only where some lane's max moved (rare once it
            // settles); the vote keeps the branch warp-uniform
            if (__any_sync(0xffffffffu, m_new != m[h])) {
#pragma unroll
              for (int e = 0; e < EPL; ++e) acc[h][e] *= alpha;
            }
            m[h] = m_new;
          }
#pragma unroll
          for (int uu = 0; uu < kU; ++uu) {
            if (!valid[uu]) continue;  // V rows outside [ra, re) unread
            const int r = r0 + uu * kWarps * TPW + tg;
            float vf[EPL];
#pragma unroll
            for (int n = 0; n < NP; ++n)
              load_piece<T, PE>(vt + r * HD + (n * LPT + li) * PE,
                                vf + n * PE);
#pragma unroll
            for (int h = 0; h < GM; ++h) {
              if (h >= G) continue;
#pragma unroll
              for (int e = 0; e < EPL; ++e)
                acc[h][e] = fmaf(p[uu][h], vf[e], acc[h][e]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar(bars, s));
        if (++s == geo.stages) {
          s = 0;
          ph ^= 1;
        }
      }

      // merge the token groups of a warp (lanes li, li + LPT, ...)
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1) {
#pragma unroll
        for (int h = 0; h < GM; ++h) {
          if (h >= G) continue;
          const float m_o = __shfl_xor_sync(0xffffffffu, m[h], o);
          const float l_o = __shfl_xor_sync(0xffffffffu, l[h], o);
          const float m_new = fmaxf(m[h], m_o);
          const float a = ex2(m[h] - m_new);
          const float a_o = ex2(m_o - m_new);
          l[h] = l[h] * a + l_o * a_o;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const float acc_o = __shfl_xor_sync(0xffffffffu, acc[h][e], o);
            acc[h][e] = acc[h][e] * a + acc_o * a_o;
          }
          m[h] = m_new;
        }
      }
      if (tg == 0) {
#pragma unroll
        for (int h = 0; h < GM; ++h) {
          if (h >= G) continue;
          float* w = mbuf + (cw * GM + h) * kMergeStride;
          if (li == 0) {
            w[0] = m[h];
            w[1] = l[h];
          }
#pragma unroll
          for (int n = 0; n < NP; ++n)
#pragma unroll
            for (int e = 0; e < PE; ++e)
              w[2 + (n * LPT + li) * PE + e] = acc[h][n * PE + e];
        }
      }
      vgt_sm90::bar_sync(1, kWarps * 32);
      // merge the warps, in warp order; one chunk: the output, else the
      // chunk's partial
      const bool direct = sl.chunks == 1;
      const size_t part =
          (((size_t)b * geo.KV + g) * geo.max_chunks + c) * G;
      for (int idx = ctid; idx < G * HD; idx += kWarps * 32) {
        const int h = idx / HD;
        const int d = idx % HD;
        float m_all = kNeg;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          m_all = fmaxf(m_all, mbuf[(w * GM + h) * kMergeStride]);
        float l_all = 0.f, a_all = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float* ws = mbuf + (w * GM + h) * kMergeStride;
          const float f = ex2(ws[0] - m_all);
          l_all += ws[1] * f;
          a_all += ws[2 + d] * f;
        }
        if (direct) {
          out[((size_t)b * geo.H + g * G + h) * HD + d] =
              from_float<T>(a_all / fmaxf(l_all, 1e-30f));
        } else {
          ws_acc[(part + h) * HD + d] = a_all;
          if (d == 0) {
            ws_ml[(part + h) * 2] = m_all;
            ws_ml[(part + h) * 2 + 1] = l_all;
          }
        }
      }
      vgt_sm90::bar_sync(1, kWarps * 32);  // mbuf is reused
    }
  }
}

// A slot's chunk partials (m, l, acc) merged in chunk order and
// normalised into out, by one CTA of kMergeThreads: each chunk's (m, l)
// pair (m in base 2) is read once, a lane a chunk, and staged in `fac`
// (shared memory, merge_smem_floats) as the factor 2^(m_c - m_all) and the
// weighted l_c 2^(m_c - m_all), summed in chunk order from there; the sum
// over chunks then reads only acc from memory (every value read once,
// from L2: __ldcg).
__host__ __device__ constexpr int merge_smem_floats(int G, int max_chunks) {
  return G * (2 * max_chunks + 1);
}
template <typename T>
__device__ __forceinline__ void merge_chunks(const float* ws_ml,
                                             const float* ws_acc, T* out,
                                             int HD, const Geo& geo, int b,
                                             int g, int chunks, float* fac) {
  const int G = geo.G;
  const int MC = geo.max_chunks;
  const size_t base = ((size_t)b * geo.KV + g) * MC;
  float* lw = fac + G * MC;
  float* inv_l = lw + G * MC;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int h = warp; h < G; h += kMergeThreads / 32) {
    float m_all = kNeg;
    for (int c = lane; c < chunks; c += 32) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          ws_ml + ((base + c) * G + h) * 2));
      fac[h * MC + c] = ml.x;
      lw[h * MC + c] = ml.y;
      m_all = fmaxf(m_all, ml.x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, o));
    for (int c = lane; c < chunks; c += 32) {  // the lane's own entries
      const float f = ex2(fac[h * MC + c] - m_all);
      fac[h * MC + c] = f;
      lw[h * MC + c] *= f;
    }
    __syncwarp();
    if (lane == 0) {  // in chunk order
      float l_all = 0.f;
      for (int c = 0; c < chunks; ++c) l_all += lw[h * MC + c];
      inv_l[h] = 1.f / fmaxf(l_all, 1e-30f);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kMergeThreads) {
    const int h = idx / HD;
    const int d = idx % HD;
    const float* f = fac + h * MC;
    float a_all = 0.f;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c)
      a_all += __ldcg(ws_acc + ((base + c) * G + h) * HD + d) * f[c];
    out[((size_t)b * geo.H + g * G + h) * HD + d] =
        from_float<T>(a_all * inv_l[h]);
  }
}

// The slots of more than one chunk, merged by a second launch: one CTA a
// (slot, kv head).  K6's; K1's twin below differs only in its name, so a
// profile tells the two apart.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ ws_ml, const float* __restrict__ ws_acc,
             const int* __restrict__ seq_lens, T* __restrict__ out, int HD,
             const Geo geo) {
  extern __shared__ float merge_smem[];  // merge_smem_floats(G, max_chunks)
  const Slot sl = slot_of(geo, seq_lens, blockIdx.x);
  if (sl.chunks == 1) return;  // written by its unit
  merge_chunks<T>(ws_ml, ws_acc, out, HD, geo, blockIdx.x, blockIdx.y,
                  sl.chunks, merge_smem);
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
tc_merge_kernel(const float* __restrict__ ws_ml,
                const float* __restrict__ ws_acc,
                const int* __restrict__ seq_lens, T* __restrict__ out,
                int HD, const Geo geo) {
  extern __shared__ float merge_smem[];
  const Slot sl = slot_of(geo, seq_lens, blockIdx.x);
  if (sl.chunks == 1) return;
  merge_chunks<T>(ws_ml, ws_acc, out, HD, geo, blockIdx.x, blockIdx.y,
                  sl.chunks, merge_smem);
}

// K1-sp's second launch: one CTA a (slot, kv head) merges the slot's
// chunks, in chunk order, into its unnormalised partial over the owned
// pages: acc [B, H, HD], l [B, H] and m [B, H] in the reference's natural
// units (the kernel's are base 2), -1e30 with l = 0 for a head that saw
// no key.
__global__ void __launch_bounds__(kMergeThreads)
tc_partial_merge_kernel(const float* __restrict__ ws_ml,
                        const float* __restrict__ ws_acc,
                        const int* __restrict__ seq_lens,
                        float* __restrict__ acc, float* __restrict__ m_out,
                        float* __restrict__ l_out, int HD, const Geo geo) {
  extern __shared__ float merge_smem[];  // merge_smem_floats(G, max_chunks)
  const int b = blockIdx.x, g = blockIdx.y;
  const int chunks = slot_of(geo, seq_lens, b).chunks;
  const int G = geo.G;
  const int MC = geo.max_chunks;
  const size_t base = ((size_t)b * geo.KV + g) * MC;
  float* fac = merge_smem;
  float* lw = fac + G * MC;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int h = warp; h < G; h += kMergeThreads / 32) {
    float m_all = kNeg;
    for (int c = lane; c < chunks; c += 32) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          ws_ml + ((base + c) * G + h) * 2));
      fac[h * MC + c] = ml.x;
      lw[h * MC + c] = ml.y;
      m_all = fmaxf(m_all, ml.x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, o));
    for (int c = lane; c < chunks; c += 32) {
      const float f = ex2(fac[h * MC + c] - m_all);
      fac[h * MC + c] = f;
      lw[h * MC + c] *= f;
    }
    __syncwarp();
    if (lane == 0) {  // in chunk order
      float l_all = 0.f;
      for (int c = 0; c < chunks; ++c) l_all += lw[h * MC + c];
      const size_t row = (size_t)b * geo.H + g * G + h;
      l_out[row] = l_all;
      m_out[row] = l_all > 0.f ? m_all / kLog2e : kNeg;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kMergeThreads) {
    const int h = idx / HD;
    const int d = idx % HD;
    const float* f = fac + h * MC;
    float a_all = 0.f;
    for (int c = 0; c < chunks; ++c)
      a_all += __ldcg(ws_acc + ((base + c) * G + h) * HD + d) * f[c];
    acc[((size_t)b * geo.H + g * G + h) * HD + d] = a_all;
  }
}

// shared memory of a launch: the barriers, the ring, the query buffers,
// the warps' merge buffer, the groups' prefix sums (ops/kernels/paged_decode.py
// split_plan computes the same)
template <typename T, int HD, int GM>
size_t smem_bytes(const Geo& g) {
  return kBarBytes + (size_t)g.stages * 2 * g.tile_rows * HD * sizeof(T) +
         kQBufs * GM * HD * sizeof(T) +
         sizeof(float) * kWarps * GM * (HD + 2) +
         sizeof(int) * (g.B / g.block_slots + 1);
}

template <typename T, int HD, int GM>
cudaError_t launch(const Geo& geo, const void* q, const void* k,
                   const void* v, const int* pt, const int* sl, void* out,
                   float* ws, int grid, cudaStream_t stream) {
  auto kern = paged_decode_split_kernel<T, HD, GM>;
  static vgt_sm90::PerDevice configured;  // once per instantiation, device
  bool& done = configured.flag();
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    done = true;
  }
  const size_t smem = smem_bytes<T, HD, GM>(geo);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  float* ws_ml = ws;
  float* ws_acc =
      ws ? ws + (size_t)geo.B * geo.KV * geo.max_chunks * geo.G * 2
         : nullptr;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, sl, static_cast<T*>(out), ws_ml, ws_acc,
      geo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || geo.max_chunks == 1) return err;
  const size_t merge_smem =
      sizeof(float) * merge_smem_floats(geo.G, geo.max_chunks);
  if (merge_smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static vgt_sm90::PerDevice merge_configured;
  bool& merged = merge_configured.flag();
  if (!merged) {
    cudaError_t e = cudaFuncSetAttribute(
        merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    merged = true;
  }
  merge_kernel<T><<<dim3(geo.B, geo.KV), kMergeThreads, merge_smem,
                    stream>>>(ws_ml, ws_acc, sl, static_cast<T*>(out), HD,
                              geo);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const Geo& geo, const void* q, const void* k,
                      const void* v, const int* pt, const int* sl, void* out,
                      float* ws, int grid, cudaStream_t stream) {
  switch (geo.G <= 1 ? 1 : geo.G <= 2 ? 2 : geo.G <= 4 ? 4 : 8) {
    case 1:
      return launch<T, HD, 1>(geo, q, k, v, pt, sl, out, ws, grid, stream);
    case 2:
      return launch<T, HD, 2>(geo, q, k, v, pt, sl, out, ws, grid, stream);
    case 4:
      return launch<T, HD, 4>(geo, q, k, v, pt, sl, out, ws, grid, stream);
    default:
      return launch<T, HD, 8>(geo, q, k, v, pt, sl, out, ws, grid, stream);
  }
}

template <typename T>
cudaError_t dispatch(const Geo& geo, int hd, const void* q, const void* k,
                     const void* v, const int* pt, const int* sl, void* out,
                     float* ws, int grid, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_hd<T, 64>(geo, q, k, v, pt, sl, out, ws, grid, stream);
    case 128:
      return launch_hd<T, 128>(geo, q, k, v, pt, sl, out, ws, grid, stream);
    case 256:
      return launch_hd<T, 256>(geo, q, k, v, pt, sl, out, ws, grid, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------------------ K1

// The layout of one K1 instantiation: KT the pool type (bf16, or int8_t
// with bf16 scale pools).  A row of K or V is kBoxes TMA boxes of kSpan
// bytes (64 bf16 or 128 int8 values; 64 int8 values at hd 64, with the
// 64-byte swizzle); Q K^T takes hd in kSteps k steps of 16 and P V hd in
// kSteps m tiles of 16.
template <typename KT, int HD>
struct TcCfg {
  static constexpr bool kI8 = sizeof(KT) == 1;
  static constexpr int kRowBytes = HD * (int)sizeof(KT);
  static constexpr int kSpan = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kBoxes = kRowBytes / kSpan;
  static constexpr int kChunks = kSpan / 16;  // 16-byte pieces a box row
  static constexpr int kSteps = HD / 16;
};

constexpr int kTcStages = 12;

// A stage: the K tile's boxes, the V tile's, each of tile_pad rows (the
// tile's rows rounded up to whole m16 steps) on 1024 bytes (the swizzle
// atom), then, for int8 pools, the K and V scale rows (tile_pad bf16
// each).  The host's decode_plan computes the same.
__host__ __device__ constexpr int tc_box_bytes(int span, int tile_pad) {
  return (tile_pad * span + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int tc_stage_bytes(int span, int boxes,
                                                 bool i8, int tile_pad) {
  return (2 * boxes * tc_box_bytes(span, tile_pad) + (i8 ? 4 * tile_pad : 0) +
          1023) / 1024 * 1024;
}
// the ring, the query buffers (8 rows of bf16 each), the warps' merge
// buffer and the units' prefix sums, then the barriers
inline size_t tc_smem_bytes(int hd, int stage_bytes, int stages, int G,
                            int B) {
  const size_t n = (size_t)stages * stage_bytes + kQBufs * 8 * hd * 2 +
                   sizeof(float) * kWarps * G * (hd + 2) +
                   sizeof(int) * (B + 1);
  return (n + 7) / 8 * 8 + 8 * 2 * (kTcStages + kQBufs);
}

__device__ __forceinline__ uint32_t tc_full(uint32_t bars, int s) {
  return bars + 8 * s;
}
__device__ __forceinline__ uint32_t tc_empty(uint32_t bars, int s) {
  return bars + 8 * (kTcStages + s);
}
__device__ __forceinline__ uint32_t tc_qfull(uint32_t bars, int i) {
  return bars + 8 * (2 * kTcStages + i);
}
__device__ __forceinline__ uint32_t tc_qempty(uint32_t bars, int i) {
  return bars + 8 * (2 * kTcStages + kQBufs + i);
}

// 16-byte piece `chunk` of row `row` of a swizzled box at shared address
// `box`: the 128-byte swizzle xors the piece with row % 8, the 64-byte one
// (64-byte rows) with (row / 2) % 4, as TMA lays the box down
template <int kSpan>
__device__ __forceinline__ uint32_t tc_piece(uint32_t box, int row,
                                            int chunk) {
  const int x = kSpan == 128 ? (row & 7) : ((row >> 1) & 3);
  return box + row * kSpan + ((chunk ^ x) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// the 8 x 8 b16 matrix the warp holds (lane l: row l / 4, elements
// 2 (l % 4), + 1), transposed
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y)
               : "r"(x));
  return y;
}
// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fragments of one 16-token step.  A lane (gr = lane / 4, cq =
// lane % 4) holds, as m16n8k16 lays them out: of an A operand the rows gr
// and gr + 8 and the k pairs 2 cq and 2 cq + 8; of B (k x n) the k pairs
// 2 cq and 2 cq + 8 of column gr; of the accumulator the rows gr and
// gr + 8 and the columns 2 cq, 2 cq + 1.
//
// K's A operand (rows: the step's tokens; k: hd).  bf16: matrix mi of the
// x4 load is rows +8 (mi & 1), hd +8 (mi & 2), so the registers are a0..a3
// as laid out.  int8: an 8 x 8 b16 matrix is 8 rows of 16 int8 values, a
// lane's word the bytes 4 cq .. 4 cq + 3 of row gr; one x4 load covers two
// k steps (mi & 1: rows +8; mi & 2: the next 16 values), widened to the
// k pairs 2 cq (bytes 0, 1) and 2 cq + 8 (bytes 2, 3): k step j takes hd
// 16 j + 4 cq .. + 3 in that order, and Q^T's fragment reads q so.
template <class C>
__device__ __forceinline__ void k_fragment(uint32_t kbox, uint32_t box_bytes,
                                           int r0, int lane, int j,
                                           uint32_t (&a)[4],
                                           uint32_t (&a_next)[4]) {
  const int mi = lane >> 3;
  const int row = r0 + (lane & 7) + ((mi & 1) << 3);
  if constexpr (!C::kI8) {
    // hd 16 j + 8 (mi >> 1): byte 32 j + 16 (mi >> 1)
    const int bc = 32 * j + 16 * (mi >> 1);
    ldsm_x4(tc_piece<C::kSpan>(kbox + (bc / C::kSpan) * box_bytes, row,
                               (bc % C::kSpan) >> 4),
            a);
  } else {
    const int bc = 16 * j + 16 * (mi >> 1);  // j even: steps j and j + 1
    uint32_t w[4];
    ldsm_x4(tc_piece<C::kSpan>(kbox + (bc / C::kSpan) * box_bytes, row,
                               (bc % C::kSpan) >> 4),
            w);
    a[0] = vgt_sm90::widen_pair(w[0], 0x5140);
    a[1] = vgt_sm90::widen_pair(w[1], 0x5140);
    a[2] = vgt_sm90::widen_pair(w[0], 0x5342);
    a[3] = vgt_sm90::widen_pair(w[1], 0x5342);
    a_next[0] = vgt_sm90::widen_pair(w[2], 0x5140);
    a_next[1] = vgt_sm90::widen_pair(w[3], 0x5140);
    a_next[2] = vgt_sm90::widen_pair(w[2], 0x5342);
    a_next[3] = vgt_sm90::widen_pair(w[3], 0x5342);
  }
}

// V^T's A operand of m tile i (rows: hd; k: the step's tokens), by
// ldmatrix.trans from V's rows.  bf16: matrix mi is tokens +8 (mi & 2),
// hd +8 (mi & 1); m row r is hd 16 i + r.  int8: the trans load hands a
// lane the b16 element gr (int8 values 2 gr, 2 gr + 1) of tokens 2 cq and
// 2 cq + 1; selecting bytes (0, 2) and (1, 3) gives hd 2 gr and 2 gr + 1
// at that token pair, so m row gr is hd 16 i + 2 gr and m row gr + 8 is
// hd 16 i + 2 gr + 1 (see out_row); one x4 load covers m tiles i, i + 1.
template <class C>
__device__ __forceinline__ void v_fragment(uint32_t vbox, uint32_t box_bytes,
                                           int r0, int lane, int i,
                                           uint32_t (&a)[4],
                                           uint32_t (&a_next)[4]) {
  const int mi = lane >> 3;
  if constexpr (!C::kI8) {
    const int row = r0 + (lane & 7) + ((mi >> 1) << 3);
    const int bc = 32 * i + 16 * (mi & 1);
    ldsm_x4_trans(tc_piece<C::kSpan>(vbox + (bc / C::kSpan) * box_bytes, row,
                                     (bc % C::kSpan) >> 4),
                  a);
  } else {
    const int row = r0 + (lane & 7) + ((mi & 1) << 3);
    const int bc = 16 * i + 16 * (mi >> 1);  // i even: tiles i and i + 1
    uint32_t w[4];
    ldsm_x4_trans(tc_piece<C::kSpan>(vbox + (bc / C::kSpan) * box_bytes, row,
                                     (bc % C::kSpan) >> 4),
                  w);
    a[0] = vgt_sm90::widen_pair(w[0], 0x5240);
    a[1] = vgt_sm90::widen_pair(w[0], 0x5341);
    a[2] = vgt_sm90::widen_pair(w[1], 0x5240);
    a[3] = vgt_sm90::widen_pair(w[1], 0x5341);
    a_next[0] = vgt_sm90::widen_pair(w[2], 0x5240);
    a_next[1] = vgt_sm90::widen_pair(w[2], 0x5341);
    a_next[2] = vgt_sm90::widen_pair(w[3], 0x5240);
    a_next[3] = vgt_sm90::widen_pair(w[3], 0x5341);
  }
}

// The hd of O^T's m row gr (hi: gr + 8) of m tile i
template <class C>
__device__ __forceinline__ int out_row(int i, int gr, bool hi) {
  return C::kI8 ? 16 * i + 2 * gr + (hi ? 1 : 0)
                : 16 * i + gr + (hi ? 8 : 0);
}

template <typename KT, int HD>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_tc_kernel(
    const __grid_constant__ CUtensorMap kmap,  // [KV * P * ps, HD] of KT
    const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q,        // [B, H, HD]
    const __nv_bfloat16* __restrict__ k_scale,  // [KV, P, ps], int8 only
    const __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ page_tables,  // [B, pps]
    const int* __restrict__ seq_lens,     // [B]
    __nv_bfloat16* __restrict__ out,      // [B, H, HD]
    float* __restrict__ ws_ml,            // [B, KV, MC, G, 2]
    float* __restrict__ ws_acc,           // [B, KV, MC, G, HD]
    const Geo geo, int scale_bulk) {
  using C = TcCfg<KT, HD>;
  constexpr int kMS = HD + 2;  // a warp's head in the merge buffer: m, l, acc
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const int T = geo.tile_rows;
  const int Tp = (T + 15) / 16 * 16;
  const uint32_t box_bytes = tc_box_bytes(C::kSpan, Tp);
  const uint32_t stage_bytes = tc_stage_bytes(C::kSpan, C::kBoxes, C::kI8, Tp);
  const int G = geo.G;
  const uint32_t q_bytes = (uint32_t)G * HD * 2;
  unsigned char* ring = tc_smem;
  const uint32_t ring_u32 = smem_u32(ring);
  __nv_bfloat16* qbuf =
      reinterpret_cast<__nv_bfloat16*>(ring + geo.stages * stage_bytes);
  float* mbuf = reinterpret_cast<float*>(qbuf + kQBufs * 8 * HD);
  int* pre = reinterpret_cast<int*>(mbuf + kWarps * G * kMS);
  const uint32_t bars =
      (smem_u32(pre + geo.B + 1) + 7) & ~7u;  // 8-byte aligned barriers
  const bool copied_scales = C::kI8 && !scale_bulk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      // int8 scales loaded by the copy warp arrive once more
      mbar_init(tc_full(bars, s), copied_scales ? 2 : 1);
      mbar_init(tc_empty(bars, s), 1);  // the one warp that took the tile
    }
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(tc_qfull(bars, i), 1);
      mbar_init(tc_qempty(bars, i), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the padding rows [T, Tp) of every box: never copied, read by the last
  // m16 step of a tile; zero, so a bf16 V row there is 0, not NaN
  if (Tp > T) {
    const int per_box = (Tp - T) * C::kChunks;
    const int total = geo.stages * 2 * C::kBoxes * per_box;
    for (int x = threadIdx.x; x < total; x += kThreads) {
      const int bx = x / per_box;  // box of the ring, stage-major
      const int st = bx / (2 * C::kBoxes);
      *reinterpret_cast<uint4*>(ring + st * stage_bytes +
                                (bx % (2 * C::kBoxes)) * box_bytes +
                                T * C::kSpan + (x % per_box) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  const int units = chunk_prefix<kThreads>(geo, seq_lens, pre);

  if (warp < 4) {  // the copy warpgroup
    setmaxnreg_dec<kCopyRegs>();
    if (warp != 0) return;
    const uint32_t tx = 2 * C::kBoxes * (uint32_t)T * C::kSpan +
                        (C::kI8 && scale_bulk ? 4 * T : 0);
    int s = 0, qs = 0;
    uint32_t ph = 1, qph = 1;  // the first round of empty barriers passes
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int b, g, c;
      unit_of(pre, geo.B, geo.KV, u, b, g, c);
      const Slot sl = slot_of(geo, seq_lens, b);
      const int i0 = sl.t0 + c * sl.ct;
      const int i1 = sl.t0 + min(sl.n, (c + 1) * sl.ct);
      const int* pt_row = page_tables + (size_t)b * geo.pps;
      if (lane == 0) {  // the slot's query rows (contiguous)
        mbar_wait(tc_qempty(bars, qs), qph);
        mbar_expect_tx(tc_qfull(bars, qs), q_bytes);
        bulk_load(smem_u32(qbuf + qs * 8 * HD),
                  q + ((size_t)b * geo.H + g * G) * HD, q_bytes,
                  tc_qfull(bars, qs));
      }
      if (++qs == kQBufs) {
        qs = 0;
        qph ^= 1;
      }
      for (int ib = i0; ib < i1; ib += 32) {
        const int ti = ib + lane;
        // only below the live count: ti < i1 <= ceil(seq_len / T)
        const int page = ti < i1 ? pt_row[ti * T / geo.ps] : 0;
        const int n = min(32, i1 - ib);
        for (int k = 0; k < n; ++k) {
          const int pg = __shfl_sync(0xffffffffu, page, k) - geo.base;
          // K1-sp: a page of another shard is not copied; the stage's
          // full barrier takes a plain arrival, and its warp skips it
          const bool own = !geo.partial || (pg >= 0 && pg < geo.P);
          const int row = (g * geo.P + pg) * geo.ps + (ib + k) * T % geo.ps;
          const uint32_t kdst = ring_u32 + s * stage_bytes;
          const uint32_t vdst = kdst + C::kBoxes * box_bytes;
          unsigned char* sc = ring + s * stage_bytes + 2 * C::kBoxes * box_bytes;
          mbar_wait(tc_empty(bars, s), ph);
          if (lane == 0 && !own) mbar_arrive(tc_full(bars, s));
          if (lane == 0 && own) {
            const uint32_t full = tc_full(bars, s);
            mbar_expect_tx(full, tx);
#pragma unroll
            for (int bx = 0; bx < C::kBoxes; ++bx) {
              const int col = bx * (C::kSpan / (int)sizeof(KT));
              vgt_sm90::tma_load_2d(kdst + bx * box_bytes, &kmap, full, col,
                                    row);
              vgt_sm90::tma_load_2d(vdst + bx * box_bytes, &vmap, full, col,
                                    row);
            }
            if (C::kI8 && scale_bulk) {
              bulk_load(smem_u32(sc), k_scale + row, 2 * T, full);
              bulk_load(smem_u32(sc) + 2 * Tp, v_scale + row, 2 * T, full);
            }
          }
          if (copied_scales) {  // a scale row of ps * 2 bytes: no bulk copy
            __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(sc);
            for (int j = lane; j < T; j += 32) {
              sk[j] = k_scale[row + j];
              sk[Tp + j] = v_scale[row + j];
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(tc_full(bars, s));
          }
          if (++s == geo.stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // the compute warps
  setmaxnreg_inc<kComputeRegs>();
  const int cw = warp - 4;  // compute warp
  const int ctid = threadIdx.x - 128;
  const int gr = lane >> 2;  // the fragments' row group
  const int cq = lane & 3;   // and column pair
  const int h0 = 2 * cq, h1 = 2 * cq + 1;  // this lane's two heads
  // base 2 from the score on: the softcap folds log2 e after the tanh
  const float qk_scale =
      geo.softcap > 0.f ? geo.scale / geo.softcap : geo.scale * kLog2e;
  const float cap_log2 = geo.softcap * kLog2e;
  int gt = 0, qs = 0;  // tiles of earlier units; query buffer
  uint32_t qph = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int b, g, c;
    unit_of(pre, geo.B, geo.KV, u, b, g, c);
    const Slot sl = slot_of(geo, seq_lens, b);
    const int i0 = sl.t0 + c * sl.ct;
    const int n = min(sl.n, (c + 1) * sl.ct) - c * sl.ct;

    // Q^T's B fragment: column gr is query head gr (0 past G), k step j
    // reads hd 16 j + 2 cq and + 8 (bf16) or 16 j + 4 cq .. + 3 (int8)
    uint32_t qf[C::kSteps][2];
    mbar_wait(tc_qfull(bars, qs), qph);
    {
      const __nv_bfloat16* qh = qbuf + qs * 8 * HD + gr * HD;
#pragma unroll
      for (int j = 0; j < C::kSteps; ++j) {
        if (gr < G) {
          if constexpr (C::kI8) {
            const uint2 w = *reinterpret_cast<const uint2*>(qh + 16 * j + 4 * cq);
            qf[j][0] = w.x;
            qf[j][1] = w.y;
          } else {
            qf[j][0] = *reinterpret_cast<const uint32_t*>(qh + 16 * j + 2 * cq);
            qf[j][1] =
                *reinterpret_cast<const uint32_t*>(qh + 16 * j + 8 + 2 * cq);
          }
        } else {
          qf[j][0] = 0u;
          qf[j][1] = 0u;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(tc_qempty(bars, qs));
    if (++qs == kQBufs) {
      qs = 0;
      qph ^= 1;
    }

    // this warp's state over its tiles of the unit: heads h0, h1
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
    float acc[C::kSteps][4];
#pragma unroll
    for (int i = 0; i < C::kSteps; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

    // tile k of the unit to warp k % 8.  A unit has at most `stages` tiles
    // (the plan), so no two of its tiles share a stage: the round a warp
    // waits for is the stage's next, never one phase further on.
    for (int k = cw; k < n; k += kWarps) {
      const int t = gt + k;  // the CTA's tile count: stage and phase
      const int s = t % geo.stages;
      mbar_wait(tc_full(bars, s), (uint32_t)(t / geo.stages) & 1u);
      const int pos0 = (i0 + k) * T;
      bool own = true;  // K1-sp: a tile of another shard's page is skipped
      if (geo.partial) {
        const int pg = page_tables[(size_t)b * geo.pps + pos0 / geo.ps] -
                       geo.base;
        own = pg >= 0 && pg < geo.P;
      }
      // the tile's live rows [ra, re), in whole m16 steps [sa, se)
      const int ra = max(sl.lo - pos0, 0);
      const int re = min(sl.sl - pos0, T);
      const int sa = ra >> 4, se = own ? (re + 15) >> 4 : sa;
      const uint32_t kbox = ring_u32 + s * stage_bytes;
      const uint32_t vbox = kbox + C::kBoxes * box_bytes;
      const __nv_bfloat16* sk = reinterpret_cast<const __nv_bfloat16*>(
          ring + s * stage_bytes + 2 * C::kBoxes * box_bytes);
      bool zeroed = false;
      if constexpr (!C::kI8) {
        // stale bf16 V rows of the steps taken may hold NaN: zero them
        const int z0 = sa * 16, z1 = min(se * 16, T);
        if (own && (ra > z0 || re < z1)) {
          unsigned char* vrow = ring + s * stage_bytes + C::kBoxes * box_bytes;
          constexpr int kPer = C::kBoxes * C::kChunks;
          for (int x = lane; x < (z1 - z0) * kPer; x += 32) {
            const int r = z0 + x / kPer;
            if (r >= ra && r < re) continue;
            const int p = x % kPer;
            *reinterpret_cast<uint4*>(vrow + (p / C::kChunks) * box_bytes +
                                      r * C::kSpan + (p % C::kChunks) * 16) =
                make_uint4(0, 0, 0, 0);
          }
          __syncwarp();
          zeroed = true;
        }
      }
      for (int sp = sa; sp < se; ++sp) {
        const int r0 = sp * 16;
        // S^T = K Q^T: tokens r0 + gr (s[0], s[1]) and r0 + gr + 8
        // (s[2], s[3]), heads h0 and h1
        float sacc[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (C::kI8) {
#pragma unroll
          for (int j = 0; j < C::kSteps; j += 2) {
            uint32_t a[4], a2[4];
            k_fragment<C>(kbox, box_bytes, r0, lane, j, a, a2);
            mma_bf16(sacc, a, qf[j][0], qf[j][1]);
            mma_bf16(sacc, a2, qf[j + 1][0], qf[j + 1][1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < C::kSteps; ++j) {
            uint32_t a[4], unused[4];
            k_fragment<C>(kbox, box_bytes, r0, lane, j, a, unused);
            mma_bf16(sacc, a, qf[j][0], qf[j][1]);
          }
        }
        const int ta = r0 + gr, tb = ta + 8;
        const bool va = ta >= ra && ta < re;
        const bool vb = tb >= ra && tb < re;
        if constexpr (C::kI8) {  // K scale: before softcap and mask
          const float ka = __bfloat162float(sk[ta]);
          const float kb = __bfloat162float(sk[tb]);
          sacc[0] *= ka;
          sacc[1] *= ka;
          sacc[2] *= kb;
          sacc[3] *= kb;
        }
        float sc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = geo.softcap > 0.f
                              ? tanhf(sacc[e] * qk_scale) * cap_log2
                              : sacc[e] * qk_scale;
          sc[e] = (e < 2 ? va : vb) ? x : kNeg;
        }
        // the step's column max: the 8 lanes of a column pair hold its 16
        // tokens
        float mx0 = fmaxf(sc[0], sc[2]), mx1 = fmaxf(sc[1], sc[3]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
        float p[4];
        p[0] = va ? ex2(sc[0] - mn0) : 0.f;
        p[1] = va ? ex2(sc[1] - mn1) : 0.f;
        p[2] = vb ? ex2(sc[2] - mn0) : 0.f;
        p[3] = vb ? ex2(sc[3] - mn1) : 0.f;
        l0 = l0 * al0 + p[0] + p[2];  // the unweighted p
        l1 = l1 * al1 + p[1] + p[3];
        m0 = mn0;
        m1 = mn1;
        if constexpr (C::kI8) {  // V scale: into p, selected, never 0 x NaN
          const float va_s = __bfloat162float(sk[Tp + ta]);
          const float vb_s = __bfloat162float(sk[Tp + tb]);
          p[0] = va ? p[0] * va_s : 0.f;
          p[1] = va ? p[1] * va_s : 0.f;
          p[2] = vb ? p[2] * vb_s : 0.f;
          p[3] = vb ? p[3] * vb_s : 0.f;
        }
#pragma unroll
        for (int i = 0; i < C::kSteps; ++i) {
          acc[i][0] *= al0;
          acc[i][1] *= al1;
          acc[i][2] *= al0;
          acc[i][3] *= al1;
        }
        // P^T's B fragment: the accumulator's token rows, transposed
        const uint32_t pb0 = movmatrix_trans(vgt_sm90::pack_bf16(p[0], p[1]));
        const uint32_t pb1 = movmatrix_trans(vgt_sm90::pack_bf16(p[2], p[3]));
        if constexpr (C::kI8) {
#pragma unroll
          for (int i = 0; i < C::kSteps; i += 2) {
            uint32_t a[4], a2[4];
            v_fragment<C>(vbox, box_bytes, r0, lane, i, a, a2);
            mma_bf16(acc[i], a, pb0, pb1);
            mma_bf16(acc[i + 1], a2, pb0, pb1);
          }
        } else {
#pragma unroll
          for (int i = 0; i < C::kSteps; ++i) {
            uint32_t a[4], unused[4];
            v_fragment<C>(vbox, box_bytes, r0, lane, i, a, unused);
            mma_bf16(acc[i], a, pb0, pb1);
          }
        }
      }
      // the zeroing's generic writes before the next copy's into the stage
      if (zeroed) vgt_sm90::fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(tc_empty(bars, s));
    }
    gt += n;

    // l over the 8 lanes of each column pair; the state into shared memory
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    float* mw = mbuf + cw * G * kMS;
    if (gr == 0) {
      if (h0 < G) {
        mw[h0 * kMS] = m0;
        mw[h0 * kMS + 1] = l0;
      }
      if (h1 < G) {
        mw[h1 * kMS] = m1;
        mw[h1 * kMS + 1] = l1;
      }
    }
#pragma unroll
    for (int i = 0; i < C::kSteps; ++i) {
      const int da = out_row<C>(i, gr, false), db = out_row<C>(i, gr, true);
      if (h0 < G) {
        mw[h0 * kMS + 2 + da] = acc[i][0];
        mw[h0 * kMS + 2 + db] = acc[i][2];
      }
      if (h1 < G) {
        mw[h1 * kMS + 2 + da] = acc[i][1];
        mw[h1 * kMS + 2 + db] = acc[i][3];
      }
    }
    vgt_sm90::bar_sync(1, kWarps * 32);
    // merge the warps, in warp order: a thread a head turns each warp's m
    // into its factor 2^(m_w - m_all) in place and sums l; then each
    // output sums the warps' acc with those factors.  One chunk: the
    // output, else the chunk's partial.
    const bool direct = sl.chunks == 1 && !geo.partial;
    const size_t part = (((size_t)b * geo.KV + g) * geo.max_chunks + c) * G;
    if (ctid < G) {
      const int h = ctid;
      float m_all = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        m_all = fmaxf(m_all, mbuf[(w * G + h) * kMS]);
      float l_all = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        float* ws = mbuf + (w * G + h) * kMS;
        const float f = ex2(ws[0] - m_all);
        l_all += ws[1] * f;
        ws[0] = f;
      }
      if (direct) {
        mbuf[h * kMS + 1] = fmaxf(l_all, 1e-30f);  // warp 0's l: the divisor
      } else {
        ws_ml[(part + h) * 2] = m_all;
        ws_ml[(part + h) * 2 + 1] = l_all;
      }
    }
    vgt_sm90::bar_sync(1, kWarps * 32);
    for (int idx = ctid; idx < G * HD; idx += kWarps * 32) {
      const int h = idx / HD;
      const int d = idx % HD;
      float a_all = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* ws = mbuf + (w * G + h) * kMS;
        a_all += ws[2 + d] * ws[0];
      }
      if (direct)
        out[((size_t)b * geo.H + g * G + h) * HD + d] =
            __float2bfloat16(a_all / mbuf[h * kMS + 1]);
      else
        ws_acc[(part + h) * HD + d] = a_all;
    }
    vgt_sm90::bar_sync(1, kWarps * 32);  // mbuf is reused
  }
}

// acc, m and l: K1-sp's outputs (geo.partial), else null
template <typename KT, int HD>
cudaError_t tc_launch(const Geo& geo, const void* q, const void* k,
                      const void* v, const void* ks, const void* vs,
                      const int* pt, const int* sl, void* out, float* ws,
                      int grid, int scale_bulk, cudaStream_t stream,
                      float* acc, float* m, float* l) {
  using C = TcCfg<KT, HD>;
  const int Tp = (geo.tile_rows + 15) / 16 * 16;
  const size_t smem = tc_smem_bytes(
      HD, tc_stage_bytes(C::kSpan, C::kBoxes, C::kI8, Tp), geo.stages, geo.G,
      geo.B);
  if (smem > (size_t)kMaxSmem ||
      sizeof(float) * merge_smem_floats(geo.G, geo.max_chunks) >
          (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  CUtensorMap km, vm;
  const CUtensorMapDataType type = C::kI8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swizzle = C::kSpan == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  const int rows = geo.KV * geo.P * geo.ps;
  const int box_cols = C::kSpan / (int)sizeof(KT);
  if (!vgt_sm90::cached_map(&km, type, swizzle, k, rows, HD, sizeof(KT),
                            geo.tile_rows, box_cols) ||
      !vgt_sm90::cached_map(&vm, type, swizzle, v, rows, HD, sizeof(KT),
                            geo.tile_rows, box_cols))
    return cudaErrorInvalidValue;
  auto kern = paged_decode_tc_kernel<KT, HD>;
  static vgt_sm90::PerDevice configured;  // once per instantiation, device
  bool& done = configured.flag();
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    done = true;
  }
  float* ws_ml = ws;
  float* ws_acc =
      ws ? ws + (size_t)geo.B * geo.KV * geo.max_chunks * geo.G * 2 : nullptr;
  using bf16 = __nv_bfloat16;
  kern<<<grid, kThreads, smem, stream>>>(
      km, vm, static_cast<const bf16*>(q), static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), pt, sl, static_cast<bf16*>(out), ws_ml,
      ws_acc, geo, scale_bulk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (geo.partial) {
    static vgt_sm90::PerDevice partial_configured;
    bool& set = partial_configured.flag();
    if (!set) {
      cudaError_t e = cudaFuncSetAttribute(
          tc_partial_merge_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return e;
      set = true;
    }
    tc_partial_merge_kernel<<<dim3(geo.B, geo.KV), kMergeThreads,
                              sizeof(float) * merge_smem_floats(
                                                  geo.G, geo.max_chunks),
                              stream>>>(ws_ml, ws_acc, sl, acc, m, l, HD,
                                        geo);
    return cudaGetLastError();
  }
  if (geo.max_chunks == 1) return err;
  static vgt_sm90::PerDevice merge_configured;
  bool& merged = merge_configured.flag();
  if (!merged) {
    cudaError_t e = cudaFuncSetAttribute(
        tc_merge_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    merged = true;
  }
  tc_merge_kernel<bf16><<<dim3(geo.B, geo.KV), kMergeThreads,
                          sizeof(float) *
                              merge_smem_floats(geo.G, geo.max_chunks),
                          stream>>>(ws_ml, ws_acc, sl, static_cast<bf16*>(out),
                                    HD, geo);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t tc_dispatch(int hd, const Geo& geo, const void* q, const void* k,
                        const void* v, const void* ks, const void* vs,
                        const int* pt, const int* sl, void* out, float* ws,
                        int grid, int scale_bulk, cudaStream_t stream,
                        float* acc = nullptr, float* m = nullptr,
                        float* l = nullptr) {
  switch (hd) {
    case 64:
      return tc_launch<KT, 64>(geo, q, k, v, ks, vs, pt, sl, out, ws, grid,
                               scale_bulk, stream, acc, m, l);
    case 128:
      return tc_launch<KT, 128>(geo, q, k, v, ks, vs, pt, sl, out, ws,
                                grid, scale_bulk, stream, acc, m, l);
    case 256:
      return tc_launch<KT, 256>(geo, q, k, v, ks, vs, pt, sl, out, ws,
                                grid, scale_bulk, stream, acc, m, l);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace split

}  // namespace

// K1's call shape and plan, packed once per call shape by the wrapper
// (ops/kernels/paged_decode.py DecodeArgs), so a call passes pointers only
struct DecodeArgs {
  int B, H, KV, P, ps, pps, hd, window;
  float scale, softcap;
  int tile_rows, stages, chunk_tiles, max_chunks, grid, int8, scale_bulk;
};

// K1: the tensor-core page-split decode on bf16 pools (int8 0) or on int8
// pools with bf16 scale pools [KV, P, ps] (int8 1); q and the output bf16.
// The plan (ops/kernels/paged_decode.py decode_plan): tile_rows divides ps
// (at most 256), 2 <= stages <= 12, 1 <= chunk_tiles <= stages (a unit's
// tiles each in a stage of their own), max_chunks >= 1, grid CTAs; ws
// holds B * KV * max_chunks * G * (hd + 2) floats when max_chunks > 1
// (else unused); scale_bulk: scale rows by bulk copy where the scale pools
// lie on 16 bytes (tile_rows and ps multiples of 8).
static bool bad_plan(const DecodeArgs* a) {
  return a->KV < 1 || a->H % a->KV || a->H / a->KV > 8 || a->tile_rows < 1 ||
         a->tile_rows > 256 || a->ps % a->tile_rows || a->stages < 2 ||
         a->stages > split::kTcStages || a->chunk_tiles < 1 ||
         a->chunk_tiles > a->stages || a->max_chunks < 1 || a->grid < 1;
}

extern "C" int vgt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scale,
                                const void* v_scale, const void* page_tables,
                                const void* seq_lens, void* out, void* ws,
                                const DecodeArgs* a, void* stream) {
  if (a->B == 0) return cudaSuccess;
  if (bad_plan(a) || (a->max_chunks > 1 && ws == nullptr) ||
      (a->int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      (a->scale_bulk && (a->tile_rows % 8 || a->ps % 8)))
    return cudaErrorInvalidValue;
  const split::Geo geo{a->B, a->H, a->KV, a->P, a->ps, a->pps, a->H / a->KV,
                       a->window, a->scale, a->softcap, 1, a->tile_rows,
                       a->stages, a->chunk_tiles, a->max_chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  float* w = static_cast<float*>(ws);
  if (a->int8) {
    const int bulk = a->scale_bulk &&
                     reinterpret_cast<uintptr_t>(k_scale) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v_scale) % 16 == 0;
    return split::tc_dispatch<int8_t>(a->hd, geo, q, k_pages, v_pages,
                                      k_scale, v_scale, pt, sl, out, w,
                                      a->grid, bulk, s);
  }
  return split::tc_dispatch<__nv_bfloat16>(a->hd, geo, q, k_pages, v_pages,
                                           nullptr, nullptr, pt, sl, out, w,
                                           a->grid, 0, s);
}

// K1-sp: K1 on one sp rank's bf16 pool shard, global pages [base, base +
// P) (parallel/sp_decode.py): the unnormalised partials over the owned
// pages, acc [B, H, hd], m and l [B, H] in fp32.  ws holds B * KV *
// max_chunks * G * (hd + 2) floats whatever max_chunks is (every slot's
// chunks merge in the second launch).
extern "C" int vgt_paged_decode_partial(const void* q, const void* k_pages,
                                        const void* v_pages,
                                        const void* page_tables,
                                        const void* seq_lens, void* acc,
                                        void* m, void* l, void* ws,
                                        const DecodeArgs* a, int base,
                                        void* stream) {
  if (a->B == 0) return cudaSuccess;
  if (bad_plan(a) || a->int8 || ws == nullptr || base < 0)
    return cudaErrorInvalidValue;
  split::Geo geo{a->B, a->H, a->KV, a->P, a->ps, a->pps, a->H / a->KV,
                 a->window, a->scale, a->softcap, 1, a->tile_rows,
                 a->stages, a->chunk_tiles, a->max_chunks};
  geo.base = base;
  geo.partial = 1;
  return split::tc_dispatch<__nv_bfloat16>(
      a->hd, geo, q, k_pages, v_pages, nullptr, nullptr,
      static_cast<const int*>(page_tables),
      static_cast<const int*>(seq_lens), nullptr, static_cast<float*>(ws),
      a->grid, 0, static_cast<cudaStream_t>(stream),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l));
}

// K6: the page-split decode (block_slots must divide B; 1 < G <= 8 query
// heads a kv head, G = H / KV); bf16 (dtype 0) or f32 (dtype 1) pools.
// The plan (ops/kernels/paged_decode.py split_plan): tile_rows divides ps
// (a tile's K and V bytes a multiple of 16), 1 <= stages <= 8,
// chunk_tiles >= 1, max_chunks >= 1, grid CTAs; ws holds B * KV *
// max_chunks * G * (hd + 2) floats when max_chunks > 1 (else unused).
extern "C" int vgt_paged_decode_blocked(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* seq_lens, void* out, void* ws,
    int B, int H, int KV, int P, int ps, int pps, int hd, int window,
    float scale, float softcap, int block_slots, int tile_rows, int stages,
    int chunk_tiles, int max_chunks, int grid, int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  if (block_slots < 1 || B % block_slots || KV < 1 || H % KV ||
      H / KV > 8 || tile_rows < 1 || ps % tile_rows ||
      (tile_rows * hd * (dtype == 0 ? 2 : 4)) % 16 || stages < 1 ||
      stages > split::kMaxStages || chunk_tiles < 1 || max_chunks < 1 ||
      grid < 1 || (max_chunks > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const split::Geo geo{B, H, KV, P, ps, pps, H / KV, window, scale, softcap,
                       block_slots, tile_rows, stages, chunk_tiles,
                       max_chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return split::dispatch<__nv_bfloat16>(geo, hd, q, k_pages, v_pages, pt,
                                          sl, out, w, grid, s);
  if (dtype == 1)
    return split::dispatch<float>(geo, hd, q, k_pages, v_pages, pt, sl, out,
                                  w, grid, s);
  return cudaErrorInvalidValue;
}
