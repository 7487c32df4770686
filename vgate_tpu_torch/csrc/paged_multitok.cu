// Paged multi-token attention for Hopper (sm_90a), bf16 in and out, over
// bf16 pools or int8 pools with bf16 scales (kv_cache.dtype: int8).
//
// Replaces the TPU kernel vgate_tpu/ops/pallas/paged_attention.py
// paged_multitok_attention_pallas (body _mt_kernel), in its plain and its
// int8 mode: S query rows per slot,
// row s at global position positions0[b] + s, attend the slot's paged
// context through its page-table row.  Row s sees key t when
// t <= positions0[b] + s and t < positions0[b] + input_lens[b] (causal
// among the rows, whose own KV the layer wrote before attending),
// intersected with the sliding window; GQA maps query head h to kv head
// h / G; logit softcap and a query scale.  It is the suffix prompt pass of
// a prefix-cache hit, of a copy-on-write hit and of every prefill chunk,
// and the verify pass of speculative decoding (S = 1..k+1 rows a slot,
// starting at any position).  Any S >= 1: Q comes by TMA in boxes of 128
// rows, and rows at or past S lie outside the map's S extent, so they
// read as zeros; no store reaches a row at or past S.
// Semantic spec: vgate_tpu_torch/ops/attention.py paged_suffix_attention.
//
// What bounds it on an H100: operations for a suffix pass, bytes for a
// verify pass.  S rows over a context of C keys do about 4 * H * hd * S * C
// flops on (S * 2H + 2 * C * KV) * hd * 2 bytes: at S 512 over a
// 1536-token context that is ~900 flops per byte, so the limit is the 989
// TFLOP/s bf16 tensor-core rate; at S <= 8 it is ~14 flops per byte, so
// the limit is reading the context's K and V at 3.35 TB/s.  A verify tile
// holds S <= 8 live rows of its 128 (packing the G heads of a kv head
// into one tile is the design for small S, not built yet).
//
// What the design does about it, bf16 pools: the Hopper tile pipeline of
// the flash-prefill kernel (flash_sm90.cuh: one CTA per 128-row query tile
// x head x slot, a producer warp keeping TMA copies in flight in a 2-stage
// ring, two consumer warpgroups running both products on wgmma with the
// softmax on the accumulator registers), with each key tile's rows copied
// through the page table, and the query tiles and heads of one (slot, kv
// head) launched side by side (their work is near-equal; their K and V
// meet in L2):
//  * K and V come by TMA from a 2-D tensor map over the layer view
//    [KV * P * ps, hd] (encoded at each launch: the view's address changes
//    per layer), one box of min(ps, kN) rows x 64 columns per page (or
//    part of a page) and column block; the page ids of a tile are read
//    once, one per lane of the producer warp, a tile ahead;
//  * key tiles are position-aligned (kN keys, a multiple or a divisor of
//    the page size), so a copy-on-write suffix that starts mid-page needs
//    nothing special: every mask is positional;
//  * the page table is read only below seq_len = positions0 + input_lens,
//    clamped on the device to the table's width (ctx_pages * ps): the width
//    is bucketed and padded with trash page 0, and a column at or past
//    ceil(seq_len / ps) is never read; V rows at or past seq_len (stale or
//    never copied) are zeroed before the P V product;
//  * query tiles wholly past input_lens (the suffix bucket is wider than
//    the real suffix) write zeros and exit before loading anything;
//  * key tiles above the tile's last row or wholly below the window of
//    its first row are never loaded.
// Page sizes: multiples of 8 that divide kN or that kN divides (the
// wrapper refuses others).
//
// int8 pools (K3-int8) run the same pipeline in its int8 mode
// (flash_sm90.cuh, Cfg kInt8): one bulk copy a page (or part of a page)
// brings its min(ps, kN) int8 K rows, as many V rows and their bf16 K and
// V scales into a staging ring; the producer warpgroup's three idle warps
// widen each staged tile to bf16 (exact, unscaled) into the swizzled K and
// V stages the consumers read, and the scales to fp32 beside them; the
// consumers fold the K scale into the scores and the V scale into the
// softmax weights after the row sum, as the TPU kernel does.  The pool
// bytes per key halve and no dequantized K or V tile reaches device
// memory.  A scale run is 2 bytes a row and a bulk copy moves multiples of
// 16 bytes, so this mode too takes page sizes that are multiples of 8
// dividing kN or divided by it.  The G query heads of a kv head share no
// K/V load in either mode (L2 serves the repeats).
//
// Rows past input_lens are finite and unspecified, as in the TPU kernel.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch on the caller's stream (cudaErrorInvalidValue for a page size the
// kernel does not take or a tensor map that cannot be encoded); the
// kernels allocate nothing.

#include "flash_sm90.cuh"

namespace {

using namespace vgt_sm90;

// The CTA's query tile: false (after writing its finite zeros) when it
// lies wholly past input_lens; else the Tile and the output rows
template <class C>
__device__ __forceinline__ bool suffix_tile(Tile& t, int& h, int& b,
                                            int& row0, bf16*& out_tile,
                                            const int* positions0,
                                            const int* input_lens, bf16* out,
                                            int S, int H, int ps,
                                            int ctx_pages, int window) {
  constexpr int HD = C::kHD;
  int qt;
  tile_coords<C::kLongestFirst>(qt, h, b);
  row0 = qt * kRows;  // first query row of the tile (local)
  const int n_rows = min(kRows, S - row0);
  const int input_len = min(input_lens[b], S);
  out_tile = out + (((size_t)b * S + row0) * H + h) * HD;
  if (row0 >= input_len) {
    // an idle tile: finite zeros, nothing read
    constexpr int VPR = HD / 8;
    for (int i = threadIdx.x; i < n_rows * VPR; i += kThreads)
      *reinterpret_cast<uint4*>(out_tile + (size_t)(i / VPR) * H * HD +
                                (i % VPR) * 8) = make_uint4(0, 0, 0, 0);
    return false;
  }
  const int pos0 = positions0[b];
  t.q_start = pos0 + row0;  // global position of tile row 0
  t.n_rows = n_rows;
  t.n_live = min(n_rows, input_len - row0);
  // never read the table at or past its width, whatever the lengths say
  t.seq_len = min(pos0 + input_len, ctx_pages * ps);
  t.window = window;
  key_tiles<C>(t);
  return true;
}

// What both loaders share: Q by TMA, and the page ids of a tile's boxes
// (box j of a tile covers positions k_start + j * box_rows .. + box_rows
// - 1 of one page)
template <class C>
struct PagedRows {
  const CUtensorMap* q;
  const int* pt_row;  // this slot's page-table row
  int h, row0, b;
  int head_page0;     // kvh * P: the kv head's first page in the pools
  int ps, box_rows, seq_len;

  __device__ void load_q(uint32_t dst, uint32_t bar, int cb) const {
    tma_load_4d(dst, q, bar, cb * 64, h, row0, b);
  }
  // lane j: the page id of box j of tile kt (0 for boxes at or past
  // seq_len, whose table entries are never read)
  __device__ int ids(int kt, int lane) const {
    const int pos = kt * C::kN + lane * box_rows;
    return lane < C::kN / box_rows && pos < seq_len ? pt_row[pos / ps] : 0;
  }
  // boxes of tile kt that start below seq_len
  __device__ int live_boxes(int k_start) const {
    return min(C::kN / box_rows,
               (seq_len - k_start + box_rows - 1) / box_rows);
  }
  // the pool row (of the layer view) of box j of the tile at k_start
  __device__ int pool_row(int page, int k_start, int j) const {
    return (head_page0 + page) * ps + (k_start + j * box_rows) % ps;
  }
};

// ------------------------------------------------------------ bf16 pools

// K and V rows by TMA from 2-D maps over the layer view [KV * P * ps, HD]
template <int HD>
struct PagedLoader : PagedRows<Cfg<HD, true>> {
  using C = Cfg<HD, true>;
  const CUtensorMap* k;
  const CUtensorMap* v;

  __device__ void prefetch() const {
    tma_prefetch(this->q);
    tma_prefetch(k);
    tma_prefetch(v);
  }
  // all lanes of the producer warp (the ids come by shuffle), lane 0
  // issues: once the stage is free (K and V are freed together), the K and
  // V boxes of each page in turn, only the boxes that start below seq_len
  __device__ void load_kv(int kt, int ids, int lane, uint32_t dk,
                          uint32_t dv, uint32_t bk, uint32_t bv, uint32_t,
                          uint32_t ev, uint32_t parity) const {
    static_assert(C::kJointRelease, "one wait frees K and V");
    const int k_start = kt * C::kN;
    const int box_rows = this->box_rows;
    const int live = this->live_boxes(k_start);
    const uint32_t bytes = live * box_rows * 128 * C::kBlocks;
    if (lane == 0) {
      mbar_wait(ev, parity);
      mbar_expect_tx(bk, bytes);
      mbar_expect_tx(bv, bytes);
    }
    for (int j = 0; j < live; ++j) {
      const int page = __shfl_sync(0xffffffffu, ids, j);
      if (lane == 0) {
        const int row = this->pool_row(page, k_start, j);
        const uint32_t off = j * box_rows * 128;
        for (int cb = 0; cb < C::kBlocks; ++cb) {
          tma_load_2d(dk + cb * C::kKVBlock + off, k, bk, cb * 64, row);
          tma_load_2d(dv + cb * C::kKVBlock + off, v, bv, cb * 64, row);
        }
      }
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
paged_multitok_kernel(const __grid_constant__ CUtensorMap qmap,  // [B,S,H,HD]
                      const __grid_constant__ CUtensorMap kmap,  // [KV*P*ps,HD]
                      const __grid_constant__ CUtensorMap vmap,
                      const int* __restrict__ page_tables,  // [B, ctx_pages]
                      const int* __restrict__ positions0,   // [B]
                      const int* __restrict__ input_lens,   // [B]
                      bf16* __restrict__ out,               // [B, S, H, HD]
                      int S, int H, int KV, int P, int ps, int box_rows,
                      int ctx_pages, int window, float scale, float softcap) {
  extern __shared__ unsigned char smem[];
  using C = Cfg<HD, true>;
  Tile t;
  int h, b, row0;
  bf16* out_tile;
  if (!suffix_tile<C>(t, h, b, row0, out_tile, positions0, input_lens, out,
                      S, H, ps, ctx_pages, window))
    return;
  PagedLoader<HD> ld;
  ld.q = &qmap;
  ld.pt_row = page_tables + (size_t)b * ctx_pages;
  ld.h = h;
  ld.row0 = row0;
  ld.b = b;
  ld.head_page0 = (h / (H / KV)) * P;
  ld.ps = ps;
  ld.box_rows = box_rows;
  ld.seq_len = t.seq_len;
  ld.k = &kmap;
  ld.v = &vmap;
  attend<C>(ld, t, smem, scale, softcap, out_tile, (size_t)H * HD);
}

// ------------------------------------------------------------ int8 pools

// int8 K and V rows and their bf16 scales by bulk copy: a box's rows are
// one contiguous run of a page (box_rows * HD bytes of data, box_rows * 2
// of scales)
template <int HD>
struct PagedLoader8 : PagedRows<Cfg<HD, true, true>> {
  using C = Cfg<HD, true, true>;
  const int8_t* k;  // the layer view [KV * P * ps, HD]
  const int8_t* v;
  const bf16* ks;   // [KV * P * ps]
  const bf16* vs;

  __device__ void prefetch() const { tma_prefetch(this->q); }
  // all lanes of the copy warp, lane 0 issues: once half `kv` (0 K, 1 V)
  // of the staging stage at `dst` is free, each live box's rows and scales
  __device__ void load_kv8(int kt, int ids, int lane, int kv, uint32_t dst,
                           uint32_t full, uint32_t empty,
                           uint32_t parity) const {
    const int k_start = kt * C::kN;
    const int box_rows = this->box_rows;
    const int live = this->live_boxes(k_start);
    const int8_t* data = kv ? v : k;
    const bf16* scales = kv ? vs : ks;
    const uint32_t rows_dst = dst + kv * C::kKV8Bytes;
    const uint32_t scales_dst = dst + 2 * C::kKV8Bytes + kv * 2 * C::kN;
    if (lane == 0) {
      mbar_wait(empty, parity);
      mbar_expect_tx(full, live * box_rows * (HD + 2));
    }
    for (int j = 0; j < live; ++j) {
      const int page = __shfl_sync(0xffffffffu, ids, j);
      if (lane == 0) {
        const size_t row = this->pool_row(page, k_start, j);
        bulk_load(rows_dst + j * box_rows * HD, data + row * HD,
                  box_rows * HD, full);
        bulk_load(scales_dst + j * box_rows * 2, scales + row,
                  box_rows * 2, full);
      }
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
paged_multitok_i8_kernel(const __grid_constant__ CUtensorMap qmap,
                         const int8_t* __restrict__ k_pages,  // [KV,P,ps,HD]
                         const int8_t* __restrict__ v_pages,
                         const bf16* __restrict__ k_scale,    // [KV, P, ps]
                         const bf16* __restrict__ v_scale,
                         const int* __restrict__ page_tables,
                         const int* __restrict__ positions0,
                         const int* __restrict__ input_lens,
                         bf16* __restrict__ out,              // [B, S, H, HD]
                         int S, int H, int KV, int P, int ps, int box_rows,
                         int ctx_pages, int window, float scale,
                         float softcap) {
  extern __shared__ unsigned char smem[];
  using C = Cfg<HD, true, true>;
  Tile t;
  int h, b, row0;
  bf16* out_tile;
  if (!suffix_tile<C>(t, h, b, row0, out_tile, positions0, input_lens, out,
                      S, H, ps, ctx_pages, window))
    return;
  PagedLoader8<HD> ld;
  ld.q = &qmap;
  ld.pt_row = page_tables + (size_t)b * ctx_pages;
  ld.h = h;
  ld.row0 = row0;
  ld.b = b;
  ld.head_page0 = (h / (H / KV)) * P;
  ld.ps = ps;
  ld.box_rows = box_rows;
  ld.seq_len = t.seq_len;
  ld.k = k_pages;
  ld.v = v_pages;
  ld.ks = k_scale;
  ld.vs = v_scale;
  attend<C>(ld, t, smem, scale, softcap, out_tile, (size_t)H * HD);
}

// both modes: the page-size rule, Q's map, the grid
template <int HD, bool kInt8>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const int* pt,
                   const int* pos0, const int* lens, void* out, int B, int S,
                   int H, int KV, int P, int ps, int ctx_pages, int window,
                   float scale, float softcap, cudaStream_t stream) {
  using C = Cfg<HD, true, kInt8>;
  constexpr int kN = C::kN;
  static bool configured = false;  // once per instantiation
  const int box_rows = ps < kN ? ps : kN;
  if (ps % 8 != 0 || (kN % ps != 0 && ps % kN != 0))
    return cudaErrorInvalidValue;
  CUtensorMap qm;
  if (!rows_map<HD>(&qm, q, B, S, H, kRows)) return cudaErrorInvalidValue;
  dim3 grid((S + kRows - 1) / kRows, H, B);
  if constexpr (kInt8) {
    return launch_sm90<C>(
        paged_multitok_i8_kernel<HD>, configured, grid, stream, qm,
        static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        static_cast<const bf16*>(ks), static_cast<const bf16*>(vs), pt, pos0,
        lens, static_cast<bf16*>(out), S, H, KV, P, ps, box_rows, ctx_pages,
        window, scale, softcap);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)HD, (cuuint64_t)KV * P * ps};
    const cuuint64_t strides[1] = {(cuuint64_t)HD * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
    CUtensorMap km, vm;
    if (!bf16_map(&km, k, 2, dims, strides, box) ||
        !bf16_map(&vm, v, 2, dims, strides, box))
      return cudaErrorInvalidValue;
    return launch_sm90<C>(paged_multitok_kernel<HD>, configured, grid, stream,
                          qm, km, vm, pt, pos0, lens, static_cast<bf16*>(out),
                          S, H, KV, P, ps, box_rows, ctx_pages, window, scale,
                          softcap);
  }
}

template <bool kInt8>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pt, const void* pos0,
             const void* lens, void* out, int B, int S, int H, int KV, int P,
             int ps, int ctx_pages, int hd, int window, float scale,
             float softcap, void* stream) {
  const int* t = static_cast<const int*>(pt);
  const int* p0 = static_cast<const int*>(pos0);
  const int* il = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return cudaSuccess;
  switch (hd) {
    case 64:
      return launch<64, kInt8>(q, k, v, ks, vs, t, p0, il, out, B, S, H, KV,
                               P, ps, ctx_pages, window, scale, softcap, s);
    case 128:
      return launch<128, kInt8>(q, k, v, ks, vs, t, p0, il, out, B, S, H, KV,
                                P, ps, ctx_pages, window, scale, softcap, s);
    case 256:
      return launch<256, kInt8>(q, k, v, ks, vs, t, p0, il, out, B, S, H, KV,
                                P, ps, ctx_pages, window, scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vgt_paged_multitok_bf16(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* page_tables,
                                       const void* positions0,
                                       const void* input_lens, void* out,
                                       int B, int S, int H, int KV, int P,
                                       int ps, int ctx_pages, int hd,
                                       int window, float scale, float softcap,
                                       void* stream) {
  return dispatch<false>(q, k_pages, v_pages, nullptr, nullptr, page_tables,
                         positions0, input_lens, out, B, S, H, KV, P, ps,
                         ctx_pages, hd, window, scale, softcap, stream);
}

// int8 pools [KV, P, ps, hd] with bf16 scale pools [KV, P, ps]; q and the
// output bf16; pools and scale pools on 16 bytes
extern "C" int vgt_paged_multitok_int8(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const void* k_scale,
                                       const void* v_scale,
                                       const void* page_tables,
                                       const void* positions0,
                                       const void* input_lens, void* out,
                                       int B, int S, int H, int KV, int P,
                                       int ps, int ctx_pages, int hd,
                                       int window, float scale, float softcap,
                                       void* stream) {
  return dispatch<true>(q, k_pages, v_pages, k_scale, v_scale, page_tables,
                        positions0, input_lens, out, B, S, H, KV, P, ps,
                        ctx_pages, hd, window, scale, softcap, stream);
}
