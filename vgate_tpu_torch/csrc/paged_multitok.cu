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
// a prefix-cache hit, of a copy-on-write hit and of every prefill chunk.
// Semantic spec: vgate_tpu_torch/ops/attention.py paged_suffix_attention.
//
// What bounds it on an H100: operations.  A suffix pass of S rows over a
// context of C keys does about 4 * H * hd * S * C flops on
// (S * 2H + 2 * C * KV) * hd * 2 bytes: at S 512 over a 1536-token context
// that is ~900 flops per byte, so the limit is the 989 TFLOP/s bf16
// tensor-core rate.
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
// int8 pools (K3-int8) keep the WMMA tile loop of flash_tile.cuh (Q8):
// each 8-byte load of a row widens to bf16 in shared memory (exact), the
// row's K and V scales go beside the tile, and the tile loop folds them
// into the scores and the softmax weights -- the pool bytes per key halve
// and no dequantized K or V tile exists.  The G query heads of a kv head
// share no K/V load in either mode (L2 serves the repeats).
//
// Rows past input_lens are finite and unspecified, as in the TPU kernel.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch on the caller's stream (cudaErrorInvalidValue for a page size the
// bf16 path does not take or a tensor map that cannot be encoded); the
// kernels allocate nothing.

#include "flash_sm90.cuh"
#include "flash_tile.cuh"

namespace {

// ------------------------------------------------ bf16 pools (Hopper)

namespace bf16_pools {

using namespace vgt_sm90;

// K and V rows through the page table: box j of a tile covers positions
// k_start + j * box_rows .. + box_rows - 1 of one page, for each 64-column
// block
template <int HD>
struct PagedLoader {
  using C = Cfg<HD, true>;
  const CUtensorMap* q;
  const CUtensorMap* k;  // 2-D over the layer view [KV * P * ps, HD]
  const CUtensorMap* v;
  const int* pt_row;     // this slot's page-table row
  int h, row0, b;
  int head_page0;        // kvh * P: the kv head's first page in the view
  int ps, box_rows, seq_len;

  __device__ void prefetch() const {
    tma_prefetch(q);
    tma_prefetch(k);
    tma_prefetch(v);
  }
  __device__ void load_q(uint32_t dst, uint32_t bar, int cb) const {
    tma_load_4d(dst, q, bar, cb * 64, h, row0, b);
  }
  // lane j: the page id of box j of tile kt (0 for boxes at or past
  // seq_len, whose table entries are never read)
  __device__ int ids(int kt, int lane) const {
    const int pos = kt * C::kN + lane * box_rows;
    return lane < C::kN / box_rows && pos < seq_len ? pt_row[pos / ps] : 0;
  }
  // all lanes of the producer warp (the ids come by shuffle), lane 0
  // issues: once the stage is free (K and V are freed together), the K and
  // V boxes of each page in turn, only the boxes that start below seq_len
  __device__ void load_kv(int kt, int ids, int lane, uint32_t dk,
                          uint32_t dv, uint32_t bk, uint32_t bv, uint32_t,
                          uint32_t ev, uint32_t parity) const {
    static_assert(C::kJointRelease, "one wait frees K and V");
    const int k_start = kt * C::kN;
    const int live = min(C::kN / box_rows,
                         (seq_len - k_start + box_rows - 1) / box_rows);
    const uint32_t bytes = live * box_rows * 128 * C::kBlocks;
    if (lane == 0) {
      mbar_wait(ev, parity);
      mbar_expect_tx(bk, bytes);
      mbar_expect_tx(bv, bytes);
    }
    for (int j = 0; j < live; ++j) {
      const int page = __shfl_sync(0xffffffffu, ids, j);
      if (lane == 0) {
        const int row =
            (head_page0 + page) * ps + (k_start + j * box_rows) % ps;
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
  int qt, h, b;
  tile_coords<C::kLongestFirst>(qt, h, b);
  const int row0 = qt * kRows;  // first query row of the tile (local)
  const int n_rows = min(kRows, S - row0);
  const int input_len = min(input_lens[b], S);
  bf16* out_tile = out + (((size_t)b * S + row0) * H + h) * HD;

  if (row0 >= input_len) {
    // an idle tile: finite zeros, nothing read
    constexpr int VPR = HD / 8;
    for (int i = threadIdx.x; i < n_rows * VPR; i += kThreads)
      *reinterpret_cast<uint4*>(out_tile + (size_t)(i / VPR) * H * HD +
                                (i % VPR) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }
  const int pos0 = positions0[b];
  Tile t;
  t.q_start = pos0 + row0;  // global position of tile row 0
  t.n_rows = n_rows;
  t.n_live = min(n_rows, input_len - row0);
  // never read the table at or past its width, whatever the lengths say
  t.seq_len = min(pos0 + input_len, ctx_pages * ps);
  t.window = window;
  key_tiles<C>(t);
  const PagedLoader<HD> ld{&qmap, &kmap, &vmap,
                           page_tables + (size_t)b * ctx_pages,
                           h, row0, b, (h / (H / KV)) * P, ps, box_rows,
                           t.seq_len};
  attend<C>(ld, t, smem, scale, softcap, out_tile, (size_t)H * HD);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pt, const int* pos0, const int* lens,
                   void* out, int B, int S, int H, int KV, int P, int ps,
                   int ctx_pages, int window, float scale, float softcap,
                   cudaStream_t stream) {
  using C = Cfg<HD, true>;
  constexpr int kN = C::kN;
  static bool configured = false;  // once per instantiation
  const int box_rows = ps < kN ? ps : kN;
  if (ps % 8 != 0 || (kN % ps != 0 && ps % kN != 0))
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)HD, (cuuint64_t)KV * P * ps};
  const cuuint64_t strides[1] = {(cuuint64_t)HD * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  CUtensorMap qm, km, vm;
  if (!rows_map<HD>(&qm, q, B, S, H, kRows) ||
      !bf16_map(&km, k, 2, dims, strides, box) ||
      !bf16_map(&vm, v, 2, dims, strides, box))
    return cudaErrorInvalidValue;
  dim3 grid((S + kRows - 1) / kRows, H, B);
  return launch_sm90<C>(paged_multitok_kernel<HD>, configured, grid, stream,
                        qm, km, vm, pt, pos0, lens, static_cast<bf16*>(out),
                        S, H, KV, P, ps, box_rows, ctx_pages, window, scale,
                        softcap);
}

}  // namespace bf16_pools

// --------------------------------------- int8 pools (the WMMA tile loop)

namespace int8_pools {

using namespace vgt_flash;

// gather a [kTile, HD] int8 key (or value) tile through one slot's
// page-table row, 8 int8 values a load widened to bf16 (unscaled), and the
// rows' scales into sc[0..kTile) (0 past seq_len); tile row r is position
// k_start + r, zero-filled at or past seq_len
template <int HD>
__device__ __forceinline__ void gather_tile_i8(
    bf16* dst, float* sc, const int8_t* __restrict__ pool,
    const bf16* __restrict__ scale_pool, const int* __restrict__ pt_row,
    int k_start, int seq_len, int ps) {
  constexpr int VPR = HD / 8;  // 8-byte vectors per row
  for (int i = threadIdx.x; i < kTile * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int pos = k_start + r;
    uint2 raw = make_uint2(0, 0);
    if (pos < seq_len) {
      const size_t row = (size_t)pt_row[pos / ps] * ps + pos % ps;
      raw = *reinterpret_cast<const uint2*>(pool + row * HD + c);
    }
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    __align__(16) bf16 w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = __float2bfloat16_rn((float)b[e]);
    *reinterpret_cast<uint4*>(dst + r * Smem<HD>::LDQ + c) =
        *reinterpret_cast<const uint4*>(w);
  }
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int pos = k_start + r;
    sc[r] = pos < seq_len
                ? __bfloat162float(
                      scale_pool[(size_t)pt_row[pos / ps] * ps + pos % ps])
                : 0.f;
  }
}

// k_scale/v_scale are the bf16 scale pools [KV, P, ps]; two kTile float
// rows of scales follow the tile's shared memory
template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_multitok_i8_kernel(const bf16* __restrict__ q,          // [B, S, H, HD]
                         const int8_t* __restrict__ k_pages,  // [KV,P,ps,HD]
                         const int8_t* __restrict__ v_pages,
                         const bf16* __restrict__ k_scale,    // [KV, P, ps]
                         const bf16* __restrict__ v_scale,
                         const int* __restrict__ page_tables,  // [B, ctx_pages]
                         const int* __restrict__ positions0,   // [B]
                         const int* __restrict__ input_lens,   // [B]
                         bf16* __restrict__ out,              // [B, S, H, HD]
                         int S, int H, int KV, int P, int ps, int ctx_pages,
                         int window, float scale, float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile<HD> t(smem);
  float* ks = reinterpret_cast<float*>(smem + Smem<HD>::bytes);
  float* vs = ks + kTile;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = qt * kTile;  // first query row of the tile (local)
  const int n_rows = min(kTile, S - row0);
  const int input_len = min(input_lens[b], S);
  bf16* out_tile = out + (((size_t)b * S + row0) * H + h) * HD;

  if (row0 >= input_len) {
    // an idle tile: finite zeros, nothing read
    constexpr int VPR = HD / 8;
    for (int i = threadIdx.x; i < n_rows * VPR; i += kThreads)
      *reinterpret_cast<uint4*>(out_tile + (size_t)(i / VPR) * H * HD +
                                (i % VPR) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }

  const int kvh = h / (H / KV);
  const int pos0 = positions0[b];
  // never read the table at or past its width, whatever the lengths say
  const int seq_len = min(pos0 + input_len, ctx_pages * ps);
  const int q_start = pos0 + row0;  // global position of tile row 0
  const int* pt_row = page_tables + (size_t)b * ctx_pages;
  const int8_t* k_head = k_pages + (size_t)kvh * P * ps * HD;
  const int8_t* v_head = v_pages + (size_t)kvh * P * ps * HD;

  load_tile<HD>(t.q, q + (((size_t)b * S + row0) * H + h) * HD,
                (size_t)H * HD, n_rows);
  t.init();
  __syncthreads();  // Q, O, m, l ready even if no key tile is live

  // live key tiles: causal to the tile's last row, below seq_len, and not
  // wholly below the window of the tile's first row
  int kt_hi = min(q_start + n_rows - 1, seq_len - 1) / kTile;
  if (seq_len <= 0) kt_hi = -1;
  int kt_lo = 0;
  if (window > 0) kt_lo = max(0, q_start - window + 1) / kTile;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k_start = kt * kTile;
    __syncthreads();  // previous tile fully consumed
    const size_t sc_head = (size_t)kvh * P * ps;
    gather_tile_i8<HD>(t.k, ks, k_head, k_scale + sc_head, pt_row, k_start,
                       seq_len, ps);
    gather_tile_i8<HD>(t.v, vs, v_head, v_scale + sc_head, pt_row, k_start,
                       seq_len, ps);
    __syncthreads();
    attend_tile<HD, true>(t, k_start, q_start, seq_len, window, scale,
                          softcap, ks, vs);
  }

  store_rows<HD>(t, out_tile, (size_t)H * HD, n_rows);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const int* pt,
                   const int* pos0, const int* lens, void* out, int B, int S,
                   int H, int KV, int P, int ps, int ctx_pages, int window,
                   float scale, float softcap, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  dim3 grid((S + kTile - 1) / kTile, H, B);
  return launch_tiles<HD, 2 * kTile * sizeof(float)>(
      paged_multitok_i8_kernel<HD>, configured, grid, stream,
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), pt, pos0, lens, static_cast<bf16*>(out),
      S, H, KV, P, ps, ctx_pages, window, scale, softcap);
}

}  // namespace int8_pools

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
  using namespace bf16_pools;
  const int* pt = static_cast<const int*>(page_tables);
  const int* p0 = static_cast<const int*>(positions0);
  const int* il = static_cast<const int*>(input_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return cudaSuccess;
  switch (hd) {
    case 64:
      return launch<64>(q, k_pages, v_pages, pt, p0, il, out, B, S, H, KV, P,
                        ps, ctx_pages, window, scale, softcap, s);
    case 128:
      return launch<128>(q, k_pages, v_pages, pt, p0, il, out, B, S, H, KV, P,
                         ps, ctx_pages, window, scale, softcap, s);
    case 256:
      return launch<256>(q, k_pages, v_pages, pt, p0, il, out, B, S, H, KV, P,
                         ps, ctx_pages, window, scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// int8 pools [KV, P, ps, hd] with bf16 scale pools [KV, P, ps]; q and the
// output bf16
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
  using namespace int8_pools;
  const int* pt = static_cast<const int*>(page_tables);
  const int* p0 = static_cast<const int*>(positions0);
  const int* il = static_cast<const int*>(input_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return cudaSuccess;
  switch (hd) {
    case 64:
      return launch<64>(q, k_pages, v_pages, k_scale, v_scale, pt, p0, il,
                        out, B, S, H, KV, P, ps, ctx_pages, window, scale,
                        softcap, s);
    case 128:
      return launch<128>(q, k_pages, v_pages, k_scale, v_scale, pt, p0, il,
                         out, B, S, H, KV, P, ps, ctx_pages, window, scale,
                         softcap, s);
    case 256:
      return launch<256>(q, k_pages, v_pages, k_scale, v_scale, pt, p0, il,
                         out, B, S, H, KV, P, ps, ctx_pages, window, scale,
                         softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}
