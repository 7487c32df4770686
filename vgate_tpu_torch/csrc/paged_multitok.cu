// Paged multi-token attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel vgate_tpu/ops/pallas/paged_attention.py
// paged_multitok_attention_pallas (body _mt_kernel): S query rows per slot,
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
// What the design does about it: the tile loop of the flash-prefill kernel
// (flash_tile.cuh: one CTA per 64-row query tile x head x slot, WMMA bf16,
// online softmax in fp32), with each key tile's 64 rows gathered through
// the page table instead of read contiguously.  What differs from K2:
//  * the page table is read only below seq_len = positions0 + input_lens,
//    clamped on the device to the table's width (ctx_pages * ps): the
//    width is bucketed and padded with trash page 0, and a column at or
//    past ceil(seq_len / ps) is never read;
//  * key tiles are 64-position aligned, not page aligned, so any page
//    size works, and a copy-on-write suffix starting mid-page (query tile
//    and first key tile unaligned) needs nothing special: every mask is
//    positional;
//  * query tiles wholly past input_lens (the suffix bucket is wider than
//    the real suffix) write zeros and exit before loading anything;
//  * key tiles above the tile's last row or wholly below the window of
//    its first row are never loaded.
// Not yet done (later work): the G query heads of a kv head share no K/V
// load (L2 serves the repeats), and the WMMA path reaches a fraction of
// the peak, as K2's does.
//
// Rows past input_lens are finite and unspecified, as in the TPU kernel.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch on the caller's stream; the kernel allocates nothing.

#include "flash_tile.cuh"

namespace {

using namespace vgt_flash;

// gather a [kTile, HD] key (or value) tile through one slot's page-table
// row: tile row r is position k_start + r, zero-filled at or past seq_len
template <int HD>
__device__ __forceinline__ void gather_tile(bf16* dst,
                                            const bf16* __restrict__ pool,
                                            const int* __restrict__ pt_row,
                                            int k_start, int seq_len, int ps) {
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kTile * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int pos = k_start + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos < seq_len) {
      const size_t row = (size_t)pt_row[pos / ps] * ps + pos % ps;
      val = *reinterpret_cast<const uint4*>(pool + row * HD + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<HD>::LDQ + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_multitok_kernel(const bf16* __restrict__ q,        // [B, S, H, HD]
                      const bf16* __restrict__ k_pages,  // [KV, P, ps, HD]
                      const bf16* __restrict__ v_pages,
                      const int* __restrict__ page_tables,  // [B, ctx_pages]
                      const int* __restrict__ positions0,   // [B]
                      const int* __restrict__ input_lens,   // [B]
                      bf16* __restrict__ out,            // [B, S, H, HD]
                      int S, int H, int KV, int P, int ps, int ctx_pages,
                      int window, float scale, float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile<HD> t(smem);

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
  const bf16* k_head = k_pages + (size_t)kvh * P * ps * HD;
  const bf16* v_head = v_pages + (size_t)kvh * P * ps * HD;

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
    gather_tile<HD>(t.k, k_head, pt_row, k_start, seq_len, ps);
    gather_tile<HD>(t.v, v_head, pt_row, k_start, seq_len, ps);
    __syncthreads();
    attend_tile<HD>(t, k_start, q_start, seq_len, window, scale, softcap);
  }

  store_rows<HD>(t, out_tile, (size_t)H * HD, n_rows);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pt, const int* pos0, const int* lens,
                   void* out, int B, int S, int H, int KV, int P, int ps,
                   int ctx_pages, int window, float scale, float softcap,
                   cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  dim3 grid((S + kTile - 1) / kTile, H, B);
  return launch_tiles<HD>(
      paged_multitok_kernel<HD>, configured, grid, stream,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), pt, pos0, lens, static_cast<bf16*>(out),
      S, H, KV, P, ps, ctx_pages, window, scale, softcap);
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
