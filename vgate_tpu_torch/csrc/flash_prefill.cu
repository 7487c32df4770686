// Flash-attention prompt pass for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel vgate_tpu/ops/pallas/flash_prefill.py
// flash_prefill_attention_pallas (body _kernel): causal attention over a
// padded prompt batch, per-row key length, optional q_offsets (queries that
// start at a nonzero global position), sliding window, logit softcap and a
// query scale; GQA maps query head h to kv head h / G.
// Semantic spec: vgate_tpu_torch/ops/attention.py flash_prefill_attention.
//
// What bounds it on an H100: operations.  The causal pass does about
// 2 * B * H * hd * S^2 flops (QK^T and PV over the lower triangle) on
// B * S * (H + 2 KV) * hd * 2 bytes, hundreds of flops per byte at the
// serving buckets, so the limit is the 989 TFLOP/s bf16 tensor-core rate.
//
// What the design does about it:
//  * one CTA per (64-row query tile, head, batch row); 4 warps, each owns
//    16 query rows, so the softmax state of a row never leaves its warp;
//  * Q, K and V tiles (64 x hd) pass through shared memory once per tile;
//    both products run on the tensor cores (WMMA bf16 16x16x16, fp32
//    accumulate); the softmax is online in fp32 and the output
//    accumulator stays in shared memory — no score matrix reaches HBM;
//  * key tiles above the causal diagonal, past the row's key length or
//    wholly below the sliding window are never loaded.
// Not yet done (later work): wgmma + TMA with a producer warp and a tile
// ring (FA3 style); the WMMA path reaches a fraction of the peak.
//
// The tile loop (Q K^T, online softmax, P V) is flash_tile.cuh, shared
// with the paged multi-token kernel (paged_multitok.cu, K3).
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch on the caller's stream; the kernel allocates nothing.

#include "flash_tile.cuh"

namespace {

using namespace vgt_flash;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const bf16* __restrict__ q,   // [B, S, H, HD]
                     const bf16* __restrict__ k,   // [B, Sk, KV, HD]
                     const bf16* __restrict__ v,   // [B, Sk, KV, HD]
                     const int* __restrict__ seq_lens,   // [B]
                     const int* __restrict__ q_offsets,  // [B] or null
                     bf16* __restrict__ out,       // [B, S, H, HD]
                     int S, int Sk, int H, int KV, int window, float scale,
                     float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile<HD> t(smem);

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int seq_len = min(seq_lens[b], Sk);
  const int q_off = q_offsets ? q_offsets[b] : 0;
  const int row0 = qt * kTile;          // first query row (local)
  const int q_start = q_off + row0;     // its global position
  const int n_rows = min(kTile, S - row0);

  load_tile<HD>(t.q, q + (((size_t)b * S + row0) * H + h) * HD,
                (size_t)H * HD, n_rows);
  t.init();
  __syncthreads();  // Q, O, m, l ready even if no key tile is live

  // live key tiles: causal (k <= q_start + 63), below the key length,
  // and not wholly below the window of the tile's first row
  const int n_k = (Sk + kTile - 1) / kTile;
  int kt_hi = min(n_k - 1, (q_start + kTile - 1) / kTile);
  kt_hi = min(kt_hi, (seq_len - 1) / kTile);
  if (seq_len <= 0) kt_hi = -1;
  int kt_lo = 0;
  if (window > 0) kt_lo = max(0, q_start - window + 1) / kTile;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k_start = kt * kTile;
    __syncthreads();  // previous tile fully consumed
    const size_t kv_base = (((size_t)b * Sk + k_start) * KV + kvh) * HD;
    load_tile<HD>(t.k, k + kv_base, (size_t)KV * HD, min(kTile, Sk - k_start));
    load_tile<HD>(t.v, v + kv_base, (size_t)KV * HD, min(kTile, Sk - k_start));
    __syncthreads();
    attend_tile<HD>(t, k_start, q_start, seq_len, window, scale, softcap);
  }

  // normalize and write the tile's rows (rows past S are padding)
  store_rows<HD>(t, out + (((size_t)b * S + row0) * H + h) * HD,
                 (size_t)H * HD, n_rows);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seq_lens, const int* q_offsets, void* out,
                   int B, int S, int Sk, int H, int KV, int window,
                   float scale, float softcap, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  dim3 grid((S + kTile - 1) / kTile, H, B);
  return launch_tiles<HD>(
      flash_prefill_kernel<HD>, configured, grid, stream,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seq_lens, q_offsets,
      static_cast<bf16*>(out), S, Sk, H, KV, window, scale, softcap);
}

}  // namespace

extern "C" int vgt_flash_prefill_bf16(const void* q, const void* k,
                                      const void* v, const void* seq_lens,
                                      const void* q_offsets, void* out,
                                      int B, int S, int Sk, int H, int KV,
                                      int hd, int window, float scale,
                                      float softcap, void* stream) {
  const int* sl = static_cast<const int*>(seq_lens);
  const int* qo = static_cast<const int*>(q_offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return cudaSuccess;
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, sl, qo, out, B, S, Sk, H, KV, window, scale,
                        softcap, s);
    case 128:
      return launch<128>(q, k, v, sl, qo, out, B, S, Sk, H, KV, window, scale,
                         softcap, s);
    case 256:
      return launch<256>(q, k, v, sl, qo, out, B, S, Sk, H, KV, window, scale,
                         softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}
