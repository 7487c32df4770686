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
// What the design does about it (the tile pipeline is flash_sm90.cuh,
// shared with the bf16 path of the paged multi-token kernel, K3):
//  * both products on wgmma, the only route to the tensor cores' full
//    rate: S = Q K^T with both operands in swizzled shared memory, O += P V
//    with P from registers; scores, P and O never touch shared memory;
//  * one CTA per (128-row query tile, head, batch row): a producer warp
//    keeps TMA copies of the next K and V tiles in flight in a ring of 3
//    stages (2 at hd 256) while two consumer warpgroups (64 rows each)
//    multiply, so copies overlap the tensor cores; the consumers take
//    turns issuing S = Q K^T, so one's softmax runs under the other's
//    products;
//  * Q, K and V arrive by TMA through 4-D tensor maps over q [B, S, H, hd]
//    and k/v [B, Sk, KV, hd] (rows past S or Sk read as zeros), encoded on
//    the host at each launch;
//  * key tiles above the causal diagonal, past the row's key length or
//    wholly below the sliding window are never loaded, and the masks run
//    only on tiles that cross one of those edges;
//  * CTAs start longest causal rows first across the whole grid: a CTA's
//    work runs from 1 to S / 128 key tiles, and K and V fit in L2.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch on the caller's stream (cudaErrorInvalidValue when a tensor map
// cannot be encoded); the kernel allocates nothing.

#include "flash_sm90.cuh"

namespace {

using namespace vgt_sm90;

// K and V rows are contiguous: one 4-D box per 64-column block
template <int HD>
struct DenseLoader {
  using C = Cfg<HD, false>;
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  int h, kvh, row0, b;

  __device__ void prefetch() const {
    tma_prefetch(q);
    tma_prefetch(k);
    tma_prefetch(v);
  }
  __device__ void load_q(uint32_t dst, uint32_t bar, int cb) const {
    tma_load_4d(dst, q, bar, cb * 64, h, row0, b);
  }
  __device__ int ids(int, int) const { return 0; }
  __device__ void load_kv(int kt, int, int lane, uint32_t dk, uint32_t dv,
                          uint32_t bk, uint32_t bv, uint32_t ek, uint32_t ev,
                          uint32_t parity) const {
    if (lane != 0) return;
    mbar_wait(C::kJointRelease ? ev : ek, parity);
    mbar_expect_tx(bk, C::kKVBytes);
    for (int cb = 0; cb < C::kBlocks; ++cb)
      tma_load_4d(dk + cb * C::kKVBlock, k, bk, cb * 64, kvh, kt * C::kN, b);
    mbar_wait(ev, parity);
    mbar_expect_tx(bv, C::kKVBytes);
    for (int cb = 0; cb < C::kBlocks; ++cb)
      tma_load_4d(dv + cb * C::kKVBlock, v, bv, cb * 64, kvh, kt * C::kN, b);
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap qmap,  // [B,S,H,HD]
                     const __grid_constant__ CUtensorMap kmap,  // [B,Sk,KV,HD]
                     const __grid_constant__ CUtensorMap vmap,
                     const int* __restrict__ seq_lens,   // [B]
                     const int* __restrict__ q_offsets,  // [B] or null
                     bf16* __restrict__ out,             // [B, S, H, HD]
                     int S, int Sk, int H, int KV, int window, float scale,
                     float softcap) {
  extern __shared__ unsigned char smem[];
  using C = Cfg<HD, false>;
  int qt, h, b;
  tile_coords<C::kLongestFirst>(qt, h, b);
  const int row0 = qt * kRows;  // first query row (local)
  Tile t;
  t.q_start = (q_offsets ? q_offsets[b] : 0) + row0;
  t.n_rows = min(kRows, S - row0);  // rows past S are padding
  t.n_live = t.n_rows;
  t.seq_len = min(seq_lens[b], Sk);
  t.window = window;
  key_tiles<C>(t);
  const DenseLoader<HD> ld{&qmap, &kmap, &vmap, h, h / (H / KV), row0, b};
  attend<C>(ld, t, smem, scale, softcap,
            out + (((size_t)b * S + row0) * H + h) * HD, (size_t)H * HD);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seq_lens, const int* q_offsets, void* out,
                   int B, int S, int Sk, int H, int KV, int window,
                   float scale, float softcap, cudaStream_t stream) {
  using C = Cfg<HD, false>;
  static bool configured = false;  // once per instantiation
  CUtensorMap qm, km, vm;
  if (!rows_map<HD>(&qm, q, B, S, H, kRows) ||
      !rows_map<HD>(&km, k, B, Sk, KV, C::kN) ||
      !rows_map<HD>(&vm, v, B, Sk, KV, C::kN))
    return cudaErrorInvalidValue;
  dim3 grid((S + kRows - 1) / kRows, H, B);
  return launch_sm90<C>(flash_prefill_kernel<HD>, configured, grid, stream,
                        qm, km, vm, seq_lens, q_offsets,
                        static_cast<bf16*>(out), S, Sk, H, KV, window, scale,
                        softcap);
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
