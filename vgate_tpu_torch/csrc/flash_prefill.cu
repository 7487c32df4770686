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
// Masked scores use the reference's -1e30 sentinel and the output divides
// by max(l, 1e-30), so a fully masked padding row yields finite garbage,
// never NaN, exactly as the TPU kernel does.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch on the caller's stream; the kernel allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;     // query rows and key rows per tile
constexpr int kWarps = 4;     // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

template <int HD>
struct Smem {
  static constexpr int LDQ = HD + 8;       // bf16 row stride of Q/K/V
  static constexpr int LDS = kTile + 4;    // fp32 row stride of scores
  static constexpr int LDP = kTile + 8;    // bf16 row stride of P
  static constexpr int LDO = HD + 4;       // fp32 row stride of O
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(bf16) * kTile * LDQ);
  static constexpr size_t v = align128(k + sizeof(bf16) * kTile * LDQ);
  static constexpr size_t s = align128(v + sizeof(bf16) * kTile * LDQ);
  static constexpr size_t p = align128(s + sizeof(float) * kTile * LDS);
  static constexpr size_t o = align128(p + sizeof(bf16) * kTile * LDP);
  static constexpr size_t ml = align128(o + sizeof(float) * kTile * LDO);
  static constexpr size_t bytes = align128(ml + sizeof(float) * 2 * kTile);
};

// copy a [kTile, HD] tile of rows (row r at src + r * row_stride) into
// shared memory, zero-filling rows >= n_rows; 16 bytes per thread-step
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t row_stride, int n_rows) {
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kTile * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<HD>::LDQ + c) = val;
  }
}

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
  using L = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::ml);
  float* sL = sM + kTile;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seq_len = min(seq_lens[b], Sk);
  const int q_off = q_offsets ? q_offsets[b] : 0;
  const int row0 = qt * kTile;          // first query row (local)
  const int q_start = q_off + row0;     // its global position

  load_tile<HD>(sQ, q + (((size_t)b * S + row0) * H + h) * HD,
                (size_t)H * HD, min(kTile, S - row0));
  for (int i = threadIdx.x; i < kTile * L::LDO; i += kThreads) sO[i] = 0.f;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    sM[i] = kNeg;
    sL[i] = 0.f;
  }
  __syncthreads();  // Q, O, m, l ready even if no key tile is live

  // live key tiles: causal (k <= q_start + 63), below the key length,
  // and not wholly below the window of the tile's first row
  const int n_k = (Sk + kTile - 1) / kTile;
  int kt_hi = min(n_k - 1, (q_start + kTile - 1) / kTile);
  kt_hi = min(kt_hi, (seq_len - 1) / kTile);
  if (seq_len <= 0) kt_hi = -1;
  int kt_lo = 0;
  if (window > 0) kt_lo = max(0, q_start - window + 1) / kTile;

  // this lane's softmax row and half-row of columns
  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int q_pos = q_start + r;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k_start = kt * kTile;
    __syncthreads();  // previous tile fully consumed
    const size_t kv_base = (((size_t)b * Sk + k_start) * KV + kvh) * HD;
    load_tile<HD>(sK, k + kv_base, (size_t)KV * HD, min(kTile, Sk - k_start));
    load_tile<HD>(sV, v + kv_base, (size_t)KV * HD, min(kTile, Sk - k_start));
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * L::LDQ + kk * 16, L::LDQ);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // K^T(d, key) = sK[key][d]: column-major with stride LDQ
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              bk;
          wmma::load_matrix_sync(bk, sK + j * 16 * L::LDQ + kk * 16, L::LDQ);
          wmma::mma_sync(acc[j], a, bk, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(sS + warp * 16 * L::LDS + j * 16, acc[j],
                                L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of row r over columns [32 * half, 32 * half + 32)
    {
      float sv[32];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int col = half * 32 + c;
        const int k_pos = k_start + col;
        float s = sS[r * L::LDS + col] * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        bool ok = (k_pos <= q_pos) && (k_pos < seq_len);
        if (window > 0) ok = ok && (q_pos - k_pos < window);
        sv[c] = ok ? s : kNeg;
        mx = fmaxf(mx, sv[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float p = expf(sv[c] - m_new);
        sum += p;
        sP[r * L::LDP + half * 32 + c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); ++c)
        sO[r * L::LDO + c] *= alpha;
      __syncwarp();
      if (half == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
#pragma unroll 1
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      float* o_ptr = sO + warp * 16 * L::LDO + n * 16;
      wmma::load_matrix_sync(o, o_ptr, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + warp * 16 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(bv, sV + kk * 16 * L::LDQ + n * 16, L::LDQ);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(o_ptr, o, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // normalize and write the warp's rows (rows past S are padding)
  __syncwarp();
  const int s_row = row0 + r;
  if (s_row < S) {
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    bf16* dst = out + (((size_t)b * S + s_row) * H + h) * HD;
    for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); c += 2) {
      __nv_bfloat162 pair = __floats2bfloat162_rn(
          sO[r * L::LDO + c] * inv, sO[r * L::LDO + c + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(dst + c) = pair;
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seq_lens, const int* q_offsets, void* out,
                   int B, int S, int Sk, int H, int KV, int window,
                   float scale, float softcap, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  auto kern = flash_prefill_kernel<HD>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((S + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seq_lens, q_offsets,
      static_cast<bf16*>(out), S, Sk, H, KV, window, scale, softcap);
  return cudaGetLastError();
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
