// The WMMA tile loop of the int8 mode of the paged multi-token kernel
// (paged_multitok.cu, K3-int8, the Q8 instantiation): its only user.  The
// flash-prefill kernel (K2) and K3's bf16 path run on the Hopper pipeline
// of flash_sm90.cuh instead; the Q8 = false branches below are no longer
// instantiated.
//
// One CTA owns a 64-row query tile of one (batch row, head) and walks the
// live 64-row key tiles: S = Q K^T and O += P V on the tensor cores (WMMA
// bf16 16x16x16, fp32 accumulate), online softmax in fp32, the output
// accumulator in shared memory.  4 warps, each owning 16 query rows, so
// the softmax state of a row never leaves its warp.
//
// Q8 = true: the K and V tiles hold the raw int8 values widened to bf16
// UNSCALED (exact: |v| <= 127), the products run as before, and the scales
// fold in as the TPU kernel folds them: the K scale multiplies each score
// column in fp32 before softcap and mask, the V scale multiplies the
// softmax weight after the row sum took the unweighted p.
//
// Masked scores take the reference's -1e30 sentinel and the output divides
// by max(l, 1e-30), so a fully masked row yields finite garbage, never NaN,
// exactly as the TPU kernels do.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace vgt_flash {

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

// The CTA's views of its dynamic shared memory.
template <int HD>
struct Tile {
  bf16* q;
  bf16* k;
  bf16* v;
  float* s;
  bf16* p;
  float* o;
  float* m;
  float* l;

  __device__ explicit Tile(unsigned char* smem)
      : q(reinterpret_cast<bf16*>(smem + Smem<HD>::q)),
        k(reinterpret_cast<bf16*>(smem + Smem<HD>::k)),
        v(reinterpret_cast<bf16*>(smem + Smem<HD>::v)),
        s(reinterpret_cast<float*>(smem + Smem<HD>::s)),
        p(reinterpret_cast<bf16*>(smem + Smem<HD>::p)),
        o(reinterpret_cast<float*>(smem + Smem<HD>::o)),
        m(reinterpret_cast<float*>(smem + Smem<HD>::ml)),
        l(reinterpret_cast<float*>(smem + Smem<HD>::ml) + kTile) {}

  // zero the output accumulator, m = -1e30, l = 0
  __device__ void init() {
    using L = Smem<HD>;
    for (int i = threadIdx.x; i < kTile * L::LDO; i += kThreads) o[i] = 0.f;
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      m[i] = kNeg;
      l[i] = 0.f;
    }
  }
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

// One key tile into the running softmax of the CTA's 64 query rows.  The
// K and V tiles are in shared memory (the caller synchronised after
// loading them).  Query row r (0..63) of the tile sits at global position
// q_start + r; key column c at k_start + c.  A key is visible when
// k_pos <= q_pos, k_pos < seq_len and, with window > 0, q_pos - k_pos <
// window.  With Q8, ks[c] and vs[c] (shared memory) are key column c's K
// and V scales.
template <int HD, bool Q8 = false>
__device__ __forceinline__ void attend_tile(const Tile<HD>& t, int k_start,
                                            int q_start, int seq_len,
                                            int window, float scale,
                                            float softcap,
                                            const float* ks = nullptr,
                                            const float* vs = nullptr) {
  using L = Smem<HD>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // S = Q K^T for this warp's 16 rows x 64 keys
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, t.q + warp * 16 * L::LDQ + kk * 16, L::LDQ);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // K^T(d, key) = sK[key][d]: column-major with stride LDQ
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, t.k + j * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(acc[j], a, bk, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(t.s + warp * 16 * L::LDS + j * 16, acc[j],
                              L::LDS, wmma::mem_row_major);
  }
  __syncwarp();

  // online softmax of row r over columns [32 * half, 32 * half + 32)
  {
    const int r = warp * 16 + (lane >> 1);
    const int half = lane & 1;
    const int q_pos = q_start + r;
    float sv[32];
    float mx = kNeg;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const int k_pos = k_start + col;
      float s = t.s[r * L::LDS + col] * scale;
      if constexpr (Q8) s *= ks[col];  // K scale: before softcap and mask
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      bool ok = (k_pos <= q_pos) && (k_pos < seq_len);
      if (window > 0) ok = ok && (q_pos - k_pos < window);
      sv[c] = ok ? s : kNeg;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = t.m[r];
    const float m_new = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sv[c] - m_new);
      sum += p;  // the unweighted p
      if constexpr (Q8)  // V scale: into the weight of P V
        t.p[r * L::LDP + half * 32 + c] =
            __float2bfloat16(p * vs[half * 32 + c]);
      else
        t.p[r * L::LDP + half * 32 + c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); ++c)
      t.o[r * L::LDO + c] *= alpha;
    __syncwarp();
    if (half == 0) {
      t.m[r] = m_new;
      t.l[r] = t.l[r] * alpha + sum;
    }
  }
  __syncwarp();

  // O += P V for this warp's 16 rows
#pragma unroll 1
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    float* o_ptr = t.o + warp * 16 * L::LDO + n * 16;
    wmma::load_matrix_sync(o, o_ptr, L::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(a, t.p + warp * 16 * L::LDP + kk * 16, L::LDP);
      wmma::load_matrix_sync(bv, t.v + kk * 16 * L::LDQ + n * 16, L::LDQ);
      wmma::mma_sync(o, a, bv, o);
    }
    wmma::store_matrix_sync(o_ptr, o, L::LDO, wmma::mem_row_major);
  }
  __syncwarp();
}

// Normalise the warp's rows and write those below n_rows: tile row r goes
// to out + r * row_stride.
template <int HD>
__device__ __forceinline__ void store_rows(const Tile<HD>& t, bf16* out,
                                           size_t row_stride, int n_rows) {
  using L = Smem<HD>;
  __syncwarp();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  if (r >= n_rows) return;
  const float inv = 1.f / fmaxf(t.l[r], 1e-30f);
  bf16* dst = out + r * row_stride;
  for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); c += 2) {
    __nv_bfloat162 pair = __floats2bfloat162_rn(t.o[r * L::LDO + c] * inv,
                                                t.o[r * L::LDO + c + 1] * inv);
    *reinterpret_cast<__nv_bfloat162*>(dst + c) = pair;
  }
}

// Set the dynamic shared-memory limit of `kern` once, then launch it with
// the tile's shared memory plus `EXTRA` bytes after it.
template <int HD, size_t EXTRA = 0, typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kern, bool& configured, dim3 grid,
                         cudaStream_t stream, Args... args) {
  const size_t smem = Smem<HD>::bytes + EXTRA;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace vgt_flash
