// The int4 dequant matmul for Hopper (sm_90a), K5: bf16 activations times
// packed int4 weights, fp32 accumulation, bf16 or fp32 out.  (K4, the
// int8 matmul, lives in int8_matmul.cu: wgmma with the widening stage of
// flash_sm90.cuh.  K5 stays on this WMMA kernel and is the next to move
// onto that design.)
//
// Replaces the TPU kernel vgate_tpu/ops/pallas/quant_matmul.py
// int4_matmul_pallas (body _kernel): out[r, o] = (sum_i x[r, i] * w[i, o])
// * scale[o], the per-output-channel f32 scale applied to the f32 sum
// BEFORE the cast to the output type.  int4 weights are packed two a byte
// in the half-split layout (vgate_tpu_torch/ops/quant.py PackedQTensor):
// byte row i holds w[i] in its low nibble and w[in/2 + i] in its high
// nibble, so the low plane contracts x[:, :in/2] and the high plane
// x[:, in/2:].  Semantic spec: vgate_tpu_torch/ops/kernels/quant_matmul.py
// int4_matmul_plain.
//
// What bounds it on an H100: at decode (R <= 32 rows) bytes: the weight
// (in * out / 2 bytes) is read once for a few flops per byte, so the
// limit is the 3.35 TB/s of HBM, and the kernel's whole point is that only
// the packed nibbles cross it.  At prompt passes of thousands of rows,
// operations: 2 * R * in * out flops at the 989 TFLOP/s bf16 tensor-core
// rate.
//
// What the design does about it:
//  * one CTA per (BM-row tile, 64-column tile, k split); row tiles vary
//    fastest, so CTAs running together read the same weight columns and
//    HBM delivers each weight byte once (the activations stay in L2);
//  * the weight tile crosses HBM packed and is widened in shared memory
//    to bf16 UNSCALED: int4 values are exact in bf16, so the WMMA bf16
//    16x16x16 products with fp32 accumulation compute exactly sum x * w_q,
//    and the scale multiplies the fp32 sum;
//  * each thread loads the next k step's tile into registers while the
//    tensor cores work on the current one;
//  * at decode the tile grid alone cannot fill 132 SMs (a 3584-wide
//    output is 56 tiles), so the k dimension is split over CTAs (the
//    wrapper picks the split); each split writes an fp32 partial and a
//    second launch sums the partials in a fixed order, applies the scale
//    and casts -- no atomics, so the result does not change run to run.
// The WMMA path reaches a fraction of the tensor-core peak at prompt
// shapes (PERF.md).
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launches on the caller's stream; the kernels allocate nothing (the
// wrapper passes the split-k workspace).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BN = 64;         // output columns per CTA
constexpr int BK = 64;         // unpacked k values per step (32 packed rows)
constexpr int kThreads = 128;  // 4 warps; warp w owns columns [16w, 16w+16)
constexpr int LDX = BK + 8;    // bf16 row stride of the activation tile
constexpr int LDW = BN + 8;    // bf16 row stride of the weight tile
constexpr int LDC = BN + 4;    // fp32 row stride of the output tile

template <int BM>
struct alignas(128) Smem {
  bf16 x[BM * LDX];
  bf16 w[BK * LDW];
  float c[BM * LDC];
};

template <typename OutT>
__device__ __forceinline__ OutT cast_out(float v);

template <>
__device__ __forceinline__ float cast_out<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ bf16 cast_out<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 packed bytes -> 16 low-nibble values at lo, 16 high-nibble at hi
// (two's-complement 4-bit, exact in bf16)
__device__ __forceinline__ void widen_i4(const uint4& raw, bf16* lo,
                                         bf16* hi) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
  __align__(16) bf16 vl[16];
  __align__(16) bf16 vh[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    vl[i] = __float2bfloat16_rn((float)(((b[i] & 0x0F) ^ 8) - 8));
    vh[i] = __float2bfloat16_rn((float)(((b[i] >> 4) ^ 8) - 8));
  }
  reinterpret_cast<uint4*>(lo)[0] = reinterpret_cast<const uint4*>(vl)[0];
  reinterpret_cast<uint4*>(lo)[1] = reinterpret_cast<const uint4*>(vl)[1];
  reinterpret_cast<uint4*>(hi)[0] = reinterpret_cast<const uint4*>(vh)[0];
  reinterpret_cast<uint4*>(hi)[1] = reinterpret_cast<const uint4*>(vh)[1];
}

// BM: rows per CTA (32 or 64).  INT4: packed half-split weights (the
// only instantiation since K4 moved to int8_matmul.cu).
// partial != nullptr: write the fp32 sum of this CTA's k split to
// partial[z, r, o] (no scale); else write out[r, o] = sum * scale[o].
template <int BM, bool INT4, typename OutT>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const bf16* __restrict__ x,        // [R, in]
           const uint8_t* __restrict__ w,     // int8 [in, out] / u8 [in/2, out]
           const float* __restrict__ scale,   // [out]
           OutT* __restrict__ out,            // [R, out]
           float* __restrict__ partial,       // [splits, R, out] or null
           int R, int in_dim, int out_dim, int steps_per_split) {
  __shared__ __align__(128) unsigned char smem[sizeof(Smem<BM>)];
  Smem<BM>& sm = *reinterpret_cast<Smem<BM>*>(smem);
  constexpr int XV = BM * (BK / 8) / kThreads;  // 16-byte x loads a thread
  constexpr int WV = INT4 ? 1 : 2;              // 16-byte w loads a thread
  constexpr int MB = BM / 16;                   // 16-row blocks
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int z = blockIdx.z;
  const int step0 = z * steps_per_split;
  const int half = in_dim / 2;
  const int warp = threadIdx.x >> 5;

  uint4 xr[XV], wr[WV];
  auto load = [&](int step) {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      // int4: tile columns [0, 32) are x[:, p0 + c], [32, 64) are
      // x[:, in/2 + p0 + c - 32] with p0 the step's first packed row
      const int col = INT4 ? (c < BK / 2 ? step * (BK / 2) + c
                                         : half + step * (BK / 2) + c - BK / 2)
                           : step * BK + c;
      xr[j] = make_uint4(0, 0, 0, 0);
      if (m0 + r < R)
        xr[j] = *reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * in_dim + col);
    }
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / (BN / 16);
      const int c = (i % (BN / 16)) * 16;
      const size_t row = INT4 ? (size_t)step * (BK / 2) + r
                              : (size_t)step * BK + r;
      wr[j] = *reinterpret_cast<const uint4*>(w + row * out_dim + n0 + c);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&sm.x[r * LDX + c]) = xr[j];
    }
#pragma unroll
    for (int j = 0; j < WV; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / (BN / 16);
      const int c = (i % (BN / 16)) * 16;
      widen_i4(wr[j], &sm.w[r * LDW + c], &sm.w[(r + BK / 2) * LDW + c]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) wmma::fill_fragment(acc[i], 0.f);

  load(step0);
  for (int step = step0; step < step0 + steps_per_split; ++step) {
    __syncthreads();  // the previous step's tiles are consumed
    store();
    __syncthreads();
    if (step + 1 < step0 + steps_per_split) load(step + 1);  // in flight
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, sm.w + kk * 16 * LDW + warp * 16, LDW);
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sm.x + i * 16 * LDX + kk * 16, LDX);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MB; ++i)
    wmma::store_matrix_sync(sm.c + i * 16 * LDC + warp * 16, acc[i], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN;
    const int c = idx % BN;
    if (m0 + r >= R) break;  // rows only grow with idx
    const float v = sm.c[r * LDC + c];
    const size_t o = (size_t)(m0 + r) * out_dim + n0 + c;
    if (partial != nullptr)
      partial[(size_t)z * R * out_dim + o] = v;
    else
      out[o] = cast_out<OutT>(v * scale[n0 + c]);
  }
}

// out[i] = (sum over splits of partial[z, i], in order) * scale, cast
template <typename OutT>
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ partial,
              const float* __restrict__ scale, OutT* __restrict__ out,
              size_t n, int out_dim, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + i];
    out[i] = cast_out<OutT>(s * scale[i % out_dim]);
  }
}

template <int BM, bool INT4, typename OutT>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   void* out, void* partial, int R, int in_dim, int out_dim,
                   int splits, cudaStream_t stream) {
  const int steps = in_dim / BK;
  dim3 grid((R + BM - 1) / BM, out_dim / BN, splits);
  qmm_kernel<BM, INT4, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<OutT*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, R, in_dim,
      out_dim, steps / splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)R * out_dim;
  const size_t want = (n + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  reduce_kernel<OutT><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<OutT*>(out), n, out_dim, splits);
  return cudaGetLastError();
}

template <bool INT4, typename OutT>
cudaError_t launch_rows(const void* x, const void* w, const void* scale,
                        void* out, void* partial, int R, int in_dim,
                        int out_dim, int splits, cudaStream_t stream) {
  if (R <= 32)
    return launch<32, INT4, OutT>(x, w, scale, out, partial, R, in_dim,
                                  out_dim, splits, stream);
  return launch<64, INT4, OutT>(x, w, scale, out, partial, R, in_dim,
                                out_dim, splits, stream);
}

}  // namespace

// x bf16 [R, in_dim]; w packed uint8 [in_dim / 2, out_dim]; scale f32
// [out_dim]; out bf16 (out_f32 == 0) or f32 [R, out_dim]; partial f32
// [splits, R, out_dim] when splits > 1.  in_dim % 64 == 0, out_dim % 64
// == 0, and splits divides in_dim / 64 (the wrapper checks all three).
extern "C" int vgt_int4_matmul(const void* x, const void* w,
                               const void* scale, void* out, void* partial,
                               int R, int in_dim, int out_dim, int splits,
                               int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0) return cudaSuccess;
  if (in_dim % BK || out_dim % BN || splits < 1 || (in_dim / BK) % splits)
    return cudaErrorInvalidValue;
  if (out_f32)
    return launch_rows<true, float>(x, w, scale, out, partial, R, in_dim,
                                    out_dim, splits, s);
  return launch_rows<true, bf16>(x, w, scale, out, partial, R, in_dim,
                                 out_dim, splits, s);
}
