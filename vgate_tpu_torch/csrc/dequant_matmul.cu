// The dequant matmuls for Hopper (sm_90a): bf16 activations times int8
// (K4) or packed int4 (K5) weights, fp32 accumulation, bf16 or fp32 out.
//
// Replaces the TPU kernels of vgate_tpu/ops/pallas/quant_matmul.py:
// int8_matmul_pallas (body _int8_kernel, K4) and int4_matmul_pallas (body
// _kernel, K5): out[r, o] = (sum_i x[r, i] * w[i, o]) * scale[o], the
// per-output-channel f32 scale applied to the f32 sum BEFORE the cast to
// the output type.  int4 weights are packed two a byte in the half-split
// layout (vgate_tpu_torch/ops/quant.py pack_int4): packed row p holds
// w[p] in its low nibble and w[in/2 + p] in its high nibble.  Semantic
// specs: vgate_tpu_torch/ops/kernels/quant_matmul.py int8_matmul_plain,
// int4_matmul_plain.
//
// What bounds them on an H100: at decode (R <= 64 rows) bytes: the weight
// (in * out bytes, or half that packed) is read once for a few flops per
// byte, so the limit is the 3.35 TB/s of HBM, and the point is that only
// the narrow weight crosses it.  At prompt passes of thousands of rows,
// operations: 2 * R * in * out flops at the 989 TFLOP/s bf16 tensor-core
// rate.
//
// What the design does about it: Hopper's copy engine and wgmma, with a
// widening stage (narrow -> bf16, in shared memory) between them: the
// int8 stage of flash_sm90.cuh (widen_tile, which K3-int8 shares) or its
// nibble variant (widen_tile_i4).
//  * A CTA is one producer and two consumer warpgroups.  Its tile is 64 x
//    256 at decode rows (both consumers take the same 64 rows, each half
//    of the columns) or 128 x 128 / 128 x 256 at prompt rows (each
//    consumer 64 rows); a k step is 64 k values.
//  * One producer thread issues, per k step, the TMA copies of x and of
//    the weight box into a ring of stages; rows past R and columns past
//    out come in as TMA's zeros.  (Loading the weight straight into the
//    consumers' registers instead, at prompt rows, measured slower.)
//    - int8 (K4): one bf16 x box of BM rows x 64 (128-byte swizzle: the
//      K-major A operand) and the int8 weight box (64 k rows x BN
//      columns, dense); 6 stages at decode (96 KB of weight in flight an
//      SM), 4 at prompt rows.
//    - int4 (K5): a step is 32 packed rows, so its 64 k values keep the
//      widened tile, its two buffers and the named barriers of K4 as they
//      are.  Packed rows [p0, p0 + 32) contract against x columns
//      [p0, p0 + 32) (low nibbles) and [in/2 + p0, in/2 + p0 + 32) (high
//      nibbles): two x boxes of BM rows x 32 (64-byte rows, so the A
//      operand takes the 64-byte swizzle and its descriptor, k-steps 0-1
//      in the first box, 2-3 in the second), the reference's x_lo / x_hi
//      blocks.  The packed box (32 x BN bytes) is half of K4's, so the
//      ring holds 8 stages at decode and 5 at prompt rows.  A step of 64
//      packed rows would keep 128-byte x boxes but double the widened
//      buffers (2 x 2 x 32 KB at BN 256), leaving too little room for
//      the ring.  in % 64 == 0 makes in/2 a whole number of steps: no
//      step ends short.
//  * The consumers run SS wgmma m64n{BN or BN/2}k16 (B transposed:
//    MN-major) on one of two bf16 weight buffers and, while those products
//    run, widen the next step's weight box (exact, unscaled) into the
//    other, in the 128-byte-swizzled MN-major layout; named barriers among
//    the 256 consumer threads order the buffers, and the tensor cores get
//    a step's products while the last step's still run.  int4 widening
//    is 11 instructions for 8 values (a lop3 a nibble plane, a byte
//    permute and a bf16 subtract a pair: 0x43yy with y = n ^ 8 is
//    136 + v).  A first design widened in the producer's three idle
//    warps and handed each buffer over by mbarriers: 96 threads could not
//    widen fast enough.  Three buffers with one barrier a step measured
//    slower (PERF.md).
//  * The epilogue multiplies the fp32 sums by scale[o] and casts: int8
//    and int4 values are exact in bf16 and bf16 x bf16 products exact in
//    fp32, so the sum is exactly sum x * w_q.
//  * The grid is persistent: a CTA walks units (row tile, column tile, k
//    split) blockIdx.x, + gridDim.x, ...; its copies run on across units,
//    so a pipeline fills once an SM.  Row tiles vary fastest, so CTAs at
//    work together read the same weight columns.  The wrapper picks the
//    tile, the k split and the grid from (bits, rows, in, out, SM count).
//  * With a k split, each unit writes an fp32 partial and a second launch
//    sums the partials in a fixed order, applies the scale and casts -- no
//    atomics, so the result does not change from run to run.  (Summing in
//    the tile's last-arriving CTA instead cost more than the launch: its
//    reads of the partials ran one after another.)
//  * Tensor maps are encoded once per (address, shape, box, swizzle) and
//    kept: the weights are static and the activations' addresses repeat.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launches on the caller's stream (cudaErrorInvalidValue for a shape or
// plan the kernel does not take or a map that cannot be encoded); the
// kernels allocate nothing (the wrapper passes the split-k workspace).

#include "flash_sm90.cuh"

namespace {

using namespace vgt_sm90;

constexpr int kBK = 64;  // k values a step

// One tile configuration: two consumer warpgroups and a BM x BN tile of
// an int8 (K4) or int4 (kInt4, K5) weight.  kSplitN (decode rows): both
// take the same 64 rows, each half of the columns; else (prompt rows)
// each takes 64 of 128 rows over all BN columns.
template <int BN, bool kSplitN, bool kInt4>
struct QCfg {
  static constexpr int kBN = BN;
  static constexpr bool kColsSplit = kSplitN;
  static constexpr bool kI4 = kInt4;
  static constexpr int kBM = kSplitN ? 64 : 128;
  static constexpr int kWN = kSplitN ? BN / 2 : BN;  // columns a consumer
  static constexpr int kThreads = 384;  // the producer and two consumers
  static constexpr int kConsThreads = 256;
  static constexpr uint32_t kXBytes = kBM * 128;  // BM rows x 64 bf16
  // int4: the two x boxes of BM rows x 32 (the k values of the low and
  // of the high nibbles), this far apart
  static constexpr uint32_t kXHalf = kBM * 64;
  static constexpr int kWRows = kInt4 ? kBK / 2 : kBK;  // weight rows a step
  static constexpr uint32_t kW8Bytes = kWRows * BN;  // int8 or packed
  static constexpr uint32_t kWBlock = kBK * 128;  // 64 columns, bf16
  static constexpr uint32_t kWBytes = (BN / 64) * kWBlock;
  static constexpr int kBufs = 2;  // widened buffers: in use, next
  // the copy ring: as deep as shared memory allows beside them (K4 at
  // prompt rows: 4, measured; K5's packed box is half of K4's)
  static constexpr int kStages8 =
      kInt4 ? (kSplitN ? 8 : 5) : (kSplitN ? 6 : 4);
  static constexpr uint32_t x = 0;
  static constexpr uint32_t w8 = x + kStages8 * kXBytes;
  static constexpr uint32_t w = w8 + kStages8 * kW8Bytes;
  static constexpr uint32_t bar = w + kBufs * kWBytes;
  static constexpr uint32_t bytes = bar + 128 + 1024;
  static_assert(bytes <= 232448, "shared memory of a block");
};

// barriers: a copy stage's full and empty
__device__ __forceinline__ uint32_t q_full8(uint32_t bar, int s) {
  return bar + 8 * s;
}
__device__ __forceinline__ uint32_t q_empty8(uint32_t bar, int s) {
  return bar + 64 + 8 * s;
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// the unit's (row tile, column tile, k split)
struct Unit {
  int m, n, z;
};
__device__ __forceinline__ Unit unit_of(int u, int m_tiles, int splits) {
  return {u % m_tiles, u / m_tiles / splits, u / m_tiles % splits};
}

// a step's weight box -> the bf16 k x BN tile, by the consumers' threads
template <class Q>
__device__ __forceinline__ void widen(unsigned char* dst,
                                      const unsigned char* src, int ctid) {
  if constexpr (Q::kI4)
    widen_tile_i4<Q::kWRows, Q::kBN, Q::kConsThreads>(dst, src, ctid);
  else
    widen_tile<kBK, Q::kBN, Q::kConsThreads, 0>(dst, src, ctid);
}

template <class Q, typename OutT>
__global__ void __launch_bounds__(Q::kThreads, 1)
dequant_mm_kernel(const __grid_constant__ CUtensorMap xmap,  // bf16 [R, in]
                  // int8 [in, out], or packed int4 [in/2, out]
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ scale,  // [out]
                  OutT* __restrict__ out,           // [R, out]
                  float* __restrict__ partial,  // [splits, R, out] or null
                  int R, int out_dim, int m_tiles, int units, int splits,
                  int steps,  // k steps a split
                  int half) {  // int4: in / 2, the high nibbles' x column
  constexpr int BN = Q::kBN;
  constexpr int WN = Q::kWN;
  constexpr int kCT = Q::kConsThreads;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem + (base - raw);
  const uint32_t bar = base + Q::bar;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Q::kStages8; ++s) {
      mbar_init(q_full8(bar, s), 1);
      mbar_init(q_empty8(bar, s), 8);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {  // the copies
      tma_prefetch(&xmap);
      tma_prefetch(&wmap);
      int s = 0;
      uint32_t ph = 1;  // the first round of empty barriers passes
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_of(u, m_tiles, splits);
        for (int i = 0; i < steps; ++i) {
          // the step's first weight row (int4: packed row, also the low
          // nibbles' first x column)
          const int k = (t.z * steps + i) * Q::kWRows;
          const uint32_t xs = base + Q::x + s * Q::kXBytes;
          mbar_wait(q_empty8(bar, s), ph);
          mbar_expect_tx(q_full8(bar, s), Q::kXBytes + Q::kW8Bytes);
          tma_load_2d(xs, &xmap, q_full8(bar, s), k, t.m * Q::kBM);
          if constexpr (Q::kI4)
            tma_load_2d(xs + Q::kXHalf, &xmap, q_full8(bar, s), half + k,
                        t.m * Q::kBM);
          tma_load_2d(base + Q::w8 + s * Q::kW8Bytes, &wmap, q_full8(bar, s),
                      t.n * BN, k);
          if (++s == Q::kStages8) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers.  Per step: issue its products on one bf16 buffer; once
  // every consumer's products of the step before are done (wait for all
  // but the newest group, named barrier), widen the next step's weight box
  // (of this unit or the next) into the other buffer under the products in
  // flight; a second barrier publishes it.  The tensor cores get the next
  // step's products while this step's still run.
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int ctid = threadIdx.x - 128;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // this consumer's rows and columns of a tile (int4: in each x box)
  const uint32_t x_off =
      Q::kColsSplit ? 0 : c * 64 * (Q::kI4 ? 64 : 128);
  const uint32_t w_off = Q::kColsSplit ? c * (WN / 64) * Q::kWBlock : 0;
  const int row_off = Q::kColsSplit ? 0 : c * 64;
  const int col_off = Q::kColsSplit ? c * WN : 0;
  float acc[WN / 2];
  int s = 0, wb = 0, ps = 0;  // this step's stage and buffer; the last one
  uint32_t ph8 = 0;
  if (blockIdx.x < units) {  // the CTA's first step
    mbar_wait(q_full8(bar, 0), 0);
    widen<Q>(gbase + Q::w, gbase + Q::w8, ctid);
    fence_async_smem();
  }
  bar_sync(1, kCT);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_of(u, m_tiles, splits);
    const bool last_unit = u + gridDim.x >= units;
    for (int i = 0; i < steps; ++i) {
      const uint32_t xa = base + Q::x + s * Q::kXBytes + x_off;
      const uint32_t wa = base + Q::w + wb * Q::kWBytes + w_off;
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // int4: k-steps 0-1 in the low nibbles' x box, 2-3 in the high
        const uint64_t a =
            Q::kI4 ? desc_kmajor64(xa + (kk >> 1) * Q::kXHalf + (kk & 1) * 32)
                   : desc_kmajor(xa + kk * 32);
        mma_ss<1>(acc, a, desc_mnmajor(wa + kk * 2048, Q::kWBlock),
                  i > 0 || kk > 0);
      }
      wg_commit();
      if (i > 0) {
        wg_wait_one();  // the step before is done: free its x and W8
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty8(bar, ps));
      }
      bar_sync(1, kCT);  // no product reads the other buffer
      const int s_next = s + 1 == Q::kStages8 ? 0 : s + 1;
      const uint32_t ph_next = s_next == 0 ? ph8 ^ 1 : ph8;
      if (i + 1 < steps || !last_unit) {
        mbar_wait(q_full8(bar, s_next), ph_next);
        widen<Q>(gbase + Q::w + (wb ^ 1) * Q::kWBytes,
                 gbase + Q::w8 + s_next * Q::kW8Bytes, ctid);
        fence_async_smem();
      }
      bar_sync(1, kCT);  // the next buffer is written
      ps = s;
      s = s_next;
      ph8 = ph_next;
      wb ^= 1;
    }
    wg_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty8(bar, ps));
    // the epilogue: element i of a thread is row 16 warp + lane / 4 + 8
    // ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane & 3) + (i & 1): the
    // scaled, cast output, or (with a k split) the unit's fp32 partial
    const int r0 = t.m * Q::kBM + row_off + 16 * warp + (lane >> 2);
    const int col0 = t.n * BN + col_off + 2 * (lane & 3);
    float* part = partial + (size_t)t.z * R * out_dim;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= out_dim) break;
      const float2 sc = *reinterpret_cast<const float2*>(scale + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        if (r >= R) continue;
        const float a = acc[4 * j + 2 * half];
        const float b = acc[4 * j + 2 * half + 1];
        const size_t o = (size_t)r * out_dim + col;
        if (partial != nullptr)
          store2<float>(part + o, a, b);
        else
          store2<OutT>(out + o, a * sc.x, b * sc.y);
      }
    }
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
    const float v = s * scale[i % out_dim];
    if constexpr (sizeof(OutT) == 4)
      out[i] = v;
    else
      out[i] = __float2bfloat16_rn(v);
  }
}

template <class Q, typename OutT>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   void* out, void* partial, int R, int in_dim, int out_dim,
                   int splits, int grid, cudaStream_t stream) {
  static PerDevice configured;  // once per instantiation and device
  // x: bf16 boxes of BM rows x 64 (128-byte swizzle), int4: x 32 (64-byte
  // swizzle); w: boxes of 64 int8 rows, or 32 packed rows, x BN columns,
  // dense
  const int w_rows = Q::kI4 ? in_dim / 2 : in_dim;
  CUtensorMap xm, wm;
  if (!cached_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  Q::kI4 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_128B,
                  x, R, in_dim, 2, Q::kBM, Q::kI4 ? 32 : 64) ||
      !cached_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                  CU_TENSOR_MAP_SWIZZLE_NONE, w, w_rows, out_dim, 1,
                  Q::kWRows, Q::kBN))
    return cudaErrorInvalidValue;
  const int m_tiles = (R + Q::kBM - 1) / Q::kBM;
  const int units = m_tiles * ((out_dim + Q::kBN - 1) / Q::kBN) * splits;
  cudaError_t err = launch_sm90<Q, Q::kThreads>(
      dequant_mm_kernel<Q, OutT>, configured,
      dim3(grid < units ? grid : units), stream, xm, wm,
      static_cast<const float*>(scale), static_cast<OutT*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, R, out_dim,
      m_tiles, units, splits, in_dim / kBK / splits, in_dim / 2);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)R * out_dim;
  const size_t want = (n + 255) / 256;
  reduce_kernel<OutT><<<(int)(want < 2048 ? want : 2048), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<OutT*>(out), n, out_dim, splits);
  return cudaGetLastError();
}

template <bool kInt4, typename OutT>
cudaError_t launch_config(int config, const void* x, const void* w,
                          const void* scale, void* out, void* partial, int R,
                          int in_dim, int out_dim, int splits, int grid,
                          cudaStream_t s) {
  switch (config) {
    case 0:
      return launch<QCfg<256, true, kInt4>, OutT>(
          x, w, scale, out, partial, R, in_dim, out_dim, splits, grid, s);
    case 1:
      return launch<QCfg<128, false, kInt4>, OutT>(
          x, w, scale, out, partial, R, in_dim, out_dim, splits, grid, s);
    case 2:
      return launch<QCfg<256, false, kInt4>, OutT>(
          x, w, scale, out, partial, R, in_dim, out_dim, splits, grid, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kInt4>
cudaError_t launch_bits(int config, const void* x, const void* w,
                        const void* scale, void* out, void* partial, int R,
                        int in_dim, int out_dim, int splits, int grid,
                        int out_f32, cudaStream_t s) {
  if (out_f32)
    return launch_config<kInt4, float>(config, x, w, scale, out, partial, R,
                                       in_dim, out_dim, splits, grid, s);
  return launch_config<kInt4, bf16>(config, x, w, scale, out, partial, R,
                                    in_dim, out_dim, splits, grid, s);
}

}  // namespace

// x bf16 [R, in_dim] on 16 bytes; w (on 16 bytes) int8 [in_dim, out_dim]
// (bits 8) or half-split packed int4 uint8 [in_dim / 2, out_dim] (bits
// 4); scale f32 [out_dim]; out bf16 (out_f32 == 0) or f32 [R, out_dim];
// partial f32 [splits, R, out_dim] when splits > 1.  config: 0 = 64 x 256
// tiles (decode rows: the consumers split the columns), 1 = 128 x 128,
// 2 = 128 x 256; grid: CTAs (at most one a unit).  in_dim % 64 == 0,
// out_dim % 64 == 0, and splits divides in_dim / 64 (the wrapper checks
// all three).
extern "C" int vgt_dequant_matmul(const void* x, const void* w,
                                  const void* scale, void* out,
                                  void* partial, int R, int in_dim,
                                  int out_dim, int bits, int config,
                                  int splits, int grid, int out_f32,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0) return cudaSuccess;
  if (in_dim % kBK || out_dim % 64 || splits < 1 ||
      (in_dim / kBK) % splits || grid < 1 ||
      (splits > 1 && partial == nullptr) || (bits != 4 && bits != 8))
    return cudaErrorInvalidValue;
  if (bits == 4)
    return launch_bits<true>(config, x, w, scale, out, partial, R, in_dim,
                             out_dim, splits, grid, out_f32, s);
  return launch_bits<false>(config, x, w, scale, out, partial, R, in_dim,
                            out_dim, splits, grid, out_f32, s);
}
