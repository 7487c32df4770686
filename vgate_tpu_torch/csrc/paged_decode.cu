// Paged decode attention for Hopper (sm_90a): K1 on bf16 or f32 pools
// and on int8 pools with bf16 scales (kv_cache.dtype: int8), and K6, the
// page-split decode, on bf16 or f32 pools.
//
// Replaces two TPU kernels of vgate_tpu/ops/pallas/paged_attention.py:
//  * K1, paged_decode_attention_pallas (body _kernel), in its plain and its
//    int8 mode: one CTA per (slot, kv head) (vgt_paged_decode,
//    vgt_paged_decode_int8), paged_decode_kernel below;
//  * K6, paged_decode_attention_pallas_blocked (body _blocked_kernel),
//    the same function with block_slots slots a program
//    (vgt_paged_decode_blocked), paged_decode_split_kernel below.
// Both compute one function: one query token per slot attends the slot's
// live KV pages through its page-table row, with an online softmax; GQA,
// sliding window, logit softcap and a query scale.
// Semantic spec: vgate_tpu_torch/ops/attention.py paged_decode_attention
// (int8 pools dequantized by ops/kv_quant.py gather_pages).
//
// What bounds both on an H100: bytes.  A decode step reads every live K
// and V token once (sum(seq_len) * KV * hd * 2 tensors * 2 bytes per layer
// in bf16) and does ~4 flops per byte, far below the ~295 flop/byte
// ridge, so the limit is the 3.35 TB/s of HBM.
//
// K1's design:
//  * one CTA per (slot, kv head); the G = H/KV query heads of the group
//    share every K/V load (GQA reuse), held in registers;
//  * the CTA loops over the LIVE positions only (from the window start to
//    seq_len-1) and reads each page id from the slot's own page-table row,
//    so it never touches a table entry past the live count nor a dead page;
//  * each lane reads its slice of a token in 16-byte loads with
//    neighbouring lanes on neighbouring addresses (one (ps, hd) page tile
//    is contiguous), and every token group keeps kUnroll tokens of K and V
//    in flight;
//  * scores, the running max/denominator and the PV accumulator are fp32;
//    token groups and warps merge their partial softmax states at the end.
//  * int8 pools (int8 mode): each lane reads its 8 int8 values of a token
//    in one 8-byte load, so a 128-byte hd-128 row is one load per 16 lanes
//    and the bytes per step halve; the token's K and V scales (bf16, one
//    per (kv head, page, slot), read through the same page id) fold in
//    exactly as the TPU kernel folds them: the K scale multiplies the
//    score BEFORE softcap and mask (q . (k_q * s) == (q . k_q) * s), the V
//    scale multiplies the softmax weight after the denominator took the
//    unweighted p (sum p * (v_q * s) == sum (p * s) * v_q).  No
//    dequantized K or V exists anywhere.
//  (The body keeps a runtime slots-a-CTA count from when K6 shared it; K1
//  passes 1.)
//
// K6's design, a page-split decode (flash-decoding):
//  * A slot's live range (window start to seq_len) is cut into tiles of T
//    rows of one page (T = ps, or a divisor of it where a page's K and V
//    would not fit a 32 KB stage) and the tiles into chunks of about
//    256 KB of the slot's K and V, whatever block_slots is (shorter chunks
//    at 8 slots a CTA measured slower: each chunk ends in a merge).  A
//    unit of work is (a block of block_slots slots, kv head, chunk c): the
//    CTA walks chunk c of each slot of the block in turn (a slot with
//    fewer chunks is skipped).  Each CTA counts the chunks of every block
//    from seq_lens itself, so only live units exist; the grid is
//    persistent, one CTA an SM (sized on the host from the SMs and the
//    live-range bound, ops/kernels/paged_decode.py split_plan), and walks
//    them blockIdx.x, + gridDim.x, ...: the card is full whatever
//    block_slots is, and a slot's time does not grow with it.
//  * A CTA is a copy warpgroup (one warp copies, three leave after
//    setmaxnreg) and 8 compute warps at up to 224 registers.  The copy
//    warp issues, per tile, one cp.async.bulk of K and one of V (a tile is
//    contiguous inside [KV, P, ps, hd]) into a ring of up to 8 stages
//    (6 of 32 KB at hd 256, bf16, ps 32) with full and empty mbarriers,
//    and per slot one of its G query rows (contiguous in [B, H, hd]) into
//    one of four query buffers; its copies run on across slots and units,
//    so no compute warp waits on a global load.  It reads page-table
//    entries only below the live count, 32 at a time by its lanes.
//  * Compute: the 8 warps split each tile's rows on the CUDA cores (fp32
//    FMAs; at G <= 8 query rows a wgmma m64 tile would be mostly empty,
//    and the work is ~2-4 flops a byte).  A lane holds EPL values of a
//    token's row for each of the G heads (the state is instantiated for
//    G in {1, 2, 4, 8}: q and acc take 2 G EPL <= 64 registers where hd
//    allows), LPT = hd / EPL lanes a token, interleaved 16-byte pieces so
//    a load phase reads 8 distinct pieces of a row.  The online softmax
//    runs in base 2 (log2 e folded after the softcap) and updates once
//    for each pair of tokens a lane group takes; acc is rescaled only
//    when some lane's max moved.  Rows before the window start or at or
//    past seq_len are never read (the copy brings them; stale rows may
//    hold anything).
//  * Merge: the warps merge their states through shared memory in a fixed
//    order.  A slot whose live range is one chunk writes its output
//    directly; otherwise each unit writes (m, l, acc[hd]) per query head
//    in fp32 to a workspace and a second launch (merge_kernel) merges a
//    slot's chunks in chunk order, so the result is the same from run to
//    run.  The workspace is the wrapper's cached scratch.
//  * K1's invariants hold: no table entry at or past the live count;
//    seq_len clamped to pps * ps on the device; a window start mid-page
//    masks the page's earlier rows; -1e30 / max(l, 1e-30), so an idle
//    slot comes out finite; the precise tanhf softcap after the score,
//    before the mask.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launches on the caller's stream; the kernels allocate nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"  // mbarriers and bulk copies

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
constexpr float kNeg = -1e30f;  // masked / initial max, as the reference

// The element types of the pools: 16 bytes hold kVec elements.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int kVec = 8;
  __device__ static void to_float(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

template <>
struct Elem<float> {
  using Raw = uint4;
  static constexpr int kVec = 4;
  __device__ static void to_float(const uint4& raw, float* out) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = f[i];
  }
  __device__ static float from_float(float x) { return x; }
};

// int8 pools: 8 values in an 8-byte load (a pool type only)
template <>
struct Elem<int8_t> {
  using Raw = uint2;
  static constexpr int kVec = 8;
  __device__ static void to_float(const uint2& raw, float* out) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = (float)b[i];
  }
};

// T: query/output type.  KT: pool type (T, or int8_t with scale pools).
// HD: head dim.  GMAX: compile-time bound on G (query heads per kv head).
// block_slots: slots served by one CTA (1 for K1); blockIdx.x is the block
// of slots, blockIdx.y the kv head.
template <typename T, typename KT, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,            // [B, H, HD]
                    const KT* __restrict__ k_pages,     // [KV, P, ps, HD]
                    const KT* __restrict__ v_pages,
                    const __nv_bfloat16* __restrict__ k_scale,  // [KV, P, ps]
                    const __nv_bfloat16* __restrict__ v_scale,  // int8 only
                    const int* __restrict__ page_tables,  // [B, pps]
                    const int* __restrict__ seq_lens,     // [B]
                    T* __restrict__ out,                // [B, H, HD]
                    int H, int KV, int P, int ps, int pps, int G,
                    int window, float scale, float softcap,
                    int block_slots) {
  using E = Elem<T>;
  using KE = Elem<KT>;
  using Raw = typename KE::Raw;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int VEC = KE::kVec;      // pool elements per load
  // elements per lane: one load, or more when a token is wider than 32
  // such loads (f32 at hd 256)
  constexpr int EPL = HD / 32 > VEC ? HD / 32 : VEC;
  constexpr int NV = EPL / VEC;      // pool loads per lane per token
  constexpr int NQ = EPL / E::kVec;  // 16-byte query loads per lane
  static_assert(EPL % E::kVec == 0, "query and pool slices must agree");
  constexpr int LPT = HD / EPL;      // lanes per token
  constexpr int TPW = 32 / LPT;      // tokens per warp per step
  static_assert(LPT >= 1 && LPT <= 32 && (32 % LPT) == 0, "bad HD");

  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tg = lane / LPT;         // token group within the warp
  const int li = lane % LPT;         // this lane's slice of the head dim
  // the CTA's warps in slot groups: n_groups groups of wps warps; a warp
  // past n_groups * wps (block_slots 3, 5, 6, 7) only joins the barriers
  const int n_groups = min(block_slots, kWarps);
  const int wps = kWarps / n_groups;
  const int grp = warp / wps;
  const int wi = warp % wps;         // this warp's place in its group
  const int stride = wps * TPW;      // tokens a group covers per step

  extern __shared__ float smem[];
  float* sm_m = smem;                        // [kWarps][GMAX]
  float* sm_l = sm_m + kWarps * GMAX;        // [kWarps][GMAX]
  float* sm_acc = sm_l + kWarps * GMAX;      // [kWarps][GMAX][HD]

  // rounds of slots: every thread runs the same count (barriers below)
  for (int r = 0; r < block_slots; r += n_groups) {
    const int j = r + grp;
    // uniform across each warp, so the shuffles below see whole warps
    const bool mine = grp < n_groups && j < block_slots;
    const int b = blockIdx.x * block_slots + j;
    if (mine) {
      // never read past the slot's page-table row, whatever seq_lens says
      const int seq_len = min(seq_lens[b], pps * ps);
      const int lo = window > 0 ? max(seq_len - window, 0) : 0;
      const int* pt_row = page_tables + (size_t)b * pps;

      float qr[GMAX][EPL];
#pragma unroll
      for (int h = 0; h < GMAX; ++h) {
        if (h < G) {
          const T* qp =
              q + ((size_t)b * H + (size_t)g * G + h) * HD + li * EPL;
#pragma unroll
          for (int n = 0; n < NQ; ++n)
            E::to_float(*reinterpret_cast<const uint4*>(qp + n * E::kVec),
                        qr[h] + n * E::kVec);
#pragma unroll
          for (int e = 0; e < EPL; ++e) qr[h][e] *= scale;
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) qr[h][e] = 0.f;
        }
      }

      float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
      for (int h = 0; h < GMAX; ++h) {
        m[h] = kNeg;
        l[h] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h][e] = 0.f;
      }

      const size_t head_base = (size_t)g * P;
      // the loop bound is warp-uniform (base0 is the warp's first token),
      // so every lane of the warp reaches the shuffles below together
      for (int base0 = lo + wi * TPW; base0 < seq_len;
           base0 += stride * kUnroll) {
        Raw kr[kUnroll][NV], vr[kUnroll][NV];
        float ksc[kUnroll], vsc[kUnroll];  // the tokens' scales (int8 mode)
        bool valid[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int pos = base0 + tg + u * stride;
          valid[u] = pos < seq_len;
          ksc[u] = 0.f;
          vsc[u] = 0.f;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            kr[u][n] = Raw{};
            vr[u][n] = Raw{};
          }
          if (valid[u]) {
            const int page = pt_row[pos / ps];
            const size_t row = (head_base + page) * ps + (pos % ps);
            const size_t off = row * HD + li * EPL;
#pragma unroll
            for (int n = 0; n < NV; ++n) {
              kr[u][n] = *reinterpret_cast<const Raw*>(k_pages + off + n * VEC);
              vr[u][n] = *reinterpret_cast<const Raw*>(v_pages + off + n * VEC);
            }
            if (kQuant) {
              ksc[u] = __bfloat162float(k_scale[row]);
              vsc[u] = __bfloat162float(v_scale[row]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float kf[EPL], vf[EPL];
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            KE::to_float(kr[u][n], kf + n * VEC);
            KE::to_float(vr[u][n], vf + n * VEC);
          }
#pragma unroll
          for (int h = 0; h < GMAX; ++h) {
            if (h >= G) continue;  // uniform across the warp
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) s = fmaf(qr[h][e], kf[e], s);
            // all 32 lanes take part; offsets < LPT stay inside the group
#pragma unroll
            for (int o = LPT / 2; o > 0; o >>= 1)
              s += __shfl_xor_sync(0xffffffffu, s, o);
            if (!valid[u]) continue;
            if (kQuant) s *= ksc[u];  // K scale: before softcap and mask
            if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
            const float m_new = fmaxf(m[h], s);
            const float alpha = expf(m[h] - m_new);
            const float p = expf(s - m_new);
            l[h] = l[h] * alpha + p;  // the unweighted p
            const float pv = kQuant ? p * vsc[u] : p;  // V scale: into p
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[h][e] = fmaf(pv, vf[e], acc[h][e] * alpha);
            m[h] = m_new;
          }
        }
      }

      // merge the token groups of a warp (lanes li, li+LPT, ...)
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1) {
#pragma unroll
        for (int h = 0; h < GMAX; ++h) {
          const float m_o = __shfl_xor_sync(0xffffffffu, m[h], o);
          const float l_o = __shfl_xor_sync(0xffffffffu, l[h], o);
          const float m_new = fmaxf(m[h], m_o);
          const float a = expf(m[h] - m_new);
          const float a_o = expf(m_o - m_new);
          l[h] = l[h] * a + l_o * a_o;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const float acc_o = __shfl_xor_sync(0xffffffffu, acc[h][e], o);
            acc[h][e] = acc[h][e] * a + acc_o * a_o;
          }
          m[h] = m_new;
        }
      }

      // each warp's state into shared memory
      if (tg == 0) {
#pragma unroll
        for (int h = 0; h < GMAX; ++h) {
          if (li == 0) {
            sm_m[warp * GMAX + h] = m[h];
            sm_l[warp * GMAX + h] = l[h];
          }
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            sm_acc[(warp * GMAX + h) * HD + li * EPL + e] = acc[h][e];
        }
      }
    }
    __syncthreads();
    // merge the warps of each slot group
    if (mine) {
      const int w0 = grp * wps;
      for (int idx = wi * 32 + lane; idx < G * HD; idx += wps * 32) {
        const int h = idx / HD;
        const int d = idx % HD;
        float m_all = kNeg;
        for (int w = w0; w < w0 + wps; ++w)
          m_all = fmaxf(m_all, sm_m[w * GMAX + h]);
        float l_all = 0.f, a_all = 0.f;
        for (int w = w0; w < w0 + wps; ++w) {
          const float f = expf(sm_m[w * GMAX + h] - m_all);
          l_all += sm_l[w * GMAX + h] * f;
          a_all += sm_acc[(w * GMAX + h) * HD + d] * f;
        }
        out[((size_t)b * H + (size_t)g * G + h) * HD + d] =
            E::from_float(a_all / fmaxf(l_all, 1e-30f));
      }
    }
    __syncthreads();  // shared memory is reused by the next round
  }
}

// One launch's arguments (pointers from the wrapper's tensors).
struct Args {
  const void *q, *k, *v, *ks, *vs;  // ks/vs: scale pools, int8 mode only
  const int *pt, *sl;
  void* out;
  int B, H, KV, P, ps, pps, window, block_slots;
  float scale, softcap;
  cudaStream_t stream;
};

template <typename T, typename KT, int HD, int GMAX>
cudaError_t launch(const Args& a) {
  const size_t smem = sizeof(float) * kWarps * GMAX * (HD + 2);
  auto kern = paged_decode_kernel<T, KT, HD, GMAX>;
  static bool configured = false;  // once per instantiation
  if (smem > 48 * 1024 && !configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(a.B / a.block_slots, a.KV);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), static_cast<const __nv_bfloat16*>(a.ks),
      static_cast<const __nv_bfloat16*>(a.vs), a.pt, a.sl,
      static_cast<T*>(a.out), a.H, a.KV, a.P, a.ps, a.pps, a.H / a.KV,
      a.window, a.scale, a.softcap, a.block_slots);
  return cudaGetLastError();
}

template <typename T, typename KT, int HD>
cudaError_t launch_hd(const Args& a) {
  const int G = a.H / a.KV;
  if (G <= 4) return launch<T, KT, HD, 4>(a);
  if (G <= 8) return launch<T, KT, HD, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename T, typename KT>
int dispatch(const Args& a, int hd) {
  if (a.B == 0) return cudaSuccess;
  if (a.block_slots < 1 || a.B % a.block_slots) return cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return launch_hd<T, KT, 64>(a);
    case 128:
      return launch_hd<T, KT, 128>(a);
    case 256:
      return launch_hd<T, KT, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 (dtype 0) or f32 (dtype 1) pools: q, pools and output share it
int dispatch_plain(const Args& a, int hd, int dtype) {
  if (dtype == 0) return dispatch<__nv_bfloat16, __nv_bfloat16>(a, hd);
  if (dtype == 1) return dispatch<float, float>(a, hd);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ K6

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

// What the kernels know of the launch.
struct Geo {
  int B, H, KV, P, ps, pps, G, window;
  float scale, softcap;
  int block_slots, tile_rows, stages, chunk_tiles, max_chunks;
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

  // every group's chunk count (the most of its slots'), then their
  // prefix sums: pre[grp] is the group's first chunk unit
  for (int grp = threadIdx.x; grp < n_groups; grp += kThreads) {
    int n = 1;
    for (int j = 0; j < geo.block_slots; ++j)
      n = max(n, slot_of(geo, seq_lens, grp * geo.block_slots + j).chunks);
    pre[grp + 1] = n;
  }
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
  __syncthreads();
  if (warp == 0) {
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
  const int units = pre[n_groups] * geo.KV;

  // unit u -> (group, kv head, chunk): kv heads vary fastest
  auto unit_of = [&](int u, int& grp, int& g, int& c) {
    const int gc = u / geo.KV;
    g = u % geo.KV;
    int lo = 0, hi = n_groups;  // the last group with pre[grp] <= gc
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (pre[mid] <= gc) lo = mid; else hi = mid;
    }
    grp = lo;
    c = gc - pre[lo];
  };

  if (warp < 4) {  // the copy warpgroup
    setmaxnreg_dec<kCopyRegs>();
    if (warp != 0) return;
    int s = 0, qs = 0;
    uint32_t ph = 1, qph = 1;  // the first round of empty barriers passes
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int grp, g, c;
      unit_of(u, grp, g, c);
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
    unit_of(u, grp, g, c);
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

// The slots of more than one chunk: their chunks' (m, l, acc) merged in
// chunk order and normalised.  One CTA a (slot, kv head); the chunks' m
// (base 2) and l are staged in shared memory as the factors
// 2^(m_c - m_all), so the sum over chunks reads only acc from memory.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ ws_ml, const float* __restrict__ ws_acc,
             const int* __restrict__ seq_lens, T* __restrict__ out, int HD,
             const Geo geo) {
  extern __shared__ float merge_smem[];  // [G][max_chunks] factors, [G] 1/l
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const Slot sl = slot_of(geo, seq_lens, b);
  if (sl.chunks == 1) return;  // written by its unit
  const int G = geo.G;
  const size_t base = ((size_t)b * geo.KV + g) * geo.max_chunks;
  float* fac = merge_smem;
  float* inv_l = merge_smem + G * geo.max_chunks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int h = warp; h < G; h += kMergeThreads / 32) {
    float m_all = kNeg;
    for (int c = lane; c < sl.chunks; c += 32)
      m_all = fmaxf(m_all, ws_ml[((base + c) * G + h) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, o));
    for (int c = lane; c < sl.chunks; c += 32)
      fac[h * geo.max_chunks + c] =
          vgt_sm90::ex2(ws_ml[((base + c) * G + h) * 2] - m_all);
    __syncwarp();
    if (lane == 0) {  // in chunk order
      float l_all = 0.f;
      for (int c = 0; c < sl.chunks; ++c)
        l_all += ws_ml[((base + c) * G + h) * 2 + 1] *
                 fac[h * geo.max_chunks + c];
      inv_l[h] = 1.f / fmaxf(l_all, 1e-30f);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kMergeThreads) {
    const int h = idx / HD;
    const int d = idx % HD;
    const float* f = fac + h * geo.max_chunks;
    float a_all = 0.f;
#pragma unroll 4
    for (int c = 0; c < sl.chunks; ++c)
      a_all += ws_acc[((base + c) * G + h) * HD + d] * f[c];
    out[((size_t)b * geo.H + g * G + h) * HD + d] =
        from_float<T>(a_all * inv_l[h]);
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
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured = true;
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
  const size_t merge_smem = sizeof(float) * geo.G * (geo.max_chunks + 1);
  if (merge_smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static bool merge_configured = false;
  if (!merge_configured) {
    cudaError_t e = cudaFuncSetAttribute(
        merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    merge_configured = true;
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

}  // namespace split

}  // namespace

// K1: one CTA per (slot, kv head).  dtype: 0 = bf16, 1 = f32
extern "C" int vgt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* page_tables,
                                const void* seq_lens, void* out, int B, int H,
                                int KV, int P, int ps, int pps, int hd,
                                int window, float scale, float softcap,
                                int dtype, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(page_tables),
               static_cast<const int*>(seq_lens), out, B, H, KV, P, ps, pps,
               window, 1, scale, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch_plain(a, hd, dtype);
}

// K1's int8 mode: int8 pools [KV, P, ps, hd] with bf16 scale pools
// [KV, P, ps]; q and the output bf16
extern "C" int vgt_paged_decode_int8(const void* q, const void* k_pages,
                                     const void* v_pages, const void* k_scale,
                                     const void* v_scale,
                                     const void* page_tables,
                                     const void* seq_lens, void* out, int B,
                                     int H, int KV, int P, int ps, int pps,
                                     int hd, int window, float scale,
                                     float softcap, void* stream) {
  const Args a{q, k_pages, v_pages, k_scale, v_scale,
               static_cast<const int*>(page_tables),
               static_cast<const int*>(seq_lens), out, B, H, KV, P, ps, pps,
               window, 1, scale, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<__nv_bfloat16, int8_t>(a, hd);
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
