// Paged decode attention for Hopper (sm_90a), bf16 or f32 pools, and int8
// pools with bf16 scales (kv_cache.dtype: int8).
//
// Replaces two TPU kernels of vgate_tpu/ops/pallas/paged_attention.py:
//  * K1, paged_decode_attention_pallas (body _kernel), in its plain and its
//    int8 mode: one CTA per (slot, kv head) (vgt_paged_decode,
//    vgt_paged_decode_int8);
//  * K6, paged_decode_attention_pallas_blocked (body _blocked_kernel):
//    block_slots slots per CTA, grid B/block_slots x KV
//    (vgt_paged_decode_blocked, bf16/f32 pools).
// Both compute one function: one query token per slot attends the slot's
// live KV pages through its page-table row, with an online softmax; GQA,
// sliding window, logit softcap and a query scale.  They are one kernel
// body with a runtime slots-per-CTA count (K1 is block_slots 1).
// Semantic spec: vgate_tpu_torch/ops/attention.py paged_decode_attention
// (int8 pools dequantized by ops/kv_quant.py gather_pages).
//
// What bounds it on an H100: bytes.  A decode step reads every live K and
// V token once (sum(seq_len) * KV * hd * 2 tensors * 2 bytes per layer in
// bf16) and does ~4 flops per byte, far below the ~295 flop/byte ridge, so
// the limit is the 3.35 TB/s of HBM.
//
// What the design does about it:
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
//  * K6 (block_slots > 1): the CTA's 8 warps are shared among its slots.
//    With n = min(block_slots, 8) slot groups of 8/n warps each, a group
//    serves one slot at a time (more than 8 slots: each group walks slots
//    g, g+n, ... in rounds); each slot loops over its own live range only
//    (the TPU kernel's block-wide chunk count and lowest window start are
//    how a static unroll gets per-slot masks, and have no counterpart).
//    Fewer CTAs than K1 (B/block_slots x KV): at 32 slots, 8 kv heads and
//    8 slots a CTA that is 32 CTAs on 132 SMs.
//  * int8 pools (int8 mode): each lane reads its 8 int8 values of a token
//    in one 8-byte load, so a 128-byte hd-128 row is one load per 16 lanes
//    and the bytes per step halve; the token's K and V scales (bf16, one
//    per (kv head, page, slot), read through the same page id) fold in
//    exactly as the TPU kernel folds them: the K scale multiplies the
//    score BEFORE softcap and mask (q . (k_q * s) == (q . k_q) * s), the V
//    scale multiplies the softmax weight after the denominator took the
//    unweighted p (sum p * (v_q * s) == sum (p * s) * v_q).  No
//    dequantized K or V exists anywhere.
// Not yet done (later work): split-K over pages (flash-decoding) for long
// contexts with few slots, TMA/cp.async pipelining.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch on the caller's stream; the kernel allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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

// K6: block_slots slots per CTA (block_slots must divide B), grid
// B/block_slots x KV; bf16 (dtype 0) or f32 (dtype 1) pools
extern "C" int vgt_paged_decode_blocked(const void* q, const void* k_pages,
                                        const void* v_pages,
                                        const void* page_tables,
                                        const void* seq_lens, void* out,
                                        int B, int H, int KV, int P, int ps,
                                        int pps, int hd, int window,
                                        float scale, float softcap,
                                        int block_slots, int dtype,
                                        void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(page_tables),
               static_cast<const int*>(seq_lens), out, B, H, KV, P, ps, pps,
               window, block_slots, scale, softcap,
               static_cast<cudaStream_t>(stream)};
  return dispatch_plain(a, hd, dtype);
}
