// Paged decode attention for Hopper (sm_90a), bf16 or f32 pools, and int8
// pools with bf16 scales (kv_cache.dtype: int8).
//
// Replaces the TPU kernel vgate_tpu/ops/pallas/paged_attention.py
// paged_decode_attention_pallas (body _kernel), in its plain and its int8
// mode: one query token per slot attends the slot's live KV pages through
// its page-table row, with an online softmax; GQA, sliding window, logit
// softcap and a query scale.
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
                    int window, float scale, float softcap) {
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
  constexpr int STRIDE = kWarps * TPW;
  static_assert(LPT >= 1 && LPT <= 32 && (32 % LPT) == 0, "bad HD");

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tg = lane / LPT;         // token group within the warp
  const int li = lane % LPT;         // this lane's slice of the head dim

  // never read past the slot's page-table row, whatever seq_lens says
  const int seq_len = min(seq_lens[b], pps * ps);
  const int lo = window > 0 ? max(seq_len - window, 0) : 0;
  const int* pt_row = page_tables + (size_t)b * pps;

  float qr[GMAX][EPL];
#pragma unroll
  for (int h = 0; h < GMAX; ++h) {
    if (h < G) {
      const T* qp = q + ((size_t)b * H + (size_t)g * G + h) * HD + li * EPL;
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
  // the loop bound is warp-uniform (base0 is the warp's first token), so
  // every lane of the warp reaches the shuffles below together
  for (int base0 = lo + warp * TPW; base0 < seq_len;
       base0 += STRIDE * kUnroll) {
    Raw kr[kUnroll][NV], vr[kUnroll][NV];
    float ksc[kUnroll], vsc[kUnroll];  // the tokens' scales (int8 mode)
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base0 + tg + u * STRIDE;
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

  // merge the warps through shared memory
  extern __shared__ float smem[];
  float* sm_m = smem;                        // [kWarps][GMAX]
  float* sm_l = sm_m + kWarps * GMAX;        // [kWarps][GMAX]
  float* sm_acc = sm_l + kWarps * GMAX;      // [kWarps][GMAX][HD]
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
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int h = idx / HD;
    const int d = idx % HD;
    float m_all = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w * GMAX + h]);
    float l_all = 0.f, a_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w * GMAX + h] - m_all);
      l_all += sm_l[w * GMAX + h] * f;
      a_all += sm_acc[(w * GMAX + h) * HD + d] * f;
    }
    out[((size_t)b * H + (size_t)g * G + h) * HD + d] =
        E::from_float(a_all / fmaxf(l_all, 1e-30f));
  }
}

template <typename T, typename KT, int HD, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const int* pt,
                   const int* sl, void* out, int B, int H, int KV, int P,
                   int ps, int pps, int window, float scale, float softcap,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * GMAX * (HD + 2);
  auto kern = paged_decode_kernel<T, KT, HD, GMAX>;
  static bool configured = false;  // once per instantiation
  if (smem > 48 * 1024 && !configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(B, KV);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), pt, sl, static_cast<T*>(out),
      H, KV, P, ps, pps, H / KV, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T, typename KT, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const int* pt,
                      const int* sl, void* out, int B, int H, int KV, int P,
                      int ps, int pps, int window, float scale,
                      float softcap, cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 4)
    return launch<T, KT, HD, 4>(q, k, v, ks, vs, pt, sl, out, B, H, KV, P,
                                ps, pps, window, scale, softcap, stream);
  if (G <= 8)
    return launch<T, KT, HD, 8>(q, k, v, ks, vs, pt, sl, out, B, H, KV, P,
                                ps, pps, window, scale, softcap, stream);
  return cudaErrorInvalidValue;
}

template <typename T, typename KT>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scale, const void* v_scale,
             const void* page_tables, const void* seq_lens, void* out, int B,
             int H, int KV, int P, int ps, int pps, int hd, int window,
             float scale, float softcap, void* stream) {
  const int* pt = static_cast<const int*>(page_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  switch (hd) {
    case 64:
      return launch_hd<T, KT, 64>(q, k_pages, v_pages, k_scale, v_scale, pt,
                                  sl, out, B, H, KV, P, ps, pps, window,
                                  scale, softcap, s);
    case 128:
      return launch_hd<T, KT, 128>(q, k_pages, v_pages, k_scale, v_scale, pt,
                                   sl, out, B, H, KV, P, ps, pps, window,
                                   scale, softcap, s);
    case 256:
      return launch_hd<T, KT, 256>(q, k_pages, v_pages, k_scale, v_scale, pt,
                                   sl, out, B, H, KV, P, ps, pps, window,
                                   scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (q, pools and output share it)
extern "C" int vgt_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* page_tables,
                                const void* seq_lens, void* out, int B, int H,
                                int KV, int P, int ps, int pps, int hd,
                                int window, float scale, float softcap,
                                int dtype, void* stream) {
  if (dtype == 0)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, page_tables, seq_lens, out, B,
        H, KV, P, ps, pps, hd, window, scale, softcap, stream);
  if (dtype == 1)
    return dispatch<float, float>(q, k_pages, v_pages, nullptr, nullptr,
                                  page_tables, seq_lens, out, B, H, KV, P, ps,
                                  pps, hd, window, scale, softcap, stream);
  return cudaErrorInvalidValue;
}

// int8 pools [KV, P, ps, hd] with bf16 scale pools [KV, P, ps]; q and the
// output bf16
extern "C" int vgt_paged_decode_int8(const void* q, const void* k_pages,
                                     const void* v_pages, const void* k_scale,
                                     const void* v_scale,
                                     const void* page_tables,
                                     const void* seq_lens, void* out, int B,
                                     int H, int KV, int P, int ps, int pps,
                                     int hd, int window, float scale,
                                     float softcap, void* stream) {
  return dispatch<__nv_bfloat16, int8_t>(
      q, k_pages, v_pages, k_scale, v_scale, page_tables, seq_lens, out, B,
      H, KV, P, ps, pps, hd, window, scale, softcap, stream);
}
