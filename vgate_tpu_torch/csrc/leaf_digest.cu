// The weight-checksum reduction of the integrity sweep (integrity.py
// leaf_digest), for sm_90a.
//
// digest(x) = sum_i bits(x)[i] * (i % 65521 + 1), in wrapping uint32,
// where bits() reinterprets each element as the unsigned integer of its
// width (1, 2 or 4 bytes).  The reference fuses the same formula into
// one XLA reduction so that a multi-GB leaf is verified without a
// full-size temporary; here one grid-stride kernel reads the leaf once
// in 16-byte vectors, keeps each thread's sum in an unsigned int (which
// wraps, as the reference's uint32 does), reduces a block in shared
// memory and adds the block's sum to the result word with a wrapping
// atomicAdd.  Wrapping addition is associative and commutative, so the
// result does not depend on the order the blocks finish in.  The only
// memory besides the leaf is the result word.
//
// The positional weight is computed once per thread from the 64-bit
// element index and then advanced by the grid stride with a conditional
// subtraction, so the loop does no 64-bit division.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned int kMod = 65521u;  // largest prime below 2^16
constexpr int kThreads = 256;

template <typename U>
__device__ __forceinline__ unsigned int weighted(U bits, unsigned int w) {
  // w = i % kMod; the weight is w + 1
  return static_cast<unsigned int>(bits) * (w + 1u);
}

// x: the leaf's first element; n elements in all.  The leaf is split
// into a head of `head` elements (up to the first 16-byte boundary), `nv`
// vectors of V elements, and a tail; head and tail are summed by the
// grid's first threads.
template <typename U>
__global__ void __launch_bounds__(kThreads)
digest_kernel(const U* __restrict__ x, unsigned long long n,
              unsigned long long head, unsigned long long nv,
              unsigned int* __restrict__ out) {
  constexpr int V = 16 / sizeof(U);
  const unsigned long long gid =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  unsigned int acc = 0;

  // head and tail, at most 2 * (V - 1) elements
  const unsigned long long tail0 = head + nv * V;
  const unsigned long long edge = head + (n - tail0);
  if (gid < edge) {
    const unsigned long long i = gid < head ? gid : tail0 + (gid - head);
    acc += weighted(x[i], static_cast<unsigned int>(i % kMod));
  }

  // the vectors: element index of vector k is head + k * V
  const uint4* vec = reinterpret_cast<const uint4*>(x + head);
  if (gid < nv) {
    unsigned int w = static_cast<unsigned int>((head + gid * V) % kMod);
    const unsigned int step = static_cast<unsigned int>((stride * V) % kMod);
    for (unsigned long long k = gid; k < nv; k += stride) {
      const uint4 raw = __ldg(vec + k);
      const U* e = reinterpret_cast<const U*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        unsigned int wj = w + j;
        wj = wj >= kMod ? wj - kMod : wj;
        acc += weighted(e[j], wj);
      }
      w += step;
      w = w >= kMod ? w - kMod : w;
    }
  }

  // block reduction: warps by shuffle, then the first warp
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ unsigned int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) atomicAdd(out, acc);
  }
}

template <typename U>
cudaError_t launch(const void* x, unsigned long long n, unsigned int* out,
                   int sms, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(U);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  unsigned long long head = ((16u - (addr & 15u)) & 15u) / sizeof(U);
  if (head > n) head = n;
  const unsigned long long nv = (n - head) / V;
  const unsigned long long edge = head + (n - head - nv * V);
  // enough blocks to fill every SM at full occupancy, no more than the
  // vectors (or the edge elements) need
  unsigned long long want = (nv > edge ? nv : edge);
  want = (want + kThreads - 1) / kThreads;
  const unsigned long long cap = static_cast<unsigned long long>(sms) * 8;
  const unsigned int blocks =
      static_cast<unsigned int>(want < cap ? (want ? want : 1) : cap);
  digest_kernel<U><<<blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(x), n, head, nv, out);
  return cudaGetLastError();
}

}  // namespace

// The digest of n elements of elem_bytes (1, 2 or 4) each at x, into the
// device word *out (zeroed here on the same stream).  Returns a CUDA
// error code (0 on success).
extern "C" int vgt_leaf_digest(const void* x, unsigned long long n,
                               int elem_bytes, void* out, int sms,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* o = static_cast<unsigned int*>(out);
  cudaError_t err = cudaMemsetAsync(o, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  switch (elem_bytes) {
    case 1:
      return launch<uint8_t>(x, n, o, sms, s);
    case 2:
      return launch<uint16_t>(x, n, o, sms, s);
    case 4:
      return launch<uint32_t>(x, n, o, sms, s);
    default:
      return cudaErrorInvalidValue;
  }
}
