// The discrete Gaussian's barrier search and residue encoding, shared by
// the fixed-consumption Gaussian S3 (gaussian_fixed.cu) and the
// stream-exact Gaussian S4 (gaussian_exact.cu).
//
// count_le() is #{barriers <= r}: r is wp words of in_bits (8 or 16,
// unsigned; uint8_t or uint16_t items) forming a big-endian integer, the
// barrier table [nb, wp] of uint16 words is ascending, and a barrier is
// <= r lexicographically.  It is the JAX package's branchless search
// (nfllib_tpu/prng/device_sampling.py:_count_barriers_le): at most
// search_steps(nb) = max(1, bit length of nb + 1) halvings with lo / hi
// updated by selects, stopped when they meet (the JAX search's remaining
// steps change nothing), and a compare that stops at the first differing
// word, as the reference's cmp walk does.  `tab` may point to shared or
// global memory (a generic load either way).
//
// store_residues() writes the sample v to every channel c of an [m, ...]
// output of out_bytes (2, 4 or 8) words as p_c + v when v < 0, else v,
// truncated to the word (the JAX package's astype after the where).
#pragma once

#include <cstdint>

namespace nfl_gauss {

__host__ __device__ __forceinline__ int search_steps(int nb) {
  int steps = 0;
  for (unsigned v = static_cast<unsigned>(nb) + 1; v != 0; v >>= 1) ++steps;
  return steps;
}

template <class W>
__device__ __forceinline__ int count_le(const W* r, const uint16_t* tab,
                                        int nb, int wp, int steps) {
  // invariant: barriers[:lo] <= r, barriers[hi:] > r
  int lo = 0, hi = nb;
  for (int step = 0; step < steps && lo < hi; ++step) {
    const int mid = (lo + hi) >> 1;
    const uint16_t* b = tab + static_cast<long long>(mid) * wp;
    int cmp = 0;   // sign of r - barrier[mid] at the first differing word
    for (int j = 0; j < wp && cmp == 0; ++j) {
      const int rj = static_cast<int>(r[j]);
      const int bj = static_cast<int>(b[j]);
      cmp = (rj > bj) - (rj < bj);
    }
    lo = cmp >= 0 ? mid + 1 : lo;
    hi = cmp < 0 ? mid : hi;
  }
  return lo;
}

__device__ __forceinline__ void store_residues(void* out, int out_bytes,
                                               long long at,
                                               long long channel_stride,
                                               int m,
                                               const long long* p,
                                               long long v) {
  for (int c = 0; c < m; ++c) {
    const uint64_t w = static_cast<uint64_t>(v < 0 ? __ldg(p + c) + v : v);
    const long long i = at + c * channel_stride;
    if (out_bytes == 8)
      static_cast<uint64_t*>(out)[i] = w;
    else if (out_bytes == 4)
      static_cast<uint32_t*>(out)[i] = static_cast<uint32_t>(w);
    else
      static_cast<uint16_t*>(out)[i] = static_cast<uint16_t>(w);
  }
}

// Copies `count` items of T from global memory to `dst` with the block's
// threads (the caller synchronises before reading them).
template <class T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long count) {
  for (long long k = threadIdx.x; k < count; k += blockDim.x)
    dst[k] = __ldg(src + k);
}

}  // namespace nfl_gauss
