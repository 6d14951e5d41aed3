// S2: the discrete Gaussian's barrier search, #{barriers <= r} a sample.
//
// Replaces XLA code, not a TPU kernel: nfllib_tpu/prng/device_sampling.py:
// _count_barriers_le and the search inside device_gaussian, a branchless
// binary search over the sorted barrier table whose every halving compares
// wp big-endian words (jnp.sign a word, where-chains between them).  XLA
// fuses it; eager torch would launch about 8 x 19 x 4 ops a call at the
// demo's sampler (sigma 4, 128-bit security: 115 barriers of 19 words).
//
// Each sample reads wp words of in_bits (8 or 16, unsigned) from a row of
// the keystream: row f at words + f * row_stride, starting at
// starts[f, s] (the exact sampler's candidate start positions) or, when
// starts is null, at s * wp (the fixed-consumption sampler's layout).  The
// words form a big-endian integer r; the count is the number of barrier
// rows (the table [nb, wp] of uint16 words, ascending) that are <= r,
// lexicographically.  Output:
//   * p == null: int32 [rows, samples] of base + count;
//   * p != null (rows == 1): the Gaussian polynomial itself, [m, samples]
//     of out_bytes (2, 4 or 8) words, v = (base + count) * amp encoded per
//     channel as p_c + v when v < 0 (nfllib_tpu device_gaussian's output).
//
// Design: one thread a sample; the block first copies the barrier table
// into shared memory when it fits in 48 KB (4.4 KB at the demo's sampler),
// else the search reads it from global memory through the read-only path.
// The search runs at most ceil(log2(nb + 1)) halvings with lo/hi updated
// by selects, and stops when they meet (the JAX search's remaining steps
// change nothing); a compare stops at the first differing word, as the
// reference's cmp walk does.  The 1-D grid covers rows * samples.
//
// Bound on this card: the operations of the search, about 8 halvings x
// (a few words compared + index arithmetic) a sample, against wp bytes
// read and one word a channel written; at the demo's n = 2^14 either is a
// few microseconds, so a launch's fixed cost dominates.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemTable = 48 * 1024;

template <class W>
__global__ void __launch_bounds__(kThreads) barrier_count_kernel(
    const W* __restrict__ words, long long row_stride,
    const int32_t* __restrict__ starts, int samples, long long total, int wp,
    const uint16_t* __restrict__ barriers, int nb, int steps, int base,
    long long amp, const long long* __restrict__ p, int m, int out_bytes,
    void* __restrict__ out, int table_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint16_t* tab = barriers;
  if (table_in_smem) {
    uint16_t* st = reinterpret_cast<uint16_t*>(smem_raw);
    for (int k = threadIdx.x; k < nb * wp; k += kThreads)
      st[k] = __ldg(barriers + k);
    tab = st;
    __syncthreads();
  }
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= total) return;
  const long long row = i / samples;
  const long long s = i - row * samples;
  const long long start = starts != nullptr ? __ldg(starts + i) : s * wp;
  const W* r = words + row * row_stride + start;
  // invariant: barriers[:lo] <= r, barriers[hi:] > r
  int lo = 0, hi = nb;
  for (int step = 0; step < steps && lo < hi; ++step) {
    const int mid = (lo + hi) >> 1;
    const uint16_t* b = tab + static_cast<long long>(mid) * wp;
    int cmp = 0;   // sign of r - barrier[mid] at the first differing word
    for (int j = 0; j < wp && cmp == 0; ++j) {
      const int rj = static_cast<int>(__ldg(r + j));
      const int bj = static_cast<int>(b[j]);
      cmp = (rj > bj) - (rj < bj);
    }
    lo = cmp >= 0 ? mid + 1 : lo;
    hi = cmp < 0 ? mid : hi;
  }
  if (p == nullptr) {
    static_cast<int32_t*>(out)[i] = base + lo;
    return;
  }
  const long long v = static_cast<long long>(base + lo) * amp;
  for (int c = 0; c < m; ++c) {
    const uint64_t w = static_cast<uint64_t>(v < 0 ? __ldg(p + c) + v : v);
    const long long at = static_cast<long long>(c) * samples + s;
    if (out_bytes == 8)
      static_cast<uint64_t*>(out)[at] = w;
    else if (out_bytes == 4)
      static_cast<uint32_t*>(out)[at] = static_cast<uint32_t>(w);
    else
      static_cast<uint16_t*>(out)[at] = static_cast<uint16_t>(w);
  }
}

}  // namespace

// Plain C entry point for ctypes.  words: the keystream, read as uint8
// (in_bits 8) or uint16 (in_bits 16) items, rows of row_stride items;
// starts: [rows, samples] int32 or null; barriers: [nb, wp] uint16; p: [m]
// int64 or null (see above); out: int32 [rows, samples] or [m, samples]
// words of out_bytes.  Returns the cudaError_t of the launch (0 on
// success); an argument the kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int nfl_barrier_count(const void* words, int in_bits,
                                 long long row_stride, const void* starts,
                                 int rows, int samples, int wp,
                                 const void* barriers, int nb, int base,
                                 long long amp, const void* p, int m,
                                 int out_bytes, void* out, void* stream) {
  if ((in_bits != 8 && in_bits != 16) || wp <= 0 || nb <= 0
      || (p != nullptr && (rows != 1 || m <= 0
                           || (out_bytes != 2 && out_bytes != 4
                               && out_bytes != 8))))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(rows) * samples;
  if (total <= 0) return 0;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  int steps = 0;   // max(1, bit length of nb + 1), as the JAX search
  for (unsigned v = static_cast<unsigned>(nb) + 1; v != 0; v >>= 1) ++steps;
  const long long table = 2LL * nb * wp;
  const int in_smem = table <= kSmemTable;
  const size_t smem = in_smem ? static_cast<size_t>(table) : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* bars = static_cast<const uint16_t*>(barriers);
  const auto* pp = static_cast<const long long*>(p);
  const auto* sp = static_cast<const int32_t*>(starts);
  const unsigned g = static_cast<unsigned>(grid);
  if (in_bits == 8)
    barrier_count_kernel<uint8_t><<<g, kThreads, smem, st>>>(
        static_cast<const uint8_t*>(words), row_stride, sp, samples, total,
        wp, bars, nb, steps, base, amp, pp, m, out_bytes, out, in_smem);
  else
    barrier_count_kernel<uint16_t><<<g, kThreads, smem, st>>>(
        static_cast<const uint16_t*>(words), row_stride, sp, samples, total,
        wp, bars, nb, steps, base, amp, pp, m, out_bytes, out, in_smem);
  return static_cast<int>(cudaGetLastError());
}
