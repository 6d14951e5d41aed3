// S5 and S6: the device hwt samplers (h coefficients +-1, the rest 0: the
// sparse ternary secret of RLWE schemes), each a walk or selection kernel
// and a store kernel.
//
// Replaces XLA code, not a TPU kernel: nfllib_tpu/prng/device_sampling.py:
// 471 device_hwt (S5) and :424 device_hwt_exact (S6), each traced into one
// XLA program there.  As eager torch on S1's raw keystream they took 37-39
// (device_hwt) and 257-261 (device_hwt_exact) CUDA activities a call.
//
// S6, stream-exact (the host walk of prng/sampling.py:sample_hwt,
// reference core.hpp:352-391, word for word, with its nonce advance).
// Word i of the reservoir's stream is word i mod h of the stream at nonce
// + i / h (fill f reads the first h * 8 bytes of a fresh stream), over
// nf = max(1, ceil((n - h) / h) + 1) fills.  A word can be rejected only
// if it is ambiguous (w > 2^64 - 1 - n), so once the at most amb_cap
// ambiguous words are resolved in order, in one thread, the counter at
// word i is k = h + i - (rejections before i) with no scan over the words,
// and T, the index just past the (n - h)-th accepted word, follows from
// the rejected indices alone.  Slot p < h keeps the largest k among the
// consumed accepted words with w mod k == p (atomicMax); the hit positions
// are distinct (each k is written once, and k > p), so a bitmap over n
// replaces the JAX package's sort, and the sign index of a hit is its rank
// (a popcount prefix).  The budget guard stays: more than amb_cap
// ambiguous words, or fewer than n - h accepted ones, give all-ones
// residues and the advance -1.
//   * hwt_walk_kernel: one block resolves the words, the reservoir, the
//     bitmap and the advance (fills + 1), when the keystream blocks fit
//     `cap` (the LWE rings at h = 64: 2,048 blocks);
//   * else the same phases as three kernels over many blocks:
//     hwt_words_kernel (keystream, ambiguous words by block, the
//     scratch's initial values), hwt_reservoir_kernel (each block
//     resolves the ambiguous words again, then its words' atomicMax) and
//     hwt_mark_kernel (the bitmap and the hits a segment).
//
// S5, fixed consumption: the n + h little-endian 64-bit words of the
// stream at nonce.  The hits are the h smallest (key, index) pairs of the
// first n words (a stable argsort's first h), found by a radix select on
// the pair: byte digits of the key from the top, then of the index, each
// a histogram and a prefix over its 256 bins, until one pair is left in
// the chosen bucket; then hit(x) = (key, x) <= that pair.  The sign of
// the hit of rank j is bit 1 of word n + j.
//   * hwt_select_kernel<true>: one block, the n keys made in its shared
//     memory (n <= 2^14 on this card: 128 KB);
//   * hwt_select_kernel<false> reads them from global memory, written by
//     hwt_keys_kernel over many blocks.
//
// Both end in hwt_store_kernel<BYTES>: a block a segment of kSeg positions
// and a group of channels takes its hits' rank offset (the hits of the
// segments before it), their ranks within the segment (popcounts), makes
// the keystream blocks of their sign words and stores (p_c - 1 + (sign &
// 2)) at hits and 0 elsewhere, in 16-byte vectors.  The testing hook: both
// samplers take their words from a pointer in place of their keystream
// (the words-in instance); the signs stay the keystream's.
//
// Bound on this card: the bytes at the LWE rings.  The residues written,
// m * n words, are 1.1 MB at u32 (16384, 510); the keystream is 2,056
// Salsa20 blocks (S6: nf * ceil(h / 8) and as many for the signs at n =
// 2^14, h = 64; S5: (n + h) / 8), each 640 rotates and xors on the ALU
// pipe and 336 adds (S1's count), a third of the bytes' time spread over
// every SM.  The one-block instances leave 131 of 132 SMs idle while they
// make their keystream: they are there to keep a call at two launches
// with no host synchronisation.

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "salsa20_block.cuh"

namespace {

using nfl_launch::sm_count;
using nfl_salsa::Key;

constexpr int kSeg = 1024;                // positions a store block
constexpr int kSegWords = kSeg / 32;
constexpr int kMaxLogN = 20;              // the largest degree: 2^20
constexpr int kMaxSeg = (1 << kMaxLogN) / kSeg;
constexpr int kStoreThreads = 256;
constexpr int kChunkThreads = 256;        // the many-block kernels
constexpr int kMaxThreads = 1024;         // the one-block kernels
constexpr int kMaxGroups = 1024;          // hwt_words_kernel's blocks
constexpr int kMaxAmbCap = 64;
constexpr uint64_t kM = ~0ull;            // 2^64 - 1

struct Stream {
  Key key;
  const long long* nonce_dev;             // null, or one int64 on the card
  unsigned long long nonce_add;
};

__device__ __forceinline__ uint64_t word64(const uint32_t x[16], int q) {
  return x[2 * q] | (static_cast<uint64_t>(x[2 * q + 1]) << 32);
}

// w mod k for 0 < k < 2^21: the high half mod k in 32 bits, then the rest,
// below k * 2^32 <= 2^53 and so exact in a double, by a rounded quotient
// (at most one too large) and one correction
__device__ __forceinline__ uint32_t umod_small(uint64_t w, uint32_t k) {
  const uint32_t r1 = static_cast<uint32_t>(w >> 32) % k;
  const uint64_t y = (static_cast<uint64_t>(r1) << 32)
                     | static_cast<uint32_t>(w);
  const long long q = static_cast<long long>(static_cast<double>(y)
                                             / static_cast<double>(k));
  long long r = static_cast<long long>(y) - q * static_cast<long long>(k);
  if (r < 0) r += k;
  if (r >= static_cast<long long>(k)) r -= k;
  return static_cast<uint32_t>(r);
}

// [lo, hi) of `total` units for block v of V, in order
__device__ __forceinline__ void chunk(int total, int v, int V, int& lo,
                                      int& hi) {
  const int per = (total + V - 1) / V;
  lo = v * per < total ? v * per : total;
  hi = lo + per < total ? lo + per : total;
}

// ascending, in one thread (at most kMaxAmbCap entries)
__device__ void sort_ints(int* a, int c) {
  for (int i = 1; i < c; ++i) {
    const int v = a[i];
    int j = i - 1;
    for (; j >= 0 && a[j] > v; --j) a[j + 1] = a[j];
    a[j + 1] = v;
  }
}

// ---------------------------------------------------------------------------
// S6: the stream-exact walk
// ---------------------------------------------------------------------------

struct Walk {
  Stream s;
  const uint64_t* words_in;  // the words-in instance's [wtot], or null
  uint64_t* w;               // [wtot] the reservoir's words
  int n, h, bpf, amb_cap;    // bpf: keystream blocks a fill
  int wtot, units;           // words; keystream blocks
  int groups;                // hwt_words_kernel's blocks: one record each
  int* rec;                  // [groups][1 + kMaxAmbCap]
  int* hit;                  // [h] the reservoir
  uint32_t* bitmap;          // [ceil(n / 32)]
  int* segcount;             // [ceil(n / kSeg)]
  long long* adv;            // the advance: fills + 1, or -1
};

struct WalkShared {
  int count, listed, nrej, ok, T;
  int list[kMaxAmbCap];
  int rej[kMaxAmbCap];
};

// the scratch's initial values: hit[p] = p, bitmap and segcount 0
__device__ void walk_init(const Walk& P, int v, int V) {
  const int nw = (P.n + 31) >> 5, nseg = (P.n + kSeg - 1) / kSeg;
  for (int i = v * blockDim.x + threadIdx.x;
       i < P.h || i < nw || i < nseg; i += V * blockDim.x) {
    if (i < P.h) P.hit[i] = i;
    if (i < nw) P.bitmap[i] = 0;
    if (i < nseg) P.segcount[i] = 0;
  }
}

// the words of block v of V (the keystream into P.w, or P.words_in) and
// its record: the count of ambiguous words and the first of them, in order
__device__ void walk_words(const Walk& P, WalkShared& S, int v, int V) {
  if (threadIdx.x == 0) S.count = 0;
  __syncthreads();
  const uint64_t amb = kM - static_cast<uint64_t>(P.n);
  auto note = [&](int i, uint64_t w) {
    if (w > amb) {
      const int slot = atomicAdd(&S.count, 1);
      if (slot < kMaxAmbCap) S.list[slot] = i;
    }
  };
  int lo, hi;
  if (P.words_in != nullptr) {
    chunk(P.wtot, v, V, lo, hi);
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
      note(i, P.words_in[i]);
  } else {
    chunk(P.units, v, V, lo, hi);
    for (int b = lo + threadIdx.x; b < hi; b += blockDim.x) {
      const int f = b / P.bpf, c = b - f * P.bpf;
      uint32_t x[16];
      nfl_salsa::block(P.s.key,
                       nfl_salsa::nonce_of(P.s.nonce_dev, P.s.nonce_add, f),
                       static_cast<uint64_t>(c), x);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (8 * c + q < P.h) {
          const int i = f * P.h + 8 * c + q;
          const uint64_t w = word64(x, q);
          P.w[i] = w;
          note(i, w);
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int* r = P.rec + v * (1 + kMaxAmbCap);
    const int c = S.count < kMaxAmbCap ? S.count : kMaxAmbCap;
    sort_ints(S.list, c);
    r[0] = S.count;
    for (int j = 0; j < c; ++j) r[1 + j] = S.list[j];
  }
  __syncthreads();
}

// every block: the records merged, the ambiguous words resolved in order,
// T and the guard; block 0 writes the advance
__device__ void walk_resolve(const Walk& P, WalkShared& S) {
  if (threadIdx.x == 0) {
    S.count = 0;
    S.listed = 0;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < P.groups; g += blockDim.x) {
    const int* r = P.rec + g * (1 + kMaxAmbCap);
    const int c = r[0];
    if (c > 0) {
      atomicAdd(&S.count, c);
      for (int j = 0; j < c && j < kMaxAmbCap; ++j) {
        const int slot = atomicAdd(&S.listed, 1);
        if (slot < kMaxAmbCap) S.list[slot] = r[1 + j];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool ok = S.count <= P.amb_cap;
    int nrej = 0;
    if (ok) {
      sort_ints(S.list, S.count);
      const long long top = P.n - 1 > 1 ? P.n - 1 : 1;
      for (int j = 0; j < S.count; ++j) {
        const int i = S.list[j];
        // k at word i = h + i - the rejections before i, all of them
        // ambiguous and so already in rej; past the consumed words k is
        // clamped as the JAX package clamps it
        const long long k = static_cast<long long>(P.h) + i - nrej;
        const uint64_t kc = static_cast<uint64_t>(k > top ? top : k);
        if (P.w[i] > kM - kM % kc) S.rej[nrej++] = i;
      }
    }
    int T = P.n - P.h;
    for (int j = 0; j < nrej; ++j)
      if (S.rej[j] < T) ++T;
    ok = ok && P.wtot - nrej >= P.n - P.h;
    S.nrej = nrej;
    S.T = T;
    S.ok = ok;
    if (blockIdx.x == 0) *P.adv = ok ? (T + P.h - 1) / P.h + 1 : -1;
  }
  __syncthreads();
}

// the consumed accepted words of block v of V into the reservoir
__device__ void walk_reservoir(const Walk& P, const WalkShared& S, int v,
                               int V) {
  if (!S.ok) return;
  int lo, hi;
  chunk(S.T, v, V, lo, hi);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    int below = 0;
    bool rejected = false;
    for (int j = 0; j < S.nrej; ++j) {
      below += S.rej[j] < i;
      rejected |= S.rej[j] == i;
    }
    if (rejected) continue;
    const uint32_t k = static_cast<uint32_t>(P.h + i - below);
    const uint32_t pos = umod_small(P.w[i], k);
    if (pos < static_cast<uint32_t>(P.h))
      atomicMax(P.hit + pos, static_cast<int>(k));
  }
}

// the reservoir's positions into the bitmap and the hits a segment
__device__ void walk_mark(const Walk& P, int v, int V) {
  for (int p = v * blockDim.x + threadIdx.x; p < P.h; p += V * blockDim.x) {
    const int x = P.hit[p];
    atomicOr(P.bitmap + (x >> 5), 1u << (x & 31));
    atomicAdd(P.segcount + x / kSeg, 1);
  }
}

__global__ void __launch_bounds__(kMaxThreads) hwt_walk_kernel(const Walk P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WalkShared& S = *reinterpret_cast<WalkShared*>(smem_raw);
  walk_init(P, 0, 1);
  walk_words(P, S, 0, 1);
  walk_resolve(P, S);
  walk_reservoir(P, S, 0, 1);
  __syncthreads();
  walk_mark(P, 0, 1);
}

__global__ void __launch_bounds__(kChunkThreads) hwt_words_kernel(
    const Walk P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WalkShared& S = *reinterpret_cast<WalkShared*>(smem_raw);
  walk_init(P, blockIdx.x, gridDim.x);
  walk_words(P, S, blockIdx.x, gridDim.x);
}

__global__ void __launch_bounds__(kChunkThreads) hwt_reservoir_kernel(
    const Walk P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WalkShared& S = *reinterpret_cast<WalkShared*>(smem_raw);
  walk_resolve(P, S);
  walk_reservoir(P, S, blockIdx.x, gridDim.x);
}

__global__ void __launch_bounds__(kChunkThreads) hwt_mark_kernel(
    const Walk P) {
  walk_mark(P, blockIdx.x, gridDim.x);
}

// ---------------------------------------------------------------------------
// S5: the radix select of the h smallest (key, index) pairs
// ---------------------------------------------------------------------------

struct Select {
  Stream s;
  const uint64_t* keys;      // [n] in global memory, or null (<true>: made)
  int n, log_n, h;
  uint32_t* bitmap;          // [ceil(n / 32)]
  int* segcount;             // [ceil(n / kSeg)]
};

struct SelectShared {
  unsigned long long kpre, kmask, kstar;
  int ipre, imask, istar, r, cnt;
  int hist[256];
  int scan[256];
  int seg[kMaxSeg];
};

constexpr int kSelectHead = (sizeof(SelectShared) + 15) / 16 * 16;

// the n keys: kShared, in shared memory after the head (copied from
// P.keys, or the keystream's words 0..n-1); else P.keys.  Threads: at
// least 256, one a histogram bin.
template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads) hwt_select_kernel(
    const Select P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SelectShared& S = *reinterpret_cast<SelectShared*>(smem_raw);
  const int n = P.n, t = threadIdx.x, T = blockDim.x;
  const uint64_t* keys = P.keys;
  if constexpr (kShared) {
    uint64_t* sk = reinterpret_cast<uint64_t*>(smem_raw + kSelectHead);
    if (P.keys != nullptr) {
      for (int x = t; x < n; x += T) sk[x] = P.keys[x];
    } else {
      const uint64_t nonce = nfl_salsa::nonce_of(P.s.nonce_dev,
                                                 P.s.nonce_add, 0);
      for (int b = t; b < (n + 7) / 8; b += T) {
        uint32_t x[16];
        nfl_salsa::block(P.s.key, nonce, static_cast<uint64_t>(b), x);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (8 * b + q < n) sk[8 * b + q] = word64(x, q);
      }
    }
    keys = sk;
  }
  if (t == 0) {
    S.kpre = S.kmask = 0;
    S.ipre = S.imask = 0;
    S.r = P.h;
    S.cnt = n;
  }
  __syncthreads();
  // digits: the key's 8 bytes from the top, then the index's log_n bits
  // from the top, 8 at a time; the pairs matching the prefix so far go
  // into a histogram, and the bin holding rank r extends the prefix
  const int passes = 8 + (P.log_n + 7) / 8;
  for (int pass = 0; pass < passes && S.cnt > 1; ++pass) {
    const bool on_key = pass < 8;
    const int top = on_key ? 64 - 8 * pass : P.log_n - 8 * (pass - 8);
    const int low = top > 8 ? top - 8 : 0;
    const uint32_t dmask = (1u << (top - low)) - 1;
    const uint64_t kpre = S.kpre, kmask = S.kmask;
    const int ipre = S.ipre, imask = S.imask, r = S.r;
    if (t < 256) S.hist[t] = 0;
    __syncthreads();
    for (int x = t; x < n; x += T) {
      const uint64_t k = keys[x];
      if ((k & kmask) == kpre && (x & imask) == ipre)
        atomicAdd(&S.hist[on_key ? static_cast<int>((k >> low) & 255)
                                 : (x >> low) & static_cast<int>(dmask)],
                  1);
    }
    __syncthreads();
    if (t < 256) S.scan[t] = S.hist[t];
    __syncthreads();
    for (int off = 1; off < 256; off <<= 1) {
      const int add = t < 256 && t >= off ? S.scan[t - off] : 0;
      __syncthreads();
      if (t < 256) S.scan[t] += add;
      __syncthreads();
    }
    if (t < 256) {
      const int incl = S.scan[t], excl = incl - S.hist[t];
      if (excl < r && r <= incl) {
        S.r = r - excl;
        S.cnt = S.hist[t];
        if (on_key) {
          S.kpre = kpre | (static_cast<uint64_t>(t) << low);
          S.kmask = kmask | (255ull << low);
        } else {
          S.ipre = ipre | (t << low);
          S.imask = imask | static_cast<int>(dmask << low);
        }
      }
    }
    __syncthreads();
  }
  // the one pair left: the h-th smallest
  {
    const uint64_t kpre = S.kpre, kmask = S.kmask;
    const int ipre = S.ipre, imask = S.imask;
    for (int x = t; x < n; x += T) {
      const uint64_t k = keys[x];
      if ((k & kmask) == kpre && (x & imask) == ipre) {
        S.kstar = k;
        S.istar = x;
      }
    }
  }
  const int nw = (n + 31) >> 5, nseg = (n + kSeg - 1) / kSeg;
  for (int g = t; g < nseg; g += T) S.seg[g] = 0;
  __syncthreads();
  const uint64_t ks = S.kstar;
  const int is = S.istar;
  for (int w = t; w < nw; w += T) {
    uint32_t bits = 0;
    for (int j = 0; j < 32; ++j) {
      const int b = (j + w) & 31;       // rotated: no bank conflicts
      const int x = 32 * w + b;
      if (x < n) {
        const uint64_t k = keys[x];
        if (k < ks || (k == ks && x <= is)) bits |= 1u << b;
      }
    }
    P.bitmap[w] = bits;
    atomicAdd(&S.seg[w / kSegWords], __popc(bits));
  }
  __syncthreads();
  for (int g = t; g < nseg; g += T) P.segcount[g] = S.seg[g];
}

// S5's keys in global memory: one keystream block a thread
__global__ void __launch_bounds__(kChunkThreads) hwt_keys_kernel(
    const Stream s, int n, uint64_t* keys) {
  const int b = blockIdx.x * kChunkThreads + threadIdx.x;
  if (b >= (n + 7) / 8) return;
  uint32_t x[16];
  nfl_salsa::block(s.key, nfl_salsa::nonce_of(s.nonce_dev, s.nonce_add, 0),
                   static_cast<uint64_t>(b), x);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (8 * b + q < n) keys[8 * b + q] = word64(x, q);
}

// ---------------------------------------------------------------------------
// the store, S5's and S6's
// ---------------------------------------------------------------------------

template <int BYTES>
using Storage = typename std::conditional<
    BYTES == 2, uint16_t,
    typename std::conditional<BYTES == 4, uint32_t, uint64_t>::type>::type;

struct Store {
  Stream s;
  const long long* adv;      // S6's advance (-1: the guard), or null (S5)
  long long sign_off;        // the first sign word's index in its stream
  const uint32_t* bitmap;
  const int* segcount;
  const long long* p;        // [m]
  int m, n, cpg;             // cpg: channels a block
  int vec;                   // 16-byte stores: rows 16-byte aligned
  void* out;                 // [m, n] at BYTES a word
};

struct StoreShared {
  uint32_t bits[kSegWords];
  int wrank[kSegWords];
  int red[kStoreThreads];
  int count;
  unsigned char sgn[kSeg];
  unsigned char code[kSeg];
};

// row[j] = val(j) for j < len: 16-byte vectors when `vec`, else one word
// a step
template <int BYTES, class F>
__device__ __forceinline__ void store_row(void* row, int len, bool vec,
                                          F val) {
  using W = Storage<BYTES>;
  constexpr int R = 16 / BYTES;
  if (vec) {
    uint4* v = static_cast<uint4*>(row);
    for (int q = threadIdx.x; q < len / R; q += blockDim.x) {
      W w[R];
#pragma unroll
      for (int k = 0; k < R; ++k) w[k] = val(q * R + k);
      uint4 u;
      memcpy(&u, w, 16);
      v[q] = u;
    }
  } else {
    W* d = static_cast<W*>(row);
    for (int j = threadIdx.x; j < len; j += blockDim.x) d[j] = val(j);
  }
}

template <int BYTES>
__global__ void __launch_bounds__(kStoreThreads) hwt_store_kernel(
    const Store P) {
  using W = Storage<BYTES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StoreShared& S = *reinterpret_cast<StoreShared*>(smem_raw);
  const int s = blockIdx.x, t = threadIdx.x;
  const int x0 = s * kSeg;
  const int len = P.n - x0 < kSeg ? P.n - x0 : kSeg;
  const int nw = (len + 31) >> 5;
  const int c_lo = blockIdx.y * P.cpg;
  const int c_hi = c_lo + P.cpg < P.m ? c_lo + P.cpg : P.m;
  char* out = static_cast<char*>(P.out);
  const long long a = P.adv != nullptr ? *P.adv : 1;
  if (a == -1) {                        // the guard: every word all ones
    for (int c = c_lo; c < c_hi; ++c)
      store_row<BYTES>(out + (static_cast<size_t>(c) * P.n + x0) * BYTES,
                       len, P.vec, [](int) { return static_cast<W>(kM); });
    return;
  }
  // the hits before this segment, and their ranks within it
  int acc = 0;
  for (int g = t; g < s; g += kStoreThreads) acc += P.segcount[g];
  S.red[t] = acc;
  if (t < nw) S.bits[t] = P.bitmap[s * kSegWords + t];
  __syncthreads();
  for (int off = kStoreThreads / 2; off > 0; off >>= 1) {
    if (t < off) S.red[t] += S.red[t + off];
    __syncthreads();
  }
  if (t == 0) {
    int run = 0;
    for (int w = 0; w < nw; ++w) {
      S.wrank[w] = run;
      run += __popc(S.bits[w]);
    }
    S.count = run;
  }
  __syncthreads();
  // the sign words of ranks [rank0, rank0 + count): words g0.. of the
  // stream at nonce (S5) or nonce + fills (S6)
  const long long g0 = P.sign_off + S.red[0];
  const int cnt = S.count;
  if (cnt > 0) {
    const uint64_t nonce = nfl_salsa::nonce_of(
        P.s.nonce_dev, P.s.nonce_add, P.adv != nullptr ? a - 1 : 0);
    const long long b_lo = g0 >> 3, b_hi = (g0 + cnt + 7) >> 3;
    for (long long b = b_lo + t; b < b_hi; b += kStoreThreads) {
      uint32_t x[16];
      nfl_salsa::block(P.s.key, nonce, static_cast<uint64_t>(b), x);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const long long r = 8 * b + q - g0;
        if (r >= 0 && r < cnt) S.sgn[r] = (x[2 * q] >> 1) & 1;
      }
    }
  }
  __syncthreads();
  for (int j = t; j < len; j += kStoreThreads) {
    const uint32_t bw = S.bits[j >> 5];
    const uint32_t below = bw & ((1u << (j & 31)) - 1);
    S.code[j] = (bw >> (j & 31)) & 1
                    ? 1 + S.sgn[S.wrank[j >> 5] + __popc(below)]
                    : 0;
  }
  __syncthreads();
  for (int c = c_lo; c < c_hi; ++c) {
    const uint64_t pm1 = static_cast<uint64_t>(P.p[c]) - 1;
    store_row<BYTES>(out + (static_cast<size_t>(c) * P.n + x0) * BYTES, len,
                     P.vec, [&](int j) {
                       const int cd = S.code[j];
                       return cd ? static_cast<W>(pm1 + 2 * (cd - 1)) : W(0);
                     });
  }
}

// ---------------------------------------------------------------------------
// host side: plans and launches
// ---------------------------------------------------------------------------

long long align16(long long b) { return (b + 15) / 16 * 16; }

int pow2_at_least(long long v, int lo, int hi) {
  int t = lo;
  while (t < hi && t < v) t <<= 1;
  return t;
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// S6's shape: fills, blocks a fill, words, keystream blocks
struct ExactShape {
  int nf, bpf, wtot, sb, units;
};

ExactShape exact_shape(int n, int h, bool words_in) {
  ExactShape e;
  const int more = (n - h + h - 1) / h + 1;
  e.nf = more > 1 ? more : 1;
  e.bpf = (h + 7) / 8;
  e.wtot = e.nf * h;
  e.sb = e.nf * e.bpf;
  e.units = words_in ? (e.wtot + 7) / 8 : e.sb;
  return e;
}

// a call's plan: one block (the walk, or the select in shared memory),
// the kernels it launches, and its scratch's parts (byte offsets); smem:
// the select's dynamic shared memory
struct Plan {
  bool one_block;
  int kernels, threads, groups;
  long long w, rec, hit, bits, seg, keys, bytes, smem;
};

Plan plan_for(bool exact, int n, int h, bool words_in, long long cap) {
  Plan pl{};
  const int nw = (n + 31) / 32, nseg = (n + kSeg - 1) / kSeg;
  long long off = 0;
  if (exact) {
    const ExactShape e = exact_shape(n, h, words_in);
    pl.one_block = e.units <= cap;
    pl.kernels = pl.one_block ? 2 : 4;
    pl.threads = pl.one_block ? pow2_at_least(e.units, 64, kMaxThreads)
                              : kChunkThreads;
    const int g = (e.units + kChunkThreads - 1) / kChunkThreads;
    pl.groups = pl.one_block ? 1 : g < kMaxGroups ? g : kMaxGroups;
    pl.w = off;
    off += words_in ? 0 : align16(8LL * e.wtot);
    pl.rec = off;
    off += align16(4LL * pl.groups * (1 + kMaxAmbCap));
    pl.hit = off;
    off += align16(4LL * h);
  } else {
    pl.smem = kSelectHead + 8LL * n;
    pl.one_block = pl.smem <= cap;
    if (!pl.one_block) pl.smem = kSelectHead;
    pl.kernels = pl.one_block || words_in ? 2 : 3;
    pl.threads = pow2_at_least(n / 16, 256, kMaxThreads);
    pl.keys = off;
    off += pl.one_block || words_in ? 0 : align16(8LL * n);
  }
  pl.bits = off;
  off += align16(4LL * nw);
  pl.seg = off;
  off += align16(4LL * nseg);
  pl.bytes = off;
  return pl;
}

bool bad_shape(int n, int h, int m, int bytes) {
  return n < 1 || n > (1 << kMaxLogN) || (n & (n - 1)) != 0 || h < 1
         || h > n || m < 1 || (bytes != 2 && bytes != 4 && bytes != 8);
}

Stream stream_of(const uint32_t* key, const void* nonce_dev,
                 unsigned long long nonce_add) {
  Stream s;
  for (int w = 0; w < 8; ++w) s.key.w[w] = key[w];
  s.nonce_dev = static_cast<const long long*>(nonce_dev);
  s.nonce_add = nonce_add;
  return s;
}

int launch_store(const Stream& s, const long long* adv, long long sign_off,
                 const uint32_t* bitmap, const int* segcount,
                 const void* p, int m, int n, int bytes, void* out,
                 int device, cudaStream_t st) {
  Store P{};
  P.s = s;
  P.adv = adv;
  P.sign_off = sign_off;
  P.bitmap = bitmap;
  P.segcount = segcount;
  P.p = static_cast<const long long*>(p);
  P.m = m;
  P.n = n;
  P.out = out;
  P.vec = reinterpret_cast<uintptr_t>(out) % 16 == 0
          && (static_cast<long long>(n) * bytes) % 16 == 0;
  const unsigned gx = static_cast<unsigned>((n + kSeg - 1) / kSeg);
  // channel groups until the grid has two blocks an SM
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (2LL * sms + gx - 1) / gx;
  const int groups = want < m ? static_cast<int>(want) : m;
  P.cpg = (m + groups - 1) / groups;
  const unsigned gy = static_cast<unsigned>((m + P.cpg - 1) / P.cpg);
  const dim3 grid(gx, gy);
  const size_t smem = sizeof(StoreShared);
  if (bytes == 2)
    hwt_store_kernel<2><<<grid, kStoreThreads, smem, st>>>(P);
  else if (bytes == 4)
    hwt_store_kernel<4><<<grid, kStoreThreads, smem, st>>>(P);
  else
    hwt_store_kernel<8><<<grid, kStoreThreads, smem, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ctypes entry: a call's plan.  exact: S6 (1) or S5 (0); words_in: the
// words-in instance; cap: S6, the most keystream blocks (words_in: words
// / 8) of the one-block walk; S5, the most shared-memory bytes a block
// takes.  out: [one block, scratch bytes, kernels launched].
extern "C" void nfl_hwt_plan(int exact, int n, int h, int words_in,
                             long long cap, long long* out) {
  const Plan pl = plan_for(exact != 0, n, h, words_in != 0, cap);
  out[0] = pl.one_block;
  out[1] = pl.bytes;
  out[2] = pl.kernels;
}

// ctypes entry, S6: the stream-exact hwt sampler.  key: 8 host words;
// nonce_dev: a device int64 or null; nonce_add: added to it; words: the
// words-in instance's [nf * h] uint64 reservoir words, or null (the
// keystream); amb_cap: the most ambiguous words resolved (0..64); p: [m]
// int64 moduli; out: [m, n] words of out_bytes; adv: one int64, the
// advance (fills + 1, or -1); scratch: nfl_hwt_plan's bytes; cap: as
// nfl_hwt_plan's.  All device pointers; device: the current device.
// Returns the cudaError_t of the launches (0 on success), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int nfl_hwt_exact(const uint32_t* key, const void* nonce_dev,
                             unsigned long long nonce_add, const void* words,
                             int n, int h, int amb_cap, const void* p, int m,
                             int out_bytes, void* out, void* adv,
                             void* scratch, long long cap, int device,
                             void* stream) {
  if (bad_shape(n, h, m, out_bytes) || amb_cap < 0 || amb_cap > kMaxAmbCap)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool words_in = words != nullptr;
  const ExactShape e = exact_shape(n, h, words_in);
  const Plan pl = plan_for(true, n, h, words_in, cap);
  auto* base = static_cast<unsigned char*>(scratch);
  Walk P{};
  P.s = stream_of(key, nonce_dev, nonce_add);
  P.words_in = static_cast<const uint64_t*>(words);
  P.w = words_in ? const_cast<uint64_t*>(P.words_in)
                 : reinterpret_cast<uint64_t*>(base + pl.w);
  P.n = n;
  P.h = h;
  P.bpf = e.bpf;
  P.amb_cap = amb_cap;
  P.wtot = e.wtot;
  P.units = e.sb;
  P.groups = pl.groups;
  P.rec = reinterpret_cast<int*>(base + pl.rec);
  P.hit = reinterpret_cast<int*>(base + pl.hit);
  P.bitmap = reinterpret_cast<uint32_t*>(base + pl.bits);
  P.segcount = reinterpret_cast<int*>(base + pl.seg);
  P.adv = static_cast<long long*>(adv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(WalkShared);
  if (pl.one_block) {
    hwt_walk_kernel<<<1, pl.threads, smem, st>>>(P);
  } else {
    hwt_words_kernel<<<pl.groups, kChunkThreads, smem, st>>>(P);
    const unsigned rb = static_cast<unsigned>(
        (e.wtot + 8 * kChunkThreads - 1) / (8 * kChunkThreads));
    hwt_reservoir_kernel<<<rb, kChunkThreads, smem, st>>>(P);
    const unsigned mb = static_cast<unsigned>(
        (h + kChunkThreads - 1) / kChunkThreads);
    hwt_mark_kernel<<<mb, kChunkThreads, 0, st>>>(P);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_store(P.s, P.adv, 0, P.bitmap, P.segcount, p, m, n,
                      out_bytes, out, device, st);
}

// ctypes entry, S5: the fixed-consumption hwt sampler.  words: the
// words-in instance's [n] uint64 keys, or null (the keystream's); cap: the
// most shared-memory bytes a block takes; the rest as nfl_hwt_exact's.
extern "C" int nfl_hwt_fixed(const uint32_t* key, const void* nonce_dev,
                             unsigned long long nonce_add, const void* words,
                             int n, int h, const void* p, int m,
                             int out_bytes, void* out, void* scratch,
                             long long cap, int device, void* stream) {
  if (bad_shape(n, h, m, out_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool words_in = words != nullptr;
  const Plan pl = plan_for(false, n, h, words_in, cap);
  auto* base = static_cast<unsigned char*>(scratch);
  Select P{};
  P.s = stream_of(key, nonce_dev, nonce_add);
  P.keys = static_cast<const uint64_t*>(words);
  P.n = n;
  P.log_n = log2_of(n);
  P.h = h;
  P.bitmap = reinterpret_cast<uint32_t*>(base + pl.bits);
  P.segcount = reinterpret_cast<int*>(base + pl.seg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.one_block) {
    const cudaError_t err = cudaFuncSetAttribute(
        hwt_select_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(pl.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    hwt_select_kernel<true><<<1, pl.threads, pl.smem, st>>>(P);
  } else {
    if (!words_in) {
      auto* keys = reinterpret_cast<uint64_t*>(base + pl.keys);
      const unsigned kb = static_cast<unsigned>(
          ((n + 7) / 8 + kChunkThreads - 1) / kChunkThreads);
      hwt_keys_kernel<<<kb, kChunkThreads, 0, st>>>(P.s, n, keys);
      P.keys = keys;
    }
    hwt_select_kernel<false><<<1, pl.threads, pl.smem, st>>>(P);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_store(P.s, nullptr, n, P.bitmap, P.segcount, p, m, n,
                      out_bytes, out, device, st);
}
