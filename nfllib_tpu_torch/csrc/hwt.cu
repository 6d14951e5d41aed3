// S5 and S6: the device hwt samplers (h coefficients +-1, the rest 0: the
// sparse ternary secret of RLWE schemes), each a first launch over many
// CTAs whose last CTA merges their work, and a store kernel.
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
// consumed accepted words with w mod k == p; the hit positions are
// distinct (each k is written once, and k > p), so a bitmap over n
// replaces the JAX package's sort, and the sign index of a hit is its rank
// (a popcount prefix).  The budget guard stays: more than amb_cap
// ambiguous words, or fewer than n - h accepted ones, give all-ones
// residues and the advance -1.
//   * hwt_partial_kernel (h <= kMaxPartialH): CTA v makes its share of the
//     keystream (kUnitsPerCta blocks, a thread a block, the words staged
//     in shared memory so that every thread of the CTA takes some),
//     records its ambiguous words, and sends each word i < n - h with p =
//     w mod (h + i) < h to slot p of a reservoir in the stream's
//     persistent state (atomicMax, no return): the answer when no word is
//     rejected.  The last CTA to take a ticket resolves the records; with
//     no rejection (all but about n * words / 2^64 of calls) it reads hit[p]
//     = max(p, slot p), else it walks the words again in shared memory with
//     the rejections counted.  Either way it sets the slots back to 0, and
//     writes the advance, the bitmap and each store segment's rank offset.
//   * else (h above the persistent reservoir) hwt_words_kernel (keystream,
//     ambiguous words by CTA, the scratch's initial values) and
//     hwt_reservoir_kernel (each CTA resolves the records, then its words'
//     atomicMax into a reservoir in the scratch; its last CTA marks the
//     bitmap and the rank offsets).
//
// S5, fixed consumption: the n + h little-endian 64-bit words of the
// stream at nonce.  The hits are the h smallest (key, index) pairs of the
// first n words (a stable argsort's first h); the sign of the hit of rank
// j is bit 1 of word n + j.  hwt_cand_kernel: CTA v makes the keys of
// segment v (kSeg positions, the store's segment) and keeps as candidates
// those at or below a threshold that about h + 8 sqrt(h) + 16 of the n
// keys pass.  When at least h pass, the h smallest pairs are among them,
// ties included (the order is lexicographic on (key, index)): the last CTA
// copies the candidates into shared memory, finds the h-th smallest by a
// radix select (byte digits of the key from the top, then of the index,
// each a histogram and a prefix over its 256 bins, until one pair is
// left) and marks the candidates at or below it.  Otherwise (too few, a
// CTA's slots overflowed, or more than `cap`: a large h) it runs the same
// selection over all n keys in global memory.
//
// Both end in hwt_store_kernel<BYTES>: a block a segment of kSeg positions
// and a group of channels reads its rank offset (written by the last
// CTA), ranks its hits within the segment (popcounts, a word a thread),
// makes the keystream blocks of their sign words and stores (p_c - 1 +
// (sign & 2)) at hits and 0 elsewhere, in 16-byte vectors.  Two launches
// a call (S6's many-block walk three), no host synchronisation, no memset:
// the stream's persistent state (the last-CTA ticket, which atomicInc
// wraps back to 0, and S6's reservoir) is zeroed once by the wrapper and
// left at 0 by every launch.  The testing hook: both samplers take their
// words from a pointer in place of their keystream (the words-in
// instance); the signs stay the keystream's.
//
// Bound on this card: the bytes at the LWE rings.  The residues written,
// m * n words, are 1.1 MB at u32 (16384, 510); the keystream is 2,056
// Salsa20 blocks (S6: nf * ceil(h / 8) and as many for the signs at n =
// 2^14, h = 64; S5: (n + h) / 8), each 640 rotates and xors on the ALU
// pipe and 336 adds (S1's count), a third of the bytes' time spread over
// every SM.  Both are far below a launch's latency, so the design keeps
// each thread to one keystream block and the last CTA's serial part (the
// records, h reservoir slots, or a selection among about 150 candidates)
// short.

#include <cmath>
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
constexpr int kThreads = 256;             // S6's CTAs
constexpr int kMaxThreads = 1024;         // S5's, selecting among all keys
constexpr int kMaxGroups = 1024;          // S6's first launch's CTAs
constexpr int kMaxAmbCap = 64;
constexpr int kUnitsPerCta = 64;          // S6: keystream blocks a CTA
constexpr int kMaxPartialH = 8192;        // S6: the persistent reservoir's h
constexpr int kStateHead = 16;            // the state: the ticket, then the
constexpr int kStateBytes = kStateHead + 4 * kMaxPartialH;  // reservoir
constexpr int kMaxCandCap = 2048;         // S5: candidates in shared memory
constexpr uint64_t kM = ~0ull;            // 2^64 - 1

struct Stream {
  Key key;
  const long long* nonce_dev;             // null, or one int64 on the card
  unsigned long long nonce_add;
};

__device__ __forceinline__ uint64_t word64(const uint32_t x[16], int q) {
  return x[2 * q] | (static_cast<uint64_t>(x[2 * q + 1]) << 32);
}

// nfl_salsa::block with its 10 double rounds kept as a loop, a tenth of
// the code: each thread here makes one block or a few, right after the
// launch, so the unrolled rounds' instructions would be fetched once and
// not reused
__device__ __forceinline__ void salsa_block(const Key& key, uint64_t nonce,
                                            uint64_t ctr, uint32_t out[16]) {
  using nfl_salsa::quarter;
  const uint32_t j[16] = {
      0x61707865u, key.w[0], key.w[1], key.w[2],
      key.w[3], 0x3320646Eu, static_cast<uint32_t>(nonce),
      static_cast<uint32_t>(nonce >> 32), static_cast<uint32_t>(ctr),
      static_cast<uint32_t>(ctr >> 32), 0x79622D32u, key.w[4],
      key.w[5], key.w[6], key.w[7], 0x6B206574u};
  uint32_t x[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = j[k];
#pragma unroll 1
  for (int r = 0; r < 10; ++r) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[5], x[9], x[13], x[1]);
    quarter(x[10], x[14], x[2], x[6]);
    quarter(x[15], x[3], x[7], x[11]);
    quarter(x[0], x[1], x[2], x[3]);
    quarter(x[5], x[6], x[7], x[4]);
    quarter(x[10], x[11], x[8], x[9]);
    quarter(x[15], x[12], x[13], x[14]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) out[k] = x[k] + j[k];
}

// a word another CTA of the launch stored: read past the SM's L1
__device__ __forceinline__ int load_cg(const int* p) { return __ldcg(p); }
__device__ __forceinline__ uint64_t load_cg(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ int sm_id() {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return static_cast<int>(r);
#else
  return 0;
#endif
}

// w mod k for 0 < k < 2^21: the high half mod k in 32 bits, then the rest,
// below k * 2^32 <= 2^53 and so exact in a double, times the rounded
// reciprocal of k: the quotient below 2^32 within 2^-20 of y / k, so its
// integer part is off by at most one, which one correction repairs
__device__ __forceinline__ uint32_t umod_small(uint64_t w, uint32_t k) {
  const uint32_t r1 = static_cast<uint32_t>(w >> 32) % k;
  const uint64_t y = (static_cast<uint64_t>(r1) << 32)
                     | static_cast<uint32_t>(w);
  const long long q = static_cast<long long>(
      static_cast<double>(y) * __drcp_rn(static_cast<double>(k)));
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

// True in the last CTA of the grid to get here, which may then read what
// every CTA stored before: each thread fences its stores before thread 0
// takes a ticket, and atomicInc wraps the counter back to 0 for the next
// launch.  flag: a shared int.
__device__ bool last_block(unsigned* ticket, int& flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    flag = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  const bool last = flag != 0;
  if (last) __threadfence();
  return last;
}

// a[i] = a[0] + ... + a[i] for i < len, in place; a, tmp: shared [len]
// (the rank offsets of the store's segments, or of S5's CTAs)
__device__ void scan_incl(int* a, int* tmp, int len) {
  const int t = threadIdx.x, T = blockDim.x;
  if (len <= 64 && len <= T) {
    // short: each entry's sum directly, its loads overlapping
    if (t < len) {
      int s = 0;
#pragma unroll 8
      for (int j = 0; j <= t; ++j) s += a[j];
      tmp[t] = s;
    }
    __syncthreads();
    if (t < len) a[t] = tmp[t];
    __syncthreads();
    return;
  }
  for (int off = 1; off < len; off <<= 1) {
    for (int i = t; i < len; i += T) tmp[i] = i >= off ? a[i - off] : 0;
    __syncthreads();
    for (int i = t; i < len; i += T) a[i] += tmp[i];
    __syncthreads();
  }
}

// the hits x = pos(j) >= 0, j < count, into the bitmap (zeroed before) and
// each store segment's rank offset into prefix; seg, tmp: shared [kMaxSeg]
template <class F>
__device__ void mark_hits(int n, int count, F pos, uint32_t* bitmap,
                          int* prefix, int* seg, int* tmp) {
  const int t = threadIdx.x, T = blockDim.x;
  const int nseg = (n + kSeg - 1) / kSeg;
  for (int s = t; s < nseg; s += T) seg[s] = 0;
  __syncthreads();
  for (int j = t; j < count; j += T) {
    const int x = pos(j);
    if (x >= 0) {
      atomicOr(bitmap + (x >> 5), 1u << (x & 31));
      atomicAdd(seg + x / kSeg, 1);
    }
  }
  __syncthreads();
  scan_incl(seg, tmp, nseg);
  for (int i = t; i < nseg; i += T) prefix[i] = i > 0 ? seg[i - 1] : 0;
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
  int groups;                // the first launch's CTAs: one record each
  int* rec;                  // [groups][1 + kMaxAmbCap]
  int* res;                  // hwt_partial_kernel: [h] of the persistent
                             // reservoir, 0 between launches
  int* hit;                  // hwt_reservoir_kernel: [h] the reservoir
  uint32_t* bitmap;          // [ceil(n / 32)]
  int* prefix;               // [ceil(n / kSeg)] each segment's rank offset
  int* smid;                 // [groups] the first launch's SM of each CTA
  unsigned* ticket;          // the last-CTA counter, 0 between launches
  long long* adv;            // the advance: fills + 1, or -1
};

struct WalkShared {
  int count, listed, nrej, ok, T, last;
  int list[kMaxAmbCap];
  int rej[kMaxAmbCap];
  int seg[kMaxSeg];
  int tmp[kMaxSeg];
};

constexpr int kWalkHead = (sizeof(WalkShared) + 15) / 16 * 16;

// the many-block walk's scratch: hit[p] = p, the bitmap 0
__device__ void walk_init(const Walk& P, int v, int V) {
  const int nw = (P.n + 31) >> 5;
  for (int i = v * blockDim.x + threadIdx.x; i < P.h || i < nw;
       i += V * blockDim.x) {
    if (i < P.h) P.hit[i] = i;
    if (i < nw) P.bitmap[i] = 0;
  }
}

// the first word of keystream block b (fill b / bpf, its block b % bpf);
// the words of blocks [b0, b1) are [word_of(b0), word_of(b1))
__device__ __forceinline__ int word_of(const Walk& P, int b) {
  const int f = b / P.bpf;
  return f * P.h + 8 * (b - f * P.bpf);
}

// The words of CTA v of V, each handed to consume(i, w), and its record:
// the count of ambiguous words and the first of them, in order.  The
// keystream: rounds of one block a thread, its words into P.w and into
// sw (shared, 8 words a thread), then every thread takes the round's
// words, so that the per-word work spreads over the whole CTA.
template <class F>
__device__ void walk_words(const Walk& P, WalkShared& S, uint64_t* sw, int v,
                           int V, F consume) {
  const int t = threadIdx.x, T = blockDim.x;
  if (t == 0) S.count = 0;
  __syncthreads();
  const uint64_t amb = kM - static_cast<uint64_t>(P.n);
  auto take = [&](int i, uint64_t w) {
    if (w > amb) {
      const int slot = atomicAdd(&S.count, 1);
      if (slot < kMaxAmbCap) S.list[slot] = i;
    }
    consume(i, w);
  };
  int lo, hi;
  if (P.words_in != nullptr) {
    chunk(P.wtot, v, V, lo, hi);
    for (int i = lo + t; i < hi; i += T) take(i, P.words_in[i]);
  } else {
    chunk(P.units, v, V, lo, hi);
    for (int r0 = lo; r0 < hi; r0 += T) {
      const int r1 = r0 + T < hi ? r0 + T : hi;
      const int i0 = word_of(P, r0), i1 = word_of(P, r1);
      const int b = r0 + t;
      if (b < r1) {
        const int f = b / P.bpf, c = b - f * P.bpf;
        uint32_t x[16];
        salsa_block(P.s.key,
                    nfl_salsa::nonce_of(P.s.nonce_dev, P.s.nonce_add, f),
                    static_cast<uint64_t>(c), x);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (8 * c + q < P.h) {
            const int i = f * P.h + 8 * c + q;
            const uint64_t w = word64(x, q);
            P.w[i] = w;
            sw[i - i0] = w;
          }
        }
      }
      __syncthreads();
      for (int i = i0 + t; i < i1; i += T) take(i, sw[i - i0]);
      __syncthreads();
    }
  }
  __syncthreads();
  if (t == 0) {
    int* r = P.rec + v * (1 + kMaxAmbCap);
    const int c = S.count < kMaxAmbCap ? S.count : kMaxAmbCap;
    sort_ints(S.list, c);
    r[0] = S.count;
    for (int j = 0; j < c; ++j) r[1 + j] = S.list[j];
  }
  __syncthreads();
}

// the records merged, the ambiguous words resolved in order, T and the
// guard; `write_adv`: this CTA writes the advance
__device__ void walk_resolve(const Walk& P, WalkShared& S, bool write_adv) {
  if (threadIdx.x == 0) {
    S.count = 0;
    S.listed = 0;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < P.groups; g += blockDim.x) {
    const int* r = P.rec + g * (1 + kMaxAmbCap);
    const int c = load_cg(r);
    if (c > 0) {
      atomicAdd(&S.count, c);
      for (int j = 0; j < c && j < kMaxAmbCap; ++j) {
        const int slot = atomicAdd(&S.listed, 1);
        if (slot < kMaxAmbCap) S.list[slot] = load_cg(r + 1 + j);
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
        if (load_cg(P.w + i) > kM - kM % kc) S.rej[nrej++] = i;
      }
    }
    int T = P.n - P.h;
    for (int j = 0; j < nrej; ++j)
      if (S.rej[j] < T) ++T;
    ok = ok && P.wtot - nrej >= P.n - P.h;
    S.nrej = nrej;
    S.T = T;
    S.ok = ok;
    if (write_adv) *P.adv = ok ? (T + P.h - 1) / P.h + 1 : -1;
  }
  __syncthreads();
}

// the consumed accepted words of block v of V into the reservoir `hit`
// (shared or global) with the rejections counted
__device__ void walk_reservoir(const Walk& P, const WalkShared& S, int v,
                               int V, int* hit) {
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
    const uint32_t pos = umod_small(load_cg(P.w + i), k);
    if (pos < static_cast<uint32_t>(P.h))
      atomicMax(hit + pos, static_cast<int>(k));
  }
}

// Each CTA: its words, their record, and each word i < n - h with pos =
// w mod (h + i) < h into the persistent reservoir (atomicMax, no return:
// the reservoir as it is when no word is rejected).  The last CTA:
// resolves the records, reads the reservoir and sets it back to 0, and,
// if a word was rejected, walks the words again in shared memory.
__global__ void __launch_bounds__(kThreads) hwt_partial_kernel(const Walk P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WalkShared& S = *reinterpret_cast<WalkShared*>(smem_raw);
  uint64_t* sw = reinterpret_cast<uint64_t*>(smem_raw + kWalkHead);
  const int v = blockIdx.x, V = gridDim.x, t = threadIdx.x, T = blockDim.x;
  const int h = P.h, q = P.n - P.h;       // words consumed, no rejection
  int lo, hi;
  chunk((P.n + 31) >> 5, v, V, lo, hi);
  for (int i = lo + t; i < hi; i += T) P.bitmap[i] = 0;
  if (t == 0) P.smid[v] = sm_id();
  walk_words(P, S, sw, v, V, [&](int i, uint64_t w) {
    if (i < q) {
      const uint32_t k = static_cast<uint32_t>(h + i);
      const uint32_t pos = umod_small(w, k);
      if (pos < static_cast<uint32_t>(h))
        atomicMax(P.res + pos, static_cast<int>(k));
    }
  });
  if (!last_block(P.ticket, S.last)) return;
  // the reservoir's loads issued before the records' resolution
  const int kt = h <= T && t < h ? load_cg(P.res + t) : 0;
  walk_resolve(P, S, true);
  int* hit = reinterpret_cast<int*>(sw);  // h ints
  for (int p = t; p < h; p += T) {
    const int k = h <= T ? kt : load_cg(P.res + p);
    P.res[p] = 0;
    hit[p] = S.nrej == 0 && k > p ? k : p;
  }
  __syncthreads();
  if (!S.ok) return;
  if (S.nrej > 0) walk_reservoir(P, S, 0, 1, hit);
  __syncthreads();
  mark_hits(P.n, h, [&](int p) { return hit[p]; }, P.bitmap, P.prefix,
            S.seg, S.tmp);
}

__global__ void __launch_bounds__(kThreads) hwt_words_kernel(const Walk P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WalkShared& S = *reinterpret_cast<WalkShared*>(smem_raw);
  uint64_t* sw = reinterpret_cast<uint64_t*>(smem_raw + kWalkHead);
  walk_init(P, blockIdx.x, gridDim.x);
  if (threadIdx.x == 0) P.smid[blockIdx.x] = sm_id();
  walk_words(P, S, sw, blockIdx.x, gridDim.x, [](int, uint64_t) {});
}

__global__ void __launch_bounds__(kThreads) hwt_reservoir_kernel(
    const Walk P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WalkShared& S = *reinterpret_cast<WalkShared*>(smem_raw);
  walk_resolve(P, S, blockIdx.x == 0);
  walk_reservoir(P, S, blockIdx.x, gridDim.x, P.hit);
  if (!last_block(P.ticket, S.last) || !S.ok) return;
  mark_hits(P.n, P.h, [&](int p) { return load_cg(P.hit + p); }, P.bitmap,
            P.prefix, S.seg, S.tmp);
}

// ---------------------------------------------------------------------------
// S5: the candidates at or below a threshold, selected by the last CTA
// ---------------------------------------------------------------------------

struct Select {
  Stream s;
  const uint64_t* keys_in;   // the words-in instance's [n], or null
  uint64_t* keys;            // [n] every key: keys_in, or made here
  int n, log_n, h, len;      // len: keys a CTA
  int store_keys;            // the first launch stores every key in keys
  unsigned long long thr;    // a candidate: key <= thr
  int thr_bits;              // thr's significant bits
  int slots;                 // candidates a CTA at most
  int cand_max;              // the most candidates selected in shared memory
  uint64_t* ckey;            // [CTAs][slots] the candidates' keys
  int* cidx;                 // [CTAs][slots] and positions
  int* ccnt;                 // [CTAs] the candidates of each CTA
  uint32_t* bitmap;          // [ceil(n / 32)]
  int* prefix;               // [ceil(n / kSeg)]
  int* smid;                 // [CTAs]
  unsigned* ticket;
};

struct SelectShared {
  unsigned long long kpre, kmask, kstar;
  int ipre, imask, istar, r, cnt, slot, last, total, over;
  int hist[256];
  int grp[16];
  int seg[kMaxSeg];
  int tmp[kMaxSeg];
};

constexpr int kSelectHead = (sizeof(SelectShared) + 15) / 16 * 16;

// The r-th smallest (1-based) of the pairs (key(j), idx(j)), j < cnt, in
// (key, index) order, into S.kstar, S.istar; the keys below 2^key_bits,
// the indices distinct and below 2^log_i.  Each pass keeps the pairs
// matching the digits fixed so far, histograms their next digit (8 bits
// of the key from bit key_bits down, then of the index) and fixes the bin
// holding rank r, until one pair is left.  Threads: at least 256.
template <class KF, class IF>
__device__ void radix_select(SelectShared& S, int cnt, int r, int key_bits,
                             int log_i, KF key, IF idx) {
  const int t = threadIdx.x, T = blockDim.x;
  if (t == 0) {
    S.kpre = S.kmask = 0;
    S.ipre = S.imask = 0;
    S.r = r;
    S.cnt = cnt;
  }
  __syncthreads();
  const int kp = (key_bits + 7) / 8, passes = kp + (log_i + 7) / 8;
  for (int pass = 0; pass < passes && S.cnt > 1; ++pass) {
    const bool on_key = pass < kp;
    const int top = on_key ? key_bits - 8 * pass : log_i - 8 * (pass - kp);
    const int low = top > 8 ? top - 8 : 0;
    const uint32_t dmask = (1u << (top - low)) - 1;
    const uint64_t kpre = S.kpre, kmask = S.kmask;
    const int ipre = S.ipre, imask = S.imask, rr = S.r;
    if (t < 256) S.hist[t] = 0;
    __syncthreads();
    for (int j = t; j < cnt; j += T) {
      const uint64_t k = key(j);
      const int x = idx(j);
      if ((k & kmask) == kpre && (x & imask) == ipre)
        atomicAdd(&S.hist[on_key ? static_cast<int>((k >> low) & dmask)
                                 : (x >> low) & static_cast<int>(dmask)],
                  1);
    }
    __syncthreads();
    // the bin holding rank rr: sums of 16 groups of 16 bins; the thread of
    // the group holding it then walks its bins (loops unrolled, so that
    // the loads overlap)
    if (t < 16) {
      int s = 0;
#pragma unroll
      for (int b = 0; b < 16; ++b) s += S.hist[16 * t + b];
      S.grp[t] = s;
    }
    __syncthreads();
    if (t < 16) {
      int e = 0;
#pragma unroll
      for (int u = 0; u < 16; ++u) e += u < t ? S.grp[u] : 0;
      if (e < rr && rr <= e + S.grp[t]) {
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int bin = 16 * t + b, c = S.hist[bin];
          if (e < rr && rr <= e + c) {
            S.r = rr - e;
            S.cnt = c;
            if (on_key) {
              S.kpre = kpre | (static_cast<uint64_t>(bin) << low);
              S.kmask = kmask | (static_cast<uint64_t>(dmask) << low);
            } else {
              S.ipre = ipre | (bin << low);
              S.imask = imask | static_cast<int>(dmask << low);
            }
          }
          e += c;
        }
      }
    }
    __syncthreads();
  }
  {
    const uint64_t kpre = S.kpre, kmask = S.kmask;
    const int ipre = S.ipre, imask = S.imask;
    for (int j = t; j < cnt; j += T) {
      const uint64_t k = key(j);
      const int x = idx(j);
      if ((k & kmask) == kpre && (x & imask) == ipre) {
        S.kstar = k;
        S.istar = x;
      }
    }
  }
  __syncthreads();
}

// Each CTA: the keys of its segment (the keystream's, a thread a block;
// or P.keys_in), those at or below P.thr into its candidate slots, and
// every key into P.keys when the plan expects the last CTA to need them.
// When at least h keys are candidates, the h smallest pairs are all
// candidates: the last CTA copies them into shared memory (at most
// cand_max), finds the h-th smallest by a radix select and marks the
// pairs at or below it.  Otherwise (too few or too many candidates, or a
// CTA's slots overflowed: many ties) it does the same over all n keys in
// global memory, after making them again if the first launch kept none.
__global__ void __launch_bounds__(kMaxThreads) hwt_cand_kernel(
    const Select P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SelectShared& S = *reinterpret_cast<SelectShared*>(smem_raw);
  const int v = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int len = P.len, x0 = v * len;
  if (t == 0) {
    S.slot = 0;
    P.smid[v] = sm_id();
  }
  for (int w = t; w < (len + 31) >> 5; w += T) P.bitmap[(x0 >> 5) + w] = 0;
  __syncthreads();
  uint64_t* ck = P.ckey + static_cast<size_t>(v) * P.slots;
  int* ci = P.cidx + static_cast<size_t>(v) * P.slots;
  auto take = [&](int x, uint64_t k) {
    if (k <= P.thr) {
      const int s = atomicAdd(&S.slot, 1);
      if (s < P.slots) {
        ck[s] = k;
        ci[s] = x;
      }
    }
  };
  if (P.keys_in != nullptr) {
    for (int j = t; j < len; j += T) take(x0 + j, P.keys_in[x0 + j]);
  } else {
    const uint64_t nonce = nfl_salsa::nonce_of(P.s.nonce_dev,
                                               P.s.nonce_add, 0);
    for (int b = t; b < (len + 7) / 8; b += T) {
      uint32_t x[16];
      salsa_block(P.s.key, nonce, static_cast<uint64_t>(x0 / 8 + b), x);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (8 * b + q < len) {
          const uint64_t k = word64(x, q);
          if (P.store_keys) P.keys[x0 + 8 * b + q] = k;
          take(x0 + 8 * b + q, k);
        }
      }
    }
  }
  __syncthreads();
  if (t == 0) P.ccnt[v] = S.slot;
  if (!last_block(P.ticket, S.last)) return;
  const int G = gridDim.x;
  if (t == 0) {
    S.total = 0;
    S.over = 0;
  }
  __syncthreads();
  for (int u = t; u < G; u += T) {
    const int c = load_cg(P.ccnt + u);
    S.seg[u] = c < P.slots ? c : P.slots;
    atomicAdd(&S.total, c);
    if (c > P.slots) S.over = 1;
  }
  __syncthreads();
  const int total = S.total;
  if (!S.over && total >= P.h && total <= P.cand_max) {
    // the candidates into shared memory as (key, position) pairs, in CTA
    // order; then the h-th smallest of them, and the pairs at or below it
    ulonglong2* c2 = reinterpret_cast<ulonglong2*>(smem_raw + kSelectHead);
    scan_incl(S.seg, S.tmp, G);
    // a thread's slots loaded together (every slot, used or not, lies in
    // the scratch), then the used ones placed
    const int nslots = G * P.slots;
    constexpr int kCopy = 4;
    for (int s0 = 0; s0 < nslots; s0 += kCopy * T) {
      ulonglong2 c[kCopy];
#pragma unroll
      for (int r = 0; r < kCopy; ++r) {
        const int s = s0 + r * T + t;
        if (s < nslots) {
          c[r].x = load_cg(P.ckey + s);
          c[r].y = static_cast<unsigned long long>(load_cg(P.cidx + s));
        }
      }
#pragma unroll
      for (int r = 0; r < kCopy; ++r) {
        const int s = s0 + r * T + t;
        if (s < nslots) {
          const int u = s / P.slots, j = s - u * P.slots;
          const int base = u > 0 ? S.seg[u - 1] : 0;
          if (base + j < S.seg[u]) c2[base + j] = c[r];
        }
      }
    }
    __syncthreads();
    radix_select(S, total, P.h, P.thr_bits, P.log_n,
                 [&](int j) { return c2[j].x; },
                 [&](int j) { return static_cast<int>(c2[j].y); });
    const uint64_t ks = S.kstar;
    const int is = S.istar;
    mark_hits(P.n, total, [&](int j) {
      const ulonglong2 c = c2[j];
      const int x = static_cast<int>(c.y);
      return c.x < ks || (c.x == ks && x <= is) ? x : -1;
    }, P.bitmap, P.prefix, S.seg, S.tmp);
  } else {
    if (P.keys_in == nullptr && !P.store_keys) {
      // the keys again, by this CTA (a fallback the plan did not expect)
      const uint64_t nonce = nfl_salsa::nonce_of(P.s.nonce_dev,
                                                 P.s.nonce_add, 0);
      for (int b = t; b < (P.n + 7) / 8; b += T) {
        uint32_t x[16];
        salsa_block(P.s.key, nonce, static_cast<uint64_t>(b), x);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (8 * b + q < P.n) P.keys[8 * b + q] = word64(x, q);
      }
      __syncthreads();
    }
    const uint64_t* keys = P.keys_in != nullptr ? P.keys_in : P.keys;
    auto key = [&](int j) { return load_cg(keys + j); };
    radix_select(S, P.n, P.h, 64, P.log_n, key, [](int j) { return j; });
    const uint64_t ks = S.kstar;
    const int is = S.istar;
    mark_hits(P.n, P.n, [&](int j) {
      const uint64_t k = key(j);
      return k < ks || (k == ks && j <= is) ? j : -1;
    }, P.bitmap, P.prefix, S.seg, S.tmp);
  }
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
  const int* prefix;         // each segment's rank offset
  const long long* p;        // [m]
  int m, n, cpg;             // cpg: channels a block
  int vec;                   // 16-byte stores: rows 16-byte aligned
  void* out;                 // [m, n] at BYTES a word
};

struct StoreShared {
  uint32_t bits[kSegWords];
  int wrank[kSegWords];
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
  // the advance, the segment's rank offset and bitmap words loaded
  // together; then each word's rank within the segment (a thread a word)
  // and the segment's hit count
  const long long a = P.adv != nullptr ? *P.adv : 1;
  const int rank0 = P.prefix[s];
  if (t < nw) S.bits[t] = P.bitmap[s * kSegWords + t];
  if (a == -1) {                        // the guard: every word all ones
    for (int c = c_lo; c < c_hi; ++c)
      store_row<BYTES>(out + (static_cast<size_t>(c) * P.n + x0) * BYTES,
                       len, P.vec, [](int) { return static_cast<W>(kM); });
    return;
  }
  __syncthreads();
  if (t < nw) {
    int run = 0;
    for (int w = 0; w < t; ++w) run += __popc(S.bits[w]);
    S.wrank[t] = run;
    if (t == nw - 1) S.count = run + __popc(S.bits[t]);
  }
  __syncthreads();
  // the sign words of ranks [rank0, rank0 + count): words g0.. of the
  // stream at nonce (S5) or nonce + fills (S6)
  const long long g0 = P.sign_off + rank0;
  const int cnt = S.count;
  if (cnt > 0) {
    const uint64_t nonce = nfl_salsa::nonce_of(
        P.s.nonce_dev, P.s.nonce_add, P.adv != nullptr ? a - 1 : 0);
    const long long b_lo = g0 >> 3, b_hi = (g0 + cnt + 7) >> 3;
    for (long long b = b_lo + t; b < b_hi; b += kStoreThreads) {
      uint32_t x[16];
      salsa_block(P.s.key, nonce, static_cast<uint64_t>(b), x);
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

// S5's threshold: a key is a candidate when at most thr; about e = h +
// 8 sqrt(h) + 16 keys of n are, so fewer than h only some 8 standard
// deviations below the mean (then the last CTA selects among all keys);
// every key when e >= n.  slots: a CTA's share of e with the same margin.
struct Threshold {
  unsigned long long thr;
  int slots;
  double expect;
};

Threshold threshold_for(int n, int h, int len) {
  Threshold th;
  th.expect = h + 8.0 * std::sqrt(static_cast<double>(h)) + 16.0;
  if (th.expect >= n) {
    th.expect = n;
    th.thr = kM;
    th.slots = len;
    return th;
  }
  const double f = th.expect / n * 18446744073709551616.0;   // * 2^64
  th.thr = f >= 18446744073709551615.0 ? kM
                                       : static_cast<unsigned long long>(f);
  const double per = th.expect * len / n;
  const int slots = static_cast<int>(std::ceil(per + 8.0 * std::sqrt(per)
                                               + 16.0));
  th.slots = slots < len ? slots : len;
  return th;
}

// a call's plan: the instance (S6: the persistent reservoir; S5: its
// expected candidates few enough for the last CTA's shared memory), the
// kernels it launches, the first launch's CTAs, threads and dynamic
// shared memory, and its scratch's parts (byte offsets)
struct Plan {
  bool fast;
  int kernels, grid, threads;
  int len;                   // S5: keys a CTA
  Threshold th;              // S5
  long long w, rec, hit, keys, ckey, cidx, ccnt, bits, prefix, smid, bytes,
      smem;
};

Plan plan_for(bool exact, int n, int h, bool words_in, long long cap) {
  Plan pl{};
  long long off = 0;
  auto take = [&](long long b) {
    const long long at = off;
    off += align16(b);
    return at;
  };
  if (exact) {
    const ExactShape e = exact_shape(n, h, words_in);
    pl.fast = h <= cap && h <= kMaxPartialH;
    pl.threads = kThreads;
    const long long staged = 64LL * kThreads;   // 8 words a thread
    if (pl.fast) {
      const int g = (e.units + kUnitsPerCta - 1) / kUnitsPerCta;
      pl.grid = g < kMaxGroups ? g : kMaxGroups;
      pl.kernels = 2;
      pl.smem = kWalkHead + (staged > 4LL * h ? staged : 4LL * h);
    } else {
      const int g = (e.units + kThreads - 1) / kThreads;
      pl.grid = g < kMaxGroups ? g : kMaxGroups;
      pl.kernels = 3;
      pl.smem = kWalkHead + staged;
      pl.hit = take(4LL * h);
    }
    pl.w = words_in ? 0 : take(8LL * e.wtot);
    pl.rec = take(4LL * pl.grid * (1 + kMaxAmbCap));
  } else {
    pl.len = n < kSeg ? n : kSeg;
    pl.grid = n / pl.len;
    pl.th = threshold_for(n, h, pl.len);
    pl.fast = pl.th.expect <= cap;
    pl.kernels = 2;
    // the selection among all n keys, when the plan expects it, at n / 16
    // threads a CTA
    pl.threads = pl.fast ? 256 : pow2_at_least(n / 16, 256, kMaxThreads);
    const long long cands = static_cast<long long>(pl.grid) * pl.th.slots;
    pl.smem = kSelectHead + 16 * (cap < kMaxCandCap ? cap : kMaxCandCap);
    pl.keys = words_in ? 0 : take(8LL * n);
    pl.ckey = take(8 * cands);
    pl.cidx = take(4 * cands);
    pl.ccnt = take(4LL * pl.grid);
  }
  pl.bits = take(4LL * ((n + 31) / 32));
  pl.prefix = take(4LL * ((n + kSeg - 1) / kSeg));
  pl.smid = take(4LL * pl.grid);
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
                 const uint32_t* bitmap, const int* prefix, const void* p,
                 int m, int n, int bytes, void* out, int device,
                 cudaStream_t st) {
  Store P{};
  P.s = s;
  P.adv = adv;
  P.sign_off = sign_off;
  P.bitmap = bitmap;
  P.prefix = prefix;
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

// ctypes entry: the bytes of a stream's persistent state, which the
// caller zeroes once and passes to every call on that stream
extern "C" long long nfl_hwt_state_bytes() { return kStateBytes; }

// ctypes entry: a call's plan.  exact: S6 (1) or S5 (0); words_in: the
// words-in instance; cap: S6, the largest h of the persistent-reservoir
// instance; S5, the most candidates the last CTA selects among in shared
// memory (beyond, or with too few, it selects among all n keys).  out:
// [the fast instance (S6's persistent reservoir; S5's expected
// candidates within cap), scratch bytes, kernels launched, the first
// launch's CTAs, the byte offset of their SM ids in the scratch].
extern "C" void nfl_hwt_plan(int exact, int n, int h, int words_in,
                             long long cap, long long* out) {
  const Plan pl = plan_for(exact != 0, n, h, words_in != 0, cap);
  out[0] = pl.fast;
  out[1] = pl.bytes;
  out[2] = pl.kernels;
  out[3] = pl.grid;
  out[4] = pl.smid;
}

// ctypes entry, S6: the stream-exact hwt sampler.  key: 8 host words;
// nonce_dev: a device int64 or null; nonce_add: added to it; words: the
// words-in instance's [nf * h] uint64 reservoir words, or null (the
// keystream); amb_cap: the most ambiguous words resolved (0..64); p: [m]
// int64 moduli; out: [m, n] words of out_bytes; adv: one int64, the
// advance (fills + 1, or -1); scratch: nfl_hwt_plan's bytes; state: the
// stream's persistent words (kStateBytes, zeroed once: the ticket, then
// the reservoir), as they were left by the last launch; cap: as
// nfl_hwt_plan's.  All device pointers; device: the current device.
// Returns the cudaError_t of the launches (0 on success), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int nfl_hwt_exact(const uint32_t* key, const void* nonce_dev,
                             unsigned long long nonce_add, const void* words,
                             int n, int h, int amb_cap, const void* p, int m,
                             int out_bytes, void* out, void* adv,
                             void* scratch, void* state, long long cap,
                             int device, void* stream) {
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
  P.groups = pl.grid;
  P.rec = reinterpret_cast<int*>(base + pl.rec);
  P.res = reinterpret_cast<int*>(static_cast<unsigned char*>(state)
                                 + kStateHead);
  P.hit = reinterpret_cast<int*>(base + pl.hit);
  P.bitmap = reinterpret_cast<uint32_t*>(base + pl.bits);
  P.prefix = reinterpret_cast<int*>(base + pl.prefix);
  P.smid = reinterpret_cast<int*>(base + pl.smid);
  P.ticket = static_cast<unsigned*>(state);
  P.adv = static_cast<long long*>(adv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.fast) {
    hwt_partial_kernel<<<pl.grid, kThreads, pl.smem, st>>>(P);
  } else {
    hwt_words_kernel<<<pl.grid, kThreads, pl.smem, st>>>(P);
    const unsigned rb = static_cast<unsigned>(
        (e.wtot + 8 * kThreads - 1) / (8 * kThreads));
    hwt_reservoir_kernel<<<rb, kThreads, kWalkHead, st>>>(P);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_store(P.s, P.adv, 0, P.bitmap, P.prefix, p, m, n, out_bytes,
                      out, device, st);
}

// ctypes entry, S5: the fixed-consumption hwt sampler.  words: the
// words-in instance's [n] uint64 keys, or null (the keystream's); cap: as
// nfl_hwt_plan's; the rest as nfl_hwt_exact's.
extern "C" int nfl_hwt_fixed(const uint32_t* key, const void* nonce_dev,
                             unsigned long long nonce_add, const void* words,
                             int n, int h, const void* p, int m,
                             int out_bytes, void* out, void* scratch,
                             void* state, long long cap, int device,
                             void* stream) {
  if (bad_shape(n, h, m, out_bytes) || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool words_in = words != nullptr;
  const Plan pl = plan_for(false, n, h, words_in, cap);
  auto* base = static_cast<unsigned char*>(scratch);
  Select P{};
  P.s = stream_of(key, nonce_dev, nonce_add);
  P.keys_in = static_cast<const uint64_t*>(words);
  P.keys = words_in ? nullptr : reinterpret_cast<uint64_t*>(base + pl.keys);
  P.store_keys = !pl.fast && !words_in;
  P.n = n;
  P.log_n = log2_of(n);
  P.h = h;
  P.len = pl.len;
  P.thr = pl.th.thr;
  while (P.thr_bits < 64 && (P.thr >> P.thr_bits) != 0) ++P.thr_bits;
  P.slots = pl.th.slots;
  P.cand_max = static_cast<int>(cap < kMaxCandCap ? cap : kMaxCandCap);
  P.ckey = reinterpret_cast<uint64_t*>(base + pl.ckey);
  P.cidx = reinterpret_cast<int*>(base + pl.cidx);
  P.ccnt = reinterpret_cast<int*>(base + pl.ccnt);
  P.bitmap = reinterpret_cast<uint32_t*>(base + pl.bits);
  P.prefix = reinterpret_cast<int*>(base + pl.prefix);
  P.smid = reinterpret_cast<int*>(base + pl.smid);
  P.ticket = static_cast<unsigned*>(state);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  hwt_cand_kernel<<<pl.grid, pl.threads, pl.smem, st>>>(P);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_store(P.s, nullptr, n, P.bitmap, P.prefix, p, m, n,
                      out_bytes, out, device, st);
}
