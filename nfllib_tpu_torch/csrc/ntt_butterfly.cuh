// Harvey butterfly NTT stage engine, shared by the butterfly NTT kernels
// (ntt_butterfly.cu, K3/K7) and the LWE chain kernels (lwe_chain.cu, K6/K8).
//
// Math: the same lazy [0, 2p) Harvey/Shoup stages as the JAX package's
// nfllib_tpu/ops/ntt_pallas.py:_ntt_kernel and ntt_pallas_u64.py:_ntt_kernel,
// in the word of the limb, wrapping:
//   forward stage s (half = n >> (s+1), twiddle w = table[n - (n >> s) + i]):
//     t0 = u0 + u1, minus 2p if >= 2p
//     t1 = u0 - u1 + 2p
//     x1 = t1*w - hi(t1*w')*p                 (w' = floor(w 2^bits / p))
//   inverse stage s (the forward stages undone last to first, no bit
//   reversal, with the omega^-1 tables: (A, B) -> (2a, 2b)):
//     v  = B*w - hi(B*w')*p
//     a  = A + v, minus 2p if >= 2p;  b = A - v + 2p, minus 2p if >= 2p
//   twist   x -> x*phi^i (Shoup, reduced to [0, p)) before the forward stages;
//   untwist x -> x*n^-1*phi^-i (Shoup, lazy) after the inverse stages;
//   strict  one conditional subtraction of p at the end.
// u32 takes hi from __umulhi and u64 from __umul64hi; u16 computes in 32-bit
// registers with every sum and product masked to 16 bits, so its results
// equal the 16-bit word arithmetic of the plain twin
// (nfllib_tpu_torch/ops/ntt.py:_stages) on every input.  Every butterfly
// pairs the same two words, with the same twiddle and in the same stage
// order, as the twin's stage loop, so every intermediate lazy value equals
// the twin's.  The exact products a*b mod p of the chains' epilogues:
// u16/u32 by K9's small-p part reduction, q = hi64(a*b * floor(2^64/p)),
// which is floor(a*b/p) or one less for every p < 2^31 and every 64-bit
// product, then one conditional subtraction; u64 by the reference's Newton
// quotient.  No division or remainder runs on the device.
//
// Design: one block per (polynomial, channel, segment) owns a segment of
// len = 2^LOG_LEN words (the whole polynomial, or for u64 above 2^14 a
// segment of 2^14 after the leading stages). LOG_LEN is a template
// argument, dispatched once on the host, so every loop below unrolls and
// every index is a shift or mask of constants. 512 threads a block at most
// (one group of 16 a thread in a full round, two at n = 2^14). The stages
// run in rounds of up to four (radix 16): in a round each thread loads a
// group of 16 words that the round's stages pair only among themselves
// (stride h_last, the round's last half), runs the round's stages on them
// in registers, and stores them back, in place; one __syncthreads separates
// two rounds. At n = 2^14 that is 4 rounds (4 + 4 + 4 + 2 stages), 3
// barriers, and each word through shared memory 3 times. The first round
// reads device memory through the prologue (load, twist, decrypt's resb -
// resa*s) and the last round writes device memory through the epilogue, so
// shared memory holds the segment only between rounds. Shared memory is
// XOR-swizzled by 32-word row (p ^ ((p >> 5) & 31)), which keeps every
// round's accesses at one wavefront (u32; two for 8-byte words) but one
// round at two. A round's twiddles come from a stage-major table of (w, w')
// pairs, one 8-byte (u32) or 16-byte (u64) load a pair, 15 pairs a group of
// 16 words in four stages; the twist and untwist tables are paired the same
// way. Shared memory holds len words: a u32 2^14 block (64 KB, 64 registers
// a thread) shares its SM with another; a u32 2^15 or u64 2^14 block (128
// KB, up to 128 registers) has the SM alone, and fills it with the
// independent butterflies of its 16 warps' groups (8 a stage each) in place
// of more blocks: the register file (256 KB) could not hold two such
// blocks' groups either. A u64 polynomial above 2^14 words does not fit:
// its first log2(n / 2^14) forward stages, after which the segments are
// independent, run as one launch each through device memory (bfly_global,
// one thread per butterfly), and the inverse runs its local stages first
// and those stages last.

#pragma once

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

// Everything here has internal linkage (the unnamed namespace): each source
// that includes this header gets its own kernels.
namespace nflbf {
namespace {

// a*b mod p, exact for p < 2^31 and any 64-bit a*b: bm = floor(2^64/p)
__device__ __forceinline__ uint32_t barrett64(uint32_t a, uint32_t b,
                                              uint32_t p, uint64_t bm) {
  const uint64_t v = static_cast<uint64_t>(a) * b;
  const uint32_t r = static_cast<uint32_t>(v - __umul64hi(v, bm) * p);
  return r >= p ? r - p : r;
}

// Word traits: storage type S, register type T, a (w, w') pair as one load
// (Pair), wrap to the limb's width, the exact product mod p.
struct U16 {
  using S = uint16_t;
  using T = uint32_t;
  using Pair = uint32_t;                 // w in the low half, w' the high
  static constexpr int kLocalLog = 9;    // u16 degrees stop at 512
  __device__ static T wrap(T v) { return v & 0xFFFFu; }
  __device__ static T mulhi(T a, T b) { return (a * b) >> 16; }
  __device__ static void unpair(Pair v, T& w, T& ws) {
    w = v & 0xFFFFu;
    ws = v >> 16;
  }
  // red: floor(2^64/p)
  __device__ static T mulmod(T a, T b, T p, uint64_t red) {
    return barrett64(a, b, p, red);
  }
};

struct U32 {
  using S = uint32_t;
  using T = uint32_t;
  using Pair = uint2;
  static constexpr int kLocalLog = 15;
  __device__ static T wrap(T v) { return v; }
  __device__ static T mulhi(T a, T b) { return __umulhi(a, b); }
  __device__ static void unpair(Pair v, T& w, T& ws) {
    w = v.x;
    ws = v.y;
  }
  __device__ static T mulmod(T a, T b, T p, uint64_t red) {
    return barrett64(a, b, p, red);
  }
};

struct U64 {
  using S = uint64_t;
  using T = uint64_t;
  using Pair = ulonglong2;
  static constexpr int kLocalLog = 14;
  __device__ static T wrap(T v) { return v; }
  __device__ static T mulhi(T a, T b) { return __umul64hi(a, b); }
  __device__ static void unpair(Pair v, T& w, T& ws) {
    w = v.x;
    ws = v.y;
  }
  // Newton-quotient reduction of the 128-bit product (the port's
  // modops._mulmod64, reference ops.hpp:201-219), red = pn; canonical
  __device__ static T mulmod(T a, T b, T p, uint64_t pn) {
    const T hi = __umul64hi(a, b), lo = a * b;
    const T s_hi = (hi << 2) | (lo >> 62), s_lo = lo << 2;
    const T q_lo = pn * hi + s_lo;
    const T q_hi = __umul64hi(pn, hi) + s_hi + (q_lo < s_lo ? 1 : 0);
    const T r = lo - q_hi * p;
    return r >= p ? r - p : r;
  }
};

template <class W>
__device__ __forceinline__ typename W::T sub_if_ge(typename W::T x,
                                                   typename W::T b) {
  return x >= b ? x - b : x;
}

// x*w mod p by Shoup, lazy [0, 2p), for any word x
template <class W>
__device__ __forceinline__ typename W::T shoup_lazy(typename W::T x,
                                                    typename W::T w,
                                                    typename W::T ws,
                                                    typename W::T p) {
  return W::wrap(x * w - W::mulhi(x, ws) * p);
}

template <class W>
__device__ __forceinline__ typename W::T shoup_pair(typename W::T x,
                                                    typename W::Pair pr,
                                                    typename W::T p) {
  typename W::T w, ws;
  W::unpair(pr, w, ws);
  return shoup_lazy<W>(x, w, ws, p);
}

template <class W>
__device__ __forceinline__ void fwd_bfly(typename W::T& a, typename W::T& b,
                                         typename W::T w, typename W::T ws,
                                         typename W::T p) {
  using T = typename W::T;
  const T two_p = p + p;
  const T t0 = sub_if_ge<W>(W::wrap(a + b), two_p);
  const T t1 = W::wrap(a - b + two_p);
  b = shoup_lazy<W>(t1, w, ws, p);
  a = t0;
}

template <class W>
__device__ __forceinline__ void inv_bfly(typename W::T& a, typename W::T& b,
                                         typename W::T w, typename W::T ws,
                                         typename W::T p) {
  using T = typename W::T;
  const T two_p = p + p;
  const T v = shoup_lazy<W>(b, w, ws, p);
  b = sub_if_ge<W>(W::wrap(a - v + two_p), two_p);
  a = sub_if_ge<W>(W::wrap(a + v), two_p);
}

template <int BYTES>
struct Vec;
template <>
struct Vec<4> { using type = uint32_t; };
template <>
struct Vec<8> { using type = uint2; };
template <>
struct Vec<16> { using type = uint4; };

// x[t] = p[t << LS] for t < N; contiguous words (LS = 0) in 16-byte (or
// smaller, as many as there are) vector loads.
template <int LS, class S, class T, int N>
__device__ __forceinline__ void gather(const S* p, T (&x)[N]) {
  if constexpr (LS == 0) {
    constexpr int kBytes = N * sizeof(S) < 16 ? N * sizeof(S) : 16;
    constexpr int kPer = kBytes / sizeof(S);
    using V = typename Vec<kBytes>::type;
#pragma unroll
    for (int v = 0; v < N / kPer; ++v) {
      const V val = *reinterpret_cast<const V*>(p + v * kPer);
      S w[kPer];
      memcpy(w, &val, kBytes);
#pragma unroll
      for (int k = 0; k < kPer; ++k) x[v * kPer + k] = w[k];
    }
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) x[t] = p[t << LS];
  }
}

// p[t << LS] = x[t] for t < N, as gather.
template <int LS, class S, class T, int N>
__device__ __forceinline__ void scatter(S* p, const T (&x)[N]) {
  if constexpr (LS == 0) {
    constexpr int kBytes = N * sizeof(S) < 16 ? N * sizeof(S) : 16;
    constexpr int kPer = kBytes / sizeof(S);
    using V = typename Vec<kBytes>::type;
#pragma unroll
    for (int v = 0; v < N / kPer; ++v) {
      S w[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) w[k] = static_cast<S>(x[v * kPer + k]);
      V val;
      memcpy(&val, w, kBytes);
      *reinterpret_cast<V*>(p + v * kPer) = val;
    }
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) p[t << LS] = static_cast<S>(x[t]);
  }
}

// The tables of one direction for all channels.
template <class W>
struct Tables {
  using Pair = typename W::Pair;
  const Pair* wp;    // [m, n-1] (w, w') pairs of the blocked twiddles (omega
                     // or omega^-1), stage s at n - (n >> s)
  const Pair* twp;   // [m, n] (tw, tw') pairs of phi^i, or n^-1 phi^-i
  const typename W::S* p;   // [m]
  const uint64_t* red;  // [m] floor(2^64/p) (u16/u32) or pn (u64); or null
};

constexpr int kRadixLog = 4;           // stages a round: radix 16

template <int LOG_LEN>
struct Plan {
  static constexpr int kLen = 1 << LOG_LEN;
  static constexpr int kRounds = (LOG_LEN + kRadixLog - 1) / kRadixLog;
  // stages of round j, in forward order; the last round takes the rest
  __host__ __device__ static constexpr int stages(int j) {
    return LOG_LEN - kRadixLog * j < kRadixLog ? LOG_LEN - kRadixLog * j
                                               : kRadixLog;
  }
};

// Threads of a block: at most one group of 16 a thread in the full rounds,
// and at most 512.
__host__ __device__ constexpr int block_threads(int log_len) {
  return ((1 << log_len) >> kRadixLog) < 512 ? (1 << log_len) >> kRadixLog
                                             : 512;
}

// Blocks an SM the register budget is set for: two where two segments fit
// in shared memory beside each other (and the kernel holds no transform in
// registers), one otherwise.
__host__ __device__ constexpr int min_blocks(int log_len, int word_bytes,
                                             bool encrypt) {
  return !encrypt && (word_bytes << log_len) <= 65536 ? 2 : 1;
}

__device__ __forceinline__ int swz(int p) { return p ^ ((p >> 5) & 31); }

// What a block needs of its channel: its pair table, the full degree (the
// tables' stage offsets), the stages run before the block, the modulus.
template <class W>
struct Chan {
  const typename W::Pair* wp;   // this channel's [n-1] pairs
  int n;
  int s_lo;
  typename W::T p;
};

// The r stages of one round on a thread's group x (word t at position
// base + t * 2^LOG_HL): forward in order, inverse (INV) in reverse.  Stage
// kk pairs words t and t + span (span = 2^(r-1-kk)) with the twiddle of
// index (t mod span) * 2^LOG_HL + q of global stage s0 + kk.
template <class W, bool INV, int R, int LOG_HL, int I = 0>
__device__ __forceinline__ void round_stages(typename W::T (&x)[1 << R],
                                             const Chan<W>& c, int s0,
                                             int q) {
  if constexpr (I < R) {
    using T = typename W::T;
    constexpr int kk = INV ? R - 1 - I : I;
    constexpr int span = 1 << (R - 1 - kk);
    const int s = s0 + kk;
    const typename W::Pair* tw = c.wp + (c.n - (c.n >> s)) + q;
#pragma unroll
    for (int j = 0; j < span; ++j) {
      T w, ws;
      W::unpair(__ldg(tw + (j << LOG_HL)), w, ws);
#pragma unroll
      for (int a = 0; a < (1 << R); a += 2 * span) {
        if constexpr (INV)
          inv_bfly<W>(x[a + j], x[a + j + span], w, ws, c.p);
        else
          fwd_bfly<W>(x[a + j], x[a + j + span], w, ws, c.p);
      }
    }
    round_stages<W, INV, R, LOG_HL, I + 1>(x, c, s0, q);
  }
}

// Round J (forward numbering) of a transform in direction INV over the
// block's segment in shared memory `sm`.  The first round executed reads
// a group with load(base, ls, x) and the last writes one with
// store(base, ls, x): word t of the group x lies at base + (t << ls), ls an
// integral_constant (0: contiguous); the others read and write sm, in
// place.  A thread's groups are unrolled, or with SERIAL run one at a time
// (a loop), which keeps one group's loads in registers at once: the u64
// transforms and the encrypt chain take SERIAL, u16/u32 transforms run
// faster unrolled (tools/chip_ab_bfly.py measures both).
template <class W, int LOG_LEN, int THREADS, bool INV, bool SERIAL, int J,
          class Load, class Store>
__device__ __forceinline__ void run_round(const Chan<W>& c,
                                          typename W::T* sm, Load& load,
                                          Store& store) {
  using T = typename W::T;
  using P = Plan<LOG_LEN>;
  constexpr int r = P::stages(J);
  constexpr int k0 = kRadixLog * J;
  constexpr int log_hl = LOG_LEN - k0 - r;       // log2 of the last half
  constexpr int hl = 1 << log_hl;
  constexpr int groups = (P::kLen >> r) / THREADS;
  constexpr bool kFirst = INV ? J == P::kRounds - 1 : J == 0;
  constexpr bool kLast = INV ? J == 0 : J == P::kRounds - 1;
  static_assert(groups >= 1 && groups * THREADS == (P::kLen >> r),
                "a round's groups must fill the block");
  auto group = [&](int g) {
    const int q = g & (hl - 1);
    const int base = ((g >> log_hl) << (log_hl + r)) + q;
    T x[1 << r];
    if constexpr (kFirst) {
      load(base, std::integral_constant<int, log_hl>{}, x);
    } else {
#pragma unroll
      for (int t = 0; t < (1 << r); ++t) x[t] = sm[swz(base + (t << log_hl))];
    }
    round_stages<W, INV, r, log_hl>(x, c, c.s_lo + k0, q);
    if constexpr (kLast) {
      store(base, std::integral_constant<int, log_hl>{}, x);
    } else {
#pragma unroll
      for (int t = 0; t < (1 << r); ++t) sm[swz(base + (t << log_hl))] = x[t];
    }
  };
  if constexpr (SERIAL) {
#pragma unroll 1
    for (int gi = 0; gi < groups; ++gi) group(gi * THREADS + threadIdx.x);
  } else {
#pragma unroll
    for (int gi = 0; gi < groups; ++gi) group(gi * THREADS + threadIdx.x);
  }
  if constexpr (!kLast) __syncthreads();
}

// A whole transform: every round, in forward or inverse order.  The caller
// puts a __syncthreads between two transforms on the same `sm`.
template <class W, int LOG_LEN, int THREADS, bool INV, bool SERIAL = false,
          int E = 0, class Load, class Store>
__device__ __forceinline__ void transform(const Chan<W>& c, typename W::T* sm,
                                          Load& load, Store& store) {
  constexpr int kR = Plan<LOG_LEN>::kRounds;
  if constexpr (E < kR) {
    run_round<W, LOG_LEN, THREADS, INV, SERIAL, INV ? kR - 1 - E : E>(
        c, sm, load, store);
    transform<W, LOG_LEN, THREADS, INV, SERIAL, E + 1>(c, sm, load, store);
  }
}

// Where a block's segment lies: data offset of its row and segment, table
// offset of its channel and segment.
struct Where {
  size_t row;
  size_t tab;
  int ch;
};

template <int LOG_LEN>
__device__ __forceinline__ Where where(int m, int log_n) {
  const int seg = blockIdx.x, ch = blockIdx.y, b = blockIdx.z;
  const size_t n = size_t{1} << log_n;
  const size_t off = static_cast<size_t>(seg) << LOG_LEN;
  return Where{(static_cast<size_t>(b) * m + ch) * n + off,
               static_cast<size_t>(ch) * n + off, ch};
}

template <class W>
__device__ __forceinline__ Chan<W> chan(const Tables<W>& t, int ch, int log_n,
                                        int s_lo) {
  const int n = 1 << log_n;
  return Chan<W>{t.wp + static_cast<size_t>(ch) * (n - 1), n, s_lo,
                 static_cast<typename W::T>(t.p[ch])};
}

// What a transform kernel does as it loads and as it stores.
enum Op : int {
  kForward = 0,   // load (twist optional); store (strict optional)
  kInverse = 1,   // load; store (untwist optional, strict optional)
  kDecrypt = 2,   // load src2 - reduce(shoup(src, op0 by op1)) mod p;
                  // store as kInverse
};

struct NttArgs {
  const void* src;    // [B, m, n]
  const void* src2;   // [B, m, n] (kDecrypt: resb)
  void* dst;          // [B, m, n]; may alias src or src2
  const void* op0;    // [m, n] (kDecrypt: s)
  const void* op1;    // [m, n] (kDecrypt: s')
  bool twist, untwist, strict;
};

// The words of a group x: its length as a constant.
template <class X>
__host__ __device__ constexpr int group_len() {
  return std::extent<std::remove_reference_t<X>>::value;
}

// One transform of a block's segment, with the op's prologue and epilogue.
// Every word is read, and written, by one thread of one block, so dst may
// alias an input.
template <class W, int LOG_LEN, int OP>
__global__ void __launch_bounds__(
    block_threads(LOG_LEN), min_blocks(LOG_LEN, sizeof(typename W::T), false))
    bfly_ntt(NttArgs a, Tables<W> t, int m, int log_n, int s_lo) {
  using T = typename W::T;
  using S = typename W::S;
  using Pair = typename W::Pair;
  constexpr bool kInv = OP != kForward;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Where at = where<LOG_LEN>(m, log_n);
  const Chan<W> c = chan<W>(t, at.ch, log_n, s_lo);
  const T p = c.p;
  const Pair* twp = t.twp + at.tab;
  auto load = [&](int base, auto ls, auto& x) {
    constexpr int kLs = decltype(ls)::value;
    constexpr int N = group_len<decltype(x)>();
    gather<kLs>(static_cast<const S*>(a.src) + at.row + base, x);
    if constexpr (OP == kForward) {
      if (a.twist) {
        Pair tp[N];
        gather<kLs>(twp + base, tp);
#pragma unroll
        for (int i = 0; i < N; ++i)
          x[i] = sub_if_ge<W>(shoup_pair<W>(x[i], tp[i], p), p);
      }
    } else if constexpr (OP == kDecrypt) {
      T s0[N], s1[N], rb[N];
      gather<kLs>(static_cast<const S*>(a.op0) + at.tab + base, s0);
      gather<kLs>(static_cast<const S*>(a.op1) + at.tab + base, s1);
      gather<kLs>(static_cast<const S*>(a.src2) + at.row + base, rb);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const T prod = sub_if_ge<W>(shoup_lazy<W>(x[i], s0[i], s1[i], p), p);
        x[i] = sub_if_ge<W>(W::wrap(rb[i] + W::wrap(p - prod)), p);
      }
    }
  };
  auto store = [&](int base, auto ls, auto& x) {
    constexpr int kLs = decltype(ls)::value;
    constexpr int N = group_len<decltype(x)>();
    if constexpr (kInv) {
      if (a.untwist) {
        Pair tp[N];
        gather<kLs>(twp + base, tp);
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] = shoup_pair<W>(x[i], tp[i], p);
      }
    }
    if (a.strict) {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = sub_if_ge<W>(x[i], p);
    }
    scatter<kLs>(static_cast<S*>(a.dst) + at.row + base, x);
  };
  transform<W, LOG_LEN, block_threads(LOG_LEN), kInv, sizeof(T) == 8>(
      c, sm, load, store);
}

struct EncArgs {
  const void* u;      // [B, m, n] each (or their leading stages' output)
  const void* e1;
  const void* e2;
  const void* pka;    // [m, n]
  const void* pkb;
  void* resa;         // [B, m, n]; may alias e1's source
  void* resb;         // [B, m, n]; may alias u's source
  bool twist;         // twist as the sources load (the whole polynomial)
};

// The LWE encrypt chain of a block's segment in one pass: u's transform is
// stored (strict) into the thread's own words of resb, then e1's transform
// is stored as resa = e1n + un*pka and e2's as resb = e2n + un*pkb, each
// word's un read back by the thread that wrote it, from L2 (a block's
// segment of u is 64-128 KB, written and read within the block's life).
// Registers cannot hold it: the thread's 32-64 words of u beside a group in
// flight spill at the 128 registers of a 512-thread block (so does the
// chain with its groups unrolled, tools/chip_ab_bfly.py "enc_unrolled"),
// and the register file (256 KB an SM) is as large as a u32 2^15 or u64
// 2^14 transform.  Each word of an output is written by the thread that
// read it, after its block's last read of the aliased source.
template <class W, int LOG_LEN>
__global__ void __launch_bounds__(
    block_threads(LOG_LEN), min_blocks(LOG_LEN, sizeof(typename W::T), true))
    bfly_encrypt(EncArgs a, Tables<W> t, int m, int log_n, int s_lo) {
  using T = typename W::T;
  using S = typename W::S;
  using Pair = typename W::Pair;
  constexpr int kThreads = block_threads(LOG_LEN);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Where at = where<LOG_LEN>(m, log_n);
  const Chan<W> c = chan<W>(t, at.ch, log_n, s_lo);
  const T p = c.p;
  const uint64_t red = t.red[at.ch];
  const Pair* twp = t.twp + at.tab;
  S* resb = static_cast<S*>(a.resb) + at.row;

  auto from = [&](const void* src) {
    const S* x0 = static_cast<const S*>(src) + at.row;
    return [=](int base, auto ls, auto& x) {
      constexpr int kLs = decltype(ls)::value;
      constexpr int N = group_len<decltype(x)>();
      gather<kLs>(x0 + base, x);
      if (a.twist) {
        Pair tp[N];
        gather<kLs>(twp + base, tp);
#pragma unroll
        for (int i = 0; i < N; ++i)
          x[i] = sub_if_ge<W>(shoup_pair<W>(x[i], tp[i], p), p);
      }
    };
  };
  auto load_u = from(a.u);
  auto keep = [&](int base, auto ls, auto& x) {
    constexpr int N = group_len<decltype(x)>();
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = sub_if_ge<W>(x[i], p);
    scatter<decltype(ls)::value>(resb + base, x);
  };
  transform<W, LOG_LEN, kThreads, false, true>(c, sm, load_u, keep);

  auto combine = [&](const void* pk, void* out) {
    const S* k0 = static_cast<const S*>(pk) + at.tab;
    S* o = static_cast<S*>(out) + at.row;
    return [=](int base, auto ls, auto& x) {
      constexpr int kLs = decltype(ls)::value;
      constexpr int N = group_len<decltype(x)>();
      T u[N], k[N];
      gather<kLs>(resb + base, u);
      gather<kLs>(k0 + base, k);
#pragma unroll
      for (int i = 0; i < N; ++i)
        x[i] = sub_if_ge<W>(
            W::wrap(sub_if_ge<W>(x[i], p) + W::mulmod(u[i], k[i], p, red)),
            p);
      scatter<kLs>(o + base, x);
    };
  };
  __syncthreads();
  auto load_e1 = from(a.e1);
  auto store_a = combine(a.pka, a.resa);
  transform<W, LOG_LEN, kThreads, false, true>(c, sm, load_e1, store_a);
  __syncthreads();
  auto load_e2 = from(a.e2);
  auto store_b = combine(a.pkb, a.resb);
  transform<W, LOG_LEN, kThreads, false, true>(c, sm, load_e2, store_b);
}

// One stage s of all (polynomial, channel) rows through device memory, one
// thread per butterfly; grid (butterflies of a row / 256, m, batch).
// Forward: `twist` applies the phi^i pre-twist to both inputs (stage 0).
// Inverse: `untwist` and `strict` finish the outputs (stage 0).  src may
// equal dst.
constexpr int kGlobalThreads = 256;

template <class W, bool INV>
__global__ void bfly_global(const typename W::S* src, typename W::S* dst,
                            Tables<W> t, int m, int log_n, int s, bool twist,
                            bool untwist, bool strict) {
  using T = typename W::T;
  const int j = blockIdx.x * kGlobalThreads + threadIdx.x;
  const int ch = blockIdx.y;
  const int n = 1 << log_n;
  const int log_half = log_n - s - 1;
  const int half = 1 << log_half;
  const int i = j & (half - 1);
  const int l0 = ((j >> log_half) << (log_half + 1)) + i, l1 = l0 + half;
  const size_t row = (static_cast<size_t>(blockIdx.z) * m + ch) * n;
  const size_t tab = static_cast<size_t>(ch) * n;
  const T p = t.p[ch];
  T u0 = src[row + l0], u1 = src[row + l1];
  T w, ws;
  W::unpair(t.wp[static_cast<size_t>(ch) * (n - 1) + (n - (n >> s)) + i], w,
            ws);
  if (!INV) {
    if (twist) {
      u0 = sub_if_ge<W>(shoup_pair<W>(u0, t.twp[tab + l0], p), p);
      u1 = sub_if_ge<W>(shoup_pair<W>(u1, t.twp[tab + l1], p), p);
    }
    fwd_bfly<W>(u0, u1, w, ws, p);
  } else {
    inv_bfly<W>(u0, u1, w, ws, p);
    if (untwist) {
      u0 = shoup_pair<W>(u0, t.twp[tab + l0], p);
      u1 = shoup_pair<W>(u1, t.twp[tab + l1], p);
    }
    if (strict) {
      u0 = sub_if_ge<W>(u0, p);
      u1 = sub_if_ge<W>(u1, p);
    }
  }
  dst[row + l0] = static_cast<typename W::S>(u0);
  dst[row + l1] = static_cast<typename W::S>(u1);
}

// Stages that must go through device memory before (forward) or after
// (inverse) the local blocks.
template <class W>
__host__ inline int global_stages(int log_n) {
  return log_n > W::kLocalLog ? log_n - W::kLocalLog : 0;
}

// fn(std::integral_constant<int, LOG_LEN>) for the segment's LOG_LEN, 8 up
// to the limb's local maximum (u16 9, u32 15, u64 14); anything else is
// refused.
template <class W, class Fn>
cudaError_t by_log_len(int log_len, Fn&& fn) {
  switch (log_len) {
    case 8: return fn(std::integral_constant<int, 8>{});
    case 9: return fn(std::integral_constant<int, 9>{});
    default: break;
  }
  if constexpr (W::kLocalLog >= 14) {
    switch (log_len) {
      case 10: return fn(std::integral_constant<int, 10>{});
      case 11: return fn(std::integral_constant<int, 11>{});
      case 12: return fn(std::integral_constant<int, 12>{});
      case 13: return fn(std::integral_constant<int, 13>{});
      case 14: return fn(std::integral_constant<int, 14>{});
      default: break;
    }
  }
  if constexpr (W::kLocalLog >= 15) {
    if (log_len == 15) return fn(std::integral_constant<int, 15>{});
  }
  return cudaErrorInvalidValue;
}

// Launch `kernel` over (segments, m, batch) with `threads` threads and the
// segment's shared memory.
template <class K, class... Args>
cudaError_t launch_segments(K kernel, int threads, size_t smem, int s_lo,
                            int m, int batch, cudaStream_t st,
                            Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(1u << s_lo, m, batch), threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <class W, int OP>
cudaError_t launch_local(const NttArgs& a, const Tables<W>& t, int batch,
                         int m, int log_n, int s_lo, cudaStream_t st) {
  using T = typename W::T;
  return by_log_len<W>(log_n - s_lo, [&](auto L) {
    constexpr int kLog = decltype(L)::value;
    return launch_segments(bfly_ntt<W, kLog, OP>, block_threads(kLog),
                           sizeof(T) << kLog, s_lo, m, batch, st, a, t, m,
                           log_n, s_lo);
  });
}

template <class W, bool INV>
cudaError_t launch_global(const typename W::S* src, typename W::S* dst,
                          const Tables<W>& t, int batch, int m, int log_n,
                          int s, bool twist, bool untwist, bool strict,
                          cudaStream_t st) {
  const unsigned blocks = (1u << (log_n - 1)) / kGlobalThreads;
  bfly_global<W, INV><<<dim3(blocks, m, batch), kGlobalThreads, 0, st>>>(
      src, dst, t, m, log_n, s, twist, untwist, strict);
  return cudaGetLastError();
}

// The forward transform of src into dst: global stages (into `stage`,
// which may equal dst), then the local blocks, twisting as they load when
// there is no global stage, with the strict reduction as they store.
template <class W>
cudaError_t forward(const typename W::S* src, typename W::S* stage,
                    typename W::S* dst, bool twist, bool strict,
                    const Tables<W>& t, int batch, int m, int log_n,
                    cudaStream_t st) {
  const int g = global_stages<W>(log_n);
  const typename W::S* cur = src;
  for (int s = 0; s < g; ++s) {
    cudaError_t err = launch_global<W, false>(cur, stage, t, batch, m, log_n,
                                              s, twist && s == 0, false,
                                              false, st);
    if (err != cudaSuccess) return err;
    cur = stage;
  }
  NttArgs a{};
  a.src = cur;
  a.dst = dst;
  a.twist = twist && g == 0;
  a.strict = strict;
  return launch_local<W, kForward>(a, t, batch, m, log_n, g, st);
}

// The inverse transform (OP kInverse or kDecrypt): local blocks from a.src
// into a.dst, then global stages in place in a.dst, the untwist and strict
// reduction with the last stage.
template <class W, int OP>
cudaError_t inverse(NttArgs a, bool untwist, bool strict, const Tables<W>& t,
                    int batch, int m, int log_n, cudaStream_t st) {
  const int g = global_stages<W>(log_n);
  a.untwist = untwist && g == 0;
  a.strict = strict && g == 0;
  cudaError_t err = launch_local<W, OP>(a, t, batch, m, log_n, g, st);
  typename W::S* dst = static_cast<typename W::S*>(a.dst);
  for (int s = g - 1; s >= 0 && err == cudaSuccess; --s)
    err = launch_global<W, true>(dst, dst, t, batch, m, log_n, s, false,
                                 untwist && s == 0, strict && s == 0, st);
  return err;
}

template <class W>
Tables<W> make_tables(const void* wp, const void* twp, const void* p,
                      const void* red) {
  return Tables<W>{static_cast<const typename W::Pair*>(wp),
                   static_cast<const typename W::Pair*>(twp),
                   static_cast<const typename W::S*>(p),
                   static_cast<const uint64_t*>(red)};
}

}  // namespace
}  // namespace nflbf
