// Harvey butterfly NTT stage loop, shared by the butterfly NTT kernels
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
// (nfllib_tpu_torch/ops/ntt.py:_stages) on every input.
//
// Design: one block per (polynomial, channel, segment) keeps a segment of
// S = 2^kLocalLog words (or the whole polynomial, if shorter) in dynamic
// shared memory and runs every stage that pairs elements inside it, one
// __syncthreads per stage.  The butterfly's twiddles are read from the
// blocked tables [m, n-1] through L2.  A u32 polynomial of the largest
// degree (2^15) takes 128 KB; a u64 polynomial above 2^14 words would take
// more than the 227 KB a block may have, so the first log2(n / 2^14) forward
// stages, after which the segments are independent, run as one launch
// each through device memory (bfly_global, one thread per butterfly), and
// the inverse runs its local stages first and those stages last.  The
// twist is applied as the first global stage loads its inputs; the untwist
// and strict reduction as the last global inverse stage stores.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// Everything here has internal linkage (the unnamed namespace): each source
// that includes this header gets its own kernels.
namespace nflbf {
namespace {

// Word traits: storage type S, register type T, wrap to the limb's width.
struct U16 {
  using S = uint16_t;
  using T = uint32_t;
  static constexpr int kLocalLog = 15;
  __device__ static T wrap(T v) { return v & 0xFFFFu; }
  __device__ static T mulhi(T a, T b) { return (a * b) >> 16; }
  __device__ static T mulmod(T a, T b, T p, T) {
    return static_cast<T>((static_cast<uint64_t>(a) * b) % p);
  }
};

struct U32 {
  using S = uint32_t;
  using T = uint32_t;
  static constexpr int kLocalLog = 15;
  __device__ static T wrap(T v) { return v; }
  __device__ static T mulhi(T a, T b) { return __umulhi(a, b); }
  __device__ static T mulmod(T a, T b, T p, T) {
    return static_cast<T>((static_cast<uint64_t>(a) * b) % p);
  }
};

struct U64 {
  using S = uint64_t;
  using T = uint64_t;
  static constexpr int kLocalLog = 14;
  __device__ static T wrap(T v) { return v; }
  __device__ static T mulhi(T a, T b) { return __umul64hi(a, b); }
  // Newton-quotient reduction of the 128-bit product (the port's
  // modops._mulmod64, reference ops.hpp:201-219); canonical result
  __device__ static T mulmod(T a, T b, T p, T pn) {
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

// The tables of one direction for all channels, in the storage type.
template <class W>
struct Tables {
  const typename W::S* w;    // [m, n-1] blocked twiddles (omega or omega^-1)
  const typename W::S* ws;   // their Shoup companions
  const typename W::S* tw;   // [m, n] phi^i, or n^-1 phi^-i for the inverse
  const typename W::S* tws;
  const typename W::S* p;    // [m]
  const typename W::S* pn;   // [m] Newton quotients (u64 mulmod), or null
};

// What a local block does as it loads and as it stores.
enum Prologue : int {
  kLoad = 0,      // x = src
  kTwist = 1,     // x = reduce(shoup(src, phi^i))
  kDecrypt = 2,   // x = src2 - reduce(shoup(src, op0 by op1)) mod p
};
enum Epilogue : int {
  kStore = 0,     // optional untwist, optional strict reduction
  kEncrypt = 1,   // dst = reduce(x) + aux * op0 mod p
};

struct LocalArgs {
  const void* src;    // [B, m, n]
  const void* src2;   // [B, m, n] (kDecrypt: resb)
  void* dst;          // [B, m, n]; may alias src, src2 or aux
  const void* aux;    // [B, m, n] (kEncrypt: the transformed u)
  const void* op0;    // [m, n] (kDecrypt: s; kEncrypt: pka or pkb)
  const void* op1;    // [m, n] (kDecrypt: s')
  int prologue, epilogue;
  bool untwist, strict;
};

constexpr int kMaxThreads = 1024;

// One block per (segment, channel, polynomial).  The block owns stages
// [s_lo, log_n) of its segment of S = n >> s_lo words: forward in order,
// inverse (INV) in reverse.  Every element is read, and written, by one
// thread of one block, so dst may alias an input.
template <class W, bool INV>
__global__ void __launch_bounds__(kMaxThreads)
    bfly_local(LocalArgs a, Tables<W> t, int m, int log_n, int s_lo) {
  using T = typename W::T;
  using S = typename W::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x = reinterpret_cast<T*>(smem_raw);

  const int seg = blockIdx.x, ch = blockIdx.y, b = blockIdx.z;
  const int n = 1 << log_n;
  const int log_s = log_n - s_lo;
  const int len = 1 << log_s;
  const size_t row = (static_cast<size_t>(b) * m + ch) * n;
  const size_t base = row + static_cast<size_t>(seg) * len;
  const size_t tab =
      static_cast<size_t>(ch) * n + static_cast<size_t>(seg) * len;
  const T p = t.p[ch];

  const S* src = static_cast<const S*>(a.src);
  for (int l = threadIdx.x; l < len; l += blockDim.x) {
    T v = src[base + l];
    if (a.prologue == kTwist) {
      v = sub_if_ge<W>(shoup_lazy<W>(v, t.tw[tab + l], t.tws[tab + l], p), p);
    } else if (a.prologue == kDecrypt) {
      const S* op0 = static_cast<const S*>(a.op0);
      const S* op1 = static_cast<const S*>(a.op1);
      const T prod =
          sub_if_ge<W>(shoup_lazy<W>(v, op0[tab + l], op1[tab + l], p), p);
      const T rb = static_cast<const S*>(a.src2)[base + l];
      v = sub_if_ge<W>(W::wrap(rb + W::wrap(p - prod)), p);
    }
    x[l] = v;
  }
  __syncthreads();

  const size_t wrow = static_cast<size_t>(ch) * (n - 1);
  const int pairs = len >> 1;
  for (int k = 0; k < log_s; ++k) {
    const int s = INV ? log_n - 1 - k : s_lo + k;
    const int log_half = log_n - s - 1;
    const int half = 1 << log_half;
    const size_t off = wrow + (n - (n >> s));
    for (int j = threadIdx.x; j < pairs; j += blockDim.x) {
      const int i = j & (half - 1);
      const int l0 = ((j >> log_half) << (log_half + 1)) + i;
      T u0 = x[l0], u1 = x[l0 + half];
      const T w = t.w[off + i], ws = t.ws[off + i];
      if (INV)
        inv_bfly<W>(u0, u1, w, ws, p);
      else
        fwd_bfly<W>(u0, u1, w, ws, p);
      x[l0] = u0;
      x[l0 + half] = u1;
    }
    __syncthreads();
  }

  S* dst = static_cast<S*>(a.dst);
  for (int l = threadIdx.x; l < len; l += blockDim.x) {
    T v = x[l];
    if (a.epilogue == kEncrypt) {
      const T un = static_cast<const S*>(a.aux)[base + l];
      const T pk = static_cast<const S*>(a.op0)[tab + l];
      const T pn = t.pn == nullptr ? T(0) : t.pn[ch];
      v = sub_if_ge<W>(W::wrap(sub_if_ge<W>(v, p) + W::mulmod(un, pk, p, pn)),
                       p);
    } else {
      if (a.untwist) v = shoup_lazy<W>(v, t.tw[tab + l], t.tws[tab + l], p);
      if (a.strict) v = sub_if_ge<W>(v, p);
    }
    dst[base + l] = static_cast<S>(v);
  }
}

// One stage s of all (polynomial, channel) rows through device memory, one
// thread per butterfly.  Forward: `twist` applies the phi^i pre-twist to
// both inputs (stage 0).  Inverse: `untwist` and `strict` finish the
// outputs (stage 0).  src may equal dst.
template <class W, bool INV>
__global__ void bfly_global(const typename W::S* src, typename W::S* dst,
                            Tables<W> t, int m, int log_n, int s, bool twist,
                            bool untwist, bool strict, size_t total) {
  using T = typename W::T;
  const size_t g = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int n = 1 << log_n;
  const size_t rowid = g >> (log_n - 1);
  const int j = static_cast<int>(g & ((n >> 1) - 1));
  const int ch = static_cast<int>(rowid % m);
  const int log_half = log_n - s - 1;
  const int half = 1 << log_half;
  const int i = j & (half - 1);
  const int l0 = ((j >> log_half) << (log_half + 1)) + i, l1 = l0 + half;
  const size_t row = rowid * n;
  const size_t tab = static_cast<size_t>(ch) * n;
  const T p = t.p[ch];
  T u0 = src[row + l0], u1 = src[row + l1];
  const size_t off = static_cast<size_t>(ch) * (n - 1) + (n - (n >> s)) + i;
  if (!INV) {
    if (twist) {
      u0 = sub_if_ge<W>(shoup_lazy<W>(u0, t.tw[tab + l0], t.tws[tab + l0], p),
                        p);
      u1 = sub_if_ge<W>(shoup_lazy<W>(u1, t.tw[tab + l1], t.tws[tab + l1], p),
                        p);
    }
    fwd_bfly<W>(u0, u1, t.w[off], t.ws[off], p);
  } else {
    inv_bfly<W>(u0, u1, t.w[off], t.ws[off], p);
    if (untwist) {
      u0 = shoup_lazy<W>(u0, t.tw[tab + l0], t.tws[tab + l0], p);
      u1 = shoup_lazy<W>(u1, t.tw[tab + l1], t.tws[tab + l1], p);
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

template <class W, bool INV>
cudaError_t launch_local(const LocalArgs& a, const Tables<W>& t, int batch,
                         int m, int log_n, int s_lo, cudaStream_t st) {
  const int log_s = log_n - s_lo;
  const int len = 1 << log_s;
  const int threads = len / 2 < kMaxThreads ? len / 2 : kMaxThreads;
  const size_t smem = static_cast<size_t>(len) * sizeof(typename W::T);
  cudaError_t err = cudaFuncSetAttribute(
      bfly_local<W, INV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bfly_local<W, INV><<<dim3(1u << s_lo, m, batch), threads, smem, st>>>(
      a, t, m, log_n, s_lo);
  return cudaGetLastError();
}

template <class W, bool INV>
cudaError_t launch_global(const typename W::S* src, typename W::S* dst,
                          const Tables<W>& t, int batch, int m, int log_n,
                          int s, bool twist, bool untwist, bool strict,
                          cudaStream_t st) {
  constexpr int kThreads = 256;
  const size_t total = static_cast<size_t>(batch) * m << (log_n - 1);
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  bfly_global<W, INV><<<blocks, kThreads, 0, st>>>(
      src, dst, t, m, log_n, s, twist, untwist, strict, total);
  return cudaGetLastError();
}

// The forward transform of src into dst: global stages, then local blocks
// with epilogue `e` (kStore with `strict`, or kEncrypt).  `stage` receives
// the global stages (it may equal dst, not src unless src is dst).
template <class W>
cudaError_t forward(const typename W::S* src, typename W::S* stage,
                    LocalArgs e, bool twist, const Tables<W>& t, int batch,
                    int m, int log_n, cudaStream_t st) {
  const int g = global_stages<W>(log_n);
  const typename W::S* cur = src;
  for (int s = 0; s < g; ++s) {
    cudaError_t err = launch_global<W, false>(cur, stage, t, batch, m, log_n,
                                              s, twist && s == 0, false,
                                              false, st);
    if (err != cudaSuccess) return err;
    cur = stage;
  }
  e.src = cur;
  e.prologue = twist && g == 0 ? kTwist : kLoad;
  e.untwist = false;
  return launch_local<W, false>(e, t, batch, m, log_n, g, st);
}

// The inverse transform: local blocks with prologue `e.prologue` (kLoad or
// kDecrypt) from e.src into e.dst, then global stages in place in e.dst,
// the untwist and strict reduction with the last stage.
template <class W>
cudaError_t inverse(LocalArgs e, bool untwist, bool strict,
                    const Tables<W>& t, int batch, int m, int log_n,
                    cudaStream_t st) {
  const int g = global_stages<W>(log_n);
  e.epilogue = kStore;
  e.untwist = untwist && g == 0;
  e.strict = strict && g == 0;
  cudaError_t err = launch_local<W, true>(e, t, batch, m, log_n, g, st);
  typename W::S* dst = static_cast<typename W::S*>(e.dst);
  for (int s = g - 1; s >= 0 && err == cudaSuccess; --s)
    err = launch_global<W, true>(dst, dst, t, batch, m, log_n, s, false,
                                 untwist && s == 0, strict && s == 0, st);
  return err;
}

template <class W>
Tables<W> make_tables(const void* w, const void* ws, const void* tw,
                      const void* tws, const void* p, const void* pn) {
  using S = typename W::S;
  return Tables<W>{static_cast<const S*>(w),   static_cast<const S*>(ws),
                   static_cast<const S*>(tw),  static_cast<const S*>(tws),
                   static_cast<const S*>(p),   static_cast<const S*>(pn)};
}

}  // namespace
}  // namespace nflbf
