// S1: the Salsa20/20 keystream, raw or turned into a sampler's residues
// in the same launch.
//
// Replaces XLA code, not a TPU kernel: nfllib_tpu/prng/salsa20.py:
// device_stream_words (the jnp tier of salsa20_block_words) and the
// samplers that XLA fuses with it into one program each,
// nfllib_tpu/prng/device_sampling.py:65 device_uniform, :78
// device_non_uniform and :101 device_zo.  Eager torch would launch about
// 1,900 ops for the keystream alone (10 double rounds x 8 quarter-rounds x
// 4 lines x add, rotate, xor on masked int64) and 4 to 10 more over [m, n]
// for a sampler's masking and encoding.
//
// One thread computes one 64-byte keystream block (salsa20_block.cuh) and
// turns it into outputs in registers; salsa20_kernel<EPI, BYTES> has one
// instance an epilogue and limb width:
//   * kRaw: the block's 16 words.  out[f, b, :] = block b (counter b) of
//     the stream at nonce (base + off_f) mod 2^64, where base = *nonce_dev
//     (a 0-d int64 on the card, which the host never reads; 0 when null)
//     + nonce_add, and off_f = offsets[f], or f when offsets is null: the
//     bytes of Salsa20Stream(key, nonce).randombytes(64 * nblocks).
//   * kUniform (sampling.sample_uniform): the stream at base read as m * n
//     little-endian limbs of BYTES bytes in [m, n] order, 64 / BYTES a
//     block, from limb `offset` of the stream on (first * n for a channel
//     block of a ring whose channels before it are `first`: the rows
//     first .. first + m - 1 of the whole ring's draw); output limb k is
//     stream limb offset + k, in the block's channel k >> log2 n; each
//     masked to modulus_bits (c0) and reduced by one conditional
//     subtraction of p_c.  Thread i makes the stream's block offset / L + i
//     (L = 64 / BYTES limbs), so the launch makes only the blocks the rows
//     read; when offset * BYTES is not a multiple of 64 (n * BYTES < 64)
//     the first thread's run starts offset % L limbs into its block and
//     the last one's may end early, and every run's live limbs are stored
//     one at a time.
//   * kNonUniform (sample_non_uniform): n limbs; t = limb & c0 (the mask
//     of bit_length(span)), one conditional subtraction of span = c1;
//     t >= ub (c2) is negative and encodes as p_c + t * amp - span * amp
//     (amp = c3), else t * amp, in wrapping limb-width arithmetic (the
//     reference's value_type).  One limb gives one residue in every
//     channel.
//   * kZo (sample_zo): n bytes, 64 coefficients a block; a byte <= rho
//     (c0) gives p_c - 1 + (byte & 2) (+1 as the non-canonical p + 1),
//     any other 0.
// Residues are stored at the limb width (the ring's storage), each
// thread's run of 64 bytes a channel as 16-byte vector stores, which fill
// whole 32-byte sectors (nothing is staged in shared memory); a partial
// first or last block (an offset off the block grid; m * n * BYTES, n *
// BYTES or n not a multiple of 64) stores only its live limbs, one at a
// time.  The moduli come from the ring's
// device table (p, [m] int64), so there is no cap on the channels.  For
// the non-uniform and ZO samplers grid.y splits the channels into groups
// of `cpg` (the host makes enough blocks to cover the SMs when n is
// small); a group recomputes its keystream blocks, which are cheap beside
// its stores.  Index math is 32-bit: shifts and masks by n, a power of
// two, and for kRaw a multiply-shift division by nblocks (FastDiv).
//
// Bound on this card: the operations.  A block takes 10 x 8 x 4 (add,
// rotate, xor) = 960 instructions and 16 final adds for 64 bytes: its 640
// rotates and xors hold the ALU pipe (64 lanes an SM a clock) for 10
// lane-clocks a byte of keystream, while the adds can issue on the FMA
// pipe beside them; HBM's rate allows about 0.2.  The samplers write m
// residues a limb (non-uniform) or byte (ZO) of keystream, so at m = 17
// their stores reach the same order as the keystream's instructions.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "salsa20_block.cuh"

namespace {

using nfl_launch::FastDiv;
using nfl_launch::make_div;
using nfl_launch::quot;
using nfl_launch::sm_count;
using nfl_salsa::Key;

constexpr int kThreads = 128;

enum Epi : int { kRaw = 0, kUniform = 1, kNonUniform = 2, kZo = 3 };

struct Params {
  Key key;
  const long long* nonce_dev;      // null, or one int64 on the card
  unsigned long long nonce_add;
  const long long* offsets;        // kRaw: [fills] or null
  const long long* p;              // samplers: [m] moduli
  void* out;
  FastDiv nblocks;                 // kRaw: blocks a stream
  uint32_t total;                  // keystream blocks in grid.x
  uint32_t count;                  // samplers: limbs (bytes for kZo) used
  uint32_t log_n, m, cpg;          // samplers: log2 n, channels, a group
  uint32_t block0, skip;           // kUniform: the stream's block of limb
                                   // `offset`, and the limbs before it there
  unsigned long long c0, c1, c2, c3;
};

// the limb width's word: 32 bits for u16 / u32 limbs, 64 for u64
template <int BYTES>
using Word = typename std::conditional<BYTES == 8, uint64_t, uint32_t>::type;

// limb j (BYTES wide) of a block's 16 keystream words
template <int BYTES>
__device__ __forceinline__ Word<BYTES> limb(const uint32_t x[16], int j) {
  if constexpr (BYTES == 1) return (x[j >> 2] >> (8 * (j & 3))) & 0xFFu;
  if constexpr (BYTES == 2) return (x[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
  if constexpr (BYTES == 4) return x[j];
  if constexpr (BYTES == 8)
    return x[2 * j] | (static_cast<uint64_t>(x[2 * j + 1]) << 32);
}

// Stores the run of N residues val(j), j in [lo, hi), at BYTES bytes each,
// residue j at out + (k0 + j) * BYTES: as 16-byte vectors when all N are
// live and `vec` (the run is on the 16-byte grid), else the live ones one
// at a time (unrolled, so that the registers the values come from stay
// registers).
template <int BYTES, int N, class F>
__device__ __forceinline__ void store_run(char* out, int k0, int lo, int hi,
                                          bool vec, F val) {
  if (vec && lo == 0 && hi == N) {
    uint4* v = reinterpret_cast<uint4*>(out + static_cast<size_t>(k0)
                                                  * BYTES);
#pragma unroll
    for (int q = 0; q < N * BYTES / 16; ++q) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (BYTES == 2) {
          w[k] = (static_cast<uint32_t>(val(8 * q + 2 * k)) & 0xFFFFu)
                 | (static_cast<uint32_t>(val(8 * q + 2 * k + 1)) << 16);
        } else if constexpr (BYTES == 4) {
          w[k] = static_cast<uint32_t>(val(4 * q + k));
        } else {
          const uint64_t y = val(2 * q + (k >> 1));
          w[k] = static_cast<uint32_t>(k & 1 ? y >> 32 : y);
        }
      }
      v[q] = uint4{w[0], w[1], w[2], w[3]};
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j >= lo && j < hi) {
        void* dst = out + static_cast<size_t>(k0 + j) * BYTES;
        if constexpr (BYTES == 2)
          *static_cast<uint16_t*>(dst) = static_cast<uint16_t>(val(j));
        else if constexpr (BYTES == 4)
          *static_cast<uint32_t*>(dst) = static_cast<uint32_t>(val(j));
        else
          *static_cast<uint64_t*>(dst) = val(j);
      }
    }
  }
}

template <int EPI, int BYTES>
__global__ void __launch_bounds__(kThreads) salsa20_kernel(const Params P) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P.total) return;
  uint32_t x[16];
  if constexpr (EPI == kRaw) {
    const uint32_t f = quot(P.nblocks, i);
    const uint64_t nonce = nfl_salsa::nonce_of(
        P.nonce_dev, P.nonce_add,
        P.offsets != nullptr ? __ldg(P.offsets + f) : f);
    nfl_salsa::block(P.key, nonce, i - f * P.nblocks.d, x);
    uint4* dst = static_cast<uint4*>(P.out) + 4 * static_cast<size_t>(i);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = uint4{x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]};
  } else {
    using W = Word<BYTES>;
    constexpr int L = EPI == kZo ? 64 : 64 / BYTES;  // outputs a channel
    nfl_salsa::block(P.key, nfl_salsa::nonce_of(P.nonce_dev, P.nonce_add, 0),
                     EPI == kUniform ? P.block0 + i : i, x);
    // output index of the block's first limb: negative for the first
    // thread of a uniform run that starts `skip` limbs into its block
    const int k0 = static_cast<int>(i * L) - static_cast<int>(P.skip);
    const int lo = k0 < 0 ? -k0 : 0;
    const int hi = static_cast<int>(P.count) - k0 < L
                       ? static_cast<int>(P.count) - k0 : L;
    char* out = static_cast<char*>(P.out);
    if constexpr (EPI == kUniform) {
      const W mask = static_cast<W>(P.c0);
      // a block lies in one channel unless n holds fewer limbs than it
      // (only then can k0 be negative)
      const bool one = (1u << P.log_n) >= static_cast<uint32_t>(L);
      const W p0 = one ? static_cast<W>(__ldg(P.p + (k0 >> P.log_n))) : 0;
      // a run starts on the block grid unless offset * BYTES is not a
      // multiple of 64: then n * BYTES < 64, and one word at a time will do
      store_run<BYTES, L>(out, k0, lo, hi, P.skip == 0, [&](int j) {
        const W pv = one ? p0 : static_cast<W>(__ldg(P.p + ((k0 + j)
                                                             >> P.log_n)));
        const W t = limb<BYTES>(x, j) & mask;
        return t >= pv ? t - pv : t;
      });
    } else {
      const int row = 1 << P.log_n;
      const uint32_t c_lo = blockIdx.y * P.cpg;
      const uint32_t c_hi = c_lo + P.cpg < P.m ? c_lo + P.cpg : P.m;
      if constexpr (EPI == kNonUniform) {
        const W mask = static_cast<W>(P.c0), span = static_cast<W>(P.c1);
        const W ub = static_cast<W>(P.c2), amp = static_cast<W>(P.c3);
        W t[L];
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const W v = limb<BYTES>(x, j) & mask;
          t[j] = v >= span ? v - span : v;
        }
        const W neg_off = span * amp;
        for (uint32_t c = c_lo; c < c_hi; ++c) {
          const W pv = static_cast<W>(__ldg(P.p + c));
          store_run<BYTES, L>(out, k0 + static_cast<int>(c) * row, lo, hi,
                              true, [&](int j) {
            const W a = t[j] * amp;
            return t[j] >= ub ? pv + a - neg_off : a;
          });
        }
      } else {
        const uint32_t rho = static_cast<uint32_t>(P.c0);
        for (uint32_t c = c_lo; c < c_hi; ++c) {
          const W pm1 = static_cast<W>(__ldg(P.p + c)) - 1;
          store_run<BYTES, L>(out, k0 + static_cast<int>(c) * row, lo, hi,
                              true, [&](int j) {
            const uint32_t b = limb<1>(x, j);
            return b <= rho ? static_cast<W>(pm1 + (b & 2u)) : W(0);
          });
        }
      }
    }
  }
}

using KernelFn = void (*)(const Params);

template <int EPI>
KernelFn pick(int bytes) {
  return bytes == 2 ? salsa20_kernel<EPI, 2>
         : bytes == 4 ? salsa20_kernel<EPI, 4>
                      : salsa20_kernel<EPI, 8>;
}

Params base_params(const uint32_t* key, const void* nonce_dev,
                   unsigned long long nonce_add, void* out) {
  Params P{};
  for (int w = 0; w < 8; ++w) P.key.w[w] = key[w];
  P.nonce_dev = static_cast<const long long*>(nonce_dev);
  P.nonce_add = nonce_add;
  P.out = out;
  P.nblocks = make_div(1);
  return P;
}

}  // namespace

// Plain C entry point for ctypes, the raw keystream.  key: 8 host words
// (passed to the kernel by value); nonce_dev: a device int64 or null;
// nonce_add: added to it; offsets: [fills] device int64 or null (then f);
// out: [fills, nblocks, 16] device uint32, 16-byte aligned.  Returns the
// cudaError_t of the launch (0 on success), cudaErrorInvalidValue for
// 2^31 blocks or more.
extern "C" int nfl_salsa20(const uint32_t* key, const void* nonce_dev,
                           unsigned long long nonce_add, const void* offsets,
                           int fills, long long nblocks, void* out,
                           void* stream) {
  if (fills <= 0 || nblocks <= 0) return 0;
  const long long total = static_cast<long long>(fills) * nblocks;
  if (total >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  Params P = base_params(key, nonce_dev, nonce_add, out);
  P.offsets = static_cast<const long long*>(offsets);
  P.nblocks = make_div(static_cast<uint32_t>(nblocks));
  P.total = static_cast<uint32_t>(total);
  const unsigned grid = (P.total + kThreads - 1) / kThreads;
  salsa20_kernel<kRaw, 4><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point for ctypes, a sampler.  epi: 1 uniform, 2
// non-uniform, 3 ZO; bytes: the limb width (2, 4 or 8); p: [m] device
// int64 moduli; n = 2^log_n; offset: the uniform's first stream limb (the
// first channel's index times n on a channel block; 0 for the others);
// c0..c3: the epilogue's constants (uniform: the modulus mask;
// non-uniform: the mask, span, ub, amp, each mod 2^64; ZO: rho); out: [m,
// n] device residues at the limb width, 16-byte aligned; device: the
// current device (the launch runs there, on `stream`).  Returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for
// arguments out of range.
extern "C" int nfl_salsa20_sampler(int epi, int bytes, const uint32_t* key,
                                   const void* nonce_dev,
                                   unsigned long long nonce_add,
                                   const void* p, int m, int log_n,
                                   long long offset,
                                   unsigned long long c0,
                                   unsigned long long c1,
                                   unsigned long long c2,
                                   unsigned long long c3, void* out,
                                   int device, void* stream) {
  if (epi < kUniform || epi > kZo || (bytes != 2 && bytes != 4 && bytes != 8)
      || m < 1 || log_n < 0 || log_n > 30 || offset < 0
      || (epi != kUniform && offset != 0)
      || offset >= (1ll << 31)
      || (offset + (static_cast<long long>(m) << log_n)) * bytes
             >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P = base_params(key, nonce_dev, nonce_add, out);
  P.p = static_cast<const long long*>(p);
  P.m = static_cast<uint32_t>(m);
  P.log_n = static_cast<uint32_t>(log_n);
  P.c0 = c0;
  P.c1 = c1;
  P.c2 = c2;
  P.c3 = c3;
  const uint32_t n = 1u << log_n;
  P.count = epi == kUniform ? P.m * n : n;
  if (epi == kUniform) {
    // only the keystream blocks that limbs offset .. offset + m n - 1 lie in
    const uint32_t per = 64 / bytes;
    P.block0 = static_cast<uint32_t>(offset / per);
    P.skip = static_cast<uint32_t>(offset % per);
    P.total = (P.skip + P.count + per - 1) / per;
  } else {
    const uint32_t stream_bytes = epi == kNonUniform ? n * bytes : n;
    P.total = (stream_bytes + 63) / 64;
  }
  const unsigned gx = (P.total + kThreads - 1) / kThreads;
  unsigned gy = 1;
  P.cpg = P.m;
  if (epi != kUniform) {
    // channel groups until the grid has two blocks an SM
    int sms = 0;
    const cudaError_t err = sm_count(device, &sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const uint32_t want = (2u * sms + gx - 1) / gx;
    const uint32_t groups = want < P.m ? want : P.m;
    P.cpg = (P.m + groups - 1) / groups;
    gy = (P.m + P.cpg - 1) / P.cpg;
  }
  const KernelFn fn = epi == kUniform ? pick<kUniform>(bytes)
                      : epi == kNonUniform ? pick<kNonUniform>(bytes)
                                           : pick<kZo>(bytes);
  fn<<<dim3(gx, gy), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
