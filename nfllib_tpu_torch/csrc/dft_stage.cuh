// The digit-group policy of the square mod-p matmul kernels K5
// (dft_mxu64.cu), K9 (dft_mxu32.cu) and K10 (dft_mxu64_pipe.cu), all on the
// tensor-core loop of digit_mma.cuh: it turns the NG exact group sums of
// one output into its residue.  Math and tables as in
// nfllib_tpu_torch/ops/dft_mxu.py (byte-equal to the JAX package's):
//
// M decomposes into NDIG unscaled balanced digit planes W_a (NDIG = 8 for
// u64, 4 for u32), x into NDIG offset bytes d_b = byte_b - 128, and the
// NDIG^2 digit products fold into NG = 2 NDIG - 1 group sums
//   G_k = sum_{a+b=k} sum_j W_a[r][j] d_b[j][c],  |G_k| <= NDIG 128^2 size
// (2^27 at u64 size 1024), one MMA a digit product.
//
// Pack and combine, per output:
//   u64 (_pack_combine_u64): g_k = G_k + n_k 2^bias_bits; the two 8-group
//     parts v = sum_k 2^(8k) g_k (< 2^84) are held as L + 2^32 H with
//     L, H < 2^53, giving v mod 2^64 and the exact a60 = floor(v / 2^60);
//     q = __umul64hi(a60, floor(2^124/p)), part = v - q p < 3p;
//   u32 words (_kernel_u32): the two 4-group parts v (< 2^51) in one
//     64-bit word, a28 = floor(v / 2^28), q = __umulhi(a28, floor(2^60/p)),
//     part = (v mod 2^32) - q p < 3p in 32-bit words, exact for p > 2^28
//     (u32 rings); with SMALLP (u16 rings, their words widened to u32
//     ones) q = __umul64hi(v, floor(2^64/p)), part < 2p, exact for every
//     p < 2^31, but 3-4.5 % slower a K9 launch (chip_smoke.py's A/B);
// then r_lo + shoup(r_hi, chi = 2^(8 NDIG) mod p) + corr with conditional
// subtractions of 2p (lazy, < 2p).  Without a twiddle one more
// subtraction of p makes it canonical; with the TW epilogue
// (matmul_mod(twiddle=)) a lazy Shoup product by tw[r][c] (tws its
// companion, both [R][C] of this channel) comes first, then the same
// subtraction, so the output is canonical either way.  An output that is
// not below p (a twiddle that disagrees with its companion) breaks the
// stage's contract and sets `bad`, which the strict-mode callers turn into
// a poisoned block.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace nfldft {

__device__ __forceinline__ uint64_t sub_if_ge(uint64_t x, uint64_t b) {
  return x >= b ? x - b : x;
}

__device__ __forceinline__ uint32_t sub_if_ge32(uint32_t x, uint32_t b) {
  return x >= b ? x - b : x;
}

// Lazy Shoup product x * w mod p in [0, 2p) with wsh = floor(w 2^64 / p)
__device__ __forceinline__ uint64_t shoup_lazy(uint64_t x, uint64_t w,
                                               uint64_t wsh, uint64_t p) {
  return x * w - __umul64hi(x, wsh) * p;
}

template <int NDIG, bool TW, bool SMALLP = false>
struct DftStage {
  static_assert(NDIG == 8 || NDIG == 4,
                "u64 (8 digits) or u32 words (4 digits)");
  static_assert(!SMALLP || NDIG == 4, "the small-p part is for u32 words");
  static constexpr int NG = 2 * NDIG - 1;
  using Word = std::conditional_t<NDIG == 8, uint64_t, uint32_t>;
  __host__ __device__ static constexpr int nk(int k) {
    return k + 1 < NG - k ? (k + 1 < NDIG ? k + 1 : NDIG)
                          : (NG - k < NDIG ? NG - k : NDIG);
  }

  const uint64_t* corr;      // per output row (left) or column (right)
  const Word* tw;            // [R][C] of this channel (TW only)
  const Word* tws;
  int cols;                  // C, the row pitch of tw/tws
  uint64_t p, mbar, chi, chis;
  int bias;
  bool left;

  // the policy of channel ch: corr [m][size], consts [m][4] = p, mbar, chi,
  // chi_shoup, tw/tws [m][R][C]
  __device__ static DftStage make(const uint64_t* corr,
                                  const uint64_t* consts, const Word* tw,
                                  const Word* tws, int bias, int ch, int R,
                                  int C, bool left) {
    DftStage pol;
    const int size = left ? R : C;
    pol.corr = corr + static_cast<size_t>(ch) * size;
    pol.tw = TW ? tw + static_cast<size_t>(ch) * R * C : nullptr;
    pol.tws = TW ? tws + static_cast<size_t>(ch) * R * C : nullptr;
    pol.cols = C;
    pol.p = consts[4 * ch];
    pol.mbar = consts[4 * ch + 1];
    pol.chi = consts[4 * ch + 2];
    pol.chis = consts[4 * ch + 3];
    pol.bias = bias;
    pol.left = left;
    return pol;
  }

  __device__ uint64_t part64(const uint64_t* g) const {
    const uint64_t lo = g[0] + (g[1] << 8) + (g[2] << 16) + (g[3] << 24);
    const uint64_t hi = g[4] + (g[5] << 8) + (g[6] << 16) + (g[7] << 24);
    const uint64_t a60 = ((lo >> 32) + hi) >> 28;
    return lo + (hi << 32) - __umul64hi(a60, mbar) * p;      // < 3p
  }

  // v < 2^51.  u32 rings: mbar = floor(2^60 / p) < 2^32 (p > 2^28).
  // SMALLP: mbar = floor(2^64 / p), and q = floor(v mbar / 2^64) is
  // floor(v / p) or one less for any p < 2^31, so the part v - q p is
  // < 2p; either way its low 32 bits are exact
  __device__ uint32_t part32(const uint64_t* g) const {
    const uint64_t v = g[0] + (g[1] << 8) + (g[2] << 16) + (g[3] << 24);
    uint32_t q;
    if constexpr (SMALLP)
      q = static_cast<uint32_t>(__umul64hi(v, mbar));
    else
      q = __umulhi(static_cast<uint32_t>(v >> 28),
                   static_cast<uint32_t>(mbar));
    return static_cast<uint32_t>(v) - q * static_cast<uint32_t>(p);  // < 3p
  }

  __device__ Word finish(const int* acc, int r, int c, bool& bad) const {
    uint64_t g[2 * NDIG];
#pragma unroll
    for (int k = 0; k < NG; ++k)
      g[k] = static_cast<uint32_t>(acc[k] + nk(k) * bias);
    g[NG] = 0;
    const size_t i = static_cast<size_t>(r) * cols + c;
    Word x;
    if constexpr (NDIG == 8) {
      const uint64_t two_p = p + p;
      const uint64_t r_lo = sub_if_ge(part64(g), two_p);
      const uint64_t r_hi = part64(g + NDIG);
      x = sub_if_ge(r_lo + shoup_lazy(r_hi, chi, chis, p), two_p);
      x = sub_if_ge(x + corr[left ? r : c], two_p);
      if constexpr (TW) x = shoup_lazy(x, __ldg(tw + i), __ldg(tws + i), p);
      x = sub_if_ge(x, p);
    } else {
      const uint32_t p32 = static_cast<uint32_t>(p);
      const uint32_t two_p = p32 + p32;
      const uint32_t r_lo = sub_if_ge32(part32(g), two_p);
      const uint32_t r_hi = part32(g + NDIG);
      const uint32_t hi = r_hi * static_cast<uint32_t>(chi)
          - __umulhi(r_hi, static_cast<uint32_t>(chis)) * p32;    // < 2p
      x = sub_if_ge32(r_lo + hi, two_p);
      x = sub_if_ge32(x + static_cast<uint32_t>(corr[left ? r : c]), two_p);
      if constexpr (TW) {
        const uint32_t w = __ldg(tw + i), ws = __ldg(tws + i);
        x = x * w - __umulhi(x, ws) * p32;                       // < 2p
      }
      x = sub_if_ge32(x, p32);
    }
    bad |= x >= p;
    return x;
  }
};

}  // namespace nfldft
