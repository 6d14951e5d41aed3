// The digit-group policy of the square mod-p matmul kernels: K9
// (dft_mxu32.cu) on the dp4a tile loop of digit_matmul64.cuh (stage_w and
// finish), K5 (dft_mxu64.cu) and K10 (dft_mxu64_pipe.cu) on the tensor-core
// loop of digit_mma.cuh (finish only; make takes a null `planes`).  Math
// and tables as in nfllib_tpu_torch/ops/dft_mxu.py (byte-equal to the JAX
// package's):
//
// M decomposes into NDIG unscaled balanced digit planes W_a (NDIG = 8 for
// u64, 4 for u32), x into NDIG offset bytes d_b = byte_b - 128, and the
// NDIG^2 digit products fold into NG = 2 NDIG - 1 group sums
//   G_k = sum_{a+b=k} sum_j W_a[r][j] d_b[j][c],  |G_k| <= NDIG 128^2 size
// (2^27 at u64 size 1024).  On the dp4a loop (u32) the staged word for
// group k holds W_{k-b} in byte b (zero where k - b is not a digit), one
// dp4a a group (7 a multiply-add position); the table keeps the 4 digits of
// each entry, and the group words are built with one __byte_perm each
// while a chunk is staged in shared memory.  The u64 tier's 64 products run
// on the tensor cores (digit_mma.cuh), one MMA each.
//
// Pack and combine, per output:
//   u64 (_pack_combine_u64): g_k = G_k + n_k 2^bias_bits; the two 8-group
//     parts v = sum_k 2^(8k) g_k (< 2^84) are held as L + 2^32 H with
//     L, H < 2^53, giving v mod 2^64 and the exact a60 = floor(v / 2^60);
//     q = __umul64hi(a60, floor(2^124/p)), part = v - q p < 3p;
//   u32 (_kernel_u32): the two 4-group parts v (< 2^51) in one 64-bit
//     word, a28 = floor(v / 2^28), q = __umulhi(a28, floor(2^60/p)),
//     part = (v mod 2^32) - q p < 3p in 32-bit words;
// then r_lo + shoup(r_hi, chi = 2^(8 NDIG) mod p) + corr with conditional
// subtractions of 2p (lazy, < 2p).  Without a twiddle one more
// subtraction of p makes it canonical; with the TW epilogue
// (matmul_mod(twiddle=)) a lazy Shoup product by tw[r][c] (tws its
// companion, both [R][C] of this channel) comes first, then the same
// subtraction, so the output is canonical either way.
#pragma once

#include <cstdint>
#include <type_traits>
#include <utility>

#include <cuda_runtime.h>

#include "digit_matmul64.cuh"

namespace nfldft {

// __byte_perm(x, y, sel) producing bytes j = 0..3 = digit (top - j), or 0
// where that is not a digit 0..7; d0 holds digits 0..3 and d1 digits 4..7
// (zero for the 4-digit tier).  src 0: (d0, d1); src 1: (d0, 0);
// src 2: (d1, 0).
struct Window {
  int src;
  unsigned sel;
};

__host__ __device__ constexpr Window window(int top) {
  Window w{0, 0u};
  if (top > 7) w.src = 2;
  else if (top < 3) w.src = 1;
  for (int j = 0; j < 4; ++j) {
    const int a = top - j;
    unsigned nib = 0;
    if (w.src == 0) nib = static_cast<unsigned>(a);
    else if (w.src == 1) nib = (a >= 0) ? static_cast<unsigned>(a) : 4u;
    else nib = (a <= 7) ? static_cast<unsigned>(a - 4) : 4u;
    w.sel |= nib << (4 * j);
  }
  return w;
}

template <int TOP>
__device__ __forceinline__ int window_word(uint32_t d0, uint32_t d1) {
  constexpr Window w = window(TOP);
  const uint32_t x = w.src == 2 ? d1 : d0;
  const uint32_t y = w.src == 0 ? d1 : 0u;
  return static_cast<int>(__byte_perm(x, y, w.sel));
}

// 4 digits: every group's word is one window of (d0, 0)
template <int... Gs>
__device__ __forceinline__ void stage_groups4(int2* ws, int slot, uint32_t d0,
                                              std::integer_sequence<int, Gs...>) {
  ((ws[Gs * nfl64::kSlots + slot] = make_int2(window_word<Gs>(d0, 0u), 0)),
   ...);
}

__device__ __forceinline__ uint32_t sub_if_ge32(uint32_t x, uint32_t b) {
  return x >= b ? x - b : x;
}

template <int NDIG, bool TW>
struct DftStage {
  static_assert(NDIG == 8 || NDIG == 4, "u64 (8 digits) or u32 (4 digits)");
  static constexpr int NG = 2 * NDIG - 1;
  using Entry = std::conditional_t<NDIG == 8, uint2, uint32_t>;
  using Word = std::conditional_t<NDIG == 8, uint64_t, uint32_t>;
  // u64: group g has a digit pair with b = 0..3 iff g <= 10, with
  // b = 4..7 iff g >= 4; u32: one word a group
  __host__ __device__ static constexpr bool uses_lo(int g) {
    return NDIG == 4 || g <= NDIG + 2;
  }
  __host__ __device__ static constexpr bool uses_hi(int g) {
    return NDIG == 8 && g >= 4;
  }
  __host__ __device__ static constexpr int nk(int k) {
    return k + 1 < NG - k ? (k + 1 < NDIG ? k + 1 : NDIG)
                          : (NG - k < NDIG ? NG - k : NDIG);
  }

  const Entry* planes;       // [size][size]: byte a of an entry is W_a
  int size;
  const uint64_t* corr;      // per output row (left) or column (right)
  const Word* tw;            // [R][C] of this channel (TW only)
  const Word* tws;
  int cols;                  // C, the row pitch of tw/tws
  uint64_t p, mbar, chi, chis;
  int bias;
  bool left;

  // the policy of channel ch: planes [m][size][size], corr [m][size],
  // consts [m][4] = p, mbar, chi, chi_shoup, tw/tws [m][R][C]
  __device__ static DftStage make(const Entry* planes, const uint64_t* corr,
                                  const uint64_t* consts, const Word* tw,
                                  const Word* tws, int bias, int ch, int R,
                                  int C, bool left) {
    DftStage pol;
    const int size = left ? R : C;
    pol.planes = planes == nullptr
        ? nullptr : planes + static_cast<size_t>(ch) * size * size;
    pol.size = size;
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

  __device__ void stage_w(int2* ws, int slot, int row, int col,
                          bool valid) const {
    static_assert(NDIG == 4, "the u64 tier runs on digit_mma.cuh");
    const Entry e = valid
        ? __ldg(planes + static_cast<size_t>(row) * size + col)
        : Entry{};
    stage_groups4(ws, slot, e, std::make_integer_sequence<int, NG>{});
  }

  __device__ uint64_t part64(const uint64_t* g) const {
    const uint64_t lo = g[0] + (g[1] << 8) + (g[2] << 16) + (g[3] << 24);
    const uint64_t hi = g[4] + (g[5] << 8) + (g[6] << 16) + (g[7] << 24);
    const uint64_t a60 = ((lo >> 32) + hi) >> 28;
    return lo + (hi << 32) - __umul64hi(a60, mbar) * p;      // < 3p
  }

  __device__ uint32_t part32(const uint64_t* g) const {
    const uint64_t v = g[0] + (g[1] << 8) + (g[2] << 16) + (g[3] << 24);
    const uint32_t q = __umulhi(static_cast<uint32_t>(v >> 28),
                                static_cast<uint32_t>(mbar));
    return static_cast<uint32_t>(v) - q * static_cast<uint32_t>(p);  // < 3p
  }

  __device__ uint64_t finish(const int* acc, int r, int c, bool&) const {
    uint64_t g[2 * NDIG];
#pragma unroll
    for (int k = 0; k < NG; ++k)
      g[k] = static_cast<uint32_t>(acc[k] + nk(k) * bias);
    g[NG] = 0;
    const size_t i = static_cast<size_t>(r) * cols + c;
    if constexpr (NDIG == 8) {
      const uint64_t two_p = p + p;
      const uint64_t r_lo = nfl64::sub_if_ge(part64(g), two_p);
      const uint64_t r_hi = part64(g + NDIG);
      uint64_t x = nfl64::sub_if_ge(
          r_lo + nfl64::shoup_lazy(r_hi, chi, chis, p), two_p);
      x = nfl64::sub_if_ge(x + corr[left ? r : c], two_p);
      if constexpr (TW)
        x = nfl64::shoup_lazy(x, __ldg(tw + i), __ldg(tws + i), p);
      return nfl64::sub_if_ge(x, p);
    } else {
      const uint32_t p32 = static_cast<uint32_t>(p);
      const uint32_t two_p = p32 + p32;
      const uint32_t r_lo = sub_if_ge32(part32(g), two_p);
      const uint32_t r_hi = part32(g + NDIG);
      const uint32_t hi = r_hi * static_cast<uint32_t>(chi)
          - __umulhi(r_hi, static_cast<uint32_t>(chis)) * p32;    // < 2p
      uint32_t x = sub_if_ge32(r_lo + hi, two_p);
      x = sub_if_ge32(x + static_cast<uint32_t>(corr[left ? r : c]), two_p);
      if constexpr (TW) {
        const uint32_t w = __ldg(tw + i), ws = __ldg(tws + i);
        x = x * w - __umulhi(x, ws) * p32;                       // < 2p
      }
      return sub_if_ge32(x, p32);
    }
  }
};

}  // namespace nfldft
