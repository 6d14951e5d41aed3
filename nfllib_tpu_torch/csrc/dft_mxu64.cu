// Square mod-p matmul by a per-channel [size, size] matrix, u64 limb tier.
//
// Replaces the TPU kernel nfllib_tpu/ops/dft_mxu.py:_kernel_u64 with its
// epilogue _pack_combine_u64, as matmul_mod runs it with twiddle=None and
// strict=True (canonical output): out = M @ X along axis -2 ("left") or
// X @ M along axis -1 ("right") of [batch, m, R, C] residues, size 8..1024.
// The large-degree u64 NTT (ops/ntt_mxu_u64.py:_large_run64) runs it twice.
//
// Math (tables from nfllib_tpu_torch/ops/dft_mxu.py, byte-equal to the JAX
// package's): M decomposes into NDIG unscaled balanced digit planes W_a,
// x into NDIG offset bytes d_b = byte_b - 128, and the NDIG^2 digit
// products fold into 2 NDIG - 1 group sums
//   G_k = sum_{a+b=k} sum_j W_a[r][j] d_b[j][c],  |G_k| <= 8 * 128^2 * size
// (2^27 at size 1024).  For group k the table word pair holds W_{k-b} in
// byte b (zero where k - b is not a digit), so G_k costs one dp4a for
// k = 0..3 and 11..14 and two for k = 4..10: 22 dp4a per multiply-add
// position.  The table keeps only the 8 digits of each entry (8 bytes); the
// group words are assembled with one __byte_perm each while a chunk is
// staged in shared memory.  Pack and combine follow _pack_combine_u64 in
// native words: g_k = G_k + n_k 2^bias_bits; the two 8-group parts
// v = sum_k 2^(8k) g_k (< 2^84) are held as L + 2^32 H with L, H < 2^53,
// giving v mod 2^64 and the exact a60 = floor(v / 2^60);
// q = __umul64hi(a60, floor(2^124/p)), part = v - q*p < 3p; then
// r_lo + shoup(r_hi, chi = 2^64 mod p) + corr with conditional
// subtractions, canonical.
//
// The digit count is a template parameter: the u32 kernel K9
// (dft_mxu.py:_kernel_u32, 4 digits) is a later instantiation with its own
// pack (static_assert below).
//
// Design: one 256-thread block per 32 x 32 output tile of one (polynomial,
// channel), looping over the contraction in chunks of 8 staged in shared
// memory (digit_matmul64.cuh); the grid covers (tile, channel, polynomial)
// with no order between blocks.
//
// Bound on this card: at n = 2^20 (n1 = n2 = 1024) one stage of one
// channel is 1024^3 multiply-add positions x 22 dp4a = 23.6 G dp4a on the
// INT32 pipes; the tensor cores are not used yet.

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "digit_matmul64.cuh"

namespace {

using nfl64::kThreads;
using nfl64::kTile;
using nfl64::sub_if_ge;

// __byte_perm(x, y, sel) producing bytes j = 0..3 = digit (top - j), or 0
// where that is not a digit 0..7; d0 holds digits 0..3 and d1 digits 4..7.
// src 0: (d0, d1); src 1: (d0, 0); src 2: (d1, 0).
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

template <int... Gs>
__device__ __forceinline__ void stage_groups(int2* ws, int slot, uint32_t d0,
                                             uint32_t d1,
                                             std::integer_sequence<int, Gs...>) {
  ((ws[Gs * nfl64::kSlots + slot] =
        make_int2(window_word<Gs>(d0, d1), window_word<Gs - 4>(d0, d1))),
   ...);
}

template <int NDIG>
struct DftStage {
  static_assert(NDIG == 8, "u64 pack; the u32 tier (NDIG = 4) is K9");
  static constexpr int NG = 2 * NDIG - 1;
  // group g has a digit pair with b = 0..3 iff g <= 10, with b = 4..7 iff
  // g >= 4
  __host__ __device__ static constexpr bool uses_lo(int g) { return g <= NDIG + 2; }
  __host__ __device__ static constexpr bool uses_hi(int g) { return g >= 4; }
  __host__ __device__ static constexpr int nk(int k) {
    return k + 1 < NG - k ? (k + 1 < NDIG ? k + 1 : NDIG)
                          : (NG - k < NDIG ? NG - k : NDIG);
  }

  const uint2* planes;       // [size][size]: byte a of an entry is W_a
  int size;
  const uint64_t* corr;      // per output row (left) or column (right)
  uint64_t p, mbar, chi, chis;
  int bias;
  bool left;

  __device__ void stage_w(int2* ws, int slot, int row, int col,
                          bool valid) const {
    const uint2 e = valid
        ? __ldg(planes + static_cast<size_t>(row) * size + col)
        : make_uint2(0, 0);
    stage_groups(ws, slot, e.x, e.y, std::make_integer_sequence<int, NG>{});
  }

  __device__ uint64_t part(const uint64_t* g) const {
    const uint64_t lo = g[0] + (g[1] << 8) + (g[2] << 16) + (g[3] << 24);
    const uint64_t hi = g[4] + (g[5] << 8) + (g[6] << 16) + (g[7] << 24);
    const uint64_t a60 = ((lo >> 32) + hi) >> 28;
    return lo + (hi << 32) - __umul64hi(a60, mbar) * p;      // < 3p
  }

  __device__ uint64_t finish(const int* acc, int r, int c, bool&) const {
    uint64_t g[2 * NDIG];
#pragma unroll
    for (int k = 0; k < NG; ++k)
      g[k] = static_cast<uint32_t>(acc[k] + nk(k) * bias);
    g[NG] = 0;
    const uint64_t two_p = p + p;
    const uint64_t r_lo = sub_if_ge(part(g), two_p);
    const uint64_t r_hi = part(g + NDIG);
    uint64_t x = sub_if_ge(r_lo + nfl64::shoup_lazy(r_hi, chi, chis, p),
                           two_p);
    x = sub_if_ge(x + corr[left ? r : c], two_p);
    return sub_if_ge(x, p);
  }
};

// x, out [batch, m, R, C]; planes [m, size, size]; corr [m, size];
// consts [m, 4] = p, mbar, chi, chi_shoup.
template <bool LEFT>
__global__ void __launch_bounds__(kThreads) dft_mxu64_kernel(
    const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
    const uint2* __restrict__ planes, const uint64_t* __restrict__ corr,
    const uint64_t* __restrict__ consts, int bias, int m, int R, int C) {
  const int ch = blockIdx.y, b = blockIdx.z;
  const int tiles_c = (C + kTile - 1) / kTile;
  const int size = LEFT ? R : C;
  const size_t off = (static_cast<size_t>(b) * m + ch) * R * C;
  DftStage<8> pol;
  pol.planes = planes + static_cast<size_t>(ch) * size * size;
  pol.size = size;
  pol.corr = corr + static_cast<size_t>(ch) * size;
  pol.p = consts[4 * ch];
  pol.mbar = consts[4 * ch + 1];
  pol.chi = consts[4 * ch + 2];
  pol.chis = consts[4 * ch + 3];
  pol.bias = bias;
  pol.left = LEFT;
  bool bad = false;
  nfl64::mod_matmul_tile<DftStage<8>, LEFT>(
      pol, x + off, out + off, R, C, blockIdx.x / tiles_c,
      blockIdx.x % tiles_c, bad);
}

}  // namespace

// Plain C entry point for ctypes.  x/out: [batch, m, r, c] u64 residues;
// planes: [m, size, size] u64 digit entries (size = r for left, c for
// right); corr: [m, size]; consts: [m, 4]; bias = 2^bias_bits.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int nfl_dft_mxu64(int left, const void* x, void* out,
                             const void* planes, const void* corr,
                             const void* consts, int bias, int batch, int m,
                             int r, int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ((r + kTile - 1) / kTile) * ((c + kTile - 1) / kTile);
  const dim3 grid(tiles, m, batch);
  const auto* xi = static_cast<const uint64_t*>(x);
  auto* o = static_cast<uint64_t*>(out);
  const auto* pl = static_cast<const uint2*>(planes);
  const auto* co = static_cast<const uint64_t*>(corr);
  const auto* cs = static_cast<const uint64_t*>(consts);
  if (left)
    dft_mxu64_kernel<true><<<grid, kThreads, 0, s>>>(xi, o, pl, co, cs, bias,
                                                     m, r, c);
  else
    dft_mxu64_kernel<false><<<grid, kThreads, 0, s>>>(xi, o, pl, co, cs,
                                                      bias, m, r, c);
  return static_cast<int>(cudaGetLastError());
}
