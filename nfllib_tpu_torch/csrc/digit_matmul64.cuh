// Tile loop shared by the u64 kernels K4 (ntt_fused64.cu) and K5
// (dft_mxu64.cu): one mod-p matmul of a [R, C] u64 slab by a per-channel
// table, as int8 digit dots accumulated exactly by __dp4a.
//
//   LEFT:  out[r][c] = sum_k W[r][k] . X[k][c]   (contraction K = R)
//   RIGHT: out[r][c] = sum_k X[r][k] . W[k][c]   (contraction K = C)
//
// X's eight offset bytes (byte_b - 128) form two dp4a operands: the low
// word ^ 0x80808080 (b = 0..3) and the high word ^ 0x80808080 (b = 4..7).
// A Policy supplies, for each of its NG digit groups g, the table's two
// matching words (byte b of the word pair multiplies digit b of x), so
//   G_g = sum_k dp4a(Wg.lo, x.lo) + dp4a(Wg.hi, x.hi)
// and then turns the NG exact int32 group sums of one output into the
// residue (Policy::finish).  Policy interface:
//   static constexpr int NG;
//   static constexpr bool uses_lo(int g), uses_hi(int g);
//   __device__ void stage_w(int2* ws, int slot, int row, int col,
//                           bool valid) const;   // ws[g * kSlots + slot]
//   __device__ uint64_t finish(const int* acc, int r, int c,
//                              bool& bad) const;
//
// Tiling: one 256-thread block per 32 x 32 output tile of one (polynomial,
// channel); 16 x 16 threads own 2 x 2 outputs each, strided by 16 so that
// shared-memory reads are broadcasts or consecutive.  The contraction runs
// in chunks of 8: each thread stages one x entry and one table entry (all
// NG group words) into shared memory, then every thread runs
// 8 * 2 * 2 * NG (or 2 NG) dp4a from shared memory.  Out-of-range rows,
// columns and contraction indices (sizes below 32) stage zero table words,
// which contribute nothing; their outputs are not written.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace nfl64 {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kKC = 8;
constexpr int kSlots = kTile * kKC;     // == kThreads: one entry a thread
constexpr int kTM = 2, kTN = 2;
static_assert(kSlots == kThreads, "one staged entry per thread");

__device__ __forceinline__ int2 offset_digits(uint64_t v) {
  return make_int2(
      static_cast<int>(static_cast<uint32_t>(v) ^ 0x80808080u),
      static_cast<int>(static_cast<uint32_t>(v >> 32) ^ 0x80808080u));
}

__device__ __forceinline__ uint64_t sub_if_ge(uint64_t x, uint64_t b) {
  return x >= b ? x - b : x;
}

// Lazy Shoup product x * w mod p in [0, 2p) with wsh = floor(w 2^64 / p)
__device__ __forceinline__ uint64_t shoup_lazy(uint64_t x, uint64_t w,
                                               uint64_t wsh, uint64_t p) {
  return x * w - __umul64hi(x, wsh) * p;
}

template <class Policy, bool LEFT>
__device__ __forceinline__ void mod_matmul_tile(
    const Policy& pol, const uint64_t* __restrict__ X,
    uint64_t* __restrict__ out, int R, int C, int tile_r, int tile_c,
    bool& bad) {
  constexpr int NG = Policy::NG;
  __shared__ int2 xs[kSlots];
  __shared__ int2 ws[NG * kSlots];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int r0 = tile_r * kTile, c0 = tile_c * kTile;
  const int K = LEFT ? R : C;
  int acc[kTM][kTN][NG];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
#pragma unroll
      for (int g = 0; g < NG; ++g) acc[i][j][g] = 0;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    if (LEFT) {
      // x chunk [kKC k][kTile c] at kk * kTile + cl; table chunk
      // [kTile r][kKC k] at rl * kKC + kk
      const int k = k0 + t / kTile, c = c0 + t % kTile;
      xs[t] = (k < K && c < C) ? offset_digits(X[static_cast<size_t>(k) * C + c])
                               : make_int2(0, 0);
      const int r = r0 + t / kKC, kw = k0 + t % kKC;
      pol.stage_w(ws, t, r, kw, r < R && kw < K);
    } else {
      // x chunk [kTile r][kKC k] at rl * kKC + kk; table chunk
      // [kKC k][kTile c] at kk * kTile + cl
      const int r = r0 + t / kKC, k = k0 + t % kKC;
      xs[t] = (r < R && k < K) ? offset_digits(X[static_cast<size_t>(r) * C + k])
                               : make_int2(0, 0);
      const int kw = k0 + t / kTile, c = c0 + t % kTile;
      pol.stage_w(ws, t, kw, c, kw < K && c < C);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      if (LEFT) {
        int2 xv[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) xv[j] = xs[kk * kTile + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int slot = (ty + 16 * i) * kKC + kk;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int2 w = ws[g * kSlots + slot];
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
              if (Policy::uses_lo(g))
                acc[i][j][g] = __dp4a(w.x, xv[j].x, acc[i][j][g]);
              if (Policy::uses_hi(g))
                acc[i][j][g] = __dp4a(w.y, xv[j].y, acc[i][j][g]);
            }
          }
        }
      } else {
        int2 xv[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) xv[i] = xs[(ty + 16 * i) * kKC + kk];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int slot = kk * kTile + tx + 16 * j;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int2 w = ws[g * kSlots + slot];
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
              if (Policy::uses_lo(g))
                acc[i][j][g] = __dp4a(xv[i].x, w.x, acc[i][j][g]);
              if (Policy::uses_hi(g))
                acc[i][j][g] = __dp4a(xv[i].y, w.y, acc[i][j][g]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
      if (r < R && c < C)
        out[static_cast<size_t>(r) * C + c] = pol.finish(acc[i][j], r, c, bad);
    }
}

}  // namespace nfl64
