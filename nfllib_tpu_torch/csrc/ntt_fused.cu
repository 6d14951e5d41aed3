// Fused four-step negacyclic NTT and inverse NTT, u16 and u32 limb tiers.
//
// Replaces the TPU kernels nfllib_tpu/ops/ntt_mxu.py:_fused_kernel (forward)
// and nfllib_tpu/ops/ntt_mxu.py:_fused_inv_kernel (inverse) with one
// template over direction, limb and strict-mod checking.  Canonical outputs
// are bit-identical to the JAX package at every degree supports_fused
// admits (u32 8..32768, u16 8..512).
//
// Math (n = n1*n2, X[i1][i2] = x[i2 + n2*i1], tables from
// nfllib_tpu_torch/ops/ntt_mxu.py, which builds them exactly as the JAX
// package does and packs them for this kernel):
//   forward:  column DFT  F = W1 @ X    (phi^(n2*i1) folded into W1)
//             twiddle     Y = F * tw    (omega^(rev(k1)*i2) * phi^i2, Shoup)
//             row DFT     O = Y @ W2
//   inverse:  O @ W2inv, twiddle (n^-1 * phi^-i2 folded in), W1inv @.
// Each mod-p matmul is a sum of int8 digit-plane dots: the table entry
// W^(b) = 2^(dbits*b) * W mod p is split into digits a, and
//   G_a = sum_b sum_k digit_a(W^(b)) * digit_b(x)
// is accumulated exactly in int32 by __dp4a, four (b) lanes per call:
//   u32: x ^ 0x80808080 is the four offset bytes byte_b - 128 as int8
//        lanes; the table word packs the four balanced digits of
//        W^(0..3)_a.  |G_a| <= 4 * 128^2 * k < 2^25 for k <= 512.
//   u16: two unsigned 7-bit digits in lanes 0, 1 (lanes 2, 3 zero).
// Recombination is _recombine_groups (ntt_mxu.py) exactly: bias 2^25, the
// low 32 bits of the pack, one Barrett step with floor(2^60/p) on
// a28 = (G1 >> 20) + (G2 >> 12) + (G3 >> 4), the correction vector for the
// offset-byte under-count, lazy [0, 2p) for the first stage and canonical
// at the end (u16: one packed term reduced with floor(2^32/p)).  The Shoup
// twiddle uses __umulhi.
//
// Design: one thread block per (polynomial, channel); the polynomial sits in
// dynamic shared memory as u32 words (64 KB at 2^14, 128 KB at 2^15).  A
// double buffer would need 256 KB at 2^15, over the 227 KB a block may
// have, so each stage runs in place: a column-DFT output column depends
// only on its input column and a row-DFT output row only on its input row,
// so the block computes whole columns (rows) a round at a time, holds the
// results in registers, syncs, and writes them back.  Tables (about 0.6 MB
// per channel at 2^14) are read from global memory through L2, which holds
// all 17 channels of the bench shape.
//
// Bound on this card: 2 stages * 4 digit planes * 128^3 = 16.8 M dp4a per
// channel-NTT at n = 2^14 on the INT32 pipes, plus one 16-byte table load
// per 4..8 dp4a.  The tensor cores (s8 mma.sync / wgmma) are not used yet.
//
// Strict mode (ntt_mxu.py:559-577): a stage result outside its contract
// ([0, 2p) lazy, [0, p) canonical) poisons the whole output block with
// 0xFFFFFFFF, which the caller's _strict_bracket turns into an
// AssertionError.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBalBias = 1 << 25;

// the table word's lanes b hold digit_a(W^(b)); x is digitized to match
template <bool U16>
__device__ __forceinline__ int digits(uint32_t x) {
  if constexpr (U16)
    return static_cast<int>((x & 0x7Fu) | (((x >> 7) & 0x7Fu) << 8));
  else
    return static_cast<int>(x ^ 0x80808080u);
}

template <bool U16>
__device__ __forceinline__ uint32_t recombine(const int* g, uint32_t p,
                                              uint32_t mbar, uint32_t corr,
                                              bool lazy) {
  if constexpr (U16) {
    const uint32_t u0 = static_cast<uint32_t>(g[0])
                        + (static_cast<uint32_t>(g[1]) << 7);
    const uint32_t t = u0 - __umulhi(u0, mbar) * p;
    return t >= p ? t - p : t;
  } else {
    const uint32_t g0 = static_cast<uint32_t>(g[0] + kBalBias);
    const uint32_t g1 = static_cast<uint32_t>(g[1] + kBalBias);
    const uint32_t g2 = static_cast<uint32_t>(g[2] + kBalBias);
    const uint32_t g3 = static_cast<uint32_t>(g[3] + kBalBias);
    const uint32_t lo = g0 + (g1 << 8) + (g2 << 16) + (g3 << 24);
    const uint32_t a28 = (g1 >> 20) + (g2 >> 12) + (g3 >> 4);
    const uint32_t two_p = p + p;
    uint32_t t = lo - __umulhi(a28, mbar) * p;        // < 4p
    if (t >= two_p) t -= two_p;
    t += corr;                                        // < 3p for valid tables
    if (t >= two_p) t -= two_p;
    if (!lazy && t >= p) t -= p;
    return t;
  }
}

// four consecutive table words; only n1 = 2 (degree 8) has fewer
__device__ __forceinline__ int4 load4(const int* ptr, int rem) {
  if (rem >= 4) return __ldg(reinterpret_cast<const int4*>(ptr));
  return make_int4(__ldg(ptr), rem > 1 ? __ldg(ptr + 1) : 0,
                   rem > 2 ? __ldg(ptr + 2) : 0, 0);
}

// Column DFT in place: X[r][c] <- sum_k W[a][r][k] . X[k][c], recombined
// with corr[r].  Each round covers whole columns: every thread owns RT rows
// of CT columns; the row groups span all n1 rows.
template <bool U16>
__device__ void left_stage(uint32_t* X, const int* __restrict__ W,
                           const uint32_t* __restrict__ corr, int n1, int n2,
                           uint32_t p, uint32_t mbar, bool lazy, bool& bad) {
  constexpr int NA = U16 ? 2 : 4;
  constexpr int RT = 4, CT = 2;
  const int nrg = (n1 + RT - 1) / RT;
  const int ncg = kThreads / nrg;
  const int rg = threadIdx.x / ncg, cg = threadIdx.x % ncg;
  const size_t plane = static_cast<size_t>(n1) * n1;
  const uint32_t bound = lazy ? p + p : p;
  for (int cbase = 0; cbase < n2; cbase += ncg * CT) {
    int acc[RT][CT][NA];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int a = 0; a < NA; ++a) acc[i][j][a] = 0;
    for (int k0 = 0; k0 < n1; k0 += 4) {
      int d[4][CT];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int k = k0 + kk, c = cbase + j * ncg + cg;
          d[kk][j] = (k < n1 && c < n2) ? digits<U16>(X[k * n2 + c]) : 0;
        }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = rg * RT + i;
        if (r >= n1) continue;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const int4 w = load4(W + a * plane + static_cast<size_t>(r) * n1 + k0,
                               n1 - k0);
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            int s = acc[i][j][a];
            s = __dp4a(w.x, d[0][j], s);
            s = __dp4a(w.y, d[1][j], s);
            s = __dp4a(w.z, d[2][j], s);
            s = __dp4a(w.w, d[3][j], s);
            acc[i][j][a] = s;
          }
        }
      }
    }
    uint32_t out[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int r = rg * RT + i, c = cbase + j * ncg + cg;
        out[i][j] = 0;
        if (r < n1 && c < n2) {
          out[i][j] = recombine<U16>(acc[i][j], p, mbar, corr[r], lazy);
          bad |= out[i][j] >= bound;
        }
      }
    __syncthreads();   // every read of these columns is done
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int r = rg * RT + i, c = cbase + j * ncg + cg;
        if (r < n1 && c < n2) X[r * n2 + c] = out[i][j];
      }
  }
  __syncthreads();
}

// Row DFT in place: X[r][c] <- sum_k X[r][k] . W[a][k][c], recombined with
// corr[c].  Each round covers whole rows: every thread owns CT = 4
// consecutive columns (one 16-byte table load per digit plane and k) of RT
// rows; the column groups span all n2 columns.
template <bool U16>
__device__ void right_stage(uint32_t* X, const int* __restrict__ W,
                            const uint32_t* __restrict__ corr, int n1, int n2,
                            uint32_t p, uint32_t mbar, bool lazy, bool& bad) {
  constexpr int NA = U16 ? 2 : 4;
  constexpr int RT = 2, CT = 4;
  const int ncg = n2 / CT;
  const int nrg = kThreads / ncg;
  const int cg = threadIdx.x % ncg, rg = threadIdx.x / ncg;
  const int c0 = cg * CT;
  const size_t plane = static_cast<size_t>(n2) * n2;
  const uint32_t bound = lazy ? p + p : p;
  for (int rbase = 0; rbase < n1; rbase += nrg * RT) {
    int acc[RT][CT][NA];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j)
#pragma unroll
        for (int a = 0; a < NA; ++a) acc[i][j][a] = 0;
    for (int k = 0; k < n2; ++k) {
      int d[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = rbase + i * nrg + rg;
        d[i] = r < n1 ? digits<U16>(X[r * n2 + k]) : 0;
      }
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(
            W + a * plane + static_cast<size_t>(k) * n2 + c0));
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          acc[i][0][a] = __dp4a(d[i], w.x, acc[i][0][a]);
          acc[i][1][a] = __dp4a(d[i], w.y, acc[i][1][a]);
          acc[i][2][a] = __dp4a(d[i], w.z, acc[i][2][a]);
          acc[i][3][a] = __dp4a(d[i], w.w, acc[i][3][a]);
        }
      }
    }
    uint32_t out[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int r = rbase + i * nrg + rg;
        out[i][j] = 0;
        if (r < n1) {
          out[i][j] = recombine<U16>(acc[i][j], p, mbar, corr[c0 + j], lazy);
          bad |= out[i][j] >= bound;
        }
      }
    __syncthreads();   // every read of these rows is done
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rbase + i * nrg + rg;
      if (r < n1) {
#pragma unroll
        for (int j = 0; j < CT; ++j) X[r * n2 + c0 + j] = out[i][j];
      }
    }
  }
  __syncthreads();
}

// Shoup twiddle, elementwise: u32 stays lazy in [0, 2p), u16 canonical
template <bool U16>
__device__ void twiddle(uint32_t* X, const uint32_t* __restrict__ tw,
                        const uint32_t* __restrict__ tws, int n, uint32_t p,
                        bool lazy, bool& bad) {
  const uint32_t bound = lazy ? p + p : p;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const uint32_t x = X[i];
    uint32_t y;
    if constexpr (U16) {
      const uint32_t q = (x * __ldg(tws + i)) >> 16;
      y = x * __ldg(tw + i) - q * p;
      if (y >= p) y -= p;
    } else {
      const uint32_t q = __umulhi(x, __ldg(tws + i));
      y = x * __ldg(tw + i) - q * p;
    }
    bad |= y >= bound;
    X[i] = y;
  }
  __syncthreads();
}

template <bool U16, bool INV, bool STRICT>
__global__ void __launch_bounds__(kThreads) ntt_fused_kernel(
    const void* __restrict__ xin, void* __restrict__ xout,
    const int* __restrict__ w1, const int* __restrict__ w2,
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws,
    const uint32_t* __restrict__ corr1, const uint32_t* __restrict__ corr2,
    const uint32_t* __restrict__ pvec, const uint32_t* __restrict__ mvec,
    int m, int n1, int n2) {
  using Limb = typename std::conditional<U16, uint16_t, uint32_t>::type;
  constexpr int NA = U16 ? 2 : 4;
  extern __shared__ uint32_t X[];
  const int n = n1 * n2;
  const int ch = blockIdx.y;
  const size_t off = (static_cast<size_t>(blockIdx.x) * m + ch) * n;
  const Limb* in = static_cast<const Limb*>(xin) + off;
  Limb* out = static_cast<Limb*>(xout) + off;
  for (int i = threadIdx.x; i < n; i += kThreads) X[i] = in[i];
  __syncthreads();

  const uint32_t p = pvec[ch], mbar = mvec[ch];
  const int* W1 = w1 + static_cast<size_t>(ch) * NA * n1 * n1;
  const int* W2 = w2 + static_cast<size_t>(ch) * NA * n2 * n2;
  const uint32_t* TW = tw + static_cast<size_t>(ch) * n;
  const uint32_t* TWS = tws + static_cast<size_t>(ch) * n;
  const uint32_t* C1 = corr1 + static_cast<size_t>(ch) * n1;
  const uint32_t* C2 = corr2 + static_cast<size_t>(ch) * n2;
  const bool lazy = !U16;      // u32 intermediates may stay in [0, 2p)
  bool bad = false;
  if (!INV) {
    left_stage<U16>(X, W1, C1, n1, n2, p, mbar, lazy, bad);
    twiddle<U16>(X, TW, TWS, n, p, lazy, bad);
    right_stage<U16>(X, W2, C2, n1, n2, p, mbar, false, bad);
  } else {
    right_stage<U16>(X, W2, C2, n1, n2, p, mbar, lazy, bad);
    twiddle<U16>(X, TW, TWS, n, p, lazy, bad);
    left_stage<U16>(X, W1, C1, n1, n2, p, mbar, false, bad);
  }
  if (STRICT && __syncthreads_or(bad)) {
    for (int i = threadIdx.x; i < n; i += kThreads)
      out[i] = static_cast<Limb>(0xFFFFFFFFu);
    return;
  }
  for (int i = threadIdx.x; i < n; i += kThreads)
    out[i] = static_cast<Limb>(X[i]);
}

template <bool U16, bool INV, bool STRICT>
cudaError_t launch(const void* x, void* out, const void* w1, const void* w2,
                   const void* tw, const void* tws, const void* corr1,
                   const void* corr2, const void* pvec, const void* mvec,
                   int batch, int m, int n1, int n2, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n1) * n2 * sizeof(uint32_t);
  auto kernel = ntt_fused_kernel<U16, INV, STRICT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(batch, m), kThreads, smem, stream>>>(
      x, out, static_cast<const int*>(w1), static_cast<const int*>(w2),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      static_cast<const uint32_t*>(corr1), static_cast<const uint32_t*>(corr2),
      static_cast<const uint32_t*>(pvec), static_cast<const uint32_t*>(mvec),
      m, n1, n2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  x/out: [batch, m, n1*n2] u16 or u32
// residues; w1: [m, NA, n1, n1] and w2: [m, NA, n2, n2] packed int32 digit
// words (NA = 4 for u32, 2 for u16); tw/tws: [m, n1*n2]; corr1: [m, n1];
// corr2: [m, n2]; pvec/mvec: [m] moduli and Barrett constants.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int nfl_ntt_fused(int inverse, int u16, int strict, const void* x,
                             void* out, const void* w1, const void* w2,
                             const void* tw, const void* tws,
                             const void* corr1, const void* corr2,
                             const void* pvec, const void* mvec, int batch,
                             int m, int n1, int n2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NFL_LAUNCH(U, I, S)                                                   \
  return static_cast<int>(launch<U, I, S>(x, out, w1, w2, tw, tws, corr1,    \
                                          corr2, pvec, mvec, batch, m, n1,   \
                                          n2, s))
  if (u16) {
    if (inverse) {
      if (strict) NFL_LAUNCH(true, true, true);
      NFL_LAUNCH(true, true, false);
    }
    if (strict) NFL_LAUNCH(true, false, true);
    NFL_LAUNCH(true, false, false);
  }
  if (inverse) {
    if (strict) NFL_LAUNCH(false, true, true);
    NFL_LAUNCH(false, true, false);
  }
  if (strict) NFL_LAUNCH(false, false, true);
  NFL_LAUNCH(false, false, false);
#undef NFL_LAUNCH
}

extern "C" const char* nfl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
