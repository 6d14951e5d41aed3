// Fused four-step negacyclic NTT and inverse NTT, u64 (62-bit) limb tier.
//
// Replaces the TPU kernel nfllib_tpu/ops/ntt_mxu_u64.py:_kernel64 (forward
// and inverse).  Canonical outputs are bit-identical to the JAX package at
// every degree 8..65536.
//
// Math (n = n1*n2, X[i1][i2] = x[i2 + n2*i1], tables from
// nfllib_tpu_torch/ops/ntt_mxu_u64.py, built exactly as the JAX package
// builds them and packed for this kernel):
//   forward:  F = W1 @ X    (phi^(n2*i1) folded into W1)
//             Y = F * tw    (omega^(rev(k1)*i2) * phi^i2, 64-bit Shoup)
//             O = Y @ W2
//   inverse:  O @ W2inv, twiddle (n^-1 * phi^-i2 folded in), W1inv @.
// Each mod-p matmul is 8 digit groups G_a = sum_b sum_k digit_a(W^(b)) d_b
// over x's eight offset bytes d_b and the balanced digits of the
// pre-scaled W^(b) = 2^(8b) W mod p: two __dp4a per (a, row, k, col), the
// table word pair of entry (a, row, k) holding digit a of W^(0..7)
// (digit_matmul64.cuh).  |G_a| <= 8 * 128^2 * 256 = 2^25 < 2^26 = bias.
// Recombination is _recombine64 in native 64-bit words: biased groups
// g_a = G_a + 2^26, v = sum_a 2^(8a) g_a mod 2^64,
// a60 = (g4 >> 28) + (g5 >> 20) + (g6 >> 12) + (g7 >> 4),
// q = __umul64hi(a60, floor(2^124/p)), r = v - q*p < 4p, then two
// conditional 2p subtractions around + corr (the offset-byte under-count
// minus the bias over-count), lazy [0, 2p) after the first matmul and
// canonical after the second.  The twiddle is a lazy Shoup product with
// __umul64hi.
//
// Design: a whole u64 polynomial takes 8n bytes (128 KB at 2^14, 512 KB at
// 2^16), over the 227 KB a block may have from 2^15 on, so the transform
// runs as two passes through device memory at every degree.  Pass 1 is the
// first mod-matmul with the twiddle as its epilogue, written lazy to a
// scratch tensor the wrapper allocates; pass 2 is the second mod-matmul.
// Each pass is one block per 32 x 32 output tile of one (polynomial,
// channel).  Tables (2 MB of digit words per channel at 2^14, 8 MB at
// 2^16) are read from global memory through L2 into shared memory.
//
// Bound on this card: 2 stages * 8 groups * 2 dp4a * 128^3 = 67 M dp4a per
// channel-NTT at n = 2^14 on the INT32 pipes, 4x K1's count, plus the
// staging of 8 table word pairs per 32 x 8 chunk entry.  The tensor cores
// (s8 mma.sync / wgmma) are not used yet.
//
// Strict mode (_kernel64): a stage result outside its contract ([0, 2p)
// after the first matmul and after the twiddle, [0, p) at the end) sets a
// per-(polynomial, channel) flag; a third launch poisons every flagged
// block with 0xFFFF_FFFF_FFFF_FFFF, which the caller's _strict_bracket
// turns into an AssertionError.

#include <cstdint>

#include <cuda_runtime.h>

#include "digit_matmul64.cuh"

namespace {

using nfl64::kThreads;
using nfl64::kTile;
using nfl64::sub_if_ge;

constexpr uint32_t kBias = 1u << 26;

struct FusedStage {
  static constexpr int NG = 8;
  __host__ __device__ static constexpr bool uses_lo(int) { return true; }
  __host__ __device__ static constexpr bool uses_hi(int) { return true; }

  const uint2* w;            // [8][wdim][wdim] word pairs of this channel
  int wdim;
  const uint64_t* corr;      // per output row (left) or column (right)
  const uint64_t* tw;        // [R * C] or null (no twiddle epilogue)
  const uint64_t* tws;
  uint64_t p, mbar;
  int C;
  bool left, lazy;

  __device__ void stage_w(int2* ws, int slot, int row, int col,
                          bool valid) const {
    const size_t plane = static_cast<size_t>(wdim) * wdim;
    const size_t off = static_cast<size_t>(row) * wdim + col;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const uint2 e = valid ? __ldg(w + g * plane + off) : make_uint2(0, 0);
      ws[g * nfl64::kSlots + slot] =
          make_int2(static_cast<int>(e.x), static_cast<int>(e.y));
    }
  }

  __device__ uint64_t finish(const int* acc, int r, int c, bool& bad) const {
    uint64_t g[NG];
#pragma unroll
    for (int a = 0; a < NG; ++a)
      g[a] = static_cast<uint32_t>(acc[a] + static_cast<int>(kBias));
    const uint64_t lo = g[0] + (g[1] << 8) + (g[2] << 16) + (g[3] << 24);
    const uint64_t hi = g[4] + (g[5] << 8) + (g[6] << 16) + (g[7] << 24);
    const uint64_t v = lo + (hi << 32);
    const uint64_t a60 = (g[4] >> 28) + (g[5] >> 20) + (g[6] >> 12)
                         + (g[7] >> 4);
    const uint64_t two_p = p + p;
    uint64_t x = v - __umul64hi(a60, mbar) * p;     // < 4p
    x = sub_if_ge(x, two_p);
    x = sub_if_ge(x + corr[left ? r : c], two_p);
    if (!lazy) x = sub_if_ge(x, p);
    bad |= x >= (lazy ? two_p : p);
    if (tw != nullptr) {
      const size_t i = static_cast<size_t>(r) * C + c;
      x = nfl64::shoup_lazy(x, __ldg(tw + i), __ldg(tws + i), p);
      bad |= x >= two_p;
    }
    return x;
  }
};

// One pass: x, out [batch, m, R, C]; w [m, 8, wdim, wdim] word pairs;
// corr [m, cdim]; tw/tws [m, R * C] or null; pvec/mvec [m].
template <bool LEFT, bool STRICT>
__global__ void __launch_bounds__(kThreads) fused64_pass(
    const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
    const uint2* __restrict__ w, const uint64_t* __restrict__ corr,
    const uint64_t* __restrict__ tw, const uint64_t* __restrict__ tws,
    const uint64_t* __restrict__ pvec, const uint64_t* __restrict__ mvec,
    int* __restrict__ flags, int m, int R, int C, bool lazy) {
  const int ch = blockIdx.y, b = blockIdx.z;
  const int tiles_c = (C + kTile - 1) / kTile;
  const int wdim = LEFT ? R : C;
  const size_t slab = static_cast<size_t>(R) * C;
  const size_t off = (static_cast<size_t>(b) * m + ch) * slab;
  FusedStage pol;
  pol.w = w + static_cast<size_t>(ch) * FusedStage::NG * wdim * wdim;
  pol.wdim = wdim;
  pol.corr = corr + static_cast<size_t>(ch) * (LEFT ? R : C);
  pol.tw = tw == nullptr ? nullptr : tw + ch * slab;
  pol.tws = tws == nullptr ? nullptr : tws + ch * slab;
  pol.p = pvec[ch];
  pol.mbar = mvec[ch];
  pol.C = C;
  pol.left = LEFT;
  pol.lazy = lazy;
  bool bad = false;
  nfl64::mod_matmul_tile<FusedStage, LEFT>(
      pol, x + off, out + off, R, C, blockIdx.x / tiles_c,
      blockIdx.x % tiles_c, bad);
  if (STRICT && __syncthreads_or(bad) && threadIdx.x == 0)
    flags[static_cast<size_t>(b) * m + ch] = 1;
}

__global__ void __launch_bounds__(kThreads) poison_flagged(
    uint64_t* __restrict__ out, const int* __restrict__ flags, int n) {
  if (flags[blockIdx.x] == 0) return;
  uint64_t* o = out + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kThreads) o[i] = ~0ull;
}

template <bool LEFT, bool STRICT>
cudaError_t launch_pass(const void* x, void* out, const void* w,
                        const void* corr, const void* tw, const void* tws,
                        const void* pvec, const void* mvec, void* flags,
                        int batch, int m, int R, int C, bool lazy,
                        cudaStream_t s) {
  const int tiles = ((R + kTile - 1) / kTile) * ((C + kTile - 1) / kTile);
  fused64_pass<LEFT, STRICT><<<dim3(tiles, m, batch), kThreads, 0, s>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out),
      static_cast<const uint2*>(w), static_cast<const uint64_t*>(corr),
      static_cast<const uint64_t*>(tw), static_cast<const uint64_t*>(tws),
      static_cast<const uint64_t*>(pvec), static_cast<const uint64_t*>(mvec),
      static_cast<int*>(flags), m, R, C, lazy);
  return cudaGetLastError();
}

template <bool STRICT>
cudaError_t fused64(int inverse, const void* x, void* out, void* scratch,
                    void* flags, const void* w1, const void* w2,
                    const void* tw, const void* tws, const void* corr1,
                    const void* corr2, const void* pvec, const void* mvec,
                    int batch, int m, int n1, int n2, cudaStream_t s) {
  cudaError_t err;
  if (!inverse) {
    err = launch_pass<true, STRICT>(x, scratch, w1, corr1, tw, tws, pvec,
                                    mvec, flags, batch, m, n1, n2, true, s);
    if (err != cudaSuccess) return err;
    err = launch_pass<false, STRICT>(scratch, out, w2, corr2, nullptr,
                                     nullptr, pvec, mvec, flags, batch, m,
                                     n1, n2, false, s);
  } else {
    err = launch_pass<false, STRICT>(x, scratch, w2, corr2, tw, tws, pvec,
                                     mvec, flags, batch, m, n1, n2, true, s);
    if (err != cudaSuccess) return err;
    err = launch_pass<true, STRICT>(scratch, out, w1, corr1, nullptr,
                                    nullptr, pvec, mvec, flags, batch, m,
                                    n1, n2, false, s);
  }
  if (err != cudaSuccess || !STRICT) return err;
  poison_flagged<<<batch * m, kThreads, 0, s>>>(
      static_cast<uint64_t*>(out), static_cast<const int*>(flags), n1 * n2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  x/out/scratch: [batch, m, n1*n2] u64
// residues (scratch takes pass 1's lazy output); flags: [batch * m] int32
// zeros (read only in strict mode); w1: [m, 8, n1, n1] and w2:
// [m, 8, n2, n2] packed u64 digit words; tw/tws: [m, n1*n2]; corr1:
// [m, n1]; corr2: [m, n2]; pvec/mvec: [m] moduli and floor(2^124/p).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int nfl_ntt_fused64(int inverse, int strict, const void* x,
                               void* out, void* scratch, void* flags,
                               const void* w1, const void* w2,
                               const void* tw, const void* tws,
                               const void* corr1, const void* corr2,
                               const void* pvec, const void* mvec, int batch,
                               int m, int n1, int n2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (strict)
    return static_cast<int>(fused64<true>(inverse, x, out, scratch, flags,
                                          w1, w2, tw, tws, corr1, corr2,
                                          pvec, mvec, batch, m, n1, n2, s));
  return static_cast<int>(fused64<false>(inverse, x, out, scratch, flags, w1,
                                         w2, tw, tws, corr1, corr2, pvec,
                                         mvec, batch, m, n1, n2, s));
}
