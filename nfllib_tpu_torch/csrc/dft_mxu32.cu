// Square mod-p matmul by a per-channel [size, size] matrix, u32 limb tier.
//
// Replaces the TPU kernel nfllib_tpu/ops/dft_mxu.py:_kernel_u32 (K9), as
// matmul_mod runs it (strict=True, canonical output), with or without the
// twiddle=(tw, tws) Shoup epilogue: out = M @ X along axis -2 ("left") or
// X @ M along axis -1 ("right") of [batch, m, R, C] u32 residues, size
// 8..1024.  The distributed four-step NTT's local column and row sub-DFTs
// (parallel/ntt_dist.py) run it on u32 rings.
//
// It is the 4-digit instantiation of K5's template (dft_stage.cuh,
// DftStage<4, TW>) on the same tile loop (digit_matmul64.cuh): the x word
// gives one dp4a operand of 4 offset bytes, the 7 digit groups k = 0..6
// hold 1, 2, 3, 4, 3, 2, 1 digit products, each one dp4a word, so a
// multiply-add position costs 7 dp4a.  Its own pack: each part of 4 biased
// groups is exact in one 64-bit word (< 2^51), reduced by Barrett with
// a28 = floor(v/2^28) and floor(2^60/p) in 32-bit words, as the JAX kernel
// does with (hi, lo) carry chains; the outputs are canonical, so they are
// the JAX package's.  Storage is int32 holding the u32 words.
//
// Bound on this card: on the u32 distributed path (n = 2^14, m = 17,
// batch 64, n1 = n2 = 128) one launch is 128^3 x 1088 positions x 16
// digit MACs = 73 G int8 operations, 0.037 ms at 1,979 T/s, and 71.3 MB in
// + 71.3 MB out, 0.043 ms at 3.35 TB/s: the bytes bind it.  The kernel
// issues dp4a on the INT32 pipes (7 per position, 1088 x 128^3 x 7 =
// 16 G dp4a), so it runs far above that bound; moving the dots to the int8
// tensor cores is the next step.

#include <cstdint>

#include <cuda_runtime.h>

#include "dft_stage.cuh"

namespace {

using nfl64::kThreads;
using nfl64::kTile;

// x, out [batch, m, R, C] u32; planes [m, size, size] u32 (4 digit
// bytes); corr [m, size]; consts [m, 4] = p, floor(2^60/p), chi,
// chi_shoup (u64 words holding u32 values); tw/tws [m, R, C] (TW only).
template <bool LEFT, bool TW>
__global__ void __launch_bounds__(kThreads) dft_mxu32_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ planes, const uint64_t* __restrict__ corr,
    const uint64_t* __restrict__ consts, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ tws, int bias, int m, int R, int C) {
  using Stage = nfldft::DftStage<4, TW>;
  const int ch = blockIdx.y, b = blockIdx.z;
  const int tiles_c = (C + kTile - 1) / kTile;
  const size_t off = (static_cast<size_t>(b) * m + ch) * R * C;
  const Stage pol = Stage::make(planes, corr, consts, tw, tws, bias, ch, R,
                                C, LEFT);
  bool bad = false;
  nfl64::mod_matmul_tile<Stage, LEFT>(pol, x + off, out + off, R, C,
                                      blockIdx.x / tiles_c,
                                      blockIdx.x % tiles_c, bad);
}

template <bool TW>
void launch(int left, const dim3& grid, cudaStream_t s, const uint32_t* x,
            uint32_t* o, const uint32_t* pl, const uint64_t* co,
            const uint64_t* cs, const uint32_t* tw, const uint32_t* tws,
            int bias, int m, int r, int c) {
  if (left)
    dft_mxu32_kernel<true, TW><<<grid, kThreads, 0, s>>>(
        x, o, pl, co, cs, tw, tws, bias, m, r, c);
  else
    dft_mxu32_kernel<false, TW><<<grid, kThreads, 0, s>>>(
        x, o, pl, co, cs, tw, tws, bias, m, r, c);
}

}  // namespace

// Plain C entry point for ctypes.  x/out: [batch, m, r, c] u32 residues;
// planes: [m, size, size] u32 digit entries (size = r for left, c for
// right); corr: [m, size] u64 words; consts: [m, 4] u64 words; tw/tws:
// [m, r, c] u32 or both null (no twiddle epilogue); bias = 2^bias_bits.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int nfl_dft_mxu32(int left, const void* x, void* out,
                             const void* planes, const void* corr,
                             const void* consts, const void* tw,
                             const void* tws, int bias, int batch, int m,
                             int r, int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ((r + kTile - 1) / kTile) * ((c + kTile - 1) / kTile);
  const dim3 grid(tiles, m, batch);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  const auto* pl = static_cast<const uint32_t*>(planes);
  const auto* co = static_cast<const uint64_t*>(corr);
  const auto* cs = static_cast<const uint64_t*>(consts);
  const auto* t = static_cast<const uint32_t*>(tw);
  const auto* ts = static_cast<const uint32_t*>(tws);
  if (t != nullptr)
    launch<true>(left, grid, s, xi, o, pl, co, cs, t, ts, bias, m, r, c);
  else
    launch<false>(left, grid, s, xi, o, pl, co, cs, t, ts, bias, m, r, c);
  return static_cast<int>(cudaGetLastError());
}
