// Square mod-p matmul by a per-channel [size, size] matrix, u64 limb tier.
//
// Replaces the TPU kernel nfllib_tpu/ops/dft_mxu.py:_kernel_u64 with its
// epilogue _pack_combine_u64, as matmul_mod runs it (strict=True,
// canonical output), with or without the twiddle=(tw, tws) Shoup epilogue:
// out = M @ X along axis -2 ("left") or X @ M along axis -1 ("right") of
// [batch, m, R, C] residues, size 8..1024.  The large-degree u64 NTT
// (ops/ntt_mxu_u64.py:_large_run64) and the distributed four-step NTT's
// local sub-DFTs (parallel/ntt_dist.py) run it.  Math: dft_stage.cuh
// (DftStage<8, TW>).
//
// Design: one 256-thread block per 32 x 32 output tile of one (polynomial,
// channel), looping over the contraction in chunks of 8 staged in shared
// memory (digit_matmul64.cuh); the grid covers (tile, channel, polynomial)
// with no order between blocks.  The twiddle epilogue reads tw/tws at the
// output's own position, so it costs one read of each per output and no
// extra pass through device memory.
//
// Bound on this card: at n = 2^20 (n1 = n2 = 1024) one stage of one
// channel is 1024^3 multiply-add positions x 22 dp4a = 23.6 G dp4a on the
// INT32 pipes; counted as int8 tensor-core operations (8 a dp4a at
// 1,979 T/s) the operations bind it, well above its bytes.  The tensor
// cores are not used yet: that is the next step for this kernel.

#include <cstdint>

#include <cuda_runtime.h>

#include "dft_stage.cuh"

namespace {

using nfl64::kThreads;
using nfl64::kTile;

// x, out [batch, m, R, C]; planes [m, size, size]; corr [m, size];
// consts [m, 4] = p, mbar, chi, chi_shoup; tw/tws [m, R, C] (TW only).
template <bool LEFT, bool TW>
__global__ void __launch_bounds__(kThreads) dft_mxu64_kernel(
    const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
    const uint2* __restrict__ planes, const uint64_t* __restrict__ corr,
    const uint64_t* __restrict__ consts, const uint64_t* __restrict__ tw,
    const uint64_t* __restrict__ tws, int bias, int m, int R, int C) {
  using Stage = nfldft::DftStage<8, TW>;
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
void launch(int left, const dim3& grid, cudaStream_t s, const uint64_t* x,
            uint64_t* o, const uint2* pl, const uint64_t* co,
            const uint64_t* cs, const uint64_t* tw, const uint64_t* tws,
            int bias, int m, int r, int c) {
  if (left)
    dft_mxu64_kernel<true, TW><<<grid, kThreads, 0, s>>>(
        x, o, pl, co, cs, tw, tws, bias, m, r, c);
  else
    dft_mxu64_kernel<false, TW><<<grid, kThreads, 0, s>>>(
        x, o, pl, co, cs, tw, tws, bias, m, r, c);
}

}  // namespace

// Plain C entry point for ctypes.  x/out: [batch, m, r, c] u64 residues;
// planes: [m, size, size] u64 digit entries (size = r for left, c for
// right); corr: [m, size]; consts: [m, 4]; tw/tws: [m, r, c] or both null
// (no twiddle epilogue); bias = 2^bias_bits.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int nfl_dft_mxu64(int left, const void* x, void* out,
                             const void* planes, const void* corr,
                             const void* consts, const void* tw,
                             const void* tws, int bias, int batch, int m,
                             int r, int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ((r + kTile - 1) / kTile) * ((c + kTile - 1) / kTile);
  const dim3 grid(tiles, m, batch);
  const auto* xi = static_cast<const uint64_t*>(x);
  auto* o = static_cast<uint64_t*>(out);
  const auto* pl = static_cast<const uint2*>(planes);
  const auto* co = static_cast<const uint64_t*>(corr);
  const auto* cs = static_cast<const uint64_t*>(consts);
  const auto* t = static_cast<const uint64_t*>(tw);
  const auto* ts = static_cast<const uint64_t*>(tws);
  if (t != nullptr)
    launch<true>(left, grid, s, xi, o, pl, co, cs, t, ts, bias, m, r, c);
  else
    launch<false>(left, grid, s, xi, o, pl, co, cs, t, ts, bias, m, r, c);
  return static_cast<int>(cudaGetLastError());
}
