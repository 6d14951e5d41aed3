// Square mod-p matmul by a per-channel [size, size] matrix, u32 limb tier.
//
// Replaces the TPU kernel nfllib_tpu/ops/dft_mxu.py:_kernel_u32 (K9), as
// matmul_mod runs it (strict=True, canonical output), with or without the
// twiddle=(tw, tws) Shoup epilogue: out = M @ X along axis -2 ("left") or
// X @ M along axis -1 ("right") of [batch, m, R, C] u32 residues, size
// 8..1024.  The distributed four-step NTT's local column and row sub-DFTs
// (parallel/ntt_dist.py) run it on u32 rings.
//
// It is K5's kernel (dft_mxu64.cu) at 4 digits, on the same tensor-core
// engine (digit_mma.cuh, NDIG = 4): digit_split writes the 4 offset-byte
// planes of the u32 words K-major into the caller's scratch, and each
// 64 x 32 output tile runs the 16 digit products as int8 mma.sync m16n8k32
// (32 a warp a k-chunk of 32) into 7 group sums k = 0..6 (1, 2, 3, 4, 3,
// 2, 1 products each), finished by DftStage<4, TW>: each part of 4 biased
// groups is exact in one 64-bit word (< 2^51), reduced by Barrett with
// a28 = floor(v/2^28) and floor(2^60/p) in 32-bit words, as the JAX kernel
// does with (hi, lo) carry chains; the outputs are canonical, so they are
// the JAX package's.  Storage is int32 holding the u32 words.  56
// accumulator registers a thread and 48 KB of ring leave room for two
// blocks an SM.
//
// Bound on this card: on the u32 distributed path (n = 2^14, m = 17,
// batch 64, n1 = n2 = 128) one launch is 128^3 x 1088 slabs x 16 digit
// products x 2 = 73 G int8 operations, 0.037 ms at 1,979 T/s, under its
// bytes: 71.3 MB in, 71.3 MB out and the 71.3 MB digit-plane scratch
// written and read, 0.085 ms at 3.35 TB/s.

#include <cstdint>

#include <cuda_runtime.h>

#include "digit_mma.cuh"

// Plain C entry point for ctypes, with nfl_dft_mxu64's arguments for u32
// words: x/out [batch, m, r, c]; table: [m, 4, kp / 32, size, 32] int8
// (DftTables.mma_planes); corr: [m, size] u64 words; consts: [m, 4] u64
// words = p, floor(2^60/p), chi, chi_shoup; tw/tws: [m, r, c] u32 or both
// null; scratch: [batch, m, 4, kp / 32, other, 32] int8; flags: [batch * m]
// int32 zeros or null.  Returns the cudaError_t of the launches.
extern "C" int nfl_dft_mxu32(int left, const void* x, void* out,
                             const void* table, const void* corr,
                             const void* consts, const void* tw,
                             const void* tws, void* scratch, void* flags,
                             int bias, int batch, int m, int r, int c,
                             void* stream) {
  return nflmma::dft_mma<4>(left, x, out, table, corr, consts, tw, tws,
                            scratch, flags, bias, batch, m, r, c,
                            static_cast<cudaStream_t>(stream));
}
