// Square mod-p matmul by a per-channel [size, size] matrix, u64 limb tier.
//
// Replaces the TPU kernel nfllib_tpu/ops/dft_mxu.py:_kernel_u64 with its
// epilogue _pack_combine_u64, as matmul_mod runs it (strict=True,
// canonical output), with or without the twiddle=(tw, tws) Shoup epilogue:
// out = M @ X along axis -2 ("left") or X @ M along axis -1 ("right") of
// [batch, m, R, C] residues, size 8..1024 (2 and 4 for the u64 NTT's own
// small degrees).  It also carries the TPU kernel
// nfllib_tpu/ops/ntt_mxu_u64.py:_kernel64 (K4): the u64 negacyclic NTT of
// degree 8..2^20 is two launches of it (ops/ntt_mxu_u64.py:_large_run64),
// the column DFT with the twiddle as its epilogue, then the row DFT.  The
// distributed four-step NTT's local sub-DFTs (parallel/ntt_dist.py) run it
// too.  Math: dft_stage.cuh (DftStage<8, TW>::finish on the 15 group sums).
//
// Design (digit_mma.cuh, NDIG = 8): two launches on the caller's stream.
// digit_split writes X's 8 offset-byte planes K-major into the caller's
// scratch; then one 256-thread block per 64 x 32 output tile of one
// (polynomial, channel) runs the 64 digit products on the int8 tensor cores
// (mma.sync m16n8k32 through a 4-stage cp.async ring of 24 KB k-chunks) and
// finishes each output from the 15 accumulators its thread holds (120
// registers of them; one block an SM).  The grid covers (tile, channel,
// polynomial) with no order between blocks; the wrapper launches at most
// 65535 polynomials at a time (grid.z).  The twiddle epilogue reads tw/tws
// at the output's own position.  In strict mode (a flags vector) an input
// not below p or an output that breaks the stage contract flags its
// (polynomial, channel) block, and a third launch poisons every flagged
// block, as K4 did.
//
// Bound on this card: at n = 2^20 (size 1024, batch 2, m = 2) one launch
// is 2^30 multiply-add positions a channel x 64 digit products x 2 int8
// operations = 550 G operations, 0.2778 ms at the dense int8 peak of
// 1,979 T/s; its bytes (x, out, the tables and the scratch written and
// read once, 151 MB) take 0.045 ms, so the operations bind it.  As K4, at
// u64 2^14 x 8 x 64 (size 128), a transform is 2 launches x 512 slabs x
// 128^3 x 128 = 275 G operations, 0.139 ms, under its bytes (x, out and
// the scratch of each pass, 537 MB), 0.160 ms.  The design feeds the tensor
// cores from shared memory in K-major planes and keeps all 15 group sums
// of an output in one thread's registers, so no group sum goes through
// memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "digit_mma.cuh"

namespace nflmma {

cudaError_t digit_split64(bool left, const void* x, int8_t* d,
                          const uint64_t* consts, int* flags, int batch, int m,
                          int R, int C, int kp, cudaStream_t s) {
  return digit_split<8>(left, x, d, consts, flags, batch, m, R, C, kp, s);
}

cudaError_t poison64(void* out, const int* flags, int slabs, int n,
                     cudaStream_t s) {
  return poison<uint64_t>(out, flags, slabs, n, s);
}

}  // namespace nflmma

// Plain C entry point for ctypes.  x/out: [batch, m, r, c] u64 residues;
// table: [m, 8, kp / 32, size, 32] int8 digit planes, K-major for the side
// and k-chunked (DftTables.mma_planes; size = r for left, c for right, kp =
// max(size, 32)); corr: [m, size]; consts: [m, 4]; tw/tws: [m, r, c] or
// both null (no twiddle epilogue); scratch: [batch, m, 8, kp / 32, other,
// 32] int8 (other = c for left, r for right), overwritten; flags: [batch *
// m] int32 zeros (strict mode) or null; bias = 2^bias_bits.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int nfl_dft_mxu64(int left, const void* x, void* out,
                             const void* table, const void* corr,
                             const void* consts, const void* tw,
                             const void* tws, void* scratch, void* flags,
                             int bias, int batch, int m, int r, int c,
                             void* stream) {
  return nflmma::dft_mma<8, false>(left, x, out, table, corr, consts, tw,
                                   tws, scratch, flags, bias, batch, m, r, c,
                                   static_cast<cudaStream_t>(stream));
}

// The message of a cudaError_t the entry points of the library return
extern "C" const char* nfl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
