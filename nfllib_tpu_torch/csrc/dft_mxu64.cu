// Square mod-p matmul by a per-channel [size, size] matrix, u64 limb tier.
//
// Replaces the TPU kernel nfllib_tpu/ops/dft_mxu.py:_kernel_u64 with its
// epilogue _pack_combine_u64, as matmul_mod runs it (strict=True,
// canonical output), with or without the twiddle=(tw, tws) Shoup epilogue:
// out = M @ X along axis -2 ("left") or X @ M along axis -1 ("right") of
// [batch, m, R, C] residues, size 8..1024.  The large-degree u64 NTT
// (ops/ntt_mxu_u64.py:_large_run64) and the distributed four-step NTT's
// local sub-DFTs (parallel/ntt_dist.py) run it.  Math: dft_stage.cuh
// (DftStage<8, TW>::finish on the 15 group sums).
//
// Design: two launches on the caller's stream.  digit_split writes X's 8
// offset-byte planes K-major into the caller's scratch; then one
// 256-thread block per 64 x 32 output tile of one (polynomial, channel)
// runs the 64 digit products on the int8 tensor cores (digit_mma.cuh:
// mma.sync m16n8k32 through a 4-stage cp.async ring of 24 KB k-chunks) and
// finishes each output from the 15 accumulators its thread holds (120
// registers of them; one block an SM).  The grid covers (tile, channel,
// polynomial) with no order between blocks.
// The twiddle epilogue reads tw/tws at the output's own position.
//
// Bound on this card: at n = 2^20 (size 1024, batch 2, m = 2) one launch
// is 2^30 multiply-add positions a channel x 64 digit products x 2 int8
// operations = 550 G operations, 0.2778 ms at the dense int8 peak of
// 1,979 T/s; its bytes (x, out, the tables and the scratch written and
// read once, 151 MB) take 0.045 ms, so the operations bind it.  The design
// feeds the tensor cores from shared memory in K-major planes and keeps
// all 15 group sums of an output in one thread's registers, so no group
// sum goes through memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "dft_stage.cuh"
#include "digit_mma.cuh"

namespace nflmma {

// X's offset-byte planes, K-major, k-chunked and swizzled as
// digit_mma.cuh stores planes: byte (k % 32) ^ (16 ((o >> 2) & 1)) of
// d[slab][b][k / 32][o] = byte_b(x) - 128 with
// x = X[k][o] (LEFT) or X[o][k] (RIGHT) of slab [R][C]; zero for
// size <= k < kp.  A block covers 32 o x 64 k of one slab (channel
// blockIdx.y of polynomial blockIdx.z, as the main kernel's grid): it reads
// the x tile coalesced along C, then each thread packs 4 consecutive k of
// one o into a 32-bit word for each of the 8 planes.
constexpr int kSplitO = 32, kSplitK = 64, kSplitThreads = 256;

template <bool LEFT>
__global__ void __launch_bounds__(kSplitThreads) digit_split_kernel(
    const uint64_t* __restrict__ x, int8_t* __restrict__ d, int R, int C,
    int kp) {
  __shared__ uint64_t xs[kSplitO][kSplitK + 1];
  const int O = LEFT ? C : R, K = LEFT ? R : C;
  const int tiles_k = (kp + kSplitK - 1) / kSplitK;
  const int o0 = (blockIdx.x / tiles_k) * kSplitO;
  const int k0 = (blockIdx.x % tiles_k) * kSplitK;
  const size_t slab =
      static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const uint64_t* xb = x + slab * R * C;
  for (int id = threadIdx.x; id < kSplitO * kSplitK; id += kSplitThreads) {
    const int oo = LEFT ? id % kSplitO : id / kSplitK;
    const int kk = LEFT ? id / kSplitO : id % kSplitK;
    const int o = o0 + oo, k = k0 + kk;
    // 0x80 bytes are zero digits: the padding past the contraction
    uint64_t v = 0x8080808080808080ull;
    if (o < O && k < K)
      v = xb[LEFT ? static_cast<size_t>(k) * C + o
                  : static_cast<size_t>(o) * C + k];
    xs[oo][kk] = v;
  }
  __syncthreads();
  int8_t* db = d + slab * kPlanes * O * kp;
  for (int id = threadIdx.x; id < kSplitO * kSplitK / 4;
       id += kSplitThreads) {
    const int oo = id / (kSplitK / 4), k4 = id % (kSplitK / 4);
    const int o = o0 + oo, k = k0 + 4 * k4;
    if (o >= O || k >= kp) continue;
    const uint64_t v0 = xs[oo][4 * k4], v1 = xs[oo][4 * k4 + 1];
    const uint64_t v2 = xs[oo][4 * k4 + 2], v3 = xs[oo][4 * k4 + 3];
#pragma unroll
    for (int b = 0; b < kPlanes; ++b) {
      const uint32_t w = static_cast<uint32_t>((v0 >> (8 * b)) & 0xFF)
          | static_cast<uint32_t>((v1 >> (8 * b)) & 0xFF) << 8
          | static_cast<uint32_t>((v2 >> (8 * b)) & 0xFF) << 16
          | static_cast<uint32_t>((v3 >> (8 * b)) & 0xFF) << 24;
      *reinterpret_cast<uint32_t*>(
          db + ((static_cast<size_t>(b) * (kp / kKC) + k / kKC) * O + o) * kKC
          + ((k % kKC) ^ (((o >> 2) & 1) << 4))) = w ^ 0x80808080u;
    }
  }
}

void digit_split(bool left, const uint64_t* x, int8_t* d, int batch, int m,
                 int R, int C, int kp, cudaStream_t s) {
  const int O = left ? C : R;
  const dim3 grid(((O + kSplitO - 1) / kSplitO)
                      * ((kp + kSplitK - 1) / kSplitK),
                  m, batch);
  if (left)
    digit_split_kernel<true><<<grid, kSplitThreads, 0, s>>>(x, d, R, C, kp);
  else
    digit_split_kernel<false><<<grid, kSplitThreads, 0, s>>>(x, d, R, C, kp);
}

}  // namespace nflmma

namespace {

using namespace nflmma;

constexpr int kStages = 4;
constexpr size_t kDynSmem = kStages * kStageBytes;       // 96 KB

// x, out [batch, m, R, C]; table [m, 8, kp / 32, size, 32]; d [batch, m,
// 8, kp / 32, other, 32]; corr [m, size]; consts [m, 4] = p, mbar, chi,
// chi_shoup; tw/tws [m, R, C] (TW only)
template <bool LEFT, bool TW>
__global__ void __launch_bounds__(kMmaThreads, 1) dft_mxu64_kernel(
    uint64_t* __restrict__ out, const int8_t* __restrict__ table,
    const int8_t* __restrict__ d, const uint64_t* __restrict__ corr,
    const uint64_t* __restrict__ consts, const uint64_t* __restrict__ tw,
    const uint64_t* __restrict__ tws, int bias, int m, int R, int C) {
  using Stage = nfldft::DftStage<8, TW>;
  extern __shared__ __align__(128) uint8_t ring[];
  const int ch = blockIdx.y, b = blockIdx.z;
  const int slab = b * m + ch;
  const int tiles_n = (C + kBN - 1) / kBN;
  const int i0 = (blockIdx.x / tiles_n) * kBM;
  const int j0 = (blockIdx.x % tiles_n) * kBN;
  const int kp = padded_k(LEFT ? R : C);
  const int nk = kp / kKC;
  const Operands ops = operands(LEFT, table, d, slab, ch, R, C, kp);
  const int t = threadIdx.x, w = t / 32, lane = t % 32;

  Acc acc;
  zero(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_chunk<kMmaThreads>(ring + s * kStageBytes, ops.P, ops.Q, i0, j0,
                              s, t);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kc + kStages - 1;
    if (next < nk)
      load_chunk<kMmaThreads>(ring + (next % kStages) * kStageBytes, ops.P,
                              ops.Q, i0, j0, next, t);
    cp_async_commit();
    chunk_mma(ring + (kc % kStages) * kStageBytes, w, lane, acc);
  }
  cp_async_wait<0>();

  const Stage pol = Stage::make(nullptr, corr, consts, tw, tws, bias, ch, R,
                                C, LEFT);
  uint64_t* ob = out + static_cast<size_t>(slab) * R * C;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = i0 + acc_row(w, lane, e);
      const int c = j0 + acc_col(w, lane, j, e);
      int g[kNG];
#pragma unroll
      for (int k = 0; k < kNG; ++k) g[k] = acc[k][j][e];
      if (r < R && c < C)
        ob[static_cast<size_t>(r) * C + c] = pol.finish(g, r, c, bad);
    }
}

template <bool LEFT, bool TW>
int launch(const dim3& grid, cudaStream_t s, uint64_t* o, const int8_t* tb,
           const int8_t* d, const uint64_t* co, const uint64_t* cs,
           const uint64_t* tw, const uint64_t* tws, int bias, int m, int r,
           int c) {
  const cudaError_t err = cudaFuncSetAttribute(
      dft_mxu64_kernel<LEFT, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDynSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dft_mxu64_kernel<LEFT, TW><<<grid, kMmaThreads, kDynSmem, s>>>(
      o, tb, d, co, cs, tw, tws, bias, m, r, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  x/out: [batch, m, r, c] u64 residues;
// table: [m, 8, kp / 32, size, 32] int8 digit planes, K-major for the side
// and k-chunked (DftTables.mma_planes; size = r for left, c for right, kp =
// max(size, 32)); corr: [m, size]; consts: [m, 4]; tw/tws: [m, r, c] or
// both null (no twiddle epilogue); scratch: [batch, m, 8, kp / 32, other,
// 32] int8
// (other = c for left, r for right), overwritten; bias = 2^bias_bits.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int nfl_dft_mxu64(int left, const void* x, void* out,
                             const void* table, const void* corr,
                             const void* consts, const void* tw,
                             const void* tws, void* scratch, int bias,
                             int batch, int m, int r, int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kp = padded_k(left ? r : c);
  auto* d = static_cast<int8_t*>(scratch);
  digit_split(left != 0, static_cast<const uint64_t*>(x), d, batch, m, r, c,
              kp, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((r + kBM - 1) / kBM) * ((c + kBN - 1) / kBN), m, batch);
  auto* o = static_cast<uint64_t*>(out);
  const auto* tb = static_cast<const int8_t*>(table);
  const auto* co = static_cast<const uint64_t*>(corr);
  const auto* cs = static_cast<const uint64_t*>(consts);
  const auto* t = static_cast<const uint64_t*>(tw);
  const auto* ts = static_cast<const uint64_t*>(tws);
  if (t != nullptr)
    return left ? launch<true, true>(grid, s, o, tb, d, co, cs, t, ts, bias, m,
                                     r, c)
                : launch<false, true>(grid, s, o, tb, d, co, cs, t, ts, bias,
                                      m, r, c);
  return left ? launch<true, false>(grid, s, o, tb, d, co, cs, t, ts, bias, m,
                                    r, c)
              : launch<false, false>(grid, s, o, tb, d, co, cs, t, ts, bias, m,
                                     r, c);
}
