// K5's warp-specialised variant: the u64 square mod-p matmul with tile
// t's digit dots overlapped with tile t-1's pack and combine.
//
// Replaces the TPU kernel nfllib_tpu/ops/dft_mxu.py:_kernel_u64_pipe
// (K10), which runs block t's MXU dots and block t-1's VPU epilogue in one
// step of a sequential grid, through ping-pong group scratch, so that
// Mosaic may overlap the two.  Its output is K5's, with and without the
// twiddle=(tw, tws) epilogue (matmul_mod(pipelined=True)); the math is
// DftStage<8, TW> of dft_stage.cuh.
//
// On Hopper the grid has no order, so the overlap moves inside a block: a
// persistent block of 512 threads walks tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... of the (polynomial, channel, tile) list.  Threads 0..255
// (the dot warps) run tile t's dp4a dots (digit_matmul64.cuh:tile_dots,
// synchronised among themselves by named barrier 1) and store the 15
// int32 group sums of its 32 x 32 outputs into one of two shared-memory
// group buffers; threads 256..511 (the epilogue warps) meanwhile pack,
// reduce and combine tile t-1 from the other buffer and write it out.  One
// block-wide barrier ends each step, and the two buffers swap roles.  The
// buffers take 2 x 15 x 1024 x 4 = 120 KB of dynamic shared memory, the
// dot staging 32 KB: one block per SM, so the grid is the SM count.
//
// Bound on this card: K5's (the same 22 dp4a a multiply-add position and
// the same bytes; at size 1024 the operations bind it).  The epilogue is
// about 100 integer instructions an output against 22 x size dp4a of dots,
// so at size 1024 the overlap can hide under 1 % of the time; it pays only
// where the contraction is short.  The A/B against K5 is in
// chip_smoke.py.

#include <cstdint>

#include <cuda_runtime.h>

#include "dft_stage.cuh"

namespace {

using nfl64::kKC;
using nfl64::kSlots;
using nfl64::kThreads;
using nfl64::kTile;
using nfl64::kTM;
using nfl64::kTN;

constexpr int kPipeThreads = 2 * kThreads;
constexpr int kNG = 15;
constexpr int kTileOut = kTile * kTile;
constexpr int kGroupBuf = kNG * kTileOut;          // ints in one buffer
constexpr size_t kDynSmem = 2 * kGroupBuf * sizeof(int);

// bar.sync over the 256 dot threads only (barrier 0 is __syncthreads)
struct DotSync {
  __device__ void operator()() const {
    asm volatile("bar.sync 1, %0;" ::"r"(kThreads) : "memory");
  }
};

struct TileRef {
  size_t off;
  int ch, tr, tc;
};

__device__ __forceinline__ TileRef tile_ref(int t, int tiles, int tiles_c,
                                            int m, int R, int C) {
  const int slab = t / tiles, tile = t % tiles;
  return {static_cast<size_t>(slab) * R * C, slab % m, tile / tiles_c,
          tile % tiles_c};
}

template <bool LEFT, bool TW>
__global__ void __launch_bounds__(kPipeThreads, 1) dft_mxu64_pipe_kernel(
    const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
    const uint2* __restrict__ planes, const uint64_t* __restrict__ corr,
    const uint64_t* __restrict__ consts, const uint64_t* __restrict__ tw,
    const uint64_t* __restrict__ tws, int bias, int batch, int m, int R,
    int C) {
  using Stage = nfldft::DftStage<8, TW>;
  static_assert(Stage::NG == kNG, "u64 groups");
  extern __shared__ int gbuf[];                     // [2][kNG][kTileOut]
  __shared__ int2 xs[kSlots];
  __shared__ int2 ws[kNG * kSlots];
  const int tiles_c = (C + kTile - 1) / kTile;
  const int tiles = ((R + kTile - 1) / kTile) * tiles_c;
  const int ntiles = batch * m * tiles;
  const int bx = static_cast<int>(blockIdx.x);
  const int gx = static_cast<int>(gridDim.x);
  const int mine = bx < ntiles ? (ntiles - 1 - bx) / gx + 1 : 0;
  const bool dots = threadIdx.x < kThreads;
  bool bad = false;

  for (int step = 0; step <= mine; ++step) {
    if (dots && step < mine) {
      const TileRef tr = tile_ref(bx + step * gx, tiles,
                                  tiles_c, m, R, C);
      const Stage pol = Stage::make(planes, corr, consts, tw, tws, bias,
                                    tr.ch, R, C, LEFT);
      int acc[kTM][kTN][kNG];
      nfl64::tile_dots<Stage, LEFT>(pol, x + tr.off, R, C, tr.tr, tr.tc,
                                    threadIdx.x, xs, ws, acc, DotSync{});
      int* g = gbuf + (step & 1) * kGroupBuf;
      const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
#pragma unroll
          for (int k = 0; k < kNG; ++k)
            g[k * kTileOut + (ty + 16 * i) * kTile + tx + 16 * j] =
                acc[i][j][k];
    } else if (!dots && step > 0) {
      const TileRef tr = tile_ref(bx + (step - 1) * gx,
                                  tiles, tiles_c, m, R, C);
      const Stage pol = Stage::make(planes, corr, consts, tw, tws, bias,
                                    tr.ch, R, C, LEFT);
      const int* g = gbuf + ((step - 1) & 1) * kGroupBuf;
      for (int o = threadIdx.x - kThreads; o < kTileOut; o += kThreads) {
        const int r = tr.tr * kTile + o / kTile;
        const int c = tr.tc * kTile + o % kTile;
        if (r >= R || c >= C) continue;
        int a[kNG];
#pragma unroll
        for (int k = 0; k < kNG; ++k) a[k] = g[k * kTileOut + o];
        out[tr.off + static_cast<size_t>(r) * C + c] =
            pol.finish(a, r, c, bad);
      }
    }
    __syncthreads();
  }
}

template <bool LEFT, bool TW>
int launch(int grid, cudaStream_t s, const uint64_t* x, uint64_t* o,
           const uint2* pl, const uint64_t* co, const uint64_t* cs,
           const uint64_t* tw, const uint64_t* tws, int bias, int batch,
           int m, int r, int c) {
  const cudaError_t err = cudaFuncSetAttribute(
      dft_mxu64_pipe_kernel<LEFT, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDynSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dft_mxu64_pipe_kernel<LEFT, TW><<<grid, kPipeThreads, kDynSmem, s>>>(
      x, o, pl, co, cs, tw, tws, bias, batch, m, r, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes, with nfl_dft_mxu64's arguments and
// K5's output.  Returns the cudaError_t of the set-up or the launch (0 on
// success).
extern "C" int nfl_dft_mxu64_pipe(int left, const void* x, void* out,
                                  const void* planes, const void* corr,
                                  const void* consts, const void* tw,
                                  const void* tws, int bias, int batch,
                                  int m, int r, int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = static_cast<long>((r + kTile - 1) / kTile)
      * ((c + kTile - 1) / kTile) * m * batch;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  const auto* xi = static_cast<const uint64_t*>(x);
  auto* o = static_cast<uint64_t*>(out);
  const auto* pl = static_cast<const uint2*>(planes);
  const auto* co = static_cast<const uint64_t*>(corr);
  const auto* cs = static_cast<const uint64_t*>(consts);
  const auto* t = static_cast<const uint64_t*>(tw);
  const auto* ts = static_cast<const uint64_t*>(tws);
  if (t != nullptr)
    return left ? launch<true, true>(grid, s, xi, o, pl, co, cs, t, ts, bias,
                                     batch, m, r, c)
                : launch<false, true>(grid, s, xi, o, pl, co, cs, t, ts,
                                      bias, batch, m, r, c);
  return left ? launch<true, false>(grid, s, xi, o, pl, co, cs, t, ts, bias,
                                    batch, m, r, c)
              : launch<false, false>(grid, s, xi, o, pl, co, cs, t, ts, bias,
                                     batch, m, r, c);
}
