// K5's warp-specialised variant: the u64 square mod-p matmul with tile
// t's digit products overlapped with tile t-1's pack and combine.
//
// Replaces the TPU kernel nfllib_tpu/ops/dft_mxu.py:_kernel_u64_pipe
// (K10), which runs block t's MXU dots and block t-1's VPU epilogue in one
// step of a sequential grid, through ping-pong group scratch, so that
// Mosaic may overlap the two.  Its output is K5's, with and without the
// twiddle=(tw, tws) epilogue (matmul_mod(pipelined=True)); the math is
// DftStage<8, TW>::finish of dft_stage.cuh, the 64 digit products per
// multiply-add position K5's, after the same digit_split prologue.
//
// On Hopper the grid has no order, so the overlap moves inside a block: a
// persistent block of 384 threads (three warpgroups) walks tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... of the (polynomial, channel,
// 64 x 32 tile) list, with three roles:
//   * warp 11, the producer, stages the k-chunks of every tile the block
//     walks into a 4-deep ring, 24 KB a stage: one thread issues 16 bulk
//     (TMA) copies a chunk, one contiguous run of rows x 32 bytes for
//     each plane of P and Q, counted on the stage's mbarrier;
//   * warps 0-7 run K5's tile loop on each staged chunk (digit_mma.cuh:
//     chunk_mma, int8 mma.sync m16n8k32) and release the stage; at the end
//     of a tile they store the 15 x 2048 group sums into one shared-memory
//     group buffer (120 KB) once the epilogue has emptied it;
//   * warps 8-10 pack, reduce and combine the previous tile from the group
//     buffer and write it out while the MMA warps run the next one.
// The MMA warps hold 120 accumulators and 36 fragment registers a thread:
// more than the 168 that ptxas leaves each of 384 threads (it counts whole
// warpgroups, so 320 or 352 threads get no more, and the loop spills), so
// setmaxnreg moves registers to them from the third warpgroup.
// A chunk is full when its stage's mbarrier completes a phase; the other
// handshakes are named barriers (bar.sync by the waiting side, bar.arrive
// by the other): 1-4 chunk free, 5 groups stored, 6 groups consumed.  96 KB
// of ring and 120 KB of group buffer leave one block an SM, so the grid is
// the SM count.
//
// Bound on this card: K5's (the same 64 digit products, 128 int8
// operations a multiply-add position, and the same bytes; at size 1024 the
// operations bind it).  At size 1024 the epilogue is a small part of a
// tile's MMA time, so the overlap hides little there; it pays where the
// contraction is short.  The producer needs one thread: fed by cp.async
// from two warps, the ring, not the MMAs, set the pace.  The A/B against
// K5 is in chip_smoke.py.

#include <cstdint>

#include <cuda_runtime.h>

#include "dft_stage.cuh"
#include "digit_mma.cuh"

namespace {

using namespace nflmma;

constexpr int kStages = 4;
constexpr int kEpiWarps = 3, kProducerWarps = 1;
constexpr int kEpiThreads = 32 * kEpiWarps;
constexpr int kProducerThreads = 32 * kProducerWarps;
constexpr int kProducer = kMmaWarps + kEpiWarps;     // the producer warp
constexpr int kPipeThreads = kMmaThreads + kEpiThreads + kProducerThreads;
// Registers a thread: the launch gives 65536 / 384 = 168; setmaxnreg moves
// what the third warpgroup frees, (168 - 72) x 128, to the two MMA
// warpgroups, (216 - 168) x 256.  An .inc that asks for more than the
// block has freed never returns.
constexpr int kLaunchRegs = 168, kMmaRegs = 216, kOtherRegs = 72;
static_assert(kPipeThreads == 3 * 128, "three whole warpgroups");
static_assert((kMmaRegs - kLaunchRegs) * kMmaThreads
                  <= (kLaunchRegs - kOtherRegs) * (kPipeThreads - kMmaThreads),
              "setmaxnreg: no more taken than freed");
constexpr int kTileOut = kBM * kBN;
constexpr size_t kRingBytes = kStages * kStageBytes;           // 96 KB
constexpr size_t kGroupBytes = kNG * kTileOut * sizeof(int);   // 120 KB
constexpr size_t kDynSmem = kRingBytes + kGroupBytes + kStages * 8;

constexpr int kBarFree = 1;
constexpr int kBarGroups = 1 + kStages, kBarGroupsFree = kBarGroups + 1;
constexpr int kRingCount = kMmaThreads + kProducerThreads;
constexpr int kGroupCount = kMmaThreads + kEpiThreads;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrives on `bar` and adds `bytes` to the transfers its phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// one bulk (TMA) copy of `bytes` contiguous bytes, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

struct TileRef {
  int slab, ch, i0, j0;
};

__device__ __forceinline__ TileRef tile_ref(int t, int tiles, int tiles_n,
                                            int m) {
  const int slab = t / tiles, tile = t % tiles;
  return {slab, slab % m, (tile / tiles_n) * kBM, (tile % tiles_n) * kBN};
}

template <bool LEFT, bool TW>
__global__ void __launch_bounds__(kPipeThreads, 1) dft_mxu64_pipe_kernel(
    uint64_t* __restrict__ out, const int8_t* __restrict__ table,
    const int8_t* __restrict__ d, const uint64_t* __restrict__ corr,
    const uint64_t* __restrict__ consts, const uint64_t* __restrict__ tw,
    const uint64_t* __restrict__ tws, int bias, int batch, int m, int R,
    int C) {
  using Stage = nfldft::DftStage<8, TW>;
  static_assert(Stage::NG == kNG, "u64 groups");
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* ring = smem;
  int* gbuf = reinterpret_cast<int*>(smem + kRingBytes);  // [kNG][kTileOut]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes
                                               + kGroupBytes);  // [kStages]
  const int tiles_n = (C + kBN - 1) / kBN;
  const int tiles = ((R + kBM - 1) / kBM) * tiles_n;
  const int ntiles = batch * m * tiles;
  const int bx = static_cast<int>(blockIdx.x);
  const int gx = static_cast<int>(gridDim.x);
  const int mine = bx < ntiles ? (ntiles - 1 - bx) / gx + 1 : 0;
  const int kp = padded_k(LEFT ? R : C);
  const int nk = kp / kKC;
  const int total = mine * nk;          // chunks this block walks
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x < kStages) mbar_init(full + threadIdx.x, 1);
  __syncthreads();

  // setmaxnreg inside each role's branch, so that ptxas sees where each
  // register budget holds
  if (w < kMmaWarps) {
    reg_alloc<kMmaRegs>();
    int it = 0;
    for (int step = 0; step < mine; ++step) {
      Acc acc;
      zero(acc);
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % kStages;
        mbar_wait(full + s, (it / kStages) & 1);
        chunk_mma(ring + s * kStageBytes, w, lane, acc);
        // the stage's fragments are in registers: the producer may refill
        // it (it waits only for the chunks it has still to stage)
        if (it + kStages < total) bar_arrive(kBarFree + s, kRingCount);
      }
      if (step > 0) bar_sync(kBarGroupsFree, kGroupCount);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = acc_row(w, lane, e) * kBN + acc_col(w, lane, j, e);
#pragma unroll
          for (int k = 0; k < kNG; ++k)
            gbuf[k * kTileOut + o] = acc[k][j][e];
        }
      __threadfence_block();
      bar_arrive(kBarGroups, kGroupCount);
    }
  } else {
    reg_dealloc<kOtherRegs>();
    if (w >= kProducer) {
      for (int it = 0; it < total; ++it) {
        const int s = it % kStages;
        if (it >= kStages) bar_sync(kBarFree + s, kRingCount);
        if (lane == 0) {
          const TileRef tr = tile_ref(bx + (it / nk) * gx, tiles, tiles_n, m);
          const Operands ops = operands(LEFT, table, d, tr.slab, tr.ch, R, C,
                                        kp);
          // rows past the operand's edge are not copied: what the stage
          // holds there only reaches outputs that are not stored
          const int pr = min(kBM, ops.P.rows - tr.i0);
          const int qr = min(kBN, ops.Q.rows - tr.j0);
          uint8_t* st = ring + s * kStageBytes;
          mbar_expect_tx(full + s, kPlanes * (pr + qr) * kKC);
#pragma unroll
          for (int pl = 0; pl < kPlanes; ++pl) {
            bulk_copy(st + pl * kBM * kKC,
                      chunk_src(ops.P, pl, tr.i0, it % nk), pr * kKC,
                      full + s);
            bulk_copy(st + kPBytes + pl * kBN * kKC,
                      chunk_src(ops.Q, pl, tr.j0, it % nk), qr * kKC,
                      full + s);
          }
        }
        __syncwarp();
      }
    } else {
      const int t = threadIdx.x - kMmaThreads;
      bool bad = false;
      for (int step = 0; step < mine; ++step) {
        const TileRef tr = tile_ref(bx + step * gx, tiles, tiles_n, m);
        const Stage pol = Stage::make(nullptr, corr, consts, tw, tws, bias,
                                      tr.ch, R, C, LEFT);
        uint64_t* ob = out + static_cast<size_t>(tr.slab) * R * C;
        bar_sync(kBarGroups, kGroupCount);
        for (int o = t; o < kTileOut; o += kEpiThreads) {
          const int r = tr.i0 + o / kBN, c = tr.j0 + o % kBN;
          if (r >= R || c >= C) continue;
          int g[kNG];
#pragma unroll
          for (int k = 0; k < kNG; ++k) g[k] = gbuf[k * kTileOut + o];
          ob[static_cast<size_t>(r) * C + c] = pol.finish(g, r, c, bad);
        }
        if (step + 1 < mine) bar_arrive(kBarGroupsFree, kGroupCount);
      }
    }
  }
}

template <bool LEFT, bool TW>
int launch(int grid, cudaStream_t s, uint64_t* o, const int8_t* tb,
           const int8_t* d, const uint64_t* co, const uint64_t* cs,
           const uint64_t* tw, const uint64_t* tws, int bias, int batch,
           int m, int r, int c) {
  const cudaError_t err = cudaFuncSetAttribute(
      dft_mxu64_pipe_kernel<LEFT, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDynSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dft_mxu64_pipe_kernel<LEFT, TW><<<grid, kPipeThreads, kDynSmem, s>>>(
      o, tb, d, co, cs, tw, tws, bias, batch, m, r, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes, with nfl_dft_mxu64's arguments and
// K5's output.  Returns the cudaError_t of the set-up or the launches (0
// on success).
extern "C" int nfl_dft_mxu64_pipe(int left, const void* x, void* out,
                                  const void* table, const void* corr,
                                  const void* consts, const void* tw,
                                  const void* tws, void* scratch, int bias,
                                  int batch, int m, int r, int c,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kp = padded_k(left ? r : c);
  auto* d = static_cast<int8_t*>(scratch);
  digit_split(left != 0, static_cast<const uint64_t*>(x), d, batch, m, r, c,
              kp, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = static_cast<long>((r + kBM - 1) / kBM)
      * ((c + kBN - 1) / kBN) * m * batch;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  auto* o = static_cast<uint64_t*>(out);
  const auto* tb = static_cast<const int8_t*>(table);
  const auto* co = static_cast<const uint64_t*>(corr);
  const auto* cs = static_cast<const uint64_t*>(consts);
  const auto* t = static_cast<const uint64_t*>(tw);
  const auto* ts = static_cast<const uint64_t*>(tws);
  if (t != nullptr)
    return left ? launch<true, true>(grid, s, o, tb, d, co, cs, t, ts, bias,
                                     batch, m, r, c)
                : launch<false, true>(grid, s, o, tb, d, co, cs, t, ts, bias,
                                      batch, m, r, c);
  return left ? launch<true, false>(grid, s, o, tb, d, co, cs, t, ts, bias,
                                    batch, m, r, c)
              : launch<false, false>(grid, s, o, tb, d, co, cs, t, ts, bias,
                                     batch, m, r, c);
}
