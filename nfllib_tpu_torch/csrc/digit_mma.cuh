// Tensor-core engine of the square mod-matmul kernels K5 (dft_mxu64.cu,
// u64, 8 digits), K9 (dft_mxu32.cu, u32, 4 digits) and K10
// (dft_mxu64_pipe.cu), mma.sync.m16n8k32: the NDIG^2 int8 digit products
// of one output tile, s8 x s8 -> s32, accumulated exactly into the
// NG = 2 NDIG - 1 group sums that DftStage<NDIG, TW>::finish (dft_stage.cuh)
// turns into residues.  NDIG is 8 (u64 words) or 4 (u32 words).
//
// Both operands reach the tensor cores K-major (int8 mma takes no
// transposed operand, and ldmatrix.trans is 16-bit only), as NDIG digit
// planes each:
//   D[i][j] = sum_k P[i][k] Q[j][k],  out[r][c] = D[r][c]
//   LEFT  (out = M @ X): P = the table's planes W_a[r][k] as stored,
//                        Q = X's offset-byte planes d_b, transposed to [c][k]
//   RIGHT (out = X @ M): P = X's planes d_b[r][k] as stored,
//                        Q = the table's planes, transposed to [c][k]
// The table planes are built once per table (ops/dft_mxu.py:
// DftTables.mma_planes, [m, NDIG, kp / 32, size, 32]); X's planes are
// written by digit_split into a scratch [batch, m, NDIG, kp / 32, other, 32]
// at the start of each call.  Both are k-chunked: the 32 bytes of k-chunk kc
// of every row of a plane lie together, so a tile's chunk is one contiguous
// run of rows x 32 bytes.  Both are also stored swizzled: the two 16-byte
// halves of a 32-byte row are swapped on rows 4..7 mod 8 (swz), so a linear
// copy of a chunk lands in shared memory ready for ldmatrix, free of bank
// conflicts.  kp = max(size, 32): rows are zero-padded to whole k-chunks,
// and a zero digit contributes nothing, so sizes 2..16 need no masking
// inside the loop.  Group k = a + b collects the products of plane a of P
// with plane b of Q; |G_k| <= 8 128^2 1024 = 2^27, exact in s32 (no
// .satfinite).
//
// Tile: kBM x kBN = 64 x 32 outputs, 8 warps of 16 x 16 (4 along i, 2 along
// j).  A k-chunk of 32 holds the NDIG P planes (64 rows) and the NDIG Q
// planes (32 rows), 24 KB at 8 digits and 12 KB at 4, staged by cp.async
// (16-byte pieces, zero-filled past the edge of P or Q; K5, K9) or by bulk
// copies (K10).  A warp loads the NDIG Q fragments of its 16 columns once a
// chunk, then for each P plane a issues the 2 NDIG MMAs into groups
// a..a+NDIG-1: 128 MMAs a warp a chunk at 8 digits, 32 at 4.  A thread's
// accumulators are NG groups x 2 n8 fragments x 4: 120 registers at 8
// digits (one block an SM), 56 at 4 (two blocks an SM).
//
// Each kernel instance is made in one source only: K5's (dft_mxu64.cu, which
// also makes digit_split and the poison pass for K10) and K9's
// (dft_mxu32.cu).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "dft_stage.cuh"

namespace nflmma {

constexpr int kBM = 64, kBN = 32, kKC = 32;
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;

// The shapes of the NDIG-digit engine
template <int NDIG>
struct Mma {
  static_assert(NDIG == 8 || NDIG == 4, "u64 (8 digits) or u32 (4 digits)");
  static constexpr int kNG = 2 * NDIG - 1;
  static constexpr int kPBytes = NDIG * kBM * kKC;      // P planes of a chunk
  static constexpr int kQBytes = NDIG * kBN * kKC;
  static constexpr int kStageBytes = kPBytes + kQBytes;
  using Acc = int[kNG][2][4];
  using Word = std::conditional_t<NDIG == 8, uint64_t, uint32_t>;
};

__host__ __device__ constexpr int padded_k(int size) {
  return size < kKC ? kKC : size;
}

// One side of the product in device memory: planes [NDIG][kp / 32][rows][32]
// int8
struct Operand {
  const int8_t* base;
  int rows;
  size_t plane;       // rows * kp
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte offset of (row, 16-byte half) in a plane of 32-byte rows, as the
// planes are stored and staged: the halves swapped on rows 4..7 mod 8
__device__ __forceinline__ int swz(int row, int half) {
  return row * kKC + ((half ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the NDIG planes x ROWS rows x 32 bytes of k-chunk kc of one operand
// as they are stored: 16-byte pieces t, t + STEP, ... (STEP threads take
// part), zero-filled for rows past the operand's edge
template <int NDIG, int ROWS, int STEP>
__device__ __forceinline__ void load_planes(uint8_t* dst, const Operand& op,
                                            int row0, int kc, int t) {
  constexpr int kN = NDIG * ROWS * 2;
  static_assert(kN % STEP == 0, "whole rounds of pieces");
#pragma unroll 4
  for (int i = 0; i < kN / STEP; ++i) {
    const int id = t + i * STEP;
    const int plane = id / (2 * ROWS), row = (id / 2) % ROWS, half = id & 1;
    const int grow = row0 + row;
    const bool valid = grow < op.rows;
    const int8_t* src = valid
        ? op.base + plane * op.plane
              + (static_cast<size_t>(kc) * op.rows + grow) * kKC + 16 * half
        : op.base;
    cp_async16(dst + (plane * ROWS + row) * kKC + 16 * half, src, valid);
  }
}

// Stage k-chunk kc of tile (i0, j0): P's 64 rows, then Q's 32
template <int NDIG, int STEP>
__device__ __forceinline__ void load_chunk(uint8_t* stage, const Operand& P,
                                           const Operand& Q, int i0, int j0,
                                           int kc, int t) {
  load_planes<NDIG, kBM, STEP>(stage, P, i0, kc, t);
  load_planes<NDIG, kBN, STEP>(stage + Mma<NDIG>::kPBytes, Q, j0, kc, t);
}

// Where rows row0.. of plane `plane`, k-chunk kc, start: one contiguous
// run of 32-byte rows
__device__ __forceinline__ const int8_t* chunk_src(const Operand& op,
                                                   int plane, int row0,
                                                   int kc) {
  return op.base + plane * op.plane
      + (static_cast<size_t>(kc) * op.rows + row0) * kKC;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NDIG>
__device__ __forceinline__ void zero(typename Mma<NDIG>::Acc& acc) {
#pragma unroll
  for (int k = 0; k < Mma<NDIG>::kNG; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][j][e] = 0;
}

// The 2 NDIG^2 MMAs of one staged chunk for warp w (rows 16 (w % 4) ..,
// columns 16 (w / 4) .. of the tile)
template <int NDIG>
__device__ __forceinline__ void chunk_mma(const uint8_t* stage, int w,
                                          int lane,
                                          typename Mma<NDIG>::Acc& acc) {
  const int wi = 16 * (w % 4), wj = 16 * (w / 4);
  // ldmatrix row addresses: P matrices (rows 0-7 | 8-15) x (half 0 | 1);
  // Q matrices (half 0 | 1) x (columns 0-7 | 8-15)
  const int prow = wi + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int phalf = lane >> 4;
  const int qrow = wj + (lane & 7) + (lane >> 4) * 8;
  const int qhalf = (lane >> 3) & 1;
  const uint8_t* sp = stage + swz(prow, phalf);
  const uint8_t* sq = stage + Mma<NDIG>::kPBytes + swz(qrow, qhalf);
  uint32_t qf[NDIG][4];
#pragma unroll
  for (int b = 0; b < NDIG; ++b) ldmatrix_x4(qf[b], sq + b * kBN * kKC);
#pragma unroll
  for (int a = 0; a < NDIG; ++a) {
    uint32_t pf[4];
    ldmatrix_x4(pf, sp + a * kBM * kKC);
#pragma unroll
    for (int b = 0; b < NDIG; ++b) {
      mma_s8(acc[a + b][0], pf, qf[b][0], qf[b][1]);
      mma_s8(acc[a + b][1], pf, qf[b][2], qf[b][3]);
    }
  }
}

// Tile coordinates of accumulator entry (j, e) of lane `lane` in warp w
__device__ __forceinline__ int acc_row(int w, int lane, int e) {
  return 16 * (w % 4) + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int w, int lane, int j, int e) {
  return 16 * (w / 4) + 8 * j + 2 * (lane & 3) + (e & 1);
}

// The P and Q operands of slab (b, ch): the table of channel ch
// (mma_planes [m][NDIG][kp / 32][size][32]) and X's planes d
// [batch][m][NDIG][kp / 32][other][32]
struct Operands {
  Operand P, Q;
};

template <int NDIG>
__device__ __forceinline__ Operands operands(bool left, const int8_t* table,
                                             const int8_t* d, int slab,
                                             int ch, int R, int C, int kp) {
  const int size = left ? R : C, other = left ? C : R;
  const Operand t{table + static_cast<size_t>(ch) * NDIG * size * kp,
                  size, static_cast<size_t>(size) * kp};
  const Operand x{d + static_cast<size_t>(slab) * NDIG * other * kp,
                  other, static_cast<size_t>(other) * kp};
  return left ? Operands{t, x} : Operands{x, t};
}

// X's offset-byte planes, K-major, k-chunked and swizzled as the table's
// planes are stored: byte (k % 32) ^ (16 ((o >> 2) & 1)) of
// d[slab][b][k / 32][o] = byte_b(x) - 128 with x = X[k][o] (LEFT) or
// X[o][k] (RIGHT) of slab [R][C]; zero for size <= k < kp.  A block covers
// 32 o x 64 k of one slab (channel blockIdx.y of polynomial blockIdx.z, as
// the main kernel's grid): it reads the x tile coalesced along C, then each
// thread packs 4 consecutive k of one o into a 32-bit word for each of the
// NDIG planes.  With `flags` (strict mode) an input word not below the
// channel's p (consts[4 ch]) flags its slab: a poisoned block stays
// poisoned through the next stage.
constexpr int kSplitO = 32, kSplitK = 64, kSplitThreads = 256;

template <int NDIG, bool LEFT>
__global__ void __launch_bounds__(kSplitThreads) digit_split_kernel(
    const typename Mma<NDIG>::Word* __restrict__ x, int8_t* __restrict__ d,
    const uint64_t* __restrict__ consts, int* __restrict__ flags, int R,
    int C, int kp) {
  using W = typename Mma<NDIG>::Word;
  __shared__ W xs[kSplitO][kSplitK + 1];
  const int O = LEFT ? C : R, K = LEFT ? R : C;
  const int tiles_k = (kp + kSplitK - 1) / kSplitK;
  const int o0 = (blockIdx.x / tiles_k) * kSplitO;
  const int k0 = (blockIdx.x % tiles_k) * kSplitK;
  const size_t slab =
      static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const W* xb = x + slab * R * C;
  const W p = flags != nullptr ? static_cast<W>(consts[4 * blockIdx.y]) : 0;
  bool bad = false;
  for (int id = threadIdx.x; id < kSplitO * kSplitK; id += kSplitThreads) {
    const int oo = LEFT ? id % kSplitO : id / kSplitK;
    const int kk = LEFT ? id / kSplitO : id % kSplitK;
    const int o = o0 + oo, k = k0 + kk;
    // 0x80 bytes are zero digits: the padding past the contraction
    W v = static_cast<W>(0x8080808080808080ull);
    if (o < O && k < K) {
      v = xb[LEFT ? static_cast<size_t>(k) * C + o
                  : static_cast<size_t>(o) * C + k];
      bad |= v >= p;
    }
    xs[oo][kk] = v;
  }
  if (flags != nullptr && bad) flags[slab] = 1;
  __syncthreads();
  int8_t* db = d + slab * NDIG * O * kp;
  for (int id = threadIdx.x; id < kSplitO * kSplitK / 4;
       id += kSplitThreads) {
    const int oo = id / (kSplitK / 4), k4 = id % (kSplitK / 4);
    const int o = o0 + oo, k = k0 + 4 * k4;
    if (o >= O || k >= kp) continue;
    const W v0 = xs[oo][4 * k4], v1 = xs[oo][4 * k4 + 1];
    const W v2 = xs[oo][4 * k4 + 2], v3 = xs[oo][4 * k4 + 3];
#pragma unroll
    for (int b = 0; b < NDIG; ++b) {
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

// digit_split of x [batch][m][R][C] into d on stream s; flags: [batch * m]
// int32 or null (not strict)
template <int NDIG>
cudaError_t digit_split(bool left, const void* x, int8_t* d,
                        const uint64_t* consts, int* flags, int batch, int m,
                        int R, int C, int kp, cudaStream_t s) {
  using W = typename Mma<NDIG>::Word;
  const int O = left ? C : R;
  const dim3 grid(((O + kSplitO - 1) / kSplitO)
                      * ((kp + kSplitK - 1) / kSplitK),
                  m, batch);
  const W* xw = static_cast<const W*>(x);
  if (left)
    digit_split_kernel<NDIG, true><<<grid, kSplitThreads, 0, s>>>(
        xw, d, consts, flags, R, C, kp);
  else
    digit_split_kernel<NDIG, false><<<grid, kSplitThreads, 0, s>>>(
        xw, d, consts, flags, R, C, kp);
  return cudaGetLastError();
}

// Strict mode: every slab [R * C] of out whose flag is set becomes all ones
// (0xFF.. words), which the caller's bracket turns into an AssertionError
template <class W>
__global__ void __launch_bounds__(256) poison_flagged(
    W* __restrict__ out, const int* __restrict__ flags, int n) {
  if (flags[blockIdx.x] == 0) return;
  W* o = out + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += 256) o[i] = ~W{0};
}

template <class W>
cudaError_t poison(void* out, const int* flags, int slabs, int n,
                   cudaStream_t s) {
  poison_flagged<W><<<slabs, 256, 0, s>>>(static_cast<W*>(out), flags, n);
  return cudaGetLastError();
}

// The square mod-matmul kernel of K5 (NDIG = 8) and K9 (NDIG = 4): one
// 256-thread block per 64 x 32 output tile of one (polynomial, channel)
// runs the NDIG^2 digit products through a 4-stage cp.async ring of
// k-chunks and finishes each output from the NG accumulators its thread
// holds.  x, out [batch, m, R, C]; table [m, NDIG, kp / 32, size, 32]; d
// [batch, m, NDIG, kp / 32, other, 32]; corr [m, size]; consts [m, 4] = p,
// mbar, chi, chi_shoup; tw/tws [m, R, C] (TW only); flags [batch * m] or
// null (strict mode: a broken output contract flags the slab).
constexpr int kMmaStages = 4;

template <int NDIG, bool LEFT, bool TW>
__global__ void __launch_bounds__(kMmaThreads, NDIG == 8 ? 1 : 2)
    dft_mma_kernel(typename Mma<NDIG>::Word* __restrict__ out,
                   const int8_t* __restrict__ table,
                   const int8_t* __restrict__ d,
                   const uint64_t* __restrict__ corr,
                   const uint64_t* __restrict__ consts,
                   const typename Mma<NDIG>::Word* __restrict__ tw,
                   const typename Mma<NDIG>::Word* __restrict__ tws,
                   int* __restrict__ flags, int bias, int m, int R, int C) {
  using E = Mma<NDIG>;
  using Stage = nfldft::DftStage<NDIG, TW>;
  extern __shared__ __align__(128) uint8_t ring[];
  const int ch = blockIdx.y, b = blockIdx.z;
  const int slab = b * m + ch;
  const int tiles_n = (C + kBN - 1) / kBN;
  const int i0 = (blockIdx.x / tiles_n) * kBM;
  const int j0 = (blockIdx.x % tiles_n) * kBN;
  const int kp = padded_k(LEFT ? R : C);
  const int nk = kp / kKC;
  const Operands ops = operands<NDIG>(LEFT, table, d, slab, ch, R, C, kp);
  const int t = threadIdx.x, w = t / 32, lane = t % 32;

  typename E::Acc acc;
  zero<NDIG>(acc);
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < nk)
      load_chunk<NDIG, kMmaThreads>(ring + s * E::kStageBytes, ops.P, ops.Q,
                                    i0, j0, s, t);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    const int next = kc + kMmaStages - 1;
    if (next < nk)
      load_chunk<NDIG, kMmaThreads>(ring + (next % kMmaStages) * E::kStageBytes,
                                    ops.P, ops.Q, i0, j0, next, t);
    cp_async_commit();
    chunk_mma<NDIG>(ring + (kc % kMmaStages) * E::kStageBytes, w, lane, acc);
  }
  cp_async_wait<0>();

  const Stage pol = Stage::make(corr, consts, tw, tws, bias, ch, R, C, LEFT);
  typename E::Word* ob = out + static_cast<size_t>(slab) * R * C;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = i0 + acc_row(w, lane, e);
      const int c = j0 + acc_col(w, lane, j, e);
      int g[E::kNG];
#pragma unroll
      for (int k = 0; k < E::kNG; ++k) g[k] = acc[k][j][e];
      if (r < R && c < C)
        ob[static_cast<size_t>(r) * C + c] = pol.finish(g, r, c, bad);
    }
  if (flags != nullptr && bad) flags[slab] = 1;
}

template <int NDIG, bool LEFT, bool TW>
cudaError_t launch_mma(const dim3& grid, cudaStream_t s, void* out,
                       const int8_t* table, const int8_t* d,
                       const uint64_t* corr, const uint64_t* consts,
                       const void* tw, const void* tws, int* flags, int bias,
                       int m, int R, int C) {
  using W = typename Mma<NDIG>::Word;
  constexpr size_t kDynSmem = kMmaStages * Mma<NDIG>::kStageBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      dft_mma_kernel<NDIG, LEFT, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDynSmem));
  if (err != cudaSuccess) return err;
  dft_mma_kernel<NDIG, LEFT, TW><<<grid, kMmaThreads, kDynSmem, s>>>(
      static_cast<W*>(out), table, d, corr, consts,
      static_cast<const W*>(tw), static_cast<const W*>(tws), flags, bias, m,
      R, C);
  return cudaGetLastError();
}

// The whole call of K5 / K9 on stream s, as the C entry points take it:
// digit_split into `scratch`, the products and finish, and in strict mode
// (flags, zeroed by the caller) the poison pass.
template <int NDIG>
int dft_mma(int left, const void* x, void* out, const void* table,
            const void* corr, const void* consts, const void* tw,
            const void* tws, void* scratch, void* flags, int bias, int batch,
            int m, int r, int c, cudaStream_t s) {
  const int kp = padded_k(left ? r : c);
  auto* d = static_cast<int8_t*>(scratch);
  const auto* cs = static_cast<const uint64_t*>(consts);
  auto* fl = static_cast<int*>(flags);
  cudaError_t err = digit_split<NDIG>(left != 0, x, d, cs, fl, batch, m, r,
                                      c, kp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((r + kBM - 1) / kBM) * ((c + kBN - 1) / kBN), m, batch);
  const auto* tb = static_cast<const int8_t*>(table);
  const auto* co = static_cast<const uint64_t*>(corr);
  if (tw != nullptr)
    err = left ? launch_mma<NDIG, true, true>(grid, s, out, tb, d, co, cs, tw,
                                              tws, fl, bias, m, r, c)
               : launch_mma<NDIG, false, true>(grid, s, out, tb, d, co, cs,
                                               tw, tws, fl, bias, m, r, c);
  else
    err = left ? launch_mma<NDIG, true, false>(grid, s, out, tb, d, co, cs,
                                               tw, tws, fl, bias, m, r, c)
               : launch_mma<NDIG, false, false>(grid, s, out, tb, d, co, cs,
                                                tw, tws, fl, bias, m, r, c);
  if (err != cudaSuccess || fl == nullptr) return static_cast<int>(err);
  return static_cast<int>(
      poison<typename Mma<NDIG>::Word>(out, fl, batch * m, r * c, s));
}

// digit_split<8> and poison<uint64_t> for K10 (dft_mxu64_pipe.cu), made in
// dft_mxu64.cu
cudaError_t digit_split64(bool left, const void* x, int8_t* d,
                          const uint64_t* consts, int* flags, int batch, int m,
                          int R, int C, int kp, cudaStream_t s);
cudaError_t poison64(void* out, const int* flags, int slabs, int n,
                     cudaStream_t s);

}  // namespace nflmma
