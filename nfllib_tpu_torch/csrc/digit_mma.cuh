// Tensor-core tile loop of the u64 square mod-matmul kernels K5
// (dft_mxu64.cu) and K10 (dft_mxu64_pipe.cu), mma.sync.m16n8k32: the 64
// int8 digit products of one output tile, s8 x s8 -> s32, accumulated
// exactly into the 15 group sums that DftStage<8, TW>::finish
// (dft_stage.cuh) turns into residues.
//
// Both operands reach the tensor cores K-major (int8 mma takes no
// transposed operand, and ldmatrix.trans is 16-bit only), as 8 digit
// planes each:
//   D[i][j] = sum_k P[i][k] Q[j][k],  out[r][c] = D[r][c]
//   LEFT  (out = M @ X): P = the table's planes W_a[r][k] as stored,
//                        Q = X's offset-byte planes d_b, transposed to [c][k]
//   RIGHT (out = X @ M): P = X's planes d_b[r][k] as stored,
//                        Q = the table's planes, transposed to [c][k]
// The table planes are built once per table (ops/dft_mxu.py:
// DftTables.mma_planes, [m, 8, kp / 32, size, 32]); X's planes are written
// by digit_split (dft_mxu64.cu) into a scratch [batch, m, 8, kp / 32,
// other, 32] at the start of each call.  Both are k-chunked: the 32 bytes
// of k-chunk kc of every row of a plane lie together, so a tile's chunk is
// one contiguous run of rows x 32 bytes (row-major planes made every
// 16-byte piece a separate 32-byte sector from another row).  Both are
// also stored swizzled: the two 16-byte halves of a 32-byte row are
// swapped on rows 4..7 mod 8 (swz), so a linear copy of a chunk lands in
// shared memory ready for ldmatrix, free of bank conflicts.  kp =
// max(size, 32): rows are zero-padded to whole k-chunks, and a zero digit
// contributes nothing, so sizes 8 and 16 need no masking inside the loop.
// Group k = a + b
// collects the products of plane a of P with plane b of Q;
// |G_k| <= 8 128^2 1024 = 2^27, exact in s32 (no .satfinite).
//
// Tile: kBM x kBN = 64 x 32 outputs, 8 warps of 16 x 16 (4 along i, 2 along
// j).  A k-chunk of 32 holds the 8 P planes (64 rows) and the 8 Q planes
// (32 rows), 24 KB, staged by cp.async (16-byte pieces, zero-filled past
// the edge of P or Q; K5) or by 16 bulk copies (K10).  A warp loads the 8
// Q fragments of its 16 columns once a chunk (32 registers), then for
// each P plane a (4 registers) issues the 16 MMAs into groups a..a+7.  A
// thread's accumulators are 15 groups x 2 n8 fragments x 4 = 120
// registers.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace nflmma {

constexpr int kPlanes = 8;
constexpr int kNG = 2 * kPlanes - 1;
constexpr int kBM = 64, kBN = 32, kKC = 32;
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kPBytes = kPlanes * kBM * kKC;          // P planes of a chunk
constexpr int kQBytes = kPlanes * kBN * kKC;
constexpr int kStageBytes = kPBytes + kQBytes;        // 24 KB

using Acc = int[kNG][2][4];

__host__ __device__ constexpr int padded_k(int size) {
  return size < kKC ? kKC : size;
}

// One side of the product in device memory: planes [8][kp / 32][rows][32]
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

// Stage the 8 planes x ROWS rows x 32 bytes of k-chunk kc of one operand
// as they are stored: 16-byte pieces t, t + STEP, ... (STEP threads take
// part), zero-filled for rows past the operand's edge
template <int ROWS, int STEP>
__device__ __forceinline__ void load_planes(uint8_t* dst, const Operand& op,
                                            int row0, int kc, int t) {
  constexpr int kN = kPlanes * ROWS * 2;
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
template <int STEP>
__device__ __forceinline__ void load_chunk(uint8_t* stage, const Operand& P,
                                           const Operand& Q, int i0, int j0,
                                           int kc, int t) {
  load_planes<kBM, STEP>(stage, P, i0, kc, t);
  load_planes<kBN, STEP>(stage + kPBytes, Q, j0, kc, t);
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

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int k = 0; k < kNG; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][j][e] = 0;
}

// The 128 MMAs of one staged chunk for warp w (rows 16 (w % 4) .., columns
// 16 (w / 4) .. of the tile)
__device__ __forceinline__ void chunk_mma(const uint8_t* stage, int w,
                                          int lane, Acc& acc) {
  const int wi = 16 * (w % 4), wj = 16 * (w / 4);
  // ldmatrix row addresses: P matrices (rows 0-7 | 8-15) x (half 0 | 1);
  // Q matrices (half 0 | 1) x (columns 0-7 | 8-15)
  const int prow = wi + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int phalf = lane >> 4;
  const int qrow = wj + (lane & 7) + (lane >> 4) * 8;
  const int qhalf = (lane >> 3) & 1;
  const uint8_t* sp = stage + swz(prow, phalf);
  const uint8_t* sq = stage + kPBytes + swz(qrow, qhalf);
  uint32_t qf[kPlanes][4];
#pragma unroll
  for (int b = 0; b < kPlanes; ++b) ldmatrix_x4(qf[b], sq + b * kBN * kKC);
#pragma unroll
  for (int a = 0; a < kPlanes; ++a) {
    uint32_t pf[4];
    ldmatrix_x4(pf, sp + a * kBM * kKC);
#pragma unroll
    for (int b = 0; b < kPlanes; ++b) {
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

// X's offset-byte planes, stored as the table's: byte (k % 32) ^
// (16 ((o >> 2) & 1)) of d[slab][b][k / 32][o] = byte_b(x) - 128 with
// x = X[k][o] (LEFT) or X[o][k] (RIGHT) of each of the batch x m slabs
// [R][C]; zero for size <= k < kp.  Launched on stream s; defined in
// dft_mxu64.cu.
void digit_split(bool left, const uint64_t* x, int8_t* d, int batch, int m,
                 int R, int C, int kp, cudaStream_t s);

// The P and Q operands of slab (b, ch): the table of channel ch
// (mma_planes [m][8][kp / 32][size][32]) and X's planes d
// [batch][m][8][kp / 32][other][32]
struct Operands {
  Operand P, Q;
};

__device__ __forceinline__ Operands operands(bool left, const int8_t* table,
                                             const int8_t* d, int slab,
                                             int ch, int R, int C, int kp) {
  const int size = left ? R : C, other = left ? C : R;
  const Operand t{table + static_cast<size_t>(ch) * kPlanes * size * kp,
                  size, static_cast<size_t>(size) * kp};
  const Operand x{d + static_cast<size_t>(slab) * kPlanes * other * kp,
                  other, static_cast<size_t>(other) * kp};
  return left ? Operands{t, x} : Operands{x, t};
}

}  // namespace nflmma
