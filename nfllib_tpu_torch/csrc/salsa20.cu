// S1: the Salsa20/20 keystream of F nonces at once.
//
// Replaces XLA code, not a TPU kernel: nfllib_tpu/prng/salsa20.py:
// device_stream_words (the jnp tier of salsa20_block_words), which XLA
// fuses into one program.  Eager torch would launch about 1,900 ops for
// the same math (10 double rounds x 8 quarter-rounds x 4 lines x add,
// rotate, xor on masked int64), so the device samplers
// (nfllib_tpu_torch/prng/device_sampling.py) other than the Gaussian draw
// every keystream a sampler call needs through this one launch.
//
// out[f, b, :] = the 16 final-state words of block b (counter b, from 0)
// of the stream at nonce (base + off_f) mod 2^64, where base = *nonce_dev
// (a 0-d int64 tensor on the card, which the host never reads; 0 when
// null) + nonce_add (a value the host knows), and off_f = offsets[f], or f
// when offsets is null.  These are the bytes of Salsa20Stream(key,
// nonce).randombytes(64 * nblocks) (reference crypto_stream_salsa20, key
// words 1-4 and 11-14, nonce words 6-7, the 64-bit counter in 8-9).
//
// Design: one thread a 64-byte block (salsa20_block.cuh); the block of
// 256 threads stages its 16 KB of output in shared memory (word-major,
// rows padded to 258 words, so both the writes and the reads are free of
// bank conflicts) and stores it with consecutive threads on consecutive
// words.  The grid is 1-D over the F * nblocks keystream blocks (no 65535
// cap in x).  The device samplers' uniform, non-uniform, ZO and hwt draws
// run on it; the Gaussians make their keystream inside S3 and S4.
//
// Bound on this card: the operations.  A block takes 10 x 8 x 4 (add,
// rotate, xor) = 960 instructions and 16 final adds for 64 bytes written:
// its 640 rotates and xors hold the ALU pipe (64 lanes an SM a clock) for
// 10 lane-clocks a byte, while the adds can issue on the FMA pipe beside
// them; HBM's rate allows about 0.2.

#include <cstdint>

#include <cuda_runtime.h>

#include "salsa20_block.cuh"

namespace {

using nfl_salsa::Key;

constexpr int kThreads = 256;
constexpr int kRow = kThreads + 2;   // padded row of the staging buffer

__global__ void __launch_bounds__(kThreads) salsa20_kernel(
    Key key, const long long* __restrict__ nonce_dev,
    unsigned long long nonce_add, const long long* __restrict__ offsets,
    long long nblocks, long long total, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem_raw);   // [16][kRow]
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long i = first + threadIdx.x;
  if (i < total) {
    const long long f = i / nblocks;
    const unsigned long long ctr =
        static_cast<unsigned long long>(i - f * nblocks);
    const uint64_t nonce = nfl_salsa::nonce_of(
        nonce_dev, nonce_add, offsets != nullptr ? __ldg(offsets + f) : f);
    uint32_t x[16];
    nfl_salsa::block(key, nonce, ctr, x);
#pragma unroll
    for (int k = 0; k < 16; ++k) stage[k * kRow + threadIdx.x] = x[k];
  }
  __syncthreads();
  // the block's output is the contiguous words [first * 16, first * 16 +
  // 16 * live): word q of it is word q % 16 of keystream block q / 16
  const long long left = total - first;
  const int live = static_cast<int>(left < kThreads ? left : kThreads);
  uint32_t* dst = out + first * 16;
  for (int q = threadIdx.x; q < 16 * live; q += kThreads)
    dst[q] = stage[(q & 15) * kRow + (q >> 4)];
}

}  // namespace

// Plain C entry point for ctypes.  key: 8 host words (passed to the kernel
// by value); nonce_dev: a device int64 or null; nonce_add: added to it;
// offsets: [fills] device int64 or null (then f); out: [fills, nblocks,
// 16] device uint32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int nfl_salsa20(const uint32_t* key, const void* nonce_dev,
                           unsigned long long nonce_add, const void* offsets,
                           int fills, long long nblocks, void* out,
                           void* stream) {
  if (fills <= 0 || nblocks <= 0) return 0;
  Key k;
  for (int w = 0; w < 8; ++w) k.w[w] = key[w];
  const long long total = static_cast<long long>(fills) * nblocks;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  salsa20_kernel<<<static_cast<unsigned>(grid), kThreads,
                   16 * kRow * sizeof(uint32_t),
                   static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<const long long*>(nonce_dev), nonce_add,
      static_cast<const long long*>(offsets), nblocks, total,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
