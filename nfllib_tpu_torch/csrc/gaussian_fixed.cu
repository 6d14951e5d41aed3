// S3: the fixed-consumption discrete Gaussian, F samplers in one launch,
// the keystream made where it is consumed.
//
// Replaces XLA code, not a TPU kernel: nfllib_tpu/prng/device_sampling.py:
// device_gaussian (the keystream of nfllib_tpu/prng/salsa20.py:130 and the
// barrier search after it), which XLA fuses into one program a sampler.
// The keystream never goes to global memory, and the three Gaussians of
// an LWE encryption (u, e1, e2) are one launch.
//
// out[f, c, s] for sampler f < F, channel c < m, sample s < n: sampler f
// reads the stream at nonce (base + off_f) mod 2^64, base = *nonce_dev (a
// device int64 the host never reads; 0 when null) + nonce_add; sample s
// reads its wp words of in_bits (8 or 16) at items [s * wp, (s + 1) * wp)
// of that stream (16-bit words little-endian, as the stream lays them
// out), big-endian across the words, and is v = (base_value +
// #{barriers <= r}) * amp_f, stored as p_c + v when v < 0 in out_bytes (2,
// 4 or 8) words: F calls of nfllib_tpu device_gaussian, bit for bit.
//
// Design: a block owns kThreads consecutive samples of one sampler
// (grid x over the samples, y over the samplers).  Its threads first
// compute exactly the Salsa20 blocks that the run's bytes cover (one
// thread a 64-byte block, salsa20_block.cuh; at wp = 19 bytes and 256
// samples 76 or 77 blocks) into shared memory, and copy the barrier table
// there when it fits beside them in 48 KB (4.4 KB at the demo's sigma 4;
// sigma 250's 6,000+ barriers are read from global memory through the
// cache instead); then one thread a sample runs the search of
// gaussian_search.cuh on its words in shared memory and writes its m
// residues, consecutive threads on consecutive samples.
//
// Bound on this card: the operations.  A sample costs wp * in_bits / 512
// Salsa20 blocks of 640 ALU instructions (rotates and xors; 336 adds go
// to either pipe) plus its search, about 7 halvings at sigma 4 of a few
// instructions and one or two words compared each, against its m output
// words written: at n = 2^14 x 3 samplers about 14,600 blocks, under a
// microsecond of the card's ALU time, and a few hundred KB written.

#include <cstdint>

#include <cuda_runtime.h>

#include "gaussian_search.cuh"
#include "salsa20_block.cuh"

namespace {

constexpr int kThreads = 256;        // samples a block
constexpr int kMaxSamplers = 8;      // samplers a launch (by value)
constexpr long long kSmemLimit = 48 * 1024;

struct Samplers {
  long long off[kMaxSamplers];       // nonce offsets
  long long amp[kMaxSamplers];       // amplifiers
};

// bytes of keystream a block stages: the run's bytes, widened to whole
// 64-byte blocks at both ends
__host__ __device__ inline long long stage_bytes(int wp, int item) {
  return (static_cast<long long>(kThreads) * wp * item / 64 + 2) * 64;
}

template <class W>
__global__ void __launch_bounds__(kThreads) gaussian_fixed_kernel(
    nfl_salsa::Key key, const long long* __restrict__ nonce_dev,
    unsigned long long nonce_add, Samplers smp, int n, int wp,
    const uint16_t* __restrict__ barriers, int nb, int base,
    const long long* __restrict__ p, int m, int out_bytes,
    void* __restrict__ out, int table_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem_raw);
  const int f = blockIdx.y;
  const long long s0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long left = n - s0;
  const int live = static_cast<int>(left < kThreads ? left : kThreads);
  const long long item = sizeof(W);
  const long long b0 = s0 * wp * item;                 // run's first byte
  const long long b1 = (s0 + live) * wp * item;        // one past its last
  const long long blk0 = b0 / 64;
  const int nblk = static_cast<int>((b1 + 63) / 64 - blk0);
  long long off = 0, amp = 0;   // smp's entry f, without a local copy
#pragma unroll
  for (int i = 0; i < kMaxSamplers; ++i)
    if (i == f) {
      off = smp.off[i];
      amp = smp.amp[i];
    }
  const uint64_t nonce = nfl_salsa::nonce_of(nonce_dev, nonce_add, off);
  for (int b = threadIdx.x; b < nblk; b += kThreads) {
    uint32_t x[16];
    nfl_salsa::block(key, nonce, static_cast<uint64_t>(blk0 + b), x);
#pragma unroll
    for (int k = 0; k < 16; ++k) ks[b * 16 + k] = x[k];
  }
  const uint16_t* tab = barriers;
  if (table_in_smem) {
    uint16_t* st = reinterpret_cast<uint16_t*>(
        smem_raw + stage_bytes(wp, static_cast<int>(item)));
    nfl_gauss::stage(st, barriers, static_cast<long long>(nb) * wp);
    tab = st;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= live) return;
  const W* r = reinterpret_cast<const W*>(
      smem_raw + (b0 - blk0 * 64)) + static_cast<long long>(threadIdx.x) * wp;
  const int cnt = nfl_gauss::count_le(r, tab, nb, wp,
                                      nfl_gauss::search_steps(nb));
  const long long v = static_cast<long long>(base + cnt) * amp;
  nfl_gauss::store_residues(out, out_bytes,
                            static_cast<long long>(f) * m * n + s0
                                + threadIdx.x,
                            n, m, p, v);
}

}  // namespace

// Plain C entry point for ctypes.  key: 8 host words; nonce_dev: a device
// int64 or null; nonce_add: added to it; offsets / amps: [samplers] host
// int64 (passed by value, at most kMaxSamplers); barriers: [nb, wp] device
// uint16; p: [m] device int64; out: [samplers, m, n] device words of
// out_bytes.  Returns the cudaError_t of the launch (0 on success); an
// argument the kernel does not take returns cudaErrorInvalidValue.
extern "C" int nfl_gaussian_fixed(const uint32_t* key, const void* nonce_dev,
                                  unsigned long long nonce_add,
                                  const long long* offsets,
                                  const long long* amps, int samplers, int n,
                                  int in_bits, int wp, const void* barriers,
                                  int nb, int base, const void* p, int m,
                                  int out_bytes, void* out, void* stream) {
  if ((in_bits != 8 && in_bits != 16) || wp <= 0 || nb <= 0 || m <= 0
      || samplers <= 0 || samplers > kMaxSamplers || n < 0
      || (out_bytes != 2 && out_bytes != 4 && out_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  nfl_salsa::Key k;
  for (int w = 0; w < 8; ++w) k.w[w] = key[w];
  Samplers smp;
  for (int f = 0; f < kMaxSamplers; ++f) {
    smp.off[f] = f < samplers ? offsets[f] : 0;
    smp.amp[f] = f < samplers ? amps[f] : 0;
  }
  const int item = in_bits / 8;
  const long long ks = stage_bytes(wp, item);
  const long long table = 2LL * nb * wp;
  const int in_smem = ks + table <= kSmemLimit;
  if (ks > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(ks + (in_smem ? table : 0));
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(samplers));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* bars = static_cast<const uint16_t*>(barriers);
  const auto* pp = static_cast<const long long*>(p);
  const auto* nd = static_cast<const long long*>(nonce_dev);
  if (in_bits == 8)
    gaussian_fixed_kernel<uint8_t><<<grid, kThreads, smem, st>>>(
        k, nd, nonce_add, smp, n, wp, bars, nb, base, pp, m, out_bytes, out,
        in_smem);
  else
    gaussian_fixed_kernel<uint16_t><<<grid, kThreads, smem, st>>>(
        k, nd, nonce_add, smp, n, wp, bars, nb, base, pp, m, out_bytes, out,
        in_smem);
  return static_cast<int>(cudaGetLastError());
}
