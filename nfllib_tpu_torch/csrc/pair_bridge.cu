// Elementwise canonical x * tw mod p for u64 residues (Shoup).
//
// Replaces the TPU kernel nfllib_tpu/ops/pair_bridge.py:_kernel (K11),
// which multiplies uint32 hi/lo pair planes by a [m, R, C] twiddle inside
// Mosaic (no u64 there).  Here the words are native u64:
//   q = __umul64hi(x, tws);  r = x * tw - q * p  (< 2p);  one conditional
//   subtraction of p,
// which is modops.mulmod_shoup's canonical result bit for bit.  x and out
// are [batch, m, R, C]; tw/tws [m, R, C] broadcast over the batch; p [m].
//
// Bound on this card: the bytes.  Each output reads x, tw and tws (24
// bytes) and writes 8; at u64 2^20 x 2 channels x batch 2 that is about
// 96 MB, 0.029 ms at 3.35 TB/s, against 5 integer instructions an element.
// Design for it: a grid-stride loop of 8-byte loads and stores on
// consecutive addresses by consecutive threads, the twiddle read once per
// batch element (from L2 after the first), nothing staged.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) pair_bridge64_kernel(
    const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
    const uint64_t* __restrict__ tw, const uint64_t* __restrict__ tws,
    const uint64_t* __restrict__ p, long long total, long long slab, int m) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads
           + threadIdx.x;
       i < total; i += step) {
    const long long j = i % (slab * m);              // [m, R, C] position
    const uint64_t pv = __ldg(p + j / slab);
    const uint64_t v = x[i];
    const uint64_t q = __umul64hi(v, __ldg(tws + j));
    const uint64_t r = v * __ldg(tw + j) - q * pv;   // < 2p
    out[i] = r >= pv ? r - pv : r;
  }
}

}  // namespace

// Plain C entry point for ctypes.  x/out: [batch, m, slab] u64 residues
// (slab = R * C); tw/tws: [m, slab]; p: [m].  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int nfl_pair_bridge64(const void* x, void* out, const void* tw,
                                 const void* tws, const void* p, int batch,
                                 int m, long long slab, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * m * slab;
  const long long want = (total + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  const int grid = static_cast<int>(want < cap ? want : cap);
  pair_bridge64_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(tw), static_cast<const uint64_t*>(tws),
      static_cast<const uint64_t*>(p), total, slab, m);
  return static_cast<int>(cudaGetLastError());
}
