// Launch helpers shared by the elementwise kernels E1 (modops_expr.cu) and
// S1 (salsa20.cu): a 32-bit division by a launch invariant as a multiply
// and a shift, and each device's SM count, looked up once.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace nfl_launch {

constexpr int kMaxDevices = 64;

// floor(n / d) for n < 2^31 as __umulhi(n, mul) >> shr (d > 1), with mul =
// ceil(2^(31 + l) / d), l = ceil(log2 d): the error n * d / 2^(31 + l) of
// the rounded-up reciprocal stays below one.
struct FastDiv {
  uint32_t d, mul, shr;
};

inline FastDiv make_div(uint32_t d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    uint32_t l = 0;
    while ((1ull << l) < d) ++l;
    f.mul = static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d);
    f.shr = l - 1;
  }
  return f;
}

__device__ __forceinline__ uint32_t quot(const FastDiv& f, uint32_t n) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shr;
}

// the SM count of each device, looked up at its first launch
inline cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  int n = cache[device].load(std::memory_order_relaxed);
  if (n == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cache[device].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

}  // namespace nfl_launch
