// A host stand-in for the parts of the CUDA runtime that the butterfly
// stage engine (nfllib_tpu_torch/csrc/ntt_butterfly.cuh), the device
// samplers' kernels (salsa20.cu, gaussian_fixed.cu, gaussian_exact.cu,
// hwt.cu) and the elementwise program kernel (modops_expr.cu) use, so that
// their sources compile with g++ and run on the CPU in
// tests/test_torch_bfly_host.py, tests/test_torch_sampling_host.py,
// tests/test_torch_gaussian_kernels.py, tests/test_torch_hwt_kernels.py
// and tests/test_torch_modops_expr.py: each block of a launch runs as
// blockDim.x std::threads sharing one barrier (__syncthreads) and one
// shared-memory buffer, blocks one after another.  It checks the engine's
// index arithmetic, rounds, prologues and epilogues, not its speed; the
// test rewrites `kernel<<<grid, block, smem, stream>>>(args)` as
// mock_launch(kernel, grid, block, smem, stream, args) and the dynamic
// shared-memory declaration as a pointer to mock_smem.
#pragma once
#include <atomic>
#include <barrier>
#include <bit>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
#define __grid_constant__

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) ulonglong2 { unsigned long long x, y; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };
// a card of kMockSms SMs: grid-stride kernels size their grids by it
inline constexpr int kMockSms = 2;
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) {
  *value = kMockSms;
  return cudaSuccess;
}

inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return static_cast<uint64_t>((static_cast<unsigned __int128>(a) * b) >> 64);
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t shift) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<uint32_t>((v << (shift & 31)) >> 32);
}
template <class T>
T __ldg(const T* p) { return *p; }
template <class T>
T __ldcg(const T* p) { return *p; }
inline double __drcp_rn(double x) { return 1.0 / x; }
// atomics on shared or global words, over std::atomic_ref (the old value)
template <class T>
T atomicAdd(T* a, T v) { return std::atomic_ref<T>(*a).fetch_add(v); }
inline unsigned atomicOr(unsigned* a, unsigned v) {
  return std::atomic_ref<unsigned>(*a).fetch_or(v);
}
inline int atomicMax(int* a, int v) {
  std::atomic_ref<int> r(*a);
  int old = r.load();
  while (old < v && !r.compare_exchange_weak(old, v)) {
  }
  return old;
}
// atomicInc: the old value; the word wraps to 0 past `top`
inline unsigned atomicInc(unsigned* a, unsigned top) {
  std::atomic_ref<unsigned> r(*a);
  unsigned old = r.load();
  while (!r.compare_exchange_weak(old, old >= top ? 0u : old + 1)) {
  }
  return old;
}
// a fence over every thread's earlier stores (the blocks of a launch run
// one after another here, so a last-block ticket sees every earlier block)
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline int __popc(unsigned x) { return std::popcount(x); }
inline int __popcll(unsigned long long x) { return std::popcount(x); }

inline std::barrier<>* mock_barrier = nullptr;
inline void __syncthreads() { mock_barrier->arrive_and_wait(); }
// the card's limit for one block (227 KB)
inline constexpr size_t kMockSmem = 232448;
alignas(16) inline unsigned char mock_smem[kMockSmem];
inline int mock_launch_count = 0;
inline int mock_error = 0;

template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int bytes) {
  return bytes > static_cast<int>(kMockSmem) ? cudaErrorInvalidValue
                                              : cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const int e = mock_error;
  mock_error = 0;
  return e;
}

// One launch: the card's limits refuse it as the card would (error 9),
// else every block runs, one at a time.
template <class K, class... A>
void mock_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                 A... args) {
  ++mock_launch_count;
  if (block.x > 1024 || grid.y > 65535 || grid.z > 65535 ||
      smem > kMockSmem) {
    mock_error = cudaErrorInvalidConfiguration;
    return;
  }
  gridDim = grid;
  blockDim = block;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(block.x);
        mock_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
