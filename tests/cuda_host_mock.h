// A host stand-in for the parts of the CUDA runtime that the butterfly
// stage engine (nfllib_tpu_torch/csrc/ntt_butterfly.cuh), the device
// samplers' kernels (salsa20.cu, gaussian_fixed.cu, gaussian_exact.cu,
// hwt.cu) and the elementwise program kernel (modops_expr.cu) use, so that
// their sources compile with g++ and run on the CPU in
// tests/test_torch_bfly_host.py, tests/test_torch_sampling_host.py,
// tests/test_torch_gaussian_kernels.py, tests/test_torch_hwt_kernels.py
// and tests/test_torch_modops_expr.py: each block of a launch runs as
// blockDim.x std::threads sharing one barrier (__syncthreads) and one
// shared-memory buffer, blocks one after another; a cluster launch
// (cudaLaunchKernelEx with a cluster dimension) runs each cluster's blocks
// together, each with its own buffer, under one cluster barrier
// (cooperative_groups::this_cluster().sync()), and map_shared_rank gives a
// peer block's buffer.  It checks the engine's index arithmetic, rounds,
// prologues and epilogues, not its speed; the test rewrites
// `kernel<<<grid, block, smem, stream>>>(args)` as
// mock_launch(kernel, grid, block, smem, stream, args), the dynamic
// shared-memory declaration as a pointer to mock_smem (the running block's
// buffer) and drops the cooperative_groups include.
#pragma once
#include <atomic>
#include <barrier>
#include <bit>
#include <cstddef>
#include <cstdint>
#include <memory>
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
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union {
    struct { unsigned x, y, z; } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
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

// the running thread's block: its barrier and shared memory
inline thread_local std::barrier<>* mock_barrier = nullptr;
inline void __syncthreads() { mock_barrier->arrive_and_wait(); }
// the card's limit for one block (227 KB)
inline constexpr size_t kMockSmem = 232448;
alignas(16) inline unsigned char mock_smem_buf[kMockSmem];
inline thread_local unsigned char* mock_smem = nullptr;
inline int mock_launch_count = 0;

// The running thread's cluster: its blocks' shared memory by rank, one
// barrier over all their threads, and the thread's block's rank.
struct MockCluster {
  std::barrier<> bar;
  std::vector<unsigned char*> smem;
  explicit MockCluster(std::ptrdiff_t threads) : bar(threads) {}
};
inline thread_local MockCluster* mock_cluster = nullptr;
inline thread_local unsigned mock_cluster_rank = 0;

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return mock_cluster_rank; }
  void sync() const { mock_cluster->bar.arrive_and_wait(); }
  // the word at p's offset in block `rank`'s shared memory
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const auto* own = mock_cluster->smem[mock_cluster_rank];
    return reinterpret_cast<T*>(mock_cluster->smem[rank] +
                                (reinterpret_cast<unsigned char*>(p) - own));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
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
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            mock_barrier = &bar;
            mock_smem = mock_smem_buf;
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}

// A launch with attributes: a cluster dimension (else clusters of one
// block) runs each cluster's blocks at once, each with its own
// shared-memory buffer.  The card's limits refuse it (returned, as
// cudaLaunchKernelEx does): those of mock_launch, more than 8 blocks a
// cluster (the portable size) and a grid that clusters do not tile.
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(P...), A&&... args) {
  ++mock_launch_count;
  dim3 cl(1, 1, 1);
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      const auto& d = cfg->attrs[i].val.clusterDim;
      cl = dim3(d.x, d.y, d.z);
    }
  const dim3 grid = cfg->gridDim, block = cfg->blockDim;
  const unsigned size = cl.x * cl.y * cl.z;
  if (block.x > 1024 || grid.y > 65535 || grid.z > 65535 ||
      cfg->dynamicSmemBytes > kMockSmem || size == 0 || size > 8 ||
      grid.x % cl.x || grid.y % cl.y || grid.z % cl.z)
    return cudaErrorInvalidConfiguration;
  gridDim = grid;
  blockDim = block;
  const size_t words = (cfg->dynamicSmemBytes + 15) / 16;
  for (unsigned z = 0; z < grid.z; z += cl.z)
    for (unsigned y = 0; y < grid.y; y += cl.y)
      for (unsigned x = 0; x < grid.x; x += cl.x) {
        MockCluster cluster(static_cast<std::ptrdiff_t>(size) * block.x);
        std::vector<std::unique_ptr<uint4[]>> bufs;
        std::vector<std::unique_ptr<std::barrier<>>> bars;
        for (unsigned r = 0; r < size; ++r) {
          bufs.emplace_back(new uint4[words ? words : 1]);
          cluster.smem.push_back(
              reinterpret_cast<unsigned char*>(bufs.back().get()));
          bars.emplace_back(new std::barrier<>(block.x));
        }
        std::vector<std::thread> threads;
        for (unsigned r = 0; r < size; ++r)
          for (unsigned t = 0; t < block.x; ++t)
            threads.emplace_back([&, r, t] {
              threadIdx = dim3(t);
              blockIdx = dim3(x + r % cl.x, y + r / cl.x % cl.y,
                              z + r / (cl.x * cl.y));
              mock_barrier = bars[r].get();
              mock_smem = cluster.smem[r];
              mock_cluster = &cluster;
              mock_cluster_rank = r;
              kernel(args...);
            });
        for (auto& th : threads) th.join();
      }
  return cudaSuccess;
}
