// S4: the stream-exact discrete Gaussian, the host walk's variable
// consumption resolved on the chip, in two launches a sampler.
//
// Replaces XLA code, not a TPU kernel: nfllib_tpu/prng/device_sampling.py:
// device_gaussian_exact (:207; its keystream is prng/salsa20.py:130's and
// its search _count_barriers_le, :186), which XLA fuses into one program;
// its plain twin (device_sampling.gaussian_exact_plain) is about a hundred
// small torch ops.
//
// The host walk (prng/gaussian.py:_get_noise_py, reference
// FastGaussianNoise.hpp:478-595) fills a block of `innoise` words from a
// fresh stream (fill k reads the start of the stream at nonce base + k),
// consumes c(q) = 1, 2 or wp words a sample at position q (from the
// lookup tables luf, and at lu_depth 2 slot / F2, of the one or two words
// at q), and refills when q + c(q) + wp >= innoise.  So the sample starts
// of fill k are the orbit of 0 under g(q) = q + c(q), or the sentinel
// innoise when that crosses the refill line; the samples are the first
// rlen of the orbits in fill order; and the host makes 1 + (the number of
// selected samples whose successor is the sentinel) fills.
//
// Launch 1, gaussian_walk_kernel: one block of kWalkThreads a refill block
// k < nblocks (the twin's static budget).  It makes fill k's keystream
// (ceil(innoise * in_bits / 512) Salsa20 blocks, one thread each,
// salsa20_block.cuh) into its scratch, builds g over the innoise words,
// finds the orbit of 0 by pointer doubling (pos[len + j] = g^len(pos[j])
// beside g^2len = g^len o g^len, one barrier a round, ceil(log2(jmax))
// rounds at most, stopped once the orbit has reached the sentinel), and
// evaluates the sample at each orbit position: lu_val of the first word,
// the second level's V2, or base + the barrier search of
// gaussian_search.cuh.  It writes the values, the orbit's length and
// whether its last successor is the sentinel.  Launch 2,
// gaussian_select_kernel: one thread an output coefficient picks its fill
// and position from the prefix of the orbit lengths, multiplies by amp and
// writes p_c + v for v < 0 in every channel; thread 0 writes the fill
// count and the next sampler's nonce (base + fills) to a device int64[2],
// so exact samplers chain on the device with no host read.
//
// Scratch: at the demo's n = 2^14 (innoise = 18,880 words) a refill
// block's words, two successor buffers and the positions take 146 KB of
// shared memory with 16-bit indices (the instance the card runs).  Where
// they do not fit (a larger degree, or innoise past 65,534) the same
// kernel runs with 32-bit indices and its scratch in global memory: a
// dispatch between two instances of one kernel, on the size.  The first
// level tables (at in_bits 8) and the barrier table go to shared memory
// when they fit beside the walk, F2 / V2 stay in global memory (read at
// flagged words only).
//
// Bound on this card: the operations.  The keystream is 640 ALU
// instructions a 64-byte block; the walk a few instructions and
// shared-memory accesses a word (the successor, then two loads and a
// store a word a doubling round); the search a few hundred instructions
// at the few flagged positions; the output m words a coefficient.  At n =
// 2^14 and 17 refill blocks that is about 5,000 Salsa20 blocks and 17 x
// 15 rounds x 18,880 words, a few microseconds of the card's pipes; a
// block runs on one SM, so its rounds take as long as one SM needs.

#include <cstdint>

#include <cuda_runtime.h>

#include "gaussian_search.cuh"
#include "salsa20_block.cuh"

namespace {

constexpr int kWalkThreads = 1024;
constexpr int kSelectThreads = 256;
constexpr long long kHead = 16;      // scalars at the head of shared memory
constexpr long long kLut = 256 * 9;  // luf u8, luv i32, slot i32 at L = 256

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// The sampler's lookup tables on the device (apps: gaussian_tables).
struct Tables {
  const uint8_t* luf;      // [L] 0 / 1
  const long long* luv;    // [L]
  const long long* slot;   // [L] (lu_depth 2)
  const int32_t* v2;       // [K + 1, L] (lu_depth 2)
  const uint8_t* f2;       // [K + 1, L] (lu_depth 2)
  const uint16_t* bw;      // [nb, wp]
};

struct Shape {
  int rlen, innoise, jmax, nblocks, nks, wp, depth, L, nb, base;
};

// Where a launch keeps what: sizes in bytes.
struct Plan {
  int shared;            // the walk in shared memory, 16-bit indices
  long long walk;        // words, two successor buffers, positions
  long long lut;         // first-level tables in shared memory, else 0
  long long table;       // barrier table in shared memory, else 0
  long long smem;        // the walk kernel's dynamic shared memory
  long long scratch;     // global scratch: values, orbit lengths, walks
};

inline long long walk_bytes(const Shape& s, long long idx) {
  return align16(static_cast<long long>(s.nks) * 64)
         + 2 * align16((s.innoise + 1LL) * idx) + align16(s.jmax * idx);
}

inline Plan plan_for(const Shape& s, long long cap) {
  Plan pl;
  pl.shared = s.innoise < 65535 && kHead + walk_bytes(s, 2) <= cap;
  pl.walk = walk_bytes(s, pl.shared ? 2 : 4);
  long long used = kHead + (pl.shared ? pl.walk : 0);
  pl.lut = s.L == 256 && used + kLut <= cap ? kLut : 0;
  used += pl.lut;
  const long long table = align16(2LL * s.nb * s.wp);
  pl.table = used + table <= cap ? table : 0;
  pl.smem = used + pl.table;
  pl.scratch = align16(4LL * s.nblocks * s.jmax) + align16(8LL * s.nblocks)
               + (pl.shared ? 0 : s.nblocks * pl.walk);
  return pl;
}

template <class W, class Idx, bool kShared>
__global__ void __launch_bounds__(kWalkThreads) gaussian_walk_kernel(
    nfl_salsa::Key key, const long long* __restrict__ nonce_dev,
    unsigned long long nonce_add, Shape s, Plan pl, Tables t,
    unsigned char* __restrict__ gwalk, int32_t* __restrict__ vals,
    int32_t* __restrict__ meta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  int* scal = reinterpret_cast<int*>(smem_raw);
  unsigned char* wb = kShared ? smem_raw + kHead : gwalk + k * pl.walk;
  uint32_t* ks = reinterpret_cast<uint32_t*>(wb);
  const long long off_a = align16(static_cast<long long>(s.nks) * 64);
  const long long buf = align16((s.innoise + 1LL) * sizeof(Idx));
  Idx* F = reinterpret_cast<Idx*>(wb + off_a);
  Idx* G = reinterpret_cast<Idx*>(wb + off_a + buf);
  Idx* pos = reinterpret_cast<Idx*>(wb + off_a + 2 * buf);
  unsigned char* tail = smem_raw + kHead + (kShared ? pl.walk : 0);

  // fill k's keystream, and the tables that fit into shared memory
  const uint64_t nonce = nfl_salsa::nonce_of(nonce_dev, nonce_add, k);
  for (int b = tid; b < s.nks; b += kWalkThreads) {
    uint32_t x[16];
    nfl_salsa::block(key, nonce, static_cast<uint64_t>(b), x);
#pragma unroll
    for (int w = 0; w < 16; ++w) ks[b * 16 + w] = x[w];
  }
  const uint8_t* luf = t.luf;
  const int32_t* luv = nullptr;
  const int32_t* slot = nullptr;
  int32_t* lut_v = reinterpret_cast<int32_t*>(tail + 256);
  int32_t* lut_s = reinterpret_cast<int32_t*>(tail + 1280);
  if (pl.lut) {
    nfl_gauss::stage(tail, t.luf, 256);
    for (int w = tid; w < 256; w += kWalkThreads) {
      lut_v[w] = static_cast<int32_t>(__ldg(t.luv + w));
      lut_s[w] =
          s.depth == 2 ? static_cast<int32_t>(__ldg(t.slot + w)) : 0;
    }
    luf = tail;
    luv = lut_v;
    slot = lut_s;
  }
  const uint16_t* bw = t.bw;
  if (pl.table) {
    uint16_t* st = reinterpret_cast<uint16_t*>(tail + pl.lut);
    nfl_gauss::stage(st, t.bw, static_cast<long long>(s.nb) * s.wp);
    bw = st;
  }
  __syncthreads();
  const W* words = reinterpret_cast<const W*>(ks);
  const Idx sentinel = static_cast<Idx>(s.innoise);

  // the first-level tables of a wide in_bits are read from global memory
  // (luv and slot as int64 there)
  auto lu_val = [&](int w0) {
    return luv != nullptr ? luv[w0] : static_cast<int>(__ldg(t.luv + w0));
  };
  auto lu_slot = [&](int w0) {
    return slot != nullptr ? slot[w0] : static_cast<int>(__ldg(t.slot + w0));
  };
  // c(q): the words the host walk consumes for the sample at q (the
  // second word wraps to 0 at the end, as the twin's roll; no orbit
  // position reads it there)
  auto consume = [&](int q) {
    const int w0 = words[q];
    if (!luf[w0]) return 1;
    if (s.depth == 1) return s.wp;
    const int w1 = words[q + 1 < s.innoise ? q + 1 : 0];
    return __ldg(t.f2 + static_cast<long long>(lu_slot(w0)) * s.L + w1)
               ? s.wp : 2;
  };

  // the successor table g, with the sentinel column at innoise
  for (int q = tid; q <= s.innoise; q += kWalkThreads) {
    Idx g = sentinel;
    if (q < s.innoise) {
      const int nxt = q + consume(q);
      if (nxt + s.wp < s.innoise) g = static_cast<Idx>(nxt);
    }
    F[q] = g;
  }
  if (tid == 0) pos[0] = 0;
  __syncthreads();

  // the orbit of 0 by doubling: F = g^len, G the next power's buffer
  int len = 1;
  while (len < s.jmax) {
    const int add = len < s.jmax - len ? len : s.jmax - len;
    const bool compose = 2 * len < s.jmax;
    for (int j = tid; j < add; j += kWalkThreads) pos[len + j] = F[pos[j]];
    if (compose)
      for (int q = tid; q <= s.innoise; q += kWalkThreads) G[q] = F[F[q]];
    __syncthreads();
    len += add;
    if (compose) {
      Idx* h = F;
      F = G;
      G = h;
    }
    if (pos[len - 1] == sentinel) break;   // every later one is too
  }

  // the orbit's length: the last position before the sentinel
  for (int j = tid; j < len; j += kWalkThreads)
    if (pos[j] != sentinel && (j + 1 == len || pos[j + 1] == sentinel))
      scal[0] = j + 1;
  __syncthreads();
  const int cnt = scal[0];

  // the sample at every orbit position (the start clamped as the twin's)
  const int steps = nfl_gauss::search_steps(s.nb);
  for (int j = tid; j < cnt; j += kWalkThreads) {
    int q = pos[j];
    q = q < s.innoise - s.wp ? q : s.innoise - s.wp;
    const int w0 = words[q];
    int v;
    if (!luf[w0]) {
      v = lu_val(w0);
    } else if (s.depth == 1) {
      v = s.base + nfl_gauss::count_le(words + q, bw, s.nb, s.wp, steps);
    } else {
      const long long at = static_cast<long long>(lu_slot(w0)) * s.L
                           + words[q + 1];
      v = __ldg(t.f2 + at)
              ? s.base + nfl_gauss::count_le(words + q, bw, s.nb, s.wp,
                                             steps)
              : __ldg(t.v2 + at);
    }
    vals[static_cast<long long>(k) * s.jmax + j] = v;
    if (j == cnt - 1) {
      // does the host refill after this sample? (its successor is the
      // sentinel; false only where the orbit runs past jmax)
      meta[2 * k] = cnt;
      meta[2 * k + 1] = q + consume(q) + s.wp >= s.innoise;
    }
  }
}

__global__ void __launch_bounds__(kSelectThreads) gaussian_select_kernel(
    const int32_t* __restrict__ vals, const int32_t* __restrict__ meta,
    Shape s, long long amp, const long long* __restrict__ p, int m,
    int out_bytes, void* __restrict__ out, long long* __restrict__ fills_out,
    const long long* __restrict__ nonce_dev, unsigned long long nonce_add) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* off = reinterpret_cast<int*>(smem_raw);   // [nblocks + 1]
  if (threadIdx.x == 0) {
    int o = 0;
    for (int k = 0; k < s.nblocks; ++k) {
      off[k] = o;
      o += meta[2 * k];
    }
    off[s.nblocks] = o;
    if (blockIdx.x == 0) {
      // the host's fills: the first, and one after every selected sample
      // whose successor is the sentinel (a fill's last, when selected)
      long long fills = 1;
      for (int k = 0; k < s.nblocks; ++k)
        fills += meta[2 * k + 1] && off[k] + meta[2 * k] - 1 < s.rlen;
      fills_out[0] = fills;
      fills_out[1] = static_cast<long long>(
          nfl_salsa::nonce_of(nonce_dev, nonce_add, fills));
    }
  }
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kSelectThreads
                      + threadIdx.x;
  if (i >= s.rlen) return;
  long long v = 0;   // the twin's zero where the budget ran short
  for (int k = 0; k < s.nblocks; ++k)
    if (i < off[k + 1]) {
      v = vals[static_cast<long long>(k) * s.jmax + (i - off[k])];
      break;
    }
  nfl_gauss::store_residues(out, out_bytes, i, s.rlen, m, p, v * amp);
}

inline Shape shape_of(int rlen, int innoise, int nblocks, int in_bits,
                      int wp, int lu_depth, int nb, int base) {
  Shape s;
  s.rlen = rlen;
  s.innoise = innoise;
  s.jmax = innoise < rlen ? innoise : rlen;
  s.nblocks = nblocks;
  s.nks = static_cast<int>((static_cast<long long>(innoise) * in_bits / 8
                            + 63) / 64);
  s.wp = wp;
  s.depth = lu_depth;
  s.L = 1 << in_bits;
  s.nb = nb;
  s.base = base;
  return s;
}

template <class W, class Idx, bool kShared>
int launch_walk(dim3 grid, const Plan& pl, cudaStream_t st,
                const nfl_salsa::Key& key, const long long* nd,
                unsigned long long nonce_add, const Shape& s,
                const Tables& t, unsigned char* gwalk, int32_t* vals,
                int32_t* meta) {
  const cudaError_t err = cudaFuncSetAttribute(
      gaussian_walk_kernel<W, Idx, kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(pl.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gaussian_walk_kernel<W, Idx, kShared><<<grid, kWalkThreads,
                                          static_cast<size_t>(pl.smem), st>>>(
      key, nd, nonce_add, s, pl, t, gwalk, vals, meta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Where a sampler's launch keeps its walk: out[0] = 1 when in shared
// memory (16-bit indices), out[1] the walk kernel's dynamic shared memory,
// out[2] the bytes of global scratch nfl_gaussian_exact takes.  smem_cap:
// the shared memory a block may use (the card's 232,448 bytes).
extern "C" void nfl_gaussian_exact_plan(int rlen, int innoise, int nblocks,
                                        int in_bits, int wp, int nb,
                                        long long smem_cap, long long* out) {
  const Plan pl = plan_for(
      shape_of(rlen, innoise, nblocks, in_bits, wp, 1, nb, 0), smem_cap);
  out[0] = pl.shared;
  out[1] = pl.smem;
  out[2] = pl.scratch;
}

// Plain C entry point for ctypes: the two launches of one exact sampler.
// key: 8 host words; nonce_dev: a device int64 or null; nonce_add: added
// to it; luf (uint8 / bool [L]), luv (int64 [L]), slot (int64 [L]), v2
// (int32 [K + 1, L]), f2 (uint8 / bool [K + 1, L]): the sampler's lookup
// tables (slot, v2 and f2 null at lu_depth 1); barriers: [nb, wp] uint16;
// p: [m] int64; out: [m, rlen] words of out_bytes; fills_out: int64 [2]
// (fills, nonce + fills); scratch: nfl_gaussian_exact_plan's bytes.  All
// device pointers.  Returns the cudaError_t of the launches (0 on
// success); an argument the kernels do not take returns
// cudaErrorInvalidValue.
extern "C" int nfl_gaussian_exact(
    const uint32_t* key, const void* nonce_dev, unsigned long long nonce_add,
    int rlen, int innoise, int nblocks, int in_bits, int wp, int lu_depth,
    const void* luf, const void* luv, const void* slot, const void* v2,
    const void* f2, const void* barriers, int nb, int base, long long amp,
    const void* p, int m, int out_bytes, void* out, void* fills_out,
    void* scratch, long long smem_cap, void* stream) {
  if ((in_bits != 8 && in_bits != 16) || wp <= 0 || nb <= 0 || m <= 0
      || rlen <= 0 || nblocks <= 0 || innoise <= wp
      || (lu_depth != 1 && lu_depth != 2)
      || (lu_depth == 2 && (slot == nullptr || v2 == nullptr
                            || f2 == nullptr))
      || (out_bytes != 2 && out_bytes != 4 && out_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape_of(rlen, innoise, nblocks, in_bits, wp, lu_depth, nb,
                           base);
  const Plan pl = plan_for(s, smem_cap);
  nfl_salsa::Key k;
  for (int w = 0; w < 8; ++w) k.w[w] = key[w];
  Tables t;
  t.luf = static_cast<const uint8_t*>(luf);
  t.luv = static_cast<const long long*>(luv);
  t.slot = static_cast<const long long*>(slot);
  t.v2 = static_cast<const int32_t*>(v2);
  t.f2 = static_cast<const uint8_t*>(f2);
  t.bw = static_cast<const uint16_t*>(barriers);
  auto* base_ptr = static_cast<unsigned char*>(scratch);
  auto* vals = reinterpret_cast<int32_t*>(base_ptr);
  auto* meta = reinterpret_cast<int32_t*>(
      base_ptr + align16(4LL * nblocks * s.jmax));
  unsigned char* gwalk = base_ptr + align16(4LL * nblocks * s.jmax)
                         + align16(8LL * nblocks);
  const auto* nd = static_cast<const long long*>(nonce_dev);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nblocks));
  int err;
  if (in_bits == 8)
    err = pl.shared ? launch_walk<uint8_t, uint16_t, true>(
                          grid, pl, st, k, nd, nonce_add, s, t, gwalk, vals,
                          meta)
                    : launch_walk<uint8_t, int32_t, false>(
                          grid, pl, st, k, nd, nonce_add, s, t, gwalk, vals,
                          meta);
  else
    err = pl.shared ? launch_walk<uint16_t, uint16_t, true>(
                          grid, pl, st, k, nd, nonce_add, s, t, gwalk, vals,
                          meta)
                    : launch_walk<uint16_t, int32_t, false>(
                          grid, pl, st, k, nd, nonce_add, s, t, gwalk, vals,
                          meta);
  if (err != 0) return err;
  const unsigned sel = static_cast<unsigned>(
      (rlen + kSelectThreads - 1) / kSelectThreads);
  gaussian_select_kernel<<<sel, kSelectThreads,
                           static_cast<size_t>(4 * (nblocks + 1)), st>>>(
      vals, meta, s, amp, static_cast<const long long*>(p), m, out_bytes,
      out, static_cast<long long*>(fills_out), nd, nonce_add);
  return static_cast<int>(cudaGetLastError());
}
