// E1: one program of modular elementwise ops, evaluated in one pass.
//
// Replaces XLA code, not a TPU kernel: the JAX package compiles each named
// Poly op into one jitted program per (ring, op) (nfllib_tpu/poly.py:59
// _jitted_impl) and each lazy Expr tree into one per tree shape
// (nfllib_tpu/poly.py:320 _chain_program_impl), which XLA fuses into one
// pass over memory, the single-pass contract of NFLlib's expression
// templates (reference core.hpp:25-37).  Eager torch runs one op per node
// and, on the u64 tier, about 150 kernels for one mulmod
// (nfllib_tpu_torch/ops/modops.py builds the 128-bit product from 16-bit
// pieces); this kernel runs the whole program in one launch.
//
// The program (nfllib_tpu_torch/ops/expr_program.py) is a list of at most
// kMaxInstr instructions over at most kMaxLeaves leaf tensors, passed by
// value.  An instruction is (op, dst, src[4]): a source is a slot (< kLeaf)
// or leaf j (kLeaf + j, read from global memory at this element); dst is a
// slot or kOut (the output).  A leaf that several instructions read is
// loaded into a slot once (kLoad).  Slots live in shared memory, slot-major
// ([slot][thread], 8 bytes a thread, free of bank conflicts), so a
// one-node program touches no shared memory at all.
//
// Every op computes, for every word input (not only canonical residues),
// bit for bit what the plain twin (ops/modops.py on int64 tensors) does:
//   u64 (BITS 64): the reference's word algorithms (ops.hpp:183-242,
//     opt/ops.hpp): the Newton-quotient mulmod with Pn, Shoup products,
//     compute_shoup through F = floor(2^125 / p), `__umul64hi` for the high
//     word, wrapping adds;
//   u16/u32 (BITS 16, 32): the twin widens to int64 and masks.  Its
//     products x * y % p use torch's floor `%` on the int64 product, which
//     wraps when x * y >= 2^63 (u32 words above p), so here the product's
//     residue comes from a Barrett step with floor(2^64 / p) (exact for
//     every 64-bit value: the quotient is short by at most one), then
//     2^64 mod p comes off when the product's top bit is set.
//     compute_shoup's floor((y mod p) 2^BITS / p) takes the same step.
// Leaves are read at their own width (2, 4 or 8 bytes; tables may arrive
// as int64 for a narrow ring) and masked to the limb, as the twin's widen
// does; the output is written at the limb's width.
//
// Layout: out is [..., m, slab] flattened; element i is in channel
// (i / slab) % m, whose constants are consts[ch] = {p, Pn, F, 0} (u64) or
// {p, floor(2^64 / p), 2^64 mod p, 0} (u16/u32).  Leaf j broadcasts over
// leading dimensions only: its element is i % numel_j.  Divisions by
// those run as a multiply and a shift (FastDiv, exact below 2^31), so a
// launch covers fewer than 2^31 elements; the wrapper chunks beyond.
//
// Bound on this card: the bytes, each leaf read once and the output written
// once (a u32 mulmod: 12 bytes an element; a u64 mulmod 24).  Design for
// it: a grid-stride loop with consecutive threads on consecutive elements
// (2-, 4- or 8-byte coalesced loads and stores), the table leaves
// broadcast over the batch read from L2 after the first pass, nothing
// staged.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxInstr = 80;     // 64 nodes and 16 loads
constexpr int kMaxLeaves = 16;
constexpr int kMaxSlots = 16;
constexpr int kLeaf = 128;        // source codes kLeaf + j read leaf j
constexpr int kOut = 255;         // the destination code of the output

enum Op : int {
  kAdd = 0, kSub, kMul, kMulAdd, kShoup, kShoupLazy, kMulAddShoup,
  kComputeShoup, kReduce, kLoad
};

// floor(n / d) for n < 2^31 as __umulhi(n, mul) >> shr (d > 1), with mul =
// ceil(2^(31 + l) / d), l = ceil(log2 d): the error n * d / 2^(31 + l) of
// the rounded-up reciprocal stays below one.
struct FastDiv {
  uint32_t d, mul, shr;
};

FastDiv make_div(uint32_t d) {
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

struct Params {
  unsigned char code[kMaxInstr][6];     // op, dst, src[4]
  int ninstr;
  const void* leaf[kMaxLeaves];
  FastDiv leaf_div[kMaxLeaves];         // by the leaf's element count
  int leaf_bytes[kMaxLeaves];
  FastDiv slab, m;
  const uint64_t* consts;               // [m, 4]
  void* out;
  uint32_t total;
};

__device__ __forceinline__ uint64_t sub_if_ge(uint64_t z, uint64_t p) {
  return z >= p ? z - p : z;
}

// floor(v / p) and v mod p for any 64-bit v, bm = floor(2^64 / p)
__device__ __forceinline__ uint64_t divmod64(uint64_t v, uint64_t p,
                                             uint64_t bm, uint64_t* r) {
  uint64_t q = __umul64hi(v, bm);
  uint64_t rem = v - q * p;
  if (rem >= p) {
    rem -= p;
    ++q;
  }
  *r = rem;
  return q;
}

// u16/u32: the twin's (x * y) % p on the int64 product, which wraps at
// 2^63 to x * y - 2^64 (c = 2^64 mod p)
__device__ __forceinline__ uint64_t mul_narrow(uint64_t x, uint64_t y,
                                               uint64_t p, uint64_t bm,
                                               uint64_t c) {
  const uint64_t v = x * y;
  uint64_t r;
  divmod64(v, p, bm, &r);
  if (v >> 63) r = r >= c ? r - c : r + p - c;
  return r;
}

// u64: the Newton-quotient reduction (reference ops.hpp:201-219)
__device__ __forceinline__ uint64_t mul_u64(uint64_t x, uint64_t y,
                                            uint64_t p, uint64_t pn) {
  const uint64_t hi = __umul64hi(x, y), lo = x * y;
  const uint64_t s_hi = (hi << 2) | (lo >> 62), s_lo = lo << 2;
  const uint64_t q_lo = pn * hi + s_lo;
  const uint64_t q_hi = __umul64hi(pn, hi) + s_hi + (q_lo < s_lo ? 1 : 0);
  return sub_if_ge(lo - q_hi * p, p);
}

// u64: floor((y mod p) 2^64 / p) through F = floor(2^125 / p)
__device__ __forceinline__ uint64_t shoup_u64(uint64_t y, uint64_t p,
                                              uint64_t f) {
  const uint64_t qy = __umul64hi(y, f) >> 61;
  const uint64_t yr = sub_if_ge(sub_if_ge(y - qy * p, p), p);
  uint64_t qhat = (__umul64hi(yr, f) << 3) | ((yr * f) >> 61);
  uint64_t r = 0 - qhat * p;
  for (int k = 0; k < 3; ++k) {
    if (r >= p) {
      r -= p;
      ++qhat;
    }
  }
  return qhat;
}

// One op on the operands s[] (masked limb words) at channel constants
// (p, k1, k2): u64 k1 = Pn, k2 = F; u16/u32 k1 = floor(2^64/p), k2 = 2^64
// mod p.
template <int BITS>
__device__ __forceinline__ uint64_t eval(int op, const uint64_t* s,
                                         uint64_t p, uint64_t k1,
                                         uint64_t k2) {
  if constexpr (BITS == 64) {
    switch (op) {
      case kAdd: return sub_if_ge(s[0] + s[1], p);
      case kSub: return sub_if_ge(s[0] + (p - s[1]), p);
      case kMul: return mul_u64(s[0], s[1], p, k1);
      case kMulAdd: return sub_if_ge(mul_u64(s[1], s[2], p, k1) + s[0], p);
      case kShoup:
        return sub_if_ge(s[0] * s[1] - __umul64hi(s[0], s[2]) * p, p);
      case kShoupLazy: return s[0] * s[1] - __umul64hi(s[0], s[2]) * p;
      case kMulAddShoup:
        return sub_if_ge(s[0] + (s[1] * s[2] - __umul64hi(s[1], s[3]) * p),
                         p);
      case kComputeShoup: return shoup_u64(s[0], p, k2);
      case kReduce: return sub_if_ge(s[0], p);
      default: return s[0];                                    // kLoad
    }
  } else {
    constexpr uint64_t kMask = (1ull << BITS) - 1;
    switch (op) {
      case kAdd: return sub_if_ge((s[0] + s[1]) & kMask, p);
      case kSub: return sub_if_ge((s[0] + ((p - s[1]) & kMask)) & kMask, p);
      case kMul: return mul_narrow(s[0], s[1], p, k1, k2);
      case kMulAdd:
        return sub_if_ge((mul_narrow(s[1], s[2], p, k1, k2) + s[0]) & kMask,
                         p);
      case kShoup:
      case kShoupLazy: {
        const uint64_t q = (s[0] * s[2]) >> BITS;
        const uint64_t r = (s[0] * s[1] - q * p) & kMask;
        return op == kShoup ? sub_if_ge(r, p) : r;
      }
      case kMulAddShoup: {
        const uint64_t q = (s[1] * s[3]) >> BITS;
        return sub_if_ge((s[0] + s[1] * s[2] - q * p) & kMask, p);
      }
      case kComputeShoup: {
        uint64_t yr, r;
        divmod64(s[0], p, k1, &yr);
        return divmod64(yr << BITS, p, k1, &r);
      }
      case kReduce: return sub_if_ge(s[0], p);
      default: return s[0];                                      // kLoad
    }
  }
}

__device__ __forceinline__ uint64_t read_leaf(const Params& P, int j,
                                              uint32_t i) {
  const FastDiv& f = P.leaf_div[j];
  const uint32_t k = i - quot(f, i) * f.d;
  switch (P.leaf_bytes[j]) {
    case 2: return __ldg(static_cast<const uint16_t*>(P.leaf[j]) + k);
    case 4: return __ldg(static_cast<const uint32_t*>(P.leaf[j]) + k);
    default:
      return __ldg(static_cast<const unsigned long long*>(P.leaf[j]) + k);
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads) modops_expr_kernel(
    const __grid_constant__ Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* slots = reinterpret_cast<uint64_t*>(smem_raw);
  constexpr uint64_t kMask = ~0ull >> (64 - BITS);
  const uint32_t step = gridDim.x * kThreads;
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < P.total;
       i += step) {
    const uint32_t row = quot(P.slab, i);
    const uint32_t ch = row - quot(P.m, row) * P.m.d;
    const uint64_t* c = P.consts + 4 * ch;
    const uint64_t p = __ldg(c), k1 = __ldg(c + 1), k2 = __ldg(c + 2);
    for (int k = 0; k < P.ninstr; ++k) {
      const unsigned char* ins = P.code[k];
      const int op = ins[0];
      const int nsrc = op == kMulAddShoup ? 4
                       : op == kMulAdd || op == kShoup || op == kShoupLazy
                           ? 3
                       : op <= kMul ? 2 : 1;
      uint64_t s[4];
      for (int a = 0; a < 4; ++a) {
        if (a < nsrc) {
          const int src = ins[2 + a];
          s[a] = src >= kLeaf ? read_leaf(P, src - kLeaf, i) & kMask
                              : slots[src * kThreads + threadIdx.x];
        }
      }
      const uint64_t r = eval<BITS>(op, s, p, k1, k2) & kMask;
      if (ins[1] == kOut) {
        if (BITS == 16)
          static_cast<uint16_t*>(P.out)[i] = static_cast<uint16_t>(r);
        else if (BITS == 32)
          static_cast<uint32_t*>(P.out)[i] = static_cast<uint32_t>(r);
        else
          static_cast<uint64_t*>(P.out)[i] = r;
      } else {
        slots[ins[1] * kThreads + threadIdx.x] = r;
      }
    }
  }
}

}  // namespace

// The program as the host passes it (the ctypes Structure of
// nfllib_tpu_torch/_kernels.py:ExprProgram).
struct NflExprProgram {
  int32_t ninstr, nslots, nleaves, pad;
  unsigned char code[kMaxInstr * 6];
  const void* leaf[kMaxLeaves];
  long long leaf_numel[kMaxLeaves];
  int32_t leaf_bytes[kMaxLeaves];
};

// Plain C entry point for ctypes.  bits: 16, 32 or 64; out: `total`
// elements of [..., m, slab] at the limb width; consts: [m, 4] u64.
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for a program or shape out of range.
extern "C" int nfl_modops_expr(int bits, const NflExprProgram* prog,
                               void* out, const void* consts,
                               long long total, long long slab, int m,
                               void* stream) {
  if (prog->ninstr < 1 || prog->ninstr > kMaxInstr || prog->nslots < 0
      || prog->nslots > kMaxSlots || prog->nleaves < 1
      || prog->nleaves > kMaxLeaves || total < 1 || total >= (1ll << 31)
      || slab < 1 || m < 1 || total % (slab * m) != 0
      || (bits != 16 && bits != 32 && bits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  for (int k = 0; k < kMaxInstr; ++k)
    for (int b = 0; b < 6; ++b)
      P.code[k][b] = k < prog->ninstr ? prog->code[6 * k + b] : 0;
  P.ninstr = prog->ninstr;
  for (int j = 0; j < kMaxLeaves; ++j) {
    const bool used = j < prog->nleaves;
    const long long numel = used ? prog->leaf_numel[j] : 1;
    if (numel < 1 || numel > total || total % numel != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    P.leaf[j] = used ? prog->leaf[j] : nullptr;
    P.leaf_div[j] = make_div(static_cast<uint32_t>(numel));
    P.leaf_bytes[j] = used ? prog->leaf_bytes[j] : 8;
  }
  P.slab = make_div(static_cast<uint32_t>(slab));
  P.m = make_div(static_cast<uint32_t>(m));
  P.consts = static_cast<const uint64_t*>(consts);
  P.out = out;
  P.total = static_cast<uint32_t>(total);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (total + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  const int grid = static_cast<int>(want < cap ? want : cap);
  const size_t smem = static_cast<size_t>(prog->nslots) * kThreads * 8;
  if (bits == 16)
    modops_expr_kernel<16><<<grid, kThreads, smem, s>>>(P);
  else if (bits == 32)
    modops_expr_kernel<32><<<grid, kThreads, smem, s>>>(P);
  else
    modops_expr_kernel<64><<<grid, kThreads, smem, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}
