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
// or leaf j (kLeaf + j, read from global memory in place); dst is a slot or
// kOut (the output).  A leaf that several instructions read is loaded into
// a slot once (kLoad).
//
// Every op computes, for every word input (not only canonical residues),
// bit for bit what the plain twin (ops/modops.py on int64 tensors) does:
//   u64 (BITS 64): the reference's word algorithms (ops.hpp:183-242,
//     opt/ops.hpp): the Newton-quotient mulmod with Pn, Shoup products,
//     compute_shoup through F = floor(2^125 / p), `__umul64hi` for the high
//     word, wrapping adds;
//   u16/u32 (BITS 16, 32; every modulus below 2^31): the twin widens to
//     int64 and masks.  Its products x * y % p use torch's floor `%` on the
//     int64 product, which wraps when x * y >= 2^63 (u32 words above p), so
//     the product's residue is taken exactly for any 64-bit value and 2^64
//     mod p comes off when the product's top bit is set.  The reduction is
//     32-bit work: the high word is reduced by a 32-bit Barrett step, then
//     (high mod p, low word) is divided by the normalized modulus
//     d = p 2^s with Moller and Granlund's 2-by-1 division by an invariant
//     ("Improved division by invariant integers", IEEE TC 2011, Alg. 4),
//     two 32 x 32 -> 64 products in all and no 64 x 64 high product.
//     compute_shoup's floor((y mod p) 2^BITS / p) is the same division's
//     quotient.
// Leaves are read at their own width (2, 4 or 8 bytes; tables may arrive
// as int64 for a narrow ring) and masked to the limb, as the twin's widen
// does; the output is written at the limb's width.
//
// Layout: out is [..., m, slab] flattened; element i is in channel
// (i / slab) % m, whose constants are consts[ch] = {p, Pn, F, 0} (u64) or,
// as 32-bit words, {p, d, s, v, 2^64 mod p, floor(2^32 / p), 0, 0}
// (u16/u32; v the division's reciprocal).  Leaf j broadcasts over leading
// dimensions only: its element is i % numel_j.  Divisions by those run as
// a multiply and a shift (FastDiv, exact below 2^31), so a launch covers
// fewer than 2^31 elements; the wrapper chunks beyond.
//
// Bound on this card: the bytes, each leaf read once and the output written
// once (a u32 mulmod: 12 bytes an element; a u64 mulmod 24).  Design for
// it:
//   * vector lanes: a thread takes VEC consecutive elements at a time, 16
//     bytes of output (8 u16, 4 u32, 2 u64 words), and moves every leaf and
//     the output as 16-byte loads and stores (an int64 table under a narrow
//     ring as 2 or 4 of them).  The host takes this instance when every
//     pointer is 16-byte aligned and the slab, the total and every leaf's
//     element count are multiples of VEC, so a vector never crosses a slab
//     or a leaf's period; else the same template at VEC = 1.
//   * the channel, each leaf's broadcast index and (for a tree) each
//     instruction's decode are paid once a vector, not once an element;
//   * a one-node program (a named op, expr_program.op_program) runs an
//     instance with the opcode as a template argument: no decode, no
//     switch, no shared memory.  A tree runs the interpreter, its live
//     values in shared memory at VEC words a slot a thread (16 bytes,
//     [slot][thread], so a warp's accesses are conflict-free);
//   * a grid-stride loop over vectors with at most kBlocksPerSm blocks of
//     kThreads an SM, so each SM keeps thousands of 16-byte loads in
//     flight.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

using nfl_launch::FastDiv;
using nfl_launch::make_div;
using nfl_launch::quot;
using nfl_launch::sm_count;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;
constexpr int kMaxInstr = 80;     // 64 nodes and 16 loads
constexpr int kMaxLeaves = 16;
constexpr int kMaxSlots = 16;
constexpr int kLeaf = 128;        // source codes kLeaf + j read leaf j
constexpr int kOut = 255;         // the destination code of the output
constexpr int kTree = -1;         // the OP of the interpreter's instances
constexpr size_t kDefaultSmem = 48 * 1024;

enum Op : int {
  kAdd = 0, kSub, kMul, kMulAdd, kShoup, kShoupLazy, kMulAddShoup,
  kComputeShoup, kReduce, kLoad
};

__host__ __device__ constexpr int arity(int op) {
  return op == kMulAddShoup ? 4
         : op == kMulAdd || op == kShoup || op == kShoupLazy ? 3
         : op <= kMul ? 2 : 1;
}

struct Params {
  unsigned long long code[kMaxInstr];   // op | dst << 8 | src_a << 16 + 8a
  int ninstr;
  const void* leaf[kMaxLeaves];
  FastDiv leaf_div[kMaxLeaves];         // by the leaf's count of vectors
  int leaf_bytes[kMaxLeaves];
  FastDiv slab, m;                      // slab in vectors
  const unsigned long long* consts;     // [m, 4]
  void* out;
  uint32_t nvec;                        // vectors of VEC elements
};

// the storage word S and the arithmetic word T of a tier
template <int BITS> struct Tier {
  using S = uint32_t;
  using T = uint32_t;
};
template <> struct Tier<16> {
  using S = uint16_t;
  using T = uint32_t;
};
template <> struct Tier<64> {
  using S = unsigned long long;
  using T = uint64_t;
};

// VEC storage words: a 16-byte vector, or one word
template <class S, int VEC>
struct alignas(sizeof(S) * VEC) Lanes {
  S v[VEC];
};

struct Wide {                 // u64 channel constants
  uint64_t p, pn, f;
};
struct Narrow {               // u16/u32 channel constants
  uint32_t p, d, s, v, c, m32;
};
template <int BITS> struct ChanOf { using type = Narrow; };
template <> struct ChanOf<64> { using type = Wide; };

template <int BITS>
__device__ __forceinline__ typename ChanOf<BITS>::type load_chan(
    const unsigned long long* row) {
  const unsigned long long w0 = __ldg(row), w1 = __ldg(row + 1),
                           w2 = __ldg(row + 2);
  if constexpr (BITS == 64) {
    return Wide{w0, w1, w2};
  } else {
    return Narrow{static_cast<uint32_t>(w0), static_cast<uint32_t>(w0 >> 32),
                  static_cast<uint32_t>(w1), static_cast<uint32_t>(w1 >> 32),
                  static_cast<uint32_t>(w2),
                  static_cast<uint32_t>(w2 >> 32)};
  }
}

// ---------------------------------------------------------------------------
// u64 words
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t sub_if_ge(uint64_t z, uint64_t p) {
  return z >= p ? z - p : z;
}

// the Newton-quotient reduction (reference ops.hpp:201-219)
__device__ __forceinline__ uint64_t mul_u64(uint64_t x, uint64_t y,
                                            const Wide& c) {
  const uint64_t hi = __umul64hi(x, y), lo = x * y;
  const uint64_t s_hi = (hi << 2) | (lo >> 62), s_lo = lo << 2;
  const uint64_t q_lo = c.pn * hi + s_lo;
  const uint64_t q_hi = __umul64hi(c.pn, hi) + s_hi + (q_lo < s_lo ? 1 : 0);
  return sub_if_ge(lo - q_hi * c.p, c.p);
}

// floor((y mod p) 2^64 / p) through F = floor(2^125 / p)
__device__ __forceinline__ uint64_t shoup_u64(uint64_t y, const Wide& c) {
  const uint64_t p = c.p, f = c.f;
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

template <int OP>
__device__ __forceinline__ uint64_t eval64(const uint64_t* s, const Wide& c) {
  const uint64_t p = c.p;
  if constexpr (OP == kAdd) {
    return sub_if_ge(s[0] + s[1], p);
  } else if constexpr (OP == kSub) {
    return sub_if_ge(s[0] + (p - s[1]), p);
  } else if constexpr (OP == kMul) {
    return mul_u64(s[0], s[1], c);
  } else if constexpr (OP == kMulAdd) {
    return sub_if_ge(mul_u64(s[1], s[2], c) + s[0], p);
  } else if constexpr (OP == kShoup) {
    return sub_if_ge(s[0] * s[1] - __umul64hi(s[0], s[2]) * p, p);
  } else if constexpr (OP == kShoupLazy) {
    return s[0] * s[1] - __umul64hi(s[0], s[2]) * p;
  } else if constexpr (OP == kMulAddShoup) {
    return sub_if_ge(s[0] + (s[1] * s[2] - __umul64hi(s[1], s[3]) * p), p);
  } else if constexpr (OP == kComputeShoup) {
    return shoup_u64(s[0], c);
  } else if constexpr (OP == kReduce) {
    return sub_if_ge(s[0], p);
  } else {
    return s[0];                                                 // kLoad
  }
}

// ---------------------------------------------------------------------------
// u16/u32 words, in 32-bit arithmetic
// ---------------------------------------------------------------------------

// z >= p ? z - p : z for any 32-bit z (p < 2^32): an unsigned min
__device__ __forceinline__ uint32_t sub_if_ge(uint32_t z, uint32_t p) {
  const uint32_t t = z - p;
  return t < z ? t : z;
}

// w mod p for a 32-bit w: hi(w floor(2^32 / p)) is floor(w / p) or one
// short, so one conditional subtract (2p < 2^32)
__device__ __forceinline__ uint32_t reduce32(uint32_t w, const Narrow& c) {
  return sub_if_ge(w - __umulhi(w, c.m32) * c.p, c.p);
}

// the quotient and remainder of (u1 2^32 + u0) / d for u1 < d, d = p 2^s
// normalized (>= 2^31), v = floor((2^64 - 1) / d) - 2^32 (Moller and
// Granlund, Algorithm 4)
__device__ __forceinline__ uint32_t div21(uint32_t u1, uint32_t u0,
                                          const Narrow& c, uint32_t* rem) {
  const uint64_t q = static_cast<uint64_t>(c.v) * u1
                     + ((static_cast<uint64_t>(u1) << 32) | u0);
  uint32_t q1 = static_cast<uint32_t>(q >> 32) + 1;
  uint32_t r = u0 - q1 * c.d;
  if (r > static_cast<uint32_t>(q)) {
    --q1;
    r += c.d;
  }
  if (r >= c.d) {
    ++q1;
    r -= c.d;
  }
  *rem = r;
  return q1;
}

// the twin's (x * y) % p on the int64 product of two words, which wraps at
// 2^63 to x * y - 2^64
template <int BITS>
__device__ __forceinline__ uint32_t mul_narrow(uint32_t x, uint32_t y,
                                               const Narrow& c) {
  const uint32_t lo = x * y;
  uint32_t h = 0, r;
  if constexpr (BITS == 32) h = reduce32(__umulhi(x, y), c);
  // (h 2^32 + lo) 2^s as two words over d: h 2^s + (lo >> 32 - s) < d
  div21(__funnelshift_l(lo, h, c.s), lo << c.s, c, &r);
  r >>= c.s;
  if constexpr (BITS == 32) {
    if (__umulhi(x, y) >> 31) r = sub_if_ge(r + (c.p - c.c), c.p);
  }
  return r;
}

// floor((y mod p) 2^BITS / p)
template <int BITS>
__device__ __forceinline__ uint32_t shoup_narrow(uint32_t y,
                                                 const Narrow& c) {
  const uint32_t yr = reduce32(y, c);
  const uint32_t w1 = BITS == 32 ? yr : 0, w0 = BITS == 32 ? 0 : yr << 16;
  uint32_t r;
  return div21(__funnelshift_l(w0, w1, c.s), w0 << c.s, c, &r);
}

template <int BITS>
__device__ __forceinline__ uint32_t hi_word(uint32_t a, uint32_t b) {
  if constexpr (BITS == 32) {
    return __umulhi(a, b);
  } else {
    return (a * b) >> 16;
  }
}

template <int BITS, int OP>
__device__ __forceinline__ uint32_t eval32(const uint32_t* s,
                                         const Narrow& c) {
  constexpr uint32_t kMask = BITS == 32 ? 0xFFFFFFFFu : 0xFFFFu;
  const uint32_t p = c.p;
  if constexpr (OP == kAdd) {
    return sub_if_ge((s[0] + s[1]) & kMask, p);
  } else if constexpr (OP == kSub) {
    return sub_if_ge((s[0] + ((p - s[1]) & kMask)) & kMask, p);
  } else if constexpr (OP == kMul) {
    return mul_narrow<BITS>(s[0], s[1], c);
  } else if constexpr (OP == kMulAdd) {
    return sub_if_ge((mul_narrow<BITS>(s[1], s[2], c) + s[0]) & kMask, p);
  } else if constexpr (OP == kShoup || OP == kShoupLazy) {
    const uint32_t q = hi_word<BITS>(s[0], s[2]);
    const uint32_t r = (s[0] * s[1] - q * p) & kMask;
    return OP == kShoup ? sub_if_ge(r, p) : r;
  } else if constexpr (OP == kMulAddShoup) {
    const uint32_t q = hi_word<BITS>(s[1], s[3]);
    return sub_if_ge((s[0] + s[1] * s[2] - q * p) & kMask, p);
  } else if constexpr (OP == kComputeShoup) {
    return shoup_narrow<BITS>(s[0], c);
  } else if constexpr (OP == kReduce) {
    return sub_if_ge(s[0], p);
  } else {
    return s[0];                                                 // kLoad
  }
}

// ---------------------------------------------------------------------------
// memory: VEC words of a leaf, of a slot, of the output
// ---------------------------------------------------------------------------

// VEC words from p (16-byte aligned when VEC > 1)
template <int BITS, int VEC>
__device__ __forceinline__ void load_words(
    const typename Tier<BITS>::S* p, typename Tier<BITS>::T (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldg(p);
  } else if constexpr (BITS == 64) {
    const ulonglong2 w = __ldg(reinterpret_cast<const ulonglong2*>(p));
    v[0] = w.x;
    v[1] = w.y;
  } else {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t q[4] = {w.x, w.y, w.z, w.w};
    for (int k = 0; k < 4; ++k) {
      if constexpr (BITS == 32) {
        v[k] = q[k];
      } else {
        v[2 * k] = q[k] & 0xFFFFu;
        v[2 * k + 1] = q[k] >> 16;
      }
    }
  }
}

// VEC int64 table words under a narrow ring, masked to the limb
template <int BITS, int VEC>
__device__ __forceinline__ void load_table(const unsigned long long* p,
                                           uint32_t (&v)[VEC]) {
  constexpr uint32_t kMask = BITS == 32 ? 0xFFFFFFFFu : 0xFFFFu;
  if constexpr (VEC == 1) {
    v[0] = static_cast<uint32_t>(__ldg(p)) & kMask;
  } else {
    for (int h = 0; h < VEC / 2; ++h) {
      const ulonglong2 w = __ldg(reinterpret_cast<const ulonglong2*>(p) + h);
      v[2 * h] = static_cast<uint32_t>(w.x) & kMask;
      v[2 * h + 1] = static_cast<uint32_t>(w.y) & kMask;
    }
  }
}

// leaf j's VEC words at vector vi, broadcast over leading dimensions
template <int BITS, int VEC>
__device__ __forceinline__ void load_leaf(const Params& P, int j,
                                          uint32_t vi,
                                          typename Tier<BITS>::T (&v)[VEC]) {
  using S = typename Tier<BITS>::S;
  const FastDiv& f = P.leaf_div[j];
  const uint32_t k = (vi - quot(f, vi) * f.d) * VEC;
  if constexpr (BITS != 64) {
    if (P.leaf_bytes[j] == 8) {
      load_table<BITS, VEC>(
          static_cast<const unsigned long long*>(P.leaf[j]) + k, v);
      return;
    }
  }
  load_words<BITS, VEC>(static_cast<const S*>(P.leaf[j]) + k, v);
}

template <int BITS, int VEC>
__device__ __forceinline__ Lanes<typename Tier<BITS>::S, VEC> pack(
    const typename Tier<BITS>::T (&r)[VEC]) {
  using S = typename Tier<BITS>::S;
  Lanes<S, VEC> out;
  for (int k = 0; k < VEC; ++k) out.v[k] = static_cast<S>(r[k]);
  return out;
}

template <int BITS, int VEC>
__device__ __forceinline__ void unpack(
    const Lanes<typename Tier<BITS>::S, VEC>& w,
    typename Tier<BITS>::T (&v)[VEC]) {
  for (int k = 0; k < VEC; ++k) v[k] = w.v[k];
}

template <int BITS, int VEC>
__device__ __forceinline__ void store_out(const Params& P, uint32_t vi,
                                          const typename Tier<BITS>::T (
                                              &r)[VEC]) {
  using S = typename Tier<BITS>::S;
  static_cast<Lanes<S, VEC>*>(P.out)[vi] = pack<BITS, VEC>(r);
}

// one instruction of the interpreter on VEC words: its sources from the
// leaves or the slots, its result to a slot or the output
template <int BITS, int VEC, int OP>
__device__ __forceinline__ void step(
    const Params& P, unsigned long long ins, uint32_t vi,
    const typename ChanOf<BITS>::type& c,
    Lanes<typename Tier<BITS>::S, VEC>* slots) {
  using T = typename Tier<BITS>::T;
  T s[arity(OP)][VEC];
  for (int a = 0; a < arity(OP); ++a) {
    const int src = static_cast<int>((ins >> (16 + 8 * a)) & 0xFF);
    if (src >= kLeaf)
      load_leaf<BITS, VEC>(P, src - kLeaf, vi, s[a]);
    else
      unpack<BITS, VEC>(slots[src * kThreads + threadIdx.x], s[a]);
  }
  T r[VEC];
  for (int k = 0; k < VEC; ++k) {
    T x[4] = {};
    for (int a = 0; a < arity(OP); ++a) x[a] = s[a][k];
    if constexpr (BITS == 64)
      r[k] = eval64<OP>(x, c);
    else
      r[k] = eval32<BITS, OP>(x, c);
  }
  const int dst = static_cast<int>((ins >> 8) & 0xFF);
  if (dst == kOut)
    store_out<BITS, VEC>(P, vi, r);
  else
    slots[dst * kThreads + threadIdx.x] = pack<BITS, VEC>(r);
}

// OP = kTree: the interpreter (one decode a vector); else the one-node
// program OP over leaves 0 .. arity(OP) - 1, compiled
template <int BITS, int VEC, int OP>
__global__ void __launch_bounds__(kThreads) modops_expr_kernel(
    const __grid_constant__ Params P) {
  using T = typename Tier<BITS>::T;
  using L = Lanes<typename Tier<BITS>::S, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  L* slots = reinterpret_cast<L*>(smem_raw);
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t vi = blockIdx.x * kThreads + threadIdx.x; vi < P.nvec;
       vi += stride) {
    const uint32_t row = quot(P.slab, vi);
    const uint32_t ch = row - quot(P.m, row) * P.m.d;
    const auto c = load_chan<BITS>(P.consts + 4 * ch);
    if constexpr (OP == kTree) {
      for (int k = 0; k < P.ninstr; ++k) {
        const unsigned long long ins = P.code[k];
        switch (static_cast<int>(ins & 0xFF)) {
          case kAdd: step<BITS, VEC, kAdd>(P, ins, vi, c, slots); break;
          case kSub: step<BITS, VEC, kSub>(P, ins, vi, c, slots); break;
          case kMul: step<BITS, VEC, kMul>(P, ins, vi, c, slots); break;
          case kMulAdd:
            step<BITS, VEC, kMulAdd>(P, ins, vi, c, slots);
            break;
          case kShoup: step<BITS, VEC, kShoup>(P, ins, vi, c, slots); break;
          case kShoupLazy:
            step<BITS, VEC, kShoupLazy>(P, ins, vi, c, slots);
            break;
          case kMulAddShoup:
            step<BITS, VEC, kMulAddShoup>(P, ins, vi, c, slots);
            break;
          case kComputeShoup:
            step<BITS, VEC, kComputeShoup>(P, ins, vi, c, slots);
            break;
          case kReduce:
            step<BITS, VEC, kReduce>(P, ins, vi, c, slots);
            break;
          default: step<BITS, VEC, kLoad>(P, ins, vi, c, slots); break;
        }
      }
    } else {
      T s[arity(OP)][VEC];
      for (int a = 0; a < arity(OP); ++a) load_leaf<BITS, VEC>(P, a, vi, s[a]);
      T r[VEC];
      for (int k = 0; k < VEC; ++k) {
        T x[4] = {};
        for (int a = 0; a < arity(OP); ++a) x[a] = s[a][k];
        if constexpr (BITS == 64)
          r[k] = eval64<OP>(x, c);
        else
          r[k] = eval32<BITS, OP>(x, c);
      }
      store_out<BITS, VEC>(P, vi, r);
    }
  }
}

using KernelFn = void (*)(Params);

template <int BITS, int VEC>
KernelFn pick(int op) {
  switch (op) {
    case kAdd: return modops_expr_kernel<BITS, VEC, kAdd>;
    case kSub: return modops_expr_kernel<BITS, VEC, kSub>;
    case kMul: return modops_expr_kernel<BITS, VEC, kMul>;
    case kMulAdd: return modops_expr_kernel<BITS, VEC, kMulAdd>;
    case kShoup: return modops_expr_kernel<BITS, VEC, kShoup>;
    case kShoupLazy: return modops_expr_kernel<BITS, VEC, kShoupLazy>;
    case kMulAddShoup: return modops_expr_kernel<BITS, VEC, kMulAddShoup>;
    case kComputeShoup:
      return modops_expr_kernel<BITS, VEC, kComputeShoup>;
    case kReduce: return modops_expr_kernel<BITS, VEC, kReduce>;
    default: return modops_expr_kernel<BITS, VEC, kTree>;
  }
}

// the opcode of a one-node program over its leaves in order, else kTree
template <class Prog>
int named_op(const Prog* prog) {
  const unsigned char* ins = prog->code;
  const int op = ins[0];
  if (prog->ninstr != 1 || prog->nslots != 0 || op >= kLoad
      || ins[1] != kOut || prog->nleaves != arity(op))
    return kTree;
  for (int a = 0; a < arity(op); ++a)
    if (ins[2 + a] != kLeaf + a) return kTree;
  return op;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
// elements of [..., m, slab] at the limb width; consts: [m, 4] u64 words;
// device: the current device (the launch runs there, on `stream`).  The
// instance follows from the inputs: 16-byte vector lanes where every
// pointer, the slab, the total and every leaf's element count allow them,
// else one word a step; a one-node program over its leaves in order
// compiled, any other the interpreter.  Writes the instance launched to
// *instance: its words a vector (VEC: 1, or 8, 4, 2 for u16, u32, u64),
// plus 16 for a compiled one-node program.  Returns the cudaError_t of
// the launch (0 on success), or cudaErrorInvalidValue for a program or
// shape out of range.
extern "C" int nfl_modops_expr(int bits, const NflExprProgram* prog,
                               void* out, const void* consts,
                               long long total, long long slab, int m,
                               int device, int* instance,
                               void* stream) {
  if (prog->ninstr < 1 || prog->ninstr > kMaxInstr || prog->nslots < 0
      || prog->nslots > kMaxSlots || prog->nleaves < 1
      || prog->nleaves > kMaxLeaves || total < 1 || total >= (1ll << 31)
      || slab < 1 || m < 1 || total % (slab * m) != 0
      || (bits != 16 && bits != 32 && bits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = 16 / (bits / 8);
  bool fit = total % lanes == 0 && slab % lanes == 0 && aligned16(out);
  for (int j = 0; j < prog->nleaves; ++j) {
    const long long numel = prog->leaf_numel[j];
    const int bytes = prog->leaf_bytes[j];
    if (numel < 1 || numel > total || total % numel != 0
        || (bytes != bits / 8 && (bits == 64 || bytes != 8)))
      return static_cast<int>(cudaErrorInvalidValue);
    fit = fit && numel % lanes == 0 && aligned16(prog->leaf[j]);
  }
  const int vec = fit ? lanes : 1;
  const int op = named_op(prog);

  Params P;
  for (int k = 0; k < kMaxInstr; ++k) {
    unsigned long long w = 0;
    for (int b = 0; b < 6 && k < prog->ninstr; ++b)
      w |= static_cast<unsigned long long>(prog->code[6 * k + b]) << (8 * b);
    P.code[k] = w;
  }
  P.ninstr = prog->ninstr;
  for (int j = 0; j < kMaxLeaves; ++j) {
    const bool used = j < prog->nleaves;
    P.leaf[j] = used ? prog->leaf[j] : nullptr;
    P.leaf_div[j] = make_div(
        used ? static_cast<uint32_t>(prog->leaf_numel[j] / vec) : 1);
    P.leaf_bytes[j] = used ? prog->leaf_bytes[j] : 8;
  }
  P.slab = make_div(static_cast<uint32_t>(slab / vec));
  P.m = make_div(static_cast<uint32_t>(m));
  P.consts = static_cast<const unsigned long long*>(consts);
  P.out = out;
  P.nvec = static_cast<uint32_t>(total / vec);

  int sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (P.nvec + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const int grid = static_cast<int>(want < cap ? want : cap);
  const size_t smem = op == kTree ? static_cast<size_t>(prog->nslots)
                                        * kThreads * (bits / 8) * vec
                                  : 0;
  KernelFn fn = bits == 16   ? (vec > 1 ? pick<16, 8>(op) : pick<16, 1>(op))
                : bits == 32 ? (vec > 1 ? pick<32, 4>(op) : pick<32, 1>(op))
                             : (vec > 1 ? pick<64, 2>(op) : pick<64, 1>(op));
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fn<<<grid, kThreads, smem, s>>>(P);
  *instance = vec + (op == kTree ? 0 : 16);
  return static_cast<int>(cudaGetLastError());
}
