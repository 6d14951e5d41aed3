// Harvey butterfly NTT and stage-inversion INTT, u16, u32 and u64 limbs.
//
// Replaces the TPU kernels nfllib_tpu/ops/ntt_pallas.py:_ntt_kernel (K3,
// u16/u32, n >= 256) and nfllib_tpu/ops/ntt_pallas_u64.py:_ntt_kernel (K7,
// u64, n 256..65536): the forward pass with the fused phi^i pre-twist and
// the final strict reduction, the forward pass with the omega^-1 tables,
// and the inverse by stage inversion with the fused n^-1 phi^-i untwist.
// Canonical outputs are bit-identical to the JAX package; every output,
// lazy ones included, equals the plain twin
// (nfllib_tpu_torch/ops/ntt_pallas.py:_ntt_plain).  The math and the
// design (the radix-16 register rounds of ntt_butterfly.cuh, shared with
// the LWE chains) are in ntt_butterfly.cuh.
//
// What the TPU kernel's design was for, and what this one does instead:
// the Pallas kernel views a channel as an [n/128, 128] tile and runs the
// last seven stages as lane rolls and selects against full-width twiddle
// vectors, in paired u32 words for u64.  Here a thread runs up to four
// stages at a time on 16 words in registers, with native 32- and 64-bit
// multiplies, and the channel grouping for VMEM is gone: one block per
// (polynomial, channel), all blocks in flight at once.
//
// Bound on this card: log2(n) * n/2 butterflies per channel-NTT, each at
// least 7 integer instructions for u32 (IADD3 and IMNMX on the ALU pipe,
// IMAD.HI, IMUL and IMAD on the FMA pipe; 23 for u64 in 32-bit halves),
// issued at up to 128 lanes an SM a clock, 64 a pipe; device memory sees
// one read and one write of the data (two more per global stage for u64
// above n = 2^14) and the twist table; the twiddle pairs (n - 1 a channel)
// come through L2.

#include "ntt_butterfly.cuh"

namespace {

template <class W>
cudaError_t run(int inverse, int twist, int strict, const void* x, void* out,
                const nflbf::Tables<W>& t, int batch, int m, int log_n,
                cudaStream_t st) {
  using S = typename W::S;
  if (inverse) {
    nflbf::NttArgs a{};
    a.src = x;
    a.dst = out;
    return nflbf::inverse<W, nflbf::kInverse>(a, twist != 0, strict != 0, t,
                                              batch, m, log_n, st);
  }
  return nflbf::forward<W>(static_cast<const S*>(x), static_cast<S*>(out),
                           static_cast<S*>(out), twist != 0, strict != 0, t,
                           batch, m, log_n, st);
}

template <class W>
int run_limb(int inverse, int twist, int strict, const void* x, void* out,
             const void* wp, const void* twp, const void* p, int batch, int m,
             int log_n, cudaStream_t st) {
  return static_cast<int>(
      run<W>(inverse, twist, strict, x, out,
             nflbf::make_tables<W>(wp, twp, p, nullptr), batch, m, log_n, st));
}

}  // namespace

// Plain C entry point for ctypes.  limb: 16, 32 or 64.  x/out: [batch, m,
// 2^log_n] residues in the limb's word; wp: [m, n-1, 2] (w, w') pairs of
// the blocked twiddles (omega, or omega^-1 for the inverse or
// inverse_tables); twp: [m, n, 2] pairs of phi^i (forward) or n^-1 phi^-i
// (inverse) and their companions; p: [m] moduli.  inverse: stage
// inversion; twist: the pre-twist (forward) or the untwist (inverse).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int nfl_ntt_butterfly(int limb, int inverse, int twist, int strict,
                                 const void* x, void* out, const void* wp,
                                 const void* twp, const void* p, int batch,
                                 int m, int log_n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (limb) {
    case 16:
      return run_limb<nflbf::U16>(inverse, twist, strict, x, out, wp, twp,
                                      p, batch, m, log_n, st);
    case 32:
      return run_limb<nflbf::U32>(inverse, twist, strict, x, out, wp, twp,
                                      p, batch, m, log_n, st);
    case 64:
      return run_limb<nflbf::U64>(inverse, twist, strict, x, out, wp, twp,
                                      p, batch, m, log_n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
