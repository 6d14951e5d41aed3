// LWE encrypt and decrypt chains, u16/u32 and u64 limbs.
//
// Replaces the TPU kernels nfllib_tpu/ops/ntt_pallas.py:_lwe_encrypt_kernel
// and _lwe_decrypt_kernel (K6, u16/u32) and
// nfllib_tpu/ops/ntt_pallas_u64.py:_lwe_encrypt_kernel and
// _lwe_decrypt_kernel (K8, u64), the chains of the reference demo
// (tests/nfllib_demo_main_op.cpp:26-58):
//   encrypt  un, e1n, e2n = the twisted NTTs of u, e1, e2 (strict);
//            resa = e1n + un*pka mod p;  resb = e2n + un*pkb mod p
//   decrypt  t = resb - resa*s mod p (Shoup with s' = compute_shoup(s));
//            out = strict(untwist(stage-inversion INTT of t))
// Outputs are bit-identical to the JAX package's chains and to the plain
// twins (nfllib_tpu_torch/ops/ntt_pallas.py:lwe_encrypt_plain /
// lwe_decrypt_plain).  The pointwise products are exact: u16/u32 by K9's
// small-p part reduction with floor(2^64/p) (ButterflyTables.bm), u64 by
// the reference's Newton quotient; no division or remainder on the device.
//
// Design: the radix-16 register rounds of ntt_butterfly.cuh with a
// prologue and an epilogue.  Encrypt is one launch a chunk of polynomials
// (bfly_encrypt): one block per (polynomial, channel) transforms u and
// stores it strict into the thread's own words of resb, transforms e1 and
// stores resa = e1n + un*pka, then e2 and stores resb = e2n + un*pkb, with
// shared memory reused by each transform; a thread owns the same output
// words in all three and reads its words of un back from L2 (the block's
// 64-128 KB of it written and read within the block's life, so L2
// serves the reads).  Decrypt forms
// resb - resa*s as its first round loads, so the chain reads each input
// once.  u64 above n = 2^14 encrypts by running each input's leading
// stages through device memory first (ntt_butterfly.cuh, bfly_global), u
// into resb, e1 into resa and e2 into a scratch tensor, then the same
// one-pass block on each 2^14 segment; its decrypt at 2^15 is one launch of
// the transform's two-block clusters (bfly_pair), at 2^16 the passes.
//
// Bound on this card: three forward transforms (encrypt) or one inverse
// (decrypt) of K3/K7's count per channel, plus two (one) pointwise
// products, in integer instructions; device memory sees the inputs once,
// the outputs once and the twist tables; the twiddle pairs come through L2.

#include "ntt_butterfly.cuh"

namespace {

template <class W>
cudaError_t launch_encrypt(const nflbf::EncArgs& a, const nflbf::Tables<W>& t,
                           int batch, int m, int log_n, int s_lo,
                           cudaStream_t st) {
  using T = typename W::T;
  return nflbf::by_log_len<W>(log_n - s_lo, [&](auto L) {
    constexpr int kLog = decltype(L)::value;
    return nflbf::launch_segments(
        nflbf::bfly_encrypt<W, kLog>,
        nflbf::block_threads(kLog), sizeof(T) << kLog, s_lo, m, batch, st, a,
        t, m, log_n, s_lo);
  });
}

template <class W>
cudaError_t encrypt(const void* u, const void* e1, const void* e2,
                    const void* pka, const void* pkb, void* resa, void* resb,
                    void* scratch, const nflbf::Tables<W>& t, int batch,
                    int m, int log_n, cudaStream_t st) {
  using S = typename W::S;
  const int g = nflbf::global_stages<W>(log_n);
  nflbf::EncArgs a{u, e1, e2, pka, pkb, resa, resb, g == 0};
  if (g > 0) {
    // the leading stages of u, e1, e2 (twisted as the first one loads)
    // into resb, resa and scratch, which the segment blocks read back
    const void* srcs[3] = {u, e1, e2};
    void* stages[3] = {resb, resa, scratch};
    for (int i = 0; i < 3; ++i) {
      const S* cur = static_cast<const S*>(srcs[i]);
      for (int s = 0; s < g; ++s) {
        cudaError_t err = nflbf::launch_global<W, false>(
            cur, static_cast<S*>(stages[i]), t, batch, m, log_n, s, s == 0,
            false, false, st);
        if (err != cudaSuccess) return err;
        cur = static_cast<const S*>(stages[i]);
      }
    }
    a.u = resb;
    a.e1 = resa;
    a.e2 = scratch;
  }
  return launch_encrypt<W>(a, t, batch, m, log_n, g, st);
}

template <class W>
cudaError_t decrypt(const void* resa, const void* resb, const void* s,
                    const void* sprime, void* out,
                    const nflbf::Tables<W>& t, int batch, int m, int log_n,
                    cudaStream_t st) {
  nflbf::NttArgs a{};
  a.src = resa;
  a.src2 = resb;
  a.dst = out;
  a.op0 = s;
  a.op1 = sprime;
  return nflbf::inverse<W, nflbf::kDecrypt>(a, true, true, t, batch, m, log_n,
                                            st);
}

}  // namespace

// Plain C entry points for ctypes.  limb: 16, 32 or 64.  u/e1/e2 and
// resa/resb/out: [batch, m, 2^log_n] residues in the limb's word;
// pka/pkb/s/sprime: [m, n]; scratch: [batch, m, n], used only by u64 above
// n = 2^14 (may be null otherwise); wp: [m, n-1, 2] (w, w') pairs of the
// blocked twiddles (omega for encrypt, omega^-1 for decrypt); twp: [m, n,
// 2] pairs of phi^i (encrypt) or n^-1 phi^-i (decrypt) and their
// companions; p: [m] moduli; red: [m] floor(2^64/p) (u16/u32) or the
// Newton quotients pn (u64).  Return the cudaError_t of
// the launches (0 on success).
extern "C" int nfl_lwe_encrypt(int limb, const void* u, const void* e1,
                               const void* e2, const void* pka,
                               const void* pkb, void* resa, void* resb,
                               void* scratch, const void* wp,
                               const void* twp, const void* p,
                               const void* red, int batch, int m, int log_n,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (limb) {
    case 16:
      return static_cast<int>(encrypt<nflbf::U16>(
          u, e1, e2, pka, pkb, resa, resb, scratch,
          nflbf::make_tables<nflbf::U16>(wp, twp, p, red),
          batch, m, log_n, st));
    case 32:
      return static_cast<int>(encrypt<nflbf::U32>(
          u, e1, e2, pka, pkb, resa, resb, scratch,
          nflbf::make_tables<nflbf::U32>(wp, twp, p, red),
          batch, m, log_n, st));
    case 64:
      return static_cast<int>(encrypt<nflbf::U64>(
          u, e1, e2, pka, pkb, resa, resb, scratch,
          nflbf::make_tables<nflbf::U64>(wp, twp, p, red),
          batch, m, log_n, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int nfl_lwe_decrypt(int limb, const void* resa, const void* resb,
                               const void* s, const void* sprime, void* out,
                               const void* wp, const void* twp, const void* p,
                               int batch, int m, int log_n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (limb) {
    case 16:
      return static_cast<int>(decrypt<nflbf::U16>(
          resa, resb, s, sprime, out,
          nflbf::make_tables<nflbf::U16>(wp, twp, p, nullptr),
          batch, m, log_n, st));
    case 32:
      return static_cast<int>(decrypt<nflbf::U32>(
          resa, resb, s, sprime, out,
          nflbf::make_tables<nflbf::U32>(wp, twp, p, nullptr),
          batch, m, log_n, st));
    case 64:
      return static_cast<int>(decrypt<nflbf::U64>(
          resa, resb, s, sprime, out,
          nflbf::make_tables<nflbf::U64>(wp, twp, p, nullptr),
          batch, m, log_n, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
