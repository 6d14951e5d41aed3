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
// lwe_decrypt_plain).  The pointwise products are exact: u16/u32 by a
// 64-bit product and `%`, u64 by the reference's Newton quotient.
//
// Design: the stage loop of ntt_butterfly.cuh with a prologue and an
// epilogue.  Encrypt holds one transform in shared memory at a time (three
// would need 3 x 128 KB for u64 at n = 2^14): the transform of u is stored
// to resb, which the e1 and e2 blocks read back elementwise in their
// epilogues; e1's block writes resa, and e2's block overwrites resb in
// place (each word read and written by one thread).  Decrypt forms
// resb - resa*s as it loads, so the chain reads each input once.  u64
// above n = 2^14 runs its leading stages through device memory as
// ntt_butterfly.cuh describes; the e2 transform then stages in a scratch
// tensor.
//
// Bound on this card: three forward transforms (encrypt) or one inverse
// (decrypt) of K3/K7's count per channel, plus two (one) pointwise
// products; device memory sees the inputs once, the outputs once and the
// staged transform of u (written once, read twice, mostly from L2).

#include "ntt_butterfly.cuh"

namespace {

template <class W>
cudaError_t encrypt(const void* u, const void* e1, const void* e2,
                    const void* pka, const void* pkb, void* resa, void* resb,
                    void* scratch, const nflbf::Tables<W>& t, int batch,
                    int m, int log_n, cudaStream_t st) {
  using S = typename W::S;
  nflbf::LocalArgs a{};
  a.dst = resb;                                  // un, staged in resb
  a.epilogue = nflbf::kStore;
  a.strict = true;
  cudaError_t err = nflbf::forward<W>(static_cast<const S*>(u),
                                      static_cast<S*>(resb), a, true, t,
                                      batch, m, log_n, st);
  if (err != cudaSuccess) return err;
  a.dst = resa;                                  // resa = e1n + un*pka
  a.epilogue = nflbf::kEncrypt;
  a.aux = resb;
  a.op0 = pka;
  err = nflbf::forward<W>(static_cast<const S*>(e1), static_cast<S*>(resa),
                          a, true, t, batch, m, log_n, st);
  if (err != cudaSuccess) return err;
  a.dst = resb;                                  // resb = e2n + un*pkb
  a.op0 = pkb;
  return nflbf::forward<W>(static_cast<const S*>(e2),
                           static_cast<S*>(scratch), a, true, t, batch, m,
                           log_n, st);
}

template <class W>
cudaError_t decrypt(const void* resa, const void* resb, const void* s,
                    const void* sprime, void* out,
                    const nflbf::Tables<W>& t, int batch, int m, int log_n,
                    cudaStream_t st) {
  nflbf::LocalArgs a{};
  a.src = resa;
  a.src2 = resb;
  a.dst = out;
  a.op0 = s;
  a.op1 = sprime;
  a.prologue = nflbf::kDecrypt;
  return nflbf::inverse<W>(a, true, true, t, batch, m, log_n, st);
}

}  // namespace

// Plain C entry points for ctypes.  limb: 16, 32 or 64.  u/e1/e2 and
// resa/resb/out: [batch, m, 2^log_n] residues in the limb's word;
// pka/pkb/s/sprime: [m, n]; scratch: [batch, m, n], used only by u64 above
// n = 2^14 (may be null otherwise); w/ws: [m, n-1] blocked twiddles and
// companions (omega for encrypt, omega^-1 for decrypt); tw/tws: [m, n]
// phi^i (encrypt) or n^-1 phi^-i (decrypt); p, pn: [m] moduli and Newton
// quotients.  Return the cudaError_t of the launches (0 on success).
extern "C" int nfl_lwe_encrypt(int limb, const void* u, const void* e1,
                               const void* e2, const void* pka,
                               const void* pkb, void* resa, void* resb,
                               void* scratch, const void* w, const void* ws,
                               const void* tw, const void* tws, const void* p,
                               const void* pn, int batch, int m, int log_n,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (limb) {
    case 16:
      return static_cast<int>(encrypt<nflbf::U16>(
          u, e1, e2, pka, pkb, resa, resb, scratch,
          nflbf::make_tables<nflbf::U16>(w, ws, tw, tws, p, nullptr), batch,
          m, log_n, st));
    case 32:
      return static_cast<int>(encrypt<nflbf::U32>(
          u, e1, e2, pka, pkb, resa, resb, scratch,
          nflbf::make_tables<nflbf::U32>(w, ws, tw, tws, p, nullptr), batch,
          m, log_n, st));
    case 64:
      return static_cast<int>(encrypt<nflbf::U64>(
          u, e1, e2, pka, pkb, resa, resb, scratch,
          nflbf::make_tables<nflbf::U64>(w, ws, tw, tws, p, pn), batch, m,
          log_n, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int nfl_lwe_decrypt(int limb, const void* resa, const void* resb,
                               const void* s, const void* sprime, void* out,
                               const void* w, const void* ws, const void* tw,
                               const void* tws, const void* p, int batch,
                               int m, int log_n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (limb) {
    case 16:
      return static_cast<int>(decrypt<nflbf::U16>(
          resa, resb, s, sprime, out,
          nflbf::make_tables<nflbf::U16>(w, ws, tw, tws, p, nullptr), batch,
          m, log_n, st));
    case 32:
      return static_cast<int>(decrypt<nflbf::U32>(
          resa, resb, s, sprime, out,
          nflbf::make_tables<nflbf::U32>(w, ws, tw, tws, p, nullptr), batch,
          m, log_n, st));
    case 64:
      return static_cast<int>(decrypt<nflbf::U64>(
          resa, resb, s, sprime, out,
          nflbf::make_tables<nflbf::U64>(w, ws, tw, tws, p, nullptr), batch,
          m, log_n, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
