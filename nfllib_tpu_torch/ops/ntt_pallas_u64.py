"""The Harvey butterfly NTT and the LWE chains, u64 limb (K7, K8).

PyTorch port of nfllib_tpu/ops/ntt_pallas_u64.py: the same surface as
ops/ntt_pallas.py for the 62-bit tier.  The TPU kernels compute in paired
u32 words (`p_add` ... `p_newton_mulmod`), a TPU workaround; here the
kernels (csrc/ntt_butterfly.cu, csrc/lwe_chain.cu) use native uint64_t
words and __umul64hi, and the plain twins compute in int64 read as
unsigned (ops/modops.py: mulhi64, the Newton-quotient mulmod with pn_col).
Above n = 2^14 a u64 polynomial does not fit one block's shared memory:
at 2^15 a transform is one launch of two-block clusters, each block
holding one half and the cross-half stage going through distributed shared
memory (`_kernels.ntt_path`); at 2^16, and in the encrypt chain above
2^14, the kernels run the leading forward stages (and the trailing inverse
stages) through device memory, one launch a stage.
"""
from __future__ import annotations

from .. import _kernels
from . import ntt_pallas
from .ntt_pallas import (intt_bwd_plain, lwe_decrypt_plain,  # noqa: F401
                         lwe_encrypt_plain, ntt_fwd_plain)


def supports(ring) -> bool:
    """Degrees 256..65536, as the JAX package's kernel."""
    return ring.limb == "u64" and 256 <= ring.degree <= 65536


def ntt_fwd(x, ctx, *, inverse_tables=False, twist=True, strict=True):
    """Forward Harvey NTT of u64 [..., m, n] residues (K7); the flags as in
    ops/ntt_pallas.py:ntt_fwd."""
    return ntt_pallas._run_ntt(x, ctx, _kernels.NTT_BUTTERFLY64_FWD, False,
                               inverse_tables, twist, strict)


def intt_bwd(x, ctx, *, untwist=True, strict=True):
    """Inverse transform of u64 residues by stage inversion (K7)."""
    return ntt_pallas._run_ntt(x, ctx, _kernels.NTT_BUTTERFLY64_INV, True,
                               True, untwist, strict)


def lwe_encrypt_fused(u, e1, e2, pka, pkb, ctx):
    """The u64 LWE encrypt chain in one kernel (K8); the contract of
    ops/ntt_pallas.py:lwe_encrypt_fused."""
    return ntt_pallas._run_encrypt(u, e1, e2, pka, pkb, ctx,
                                   _kernels.LWE64_ENCRYPT)


def lwe_decrypt_fused(resa, resb, s, sprime, ctx):
    """The u64 LWE decrypt head in one kernel (K8)."""
    return ntt_pallas._run_decrypt(resa, resb, s, sprime, ctx,
                                   _kernels.LWE64_DECRYPT)
