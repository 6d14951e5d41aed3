"""The Harvey butterfly NTT and the LWE chains, u16/u32 limbs (K3, K6).

PyTorch port of nfllib_tpu/ops/ntt_pallas.py.  Its two TPU kernels become
hand-written CUDA (nfllib_tpu_torch/csrc/ntt_butterfly.cu and
csrc/lwe_chain.cu, with the stage loop in csrc/ntt_butterfly.cuh):
  * `ntt_fwd` / `intt_bwd`: all log2(n) lazy-Shoup stages in one kernel,
    with the fused phi^i twist, the fused n^-1 phi^-i untwist and the final
    strict reduction; the inverse undoes the forward stages last to first,
    with no bit reversal, which yields the unique canonical INTT (the
    accumulated 2^log2(n) = n cancels against the n^-1 of the untwist
    table);
  * `lwe_encrypt_fused` / `lwe_decrypt_fused`: the LWE demo's encrypt chain
    (three twisted NTTs and two muladds) and decrypt head (resb - resa*s,
    the inverse NTT and the untwist).
Each launches its kernel for a tensor on a CUDA device and runs its plain
torch twin (`*_plain`, the same arithmetic on int64) for a tensor on the
CPU.  The TPU kernel's [R, 128] lane view, its roll-and-select lane
stages and its VMEM channel grouping are TPU workarounds and are not
ported; kernel and twin read the blocked tables of RingContext (the
kernels as (w, w') pairs, and the chains' exact products with the Barrett
constant floor(2^64/p), `ButterflyTables`).  The kernels run the stages in
radix-16 rounds of registers (csrc/ntt_butterfly.cuh); the encrypt chain
is one launch a chunk of polynomials.

The twins here are shared with the u64 tier (ops/ntt_pallas_u64.py); their
stage loop is the plain path's (ops/ntt.py:_stages), written once for
every limb width, wrapping in the word (u16/u32 values widened to int64
and masked, u64 in int64 read as unsigned, ops/modops.py).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _kernels
from ..ring import canonical_device
from ..utils import static_log2
from . import modops
from .ntt import _shoup_lazy, _stages
from .ntt_mxu import _as_batch

# log2 of the longest segment one CUDA block holds in shared memory
# (csrc/ntt_butterfly.cuh kLocalLog): 2^15 u32 words, 2^14 u64 words (u16
# degrees stop at 2^9)
_LOCAL_LOG = {"u16": 9, "u32": 15, "u64": 14}


def supports(ring) -> bool:
    return ring.limb in ("u16", "u32") and ring.degree >= 256


# ---------------------------------------------------------------------------
# kernel tables: RingContext's tables in the storage dtype, on the device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ButterflyTables:
    """The tables the butterfly and LWE kernels read, in the ring's storage
    dtype on `device`: the blocked twiddles of omega (wp) and omega^-1 (iwp)
    as (w, w') pairs [m, n-1, 2] (the blocked layout is stage-major, stage
    s at n - (n >> s)), the twist phi^i (twp) and untwist n^-1 phi^-i
    (itwp) as pairs [m, n, 2], so that a kernel loads a twiddle and its
    Shoup companion at once; the moduli p and Newton quotients pn [m]; bm
    [m] int64, floor(2^64/p) as a uint64 bit pattern, the Barrett constant
    of the u16/u32 chains' exact products (K9's small-p part reduction)."""
    limb: str
    bits: int
    m: int
    n: int
    log_n: int
    global_stages: int       # stages run through device memory (u64 > 2^14)
    device: torch.device
    wp: torch.Tensor
    iwp: torch.Tensor
    twp: torch.Tensor
    itwp: torch.Tensor
    p: torch.Tensor
    pn: torch.Tensor
    bm: torch.Tensor


def pair_table(w, ws):
    """[..., k] twiddles and companions -> [..., k, 2] (w, w') pairs"""
    return np.ascontiguousarray(np.stack([w, ws], axis=-1))


def barrett_constants(p):
    """floor(2^64 / p) of each modulus as uint64 words"""
    return np.array([(1 << 64) // int(q) for q in p],
                    dtype=np.uint64).reshape(np.shape(p))


@functools.lru_cache(maxsize=None)
def _device_tables(ring, device: torch.device) -> ButterflyTables:
    ctx = ring.context()
    signed = ring.limb_params.signed_dtype

    def put(a):
        return torch.from_numpy(a.view(signed).copy()).to(device)
    log_n = static_log2(ring.degree)
    return ButterflyTables(
        limb=ring.limb, bits=ring.repr_bits, m=ring.nmoduli, n=ring.degree,
        log_n=log_n, global_stages=max(0, log_n - _LOCAL_LOG[ring.limb]),
        device=device, wp=put(pair_table(ctx.omegas, ctx.shoupomegas)),
        iwp=put(pair_table(ctx.invomegas, ctx.shoupinvomegas)),
        twp=put(pair_table(ctx.phis, ctx.shoupphis)),
        itwp=put(pair_table(ctx.invpoly_times_invphis,
                            ctx.shoupinvpoly_times_invphis)),
        p=put(ctx.p), pn=put(ctx.pn),
        bm=torch.from_numpy(barrett_constants(ctx.p).view(np.int64)).to(
            device))


def kernel_tables(ring, device) -> ButterflyTables:
    """The butterfly kernels' tables for `ring`, cached per device."""
    return _device_tables(ring, canonical_device(device))


# ---------------------------------------------------------------------------
# plain torch twins: the kernels' arithmetic on int64, every limb width
# ---------------------------------------------------------------------------

def _ntt_plain(x, ctx, stage_inverse, tables_inverse, twist, strict):
    """The butterfly kernel's computation on [..., m, n] storage residues."""
    bits = modops.limb_bits(x.dtype)
    tabs = ctx.to(x.device)
    p = tabs.p_col
    v = modops.widen(x, bits)
    if stage_inverse or tables_inverse:
        w, ws = tabs.invomegas, tabs.shoupinvomegas
    else:
        w, ws = tabs.omegas, tabs.shoupomegas
    if not stage_inverse:
        if twist:
            v = modops._sub_if_ge(
                _shoup_lazy(v, tabs.phis, tabs.shoupphis, p, bits), p, bits)
        v = _stages(v, w, ws, p, bits)
    else:
        v = _stages(v, w, ws, p, bits, inverse=True)
        if twist:
            v = _shoup_lazy(v, tabs.invpoly_times_invphis,
                            tabs.shoupinvpoly_times_invphis, p, bits)
    if strict:
        v = modops._sub_if_ge(v, p, bits)
    return modops.narrow(v, x.dtype)


def ntt_fwd_plain(x, ctx, *, inverse_tables=False, twist=True, strict=True):
    """Plain torch twin of the forward butterfly kernel, on any device."""
    return _ntt_plain(x, ctx, False, inverse_tables, twist, strict)


def intt_bwd_plain(x, ctx, *, untwist=True, strict=True):
    """Plain torch twin of the inverse butterfly kernel, on any device."""
    return _ntt_plain(x, ctx, True, True, untwist, strict)


def lwe_encrypt_plain(u, e1, e2, pka, pkb, ctx):
    """Plain torch twin of the LWE encrypt chain kernel."""
    tabs = ctx.to(u.device)
    un, e1n, e2n = (ntt_fwd_plain(v, ctx) for v in (u, e1, e2))
    resa = modops.muladd(e1n, un, pka, tabs.p_col, tabs.pn_col)
    resb = modops.muladd(e2n, un, pkb, tabs.p_col, tabs.pn_col)
    return resa, resb


def lwe_decrypt_plain(resa, resb, s, sprime, ctx):
    """Plain torch twin of the LWE decrypt chain kernel."""
    p = ctx.to(resa.device).p_col
    t = modops.submod(resb, modops.mulmod_shoup(resa, s, sprime, p), p)
    return intt_bwd_plain(t, ctx)


# ---------------------------------------------------------------------------
# dispatch: the kernel for a CUDA tensor, the twin for a CPU tensor
# ---------------------------------------------------------------------------

def _batch(x, ring):
    return _as_batch(x, ring).contiguous()


def _on_cuda(x, what):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for tensors on {x.device}")
    return True


def _run_ntt(x, ctx, kernel, inverse, inverse_tables, twist, strict):
    if not _on_cuda(x, "butterfly NTT"):
        return _ntt_plain(x, ctx, inverse, inverse or inverse_tables, twist,
                          strict)
    ring = ctx.ring
    out = kernel(_batch(x, ring), kernel_tables(ring, x.device), twist=twist,
                 strict=strict, inverse_tables=inverse_tables)
    return out.reshape(x.shape)


def _run_encrypt(u, e1, e2, pka, pkb, ctx, kernel):
    if not _on_cuda(u, "LWE encrypt"):
        return lwe_encrypt_plain(u, e1, e2, pka, pkb, ctx)
    ring = ctx.ring
    resa, resb = kernel(*(_batch(v, ring) for v in (u, e1, e2)),
                        pka.contiguous(), pkb.contiguous(),
                        kernel_tables(ring, u.device))
    return resa.reshape(u.shape), resb.reshape(u.shape)


def _run_decrypt(resa, resb, s, sprime, ctx, kernel):
    if not _on_cuda(resa, "LWE decrypt"):
        return lwe_decrypt_plain(resa, resb, s, sprime, ctx)
    ring = ctx.ring
    out = kernel(_batch(resa, ring), _batch(resb, ring), s.contiguous(),
                 sprime.contiguous(), kernel_tables(ring, resa.device))
    return out.reshape(resa.shape)


def ntt_fwd(x, ctx, *, inverse_tables=False, twist=True, strict=True):
    """Forward Harvey NTT of [..., m, n] residues (K3).  twist=True fuses
    the phi^i pre-twist (the whole ntt_pow_phi); inverse_tables runs the
    pass with the omega^-1 tables (the plain inv_ntt's building block);
    strict=False leaves the last stage's lazy [0, 2p) values."""
    return _run_ntt(x, ctx, _kernels.NTT_BUTTERFLY_FWD, False,
                    inverse_tables, twist, strict)


def intt_bwd(x, ctx, *, untwist=True, strict=True):
    """Inverse negacyclic transform of [..., m, n] Harvey-ordered residues
    by stage inversion (K3); untwist=True applies the fused n^-1 phi^-i
    (the whole invntt_pow_invphi), untwist=False gives the reference's
    unscaled inv_ntt."""
    return _run_ntt(x, ctx, _kernels.NTT_BUTTERFLY_INV, True, True, untwist,
                    strict)


def lwe_encrypt_fused(u, e1, e2, pka, pkb, ctx):
    """The LWE encrypt chain (reference demo encrypt, lines 26-45) in one
    kernel (K6): u/e1/e2 [..., m, n] coefficient-domain noise, pka/pkb
    [m, n] NTT-domain public key -> (resa, resb), bit-identical to the
    plain graph of apps/lwe.py."""
    return _run_encrypt(u, e1, e2, pka, pkb, ctx, _kernels.LWE_ENCRYPT)


def lwe_decrypt_fused(resa, resb, s, sprime, ctx):
    """The LWE decrypt head (reference demo decrypt, lines 48-58) in one
    kernel (K6): resb - resa*s (Shoup), the inverse NTT and the untwist ->
    the coefficient-domain [..., m, n] message plus noise."""
    return _run_decrypt(resa, resb, s, sprime, ctx, _kernels.LWE_DECRYPT)
