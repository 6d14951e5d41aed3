"""Negacyclic NTT / inverse NTT on residue tensors.

PyTorch port of nfllib_tpu/ops/ntt.py: the plain Harvey butterfly path
(reference include/nfl/core.hpp:438-614, include/nfl/algos.hpp:16-73) and
the dispatch to the kernel modules, steered by the NFL_TORCH_NTT mode
(`kernel_mode`), the counterpart of NFL_TPU_NTT:

  NFL_TORCH_NTT   NFL_TPU_NTT   ntt_pow_phi / invntt_pow_invphi   ntt / inv_ntt
  auto            auto          four-step route: two mod-matmul   butterfly
                                launches (K9 for u16/u32, K5      kernels (K3,
                                for u64; K1/K2, K4 in JAX)        K7) on CUDA
  plain           jnp           plain torch ops                   plain
  butterfly       pallas        butterfly kernels (K3, K7)        butterfly
  fused           mxu           fused kernels, else butterfly     butterfly

`auto` resolves by the tensor's device: a CUDA tensor takes what the JAX
package's auto takes on its accelerator; a CPU tensor keeps ntt / inv_ntt
on the plain path (ntt_pow_phi still takes the route's twin).  A
kernel module runs its hand-written CUDA kernel for a CUDA tensor and its
plain torch twin for a CPU tensor, so `butterfly` and `fused` on the CPU
run the twins; `plain` on a CUDA tensor runs plain torch ops on the card.
Fused modules: ops/ntt_mxu.py (u16/u32, degree >= 8) and
ops/ntt_mxu_u64.py (u64, 8..2^20); butterfly modules: ops/ntt_pallas.py
(u16/u32, degree >= 256) and ops/ntt_pallas_u64.py (u64, 256..65536).
Every other ring takes the plain Harvey path on the tensor's own device;
for u64 it computes in int64 read as unsigned (ops/modops.py).

Shapes: data is [..., m, n] in the limb's storage dtype; outputs of
`ntt_pow_phi` are bit-identical to the reference's (canonical residues,
Harvey bit-reversed ordering).
"""
from __future__ import annotations

import os

import torch

from .. import debug
from ..ring import RingContext
from ..utils import static_log2
from . import modops, ntt_mxu, ntt_mxu_u64


MODES = ("auto", "plain", "butterfly", "fused")


def kernel_mode() -> str:
    """The NFL_TORCH_NTT mode, read at call time; the one reader of it."""
    mode = os.environ.get("NFL_TORCH_NTT", "auto")
    if mode not in MODES:
        raise ValueError(f"NFL_TORCH_NTT={mode!r}: expected one of {MODES}")
    return mode


def _fused_module(ring):
    """The fused four-step module for `ring`, or None; the counterpart of
    nfllib_tpu/ops/ntt.py:_fused_mxu_module (`plain` and `butterfly` turn
    it off)."""
    if kernel_mode() in ("plain", "butterfly"):
        return None
    mod = ntt_mxu_u64 if ring.limb == "u64" else ntt_mxu
    return mod if mod.supports_fused(ring) else None


def _butterfly_module(ring, x):
    """The butterfly module (ntt_pallas, ntt_pallas_u64) for `ring` and the
    tensor `x`, or None; the counterpart of
    nfllib_tpu/ops/ntt.py:_pallas_backend, with `auto` resolved by x's
    device."""
    mode = kernel_mode()
    if mode == "plain":
        return None
    from . import ntt_pallas, ntt_pallas_u64
    mod = ntt_pallas_u64 if ring.limb == "u64" else ntt_pallas
    if not mod.supports(ring):
        return None
    if mode in ("butterfly", "fused"):
        return mod
    return mod if x.is_cuda else None


def _strict_bracket(fn, x, ctx):
    """Strict-mod boundary checks around a fused-kernel call: the kernels
    poison a block that breaks a stage contract, and this wrapper asserts
    the canonical [0, p) contract on the way in and out, so a poisoned
    block, or a caller handing lazy values to a strict interface, raises
    like the plain path's per-op asserts."""
    p = ctx.to(x.device).p_col
    debug.check_residues(x, p)
    out = fn(x)
    debug.check_residues(out, p)
    return out


def _wrap(v, bits):
    return v if bits == 64 else v & ((1 << bits) - 1)


def _shoup_lazy(x, w, ws, p, bits):
    """x*w mod p by Shoup on widened values, lazy [0, 2p), wrapping in the
    word."""
    return _wrap(x * w - modops.mulhi(x, ws, bits) * p, bits)


def _stages(x, w, ws, p_col, bits, inverse=False):
    """All Harvey stages on widened int64 [..., m, n] values with blocked
    tables w/ws [m, n-1]; every sum and product wraps in the limb's word
    (u64 words wrap in int64 and compare unsigned).

    Forward DIF stage s (in: < p or lazy, out: [0, 2p)) splits each
    length-(n>>s) segment in half:
      t0 = u0 + u1            (lazy mod 2p)
      t1 = u0 - u1 + 2p       (< 4p)
      x1 = t1*w - hi(t1*w')*p (Harvey lazy Shoup, < 2p)
    inverse=True undoes the forward stages last to first with the omega^-1
    tables, no bit reversal: v = B*w - hi(B*w')*p, (A, B) -> (A + v,
    A - v + 2p), each lazy mod 2p; the result is n times the inverse
    transform (the butterfly kernels' stage inversion, csrc/ntt_butterfly.cuh).
    """
    batch = x.shape[:-2]
    m, n = x.shape[-2], x.shape[-1]
    p = p_col[:, None, :]
    two_p = 2 * p
    log_n = static_log2(n)
    for s in (reversed(range(log_n)) if inverse else range(log_n)):
        half = n >> (s + 1)
        off = n - (n >> s)
        wt = w[:, None, off:off + half]
        wi = ws[:, None, off:off + half]
        v = x.reshape(batch + (m, 1 << s, 2 * half))
        u0, u1 = v[..., :half], v[..., half:]
        if inverse:
            t = _shoup_lazy(u1, wt, wi, p, bits)
            a = modops._sub_if_ge(_wrap(u0 + t, bits), two_p, bits)
            b = modops._sub_if_ge(_wrap(u0 - t + two_p, bits), two_p, bits)
        else:
            a = modops._sub_if_ge(_wrap(u0 + u1, bits), two_p, bits)
            b = _shoup_lazy(_wrap(u0 - u1 + two_p, bits), wt, wi, p, bits)
        x = torch.cat([a, b], dim=-1).reshape(batch + (m, n))
    return x


def ntt(x, ctx: RingContext, *, inverse_tables: bool = False):
    """One forward Harvey NTT pass over [..., m, n] (no phi twist, no
    permutation), with the reference's final strict reduction to [0, p)
    (NTT_STRICTMOD is always on: reference debug.hpp:31, core.hpp:523-529)."""
    ring = ctx.ring
    if ring.degree == 1:
        return x
    mod = _butterfly_module(ring, x)
    if mod is not None:
        return mod.ntt_fwd(x, ctx, inverse_tables=inverse_tables, twist=False)
    bits = modops.limb_bits(x.dtype)
    tabs = ctx.to(x.device)
    p_col = tabs.p_col
    two_p = 2 * p_col
    xw = modops.widen(x, bits)
    if ring.degree == 2:
        # special case (reference core.hpp:472-483)
        u0, u1 = xw[..., :1], xw[..., 1:]
        t0 = modops._sub_if_ge(u0 + u1, two_p, bits)
        t1 = modops._sub_if_ge(u0 - u1 + two_p, two_p, bits)
        out = torch.cat([t0, t1], dim=-1)
    else:
        wt, wi = ((tabs.invomegas, tabs.shoupinvomegas) if inverse_tables
                  else (tabs.omegas, tabs.shoupomegas))
        out = _stages(xw, wt, wi, p_col, bits)
    return modops.narrow(modops._sub_if_ge(out, p_col, bits), x.dtype)


def inv_ntt(x, ctx: RingContext):
    """Bit-reverse -> forward pass with inverse twiddles -> bit-reverse
    (reference core.hpp:539-557).  No n^-1 scaling.  The butterfly kernels
    compute the same unique values by stage inversion, with no
    permutations."""
    mod = _butterfly_module(ctx.ring, x)
    if mod is not None:
        return mod.intt_bwd(x, ctx, untwist=False)
    rev = ctx.to(x.device).bitrev
    y = torch.index_select(x, -1, rev)
    y = ntt(y, ctx, inverse_tables=True)
    return torch.index_select(y, -1, rev)


def ntt_pow_phi(x, ctx: RingContext):
    """Negacyclic forward transform: fused shoup(x * phi^i) pre-twist then NTT
    (reference core.hpp:594-600)."""
    fused = _fused_module(ctx.ring)
    if fused is not None:
        if debug.strictmod_enabled():
            return _strict_bracket(
                lambda v: fused.ntt_pow_phi_fused(v, ctx), x, ctx)
        return fused.ntt_pow_phi_fused(x, ctx)
    mod = _butterfly_module(ctx.ring, x)
    if mod is not None:
        if debug.strictmod_enabled():
            return _strict_bracket(
                lambda v: mod.ntt_fwd(v, ctx, twist=True), x, ctx)
        return mod.ntt_fwd(x, ctx, twist=True)
    tabs = ctx.to(x.device)
    tw = modops.mulmod_shoup(x, tabs.phis, tabs.shoupphis, tabs.p_col)
    return ntt(tw, ctx)


def invntt_pow_invphi(x, ctx: RingContext):
    """Inverse transform with fused n^-1 * phi^-i un-twist
    (reference core.hpp:608-614)."""
    fused = _fused_module(ctx.ring)
    if fused is not None:
        if debug.strictmod_enabled():
            return _strict_bracket(
                lambda v: fused.invntt_pow_invphi_fused(v, ctx), x, ctx)
        return fused.invntt_pow_invphi_fused(x, ctx)
    mod = _butterfly_module(ctx.ring, x)
    if mod is not None:
        if debug.strictmod_enabled():
            return _strict_bracket(
                lambda v: mod.intt_bwd(v, ctx, untwist=True), x, ctx)
        return mod.intt_bwd(x, ctx, untwist=True)
    tabs = ctx.to(x.device)
    y = inv_ntt(x, ctx)
    return modops.mulmod_shoup(y, tabs.invpoly_times_invphis,
                               tabs.shoupinvpoly_times_invphis, tabs.p_col)
