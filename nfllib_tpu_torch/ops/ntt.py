"""Negacyclic NTT / inverse NTT on residue tensors.

PyTorch port of nfllib_tpu/ops/ntt.py: the plain Harvey butterfly path
(reference include/nfl/core.hpp:438-614, include/nfl/algos.hpp:16-73) and
the dispatch, as nfllib_tpu/ops/ntt.py:_fused_mxu_module dispatches in auto
mode on its accelerator.  Rings that ntt_mxu.supports_fused admits (u16/u32,
degree >= 8) take the fused four-step transform of ops/ntt_mxu.py; u64
rings that ntt_mxu_u64.supports_fused admits (degree 8..2^20) take
ops/ntt_mxu_u64.py.  Each runs its hand-written CUDA kernel for a tensor on
a CUDA device and its plain torch twin for a tensor on the CPU.  Every
other ring takes the plain Harvey path on the tensor's own device; for u64
it computes in int64 read as unsigned (ops/modops.py).

Shapes: data is [..., m, n] in the limb's storage dtype; outputs of
`ntt_pow_phi` are bit-identical to the reference's (canonical residues,
Harvey bit-reversed ordering).
"""
from __future__ import annotations

import torch

from .. import debug
from ..ring import RingContext
from ..utils import static_log2
from . import modops, ntt_mxu, ntt_mxu_u64


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


def _ntt_core(x, wtabs, witabs, p_col, bits):
    """All-stages Harvey DIF butterfly pass on widened int64 values;
    in: [..., m, n] < p, out: [0, 2p).

    Stage s splits each length-(n>>s) segment in half:
      t0 = u0 + u1            (lazy mod 2p)
      t1 = u0 - u1 + 2p       (< 4p, wrapping word)
      x1 = t1*w - hi(t1*w')*p (Harvey lazy Shoup, < 2p, wrapping word)
    u64 words wrap in int64 and compare unsigned (t0 and t1 may pass 2^63).
    """
    batch = x.shape[:-2]
    m, n = x.shape[-2], x.shape[-1]
    p = p_col[:, None, :]
    two_p = 2 * p
    for s in range(static_log2(n)):
        half = n >> (s + 1)
        v = x.reshape(batch + (m, 1 << s, 2 * half))
        u0 = v[..., :half]
        u1 = v[..., half:]
        t0 = modops._sub_if_ge(u0 + u1, two_p, bits)
        t1 = u0 - u1 + two_p
        q = modops.mulhi(t1, witabs[s][:, None, :], bits)
        t2 = t1 * wtabs[s][:, None, :] - q * p
        if bits != 64:
            t2 = t2 & ((1 << bits) - 1)
        x = torch.cat([t0, t2], dim=-1).reshape(batch + (m, n))
    return x


def ntt(x, ctx: RingContext, *, inverse_tables: bool = False):
    """One forward Harvey NTT pass over [..., m, n] (no phi twist, no
    permutation), with the reference's final strict reduction to [0, p)
    (NTT_STRICTMOD is always on: reference debug.hpp:31, core.hpp:523-529)."""
    ring = ctx.ring
    if ring.degree == 1:
        return x
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
        stages = [slice(off, off + length) for off, length in ctx.stage_offsets]
        out = _ntt_core(xw, [wt[:, sl] for sl in stages],
                        [wi[:, sl] for sl in stages], p_col, bits)
    return modops.narrow(modops._sub_if_ge(out, p_col, bits), x.dtype)


def inv_ntt(x, ctx: RingContext):
    """Bit-reverse -> forward pass with inverse twiddles -> bit-reverse
    (reference core.hpp:539-557).  No n^-1 scaling."""
    rev = ctx.to(x.device).bitrev
    y = torch.index_select(x, -1, rev)
    y = ntt(y, ctx, inverse_tables=True)
    return torch.index_select(y, -1, rev)


def _fused_module(ring):
    """The fused four-step module for `ring`, or None (plain Harvey path);
    the port's counterpart of nfllib_tpu/ops/ntt.py:_fused_mxu_module in
    auto mode on the accelerator."""
    mod = ntt_mxu_u64 if ring.limb == "u64" else ntt_mxu
    return mod if mod.supports_fused(ring) else None


def ntt_pow_phi(x, ctx: RingContext):
    """Negacyclic forward transform: fused shoup(x * phi^i) pre-twist then NTT
    (reference core.hpp:594-600)."""
    fused = _fused_module(ctx.ring)
    if fused is not None:
        if debug.strictmod_enabled():
            return _strict_bracket(
                lambda v: fused.ntt_pow_phi_fused(v, ctx), x, ctx)
        return fused.ntt_pow_phi_fused(x, ctx)
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
    tabs = ctx.to(x.device)
    y = inv_ntt(x, ctx)
    return modops.mulmod_shoup(y, tabs.invpoly_times_invphis,
                               tabs.shoupinvpoly_times_invphis, tabs.p_col)
