"""Four-step negacyclic NTT on the square mod-matmul kernels, for every
limb tier: the route, its matrices and twiddle, and the u16/u32 entry
points (ops/ntt_mxu_u64.py holds the u64 tier's).

PyTorch port of the fused path of nfllib_tpu/ops/ntt_mxu.py (the JAX
kernels _fused_kernel K1 and _fused_inv_kernel K2) and of
nfllib_tpu/ops/ntt_mxu_u64.py (_kernel64 K4, and _large_run64, the same
transform as two mod-matmuls):

  n = n1*n2 (n1 = 2^floor(log2(n)/2)), X[i1, i2] = x[i2 + n2*i1]:
  forward:  F = E1 @ X (phi^(n2*i1) folded into E1's columns), Y = F * tw
            (Shoup, tw = omega^(rev(r)*i2) * phi^i2), O = Y @ E2,
            O[r, c] = harvey[r*n2 + c];
  inverse:  O @ E2inv, twiddle with n^-1 * phi^-i2 folded in, then
            E1inv @ (phi^-(n2*i1) folded into its rows).

`_route` runs each transform as two launches of one square mod-matmul
kernel (ops/dft_mxu.py:ntt_stage), the twiddle in the first launch's
Shoup epilogue: K9 (csrc/dft_mxu32.cu, int8 tensor cores at 4 digits) for
u16 and u32 rings, whose int16 words are widened to u32 ones at the
route's edges and narrowed after; K5 (csrc/dft_mxu64.cu, 8 digits; K10
under NFL_TORCH_DFT_PIPE) for u64 rings.  The matrices are the JAX
package's own (interop.fused_tables_from_numpy recovers them from its
digit planes), unscaled and in Harvey order.  The outputs are canonical,
and a canonical negacyclic NTT has one correct value, so they are
bit-identical to the JAX kernels'.  A CPU tensor (or plain=True) runs the
same two stages' twin (dft_mxu.matmul_plain): one algorithm on both
devices.  Strict mode poisons a (polynomial, channel) block whose input
or stage output is not below p (the stages' flags); ops/ntt.py's bracket
turns that into an AssertionError.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import debug
from ..ring import _np_mulmod_vec, _np_shoup_vec, canonical_device
from ..utils import bitrev_indices, static_log2
from . import dft_mxu


def _geometry(n):
    """(n1, n2): n = n1*n2 with n1 = 2^floor(log2(n)/2) <= n2, for every
    tier (the JAX package's _fused_geometry and _geometry)."""
    n1 = 1 << (static_log2(n) // 2)
    return n1, n // n1


def supports_fused(ring) -> bool:
    """The u16 and u32 tiers at every degree >= 8 with n2 <= 512, the JAX
    package's rule (its exactness bound |G_a| <= 4*128^2*n2 < 2^25; the
    route's engine holds |G_k| <= 2^27 up to size 1024)."""
    if ring.limb not in ("u16", "u32") or ring.degree < 8:
        return False
    return _geometry(ring.degree)[1] <= 512


# ---------------------------------------------------------------------------
# The route's matrices (dft_mxu providers) and twiddle
# ---------------------------------------------------------------------------

def _e1_fwd(ring, size):
    """Column-DFT matrices e1[r, i1] = (wc^rev(r) * phi^n2)^i1 (the phi
    twist's i1 part folded in), rows in Harvey bit-reversed output order."""
    ctx = ring.context()
    n1, n2 = _geometry(ring.degree)
    assert size == n1
    rev1 = bitrev_indices(n1)
    mats = np.empty((ring.nmoduli, n1, n1), dtype=np.uint64)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        w, phi = ctx.omega_int[cm], ctx.phi_int[cm]
        wc = pow(w, n2, p)
        wcr = np.array([pow(wc, int(r), p) for r in rev1], dtype=np.uint64)
        q = _np_mulmod_vec(wcr, np.uint64(pow(phi, n2, p)), p)  # row ratio
        e = mats[cm]
        e[:, 0] = 1
        for i1 in range(1, n1):
            e[:, i1] = _np_mulmod_vec(e[:, i1 - 1], q, p)
    return mats


def _e2_fwd(ring, size):
    """Row-DFT matrices e2[i2, c] = (wr^rev(c))^i2, columns bit-reversed."""
    ctx = ring.context()
    n1, n2 = _geometry(ring.degree)
    assert size == n2
    rev2 = bitrev_indices(n2)
    mats = np.empty((ring.nmoduli, n2, n2), dtype=np.uint64)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        wr = pow(ctx.omega_int[cm], n1, p)
        q = np.array([pow(wr, int(c), p) for c in rev2], dtype=np.uint64)
        e = mats[cm]
        e[0, :] = 1
        for i2 in range(1, n2):
            e[i2, :] = _np_mulmod_vec(e[i2 - 1, :], q, p)
    return mats


def _e1_inv(ring, size):
    """Inverse column matrices e1[i1, r] = (iwc^rev(r) * iphi^n2)^i1 (the
    n^-1-free untwist i1 part folded in)."""
    ctx = ring.context()
    n1, n2 = _geometry(ring.degree)
    assert size == n1
    rev1 = bitrev_indices(n1)
    mats = np.empty((ring.nmoduli, n1, n1), dtype=np.uint64)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        iw = pow(ctx.omega_int[cm], -1, p)
        iphi = pow(ctx.phi_int[cm], -1, p)
        iwc = pow(iw, n2, p)
        iwcr = np.array([pow(iwc, int(r), p) for r in rev1], dtype=np.uint64)
        q = _np_mulmod_vec(iwcr, np.uint64(pow(iphi, n2, p)), p)
        e = mats[cm]
        e[0, :] = 1
        for i1 in range(1, n1):
            e[i1, :] = _np_mulmod_vec(e[i1 - 1, :], q, p)
    return mats


def _e2_inv(ring, size):
    """Inverse row matrices e2[c, i2] = (iwr^rev(c))^i2."""
    ctx = ring.context()
    n1, n2 = _geometry(ring.degree)
    assert size == n2
    rev2 = bitrev_indices(n2)
    mats = np.empty((ring.nmoduli, n2, n2), dtype=np.uint64)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        iwr = pow(pow(ctx.omega_int[cm], -1, p), n1, p)
        q = np.array([pow(iwr, int(c), p) for c in rev2], dtype=np.uint64)
        e = mats[cm]
        e[:, 0] = 1
        for i2 in range(1, n2):
            e[:, i2] = _np_mulmod_vec(e[:, i2 - 1], q, p)
    return mats


# under the JAX package's names (its u64 route's), for every tier here
dft_mxu.register_matrix_provider("ntt64_e1_fwd", _e1_fwd)
dft_mxu.register_matrix_provider("ntt64_e2_fwd", _e2_fwd)
dft_mxu.register_matrix_provider("ntt64_e1_inv", _e1_inv)
dft_mxu.register_matrix_provider("ntt64_e2_inv", _e2_inv)


@functools.lru_cache(maxsize=None)
def _twiddle(ring, inverse):
    """[m, n1, n2] uint64 twiddle and Shoup companions (the kernels' word:
    64 bits for u64, 32 for u32 words, u16 too), the first mod-matmul's
    epilogue: fwd t[r, i2] = (w^rev(r) * phi)^i2;
    inv t[r, i2] = inv_deg * (iw^rev(r) * iphi)^i2 (the i2 untwist and
    n^-1 folded in)."""
    ctx = ring.context()
    m = ring.nmoduli
    n1, n2 = _geometry(ring.degree)
    rev1 = bitrev_indices(n1)
    width = 64 if ring.limb == "u64" else 32
    tw = np.empty((m, n1, n2), dtype=np.uint64)
    tws = np.empty((m, n1, n2), dtype=np.uint64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        w, phi = ctx.omega_int[cm], ctx.phi_int[cm]
        if inverse:
            w, phi = pow(w, -1, p), pow(phi, -1, p)
        start = int(ctx.invpolyDegree[cm]) if inverse else 1
        wr = np.array([pow(w, int(r), p) for r in rev1], dtype=np.uint64)
        q = _np_mulmod_vec(wr, np.uint64(phi), p)        # per-row ratio
        t = tw[cm]
        t[:, 0] = start
        for i2 in range(1, n2):
            t[:, i2] = _np_mulmod_vec(t[:, i2 - 1], q, p)
        tws[cm] = _np_shoup_vec(t.reshape(-1), p, width).reshape(n1, n2)
    return tw, tws


@functools.lru_cache(maxsize=None)
def _twiddle_device(ring, inverse, device):
    """_twiddle as the kernels' words (dft_mxu.word_dtype) on `device`."""
    unsigned, word = ((np.uint64, np.int64) if ring.limb == "u64"
                      else (np.uint32, np.int32))
    return tuple(torch.from_numpy(a.astype(unsigned).view(word)).to(device)
                 for a in _twiddle(ring, bool(inverse)))


# ---------------------------------------------------------------------------
# The route: two mod-matmuls, the twiddle in the first one's epilogue
# ---------------------------------------------------------------------------

def _as_batch(x, ring):
    m, n = ring.nmoduli, ring.degree
    if x.shape[-2:] != (m, n):
        raise ValueError(f"expected [..., {m}, {n}] residues, "
                         f"got {tuple(x.shape)}")
    return x.reshape(-1, m, n)


def _route(x, ctx, inverse, plain=False):
    """The transform of [..., m, n] residues: the first stage with the
    twiddle epilogue, then the second (ops/dft_mxu.py:ntt_stage; the twins
    when `plain` or on a CPU tensor), under strict mode with the stages'
    poison.  u16 words go through as u32 words."""
    ring = ctx.ring
    m, n = ring.nmoduli, ring.degree
    n1, n2 = _geometry(n)
    xb = x.reshape((-1, m, n1, n2))
    if ring.limb == "u16":
        xb = xb.to(torch.int32) & 0xFFFF
    twiddle = _twiddle_device(ring, bool(inverse),
                              canonical_device(x.device))
    prov1, prov2 = (("ntt64_e1_fwd", "ntt64_e2_fwd") if not inverse
                    else ("ntt64_e2_inv", "ntt64_e1_inv"))
    s1, a1, s2, a2 = ((n1, -2, n2, -1) if not inverse
                      else (n2, -1, n1, -2))
    strict = debug.strictmod_enabled()
    f = dft_mxu.ntt_stage(xb, ring, prov1, s1, axis=a1, twiddle=twiddle,
                          strict=strict, plain=plain)
    o = dft_mxu.ntt_stage(f, ring, prov2, s2, axis=a2, strict=strict,
                          plain=plain)
    return o.to(x.dtype).reshape(x.shape)


def _run(x, ctx, inverse, plain=False):
    """The checked entry: the route's kernels on a CUDA tensor, its twin on
    a CPU tensor (or when `plain`)."""
    ring = ctx.ring
    _as_batch(x, ring)
    if x.dtype != ring.torch_dtype:
        raise ValueError(f"expected {ring.torch_dtype} residues, got "
                         f"{x.dtype}")
    return _route(x, ctx, inverse, plain=plain)


def ntt_pow_phi_fused(x, ctx):
    """Forward negacyclic transform of [..., m, n] residues; bit-identical
    to ops/ntt.py's plain path.  CUDA tensor: two launches of the
    mod-matmul kernel (K9 for u16/u32, K5 or K10 for u64); CPU tensor: the
    route's twin."""
    return _run(x, ctx, False)


def invntt_pow_invphi_fused(x, ctx):
    """Inverse negacyclic transform (n^-1 and the untwist folded in);
    bit-identical to ops/ntt.py's plain path."""
    return _run(x, ctx, True)


def ntt_pow_phi_fused_plain(x, ctx):
    """The route's twin of the forward transform, on any device."""
    return _run(x, ctx, False, plain=True)


def invntt_pow_invphi_fused_plain(x, ctx):
    """The route's twin of the inverse transform, on any device."""
    return _run(x, ctx, True, plain=True)
