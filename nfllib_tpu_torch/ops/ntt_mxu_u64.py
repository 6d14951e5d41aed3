"""Four-step negacyclic NTT for the u64 (62-bit-moduli) tier: table
builders, the route through the square mod-matmul kernel, and the plain
torch twins.

PyTorch port of nfllib_tpu/ops/ntt_mxu_u64.py.  The numpy table builders
are ported as they are, so digit planes, twiddles and correction vectors
are byte-equal to the JAX package's (as native uint64 instead of its hi/lo
u32 pairs, which are a TPU workaround).

  n = n1*n2, X[i1, i2] = x[i2 + n2*i1]:
  forward:  F = W1 @ X (phi^(n2*i1) folded into W1), Y = F * tw (Shoup,
            phi^i2 folded in), O = Y @ W2;
  inverse:  O @ W2inv, twiddle with n^-1 * phi^-i2, W1inv @.

On a CUDA tensor every degree 8..2^20 runs _large_run64: two launches of
the u64 square mod-matmul kernel K5 (csrc/dft_mxu64.cu, int8 tensor cores;
ops/dft_mxu.py:ntt_stage) with unscaled Harvey-ordered matrices, the
column DFT with the twiddle as its Shoup epilogue, then the row DFT.  This
is what the JAX kernel _kernel64 (K4) computes; its outputs are canonical,
so they are bit-identical to it and to the JAX package's _large_run64.
Strict mode keeps K4's meaning: a residue equal to p raises
(ops/ntt.py:_strict_bracket), and a broken stage contract poisons the
(polynomial, channel) block.

On a CPU tensor the path is the plain twin of K4's own math (`_fused64_plain`,
held to the JAX _kernel64 in interpret mode), and _large_run64 with the
mod-matmul twins above degree 65536.  K4's math: each mod-p matmul is a sum
of digit-plane dots: x splits into EIGHT offset bytes d_b = byte_b - 128,
each table entry W into pre-scaled W^(b) = 2^(8b) W mod p decomposed into
balanced digits, and G_a = sum_b sum_k digit_a(W^(b)) d_b
(|G_a| <= 8 * 128^2 * 256 = 2^25); the biased groups pack into
v = sum_a 2^(8a) (G_a + 2^26) mod 2^64, reduced by one Barrett step with
floor(2^124/p) on a60 = the floored shifts of G_4..G_7, plus the per-row /
per-column correction for the offset-byte under-count (_recombine64).
Intermediates stay lazy in [0, 2p).  `_large_run64(..., plain=True)` is the
twin of the CUDA route on any device.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import debug
from ..ring import DEFAULT_DEVICE, _np_mulmod_vec, _np_shoup_vec, \
    _powers_mod, canonical_device
from ..utils import bitrev_indices, static_log2
from . import dft_mxu, modops

_NDIG = 8
_BIAS = 1 << 26          # > max |G_a| = 8 * 128^2 * 256 = 2^25
_BIAS_SUM = _BIAS * sum(1 << (8 * a) for a in range(_NDIG))


def supports_fused(ring) -> bool:
    """Degrees 8..2^20 (n1, n2 <= 1024), as the JAX package's: on the card
    all run _large_run64 (two mod-matmul kernel launches, the twiddle in
    the first one's epilogue)."""
    if ring.limb != "u64" or ring.degree < 8:
        return False
    if ring.degree <= 65536:
        return True
    n1, n2 = _geometry(ring.degree)
    return max(n1, n2) <= 1024          # degree <= 2^20


def _geometry(n):
    n1 = 1 << (static_log2(n) // 2)
    return n1, n // n1


def _fill_planes64(w1_cm, w2_cm, e1, e2, p):
    """Digit planes of the pre-scaled DFT matrices + the offset-byte
    correction sums (128 * row/col sums of every W^(b), minus the
    recombination bias over-count)."""
    corr1 = np.zeros(e1.shape[0], dtype=object)
    corr2 = np.zeros(e2.shape[1], dtype=object)
    for b in range(_NDIG):
        s1 = _np_mulmod_vec(e1, np.uint64(pow(2, 8 * b, p)), p)
        s2 = _np_mulmod_vec(e2, np.uint64(pow(2, 8 * b, p)), p)
        d1 = dft_mxu._balanced_digits_np(s1, _NDIG)
        d2 = dft_mxu._balanced_digits_np(s2, _NDIG)
        for a in range(_NDIG):
            w1_cm[_NDIG * a + b] = d1[a]
            w2_cm[_NDIG * a + b] = d2[a]
        corr1 += 128 * s1.astype(object).sum(axis=1)
        corr2 += 128 * s2.astype(object).sum(axis=0)
    c1 = np.array([(int(v) - _BIAS_SUM) % p for v in corr1], dtype=np.uint64)
    c2 = np.array([(int(v) - _BIAS_SUM) % p for v in corr2], dtype=np.uint64)
    return c1, c2


@functools.lru_cache(maxsize=None)
def _tables64(ring, inverse):
    """(n1, n2, w1l, w2l, tw, tws, corr1, corr2, mbar, p): the JAX
    package's tables, with every 64-bit quantity a native uint64 array."""
    ctx = ring.context()
    n, m = ring.degree, ring.nmoduli
    n1, n2 = _geometry(n)
    rev1 = bitrev_indices(n1)
    rev2 = bitrev_indices(n2)

    w1l = np.empty((m, _NDIG * _NDIG, n1, n1), dtype=np.int8)
    w2l = np.empty((m, _NDIG * _NDIG, n2, n2), dtype=np.int8)
    tw = np.empty((m, n1, n2), dtype=np.uint64)
    tws = np.empty((m, n1, n2), dtype=np.uint64)
    corr1 = np.zeros((m, n1, 1), dtype=np.uint64)
    corr2 = np.zeros((m, 1, n2), dtype=np.uint64)
    mbar = np.empty((m, 1, 1), dtype=np.uint64)   # floor(2^124/p)

    r1 = np.asarray(rev1, dtype=np.int64)
    r2 = np.asarray(rev2, dtype=np.int64)
    i1s = np.arange(n1, dtype=np.int64)
    i2s = np.arange(n2, dtype=np.int64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        w = ctx.omega_int[cm]
        phi = ctx.phi_int[cm]
        # each matrix entry is base^(idx) * scale^i with idx reducible mod
        # the base's order: one power table per base + fancy indexing + one
        # exact Barrett mulmod
        if not inverse:
            wc, wr = pow(w, n2, p), pow(w, n1, p)
            pw_wc = _powers_mod(wc, n1, p, obj=True)       # order n1
            pw_wr = _powers_mod(wr, n2, p, obj=True)       # order n2
            pw_w = _powers_mod(w, n, p, obj=True)          # order n
            phi_n2 = _powers_mod(pow(phi, n2, p), n1, p, obj=True)
            phi_i2 = _powers_mod(phi, n2, p, obj=True)
            e1 = _np_mulmod_vec(pw_wc[(r1[:, None] * i1s[None, :]) % n1],
                                phi_n2[None, :], p)
            e2 = pw_wr[(i2s[:, None] * r2[None, :]) % n2]
            t = _np_mulmod_vec(pw_w[(r1[:, None] * i2s[None, :]) % n],
                               phi_i2[None, :], p)
        else:
            iw = pow(w, -1, p)
            iphi = pow(phi, -1, p)
            inv_deg = int(ctx.invpolyDegree[cm])
            iwc, iwr = pow(iw, n2, p), pow(iw, n1, p)
            pw_iwc = _powers_mod(iwc, n1, p, obj=True)
            pw_iwr = _powers_mod(iwr, n2, p, obj=True)
            pw_iw = _powers_mod(iw, n, p, obj=True)
            iphi_n2 = _powers_mod(pow(iphi, n2, p), n1, p, obj=True)
            # n^-1 folds into the iphi^i2 scale of the twiddle
            iphi_i2 = _powers_mod(iphi, n2, p, start=inv_deg, obj=True)
            e1 = _np_mulmod_vec(                            # W1inv'
                pw_iwc[(i1s[:, None] * r1[None, :]) % n1],
                iphi_n2[:, None], p)
            e2 = pw_iwr[(r2[:, None] * i2s[None, :]) % n2]  # W2inv
            t = _np_mulmod_vec(pw_iw[(r1[:, None] * i2s[None, :]) % n],
                               iphi_i2[None, :], p)
        tw[cm] = t
        tws[cm] = _np_shoup_vec(t, p, 64)
        c1, c2 = _fill_planes64(w1l[cm], w2l[cm], e1, e2, p)
        corr1[cm, :, 0] = c1
        corr2[cm, 0, :] = c2
        mbar[cm, 0, 0] = (1 << 124) // p

    p_vec = ctx.p.reshape(m, 1, 1)
    return n1, n2, w1l, w2l, tw, tws, corr1, corr2, mbar, p_vec


# ---------------------------------------------------------------------------
# The twin's table object: K4's tables packed 8 digit planes a word, on one
# device
# ---------------------------------------------------------------------------

def pack_planes64(wl: np.ndarray) -> np.ndarray:
    """[m, 64, r, c] int8 planes (index 8a + b) -> [m, 8, r, c] int64 words
    whose byte b is plane 8a + b."""
    m, _, r, c = wl.shape
    return np.ascontiguousarray(
        wl.reshape(m, _NDIG, _NDIG, r, c).transpose(0, 1, 3, 4, 2)
    ).view(np.int64)[..., 0]


@dataclasses.dataclass(frozen=True, eq=False)
class Fused64Tables:
    """One direction's K4 tables on one device, as the twin
    `_fused64_plain` reads them (int64 tensors holding the uint64 bit
    patterns):
      w1 [m, 8, n1, n1], w2 [m, 8, n2, n2]: packed digit words
      tw, tws [m, n]; corr1 [m, n1]; corr2 [m, n2]; p, mbar [m]."""
    n1: int
    n2: int
    w1: torch.Tensor
    w2: torch.Tensor
    tw: torch.Tensor
    tws: torch.Tensor
    corr1: torch.Tensor
    corr2: torch.Tensor
    p: torch.Tensor
    mbar: torch.Tensor

    @property
    def m(self) -> int:
        return self.p.shape[0]

    @property
    def device(self) -> torch.device:
        return self.p.device

    @functools.cached_property
    def plain_planes(self):
        """float64 digit matrices for the twin's exact dots:
        left [m, 8*n1, 8*n1] (rows (a, r), cols (b, k)) and
        right [m, 8*n2, 8*n2] (rows (b, k), cols (a, c))."""
        shifts = torch.arange(_NDIG, device=self.device) * 8

        def lanes(w):     # [...] int64 words -> [..., 8] signed bytes
            v = (w[..., None] >> shifts) & 0xFF
            return (v - ((v >= 128).to(torch.int64) << 8)).to(torch.float64)

        m, n1, n2 = self.m, self.n1, self.n2
        left = lanes(self.w1).permute(0, 1, 2, 4, 3).reshape(
            m, _NDIG * n1, _NDIG * n1)
        right = lanes(self.w2).permute(0, 4, 2, 1, 3).reshape(
            m, _NDIG * n2, _NDIG * n2)
        return left.contiguous(), right.contiguous()


def _join_pair(v):
    """A JAX (hi, lo) uint32 pair -> native uint64; native arrays pass."""
    if isinstance(v, tuple):
        hi, lo = (np.asarray(a).astype(np.uint64) for a in v)
        return (hi << np.uint64(32)) | lo
    return np.asarray(v, dtype=np.uint64)


def fused_tables64_from_numpy(tables,
                              device=DEFAULT_DEVICE) -> Fused64Tables:
    """The tuple _tables64 returns -> Fused64Tables on `device`.  Takes the
    port's tuple (native uint64) or the JAX package's
    nfllib_tpu.ops.ntt_mxu_u64._tables64 tuple, whose 64-bit entries are
    (hi, lo) uint32 pairs."""
    n1, n2, w1l, w2l, tw, tws, corr1, corr2, mbar, p_vec = tables
    m = w2l.shape[0]

    def put(a, shape):
        a = np.ascontiguousarray(_join_pair(a).reshape(shape))
        return torch.from_numpy(a.view(np.int64).copy()).to(device)

    n1, n2 = int(n1), int(n2)
    return Fused64Tables(
        n1=n1, n2=n2,
        w1=put(pack_planes64(w1l), (m, _NDIG, n1, n1)),
        w2=put(pack_planes64(w2l), (m, _NDIG, n2, n2)),
        tw=put(tw, (m, n1 * n2)), tws=put(tws, (m, n1 * n2)),
        corr1=put(corr1, (m, n1)), corr2=put(corr2, (m, n2)),
        p=put(p_vec, (m,)), mbar=put(mbar, (m,)))


@functools.lru_cache(maxsize=None)
def _device_tables(ring, inverse: bool, device: torch.device):
    return fused_tables64_from_numpy(_tables64(ring, inverse), device)


def fused_tables64(ring, inverse: bool, device) -> Fused64Tables:
    """The port's own fused tables for `ring`, cached per device."""
    return _device_tables(ring, bool(inverse), canonical_device(device))


# ---------------------------------------------------------------------------
# Plain torch twin: the kernel's math in int64, digit dots as float64 matmuls
# ---------------------------------------------------------------------------

def _recombine64_plain(g, p, mbar, corr, lazy):
    """_recombine64 on exact int64 group sums g[a] (the carry-free Barrett:
    v mod 2^64 and a60 = the floored shifts of g4..g7, r = v - q*p < 4p)."""
    g = [ga + _BIAS for ga in g]
    lo = g[0] + (g[1] << 8) + (g[2] << 16) + (g[3] << 24)      # < 2^53
    hi = g[4] + (g[5] << 8) + (g[6] << 16) + (g[7] << 24)
    v = lo + (hi << 32)                                         # mod 2^64
    a60 = (g[4] >> 28) + (g[5] >> 20) + (g[6] >> 12) + (g[7] >> 4)
    r = v - modops.mulhi64(a60, mbar) * p
    two_p = 2 * p
    r = modops._sub_if_ge(r, two_p, 64)
    r = modops._sub_if_ge(r + corr, two_p, 64)
    return r if lazy else modops._sub_if_ge(r, p, 64)


def _fused64_plain(x, t: Fused64Tables, inverse: bool, strict: bool):
    """The JAX kernel _kernel64's computation on [B, m, n] int64 residues,
    in plain torch; strict mode poisons a (polynomial, channel) block whose
    stage results leave their contract.  Works in [m, B, n1, n2] layout so
    the digit dots are batched per channel."""
    m, n1, n2 = t.m, t.n1, t.n2
    B = x.shape[0]
    X = x.reshape(B, m, n1, n2).transpose(0, 1)
    p = t.p.view(m, 1, 1, 1)
    mbar = t.mbar.view(m, 1, 1, 1)
    left_w, right_w = t.plain_planes
    bad = torch.zeros((m, B), dtype=torch.bool, device=x.device)

    def check(v, bound):
        nonlocal bad
        if strict:
            bad = bad | modops.uge(v, bound).flatten(2).any(-1)

    def left(v, lazy):        # F[r, c] = sum_k W[r, k] . v[k, c]
        d = dft_mxu._offset_digits(v)                      # [b, m, B, k, c]
        d = d.permute(1, 0, 3, 2, 4).reshape(m, _NDIG * n1, B * n2)
        g = torch.matmul(left_w, d).to(torch.int64)
        g = g.view(m, _NDIG, n1, B, n2).permute(1, 0, 3, 2, 4)  # [a, m, B, r, c]
        corr = t.corr1.view(m, 1, n1, 1)
        return _recombine64_plain(list(g), p, mbar, corr, lazy)

    def right(v, lazy):       # O[r, c] = sum_k v[r, k] . W[k, c]
        d = dft_mxu._offset_digits(v)                      # [b, m, B, r, k]
        d = d.permute(1, 2, 3, 0, 4).reshape(m, B * n1, _NDIG * n2)
        g = torch.matmul(d, right_w).to(torch.int64)
        g = g.view(m, B, n1, _NDIG, n2).permute(3, 0, 1, 2, 4)  # [a, m, B, r, c]
        corr = t.corr2.view(m, 1, 1, n2)
        return _recombine64_plain(list(g), p, mbar, corr, lazy)

    def twiddle(v):           # lazy Shoup, < 2p
        tw = t.tw.view(m, 1, n1, n2)
        tws = t.tws.view(m, 1, n1, n2)
        return v * tw - modops.mulhi64(v, tws) * p

    first, second = (left, right) if not inverse else (right, left)
    X = first(X, True)
    check(X, 2 * p)
    X = twiddle(X)
    check(X, 2 * p)
    X = second(X, False)
    check(X, p)
    if strict:
        X = torch.where(bad[:, :, None, None], torch.full_like(X, -1), X)
    return X.transpose(0, 1).reshape(B, m, n1 * n2)


def _as_batch(x, ring):
    m, n = ring.nmoduli, ring.degree
    if x.shape[-2:] != (m, n) or x.dtype != torch.int64:
        raise ValueError(f"expected [..., {m}, {n}] int64 residues, "
                         f"got {x.dtype} {tuple(x.shape)}")
    return x.reshape(-1, m, n)


def _fused_plain_entry(x, ctx, tables, inverse):
    ring = ctx.ring
    if ring.degree > 65536:
        return _large_run64(x, ctx, inverse, plain=True)
    t = tables if tables is not None else fused_tables64(ring, inverse,
                                                         x.device)
    out = _fused64_plain(_as_batch(x, ring), t, inverse,
                         debug.strictmod_enabled())
    return out.reshape(x.shape)


def ntt_pow_phi_fused_plain(x, ctx, tables: Fused64Tables | None = None):
    """Plain torch twin of the forward transform (K4's math), on any device
    (degrees above 65536: _large_run64 with the mod-matmul twins)."""
    return _fused_plain_entry(x, ctx, tables, False)


def invntt_pow_invphi_fused_plain(x, ctx, tables: Fused64Tables | None = None):
    """Plain torch twin of the inverse transform, on any device."""
    return _fused_plain_entry(x, ctx, tables, True)


# ---------------------------------------------------------------------------
# The route of every degree on the card (and of 2^17..2^20 everywhere): two
# dft_mxu mod-matmuls with Harvey-ordered matrices, the twiddle in the
# first one's epilogue.
# ---------------------------------------------------------------------------

def _large_e1_fwd(ring, size):
    """Column-DFT matrices e1[r, i1] = (wc^rev(r) * phi^n2)^i1 (the phi
    twist's i1 part folded in), rows in Harvey bit-reversed output order."""
    ctx = ring.context()
    n = ring.degree
    n1, n2 = _geometry(n)
    assert size == n1
    rev1 = bitrev_indices(n1)
    m = ring.nmoduli
    mats = np.empty((m, n1, n1), dtype=np.uint64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        w, phi = ctx.omega_int[cm], ctx.phi_int[cm]
        wc = pow(w, n2, p)
        phin2 = pow(phi, n2, p)
        wcr = np.array([pow(wc, int(r), p) for r in rev1], dtype=np.uint64)
        q = _np_mulmod_vec(wcr, np.uint64(phin2), p)     # per-row ratio
        e = mats[cm]
        e[:, 0] = 1
        for i1 in range(1, n1):
            e[:, i1] = _np_mulmod_vec(e[:, i1 - 1], q, p)
    return mats


def _large_e2_fwd(ring, size):
    """Row-DFT matrices e2[i2, c] = (wr^rev(c))^i2, columns bit-reversed."""
    ctx = ring.context()
    n = ring.degree
    n1, n2 = _geometry(n)
    assert size == n2
    rev2 = bitrev_indices(n2)
    m = ring.nmoduli
    mats = np.empty((m, n2, n2), dtype=np.uint64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        wr = pow(ctx.omega_int[cm], n1, p)
        q = np.array([pow(wr, int(c), p) for c in rev2], dtype=np.uint64)
        e = mats[cm]
        e[0, :] = 1
        for i2 in range(1, n2):
            e[i2, :] = _np_mulmod_vec(e[i2 - 1, :], q, p)
    return mats


def _large_e1_inv(ring, size):
    """Inverse column matrices e1[i1, r] = (iwc^rev(r) * iphi^n2)^i1 (the
    n^-1-free untwist i1 part folded in)."""
    ctx = ring.context()
    n = ring.degree
    n1, n2 = _geometry(n)
    assert size == n1
    rev1 = bitrev_indices(n1)
    m = ring.nmoduli
    mats = np.empty((m, n1, n1), dtype=np.uint64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        iw = pow(ctx.omega_int[cm], -1, p)
        iphi = pow(ctx.phi_int[cm], -1, p)
        iwc = pow(iw, n2, p)
        iphin2 = pow(iphi, n2, p)
        iwcr = np.array([pow(iwc, int(r), p) for r in rev1], dtype=np.uint64)
        q = _np_mulmod_vec(iwcr, np.uint64(iphin2), p)   # per-column ratio
        e = mats[cm]
        e[0, :] = 1
        for i1 in range(1, n1):
            e[i1, :] = _np_mulmod_vec(e[i1 - 1, :], q, p)
    return mats


def _large_e2_inv(ring, size):
    """Inverse row matrices e2[c, i2] = (iwr^rev(c))^i2."""
    ctx = ring.context()
    n = ring.degree
    n1, n2 = _geometry(n)
    assert size == n2
    rev2 = bitrev_indices(n2)
    m = ring.nmoduli
    mats = np.empty((m, n2, n2), dtype=np.uint64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        iwr = pow(pow(ctx.omega_int[cm], -1, p), n1, p)
        q = np.array([pow(iwr, int(c), p) for c in rev2], dtype=np.uint64)
        e = mats[cm]
        e[:, 0] = 1
        for i2 in range(1, n2):
            e[:, i2] = _np_mulmod_vec(e[:, i2 - 1], q, p)
    return mats


@functools.lru_cache(maxsize=None)
def _large_twiddle(ring, inverse):
    """[m, n1, n2] twiddle + 64-bit Shoup companions, the first
    mod-matmul's epilogue: fwd t[r, i2] = (w^rev(r) * phi)^i2; inv
    t[r, i2] = inv_deg * (iw^rev(r) * iphi)^i2 (the i2 untwist and n^-1
    folded in)."""
    ctx = ring.context()
    n, m = ring.degree, ring.nmoduli
    n1, n2 = _geometry(n)
    rev1 = bitrev_indices(n1)
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
        tws[cm] = _np_shoup_vec(t.reshape(-1), p, 64).reshape(n1, n2)
    return tw, tws


@functools.lru_cache(maxsize=None)
def _large_twiddle_device(ring, inverse, device):
    tw, tws = _large_twiddle(ring, inverse)
    return tuple(torch.from_numpy(a.view(np.int64).copy()).to(device)
                 for a in (tw, tws))


dft_mxu.register_matrix_provider("ntt64_e1_fwd", _large_e1_fwd)
dft_mxu.register_matrix_provider("ntt64_e2_fwd", _large_e2_fwd)
dft_mxu.register_matrix_provider("ntt64_e1_inv", _large_e1_inv)
dft_mxu.register_matrix_provider("ntt64_e2_inv", _large_e2_inv)


def _large_run64(x, ctx, inverse, plain=False):
    """K5 with the twiddle epilogue, then K5 (ops/dft_mxu.py:ntt_stage;
    the twins when `plain` or on a CPU tensor), under strict mode with the
    stages' poison.  The JAX package's _large_run64 runs the twiddle as a
    separate mulmod_shoup; the epilogue's output is bit-identical to
    that."""
    ring = ctx.ring
    m, n = ring.nmoduli, ring.degree
    n1, n2 = _geometry(n)
    xb = x.reshape((-1, m, n1, n2))
    twiddle = _large_twiddle_device(ring, bool(inverse),
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
    return o.reshape(x.shape)


def _run64(x, ctx, inverse):
    if x.device.type == "cpu":
        return _fused_plain_entry(x, ctx, None, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"no fused NTT for tensors on {x.device}")
    _as_batch(x, ctx.ring)                 # the shape and dtype check
    return _large_run64(x, ctx, inverse)


def ntt_pow_phi_fused(x, ctx):
    """Forward negacyclic transform of u64 [..., m, n]; bit-identical to
    ops/ntt.py's plain path.  CUDA tensor: two K5 launches (_large_run64);
    CPU tensor: the plain twins."""
    return _run64(x, ctx, False)


def invntt_pow_invphi_fused(x, ctx):
    """Inverse negacyclic transform (fused untwist); bit-identical to
    ops/ntt.py's plain path."""
    return _run64(x, ctx, True)
