"""Fused four-step negacyclic NTT: table builders, the CUDA kernel wrappers
and their plain torch twins.

PyTorch port of the fused path of nfllib_tpu/ops/ntt_mxu.py.  The numpy
table builders are ported as they are, so the tables are byte-equal to the
JAX package's; the JAX kernels _fused_kernel / _fused_inv_kernel become
csrc/ntt_fused.cu, one hand-written CUDA kernel for both directions.

  n = n1*n2, X[i1, i2] = x[i2 + n2*i1]:
  forward:  F = W1 @ X (phi^(n2*i1) folded into W1's columns), twiddle
            Y = F * tw (omega^(rev(k1)*i2) * phi^i2), O = Y @ W2,
            O[r, c] = harvey[r*n2 + c];
  inverse:  O @ W2inv, twiddle with n^-1 * phi^-i2, W1inv @ with
            phi^-(n2*i1) folded into its rows.

Each mod-p matmul is a sum of digit-plane dots (see _fill_digit_planes):
u32 uses four offset-byte digits of x against four balanced digits of each
pre-scaled W^(b) = 2^(8b) W mod p; u16 two unsigned 7-bit digits.  The
biased groups recombine with one Barrett step (_recombine_consts) plus the
per-row / per-column correction vectors.

`ntt_pow_phi_fused` / `invntt_pow_invphi_fused` launch the kernel for a
CUDA tensor and run the plain twin (`*_fused_plain`, same math in int64
with float64 matmuls for the exact digit dots) for a CPU tensor.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _kernels, debug
from ..ring import DEFAULT_DEVICE, _powers_mod, canonical_device
from ..utils import bitrev_indices, static_log2
from . import dft_mxu, modops


def supports_fused(ring) -> bool:
    """The fused kernel covers the u16 and u32 tiers at every degree >= 8.

    The explicit cap n2 <= 512 enforces the exactness bound
    |G_a| <= 4*128^2*k < 2^25 (k = max contraction = n2)."""
    if ring.limb not in ("u16", "u32") or ring.degree < 8:
        return False
    n2 = _fused_geometry(ring.degree, ring.limb)[1]
    return n2 <= 512


def _fused_geometry(n, limb="u32"):
    """(n1, n2, dbits, ndig): split n = n1*n2 with n1 <= n2, and pick the
    digit decomposition: u32 four balanced 8-bit digits, u16 two unsigned
    7-bit digits."""
    lg = static_log2(n)
    n1 = 1 << (lg // 2)
    n2 = n // n1
    if limb == "u16":
        return n1, n2, 7, 2
    return n1, n2, 8, 4


def _balanced_digits_host(v):
    """[r, c] (< 2^31) -> [4, r, c] int8 balanced base-256 digits."""
    return dft_mxu._balanced_digits_np(np.asarray(v).astype(np.uint64), 4)


@functools.lru_cache(maxsize=None)
def _fused_tables(ring):
    ctx = ring.context()
    n, m = ring.degree, ring.nmoduli
    n1, n2, dbits, ndig = _fused_geometry(n, ring.limb)
    rev1 = bitrev_indices(n1)
    rev2 = bitrev_indices(n2)

    w1l = np.empty((m, ndig * ndig, n1, n1), dtype=np.int8)
    w2l = np.empty((m, ndig * ndig, n2, n2), dtype=np.int8)
    tw = np.empty((m, n1, n2), dtype=np.uint32)
    tws = np.empty((m, n1, n2), dtype=np.uint32)
    corr1 = np.zeros((m, n1, 1), dtype=np.uint32)
    corr2 = np.zeros((m, 1, n2), dtype=np.uint32)
    shoup1 = _recombine_consts(ring, ndig)
    wshift = 16 if ring.limb == "u16" else 32

    r1 = np.asarray(rev1, dtype=np.int64)
    r2 = np.asarray(rev2, dtype=np.int64)
    i1s = np.arange(n1, dtype=np.int64)
    i2s = np.arange(n2, dtype=np.int64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        w = ctx.omega_int[cm]
        phi = ctx.phi_int[cm]
        wc, wr = pow(w, n2, p), pow(w, n1, p)
        # the phi^i pre-twist factors as phi^(i2 + n2*i1) =
        # (phi^n2)^i1 * phi^i2: the i1 part folds into W1's columns, the i2
        # part into the twiddle table — the kernel has NO twist stage.
        pw_wc = _powers_mod(wc, n1, p)                 # order n1
        pw_wr = _powers_mod(wr, n2, p)                 # order n2
        pw_w = _powers_mod(w, n, p)                    # order n
        phi_n2 = _powers_mod(pow(phi, n2, p), n1, p)
        phi_i2 = _powers_mod(phi, n2, p)
        e1 = (pw_wc[(r1[:, None] * i1s[None, :]) % n1]
              * phi_n2[None, :]) % p
        e2 = pw_wr[(i2s[:, None] * r2[None, :]) % n2]
        t = (pw_w[(r1[:, None] * i2s[None, :]) % n]
             * phi_i2[None, :]) % p
        tw[cm] = t
        tws[cm] = (t << np.uint64(wshift)) // np.uint64(p)
        c1, c2 = _fill_digit_planes(w1l[cm], w2l[cm], e1, e2, p, dbits, ndig)
        corr1[cm, :, 0] = c1
        corr2[cm, 0, :] = c2

    p_vec = ctx.p.reshape(m, 1, 1).astype(np.uint32)
    w1t = _interleave_left(w1l, ndig) if ndig == 4 else w1l
    return n1, n2, w1t, w2l, tw, tws, corr1, corr2, shoup1, p_vec


def _interleave_left(w1l, ndig):
    """[m, ndig*ndig, n1, n1] digit planes -> [m, ndig, n1, ndig*n1] with
    w1i[a][r, ndig*i1 + b] = digit_a(W^(b))[r, i1] (the JAX kernel's
    byte-interleaved left operand; viewed as int32 it is one dp4a word per
    (a, r, i1))."""
    m, _, n1, _ = w1l.shape
    return np.ascontiguousarray(
        w1l.reshape(m, ndig, ndig, n1, n1)
        .transpose(0, 1, 3, 4, 2)
        .reshape(m, ndig, n1, ndig * n1))


_BAL_BIAS = 1 << 25      # makes balanced group sums nonneg (|G_a| < 2^25)


def _recombine_consts(ring, ndig):
    """[m, 5] per-channel constants for the group recombination:
    u32 (ndig=4): [floor(2^60/p), 0...]; u16 (ndig=2): [floor(2^32/p), 0...]."""
    m = ring.nmoduli
    out = np.zeros((m, 5), dtype=np.uint32)
    for cm in range(m):
        p = int(ring.moduli[cm])
        out[cm, 0] = ((1 << 60) // p) if ndig == 4 else ((1 << 32) // p)
    return out


# constant over-count of the biased pack: sum_a BIAS * 2^(8a)
_BIAS_SUM = _BAL_BIAS * (1 + (1 << 8) + (1 << 16) + (1 << 24))


def _fill_digit_planes(w1_cm, w2_cm, e1, e2, p, dbits, ndig):
    """Pre-scaled digit planes: W^(b) = (2^(dbits*b) * W) mod p, decomposed
    into ndig digit matrices (balanced int8 for u32, unsigned for u16).

    Returns (corr1_add[n1], corr2_add[n2]): x is digitized with OFFSET
    bytes (d = byte - 128), which under-counts the true product by
    128 * sum_b W^(b) summed over the contraction — a per-output-row (left
    matmul) / per-output-column (right matmul) constant.  corr*_add = (that
    - _BIAS_SUM) mod p is added back once at recombination.  Zero vectors
    for the unsigned u16 scheme."""
    corr1 = np.zeros(e1.shape[0], dtype=object)
    corr2 = np.zeros(e2.shape[1], dtype=object)
    dmask = (1 << dbits) - 1
    for b in range(ndig):
        s1 = (e1 * pow(2, dbits * b, p)) % p
        s2 = (e2 * pow(2, dbits * b, p)) % p
        if ndig == 4:
            d1 = _balanced_digits_host(s1)
            d2 = _balanced_digits_host(s2)
            for a in range(ndig):
                w1_cm[ndig * a + b] = d1[a]
                w2_cm[ndig * a + b] = d2[a]
            corr1 += 128 * s1.astype(object).sum(axis=1)   # row sums
            corr2 += 128 * s2.astype(object).sum(axis=0)   # col sums
        else:
            for a in range(ndig):
                w1_cm[ndig * a + b] = ((s1 >> (dbits * a))
                                       & dmask).astype(np.int8)
                w2_cm[ndig * a + b] = ((s2 >> (dbits * a))
                                       & dmask).astype(np.int8)
    bias = _BIAS_SUM if ndig == 4 else 0
    c1 = np.array([(int(v) - bias) % p for v in corr1], dtype=np.uint32)
    c2 = np.array([(int(v) - bias) % p for v in corr2], dtype=np.uint32)
    return c1, c2


@functools.lru_cache(maxsize=None)
def _fused_inv_tables(ring):
    ctx = ring.context()
    n, m = ring.degree, ring.nmoduli
    n1, n2, dbits, ndig = _fused_geometry(n, ring.limb)
    rev1 = bitrev_indices(n1)
    rev2 = bitrev_indices(n2)

    w1l = np.empty((m, ndig * ndig, n1, n1), dtype=np.int8)
    w2l = np.empty((m, ndig * ndig, n2, n2), dtype=np.int8)
    tw = np.empty((m, n1, n2), dtype=np.uint32)
    tws = np.empty((m, n1, n2), dtype=np.uint32)
    corr1 = np.zeros((m, n1, 1), dtype=np.uint32)
    corr2 = np.zeros((m, 1, n2), dtype=np.uint32)
    shoup1 = _recombine_consts(ring, ndig)
    wshift = 16 if ring.limb == "u16" else 32

    r1 = np.asarray(rev1, dtype=np.int64)
    r2 = np.asarray(rev2, dtype=np.int64)
    i1s = np.arange(n1, dtype=np.int64)
    i2s = np.arange(n2, dtype=np.int64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        w = ctx.omega_int[cm]
        iw = pow(w, -1, p)
        iphi = pow(ctx.phi_int[cm], -1, p)
        inv_deg = int(ctx.invpolyDegree[cm])
        iwc, iwr = pow(iw, n2, p), pow(iw, n1, p)
        # the n^-1 * phi^-i untwist factors as
        # inv_deg * (phi^-n2)^i1 * (phi^-1)^i2: the i1 part folds into
        # W1inv's rows, the i2 part (with inv_deg) into the inverse twiddle
        # — the kernel has NO untwist stage.
        pw_iwc = _powers_mod(iwc, n1, p)
        pw_iwr = _powers_mod(iwr, n2, p)
        pw_iw = _powers_mod(iw, n, p)
        iphi_n2 = _powers_mod(pow(iphi, n2, p), n1, p)
        iphi_i2 = _powers_mod(iphi, n2, p, start=inv_deg)
        e1 = (pw_iwc[(i1s[:, None] * r1[None, :]) % n1]
              * iphi_n2[:, None]) % p                             # W1inv'
        e2 = pw_iwr[(r2[:, None] * i2s[None, :]) % n2]            # W2inv
        t = (pw_iw[(r1[:, None] * i2s[None, :]) % n]
             * iphi_i2[None, :]) % p                              # Tinv'
        tw[cm] = t
        tws[cm] = (t << np.uint64(wshift)) // np.uint64(p)
        c1, c2 = _fill_digit_planes(w1l[cm], w2l[cm], e1, e2, p, dbits, ndig)
        corr1[cm, :, 0] = c1
        corr2[cm, 0, :] = c2

    p_vec = ctx.p.reshape(m, 1, 1).astype(np.uint32)
    w1t = _interleave_left(w1l, ndig) if ndig == 4 else w1l
    return n1, n2, w1t, w2l, tw, tws, corr1, corr2, shoup1, p_vec


# ---------------------------------------------------------------------------
# The port's table object: the JAX tuple packed for dp4a, on one device
# ---------------------------------------------------------------------------

def pack_planes(wl: np.ndarray, ndig: int) -> np.ndarray:
    """[m, ndig*ndig, r, c] int8 planes (index ndig*a + b) -> [m, ndig, r, c]
    int32 words whose byte b is plane ndig*a + b (bytes ndig..3 zero): one
    __dp4a operand per (a, r, c) for both the u32 and the u16 tier."""
    m, _, r, c = wl.shape
    words = np.zeros((m, ndig, r, c, 4), dtype=np.int8)
    words[..., :ndig] = wl.reshape(m, ndig, ndig, r, c).transpose(0, 1, 3, 4, 2)
    return words.view(np.int32)[..., 0]


@dataclasses.dataclass(frozen=True, eq=False)
class FusedTables:
    """One direction's fused tables on one device, in the kernel's format
    (int32 tensors holding the unsigned bit patterns):
      w1 [m, NA, n1, n1], w2 [m, NA, n2, n2]: packed digit words (NA = ndig)
      tw, tws [m, n]; corr1 [m, n1]; corr2 [m, n2]; p, mbar [m]."""
    n1: int
    n2: int
    ndig: int
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
        left [m, NA*n1, ndig*n1] (rows (a, r), cols (b, k)) and
        right [m, ndig*n2, NA*n2] (rows (b, k), cols (a, c))."""
        nd = self.ndig
        shifts = torch.arange(nd, device=self.device) * 8

        def lanes(w):     # [...] int32 words -> [..., nd] signed bytes
            v = (w[..., None].to(torch.int64) >> shifts) & 0xFF
            return (v - ((v >= 128).to(torch.int64) << 8)).to(torch.float64)

        m, n1, n2 = self.m, self.n1, self.n2
        left = lanes(self.w1).permute(0, 1, 2, 4, 3).reshape(
            m, nd * n1, nd * n1)
        right = lanes(self.w2).permute(0, 4, 2, 1, 3).reshape(
            m, nd * n2, nd * n2)
        return left.contiguous(), right.contiguous()


def fused_tables_from_numpy(tables,
                            device=DEFAULT_DEVICE) -> FusedTables:
    """The tuple _fused_tables / _fused_inv_tables return (the JAX package's
    or the port's: they are byte-equal) -> FusedTables on `device`."""
    n1, n2, w1t, w2l, tw, tws, corr1, corr2, shoup1, p_vec = tables
    m = w2l.shape[0]
    ndig = 4 if w1t.shape[-1] == 4 * n1 else 2
    if ndig == 4:
        # the interleaved left layout already is one dp4a word per (a, r, i1)
        w1 = np.ascontiguousarray(w1t).view(np.int32)
    else:
        w1 = pack_planes(w1t, ndig)
    w2 = pack_planes(w2l, ndig)

    def put(a, shape):
        a = np.ascontiguousarray(np.asarray(a).reshape(shape))
        if a.dtype != np.int32:
            a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
        return torch.from_numpy(a.copy()).to(device)

    return FusedTables(
        n1=int(n1), n2=int(n2), ndig=ndig,
        w1=put(w1, (m, ndig, n1, n1)), w2=put(w2, (m, ndig, n2, n2)),
        tw=put(tw, (m, n1 * n2)), tws=put(tws, (m, n1 * n2)),
        corr1=put(corr1, (m, n1)), corr2=put(corr2, (m, n2)),
        p=put(p_vec, (m,)), mbar=put(shoup1[:, 0], (m,)))


@functools.lru_cache(maxsize=None)
def _device_tables(ring, inverse: bool, device: torch.device) -> FusedTables:
    build = _fused_inv_tables if inverse else _fused_tables
    return fused_tables_from_numpy(build(ring), device)


def fused_tables(ring, inverse: bool, device) -> FusedTables:
    """The port's own fused tables for `ring`, cached per device."""
    return _device_tables(ring, bool(inverse), canonical_device(device))


# ---------------------------------------------------------------------------
# Plain torch twin: the kernel's math in int64, digit dots as float64 matmuls
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _digits_plain(x, ndig):
    """int64 [..., k] -> [..., ndig, k] digits as float64: offset bytes
    byte_b - 128 (u32) or unsigned 7-bit digits (u16)."""
    if ndig == 4:
        d = [((x >> (8 * b)) & 0xFF) - 128 for b in range(4)]
    else:
        d = [(x >> (7 * b)) & 0x7F for b in range(2)]
    return torch.stack(d, dim=-2).to(torch.float64)


def _recombine_plain(g, p, mbar, corr, lazy, ndig):
    """_recombine_groups on exact int64 group sums g[a]."""
    if ndig == 2:
        u0 = g[0] + (g[1] << 7)
        t = (u0 - ((u0 * mbar) >> 32) * p) & _M32
        return torch.where(t >= p, t - p, t)
    two_p = 2 * p
    gb = [ga + _BAL_BIAS for ga in g]
    lo = (gb[0] + (gb[1] << 8) + (gb[2] << 16) + (gb[3] << 24)) & _M32
    a28 = (gb[1] >> 20) + (gb[2] >> 12) + (gb[3] >> 4)
    t = (lo - ((a28 * mbar) >> 32) * p) & _M32                  # < 4p
    t = torch.where(t >= two_p, t - two_p, t)
    t = (t + corr) & _M32
    t = torch.where(t >= two_p, t - two_p, t)
    return t if lazy else torch.where(t >= p, t - p, t)


def _fused_plain(x, t: FusedTables, inverse: bool, strict: bool):
    """The kernel's computation on [B, m, n] storage residues, in plain torch.
    Works in [m, B, n1, n2] layout so the digit dots are batched per
    channel."""
    bits = modops.limb_bits(x.dtype)
    m, n1, n2, nd = t.m, t.n1, t.n2, t.ndig
    B = x.shape[0]
    X = modops.widen(x, bits).reshape(B, m, n1, n2).transpose(0, 1)
    w64 = functools.partial(modops.widen, bits=32)
    p = w64(t.p).view(m, 1, 1, 1)
    mbar = w64(t.mbar).view(m, 1, 1, 1)
    left_w, right_w = t.plain_planes
    lazy = nd == 4
    bad = torch.zeros((m, B), dtype=torch.bool, device=x.device)

    def check(v, bound):
        nonlocal bad
        if strict:
            bad = bad | (v >= bound).flatten(2).any(-1)

    def left(v, lz):        # F[r, c] = sum_k W[r, k] . v[k, c]
        # digits [m, B, k, b, c] -> [m, (b, k), (B, c)]
        d = _digits_plain(v, nd).permute(0, 3, 2, 1, 4).reshape(
            m, nd * n1, B * n2)
        g = torch.matmul(left_w, d).to(torch.int64)
        g = g.view(m, nd, n1, B, n2).permute(1, 0, 3, 2, 4)     # [a, m, B, r, c]
        corr = w64(t.corr1).view(m, 1, n1, 1)
        return _recombine_plain(list(g), p, mbar, corr, lz, nd)

    def right(v, lz):       # O[r, c] = sum_k v[r, k] . W[k, c]
        # digits [m, B, r, b, k] -> [m, (B, r), (b, k)]
        d = _digits_plain(v, nd).reshape(m, B * n1, nd * n2)
        g = torch.matmul(d, right_w).to(torch.int64)
        g = g.view(m, B, n1, nd, n2).permute(3, 0, 1, 2, 4)     # [a, m, B, r, c]
        corr = w64(t.corr2).view(m, 1, 1, n2)
        return _recombine_plain(list(g), p, mbar, corr, lz, nd)

    def twiddle(v):
        tw = w64(t.tw).view(m, 1, n1, n2)
        tws = w64(t.tws).view(m, 1, n1, n2)
        if nd == 2:
            y = (v * tw - ((v * tws) >> 16) * p) & _M32
            return torch.where(y >= p, y - p, y)
        return (v * tw - ((v * tws) >> 32) * p) & _M32

    mid = 2 * p if lazy else p
    if not inverse:
        X = left(X, lazy)
        check(X, mid)
        X = twiddle(X)
        check(X, mid)
        X = right(X, False)
    else:
        X = right(X, lazy)
        check(X, mid)
        X = twiddle(X)
        check(X, mid)
        X = left(X, False)
    check(X, p)
    if strict:
        X = torch.where(bad[:, :, None, None], torch.full_like(X, _M32), X)
    return modops.narrow(X.transpose(0, 1).reshape(B, m, n1 * n2), x.dtype)


def _as_batch(x, ring):
    m, n = ring.nmoduli, ring.degree
    if x.shape[-2:] != (m, n):
        raise ValueError(f"expected [..., {m}, {n}] residues, "
                         f"got {tuple(x.shape)}")
    return x.reshape(-1, m, n)


def ntt_pow_phi_fused_plain(x, ctx, tables: FusedTables | None = None):
    """Plain torch twin of the forward kernel, on any device."""
    ring = ctx.ring
    t = tables if tables is not None else fused_tables(ring, False, x.device)
    out = _fused_plain(_as_batch(x, ring), t, False, debug.strictmod_enabled())
    return out.reshape(x.shape)


def invntt_pow_invphi_fused_plain(x, ctx, tables: FusedTables | None = None):
    """Plain torch twin of the inverse kernel, on any device."""
    ring = ctx.ring
    t = tables if tables is not None else fused_tables(ring, True, x.device)
    out = _fused_plain(_as_batch(x, ring), t, True, debug.strictmod_enabled())
    return out.reshape(x.shape)


def _dispatch(kernel, plain, x, ctx, inverse):
    if x.device.type == "cpu":
        return plain(x, ctx)
    if x.device.type != "cuda":
        raise ValueError(f"no fused NTT for tensors on {x.device}")
    ring = ctx.ring
    xb = _as_batch(x, ring).contiguous()
    out = kernel(xb, fused_tables(ring, inverse, x.device),
                 debug.strictmod_enabled())
    return out.reshape(x.shape)


def ntt_pow_phi_fused(x, ctx):
    """Forward negacyclic transform; bit-identical to ops/ntt.py
    ntt_pow_phi.  CUDA tensor: the hand-written kernel; CPU tensor: the
    plain twin."""
    return _dispatch(_kernels.NTT_FUSED_FWD, ntt_pow_phi_fused_plain, x, ctx,
                     False)


def invntt_pow_invphi_fused(x, ctx):
    """Inverse negacyclic transform; bit-identical to ops/ntt.py
    invntt_pow_invphi.  CUDA tensor: the hand-written kernel; CPU tensor:
    the plain twin."""
    return _dispatch(_kernels.NTT_FUSED_INV, invntt_pow_invphi_fused_plain,
                     x, ctx, True)
