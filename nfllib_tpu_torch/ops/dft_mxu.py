"""Square mod-matmuls by per-channel [size, size] matrices for the u64 tier:
table builders, the CUDA kernel wrapper and its plain torch twin.

PyTorch port of the part of nfllib_tpu/ops/dft_mxu.py that the u64
large-degree NTT needs (ops/ntt_mxu_u64.py:_large_run64).  The numpy table
builders are ported as they are, so digit planes and correction vectors
are byte-equal to the JAX package's; the JAX kernel _kernel_u64 (with its
epilogue _pack_combine_u64) becomes csrc/dft_mxu64.cu.

  out = M @ X (axis -2, "left") or X @ M (axis -1, "right") mod p, per
  channel, for x [..., m, r, c] u64 residues and size 8..1024.

M decomposes into 8 UNSCALED balanced digit planes W_a; x into 8 offset
bytes d_b = byte_b - 128.  The 64 digit products fold into 15 group sums
G_k = sum_{a+b=k} W_a . d_b (|G_k| <= 8 * 128^2 * size <= 2^27), which are
biased, packed into two exact multi-word parts (groups 0..7 and 8..14),
reduced by Barrett with floor(2^124/p) and combined as
r_lo + shoup(r_hi, chi = 2^64 mod p) + corr, canonical.  corr folds the
offset-byte under-count and the pack bias over-count.

`matmul_mod` launches the kernel for a CUDA tensor and runs the twin
(`matmul_mod_plain`: the same math in int64, digit dots as exact float64
matmuls) for a CPU tensor.  The u32 tier (K9), the `twiddle=` epilogue,
pair I/O and the pipelined variant (K10) serve the distributed layer and
are not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _kernels
from ..ring import _np_mulmod_vec, canonical_device
from . import modops

# table-size cap: the digit planes of one [size, size] matrix per channel
_MAX_SIZE = {"u32": 1024, "u64": 1024}


def supports(ring, size: int) -> bool:
    return (ring.limb in _MAX_SIZE and 8 <= size <= _MAX_SIZE[ring.limb]
            and (size & (size - 1)) == 0)


def _ndig(limb):
    return 4 if limb == "u32" else 8


def _bias_bits(limb, size):
    """Per-PARTIAL bias: each (a, b) dot's |S_ab| <= 128^2 * size = 2^14 *
    size, so biasing every partial product by the next power of two keeps
    the pack additions nonnegative; the total over-count has the closed
    form bias * S^2 (S = sum_b 2^(8b)), folded into corr."""
    return int(np.ceil(np.log2(size))) + 14


def _balanced_digits_np(v, ndig):
    """uint64 [..., r, c] -> [ndig, ..., r, c] int8 balanced base-256 digits,
    fully vectorized (v < 2^63 - 2^56 so the carried top digit stays in
    int8 range).  The one copy: ntt_mxu and ntt_mxu_u64 use it too."""
    v = np.asarray(v, dtype=np.uint64)
    digs = []
    carry = np.zeros(v.shape, dtype=np.int64)
    for a in range(ndig - 1):
        u = ((v >> np.uint64(8 * a)) & np.uint64(0xFF)).astype(np.int64) \
            + carry
        carry = (u >= 128).astype(np.int64)
        digs.append(u - (carry << 8))
    digs.append((v >> np.uint64(8 * (ndig - 1))).astype(np.int64) + carry)
    out = np.stack(digs, axis=0)
    assert out.min() >= -128 and out.max() <= 127
    return out.astype(np.int8)


# Custom square mod-matmul matrices (the large-degree u64 NTT's Harvey-
# ordered DFT factors, ops/ntt_mxu_u64.py) plug in by name: a provider maps
# (ring, size) -> [m, size, size] uint64 matrices.
_MATRIX_PROVIDERS = {}


def register_matrix_provider(name: str, fn) -> None:
    _MATRIX_PROVIDERS[name] = fn


def _dft_matrix(ring, size, inverse):
    """Dense natural-order DFT matrices Wd[i, k] = r^(i*k) with
    r = omega^(n/size) (or its inverse), built column-iteratively with
    vectorized exact modmuls."""
    ctx = ring.context()
    n, m = ring.degree, ring.nmoduli
    mats = np.empty((m, size, size), dtype=np.uint64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        r = pow(ctx.omega_int[cm], n // size, p)
        if inverse:
            r = pow(r, -1, p)
        col0 = np.empty(size, dtype=np.uint64)
        acc = 1
        for i in range(size):
            col0[i] = acc
            acc = (acc * r) % p
        wd = mats[cm]
        wd[:, 0] = 1
        for k in range(1, size):
            wd[:, k] = _np_mulmod_vec(wd[:, k - 1], col0, p)
    return mats


register_matrix_provider("dft_fwd", lambda r, s: _dft_matrix(r, s, False))
register_matrix_provider("dft_inv", lambda r, s: _dft_matrix(r, s, True))


@functools.lru_cache(maxsize=None)
def _custom_tables(ring, provider: str, size: int, left: bool):
    """Per-(ring, provider, size, side) tables: balanced digit planes of
    the provider's matrices, the offset/bias correction vector (row sums
    for the left side, column sums for the right), and the u32 tier's
    recombination constants, which stay zero here: the u32 tier (K9) is
    not ported, and u64 keeps its constants in _u64_const_tables."""
    m = ring.nmoduli
    ndig = _ndig(ring.limb)
    bias = 1 << _bias_bits(ring.limb, size)
    S = sum(1 << (8 * b) for b in range(ndig))
    bias_sum = bias * S * S          # one bias per (a, b) partial product

    mats = _MATRIX_PROVIDERS[provider](ring, size)
    planes = np.empty((m, ndig, size, size), dtype=np.int8)
    corr = np.empty((m, size), dtype=np.uint64)
    consts = np.zeros((m, 4), dtype=np.uint64)

    for cm in range(m):
        p = int(ring.moduli[cm])
        wd = mats[cm]
        planes[cm] = _balanced_digits_np(wd, ndig)
        sums = wd.astype(object).sum(axis=1 if left else 0)
        corr[cm] = np.array(
            [((128 * S * int(v)) - bias_sum) % p for v in sums],
            dtype=np.uint64)
    return planes, corr, consts, bias, ndig


def _u64_const_tables(ring, ndig):
    """[m, 4] uint64 per-channel constants [p, floor(2^124/p), chi,
    chi_shoup] with chi = 2^(8*ndig) mod p (the JAX package's SMEM rows,
    as native words instead of hi/lo pairs)."""
    m = ring.nmoduli
    sm = np.zeros((m, 4), dtype=np.uint64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        chi = pow(2, 8 * ndig, p)
        sm[cm] = [p, (1 << 124) // p, chi, (chi << 64) // p]
    return sm


# ---------------------------------------------------------------------------
# The port's table object, on one device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DftTables:
    """One (provider, size, side)'s tables on one device, in the kernel's
    format:
      planes [m, size, size] int64: entry byte a is digit plane W_a (the
             kernel assembles each group's two dp4a words from them);
      corr [m, size]; consts [m, 4] = p, mbar, chi, chi_shoup (int64 bit
      patterns); bias = 2^_bias_bits."""
    size: int
    left: bool
    bias: int
    planes: torch.Tensor
    corr: torch.Tensor
    consts: torch.Tensor

    @property
    def m(self) -> int:
        return self.consts.shape[0]

    @property
    def device(self) -> torch.device:
        return self.consts.device

    @functools.cached_property
    def plain_planes(self):
        """[m, 8, size, size] float64 digit planes for the twin's dots."""
        shifts = torch.arange(8, device=self.device) * 8
        v = (self.planes[..., None] >> shifts) & 0xFF
        v = v - ((v >= 128).to(torch.int64) << 8)
        return v.permute(0, 3, 1, 2).to(torch.float64).contiguous()


def pack_digit_planes(planes: np.ndarray) -> np.ndarray:
    """[m, 8, r, c] int8 planes -> [m, r, c] int64 whose byte a is plane a."""
    return np.ascontiguousarray(planes.transpose(0, 2, 3, 1)).view(
        np.int64)[..., 0]


@functools.lru_cache(maxsize=None)
def _device_tables(ring, provider, size, left, device) -> DftTables:
    planes, corr, _, bias, ndig = _custom_tables(ring, provider, size, left)
    consts = _u64_const_tables(ring, ndig)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)
                                .copy()).to(device)
    return DftTables(size=size, left=left, bias=bias,
                     planes=put(pack_digit_planes(planes)), corr=put(corr),
                     consts=put(consts))


def dft_tables(ring, provider: str, size: int, left: bool, device):
    """The port's own tables for one mod-matmul, cached per device."""
    return _device_tables(ring, provider, size, bool(left),
                          canonical_device(device))


# ---------------------------------------------------------------------------
# Plain torch twin: the kernel's math in int64, digit dots as float64 matmuls
# ---------------------------------------------------------------------------

_NG = 15          # group sums of the u64 tier (2 * 8 digits - 1)


def _offset_digits(x):
    """int64 u64 words [...] -> [8, ...] float64 offset bytes byte_b - 128."""
    return torch.stack([((x >> (8 * b)) & 0xFF) - 128 for b in range(8)]
                       ).to(torch.float64)


def _pack_part(g):
    """Exact floor(v / 2^60) and v mod 2^64 of v = sum_k 2^(8k) g_k for 8
    nonnegative group values g_k < 2^28: the two 32-bit-aligned halves
    L = sum_{k<4}, H = sum_{k>=4} / 2^32 are each < 2^53."""
    lo = g[0] + (g[1] << 8) + (g[2] << 16) + (g[3] << 24)
    hi = g[4] + (g[5] << 8) + (g[6] << 16) + (g[7] << 24)
    return ((lo >> 32) + hi) >> 28, lo + (hi << 32)


def _pack_combine_plain(G, consts, corr, bias):
    """_pack_combine_u64 (twiddle=None, strict=True) on exact int64 group
    sums G[k]; consts/corr broadcast against them."""
    p, mbar, chi, chis = (consts[..., i] for i in range(4))
    nk = [min(k + 1, 2 * 8 - 1 - k, 8) for k in range(_NG)]
    g = [G[k] + nk[k] * bias for k in range(_NG)]
    g.append(torch.zeros_like(g[0]))           # pad part 1 to 8 groups
    rs = []
    for part in range(2):
        a60, v = _pack_part(g[8 * part:8 * part + 8])
        rs.append(v - modops.mulhi64(a60, mbar) * p)          # < 3p
    two_p = 2 * p
    r_lo = modops._sub_if_ge(rs[0], two_p, 64)
    r = r_lo + (rs[1] * chi - modops.mulhi64(rs[1], chis) * p)
    r = modops._sub_if_ge(r, two_p, 64)
    r = modops._sub_if_ge(r + corr, two_p, 64)
    return modops._sub_if_ge(r, p, 64)


def matmul_plain(x, t: DftTables):
    """The kernel's computation on contiguous [B, m, r, c] int64 residues."""
    B, m, r, c = x.shape
    size = t.size
    W = t.plain_planes                                       # [m, a, i, j]
    d = _offset_digits(x.transpose(0, 1))                    # [b, m, B, r, c]
    G = [None] * _NG
    if t.left:
        # P_a[i, (b, B, c)] = sum_j W_a[i, j] d_b[j, c]
        D = d.permute(1, 3, 0, 2, 4).reshape(m, size, 8 * B * c)
        for a in range(8):
            P = torch.matmul(W[:, a], D).to(torch.int64).view(m, r, 8, B, c)
            for b in range(8):
                k = a + b
                term = P[:, :, b].permute(2, 0, 1, 3)        # [B, m, r, c]
                G[k] = term if G[k] is None else G[k] + term
        corr = t.corr.view(1, m, r, 1)
    else:
        # P_a[(b, B, r), c] = sum_j d_b[r, j] W_a[j, c]
        D = d.permute(1, 0, 2, 3, 4).reshape(m, 8 * B * r, size)
        for a in range(8):
            P = torch.matmul(D, W[:, a]).to(torch.int64).view(m, 8, B, r, c)
            for b in range(8):
                k = a + b
                term = P[:, b].transpose(0, 1)               # [B, m, r, c]
                G[k] = term if G[k] is None else G[k] + term
        corr = t.corr.view(1, m, 1, c)
    consts = t.consts.view(1, m, 1, 1, 4)
    return _pack_combine_plain(G, consts, corr, t.bias)


def _check_args(x, ring, size, axis, twiddle, pair_out, pipelined):
    if ring.limb != "u64":
        raise NotImplementedError(
            "matmul_mod: the u32 tier is kernel K9 (dft_mxu._kernel_u32), "
            "not ported yet; it belongs to the distributed slice")
    if twiddle is not None or pair_out or pipelined or isinstance(x, tuple):
        raise NotImplementedError(
            "matmul_mod: the twiddle= epilogue, pair I/O and the pipelined "
            "kernel (K10) serve the distributed layer and are not ported yet")
    if axis not in (-1, -2):
        raise ValueError(f"axis must be -1 or -2, got {axis}")
    if not supports(ring, size):
        raise ValueError(f"no mod-matmul of size {size} for {ring}")
    r, c = x.shape[-2], x.shape[-1]
    if (r if axis == -2 else c) != size or x.shape[-3] != ring.nmoduli:
        raise ValueError(f"expected [..., {ring.nmoduli}, r, c] with the "
                         f"axis {axis} of length {size}, got {tuple(x.shape)}")


def matmul_mod_plain(x, ring, provider: str, size: int, *, axis: int,
                     tables: DftTables | None = None):
    """Plain torch twin of the kernel, on any device."""
    _check_args(x, ring, size, axis, None, False, None)
    t = tables if tables is not None else dft_tables(
        ring, provider, size, axis == -2, x.device)
    xb = x.reshape((-1,) + tuple(x.shape[-3:])).contiguous()
    return matmul_plain(xb, t).reshape(x.shape)


def matmul_mod(x, ring, provider: str, size: int, *, axis: int,
               twiddle=None, pair_out=False, pipelined=None):
    """Square mod-matmul by the provider's per-channel [size, size] matrix
    along `axis` (-2: left, M @ X contracting the row axis; -1: right,
    X @ M) of [..., m, r, c] u64 residues, canonical in and out.  CUDA
    tensor: the hand-written kernel; CPU tensor: the plain twin."""
    _check_args(x, ring, size, axis, twiddle, pair_out, pipelined)
    if x.device.type == "cpu":
        return matmul_mod_plain(x, ring, provider, size, axis=axis)
    if x.device.type != "cuda":
        raise ValueError(f"no mod-matmul for tensors on {x.device}")
    t = dft_tables(ring, provider, size, axis == -2, x.device)
    xb = x.reshape((-1,) + tuple(x.shape[-3:])).contiguous()
    return _kernels.DFT_MXU64(xb, t).reshape(x.shape)
