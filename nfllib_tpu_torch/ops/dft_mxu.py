"""Square mod-matmuls by per-channel [size, size] matrices (u32 and u64
tiers): table builders, the CUDA kernel wrappers and their plain torch twin.

PyTorch port of nfllib_tpu/ops/dft_mxu.py.  The numpy table builders are
ported as they are, so digit planes, correction vectors and constants are
byte-equal to the JAX package's.  The JAX kernels become hand-written CUDA
on one int8 tensor-core engine, csrc/digit_mma.cuh: _kernel_u64 (K5, with
its Shoup twiddle epilogue) csrc/dft_mxu64.cu at 8 digits, _kernel_u32 (K9)
csrc/dft_mxu32.cu, the same kernel at 4 digits, and _kernel_u64_pipe (K10)
csrc/dft_mxu64_pipe.cu.  The u64 NTT (ops/ntt_mxu_u64.py) runs as two
launches of K5 through `ntt_stage`.

  out = M @ X (axis -2, "left") or X @ M (axis -1, "right") mod p, per
  channel, for x [..., m, r, c] residues and size 8..1024.

M decomposes into ndig UNSCALED balanced digit planes W_a (ndig = 4 for
u32, 8 for u64); x into ndig offset bytes d_b = byte_b - 128.  The ndig^2
digit products fold into 2 ndig - 1 group sums
G_k = sum_{a+b=k} W_a . d_b (|G_k| <= ndig * 128^2 * size <= 2^27), which
are biased, packed into two exact parts (groups 0..ndig-1 and the rest) and
reduced by Barrett (u32: a28 = floor(v/2^28), q = mulhi32(a28,
floor(2^60/p)); u64: a60 = floor(v/2^60), q = mulhi64(a60, floor(2^124/p))),
then combined as r_lo + shoup(r_hi, chi = 2^(8 ndig) mod p) + corr.  corr
folds the offset-byte under-count and the pack bias over-count.  The
optional twiddle=(tw, tws) epilogue keeps the combine lazy (< 2p), takes
one lazy Shoup product by tw and reduces strictly, so the output is
canonical either way.

`matmul_mod` launches a kernel for a CUDA tensor and runs the twin
(`matmul_mod_plain`: the same math in int64, digit dots as exact float64
matmuls) for a CPU tensor; so does `ntt_stage`, which also takes sizes 2
and 4 and strict-mode poison.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from .. import _kernels
from ..ring import _np_mulmod_vec, canonical_device
from . import modops

# table-size cap: the digit planes of one [size, size] matrix per channel
_MAX_SIZE = {"u32": 1024, "u64": 1024}
_MMA_KC = 32      # k-chunk of the tensor-core loop (csrc/digit_mma.cuh)
_M32 = 0xFFFFFFFF


def supports(ring, size: int) -> bool:
    """Whether matmul_mod takes `size` (8..1024, as the JAX package's)."""
    return _size_ok(ring, size, 8)


def _size_ok(ring, size, least):
    """A power of two in least..1024 on a tier with a mod-matmul; the u64
    NTT's own stages (`ntt_stage`) take least=2."""
    return (ring.limb in _MAX_SIZE and least <= size <= _MAX_SIZE[ring.limb]
            and (size & (size - 1)) == 0)


def _ndig(limb):
    return 4 if limb == "u32" else 8


def _bias_bits(limb, size):
    """Per-PARTIAL bias: each (a, b) dot's |S_ab| <= 128^2 * size = 2^14 *
    size, so biasing every partial product by the next power of two keeps
    the pack additions nonnegative; the total over-count has the closed
    form bias * S^2 (S = sum_b 2^(8b)), folded into corr."""
    return int(np.ceil(np.log2(size))) + 14


def _nk(ndig):
    """Digit pairs (a, b) with a + b = k, for each group k."""
    return [min(k + 1, 2 * ndig - 1 - k, ndig) for k in range(2 * ndig - 1)]


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
# ordered DFT factors, ops/ntt_mxu_u64.py; the four-step column matrices
# with the phi twist folded in, parallel/ntt_dist.py) plug in by name: a
# provider maps (ring, size) -> [m, size, size] uint64 matrices.
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
    recombination constants [floor(2^60/p), chi, floor(chi 2^32/p)] with
    chi = 2^(8*ndig) mod p (zero for u64, which keeps its constants in
    _u64_const_tables)."""
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
        if ring.limb == "u32":
            chi = pow(2, 8 * ndig, p)           # 2^(8*ndig) mod p
            consts[cm, 0] = (1 << 60) // p
            consts[cm, 1] = chi
            consts[cm, 2] = (chi << 32) // p
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


def _kernel_consts(ring, consts):
    """The kernels' [m, 4] rows [p, mbar, chi, chi_shoup]: u64 from
    _u64_const_tables, u32 from _custom_tables' rows with p in front."""
    if ring.limb == "u64":
        return _u64_const_tables(ring, 8)
    p = np.array([int(q) for q in ring.moduli], dtype=np.uint64)
    return np.concatenate([p[:, None], consts[:, :3]], axis=1)


# ---------------------------------------------------------------------------
# The port's table object, on one device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DftTables:
    """One (provider, size, side)'s tables on one device, in the kernels'
    format:
      planes [m, size, size] int64 (u64, 8 digits) or int32 (u32, 4
             digits): entry byte a is digit plane W_a (the kernels read
             `mma_planes`, built from them on first use);
      corr [m, size] int64; consts [m, 4] int64 = p, mbar, chi, chi_shoup
      (u64: mbar = floor(2^124/p), chi_shoup = floor(chi 2^64/p); u32:
      mbar = floor(2^60/p), chi_shoup = floor(chi 2^32/p));
      bias = 2^_bias_bits."""
    size: int
    left: bool
    ndig: int
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

    @property
    def kp(self) -> int:
        """Row length of the kernels' K-major operand planes: size, padded
        to a whole k-chunk of the tensor-core loop."""
        return max(self.size, _MMA_KC)

    @functools.cached_property
    def mma_planes(self):
        """[m, ndig, kp / 32, size, 32] int8 digit planes, K-major for the
        side's operand of the tensor-core loop (csrc/digit_mma.cuh), cut
        into k-chunks of 32 and swizzled as the kernels stage them: byte
        (k % 32) ^ (16 ((o >> 2) & 1)) of [m][a][k // 32][o] is W_a[o][k]
        (left, as stored) or W_a[k][o] (right, transposed), zero for
        k >= size.  Built on the tables' device from `planes` (a byte view,
        permutes and the half swap)."""
        m, nd, size, kp = self.m, self.ndig, self.size, self.kp
        v = self.planes.view(torch.int8).view(m, size, size, nd)
        v = v.permute(0, 3, 1, 2) if self.left else v.permute(0, 3, 2, 1)
        out = torch.zeros((m, nd, size, kp), dtype=torch.int8,
                          device=self.device)
        out[..., :size] = v
        out = out.view(m, nd, size, kp // _MMA_KC, _MMA_KC).transpose(
            2, 3).contiguous()
        swap = ((torch.arange(size, device=self.device) >> 2) & 1).bool()
        halves = out.view(m, nd, kp // _MMA_KC, size, 2, _MMA_KC // 2)
        halves[:, :, :, swap] = halves[:, :, :, swap].flip(-2)
        return out

    @functools.cached_property
    def plain_planes(self):
        """[m, ndig, size, size] float64 digit planes for the twin's dots."""
        shifts = torch.arange(self.ndig, device=self.device) * 8
        v = (self.planes.to(torch.int64)[..., None] >> shifts) & 0xFF
        v = v - ((v >= 128).to(torch.int64) << 8)
        return v.permute(0, 3, 1, 2).to(torch.float64).contiguous()


def pack_digit_planes(planes: np.ndarray) -> np.ndarray:
    """[m, ndig, r, c] int8 planes -> [m, r, c] int64 (8 digits) or int32
    (4 digits) whose byte a is plane a."""
    word = np.int64 if planes.shape[1] == 8 else np.int32
    return np.ascontiguousarray(planes.transpose(0, 2, 3, 1)).view(
        word)[..., 0]


@functools.lru_cache(maxsize=None)
def _device_tables(ring, provider, size, left, device) -> DftTables:
    planes, corr, consts, bias, ndig = _custom_tables(ring, provider, size,
                                                      left)

    def put(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        return torch.from_numpy(a.copy()).to(device)
    return DftTables(size=size, left=left, ndig=ndig, bias=bias,
                     planes=put(pack_digit_planes(planes)), corr=put(corr),
                     consts=put(_kernel_consts(ring, consts)))


def dft_tables(ring, provider: str, size: int, left: bool, device):
    """The port's own tables for one mod-matmul, cached per device."""
    return _device_tables(ring, provider, size, bool(left),
                          canonical_device(device))


# ---------------------------------------------------------------------------
# Plain torch twin: the kernels' math in int64, digit dots as float64
# matmuls
# ---------------------------------------------------------------------------

_NG = 15          # group sums of the u64 tier (2 * 8 digits - 1)


def _offset_digits(x, ndig=8):
    """Residue words [...] (int64 u64 bit patterns, or int32 u32 storage)
    -> [ndig, ...] float64 offset bytes byte_b - 128."""
    x = x.to(torch.int64)
    return torch.stack([((x >> (8 * b)) & 0xFF) - 128 for b in range(ndig)]
                       ).to(torch.float64)


def _pack_part(g):
    """Exact floor(v / 2^60) and v mod 2^64 of v = sum_k 2^(8k) g_k for 8
    nonnegative group values g_k < 2^28: the two 32-bit-aligned halves
    L = sum_{k<4}, H = sum_{k>=4} / 2^32 are each < 2^53."""
    lo = g[0] + (g[1] << 8) + (g[2] << 16) + (g[3] << 24)
    hi = g[4] + (g[5] << 8) + (g[6] << 16) + (g[7] << 24)
    return ((lo >> 32) + hi) >> 28, lo + (hi << 32)


def _pack_combine_plain(G, consts, corr, bias, twiddle=None):
    """_pack_combine_u64 (strict=True) on exact int64 group sums G[k];
    consts/corr (and twiddle=(tw, tws)) broadcast against them.  With a
    twiddle the combine stays lazy (< 2p) before the lazy Shoup product."""
    p, mbar, chi, chis = (consts[..., i] for i in range(4))
    nk = _nk(8)
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
    if twiddle is not None:
        tw, tws = twiddle
        r = r * tw - modops.mulhi64(r, tws) * p                # < 2p
    return modops._sub_if_ge(r, p, 64)


def _pack_combine_plain32(G, consts, corr, bias, twiddle=None):
    """The JAX package's u32 pack and _combine_parts_u32 (strict=True) on
    exact group sums G[k] (k = 0..6), in int64 holding u32 words: each part
    v = sum_{k<4} 2^(8k) g_k is exact (< 2^51), a28 = floor(v/2^28),
    q = mulhi32(a28, floor(2^60/p)), part = (v mod 2^32) - q p < 3p.  With
    a twiddle the combine stays lazy (< 2p) before the lazy Shoup
    product."""
    p, m60, chi, chis = (consts[..., i] for i in range(4))
    nk = _nk(4)
    g = [G[k] + nk[k] * bias for k in range(7)]
    g.append(torch.zeros_like(g[0]))           # pad part 1 to 4 groups
    rs = []
    for part in range(2):
        g0, g1, g2, g3 = g[4 * part:4 * part + 4]
        v = g0 + (g1 << 8) + (g2 << 16) + (g3 << 24)
        q = modops.mulhi(v >> 28, m60, 32)
        rs.append(((v & _M32) - q * p) & _M32)                 # < 3p
    two_p = 2 * p
    r_lo = modops._sub_if_ge(rs[0], two_p)
    hi = (rs[1] * chi - modops.mulhi(rs[1], chis, 32) * p) & _M32   # < 2p
    r = modops._sub_if_ge(r_lo + hi, two_p)
    r = modops._sub_if_ge(r + corr, two_p)
    if twiddle is not None:
        tw, tws = (modops.widen(t, 32) for t in twiddle)
        r = (r * tw - modops.mulhi(r, tws, 32) * p) & _M32     # < 2p
    return modops._sub_if_ge(r, p)


def matmul_plain(x, t: DftTables, twiddle=None, strict=False):
    """The kernels' computation on contiguous [B, m, r, c] residues (int64
    u64 words or int32 u32 storage); twiddle=(tw, tws) [m, r, c] in the
    same storage.  strict: a (polynomial, channel) slab with an input or an
    output not below p comes out as all-ones words, as the kernels poison
    it."""
    B, m, r, c = x.shape
    size, nd = t.size, t.ndig
    ng = 2 * nd - 1
    W = t.plain_planes                                       # [m, a, i, j]
    d = _offset_digits(x.transpose(0, 1), nd)                # [b, m, B, r, c]
    G = [None] * ng
    if t.left:
        # P_a[i, (b, B, c)] = sum_j W_a[i, j] d_b[j, c]
        D = d.permute(1, 3, 0, 2, 4).reshape(m, size, nd * B * c)
        for a in range(nd):
            P = torch.matmul(W[:, a], D).to(torch.int64).view(m, r, nd, B, c)
            for b in range(nd):
                k = a + b
                term = P[:, :, b].permute(2, 0, 1, 3)        # [B, m, r, c]
                G[k] = term if G[k] is None else G[k] + term
        corr = t.corr.view(1, m, r, 1)
    else:
        # P_a[(b, B, r), c] = sum_j d_b[r, j] W_a[j, c]
        D = d.permute(1, 0, 2, 3, 4).reshape(m, nd * B * r, size)
        for a in range(nd):
            P = torch.matmul(D, W[:, a]).to(torch.int64).view(m, nd, B, r, c)
            for b in range(nd):
                k = a + b
                term = P[:, b].transpose(0, 1)               # [B, m, r, c]
                G[k] = term if G[k] is None else G[k] + term
        corr = t.corr.view(1, m, 1, c)
    consts = t.consts.view(1, m, 1, 1, 4)
    if nd == 8:
        out = _pack_combine_plain(G, consts, corr, t.bias, twiddle)
    else:
        out = _pack_combine_plain32(G, consts, corr, t.bias, twiddle)
    if strict:
        p = t.consts[:, 0].view(1, m, 1, 1)
        bad = modops.uge(modops.widen(x, 8 * nd), p) | modops.uge(out, p)
        out = torch.where(bad.flatten(2).any(-1)[..., None, None],
                          torch.full_like(out, -1), out)
    return out if nd == 8 else out.to(torch.int32)


# ---------------------------------------------------------------------------
# Pair I/O: the JAX package's uint32 (hi, lo) planes, merged and split at
# the edges of a call (the kernels read and write native 64-bit words)
# ---------------------------------------------------------------------------

def merge_pair(pair):
    """(hi, lo) int32 tensors holding u32 words -> int64 u64 words."""
    hi, lo = pair
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & _M32)


def split_pair(x):
    """int64 u64 words -> (hi, lo) int32 tensors holding u32 words."""
    return (x >> 32).to(torch.int32), x.to(torch.int32)


def pipe_default() -> bool:
    """NFL_TORCH_DFT_PIPE (the port's NFL_TPU_DFT_PIPE), read at call time:
    "1" sends u64 mod-matmuls to the pipelined kernel K10; off by
    default."""
    return os.environ.get("NFL_TORCH_DFT_PIPE", "0") == "1"


def _check_args(xs, ring, size, axis, twiddle, pair, pipelined, least=8):
    if ring.limb not in _MAX_SIZE:
        raise ValueError(f"matmul_mod: no mod-matmul for the {ring.limb} "
                         f"tier (u32 and u64 only)")
    if ring.limb != "u64" and (pair or pipelined):
        raise ValueError("matmul_mod: pair I/O and the pipelined kernel are "
                         "u64-tier features")
    if axis not in (-1, -2):
        raise ValueError(f"axis must be -1 or -2, got {axis}")
    if not _size_ok(ring, size, least):
        raise ValueError(f"no mod-matmul of size {size} for {ring}")
    r, c = xs.shape[-2], xs.shape[-1]
    if (r if axis == -2 else c) != size or xs.shape[-3] != ring.nmoduli:
        raise ValueError(f"expected [..., {ring.nmoduli}, r, c] with the "
                         f"axis {axis} of length {size}, got {tuple(xs.shape)}")
    if xs.dtype != ring.torch_dtype:
        raise ValueError(f"expected {ring.torch_dtype} residues, got "
                         f"{xs.dtype}")
    if twiddle is not None:
        for tw in twiddle:
            if (tuple(tw.shape) != (ring.nmoduli, r, c)
                    or tw.dtype != xs.dtype or tw.device != xs.device):
                raise ValueError(
                    f"twiddle: expected {xs.dtype} [{ring.nmoduli}, {r}, "
                    f"{c}] on {xs.device}, got {tw.dtype} "
                    f"{tuple(tw.shape)} on {tw.device}")


def _run(xs, ring, provider, size, axis, twiddle, pipelined, strict,
         plain):
    """The checked call: the twin for a CPU tensor (or `plain`), else the
    kernel (K9 for u32, K5 or its epilogue for u64, K10 when pipelined)."""
    t = dft_tables(ring, provider, size, axis == -2, xs.device)
    xb = xs.reshape((-1,) + tuple(xs.shape[-3:])).contiguous()
    if plain or xs.device.type == "cpu":
        out = matmul_plain(xb, t, twiddle, strict)
    elif xs.device.type == "cuda":
        tw = None if twiddle is None else tuple(
            v.contiguous() for v in twiddle)
        if ring.limb == "u32":
            kern = _kernels.DFT_MXU32
        elif pipelined:
            kern = _kernels.DFT_MXU64_PIPE
        else:
            kern = _kernels.DFT_MXU64 if tw is None \
                else _kernels.DFT_MXU64_TW
        out = kern(xb, t, tw, strict=strict)
    else:
        raise ValueError(f"no mod-matmul for tensors on {xs.device}")
    return out.reshape(xs.shape)


def matmul_mod_plain(x, ring, provider: str, size: int, *, axis: int,
                     twiddle=None):
    """Plain torch twin of the kernels, on any device (the twin of K10 is
    K5's)."""
    _check_args(x, ring, size, axis, twiddle, False, False)
    return _run(x, ring, provider, size, axis, twiddle, False, False, True)


def matmul_mod(x, ring, provider: str, size: int, *, axis: int,
               twiddle=None, pair_out=False, pipelined=None):
    """Square mod-matmul by the provider's per-channel [size, size] matrix
    along `axis` (-2: left, M @ X contracting the row axis; -1: right,
    X @ M) of [..., m, r, c] u32 (int32 storage) or u64 (int64) residues,
    canonical in and out.  CUDA tensor: the hand-written kernel (K9 for
    u32, K5 for u64, K10 when pipelined); CPU tensor: the plain twin.

    twiddle=(tw, tws): the Shoup-multiply epilogue, out * tw mod p with
    tws = floor(tw 2^w / p); tw/tws are [m, r, c] tensors in the residues'
    storage, on their device, canonical.

    Pair I/O (u64 only): x may be an (xh, xl) tuple of int32 tensors
    holding the u32 halves, and pair_out=True returns (oh, ol).  It keeps
    the JAX package's surface, where Mosaic has no u64 and its kernels
    speak hi/lo planes; here the kernels read and write native 64-bit words
    and the pairs are merged and split at the edges of the call only.

    pipelined (u64 only): None reads NFL_TORCH_DFT_PIPE (off by default);
    True runs K10, K5's warp-specialised variant, bit-identical to K5."""
    pair_in = isinstance(x, tuple)
    xs = merge_pair(x) if pair_in else x
    if pipelined is None:
        pipelined = ring.limb == "u64" and pipe_default()
    _check_args(xs, ring, size, axis, twiddle, pair_in or pair_out,
                pipelined)
    out = _run(xs, ring, provider, size, axis, twiddle, pipelined, False,
               False)
    return split_pair(out) if pair_out else out


def ntt_stage(x, ring, provider: str, size: int, *, axis: int,
              twiddle=None, strict=False, plain=False):
    """One mod-matmul of the u64 NTT (ops/ntt_mxu_u64.py:_large_run64):
    matmul_mod's kernels (K5, its epilogue, K10 under NFL_TORCH_DFT_PIPE)
    for a CUDA tensor, the twin for a CPU tensor or when `plain`.  Unlike
    matmul_mod it takes sizes 2 and 4 (the NTT's degrees 8..32: the
    kernels pad the contraction to one k-chunk with zero digits), and
    strict=True poisons a (polynomial, channel) slab with an input or an
    output not below p, kernel and twin alike, so a poisoned block stays
    poisoned through the next stage."""
    pipelined = ring.limb == "u64" and pipe_default()
    _check_args(x, ring, size, axis, twiddle, False, pipelined, least=2)
    return _run(x, ring, provider, size, axis, twiddle, pipelined, strict,
                plain)


def dft_along(x, ring, size: int, *, axis: int, inverse: bool = False,
              pair_out=False):
    """Size-`size` natural-order DFT (root omega^(n/size), or its inverse)
    along `axis` (-1: row stage, -2: column stage) of [..., m, r, c].
    Bit-identical to parallel/ntt_dist._dft_lastaxis's math."""
    provider = "dft_inv" if inverse else "dft_fwd"
    return matmul_mod(x, ring, provider, size, axis=axis, pair_out=pair_out)
