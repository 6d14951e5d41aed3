"""Elementwise u64 Shoup multiply by a [m, R, C] twiddle: the CUDA kernel
K11 (csrc/pair_bridge.cu) and its plain torch twin.

PyTorch port of nfllib_tpu/ops/pair_bridge.py, whose Pallas kernel
_kernel multiplies uint32 hi/lo pair planes (Mosaic has no u64) and which
the JAX package keeps as a tested capability that production does not
dispatch: its large-degree and distributed paths use the plain
modops.mulmod_shoup; the port's take the twiddle in K5's epilogue
(ops/ntt_mxu.py:_route, parallel/ntt_dist.py).  chip_smoke.py measures the
kernel against the plain twiddle and against that epilogue.

The surface is the JAX package's: `mulmod_shoup_pairs` on (hi, lo) int32
pairs, `mulmod_shoup_u64` on int64 u64 words, `supports_shape` (the JAX
kernel's block constraint, kept so both packages accept the same shapes)
and `_p_pairs`.  The kernel reads native 64-bit words; pairs are merged and
split at the edges of the call.  Canonical output, bit-identical to
modops.mulmod_shoup: q = hi(x * tws); r = x * tw - q * p; one conditional
subtraction.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from ..ring import canonical_device
from . import dft_mxu, modops


def supports_shape(R: int, C: int) -> bool:
    """The JAX kernel's block constraint: full-C rows with an 8-aligned row
    block."""
    return C % 128 == 0 and R % 8 == 0


@functools.lru_cache(maxsize=None)
def _p_pairs(ring):
    p = np.array([int(q) for q in ring.moduli], dtype=np.uint64)
    return ((p >> np.uint64(32)).astype(np.uint32).reshape(-1, 1, 1),
            (p & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(-1, 1, 1))


@functools.lru_cache(maxsize=None)
def _p_words(ring, device):
    """[m] int64 moduli on `device`, the kernel's p."""
    p = np.array([int(q) for q in ring.moduli], dtype=np.uint64)
    return torch.from_numpy(p.view(np.int64).copy()).to(device)


def mulmod_shoup_u64_plain(x, tw, tws, ring):
    """The kernel's math in plain torch on any device: int64 u64 words
    [..., m, R, C], tw/tws [m, R, C]."""
    p3 = _p_words(ring, canonical_device(x.device)).view(-1, 1, 1)
    return modops.mulmod_shoup(x, tw, tws, p3)


def _check(x, tw, tws, ring):
    m, R, C = x.shape[-3:]
    if not supports_shape(R, C):
        raise ValueError(f"pair bridge: no block for R={R}, C={C} "
                         f"(R % 8 == 0 and C % 128 == 0)")
    if ring.limb != "u64" or m != ring.nmoduli or x.dtype != torch.int64:
        raise ValueError(f"pair bridge: expected int64 u64 residues "
                         f"[..., {ring.nmoduli}, R, C] of {ring}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    for t in (tw, tws):
        if tuple(t.shape) != (m, R, C) or t.dtype != torch.int64:
            raise ValueError(f"pair bridge: twiddle must be int64 "
                             f"[{m}, {R}, {C}], got {t.dtype} "
                             f"{tuple(t.shape)}")


def mulmod_shoup_u64(x, tw, tws, ring):
    """u64-facing drop-in for modops.mulmod_shoup on [..., m, R, C] int64
    residues with [m, R, C] tw / tws = floor(tw 2^64 / p).  CUDA tensor:
    K11; CPU tensor: the plain twin."""
    _check(x, tw, tws, ring)
    if x.device.type == "cpu":
        return mulmod_shoup_u64_plain(x, tw, tws, ring)
    if x.device.type != "cuda":
        raise ValueError(f"no pair bridge for tensors on {x.device}")
    m, R, C = x.shape[-3:]
    xb = x.reshape(-1, m, R, C).contiguous()
    out = _kernels.PAIR_BRIDGE64(xb, tw.contiguous(), tws.contiguous(),
                                 _p_words(ring, canonical_device(x.device)))
    return out.reshape(x.shape)


def mulmod_shoup_pairs(xp, twp, twsp, ring):
    """Canonical x * tw mod p on (hi, lo) int32 pairs holding u32 words:
    xp [..., m, R, C], twp/twsp [m, R, C] (tws = floor(tw 2^64 / p)).
    Returns the (oh, ol) pair, bit-identical to modops.mulmod_shoup on the
    merged u64 words."""
    out = mulmod_shoup_u64(dft_mxu.merge_pair(xp), dft_mxu.merge_pair(twp),
                           dft_mxu.merge_pair(twsp), ring)
    return dft_mxu.split_pair(out)
