"""Elementwise modular arithmetic on residue tensors (plain torch).

PyTorch port of nfllib_tpu/ops/modops.py for the u16 and u32 tiers
(reference include/nfl/ops.hpp:100-242, include/nfl/opt/ops.hpp:7-78).

Conventions:
  * Operands are storage tensors (int16 for u16, int32 for u32) holding the
    unsigned limb bit pattern; results come back in the first operand's
    storage dtype.  Table operands may also be int64 tensors of widened
    values (RingContext.to).
  * Arithmetic widens to int64 and masks to the limb width, which
    reproduces the reference's wrapping word arithmetic.  Products of
    canonical residues (< 2^31 * 2^32) fit int64, so `%` and floor division
    are exact and give the same values as the JAX package's Barrett and
    16-bit-split formulations, which are TPU workarounds and not ported.
  * p is an int64 tensor broadcasting against the data ([m, 1]).
  * The u64 tier raises NotImplementedError.
"""
from __future__ import annotations

import torch

from .. import debug

_BITS = {torch.int16: 16, torch.int32: 32}


def limb_bits(dtype: torch.dtype) -> int:
    """Limb width of a storage dtype (16 or 32)."""
    bits = _BITS.get(dtype)
    if bits is None:
        if dtype == torch.int64:
            raise NotImplementedError(
                "nfllib_tpu_torch: the u64 limb tier is not ported yet "
                "(its slice follows LWE in ROADMAP.md)")
        raise TypeError(f"not a residue storage dtype: {dtype}")
    return bits


def widen(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Storage (or int64) tensor -> int64 unsigned limb values."""
    return x.to(torch.int64) & ((1 << bits) - 1)


def narrow(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values in [0, 2^bits) -> storage dtype (wrapping cast)."""
    return v.to(dtype)


def mulhi(x: torch.Tensor, y: torch.Tensor, bits: int) -> torch.Tensor:
    """High word of the full product of two widened limb values.  u32 splits
    x into 16-bit halves so every partial product stays under 2^49."""
    if bits == 16:
        return (x * y) >> 16
    return (((x >> 16) * y) + (((x & 0xFFFF) * y) >> 16)) >> 16


def _sub_if_ge(z: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= p, z - p, z)


def addmod(x, y, p):
    """x + y mod p, assuming x, y < p (reference ops.hpp:124-135)."""
    debug.op_check(p, x, y)
    bits = limb_bits(x.dtype)
    z = (widen(x, bits) + widen(y, bits)) & ((1 << bits) - 1)
    return narrow(_sub_if_ge(z, p), x.dtype)


def submod(x, y, p):
    """x - y mod p, assuming x, y < p (reference ops.hpp:141-151)."""
    debug.op_check(p, x, y)
    bits = limb_bits(x.dtype)
    mask = (1 << bits) - 1
    z = (widen(x, bits) + ((p - widen(y, bits)) & mask)) & mask
    return narrow(_sub_if_ge(z, p), x.dtype)


def mulmod(x, y, p, pn=None):
    """x * y mod p (reference ops.hpp:183-219); `pn` is the u64 tier's
    Newton quotient, unused here."""
    debug.op_check(p, x, y)
    bits = limb_bits(x.dtype)
    return narrow((widen(x, bits) * widen(y, bits)) % p, x.dtype)


def compute_shoup(y, p):
    """floor((y mod p) * 2^w / p) for Shoup multiplication (reference
    ops.hpp:165-177); exact for every word value y.  u32 companions reach
    2^32 - 1, so they read negative in int32 storage."""
    bits = limb_bits(y.dtype)
    return narrow(((widen(y, bits) % p) << bits) // p, y.dtype)


def mulmod_shoup(x, y, yprime, p):
    """x * y mod p with precomputed yprime = floor(y 2^w / p) (reference
    ops.hpp:225-242): q = hi(x * yprime); r = x*y - q*p in wrapping word
    arithmetic; one conditional subtract."""
    debug.op_check(p, x, y)
    return narrow(_sub_if_ge(_shoup_lazy(x, y, yprime, p), p), x.dtype)


def mulmod_shoup_lazy(x, y, yprime, p):
    """Same as mulmod_shoup without the final correction: result in [0, 2p)."""
    return narrow(_shoup_lazy(x, y, yprime, p), x.dtype)


def _shoup_lazy(x, y, yprime, p):
    bits = limb_bits(x.dtype)
    xw = widen(x, bits)
    q = mulhi(xw, widen(yprime, bits), bits)
    return (xw * widen(y, bits) - q * p) & ((1 << bits) - 1)


def muladd(rop, x, y, p, pn=None):
    """rop + x*y mod p (reference opt/ops.hpp:7-48)."""
    debug.op_check(p, rop, x, y)
    bits = limb_bits(x.dtype)
    r = ((widen(x, bits) * widen(y, bits)) % p + widen(rop, bits)) \
        & ((1 << bits) - 1)
    return narrow(_sub_if_ge(r, p), x.dtype)


def muladd_shoup(rop, x, y, yprime, p):
    """rop + x*y mod p via Shoup (reference opt/ops.hpp:54-78)."""
    debug.op_check(p, rop, x, y)
    bits = limb_bits(x.dtype)
    xw = widen(x, bits)
    q = mulhi(xw, widen(yprime, bits), bits)
    r = (widen(rop, bits) + xw * widen(y, bits) - q * p) & ((1 << bits) - 1)
    return narrow(_sub_if_ge(r, p), x.dtype)


def reduce_once(x, p):
    """One conditional subtract: maps [0, 2p) -> [0, p)."""
    bits = limb_bits(x.dtype)
    return narrow(_sub_if_ge(widen(x, bits), p), x.dtype)
