"""Elementwise modular arithmetic on residue tensors (plain torch).

PyTorch port of nfllib_tpu/ops/modops.py for every limb tier (reference
include/nfl/ops.hpp:100-242, include/nfl/opt/ops.hpp:7-78).

Conventions:
  * Operands are storage tensors (int16 for u16, int32 for u32, int64 for
    u64) holding the unsigned limb bit pattern; results come back in the
    first operand's storage dtype.  Table operands may also be int64
    tensors (RingContext.to).
  * u16/u32: arithmetic widens to int64 and masks to the limb width, which
    reproduces the reference's wrapping word arithmetic.  Products of
    canonical residues (< 2^31 * 2^32) fit int64, so `%` and floor division
    are exact and give the same values as the JAX package's Barrett and
    16-bit-split formulations, which are TPU workarounds and not ported.
  * u64: nothing wider than int64 exists, so the 62-bit tier runs the
    reference's own word algorithms (Newton-quotient mulmod, Shoup,
    compute_shoup via floor(2^125/p)) on int64 tensors read as unsigned:
    add, subtract and the low word of a product wrap modulo 2^64 in
    two's complement (tests pin this), comparisons go through `uge`/`ult`
    (flip the sign bit), right shifts through `srl` (shift, then mask), and
    `mulhi64` builds the high word from 32 x 16-bit pieces whose products
    fit int64.  Values >= 2^63 (Shoup companions, the butterfly's t1 < 4p,
    the strict-mode poison) read negative.
  * p is an int64 tensor broadcasting against the data ([m, 1]).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import debug

_BITS = {torch.int16: 16, torch.int32: 32, torch.int64: 64}
_NP_BITS = {np.dtype(np.uint16): 16, np.dtype(np.uint32): 32,
            np.dtype(np.uint64): 64}
_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)          # the int64 bit pattern 0x8000_0000_0000_0000


def limb_bits(dtype: torch.dtype) -> int:
    """Limb width of a storage dtype (16, 32 or 64)."""
    bits = _BITS.get(dtype)
    if bits is None:
        raise TypeError(f"not a residue storage dtype: {dtype}")
    return bits


def repr_bits(dtype) -> int:
    """Limb width of a residue dtype: a storage dtype (torch.int16 / int32
    / int64) or an unsigned limb dtype (numpy uint16 / uint32 / uint64, the
    JAX package's)."""
    if isinstance(dtype, torch.dtype):
        return limb_bits(dtype)
    bits = _NP_BITS.get(np.dtype(dtype))
    if bits is None:
        raise TypeError(f"not a limb dtype: {dtype}")
    return bits


def widen(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Storage (or int64) tensor -> int64 unsigned limb values (u64: the
    bit pattern itself)."""
    if bits == 64:
        return x.to(torch.int64)
    return x.to(torch.int64) & ((1 << bits) - 1)


def narrow(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values in [0, 2^bits) -> storage dtype (wrapping cast)."""
    return v.to(dtype)


# ---------------------------------------------------------------------------
# unsigned 64-bit helpers on int64 tensors
# ---------------------------------------------------------------------------

def uge(a, b):
    """a >= b for int64 tensors read as unsigned 64-bit words."""
    return (a ^ _SIGN) >= (b ^ _SIGN)


def ult(a, b):
    """a < b, unsigned."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def srl(x, k: int):
    """Logical right shift by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mul32(a, b):
    """(hi, lo) 32-bit words of a * b for a, b in [0, 2^32): b splits into
    16-bit halves so each partial product stays under 2^48."""
    t0 = a * (b & 0xFFFF)
    t1 = a * (b >> 16)
    s = t0 + ((t1 & 0xFFFF) << 16)
    return (t1 >> 16) + (s >> 32), s & _M32


def mul128(x, y):
    """(hi, lo) 64-bit words of the full unsigned product x * y."""
    x0, x1 = x & _M32, srl(x, 32)
    y0, y1 = y & _M32, srl(y, 32)
    llh, lll = _mul32(x0, y0)
    lhh, lhl = _mul32(x0, y1)
    hlh, hll = _mul32(x1, y0)
    hhh, hhl = _mul32(x1, y1)
    mid = llh + lhl + hll                            # < 3 * 2^32
    lo = ((mid & _M32) << 32) | lll
    s = hhl + lhh + hlh + (mid >> 32)                # < 2^35
    hi = ((hhh + (s >> 32)) << 32) | (s & _M32)
    return hi, lo


def mulhi64(x, y):
    """High 64 bits of the unsigned product."""
    return mul128(x, y)[0]


def mullo64(x, y):
    """Low 64 bits of the product: int64 `*` wraps modulo 2^64."""
    return x * y


def mulhi(x: torch.Tensor, y: torch.Tensor, bits: int) -> torch.Tensor:
    """High word of the full product of two widened limb values.  u32 splits
    x into 16-bit halves so every partial product stays under 2^49."""
    if bits == 16:
        return (x * y) >> 16
    if bits == 64:
        return mulhi64(x, y)
    return (((x >> 16) * y) + (((x & 0xFFFF) * y) >> 16)) >> 16


def _sub_if_ge(z: torch.Tensor, p: torch.Tensor, bits: int = 32):
    if bits == 64:
        return torch.where(uge(z, p), z - p, z)
    return torch.where(z >= p, z - p, z)


def shoup_f(p: torch.Tensor) -> torch.Tensor:
    """floor(2^125 / p) per modulus (u64 compute_shoup's Barrett constant),
    from p's values on the host; RingContext.to carries it as `shoup_f`."""
    vals = [int(v) for v in p.reshape(-1).tolist()]
    f = [((1 << 125) // v) for v in vals]
    f = [v - (1 << 64) if v >= (1 << 63) else v for v in f]
    return torch.tensor(f, dtype=torch.int64,
                        device=p.device).reshape(p.shape)


# ---------------------------------------------------------------------------
# the functors (reference ops.hpp semantics)
# ---------------------------------------------------------------------------

def addmod(x, y, p):
    """x + y mod p, assuming x, y < p (reference ops.hpp:124-135)."""
    debug.op_check(p, x, y)
    bits = limb_bits(x.dtype)
    if bits == 64:
        return _sub_if_ge(x + y, p, 64)
    z = (widen(x, bits) + widen(y, bits)) & ((1 << bits) - 1)
    return narrow(_sub_if_ge(z, p), x.dtype)


def submod(x, y, p):
    """x - y mod p, assuming x, y < p (reference ops.hpp:141-151)."""
    debug.op_check(p, x, y)
    bits = limb_bits(x.dtype)
    if bits == 64:
        return _sub_if_ge(x + (p - y), p, 64)
    mask = (1 << bits) - 1
    z = (widen(x, bits) + ((p - widen(y, bits)) & mask)) & mask
    return narrow(_sub_if_ge(z, p), x.dtype)


def eqmod(x, y):
    return x == y


def neqmod(x, y):
    return x != y


def _mulmod64(x, y, p, pn):
    """Newton-quotient reduction (reference ops.hpp:201-219)."""
    hi, lo = mul128(x, y)
    # q = Pn * (res >> 64) + (res << 2), keep only q >> 64
    s_hi = (hi << 2) | srl(lo, 62)
    s_lo = lo << 2
    q_lo = pn * hi + s_lo
    q_hi = mulhi64(pn, hi) + s_hi + ult(q_lo, s_lo).to(torch.int64)
    return _sub_if_ge(lo - q_hi * p, p, 64)


def mulmod(x, y, p, pn=None):
    """x * y mod p (reference ops.hpp:183-219); `pn` is the u64 tier's
    Newton quotient (RingContext.pn_col)."""
    debug.op_check(p, x, y)
    bits = limb_bits(x.dtype)
    if bits == 64:
        if pn is None:
            raise ValueError("mulmod on u64 residues needs the Newton "
                             "quotient pn")
        return _mulmod64(x, y, p, pn)
    return narrow((widen(x, bits) * widen(y, bits)) % p, x.dtype)


def compute_shoup(y, p, f=None):
    """floor((y mod p) * 2^w / p) for Shoup multiplication (reference
    ops.hpp:165-177); exact for every word value y.  u32/u64 companions
    reach 2^w - 1, so they read negative in storage.  u64 uses the Barrett
    constant f = floor(2^125 / p) (`shoup_f(p)` when not given)."""
    bits = limb_bits(y.dtype)
    if bits != 64:
        return narrow(((widen(y, bits) % p) << bits) // p, y.dtype)
    if f is None:
        f = shoup_f(p)
    # reduce y mod p: qy = floor(y*F/2^125) >= floor(y/p) - 2, so yr < 3p
    qy = srl(mulhi64(y, f), 61)
    yr = y - qy * p
    yr = _sub_if_ge(_sub_if_ge(yr, p, 64), p, 64)
    # q = floor(yr * 2^64 / p): qhat = floor(yr*F/2^61) in [q-3, q], so
    # r = yr*2^64 - qhat*p < 4p < 2^64, exact in wrapping words as -qhat*p
    hi, lo = mul128(yr, f)
    qhat = (hi << 3) | srl(lo, 61)
    r = -(qhat * p)
    for _ in range(3):
        ge = uge(r, p)
        r = torch.where(ge, r - p, r)
        qhat = qhat + ge.to(torch.int64)
    return qhat


def mulmod_shoup(x, y, yprime, p):
    """x * y mod p with precomputed yprime = floor(y 2^w / p) (reference
    ops.hpp:225-242): q = hi(x * yprime); r = x*y - q*p in wrapping word
    arithmetic; one conditional subtract."""
    debug.op_check(p, x, y)
    bits = limb_bits(x.dtype)
    return narrow(_sub_if_ge(_shoup_lazy(x, y, yprime, p), p, bits), x.dtype)


def mulmod_shoup_lazy(x, y, yprime, p):
    """Same as mulmod_shoup without the final correction: result in [0, 2p)."""
    return narrow(_shoup_lazy(x, y, yprime, p), x.dtype)


def _shoup_lazy(x, y, yprime, p):
    bits = limb_bits(x.dtype)
    if bits == 64:
        return x * y - mulhi64(x, yprime.to(torch.int64)) * p
    xw = widen(x, bits)
    q = mulhi(xw, widen(yprime, bits), bits)
    return (xw * widen(y, bits) - q * p) & ((1 << bits) - 1)


def muladd(rop, x, y, p, pn=None):
    """rop + x*y mod p (reference opt/ops.hpp:7-48)."""
    debug.op_check(p, rop, x, y)
    bits = limb_bits(x.dtype)
    if bits == 64:
        return _sub_if_ge(mulmod(x, y, p, pn) + rop, p, 64)
    r = ((widen(x, bits) * widen(y, bits)) % p + widen(rop, bits)) \
        & ((1 << bits) - 1)
    return narrow(_sub_if_ge(r, p), x.dtype)


def muladd_shoup(rop, x, y, yprime, p):
    """rop + x*y mod p via Shoup (reference opt/ops.hpp:54-78)."""
    debug.op_check(p, rop, x, y)
    bits = limb_bits(x.dtype)
    if bits == 64:
        return _sub_if_ge(rop + _shoup_lazy(x, y, yprime, p), p, 64)
    xw = widen(x, bits)
    q = mulhi(xw, widen(yprime, bits), bits)
    r = (widen(rop, bits) + xw * widen(y, bits) - q * p) & ((1 << bits) - 1)
    return narrow(_sub_if_ge(r, p), x.dtype)


def reduce_once(x, p):
    """One conditional subtract: maps [0, 2p) -> [0, p)."""
    bits = limb_bits(x.dtype)
    return narrow(_sub_if_ge(widen(x, bits), p, bits), x.dtype)
