"""MPFR-exact Gaussian barrier computation via ctypes on libmpfr.

A copy of nfllib_tpu/prng/mpfr_barriers.py (which imports nothing of JAX),
kept in the port so that the port never imports the JAX package.

The reference computes its CDF "barrier" integers with MPFR at working
precision `bit_precision`, rounding to nearest after *every* operation
(reference include/nfl/prng/FastGaussianNoise.hpp:296-368 and the
1/(2 sigma^2) precompute at :282-286).  Those intermediate roundings
accumulate, so the barrier integers are not the exactly-rounded mathematical
values — they are whatever MPFR's specific op sequence produces.  To be
bit-identical (the "same keystream => same outputs" contract), we replay the
exact same op sequence against the same library:

    _const_sigma = 1 / (2 * sigma^2)            [set_d, sqr, mul_ui, ui_div]
    for i in 0..nb-1:
        tmp = exp(-(i + lo - center)^2 * _const_sigma)   [sub, sqr, neg, mul, exp]
        bar[i] = bar[i-1] + tmp; sum += tmp
    sum = (2^prec - 1) / sum                     [ui_div, set_ui, pow_ui, sub_ui, mul]
    barriers[i] = round_to_int(bar[i] * sum)     [mul, get_z]

Every step at precision `bit_precision`, MPFR_RNDN, except `_center` which
the reference creates with mpfr_init_set_d at MPFR's default precision (53).

Falls back to None when libmpfr/libgmp are not loadable; callers then use
the mpmath approximation (documented as potentially off in the final ulps).
"""
from __future__ import annotations

import ctypes
import ctypes.util


class _MpfrT(ctypes.Structure):
    _fields_ = [
        ("_mpfr_prec", ctypes.c_long),
        ("_mpfr_sign", ctypes.c_int),
        ("_mpfr_exp", ctypes.c_long),
        ("_mpfr_d", ctypes.c_void_p),
    ]


class _MpzT(ctypes.Structure):
    _fields_ = [
        ("_mp_alloc", ctypes.c_int),
        ("_mp_size", ctypes.c_int),
        ("_mp_d", ctypes.c_void_p),
    ]


_RNDN = 0


def _load_libs():
    names_mpfr = ["libmpfr.so.6", "libmpfr.so", "mpfr"]
    names_gmp = ["libgmp.so.10", "libgmp.so", "gmp"]

    def try_load(names):
        for n in names:
            try:
                return ctypes.CDLL(n)
            except OSError:
                found = ctypes.util.find_library(n)
                if found:
                    try:
                        return ctypes.CDLL(found)
                    except OSError:
                        pass
        return None

    return try_load(names_mpfr), try_load(names_gmp)


_MPFR, _GMP = _load_libs()

if _MPFR is not None and _GMP is not None:
    _P = ctypes.POINTER(_MpfrT)
    _Z = ctypes.POINTER(_MpzT)
    _MPFR.mpfr_init2.argtypes = [_P, ctypes.c_long]
    _MPFR.mpfr_clear.argtypes = [_P]
    _MPFR.mpfr_set_d.argtypes = [_P, ctypes.c_double, ctypes.c_int]
    _MPFR.mpfr_set_ui.argtypes = [_P, ctypes.c_ulong, ctypes.c_int]
    _MPFR.mpfr_set_si.argtypes = [_P, ctypes.c_long, ctypes.c_int]
    _MPFR.mpfr_set.argtypes = [_P, _P, ctypes.c_int]
    _MPFR.mpfr_sqr.argtypes = [_P, _P, ctypes.c_int]
    _MPFR.mpfr_mul.argtypes = [_P, _P, _P, ctypes.c_int]
    _MPFR.mpfr_mul_ui.argtypes = [_P, _P, ctypes.c_ulong, ctypes.c_int]
    _MPFR.mpfr_ui_div.argtypes = [_P, ctypes.c_ulong, _P, ctypes.c_int]
    _MPFR.mpfr_add.argtypes = [_P, _P, _P, ctypes.c_int]
    _MPFR.mpfr_sub.argtypes = [_P, _P, _P, ctypes.c_int]
    _MPFR.mpfr_sub_ui.argtypes = [_P, _P, ctypes.c_ulong, ctypes.c_int]
    _MPFR.mpfr_neg.argtypes = [_P, _P, ctypes.c_int]
    _MPFR.mpfr_exp.argtypes = [_P, _P, ctypes.c_int]
    _MPFR.mpfr_pow_ui.argtypes = [_P, _P, ctypes.c_ulong, ctypes.c_int]
    _MPFR.mpfr_get_z.argtypes = [_Z, _P, ctypes.c_int]
    _GMP.__gmpz_init2.argtypes = [_Z, ctypes.c_ulong]
    _GMP.__gmpz_clear.argtypes = [_Z]
    _GMP.__gmpz_sizeinbase.argtypes = [_Z, ctypes.c_int]
    _GMP.__gmpz_sizeinbase.restype = ctypes.c_size_t
    _GMP.__gmpz_get_str.argtypes = [ctypes.c_char_p, ctypes.c_int, _Z]
    _GMP.__gmpz_get_str.restype = ctypes.c_char_p


def available() -> bool:
    return _MPFR is not None and _GMP is not None


def compute_barriers(sigma: float, center: float, rounded_center: int,
                     number_of_barriers: int, bit_precision: int) -> list:
    """Barrier integers with MPFR's exact op-sequence rounding.

    Returns a list of python ints, identical to the reference's
    precomputeBarrierValues() output for the same parameters.
    """
    if not available():
        raise RuntimeError("libmpfr/libgmp not available")
    prec = int(bit_precision)
    nb = int(number_of_barriers)

    def new(p=prec):
        v = _MpfrT()
        _MPFR.mpfr_init2(ctypes.byref(v), p)
        return v

    # ctor: mpfr_init_set_d(_center, center_d, RNDN) at default precision 53
    c_center = new(53)
    _MPFR.mpfr_set_d(ctypes.byref(c_center), float(center), _RNDN)

    # init(): _const_sigma = 1 / (2 * sigma^2) at working precision
    cs = new()
    _MPFR.mpfr_set_d(ctypes.byref(cs), float(sigma), _RNDN)
    _MPFR.mpfr_sqr(ctypes.byref(cs), ctypes.byref(cs), _RNDN)
    _MPFR.mpfr_mul_ui(ctypes.byref(cs), ctypes.byref(cs), 2, _RNDN)
    _MPFR.mpfr_ui_div(ctypes.byref(cs), 1, ctypes.byref(cs), _RNDN)

    ssum, tmp, tmp2 = new(), new(), new()
    _MPFR.mpfr_set_ui(ctypes.byref(ssum), 0, _RNDN)
    bars = [new() for _ in range(nb)]

    lo = rounded_center - (nb - 1) // 2
    for i in range(nb):
        _MPFR.mpfr_set_si(ctypes.byref(tmp2), lo + i, _RNDN)
        # nn_gaussian_law(tmp, tmp2)
        _MPFR.mpfr_sub(ctypes.byref(tmp), ctypes.byref(tmp2),
                       ctypes.byref(c_center), _RNDN)
        _MPFR.mpfr_sqr(ctypes.byref(tmp), ctypes.byref(tmp), _RNDN)
        _MPFR.mpfr_neg(ctypes.byref(tmp), ctypes.byref(tmp), _RNDN)
        _MPFR.mpfr_mul(ctypes.byref(tmp), ctypes.byref(tmp),
                       ctypes.byref(cs), _RNDN)
        _MPFR.mpfr_exp(ctypes.byref(tmp), ctypes.byref(tmp), _RNDN)
        if i == 0:
            _MPFR.mpfr_set(ctypes.byref(bars[0]), ctypes.byref(tmp), _RNDN)
        else:
            _MPFR.mpfr_add(ctypes.byref(bars[i]), ctypes.byref(bars[i - 1]),
                           ctypes.byref(tmp), _RNDN)
        _MPFR.mpfr_add(ctypes.byref(ssum), ctypes.byref(ssum),
                       ctypes.byref(tmp), _RNDN)

    # sum = (2^prec - 1) * (1/sum)
    _MPFR.mpfr_ui_div(ctypes.byref(ssum), 1, ctypes.byref(ssum), _RNDN)
    _MPFR.mpfr_set_ui(ctypes.byref(tmp), 2, _RNDN)
    _MPFR.mpfr_pow_ui(ctypes.byref(tmp), ctypes.byref(tmp), prec, _RNDN)
    _MPFR.mpfr_sub_ui(ctypes.byref(tmp), ctypes.byref(tmp), 1, _RNDN)
    _MPFR.mpfr_mul(ctypes.byref(ssum), ctypes.byref(ssum),
                   ctypes.byref(tmp), _RNDN)

    z = _MpzT()
    _GMP.__gmpz_init2(ctypes.byref(z), prec)
    out = []
    for i in range(nb):
        _MPFR.mpfr_mul(ctypes.byref(bars[i]), ctypes.byref(bars[i]),
                       ctypes.byref(ssum), _RNDN)
        _MPFR.mpfr_get_z(ctypes.byref(z), ctypes.byref(bars[i]), _RNDN)
        ndigits = _GMP.__gmpz_sizeinbase(ctypes.byref(z), 10)
        buf = ctypes.create_string_buffer(int(ndigits) + 2)
        _GMP.__gmpz_get_str(buf, 10, ctypes.byref(z))
        out.append(int(buf.value))

    _GMP.__gmpz_clear(ctypes.byref(z))
    for v in bars + [c_center, cs, ssum, tmp, tmp2]:
        _MPFR.mpfr_clear(ctypes.byref(v))
    return out
