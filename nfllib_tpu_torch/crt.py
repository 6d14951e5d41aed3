"""CRT lifting between RNS residues and big integers.

Port of nfllib_tpu/crt.py (reference include/nfl/gmp.hpp:113-219): the
residues come to the host and lift there, in the native tier's multiword
arithmetic (csrc/nfl_native.cpp nfl_poly2mpz / nfl_mpz2poly, through
nfllib_tpu_torch.native) when it is available, else in exact Python
integers.  The reference's Shoup-style reduction modulo the moduli product
(gmp.hpp:198-204) is an exact algorithm, so both give identical results.

poly2mpz:  x_i = (sum_cm lifting[cm] * residue[cm][i]) mod prod   (canonical)
mpz2poly:  residue[cm][i] = x_i mod p_cm  (floor division semantics, matching
           mpz_fdiv_ui for negative inputs, gmp.hpp:216)
"""
from __future__ import annotations

import numpy as np

from . import native
from .poly import Poly
from .ring import DEFAULT_DEVICE, Ring


def poly2mpz(p: Poly) -> list:
    """Lift an (unbatched) Poly to a list of `degree` python ints."""
    ctx = p.ring.context()
    arr = p.numpy()          # unsigned: the signed storage must not widen
    if arr.ndim != 2:
        raise ValueError("poly2mpz expects an unbatched [m, n] poly")
    if native.available():
        return native.poly2mpz_native(arr, ctx)
    return _poly2mpz_py(arr, ctx)


def _poly2mpz_py(arr: np.ndarray, ctx) -> list:
    """The Python tier of poly2mpz: unsigned residues [m, n] -> ints."""
    prod = ctx.moduli_product
    lift = ctx.lifting_integers
    rows = [arr[cm].tolist() for cm in range(ctx.ring.nmoduli)]
    out = []
    for i in range(ctx.ring.degree):
        acc = 0
        for cm, row in enumerate(rows):
            if row[i]:
                acc += lift[cm] * row[i]
        out.append(acc % prod)
    return out


def _reduce_rows(ring: Ring, rows) -> np.ndarray:
    data = np.zeros((ring.nmoduli, ring.degree), dtype=ring.dtype)
    for cm in range(ring.nmoduli):
        pm = int(ring.moduli[cm])
        row = rows(cm)
        data[cm][: len(row)] = [int(v) % pm for v in row]
    return data


def mpz2poly(ring: Ring, values, device=DEFAULT_DEVICE) -> Poly:
    """Reduce `degree` python ints into RNS residues on `device`."""
    vals = list(values)
    if len(vals) != ring.degree:
        raise ValueError(f"expected {ring.degree} coefficients, "
                         f"got {len(vals)}")
    if native.available() and all(v >= 0 for v in vals):
        return Poly.from_numpy(ring, native.mpz2poly_native(vals, ring),
                               device)
    return Poly.from_numpy(ring, _reduce_rows(ring, lambda cm: vals), device)


def set_mpz(ring: Ring, values, device=DEFAULT_DEVICE) -> Poly:
    """set_mpz semantics (reference gmp.hpp:75-108): broadcast-or-full with
    per-channel reduction of arbitrarily large (possibly negative) ints."""
    vals = [int(v) for v in values]
    n, m = ring.degree, ring.nmoduli
    if len(vals) > n and len(vals) != n * m:
        raise ValueError(
            "initializer of size above degree but not equal to nmoduli*degree")
    if len(vals) == n * m:
        data = _reduce_rows(ring, lambda cm: vals[cm * n:(cm + 1) * n])
    else:
        data = _reduce_rows(ring, lambda cm: vals)
    return Poly.from_numpy(ring, data, device)
