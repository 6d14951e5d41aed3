"""Pure-Python scalar oracle for differential testing.

Port of the part of nfllib_tpu/oracle.py the port's checks use: the O(n^2)
negacyclic product in trivially-correct python-int arithmetic.
"""
from __future__ import annotations

import numpy as np

from .ring import Ring


def negacyclic_mul_schoolbook(a, b, ring: Ring):
    """O(n^2) negacyclic polynomial product per channel — the ground truth
    that NTT-domain pointwise multiplication must reproduce.  a, b: [m, n]
    integer arrays; returns [m, n] in the unsigned limb dtype."""
    n = ring.degree
    out = np.zeros((ring.nmoduli, n), dtype=object)
    a = np.asarray(a)
    b = np.asarray(b)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        acc = [0] * n
        for i in range(n):
            ai = int(a[cm][i])
            if ai == 0:
                continue
            for j in range(n):
                k = i + j
                t = ai * int(b[cm][j])
                if k < n:
                    acc[k] = (acc[k] + t) % p
                else:
                    acc[k - n] = (acc[k - n] - t) % p
        out[cm] = acc
    return out.astype(ring.dtype)
