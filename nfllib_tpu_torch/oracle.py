"""Pure-Python scalar oracle for differential testing.

Port of nfllib_tpu/oracle.py (pure Python and numpy).  It re-states the
reference's numerical contracts in trivially-correct python-int arithmetic;
the port's fast paths (plain torch ops, CUDA kernels and their twins) are
tested against these, mirroring the reference's own differential test
strategy (reference tests/test_binary_op.h:9-32).

The NTT oracle follows the exact algorithm of the reference so intermediate
conventions (Harvey blocked twiddles, bit-reversed forward-domain ordering,
lazy [0,2p) arithmetic, final strict reduction) are pinned down executably
(reference include/nfl/core.hpp:455-557, include/nfl/algos.hpp:16-73).
Residue arrays here are in the unsigned limb dtype (`Poly.numpy()`); the
tables are the port's RingContext's (numpy, the same values as the JAX
package's).
"""
from __future__ import annotations

import numpy as np

from .ring import Ring, RingContext
from .utils import bitrev_indices, static_log2


# ---------------------------------------------------------------------------
# scalar modular ops (reference ops.hpp)
# ---------------------------------------------------------------------------

def addmod(x: int, y: int, p: int) -> int:
    return (x + y) % p


def submod(x: int, y: int, p: int) -> int:
    return (x - y) % p


def mulmod(x: int, y: int, p: int) -> int:
    return (x * y) % p


def compute_shoup(y: int, p: int, w: int) -> int:
    return ((y % p) << w) // p


def mulmod_shoup(x: int, y: int, yprime: int, p: int, w: int) -> int:
    """Wrapping-word Shoup multiply (reference ops.hpp:225-242)."""
    mask = (1 << w) - 1
    q = (x * yprime) >> w
    r = (x * y - q * p) & mask
    return r - p if r >= p else r


def muladd(rop: int, x: int, y: int, p: int) -> int:
    return (rop + x * y) % p


def muladd_shoup(rop: int, x: int, y: int, yprime: int, p: int, w: int) -> int:
    mask = (1 << w) - 1
    q = (x * yprime) >> w
    r = (rop + x * y - q * p) & mask
    return r - p if r >= p else r


# ---------------------------------------------------------------------------
# NTT oracle (exact transcription of the reference algorithm's semantics)
# ---------------------------------------------------------------------------

def ntt(x, wtab, winvtab, p: int, w: int):
    """Forward Harvey NTT on one channel; returns canonical residues [0,p).

    x: list/array of n ints < p.  wtab/winvtab: blocked twiddles of length n-1
    (RingContext.omegas / shoupomegas rows).  Output ordering is the
    reference's bit-reversed evaluation order.
    """
    x = [int(v) for v in x]
    wtab = [int(v) for v in wtab]
    winvtab = [int(v) for v in winvtab]
    n = len(x)
    mask = (1 << w) - 1
    if n == 1:
        return x
    if n == 2:
        t0 = x[0] + x[1]
        t1 = x[0] - x[1]
        t0 -= 2 * p if t0 >= 2 * p else 0
        t1 += 2 * p if t1 < 0 else 0
        return [t0 % p, t1 % p]

    # main stages (reference algos.hpp:55-72); J = log2(n) - 2
    J = static_log2(n) - 2
    off = 0
    for s in range(J):
        M = 1 << s
        N = n >> s
        for r in range(M):
            for i in range(N // 2):
                i0 = N * r + i
                i1 = i0 + N // 2
                u0, u1 = x[i0], x[i1]
                t0 = u0 + u1
                t0 -= 2 * p if t0 >= 2 * p else 0
                t1 = u0 - u1 + 2 * p
                q = (t1 * winvtab[off + i]) >> w
                t2 = (t1 * wtab[off + i] - q * p) & mask
                x[i0], x[i1] = t0, t2
        off += N // 2

    # last two radix-2 layers, hand-unrolled (reference core.hpp:488-521)
    wt1 = int(wtab[off + 1])
    wi1 = int(winvtab[off + 1])
    for r in range(n // 4):
        b = 4 * r
        u0, u1, u2, u3 = x[b], x[b + 1], x[b + 2], x[b + 3]
        v0 = u0 + u2
        v0 -= 2 * p if v0 >= 2 * p else 0
        v2 = u0 - u2
        v2 += 2 * p if v2 < 0 else 0
        v1 = u1 + u3
        v1 -= 2 * p if v1 >= 2 * p else 0
        t = u1 - u3 + 2 * p
        q = (t * wi1) >> w
        v3 = (t * wt1 - q * p) & mask
        z0 = v0 + v1
        z0 -= 2 * p if z0 >= 2 * p else 0
        z1 = v0 - v1
        z1 += 2 * p if z1 < 0 else 0
        z2 = v2 + v3
        z2 -= 2 * p if z2 >= 2 * p else 0
        z3 = v2 - v3
        z3 += 2 * p if z3 < 0 else 0
        x[b], x[b + 1], x[b + 2], x[b + 3] = z0, z1, z2, z3

    # NTT_STRICTMOD final reduction (always on in the reference, debug.hpp:31)
    return [v - p if v >= p else v for v in x]


def inv_ntt(x, inv_wtab, inv_winvtab, p: int, w: int):
    """Bit-reverse -> forward NTT with inverse twiddles -> bit-reverse
    (reference core.hpp:539-557).  Does NOT scale by n^-1."""
    n = len(x)
    if n == 1:
        return [int(v) for v in x]
    rev = bitrev_indices(n)
    y = [int(x[rev[i]]) for i in range(n)]
    y = ntt(y, inv_wtab, inv_winvtab, p, w)
    return [y[rev[i]] for i in range(n)]


def ntt_pow_phi(data, ctx: RingContext):
    """Full negacyclic forward transform on an [m, n] residue array
    (reference core.hpp:594-600): fused shoup(x * phi^i) pre-twist then NTT."""
    ring = ctx.ring
    w = ring.repr_bits
    out = np.empty_like(np.asarray(data))
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        row = [mulmod_shoup(int(v), int(ctx.phis[cm][i]),
                            int(ctx.shoupphis[cm][i]), p, w)
               for i, v in enumerate(np.asarray(data)[cm])]
        out[cm] = ntt(row, ctx.omegas[cm], ctx.shoupomegas[cm], p, w)
    return out


def invntt_pow_invphi(data, ctx: RingContext):
    """Full inverse transform (reference core.hpp:608-614)."""
    ring = ctx.ring
    w = ring.repr_bits
    out = np.empty_like(np.asarray(data))
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        row = inv_ntt(np.asarray(data)[cm], ctx.invomegas[cm],
                      ctx.shoupinvomegas[cm], p, w)
        out[cm] = [mulmod_shoup(int(v),
                                int(ctx.invpoly_times_invphis[cm][i]),
                                int(ctx.shoupinvpoly_times_invphis[cm][i]),
                                p, w)
                   for i, v in enumerate(row)]
    return out


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


def dft_eval(data, ctx: RingContext):
    """Direct evaluation map: E[cm][k] = A_cm(phi^(2k+1)) in natural order.

    The reference's forward transform equals E composed with bit-reversal;
    this pins the ordering convention down independently of the FFT."""
    ring = ctx.ring
    n = ring.degree
    out = np.empty((ring.nmoduli, n), dtype=object)
    a = np.asarray(data)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        phi = ctx.phi_int[cm]
        for k in range(n):
            root = pow(phi, 2 * k + 1, p)
            acc = 0
            x = 1
            for i in range(n):
                acc = (acc + int(a[cm][i]) * x) % p
                x = (x * root) % p
            out[cm][k] = acc
    return out.astype(ring.dtype)
