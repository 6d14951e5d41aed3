"""The plain reference the benchmark holds the port to.

Plain PyTorch on int64 tensors, on whatever device it is given: modular
arithmetic for word-sized primes, the negacyclic NTT in NFLlib's order, the
ring product, the Salsa20 keystream, and the fixed-consumption discrete
Gaussian of NFLlib's FastGaussianNoise with its barrier table.  It imports
nothing of the program: every table (roots, twiddles, barriers, keystream)
is worked out here again from the configuration's primes and NFLlib's
published primitive roots, which the configuration file holds.

Residues are canonical, in [0, p).  Products of two residues of a prime
below 2^31 fit int64 and reduce by `%`; for primes below 2^62 the product
is reduced by Montgomery's method over 64-bit words emulated with 32-bit
halves (torch's int64 product keeps the low 64 bits).
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_R = 1 << 64


def _signed(v: int) -> int:
    """A 64-bit word as the int64 value of its bit pattern."""
    v &= _R - 1
    return v - _R if v >> 63 else v


def mulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The high 64 bits of the 128-bit product of two unsigned 64-bit words
    held as int64 bit patterns."""
    a0, a1 = a & M32, (a >> 32) & M32
    b0, b1 = b & M32, (b >> 32) & M32
    p00, p01, p10 = a0 * b0, a0 * b1, a1 * b0
    mid = ((p00 >> 32) & M32) + (p01 & M32) + (p10 & M32)
    return (a1 * b1 + ((p01 >> 32) & M32) + ((p10 >> 32) & M32)
            + (mid >> 32))


class Moduli:
    """The primes of a ring as per-channel columns on one device, and the
    modular arithmetic on [..., m, n] int64 residues (channel axis -2)."""

    def __init__(self, primes, device):
        self.primes = [int(p) for p in primes]
        if any(p >= 1 << 62 or p % 2 == 0 for p in self.primes):
            raise ValueError("odd primes below 2^62 only")
        self.wide = max(self.primes) >= 1 << 31
        self.device = torch.device(device)
        self.p = self._col(self.primes)
        if self.wide:
            self.pinv = self._col(_signed(-pow(p, -1, _R))
                                  for p in self.primes)
            self.r2 = self._col(_R * _R % p for p in self.primes)

    def inner(self) -> "Moduli":
        """The same moduli for tensors with one more axis after the
        channel axis ([..., m, k, n])."""
        out = object.__new__(Moduli)
        out.__dict__.update({k: v[..., None] if torch.is_tensor(v) else v
                             for k, v in self.__dict__.items()})
        return out

    def _col(self, vals) -> torch.Tensor:
        return torch.tensor(list(vals), dtype=torch.int64,
                            device=self.device).reshape(-1, 1)

    def add(self, a, b):
        s = a + b
        return torch.where(s >= self.p, s - self.p, s)

    def sub(self, a, b):
        d = a - b
        return torch.where(d < 0, d + self.p, d)

    def _redc(self, a, b):
        """a * b * 2^-64 mod p for a, b < p (Montgomery reduction)."""
        lo = a * b
        m = lo * self.pinv
        u = mulhi(a, b) + mulhi(m, self.p) + (lo != 0).to(torch.int64)
        return torch.where(u >= self.p, u - self.p, u)

    def mul(self, a, b):
        if not self.wide:
            return a * b % self.p
        return self._redc(self._redc(a, b), self.r2)

    def companion(self, w: torch.Tensor) -> torch.Tensor:
        """Shoup's companion of constants w [m, k]: floor(w 2^32 / p) for
        primes below 2^31, floor(w 2^64 / p) (as its int64 bit pattern)
        for wider ones."""
        if not self.wide:
            return torch.div(w << 32, self.p, rounding_mode="floor")
        rows = [[_signed((v << 64) // p) for v in row]
                for row, p in zip(w.tolist(), self.primes)]
        return torch.tensor(rows, dtype=torch.int64, device=self.device)

    def mul_const(self, x, w, ws):
        """x * w mod p for a constant w with its companion ws (Shoup)."""
        q = mulhi(x, ws) if self.wide else (x * ws) >> 32
        r = x * w - q * self.p
        return torch.where(r >= self.p, r - self.p, r)

    def powers(self, bases, count: int) -> torch.Tensor:
        """[m, count]: bases[c]^j mod p_c for j < count."""
        m = len(self.primes)
        out = torch.empty((m, count), dtype=torch.int64, device=self.device)
        out[:, 0] = 1
        step = [int(b) % p for b, p in zip(bases, self.primes)]
        filled = 1
        while filled < count:
            take = min(filled, count - filled)
            out[:, filled:filled + take] = self.mul(out[:, :take],
                                                    self._col(step))
            step = [s * s % p for s, p in zip(step, self.primes)]
            filled += take
        return out


class NegacyclicNtt:
    """NFLlib's negacyclic NTT of degree n over the given primes.

    phi is NFLlib's primitive root of order 2 * max_degree squared down to
    order 2n, omega = phi^2.  The forward transform of x is the evaluation
    of x at phi * omega^rev(k), listed in bit-reversed order k (NFLlib's
    ntt_pow_phi: the phi twist, then decimation in frequency with no
    reordering); the inverse undoes it, n^-1 and the phi untwist
    included."""

    def __init__(self, primes, roots, max_degree: int, n: int, device):
        if n < 2 or n & (n - 1) or max_degree % n:
            raise ValueError("n must be a power of two dividing max_degree")
        self.mod = Moduli(primes, device)
        self.n = n
        self.log_n = n.bit_length() - 1
        phis, omegas = [], []
        for p, g in zip(self.mod.primes, roots):
            phi = int(g) % p
            for _ in range((max_degree // n).bit_length() - 1):
                phi = phi * phi % p
            if pow(phi, n, p) != p - 1:
                raise ValueError(f"root {g} is not of order 2n mod {p}")
            phis.append(phi)
            omegas.append(phi * phi % p)
        mod = self.mod
        self.stage_mod = mod.inner()
        inv = [pow(phi, -1, p) for phi, p in zip(phis, mod.primes)]
        # every table with its Shoup companion
        self.phis = self._pair(mod.powers(phis, n))
        self.untwist = self._pair(mod.mul(mod.powers(inv, n), mod._col(
            pow(n, -1, p) for p in mod.primes)))
        self.omegas = self._pair(mod.powers(omegas, max(n // 2, 1)))
        self.invomegas = self._pair(mod.powers(
            [pow(w, -1, p) for w, p in zip(omegas, mod.primes)],
            max(n // 2, 1)))

    def _pair(self, w):
        return w, self.mod.companion(w)

    @staticmethod
    def _stage_table(pair, s, half):
        return tuple(t[:, ::1 << s][:, None, :half] for t in pair)

    def _stage_view(self, x, s):
        half = self.n >> (s + 1)
        return x.reshape(x.shape[:-1] + (1 << s, 2 * half)), half

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mod = self.stage_mod
        x = self.mod.mul_const(x, *self.phis)
        for s in range(self.log_n):
            v, half = self._stage_view(x, s)
            w = self._stage_table(self.omegas, s, half)
            u0, u1 = v[..., :half], v[..., half:]
            x = torch.cat([mod.add(u0, u1), mod.mul_const(mod.sub(u0, u1),
                                                          *w)],
                          dim=-1).reshape(x.shape)
        return x

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        mod = self.stage_mod
        for s in reversed(range(self.log_n)):
            v, half = self._stage_view(y, s)
            w = self._stage_table(self.invomegas, s, half)
            a, t = v[..., :half], mod.mul_const(v[..., half:], *w)
            y = torch.cat([mod.add(a, t), mod.sub(a, t)],
                          dim=-1).reshape(y.shape)
        return self.mod.mul_const(y, *self.untwist)

    def product(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The negacyclic product a * b mod (X^n + 1, p), channel by
        channel."""
        return self.inverse(self.mod.mul(self.forward(a), self.forward(b)))


# ---------------------------------------------------------------------------
# Salsa20 (Bernstein's specification; NFLlib's stream: 32-byte key, the
# 64-bit nonce in words 6-7, the 64-bit block counter in words 8-9)
# ---------------------------------------------------------------------------

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x, c):
    return ((x << c) | (x >> (32 - c))) & M32


def salsa20_bytes(key: bytes, nonces: torch.Tensor, nblocks: int
                  ) -> torch.Tensor:
    """uint8 [len(nonces), nblocks * 64]: the first nblocks blocks of the
    keystream at each nonce (int64 bit patterns of the 64-bit nonces)."""
    dev = nonces.device
    kw = [int.from_bytes(key[4 * i:4 * i + 4], "little") for i in range(8)]
    f = nonces.shape[0]
    ctr = torch.arange(nblocks, dtype=torch.int64, device=dev)[None, :] \
        .expand(f, nblocks)
    nz = nonces.reshape(-1, 1).expand(f, nblocks)

    def const(v):
        return torch.full((f, nblocks), v, dtype=torch.int64, device=dev)

    x = [const(_SIGMA[0]), *map(const, kw[:4]), const(_SIGMA[1]),
         nz & M32, (nz >> 32) & M32, ctr & M32, (ctr >> 32) & M32,
         const(_SIGMA[2]), *map(const, kw[4:]), const(_SIGMA[3])]
    init = list(x)

    def qr(a, b, c, d):
        x[b] = x[b] ^ _rotl((x[a] + x[d]) & M32, 7)
        x[c] = x[c] ^ _rotl((x[b] + x[a]) & M32, 9)
        x[d] = x[d] ^ _rotl((x[c] + x[b]) & M32, 13)
        x[a] = x[a] ^ _rotl((x[d] + x[c]) & M32, 18)

    for _ in range(10):
        qr(0, 4, 8, 12), qr(5, 9, 13, 1), qr(10, 14, 2, 6), qr(15, 3, 7, 11)
        qr(0, 1, 2, 3), qr(5, 6, 7, 4), qr(10, 11, 8, 9), qr(15, 12, 13, 14)
    words = torch.stack([(a + b) & M32 for a, b in zip(x, init)], dim=-1)
    shifts = torch.arange(0, 32, 8, device=dev)
    out = (words[..., None] >> shifts) & 0xFF
    return out.reshape(f, nblocks * 64).to(torch.uint8)


# ---------------------------------------------------------------------------
# the discrete Gaussian of NFLlib's FastGaussianNoise (fixed consumption)
# ---------------------------------------------------------------------------

def _tail_bound(k: float, guess: float, digits: int) -> float:
    """The tail bound t solving t^2 - 2 ln t - 1 = 2 k ln 2 by NFLlib's
    float64 Newton iteration (FastGaussianNoise.hpp), then lowered by
    factors of 0.95 while the bound still holds."""
    def f(t):
        return t * t - 2 * math.log(t) - 1 - 2 * k * math.log(2)

    for _ in range(1 << 15):
        delta = f(guess) / (2 * guess - 2 / guess)
        guess -= delta
        if abs(delta) / abs(guess) < 10.0 ** (-digits):
            break
    while f(0.95 * guess) >= 0:
        guess *= 0.95
    return guess


class Gaussian:
    """FastGaussianNoise(sigma, security, samples) with in_bits-bit words:
    the tail bound, the precision, the barrier integers (cumulative
    probabilities scaled to 2^bit_precision - 1, by NFLlib's sequence of
    operations in mpmath at NFLlib's precision) and the fixed-consumption
    draw."""

    def __init__(self, sigma: float, security: int, samples: int,
                 in_bits: int = 8):
        from mpmath import mp, mpf
        k = security + 1 + math.ceil(math.log(samples) / math.log(2))
        tail = _tail_bound(k, math.sqrt(1 + 2 * k * math.log(2)), 3)
        bits = math.ceil(k + math.log2(2 * tail * sigma))
        self.in_bits = in_bits
        self.wp = math.ceil(bits / in_bits)
        self.bit_precision = self.wp * in_bits
        nb = 1 + 2 * math.ceil(tail * sigma)
        self.base = -((nb - 1) // 2)
        # NFLlib's MPFR sequence, every operation rounded to nearest at
        # bit_precision bits (FastGaussianNoise.hpp, precomputeBarrierValues)
        old = mp.prec
        try:
            mp.prec = self.bit_precision
            cs = 1 / (mpf(sigma) ** 2 * 2)
            acc, bars = mpf(0), []
            for i in range(nb):
                acc = acc + mp.exp(-(mpf(self.base + i) ** 2) * cs)
                bars.append(acc)
            scale = (1 / acc) * (mpf(2) ** self.bit_precision - 1)
            self.barriers = [int(mp.nint(b * scale)) for b in bars]
        finally:
            mp.prec = old

    def draw(self, key: bytes, nonces: torch.Tensor, amps: torch.Tensor,
             n: int) -> torch.Tensor:
        """int64 [F, n]: draw f reads the stream at nonces[f], sample s
        the wp big-endian in_bits words from word s * wp; its value is
        (base + #{barriers <= r}) * amps[f]."""
        if self.in_bits != 8:
            raise ValueError("8-bit words only")
        nbl = (n * self.wp + 63) // 64
        raw = salsa20_bytes(key, nonces, nbl)[:, :n * self.wp] \
            .reshape(-1, n, self.wp).to(torch.int64)
        return (self.base + self.count(self.chunks(raw))) \
            * amps.reshape(-1, 1)

    CHUNK = 6      # bytes of a chunk: 48 bits compare exactly in int64

    def chunks(self, words: torch.Tensor) -> torch.Tensor:
        """[..., wp] bytes, most significant first -> [..., c] int64 chunks
        of CHUNK bytes, most significant first."""
        pad = -self.wp % self.CHUNK
        r = torch.nn.functional.pad(words, (pad, 0))
        weights = torch.tensor([1 << (8 * (self.CHUNK - 1 - i))
                                for i in range(self.CHUNK)],
                               device=words.device)
        return (r.reshape(r.shape[:-1] + (-1, self.CHUNK)) * weights).sum(-1)

    def barrier_chunks(self, device) -> torch.Tensor:
        nch = -(-self.wp // self.CHUNK)
        bits = 8 * self.CHUNK
        return torch.tensor([[(b >> (bits * (nch - 1 - c))) & ((1 << bits) - 1)
                              for c in range(nch)] for b in self.barriers],
                            dtype=torch.int64, device=device)

    def count_all(self, rc: torch.Tensor) -> torch.Tensor:
        """#{barriers <= r} for chunked r [..., c], barrier by barrier."""
        count = torch.zeros(rc.shape[:-1], dtype=torch.int64,
                            device=rc.device)
        for bar in self.barrier_chunks(rc.device):
            le = torch.zeros_like(count, dtype=torch.bool)
            eq = torch.ones_like(count, dtype=torch.bool)
            for c in range(rc.shape[-1]):
                le |= eq & (rc[..., c] > bar[c])
                eq &= rc[..., c] == bar[c]
            count += (le | eq).to(torch.int64)
        return count

    def count(self, rc: torch.Tensor) -> torch.Tensor:
        """count_all's answer: by the leading chunk alone, and barrier by
        barrier for the samples whose leading chunk equals a barrier's."""
        bc = self.barrier_chunks(rc.device)
        lead = rc[..., 0].contiguous()
        lo = torch.searchsorted(bc[:, 0].contiguous(), lead)
        hi = torch.searchsorted(bc[:, 0].contiguous(), lead, right=True)
        tie = hi > lo
        if bool(tie.any()):
            lo = lo.clone()
            lo[tie] = self.count_all(rc[tie])
        return lo
