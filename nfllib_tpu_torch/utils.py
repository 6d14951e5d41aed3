"""Small meta utilities (reference include/nfl/meta.hpp:12-41 equivalents)."""
from __future__ import annotations

import numpy as np


def static_log2(n: int) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{n} is not a positive power of two")
    return n.bit_length() - 1


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def bitrev_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation indices for length n (reference permut.hpp)."""
    bits = static_log2(n)
    idx = np.arange(n, dtype=np.uint32)
    out = np.zeros_like(idx)
    for _ in range(bits):
        out = (out << 1) | (idx & 1)
        idx >>= 1
    return out.astype(np.int32)
