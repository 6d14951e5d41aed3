"""System entropy source (reference lib/prng/randombytes.cpp:11-34).

The reference blocks on /dev/urandom with a retry loop; Python's os.urandom
has the same contract.  Used once per stream to draw the Salsa20 key.
"""
from __future__ import annotations

import os


def randombytes(n: int) -> bytes:
    return os.urandom(n)
