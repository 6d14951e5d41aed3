"""NFLlib-compatible parameter tables (limb types, primes, roots).

PyTorch port of nfllib_tpu/params.py.  The JSON tables in data/ are byte
copies of nfllib_tpu/data/ (tests hold them equal), generated by
tools/gen_params.py from the reference's params.hpp formulas.

Limb tiers (mirroring params.hpp):
  u16: 14-bit moduli,  2 primes, max degree 512
  u32: 30-bit moduli, 291 primes, max degree 32768
  u64: 62-bit moduli, 1000 primes, max degree 2^20

Storage: torch has no add, subtract, shift or compare for its unsigned
integer types on the CPU, so residue tensors use the SIGNED type of the
limb's width (u16 -> int16, u32 -> int32) holding the same bit pattern as
the JAX package's unsigned arrays.  The numpy boundary is a zero-cost
`.view(np.uint16 / np.uint32)`.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os

import numpy as np
import torch

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

LIMBS = ("u16", "u32", "u64")

_NP_DTYPE = {"u16": np.uint16, "u32": np.uint32, "u64": np.uint64}
_NP_SIGNED = {"u16": np.int16, "u32": np.int32, "u64": np.int64}
_TORCH_DTYPE = {"u16": torch.int16, "u32": torch.int32, "u64": torch.int64}


@dataclasses.dataclass(frozen=True)
class LimbParams:
    """Static parameter table for one limb type (params<T> equivalent)."""
    limb: str
    modulus_bits: int           # kModulusBitsize
    repr_bits: int              # kModulusRepresentationBitsize
    max_poly_degree: int        # kMaxPolyDegree
    max_nb_moduli: int          # kMaxNbModuli
    P: tuple                    # primes, descending
    Pn: tuple                   # Newton quotient low words
    primitive_roots: tuple      # primitive 2*kMaxPolyDegree-th roots
    inv_max_poly_degree: tuple  # kMaxPolyDegree^-1 mod P[i]

    @property
    def dtype(self):
        """numpy unsigned limb dtype (the JAX package's storage type)."""
        return _NP_DTYPE[self.limb]

    @property
    def signed_dtype(self):
        return _NP_SIGNED[self.limb]

    @property
    def torch_dtype(self) -> torch.dtype:
        """Signed torch storage type with the limb's width."""
        return _TORCH_DTYPE[self.limb]

    @property
    def itemsize(self):
        return self.repr_bits // 8


@functools.lru_cache(maxsize=None)
def get_limb_params(limb: str) -> LimbParams:
    if limb not in LIMBS:
        raise ValueError(f"unknown limb type {limb!r}; expected one of {LIMBS}")
    with open(os.path.join(_DATA_DIR, f"params_{limb}.json")) as f:
        d = json.load(f)
    return LimbParams(
        limb=limb,
        modulus_bits=d["modulus_bits"],
        repr_bits=d["repr_bits"],
        max_poly_degree=d["max_poly_degree"],
        max_nb_moduli=d["max_nb_moduli"],
        P=tuple(d["P"]),
        Pn=tuple(d["Pn"]),
        primitive_roots=tuple(d["primitive_roots"]),
        inv_max_poly_degree=tuple(d["inv_max_poly_degree"]),
    )


def limb_for_ctype(ctype: str) -> str:
    """Map the reference's C limb type names onto our tier names."""
    return {"uint16_t": "u16", "uint32_t": "u32", "uint64_t": "u64"}[ctype]
