"""nfllib_tpu_torch — the PyTorch / CUDA port of nfllib_tpu.

Polynomial arithmetic in R_q = Z_q[X]/(X^n + 1) in RNS form, on PyTorch
tensors.  The forward and inverse negacyclic NTT run as hand-written CUDA
kernels (csrc/, built with nvcc at first use) for tensors on a CUDA
device, and as their plain torch twins for tensors on the CPU.
The port imports torch and never jax; the JAX package nfllib_tpu beside it
is the reference its tests hold it to.

Covered so far: the u16, u32 and u64 limb tiers (degrees up to 2^20 for
u64), Poly with the lazy expression tree and the shoup(a * b, bprec)
rewrite, the NTT, the uniform sampler on the Salsa20 stream, CRT lifting
and NFLlib-compatible serialization.
"""
from .params import LIMBS, LimbParams, get_limb_params
from .ring import Ring, RingContext, get_context, ring_from_modulus
from .poly import Expr, Poly, compute_shoup, shoup, uniform
from .serialize import deserialize_poly, serialize_poly
from .crt import mpz2poly, poly2mpz, set_mpz

__all__ = [
    "LIMBS",
    "LimbParams",
    "get_limb_params",
    "Ring",
    "RingContext",
    "get_context",
    "ring_from_modulus",
    "Poly",
    "Expr",
    "uniform",
    "shoup",
    "compute_shoup",
    "serialize_poly",
    "deserialize_poly",
    "poly2mpz",
    "mpz2poly",
    "set_mpz",
]

__version__ = "0.1.0"
