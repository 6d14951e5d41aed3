"""nfllib_tpu_torch — the PyTorch / CUDA port of nfllib_tpu.

Polynomial arithmetic in R_q = Z_q[X]/(X^n + 1) in RNS form, on PyTorch
tensors.  The forward and inverse negacyclic NTT run as hand-written CUDA
kernels (csrc/, built with nvcc at first use) for tensors on a CUDA
device, and as their plain torch twins for tensors on the CPU.
The port imports torch and never jax; the JAX package nfllib_tpu beside it
is the reference its tests hold it to.

Covered so far: the u16, u32 and u64 limb tiers (degrees up to 2^20 for
u64), Poly with the lazy expression tree and the shoup(a * b, bprec)
rewrite, the NTT (fused four-step and Harvey butterfly kernels, chosen by
NFL_TORCH_NTT, ops/ntt.py), the host samplers on the Salsa20 stream
(uniform, non_uniform, ZO_dist, hwt_dist, gaussian), CRT lifting,
NFLlib-compatible serialization, the LWE demo (apps/lwe.py) and the
degree-sharded four-step NTT on torch.distributed (parallel/).
Constructors put tensors on the card unless given device="cpu".
"""
from .params import LIMBS, LimbParams, get_limb_params
from .ring import Ring, RingContext, get_context, ring_from_modulus
from .poly import (Expr, Poly, ZO_dist, compute_shoup, gaussian, hwt_dist,
                   non_uniform, shoup, uniform)
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
    "non_uniform",
    "hwt_dist",
    "ZO_dist",
    "gaussian",
    "shoup",
    "compute_shoup",
    "serialize_poly",
    "deserialize_poly",
    "poly2mpz",
    "mpz2poly",
    "set_mpz",
]

__version__ = "0.1.0"
