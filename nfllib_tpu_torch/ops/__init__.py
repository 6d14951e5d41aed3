"""Residue-tensor operations: the elementwise modular ops and the NTT
dispatch (port of nfllib_tpu/ops)."""
from . import modops, ntt

__all__ = ["modops", "ntt"]
