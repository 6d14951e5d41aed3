"""The yardstick: the card's published peak and the least bytes each traced
span must move, worked out from the shapes alone.

A span's bound counts each input tensor read once and each output tensor
written once, whatever the kernels under it read again or keep as scratch,
so it is the same for the route, the butterfly, a plain twin or any later
kernel.  These spans move integer residues with few operations a byte, so
the bandwidth bounds them.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 (at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
