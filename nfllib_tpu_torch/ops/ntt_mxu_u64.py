"""Four-step negacyclic NTT for the u64 (62-bit-moduli) tier.

PyTorch port of nfllib_tpu/ops/ntt_mxu_u64.py.  Its JAX kernel _kernel64
(K4) and its _large_run64 compute one transform; here every degree 8..2^20
runs ops/ntt_mxu.py's route, the one four-step of every tier: two launches
of the u64 square mod-matmul kernel K5 (csrc/dft_mxu64.cu, int8 tensor
cores; K10 under NFL_TORCH_DFT_PIPE) on a CUDA tensor, the column DFT with
the twiddle as its Shoup epilogue, then the row DFT; the same two stages'
twin on a CPU tensor.  The outputs are canonical, so they are bit-identical
to the JAX package's.  Strict mode keeps K4's meaning: a residue equal to
p raises (ops/ntt.py:_strict_bracket), and a broken stage contract poisons
the (polynomial, channel) block.
"""
from __future__ import annotations

from .ntt_mxu import (_geometry, invntt_pow_invphi_fused,  # noqa: F401
                      invntt_pow_invphi_fused_plain, ntt_pow_phi_fused,
                      ntt_pow_phi_fused_plain)


def supports_fused(ring) -> bool:
    """Degrees 8..2^20 (n1, n2 <= 1024), as the JAX package's."""
    if ring.limb != "u64" or ring.degree < 8:
        return False
    return max(_geometry(ring.degree)) <= 1024
