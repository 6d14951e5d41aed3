"""Strict-mod debug checks (reference include/nfl/debug.hpp).

The reference's CHECK_STRICTMOD compiles range-contract assertions into every
modular op (debug.hpp:33-37, ops.hpp:131,148,190,211 ...).  Here a global
flag, read from NFL_TPU_STRICTMOD exactly as nfllib_tpu/debug.py reads it,
turns on eager assertions that residues are < p at op boundaries.
NTT_STRICTMOD (the final reduction to [0, p), debug.hpp:31) is always on.
"""
from __future__ import annotations

import os

import numpy as np
import torch

_STRICT = os.environ.get("NFL_TPU_STRICTMOD", "0") not in ("0", "", "false")


def set_strictmod(enabled: bool) -> None:
    global _STRICT
    _STRICT = bool(enabled)


def strictmod_enabled() -> bool:
    return _STRICT


def check_residues(data, p_col) -> None:
    """Assert all residues < p (per channel).  No-op unless strict mode.

    `data` is a storage tensor (int16/int32/int64 holding unsigned bit
    patterns) or an int64 tensor of widened values.  A negative value is
    out of range: in storage it is a limb value >= 2^15 / 2^31 / 2^63, e.g.
    the kernels' poison words 0xFFFFFFFF and 0xFFFF_FFFF_FFFF_FFFF, which
    read as -1.  So the signed test below is also the right one for the u64
    tier, whose moduli are < 2^62: every word >= 2^63 reads negative."""
    if not _STRICT:
        return
    x = data.to(torch.int64)
    if not isinstance(p_col, torch.Tensor):
        p_col = torch.from_numpy(np.asarray(p_col).astype(np.int64))
    p = p_col.to(device=x.device, dtype=torch.int64)
    if not bool(torch.all((x >= 0) & (x < p))):
        raise AssertionError("STRICTMOD: residue out of [0, p) range")


def op_check(p, *operands) -> None:
    """Per-op strict-mod operand bracket (reference debug.hpp:33-37)."""
    if not _STRICT:
        return
    for d in operands:
        check_residues(d, p)
