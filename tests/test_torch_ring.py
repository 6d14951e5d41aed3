"""The port's parameter tables and ring contexts against nfllib_tpu's.

Every table is numpy on both sides, built by the same exact integer math,
so the comparison is exact equality."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
import nfllib_tpu_torch as tnfl

from conftest import CONFIG_MATRIX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL_LIMB_POINTS = [c for c in CONFIG_MATRIX if c[2] != "u64"] \
    + [(16384, 510, "u32")]

_TABLES = ("p", "pn", "p_col", "phis", "shoupphis", "invpoly_times_invphis",
           "shoupinvpoly_times_invphis", "omegas", "shoupomegas", "invomegas",
           "shoupinvomegas", "invpolyDegree", "omega_pows", "invomega_pows",
           "bitrev")


@pytest.mark.parametrize("limb", ["u16", "u32", "u64"])
def test_param_json_is_a_byte_copy(limb):
    name = f"params_{limb}.json"
    with open(os.path.join(ROOT, "nfllib_tpu", "data", name), "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "nfllib_tpu_torch", "data", name), "rb") as f:
        assert f.read() == ref
    assert dataclasses.astuple(tnfl.get_limb_params(limb)) == \
        dataclasses.astuple(nfl.get_limb_params(limb))


@pytest.mark.parametrize("degree,agg,limb", SMALL_LIMB_POINTS)
def test_ring_context_tables_match(degree, agg, limb):
    jctx = nfl.ring_from_modulus(limb, degree, agg).context()
    ring = tnfl.ring_from_modulus(limb, degree, agg)
    ctx = ring.context()
    assert (ring.limb, ring.degree, ring.nmoduli) == (
        jctx.ring.limb, jctx.ring.degree, jctx.ring.nmoduli)
    for name in _TABLES:
        a, b = getattr(ctx, name), getattr(jctx, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("phi_int", "omega_int", "stage_offsets", "lifting_integers",
                 "moduli_product"):
        assert getattr(ctx, name) == getattr(jctx, name), name


@pytest.mark.parametrize("degree,agg,limb", SMALL_LIMB_POINTS[:3])
def test_device_tables_are_widened_and_cached(degree, agg, limb):
    ctx = tnfl.ring_from_modulus(limb, degree, agg).context()
    tabs = ctx.to("cpu")
    assert ctx.to(torch.device("cpu")) is tabs
    for name in ("p_col", "shoupphis", "shoupomegas"):
        t = getattr(tabs, name)
        assert t.dtype == torch.int64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(),
                                      getattr(ctx, name).astype(np.int64))


def test_u64_tables_build_but_device_ops_refuse():
    """The u64 tier is ported: the host tables equal the JAX package's and
    RingContext.to puts them on the device as int64 bit patterns (no
    widening exists: companions >= 2^63 read negative), with the Newton
    quotient pn_col and compute_shoup's floor(2^125/p), cached per
    device."""
    ctx = tnfl.ring_from_modulus("u64", 512, 124).context()
    jctx = nfl.ring_from_modulus("u64", 512, 124).context()
    for name in _TABLES:
        np.testing.assert_array_equal(getattr(ctx, name),
                                      getattr(jctx, name), err_msg=name)
    tabs = ctx.to("cpu")
    assert ctx.to(torch.device("cpu")) is tabs
    for name in ("p_col", "pn_col", "phis", "shoupphis", "shoupomegas"):
        t = getattr(tabs, name)
        assert t.dtype == torch.int64
        assert t.numpy().view(np.uint64).tobytes() == \
            np.ascontiguousarray(getattr(ctx, name)).tobytes()
    assert bool((tabs.shoupomegas < 0).any())
    assert tabs.shoup_f.numpy().view(np.uint64).reshape(-1).tolist() == \
        [(1 << 125) // int(p) for p in ctx.ring.moduli]


def test_ring_validation_matches_reference():
    with pytest.raises(ValueError):
        tnfl.Ring("u32", 1000, 2)            # not a power of two
    with pytest.raises(ValueError):
        tnfl.Ring("u16", 1024, 1)            # above kMaxPolyDegree
    with pytest.raises(ValueError):
        tnfl.Ring("u16", 8, 3)               # above kMaxNbModuli
    with pytest.raises(ValueError):
        tnfl.ring_from_modulus("u32", 8, 61)  # not a multiple of 30
    assert tnfl.Ring("u32", 8, 2).torch_dtype == torch.int32
    assert tnfl.Ring("u16", 8, 2).torch_dtype == torch.int16
    assert tnfl.Ring("u64", 8, 2).torch_dtype == torch.int64


def test_import_loads_no_jax():
    code = ("import sys, nfllib_tpu_torch, nfllib_tpu_torch.interop, "
            "nfllib_tpu_torch.oracle, nfllib_tpu_torch.prng, "
            "nfllib_tpu_torch.golden, "
            "nfllib_tpu_torch.apps.lwe, nfllib_tpu_torch.ops.ntt_pallas, "
            "nfllib_tpu_torch.ops.ntt_pallas_u64, "
            "nfllib_tpu_torch.prng.gaussian, nfllib_tpu_torch.prng.sampling, "
            "nfllib_tpu_torch.prng.mpfr_barriers; "
            "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k == 'nfllib_tpu' or k.startswith('nfllib_tpu.')]; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
