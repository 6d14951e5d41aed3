"""The port's u64 butterfly NTT (K7's twin, ops/ntt_pallas_u64.py) against
nfllib_tpu: the jnp path for every flag combination, and the paired-u32
Pallas kernel in interpret mode, exact equality."""
import itertools

import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.ops import ntt as jntt
from nfllib_tpu.ops import ntt_pallas_u64 as jpallas64
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.ops import modops
from nfllib_tpu_torch.ops import ntt as tntt
from nfllib_tpu_torch.ops import ntt_pallas, ntt_pallas_u64

from conftest import rand_residues

CONFIGS = [(256, 124), (512, 124), (512, 62),
           pytest.param(65536, 124, marks=pytest.mark.slow)]


def _both(degree, agg):
    return (nfl.ring_from_modulus("u64", degree, agg),
            tnfl.ring_from_modulus("u64", degree, agg))


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int64).copy())


def _np(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("degree,agg", CONFIGS)
def test_forward_and_inverse_flags_match_jnp(degree, agg, rng):
    jr, tr = _both(degree, agg)
    jctx, tctx = jr.context(), tr.context()
    x = rand_residues(jr, rng, batch=(3,))
    tx = _t(x)
    p = tctx.to("cpu").p_col
    f = np.asarray(jntt.ntt_pow_phi(x, jctx))

    def strict_of(got, strict):
        if strict:
            return got
        assert bool(modops.ult(got, 2 * p).all())
        return modops.reduce_once(got, p)
    for inv, strict in itertools.product((False, True), repeat=2):
        got = ntt_pallas_u64.ntt_fwd(tx, tctx, inverse_tables=inv,
                                     twist=False, strict=strict)
        np.testing.assert_array_equal(
            _np(strict_of(got, strict)),
            np.asarray(jntt.ntt(x, jctx, inverse_tables=inv)))
        got = ntt_pallas_u64.ntt_fwd(tx, tctx, strict=strict)
        np.testing.assert_array_equal(_np(strict_of(got, strict)), f)
    for untwist, strict in itertools.product((False, True), repeat=2):
        got = ntt_pallas_u64.intt_bwd(_t(f), tctx, untwist=untwist,
                                      strict=strict)
        want = x if untwist else np.asarray(jntt.inv_ntt(f, jctx))
        np.testing.assert_array_equal(_np(strict_of(got, strict)), want)


def test_twin_matches_interpret_kernel(rng):
    """Both directions against the paired-u32 Pallas kernel in interpret
    mode at n = 256, the inverse's lazy output included."""
    jr, tr = _both(256, 124)
    x = rand_residues(jr, rng, batch=(2,))
    np.testing.assert_array_equal(
        _np(ntt_pallas_u64.ntt_fwd(_t(x), tr.context())),
        np.asarray(jpallas64.ntt_fwd(x, jr.context(), interpret=True)))
    np.testing.assert_array_equal(
        _np(ntt_pallas_u64.intt_bwd(_t(x), tr.context(), strict=False)),
        np.asarray(jpallas64.intt_bwd(x, jr.context(), strict=False,
                                      interpret=True)))


@pytest.mark.parametrize("mode", ["butterfly", "fused"])
def test_u64_dispatch_to_butterfly(mode, rng, monkeypatch):
    """ntt / inv_ntt go to the butterfly module under butterfly and fused
    (as NFL_TPU_NTT=pallas|mxu send them to ntt_pallas_u64); ntt_pow_phi
    takes it under butterfly only."""
    monkeypatch.setenv("NFL_TORCH_NTT", mode)
    jr, tr = _both(512, 124)
    x = rand_residues(jr, rng)
    tx = _t(x)
    assert tntt._butterfly_module(tr, tx) is ntt_pallas_u64
    assert (tntt._fused_module(tr) is None) == (mode == "butterfly")
    np.testing.assert_array_equal(_np(tntt.ntt(tx, tr.context())),
                                  np.asarray(jntt.ntt(x, jr.context())))
    np.testing.assert_array_equal(_np(tntt.inv_ntt(tx, tr.context())),
                                  np.asarray(jntt.inv_ntt(x, jr.context())))
    f = tntt.ntt_pow_phi(tx, tr.context())
    np.testing.assert_array_equal(_np(f), np.asarray(
        jntt.ntt_pow_phi(x, jr.context())))
    np.testing.assert_array_equal(
        _np(tntt.invntt_pow_invphi(f, tr.context())), x)


def test_supports_and_global_stages():
    """Degrees 256..65536; above 2^14 the CUDA kernels run the leading
    stages through device memory, which the tables record."""
    assert ntt_pallas_u64.supports(tnfl.ring_from_modulus("u64", 256, 62))
    assert ntt_pallas_u64.supports(tnfl.ring_from_modulus("u64", 65536, 62))
    assert not ntt_pallas_u64.supports(
        tnfl.ring_from_modulus("u64", 131072, 62))
    assert not ntt_pallas_u64.supports(tnfl.ring_from_modulus("u64", 128, 62))
    assert not ntt_pallas_u64.supports(tnfl.ring_from_modulus("u32", 256, 60))
    for degree, g in ((16384, 0), (32768, 1), (65536, 2)):
        t = ntt_pallas.kernel_tables(tnfl.ring_from_modulus("u64", degree, 62),
                                     "cpu")
        assert t.global_stages == g and t.wp.dtype == torch.int64


def test_chains_match_interpret_kernel():
    """The u64 LWE chains (twins and entry points) against the paired-u32
    Pallas chain kernels in interpret mode at n = 512, batch 2, with 0 and
    p - 1 in every channel, exact."""
    from test_torch_ntt_pallas import chain_matches_interpret_kernels
    jr, tr = _both(512, 124)
    chain_matches_interpret_kernels(jpallas64, ntt_pallas_u64, jr, tr, 512)
