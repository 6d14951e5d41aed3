"""The port's plain Harvey NTT and its dispatch against nfllib_tpu's jnp
path (exact equality), and the strict-mod bracket."""
import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.ops import ntt as jntt
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import debug
from nfllib_tpu_torch.ops import ntt as tntt
from nfllib_tpu_torch.ops import ntt_mxu as tmxu

from conftest import rand_residues

# degrees 2 and 4 take the plain path through the dispatch as well
HARVEY_CONFIGS = [(2, 60, "u32"), (4, 14, "u16"), (8, 60, "u32"),
                  (128, 14, "u16"), (256, 28, "u16"), (1024, 60, "u32")]


def _both(degree, agg, limb):
    return (nfl.ring_from_modulus(limb, degree, agg),
            tnfl.ring_from_modulus(limb, degree, agg))


def _t(arr, ring):
    return torch.from_numpy(np.ascontiguousarray(arr).view(
        ring.limb_params.signed_dtype).copy())


@pytest.mark.parametrize("degree,agg,limb", HARVEY_CONFIGS)
def test_harvey_ntt_and_inverse_match_jnp(degree, agg, limb, rng):
    jr, tr = _both(degree, agg, limb)
    x = rand_residues(jr, rng, batch=(2,))
    tx = _t(x, jr)
    for kw in ({}, {"inverse_tables": True}):
        want = np.asarray(jntt.ntt(x, jr.context(), **kw))
        got = tntt.ntt(tx, tr.context(), **kw).numpy().view(jr.dtype)
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jntt.inv_ntt(x, jr.context()))
    got = tntt.inv_ntt(tx, tr.context()).numpy().view(jr.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("degree,agg,limb", HARVEY_CONFIGS)
def test_ntt_pow_phi_dispatch_matches_jnp(degree, agg, limb, rng):
    jr, tr = _both(degree, agg, limb)
    assert tmxu.supports_fused(tr) == (degree >= 8)
    x = rand_residues(jr, rng, batch=(2,))
    want = np.asarray(jntt.ntt_pow_phi(x, jr.context()))
    got = tntt.ntt_pow_phi(_t(x, jr), tr.context())
    np.testing.assert_array_equal(got.numpy().view(jr.dtype), want)
    back = tntt.invntt_pow_invphi(got, tr.context())
    np.testing.assert_array_equal(back.numpy().view(jr.dtype), x)


def test_degree_one_is_identity():
    tr = tnfl.Ring("u32", 1, 2)
    x = torch.tensor([[5], [7]], dtype=torch.int32)
    assert torch.equal(tntt.ntt(x, tr.context()), x)


@pytest.mark.parametrize("degree,agg,limb", [(1024, 60, "u32"),
                                             (128, 14, "u16"),
                                             (4, 60, "u32")])
def test_strict_mode_rejects_out_of_range(degree, agg, limb, rng):
    """Values >= p, including limb values that read negative in storage,
    raise under strict mode: the forward transform on both paths, the
    inverse on the fused path (the plain inverse, like nfllib_tpu's, only
    checks its own intermediate)."""
    jr, tr = _both(degree, agg, limb)
    ctx = tr.context()
    x = _t(rand_residues(jr, rng), jr)
    debug.set_strictmod(True)
    try:
        tntt.ntt_pow_phi(x, ctx)          # in range: fine
        for v in (int(tr.moduli[0]), (1 << tr.repr_bits) - 1):
            bad = x.clone()
            bad[0, 1] = torch.tensor(v, dtype=torch.int64).to(x.dtype)
            with pytest.raises(AssertionError):
                tntt.ntt_pow_phi(bad, ctx)
            if degree >= 8:
                with pytest.raises(AssertionError):
                    tntt.invntt_pow_invphi(bad, ctx)
    finally:
        debug.set_strictmod(False)
