"""The u16/u32 four-step NTT against nfllib_tpu.ops.ntt_mxu.

The port runs the JAX kernels _fused_kernel / _fused_inv_kernel (K1/K2) as
the four-step route of ops/ntt_mxu.py: two launches of the u32-word square
mod-matmul kernel K9 (nfllib_tpu_torch/csrc/dft_mxu32.cu), the twiddle in
the first one's epilogue; a CPU tensor runs the same two stages' twin,
which chip_smoke.py holds the kernels to on the card.  The JAX side runs
as its own tests run it on the CPU: the Pallas kernels in interpret mode.
Everything is integer arithmetic: exact equality."""
import itertools

import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.ops import ntt_mxu as jmxu
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import debug, interop
from nfllib_tpu_torch.ops import dft_mxu as tdft
from nfllib_tpu_torch.ops import ntt as tntt
from nfllib_tpu_torch.ops import ntt_mxu as tmxu

from conftest import rand_residues

TWIN_CONFIGS = [(8, 60, "u32"), (128, 14, "u16"), (512, 14, "u16"),
                (1024, 60, "u32"), (4096, 60, "u32")]
TABLE_CONFIGS = TWIN_CONFIGS + [(16384, 510, "u32")]
ROUTE_CONFIGS = TWIN_CONFIGS + [(16, 60, "u32"), (32, 60, "u32")]


def _both(degree, agg, limb):
    return (nfl.ring_from_modulus(limb, degree, agg),
            tnfl.ring_from_modulus(limb, degree, agg))


def _t(arr, ring):
    return torch.from_numpy(np.ascontiguousarray(arr).view(
        ring.limb_params.signed_dtype).copy())


def test_geometry_and_support_match():
    for limb, lg in itertools.product(("u16", "u32", "u64"), range(0, 16)):
        n = 1 << lg
        try:
            jr = nfl.Ring(limb, n, 1)
        except ValueError:
            continue
        tr = tnfl.Ring(limb, n, 1)
        assert tmxu.supports_fused(tr) == jmxu.supports_fused(jr), (limb, n)
        if n >= 8:
            assert tmxu._geometry(n) == jmxu._fused_geometry(n, limb)[:2]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("degree,agg,limb", TABLE_CONFIGS)
def test_route_tables_equal_jax_tables(degree, agg, limb, inverse):
    """The route's matrices and twiddle are byte-equal to the JAX
    kernels' own, recovered from their digit planes by interop."""
    jr, tr = _both(degree, agg, limb)
    build = jmxu._fused_inv_tables if inverse else jmxu._fused_tables
    got = interop.fused_tables_from_numpy(build(jr))
    n1, n2 = tmxu._geometry(degree)
    d = "inv" if inverse else "fwd"
    want = (tdft._MATRIX_PROVIDERS[f"ntt64_e1_{d}"](tr, n1),
            tdft._MATRIX_PROVIDERS[f"ntt64_e2_{d}"](tr, n2),
            *tmxu._twiddle(tr, inverse))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint64 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("degree,agg,limb", ROUTE_CONFIGS)
def test_route_twin_matches_interpret_kernels(degree, agg, limb, inverse,
                                              rng):
    """The route's twin (and the public entry point on a CPU tensor)
    against the Pallas kernel in interpret mode, one direction a case,
    sides 2 and 4 (degrees 8..32) included."""
    jr, tr = _both(degree, agg, limb)
    jctx, tctx = jr.context(), tr.context()
    x = rand_residues(jr, rng, batch=(2,))
    if inverse:
        x = np.asarray(jmxu.ntt_pow_phi_fused(x, jctx, interpret=True))
        want = np.asarray(jmxu.invntt_pow_invphi_fused(x, jctx,
                                                       interpret=True))
        plain, entry = (tmxu.invntt_pow_invphi_fused_plain,
                        tmxu.invntt_pow_invphi_fused)
    else:
        want = np.asarray(jmxu.ntt_pow_phi_fused(x, jctx, interpret=True))
        plain, entry = tmxu.ntt_pow_phi_fused_plain, tmxu.ntt_pow_phi_fused
    for fn in (plain, entry):
        got = fn(_t(x, jr), tctx)
        assert got.dtype == tr.torch_dtype
        np.testing.assert_array_equal(got.numpy().view(jr.dtype), want)


@pytest.mark.parametrize("limb,agg", [("u16", 14), ("u32", 30)])
def test_small_p_part_reduction_exact(limb, agg):
    """The small-p part reduction of u32 words (dft_stage.cuh part32 with
    SMALLP, twinned by _part32(small=True)), q = mulhi64(v, floor(2^64/p)),
    is exact for a 14-bit modulus (the u16 tier's, which the kernels'
    floor(2^60/p) Barrett cannot take) as for a 30-bit one: at the extreme
    parts v < 2^51 it leaves v mod p or v mod p + p; and the whole pack and
    combine at the extreme group sums |G_k| <= n_k 128^2 1024 equals
    (sum_k 2^(8k) (G_k + n_k bias) + corr) mod p (times tw with the
    epilogue), against Python ints.  The u16 ring's tables select it."""
    ring = tnfl.ring_from_modulus(limb, 256, agg)
    assert tdft.small_p(ring) == (limb == "u16")
    assert tdft.dft_tables(ring, "dft_fwd", 8, True, "cpu").small_p == \
        (limb == "u16")
    rng = np.random.default_rng(agg)
    size = 1024
    bias = 1 << tdft._bias_bits(limb, size)
    nk = tdft._nk(4)
    lim = [n * (1 << 14) * size for n in nk]
    rows = [[s * lim[k] for k in range(7)] for s in (-1, 0, 1)]
    rows += [[rng.integers(-lim[k], lim[k] + 1) for k in range(7)]
             for _ in range(64)]
    G = np.array(rows, dtype=np.int64)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        assert p.bit_length() == agg // ring.nmoduli
        chi = (1 << 32) % p
        c = torch.tensor([p, (1 << 64) // p, chi, (chi << 32) // p])
        vs = [0, 1, p - 1, p, 2 * p - 1, p << 30, (1 << 51) - 1,
              (1 << 51) - p] + rng.integers(0, 1 << 51, 64).tolist()
        r = tdft._part32(torch.tensor(vs, dtype=torch.int64), c[0], c[1],
                         True)
        for v, got in zip(vs, r.tolist()):
            assert got % p == v % p and 0 <= got < 2 * p, (p, v, got)
        corr = int(rng.integers(0, p))
        w = int(rng.integers(0, p))
        tw = tuple(torch.tensor(v, dtype=torch.int64).to(torch.int32)
                   for v in (w, (w << 32) // p))
        Gs = [torch.from_numpy(G[:, k].copy()) for k in range(7)]
        got = tdft._pack_combine_plain32(Gs, c, torch.tensor(corr), bias,
                                         small=True)
        got_tw = tdft._pack_combine_plain32(Gs, c, torch.tensor(corr), bias,
                                            tw, small=True)
        for i in range(G.shape[0]):
            v = sum((int(G[i, k]) + nk[k] * bias) << (8 * k)
                    for k in range(7))
            assert int(got[i]) == (v + corr) % p, (cm, i)
            assert int(got_tw[i]) == (v + corr) * w % p, (cm, i)


@pytest.mark.parametrize("degree,agg,limb", [(64, 60, "u32"),
                                             (128, 14, "u16")])
def test_route_strict_poison(degree, agg, limb, rng, monkeypatch):
    """Under strict mode a twiddle that disagrees with its Shoup companion
    poisons every (polynomial, channel) block through both stages of the
    route's twin (all-ones words: 0xFFFFFFFF, u16 0xFFFF), and the bracket
    raises; without strict mode nothing is poisoned, and a valid transform
    is unchanged."""
    jr, tr = _both(degree, agg, limb)
    ctx = tr.context()
    x = _t(rand_residues(jr, rng, batch=(2,)), jr)
    debug.set_strictmod(True)
    try:
        valid = tmxu.ntt_pow_phi_fused_plain(x, ctx)
    finally:
        debug.set_strictmod(False)
    assert torch.equal(valid, tmxu.ntt_pow_phi_fused_plain(x, ctx))
    tw, tws = tmxu._twiddle_device(tr, False, torch.device("cpu"))
    broken = (torch.full_like(tw, 0x7FFFFFFF), tws)
    monkeypatch.setattr(tmxu, "_twiddle_device", lambda *args: broken)
    lax = tmxu.ntt_pow_phi_fused_plain(x, ctx)
    assert not bool((lax == -1).any())
    debug.set_strictmod(True)
    try:
        poisoned = tmxu.ntt_pow_phi_fused_plain(x, ctx)
        assert poisoned.dtype == x.dtype and bool((poisoned == -1).all())
        with pytest.raises(AssertionError):
            tntt._strict_bracket(
                lambda v: tmxu.ntt_pow_phi_fused_plain(v, ctx), x, ctx)
    finally:
        debug.set_strictmod(False)


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    """On a CPU tensor only the twin runs: the entry points launch nothing;
    the wrapper of the route's kernel (K9), at the degree-8 ring's sides 2
    and 4 and on a u16 ring's widened words, refuses it instead of falling
    back, and counts nothing."""
    from nfllib_tpu_torch import _kernels
    before = [k.launches for k in _kernels.KERNELS]
    for limb, degree, agg in (("u32", 8, 60), ("u16", 128, 14)):
        jr, tr = nfl.ring_from_modulus(limb, degree, agg), \
            tnfl.ring_from_modulus(limb, degree, agg)
        x = _t(rand_residues(jr, rng, batch=(1,)), jr)
        f = tmxu.ntt_pow_phi_fused(x, tr.context())
        assert torch.equal(f, tmxu.ntt_pow_phi_fused_plain(x, tr.context()))
        n1, n2 = tmxu._geometry(degree)
        e1 = tdft.dft_tables(tr, "ntt64_e1_fwd", n1, True, "cpu")
        e2 = tdft.dft_tables(tr, "ntt64_e2_fwd", n2, False, "cpu")
        tw = tmxu._twiddle_device(tr, False, torch.device("cpu"))
        xs = torch.zeros(1, tr.nmoduli, n1, n2, dtype=torch.int32)
        with pytest.raises(ValueError):
            _kernels.DFT_MXU32(xs, e1, tw)
        with pytest.raises(ValueError):
            _kernels.DFT_MXU32(xs, e2)
    assert [k.launches for k in _kernels.KERNELS] == before
