"""The elementwise u64 Shoup multiply of nfllib_tpu_torch.ops.pair_bridge
(the twin of K11, which runs on the card as one launch of E1,
csrc/modops_expr.cu) against nfllib_tpu.ops.pair_bridge and
modops.mulmod_shoup.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do;
tests/test_torch_modops_expr.py holds the route on the host-built E1 to
both, and chip_smoke.py holds it to the twin on the card.  Integer
arithmetic: exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nfllib_tpu.ops import dft_mxu as jdft
from nfllib_tpu.ops import modops as jmod
from nfllib_tpu.ops import pair_bridge as jpb
import nfllib_tpu as nfl
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.ops import dft_mxu as tdft
from nfllib_tpu_torch.ops import modops as tmod
from nfllib_tpu_torch.ops import pair_bridge as tpb

from conftest import make_ring


def _t(arr, dtype=np.uint64):
    signed = np.int64 if dtype == np.uint64 else np.int32
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)
                            .view(signed).copy())


def _np(t):
    return t.numpy().view(np.uint64 if t.dtype == torch.int64 else np.uint32)


def _operands(ring, rng, shape, R, C):
    m = ring.nmoduli
    x = np.empty(shape, dtype=np.uint64)
    tw = np.empty((m, R, C), dtype=np.uint64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        x[..., cm, :, :] = rng.integers(0, p, shape[:-3] + (R, C))
        tw[cm] = rng.integers(0, p, (R, C))
    tws = np.empty_like(tw)
    for cm in range(m):
        p = int(ring.moduli[cm])
        tws[cm] = np.array(
            [(int(v) << 64) // p for v in tw[cm].reshape(-1)],
            dtype=object).astype(np.uint64).reshape(R, C)
    return x, tw, tws


def _pairs(a):
    return ((a >> np.uint64(32)).astype(np.uint32), a.astype(np.uint32))


@pytest.mark.parametrize("R,C,B", [(8, 128, 1), (16, 256, 3), (64, 128, 1)])
def test_pair_bridge_matches_jax(R, C, B, rng):
    """mulmod_shoup_u64 and mulmod_shoup_pairs against the JAX kernel in
    interpret mode and modops.mulmod_shoup (the shapes of
    tests/test_pair_bridge.py)."""
    jr = make_ring(1024, 124, "u64")
    tr = tnfl.ring_from_modulus("u64", 1024, 124)
    m = jr.nmoduli
    shape = (B, m, R, C) if B > 1 else (m, R, C)
    x, tw, tws = _operands(jr, rng, shape, R, C)
    p3 = jnp.asarray(jr.context().p_col)[..., None]
    want = np.asarray(jmod.mulmod_shoup(
        jnp.asarray(x), jnp.asarray(tw), jnp.asarray(tws), p3))
    np.testing.assert_array_equal(
        np.asarray(jpb.mulmod_shoup_u64(x, tw, tws, jr, interpret=True)),
        want)
    got = tpb.mulmod_shoup_u64(_t(x), _t(tw), _t(tws), tr)
    np.testing.assert_array_equal(_np(got), want)
    plain = tpb.mulmod_shoup_u64_plain(_t(x), _t(tw), _t(tws), tr)
    np.testing.assert_array_equal(_np(plain), want)
    wh, wl = jpb.mulmod_shoup_pairs(_pairs(x), _pairs(tw), _pairs(tws), jr,
                                    interpret=True)
    gh, gl = tpb.mulmod_shoup_pairs(
        tuple(_t(a, np.uint32) for a in _pairs(x)),
        tuple(_t(a, np.uint32) for a in _pairs(tw)),
        tuple(_t(a, np.uint32) for a in _pairs(tws)), tr)
    np.testing.assert_array_equal(_np(gh), np.asarray(wh))
    np.testing.assert_array_equal(_np(gl), np.asarray(wl))


def test_pair_io_matmul_chain_matches_u64(rng):
    """matmul_mod pair_out -> pair bridge -> matmul_mod pair in equals the
    all-u64 chain, on both packages (tests/test_pair_bridge.py's chain, at
    a smaller degree and n1 = 8, n2 = 128: the bridge wants C % 128 == 0)."""
    jr = make_ring(1024, 124, "u64")
    tr = tnfl.ring_from_modulus("u64", 1024, 124)
    n1, n2 = 8, 128
    x, tw, tws = _operands(jr, rng, (jr.nmoduli, n1, n2), n1, n2)
    p3 = jnp.asarray(jr.context().p_col)[..., None]
    f64 = jdft.matmul_mod(x, jr, "dft_fwd", n1, axis=-2, interpret=True)
    f64 = jmod.mulmod_shoup(f64, jnp.asarray(tw), jnp.asarray(tws), p3)
    want = np.asarray(jdft.matmul_mod(f64, jr, "dft_fwd", n2, axis=-1,
                                      interpret=True))
    twp = tuple(_t(a, np.uint32) for a in _pairs(tw))
    twsp = tuple(_t(a, np.uint32) for a in _pairs(tws))
    fp = tdft.matmul_mod(_t(x), tr, "dft_fwd", n1, axis=-2, pair_out=True)
    fp = tpb.mulmod_shoup_pairs(fp, twp, twsp, tr)
    got = tdft.matmul_mod(fp, tr, "dft_fwd", n2, axis=-1)
    np.testing.assert_array_equal(_np(got), want)
    # the same chain with the twiddle as the first matmul's epilogue
    f = tdft.matmul_mod(_t(x), tr, "dft_fwd", n1, axis=-2,
                        twiddle=(_t(tw), _t(tws)))
    np.testing.assert_array_equal(
        _np(tdft.matmul_mod(f, tr, "dft_fwd", n2, axis=-1)), want)
    # and with the plain twiddle the JAX package's _large_run64 uses
    f = tdft.matmul_mod(_t(x), tr, "dft_fwd", n1, axis=-2)
    f = tmod.mulmod_shoup(f, _t(tw), _t(tws),
                          tr.context().to("cpu").p_col[..., None])
    np.testing.assert_array_equal(
        _np(tdft.matmul_mod(f, tr, "dft_fwd", n2, axis=-1)), want)


def test_surface_matches_jax():
    """supports_shape is the JAX kernel's block rule; _p_pairs its moduli
    pairs; unsupported shapes and non-u64 residues raise."""
    for R in (1, 8, 12, 16, 24, 64):
        for C in (64, 128, 200, 256):
            assert tpb.supports_shape(R, C) == jpb.supports_shape(R, C)
    jr = nfl.ring_from_modulus("u64", 1024, 186)
    tr = tnfl.ring_from_modulus("u64", 1024, 186)
    for a, b in zip(tpb._p_pairs(tr), jpb._p_pairs(jr)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    x = torch.zeros(3, 8, 64, dtype=torch.int64)
    tw = torch.zeros(3, 8, 64, dtype=torch.int64)
    with pytest.raises(ValueError, match="block"):
        tpb.mulmod_shoup_u64(x, tw, tw, tr)
    x = torch.zeros(3, 8, 128, dtype=torch.int32)
    tw = torch.zeros(3, 8, 128, dtype=torch.int64)
    with pytest.raises(ValueError, match="u64"):
        tpb.mulmod_shoup_u64(x, tw, tw, tr)
