"""The u64 square mod-matmul's tables and plain twin against
nfllib_tpu.ops.dft_mxu.

The JAX side runs matmul_mod as its own tests run it on the CPU (the
Pallas kernel _kernel_u64 in interpret mode).  The twin is the plain
version of nfllib_tpu_torch/csrc/dft_mxu64.cu (K5); chip_smoke.py holds the
kernel to it on the card.  Integer arithmetic: exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import nfllib_tpu as nfl
from nfllib_tpu.ops import dft_mxu as jdft
from nfllib_tpu.ops import ntt_mxu_u64 as j64
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.ops import dft_mxu as tdft
from nfllib_tpu_torch.ops import ntt_mxu, ntt_mxu_u64  # noqa: F401  (registers the ntt64_* providers)


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint64)
                            .view(np.int64).copy())


def _np(t):
    return t.numpy().view(np.uint64)


def _rand(ring, rng, shape):
    """[B, m, r, c] canonical u64 residues."""
    out = np.empty(shape, dtype=np.uint64)
    for cm in range(ring.nmoduli):
        out[:, cm] = rng.integers(0, int(ring.moduli[cm]),
                                  size=(shape[0],) + shape[2:],
                                  dtype=np.uint64)
    return out


def test_supports_and_constants_match():
    for size in (4, 8, 12, 1024, 2048):
        for limb in ("u32", "u64"):
            jr, tr = nfl.Ring(limb, 4096, 1), tnfl.Ring(limb, 4096, 1)
            assert tdft.supports(tr, size) == jdft.supports(jr, size)
            assert tdft._ndig(limb) == jdft._ndig(limb)
            if size <= 1024:
                assert tdft._bias_bits(limb, size) == \
                    jdft._bias_bits(limb, size)
    # one copy of the digit builder, shared with the u32 fused tables
    v = np.random.default_rng(0).integers(0, 1 << 62, size=(5, 7),
                                          dtype=np.uint64)
    np.testing.assert_array_equal(tdft._balanced_digits_np(v, 8),
                                  jdft._balanced_digits_np(v, 8))
    assert not hasattr(ntt_mxu, "_balanced_digits_np")


@pytest.mark.parametrize("provider,size,left", [
    ("dft_fwd", 8, True), ("dft_inv", 64, False),
    ("ntt64_e1_fwd", 32, True), ("ntt64_e2_fwd", 32, False),
    ("ntt64_e1_inv", 32, False), ("ntt64_e2_inv", 32, True)])
def test_custom_tables_byte_equal(provider, size, left):
    """Digit planes, correction vectors and the per-channel constants equal
    the JAX package's (its constants as hi/lo pairs, recombined)."""
    jr, tr = nfl.Ring("u64", 1024, 2), tnfl.Ring("u64", 1024, 2)
    j64._register_large_providers()
    want = jdft._custom_tables(jr, provider, size, left)
    got = tdft._custom_tables(tr, provider, size, left)
    assert got[3:] == want[3:]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    smh, sml, ch, cl = jdft._u64_const_tables(jr, want[1], size, 8)
    consts = tdft._u64_const_tables(tr, 8)
    assert consts.tobytes() == ((smh.astype(np.uint64) << np.uint64(32))
                                | sml.astype(np.uint64)).reshape(2, 4).tobytes()
    joined = (ch.astype(np.uint64) << np.uint64(32)) | cl.astype(np.uint64)
    assert joined.reshape(2, size).tobytes() == got[1].tobytes()
    # the kernel's packed entries hold the planes byte for byte
    t = tdft.dft_tables(tr, provider, size, left, "cpu")
    planes = t.planes.numpy().view(np.int8).reshape(2, size, size, 8)
    np.testing.assert_array_equal(planes.transpose(0, 3, 1, 2), want[0])
    np.testing.assert_array_equal(
        t.plain_planes.numpy(), want[0].astype(np.float64))


@pytest.mark.parametrize("size", [8, 16, 32, 64])
@pytest.mark.parametrize("axis", [-2, -1])
def test_twin_matches_interpret_kernel(size, axis):
    """matmul_mod's twin against the JAX kernel in interpret mode, both
    axes, with a non-square other axis and a leading batch."""
    jr, tr = nfl.Ring("u64", 4096, 2), tnfl.Ring("u64", 4096, 2)
    rng = np.random.default_rng(size - axis)
    other = 24
    shape = (2, 2, size, other) if axis == -2 else (2, 2, other, size)
    x = _rand(jr, rng, shape)
    provider = "dft_inv" if size == 32 else "dft_fwd"
    want = np.asarray(jdft.matmul_mod(jnp.asarray(x), jr, provider, size,
                                      axis=axis, interpret=True))
    got = tdft.matmul_mod(_t(x), tr, provider, size, axis=axis)
    np.testing.assert_array_equal(_np(got), want)
    plain = tdft.matmul_mod_plain(_t(x[None]), tr, provider, size, axis=axis)
    np.testing.assert_array_equal(_np(plain)[0], want)


def test_pack_combine_extremes_against_python_ints():
    """The twin's exact pack + Barrett + chi-Shoup combine at the group-sum
    extremes |G_k| <= n_k 128^2 size (size 1024) equals
    (sum_k 2^(8k) (G_k + n_k bias) + corr) mod p."""
    ring = tnfl.Ring("u64", 1 << 20, 2)
    size = 1024
    bias = 1 << tdft._bias_bits("u64", size)
    nk = [min(k + 1, 15 - k, 8) for k in range(15)]
    lim = [n * (1 << 14) * size for n in nk]
    rng = np.random.default_rng(4)
    rows = [[s * lim[k] for k in range(15)] for s in (-1, 0, 1)]
    rows += [[rng.integers(-lim[k], lim[k] + 1) for k in range(15)]
             for _ in range(64)]
    G = np.array(rows, dtype=np.int64)
    consts = torch.from_numpy(tdft._u64_const_tables(ring, 8)
                              .view(np.int64).copy())
    for cm in range(2):
        p = int(ring.moduli[cm])
        corr = int(rng.integers(0, p))
        got = _np(tdft._pack_combine_plain(
            [torch.from_numpy(G[:, k].copy()) for k in range(15)],
            consts[cm], torch.tensor(corr, dtype=torch.int64), bias))
        for i in range(G.shape[0]):
            v = sum((int(G[i, k]) + nk[k] * bias) << (8 * k)
                    for k in range(15))
            assert int(got[i]) == (v + corr) % p, (cm, i)


def test_matmul_mod_refuses_what_is_not_ported():
    tr = tnfl.Ring("u64", 4096, 2)
    x = torch.zeros(1, 2, 8, 8, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="K9"):
        tdft.matmul_mod(torch.zeros(1, 2, 8, 8, dtype=torch.int32),
                        tnfl.Ring("u32", 4096, 2), "dft_fwd", 8, axis=-2)
    for kw in ({"twiddle": (x, x)}, {"pair_out": True}, {"pipelined": True}):
        with pytest.raises(NotImplementedError):
            tdft.matmul_mod(x, tr, "dft_fwd", 8, axis=-2, **kw)
    with pytest.raises(NotImplementedError):
        tdft.matmul_mod((x, x), tr, "dft_fwd", 8, axis=-2)
    with pytest.raises(ValueError):
        tdft.matmul_mod(x, tr, "dft_fwd", 16, axis=-2)
