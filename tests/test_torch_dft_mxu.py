"""The square mod-matmul's tables and plain twin (u32 and u64 tiers, the
twiddle epilogue, pair I/O, the pipelined variant) against
nfllib_tpu.ops.dft_mxu.

The JAX side runs matmul_mod as its own tests run it on the CPU (the
Pallas kernels _kernel_u64, _kernel_u32 and _kernel_u64_pipe in interpret
mode).  The twin is the plain version of nfllib_tpu_torch/csrc/dft_mxu64.cu
(K5), dft_mxu32.cu (K9) and dft_mxu64_pipe.cu (K10), all on the int8
tensor-core engine csrc/digit_mma.cuh; chip_smoke.py holds the kernels to
it on the card.  Integer arithmetic: exact equality."""
import numpy as np
import pytest
import torch

from nfllib_tpu.ring import _np_shoup_vec

import jax.numpy as jnp
import nfllib_tpu as nfl
from nfllib_tpu.ops import dft_mxu as jdft
from nfllib_tpu.ops import ntt_mxu_u64 as j64
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.ops import dft_mxu as tdft
from nfllib_tpu_torch.ops import ntt_mxu, ntt_mxu_u64  # noqa: F401  (registers the ntt64_* providers)


def _t(arr, dtype=np.uint64):
    """unsigned residues -> storage tensor (int64 for u64, int32 for u32)"""
    signed = np.int64 if dtype == np.uint64 else np.int32
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)
                            .view(signed).copy())


def _np(t):
    return t.numpy().view(np.uint64 if t.dtype == torch.int64 else np.uint32)


def _rand(ring, rng, shape):
    """[B, m, r, c] canonical residues in the ring's dtype."""
    out = np.empty(shape, dtype=np.uint64)
    for cm in range(ring.nmoduli):
        out[:, cm] = rng.integers(0, int(ring.moduli[cm]),
                                  size=(shape[0],) + shape[2:],
                                  dtype=np.uint64)
    return out.astype(ring.dtype)


def _twiddle(ring, rng, shape):
    """[m, r, c] canonical twiddles and their Shoup companions."""
    m = ring.nmoduli
    tw = np.empty((m,) + shape, dtype=np.uint64)
    tws = np.empty_like(tw)
    for cm in range(m):
        p = int(ring.moduli[cm])
        t = rng.integers(0, p, size=shape).astype(np.uint64)
        tw[cm] = t
        tws[cm] = _np_shoup_vec(t.reshape(-1), p,
                                ring.repr_bits).reshape(shape)
    return tw.astype(ring.dtype), tws.astype(ring.dtype)


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
    """What stays refused: the u16 tier (no mod-matmul in either package),
    a bad axis or size, pair I/O and the pipelined kernel on u32, a wrong
    storage dtype or twiddle shape."""
    tr = tnfl.Ring("u64", 4096, 2)
    t32 = tnfl.Ring("u32", 4096, 2)
    x = torch.zeros(1, 2, 8, 8, dtype=torch.int64)
    x32 = torch.zeros(1, 2, 8, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="u16"):
        tdft.matmul_mod(torch.zeros(1, 1, 8, 8, dtype=torch.int16),
                        tnfl.Ring("u16", 256, 1), "dft_fwd", 8, axis=-2)
    for kw in ({"pair_out": True}, {"pipelined": True}):
        with pytest.raises(ValueError, match="u64-tier"):
            tdft.matmul_mod(x32, t32, "dft_fwd", 8, axis=-2, **kw)
    with pytest.raises(ValueError, match="u64-tier"):
        tdft.matmul_mod((x32, x32), t32, "dft_fwd", 8, axis=-2)
    with pytest.raises(ValueError):
        tdft.matmul_mod(x, tr, "dft_fwd", 16, axis=-2)
    with pytest.raises(ValueError):
        tdft.matmul_mod(x, tr, "dft_fwd", 8, axis=0)
    with pytest.raises(ValueError):
        tdft.matmul_mod(x.to(torch.int32), tr, "dft_fwd", 8, axis=-2)
    bad = torch.zeros(2, 8, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="twiddle"):
        tdft.matmul_mod(x, tr, "dft_fwd", 8, axis=-2, twiddle=(bad, bad))


@pytest.mark.parametrize("provider,size,left", [
    ("dft_fwd", 8, True), ("dft_inv", 64, False), ("dft_fwd", 16, False),
    ("dft_inv", 32, True)])
def test_custom_tables_u32_byte_equal(provider, size, left):
    """The u32 tier's digit planes, correction vectors and recombination
    constants [floor(2^60/p), chi, floor(chi 2^32/p)] equal the JAX
    package's; the kernels' packed words hold the planes byte for byte."""
    jr, tr = nfl.Ring("u32", 1024, 3), tnfl.Ring("u32", 1024, 3)
    want = jdft._custom_tables(jr, provider, size, left)
    got = tdft._custom_tables(tr, provider, size, left)
    assert got[3:] == want[3:] and got[4] == 4
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    t = tdft.dft_tables(tr, provider, size, left, "cpu")
    assert t.planes.dtype == torch.int32 and t.ndig == 4
    planes = t.planes.numpy().view(np.int8).reshape(3, size, size, 4)
    np.testing.assert_array_equal(planes.transpose(0, 3, 1, 2), want[0])
    np.testing.assert_array_equal(t.consts.numpy()[:, 1:], want[2][:, :3])
    np.testing.assert_array_equal(
        t.consts.numpy()[:, 0], np.array([int(p) for p in tr.moduli]))


@pytest.mark.parametrize("size", [8, 16, 64])
@pytest.mark.parametrize("axis", [-2, -1])
def test_u32_twin_matches_interpret_kernel(size, axis):
    """K9's twin against the JAX kernel _kernel_u32 in interpret mode, both
    axes, a non-square other axis and a leading batch."""
    jr, tr = nfl.Ring("u32", 4096, 3), tnfl.Ring("u32", 4096, 3)
    rng = np.random.default_rng(size + axis)
    other = 24
    shape = (2, 3, size, other) if axis == -2 else (2, 3, other, size)
    x = _rand(jr, rng, shape)
    provider = "dft_inv" if size == 16 else "dft_fwd"
    want = np.asarray(jdft.matmul_mod(jnp.asarray(x), jr, provider, size,
                                      axis=axis, interpret=True))
    got = tdft.matmul_mod(_t(x, np.uint32), tr, provider, size, axis=axis)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("limb,agg", [("u32", 60), ("u64", 124)])
def test_twisted_providers_match_interpret_kernel(limb, agg):
    """The four-step column matrices with the phi twist folded in
    (parallel/ntt_dist.py's providers) through the twin, against the JAX
    kernel on its own providers."""
    from nfllib_tpu.parallel import ntt_dist as jnd
    from nfllib_tpu_torch.parallel import ntt_dist  # noqa: F401  (registers)
    jnd._ensure_twisted_providers()
    jr, tr = nfl.Ring(limb, 256, agg // 30 if limb == "u32" else 2), \
        tnfl.Ring(limb, 256, agg // 30 if limb == "u32" else 2)
    rng = np.random.default_rng(7)
    x = _rand(jr, rng, (1, jr.nmoduli, 16, 8))
    for provider in ("fourstep_col_fwd_tw", "fourstep_col_inv_tw"):
        want = np.asarray(jdft.matmul_mod(jnp.asarray(x), jr, provider, 16,
                                          axis=-2, interpret=True))
        got = tdft.matmul_mod(_t(x, jr.dtype), tr, provider, 16, axis=-2)
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("limb,agg", [("u32", 60), ("u64", 124)])
@pytest.mark.parametrize("axis", [-2, -1])
def test_twiddle_epilogue_matches_interpret_kernel(limb, agg, axis):
    """matmul_mod(twiddle=) against the JAX kernel's epilogue in interpret
    mode, and equal to the matmul followed by a plain mulmod_shoup (both
    tiers, both sides; tests/test_parallel.py's check on the port)."""
    jr, tr = nfl.ring_from_modulus(limb, 256, agg), \
        tnfl.ring_from_modulus(limb, 256, agg)
    rng = np.random.default_rng(11)
    size = 16
    m = jr.nmoduli
    x = _rand(jr, rng, (1, m, size, size))
    tw, tws = _twiddle(jr, rng, (size, size))
    want = np.asarray(jdft.matmul_mod(x, jr, "dft_fwd", size, axis=axis,
                                      interpret=True, twiddle=(tw, tws)))
    got = tdft.matmul_mod(_t(x, jr.dtype), tr, "dft_fwd", size, axis=axis,
                          twiddle=(_t(tw, jr.dtype), _t(tws, jr.dtype)))
    np.testing.assert_array_equal(_np(got), want)
    from nfllib_tpu_torch.ops import modops
    plain = tdft.matmul_mod(_t(x, jr.dtype), tr, "dft_fwd", size, axis=axis)
    p3 = tr.context().to("cpu").p_col[..., None]
    np.testing.assert_array_equal(_np(modops.mulmod_shoup(
        plain, _t(tw, jr.dtype), _t(tws, jr.dtype), p3)), want)


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("twiddle", [False, True])
def test_pipelined_matches_interpret_kernel(axis, twiddle, monkeypatch):
    """pipelined=True (K10; on the CPU K5's twin) against the JAX
    pipelined kernel _kernel_u64_pipe in interpret mode, and equal to
    pipelined=False; NFL_TORCH_DFT_PIPE=1 turns it on by default."""
    jr, tr = nfl.ring_from_modulus("u64", 256, 124), \
        tnfl.ring_from_modulus("u64", 256, 124)
    rng = np.random.default_rng(13)
    size, B = 16, 2
    x = _rand(jr, rng, (B, jr.nmoduli, size, size))
    kw, tkw = {}, {}
    if twiddle:
        tw, tws = _twiddle(jr, rng, (size, size))
        kw["twiddle"] = (tw, tws)
        tkw["twiddle"] = (_t(tw), _t(tws))
    want = np.asarray(jdft.matmul_mod(x, jr, "dft_fwd", size, axis=axis,
                                      interpret=True, pipelined=True, **kw))
    got = tdft.matmul_mod(_t(x), tr, "dft_fwd", size, axis=axis,
                          pipelined=True, **tkw)
    np.testing.assert_array_equal(_np(got), want)
    off = tdft.matmul_mod(_t(x), tr, "dft_fwd", size, axis=axis,
                          pipelined=False, **tkw)
    np.testing.assert_array_equal(_np(off), want)
    monkeypatch.setenv("NFL_TORCH_DFT_PIPE", "1")
    assert tdft.pipe_default()
    monkeypatch.setenv("NFL_TORCH_DFT_PIPE", "0")
    assert not tdft.pipe_default()


def test_pair_io_matches_interpret_kernel():
    """x as an (xh, xl) tuple and pair_out=True give the JAX kernel's pair
    planes; the u64 words merge and split exactly."""
    jr, tr = nfl.ring_from_modulus("u64", 256, 124), \
        tnfl.ring_from_modulus("u64", 256, 124)
    rng = np.random.default_rng(17)
    x = _rand(jr, rng, (2, jr.nmoduli, 16, 8))
    xp = ((x >> np.uint64(32)).astype(np.uint32), x.astype(np.uint32))
    wh, wl = jdft.matmul_mod(xp, jr, "dft_fwd", 16, axis=-2, interpret=True,
                             pair_out=True)
    gh, gl = tdft.matmul_mod((_t(xp[0], np.uint32), _t(xp[1], np.uint32)),
                             tr, "dft_fwd", 16, axis=-2, pair_out=True)
    assert gh.dtype == gl.dtype == torch.int32
    np.testing.assert_array_equal(_np(gh), np.asarray(wh))
    np.testing.assert_array_equal(_np(gl), np.asarray(wl))
    v = _t(x)
    assert torch.equal(tdft.merge_pair(tdft.split_pair(v)), v)
    full = tdft.matmul_mod(v, tr, "dft_fwd", 16, axis=-2)
    assert torch.equal(tdft.merge_pair((gh, gl)), full)


def test_u32_pack_combine_extremes_against_python_ints():
    """The u32 twin's pack + Barrett + chi-Shoup combine at the group-sum
    extremes |G_k| <= n_k 128^2 size (size 1024), with and without the
    twiddle epilogue, equals (sum_k 2^(8k) (G_k + n_k bias) + corr) mod p
    (times tw)."""
    ring = tnfl.Ring("u32", 1 << 14, 3)
    size = 1024
    bias = 1 << tdft._bias_bits("u32", size)
    nk = [min(k + 1, 7 - k, 4) for k in range(7)]
    lim = [n * (1 << 14) * size for n in nk]
    rng = np.random.default_rng(5)
    rows = [[s * lim[k] for k in range(7)] for s in (-1, 0, 1)]
    rows += [[rng.integers(-lim[k], lim[k] + 1) for k in range(7)]
             for _ in range(64)]
    G = np.array(rows, dtype=np.int64)
    t = tdft.dft_tables(ring, "dft_fwd", size, True, "cpu")
    for cm in range(3):
        p = int(ring.moduli[cm])
        corr = int(rng.integers(0, p))
        w = int(rng.integers(0, p))
        tw = (torch.tensor(w, dtype=torch.int32),
              torch.tensor(((w << 32) // p) - (1 << 32) if (w << 32) // p
                           >= 1 << 31 else (w << 32) // p,
                           dtype=torch.int32))
        Gs = [torch.from_numpy(G[:, k].copy()) for k in range(7)]
        got = tdft._pack_combine_plain32(
            Gs, t.consts[cm], torch.tensor(corr), bias).numpy()
        got_tw = tdft._pack_combine_plain32(
            Gs, t.consts[cm], torch.tensor(corr), bias, tw).numpy()
        for i in range(G.shape[0]):
            v = sum((int(G[i, k]) + nk[k] * bias) << (8 * k)
                    for k in range(7))
            assert int(got[i]) == (v + corr) % p, (cm, i)
            assert int(got_tw[i]) == (v + corr) * w % p, (cm, i)


def test_new_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor only the twins run: the wrappers of K9, K10 and K5's
    epilogue refuse it instead of falling back, and count nothing.  K11
    has no wrapper of its own: on the card it is one E1 launch
    (ops/pair_bridge.py:_route)."""
    from nfllib_tpu_torch import _kernels
    t64 = tdft.dft_tables(tnfl.Ring("u64", 64, 2), "dft_fwd", 8, True, "cpu")
    t32 = tdft.dft_tables(tnfl.Ring("u32", 64, 2), "dft_fwd", 8, True, "cpu")
    x64 = torch.zeros(1, 2, 8, 8, dtype=torch.int64)
    x32 = torch.zeros(1, 2, 8, 8, dtype=torch.int32)
    tw = torch.zeros(2, 8, 8, dtype=torch.int64)
    before = [k.launches for k in _kernels.KERNELS]
    for call in (lambda: _kernels.DFT_MXU32(x32, t32),
                 lambda: _kernels.DFT_MXU64_PIPE(x64, t64),
                 lambda: _kernels.DFT_MXU64_TW(x64, t64, (tw, tw))):
        with pytest.raises(ValueError):
            call()
    assert [k.launches for k in _kernels.KERNELS] == before
    names = {k.name for k in _kernels.KERNELS}
    assert {"dft_mxu32", "dft_mxu64_pipe", "dft_mxu64_twiddle",
            "modops_expr"} <= names
    assert "pair_bridge64" not in names


def _unchunk(v):
    """[..., kp / 32, rows, 32] planes as the kernels store them (k-chunked,
    the 16-byte halves of rows 4..7 mod 8 swapped) -> [..., rows, kp]"""
    *lead, nc, rows, kc = v.shape
    swap = ((torch.arange(rows) >> 2) & 1).bool()
    h = v.reshape(*lead, nc, rows, 2, kc // 2).clone()
    h[..., swap, :, :] = h[..., swap, :, :].flip(-2)
    return h.reshape(*lead, nc, rows, kc).transpose(-3, -2).reshape(
        *lead, rows, nc * kc)


def _jax_providers():
    from nfllib_tpu.parallel import ntt_dist as jnd
    from nfllib_tpu_torch.parallel import ntt_dist  # noqa: F401  (registers)
    j64._register_large_providers()
    jnd._ensure_twisted_providers()


def _mma_planes_case(limb, provider, size, left):
    """mma_planes of one table against the JAX package's balanced digits
    of the same provider matrix"""
    _jax_providers()
    nd = 8 if limb == "u64" else 4
    deg = size * size if limb == "u64" else min(size * size, 32768)
    jr, tr = nfl.Ring(limb, deg, 2), tnfl.Ring(limb, deg, 2)
    digits = jdft._balanced_digits_np(
        jdft._MATRIX_PROVIDERS[provider](jr, size), nd)    # [a, m, i, j]
    want = digits.transpose(1, 0, 2, 3) if left \
        else digits.transpose(1, 0, 3, 2)
    t = tdft.dft_tables(tr, provider, size, left, "cpu")
    assert t.mma_planes.dtype == torch.int8 and t.kp == max(size, 32)
    assert t.mma_planes.shape == (2, nd, t.kp // 32, size, 32)
    got = _unchunk(t.mma_planes).numpy()
    np.testing.assert_array_equal(got[..., :size], want)
    assert not got[..., size:].any()


@pytest.mark.parametrize("provider", ["dft_fwd", "ntt64_e1_fwd",
                                      "ntt64_e2_inv", "fourstep_col_fwd_tw"])
@pytest.mark.parametrize("size", [8, 128, 1024])
@pytest.mark.parametrize("left", [True, False])
def test_mma_planes_are_jax_digits_k_major(provider, size, left):
    """K5/K10's operand planes are the JAX package's balanced digits of the
    same provider matrix, K-major for the side: left [a][r][k] = W_a[r][k],
    right [a][c][k] = W_a[k][c]; zero past the contraction (kp =
    max(size, 32)); stored in k-chunks of 32, [m, 8, kp / 32, size, 32],
    with the 16-byte halves of rows 4..7 mod 8 swapped."""
    _mma_planes_case("u64", provider, size, left)


@pytest.mark.parametrize("provider", ["dft_fwd", "dft_inv",
                                      "fourstep_col_fwd_tw"])
@pytest.mark.parametrize("size", [8, 128, 1024])
@pytest.mark.parametrize("left", [True, False])
def test_mma_planes_u32_are_jax_digits_k_major(provider, size, left):
    """K9's operand planes: the JAX package's 4 balanced u32 digits of the
    same provider, K-major for the side, [m, 4, kp / 32, size, 32],
    chunked and swizzled as the u64 tier's."""
    _mma_planes_case("u32", provider, size, left)


def _operand_order(x, t, twiddle=None):
    """The arithmetic of K5/K9/K10 in their operand order, for the tests:
    x's ndig offset-byte planes split K-major ([B, m, ndig, other, kp],
    zero past the contraction, as the kernels' digit_split writes them,
    there in swizzled k-chunks), the 2 ndig - 1 group sums as ndig^2 int64
    matmuls of those planes with the table's mma_planes (table plane a
    with digit plane b into group a + b, both operands contracted along
    their last axis), then _pack_combine_plain (u64: 64 products into 15
    groups) or _pack_combine_plain32 (u32: 16 products into 7 groups)."""
    B, m, r, c = x.shape
    nd = t.ndig
    xk = x.to(torch.int64)
    xk = xk.transpose(-1, -2) if t.left else xk        # [B, m, other, size]
    d = torch.stack([((xk >> (8 * b)) & 0xFF) - 128 for b in range(nd)],
                    dim=2)
    d = torch.nn.functional.pad(d, (0, t.kp - t.size))
    planes = _unchunk(t.mma_planes).to(torch.int64)     # [m, nd, size, kp]
    G = [torch.zeros((B, m, r, c), dtype=torch.int64)
         for _ in range(2 * nd - 1)]
    for a in range(nd):
        for b in range(nd):
            P, Q = (planes[:, a], d[:, :, b]) if t.left \
                else (d[:, :, b], planes[:, a])
            G[a + b] += torch.matmul(P, Q.transpose(-1, -2))
    corr = t.corr.view(1, m, r, 1) if t.left else t.corr.view(1, m, 1, c)
    consts = t.consts.view(1, m, 1, 1, 4)
    if nd == 8:
        return tdft._pack_combine_plain(G, consts, corr, t.bias, twiddle)
    return tdft._pack_combine_plain32(G, consts, corr, t.bias,
                                      twiddle).to(torch.int32)


@pytest.mark.parametrize("size", [8, 128])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("twiddle", [False, True])
def test_operand_order_matches_twin_and_interpret_kernel(size, axis,
                                                         twiddle):
    """The kernels' operand order (K-major digit planes, padded k-chunks,
    64 products into 15 groups) equals matmul_plain and the JAX kernel in
    interpret mode, with and without the twiddle epilogue."""
    jr, tr = nfl.Ring("u64", 4096, 2), tnfl.Ring("u64", 4096, 2)
    rng = np.random.default_rng(size + 3 * axis + 7 * twiddle)
    other = 16
    shape = (2, 2, size, other) if axis == -2 else (2, 2, other, size)
    x = _rand(jr, rng, shape)
    kw, tkw = {}, {}
    if twiddle:
        tw, tws = _twiddle(jr, rng, shape[2:])
        kw["twiddle"] = (tw, tws)
        tkw["twiddle"] = (_t(tw), _t(tws))
    want = np.asarray(jdft.matmul_mod(x, jr, "dft_fwd", size, axis=axis,
                                      interpret=True, **kw))
    t = tdft.dft_tables(tr, "dft_fwd", size, axis == -2, "cpu")
    got = _operand_order(_t(x), t, tkw.get("twiddle"))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(tdft.matmul_plain(_t(x), t, tkw.get("twiddle"))), want)


@pytest.mark.parametrize("size", [8, 128])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("fill", ["zero", "p-1"])
def test_extreme_inputs_against_python_ints(size, axis, fill):
    """x = 0 (every offset digit -128, the corr vector alone) and x = p - 1
    through matmul_plain and the operand order, against M @ X mod p (or
    X @ M) in Python ints."""
    tr = tnfl.Ring("u64", 4096, 2)
    m, other = 2, 16
    shape = (1, m, size, other) if axis == -2 else (1, m, other, size)
    x = np.zeros(shape, dtype=np.uint64)
    if fill == "p-1":
        for cm in range(m):
            x[:, cm] = int(tr.moduli[cm]) - 1
    mats = tdft._MATRIX_PROVIDERS["dft_fwd"](tr, size)
    t = tdft.dft_tables(tr, "dft_fwd", size, axis == -2, "cpu")
    got_plain = _np(tdft.matmul_plain(_t(x), t))
    got_order = _np(_operand_order(_t(x), t))
    for cm in range(m):
        p = int(tr.moduli[cm])
        M, X = mats[cm].astype(object), x[0, cm].astype(object)
        want = (M @ X if axis == -2 else X @ M) % p
        np.testing.assert_array_equal(got_plain[0, cm].astype(object), want)
        np.testing.assert_array_equal(got_order[0, cm].astype(object), want)


@pytest.mark.parametrize("size", [8, 128])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("twiddle", [False, True])
def test_u32_operand_order_matches_twin_and_interpret_kernel(size, axis,
                                                             twiddle):
    """K9's operand order (4 K-major digit planes a side, padded k-chunks,
    16 products into 7 groups, then _pack_combine_plain32) equals
    matmul_plain and the JAX kernel _kernel_u32 in interpret mode, with and
    without the twiddle epilogue."""
    jr, tr = nfl.Ring("u32", 4096, 3), tnfl.Ring("u32", 4096, 3)
    rng = np.random.default_rng(size + 5 * (axis + 2) + 11 * twiddle)
    other = 16
    shape = (2, 3, size, other) if axis == -2 else (2, 3, other, size)
    x = _rand(jr, rng, shape)
    kw, tkw = {}, {}
    if twiddle:
        tw, tws = _twiddle(jr, rng, shape[2:])
        kw["twiddle"] = (tw, tws)
        tkw["twiddle"] = (_t(tw, np.uint32), _t(tws, np.uint32))
    want = np.asarray(jdft.matmul_mod(x, jr, "dft_fwd", size, axis=axis,
                                      interpret=True, **kw))
    t = tdft.dft_tables(tr, "dft_fwd", size, axis == -2, "cpu")
    xt = _t(x, np.uint32)
    got = _operand_order(xt, t, tkw.get("twiddle"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(tdft.matmul_plain(xt, t, tkw.get("twiddle"))), want)


@pytest.mark.parametrize("limb", ["u32", "u64"])
@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("axis", [-2, -1])
def test_small_sizes_operand_order_against_python_ints(limb, size, axis):
    """Sizes 2 and 4 (the u64 NTT's degrees 8..32 run them; matmul_mod
    refuses them, as the JAX package does): one k-chunk of 32 with zero
    digits past the contraction, through the operand order, the twin and
    ntt_stage, against M @ X mod p (or X @ M) in Python ints."""
    tr = tnfl.ring_from_modulus(limb, 64, 124 if limb == "u64" else 60)
    m, other = tr.nmoduli, 3
    shape = (2, m, size, other) if axis == -2 else (2, m, other, size)
    x = _rand(tr, np.random.default_rng(size - axis), shape)
    mats = tdft._MATRIX_PROVIDERS["dft_fwd"](tr, size)
    t = tdft.dft_tables(tr, "dft_fwd", size, axis == -2, "cpu")
    assert t.kp == 32 and t.mma_planes.shape[2:] == (1, size, 32)
    xt = _t(x, tr.dtype)
    with pytest.raises(ValueError):
        tdft.matmul_mod(xt, tr, "dft_fwd", size, axis=axis)
    outs = [_operand_order(xt, t), tdft.matmul_plain(xt, t),
            tdft.ntt_stage(xt, tr, "dft_fwd", size, axis=axis)]
    for b in range(2):
        for cm in range(m):
            p = int(tr.moduli[cm])
            M, X = mats[cm].astype(object), x[b, cm].astype(object)
            want = (M @ X if axis == -2 else X @ M) % p
            for got in outs:
                np.testing.assert_array_equal(
                    _np(got)[b, cm].astype(object), want)


@pytest.mark.parametrize("limb", ["u32", "u64"])
def test_strict_twin_poisons_slabs(limb):
    """matmul_plain(strict=True) turns a (polynomial, channel) slab with an
    input or an output not below p into all-ones words, as the kernels
    poison it, and leaves the other slabs as they were."""
    tr = tnfl.ring_from_modulus(limb, 64, 124 if limb == "u64" else 60)
    rng = np.random.default_rng(19)
    x = _rand(tr, rng, (2, tr.nmoduli, 8, 8))
    t = tdft.dft_tables(tr, "dft_fwd", 8, True, "cpu")
    xt = _t(x, tr.dtype)
    clean = tdft.matmul_plain(xt, t)
    assert torch.equal(tdft.matmul_plain(xt, t, strict=True), clean)
    bad = xt.clone()
    bad[1, 0, 3, 5] = int(tr.moduli[0])              # an input equal to p
    got = tdft.matmul_plain(bad, t, strict=True)
    assert bool((got[1, 0] == -1).all())
    assert torch.equal(got[0], clean[0]) and torch.equal(got[1, 1:],
                                                         clean[1, 1:])
    # a twiddle that disagrees with its Shoup companion breaks the output's
    # contract in slab (0, 1)
    tw, tws = (_t(a, tr.dtype) for a in _twiddle(tr, rng, (8, 8)))
    lax = tdft.matmul_plain(xt, t, (tw, tws))
    broken = tw.clone()
    broken[1] = -1 >> 1 if limb == "u64" else 0x7FFFFFFF
    got = tdft.matmul_plain(xt, t, (broken, tws), strict=True)
    assert bool((got[:, 1] == -1).all()) and torch.equal(got[:, 0],
                                                         lax[:, 0])


def test_batch_chunks_split_at_grid_limit_and_reassemble():
    """The wrappers launch at most MAX_BATCH = 65535 polynomials at a time
    (the kernels put the batch on grid.z): batch_chunks covers the batch
    in order, and _launch_chunks, with a fake launcher standing in for the
    C entry point, hands each chunk's slices of the batched tensors
    (None stays None) and reassembles the output exactly."""
    from nfllib_tpu_torch import _kernels
    assert _kernels.MAX_BATCH == 65535
    assert _kernels.batch_chunks(0) == []
    assert _kernels.batch_chunks(65535) == [(0, 65535)]
    assert _kernels.batch_chunks(65536) == [(0, 65535), (65535, 65536)]
    assert _kernels.batch_chunks(2 * 65535 + 3) == [
        (0, 65535), (65535, 131070), (131070, 131073)]
    batch = 2 * 65535 + 3
    x = torch.arange(batch * 2, dtype=torch.int64).view(batch, 1, 2)
    out = torch.zeros_like(x)
    w = _kernels._Wrapper("fake")
    calls = []

    def fake_launch(first, entry, xc, oc, sc, nb):
        assert entry == "nfl_fake" and sc is None and first.shape == x.shape
        calls.append(nb)
        oc.copy_(3 * xc + 1)

    w._launch = fake_launch
    w._launch_chunks((x, out, None), "nfl_fake",
                     lambda xc, oc, sc, nb: (xc, oc, sc, nb))
    assert calls == [65535, 65535, 3]
    assert torch.equal(out, 3 * x + 1)
