"""The butterfly stage engine's CUDA sources (nfllib_tpu_torch/csrc:
ntt_butterfly.cuh, ntt_butterfly.cu, lwe_chain.cu) compiled with g++ for
the host against tests/cuda_host_mock.h, and their C entry points (K3/K7,
K6/K8) held to the plain twins, exact, on the CPU.

The mock runs each block's threads as std::threads with a barrier, and a
cluster's blocks together, so the engine's rounds, swizzle, twiddle-pair
indexing, prologues, epilogues and its paths past a block's shared memory
(one stage beyond it: the two-block cluster, u64 2^15 and u32 2^16; more:
the leading stages through device memory) run as written; what only the
card shows (that nvcc accepts the code, registers, speed) stays with
chip_smoke.py.  The library is built once per module
into pytest's temporary directory (about 15 s); without g++ the tests skip.
"""
import ctypes
import itertools
import types

import numpy as np
import pytest
import torch

import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import _kernels
from nfllib_tpu_torch.ops import modops
from nfllib_tpu_torch.ops import ntt_pallas as tpallas

import cuda_host_build

P, I32 = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = cuda_host_build.build(
        tmp_path_factory.mktemp("bfly_host"),
        ("ntt_butterfly.cuh", "ntt_butterfly.cu", "lwe_chain.cu"),
        ("ntt_butterfly.cu", "lwe_chain.cu"))
    lib.nfl_ntt_butterfly.argtypes = [I32] * 4 + [P] * 5 + [I32] * 3 + [P]
    lib.nfl_lwe_encrypt.argtypes = [I32] + [P] * 12 + [I32] * 3 + [P]
    lib.nfl_lwe_decrypt.argtypes = [I32] + [P] * 8 + [I32] * 3 + [P]
    lib.nfl_ntt_butterfly_path.argtypes = [I32, I32]
    return lib


def _launches_a_transform(lib, t):
    """launches of one transform by the engine's path (ntt_path): one
    block or one cluster a polynomial, or one more a global stage"""
    return 1 + t.global_stages * (lib.nfl_ntt_butterfly_path(
        t.bits, t.log_n) == 2)


def _p(t):
    return P(None if t is None else t.data_ptr())


def _rows(ring, rng, batch):
    """[batch, m, n] residues with 0 and p - 1 in every channel"""
    out = np.empty((batch, ring.nmoduli, ring.degree), dtype=np.uint64)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        out[:, cm] = rng.integers(0, p, size=(batch, ring.degree),
                                  dtype=np.uint64)
        out[:, cm, :4] = 0
        out[:, cm, -4:] = p - 1
    return torch.from_numpy(out.astype(ring.dtype).view(
        ring.limb_params.signed_dtype).copy())


def _ntt(lib, t, x, inverse, twist, strict, inverse_tables=False):
    out = torch.empty_like(x)
    wp = t.iwp if inverse or inverse_tables else t.wp
    twp = t.itwp if inverse else t.twp
    assert lib.nfl_ntt_butterfly(t.bits, int(inverse), int(twist),
                                 int(strict), _p(x), _p(out), _p(wp),
                                 _p(twp), _p(t.p), x.shape[0], t.m,
                                 t.log_n, None) == 0
    return out


# (limb, degree, modulus bits, batch, every flag set): the segment logs
# 8..15, u64 at the local maximum 2^14 and one stage above it (2^15, the
# two-block cluster; every flag at batch 2 too).  No u32 ring is longer
# than a block holds (its degrees stop at 2^15).
SHAPES = [("u16", 256, 14, 2, True), ("u16", 512, 28, 2, True),
          ("u32", 1024, 60, 2, True), ("u32", 2048, 30, 1, True),
          ("u32", 8192, 30, 1, True), ("u32", 32768, 30, 1, False),
          ("u64", 256, 124, 2, True), ("u64", 16384, 62, 1, False),
          ("u64", 32768, 62, 1, False), ("u64", 32768, 62, 2, True)]


@pytest.mark.parametrize("limb,degree,bits,batch,flags", SHAPES)
def test_engine_matches_twins(lib, limb, degree, bits, batch, flags):
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    ctx = ring.context()
    t = tpallas.kernel_tables(ring, "cpu")
    rng = np.random.default_rng(degree + bits)
    x = _rows(ring, rng, batch)
    per = _launches_a_transform(lib, t)
    lib.mock_launches()
    fwd_sets = itertools.product((False, True), repeat=3) if flags \
        else [(False, True, True)]
    for inv_tabs, twist, strict in fwd_sets:
        assert torch.equal(
            _ntt(lib, t, x, False, twist, strict, inv_tabs),
            tpallas.ntt_fwd_plain(x, ctx, inverse_tables=inv_tabs,
                                  twist=twist, strict=strict))
        assert lib.mock_launches() == per
    for untwist, strict in (itertools.product((False, True), repeat=2)
                            if flags else [(True, True)]):
        assert torch.equal(
            _ntt(lib, t, x, True, untwist, strict),
            tpallas.intt_bwd_plain(x, ctx, untwist=untwist, strict=strict))
        assert lib.mock_launches() == per
    u, e1, e2 = (_rows(ring, rng, batch) for _ in range(3))
    pka, pkb, s = (_rows(ring, rng, 1)[0] for _ in range(3))
    tabs = ctx.to("cpu")
    sp = modops.compute_shoup(s, tabs.p_col, tabs.shoup_f)
    ra, rb = torch.empty_like(u), torch.empty_like(u)
    scratch = torch.empty_like(u) if t.global_stages else None
    red = t.pn if limb == "u64" else t.bm
    assert lib.nfl_lwe_encrypt(t.bits, _p(u), _p(e1), _p(e2), _p(pka),
                               _p(pkb), _p(ra), _p(rb), _p(scratch),
                               _p(t.wp), _p(t.twp), _p(t.p), _p(red), batch,
                               t.m, t.log_n, None) == 0
    # one launch an encrypt, and 3 more a leading stage through memory
    assert lib.mock_launches() == 1 + 3 * t.global_stages
    pa, pb = tpallas.lwe_encrypt_plain(u, e1, e2, pka, pkb, ctx)
    assert torch.equal(ra, pa) and torch.equal(rb, pb)
    out = torch.empty_like(u)
    assert lib.nfl_lwe_decrypt(t.bits, _p(ra), _p(rb), _p(s), _p(sp),
                               _p(out), _p(t.iwp), _p(t.itwp), _p(t.p),
                               batch, t.m, t.log_n, None) == 0
    assert lib.mock_launches() == per
    assert torch.equal(out, tpallas.lwe_decrypt_plain(ra, rb, s, sp, ctx))


def test_engine_refuses_what_the_card_refuses(lib):
    """A degree below the engine's instances (2^7) and a batch past
    grid.z's 65535 polynomials return an error, as on the card, the latter
    for a block a polynomial and for a two-block cluster (u32 2^16; the
    launch is refused before any word is read)."""
    ring = tnfl.ring_from_modulus("u32", 256, 30)
    t = tpallas.kernel_tables(ring, "cpu")
    x = torch.zeros((1, t.m, t.n), dtype=torch.int32)
    out = torch.empty_like(x)
    for batch, log_n, want in ((1, 7, 1), (65536, t.log_n, 9),
                               (65536, 16, 9)):
        assert lib.nfl_ntt_butterfly(32, 0, 1, 1, _p(x), _p(out), _p(t.wp),
                                     _p(t.twp), _p(t.p), batch, t.m, log_n,
                                     None) == want


def test_wrappers_count_cluster_launches(lib, monkeypatch):
    """K7's wrappers and K8's decrypt on the host-built library (its
    ntt_path read through nfl_ntt_butterfly_path, as on the card): a
    transform at u64 2^15 is one launch, counted in `cluster_launches`;
    2^14 and the encrypt count none; outputs equal the twins."""
    host = _kernels.Library.__new__(_kernels.Library)
    host.lib = lib
    monkeypatch.setattr(_kernels, "library", lambda: host)
    monkeypatch.setattr(_kernels, "ntt_path",
                        _kernels.ntt_path.__wrapped__)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(_kernels._ButterflyWrapper, "_check_all",
                        lambda self, tables, shape, *xs: None)
    fwd = _kernels.ButterflyNttKernel("k7_fwd", False, ("u64",))
    inv = _kernels.ButterflyNttKernel("k7_inv", True, ("u64",))
    enc = _kernels.LweEncryptKernel("k8_enc", ("u64",))
    dec = _kernels.LweDecryptKernel("k8_dec", ("u64",))
    lib.nfl_lwe_encrypt.restype = lib.nfl_lwe_decrypt.restype = I32
    lib.nfl_ntt_butterfly.restype = I32
    for degree, want in ((16384, 0), (32768, 1)):
        ring = tnfl.ring_from_modulus("u64", degree, 62)
        ctx = ring.context()
        t = tpallas.kernel_tables(ring, "cpu")
        x = _rows(ring, np.random.default_rng(degree), 2)
        f = fwd(x, t, twist=True, strict=True)
        assert torch.equal(f, tpallas.ntt_fwd_plain(x, ctx))
        assert torch.equal(inv(f, t, twist=True, strict=True), x)
        pka, pkb, sk = (_rows(ring, np.random.default_rng(k), 1)[0]
                        for k in range(3))
        tabs = ctx.to("cpu")
        sp = modops.compute_shoup(sk, tabs.p_col, tabs.shoup_f)
        ra, rb = enc(x, x, x, pka, pkb, t)
        assert torch.equal(dec(ra, rb, sk, sp, t),
                           tpallas.lwe_decrypt_plain(ra, rb, sk, sp, ctx))
        assert (fwd.cluster_launches, inv.cluster_launches,
                enc.cluster_launches, dec.cluster_launches) == (
                    want, want, 0, want)
        assert (fwd.launches, inv.launches, dec.launches) == (
            1 + want, 1 + want, 1 + want)
