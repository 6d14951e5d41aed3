"""The butterfly stage engine's CUDA sources (nfllib_tpu_torch/csrc:
ntt_butterfly.cuh, ntt_butterfly.cu, lwe_chain.cu) compiled with g++ for
the host against tests/cuda_host_mock.h, and their C entry points (K3/K7,
K6/K8) held to the plain twins, exact, on the CPU.

The mock runs each block's threads as std::threads with a barrier, so the
engine's rounds, swizzle, twiddle-pair indexing, prologues, epilogues and
its u64 path above 2^14 (the leading stages through device memory) run as
written; what only the card shows (that nvcc accepts the code, registers,
speed) stays with chip_smoke.py.  The library is built once per module
into pytest's temporary directory (about 15 s); without g++ the tests skip.
"""
import ctypes
import itertools
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.ops import modops
from nfllib_tpu_torch.ops import ntt_pallas as tpallas

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "nfllib_tpu_torch" / "csrc"
MOCK = pathlib.Path(__file__).resolve().parent / "cuda_host_mock.h"
P, I32 = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the engine's sources for the host")
    out = tmp_path_factory.mktemp("bfly_host")
    for name in ("ntt_butterfly.cuh", "ntt_butterfly.cu", "lwe_chain.cu"):
        s = (CSRC / name).read_text()
        s = s.replace("#include <cuda_runtime.h>", f'#include "{MOCK}"')
        s = s.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = mock_smem;")
        s = re.sub(r"([\w:]+(?:<[^;<>]*>)?)<<<(.*?)>>>\(",
                   r"mock_launch(\1, \2, ", s, flags=re.S)
        (out / name).write_text(s)
    (out / "count.cpp").write_text(
        f'#include "{MOCK}"\nextern "C" int mock_launches() '
        "{ int n = mock_launch_count; mock_launch_count = 0; return n; }\n")
    so = out / "libbfly_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-x", "c++", str(out / "ntt_butterfly.cu"),
                    str(out / "lwe_chain.cu"), str(out / "count.cpp"), "-o",
                    str(so)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    lib.nfl_ntt_butterfly.argtypes = [I32] * 4 + [P] * 5 + [I32] * 3 + [P]
    lib.nfl_lwe_encrypt.argtypes = [I32] + [P] * 12 + [I32] * 3 + [P]
    lib.nfl_lwe_decrypt.argtypes = [I32] + [P] * 8 + [I32] * 3 + [P]
    return lib


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
# 8..15, u64 at the local maximum 2^14 and above it (2^15: one stage
# through device memory)
SHAPES = [("u16", 256, 14, 2, True), ("u16", 512, 28, 2, True),
          ("u32", 1024, 60, 2, True), ("u32", 2048, 30, 1, True),
          ("u32", 8192, 30, 1, True), ("u32", 32768, 30, 1, False),
          ("u64", 256, 124, 2, True), ("u64", 16384, 62, 1, False),
          ("u64", 32768, 62, 1, False)]


@pytest.mark.parametrize("limb,degree,bits,batch,flags", SHAPES)
def test_engine_matches_twins(lib, limb, degree, bits, batch, flags):
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    ctx = ring.context()
    t = tpallas.kernel_tables(ring, "cpu")
    rng = np.random.default_rng(degree + bits)
    x = _rows(ring, rng, batch)
    lib.mock_launches()
    fwd_sets = itertools.product((False, True), repeat=3) if flags \
        else [(False, True, True)]
    for inv_tabs, twist, strict in fwd_sets:
        assert torch.equal(
            _ntt(lib, t, x, False, twist, strict, inv_tabs),
            tpallas.ntt_fwd_plain(x, ctx, inverse_tables=inv_tabs,
                                  twist=twist, strict=strict))
    for untwist, strict in (itertools.product((False, True), repeat=2)
                            if flags else [(True, True)]):
        assert torch.equal(
            _ntt(lib, t, x, True, untwist, strict),
            tpallas.intt_bwd_plain(x, ctx, untwist=untwist, strict=strict))
    lib.mock_launches()
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
    assert torch.equal(out, tpallas.lwe_decrypt_plain(ra, rb, s, sp, ctx))


def test_engine_refuses_what_the_card_refuses(lib):
    """A degree below the engine's instances (2^7) and a batch past
    grid.z's 65535 polynomials return an error, as on the card."""
    ring = tnfl.ring_from_modulus("u32", 256, 30)
    t = tpallas.kernel_tables(ring, "cpu")
    x = torch.zeros((1, t.m, t.n), dtype=torch.int32)
    out = torch.empty_like(x)
    for batch, log_n, want in ((1, 7, 1), (65536, t.log_n, 9)):
        assert lib.nfl_ntt_butterfly(32, 0, 1, 1, _p(x), _p(out), _p(t.wp),
                                     _p(t.twp), _p(t.p), batch, t.m, log_n,
                                     None) == want
