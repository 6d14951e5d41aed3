"""The distributed four-step NTT of nfllib_tpu_torch.parallel against
nfllib_tpu.parallel.

Single-process parts (the four-step tables, the twisted column matrices,
four_step_reference{,_inverse}) run here.  The distributed parts run in
gloo process groups of d = 2 and 4 ranks, each rank a fresh `python -c`
process that imports torch, numpy and the port only (never this file,
conftest or jax): it reads the global inputs from .npy files, cuts its
column block, runs every check and writes its output blocks back.  The
parent gathers the blocks and holds them against the JAX package's
distributed transform on the 8-device virtual CPU mesh.  Integer
arithmetic: exact equality throughout."""
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import nfllib_tpu as nfl
from nfllib_tpu.parallel import api as japi
from nfllib_tpu.parallel import ntt_dist as jnd
from nfllib_tpu.utils import bitrev_indices
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import interop
from nfllib_tpu_torch.ops import dft_mxu as tdft
from nfllib_tpu_torch.ops import ntt as tntt
from nfllib_tpu_torch.parallel import api as tapi
from nfllib_tpu_torch.parallel import ntt_dist as tnd

from conftest import rand_residues

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEV = "cpu"
CHILD_TIMEOUT = 120          # seconds, per rank process
BATCH = 3                    # transforms in the pipelined entry
# (name, limb, degree, modulus bits, n1): the distributed cases
CASES = (("u32", "u32", 1024, 60, 32), ("u64", "u64", 256, 124, 16))
API_RING = ("u32", 256, 120)          # 4 channels, for the mesh API
# parallel/dryrun.py at small sizes: the LWE ring, part 2's u64 ring, the
# mesh of each group size (default: api.mesh_shape) and the counts it reads
DRY_LWE = ("u32", 256, 60)
DRY_BIG = ("u64", 1 << 10, 2)
DRY_SHAPES = {2: (1, 1, 2)}
DRY_COUNTS = ("fwd", "fwd_chunks", "fwd_ppermute", "inv_chunks")
CHECKS = ("fwd", "fwd_plain", "fwd_ppermute", "fwd_chunks", "inv",
          "inv_plain", "inv_ppermute", "inv_chunks", "prod", "pipe")


def _ring(limb, degree, bits):
    return nfl.ring_from_modulus(limb, degree, bits), \
        tnfl.ring_from_modulus(limb, degree, bits)


def _t(arr, ring):
    """unsigned numpy residues of any shape -> storage tensor"""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=ring.dtype))
    return torch.from_numpy(arr.view(ring.limb_params.signed_dtype).copy())


def _np(t, ring):
    return t.numpy().view(ring.dtype)


# ---------------------------------------------------------------------------
# single process: tables and the four-step math
# ---------------------------------------------------------------------------

TABLE_NAMES = ("p_col", "col_w", "col_ws", "col_iw", "col_iws", "row_w",
               "row_ws", "row_iw", "row_iws", "phis", "shoupphis", "ivp",
               "ivp_s", "rev1", "rev2", "twiddle", "twiddle_s", "itwiddle",
               "itwiddle_s", "twiddle_tw", "twiddle_tw_s", "itwiddle_tw",
               "itwiddle_tw_s")


@pytest.mark.parametrize("degree,agg,limb,n1", [
    (64, 60, "u32", 8), (256, 60, "u32", 16), (256, 14, "u16", 16),
    (64, 124, "u64", 8), (1024, 124, "u64", 64)])
def test_four_step_tables_byte_equal(degree, agg, limb, n1):
    jr, tr = _ring(limb, degree, agg)
    jf = jnd.get_four_step_context(jr, n1, degree // n1)
    tf = tnd.get_four_step_context(tr, n1, degree // n1)
    for name in TABLE_NAMES:
        a, b = np.asarray(getattr(jf, name)), np.asarray(getattr(tf, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("limb,agg", [("u32", 60), ("u64", 124)])
@pytest.mark.parametrize("inverse", [False, True])
def test_colmat_twisted_byte_equal(limb, agg, inverse):
    jr, tr = _ring(limb, 1024, agg)
    for size in (8, 32):
        want = jnd._colmat_twisted(jr, size, inverse)
        got = tnd._colmat_twisted(tr, size, inverse)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # the registered providers feed the port's mod-matmul tables
    name = "fourstep_col_inv_tw" if inverse else "fourstep_col_fwd_tw"
    from nfllib_tpu.ops import dft_mxu as jdft
    jnd._ensure_twisted_providers()
    want = jdft._custom_tables(jr, name, 32, True)
    got = tdft._custom_tables(tr, name, 32, True)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got[:3], want[:3]))


@pytest.mark.parametrize("degree,agg,limb,n1", [
    (64, 60, "u32", 8), (256, 60, "u32", 16), (256, 14, "u16", 16),
    (64, 124, "u64", 8)])
@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_four_step_reference_matches_jax_and_harvey(degree, agg, limb, n1,
                                                    mode, rng, monkeypatch):
    jr, tr = _ring(limb, degree, agg)
    x = rand_residues(jr, rng)
    n2 = degree // n1
    want = np.asarray(jnd.four_step_reference(x, jr, n1))
    monkeypatch.setenv("NFL_TORCH_NTT", mode)
    four = _np(tnd.four_step_reference(_t(x, tr), tr, n1), jr)
    np.testing.assert_array_equal(four, want)
    # harvey[j] = E[bitrev_n(j)]; four[k1, k2] = E[k1 + n1*k2], against the
    # port's single-chip transform
    harvey = _np(tntt.ntt_pow_phi(_t(x, tr), tr.context()), jr)
    E = four.reshape(tr.nmoduli, n1, n2).transpose(0, 2, 1).reshape(
        tr.nmoduli, degree)
    np.testing.assert_array_equal(harvey, E[:, bitrev_indices(degree)])


@pytest.mark.parametrize("degree,agg,limb,n1", [
    (64, 60, "u32", 8), (256, 60, "u32", 16), (1024, 124, "u64", 32)])
def test_four_step_reference_inverse_matches_jax(degree, agg, limb, n1, rng):
    jr, tr = _ring(limb, degree, agg)
    x = rand_residues(jr, rng)
    y = np.asarray(jnd.four_step_reference(x, jr, n1))
    want = np.asarray(jnd.four_step_reference_inverse(jnp.asarray(y), jr, n1))
    np.testing.assert_array_equal(want, x)
    got = tnd.four_step_reference_inverse(_t(y, tr), tr, n1)
    np.testing.assert_array_equal(_np(got, jr), want)


def test_degenerate_four_step_split_raises():
    tr = tnfl.ring_from_modulus("u32", 16, 60)
    for n1, n2 in ((1, 16), (16, 1), (4, 8)):
        with pytest.raises(ValueError, match="four-step factors"):
            tnd.get_four_step_context(tr, n1, n2)


def test_dispatch_and_transpose_resolution(monkeypatch):
    """auto/fused give the local DFTs to the mod-matmul (kernels on CUDA,
    twins on the CPU) on both devices; plain/butterfly take the stage loop;
    transpose 'auto' is a2a everywhere; typos and ppermute with chunks
    raise."""
    tr = tnfl.ring_from_modulus("u32", 1024, 60)
    for mode, want in (("auto", (True, True)), ("fused", (True, True)),
                       ("plain", (False, False)),
                       ("butterfly", (False, False))):
        monkeypatch.setenv("NFL_TORCH_NTT", mode)
        for device in ("cpu", "cuda"):
            assert tnd._resolved_backends(tr, 32, 32, device) == want
    monkeypatch.setenv("NFL_TORCH_NTT", "auto")
    assert tnd._resolved_backends(tr, 32, 32, "meta") == (False, False)
    t16 = tnfl.ring_from_modulus("u16", 256, 14)
    assert tnd._resolved_backends(t16, 16, 16, "cpu") == (False, False)
    assert tnd._resolve_transpose("auto") == "a2a"
    assert tnd._resolve_transpose("auto", 4) == "a2a"
    assert tnd._resolve_transpose("ppermute") == "ppermute"
    with pytest.raises(ValueError):
        tnd._resolve_transpose("ppermut")
    with pytest.raises(ValueError):
        tnd._resolve_transpose("ppermute", 2)


def test_entry_points_need_a_process_group():
    tr = tnfl.ring_from_modulus("u32", 256, 60)
    x = torch.zeros((tr.nmoduli, 16, 16), dtype=torch.int32)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tnd.distributed_ntt_pow_phi(x, tr)


def test_mesh_shape_matches_jax_make_mesh():
    for ndev in (1, 2, 4, 8):
        mesh = japi.make_mesh(devices=jax.devices("cpu")[:ndev])
        assert tapi.mesh_shape(ndev) == tuple(mesh.devices.shape)
    assert tapi.mesh_shape(6) == (6, 1, 1)
    mesh = japi.make_mesh(devices=jax.devices("cpu")[:6])
    assert tapi.mesh_shape(6) == tuple(mesh.devices.shape)
    assert tapi.poly_sharding(None, batch_ndim=2) == ("batch", None, "rns",
                                                      None)


def test_column_blocks_and_gather(rng):
    jr, tr = _ring("u64", 256, 124)
    x = rand_residues(jr, rng, batch=(2,))
    blocks = [interop.column_block_from_numpy(x, tr, r, 4, device=DEV)
              for r in range(4)]
    assert all(b.shape == (2, tr.nmoduli, 16, 4) for b in blocks)
    np.testing.assert_array_equal(interop.gather_column_blocks(blocks, tr), x)
    rows = [torch.from_numpy(x.reshape(2, 2, 16, 16)[..., 4 * r:4 * r + 4, :]
                             .view(np.int64).copy()) for r in range(4)]
    np.testing.assert_array_equal(interop.gather_row_blocks(rows, tr),
                                  x.reshape(2, 2, 16, 16))
    with pytest.raises(TypeError):
        interop.column_block_from_numpy(x.astype(np.uint32), tr, 0, 4,
                                        device=DEV)


# ---------------------------------------------------------------------------
# gloo process groups
# ---------------------------------------------------------------------------

_WORKER = r"""
import datetime, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, d, rdzv, out, root = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4], sys.argv[5])
sys.path.insert(0, root)
from nfllib_tpu_torch import Poly, interop, ring_from_modulus
from nfllib_tpu_torch.ops import modops
from nfllib_tpu_torch.parallel import api, ntt_dist as nd

got = api.init_distributed(f"file://{rdzv}", d, rank, backend="gloo",
                           timeout=datetime.timedelta(seconds=60))
assert got == (rank, d), got
assert not any(k == "jax" or k.startswith(("jax.", "nfllib_tpu."))
               or k == "nfllib_tpu" for k in sys.modules)


def save(name, tag, t):
    np.save(f"{out}/{name}_{tag}_r{rank}.npy", t.numpy())


for name, limb, degree, bits, n1 in CASES:
    ring = ring_from_modulus(limb, degree, bits)
    inp = {k: np.load(f"{out}/in_{name}_{k}.npy") for k in ("x", "a", "b",
                                                              "xs")}
    blk = {k: interop.column_block_from_numpy(v, ring, rank, d, n1,
                                              device="cpu")
           for k, v in inp.items()}
    res = {}
    for mode, sfx in (("fused", ""), ("plain", "_plain")):
        os.environ["NFL_TORCH_NTT"] = mode
        res["fwd" + sfx] = nd.distributed_ntt_pow_phi(blk["x"], ring, n1=n1)
        res["inv" + sfx] = nd.distributed_invntt_pow_invphi(
            res["fwd" + sfx], ring, n1=n1)
    os.environ["NFL_TORCH_NTT"] = "auto"
    y = res["fwd"]
    res["fwd_ppermute"] = nd.distributed_ntt_pow_phi(
        blk["x"], ring, n1=n1, transpose="ppermute")
    res["fwd_chunks"] = nd.distributed_ntt_pow_phi(blk["x"], ring, n1=n1,
                                                   chunks=2)
    res["inv_ppermute"] = nd.distributed_invntt_pow_invphi(
        y, ring, n1=n1, transpose="ppermute")
    res["inv_chunks"] = nd.distributed_invntt_pow_invphi(y, ring, n1=n1,
                                                         chunks=2)
    fa = nd.distributed_ntt_pow_phi(blk["a"], ring, n1=n1)
    fb = nd.distributed_ntt_pow_phi(blk["b"], ring, n1=n1)
    tabs = ring.context().to("cpu")
    prod = modops.mulmod(fa, fb, tabs.p_col[..., None],
                         tabs.pn_col[..., None])
    res["prod"] = nd.distributed_invntt_pow_invphi(prod, ring, n1=n1)
    res["pipe"] = nd.distributed_ntt_pow_phi_pipelined(blk["xs"], ring,
                                                       n1=n1)
    for tag, t in res.items():
        save(name, tag, t)

# the mesh API: this rank's block of a [4, 4, n] polynomial batch, a Poly
# on the channel block of its rns slice, and the whole batch gathered back
limb, degree, bits = API_RING
ring = ring_from_modulus(limb, degree, bits)
mesh = api.make_mesh()
assert tuple(mesh.shape) == api.mesh_shape(d), mesh
p = Poly.from_numpy(ring, np.load(f"{out}/in_api.npy"), "cpu")
local = api.shard_poly(p, mesh)
whole = api.gather_poly(local, mesh)
save("api", "block", local.data)
save("api", "add", modops.addmod(local.data, local.data,
                                 local.ring.context().to("cpu").p_col))
save("api", "ntt", local.ntt_pow_phi().data)
# the four-step transform of the block over the mesh's deg group (one rank
# here): the block ring's own tables, the single-chip order by bit reversal
n1 = 16
four = nd.distributed_ntt_pow_phi(
    local.data.reshape(local.data.shape[:-1] + (n1, degree // n1)),
    local.ring, mesh.get_group("deg"), n1=n1)
harvey = four.transpose(-1, -2).reshape(local.data.shape)[
    ..., torch.from_numpy(local.ring.context().bitrev.astype(np.int64))]
assert torch.equal(harvey, local.ntt_pow_phi().data)
save("api", "gather", whole.data)
save("api", "rings", torch.tensor([local.ring.first, local.ring.nmoduli,
                                   whole.ring.first, whole.ring.nmoduli]))
save("api", "coord", torch.tensor([mesh.get_local_rank(a)
                                   for a in ("batch", "rns", "deg")]))
dist.destroy_process_group()

# the port's dryrun_multichip on its own mesh: the default factoring, and
# at d = 2 the deg axis alone, so that the four-step exchanges cross ranks
from nfllib_tpu_torch.parallel import dryrun
api.init_distributed(f"file://{rdzv}_dry", d, rank, backend="gloo",
                     timeout=datetime.timedelta(seconds=60))
os.environ["NFL_TORCH_NTT"] = "auto"
res = dryrun.dryrun_multichip(DRY_LWE, DRY_BIG, device="cpu",
                              shape=DRY_SHAPES.get(d))
for name in dryrun.INPUTS:
    save("dry", name, res["inputs"][name].data)
for name in ("resa", "resb", "bits"):
    save("dry", name, res[name].data)
save("dry", "meta", torch.tensor(list(res["mesh"]) + [
    res["exchanges"][k].get(kind, 0) for k in DRY_COUNTS
    for kind in ("all_to_all", "p2p")]))
dist.destroy_process_group()
"""


def _run_group(d, tmp, inputs):
    """Spawn d gloo ranks running _WORKER; returns their outputs by
    (name, tag) as lists of d arrays."""
    for name, arr in inputs.items():
        np.save(tmp / f"in_{name}.npy", arr)
    code = (f"CASES = {CASES!r}\nAPI_RING = {API_RING!r}\n"
            f"DRY_LWE = {DRY_LWE!r}\nDRY_BIG = {DRY_BIG!r}\n"
            f"DRY_SHAPES = {DRY_SHAPES!r}\nDRY_COUNTS = {DRY_COUNTS!r}\n"
            + _WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(d), str(tmp / "rdzv"),
         str(tmp), str(ROOT)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(d)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {d} failed:\n{log}"
    out = {}
    for f in tmp.glob("*_r0.npy"):
        key = f.name[:-len("_r0.npy")]
        out[key] = [np.load(tmp / f"{key}_r{r}.npy") for r in range(d)]
    return out


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Both group sizes, once for the module: inputs from one seed, the
    ranks' outputs, keyed by d."""
    rng = np.random.default_rng(20261016)
    inputs = {}
    for name, limb, degree, bits, _ in CASES:
        ring = nfl.ring_from_modulus(limb, degree, bits)
        inputs[f"{name}_x"] = rand_residues(ring, rng)
        inputs[f"{name}_a"] = rand_residues(ring, rng)
        inputs[f"{name}_b"] = rand_residues(ring, rng)
        inputs[f"{name}_xs"] = rand_residues(ring, rng, batch=(BATCH,))
    inputs["api"] = rand_residues(nfl.ring_from_modulus(*API_RING), rng,
                                  batch=(4,))
    runs = {d: _run_group(d, tmp_path_factory.mktemp(f"gloo{d}"), inputs)
            for d in (2, 4)}
    return inputs, runs


@pytest.fixture(scope="module")
def jax_refs(gloo_runs):
    """The JAX package's distributed transforms of the same inputs on the
    8-device virtual mesh (its default dispatch on the CPU: the jnp stage
    loop), global arrays keyed by (d, name, tag)."""
    inputs, _ = gloo_runs
    refs = {}
    for d in (2, 4):
        mesh = Mesh(np.array(jax.devices("cpu")[:d]), axis_names=("deg",))
        sh = NamedSharding(mesh, P(None, "deg"))
        for name, limb, degree, bits, n1 in CASES:
            ring = nfl.ring_from_modulus(limb, degree, bits)
            ctx = ring.context()

            def fwd(v):
                return jnd.distributed_ntt_pow_phi(
                    jax.device_put(jnp.asarray(v), sh), ring, mesh, n1=n1)
            y = fwd(inputs[f"{name}_x"])
            refs[d, name, "fwd"] = np.asarray(y)
            refs[d, name, "inv"] = np.asarray(
                jnd.distributed_invntt_pow_invphi(y, ring, mesh, n1=n1))
            from nfllib_tpu.ops import modops as jmod
            prod = jmod.mulmod(fwd(inputs[f"{name}_a"]),
                               fwd(inputs[f"{name}_b"]),
                               jnp.asarray(ctx.p_col)[..., None],
                               jnp.asarray(ctx.pn_col)[..., None])
            refs[d, name, "prod"] = np.asarray(
                jnd.distributed_invntt_pow_invphi(prod, ring, mesh, n1=n1))
            xs = jax.device_put(jnp.asarray(inputs[f"{name}_xs"]),
                                NamedSharding(mesh, P(None, None, "deg")))
            refs[d, name, "pipe"] = np.asarray(
                jnd.distributed_ntt_pow_phi_pipelined(xs, ring, mesh, n1=n1))
    return refs


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
@pytest.mark.parametrize("check", CHECKS)
def test_distributed_matches_jax_mesh(gloo_runs, jax_refs, d, name, check):
    """Each rank's blocks, gathered in rank order, equal the JAX package's
    global output on the virtual mesh: the forward for a2a, ppermute,
    chunks=2 and NFL_TORCH_NTT=plain (stage loop) as for fused (the
    mod-matmul twins); the inverse of the forward (the round trip, equal to
    the input) likewise; the pointwise product pipeline (equal to the
    schoolbook product on JAX's side); the pipelined batch entry."""
    inputs, runs = gloo_runs
    tr = tnfl.ring_from_modulus(*[c for c in CASES if c[0] == name][0][1:4])
    blocks = runs[d][f"{name}_{check}"]
    if check.startswith("fwd") or check == "pipe":
        got = interop.gather_row_blocks(blocks, tr)
    else:
        got = interop.gather_column_blocks(blocks, tr)
    kind = check.split("_")[0]
    want = jax_refs[d, name, kind]
    np.testing.assert_array_equal(got, want)
    if kind == "inv":
        np.testing.assert_array_equal(got, inputs[f"{name}_x"])


@pytest.mark.parametrize("d", [2, 4])
def test_distributed_product_is_the_negacyclic_product(gloo_runs, d):
    from nfllib_tpu import oracle
    inputs, runs = gloo_runs
    for name, limb, degree, bits, _ in CASES:
        jr, tr = _ring(limb, degree, bits)
        got = interop.gather_column_blocks(runs[d][f"{name}_prod"], tr)
        want = oracle.negacyclic_mul_schoolbook(inputs[f"{name}_a"],
                                                inputs[f"{name}_b"], jr)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [2, 4])
def test_mesh_api_blocks(gloo_runs, d):
    """make_mesh factors the ranks like the JAX package; shard_poly gives
    each rank a Poly of its (batch, rns) block on the channel block ring
    of its rns slice; a zero-comm addmod on the block's p and ntt_pow_phi
    on the block give the same block of the whole batch's result (and,
    in the worker, the four-step transform of the block over the mesh's
    deg group equals its ntt_pow_phi by bit reversal); and gather_poly
    gives every rank the whole batch on the whole ring."""
    inputs, runs = gloo_runs
    tr = tnfl.ring_from_modulus(*API_RING)
    x = inputs["api"]
    ctx = tr.context()
    full_ntt = _np(tntt.ntt_pow_phi(_t(x, tr), ctx), tr)
    full_add = (x.astype(np.uint64) * 2 % ctx.p_col.astype(np.uint64)
                ).astype(tr.dtype)
    shape = tapi.mesh_shape(d)
    nb, nc = 4 // shape[0], tr.nmoduli // shape[1]
    seen = set()
    for r in range(d):
        b, c, _ = (int(v) for v in runs[d]["api_coord"][r])
        sl = (slice(b * nb, (b + 1) * nb), slice(c * nc, (c + 1) * nc))
        np.testing.assert_array_equal(
            runs[d]["api_block"][r].view(tr.dtype), x[sl])
        np.testing.assert_array_equal(
            runs[d]["api_add"][r].view(tr.dtype), full_add[sl])
        np.testing.assert_array_equal(
            runs[d]["api_ntt"][r].view(tr.dtype), full_ntt[sl])
        np.testing.assert_array_equal(
            runs[d]["api_gather"][r].view(tr.dtype), x)
        np.testing.assert_array_equal(runs[d]["api_rings"][r],
                                      [c * nc, nc, 0, tr.nmoduli])
        seen.add((b, c))
    assert len(seen) == d


@functools.lru_cache(maxsize=None)
def _jax_dryrun(batch):
    """__graft_entry__.py's part 1 on the JAX package at DRY_LWE: the keys
    and noise from its seed, the encrypt and decrypt graphs of the whole
    ring, as numpy"""
    from nfllib_tpu.apps import lwe as jlwe
    from nfllib_tpu.prng.salsa20 import Salsa20Stream as JStream

    ring = nfl.ring_from_modulus(*DRY_LWE)
    stream = JStream(b"\x09" * 32)
    g = jlwe.make_gaussian_prng(samples=ring.degree)
    keys = jlwe.keygen(ring, stream, g)

    def noise_batch(mode):
        return np.stack([np.asarray(nfl.Poly.sample(ring, mode, stream).data)
                         for _ in range(batch)])

    v = {"pka": keys.pka.data, "pkb": keys.pkb.data, "s": keys.s.data,
         "sprime": keys.sprime.data, "u": noise_batch(nfl.gaussian(g)),
         "e1": noise_batch(nfl.gaussian(g, 2)),
         "e2": noise_batch(nfl.gaussian(g, 2))}
    ctx = ring.context()
    ra, rb = jlwe._encrypt_graph(ctx, *(jnp.asarray(v[k]) for k in (
        "pka", "pkb", "u", "e1", "e2")))
    bits = jlwe._decrypt_graph(ctx, ra, rb, jnp.asarray(v["s"]),
                               jnp.asarray(v["sprime"]))
    v.update(resa=ra, resb=rb, bits=bits)
    return {k: np.asarray(a) for k, a in v.items()}


@pytest.mark.parametrize("d", [2, 4])
def test_dryrun_multichip_matches_jax(gloo_runs, d):
    """parallel/dryrun.py:dryrun_multichip on d gloo ranks passed its
    gates (zero bits, gathered blocks equal to the whole ring's run, the
    deg round trip exact and balanced); every rank drew the JAX package's
    keys and noise and gathered the JAX package's ciphertexts and bits;
    one exchange a deg transform, two with chunks=2, d - 1 ppermute
    hops."""
    _, runs = gloo_runs
    shape = DRY_SHAPES.get(d, tapi.mesh_shape(d))
    want = _jax_dryrun(2 * shape[0])
    assert not want["bits"].any()
    deg = shape[2]
    counts = [1, 0, 2, 0, 0, deg - 1, 2, 0]
    for r in range(d):
        np.testing.assert_array_equal(runs[d]["dry_meta"][r],
                                      list(shape) + counts)
        for name, arr in want.items():
            got = runs[d][f"dry_{name}"][r]
            np.testing.assert_array_equal(got.view(arr.dtype), arr, name)
