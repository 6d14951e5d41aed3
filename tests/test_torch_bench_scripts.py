"""The port's measuring scripts (bench_torch.py, tools/bench_ops_torch.py,
tools/prng_bench_torch.py) against the JAX package's (bench.py,
tools/bench_ops.py, tools/prng_bench.py) on the CPU: their output lines,
their refusals, and what they time held exactly to the JAX package on the
same inputs (the first NTT application, every bench_ops row's callable at
configs 0 and 1, the host and device Gaussian sample dumps).  Each script
is loaded from its path with importlib; none of them may import JAX."""
import ast
import functools
import importlib.util
import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.apps import lwe as jlwe
from nfllib_tpu.ops import modops as jmodops, ntt as jntt
from nfllib_tpu.prng import device_sampling as jdsamp, sampling as jsampling
from nfllib_tpu.prng.gaussian import FastGaussianNoise as JFastGaussianNoise
from nfllib_tpu.prng.salsa20 import Salsa20Stream as JStream
import nfllib_tpu_torch as tnfl

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = {"bench_torch": "bench_torch.py",
           "bench_ops_torch": "tools/bench_ops_torch.py",
           "prng_bench_torch": "tools/prng_bench_torch.py"}
CPU = torch.device("cpu")
KEY = bytes(range(7, 39))
SMALL = ["--device", "cpu", "--degree", "64", "--nmoduli", "2", "--batch",
         "2", "--samples", "3", "--chain", "2"]


@functools.lru_cache(maxsize=None)
def _load(name):
    """The script `name` (or tools/bench_ops.py as "bench_ops") as a
    module, loaded from its path"""
    path = ROOT / SCRIPTS.get(name, "tools/bench_ops.py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _unsigned(t, ring):
    """A port tensor as the JAX package's unsigned residues"""
    return t.numpy().view(ring.dtype)


# -- bench_torch.py ----------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_bench_last_line(inverse, capsys):
    bt = _load("bench_torch")
    assert bt.main(SMALL + (["--inverse"] if inverse else [])) == 0
    out = _last_json(capsys.readouterr().out)
    assert set(out) == {"metric", "value", "unit", "vs_baseline"}
    kind = "intt" if inverse else "ntt"
    assert out["metric"] == f"rns_{kind}_n2pow6_u32_m2_b2_per_sec_on_cpu"
    assert out["unit"] == "ntt/s" and out["value"] > 0
    assert out["vs_baseline"] == round(out["value"] / 1e6, 4)


def test_bench_metric_names():
    """The default metric is bench.py's literal; other shapes carry theirs"""
    tree = ast.parse((ROOT / "bench.py").read_text())
    literal = [v.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
               for k, v in zip(node.keys, node.values)
               if isinstance(k, ast.Constant) and k.value == "metric"]
    bt = _load("bench_torch")
    assert literal == [bt.metric_name(*bt.DEFAULT_SHAPE, inverse=False)]
    assert bt.metric_name(*bt.DEFAULT_SHAPE, inverse=True) == \
        "rns_intt_n2pow14_per_sec_per_chip"
    assert bt.metric_name("u64", 1 << 20, 2, 2, False) == \
        "rns_ntt_n2pow20_u64_m2_b2_per_sec_per_chip"


def test_bench_input_is_bench_py_input():
    """bench.py:37-44's input at its shape, rebuilt here in numpy"""
    bt = _load("bench_torch")
    limb, n, m, batch = bt.DEFAULT_SHAPE
    ring = nfl.Ring(limb, n, m)
    rng = np.random.default_rng(42)
    x = np.empty((batch, m, n), dtype=np.uint32)
    for cm in range(m):
        x[:, cm, :] = rng.integers(0, int(ring.moduli[cm]), size=(batch, n),
                                   dtype=np.uint32)
    got = bt.make_input(tnfl.Ring(limb, n, m), batch)
    assert got.dtype == x.dtype and np.array_equal(got, x)


# (limb, degree, batch): the u32 shape is bench_ops config 0's, whose JAX
# transforms test_bench_ops_rows_exact compiles too
FIRST_SHAPES = {"u32": (8, 8), "u64": (64, 2)}


@pytest.mark.parametrize("mode", ["auto", "butterfly"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("limb", sorted(FIRST_SHAPES))
def test_bench_first_application_exact(limb, inverse, mode):
    bt = _load("bench_torch")
    degree, batch = FIRST_SHAPES[limb]
    args = bt.parse_args(["--device", "cpu", "--limb", limb, "--degree",
                          str(degree), "--nmoduli", "2", "--batch",
                          str(batch), "--mode", mode]
                         + (["--inverse"] if inverse else []))
    ring, op, x = bt.workload(args, CPU)
    with bt.ntt_mode(mode):
        got = op(x, ring.context())
    jring = nfl.Ring(limb, degree, 2)
    jop = jntt.invntt_pow_invphi if inverse else jntt.ntt_pow_phi
    want = np.asarray(jop(jnp.asarray(bt.make_input(ring, batch)),
                          jring.context()))
    assert np.array_equal(_unsigned(got, ring), want)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_no_card_refused(name, monkeypatch, capsys):
    """Without --device cpu and without a card each script stops with one
    line and prints no result"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _load(name).main([]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert out.err.strip().splitlines() == [
        f"{name}: no CUDA device found (torch.cuda.is_available() is "
        f"false); pass --device cpu to run the plain twins on the CPU"]


@pytest.mark.parametrize("name", ["bench_torch", "bench_ops_torch"])
def test_plain_mode_refused_on_card(name, monkeypatch, capsys):
    """--mode plain would time the twins: refused on cuda before the card
    is touched, allowed on the CPU"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mod = _load(name)
    assert mod.main(["--mode", "plain"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--mode plain runs the plain torch twins" \
        in out.err


# -- tools/bench_ops_torch.py ------------------------------------------------

def _bench_ops_rows_in_source():
    """The row names tools/bench_ops.py records, in its order"""
    tree = ast.parse((ROOT / "tools/bench_ops.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bench_config")
    names = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id == "rec":
            names.append((node.lineno, node.args[0].value))
        elif isinstance(f, ast.Attribute) and f.attr == "append" \
                and isinstance(node.args[0], ast.Tuple) \
                and isinstance(node.args[0].elts[0], ast.Constant):
            names.append((node.lineno, node.args[0].elts[0].value))
    return [n for _, n in sorted(names)]


def test_bench_ops_matrix_and_rows():
    jbo, bo = _load("bench_ops"), _load("bench_ops_torch")
    assert bo.CONFIGS == jbo.CONFIGS and bo.BATCH == jbo.BATCH
    rows = bo.build_rows(tnfl.ring_from_modulus("u32", 8, 60), CPU)
    names = _bench_ops_rows_in_source()
    assert len(names) == 13
    assert [r.name for r in rows] == names


@functools.lru_cache(maxsize=None)
def _jax_rows(degree, agg, limb):
    """{row: output} of tools/bench_ops.py's calls, one application each,
    on its inputs (its _rand, default_rng(7), the same streams)"""
    jbo = _load("bench_ops")
    ring = nfl.ring_from_modulus(limb, degree, agg)
    ctx = ring.context()
    rng = np.random.default_rng(7)
    p_col, pn_col = jnp.asarray(ctx.p_col), jnp.asarray(ctx.pn_col)
    a = jnp.asarray(jbo._rand(ring, rng))
    b = jnp.asarray(jbo._rand(ring, rng))
    bprec = jmodops.compute_shoup(b, p_col)
    out = {
        "add": jmodops.addmod(a, b, p_col),
        "sub": jmodops.submod(a, b, p_col),
        "mul (pointwise)": jmodops.mulmod(a, b, p_col, pn_col),
        "mulmod_shoup": jmodops.mulmod_shoup(a, b, bprec, p_col),
        "muladd (fma)": jmodops.muladd(a, a, b, p_col, pn_col),
        "muladd_shoup": jmodops.muladd_shoup(a, a, b, bprec, p_col),
        "ntt_pow_phi": jntt.ntt_pow_phi(a, ctx),
        "invntt_pow_invphi": jntt.invntt_pow_invphi(a, ctx),
    }
    stream = JStream(b"\x11" * 32)
    g = jlwe.make_gaussian_prng(samples=max(degree, 1 << 10))
    keys = jlwe.keygen(ring, stream, g)
    e2 = jnp.asarray(jbo._rand(ring, rng))
    resa, resb = jlwe._encrypt_graph(ctx, keys.pka.data, keys.pkb.data, a, b,
                                     e2)
    out["lwe encrypt (chain)"] = resa
    out["lwe decrypt (chain)"] = jlwe._decrypt_graph(
        ctx, resa, resb, keys.s.data, keys.sprime.data)
    s = JStream(b"\x13" * 32)
    out["uniform (host)"] = jsampling.sample_uniform(ring, s)
    out["non_uniform ub=7 (host)"] = jsampling.sample_non_uniform(
        ring, s, jsampling.non_uniform(7))
    fg = JFastGaussianNoise(4.0, 128, max(degree, 1024))
    out["gaussian (host)"] = jsampling.sample_gaussian(
        ring, s, jsampling.gaussian(fg))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("config", [0, 1])
def test_bench_ops_rows_exact(config):
    """Each row's callable, once on the CPU (the twins), equals the JAX
    call of the same row on the same inputs; the host samplers too, called
    in the rows' order on the same streams"""
    bo = _load("bench_ops_torch")
    degree, agg, limb = bo.CONFIGS[config]
    ring = tnfl.ring_from_modulus(limb, degree, agg)
    with _load("bench_torch").ntt_mode("auto"):
        rows = bo.build_rows(ring, CPU)
        got = {r.name: (r.fn(r.x) if r.x is not None else r.fn())
               for r in rows}
    want = _jax_rows(degree, agg, limb)
    assert list(got) == list(want)
    for name, g in got.items():
        g = _unsigned(g, ring) if isinstance(g, torch.Tensor) else g
        assert np.array_equal(g, want[name].astype(g.dtype)), name


@pytest.mark.parametrize("trace", [False, True], ids=["csv", "trace"])
def test_bench_ops_output(trace, tmp_path, capsys):
    argv = ["--device", "cpu", "--config", "0", "--csv", "--chain", "1",
            "--samples", "1"] + (["--trace", str(tmp_path)] if trace else [])
    assert _load("bench_ops_torch").main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "== n=8 60-bit u32 (batch=8, device=cpu, mode=auto) =="
    rows = [ln.split(",") for ln in lines[1:]]
    assert [r[3] for r in rows] == _bench_ops_rows_in_source()
    for r in rows:
        assert r[:3] == ["8", "60", "u32"] and np.isfinite(float(r[4]))
        assert r[5:7] == ["n/a", "n/a"]
    if trace:
        assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1


# -- tools/prng_bench_torch.py -----------------------------------------------

def _run_prng(argv, tmp_path, capsys):
    dump = tmp_path / "samples.bin"
    assert _load("prng_bench_torch").main(
        ["--device", "cpu", "--samples", "20000", "--key", KEY.hex(),
         "--dump", str(dump)] + argv) == 0
    return np.fromfile(dump, dtype="<i8"), capsys.readouterr().out


def _stats_line(out, sigma=4.0):
    """tools/prng_bench.py's statistics line over the samples `out`"""
    total = out.size
    mean = float(out.sum()) / total
    std = (float((out.astype(np.float64) ** 2).sum()) / total
           - mean * mean) ** 0.5
    outliers = int(np.count_nonzero(np.abs(out) > 6 * sigma + 1))
    return (f"mean {mean:+.5f} (expect 0)   std {std:.5f} "
            f"(expect {sigma})   >6-sigma outliers: {outliers} "
            f"(~{total * 2e-9:.1f} expected)")


def test_prng_host_dump_and_stats(tmp_path, capsys):
    got, printed = _run_prng([], tmp_path, capsys)
    fg = JFastGaussianNoise(4.0, 128, 20000)
    want = fg.get_noise(JStream(KEY), 20000)
    assert got.tobytes() == want.astype("<i8").tobytes()
    assert _stats_line(want) in printed.splitlines()
    assert re.search(r"^table build: .*\(117 barriers, 152 bits\)$", printed,
                     re.M)


def _device_ring_values(vals, p):
    v = np.asarray(vals)[0].astype(np.int64)
    return np.where(v > p // 2, v - p, v)


def test_prng_device_fixed_is_jax_device_gaussian(tmp_path, capsys):
    """--sampler device on the CPU (S3's twin): draw f of the JAX package's
    device_gaussian at nonce f, channel 0 read signed"""
    got, printed = _run_prng(["--sampler", "device"], tmp_path, capsys)
    limb, n, m = _load("prng_bench_torch").DEVICE_RING
    ring = nfl.Ring(limb, n, m)
    mode = nfl.gaussian(JFastGaussianNoise(4.0, 128, 20000))
    p = int(ring.moduli[0])
    want = np.concatenate([_device_ring_values(
        jdsamp.device_gaussian(ring, KEY, f, mode), p) for f in (0, 1)])
    assert np.array_equal(got, want[:20000])
    assert _stats_line(got) in printed.splitlines()


def test_prng_device_exact_is_the_host_walk(tmp_path, capsys):
    """--sampler device_exact on the CPU (S4's twin), each draw where the
    one before stopped: the JAX package's host walk drawn in the same
    lengths from one stream"""
    got, _ = _run_prng(["--sampler", "device_exact"], tmp_path, capsys)
    n = _load("prng_bench_torch").DEVICE_RING[1]
    fg = JFastGaussianNoise(4.0, 128, 20000)
    stream = JStream(KEY)
    want = np.concatenate([fg.get_noise(stream, n) for _ in range(2)])
    assert np.array_equal(got, want[:20000])


# -- imports ---------------------------------------------------------------

JAX_SIDE = {"jax", "jaxlib", "nfllib_tpu", "bench", "bench_ops",
            "prng_bench"}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_imports_nothing_of_jax(name):
    tree = ast.parse((ROOT / SCRIPTS[name]).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert mods and not [m for m in mods if m.split(".")[0] in JAX_SIDE]
