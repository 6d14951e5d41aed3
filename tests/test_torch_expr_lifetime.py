"""What a forced `Expr` keeps alive, and the programs its trace builds
(nfllib_tpu_torch/ops/expr_program.py: `_Tracer`, `from_expr`), on the CPU.

A forced tree's leaf tensors are freed by reference count once the caller
drops its Polys, with the collector off, as the JAX package's `Expr.poly`
frees them (its trace is a method, nfllib_tpu/poly.py `_flatten`).  The
programs are those of the recursive trace the port had before: the same
nodes and leaf order for every tree of tests/test_torch_modops_expr.py,
the same subtrees forced first past the launch caps.  The benchmark's
`macc` request (portbench/kinds/macc.py) at a small size equals the plain
reference's sum and the same chain through the JAX package's `Expr`.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import interop
from nfllib_tpu_torch.ops import expr_program as ep

import test_torch_modops_expr as trees

DEV = "cpu"
RINGS = {"u32": ("u32", 64, 60), "u64": ("u64", 64, 124)}


# ---------------------------------------------------------------------------
# The trace before the tracer class: nested closures that call themselves
# (kept here as the programs' oracle; it holds its leaves in a cycle)
# ---------------------------------------------------------------------------

def _trace_before(expr):
    leaves, leaf_id, nodes, node_id, memo = [], {}, [], {}, {}

    def leaf(a):
        if id(a) not in leaf_id:
            poly = a if not hasattr(a, "args") else a._val
            leaf_id[id(a)] = len(leaves)
            leaves.append(poly)
        return ("leaf", leaf_id[id(a)])

    def node(op, *args):
        key = (op, args)
        if key not in node_id:
            node_id[key] = ("node", len(nodes))
            nodes.append(key)
        return node_id[key]

    def ev(e):
        if not ep._is_open(e):
            return leaf(e)
        if id(e) in memo:
            return memo[id(e)]
        op, args = e.op, e.args
        if op == "add" and ep._is_product(args[0]):
            r = node("muladd", ev(args[1]), ev(args[0].args[0]),
                     ev(args[0].args[1]))
        elif op == "add" and ep._is_product(args[1]):
            r = node("muladd", ev(args[0]), ev(args[1].args[0]),
                     ev(args[1].args[1]))
        else:
            name = {"add": "addmod", "sub": "submod", "mul": "mulmod",
                    "shoup": "mulmod_shoup"}[op]
            r = node(name, *(ev(a) for a in args))
        memo[id(e)] = r
        return r

    def collect(e, seen):
        for a in e.args:
            if not ep._is_open(a):
                leaf(a)
            elif id(a) not in seen:
                seen.add(id(a))
                collect(a, seen)

    collect(expr, set())
    ev(expr)
    nl = len(leaves)

    def ident(ref):
        kind, k = ref
        return k if kind == "leaf" else nl + k

    return ep.Program(nl, tuple((op, tuple(ident(a) for a in args))
                                for op, args in nodes)), leaves


def _from_expr_before(expr):
    while True:
        program, leaves = _trace_before(expr)
        if program.fits():
            return program, leaves
        open_args = [a for a in expr.args if ep._is_open(a)]
        max(open_args, key=lambda a: len(_trace_before(a)[0].nodes)).poly()


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _polys(ring, count, seed, batch=()):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = np.empty(batch + ring.shape, dtype=np.uint64)
        for cm, p in enumerate(ring.moduli):
            a[..., cm, :] = rng.integers(0, int(p), size=batch
                                         + (ring.degree,), dtype=np.uint64)
        out.append(interop.poly_from_numpy(a.astype(ring.dtype), ring, DEV))
    return out


def _muladd(ps):
    a, b, c = ps[:3]
    return a * b + c


def _shared(ps):
    a, b, c = ps[:3]
    s = a + b
    return (s * s - s) * c + s


def _past_caps(ps):
    # 9 products of 18 leaves summed: the root reads more than MAX_LEAVES,
    # so its 16-leaf operand is forced first
    return trees._pair_sum(tnfl, ps, [(2 * k, 2 * k + 1) for k in range(9)])


TREES = {"muladd": (_muladd, 3), "shared": (_shared, 3),
         "past_caps": (_past_caps, 18)}


def _alive(refs) -> list:
    return [k for k, r in enumerate(refs) if r() is not None]


@pytest.mark.parametrize("tree", list(TREES) + ["macc_loop"])
@pytest.mark.parametrize("limb", list(RINGS))
def test_forced_expr_frees_its_leaves_by_reference_count(limb, tree):
    """With the collector off: a forced tree's leaf tensors (and a subtree
    forced past the caps) die with the caller's last reference; in a
    K-term acc = (acc + a_i * b_i).poly() loop no earlier sum survives."""
    ring = tnfl.ring_from_modulus(*RINGS[limb])
    gc.collect()
    gc.disable()
    try:
        if tree == "macc_loop":
            terms = 6
            a, b = _polys(ring, terms, 5), _polys(ring, terms, 6)
            acc = tnfl.Poly.zeros(ring, device=DEV)
            sums = [weakref.ref(acc.data)]
            for i in range(terms):
                acc = (acc + a[i] * b[i]).poly()
                sums.append(weakref.ref(acc.data))
            assert _alive(sums) == [terms], "earlier sums still alive"
            assert sums[-1]() is acc.data
        else:
            build, count = TREES[tree]
            ps = _polys(ring, count, 7)
            refs = [weakref.ref(p.data) for p in ps]
            expr = build(ps)
            past = not ep._Tracer(expr).program().fits()
            assert past == (tree == "past_caps")
            val = expr.poly()
            forced = [weakref.ref(a._val.data) for a in expr.args
                      if hasattr(a, "args") and a._val is not None]
            assert len(forced) == past
            assert _alive(refs) == list(range(count))  # the Polys hold them
            del expr, ps
            assert _alive(refs) == [], "leaf tensors alive after the drop"
            assert _alive(forced) == [], "a forced subtree's value alive"
            assert val.data.shape == ring.shape
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# The programs, unchanged
# ---------------------------------------------------------------------------

def _runs(monkeypatch, build, from_expr):
    """Every (program, leaf tensors) that forcing build()'s tree runs, in
    order, with `from_expr` as the module's, and the result."""
    seen, run = [], ep.run

    def record(program, leaves, ring, channel_axis=-2):
        seen.append((program, list(leaves)))
        return run(program, leaves, ring, channel_axis)
    with monkeypatch.context() as mp:
        mp.setattr(ep, "from_expr", from_expr)
        mp.setattr(ep, "run", record)
        out = build()
        out = out.poly() if hasattr(out, "op") else out
    return seen, out


def _tree_cases():
    """(name, limb, degree, bits, leaves, specs): the random trees of
    test_torch_modops_expr.py, and deeper random trees over 20 leaves, of
    which some pass the caps."""
    cases = []
    for limb, degree, bits in [("u16", 128, 14), ("u32", 64, 60),
                               ("u64", 64, 124)]:
        pyrng = np.random.default_rng(777 + degree + bits)
        specs = []
        for _ in range(6):
            spec = trees._spec(pyrng, int(pyrng.integers(2, 6)), 5, [])
            if spec[0] == "leaf":
                spec = ("add", ("mul", ("leaf", 0), ("leaf", 1)), spec)
            specs.append(spec)
        cases.append((f"random_{limb}", limb, degree, bits, 5, specs))
    pyrng = np.random.default_rng(2026)
    deep = [trees._spec(pyrng, 8, 20, []) for _ in range(12)]
    cases.append(("random_deep_u32", "u32", 64, 60, 20,
                  [s for s in deep if s[0] != "leaf"]))
    return cases


def _leaf_ids(leaves, originals):
    """Each leaf as its index among the tree's original Polys' tensors, or
    its bytes (a subtree's value, made anew on each side)."""
    ids = {id(p.data): k for k, p in enumerate(originals)}
    return [ids.get(id(t), t.numpy().tobytes()) for t in leaves]


@pytest.mark.parametrize("case", _tree_cases(), ids=lambda c: c[0])
def test_programs_equal_the_recursive_trace(monkeypatch, case):
    _, limb, degree, bits, count, specs = case
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    ps = _polys(ring, count, 11, batch=(3,))[:1] \
        + _polys(ring, count - 1, 12)
    past = 0
    for spec in specs:
        build = lambda: trees._realize(tnfl, spec, ps, {})   # noqa: E731
        old, want = _runs(monkeypatch, build, _from_expr_before)
        new, got = _runs(monkeypatch, build, ep.from_expr)
        assert [p for p, _ in new] == [p for p, _ in old], spec
        assert [_leaf_ids(ls, ps) for _, ls in new] == \
            [_leaf_ids(ls, ps) for _, ls in old]
        assert torch.equal(got.data, want.data)
        past += len(old) > 1
        expr = build()
        t = ep._Tracer(expr)
        old_program, old_leaves = _trace_before(expr)
        assert t.program() == old_program
        assert [id(p) for p in t.leaves] == [id(p) for p in old_leaves]
        # the node count of each operand read off the one trace
        for a in expr.args:
            if ep._is_open(a):
                assert t.size(a) == len(_trace_before(a)[0].nodes)
    if case[0] == "random_deep_u32":
        assert past >= 3, "too few trees past the caps"


@pytest.mark.parametrize("count,npairs,limb,degree,bits", [
    (16, 70, "u32", 64, 60), (24, 12, "u64", 64, 124)])
def test_past_the_caps_programs_equal_the_recursive_trace(
        monkeypatch, count, npairs, limb, degree, bits):
    """test_torch_modops_expr.py's trees past MAX_NODES and MAX_LEAVES:
    the same subtrees forced in the same order, the same programs."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    ps = _polys(ring, count, 13)
    pairs = [(i, j) for i in range(count) for j in range(i + 1, count)
             if count <= 16 or j == i + 1 and i % 2 == 0][:npairs]
    build = lambda: trees._pair_sum(tnfl, ps, pairs)          # noqa: E731
    old, want = _runs(monkeypatch, build, _from_expr_before)
    new, got = _runs(monkeypatch, build, ep.from_expr)
    assert len(old) > 1
    assert [p for p, _ in new] == [p for p, _ in old]
    assert [_leaf_ids(ls, ps) for _, ls in new] == \
        [_leaf_ids(ls, ps) for _, ls in old]
    assert torch.equal(got.data, want.data)


def test_rewrite_and_cse_programs_equal_the_recursive_trace():
    ring = tnfl.ring_from_modulus("u32", 64, 60)
    a, b, c = _polys(ring, 3, 17)
    s = a + b
    p = a * b
    p.poly()
    for expr in (s * s - s, (a + b) * (a + b), a * b + c * a, c + a * b,
                 tnfl.shoup(a * b, c) - a, p + c, a * b + c * (a * b),
                 (a * b + c) * (a * b + c) + a * b):
        program, leaves = ep.from_expr(expr)
        old_program, old_leaves = _trace_before(expr)
        assert program == old_program
        assert [id(x) for x in leaves] == [id(x) for x in old_leaves]


# ---------------------------------------------------------------------------
# The benchmark's macc request at a small size
# ---------------------------------------------------------------------------

def test_macc_request_equals_the_reference_and_the_jax_chain():
    """portbench's macc kind at the CPU cut (n = 64, 2 primes, B = 4, K =
    3): its request equals the plain reference's sum (portbench/
    reference.py), and the JAX package's Expr chain over the same inputs
    gives the same residues bit for bit."""
    from portbench import run, traffic
    from portbench.tests.conftest import small_cell
    _, _, cfg, mix = small_cell("xpir_he128_u64_n32768_q868.macc")
    kind = traffic.load_kind(mix["kind"])(tnfl, cfg, mix, 2 ** 31 + 11, DEV)
    assert (kind.batch, kind.terms) == (4, 3)
    kind.setup()
    r = 2
    _, out = kind.request(r, run.Spans(False))
    assert kind.check({r: (0, out)}) == {"residues_wrong": 0}
    assert torch.equal(out.to(torch.int64), kind._sum(kind.ref()))

    jring = nfl.ring_from_modulus(cfg["limb"], cfg["degree"],
                                  cfg["modulus_bits"])
    assert [int(q) for q in jring.moduli] == cfg["primes"]
    pairs = [tuple(nfl.Poly(interop.poly_to_numpy(kind.poly(t)), jring)
                   .ntt_pow_phi() for t in ab) for ab in kind.inputs()]
    acc = nfl.Poly(np.zeros((kind.batch,) + jring.shape, jring.dtype), jring)
    for t in range(kind.terms):
        fa, fb = pairs[(r + t) % kind.terms]
        acc = (acc + fa * fb).poly()
    want = np.asarray(acc.invntt_pow_invphi().data)
    got = interop.poly_to_numpy(tnfl.Poly(out, kind.ring))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
