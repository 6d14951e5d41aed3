"""E1, the elementwise program kernel (nfllib_tpu_torch/csrc/modops_expr.cu),
and its programs (nfllib_tpu_torch/ops/expr_program.py), on the CPU.

The kernel's CUDA source is compiled with g++ against tests/cuda_host_mock.h
(tests/cuda_host_build.py, once for this module) and driven through the
port's own wrapper (`_kernels.ModopsExprKernel`, its leaf preparation and
chunking) with CPU tensors.  It must be bit-identical (exact, no
tolerance) to the twin `expr_program.run_plain` for every opcode and limb
tier, on canonical residues and on the words 0, 1, p - 1, p, 2^w - 1 (the
strict mode's poison) and arbitrary words.  The programs built from `Expr`
trees must give the JAX package's `_chain_program` results byte for byte
on a random-tree fuzz (shared subtrees, `shoup`, both muladd rewrites,
leaves broadcast over a batch, trees past the launch caps), through the
twin and through the host-built kernel.  Inputs come from numpy seeds.
Without g++ the kernel's tests skip.
"""
import ctypes

import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import _kernels, debug, interop
from nfllib_tpu_torch.ops import expr_program as ep
from nfllib_tpu_torch.ops import modops

import cuda_host_build

DEV = "cpu"
P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (limb, degree, modulus bits): u16 at one and two 14-bit moduli, u32 at
# two 30-bit ones, u64 at two 62-bit ones
TIERS = [("u16", 64, 14), ("u16", 64, 28), ("u32", 64, 60),
         ("u64", 64, 124)]


class HostE1(_kernels.ModopsExprKernel):
    """The port's E1 wrapper over the host-built library and CPU tensors."""

    def __init__(self, lib):
        super().__init__("modops_expr_host")
        self.lib = lib

    def _on_card(self, t):
        return t.device.type == "cpu"

    def _launch(self, x, entry, *args):
        assert getattr(self.lib, entry)(*args, None) == 0
        assert self.lib.mock_launches() == 1
        self.launches += 1


@pytest.fixture(scope="module")
def e1(tmp_path_factory):
    lib = cuda_host_build.build(tmp_path_factory.mktemp("modops_expr"),
                                ("modops_expr.cu",), ("modops_expr.cu",))
    lib.nfl_modops_expr.argtypes = [I32, ctypes.POINTER(
        _kernels.ExprProgram), P, P, I64, I64, I32, P]
    return HostE1(lib)


def _kernel_run(e1, program, leaves, ring, channel_axis=-2):
    """expr_program.run's card branch, on the host-built kernel."""
    return ep._run_kernel(program, leaves, ring.context().to(DEV),
                          channel_axis, e1)


@pytest.fixture
def on_host_e1(e1, monkeypatch):
    """Every program of the port (named ops, forced trees) through the
    host-built kernel."""
    monkeypatch.setattr(ep, "run", lambda program, leaves, ring,
                        channel_axis=-2: _kernel_run(e1, program, leaves,
                                                     ring, channel_axis))
    return e1


def _storage(ring, vals):
    return torch.from_numpy(np.asarray(vals, dtype=np.uint64)
                            .astype(ring.dtype)
                            .view(ring.limb_params.signed_dtype).copy())


def _words(ring, rng, shape, k):
    """Operand k of a test: random residues, and in the first 64 words of
    each channel of the first polynomial the words 0, 1, p - 1, p, p + 1,
    2^w - 1 (the poison) and two arbitrary words, laid out so that
    operands 0 and 1 meet in every pair (operand 0 runs the eight words
    slowly, operand 1 fast; 2 and 3 in other orders)."""
    top = (1 << ring.repr_bits) - 1
    out = np.empty(shape, dtype=np.uint64)
    i = np.arange(64)
    pick = ((i // 8) % 8, i % 8, (3 * i + i // 8) % 8, (5 * i + 1) % 8)[k]
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        out[..., cm, :] = rng.integers(0, p, size=shape[:-2] + shape[-1:],
                                       dtype=np.uint64)
        special = np.array([0, 1, p - 1, p, p + 1, top,
                            int(rng.integers(0, top, dtype=np.uint64)),
                            int(rng.integers(0, top, dtype=np.uint64))],
                           dtype=np.uint64)
        out.reshape((-1,) + shape[-2:])[0, cm, :64] = special[pick]
    return _storage(ring, out)


@pytest.mark.parametrize("limb,degree,bits", TIERS)
@pytest.mark.parametrize("op", ep.OPS)
def test_every_opcode_bit_identical_to_twin(e1, limb, degree, bits, op, rng):
    """One launch a named op over [3, m, n] words, canonical and not, equal
    to the twin's words bit for bit; arbitrary Shoup companions in the
    first polynomial, the residues' companions in the others."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    shape = (3, ring.nmoduli, degree)
    leaves = [_words(ring, rng, shape, k) for k in range(ep.ARITY[op])]
    if op in ("mulmod_shoup", "mulmod_shoup_lazy", "muladd_shoup"):
        tabs = ring.context().to(DEV)
        y = leaves[-2]
        good = modops.compute_shoup(y, tabs.p_col, tabs.shoup_f)
        first = (torch.arange(3) == 0).reshape(3, 1, 1)
        leaves[-1] = torch.where(first, leaves[-1], good)
    program = ep.op_program(op)
    before = e1.launches
    got = _kernel_run(e1, program, leaves, ring)
    want = ep.run_plain(program, leaves, ring.context().to(DEV))
    assert e1.launches == before + 1
    assert got.dtype == want.dtype == ring.torch_dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("limb,degree,bits", TIERS)
@pytest.mark.parametrize("op", ("mulmod", "muladd", "compute_shoup",
                                "muladd_shoup"))
def test_arbitrary_words_at_volume(e1, limb, degree, bits, op):
    """8192 elements of arbitrary words an operand (residues or not), so
    that the rare corrections (a carry of the Newton quotient, the third
    step of compute_shoup's quotient) run too."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    g = np.random.default_rng(99 + bits)
    shape = (64 // ring.nmoduli, ring.nmoduli, degree)
    leaves = [_storage(ring, g.integers(0, 1 << ring.repr_bits, size=shape,
                                        dtype=np.uint64))
              for _ in range(ep.ARITY[op])]
    program = ep.op_program(op)
    assert torch.equal(_kernel_run(e1, program, leaves, ring),
                       ep.run_plain(program, leaves,
                                    ring.context().to(DEV)))


@pytest.mark.parametrize("limb,degree,bits", TIERS)
def test_broadcast_tables_and_channel_axis(e1, limb, degree, bits, rng):
    """The twist's leaves: [B, m, n] data against the ring's [m, n] tables
    (int64 for u16/u32, read at their width) and [1, m, n]; a leaf that
    broadcasts inside ([B, m, 1]) is expanded first; the distributed
    layer's [B, m, r, c] blocks against [m, r, c] with the channel at -3."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    tabs = ring.context().to(DEV)
    m = ring.nmoduli
    x = _words(ring, rng, (3, m, degree), 2)
    cases = [
        ("mulmod_shoup", (x, tabs.phis, tabs.shoupphis), -2),
        ("muladd", (x[:1], x, x[:, :, :1]), -2),
        ("addmod", (x[0], x), -2),
        ("mulmod_shoup", (x.reshape(3, m, 8, degree // 8),
                          tabs.phis.reshape(m, 8, degree // 8),
                          tabs.shoupphis.reshape(m, 8, degree // 8)), -3),
    ]
    for op, leaves, axis in cases:
        got = _kernel_run(e1, ep.op_program(op), leaves, ring, axis)
        want = ep.run_plain(ep.op_program(op), leaves, tabs, axis)
        assert got.shape == want.shape and torch.equal(got, want), op


def test_odd_shapes_and_chunks(e1, rng):
    """Divisors that are not powers of two (the kernel's FastDiv), and
    launches in whole broadcast periods when a launch's cap is small."""
    ring = tnfl.ring_from_modulus("u32", 64, 90)          # m = 3
    tabs = ring.context().to(DEV)
    x = _words(ring, rng, (5, 3, 64), 1).reshape(5, 3, 8, 8)[..., :7, :5] \
        .contiguous()
    y = _words(ring, rng, (3, 64), 3).reshape(3, 8, 8)[:, :7, :5] \
        .contiguous()
    prog = ep.op_program("mulmod")
    for axis, leaves in ((-3, (x, y)), (-3, (y, x))):
        want = ep.run_plain(prog, leaves, tabs, axis)
        assert torch.equal(_kernel_run(e1, prog, leaves, ring, axis), want)
    x = _words(ring, rng, (7, 3, 64), 0)
    y = _words(ring, rng, (3, 64), 1)
    small = HostE1(e1.lib)
    small.MAX_ELEMENTS = 500                  # 2 periods of 192 a launch
    got = _kernel_run(small, prog, (x, y), ring)
    assert small.launches == 4
    assert torch.equal(got, ep.run_plain(prog, (x, y), tabs))


def test_wrapper_refuses(e1):
    ring = tnfl.ring_from_modulus("u64", 64, 124)
    x = torch.zeros((2, 64), dtype=torch.int64)
    with pytest.raises(ValueError):          # an int32 leaf on a u64 ring
        _kernel_run(e1, ep.op_program("addmod"), (x, x.int()), ring)
    with pytest.raises(ValueError):
        ep.run(ep.op_program("addmod"), (x,), ring)       # one leaf short
    with pytest.raises(ValueError):          # an operand after its node
        ep.Program(2, (("addmod", (0, 2)),))
    chain = ep.Program(1, (("reduce_once", (0,)),) + tuple(
        ("reduce_once", (k,)) for k in range(1, ep.MAX_NODES + 1)))
    with pytest.raises(ValueError):          # past the node cap
        _kernel_run(e1, chain, (x,), ring)
    assert torch.equal(ep.run(chain, (x,), ring), x)   # the twin takes it


# ---------------------------------------------------------------------------
# Expr trees against the JAX package
# ---------------------------------------------------------------------------

def _spec(pyrng, depth, nleaves, pool):
    """A random tree: ("leaf", i), (op, a, b) for add/sub/mul, ("shoup",
    a, i) for shoup(a * leaf_i, compute_shoup(leaf_i)); a subtree of
    `pool` is reused now and then (a shared subtree)."""
    if pool and pyrng.random() < 0.15:
        return pool[int(pyrng.integers(len(pool)))]
    if depth == 0 or pyrng.random() < 0.25:
        return ("leaf", int(pyrng.integers(nleaves)))
    if pyrng.random() < 0.12:
        s = ("shoup", _spec(pyrng, depth - 1, nleaves, pool),
             int(pyrng.integers(nleaves)))
    else:
        op = ("add", "sub", "mul")[int(pyrng.integers(3))]
        s = (op, _spec(pyrng, depth - 1, nleaves, pool),
             _spec(pyrng, depth - 1, nleaves, pool))
    pool.append(s)
    return s


def _realize(lib, spec, leaves, memo):
    """The spec's Expr (or leaf Poly) in package `lib`, one object for
    equal subtrees."""
    if spec in memo:
        return memo[spec]
    kind = spec[0]
    if kind == "leaf":
        r = leaves[spec[1]]
    elif kind == "shoup":
        b = leaves[spec[2]]
        r = lib.shoup(_realize(lib, spec[1], leaves, memo) * b,
                      b.compute_shoup())
    else:
        a, b = (_realize(lib, s, leaves, memo) for s in spec[1:])
        r = {"add": lambda u, v: u + v, "sub": lambda u, v: u - v,
             "mul": lambda u, v: u * v}[kind](a, b)
    memo[spec] = r
    return r


def _leaf_sets(limb, degree, bits, rng, count, batched):
    jring = nfl.ring_from_modulus(limb, degree, bits)
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    arrs = [_rand(jring, rng, (3,) if k in batched else ())
            for k in range(count)]
    jl = [nfl.Poly(a, jring) for a in arrs]
    tl = [interop.poly_from_numpy(a, ring, DEV) for a in arrs]
    return jl, tl, ring


def _rand(jring, rng, batch):
    out = np.empty(batch + jring.shape, dtype=np.uint64)
    for cm in range(jring.nmoduli):
        out[..., cm, :] = rng.integers(0, int(jring.moduli[cm]),
                                       size=batch + (jring.degree,),
                                       dtype=np.uint64)
    return out.astype(jring.dtype)


def _forced(lib, spec, leaves):
    e = _realize(lib, spec, leaves, {})
    return e.poly() if hasattr(e, "op") else e


@pytest.mark.parametrize("limb,degree,bits", [("u16", 128, 14),
                                              ("u32", 64, 60),
                                              ("u64", 64, 124)])
def test_random_trees_match_jax_chain_program(e1, monkeypatch, limb, degree,
                                              bits, rng):
    """Six random trees a tier over five leaves (two batched [3, m, n]):
    the JAX package's one jitted program, the port's twin walk and the
    host-built E1 give the same bytes; each tree below the caps is one
    launch."""
    pyrng = np.random.default_rng(777 + degree + bits)
    jl, tl, ring = _leaf_sets(limb, degree, bits, rng, 5, (1, 3))
    for trial in range(6):
        spec = _spec(pyrng, int(pyrng.integers(2, 6)), 5, [])
        if spec[0] == "leaf":
            spec = ("add", ("mul", ("leaf", 0), ("leaf", 1)), spec)
        want = np.asarray(_forced(nfl, spec, jl).data)
        got = interop.poly_to_numpy(_forced(tnfl, spec, tl))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        with monkeypatch.context() as mp:
            mp.setattr(ep, "run", lambda program, leaves, ring_,
                       channel_axis=-2: _kernel_run(e1, program, leaves,
                                                    ring_, channel_axis))
            expr = _realize(tnfl, spec, tl, {})
            program, _ = ep.from_expr(expr)
            before = e1.launches
            kern = interop.poly_to_numpy(expr.poly())
            # shoup's companions are computed (one launch each) while the
            # tree is built, before `before`
            assert e1.launches == before + 1, program
        assert kern.tobytes() == want.tobytes()


def _pair_sum(lib, leaves, pairs):
    """A balanced sum of the products leaves[i] * leaves[j] over `pairs`."""
    terms = [leaves[i] * leaves[j] for i, j in pairs]
    while len(terms) > 1:
        terms = [terms[k] + terms[k + 1] if k + 1 < len(terms) else terms[k]
                 for k in range(0, len(terms), 2)]
    return terms[0]


@pytest.mark.parametrize("count,npairs,limb,degree,bits", [
    (16, 70, "u32", 64, 60), (24, 12, "u64", 64, 124)])
def test_tree_past_the_caps(on_host_e1, count, npairs, limb, degree, bits,
                            rng):
    """Past MAX_NODES (70 distinct products of 16 leaves summed: more than
    64 nodes) or MAX_LEAVES (24 leaves): subtrees are forced into programs
    of their own first; the result equals the JAX package's one
    program."""
    jl, tl, ring = _leaf_sets(limb, degree, bits, rng, count, (2,))
    pairs = [(i, j) for i in range(count) for j in range(i + 1, count)
             if count <= 16 or j == i + 1 and i % 2 == 0][:npairs]
    big, jbig = _pair_sum(tnfl, tl, pairs), _pair_sum(nfl, jl, pairs)
    assert not ep._trace(big)[0].fits()
    before = on_host_e1.launches
    got = interop.poly_to_numpy(big.poly())
    assert on_host_e1.launches > before + 1
    want = np.asarray(jbig.poly().data)
    assert got.tobytes() == want.tobytes()


def test_cse_and_rewrites_in_the_program():
    ring = tnfl.ring_from_modulus("u32", 64, 60)
    a, b, c = (tnfl.Poly.zeros(ring, device=DEV) for _ in range(3))
    s = a + b
    prog, leaves = ep.from_expr(s * s - s)
    assert prog.nodes == (("addmod", (0, 1)), ("mulmod", (2, 2)),
                          ("submod", (3, 2)))
    assert leaves == [a, b]
    # two equal subtrees built apart are one node too (the JAX package's
    # trace-time CSE by key)
    prog, _ = ep.from_expr((a + b) * (a + b))
    assert [op for op, _ in prog.nodes] == ["addmod", "mulmod"]
    # both muladd rewrites, the left product first; shoup one node
    prog, _ = ep.from_expr(a * b + c * a)
    assert prog.nodes == (("mulmod", (2, 0)), ("muladd", (3, 0, 1)))
    prog, _ = ep.from_expr(c + a * b)
    assert prog.nodes == (("muladd", (0, 1, 2)),)
    prog, _ = ep.from_expr(tnfl.shoup(a * b, c) - a)
    assert prog.nodes == (("mulmod_shoup", (0, 1, 2)), ("submod", (3, 0)))
    # a forced operand is a leaf
    p = a * b
    p.poly()
    prog, leaves = ep.from_expr(p + c)
    assert prog.nodes == (("addmod", (0, 1)),) and leaves[0] is p._val
    # slots: a one-node program reads its leaves in place; a leaf read
    # twice is loaded once
    assert ep.op_program("muladd").code == (
        ((ep.OPS.index("muladd"), ep.OUT, (ep.LEAF, ep.LEAF + 1,
                                           ep.LEAF + 2)),), 0)
    instrs, slots = ep.from_expr(s * s - s)[0].code
    assert slots == 2 and [i[0] for i in instrs] == [
        ep.OPS.index("addmod"), ep.OPS.index("mulmod"),
        ep.OPS.index("submod")]


def test_named_ops_are_one_launch_each(on_host_e1, rng):
    """Poly.mulmod / mulmod_shoup / muladd / muladd_shoup / compute_shoup
    and a forced tree: one launch each, equal to the twin."""
    jring = nfl.ring_from_modulus("u64", 64, 124)
    ring = tnfl.ring_from_modulus("u64", 64, 124)
    a, b, c = (interop.poly_from_numpy(_rand(jring, rng, ()), ring, DEV)
               for _ in range(3))
    tabs = ring.context().to(DEV)
    calls = [
        (lambda: a.mulmod(b), ep.op_program("mulmod"), (a, b)),
        (lambda: b.compute_shoup(), ep.op_program("compute_shoup"), (b,)),
        (lambda: c.muladd(a, b), ep.op_program("muladd"), (c, a, b)),
    ]
    bp = b.compute_shoup()
    calls += [
        (lambda: a.mulmod_shoup(b, bp), ep.op_program("mulmod_shoup"),
         (a, b, bp)),
        (lambda: c.muladd_shoup(a, b, bp), ep.op_program("muladd_shoup"),
         (c, a, b, bp))]
    for fn, prog, leaves in calls:
        before = on_host_e1.launches
        got = fn()
        assert on_host_e1.launches == before + 1
        assert torch.equal(got.data, ep.run_plain(
            prog, [t.data for t in leaves], tabs))
    before = on_host_e1.launches
    tree = ((a * b + c) - tnfl.shoup(c * b, bp)) * a
    assert tree.poly() is tree.poly()
    assert on_host_e1.launches == before + 1


@pytest.mark.parametrize("limb,degree,bits", [("u16", 64, 14),
                                              ("u32", 64, 60),
                                              ("u64", 64, 124)])
def test_strict_mode_raises_on_a_noncanonical_leaf(e1, limb, degree, bits,
                                                   rng):
    """A word p in a checked operand raises in the twin (modops.op_check)
    and before E1's launch; in a Shoup companion it does not."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    tabs = ring.context().to(DEV)
    x = _storage(ring, _rand(ring, rng, ()))
    bad = x.clone()
    bad.view(-1)[5] = _storage(ring, [int(ring.moduli[0])])[0]
    prog = ep.op_program("mulmod_shoup")
    comp = modops.compute_shoup(x, tabs.p_col, tabs.shoup_f)
    debug.set_strictmod(True)
    try:
        for leaves in ((bad, x, comp), (x, bad, comp)):
            with pytest.raises(AssertionError):
                ep.run_plain(prog, leaves, tabs)
            before = e1.launches
            with pytest.raises(AssertionError):
                _kernel_run(e1, prog, leaves, ring)
            assert e1.launches == before
        ok = (x, x, bad)                       # a companion is a word
        assert torch.equal(_kernel_run(e1, prog, ok, ring),
                           ep.run_plain(prog, ok, tabs))
        a = tnfl.Poly(x, ring)
        with pytest.raises(AssertionError):
            tnfl.Poly(bad, ring) * a       # checked when the node is built
    finally:
        debug.set_strictmod(False)
