"""E1, the elementwise program kernel (nfllib_tpu_torch/csrc/modops_expr.cu),
and its programs (nfllib_tpu_torch/ops/expr_program.py), on the CPU.

The kernel's CUDA source is compiled with g++ against tests/cuda_host_mock.h
(tests/cuda_host_build.py, once for this module) and driven through the
port's own wrapper (`_kernels.ModopsExprKernel`, its leaf preparation and
chunking) with CPU tensors.  It must be bit-identical (exact, no
tolerance) to the twin `expr_program.run_plain` for every opcode and limb
tier, on canonical residues and on the words 0, 1, p - 1, p, 2^w - 1 (the
strict mode's poison) and arbitrary words, in each instance family the
kernel has (16-byte vector lanes or one word a step, the compiled named
op or the interpreter); the host takes the one-word instance where the
lanes do not fit (an odd slab, an odd leaf, a leaf off the 16-byte
grid).  The programs built from `Expr`
trees must give the JAX package's `_chain_program` results byte for byte
on a random-tree fuzz (shared subtrees, `shoup`, both muladd rewrites,
leaves broadcast over a batch, trees past the launch caps), through the
twin and through the host-built kernel.  Inputs come from numpy seeds.
Without g++ the kernel's tests skip.
"""
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
# (limb, degree, modulus bits): u16 at one and two 14-bit moduli, u32 at
# two 30-bit ones, u64 at two 62-bit ones
TIERS = [("u16", 64, 14), ("u16", 64, 28), ("u32", 64, 60),
         ("u64", 64, 124)]


# the kernel's instance families, each reached by its inputs alone:
# (compiled one-node program, one word a step)
FAMILIES = {"lanes": (False, False), "one_word": (False, True),
            "named": (True, False), "named_one_word": (True, True)}
VEC = {"u16": 8, "u32": 4, "u64": 2}


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
                                ("launch.cuh", "modops_expr.cu"),
                                ("modops_expr.cu",))
    lib.nfl_modops_expr.argtypes = _kernels.MODOPS_EXPR_ARGTYPES
    return HostE1(lib)


@pytest.fixture(params=list(FAMILIES))
def family(request):
    """in_family(op, leaves, vec) -> (program, leaves, the instance E1
    must take): the named op's program and leaves (at shapes the vector
    lanes fit), made to reach one instance family by the inputs alone.
    The interpreter: the same node behind a leaf it does not read, so the
    program is not a named op over its leaves in order; one word a step:
    the first leaf a contiguous view off the 16-byte grid."""
    named, one_word = FAMILIES[request.param]

    def in_family(op, leaves, vec):
        leaves = list(leaves)
        if one_word:
            leaves[0] = _misaligned(leaves[0])
        program = ep.op_program(op)
        if not named:
            k = program.nleaves
            program = ep.Program(k + 1, ((op, tuple(range(1, k + 1))),))
            leaves = leaves[:1] + leaves
        return program, leaves, ("named" if named else "tree",
                                 1 if one_word else vec)
    return in_family


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
def test_every_opcode_bit_identical_to_twin(e1, family, limb, degree, bits,
                                            op, rng):
    """One launch a named op over [3, m, n] words, canonical and not, equal
    to the twin's words bit for bit; arbitrary Shoup companions in the
    first polynomial, the residues' companions in the others.  Each
    instance family: the interpreter with vector lanes and one word a
    step, the compiled one-node program with both."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    shape = (3, ring.nmoduli, degree)
    leaves = [_words(ring, rng, shape, k) for k in range(ep.ARITY[op])]
    if op in ("mulmod_shoup", "mulmod_shoup_lazy", "muladd_shoup"):
        tabs = ring.context().to(DEV)
        y = leaves[-2]
        good = modops.compute_shoup(y, tabs.p_col, tabs.shoup_f)
        first = (torch.arange(3) == 0).reshape(3, 1, 1)
        leaves[-1] = torch.where(first, leaves[-1], good)
    program, leaves, instance = family(op, leaves, VEC[limb])
    before = e1.launches
    got = _kernel_run(e1, program, leaves, ring)
    want = ep.run_plain(program, leaves, ring.context().to(DEV))
    assert e1.launches == before + 1
    assert e1.last_instance == instance
    assert got.dtype == want.dtype == ring.torch_dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("limb,degree,bits", TIERS)
@pytest.mark.parametrize("op", ("mulmod", "muladd", "compute_shoup",
                                "muladd_shoup"))
def test_arbitrary_words_at_volume(e1, family, limb, degree, bits, op):
    """8192 elements of arbitrary words an operand (residues or not), so
    that the rare corrections (a carry of the Newton quotient, the third
    step of compute_shoup's quotient, the first correction of the 2-by-1
    division; its second is test_narrow_reduction_every_modulus's) run
    too, in each instance family."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    g = np.random.default_rng(99 + bits)
    shape = (64 // ring.nmoduli, ring.nmoduli, degree)
    leaves = [_storage(ring, g.integers(0, 1 << ring.repr_bits, size=shape,
                                        dtype=np.uint64))
              for _ in range(ep.ARITY[op])]
    program, leaves, instance = family(op, leaves, VEC[limb])
    assert torch.equal(_kernel_run(e1, program, leaves, ring),
                       ep.run_plain(program, leaves,
                                    ring.context().to(DEV)))
    assert e1.last_instance == instance


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


CHOICE_TIERS = [("u16", 64, 28), ("u32", 64, 60), ("u64", 64, 124)]


def _misaligned(t):
    """t's values in a contiguous view one word into a larger storage:
    t[..., 1:] of a tensor one word longer, made contiguous by its
    layout, so its pointer is off the 16-byte grid"""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("limb,degree,bits", CHOICE_TIERS)
@pytest.mark.parametrize("case", ("slab", "leaf_count", "misaligned"))
@pytest.mark.parametrize("op", ("muladd", "mulmod_shoup"))
def test_host_chooses_one_word_lanes(e1, limb, degree, bits, case, op, rng):
    """The host takes the one-word instance when the vector lanes do not
    fit: a slab that is not a multiple of the lanes, a leaf whose element
    count is not one (while the slab is), a leaf that is a contiguous view
    off the 16-byte grid; the named op and a tree over the same leaves
    stay exact there, as at the aligned shapes next to them."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    tabs = ring.context().to(DEV)
    m, vec, k = ring.nmoduli, VEC[limb], ep.ARITY[op]
    words = [_words(ring, rng, (3, m, degree), a) for a in range(k)]
    if case == "slab":            # [3, m, 3, vec + 1]: an odd slab
        leaves = [w[..., :3 * vec + 3].reshape(3, m, 3, vec + 1)
                  .contiguous() for w in words]
        axis = -3
    elif case == "leaf_count":    # slab 3 vec, a leaf of [3] broadcast
        leaves = [w[..., :3 * vec].reshape(3, m, vec, 3).contiguous()
                  for w in words]
        leaves[1] = leaves[1][0, 0, 0].contiguous()
        axis = -3
    else:
        leaves, axis = list(words), -2
        leaves[1] = _misaligned(leaves[1])
    if op == "mulmod_shoup":      # a canonical companion for leaf 1
        leaves[2] = modops.compute_shoup(
            leaves[1], ep._channel_shaped(tabs.p_col, axis),
            ep._channel_shaped(tabs.shoup_f, axis)).expand(
                leaves[0].shape).contiguous()
    tree = ep.Program(k, ((op, tuple(range(k))), ("addmod", (k, 0))))
    for program, kind in ((ep.op_program(op), "named"), (tree, "tree")):
        want = ep.run_plain(program, leaves, tabs, axis)
        got = _kernel_run(e1, program, leaves, ring, axis)
        assert e1.last_instance == (kind, 1), (case, kind)
        assert torch.equal(got, want), (case, kind)
        if case != "misaligned":
            continue
        aligned = [t.clone() for t in leaves]
        assert torch.equal(_kernel_run(e1, program, aligned, ring, axis),
                           want)
        assert e1.last_instance == (kind, vec)


@pytest.mark.parametrize("limb,degree,bits", CHOICE_TIERS)
def test_chunk_boundaries_on_the_vector_grid(e1, limb, degree, bits, rng):
    """Chunks of whole broadcast periods whose offsets are multiples of the
    lanes keep the vector instance in every launch, named and tree, exact
    across the boundaries."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    tabs = ring.context().to(DEV)
    m = ring.nmoduli
    x = _words(ring, rng, (7, m, degree), 0)
    y = _words(ring, rng, (m, degree), 1)
    period = m * degree
    small = HostE1(e1.lib)
    small.MAX_ELEMENTS = 2 * period + 5       # two periods a launch
    assert (2 * period) % VEC[limb] == 0
    tree = ep.Program(2, (("mulmod", (0, 1)), ("submod", (2, 1))))
    for program, kind in ((ep.op_program("mulmod"), "named"),
                          (tree, "tree")):
        before = small.launches
        got = _kernel_run(small, program, (x, y), ring)
        assert small.launches == before + 4
        assert small.last_instance == (kind, VEC[limb])
        assert torch.equal(got, ep.run_plain(program, (x, y), tabs))


# E1's narrow arithmetic on the host, one translation unit with the source
NARROW_HARNESS = r"""
#include "modops_expr.cu"
// the products and companions of n word pairs under each modulus (its
// expr_consts row), against the twin's int64 arithmetic written out:
// mismatches, and the first one's (modulus, pair) in bad[0..1]
extern "C" long long e1_narrow_check(int bits, const unsigned long long* rows,
                                     int nmod, const unsigned* xs,
                                     const unsigned* ys, int n, int* bad) {
  long long wrong = 0;
  for (int k = 0; k < nmod; ++k) {
    const Narrow c = load_chan<32>(rows + 4 * k);
    const long long p = c.p;
    for (int i = 0; i < n; ++i) {
      const unsigned x = xs[i], y = ys[i];
      const long long v = static_cast<long long>(
          static_cast<unsigned long long>(x) * y);         // wraps at 2^63
      const unsigned want_mul = static_cast<unsigned>((v % p + p) % p);
      const unsigned want_shoup = static_cast<unsigned>(
          ((static_cast<unsigned long long>(y) % p) << bits) / p);
      const unsigned got_mul = bits == 32 ? mul_narrow<32>(x, y, c)
                                          : mul_narrow<16>(x, y, c);
      const unsigned got_shoup = bits == 32 ? shoup_narrow<32>(y, c)
                                            : shoup_narrow<16>(y, c);
      if (got_mul != want_mul || got_shoup != want_shoup) {
        if (wrong++ == 0) {
          bad[0] = k;
          bad[1] = i;
        }
      }
    }
  }
  return wrong;
}
"""


# u32 word pairs whose product's 2-by-1 division takes its second
# correction (the quotient estimate two short) under the modulus beside
# them: (p, x, y).  It needs the division's high word within about 1.6 %
# of d and an estimate error (2^64 - 1) mod d close to d, which 5 of the
# u32 moduli have; at u16 (a high word below 2^18) and in the companion's
# division (a low word of 0) the estimate is never two short.
SECOND_CORRECTION = (
    (919601153, 978262865, 4037417649), (919601153, 1203578009, 3281593021),
    (875298817, 1241198333, 3028830721), (875298817, 884878716, 4248464113),
    (882245633, 896574636, 4226320565), (882245633, 1246101743, 3040853992),
    (897581057, 1174978692, 3280977097), (897581057, 1690694653, 2280174587),
    (936312833, 1056920118, 3804858779), (936312833, 1469455037, 2736682809))


def _second_correction(p, x, y):
    """Whether E1's 32-bit product of the words x, y under p reaches the
    second correction of its 2-by-1 division (Moller and Granlund,
    Algorithm 4, as csrc/modops_expr.cu:div21 runs it)."""
    s = 32 - p.bit_length()
    d, top = p << s, (1 << 32) - 1
    v = ((1 << 64) - 1) // d - (1 << 32)
    h, lo = (x * y >> 32) % p, x * y & top
    u1, u0 = (h << s | lo >> (32 - s)) & top, lo << s & top
    q = (v * u1 + (u1 << 32 | u0)) % (1 << 64)
    r = (u0 - ((q >> 32) + 1) * d) & top
    if r > q & top:
        r = (r + d) & top
    return r >= d


@pytest.mark.parametrize("limb", ("u16", "u32"))
def test_narrow_reduction_every_modulus(tmp_path, limb):
    """The 32-bit reduction (a Barrett step, then the 2-by-1 division) and
    the companion's division under every modulus of the tier, with its
    `expr_consts` row as the ring builds it: every product x * y of two
    limb words, wrapped at 2^63 as the twin's int64 product is, and
    floor((y mod p) 2^w / p), equal to the integer arithmetic written out,
    on 4096 random pairs, all pairs of the words 0, 1, p - 1, p, p + 1,
    2^w - 1 of each modulus and, at u32, the pairs that reach the
    division's second correction."""
    import ctypes
    from nfllib_tpu_torch import params
    from nfllib_tpu_torch.ring import _narrow_expr_consts
    lib = cuda_host_build.build(tmp_path, ("launch.cuh", "modops_expr.cu"),
                                (),
                                {"e1_harness.cpp": NARROW_HARNESS})
    lib.e1_narrow_check.restype = ctypes.c_longlong
    bits = 16 if limb == "u16" else 32
    moduli = [int(p) for p in params.get_limb_params(limb).P]
    rows = np.array([_narrow_expr_consts(p) for p in moduli],
                    dtype=np.uint64)
    g = np.random.default_rng(5 + bits)
    top = (1 << bits) - 1
    xs = [g.integers(0, 1 << bits, size=4096, dtype=np.uint64)]
    ys = [g.integers(0, 1 << bits, size=4096, dtype=np.uint64)]
    for p in moduli:
        w = np.array([0, 1, p - 1, p, p + 1, top], dtype=np.uint64)
        xs.append(np.repeat(w, len(w)))
        ys.append(np.tile(w, len(w)))
    if bits == 32:
        assert all(p in moduli and _second_correction(p, x, y)
                   for p, x, y in SECOND_CORRECTION)
        xs.append(np.array([x for _, x, _ in SECOND_CORRECTION],
                           dtype=np.uint64))
        ys.append(np.array([y for _, _, y in SECOND_CORRECTION],
                           dtype=np.uint64))
    xs = np.ascontiguousarray(np.concatenate(xs).astype(np.uint32))
    ys = np.ascontiguousarray(np.concatenate(ys).astype(np.uint32))
    bad = (ctypes.c_int * 2)()
    wrong = lib.e1_narrow_check(
        bits, rows.ctypes.data_as(ctypes.c_void_p), len(moduli),
        xs.ctypes.data_as(ctypes.c_void_p),
        ys.ctypes.data_as(ctypes.c_void_p), len(xs), bad)
    assert wrong == 0, (f"{wrong} mismatches, first p = {moduli[bad[0]]}, "
                        f"x = {xs[bad[1]]}, y = {ys[bad[1]]}")


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
    assert not ep._Tracer(big).program().fits()
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


def _jax_ring(ring):
    """the JAX package's ring of the port's ring"""
    return nfl.Ring(ring.limb, ring.degree, ring.nmoduli)


@pytest.mark.parametrize("B", [1, 3])
def test_pair_bridge_route_through_e1(e1, B, rng):
    """K11 on the card is one E1 launch, the one-node mulmod_shoup over x
    [B, m, R, C] and tw / tws [m, R, C] broadcast over B, the channel axis
    at -3 (ops/pair_bridge.py:_route): bit-identical to
    mulmod_shoup_u64_plain and to the JAX package's pair bridge (its
    Pallas kernel in interpret mode), x holding the words 0, p - 1, p,
    p + 1 and 2^64 - 1 beside residues.  Like the JAX kernel it checks
    nothing in strict mode, so a word >= p passes there too."""
    import jax.numpy as jnp
    from nfllib_tpu.ops import pair_bridge as jpb
    from nfllib_tpu_torch.ops import pair_bridge as tpb
    ring = tnfl.ring_from_modulus("u64", 1024, 124)
    m, R, C = ring.nmoduli, 8, 128
    x = np.empty((B, m, R, C), dtype=np.uint64)
    tw = np.empty((m, R, C), dtype=np.uint64)
    tws = np.empty_like(tw)
    for cm in range(m):
        p = int(ring.moduli[cm])
        x[:, cm] = rng.integers(0, p, (B, R, C), dtype=np.uint64)
        x[0, cm, 0, :5] = [0, p - 1, p, p + 1, (1 << 64) - 1]
        tw[cm] = rng.integers(0, p, (R, C), dtype=np.uint64)
        tw[cm, 0, :2] = [0, p - 1]
        tws[cm] = np.array([(int(v) << 64) // p for v in tw[cm].reshape(-1)],
                           dtype=object).astype(np.uint64).reshape(R, C)
    xt, twt, twst = (torch.from_numpy(a.view(np.int64).copy())
                     for a in (x, tw, tws))
    before = e1.launches
    got = tpb._route(xt, twt, twst, ring, e1)
    assert e1.launches == before + 1
    assert e1.last_instance == ("named", 2)
    assert torch.equal(got, tpb.mulmod_shoup_u64_plain(xt, twt, twst, ring))
    want = jpb.mulmod_shoup_u64(jnp.asarray(x), jnp.asarray(tw),
                                jnp.asarray(tws), _jax_ring(ring))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(want))
    debug.set_strictmod(True)
    try:
        assert torch.equal(tpb._route(xt, twt, twst, ring, e1), got)
    finally:
        debug.set_strictmod(False)
