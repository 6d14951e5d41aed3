"""One pass per named op and per Expr tree: elementwise programs (E1).

PyTorch port of the JAX package's jitted pointwise programs: every named
Poly op is one jax.jit program per (ring, op) (nfllib_tpu/poly.py:59-89,
`_jitted_impl`) and every lazy Expr tree one per tree shape
(nfllib_tpu/poly.py:319-368, `_chain_program_impl`), which XLA fuses into
one pass over memory, as NFLlib's expression templates do (reference
core.hpp:25-37).  Here such a program is a `Program`: SSA nodes (opcode,
operand ids) over leaf tensors, the last node the output.  `run` sends it
to one launch of the hand-written kernel E1 (csrc/modops_expr.cu) when the
leaves are on the card, and to `run_plain`, a walk over ops/modops.py, the
kernel's twin, anywhere else.

Built from an Expr tree (`from_expr`) as the JAX package traces one: a
leaf is a Poly (by identity, as `Expr._flatten`), shared subtrees are one
node (the JAX package's trace-time CSE), add(mul(a, b), c) and add(c,
mul(a, b)) become muladd(c, a, b), the left product first
(nfllib_tpu/poly.py:341-352), and shoup(a * b, bprec) is one
mulmod_shoup.  A launch holds at most MAX_NODES nodes, MAX_LEAVES leaves
and MAX_SLOTS live intermediates (the kernel takes the program by value);
a tree past a cap has its largest operand subtrees forced into programs
of their own first, which gives the same result.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .. import debug, profiling
from . import modops

# the opcodes in the order of the kernel's `Op` enum, each op's arity, and
# the operand positions its modops function op_checks in strict mode
OPS = ("addmod", "submod", "mulmod", "muladd", "mulmod_shoup",
       "mulmod_shoup_lazy", "muladd_shoup", "compute_shoup", "reduce_once")
ARITY = {"addmod": 2, "submod": 2, "mulmod": 2, "muladd": 3,
         "mulmod_shoup": 3, "mulmod_shoup_lazy": 3, "muladd_shoup": 4,
         "compute_shoup": 1, "reduce_once": 1}
CHECKED = {"addmod": (0, 1), "submod": (0, 1), "mulmod": (0, 1),
           "muladd": (0, 1, 2), "mulmod_shoup": (0, 1),
           "mulmod_shoup_lazy": (), "muladd_shoup": (0, 1, 2),
           "compute_shoup": (), "reduce_once": ()}
LOAD = len(OPS)           # the kernel's kLoad: a leaf read into a slot
LEAF = 128                # source code LEAF + j: leaf j, read in place
OUT = 255                 # destination code of the output
MAX_NODES = 64
MAX_LEAVES = 16
MAX_SLOTS = 16


@dataclasses.dataclass(frozen=True)
class Program:
    """nodes: ((op, (operand ids...)), ...), an id below `nleaves` naming
    a leaf and nleaves + k node k; the last node is the output."""
    nleaves: int
    nodes: tuple

    def __post_init__(self):
        for k, (op, args) in enumerate(self.nodes):
            if len(args) != ARITY[op] or not all(
                    0 <= a < self.nleaves + k for a in args):
                raise ValueError(f"node {k}: {op}{args} is not a node over "
                                 f"{self.nleaves} leaves and the nodes "
                                 f"before it")

    @functools.cached_property
    def code(self):
        """(instructions, slots): the kernel's instructions (op, dst,
        srcs) after slot allocation: a leaf read once is read in place, a
        leaf read more often is loaded into a slot before its first use, a
        node's value takes a slot from its definition to its last use."""
        nl, last = self.nleaves, len(self.nodes) - 1
        uses, last_use = {}, {}
        for k, (_, args) in enumerate(self.nodes):
            for a in args:
                uses[a] = uses.get(a, 0) + 1
                last_use[a] = k
        free, slot_of, instrs, top = [], {}, [], 0

        def take():
            nonlocal top
            if free:
                return free.pop()
            top += 1
            return top - 1

        for k, (op, args) in enumerate(self.nodes):
            for a in args:
                if a < nl and uses[a] > 1 and a not in slot_of:
                    slot_of[a] = take()
                    instrs.append((LOAD, slot_of[a], (LEAF + a,)))
            srcs = tuple(slot_of[a] if a in slot_of else LEAF + a
                         for a in args)
            for a in sorted(set(args)):
                if a in slot_of and last_use[a] == k:
                    free.append(slot_of.pop(a))
            if k == last:
                dst = OUT
            else:
                dst = take()
                if nl + k in last_use:
                    slot_of[nl + k] = dst
                else:
                    free.append(dst)          # a value nothing reads
            instrs.append((OPS.index(op), dst, srcs))
        return tuple(instrs), top

    @functools.cached_property
    def code_bytes(self) -> bytes:
        """The instructions as the kernel reads them, 6 bytes each: op,
        dst, up to four sources (unused ones 0)."""
        return b"".join(bytes((op, dst) + srcs + (0,) * (4 - len(srcs)))
                        for op, dst, srcs in self.code[0])

    @functools.cached_property
    def checked_leaves(self) -> tuple:
        """Leaves that the plain walk's modops op_check in strict mode."""
        return tuple(sorted({args[i] for op, args in self.nodes
                             for i in CHECKED[op] if args[i] < self.nleaves}))

    def fits(self) -> bool:
        """Within one launch's caps."""
        return (len(self.nodes) <= MAX_NODES and self.nleaves <= MAX_LEAVES
                and self.code[1] <= MAX_SLOTS)


@functools.lru_cache(maxsize=None)
def op_program(name: str) -> Program:
    """The one-node program of the named op over its operands in modops'
    order (muladd: rop, x, y; muladd_shoup: rop, x, y, yprime)."""
    n = ARITY[name]
    return Program(n, ((name, tuple(range(n))),))


# ---------------------------------------------------------------------------
# Expr trees
# ---------------------------------------------------------------------------

def _is_open(a) -> bool:
    """An Expr node still to evaluate (a forced one is a leaf)."""
    return hasattr(a, "args") and a._val is None


def _is_product(a) -> bool:
    return _is_open(a) and a.op == "mul"


_OPCODE = {"add": "addmod", "sub": "submod", "mul": "mulmod",
           "shoup": "mulmod_shoup"}


class _Tracer:
    """One trace of an Expr tree: `leaves` (Polys by identity, numbered
    left to right as Expr._flatten numbers them), then `nodes`, one per
    distinct (op, operand ids) with the muladd rewrite (left product
    first), the tree's own last.  An id below `nleaves` names a leaf and
    nleaves + k node k, as in `Program`.  The state is attributes that
    the methods reach through `self`, so no closure or cycle holds it: the
    leaves are freed by reference count once the caller drops them."""

    def __init__(self, expr):
        self.leaves, self.leaf_id = [], {}
        self._collect(expr, set())
        self.nleaves = len(self.leaves)
        self.nodes, self.node_id, self.memo = [], {}, {}
        self._ev(expr)

    def _leaf(self, a) -> int:
        k = self.leaf_id.get(id(a))
        if k is None:
            k = self.leaf_id[id(a)] = len(self.leaves)
            self.leaves.append(a if not hasattr(a, "args") else a._val)
        return k

    def _collect(self, e, seen):
        for a in e.args:
            if not _is_open(a):
                self._leaf(a)
            elif id(a) not in seen:
                seen.add(id(a))
                self._collect(a, seen)

    def _node(self, op, args) -> int:
        key = (op, tuple(self._ev(a) for a in args))
        k = self.node_id.get(key)
        if k is None:
            k = self.node_id[key] = self.nleaves + len(self.nodes)
            self.nodes.append(key)
        return k

    def _ev(self, e) -> int:
        if not _is_open(e):
            return self._leaf(e)
        k = self.memo.get(id(e))
        if k is None:
            op, args = e.op, e.args
            if op == "add" and _is_product(args[0]):
                k = self._node("muladd", (args[1],) + args[0].args)
            elif op == "add" and _is_product(args[1]):
                k = self._node("muladd", (args[0],) + args[1].args)
            else:
                k = self._node(_OPCODE[op], args)
            self.memo[id(e)] = k
        return k

    def program(self) -> Program:
        return Program(self.nleaves, tuple(self.nodes))

    def size(self, e) -> int:
        """The node count of the program of e, an open operand in the
        tree, as its own trace would give it: the nodes its id reaches
        here, and for a product that the muladd rewrite folded into its
        parent, one node more than its operands reach."""
        k = self.memo.get(id(e))
        if k is not None:
            return len(self._reach((k,)))
        return 1 + len(self._reach(tuple(
            self.memo[id(a)] if _is_open(a) else self.leaf_id[id(a)]
            for a in e.args)))

    def _reach(self, ids) -> set:
        nl, seen = self.nleaves, set()
        stack = [k for k in ids if k >= nl]
        while stack:
            k = stack.pop()
            if k not in seen:
                seen.add(k)
                stack.extend(a for a in self.nodes[k - nl][1] if a >= nl)
        return seen


def from_expr(expr):
    """(Program, leaf Polys) of an unforced Expr, within one launch's caps:
    past them, the root's largest open operand subtree (by its node count,
    read off the same trace) is forced first (`.poly()`, its own program
    or programs) and becomes a leaf, until the rest fits.  Runs in span
    `nfl.expr_trace`, so a subtree forced here shows its `nfl.e1` (and its
    own `nfl.expr_trace`) inside it."""
    with profiling.span("expr_trace"):
        while True:
            t = _Tracer(expr)
            program = t.program()
            if program.fits():
                return program, t.leaves
            open_args = [a for a in expr.args if _is_open(a)]
            max(open_args, key=t.size).poly()


# ---------------------------------------------------------------------------
# running a program
# ---------------------------------------------------------------------------

def _channel_shaped(col: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """A [m, 1] table column as [m, 1, ..., 1] for the channel axis."""
    return col.reshape((col.shape[0],) + (1,) * (-channel_axis - 1))


def run_plain(program: Program, leaves, tabs, channel_axis: int = -2):
    """E1's twin: the nodes in order through ops/modops.py.  `tabs` is the
    ring's RingContext.to(device); each leaf becomes the ring's storage
    dtype first (an int64 table keeps its low limb bits, as modops' widen
    reads them), and the result is in it."""
    p = _channel_shaped(tabs.p_col, channel_axis)
    pn = _channel_shaped(tabs.pn_col, channel_axis)
    f = _channel_shaped(tabs.shoup_f, channel_axis)
    fns = {
        "addmod": lambda x, y: modops.addmod(x, y, p),
        "submod": lambda x, y: modops.submod(x, y, p),
        "mulmod": lambda x, y: modops.mulmod(x, y, p, pn),
        "muladd": lambda r, x, y: modops.muladd(r, x, y, p, pn),
        "mulmod_shoup": lambda x, y, yp: modops.mulmod_shoup(x, y, yp, p),
        "mulmod_shoup_lazy": lambda x, y, yp: modops.mulmod_shoup_lazy(
            x, y, yp, p),
        "muladd_shoup": lambda r, x, y, yp: modops.muladd_shoup(
            r, x, y, yp, p),
        "compute_shoup": lambda y: modops.compute_shoup(y, p, f),
        "reduce_once": lambda x: modops.reduce_once(x, p),
    }
    vals = [t.to(tabs.storage_dtype) for t in leaves]
    for op, args in program.nodes:
        vals.append(fns[op](*(vals[a] for a in args)))
    return vals[-1]


def run(program: Program, leaves, ring, channel_axis: int = -2):
    """The program over `leaves` (storage tensors of `ring`, or int64
    tables, broadcasting against each other, the channel axis at
    `channel_axis`) -> a new tensor in the ring's storage dtype.  On CUDA
    tensors one launch of E1, whose strict mode checks the leaves the plain
    walk checks; on any other device `run_plain`."""
    with profiling.span("e1"):
        if len(leaves) != program.nleaves:
            raise ValueError(f"the program reads {program.nleaves} leaves, "
                             f"got {len(leaves)}")
        dev = leaves[0].device
        if any(t.device != dev for t in leaves):
            raise ValueError(f"leaves on several devices: "
                             f"{sorted({str(t.device) for t in leaves})}")
        tabs = ring.context().to(dev)
        if dev.type != "cuda":
            return run_plain(program, leaves, tabs, channel_axis)
        from .._kernels import MODOPS_EXPR
        return _run_kernel(program, leaves, tabs, channel_axis, MODOPS_EXPR)


def _broadcast(shapes) -> tuple:
    """torch.broadcast_shapes, without its cost on the launch path."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, d in enumerate(s, nd - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def _run_kernel(program: Program, leaves, tabs, channel_axis, kernel):
    """One launch of `kernel` (E1's wrapper) after strict mode's checks of
    the leaves that the plain walk checks."""
    if debug.strictmod_enabled():
        p = _channel_shaped(tabs.p_col, channel_axis)
        for j in program.checked_leaves:
            debug.check_residues(leaves[j], p)
    p_shape = (tabs.p_col.shape[0],) + (1,) * (-channel_axis - 1)
    shape = _broadcast([tuple(t.shape) for t in leaves] + [p_shape])
    return kernel(program, leaves, tabs.expr_consts, shape, channel_axis,
                  tabs.storage_dtype)


def apply(name: str, leaves, ring, channel_axis: int = -2):
    """run(op_program(name), leaves, ...): one named op."""
    return run(op_program(name), leaves, ring, channel_axis)
