"""Poly — the polynomial value type (reference include/nfl/poly.hpp).

PyTorch port of nfllib_tpu/poly.py.  A Poly holds a residue tensor of shape
[..., nmoduli, degree] in the ring's storage dtype (int16 for u16, int32
for u32, int64 for u64, holding the unsigned bit pattern) on any device,
plus its `Ring`.
Constructors put it on the card unless the caller names another device
(`device="cpu"`); see ring.DEFAULT_DEVICE.
Leading axes are free batch dimensions.  Operations never modify a Poly's
tensor: every result is a new Poly.

Operator sugar mirrors the reference's expression-template surface
(poly.hpp:346-352): `+ - *` build a lazy `Expr` op tree; demanding a value
runs the whole tree as ONE elementwise program (ops/expr_program.py): on
the card one launch of the kernel E1, the single pass of the reference's
assignment loop (core.hpp:25-37) and of the JAX package's jitted tree;
elsewhere its plain twin.  The named ops (mulmod, mulmod_shoup, muladd,
muladd_shoup, compute_shoup) are one-node programs.  Two rewrites keep
the reference's semantics: `shoup(a * b, bprec)` becomes one mulmod_shoup
(ops.hpp:267-277), and add(mul(a, b), c) becomes one muladd (opt/ops.hpp),
bit-identical to addmod(mulmod(a, b), c).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import debug
from .ops import expr_program
from .ops import ntt as ntt_mod
from .prng.sampling import (ZO_dist, gaussian, hwt_dist, non_uniform,
                            sample, uniform)
from .ring import DEFAULT_DEVICE, Ring

__all__ = ["Poly", "PolyP", "Expr", "MulExpr", "shoup", "compute_shoup",
           "add", "sub", "mul", "uniform", "non_uniform", "ZO_dist",
           "hwt_dist", "gaussian"]


def _to_storage(arr, ring: Ring) -> torch.Tensor:
    """numpy unsigned limb array -> storage tensor (same bytes)."""
    arr = np.ascontiguousarray(np.asarray(arr).astype(ring.dtype, copy=False))
    return torch.from_numpy(arr.view(ring.limb_params.signed_dtype).copy())


@dataclasses.dataclass(frozen=True)
class Poly:
    data: torch.Tensor     # [..., nmoduli, degree], storage dtype
    ring: Ring

    def __post_init__(self):
        if tuple(self.data.shape[-2:]) != self.ring.shape:
            raise ValueError(f"expected [..., {self.ring.nmoduli}, "
                             f"{self.ring.degree}] residues of {self.ring}, "
                             f"got {tuple(self.data.shape)}")

    # --- constructors -------------------------------------------------------
    @classmethod
    def zeros(cls, ring: Ring, batch=(), device=DEFAULT_DEVICE):
        return cls(torch.zeros(tuple(batch) + ring.shape,
                               dtype=ring.torch_dtype, device=device), ring)

    @classmethod
    def from_coeffs(cls, ring: Ring, values, reduce_coeffs: bool = True,
                    device=DEFAULT_DEVICE):
        """set(It, It) semantics (reference core.hpp:103-136): either up to
        `degree` coefficients broadcast to every channel (zero padded), or the
        full nmoduli*degree array."""
        vals = [int(v) for v in np.asarray(values).reshape(-1)]
        n, m = ring.degree, ring.nmoduli
        if len(vals) > n and len(vals) != n * m:
            raise ValueError(
                "initializer of size above degree but not equal to "
                "nmoduli*degree")
        data = np.zeros((m, n), dtype=ring.dtype)
        mask = (1 << ring.repr_bits) - 1
        for cm in range(m):
            p = int(ring.moduli[cm])
            row = vals[cm * n:(cm + 1) * n] if len(vals) == n * m else vals
            data[cm][: len(row)] = [
                (v % p if reduce_coeffs else v) & mask for v in row]
        return cls.from_numpy(ring, data, device)

    @classmethod
    def constant(cls, ring: Ring, v: int, reduce_coeffs: bool = True,
                 device=DEFAULT_DEVICE):
        if v == 0:
            return cls.zeros(ring, device=device)
        return cls.from_coeffs(ring, [v], reduce_coeffs, device)

    @classmethod
    def from_numpy(cls, ring: Ring, arr, device=DEFAULT_DEVICE):
        """[..., m, n] unsigned residues (e.g. the JAX package's Poly.data)."""
        arr = np.asarray(arr)
        if arr.shape[-2:] != ring.shape:
            raise ValueError(f"expected [..., {ring.nmoduli}, {ring.degree}] "
                             f"residues, got {arr.shape}")
        return cls(_to_storage(arr, ring).to(device), ring)

    @classmethod
    def sample(cls, ring: Ring, mode, stream, device=DEFAULT_DEVICE):
        """Draw a random polynomial (reference poly(mode) constructors):
        mode is uniform(), non_uniform(ub, amp), ZO_dist(rho),
        hwt_dist(h) or gaussian(fg_prng, amp), drawn on the host from
        `stream`.  On a channel block (Ring.channel_block) the draw is the
        rows first .. first + m - 1 of the same draw on the whole ring, and
        it leaves the stream at the nonce the whole draw leaves it at."""
        return cls.from_numpy(ring, sample(ring, mode, stream), device)

    @classmethod
    def sample_on_device(cls, ring: Ring, mode, key: bytes, nonce=0,
                         device=DEFAULT_DEVICE):
        """Draw a random polynomial with the keystream generated and consumed
        on `device` (prng/device_sampling.py: S1, or the Gaussian's S3, on
        the card, their twins on the CPU); `nonce` is a Python int or a 0-d
        int64 tensor on `device`.  uniform, non_uniform and ZO_dist equal
        Poly.sample on a stream at the same (key, nonce).  On a channel
        block the draw is the rows first .. first + m - 1 of the same draw
        on the whole ring."""
        from .prng.device_sampling import device_sample
        return cls(device_sample(ring, mode, key, nonce, device), ring)

    def to(self, device) -> "Poly":
        return Poly(self.data.to(device), self.ring)

    def numpy(self) -> np.ndarray:
        """Residues as the unsigned limb dtype (the JAX package's layout)."""
        return self.data.cpu().numpy().view(self.ring.dtype)

    # --- basic introspection -------------------------------------------------
    @property
    def batch_shape(self):
        return tuple(self.data.shape[:-2])

    @property
    def nmoduli(self):
        return self.ring.nmoduli

    @property
    def degree(self):
        return self.ring.degree

    @property
    def device(self) -> torch.device:
        return self.data.device

    def get_modulus(self, cm: int) -> int:
        return int(self.ring.moduli[cm])

    def __call__(self, cm: int, i: int) -> int:
        """Residue accessor `p(cm, i)` (reference poly.hpp:156-158)."""
        return int(self.numpy()[..., cm, i])

    def __iter__(self):
        """Iterate residues in storage order (reference begin()/end():
        moduli-major over the flat array)."""
        return iter(self.numpy().reshape(-1).tolist())

    def __bool__(self):
        # reference operator bool: any nonzero coefficient (core.hpp:39-43)
        return bool((self.data != 0).any())

    def __repr__(self):
        return (f"Poly(ring={self.ring.limb}/n={self.ring.degree}"
                f"/m={self.ring.nmoduli}, batch={self.batch_shape}, "
                f"device={self.device})")

    def __str__(self):
        """Reference operator<< format (core.hpp:398-421): residues in
        storage order as a C initializer list, the limb suffix (ULL / UL /
        U) printed after each value but the first's predecessor, i.e.
        '{ 1UL, 2UL, 3UL }' for u32."""
        term = {"u64": "ULL", "u32": "UL", "u16": "U"}[self.ring.limb]
        out = ["{ "]
        for k, v in enumerate(self):
            out.append(str(v) if k == 0 else f"{term}, {v}")
        out.append(f"{term} }}")
        return "".join(out)

    # --- helpers -------------------------------------------------------------
    def _tabs(self):
        return self.ring.context().to(self.device)

    def _p(self):
        return self._tabs().p_col

    def _strict_check(self, *polys):
        if debug.strictmod_enabled():
            for q in polys:
                debug.check_residues(q.data, self._p())

    def _check_same_ring(self, *others):
        for other in others:
            if self.ring != other.ring:
                raise ValueError(f"ring mismatch: {self.ring} vs {other.ring}")

    def _wrap(self, data):
        return Poly(data, self.ring)

    # --- arithmetic (reference poly.hpp:346-352 operator set) ----------------
    def __add__(self, other):
        return Expr("add", (self, _as_operand(other)))

    def __radd__(self, other):
        return Expr("add", (_as_operand(other), self))

    def __sub__(self, other):
        return Expr("sub", (self, _as_operand(other)))

    def __rsub__(self, other):
        return Expr("sub", (_as_operand(other), self))

    def __mul__(self, other):
        return Expr("mul", (self, _as_operand(other)))

    def __rmul__(self, other):
        return Expr("mul", (_as_operand(other), self))

    def __eq__(self, other):
        if isinstance(other, Expr):
            other = other.poly()
        if not isinstance(other, Poly) or other.ring != self.ring:
            return NotImplemented
        return torch.equal(self.data, other.data)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None

    def eqmod(self, other):
        """Elementwise equality mask (reference ops eqmod)."""
        return self.data == _as_poly(other).data

    def _run(self, name, *others):
        """The named op as a one-node program over self and `others`."""
        return self._wrap(expr_program.apply(
            name, (self.data,) + tuple(o.data for o in others), self.ring))

    def mulmod(self, other):
        """Pointwise modular multiplication."""
        other = _as_poly(other)
        self._check_same_ring(other)
        return self._run("mulmod", other)

    def mulmod_shoup(self, other, other_prec):
        other = _as_poly(other)
        self._check_same_ring(other, other_prec)
        return self._run("mulmod_shoup", other, other_prec)

    def muladd(self, x, y):
        """self + x*y mod p, fused (reference opt/ops.hpp muladd)."""
        self._check_same_ring(x, y)
        return self._run("muladd", x, y)

    def muladd_shoup(self, x, y, yprec):
        """self + x*y mod p via Shoup (reference opt/ops.hpp:54-78)."""
        self._check_same_ring(x, y, yprec)
        return self._run("muladd_shoup", x, y, yprec)

    def compute_shoup(self):
        """Precompute Shoup companions (reference ops.hpp:165-177)."""
        return self._run("compute_shoup")

    # --- NTT (reference poly.hpp:167-168) -------------------------------------
    def ntt_pow_phi(self):
        self._strict_check(self)
        return self._wrap(ntt_mod.ntt_pow_phi(self.data, self.ring.context()))

    def invntt_pow_invphi(self):
        return self._wrap(
            ntt_mod.invntt_pow_invphi(self.data, self.ring.context()))

    # --- serialization / CRT bridges ------------------------------------------
    def serialize_manually(self) -> bytes:
        from .serialize import serialize_poly
        return serialize_poly(self)

    def poly2mpz(self):
        from .crt import poly2mpz
        return poly2mpz(self)


# poly_p parity alias (reference poly_p.hpp:10-204): a Poly never changes
# its tensor, so the copy-on-write wrapper has nothing left to do
PolyP = Poly


class Expr:
    """Lazy elementwise op tree (reference ops::expr, ops.hpp:52-97).

    Nodes: add / sub / mul / shoup(a, b, bprec); operands are Polys or nested
    Exprs.  Demanding a value (``.poly()``, ``.data``, comparison, NTT, any
    Poly method) runs the tree once as one elementwise program
    (expr_program.from_expr: shared subtrees once, the muladd rewrite; on
    the card one E1 launch below the program caps) and keeps the
    result."""

    __slots__ = ("op", "args", "ring", "_val", "depth")

    # Trees deeper than this force their deep operands eagerly, so an
    # accumulation loop (`acc = acc + x` repeated) cannot grow a tree whose
    # evaluation outruns the Python recursion limit.
    _MAX_DEPTH = 32

    def __init__(self, op: str, args):
        args = tuple(
            a.poly() if isinstance(a, Expr) and a.depth >= self._MAX_DEPTH
            else a
            for a in args)
        ring = args[0].ring
        for a in args[1:]:
            if a.ring != ring:
                raise ValueError(f"ring mismatch: {ring} vs {a.ring}")
        if debug.strictmod_enabled():
            # reference CHECK_STRICTMOD asserts at every op boundary
            # (debug.hpp:33-37): check Poly operands when the node is built
            for a in args:
                if isinstance(a, Poly):
                    debug.check_residues(a.data, a._p())
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "args", args)
        object.__setattr__(self, "ring", ring)
        object.__setattr__(self, "_val", None)
        object.__setattr__(self, "depth", 1 + max(
            (a.depth for a in args if isinstance(a, Expr)), default=0))

    # --- evaluation ---------------------------------------------------------
    def poly(self) -> Poly:
        if self._val is not None:
            return self._val
        program, leaves = expr_program.from_expr(self)
        val = Poly(expr_program.run(program, [a.data for a in leaves],
                                    self.ring), self.ring)
        object.__setattr__(self, "_val", val)
        return val

    @property
    def data(self):
        return self.poly().data

    # --- lazy operators (stay lazy: extend the tree) ------------------------
    def __add__(self, other):
        return Expr("add", (self, _as_operand(other)))

    def __radd__(self, other):
        return Expr("add", (_as_operand(other), self))

    def __sub__(self, other):
        return Expr("sub", (self, _as_operand(other)))

    def __rsub__(self, other):
        return Expr("sub", (_as_operand(other), self))

    def __mul__(self, other):
        return Expr("mul", (self, _as_operand(other)))

    def __rmul__(self, other):
        return Expr("mul", (_as_operand(other), self))

    # --- forcing surface ----------------------------------------------------
    def __eq__(self, other):
        return self.poly() == other

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None

    def __bool__(self):
        return bool(self.poly())

    def __call__(self, cm: int, i: int) -> int:
        return self.poly()(cm, i)

    def __iter__(self):
        return iter(self.poly())

    def __repr__(self):
        return f"Expr({self.op}, depth={self.depth})"

    def __str__(self):
        return str(self.poly())

    def __getattr__(self, name):
        # forward the Poly surface (ntt_pow_phi, mulmod, ...) — but never
        # dunders: protocol probes (copy/pickle/inspect) would otherwise
        # silently force evaluation
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return getattr(self.poly(), name)


# the JAX package's name for its first single-node expression type
MulExpr = Expr


def _as_operand(x):
    """Poly or Expr, unforced (for building lazy trees)."""
    if isinstance(x, (Poly, Expr)):
        return x
    raise TypeError(f"expected Poly, got {type(x)!r}")


def _as_poly(x) -> Poly:
    if isinstance(x, Poly):
        return x
    if isinstance(x, Expr):
        return x.poly()
    raise TypeError(f"expected Poly, got {type(x)!r}")


def shoup(expr, prec) -> Expr:
    """nfl::shoup(a * b, bprec) -> fused mulmod_shoup (ops.hpp:267-277).

    Only the product pattern is defined (shoup on anything else is a static
    error in the reference, ops.hpp:153-163)."""
    if isinstance(expr, Expr) and expr.op == "mul":
        return Expr("shoup", expr.args + (_as_operand(prec),))
    raise TypeError("shoup() expects a deferred product a * b")


def compute_shoup(x) -> Poly:
    return _as_poly(x).compute_shoup()


# free functions (reference poly.hpp:314-332 nfl::add/sub/mul): add and sub
# return the deferred expression, mul the product
def add(a, b) -> Expr:
    return _as_poly(a) + b


def sub(a, b) -> Expr:
    return _as_poly(a) - b


def mul(a, b) -> Poly:
    return _as_poly(a).mulmod(b)
