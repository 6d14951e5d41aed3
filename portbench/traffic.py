"""The one general generator: what every kind of request shares, and the
kinds found by name.

A mix file (mixes/<traffic>.json) is data: it names a kind and gives its
parameters.  The kind's code is kinds/<kind>.py, whose `KIND` is a
subclass of `Kind`; the harness imports it by the name the mix gives, so a
later mix of a kind that is here adds a data file only, and a new kind adds
a file of its own.  A kind makes its inputs on the device from the seed,
drives the port through its public entry points one request at a time,
and checks what sampled requests produced against the plain reference
(reference.py), which works every table and key out again from the
benchmark's own inputs.

Every kind is a closed loop with one client: a request enqueues a whole
batch; the caller synchronises.  The batch is the configuration's number
of polynomials that fills `operand_mib` MiB per operand tensor.

Each kind also runs its control (`control_request`): the reference put in
the program's place with its modular products taken in float64, the
precision below the exact integer arithmetic the configuration states.
"""
from __future__ import annotations

import hashlib
import importlib

import torch

from . import reference

ROWS = 32          # reference block: polynomials of a batch at a time


def load_kind(name: str) -> type:
    """The class `KIND` of kinds/<name>.py."""
    if not name.isidentifier():
        raise ValueError(f"no kind {name!r}")
    return importlib.import_module(f"{__package__}.kinds.{name}").KIND


class LowModuli(reference.Moduli):
    """The control's arithmetic: products of residues rounded to float64."""

    def mul(self, a, b):
        return torch.remainder(a.double() * b.double(),
                               self.p.double()).to(torch.int64)

    def mul_const(self, x, w, ws):
        return self.mul(x, w)


def _low_ntt(ntt: reference.NegacyclicNtt) -> reference.NegacyclicNtt:
    """A copy of `ntt` whose stage and pointwise products are float64's."""
    low = object.__new__(reference.NegacyclicNtt)
    low.__dict__.update(ntt.__dict__)
    for attr in ("mod", "stage_mod"):
        m = object.__new__(LowModuli)
        m.__dict__.update(getattr(ntt, attr).__dict__)
        setattr(low, attr, m)
    return low


def seed_bytes(seed: int) -> bytes:
    return int(seed).to_bytes(16, "little", signed=True)


class Kind:
    """What every kind shares: the ring, the batch, the seeded generator,
    the reference transform and the comparison.

    A kind defines `setup()` (the port's set-up of the mix, counted in
    setup_s), `request(r, span)` (request r through the port, each call
    into a layer inside `span(name, nbytes)`; returns what the check
    reads), `release()` (drops the program's state before the check),
    `check(kept)` ({compared number: value} over {r: request(r)'s return}),
    and `control_request(r)` (request r's return computed by the control),
    with `control_setup()` where the control needs inputs first."""

    units = ("batch",)      # work units a request completes: product of

    def __init__(self, port, cfg: dict, mix: dict, seed: int, device):
        self.port, self.cfg, self.mix = port, cfg, mix
        self.seed, self.device = int(seed), torch.device(device)
        ring = port.ring_from_modulus(cfg["limb"], cfg["degree"],
                                      cfg["modulus_bits"])
        if [int(p) for p in ring.moduli] != cfg["primes"]:
            raise ValueError(f"{cfg['name']}: the port's primes differ from "
                             f"the configuration's")
        self.ring = ring
        m, n = ring.shape
        item = torch.empty((), dtype=ring.torch_dtype).element_size()
        poly_bytes = m * n * item
        total = round(float(mix["operand_mib"]) * (1 << 20))
        if total % poly_bytes:
            raise ValueError(f"{mix['operand_mib']} MiB is no whole number "
                             f"of {cfg['name']} polynomials")
        self.batch = total // poly_bytes
        self.operand_bytes = total
        self._ref = None

    # -- inputs --------------------------------------------------------------
    def generator(self, stream: str) -> torch.Generator:
        h = hashlib.sha256(seed_bytes(self.seed) + stream.encode()).digest()
        return torch.Generator(device=self.device).manual_seed(
            int.from_bytes(h[:8], "little") >> 1)

    def uniform(self, gen, lead) -> torch.Tensor:
        """Residues uniform below each prime, [*lead, m, n], storage dtype."""
        m, n = self.ring.shape
        p = torch.tensor(self.cfg["primes"], dtype=torch.int64,
                         device=self.device).reshape(m, 1)
        x = torch.randint(0, 1 << 62, tuple(lead) + (m, n), generator=gen,
                          device=self.device, dtype=torch.int64)
        return torch.remainder(x, p).to(self.ring.torch_dtype)

    def poly(self, data):
        return self.port.Poly(data, self.ring)

    @property
    def units_per_request(self) -> int:
        out = 1
        for name in self.units:
            out *= getattr(self, name)
        return out

    # -- the reference ---------------------------------------------------------
    def ref(self, low: bool = False) -> reference.NegacyclicNtt:
        if self._ref is None:
            c = self.cfg
            self._ref = reference.NegacyclicNtt(
                c["primes"], c["primitive_roots"], c["max_poly_degree"],
                c["degree"], self.device)
        return _low_ntt(self._ref) if low else self._ref

    def control_setup(self):
        """What the control needs before its requests (the inputs it reads
        again itself need nothing)."""

    def release(self):
        """Drops the program's state before the check."""

    @staticmethod
    def wrong(out: torch.Tensor, want: torch.Tensor) -> int:
        """Residues of `out` (storage dtype) that differ from `want`."""
        return int((out.to(torch.int64) != want).sum())
