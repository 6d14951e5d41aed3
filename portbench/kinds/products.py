"""Ring products: a batch of negacyclic products a request."""
from __future__ import annotations

import torch

from ..traffic import ROWS, Kind


class Products(Kind):
    """Request r: the negacyclic products of pair r mod pool, a batch of
    polynomial pairs, as (a.ntt_pow_phi() * b.ntt_pow_phi()).poly()
    .invntt_pow_invphi().  Checked: every residue of the sampled products
    against the reference's product."""

    def inputs(self):
        pool = int(self.mix["pool"])
        g = self.generator("products")
        return (self.uniform(g, (pool, self.batch)),
                self.uniform(g, (pool, self.batch)))

    def setup(self):
        self.a, self.b = self.inputs()

    control_setup = setup

    def request(self, r, span):
        j = r % self.a.shape[0]
        nb = self.operand_bytes
        with span("ntt", 2 * nb):
            fa = self.poly(self.a[j]).ntt_pow_phi()
        with span("ntt", 2 * nb):
            fb = self.poly(self.b[j]).ntt_pow_phi()
        with span("e1", 3 * nb):
            c = (fa * fb).poly()
        with span("ntt", 2 * nb):
            out = c.invntt_pow_invphi()
        return j, out.data

    def control_request(self, r):
        j = r % self.a.shape[0]
        low = self.ref(low=True)
        out = torch.cat([low.product(self.a[j, s:s + ROWS].to(torch.int64),
                                     self.b[j, s:s + ROWS].to(torch.int64))
                         for s in range(0, self.batch, ROWS)])
        return j, out.to(self.ring.torch_dtype)

    def check(self, kept: dict) -> dict:
        ref, wrong = self.ref(), 0
        for j in sorted({j for j, _ in kept.values()}):
            outs = [out for jj, out in kept.values() if jj == j]
            for s in range(0, self.batch, ROWS):
                want = ref.product(self.a[j, s:s + ROWS].to(torch.int64),
                                   self.b[j, s:s + ROWS].to(torch.int64))
                wrong += sum(self.wrong(o[s:s + ROWS], want) for o in outs)
        return {"residues_wrong": wrong}


KIND = Products
