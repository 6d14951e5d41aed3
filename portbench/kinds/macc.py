"""NTT-domain multiply-accumulate: a sum of products, then one inverse."""
from __future__ import annotations

import torch

from ..traffic import ROWS, Kind


class Macc(Kind):
    """Request r: over a batch, the sum of `terms` NTT-domain products
    a_i * b_i, one term at a time from term r mod terms as acc = (acc +
    a_i * b_i).poly() (one muladd each), then one invntt_pow_invphi.  The
    operands are made in the coefficient domain and transformed by the
    port in set-up.  Checked: every residue of the sampled sums against the
    reference's sum of negacyclic products of the coefficient operands."""

    units = ("batch", "terms")

    @property
    def terms(self) -> int:
        return int(self.mix["terms"])

    def inputs(self):
        """Term by term: (a_i, b_i) [batch, m, n] for i < terms."""
        g = self.generator("macc")
        for _ in range(self.terms):
            yield self.uniform(g, (self.batch,)), self.uniform(g, (self.batch,))

    def setup(self):
        self.fa, self.fb = [], []
        for a, b in self.inputs():
            self.fa.append(self.poly(a).ntt_pow_phi())
            self.fb.append(self.poly(b).ntt_pow_phi())
        self.zero = self.poly(torch.zeros((self.batch,) + self.ring.shape,
                                          dtype=self.ring.torch_dtype,
                                          device=self.device))

    def request(self, r, span):
        nb, k = self.operand_bytes, self.terms
        acc = self.zero
        for t in range(k):
            i = (r + t) % k
            with span("e1", 4 * nb):
                acc = (acc + self.fa[i] * self.fb[i]).poly()
        with span("ntt", 2 * nb):
            out = acc.invntt_pow_invphi()
        return 0, out.data

    def _sum(self, ntt):
        """The reference's sum over the terms, [batch, m, n] int64."""
        mod, acc = ntt.mod, None
        for a, b in self.inputs():
            t = torch.cat([mod.mul(ntt.forward(a[s:s + ROWS].to(torch.int64)),
                                   ntt.forward(b[s:s + ROWS].to(torch.int64)))
                           for s in range(0, self.batch, ROWS)])
            acc = t if acc is None else mod.add(acc, t)
        return torch.cat([ntt.inverse(acc[s:s + ROWS])
                          for s in range(0, self.batch, ROWS)])

    def control_request(self, r):
        return 0, self._sum(self.ref(low=True)).to(self.ring.torch_dtype)

    def release(self):
        self.fa = self.fb = self.zero = None

    def check(self, kept: dict) -> dict:
        want = self._sum(self.ref())
        return {"residues_wrong": sum(self.wrong(out, want)
                                      for _, out in kept.values())}


KIND = Macc
