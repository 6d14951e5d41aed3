"""The LWE demo's encryptions of zero with device noise, and their
decryptions: a batch a request."""
from __future__ import annotations

import hashlib

import torch

from .. import reference
from ..bounds import tensor_bytes
from ..traffic import ROWS, Kind, seed_bytes


class Lwe(Kind):
    """Request r: a batch of the LWE demo's encryptions of zero with device
    noise, and their decryptions.  Message k's noise u, e1, e2 are the
    fixed-consumption Gaussians at nonces r * 3 * batch + 3k + (0, 1, 2)
    (amplifiers 1, 2, 2, as encrypt_on_device orders them), drawn by
    device_sampling.device_gaussians as many at a time as one launch of
    the port's S3 takes (GaussianFixedKernel.MAX_SAMPLERS) and joined into
    [batch, m, n] tensors (harness work, span `noise_cat`); then
    apps.lwe._encrypt_graph on the batch and apps.lwe.decrypt.  The keys
    follow apps.lwe.keygen's arithmetic on inputs made here from the seed
    (s and the public noise small integers, pka uniform).  Checked: the
    noise, both ciphertext halves and the decrypted bits of the sampled
    requests against the reference's, which draws its own noise from the
    Salsa20 keystream and the barrier table it works out itself."""

    def __init__(self, *args):
        super().__init__(*args)
        from nfllib_tpu_torch._kernels import GaussianFixedKernel
        self.key = hashlib.sha256(b"portbench-lwe" +
                                  seed_bytes(self.seed)).digest()
        g = self.mix["gaussian"]
        self.gauss_args = (float(g["sigma"]), int(g["security"]),
                           int(g["samples"]))
        f = GaussianFixedKernel.MAX_SAMPLERS
        if self.batch % f:
            raise ValueError(f"the batch must be a multiple of {f}, the "
                             f"draws of one S3 launch")
        # plan[part]: the calls' offsets from the request's first nonce
        self.plan = [[[3 * (c * f + k) + part for k in range(f)]
                      for c in range(self.batch // f)] for part in range(3)]

    def inputs(self):
        """s and the public key's noise as small integers [n] (rounded
        normal, sigma as the mix's, clamped to 6 sigma), pka uniform."""
        g = self.generator("lwe")
        n, sigma = self.ring.degree, self.gauss_args[0]

        def small():
            v = torch.randn((n,), generator=g, device=self.device) * sigma
            return v.round().clamp(-6 * sigma, 6 * sigma).to(torch.int64)

        s, e = small(), small()
        return s, 2 * e, self.uniform(g, ())

    def encode(self, v):
        """Small integers [..., n] as residues [..., m, n] (p + v below 0),
        int64."""
        p = torch.tensor(self.cfg["primes"], dtype=torch.int64,
                         device=self.device).reshape(-1, 1)
        v = v[..., None, :]
        return torch.where(v < 0, v + p, v).expand(
            v.shape[:-2] + self.ring.shape)

    def setup(self):
        from nfllib_tpu_torch.apps import lwe
        from nfllib_tpu_torch.prng import device_sampling
        port, dt = self.port, self.ring.torch_dtype
        self.lwe, self.sampling = lwe, device_sampling
        fg = lwe.make_gaussian_prng(self.gauss_args[1], self.gauss_args[2],
                                    self.gauss_args[0])
        self.tables = device_sampling.gaussian_tables(fg, self.device)
        modes = (port.gaussian(fg), port.gaussian(fg, 2), port.gaussian(fg, 2))
        self.draws = [[tuple((off, modes[part]) for off in call)
                       for call in calls]
                      for part, calls in enumerate(self.plan)]
        s_v, e_v, pka = self.inputs()
        s = self.poly(self.encode(s_v).to(dt)).ntt_pow_phi()
        sprime = port.compute_shoup(s)
        pka = self.poly(pka)
        pkb = (self.poly(self.encode(e_v).to(dt)).ntt_pow_phi()
               + port.shoup(pka * s, sprime)).poly()
        self.keys = lwe.LweKeys(s=s, sprime=sprime, pka=pka, pkb=pkb)
        self.ctx = self.ring.context()

    def request(self, r, span):
        base = r * 3 * self.batch
        nb = self.operand_bytes
        key_bytes = tensor_bytes(self.keys.pka.data)
        with span("sampler"):
            noise = [[self.sampling.device_gaussians(
                self.ring, self.key, base, draws, self.device, self.tables)
                for draws in calls] for calls in self.draws]
        with span("noise_cat"):
            u, e1, e2 = (torch.cat(calls) for calls in noise)
        del noise
        with span("lwe_graph", 5 * nb + 2 * key_bytes):
            resa, resb = self.lwe._encrypt_graph(
                self.ctx, self.keys.pka.data, self.keys.pkb.data, u, e1, e2)
        with span("lwe_graph", 3 * nb + 2 * key_bytes):
            bits = self.lwe.decrypt(self.keys, self.ring, self.poly(resa),
                                    self.poly(resb))
        return r, u, e1, e2, resa, resb, bits

    def _reference(self, r, s, ntt, keys, gauss):
        """Noise, ciphertexts and bits of messages s .. s + ROWS of request
        r, by the reference (`ntt` and `gauss` may be the control's)."""
        mod, k = ntt.mod, torch.arange(s, min(s + ROWS, self.batch),
                                       device=self.device)
        nonces = r * 3 * self.batch + 3 * k
        noise = [self.encode(gauss.draw(
            self.key, nonces + part, torch.full_like(k, 1 if part == 0 else 2),
            self.ring.degree)) for part in range(3)]
        s_ref, pka, pkb = keys
        fu = ntt.forward(noise[0])
        resa = mod.add(ntt.forward(noise[1]), mod.mul(fu, pka))
        resb = mod.add(ntt.forward(noise[2]), mod.mul(fu, pkb))
        t = ntt.inverse(mod.sub(resb, mod.mul(resa, s_ref)))
        bit = t & 1
        bits = torch.where(t < self.cfg["primes"][0] // 2, bit, 1 - bit)
        return noise + [resa, resb, bits]

    def _keys(self, ntt):
        s_v, e_v, pka = self.inputs()
        s_ref = ntt.forward(self.encode(s_v))
        pka = pka.to(torch.int64)
        return s_ref, pka, ntt.mod.add(ntt.forward(self.encode(e_v)),
                                       ntt.mod.mul(pka, s_ref))

    def control_request(self, r):
        """The control: float64 products, and the Gaussian at half the
        security, whose samples read fewer keystream words."""
        low = self.ref(low=True)
        keys = self._keys(low)
        sigma, security, samples = self.gauss_args
        gauss = reference.Gaussian(sigma, security // 2, samples)
        parts = zip(*[self._reference(r, s, low, keys, gauss)
                      for s in range(0, self.batch, ROWS)])
        return (r,) + tuple(torch.cat(p).to(self.ring.torch_dtype)
                            for p in parts)

    def release(self):
        self.keys = self.tables = self.draws = None

    def check(self, kept: dict) -> dict:
        ref = self.ref()
        keys = self._keys(ref)
        gauss = reference.Gaussian(*self.gauss_args)
        wrong = {"noise_wrong": 0, "cipher_wrong": 0, "bits_wrong": 0}
        names = ("noise_wrong",) * 3 + ("cipher_wrong",) * 2 + ("bits_wrong",)
        for r, *outs in kept.values():
            for s in range(0, self.batch, ROWS):
                want = self._reference(r, s, ref, keys, gauss)
                for name, o, w in zip(names, outs, want):
                    wrong[name] += self.wrong(o[s:s + ROWS], w)
        return wrong


KIND = Lwe
