"""The port's whole-system entry points: the counterpart of the root
__graft_entry__.py (which stays the JAX package's).

`entry(device)` returns the flagship forward step, the LWE encryption of a
batch of zeros and its decryption (the reference demo's end-to-end
workload, tests/nfllib_demo_main_op.cpp:26-58), and its arguments on
`device`.

`dryrun_multichip(...)` runs one step over the framework's parallel axes
inside an initialised torch.distributed process group of n ranks, the
mesh ("batch", "rns", "deg") factored from n by api.mesh_shape:
  * part 1, "batch" x "rns": keys and noise are drawn on the whole ring
    (every rank the same draw, from a fixed key), each rank takes its
    (batch, rns) block with api.shard_poly and runs the encrypt and
    decrypt graphs on it, with no communication.  The gate: every
    decrypted bit of an encryption of zero is 0, and the blocks'
    ciphertexts and bits, all-gathered (api.gather_poly), equal the whole
    ring's run.
  * part 2, "deg": the degree-sharded u64 four-step NTT (ntt_dist.py) over
    the mesh's deg group: the round trip is exact, every rank's block has
    the same shape, one exchange a transform (two with chunks=2, counted
    from ntt_dist.exchanges), and the ppermute transpose's output is
    bit-identical to the all-to-all's.
The kernel mode is the caller's (NFL_TORCH_NTT); the sizes are arguments,
so that the CPU tests run it small on gloo.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..apps import lwe
from ..poly import Poly
from ..prng.salsa20 import Salsa20Stream
from ..prng.sampling import gaussian
from ..ring import DEFAULT_DEVICE, Ring, ring_from_modulus
from ..utils import static_log2
from . import api, ntt_dist

# n = 4096, two 30-bit moduli: the smallest end-to-end configuration
FLAGSHIP = ("u32", 4096, 60)         # limb, degree, modulus bits
BIG = ("u64", 1 << 18, 2)            # limb, degree, moduli: part 2's ring
INPUTS = ("pka", "pkb", "s", "sprime", "u", "e1", "e2")


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _graphs(ctx, pka, pkb, s, sprime, u, e1, e2):
    """encrypt + decrypt of the noise batch: (resa, resb, bits)"""
    resa, resb = lwe._encrypt_graph(ctx, pka, pkb, u, e1, e2)
    return resa, resb, lwe._decrypt_graph(ctx, resa, resb, s, sprime)


def entry(device=DEFAULT_DEVICE):
    """(forward, args): forward(*args) encrypts a zero on the flagship
    ring and decrypts it, returning the bit tensor."""
    ring = ring_from_modulus(*FLAGSHIP)
    ctx = ring.context()
    stream = Salsa20Stream(b"\x07" * 32)
    g = lwe.make_gaussian_prng()
    keys = lwe.keygen(ring, stream, g, device)
    noise = [Poly.sample(ring, gaussian(g, amp), stream, device).data
             for amp in (1, 2, 2)]

    def forward(pka, pkb, s, sprime, u, e1, e2):
        """encrypt + decrypt one batch of zeros; returns the bit tensor"""
        return _graphs(ctx, pka, pkb, s, sprime, u, e1, e2)[2]

    return forward, (keys.pka.data, keys.pkb.data, keys.s.data,
                     keys.sprime.data, *noise)


def _lwe_part(mesh, shape, lwe_ring, device) -> dict:
    b_sz, r_sz, _ = shape
    ring = ring_from_modulus(*lwe_ring)
    if ring.nmoduli % r_sz:
        ring = Ring(ring.limb, ring.degree,
                    max(r_sz, ring.nmoduli) // r_sz * r_sz)
    stream = Salsa20Stream(b"\x09" * 32)
    g = lwe.make_gaussian_prng(samples=ring.degree)
    keys = lwe.keygen(ring, stream, g, device)

    def noise_batch(mode):
        return Poly(torch.stack([Poly.sample(ring, mode, stream, device).data
                                 for _ in range(2 * b_sz)]), ring)

    whole = (keys.pka, keys.pkb, keys.s, keys.sprime,
             noise_batch(gaussian(g)), noise_batch(gaussian(g, 2)),
             noise_batch(gaussian(g, 2)))
    blocks = [api.shard_poly(p, mesh) for p in whole]
    block_ring = blocks[0].ring
    _check(all(b.ring == block_ring for b in blocks),
           "keys and noise blocks on different channel blocks")
    got = _graphs(block_ring.context(), *(b.data for b in blocks))
    bad = torch.tensor([int(bool(got[2].any()))], device=device)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX)
    _check(not bool(bad.item()), "zero-encryption gate failed")
    gathered = [api.gather_poly(Poly(t, block_ring), mesh) for t in got]
    want = _graphs(ring.context(), *(p.data for p in whole))
    for name, g_, w in zip(("resa", "resb", "bits"), gathered, want):
        _check(g_.ring == ring and torch.equal(g_.data, w),
               f"gathered {name} differs from the whole ring's run")
    return {"ring": ring, "block_ring": block_ring,
            "inputs": dict(zip(INPUTS, whole)),
            **dict(zip(("resa", "resb", "bits"), gathered))}


def _deg_part(mesh, big, device) -> dict:
    ring = Ring(*big)
    rng = np.random.default_rng(0)
    x = np.empty(ring.shape, dtype=ring.dtype)
    for cm in range(ring.nmoduli):
        x[cm] = rng.integers(0, int(ring.moduli[cm]), size=ring.degree)
    group = mesh.get_group("deg")
    d, r = dist.get_world_size(group), dist.get_rank(group)
    n1 = 1 << (static_log2(ring.degree) // 2)
    n2 = ring.degree // n1
    xb = Poly.from_numpy(ring, x, device).data.reshape(
        ring.nmoduli, n1, n2)[..., r * n2 // d:(r + 1) * n2 // d].contiguous()
    counts = {}

    def counted(tag, fn, **kw):
        ntt_dist.exchanges.clear()
        out = fn(kw.pop("v", xb), ring, group, **kw)
        counts[tag] = dict(ntt_dist.exchanges)
        return out

    fwd, inv = (ntt_dist.distributed_ntt_pow_phi,
                ntt_dist.distributed_invntt_pow_invphi)
    y = counted("fwd", fwd)
    y2 = counted("fwd_chunks", fwd, chunks=2)
    ypp = counted("fwd_ppermute", fwd, transpose="ppermute")
    back = counted("inv_chunks", inv, v=y, chunks=2)
    want = {"fwd": {"all_to_all": 1}, "fwd_chunks": {"all_to_all": 2},
            "fwd_ppermute": {"p2p": d - 1} if d > 1 else {},
            "inv_chunks": {"all_to_all": 2}}
    _check(counts == want, f"exchanges {counts}, expected {want}")
    _check(torch.equal(y2, y), "chunks=2 forward differs from the a2a one")
    _check(torch.equal(ypp, y), "ppermute forward differs from the a2a one")
    _check(torch.equal(back, xb), "deg-sharded round trip is not exact")
    shapes = [torch.empty(3, dtype=torch.int64, device=device)
              for _ in range(dist.get_world_size())]
    dist.all_gather(shapes, torch.tensor(y.shape, device=device))
    _check(all(torch.equal(s, shapes[0]) for s in shapes),
           f"unbalanced blocks: {[tuple(s.tolist()) for s in shapes]}")
    return {"big_ring": ring, "exchanges": counts, "block": tuple(y.shape)}


def dryrun_multichip(lwe_ring=FLAGSHIP, big=BIG, device=DEFAULT_DEVICE,
                     shape=None) -> dict:
    """Both parts (module docstring) on this rank, inside an initialised
    process group (api.init_distributed); raises RuntimeError on a failed
    gate.  lwe_ring: (limb, degree, modulus bits) of part 1, its channel
    count raised to a multiple of the rns axis where it is not one; big:
    the Ring fields of part 2; shape: the (batch, rns, deg) mesh, by
    default api.mesh_shape of the world size.  Returns what it checked:
    the mesh shape, part 1's rings, whole-ring inputs, gathered ciphertexts
    and bits, and part 2's exchange counts and block shape."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is "
                           "initialised (parallel.api.init_distributed)")
    device = torch.device(device)
    if shape is None:
        shape = api.mesh_shape(dist.get_world_size())
    mesh = api.make_mesh(shape, device_type=device.type)
    return {"mesh": tuple(shape), **_lwe_part(mesh, shape, lwe_ring, device),
            **_deg_part(mesh, big, device)}
