"""Process-group and mesh conveniences for distributed polynomial pipelines.

PyTorch port of nfllib_tpu/parallel/api.py.  The framework's three parallel
axes:
  * "batch": data parallelism over leading batch dims of Poly tensors;
  * "rns":   parallelism over RNS residue channels (the reference's
             independent `cm` loops, core.hpp:597,610);
  * "deg":   the degree, through the four-step NTT (ntt_dist.py), whose
             only communication is one transpose.
batch and rns need no communication: every op in ops/modops.py and the NTT
kernels is elementwise or within one channel, so each rank runs them on its
own block.  Where the JAX package places a global array with a
NamedSharding, a rank here holds its local block, cut out by its mesh
coordinates (`shard_poly`): a Poly whose tensor is contiguous (the kernels
take nothing else) and whose ring is the channel block of its rns slice
(ring.py:Ring.channel_block), whose tables are the whole ring's rows of
those channels.  `gather_poly` all-gathers the blocks into the whole Poly
on every rank.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..poly import Poly
from ..ring import Ring


def init_distributed(init_method=None, world_size=None, rank=None, *,
                     backend=None, **kw):
    """Initialise the default process group; returns (rank, world size).

    Arguments default to torchrun's environment: init_method "env://"
    (MASTER_ADDR / MASTER_PORT), WORLD_SIZE and RANK.  backend defaults to
    nccl when CUDA is available, else gloo.  Other keywords (timeout, ...)
    go to torch.distributed.init_process_group."""
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kw)
    return dist.get_rank(), dist.get_world_size()


def mesh_shape(ndev: int, naxes: int = 3) -> tuple:
    """Factor `ndev` over `naxes` mesh axes: powers of two round-robin from
    the first axis, an odd remainder on the first (the JAX package's
    make_mesh rule)."""
    sizes = [1] * naxes
    i = 0
    while ndev % 2 == 0 and ndev > 1:
        sizes[i % naxes] *= 2
        ndev //= 2
        i += 1
    sizes[0] *= ndev
    return tuple(sizes)


def make_mesh(shape=None, axis_names=("batch", "rns", "deg"),
              device_type=None):
    """A DeviceMesh over the default group's ranks
    (torch.distributed.device_mesh.init_device_mesh).  shape=None factors
    the world size with `mesh_shape`; device_type defaults to cuda when
    CUDA is available, else cpu."""
    from torch.distributed.device_mesh import init_device_mesh

    if shape is None:
        shape = mesh_shape(dist.get_world_size(), len(axis_names))
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def poly_sharding(mesh, batch_axes=("batch",), rns_axis="rns",
                  batch_ndim=1) -> tuple:
    """The mesh axis (or None) of each dim of a [batch..., m, n] Poly
    tensor: batch dims over the batch axes, channels over `rns`,
    coefficients whole (the JAX package's PartitionSpec, as a tuple)."""
    spec = list(batch_axes[:batch_ndim])
    spec += [None] * (batch_ndim - len(spec))
    spec += [rns_axis, None]
    return tuple(spec)


def block_slices(shape, mesh, spec) -> tuple:
    """The slice of each dim of a tensor of `shape` that this rank holds
    under `spec` (one mesh axis name or None a dim), by its mesh
    coordinates; every sharded dim must split evenly."""
    names = list(mesh.mesh_dim_names)
    out = []
    for dim, name in enumerate(spec):
        if name is None:
            out.append(slice(None))
            continue
        size = mesh.size(names.index(name))
        if shape[dim] % size:
            raise ValueError(f"dim {dim} of length {shape[dim]} does not "
                             f"split over {size} ranks of {name!r}")
        blk = shape[dim] // size
        start = mesh.get_local_rank(name) * blk
        out.append(slice(start, start + blk))
    return tuple(out)


def shard_poly(p: Poly, mesh, **kw) -> Poly:
    """This rank's block of p under poly_sharding: a Poly whose data is the
    contiguous [batch/b..., m/r, n] block (block_slices) on p's device and
    whose ring is p.ring.channel_block of the rank's rns slice, so every
    op, tree, transform and LWE graph runs on it with the block's tables
    (the JAX package's shard_poly returns a Poly too)."""
    spec = poly_sharding(mesh, batch_ndim=len(p.batch_shape), **kw)
    sl = block_slices(tuple(p.data.shape), mesh, spec)
    chans = sl[-2]
    ring = p.ring if chans == slice(None) else p.ring.channel_block(
        chans.start, chans.stop)
    return Poly(p.data[sl].contiguous(), ring)


def gather_poly(block: Poly, mesh, **kw) -> Poly:
    """The whole Poly of which `block` is this rank's shard_poly block (the
    same keywords), on every rank: the blocks all-gathered over the mesh
    groups of the sharded dims (mesh.get_group(name)), in the order of
    their coordinates; the counterpart of reading a global array.  Its
    ring is the whole ring of the block's channel slice."""
    spec = poly_sharding(mesh, batch_ndim=len(block.batch_shape), **kw)
    names = list(mesh.mesh_dim_names)
    data, ring = block.data, block.ring
    for dim, name in enumerate(spec):
        if name is None or mesh.size(names.index(name)) == 1:
            continue
        group = mesh.get_group(name)
        size, me = mesh.size(names.index(name)), mesh.get_local_rank(name)
        if dist.get_rank(group) != me:
            raise RuntimeError(f"rank {dist.get_rank(group)} of group "
                               f"{name!r} is not its mesh coordinate {me}")
        # gathered as bytes: every backend gathers uint8
        raw = data.contiguous().view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(size)]
        dist.all_gather(parts, raw, group=group)
        data = torch.cat([t.view(data.dtype) for t in parts], dim=dim)
        if dim == len(spec) - 2:
            ring = Ring(ring.limb, ring.degree, ring.nmoduli * size,
                        ring.first - me * ring.nmoduli)
    return Poly(data, ring)
