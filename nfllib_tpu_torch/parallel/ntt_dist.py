"""Distributed four-step negacyclic NTT over torch.distributed ranks.

PyTorch port of nfllib_tpu/parallel/ntt_dist.py.  The JAX package runs the
transform as one shard_map program over a device Mesh; here each rank is a
process (one device each) in a torch.distributed process group, and every
entry point takes and returns the rank's LOCAL block (there is no global
array):

  n = n1 * n2, data viewed as X[i1, i2] (i = i2 + n2*i1), the ranks of a
  group of size d holding column blocks i2 in [r n2/d, (r+1) n2/d):
    1. pre-twist by phi^i                        (local, elementwise)
    2. size-n1 DFTs down each column, root w^n2  (local: column block)
    3. twiddle by w^(k1*i2)                      (local, elementwise)
    4. transpose                                 (the only communication)
    5. size-n2 DFTs along each row, root w^n1    (local: row block)
  out[k1, k2] = E[k1 + n1*k2] where E[k] = A(phi^(2k+1)) in natural order.

Local layouts: the forward input is the rank's column block
[..., m, n1, n2/d] of the [..., m, n1, n2] view, its output the row block
[..., m, n1/d, n2] (rows k1 in [r n1/d, (r+1) n1/d)); the inverse takes a
row block and returns the column block.  The single-chip Harvey ordering is
harvey[j] = E[bitrev_n(j)]; pointwise products and the inverse consume the
four-step layout directly, so a pipeline never reorders globally.

The transpose (step 4, with the twiddle of step 3):
  * "a2a": one all_to_all_single on a buffer laid out by destination,
    bit-identical to jax.lax.all_to_all(tiled=True): block j of the split
    axis goes to rank j, and the block received from rank j lands at slot
    j of the concat axis;
  * "ppermute": d-1 hops of batch_isend_irecv; hop s twiddles the block
    for rank (me+s) mod d, sends it there and receives from (me-s) mod d;
  * chunks > 1 (a2a): `chunks` all-to-alls issued with async_op=True, the
    twiddle of chunk c+1 computed while chunk c is in flight.
"auto" is a2a on every device (JAX's ppermute-on-TPU rule works around
XLA keeping all-to-all synchronous on a TPU).

Local sub-DFTs (`_resolved_backends`, read at call time): under
NFL_TORCH_NTT=auto or fused, sizes that ops/dft_mxu.py supports go to its
mod-matmul (the CUDA kernels K9/K5 for a CUDA tensor, their twins for a
CPU tensor), with the phi twist and n^-1 untwist folded into the column
matrices and the twiddles when both stages are served; plain and butterfly
take the Harvey stage loop (ops/ntt.py:_stages).  The elementwise twiddle
rides the mod-matmul next to it as its Shoup epilogue (matmul_mod(twiddle=):
the forward column DFT's, the inverse row DFT's), bit-identical to the JAX
package's separate multiply; beside the stage loop it is one mulmod_shoup
program (`_twiddle_mul`, ops/expr_program.py: E1 on the card), as the
JAX package's jitted modops.mulmod_shoup.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from ..ring import (Ring, _harvey_blocked, _np_mulmod_vec, _np_shoup_vec,
                    _powers_mod, _shoup_arr, canonical_device)
from ..utils import bitrev_indices, static_log2
from ..ops import dft_mxu, expr_program, modops
from ..ops.ntt import _stages, kernel_mode


def _colmat_twisted(ring, size, inverse=False):
    """Column-stage DFT matrices with the phi (pre-)twist FOLDED IN, so the
    mod-matmul path skips the separate elementwise twist pass:
      fwd: W'[r, j]  = wc^(r*j)  * phi^(n2*j)   (column scale: the
           pre-twist's phi^(n2*i1) part rides the contraction index)
      inv: W'[i, k]  = wc^(-i*k) * phi^(-n2*i)  (row scale: the untwist's
           phi^(-n2*i1) part rides the output index)
    with wc = omega^(n/size), n2 = n/size.  The remaining phi^(+-i2) (and
    n^-1 on the inverse) fold into the twiddle tables
    (FourStepContext.twiddle_tw / itwiddle_tw)."""
    ctx = ring.context()
    n, m = ring.degree, ring.nmoduli
    n2 = n // size
    base = dft_mxu._dft_matrix(ring, size, inverse)
    mats = np.empty((m, size, size), dtype=np.uint64)
    for cm in range(m):
        p = int(ring.moduli[cm])
        phi_n2 = pow(ctx.phi_int[cm], n2, p)
        if inverse:
            phi_n2 = pow(phi_n2, -1, p)
        scale = np.array([pow(phi_n2, j, p) for j in range(size)],
                         dtype=np.uint64)
        if inverse:
            mats[cm] = _np_mulmod_vec(base[cm], scale[:, None], p)
        else:
            mats[cm] = _np_mulmod_vec(base[cm], scale[None, :], p)
    return mats


def _ensure_twisted_providers():
    if "fourstep_col_fwd_tw" not in dft_mxu._MATRIX_PROVIDERS:
        dft_mxu.register_matrix_provider(
            "fourstep_col_fwd_tw", functools.partial(_colmat_twisted,
                                                     inverse=False))
        dft_mxu.register_matrix_provider(
            "fourstep_col_inv_tw", functools.partial(_colmat_twisted,
                                                     inverse=True))


_ensure_twisted_providers()


# ---------------------------------------------------------------------------
# table construction (host, numpy, byte-equal to the JAX package's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FourStepPlan:
    ring: Ring
    n1: int
    n2: int


def _sub_tables(p: int, w_root: int, size: int, wbits: int, obj: bool):
    """Blocked Harvey twiddles (+shoup) for a size-`size` DFT with root w."""
    pows = _powers_mod(w_root, size, p, obj=obj)
    blocked = _harvey_blocked(pows, size)
    return blocked, _shoup_arr(blocked, p, wbits, obj)


class FourStepContext:
    """Per-(ring, n1, n2) constants for the four-step transform."""

    def __init__(self, plan: FourStepPlan):
        ring = plan.ring
        self.plan = plan
        n1, n2 = plan.n1, plan.n2
        n, m = ring.degree, ring.nmoduli
        assert n1 * n2 == n
        dt = ring.dtype
        wbits = ring.repr_bits
        obj = ring.limb == "u64"
        ctx = ring.context()

        self.p_col = ctx.p_col
        shape1 = (m, max(n1 - 1, 1))
        shape2 = (m, max(n2 - 1, 1))
        self.col_w = np.empty(shape1, dtype=dt)       # size-n1 tables
        self.col_ws = np.empty(shape1, dtype=dt)
        self.col_iw = np.empty(shape1, dtype=dt)
        self.col_iws = np.empty(shape1, dtype=dt)
        self.row_w = np.empty(shape2, dtype=dt)       # size-n2 tables
        self.row_ws = np.empty(shape2, dtype=dt)
        self.row_iw = np.empty(shape2, dtype=dt)
        self.row_iws = np.empty(shape2, dtype=dt)

        for cm in range(m):
            p = int(ring.moduli[cm])
            w = ctx.omega_int[cm]
            iw = pow(w, -1, p)
            w1, iw1 = pow(w, n2, p), pow(iw, n2, p)
            w2, iw2 = pow(w, n1, p), pow(iw, n1, p)
            self.col_w[cm], self.col_ws[cm] = [
                a.astype(dt) for a in _sub_tables(p, w1, n1, wbits, obj)]
            self.col_iw[cm], self.col_iws[cm] = [
                a.astype(dt) for a in _sub_tables(p, iw1, n1, wbits, obj)]
            self.row_w[cm], self.row_ws[cm] = [
                a.astype(dt) for a in _sub_tables(p, w2, n2, wbits, obj)]
            self.row_iw[cm], self.row_iws[cm] = [
                a.astype(dt) for a in _sub_tables(p, iw2, n2, wbits, obj)]

        # phi pre-twist and inverse un-twist reshaped to [m, n1, n2]
        self.phis = ctx.phis.reshape(m, n1, n2)
        self.shoupphis = ctx.shoupphis.reshape(m, n1, n2)
        self.ivp = ctx.invpoly_times_invphis.reshape(m, n1, n2)
        self.ivp_s = ctx.shoupinvpoly_times_invphis.reshape(m, n1, n2)

        self.rev1 = bitrev_indices(n1)
        self.rev2 = bitrev_indices(n2)

    # --- [m, n1, n2] elementwise twiddle tables, built lazily per family:
    # one pipeline direction and dispatch reads only one of the four
    # (value, shoup) families below

    @functools.cached_property
    def _t_it(self):
        """uint64 [m, n1, n2] w^(k1*i2) and w^(-k1*i2), built
        column-iteratively with vectorized exact modmuls."""
        ring = self.plan.ring
        n1, n2 = self.plan.n1, self.plan.n2
        m = ring.nmoduli
        obj = ring.limb == "u64"
        ctx = ring.context()
        t_all = np.empty((m, n1, n2), dtype=np.uint64)
        it_all = np.empty((m, n1, n2), dtype=np.uint64)
        for cm in range(m):
            p = int(ring.moduli[cm])
            w = ctx.omega_int[cm]
            iw = pow(w, -1, p)
            k1_u64 = np.asarray(_powers_mod(w, n1, p, obj=obj)
                                ).astype(np.uint64)
            ik1_u64 = np.asarray(_powers_mod(iw, n1, p, obj=obj)
                                 ).astype(np.uint64)
            t_all[cm, :, 0] = 1
            it_all[cm, :, 0] = 1
            for i2 in range(1, n2):
                t_all[cm, :, i2] = _np_mulmod_vec(
                    t_all[cm, :, i2 - 1], k1_u64, p)
                it_all[cm, :, i2] = _np_mulmod_vec(
                    it_all[cm, :, i2 - 1], ik1_u64, p)
        return t_all, it_all

    def _with_shoup(self, vals):
        """(values, shoup) pair in the ring dtype from uint64 canonical."""
        ring = self.plan.ring
        dt = ring.dtype
        wbits = ring.repr_bits
        s = np.empty(vals.shape, dtype=np.uint64)
        for cm in range(ring.nmoduli):
            p = int(ring.moduli[cm])
            s[cm] = _np_shoup_vec(vals[cm].reshape(-1), p,
                                  wbits).reshape(vals.shape[1:])
        return vals.astype(dt), s.astype(dt)

    def _i2_scale(self, inverse):
        """phi^(i2) (fwd) or n^-1 * phi^(-i2) (inv) per channel: the twist
        part that folds into the mod-matmul path's twiddles."""
        ring = self.plan.ring
        n2 = self.plan.n2
        obj = ring.limb == "u64"
        ctx = ring.context()
        out = np.empty((ring.nmoduli, n2), dtype=np.uint64)
        for cm in range(ring.nmoduli):
            p = int(ring.moduli[cm])
            phi = ctx.phi_int[cm]
            if inverse:
                out[cm] = _powers_mod(pow(phi, -1, p), n2, p,
                                      start=int(ctx.invpolyDegree[cm]),
                                      obj=obj)
            else:
                out[cm] = _powers_mod(phi, n2, p, obj=obj)
        return out

    def _scaled(self, t, inverse):
        ring = self.plan.ring
        sc = self._i2_scale(inverse)
        out = np.empty_like(t)
        for cm in range(ring.nmoduli):
            out[cm] = _np_mulmod_vec(t[cm], sc[cm][None, :],
                                     int(ring.moduli[cm]))
        return self._with_shoup(out)

    @functools.cached_property
    def _plain_fwd(self):
        return self._with_shoup(self._t_it[0])

    @functools.cached_property
    def _plain_inv(self):
        return self._with_shoup(self._t_it[1])

    @functools.cached_property
    def _twisted_fwd(self):
        return self._scaled(self._t_it[0], False)

    @functools.cached_property
    def _twisted_inv(self):
        return self._scaled(self._t_it[1], True)

    @property
    def twiddle(self):          # w^(k1*i2)
        return self._plain_fwd[0]

    @property
    def twiddle_s(self):
        return self._plain_fwd[1]

    @property
    def itwiddle(self):         # w^(-k1*i2)
        return self._plain_inv[0]

    @property
    def itwiddle_s(self):
        return self._plain_inv[1]

    @property
    def twiddle_tw(self):       # * phi^(i2)   (mod-matmul twisted path)
        return self._twisted_fwd[0]

    @property
    def twiddle_tw_s(self):
        return self._twisted_fwd[1]

    @property
    def itwiddle_tw(self):      # * n^-1 phi^(-i2)
        return self._twisted_inv[0]

    @property
    def itwiddle_tw_s(self):
        return self._twisted_inv[1]


@functools.lru_cache(maxsize=None)
def get_four_step_context(ring: Ring, n1: int, n2: int) -> FourStepContext:
    if n1 < 2 or n2 < 2 or n1 * n2 != ring.degree:
        raise ValueError(
            f"four-step factors must each be >= 2 and multiply to the "
            f"degree: n1={n1}, n2={n2}, degree={ring.degree} (a degenerate "
            f"factor means there is nothing to shard: use the single-chip "
            f"dispatch)")
    return FourStepContext(FourStepPlan(ring, n1, n2))


# ---------------------------------------------------------------------------
# one rank's tables on its device
# ---------------------------------------------------------------------------

def _storage(a, ring, device):
    """numpy residues in the limb dtype -> storage tensor on `device`."""
    a = np.ascontiguousarray(a)
    view = {"u16": np.int16, "u32": np.int32, "u64": np.int64}[ring.limb]
    return torch.from_numpy(a.view(view).copy()).to(device)


def _widened(a, ring, device):
    """numpy residues -> int64 tensor of the unsigned values (u64: the bit
    pattern), as the plain stage loop reads its tables."""
    a = np.ascontiguousarray(a)
    a = a.view(np.int64) if ring.limb == "u64" else a.astype(np.int64)
    return torch.from_numpy(a.copy()).to(device)


class RankTables:
    """The four-step tables one rank of a group of size d reads, on its
    device: the small sub-DFT tables whole, and this rank's slice of each
    [m, n1, n2] elementwise table (column block for the forward twist and
    twiddles and the inverse untwist, row block for the inverse twiddles),
    sliced once per family when a path first reads it."""

    def __init__(self, fctx: FourStepContext, d: int, rank: int, device):
        ring = fctx.plan.ring
        n1, n2 = fctx.plan.n1, fctx.plan.n2
        self.fctx, self.plan, self.ring = fctx, fctx.plan, ring
        self.d, self.rank, self.device = d, rank, device
        self.cols = slice(rank * n2 // d, (rank + 1) * n2 // d)
        self.rows = slice(rank * n1 // d, (rank + 1) * n1 // d)
        self.p_col = _widened(fctx.p_col, ring, device)          # [m, 1]
        for name in ("col_w", "col_ws", "col_iw", "col_iws", "row_w",
                     "row_ws", "row_iw", "row_iws"):
            setattr(self, name, _widened(getattr(fctx, name), ring, device))
        self.rev1 = torch.from_numpy(fctx.rev1.astype(np.int64)).to(device)
        self.rev2 = torch.from_numpy(fctx.rev2.astype(np.int64)).to(device)

    def _col(self, *tabs):
        return tuple(_storage(t[:, :, self.cols], self.ring, self.device)
                     for t in tabs)

    def _row(self, *tabs):
        return tuple(_storage(t[:, self.rows, :], self.ring, self.device)
                     for t in tabs)

    @functools.cached_property
    def fwd_plain(self):
        """(phis, shoupphis, twiddle, twiddle_s), column block."""
        f = self.fctx
        return self._col(f.phis, f.shoupphis, f.twiddle, f.twiddle_s)

    @functools.cached_property
    def fwd_twisted(self):
        """(twiddle_tw, twiddle_tw_s), column block."""
        return self._col(self.fctx.twiddle_tw, self.fctx.twiddle_tw_s)

    @functools.cached_property
    def inv_plain(self):
        """(itwiddle, itwiddle_s) row block + (ivp, ivp_s) column block."""
        f = self.fctx
        return self._row(f.itwiddle, f.itwiddle_s) + self._col(f.ivp, f.ivp_s)

    @functools.cached_property
    def inv_twisted(self):
        """(itwiddle_tw, itwiddle_tw_s), row block."""
        return self._row(self.fctx.itwiddle_tw, self.fctx.itwiddle_tw_s)


@functools.lru_cache(maxsize=None)
def _rank_tables(ring, n1, d, rank, device) -> RankTables:
    return RankTables(get_four_step_context(ring, n1, ring.degree // n1), d,
                      rank, device)


def rank_tables(ring: Ring, n1: int, d: int, rank: int, device) -> RankTables:
    """The rank's tables, cached per (ring, n1, d, rank, device)."""
    return _rank_tables(ring, n1, d, rank, canonical_device(device))


# ---------------------------------------------------------------------------
# local building blocks
# ---------------------------------------------------------------------------

def _twiddle_mul(x, tw, tws, ring):
    """The elementwise Shoup twiddle of a four-step branch whose adjacent
    sub-DFT is the stage loop: one mulmod_shoup program (E1 on the card),
    the JAX package's jitted modops.mulmod_shoup.  tw None: the
    mod-matmul's epilogue applied it already."""
    return x if tw is None else _shoup3(x, tw, tws, ring)


def _shoup3(x, w, ws, ring):
    """mulmod_shoup of [..., m, r, c] blocks by [m, r, c] tables."""
    return expr_program.apply("mulmod_shoup", (x, w, ws), ring,
                              channel_axis=-3)


def _dft_lastaxis(x, w, ws, size, p_col, rev):
    """Forward size-`size` DFT along the last axis of [..., m, B, size],
    natural output order (Harvey stages + bit-reversal gather); w/ws are
    the widened blocked tables [m, size - 1]."""
    if size == 1:
        return x
    bits = modops.limb_bits(x.dtype)
    # the stage loop wants [..., m, n]: x: [..., m, B, size] -> [..., B, m, size]
    xt = modops.widen(x.transpose(-3, -2), bits)
    out = modops._sub_if_ge(_stages(xt, w, ws, p_col, bits), p_col, bits)
    out = torch.index_select(out, -1, rev)
    return modops.narrow(out, x.dtype).transpose(-3, -2)


def _resolve_transpose(transpose: str, chunks: int = 1) -> str:
    """'auto' -> 'a2a' on every device; explicit 'a2a'/'ppermute' pass.
    ppermute already pipelines per block, so it refuses chunks > 1."""
    if transpose not in ("auto", "a2a", "ppermute"):
        raise ValueError(f"transpose must be auto|a2a|ppermute, "
                         f"got {transpose!r}")
    if transpose == "ppermute" and chunks > 1:
        raise ValueError("ppermute already pipelines per block: chunks must "
                         "be 1")
    return "a2a" if transpose == "auto" else transpose


def _resolved_backends(ring: Ring, n1: int, n2: int, device):
    """(use_mod_matmul_col, use_mod_matmul_row), read at call time from
    NFL_TORCH_NTT and resolved by the tensor's device: auto and fused give
    each supported size to ops/dft_mxu.py on a CUDA tensor (the kernels)
    and on a CPU tensor (their twins); plain and butterfly, and tensors on
    any other device, take the stage loop."""
    mode = kernel_mode()
    if mode in ("plain", "butterfly") or torch.device(device).type not in (
            "cuda", "cpu"):
        return (False, False)
    return (dft_mxu.supports(ring, n1), dft_mxu.supports(ring, n2))


# ---------------------------------------------------------------------------
# the transposes: started, then finished, so that the pipelined entry can
# overlap one transform's exchange with the next one's compute
# ---------------------------------------------------------------------------

class _Pending:
    """An exchange in flight: the collective's work handles and the
    function that assembles the result once they are done."""

    def __init__(self, works, finish):
        self.works, self.finish = works, finish

    def wait(self):
        for w in self.works:
            w.wait()
        return self.finish()


def _blocks(x, split_ax, d):
    """x [..., A, B] with the split axis (-2 or -1) cut into d blocks, the
    block axis moved to the front: [d, ..., A/d, B] or [d, ..., A, B/d]."""
    shape = list(x.shape)
    ax = len(shape) + split_ax
    xs = x.reshape(shape[:ax] + [d, shape[ax] // d] + shape[ax + 1:])
    return xs.movedim(ax, 0)


def _merge(recv, concat_ax):
    """[d, ..., A, B] blocks by source -> the source axis folded into the
    concat axis (-2 or -1) at slot j for source j."""
    d, shape = recv.shape[0], list(recv.shape[1:])
    ax = len(shape) + concat_ax
    out = recv.movedim(0, ax)
    return out.reshape(shape[:ax] + [d * shape[ax]] + shape[ax + 1:])


def _peer(group, r):
    return r if group is None else dist.get_global_rank(group, r)


def _a2a_start(x, split_ax, concat_ax, d, group):
    """jax.lax.all_to_all(tiled=True) by one all_to_all_single: block j of
    the split axis to rank j; the block from rank j at slot j of the
    concat axis."""
    send = _blocks(x, split_ax, d).contiguous()
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=True)
    return _Pending([work], lambda: _merge(recv, concat_ax))


def _ppermute_start(x, tw, tws, ring, split_ax, concat_ax, d, group):
    """Twiddle + transpose as d-1 point-to-point hops: hop s twiddles the
    block for rank (me+s) mod d, sends it there and receives the block
    from (me-s) mod d, which lands at slot (me-s) mod d; hop s+1's twiddle
    runs while hop s is in flight."""
    me = dist.get_rank(group)
    xb = _blocks(x, split_ax, d)
    tb, sb = ((None,) * d, (None,) * d) if tw is None \
        else (_blocks(tw, split_ax, d), _blocks(tws, split_ax, d))
    recv, works = [None] * d, []
    for s in range(d):
        t, src = (me + s) % d, (me - s) % d
        blk = _twiddle_mul(xb[t], tb[t], sb[t], ring).contiguous()
        if s == 0:
            recv[src] = blk
            continue
        recv[src] = torch.empty_like(blk)
        works += dist.batch_isend_irecv([
            dist.P2POp(dist.isend, blk, _peer(group, t), group),
            dist.P2POp(dist.irecv, recv[src], _peer(group, src), group)])
    return _Pending(works, lambda: _merge(torch.stack(recv), concat_ax))


def _exchange_start(x, tw, tws, ring, fwd, group, d, chunks, transpose,
                    distributed):
    """Steps 3 + 4 (forward: column block [..., m, n1, n2/d] -> row block
    [..., m, n1/d, n2]; fwd=False mirrors it), started; not `distributed`:
    the twiddle alone."""
    split_ax, concat_ax = (-2, -1) if fwd else (-1, -2)
    if not distributed:
        out = _twiddle_mul(x, tw, tws, ring)
        return _Pending([], lambda: out)
    if transpose == "ppermute":
        return _ppermute_start(x, tw, tws, ring, split_ax, concat_ax, d,
                               group)
    if chunks == 1:
        return _a2a_start(_twiddle_mul(x, tw, tws, ring), split_ax,
                          concat_ax, d, group)
    # chunk c: the c-th sub-block of every destination block, so the chunk
    # outputs concatenate to the monolithic transpose
    sub = x.shape[split_ax] // d // chunks

    def chunk(v, c):
        if v is None:
            return None
        shape = list(v.shape)
        ax = len(shape) + split_ax
        v5 = v.reshape(shape[:ax] + [d, chunks, sub] + shape[ax + 1:])
        return v5.select(ax + 1, c).reshape(
            shape[:ax] + [d * sub] + shape[ax + 1:])

    pend = [_a2a_start(_twiddle_mul(chunk(x, c), chunk(tw, c), chunk(tws, c),
                                    ring), split_ax, concat_ax, d, group)
            for c in range(chunks)]
    return _Pending([w for p in pend for w in p.works],
                    lambda: torch.cat([p.finish() for p in pend],
                                      dim=split_ax))


# ---------------------------------------------------------------------------
# the local passes
# ---------------------------------------------------------------------------

def _fwd_pre(x, tabs: RankTables, backends):
    """Steps 1 + 2 on the column block; returns (x, tw, tws), tw None when
    the column mod-matmul's epilogue took the twiddle (step 3's multiply)."""
    ring, n1 = tabs.ring, tabs.plan.n1
    use1, use2 = backends
    if use1 and use2:
        # twisted mod-matmul path: the phi pre-twist rides the column
        # matrices (phi^(n2*i1)) and the twiddles (phi^(i2))
        x = dft_mxu.matmul_mod(x, ring, "fourstep_col_fwd_tw", n1, axis=-2,
                               twiddle=tabs.fwd_twisted)
        return x, None, None
    phis, shoupphis, tw, tws = tabs.fwd_plain
    x = _shoup3(x, phis, shoupphis, ring)
    if use1:
        x = dft_mxu.matmul_mod(x, ring, "dft_fwd", n1, axis=-2,
                               twiddle=(tw, tws))
        return x, None, None
    x = _dft_lastaxis(x.transpose(-1, -2), tabs.col_w, tabs.col_ws, n1,
                      tabs.p_col, tabs.rev1).transpose(-1, -2)
    return x, tw, tws


def _fwd_post(x, tabs: RankTables, backends):
    """Step 5 on the row block."""
    if backends[1]:
        return dft_mxu.dft_along(x, tabs.ring, tabs.plan.n2, axis=-1)
    return _dft_lastaxis(x, tabs.row_w, tabs.row_ws, tabs.plan.n2,
                         tabs.p_col, tabs.rev2)


def four_step_ntt_local(x, tabs: RankTables, *, distributed=False,
                        group=None, chunks=1, transpose="a2a",
                        backends=None):
    """Forward four-step pass of one rank: x [..., m, n1, n2/d] (its column
    block) -> [..., m, n1/d, n2] (its row block), exchanging over `group`
    (None: the default group) when `distributed`; otherwise d = 1 and the
    whole [..., m, n1, n2] goes through with no communication.  chunks > 1
    splits the twiddle + all-to-all into `chunks` async pieces along the
    row axis."""
    if backends is None:
        backends = _resolved_backends(tabs.ring, tabs.plan.n1,
                                      tabs.plan.n2, x.device)
    x, tw, tws = _fwd_pre(x, tabs, backends)
    x = _exchange_start(x, tw, tws, tabs.ring, True, group, tabs.d, chunks,
                        transpose, distributed).wait()
    return _fwd_post(x, tabs, backends)


def four_step_intt_local(y, tabs: RankTables, *, distributed=False,
                         group=None, chunks=1, transpose="a2a",
                         backends=None):
    """Inverse of four_step_ntt_local: y [..., m, n1/d, n2] (the rank's
    row block) -> [..., m, n1, n2/d] (its column block of the coefficient
    tensor), the n^-1 phi^-i untwist included (folded into the column
    matrices and twiddles on the twisted mod-matmul path)."""
    ring, n1, n2 = tabs.ring, tabs.plan.n1, tabs.plan.n2
    if backends is None:
        backends = _resolved_backends(ring, n1, n2, y.device)
    use1, use2 = backends
    twisted = use1 and use2
    # inverse of step 5: unscaled inverse DFT along rows, the twiddle as
    # its epilogue when it is a mod-matmul
    itw, itws = tabs.inv_twisted if twisted else tabs.inv_plain[:2]
    if use2:
        x = dft_mxu.matmul_mod(y, ring, "dft_inv", n2, axis=-1,
                               twiddle=(itw, itws))
        itw = itws = None
    else:
        x = _dft_lastaxis(y, tabs.row_iw, tabs.row_iws, n2, tabs.p_col,
                          tabs.rev2)
    x = _exchange_start(x, itw, itws, ring, False, group, tabs.d, chunks,
                        transpose, distributed).wait()
    # inverse of step 2: inverse DFT down columns
    if twisted:
        return dft_mxu.matmul_mod(x, ring, "fourstep_col_inv_tw", n1,
                                  axis=-2)
    if use1:
        x = dft_mxu.dft_along(x, ring, n1, axis=-2, inverse=True)
    else:
        x = _dft_lastaxis(x.transpose(-1, -2), tabs.col_iw, tabs.col_iws, n1,
                          tabs.p_col, tabs.rev1).transpose(-1, -2)
    # un-twist by n^-1 * phi^-i (column block; both 1/n1 and 1/n2)
    ivp, ivp_s = tabs.inv_plain[2:]
    return _shoup3(x, ivp, ivp_s, ring)


# ---------------------------------------------------------------------------
# process-group API
# ---------------------------------------------------------------------------

def _group_geometry(ring, group, n1, chunks=1, inverse=False):
    """(d, rank, n1, n2) of a call on `group` (None: the default group,
    which must be initialised)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is "
                           "initialised (parallel.api.init_distributed)")
    d, rank = dist.get_world_size(group), dist.get_rank(group)
    n = ring.degree
    if n1 is None:
        n1 = 1 << (static_log2(n) // 2)
    n2 = n // n1
    if n1 % d or n2 % d:
        raise ValueError(f"factor sizes n1={n1}, n2={n2} must split evenly "
                         f"over {d} ranks")
    if chunks > 1 and (n2 if inverse else n1) % (d * chunks):
        raise ValueError(f"chunks={chunks} must divide the "
                         f"{'column' if inverse else 'row'} blocks")
    return d, rank, n1, n2


def _check_block(x, ring, shape):
    if tuple(x.shape[-3:]) != shape:
        raise ValueError(f"expected the rank's block [..., {shape[0]}, "
                         f"{shape[1]}, {shape[2]}], got {tuple(x.shape)}")


def distributed_ntt_pow_phi(x, ring: Ring, group=None, *, n1=None,
                            chunks: int = 1, transpose: str = "auto"):
    """Forward negacyclic transform, degree-sharded over the ranks of
    `group` (None: the default group).

    x is this rank's column block [..., m, n1, n2/d] of the [..., m, n1, n2]
    view of the coefficients (columns i2 in [r n2/d, (r+1) n2/d) for rank r
    of d); returns its row block [..., m, n1/d, n2] of the four-step layout,
    E[k1 + n1*k2] = out[..., k1, k2]; the single-chip Harvey ordering is
    harvey[j] = E[bitrev_n(j)].

    transpose: 'auto' (a2a), or an explicit 'a2a'/'ppermute'."""
    transpose = _resolve_transpose(transpose, chunks)
    d, rank, n1, n2 = _group_geometry(ring, group, n1, chunks)
    _check_block(x, ring, (ring.nmoduli, n1, n2 // d))
    tabs = rank_tables(ring, n1, d, rank, x.device)
    return four_step_ntt_local(x, tabs, distributed=True, group=group,
                               chunks=chunks, transpose=transpose)


def distributed_ntt_pow_phi_pipelined(x, ring: Ring, group=None, *,
                                      n1=None, transpose: str = "ppermute"):
    """Batch-pipelined forward transform of B independent polynomials:
    x [B, m, n1, n2/d] (this rank's column blocks) -> [B, m, n1/d, n2],
    bit-identical per element to distributed_ntt_pow_phi.  Transform b's
    exchange is started asynchronously and finished after transform b+1's
    twist, column DFTs and twiddle are issued, so the two overlap."""
    transpose = _resolve_transpose(transpose)
    d, rank, n1, n2 = _group_geometry(ring, group, n1)
    if x.dim() != 4:
        raise ValueError(f"expected [B, m, n1, n2/d], got {tuple(x.shape)}")
    _check_block(x, ring, (ring.nmoduli, n1, n2 // d))
    tabs = rank_tables(ring, n1, d, rank, x.device)
    backends = _resolved_backends(ring, n1, n2, x.device)
    outs, pending = [], None
    for b in range(x.shape[0]):
        v, tw, tws = _fwd_pre(x[b], tabs, backends)
        started = _exchange_start(v, tw, tws, ring, True, group, d, 1,
                                  transpose, True)
        if pending is not None:
            outs.append(_fwd_post(pending.wait(), tabs, backends))
        pending = started
    if pending is not None:
        outs.append(_fwd_post(pending.wait(), tabs, backends))
    if not outs:
        return x.new_empty((0, ring.nmoduli, n1 // d, n2))
    return torch.stack(outs)


def distributed_invntt_pow_invphi(y, ring: Ring, group=None, *, n1=None,
                                  chunks: int = 1, transpose: str = "auto"):
    """Inverse of distributed_ntt_pow_phi: y is this rank's row block
    [..., m, n1/d, n2] of the four-step layout; returns its column block
    [..., m, n1, n2/d] of the coefficient tensor's [..., m, n1, n2] view."""
    transpose = _resolve_transpose(transpose, chunks)
    d, rank, n1, n2 = _group_geometry(ring, group, n1, chunks, inverse=True)
    _check_block(y, ring, (ring.nmoduli, n1 // d, n2))
    tabs = rank_tables(ring, n1, d, rank, y.device)
    return four_step_intt_local(y, tabs, distributed=True, group=group,
                                chunks=chunks, transpose=transpose)


def four_step_reference(x, ring: Ring, n1: int):
    """Single-process four-step forward of [..., m, n] -> [..., m, n1, n2]
    (no group), for differential tests."""
    n2 = ring.degree // n1
    tabs = rank_tables(ring, n1, 1, 0, x.device)
    return four_step_ntt_local(x.reshape(x.shape[:-1] + (n1, n2)), tabs)


def four_step_reference_inverse(y, ring: Ring, n1: int):
    """Single-process inverse: [..., m, n1, n2] -> [..., m, n]."""
    tabs = rank_tables(ring, n1, 1, 0, y.device)
    xb = four_step_intt_local(y, tabs)
    return xb.reshape(y.shape[:-2] + (ring.degree,))
