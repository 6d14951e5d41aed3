"""On-device polynomial samplers.

PyTorch port of nfllib_tpu/prng/device_sampling.py, the device tier of the
sampling subsystem (reference include/nfl/core.hpp:145-391 semantics): the
Salsa20 keystream is generated on the device and consumed there, so a
sampler call reads nothing back to the host and sends nothing to the
device.  Every function takes `device=` (the card unless named) and a
nonce that is a Python int or a 0-d int64 tensor on that device.

On a CUDA device the programs that XLA fuses in the JAX package are
hand-written kernels: a uniform, non-uniform or ZO call is one launch of
S1 (csrc/salsa20.cu) with that sampler's epilogue, the keystream turned
into residues in registers; the hwt samplers are S5 (device_hwt) and S6
(device_hwt_exact) in csrc/hwt.cu, a selection or walk kernel that makes
its own keystream and a store kernel; the Gaussian makes its keystream
inside its own kernels, S3 (csrc/gaussian_fixed.cu: the fixed-consumption
sampler, F of them in one launch) and S4 (csrc/gaussian_exact.cu: the
stream-exact walk, two launches a sampler).  On the CPU the same
functions run the plain twins (`device_uniform_plain`,
`device_non_uniform_plain`, `device_zo_plain`, `device_hwt_plain`,
`device_hwt_exact_plain`, `salsa20.keystream_plain`,
`gaussian_fixed_plain`, `gaussian_exact_plain`).

Byte-consumption contracts (the JAX package's):
  * uniform / non_uniform / ZO reproduce the host tier EXACTLY for the same
    (key, nonce): same stream layout, same masking quirks, same values.
  * gaussian has two device formulations:
      - device_gaussian (default in the fused pipelines): fixed consumption
        (every sample eats word_precision big-endian words), equal in
        DISTRIBUTION to the host walk but a different stream pattern;
      - device_gaussian_exact: STREAM-EXACT, bit-identical outputs to the
        host walk for the same (key, nonce), reproducing its variable
        per-sample consumption and refill policy by pointer doubling.
  * hwt_dist has the same two device formulations:
      - device_hwt (dispatcher default): fixed consumption (n + h words),
        distribution-equal via argsort-of-random-keys subset selection;
      - device_hwt_exact: STREAM-EXACT, bit-identical to the host's
        sequential rejection reservoir (core.hpp:352-391) for the same
        (key, nonce), resolving the (astronomically rare) data-dependent
        rejections exactly.
On a channel block of a ring (Ring.channel_block, first > 0) every
sampler gives the whole ring's draw's rows first .. first + m - 1 and the
same advance: the uniform reads the stream from limb first * n on (S1 makes
only those blocks), and every other sampler reads one value a coefficient,
whatever the channels, and encodes it against the block's moduli (p_col),
the only thing it reads of the ring's channels.
Storage follows the port's convention: residues in the signed type of the
limb's width holding the unsigned bit pattern.
"""
from __future__ import annotations

import functools
import types

import numpy as np
import torch

from .. import profiling
from ..ops import modops
from ..ring import DEFAULT_DEVICE, Ring
from .salsa20 import keystream_plain, nonce_add
from .sampling import ZO_dist, gaussian, hwt_dist, non_uniform, uniform

_ITEM = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_SIGN = -(1 << 63)
_INT32_MIN = -(1 << 31)


def _items(words: torch.Tensor, itemsize: int) -> torch.Tensor:
    """S1's int32 keystream rows [F, L] read as little-endian items of
    `itemsize` bytes: [F, 4L / itemsize], free (the tensor's bytes are the
    keystream's)."""
    return words.view(_ITEM[itemsize])


def _stream_limbs(key: bytes, nonce, count: int, itemsize: int,
                  device=DEFAULT_DEVICE, start: int = 0):
    """[count] little-endian unsigned integers of `itemsize` bytes (the
    bytes of Salsa20Stream.randombytes) in the storage type of that width
    (uint8 / int16 / int32 / int64), from the plain twins' keystream
    (keystream_plain), the stream's items start .. start + count - 1 (only
    the blocks they lie in are made)."""
    per = 64 // itemsize
    first, skip = divmod(start, per)
    words = keystream_plain(key, nonce, -(-(skip + count) // per), 1,
                            device, first)
    return _items(words, itemsize).reshape(-1)[skip:skip + count]


def _itemsize(ring: Ring) -> int:
    return np.dtype(ring.dtype).itemsize


def _p_col(ring: Ring, device) -> torch.Tensor:
    """[m, 1] int64 moduli on device (the ring's cached tables; on a
    channel block the block's)."""
    return ring.context().to(device).p_col


def _to_storage(vals: torch.Tensor, ring: Ring) -> torch.Tensor:
    """int64 words -> the ring's storage dtype, keeping repr_bits bits
    (the JAX package's `& repr_mask` then astype)."""
    if ring.repr_bits < 64:
        vals = vals & ((1 << ring.repr_bits) - 1)
    return vals.to(ring.torch_dtype)


def _uniform_consts(ring: Ring) -> tuple:
    """S1's uniform epilogue words: the modulus mask"""
    return ((1 << ring.limb_params.modulus_bits) - 1,)


@functools.lru_cache(maxsize=64)
def _non_uniform_consts(ring: Ring, ub: int, amp: int) -> tuple:
    """S1's non-uniform epilogue words: the mask of bit_length(span), span,
    ub and the amplifier; refuses ub >= a modulus of the ring (on a
    channel block, of the block: the whole ring's other channels are not
    known there)"""
    if ub >= min(int(p) for p in ring.moduli):
        raise ValueError("upper_bound is larger than the modulus")
    span = 2 * ub - 1
    return (1 << span.bit_length()) - 1, span, ub, amp


def device_uniform(ring: Ring, key: bytes, nonce, device=DEFAULT_DEVICE):
    """Uniform residues, bit-identical to sampling.sample_uniform
    (mask + single conditional subtract, core.hpp:151-186).  On a channel
    block the limbs come from limb first * n of the stream on, so the
    block's rows are the whole ring's.  On a CUDA device one launch of S1's
    uniform instance, which makes only the keystream blocks those limbs
    lie in."""
    with profiling.span("sampler"):
        p = _p_col(ring, device)
        if not p.is_cuda:
            return device_uniform_plain(ring, key, nonce, device)
        from .._kernels import SALSA20_UNIFORM
        return SALSA20_UNIFORM(key, nonce, p, ring.degree, ring.torch_dtype,
                               *_uniform_consts(ring),
                               offset=ring.first * ring.degree)


def device_uniform_plain(ring: Ring, key: bytes, nonce,
                         device=DEFAULT_DEVICE):
    """device_uniform's plain twin on any device: the plain keystream
    (keystream_plain, from the block of limb first * n on) read as limbs,
    masked and reduced by torch ops."""
    lp = ring.limb_params
    vals = _stream_limbs(key, nonce, ring.nmoduli * ring.degree,
                         _itemsize(ring), device, ring.first * ring.degree)
    t = vals.reshape(ring.nmoduli, ring.degree) \
        & ((1 << lp.modulus_bits) - 1)
    p = _p_col(ring, device)
    return torch.where(t >= p, t - p, t).to(ring.torch_dtype)


def device_non_uniform(ring: Ring, key: bytes, nonce, mode: non_uniform,
                       device=DEFAULT_DEVICE):
    """Bounded centered noise, bit-identical to sampling.sample_non_uniform
    (core.hpp:194-282: wrapping value_type arithmetic, negatives as
    p + v).  On a CUDA device one launch of S1's non-uniform instance."""
    with profiling.span("sampler"):
        consts = _non_uniform_consts(ring, int(mode.upper_bound),
                                     int(mode.amplifier))
        p = _p_col(ring, device)
        if not p.is_cuda:
            return device_non_uniform_plain(ring, key, nonce, mode, device)
        from .._kernels import SALSA20_NON_UNIFORM
        return SALSA20_NON_UNIFORM(key, nonce, p, ring.degree,
                                   ring.torch_dtype, *consts)


def device_non_uniform_plain(ring: Ring, key: bytes, nonce,
                             mode: non_uniform, device=DEFAULT_DEVICE):
    """device_non_uniform's plain twin on any device (torch ops after the
    plain keystream)."""
    ub = int(mode.upper_bound)
    amp = int(mode.amplifier)
    for p in ring.moduli:
        if ub >= p:
            raise ValueError("upper_bound is larger than the modulus")
    rnd = _stream_limbs(key, nonce, ring.degree, _itemsize(ring), device)
    span = 2 * ub - 1
    t = modops.widen(rnd, ring.repr_bits) & ((1 << span.bit_length()) - 1)
    t = torch.where(t >= span, t - span, t)
    neg = t >= ub
    # int64 arithmetic wraps like the reference's value_type arithmetic
    vals = torch.where(neg[None, :],
                       _p_col(ring, device) + t[None, :] * amp - span * amp,
                       t[None, :] * amp)
    return _to_storage(vals, ring)


def device_zo(ring: Ring, key: bytes, nonce, mode: ZO_dist,
              device=DEFAULT_DEVICE):
    """Ternary sampler, bit-identical to sampling.sample_zo including the
    non-canonical p+1 encoding of +1 (core.hpp:333-344).  On a CUDA device
    one launch of S1's ZO instance."""
    with profiling.span("sampler"):
        p = _p_col(ring, device)
        if not p.is_cuda:
            return device_zo_plain(ring, key, nonce, mode, device)
        from .._kernels import SALSA20_ZO
        return SALSA20_ZO(key, nonce, p, ring.degree, ring.torch_dtype,
                          int(mode.rho))


def device_zo_plain(ring: Ring, key: bytes, nonce, mode: ZO_dist,
                    device=DEFAULT_DEVICE):
    """device_zo's plain twin on any device (torch ops after the plain
    keystream)."""
    rnd = _stream_limbs(key, nonce, ring.degree, 1, device)
    hit = rnd <= int(mode.rho)
    bit = (rnd & 2).to(torch.int64)
    vals = torch.where(hit[None, :], _p_col(ring, device) - 1 + bit[None, :],
                       0)
    return _to_storage(vals, ring)


# ---------------------------------------------------------------------------
# the Gaussian's device tables, and the search of its plain twins
# ---------------------------------------------------------------------------

def gaussian_tables(fg, device=DEFAULT_DEVICE, exact: bool = False):
    """The device tables a FastGaussianNoise's device samplers read:
    `bw`, the barrier words int16 [nb, wp] (uint16 bit patterns), and for
    the stream-exact sampler (`exact`) the lookup tables `luf` (bool [L]),
    `luv` (int64 [L]) and, at lu_depth 2, the compact second level `slot`
    (int64 [L]: first word -> row, row 0 a dummy), `V2` (int32 [K + 1, L])
    and `F2` (bool [K + 1, L]) over the K flagged first words (a dense
    [L, L] table would hold 2^32 entries at in_bits 16).  Built on the host
    and copied to the device: callers on a hot path build them once
    (apps/lwe.py caches them)."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tabs = types.SimpleNamespace(
        bw=put(np.asarray(fg.barrier_words, dtype=np.uint16)
               .view(np.int16)))
    if not exact:
        return tabs
    L = 1 << fg.in_bits
    tabs.luf = put(np.asarray(fg.lu_flag, dtype=bool))
    tabs.luv = put(np.asarray(fg.lu_val, dtype=np.int64))
    if fg.lu_depth == 2:
        flagged = [v0 for v0 in range(L) if fg.lu_flag[v0]]
        V2 = np.zeros((len(flagged) + 1, L), dtype=np.int32)
        F2 = np.zeros((len(flagged) + 1, L), dtype=bool)
        slot = np.zeros(L, dtype=np.int64)
        for i, v0 in enumerate(flagged):
            val2, flag2, _ = fg.lu2[v0]
            V2[i + 1] = val2
            F2[i + 1] = flag2
            slot[v0] = i + 1
        tabs.slot, tabs.V2, tabs.F2 = put(slot), put(V2), put(F2)
    return tabs


def _take(x, idx, fill=_INT32_MIN):
    """x's items at idx along its last axis (x [rows, n] and idx [rows, k],
    or x [n] and any idx) as the JAX package's jnp.take and
    take_along_axis read them: an index below 0 counts once from the end,
    and one still outside x reads `fill` (theirs: INT32_MIN for the int32
    words and tables, True for a bool table)."""
    n = x.shape[-1]
    i = torch.where(idx < 0, idx + n, idx)
    inside = (i >= 0) & (i < n)
    i = i.clamp(0, n - 1)
    return torch.where(inside, torch.gather(x, 1, i) if x.dim() == 2
                       else x[i], fill)


def _clip(idx, n: int):
    """idx as the JAX package's x[i, j] reads an axis of n: an index below
    0 counts once from the end, one still outside is clamped to it"""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _count_barriers_le(r, bw, nb: int):
    """#{barriers <= r} per sample via branchless binary search over the
    sorted barrier table (the plain twin of csrc/gaussian_search.cuh's
    count_le).  r: [s, wp] int64 big-endian words; bw: [nb, wp] int64.
    A word compares by the sign of its difference to the barrier's wrapped
    to int32, as the JAX package's int32 search does: the same for every
    keystream word, and for its INT32_MIN fill (_take) greater than every
    barrier word but 0."""
    s, wp = r.shape
    lo = torch.zeros((s,), dtype=torch.int64, device=r.device)
    hi = torch.full((s,), nb, dtype=torch.int64, device=r.device)
    for _ in range(max(1, (nb + 1).bit_length())):
        valid = lo < hi
        mid = (lo + hi) >> 1
        rows = bw[mid.clamp(max=nb - 1)]
        acc = torch.zeros((s,), dtype=torch.int64, device=r.device)
        for j in range(wp):
            d = ((r[:, j] - rows[:, j] - _INT32_MIN) & 0xFFFFFFFF) + _INT32_MIN
            acc = torch.where(acc != 0, acc, torch.sign(d))
        le = acc >= 0
        lo = torch.where(valid & le, mid + 1, lo)
        hi = torch.where(valid & ~le, mid, hi)
    return lo


def _item_words(stream: torch.Tensor, in_bits: int) -> torch.Tensor:
    """keystream rows -> the sampler's unsigned in_bits words, int64"""
    if in_bits == 8:
        return _items(stream, 1).to(torch.int64)
    return _items(stream, 2).to(torch.int64) & 0xFFFF


def barrier_count_plain(words, in_bits: int, wp: int, barriers, base: int, *,
                        starts=None, size=None, samples: int = 0,
                        amp: int = 1, p=None, dtype=None):
    """The barrier search of the plain twins, on keystream rows (int32
    [rows, L], read as in_bits items) and barriers int16 [nb, wp] (uint16
    words).  With `starts` (int [rows, S]): int32 [rows, S] of base +
    #{barriers <= r} at each start, r the wp items from the start among
    the first `size` items of the row (all when None), read by _take's
    rule where they lie outside.  Without: the fixed-consumption
    Gaussian of `samples` samples, sample s reading the wp items from
    s * wp of row 0, as the [m, samples] residues (base + count) * amp
    encoded p + v when negative, in `dtype` (p: int64 [m] or [m, 1])."""
    items = _item_words(words, in_bits)
    bw = barriers.to(torch.int64) & 0xFFFF
    if starts is not None:
        q = starts.to(torch.int64)
        items = items[:, :size]
        r = torch.stack([_take(items, q + j) for j in range(wp)], dim=-1)
        return (base + _count_barriers_le(r.reshape(-1, wp), bw, bw.shape[0])
                ).reshape(starts.shape).to(torch.int32)
    raw = items[0, :samples * wp].reshape(samples, wp)
    noise = (base + _count_barriers_le(raw, bw, bw.shape[0])) * amp
    p = p.reshape(-1, 1)
    return torch.where(noise[None, :] < 0, p + noise[None, :],
                       noise[None, :]).to(dtype)


# ---------------------------------------------------------------------------
# the fixed-consumption Gaussian: S3 and its twin
# ---------------------------------------------------------------------------

def gaussian_fixed_plain(key: bytes, nonce, offsets, amps, n: int,
                         in_bits: int, wp: int, barriers, base: int, p,
                         dtype) -> torch.Tensor:
    """S3's plain twin, with the arguments and the result of
    _kernels.GAUSSIAN_FIXED, on the barriers' device: for each sampler f
    the keystream at nonce + offsets[f] (keystream_plain) and the search
    of barrier_count_plain -> [F, m, n]."""
    device = barriers.device
    nbl = (n * wp * in_bits // 8 + 63) // 64
    return torch.stack([
        barrier_count_plain(
            keystream_plain(key, nonce_add(nonce, off), nbl, 1, device),
            in_bits, wp, barriers, base, samples=n, amp=amp, p=p,
            dtype=dtype)
        for off, amp in zip(offsets, amps)])


def device_gaussians(ring: Ring, key: bytes, nonce, draws,
                     device=DEFAULT_DEVICE, tables=None) -> torch.Tensor:
    """F fixed-consumption Gaussians of one FastGaussianNoise in one call:
    draws = ((offset, mode), ...), draw f at nonce + offset with mode's
    amplifier -> [F, m, n] residues, draw f equal to device_gaussian(ring,
    key, nonce + offset, mode).  On a CUDA device one launch of S3."""
    with profiling.span("sampler"):
        fg = draws[0][1].fg_prng
        if any(mode.fg_prng is not fg for _, mode in draws):
            raise ValueError("device_gaussians: the draws share one sampler")
        tables = tables if tables is not None else gaussian_tables(fg, device)
        args = (key, nonce, [off for off, _ in draws],
                [int(mode.amplifier) for _, mode in draws], ring.degree,
                fg.in_bits, fg.word_precision, tables.bw, fg.base_value,
                _p_col(ring, device), ring.torch_dtype)
        if tables.bw.is_cuda:
            from .._kernels import GAUSSIAN_FIXED
            return GAUSSIAN_FIXED(*args)
        return gaussian_fixed_plain(*args)


def device_gaussian(ring: Ring, key: bytes, nonce, mode: gaussian,
                    device=DEFAULT_DEVICE, tables=None):
    """Fixed-consumption discrete Gaussian: degree * word_precision
    big-endian stream words per call; output = base_value + #{barriers <=
    r}, encoded per channel as p + v for negative v (core.hpp:306-316).

    #{barriers <= r} is a branchless binary search over the sorted barrier
    table, O(wp log nb) per sample.  On a CUDA device the call is one
    launch of S3 (device_gaussians with one draw), the keystream made in
    its shared memory.  `tables`: gaussian_tables(fg, device), built here
    when not given."""
    return device_gaussians(ring, key, nonce, ((0, mode),), device,
                            tables)[0]


def device_sample(ring: Ring, mode, key: bytes, nonce, device=DEFAULT_DEVICE):
    """Dispatcher mirroring sampling.sample for the device tier."""
    if isinstance(mode, uniform):
        return device_uniform(ring, key, nonce, device)
    if isinstance(mode, non_uniform):
        return device_non_uniform(ring, key, nonce, mode, device)
    if isinstance(mode, ZO_dist):
        return device_zo(ring, key, nonce, mode, device)
    if isinstance(mode, gaussian):
        return device_gaussian(ring, key, nonce, mode, device)
    if isinstance(mode, hwt_dist):
        return device_hwt(ring, key, nonce, mode, device)
    raise TypeError(f"no device tier for sampler mode {mode!r}")


# ---------------------------------------------------------------------------
# stream-exact device Gaussian (the host walk's variable consumption,
# parallelized by pointer doubling): S4 and its twin; device hwt_dist
# ---------------------------------------------------------------------------

def gaussian_exact_plain(key: bytes, nonce, rlen: int, innoise: int,
                         nblocks: int, in_bits: int, wp: int, lu_depth: int,
                         tables, base: int, amp: int, p, dtype):
    """S4's plain twin, with the arguments and the result of
    _kernels.GAUSSIAN_EXACT, on the tables' device: the host walk's first
    rlen samples from nblocks fills of innoise words (fill k reads the
    start of the stream at nonce + k) -> ([m, rlen] residues in `dtype`,
    int64 [2]: the host's fill count and nonce + that count).

    The walk parallelizes by POINTER DOUBLING: the per-position
    consumption c(q) depends only on the one or two words at q, so the
    successor map g(q) = q + c(q) (with an absorbing sentinel at the
    refill boundary) is a table per refill block, and the sample starts
    are g's orbit of 0, computed for all blocks at once in
    ceil(log2(block_size)) gather rounds instead of one step per sample.
    Outputs are then a table / binary-search evaluation at the start
    positions, exactly as the host short-circuits them."""
    t = tables
    device = t.bw.device
    stream = keystream_plain(key, nonce, (innoise * in_bits // 8 + 63) // 64,
                             nblocks, device)
    words = _item_words(stream, in_bits)[:, :innoise]  # [nblocks, innoise]

    # per-position consumption -> successor table with sentinel = innoise
    fl0 = t.luf[words]
    if lu_depth == 1:
        c = torch.where(fl0, wp, 1)
    else:
        w1 = torch.roll(words, -1, dims=1)              # w1 at q = words[q+1]
        f2 = t.F2[t.slot[words], w1]
        c = torch.where(~fl0, 1, torch.where(f2, wp, 2))
    nxt = torch.arange(innoise, device=device)[None, :] + c
    g = torch.where(nxt + wp >= innoise, innoise, nxt)
    g = torch.cat([g, torch.full((nblocks, 1), innoise, dtype=g.dtype,
                                 device=device)], dim=1)  # sentinel column

    # orbit of 0 under g, all blocks at once, by doubling
    pos = torch.zeros((nblocks, 1), dtype=torch.int64, device=device)
    F = g
    jmax = min(innoise, rlen)                 # c >= 1 per sample
    while pos.shape[1] < jmax:
        pos = torch.cat([pos, torch.gather(F, 1, pos)], dim=1)
        if pos.shape[1] < jmax:
            F = torch.gather(F, 1, F)
    valid = pos < innoise                     # [nblocks, jmax]

    # outputs at every candidate start position, the sentinel's reads
    # clamped.  Where innoise < wp every start is innoise - wp < 0, and
    # each read follows the JAX package's gather on its line: _take's rule
    # for its take / take_along_axis, _clip's for its F2 / V2 indexing.
    qs = torch.clamp(pos, max=innoise - wp)
    w0s = _take(words, qs)
    fl0s = _take(t.luf, w0s, True)
    lu = _take(t.luv, w0s)                    # lu_val[w0]
    full = barrier_count_plain(stream, in_bits, wp, t.bw, base, starts=qs,
                               size=innoise).to(torch.int64)
    if lu_depth == 1:
        out = torch.where(fl0s, full, lu)
    else:
        s0 = _take(t.slot, w0s)
        at = (_clip(s0, t.F2.shape[0]), _clip(_take(words, qs + 1),
                                              t.F2.shape[1]))
        out = torch.where(~fl0s, lu,
                          torch.where(t.F2[at], full,
                                      t.V2[at].to(torch.int64)))

    # first rlen valid samples in block-major order; index rlen is the drop
    # slot of the scatter
    flat_valid = valid.reshape(-1)
    flat_out = out.reshape(-1) * amp
    idx = torch.cumsum(flat_valid.to(torch.int64), 0) - 1
    selected = flat_valid & (idx < rlen)
    tgt = torch.where(selected, idx, rlen)
    noise = torch.zeros((rlen + 1,), dtype=torch.int64, device=device)
    noise = noise.scatter(0, tgt, flat_out)[:rlen]
    vals = torch.where(noise[None, :] < 0, p.reshape(-1, 1) + noise[None, :],
                       noise[None, :]).to(dtype)
    # fills the HOST would make: the initial one plus one refill per
    # selected sample whose successor hits the sentinel (the host refills
    # inside the loop body, even after the final sample)
    succ = torch.gather(g, 1, torch.clamp(pos, max=innoise))
    trip = (succ == innoise).reshape(-1)
    fills = 1 + (selected & trip).sum()
    return vals, torch.stack([fills, nonce_add(nonce, fills)])


def _gaussian_exact(ring: Ring, key: bytes, nonce, mode: gaussian, device,
                    tables):
    """device_gaussian_exact's residues and its int64 [2] (fills, nonce +
    fills) on the device: S4 on a CUDA device, else its twin."""
    with profiling.span("sampler"):
        fg = mode.fg_prng
        wp = fg.word_precision
        rlen = ring.degree
        innoise = int(np.float32(rlen) * np.float32(fg.innoise_multiplier))
        # static block budget: each refill block yields at least
        # floor((innoise - wp)/wp) samples (worst case wp words per sample)
        s_min = max(1, (innoise - wp) // wp)
        nblocks = -(-rlen // s_min)
        t = tables if tables is not None else gaussian_tables(fg, device, True)
        args = (key, nonce, rlen, innoise, nblocks, fg.in_bits, wp,
                fg.lu_depth, t, fg.base_value, int(mode.amplifier),
                _p_col(ring, device), ring.torch_dtype)
        if t.bw.is_cuda:
            from .._kernels import GAUSSIAN_EXACT
            return GAUSSIAN_EXACT(*args)
        return gaussian_exact_plain(*args)


def device_gaussian_exact(ring: Ring, key: bytes, nonce, mode: gaussian,
                          return_fills: bool = False, device=DEFAULT_DEVICE,
                          tables=None):
    """STREAM-EXACT device Gaussian: same (key, nonce) => bit-identical
    outputs to the host walk (prng/gaussian.py _get_noise_py, reference
    FastGaussianNoise.hpp:478-595), including its data-dependent per-sample
    word consumption (1, 2 or word_precision words) and its
    refill-and-discard block policy (see gaussian_exact_plain).

    On a CUDA device the call is S4: one launch of its walk (a block a
    refill block: keystream, successor table, pointer doubling and the
    samples, on chip) and one of its selection.  `nonce` may be a Python
    int or a 0-d int64 tensor on the device, and `return_fills=True`
    additionally returns the number of fill() calls the host walk would
    have made, as a 0-d int64 tensor on the device, so exact samplers
    CHAIN with bit-identical results to sequential host draws without a
    host read (apps/lwe.py's exact on-device pipeline).  `tables`:
    gaussian_tables(fg, device, exact=True), built here when not given."""
    vals, fills = _gaussian_exact(ring, key, nonce, mode, device, tables)
    return (vals, fills[0]) if return_fills else vals


def _umod(x, k):
    """x mod k for int64 tensors x read as unsigned 64-bit words and
    0 < k < 2^31, from the two 32-bit halves"""
    hi = modops.srl(x, 32)
    lo = x & 0xFFFFFFFF
    return (((hi % k) << 32) | lo) % k


def _hwt_positions_from_words(W, n: int, h: int, amb_cap: int):
    """Core of the stream-exact hwt walk: given the budgeted reservoir word
    stream W ([Wtot] int64 holding uint64 words, consumption order),
    reproduce the host rejection-sampled reservoir (sampling.sample_hwt,
    reference core.hpp:352-391) exactly and return (order, fills_res, ok):
      order     [h] int64, the sorted final reservoir (hit positions);
      fills_res 0-d int64, how many h-word fill() calls the host consumed;
      ok        0-d bool, False when either budget assumption is exceeded
                (more than `amb_cap` ambiguous words, or fewer than n - h
                accepted words in the budgeted stream; each has probability
                ~2^-44 per word), so callers poison the output instead of
                silently diverging from the host stream.
    All three stay on W's device.

    The host walk is sequential, but every pop consumes exactly ONE word,
    and a word can only be REJECTED when w > M - (M mod k) with (M mod k)
    < k <= n, i.e. in the top < n values of the 2^64 range.  Words with
    w <= M - n are accepted at ANY k, so the k-counter at word i is h + i
    minus the rejections before it; the at-most-a-handful ambiguous words
    are resolved exactly, in order, by `amb_cap` O(1) tensor steps (the JAX
    package's fori_loop; each rejection shifts every later word's k down
    by one)."""
    Wtot = int(W.shape[0])
    dev = W.device
    M = torch.full((), -1, dtype=torch.int64, device=dev)  # 2^64 - 1
    # superset of every possibly-rejectable word: rejection needs
    # w > M - (M mod k) >= M - (n - 2)
    amb = modops.ult(M - n, W)
    amb_count = amb.sum()
    iota = torch.arange(Wtot, dtype=torch.int64, device=dev)
    big = Wtot
    amb_idx = torch.sort(torch.where(amb, iota, big)).values[:amb_cap]

    rejected = torch.zeros((Wtot + 1,), dtype=torch.bool, device=dev)
    rejcount = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(amb_idx.shape[0]):
        i = amb_idx[j:j + 1]
        valid = i < big
        ic = torch.clamp(i, max=big - 1)
        w = W.index_select(0, ic)
        # k at word i = h + #accepts before i = h + i - #rejects before i;
        # all rejected words are ambiguous, so rejcount IS that count
        k = h + ic - rejcount
        kc = torch.clamp(k, 1, max(n - 1, 1))
        rej = valid & modops.ult(M - _umod(M, kc), w)
        rejected = rejected.index_put((i,), rej)
        rejcount = rejcount + rej.to(torch.int64).reshape(())
    accepted = ~rejected[:Wtot]
    acc = accepted.to(torch.int64)
    acc_excl = torch.cumsum(acc, 0) - acc             # #accepts before i
    k = h + acc_excl
    consumed = acc_excl < (n - h)                     # popped by the host
    upd = consumed & accepted
    pos = _umod(W, torch.clamp(k, min=1))
    write = upd & (pos < h)
    tgt = torch.where(write, pos, h)                  # h = drop slot
    # hitted[p] = k of the LAST write to slot p (k strictly increases over
    # accepted words, so last == max), else its initial value p
    vals = torch.full((h + 1,), -1, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, tgt, k, reduce="amax")[:h]
    hitted = torch.where(vals >= 0, vals,
                         torch.arange(h, dtype=torch.int64, device=dev))
    order = torch.sort(hitted).values
    T = consumed.sum()                                # words popped
    fills_res = (T + h - 1) // h                      # ceil: refill-on-empty
    ok = (amb_count <= amb_cap) & (acc.sum() >= n - h)
    return order, fills_res, ok


def _pm_one(ring: Ring, hit, bit, device):
    """[m, n] storage: (p - 1) + bit where hit, else 0 (the reference's
    +-1 encoding, +1 as the non-canonical p + 1)"""
    vals = torch.where(hit[None, :], _p_col(ring, device) - 1 + bit[None, :],
                       0)
    return _to_storage(vals, ring)


def _hwt_h(ring: Ring, mode) -> int:
    h = int(mode.hwt)
    if not 0 < h <= ring.degree:
        raise ValueError("hwt must be in (0, degree]")
    return h


def _hwt_fills(n: int, h: int) -> int:
    """device_hwt_exact's budget of h-word fills: the n - h words of a walk
    without rejections, and ONE spare fill that absorbs any realistic
    rejection count"""
    return max(1, -(-(n - h) // h) + 1)


def device_hwt_exact(ring: Ring, key: bytes, nonce, mode,
                     return_fills: bool = False, _amb_cap: int = 8,
                     device=DEFAULT_DEVICE):
    """STREAM-EXACT device hwt_dist: same (key, nonce) => bit-identical
    output to the host walk (sampling.sample_hwt, reference
    core.hpp:352-391), including its variable rejection-loop word
    consumption and refill-on-empty policy (see _hwt_positions_from_words).

    Like the host, fill f reads the first h*8 bytes of the (nonce + f)
    stream, and the h sign words come from one more call AFTER the
    reservoir finishes, at a data-dependent nonce (nonce + fills_res, which
    stays on the device).  `return_fills=True` additionally returns the
    total nonce advance (reservoir fills + the sign call) as a 0-d device
    tensor, so exact samplers chain bit-identically to sequential host
    draws; when the budget guard trips, every residue is the out-of-range
    word 2^w - 1 and the advance is -1.  On a CUDA device the call is S6
    (_kernels.HWT_EXACT: the walk over many CTAs, whose last merges their
    reservoir, then the store); elsewhere its twin,
    device_hwt_exact_plain."""
    with profiling.span("sampler"):
        h = _hwt_h(ring, mode)
        p = _p_col(ring, device)
        if p.is_cuda:
            from .._kernels import HWT_EXACT
            out, adv = HWT_EXACT(key, nonce, p, ring.degree, h,
                                 ring.torch_dtype, _amb_cap)
        else:
            out, adv = device_hwt_exact_plain(ring, key, nonce, mode, True,
                                              _amb_cap, device)
        return (out, adv) if return_fills else out


def device_hwt_exact_plain(ring: Ring, key: bytes, nonce, mode,
                           return_fills: bool = False, _amb_cap: int = 8,
                           device=DEFAULT_DEVICE):
    """device_hwt_exact's plain twin on any device: every fill in one
    keystream_plain call, _hwt_positions_from_words and torch ops."""
    h = _hwt_h(ring, mode)
    fills = keystream_plain(key, nonce, (h * 8 + 63) // 64,
                            _hwt_fills(ring.degree, h), device)
    out, adv = hwt_exact_from_words(ring, key, nonce,
                                    _items(fills, 8)[:, :h].reshape(-1), h,
                                    _amb_cap, device)
    return (out, adv) if return_fills else out


def hwt_exact_from_words(ring: Ring, key: bytes, nonce, W, h: int,
                         amb_cap: int, device=DEFAULT_DEVICE):
    """The exact twin's residues and advance from its reservoir words W
    (int64 [_hwt_fills(n, h) * h], the keystream's or, in the tests, the
    words that S6's words-in instance takes); the signs are the keystream's
    at nonce + fills."""
    n = ring.degree
    order, fills_res, ok = _hwt_positions_from_words(W, n, h, amb_cap)
    signs = _stream_limbs(key, nonce_add(nonce, fills_res), h, 8, device)
    hit = torch.zeros((n,), dtype=torch.bool, device=W.device) \
        .index_fill(0, order, True)
    bitarr = torch.zeros((n,), dtype=torch.int64, device=W.device) \
        .index_put((order,), signs & 2)
    out = _pm_one(ring, hit, bitarr, device)
    # budget guard: poison every residue with the all-ones word (>= p,
    # fails any strict-mod/range check): loud instead of silent divergence
    out = torch.where(ok, out, torch.full_like(out, -1))
    return out, torch.where(ok, fills_res + 1, -1)


def device_hwt(ring: Ring, key: bytes, nonce, mode, device=DEFAULT_DEVICE):
    """Exact-Hamming-weight +-1 polynomial on device (reference
    core.hpp:352-391 semantics: h positions hit, signs from bit 1 of one
    64-bit word per hit, negatives encoded as p - 1).

    Fixed-consumption formulation (the dispatcher default; see
    device_hwt_exact for the stream-exact tier): the h-subset comes from a
    random-key argsort (the first h of n 64-bit keys in unsigned order,
    stable as jnp.argsort, = a uniform h-subset), consuming n + h words
    instead of the host's variable count: distribution-equal, not
    stream-exact.  On a CUDA device the call is S5 (_kernels.HWT_FIXED:
    the keys over many CTAs, the h smallest selected by the last among
    those below a threshold, then the store); elsewhere its twin,
    device_hwt_plain."""
    with profiling.span("sampler"):
        h = _hwt_h(ring, mode)
        p = _p_col(ring, device)
        if p.is_cuda:
            from .._kernels import HWT_FIXED
            return HWT_FIXED(key, nonce, p, ring.degree, h, ring.torch_dtype)
        return device_hwt_plain(ring, key, nonce, mode, device)


def device_hwt_plain(ring: Ring, key: bytes, nonce, mode,
                     device=DEFAULT_DEVICE):
    """device_hwt's plain twin on any device: keystream_plain's n + h
    words, a stable argsort and torch ops."""
    h = _hwt_h(ring, mode)
    n = ring.degree
    keys64 = _stream_limbs(key, nonce, n + h, 8, device)
    return hwt_fixed_from_keys(ring, keys64[:n], keys64[n:], device)


def hwt_fixed_from_keys(ring: Ring, keys, signs, device=DEFAULT_DEVICE):
    """The fixed twin's residues from its n keys and h sign words (int64,
    read as unsigned; the keystream's or, in the tests, the keys that S5's
    words-in instance takes)."""
    n, h = ring.degree, signs.shape[0]
    order = torch.argsort(keys ^ _SIGN, stable=True)
    hit = torch.zeros((n,), dtype=torch.bool, device=keys.device) \
        .index_fill(0, order[:h], True)
    # signs: one word per hit, assigned in ascending position order like
    # the host (hitted.sort() before the sign draw)
    rank = torch.cumsum(hit.to(torch.int64), 0) - 1   # position -> j
    bit = torch.where(hit, signs[torch.clamp(rank, 0, h - 1)] & 2, 0)
    return _pm_one(ring, hit, bit, device)
