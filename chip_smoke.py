#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (nfllib_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from nfllib_tpu_torch/csrc/, holds each
against its plain torch twin on the card, drives the main path (the R_q
product a*b through Poly: forward NTT, Shoup product, inverse NTT) at the
bench shape n = 2^14 x 17 u32 moduli, batch 64, checks the result against
the twins and exact Python-int arithmetic, checks strict mode, and times
the kernels against their twins with CUDA events.  Every phase prints one
line; any failure raises and exits nonzero.  The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels.

It imports nothing of JAX.  Without CUDA, or without the port beside it,
it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

BENCH = ("u32", 16384, 510, 64)          # limb, degree, modulus bits, batch
SHAPES = [("u32", 8, 60, 3), ("u16", 128, 14, 3), ("u16", 512, 14, 3),
          ("u32", 1024, 60, 3), ("u32", 4096, 60, 3), ("u32", 32768, 60, 3),
          BENCH]
TIMING_RUNS = 25
REPLACES = {"ntt_fused_fwd": "nfllib_tpu/ops/ntt_mxu.py:547",
            "ntt_fused_inv": "nfllib_tpu/ops/ntt_mxu.py:723"}
SOURCE = "nfllib_tpu_torch/csrc/ntt_fused.cu"


def expect(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def rand_residues(ring, rng, batch):
    m, n = ring.nmoduli, ring.degree
    out = np.empty((batch, m, n), dtype=np.uint64)
    for cm in range(m):
        out[:, cm, :] = rng.integers(0, int(ring.moduli[cm]), size=(batch, n),
                                     dtype=np.uint64)
    return out.astype(ring.dtype)


def unsigned(t, ring):
    """storage tensor -> int64 unsigned limb values"""
    return t.to("cpu").numpy().view(ring.dtype).astype(np.int64)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import _kernels, debug, oracle
    from nfllib_tpu_torch.ops import modops, ntt, ntt_mxu
    from nfllib_tpu_torch.prng import Salsa20Stream

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    expect(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]

    # 1. device
    print(f"device: {kind}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    print(card)

    # 2. build
    t0 = time.perf_counter()
    lib = _kernels.library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{lib.build_seconds:.1f} s) -> {lib.path.name}; ptxas: "
          f"{' | '.join(ptxas)}")

    # 3. each kernel against its twin, exact equality
    rng = np.random.default_rng(2024)
    err = {k.name: 0 for k in _kernels.KERNELS}
    before = {k.name: k.launches for k in _kernels.KERNELS}
    for limb, degree, bits, batch in SHAPES:
        ring = nfl.ring_from_modulus(limb, degree, bits)
        ctx = ring.context()
        x = nfl.Poly.from_numpy(ring, rand_residues(ring, rng, batch), dev)
        f = ntt_mxu.ntt_pow_phi_fused(x.data, ctx)
        f_plain = ntt_mxu.ntt_pow_phi_fused_plain(x.data, ctx)
        tabs = ctx.to(dev)
        f_harvey = ntt.ntt(modops.mulmod_shoup(
            x.data, tabs.phis, tabs.shoupphis, tabs.p_col), ctx)
        g = ntt_mxu.invntt_pow_invphi_fused(f, ctx)
        g_plain = ntt_mxu.invntt_pow_invphi_fused_plain(f, ctx)
        torch.cuda.synchronize()
        e_fwd = int(np.abs(unsigned(f, ring) - unsigned(f_plain, ring)).max())
        e_inv = int(np.abs(unsigned(g, ring) - unsigned(g_plain, ring)).max())
        err["ntt_fused_fwd"] = max(err["ntt_fused_fwd"], e_fwd)
        err["ntt_fused_inv"] = max(err["ntt_fused_inv"], e_inv)
        expect(e_fwd == 0, f"K1 != twin at {limb} n={degree}")
        expect(e_inv == 0, f"K2 != twin at {limb} n={degree}")
        expect(torch.equal(f, f_harvey), f"K1 != Harvey at {limb} n={degree}")
        expect(torch.equal(g, x.data), f"K2(K1(x)) != x at {limb} n={degree}")
        print(f"kernels vs twins: {limb} n={degree} m={ring.nmoduli} "
              f"batch={batch}: fwd and inv exact, round trip exact")
    grew = {k.name: k.launches - before[k.name] for k in _kernels.KERNELS}
    expect(all(v >= len(SHAPES) for v in grew.values()),
           f"launch counters did not grow: {grew}")
    print(f"launch counters grew: {grew}")

    # 4. the main path through Poly at the bench shape
    limb, degree, bits, batch = BENCH
    ring = nfl.ring_from_modulus(limb, degree, bits)
    ctx = ring.context()
    stream = Salsa20Stream(bytes(range(32)))

    def sample_batch(r, count):
        rows = [nfl.Poly.sample(r, nfl.uniform(), stream).data
                for _ in range(count)]
        return nfl.Poly(torch.stack(rows).to(dev), r)

    a, b = sample_batch(ring, batch), sample_batch(ring, batch)
    torch.cuda.synchronize()
    for k in _kernels.KERNELS:
        k.launches = 0
    fa, fb = a.ntt_pow_phi(), b.ntt_pow_phi()
    c = nfl.shoup(fa * fb, nfl.compute_shoup(fb)).invntt_pow_invphi()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    expect(all(v > 0 for v in launches.values()),
           f"main path skipped a kernel: {launches}")
    expect(c.data.shape == (batch, ring.nmoduli, degree)
           and c.data.dtype == torch.int32 and c.data.is_cuda,
           f"product has shape {tuple(c.data.shape)} {c.data.dtype}")
    pa = ntt_mxu.ntt_pow_phi_fused_plain(a.data, ctx)
    pb = ntt_mxu.ntt_pow_phi_fused_plain(b.data, ctx)
    p_col = ctx.to(dev).p_col
    pc = ntt_mxu.invntt_pow_invphi_fused_plain(modops.mulmod_shoup(
        pa, pb, modops.compute_shoup(pb, p_col), p_col), ctx)
    expect(torch.equal(c.data, pc), "product != twin path")
    av, bv, cv = (unsigned(t.data, ring) for t in (a, b, c))
    n = degree
    for j in range(16):
        bi, ch, k = (j * 5) % batch, (j * 7) % ring.nmoduli, (j * 1021 + 3) % n
        p = int(ring.moduli[ch])
        ar = av[bi, ch].astype(object)
        br = bv[bi, ch].astype(object)
        want = (int(np.dot(ar[:k + 1], br[k::-1]))
                - int(np.dot(ar[k + 1:], br[:k:-1]))) % p
        expect(int(cv[bi, ch, k]) == want,
               f"c[{bi},{ch},{k}] = {cv[bi, ch, k]} != {want}")
    small = nfl.ring_from_modulus("u32", 64, 60)
    sa, sb = sample_batch(small, 2), sample_batch(small, 2)
    sfb = sb.ntt_pow_phi()
    sc = nfl.shoup(sa.ntt_pow_phi() * sfb,
                   nfl.compute_shoup(sfb)).invntt_pow_invphi()
    for i in range(2):
        want = oracle.negacyclic_mul_schoolbook(
            sa.numpy()[i], sb.numpy()[i], small)
        expect(np.array_equal(sc.numpy()[i], want), "schoolbook mismatch")
    expect(a.ntt_pow_phi().invntt_pow_invphi() == a, "round trip of a")
    print(f"main path: c = a*b at n={degree} m={ring.nmoduli} batch={batch}:"
          f" equals twin path, 16 Python-int coefficients, schoolbook at "
          f"n=64 m=2, round trip; launches {launches}")

    # 5. strict mode
    debug.set_strictmod(True)
    try:
        bad = a.data.clone()
        bad[0, 0, 0] = int(ring.moduli[0])
        try:
            ntt.ntt_pow_phi(bad, ctx)
            raised = False
        except AssertionError:
            raised = True
        expect(raised, "strict mode let a residue >= p through")
        # a twiddle that disagrees with its Shoup companion breaks the
        # twiddle's [0, 2p) contract
        t = ntt_mxu.fused_tables(ring, False, dev)
        broken = dataclasses.replace(t, tw=torch.full_like(t.tw, 0x7FFFFFFF))
        x3 = a.data[:2].contiguous()
        poisoned = _kernels.NTT_FUSED_FWD(x3, broken, True)
        twin = ntt_mxu.ntt_pow_phi_fused_plain(x3, ctx, tables=broken)
        expect(torch.equal(poisoned, twin) and bool((poisoned == -1).all()),
               "kernel poison differs from the twin's")
    finally:
        debug.set_strictmod(False)
    print("strict mode: out-of-range input raises; broken-contract poison "
          "matches the twin")

    # 6. timing at the bench shape, CUDA events, kernel and twin in turns
    x = a.data
    fwd_in = fa.data

    def timed(fn, arg):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        fn(arg, ctx)
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    cases = {
        "ntt_fused_fwd": (ntt_mxu.ntt_pow_phi_fused,
                          ntt_mxu.ntt_pow_phi_fused_plain, x),
        "ntt_fused_inv": (ntt_mxu.invntt_pow_invphi_fused,
                          ntt_mxu.invntt_pow_invphi_fused_plain, fwd_in),
    }
    times = {}
    for name, (kern, plain, arg) in cases.items():
        for _ in range(3):
            timed(kern, arg)
            timed(plain, arg)
        tk, tp = [], []
        for i in range(TIMING_RUNS):
            order = ((kern, tk), (plain, tp)) if i % 2 == 0 \
                else ((plain, tp), (kern, tk))
            for fn, acc in order:
                acc.append(timed(fn, arg))
        times[name] = (statistics.median(tk), statistics.median(tp))
        rate = batch * ring.nmoduli / (times[name][0] * 1e-3)
        print(f"timing {name}: kernel {times[name][0]:.4f} ms "
              f"({rate:.0f} channel-NTT/s), twin {times[name][1]:.4f} ms, "
              f"median of {TIMING_RUNS}, n={degree} m={ring.nmoduli} "
              f"batch={batch} | {card}")

    # 7. result
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": times[name][0],
         "plain_ms": times[name][1]} for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
