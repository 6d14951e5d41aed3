#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (nfllib_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from nfllib_tpu_torch/csrc/ (one nvcc
per source, all started together), holds each against its plain torch twin
on the card, and drives the main paths through Poly, each with the launch
counters set to 0 just before it and read just after:
  * u32: the R_q product a*b (forward NTT, Shoup product, inverse NTT) at
    n = 2^14 x 17 u32 moduli, batch 64 (kernels K1, K2);
  * u64: the same product at n = 2^14 x 8 62-bit moduli (a 496-bit q),
    batch 64 (K4), and at n = 2^20 x 2 moduli, batch 2 (K5);
and checks the results against the twins, exact Python-int arithmetic, the
CRT-lifted 496-bit big-integer product and the schoolbook oracle.  It then
checks strict mode and times the kernels against their twins with CUDA
events.  Every phase prints one line; any failure raises and exits
nonzero.  The last line is {"ok": true, "device": {...}}; the line before
it lists the kernels.

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
BENCH64 = (16384, 496, 64)               # degree, modulus bits, batch
SHAPES64 = [(8, 124, 3), (64, 124, 3), (256, 62, 3), (8192, 124, 3),
            (32768, 124, 3), (65536, 62, 3), BENCH64]
LARGE64 = [(1 << 17, 62, 2), (1 << 20, 124, 2)]
LARGE_MAIN = (1 << 20, 124, 2)           # degree, modulus bits, batch
DFT_SIZES = (8, 128, 1024)
TIMING_RUNS = 25
KERNELS = {   # name: (source, TPU kernel it replaces)
    "ntt_fused_fwd": ("nfllib_tpu_torch/csrc/ntt_fused.cu",
                      "nfllib_tpu/ops/ntt_mxu.py:547"),
    "ntt_fused_inv": ("nfllib_tpu_torch/csrc/ntt_fused.cu",
                      "nfllib_tpu/ops/ntt_mxu.py:723"),
    "ntt_fused64_fwd": ("nfllib_tpu_torch/csrc/ntt_fused64.cu",
                        "nfllib_tpu/ops/ntt_mxu_u64.py:274"),
    "ntt_fused64_inv": ("nfllib_tpu_torch/csrc/ntt_fused64.cu",
                        "nfllib_tpu/ops/ntt_mxu_u64.py:274"),
    "dft_mxu64": ("nfllib_tpu_torch/csrc/dft_mxu64.cu",
                  "nfllib_tpu/ops/dft_mxu.py:317"),
}


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


def rand_slab(ring, rng, shape, dev):
    """[B, m, r, c] canonical u64 residues on `dev`"""
    import torch
    out = np.empty(shape, dtype=np.uint64)
    for cm in range(ring.nmoduli):
        out[:, cm] = rng.integers(0, int(ring.moduli[cm]),
                                  size=(shape[0],) + shape[2:],
                                  dtype=np.uint64)
    return torch.from_numpy(out.view(np.int64)).to(dev)


def unsigned(t, ring):
    """storage tensor -> unsigned limb values as a numpy array"""
    return t.to("cpu").numpy().view(ring.dtype)


def max_err(a, b, ring):
    """max |a - b| over the unsigned limb values (exact)."""
    import torch
    if torch.equal(a, b):
        return 0
    d = unsigned(a, ring).astype(object) - unsigned(b, ring).astype(object)
    return int(np.abs(d).max())


def negacyclic_coeff(ar, br, k, mod):
    """coefficient k of a*b mod (X^n + 1, mod) from Python-int rows"""
    return (int(np.dot(ar[:k + 1], br[k::-1]))
            - int(np.dot(ar[k + 1:], br[:k:-1]))) % mod


def check_coeffs(a, b, c, ring, count):
    """`count` coefficients of c = a*b across channels and batch against
    exact Python-int negacyclic convolution"""
    av, bv, cv = (unsigned(t.data, ring) for t in (a, b, c))
    batch, n = av.shape[0], ring.degree
    for j in range(count):
        bi, ch, k = (j * 5) % batch, (j * 7) % ring.nmoduli, \
            (j * 1021 + 3) % n
        want = negacyclic_coeff(av[bi, ch].astype(object),
                                bv[bi, ch].astype(object), k,
                                int(ring.moduli[ch]))
        expect(int(cv[bi, ch, k]) == want,
               f"c[{bi},{ch},{k}] = {cv[bi, ch, k]} != {want}")


def product(nfl, a, b):
    fb = b.ntt_pow_phi()
    return nfl.shoup(a.ntt_pow_phi() * fb,
                     nfl.compute_shoup(fb)).invntt_pow_invphi()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import _kernels, crt, debug, oracle
    from nfllib_tpu_torch.ops import dft_mxu, modops, ntt, ntt_mxu, \
        ntt_mxu_u64
    from nfllib_tpu_torch.prng import Salsa20Stream

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    expect(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    k_by_name = {k.name: k for k in _kernels.KERNELS}
    expect(set(k_by_name) == set(KERNELS), f"kernels: {sorted(k_by_name)}")

    # 1. device
    print(f"device: {kind}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    print(card)

    # 2. build
    t0 = time.perf_counter()
    lib = _kernels.library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, parallel "
          f"{lib.build_seconds:.1f} s) -> {lib.path.name}; ptxas: "
          f"{' | '.join(ptxas)}")

    err = {name: 0 for name in KERNELS}

    def harvey(x, ctx):
        tabs = ctx.to(dev)
        return ntt.ntt(modops.mulmod_shoup(x, tabs.phis, tabs.shoupphis,
                                           tabs.p_col), ctx)

    # 3. K1/K2 against their twins, exact equality
    rng = np.random.default_rng(2024)
    u32_kernels = ("ntt_fused_fwd", "ntt_fused_inv")
    before = {name: k_by_name[name].launches for name in u32_kernels}
    for limb, degree, bits, batch in SHAPES:
        ring = nfl.ring_from_modulus(limb, degree, bits)
        ctx = ring.context()
        x = nfl.Poly.from_numpy(ring, rand_residues(ring, rng, batch), dev)
        f = ntt_mxu.ntt_pow_phi_fused(x.data, ctx)
        f_plain = ntt_mxu.ntt_pow_phi_fused_plain(x.data, ctx)
        g = ntt_mxu.invntt_pow_invphi_fused(f, ctx)
        g_plain = ntt_mxu.invntt_pow_invphi_fused_plain(f, ctx)
        torch.cuda.synchronize()
        e_fwd, e_inv = max_err(f, f_plain, ring), max_err(g, g_plain, ring)
        err["ntt_fused_fwd"] = max(err["ntt_fused_fwd"], e_fwd)
        err["ntt_fused_inv"] = max(err["ntt_fused_inv"], e_inv)
        expect(e_fwd == 0, f"K1 != twin at {limb} n={degree}")
        expect(e_inv == 0, f"K2 != twin at {limb} n={degree}")
        expect(torch.equal(f, harvey(x.data, ctx)),
               f"K1 != Harvey at {limb} n={degree}")
        expect(torch.equal(g, x.data), f"K2(K1(x)) != x at {limb} n={degree}")
        print(f"K1/K2 vs twins: {limb} n={degree} m={ring.nmoduli} "
              f"batch={batch}: fwd and inv exact, equal to Harvey, "
              f"round trip exact")
    grew = {name: k_by_name[name].launches - before[name]
            for name in u32_kernels}
    expect(all(v >= len(SHAPES) for v in grew.values()),
           f"launch counters did not grow: {grew}")
    print(f"launch counters grew: {grew}")

    # 4. K4 against its twin, exact equality, and against plain Harvey
    for degree, bits, batch in SHAPES64:
        ring = nfl.ring_from_modulus("u64", degree, bits)
        ctx = ring.context()
        x = nfl.Poly.from_numpy(ring, rand_residues(ring, rng, batch), dev)
        f = ntt_mxu_u64.ntt_pow_phi_fused(x.data, ctx)
        f_plain = ntt_mxu_u64.ntt_pow_phi_fused_plain(x.data, ctx)
        g = ntt_mxu_u64.invntt_pow_invphi_fused(f, ctx)
        g_plain = ntt_mxu_u64.invntt_pow_invphi_fused_plain(f, ctx)
        torch.cuda.synchronize()
        e_fwd, e_inv = max_err(f, f_plain, ring), max_err(g, g_plain, ring)
        err["ntt_fused64_fwd"] = max(err["ntt_fused64_fwd"], e_fwd)
        err["ntt_fused64_inv"] = max(err["ntt_fused64_inv"], e_inv)
        expect(e_fwd == 0, f"K4 fwd != twin at n={degree} bits={bits}")
        expect(e_inv == 0, f"K4 inv != twin at n={degree} bits={bits}")
        expect(torch.equal(f, harvey(x.data, ctx)),
               f"K4 != Harvey at n={degree} bits={bits}")
        expect(torch.equal(g, x.data), f"K4 round trip at n={degree}")
        print(f"K4 vs twins: u64 n={degree} m={ring.nmoduli} batch={batch}: "
              f"fwd and inv exact, equal to Harvey, round trip exact")

    # 5. K5 against its twin: matmul_mod on both axes, then _large_run64
    ring = nfl.ring_from_modulus("u64", LARGE_MAIN[0], LARGE_MAIN[1])
    for size in DFT_SIZES:
        for axis in (-2, -1):
            shape = (2, 2, size, 96) if axis == -2 else (2, 2, 96, size)
            xs = rand_slab(ring, rng, shape, dev)
            out = dft_mxu.matmul_mod(xs, ring, "dft_fwd", size, axis=axis)
            plain = dft_mxu.matmul_mod_plain(xs, ring, "dft_fwd", size,
                                             axis=axis)
            torch.cuda.synchronize()
            e = max_err(out, plain, ring)
            err["dft_mxu64"] = max(err["dft_mxu64"], e)
            expect(e == 0, f"K5 != twin at size {size} axis {axis}")
    print(f"K5 vs twin: matmul_mod dft_fwd sizes {DFT_SIZES} on both axes "
          f"exact")
    for degree, bits, batch in LARGE64:
        ring = nfl.ring_from_modulus("u64", degree, bits)
        ctx = ring.context()
        x = nfl.Poly.from_numpy(ring, rand_residues(ring, rng, batch), dev)
        f = ntt_mxu_u64._large_run64(x.data, ctx, False)
        f_plain = ntt_mxu_u64._large_run64(x.data, ctx, False, plain=True)
        g = ntt_mxu_u64._large_run64(f, ctx, True)
        g_plain = ntt_mxu_u64._large_run64(f, ctx, True, plain=True)
        torch.cuda.synchronize()
        expect(torch.equal(f, f_plain), f"_large_run64 fwd != twin n={degree}")
        expect(torch.equal(g, g_plain), f"_large_run64 inv != twin n={degree}")
        expect(torch.equal(g, x.data), f"_large_run64 round trip n={degree}")
        if degree == 1 << 17:
            expect(torch.equal(f, harvey(x.data, ctx)),
                   "_large_run64 != Harvey at 2^17")
        print(f"K5 via _large_run64: u64 n={degree} m={ring.nmoduli} "
              f"batch={batch}: fwd and inv equal the twins, round trip exact"
              + (", equal to Harvey" if degree == 1 << 17 else ""))

    launches = {}

    def drive(names, fn):
        """run fn with every launch counter at 0; keep `names`' counts"""
        torch.cuda.synchronize()
        for k in _kernels.KERNELS:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {name: k_by_name[name].launches for name in names}
        expect(all(v > 0 for v in got.values()),
               f"main path skipped a kernel: {got}")
        launches.update(got)
        return out

    def sample_batch(r, count, stream):
        rows = [nfl.Poly.sample(r, nfl.uniform(), stream).data
                for _ in range(count)]
        return nfl.Poly(torch.stack(rows).to(dev), r)

    # 6. the u32 main path through Poly at the bench shape
    limb, degree, bits, batch = BENCH
    ring = nfl.ring_from_modulus(limb, degree, bits)
    ctx = ring.context()
    stream = Salsa20Stream(bytes(range(32)))
    a, b = sample_batch(ring, batch, stream), sample_batch(ring, batch, stream)
    c = drive(u32_kernels, lambda: product(nfl, a, b))
    expect(c.data.shape == (batch, ring.nmoduli, degree)
           and c.data.dtype == torch.int32 and c.data.is_cuda,
           f"product has shape {tuple(c.data.shape)} {c.data.dtype}")
    pa = ntt_mxu.ntt_pow_phi_fused_plain(a.data, ctx)
    pb = ntt_mxu.ntt_pow_phi_fused_plain(b.data, ctx)
    p_col = ctx.to(dev).p_col
    pc = ntt_mxu.invntt_pow_invphi_fused_plain(modops.mulmod_shoup(
        pa, pb, modops.compute_shoup(pb, p_col), p_col), ctx)
    expect(torch.equal(c.data, pc), "u32 product != twin path")
    check_coeffs(a, b, c, ring, 16)
    small = nfl.ring_from_modulus("u32", 64, 60)
    sa, sb = sample_batch(small, 2, stream), sample_batch(small, 2, stream)
    sc = product(nfl, sa, sb)
    for i in range(2):
        want = oracle.negacyclic_mul_schoolbook(
            sa.numpy()[i], sb.numpy()[i], small)
        expect(np.array_equal(sc.numpy()[i], want), "schoolbook mismatch")
    expect(a.ntt_pow_phi().invntt_pow_invphi() == a, "round trip of a")
    print(f"main path u32: c = a*b at n={degree} m={ring.nmoduli} "
          f"batch={batch}: equals twin path, 16 Python-int coefficients, "
          f"schoolbook at n=64 m=2, round trip; launches "
          f"{ {n: launches[n] for n in u32_kernels} }")
    u32_state = (ring, ctx, a, c)

    # 7. the u64 main path through Poly at n = 2^14 x 8 x 62-bit (496-bit q)
    u64_kernels = ("ntt_fused64_fwd", "ntt_fused64_inv")
    degree, bits, batch = BENCH64
    ring64 = nfl.ring_from_modulus("u64", degree, bits)
    ctx64 = ring64.context()
    stream = Salsa20Stream(bytes(range(32)))
    a64 = sample_batch(ring64, batch, stream)
    b64 = sample_batch(ring64, batch, stream)
    c64 = drive(u64_kernels, lambda: product(nfl, a64, b64))
    expect(c64.data.shape == (batch, ring64.nmoduli, degree)
           and c64.data.dtype == torch.int64 and c64.data.is_cuda,
           f"u64 product has shape {tuple(c64.data.shape)} {c64.data.dtype}")
    tabs = ctx64.to(dev)
    pa = ntt_mxu_u64.ntt_pow_phi_fused_plain(a64.data, ctx64)
    pb = ntt_mxu_u64.ntt_pow_phi_fused_plain(b64.data, ctx64)
    pc = ntt_mxu_u64.invntt_pow_invphi_fused_plain(modops.mulmod_shoup(
        pa, pb, modops.compute_shoup(pb, tabs.p_col, tabs.shoup_f),
        tabs.p_col), ctx64)
    expect(torch.equal(c64.data, pc), "u64 product != twin path")
    check_coeffs(a64, b64, c64, ring64, 16)
    i = 37
    A, B, C = (crt.poly2mpz(nfl.Poly(t.data[i].cpu(), ring64))
               for t in (a64, b64, c64))
    q = ctx64.moduli_product
    expect(q.bit_length() == 496, f"q has {q.bit_length()} bits")
    Ao, Bo = np.array(A, dtype=object), np.array(B, dtype=object)
    for k in (0, 1, degree // 2 - 1, degree - 1):
        expect(C[k] == negacyclic_coeff(Ao, Bo, k, q),
               f"CRT-lifted coefficient {k} != the 496-bit product")
    buf = nfl.serialize_poly(c64)
    expect(len(buf) == batch * ring64.nmoduli * degree * 8, "serialized size")
    expect(nfl.deserialize_poly(ring64, buf, batch=(batch,), device=dev)
           == c64, "serialize round trip")
    small = nfl.ring_from_modulus("u64", 32, 124)
    sa, sb = sample_batch(small, 2, stream), sample_batch(small, 2, stream)
    sc = product(nfl, sa, sb)
    for j in range(2):
        want = oracle.negacyclic_mul_schoolbook(
            sa.numpy()[j], sb.numpy()[j], small)
        expect(np.array_equal(sc.numpy()[j], want), "u64 schoolbook mismatch")
    expect(a64.ntt_pow_phi().invntt_pow_invphi() == a64, "u64 round trip")
    print(f"main path u64: c = a*b at n={degree} m={ring64.nmoduli} "
          f"batch={batch}: equals twin path, 16 Python-int coefficients, 4 "
          f"coefficients of the CRT-lifted 496-bit product, serialize round "
          f"trip, schoolbook at n=32 m=2, round trip; launches "
          f"{ {n: launches[n] for n in u64_kernels} }")

    # 8. the u64 main path at n = 2^20 x 2 moduli, batch 2 (K5 twice a way)
    degree, bits, batch = LARGE_MAIN
    ringL = nfl.ring_from_modulus("u64", degree, bits)
    ctxL = ringL.context()
    aL = sample_batch(ringL, batch, stream)
    bL = sample_batch(ringL, batch, stream)
    cL = drive(("dft_mxu64",), lambda: product(nfl, aL, bL))
    expect(cL.data.shape == (batch, ringL.nmoduli, degree),
           "large product shape")
    check_coeffs(aL, bL, cL, ringL, 8)
    expect(aL.ntt_pow_phi().invntt_pow_invphi() == aL, "large round trip")
    print(f"main path u64: c = a*b at n={degree} m={ringL.nmoduli} "
          f"batch={batch}: 8 Python-int coefficients, round trip; launches "
          f"{ {'dft_mxu64': launches['dft_mxu64']} }")

    # 9. strict mode
    ring, ctx, a, c = u32_state
    debug.set_strictmod(True)
    try:
        for r_, ctx_, x_, kern, mod, bad_tw in (
                (ring, ctx, a.data, _kernels.NTT_FUSED_FWD, ntt_mxu,
                 0x7FFFFFFF),
                (ring64, ctx64, a64.data, _kernels.NTT_FUSED64_FWD,
                 ntt_mxu_u64, (1 << 63) - 1)):
            bad = x_.clone()
            bad[0, 0, 0] = int(r_.moduli[0])
            try:
                ntt.ntt_pow_phi(bad, ctx_)
                raised = False
            except AssertionError:
                raised = True
            expect(raised, f"strict mode let a {r_.limb} residue p through")
            # a twiddle that disagrees with its Shoup companion breaks the
            # twiddle's [0, 2p) contract
            if mod is ntt_mxu:
                t = ntt_mxu.fused_tables(r_, False, dev)
            else:
                t = ntt_mxu_u64.fused_tables64(r_, False, dev)
            broken = dataclasses.replace(t, tw=torch.full_like(t.tw, bad_tw))
            x3 = x_[:2].contiguous()
            poisoned = kern(x3, broken, True)
            twin = mod.ntt_pow_phi_fused_plain(x3, ctx_, tables=broken)
            expect(torch.equal(poisoned, twin)
                   and bool((poisoned == -1).all()),
                   f"{kern.name} poison differs from the twin's")
    finally:
        debug.set_strictmod(False)
    print("strict mode: a residue equal to p raises (u32, u64); "
          "broken-contract poison of K1 and K4 matches the twins")

    # 10. timing, CUDA events, kernel and twin in turns
    def timed(fn, arg):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        fn(arg)
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def compare(kern, plain, arg):
        for _ in range(3):
            timed(kern, arg)
            timed(plain, arg)
        tk, tp = [], []
        for j in range(TIMING_RUNS):
            order = ((kern, tk), (plain, tp)) if j % 2 == 0 \
                else ((plain, tp), (kern, tk))
            for fn, acc in order:
                acc.append(timed(fn, arg))
        return statistics.median(tk), statistics.median(tp)

    n1, n2 = ntt_mxu_u64._geometry(ringL.degree)
    bench32 = f"n={ring.degree} m={ring.nmoduli} u32 batch={BENCH[3]}"
    bench64 = f"n={ring64.degree} m={ring64.nmoduli} u64 batch={BENCH64[2]}"
    xL = aL.data.reshape(batch, ringL.nmoduli, n1, n2)
    cases = {
        "ntt_fused_fwd": (
            lambda v: ntt_mxu.ntt_pow_phi_fused(v, ctx),
            lambda v: ntt_mxu.ntt_pow_phi_fused_plain(v, ctx),
            a.data, ring, BENCH[3], bench32),
        "ntt_fused_inv": (
            lambda v: ntt_mxu.invntt_pow_invphi_fused(v, ctx),
            lambda v: ntt_mxu.invntt_pow_invphi_fused_plain(v, ctx),
            c.data, ring, BENCH[3], bench32),
        "ntt_fused64_fwd": (
            lambda v: ntt_mxu_u64.ntt_pow_phi_fused(v, ctx64),
            lambda v: ntt_mxu_u64.ntt_pow_phi_fused_plain(v, ctx64),
            a64.data, ring64, BENCH64[2], bench64),
        "ntt_fused64_inv": (
            lambda v: ntt_mxu_u64.invntt_pow_invphi_fused(v, ctx64),
            lambda v: ntt_mxu_u64.invntt_pow_invphi_fused_plain(v, ctx64),
            c64.data, ring64, BENCH64[2], bench64),
        "dft_mxu64": (
            lambda v: dft_mxu.matmul_mod(v, ringL, "ntt64_e1_fwd", n1,
                                         axis=-2),
            lambda v: dft_mxu.matmul_mod_plain(v, ringL, "ntt64_e1_fwd", n1,
                                               axis=-2),
            xL, ringL, batch, f"one launch, size {n1} left, n={ringL.degree} "
            f"m={ringL.nmoduli} batch={batch}"),
    }
    times = {}
    for name, (kern, plain, arg, r_, batch, what) in cases.items():
        times[name] = compare(kern, plain, arg)
        rate = batch * r_.nmoduli / (times[name][0] * 1e-3)
        unit = "channel-NTT/s" if name != "dft_mxu64" else \
            "channel-stages/s"
        print(f"timing {name}: kernel {times[name][0]:.4f} ms ({rate:.0f} "
              f"{unit}), twin {times[name][1]:.4f} ms, median of "
              f"{TIMING_RUNS}, {what} | {card}")
    for inverse in (False, True):
        fn = ntt_mxu_u64.invntt_pow_invphi_fused if inverse \
            else ntt_mxu_u64.ntt_pow_phi_fused
        pl = ntt_mxu_u64.invntt_pow_invphi_fused_plain if inverse \
            else ntt_mxu_u64.ntt_pow_phi_fused_plain
        tk, tp = compare(lambda v: fn(v, ctxL), lambda v: pl(v, ctxL),
                         aL.data)
        rate = batch * ringL.nmoduli / (tk * 1e-3)
        print(f"timing _large_run64 {'inv' if inverse else 'fwd'}: K5 path "
              f"{tk:.4f} ms ({rate:.0f} channel-NTT/s), twin path "
              f"{tp:.4f} ms, median of {TIMING_RUNS}, n={ringL.degree} "
              f"m={ringL.nmoduli} batch={batch} | {card}")

    # 11. result
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
