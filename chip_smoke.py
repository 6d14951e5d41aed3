#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (nfllib_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from nfllib_tpu_torch/csrc/ (one nvcc
per source, all started together), holds each against its plain torch twin
on the card, and drives the main paths through the entry points a user
calls, each with the launch counters set to 0 just before it and read just
after:
  * u32: the R_q product a*b (forward NTT, Shoup product, inverse NTT) at
    n = 2^14 x 17 u32 moduli, batch 64 (kernels K1, K2);
  * u64: the same product at n = 2^14 x 8 62-bit moduli (a 496-bit q),
    batch 64 (K4), and at n = 2^20 x 2 moduli, batch 2 (K5);
  * the LWE demo (apps/lwe.py: keygen, 10 encryptions and decryptions of
    zero, the zero-sum gate) on u32 (16384, 510) and u64 (16384, 496) under
    NFL_TORCH_NTT=butterfly (K3/K7 in keygen, the chain kernels K6/K8) and
    auto (K1/K2, K4), with equal keys and ciphertexts in both modes;
  * the product of the first two paths under NFL_TORCH_NTT=butterfly (the
    butterfly kernels K3, K7 both ways), equal to the auto-mode products;
and checks the results against the twins, exact Python-int arithmetic, the
CRT-lifted 496-bit big-integer product, the schoolbook oracle and the
golden LWE transcript of the compiled C++ NFLlib (16384_496_u64).  It then
checks strict mode and times the kernels against their twins with CUDA
events.  Every phase prints one line; any failure raises and exits
nonzero.  The last line is {"ok": true, "device": {...}}; the line before
it lists the kernels, each with its time beside its bound.

It imports nothing of JAX.  Without CUDA, or without the port beside it,
it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import itertools
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
BFLY_SHAPES = [("u16", 256, 14, 3), ("u16", 512, 28, 3), ("u32", 256, 60, 3),
               ("u32", 1024, 60, 3), ("u32", 4096, 60, 3),
               ("u32", 32768, 60, 3), BENCH]
BFLY64_SHAPES = [(256, 124, 3), (8192, 124, 3), (16384, 124, 3),
                 (32768, 124, 3), (65536, 124, 3), BENCH64]
K7_LARGE = (65536, 124, 8)               # degree, modulus bits, batch
LWE_RINGS = (("u32", 16384, 510), ("u64", 16384, 496))
LWE_REPS = 10
LWE_BATCHES = (3, 64)
LWE_KEY = bytes(range(32, 64))
GOLDEN = ("16384_496_u64", "u64", 16384, 496)
TIMING_RUNS = 25
KERNEL_REPS = 10         # back-to-back kernel calls in one timing sample
# Peak rates of one H100 SXM at 700 W: HBM3 bytes/s and dense int8 tensor
# ops/s (NVIDIA's data sheet); 132 SMs at the 1.98 GHz boost clock, each
# issuing 4 warp instructions (128 lanes) a clock, at most 64 lanes of them
# on the ALU pipe and 64 on the FMA pipe.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
SM_CLOCKS_PER_S = 132 * 1.98e9
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
    "ntt_butterfly_fwd": ("nfllib_tpu_torch/csrc/ntt_butterfly.cu",
                          "nfllib_tpu/ops/ntt_pallas.py:190"),
    "ntt_butterfly_inv": ("nfllib_tpu_torch/csrc/ntt_butterfly.cu",
                          "nfllib_tpu/ops/ntt_pallas.py:190"),
    "ntt_butterfly64_fwd": ("nfllib_tpu_torch/csrc/ntt_butterfly.cu",
                            "nfllib_tpu/ops/ntt_pallas_u64.py:250"),
    "ntt_butterfly64_inv": ("nfllib_tpu_torch/csrc/ntt_butterfly.cu",
                            "nfllib_tpu/ops/ntt_pallas_u64.py:250"),
    "lwe_encrypt": ("nfllib_tpu_torch/csrc/lwe_chain.cu",
                    "nfllib_tpu/ops/ntt_pallas.py:420"),
    "lwe_decrypt": ("nfllib_tpu_torch/csrc/lwe_chain.cu",
                    "nfllib_tpu/ops/ntt_pallas.py:448"),
    "lwe64_encrypt": ("nfllib_tpu_torch/csrc/lwe_chain.cu",
                      "nfllib_tpu/ops/ntt_pallas_u64.py:440"),
    "lwe64_decrypt": ("nfllib_tpu_torch/csrc/lwe_chain.cu",
                      "nfllib_tpu/ops/ntt_pallas_u64.py:472"),
}
# The least 32-bit integer instructions, (ALU pipe, FMA pipe), of each step
# of the butterfly and chain kernels' math, as sm_90 issues them: IADD3,
# IMNMX, SEL and SHF on the ALU pipe; IMUL, IMAD, IMAD.HI and IMAD.WIDE on
# the FMA pipe.  u32: an add (of two or three terms) is IADD3; a conditional
# subtraction IADD3 + IMNMX; a lazy Shoup product x*w - hi(x*w')*p IMAD.HI +
# IMUL + IMAD; an exact product mod p a Barrett reduction of the 64-bit
# product (IMUL, IMAD.HI, SHF, IMAD.HI, IMAD, a conditional subtraction).
# u64 in 32-bit halves: an add 2; a conditional subtraction 4 (subtract with
# borrow, 2 SEL); a low product 3 (IMAD.WIDE + 2 IMAD); a high product 4
# IMAD.WIDE + 3 carry adds; so a lazy Shoup product (5, 10) and a Barrett
# product (15, 11).
STEP_OPS = {
    "u32": {"add": (1, 0), "red": (2, 0), "shoup": (0, 3), "mulmod": (3, 4)},
    "u64": {"add": (2, 0), "red": (4, 0), "shoup": (5, 10),
            "mulmod": (15, 11)},
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


def set_mode(mode):
    """NFL_TORCH_NTT, read by the port at call time"""
    os.environ["NFL_TORCH_NTT"] = mode


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(t_ops, moved):
    """(least ms for the work, what binds it): the larger of `t_ops` (ms of
    the operations at the peak rate of their type) and the bytes moved over
    HBM's rate"""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def int_ms(alu, fma):
    """least ms for `alu` ALU-pipe and `fma` FMA-pipe lane instructions"""
    return float(max((alu + fma) / 128, alu / 64, fma / 64)
                 / SM_CLOCKS_PER_S * 1e3)


def steps(limb, *names):
    """(ALU, FMA) instructions of the named steps, one after another"""
    return np.array([STEP_OPS[limb][s] for s in names]).sum(axis=0)


def transform_ops(limb, n, rows, inverse, ends):
    """(ALU, FMA) instructions of `rows` butterfly transforms of degree n,
    each element also taking the steps `ends` (prologue and epilogue)"""
    bf = steps(limb, "shoup", "add", "red", "add", "red") if inverse \
        else steps(limb, "add", "red", "add", "shoup")
    log_n = n.bit_length() - 1
    return rows * (n // 2 * log_n * bf + n * steps(limb, *ends))

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import _kernels, crt, debug, golden, oracle
    from nfllib_tpu_torch.apps import lwe
    from nfllib_tpu_torch.ops import dft_mxu, modops, ntt, ntt_mxu, \
        ntt_mxu_u64, ntt_pallas, ntt_pallas_u64
    from nfllib_tpu_torch.prng import Salsa20Stream, mpfr_barriers
    from nfllib_tpu_torch.prng.gaussian import FastGaussianNoise

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
    set_mode("auto")
    mpfr = mpfr_barriers.available()
    print(f"libmpfr/libgmp load: {mpfr} (Gaussian barriers "
          f"{'by MPFR' if mpfr else 'by mpmath'})")

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
        """the plain Harvey path (plain torch ops) on the card"""
        tabs = ctx.to(dev)
        set_mode("plain")
        try:
            return ntt.ntt(modops.mulmod_shoup(x, tabs.phis, tabs.shoupphis,
                                               tabs.p_col), ctx)
        finally:
            set_mode("auto")

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

    # 5b. K3 and K7 against their twins, every flag, exact equality
    def bfly_check(mod, r_, x, tag):
        c_ = r_.context()
        e_f = e_i = 0
        for it, tw, st in itertools.product((False, True), repeat=3):
            got = mod.ntt_fwd(x, c_, inverse_tables=it, twist=tw, strict=st)
            want = mod.ntt_fwd_plain(x, c_, inverse_tables=it, twist=tw,
                                     strict=st)
            torch.cuda.synchronize()
            e_f = max(e_f, max_err(got, want, r_))
        for tw, st in itertools.product((False, True), repeat=2):
            got = mod.intt_bwd(x, c_, untwist=tw, strict=st)
            want = mod.intt_bwd_plain(x, c_, untwist=tw, strict=st)
            torch.cuda.synchronize()
            e_i = max(e_i, max_err(got, want, r_))
        expect(e_f == 0 and e_i == 0, f"{tag} != twin: {e_f}, {e_i}")
        f = mod.ntt_fwd(x, c_)
        expect(torch.equal(f, harvey(x, c_)), f"{tag} != Harvey")
        expect(torch.equal(mod.intt_bwd(f, c_), x), f"{tag} round trip")
        return e_f, e_i

    for limb, degree, bits, batch in BFLY_SHAPES:
        r_ = nfl.ring_from_modulus(limb, degree, bits)
        x = nfl.Poly.from_numpy(r_, rand_residues(r_, rng, batch), dev).data
        e_f, e_i = bfly_check(ntt_pallas, r_, x, f"K3 {limb} n={degree}")
        err["ntt_butterfly_fwd"] = max(err["ntt_butterfly_fwd"], e_f)
        err["ntt_butterfly_inv"] = max(err["ntt_butterfly_inv"], e_i)
        print(f"K3 vs twin: {limb} n={degree} m={r_.nmoduli} batch={batch}: "
              f"8 forward and 4 inverse flag sets exact, equal to Harvey, "
              f"round trip exact")
    for degree, bits, batch in BFLY64_SHAPES:
        r_ = nfl.ring_from_modulus("u64", degree, bits)
        x = nfl.Poly.from_numpy(r_, rand_residues(r_, rng, batch), dev).data
        e_f, e_i = bfly_check(ntt_pallas_u64, r_, x, f"K7 n={degree}")
        err["ntt_butterfly64_fwd"] = max(err["ntt_butterfly64_fwd"], e_f)
        err["ntt_butterfly64_inv"] = max(err["ntt_butterfly64_inv"], e_i)
        print(f"K7 vs twin: u64 n={degree} m={r_.nmoduli} batch={batch}: "
              f"8 forward and 4 inverse flag sets exact, equal to Harvey, "
              f"round trip exact")

    # 5c. K6 and K8 against their twins on the LWE rings
    lwe_args = {}
    for limb, degree, bits in LWE_RINGS:
        r_ = nfl.ring_from_modulus(limb, degree, bits)
        c_ = r_.context()
        mod, enc, dec = ((ntt_pallas_u64, "lwe64_encrypt", "lwe64_decrypt")
                         if limb == "u64"
                         else (ntt_pallas, "lwe_encrypt", "lwe_decrypt"))

        def rows(batch):
            return nfl.Poly.from_numpy(r_, rand_residues(r_, rng, batch),
                                       dev).data
        pka, pkb, sk = rows(1)[0], rows(1)[0], rows(1)[0]
        tabs = c_.to(dev)
        sp = modops.compute_shoup(sk, tabs.p_col, tabs.shoup_f)
        for batch in LWE_BATCHES:
            u, e1, e2 = rows(batch), rows(batch), rows(batch)
            ra, rb = mod.lwe_encrypt_fused(u, e1, e2, pka, pkb, c_)
            pa, pb = mod.lwe_encrypt_plain(u, e1, e2, pka, pkb, c_)
            d = mod.lwe_decrypt_fused(ra, rb, sk, sp, c_)
            pd = mod.lwe_decrypt_plain(ra, rb, sk, sp, c_)
            torch.cuda.synchronize()
            e_e = max(max_err(ra, pa, r_), max_err(rb, pb, r_))
            e_d = max_err(d, pd, r_)
            err[enc], err[dec] = max(err[enc], e_e), max(err[dec], e_d)
            expect(e_e == 0 and e_d == 0,
                   f"{enc}/{dec} != twins at {limb} batch {batch}")
            print(f"K{8 if limb == 'u64' else 6} vs twins: {limb} n={degree} "
                  f"m={r_.nmoduli} batch={batch}: encrypt (resa, resb) and "
                  f"decrypt exact")
        lwe_args[limb] = (r_, (u, e1, e2, pka, pkb), (ra, rb, sk, sp))

    launches = {}
    fused_all = ("ntt_fused_fwd", "ntt_fused_inv", "ntt_fused64_fwd",
                 "ntt_fused64_inv", "dft_mxu64")
    bfly_all = tuple(n for n in KERNELS if n.startswith(("ntt_butterfly",
                                                         "lwe")))

    def drive(names, fn, zero=(), record=True):
        """run fn with every launch counter at 0; `names` must have
        launched and `zero` not; keep `names`' counts if `record`"""
        torch.cuda.synchronize()
        for k in _kernels.KERNELS:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in _kernels.KERNELS}
        expect(all(got[n] > 0 for n in names),
               f"main path skipped a kernel: {got}")
        expect(all(got[n] == 0 for n in zero),
               f"main path launched a kernel of another mode: {got}")
        if record:
            launches.update({n: got[n] for n in names})
        return out, {n: v for n, v in got.items() if v}

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
    c = drive(u32_kernels, lambda: product(nfl, a, b))[0]
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
    c64 = drive(u64_kernels, lambda: product(nfl, a64, b64))[0]
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
    cL = drive(("dft_mxu64",), lambda: product(nfl, aL, bL))[0]
    expect(cL.data.shape == (batch, ringL.nmoduli, degree),
           "large product shape")
    check_coeffs(aL, bL, cL, ringL, 8)
    expect(aL.ntt_pow_phi().invntt_pow_invphi() == aL, "large round trip")
    print(f"main path u64: c = a*b at n={degree} m={ringL.nmoduli} "
          f"batch={batch}: 8 Python-int coefficients, round trip; launches "
          f"{ {'dft_mxu64': launches['dft_mxu64']} }")

    # 8b. the LWE demo through the app API in butterfly and auto modes
    def lwe_run(r_):
        stream_ = Salsa20Stream(LWE_KEY)
        g = lwe.make_gaussian_prng()
        keys = lwe.keygen(r_, stream_, g, dev)
        total = torch.zeros(r_.shape, dtype=torch.int64, device=dev)
        cts = []
        for _ in range(LWE_REPS):
            resa, resb = lwe.encrypt(keys, r_, stream_, g)
            total += lwe.decrypt(keys, r_, resa, resb).to(torch.int64)
            cts.append((resa.data, resb.data))
        return keys, cts, total

    for limb, degree, bits in LWE_RINGS:
        r_ = nfl.ring_from_modulus(limb, degree, bits)
        if limb == "u64":
            want = {"butterfly": ("ntt_butterfly64_fwd", "lwe64_encrypt",
                                  "lwe64_decrypt"),
                    "auto": ("ntt_fused64_fwd", "ntt_fused64_inv")}
        else:
            want = {"butterfly": ("ntt_butterfly_fwd", "lwe_encrypt",
                                  "lwe_decrypt"),
                    "auto": ("ntt_fused_fwd", "ntt_fused_inv")}
        runs, counts = {}, {}
        for mode, zero in (("butterfly", fused_all), ("auto", bfly_all)):
            set_mode(mode)
            t0 = time.perf_counter()
            runs[mode], counts[mode] = drive(
                want[mode], lambda: lwe_run(r_), zero=zero,
                record=mode == "butterfly")
            counts[mode]["seconds"] = round(time.perf_counter() - t0, 3)
        set_mode("auto")
        (kb, cb, tb), (ka, ca, ta) = runs["butterfly"], runs["auto"]
        for mode, total in (("butterfly", tb), ("auto", ta)):
            expect(total.shape == r_.shape and not bool(total.any()),
                   f"LWE zero-sum gate failed on {limb} in {mode} mode")
        for name in ("s", "sprime", "pka", "pkb"):
            expect(getattr(kb, name) == getattr(ka, name),
                   f"LWE key {name} differs between modes on {limb}")
        expect(all(torch.equal(x, y) for pb, pa in zip(cb, ca)
                   for x, y in zip(pb, pa)),
               f"LWE ciphertexts differ between modes on {limb}")
        expect(cb[0][0].shape == r_.shape and cb[0][0].is_cuda,
               "ciphertext shape")
        print(f"main path LWE {limb} (n={degree}, {bits}-bit q): keygen, "
              f"{LWE_REPS} x encrypt/decrypt, zero-sum gate passed in both "
              f"modes; keys and ciphertexts equal across modes; launches "
              f"butterfly {counts['butterfly']}, auto {counts['auto']}")

    # 8c. the products of phases 6 and 7 in butterfly mode (K3, K7)
    set_mode("butterfly")
    try:
        cb = drive(("ntt_butterfly_fwd", "ntt_butterfly_inv"),
                   lambda: product(nfl, a, b), zero=fused_all)[0]
        c64b = drive(("ntt_butterfly64_fwd", "ntt_butterfly64_inv"),
                     lambda: product(nfl, a64, b64), zero=fused_all)[0]
    finally:
        set_mode("auto")
    expect(torch.equal(cb.data, c.data), "butterfly u32 product != K1/K2's")
    expect(torch.equal(c64b.data, c64.data), "butterfly u64 product != K4's")
    print(f"main path products in butterfly mode: u32 n={BENCH[1]} x 17 x "
          f"{BENCH[3]} and u64 n={BENCH64[0]} x 8 x {BENCH64[2]} equal the "
          f"fused-kernel products; launches "
          f"{ {n: launches[n] for n in launches if 'butterfly' in n} }")

    # 8d. the golden transcript of the compiled C++ NFLlib, butterfly mode
    gname, glimb, gdeg, gbits = GOLDEN
    gring = nfl.ring_from_modulus(glimb, gdeg, gbits)
    records = golden.load_golden(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tools", "golden",
        f"nfl_golden_{gname}.bin.xz"))

    def golden_replay():
        for name, got, want in golden.replay(gring, records, dev):
            expect(got == want, f"golden record {name} differs")
        return len(records)
    set_mode("butterfly")
    try:
        nrec, gcounts = drive(
            ("ntt_butterfly64_fwd", "ntt_butterfly64_inv", "lwe64_encrypt",
             "lwe64_decrypt"), golden_replay, zero=fused_all, record=False)
    finally:
        set_mode("auto")
    print(f"golden {gname}: {nrec} records replayed byte for byte in "
          f"butterfly mode (samplers, NTT, LWE keys, encryption, raw and bit "
          f"decryption); launches {gcounts}")

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
    def timed(fn, arg, reps):
        """ms per call: `reps` calls back to back between two CUDA events
        (one call of a sub-millisecond kernel mostly times its host-side
        launch)"""
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn(arg)
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    def compare(kern, plain, arg, reps=(KERNEL_REPS, 1)):
        """medians of TIMING_RUNS samples of each, in turns, after 3
        warm-ups; a kernel sample is KERNEL_REPS calls, a twin's one"""
        for _ in range(3):
            timed(kern, arg, 1)
            timed(plain, arg, 1)
        tk, tp = [], []
        for j in range(TIMING_RUNS):
            order = ((kern, tk, reps[0]), (plain, tp, reps[1]))
            for fn, acc, r in (order if j % 2 == 0 else order[::-1]):
                acc.append(timed(fn, arg, r))
        return statistics.median(tk), statistics.median(tp)

    n1, n2 = ntt_mxu_u64._geometry(ringL.degree)
    bench32 = f"n={ring.degree} m={ring.nmoduli} u32 batch={BENCH[3]}"
    bench64 = f"n={ring64.degree} m={ring64.nmoduli} u64 batch={BENCH64[2]}"
    xL = aL.data.reshape(aL.data.shape[0], ringL.nmoduli, n1, n2)
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
    r32, (u, e1, e2, pka, pkb), (ra, rb, sk, sp) = lwe_args["u32"]
    c32 = r32.context()
    r64, (u6, e16, e26, pka6, pkb6), (ra6, rb6, sk6, sp6) = lwe_args["u64"]
    c64_ = r64.context()
    lwe32 = f"n={r32.degree} m={r32.nmoduli} u32 batch={u.shape[0]}"
    lwe64 = f"n={r64.degree} m={r64.nmoduli} u64 batch={u6.shape[0]}"
    cases.update({
        "ntt_butterfly_fwd": (
            lambda v: ntt_pallas.ntt_fwd(v, ctx),
            lambda v: ntt_pallas.ntt_fwd_plain(v, ctx),
            a.data, ring, BENCH[3], bench32),
        "ntt_butterfly_inv": (
            lambda v: ntt_pallas.intt_bwd(v, ctx),
            lambda v: ntt_pallas.intt_bwd_plain(v, ctx),
            c.data, ring, BENCH[3], bench32),
        "ntt_butterfly64_fwd": (
            lambda v: ntt_pallas_u64.ntt_fwd(v, ctx64),
            lambda v: ntt_pallas_u64.ntt_fwd_plain(v, ctx64),
            a64.data, ring64, BENCH64[2], bench64),
        "ntt_butterfly64_inv": (
            lambda v: ntt_pallas_u64.intt_bwd(v, ctx64),
            lambda v: ntt_pallas_u64.intt_bwd_plain(v, ctx64),
            c64.data, ring64, BENCH64[2], bench64),
        "lwe_encrypt": (
            lambda v: ntt_pallas.lwe_encrypt_fused(*v, c32),
            lambda v: ntt_pallas.lwe_encrypt_plain(*v, c32),
            (u, e1, e2, pka, pkb), r32, u.shape[0], lwe32),
        "lwe_decrypt": (
            lambda v: ntt_pallas.lwe_decrypt_fused(*v, c32),
            lambda v: ntt_pallas.lwe_decrypt_plain(*v, c32),
            (ra, rb, sk, sp), r32, u.shape[0], lwe32),
        "lwe64_encrypt": (
            lambda v: ntt_pallas_u64.lwe_encrypt_fused(*v, c64_),
            lambda v: ntt_pallas_u64.lwe_encrypt_plain(*v, c64_),
            (u6, e16, e26, pka6, pkb6), r64, u6.shape[0], lwe64),
        "lwe64_decrypt": (
            lambda v: ntt_pallas_u64.lwe_decrypt_fused(*v, c64_),
            lambda v: ntt_pallas_u64.lwe_decrypt_plain(*v, c64_),
            (ra6, rb6, sk6, sp6), r64, u6.shape[0], lwe64),
    })
    times = {}
    for name, (kern, plain, arg, r_, batch, what) in cases.items():
        times[name] = compare(kern, plain, arg)
        rate = batch * r_.nmoduli / (times[name][0] * 1e-3)
        unit = {"dft_mxu64": "channel-stages/s"}.get(
            name, "channel-chains/s" if name.startswith("lwe")
            else "channel-NTT/s")
        print(f"timing {name}: kernel {times[name][0]:.4f} ms ({rate:.0f} "
              f"{unit}), twin {times[name][1]:.4f} ms, medians of "
              f"{TIMING_RUNS} samples ({KERNEL_REPS} back-to-back kernel "
              f"calls, one twin call), {what} | {card}")
    for inverse in (False, True):
        fn = ntt_mxu_u64.invntt_pow_invphi_fused if inverse \
            else ntt_mxu_u64.ntt_pow_phi_fused
        pl = ntt_mxu_u64.invntt_pow_invphi_fused_plain if inverse \
            else ntt_mxu_u64.ntt_pow_phi_fused_plain
        tk, tp = compare(lambda v: fn(v, ctxL), lambda v: pl(v, ctxL),
                         aL.data)
        rate = xL.shape[0] * ringL.nmoduli / (tk * 1e-3)
        print(f"timing _large_run64 {'inv' if inverse else 'fwd'}: K5 path "
              f"{tk:.4f} ms ({rate:.0f} channel-NTT/s), twin path "
              f"{tp:.4f} ms, median of {TIMING_RUNS}, n={ringL.degree} "
              f"m={ringL.nmoduli} batch={xL.shape[0]} | {card}")

    # 10b. A/B of the two NTT formulations and of the LWE graphs' modes
    for tag, (k_b, k_f, arg, what) in {
            "K3 fwd vs K1": (cases["ntt_butterfly_fwd"][0],
                             cases["ntt_fused_fwd"][0], a.data, bench32),
            "K3 inv vs K2": (cases["ntt_butterfly_inv"][0],
                             cases["ntt_fused_inv"][0], c.data, bench32),
            "K7 fwd vs K4": (cases["ntt_butterfly64_fwd"][0],
                             cases["ntt_fused64_fwd"][0], a64.data, bench64),
            "K7 inv vs K4": (cases["ntt_butterfly64_inv"][0],
                             cases["ntt_fused64_inv"][0], c64.data,
                             bench64)}.items():
        tb_, tf_ = compare(k_b, k_f, arg, (KERNEL_REPS, KERNEL_REPS))
        print(f"A/B {tag}: butterfly {tb_:.4f} ms, fused {tf_:.4f} ms, "
              f"ratio {tf_ / tb_:.2f}, medians of {TIMING_RUNS} samples of "
              f"{KERNEL_REPS} back-to-back calls in turns, {what} | {card}")
    degree, bits, batch = K7_LARGE
    rK = nfl.ring_from_modulus("u64", degree, bits)
    cK = rK.context()
    xK = nfl.Poly.from_numpy(rK, rand_residues(rK, rng, batch), dev).data
    for inverse in (False, True):
        fn = ntt_pallas_u64.intt_bwd if inverse else ntt_pallas_u64.ntt_fwd
        pl = ntt_pallas_u64.intt_bwd_plain if inverse \
            else ntt_pallas_u64.ntt_fwd_plain
        tk, tp = compare(lambda v: fn(v, cK), lambda v: pl(v, cK), xK)
        print(f"timing K7 {'inv' if inverse else 'fwd'} at n={degree} "
              f"m={rK.nmoduli} batch={batch} (2 stages through device "
              f"memory): kernel {tk:.4f} ms, twin {tp:.4f} ms, medians of "
              f"{TIMING_RUNS} samples | {card}")

    def in_mode(mode, fn):
        def run(v):
            set_mode(mode)
            try:
                return fn(v)
            finally:
                set_mode("auto")
        return run

    for limb, (r_, enc_args, dec_args) in lwe_args.items():
        c_ = r_.context()
        for gname_, graph, args in (
                ("_encrypt_graph", lambda v: lwe._encrypt_graph(
                    c_, v[3], v[4], v[0], v[1], v[2]), enc_args),
                ("_decrypt_graph", lambda v: lwe._decrypt_graph(c_, *v),
                 dec_args)):
            tb_, ta_ = compare(in_mode("butterfly", graph),
                               in_mode("auto", graph), args, (1, 1))
            print(f"timing LWE {gname_} {limb} n={r_.degree} m={r_.nmoduli} "
                  f"batch={args[0].shape[0]}: butterfly mode (chain kernel) "
                  f"{tb_:.4f} ms, auto mode (fused NTT kernels + plain ops) "
                  f"{ta_:.4f} ms, one call a sample, medians of "
                  f"{TIMING_RUNS} in turns | {card}")
    g = FastGaussianNoise(lwe.SIGMA, 128, 1 << 10)
    gs = Salsa20Stream(LWE_KEY)
    walk = []
    for _ in range(TIMING_RUNS):
        t0 = time.perf_counter()
        g.get_noise(gs, 16384)
        walk.append((time.perf_counter() - t0) * 1e3)
    print(f"timing Gaussian host walk (sigma {lwe.SIGMA}, n=16384, one "
          f"polynomial): median {statistics.median(walk):.4f} ms, min "
          f"{min(walk):.4f}, max {max(walk):.4f} of {TIMING_RUNS}, host clock")

    # 10c. bounds: the larger of operations over the peak rate of their
    # type and bytes (each input once, each output once) over HBM's rate
    bounds = {}
    for name, r_, x, tabs in (
            ("ntt_fused_fwd", ring, a.data, ntt_mxu.fused_tables(
                ring, False, dev)),
            ("ntt_fused_inv", ring, c.data, ntt_mxu.fused_tables(
                ring, True, dev)),
            ("ntt_fused64_fwd", ring64, a64.data, ntt_mxu_u64.fused_tables64(
                ring64, False, dev)),
            ("ntt_fused64_inv", ring64, c64.data, ntt_mxu_u64.fused_tables64(
                ring64, True, dev))):
        per = (tabs.ndig if name.startswith("ntt_fused_") else 16) * (
            tabs.n1 * tabs.n1 * tabs.n2 + tabs.n1 * tabs.n2 * tabs.n2)
        moved = 2 * nbytes(x) + nbytes(tabs.w1, tabs.w2, tabs.tw, tabs.tws,
                                       tabs.corr1, tabs.corr2, tabs.p,
                                       tabs.mbar)
        bounds[name] = bound(
            8 * per * x.shape[0] * r_.nmoduli / INT8_OPS_PER_S * 1e3, moved)
    dt = dft_mxu.dft_tables(ringL, "ntt64_e1_fwd", n1, True, dev)
    bounds["dft_mxu64"] = bound(
        8 * 22 * n1 * n1 * n2 * xL.shape[0] * ringL.nmoduli / INT8_OPS_PER_S
        * 1e3, 2 * nbytes(xL) + nbytes(dt.planes, dt.corr, dt.consts))
    # the default flags: forward with the canonical twist and the strict
    # reduction, inverse with the lazy untwist and the strict reduction
    for name, r_, x, inverse in (
            ("ntt_butterfly_fwd", ring, a.data, False),
            ("ntt_butterfly_inv", ring, c.data, True),
            ("ntt_butterfly64_fwd", ring64, a64.data, False),
            ("ntt_butterfly64_inv", ring64, c64.data, True)):
        t = ntt_pallas.kernel_tables(r_, dev)
        tw = (t.iw, t.iws, t.itw, t.itws) if inverse \
            else (t.w, t.ws, t.tw, t.tws)
        ends = ("shoup", "red") if inverse else ("shoup", "red", "red")
        bounds[name] = bound(
            int_ms(*transform_ops(r_.limb, r_.degree,
                                  x.shape[0] * r_.nmoduli, inverse, ends)),
            2 * nbytes(x) + nbytes(*tw, t.p))
    for limb, (r_, enc_args, dec_args) in lwe_args.items():
        t = ntt_pallas.kernel_tables(r_, dev)
        rows = enc_args[0].shape[0] * r_.nmoduli
        elems = rows * r_.degree
        # encrypt: three twisted transforms, u's strict reduction, and two
        # epilogues e + u*pk mod p; decrypt: resb - resa*s mod p as it
        # loads, the inverse transform, the untwist and strict reduction
        enc = (3 * transform_ops(limb, r_.degree, rows, False,
                                 ("shoup", "red"))
               + elems * steps(limb, "red")
               + 2 * elems * steps(limb, "red", "mulmod", "add", "red"))
        dec = transform_ops(limb, r_.degree, rows, True,
                            ("shoup", "red", "add", "red", "shoup", "red"))
        pre = "lwe64" if limb == "u64" else "lwe"
        bounds[f"{pre}_encrypt"] = bound(
            int_ms(*enc), nbytes(*enc_args) + 2 * nbytes(enc_args[0])
            + nbytes(t.w, t.ws, t.tw, t.tws, t.p, t.pn))
        bounds[f"{pre}_decrypt"] = bound(
            int_ms(*dec), nbytes(*dec_args) + nbytes(dec_args[0])
            + nbytes(t.iw, t.iws, t.itw, t.itws, t.p))
    for name in KERNELS:
        print(f"bound {name}: {bounds[name][0]:.4f} ms ({bounds[name][1]}), "
              f"kernel {times[name][0]:.4f} ms, "
              f"{100 * bounds[name][0] / times[name][0]:.1f} % of the bound "
              f"| {card}")

    # 11. result
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
