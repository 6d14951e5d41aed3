#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (nfllib_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from nfllib_tpu_torch/csrc/ (one nvcc
per source, all started together), shows that one launch of more than
65535 polynomials is refused (grid.z) and that the wrappers' chunked
launches are exact at 65537, holds each kernel against its plain torch twin
on the card, and drives the main paths through the entry points a user
calls, each with the launch counters set to 0 just before it and read just
after:
  * u32: the R_q product a*b (forward NTT, Shoup product, inverse NTT) at
    n = 2^14 x 17 u32 moduli, batch 64 (the route of K1/K2: two K9
    launches a transform, the twiddle in the first one's epilogue);
  * u64: the same product at n = 2^14 x 8 62-bit moduli (a 496-bit q),
    batch 64, and at n = 2^20 x 2 moduli, batch 2 (both K4's route: two
    K5 launches a transform, the twiddle in the first one's epilogue);
  * the LWE demo (apps/lwe.py: keygen, 10 encryptions and decryptions of
    zero, the zero-sum gate) on u32 (16384, 510) and u64 (16384, 496) under
    NFL_TORCH_NTT=butterfly (K3/K7 in keygen, the chain kernels K6/K8) and
    auto (K9, K5), with equal keys and ciphertexts in both modes;
  * the product of the first two paths under NFL_TORCH_NTT=butterfly (the
    butterfly kernels K3, K7 both ways), equal to the auto-mode products;
  * the distributed four-step NTT (parallel/ntt_dist.py) under an NCCL
    process group of one rank on this card: forward, pointwise Shoup
    product and inverse at u32 2^14 x 17 x 64 (local sub-DFTs on K9) and
    u64 2^20 x 2 x 2 (K5; again with NFL_TORCH_DFT_PIPE=1 on K10), equal
    to the single-chip products, with the a2a, ppermute and chunked
    transposes and the pipelined batch entry; and the large-degree u64
    forward chained through pair I/O and the pair bridge K11, and through
    K5's twiddle epilogue, equal to _route;
and checks the results against the twins, exact Python-int arithmetic, the
CRT-lifted 496-bit big-integer product, the schoolbook oracle and the
golden LWE transcript of the compiled C++ NFLlib (16384_496_u64).  It
reads the built library's SASS (cuobjdump): K5's, K9's and K10's kernels
must issue int8 tensor-core MMAs, and no kernel dp4a; it prints the
instruction mix of the butterfly stage engine's main instances.  The
u16/u32 route runs at every degree from 8 (sides 2 and 4) to 2^15, u16 at
its extreme inputs, and at 65537 polynomials.  The LWE chain kernels K6/K8
are held to their twins on the LWE rings, the u16 rings and u64 2^15 and
2^16, with inputs and keys at 0 and p - 1; one encrypt call must issue one
CUDA launch a chunk (torch.profiler), and it is timed at batch 1 beside
batch 64.  It then checks strict mode and
times the kernels against their twins with CUDA events (and K11's launch
path on the host clock and in torch.profiler), and prints cuBLAS's int8
product (torch._int_mm, both mat2 layouts) on K5's 64 digit products as a
yardstick the port never calls.  Every phase prints one line; any failure
raises and exits nonzero.  The last line is {"ok": true, "device":
{...}}; the line before it lists the kernels, each with its time beside
its bound.

It imports nothing of JAX.  Without CUDA, or without the port beside it,
it exits nonzero and prints no result.
"""
from __future__ import annotations

import ctypes
import dataclasses
import datetime
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

BENCH = ("u32", 16384, 510, 64)          # limb, degree, modulus bits, batch
SHAPES = [("u32", 8, 60, 3), ("u32", 16, 60, 3), ("u32", 32, 60, 3),
          ("u16", 128, 14, 3), ("u16", 512, 14, 3), ("u32", 1024, 60, 3),
          ("u32", 4096, 60, 3), ("u32", 32768, 60, 3), BENCH]
BENCH64 = (16384, 496, 64)               # degree, modulus bits, batch
SHAPES64 = [(8, 124, 3), (16, 62, 3), (32, 124, 3), (64, 124, 3),
            (256, 62, 3), (8192, 124, 3), (32768, 124, 3), (65536, 62, 3),
            BENCH64]
LARGE64 = [(1 << 17, 62, 2), (1 << 20, 124, 2)]
LARGE_MAIN = (1 << 20, 124, 2)           # degree, modulus bits, batch
DFT_SIZES = (8, 128, 1024)
WIDE_BATCH = 40000       # K5/K10 at batch x m = 80000 slabs, size 8
WIDE_POLYS = 65537       # past grid.z's 65535 polynomials a launch
SHARD_OTHERS = (64, 32, 16)              # n2/d of the u32 path at d = 2, 4, 8
DIST_RUNS = 10                           # samples of a distributed round trip
BFLY_SHAPES = [("u16", 256, 14, 3), ("u16", 512, 28, 3), ("u32", 256, 60, 3),
               ("u32", 1024, 60, 3), ("u32", 4096, 60, 3),
               ("u32", 32768, 60, 3), BENCH]
BFLY64_SHAPES = [(256, 124, 3), (8192, 124, 3), (16384, 124, 3),
                 (32768, 124, 3), (65536, 124, 3), BENCH64]
K7_LARGE = (65536, 124, 8)               # degree, modulus bits, batch
LWE_RINGS = (("u32", 16384, 510), ("u64", 16384, 496))
LWE_REPS = 10
LWE_BATCHES = (3, 64)
CHAIN_SHAPES = [("u16", 256, 14, 3), ("u16", 512, 28, 3),
                ("u64", 32768, 124, 3), ("u64", 65536, 124, 2)]
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
    "dft_mxu64": ("nfllib_tpu_torch/csrc/dft_mxu64.cu",
                  "nfllib_tpu/ops/dft_mxu.py:317"),
    "dft_mxu64_twiddle": ("nfllib_tpu_torch/csrc/dft_mxu64.cu",
                          "nfllib_tpu/ops/dft_mxu.py:411"),
    "dft_mxu32": ("nfllib_tpu_torch/csrc/dft_mxu32.cu",
                  "nfllib_tpu/ops/dft_mxu.py:232"),
    "dft_mxu64_pipe": ("nfllib_tpu_torch/csrc/dft_mxu64_pipe.cu",
                       "nfllib_tpu/ops/dft_mxu.py:427"),
    "pair_bridge64": ("nfllib_tpu_torch/csrc/pair_bridge.cu",
                      "nfllib_tpu/ops/pair_bridge.py:48"),
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
# TPU kernels that run as launches of another kernel of the port
# (ops/ntt_mxu.py:_route, the four-step of every tier): name: (source, TPU
# kernel it replaces).  K4 (the u64 NTT) is two launches of K5 (dft_mxu64,
# dft_mxu64_twiddle), K1/K2 (the u16/u32 NTT) two of K9 (dft_mxu32): the
# first DFT with the twiddle in its epilogue, then the second.
ROUTE_KERNELS = {"u64": ("dft_mxu64_twiddle", "dft_mxu64"),
                 "u32": ("dft_mxu32",)}
ROUTES = {
    "ntt32_route_fwd": ("nfllib_tpu_torch/csrc/dft_mxu32.cu",
                        "nfllib_tpu/ops/ntt_mxu.py:547"),
    "ntt32_route_inv": ("nfllib_tpu_torch/csrc/dft_mxu32.cu",
                        "nfllib_tpu/ops/ntt_mxu.py:723"),
    "ntt64_route_fwd": ("nfllib_tpu_torch/csrc/dft_mxu64.cu",
                        "nfllib_tpu/ops/ntt_mxu_u64.py:274"),
    "ntt64_route_inv": ("nfllib_tpu_torch/csrc/dft_mxu64.cu",
                        "nfllib_tpu/ops/ntt_mxu_u64.py:274"),
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
    """[B, m, r, c] canonical residues in the ring's storage on `dev`"""
    import torch
    out = np.empty(shape, dtype=np.uint64)
    for cm in range(ring.nmoduli):
        out[:, cm] = rng.integers(0, int(ring.moduli[cm]),
                                  size=(shape[0],) + shape[2:],
                                  dtype=np.uint64)
    out = out.astype(ring.dtype).view(ring.limb_params.signed_dtype)
    return torch.from_numpy(out).to(dev)


def rand_twiddle(ring, rng, shape, dev):
    """[m, r, c] canonical twiddles and their Shoup companions on `dev`"""
    import torch
    from nfllib_tpu_torch.ring import _np_shoup_vec
    tw = np.empty((ring.nmoduli,) + shape, dtype=np.uint64)
    tws = np.empty_like(tw)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        tw[cm] = rng.integers(0, p, size=shape, dtype=np.uint64)
        tws[cm] = _np_shoup_vec(tw[cm].reshape(-1), p,
                                ring.repr_bits).reshape(shape)
    signed = ring.limb_params.signed_dtype
    return tuple(torch.from_numpy(a.astype(ring.dtype).view(signed)).to(dev)
                 for a in (tw, tws))


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


# kernels of the SASS check, by a fragment of their mangled names, and
# their instance counts: K5 and K9 are the 8- and 4-digit instances of
# digit_mma.cuh's dft_mma_kernel (4 of (LEFT, TW); K9 twice, without and
# with the small-p finish), K10 its own (4); all must issue int8
# tensor-core MMAs.  No kernel of the library issues dp4a.
SASS_MMA = {"K5": ("dft_mma_kernelILi8E", 4),
            "K9": ("dft_mma_kernelILi4E", 8),
            "K10": ("dft_mxu64_pipe_kernelI", 4)}
ENGINE_SASS = ("bfly_nttINS0_3U32ELi14ELi0E", "bfly_nttINS0_3U64ELi14ELi0E",
               "bfly_encryptINS0_3U32ELi14E", "bfly_encryptINS0_3U64ELi14E")
SASS_OPS = {"IMMA": r"\bIMMA\b", "IGMMA": r"\bIGMMA\b",
            "HGMMA": r"\bHGMMA\b", "IDP4A": r"\bIDP\.4A\b"}


def sass_counts(cuobjdump, lib_path):
    """({mangled kernel symbol: {op: count}}, {symbol: {opcode: count}}) of
    every kernel in the library: the SASS_OPS matches, and every
    instruction by its opcode's first word"""
    import collections
    import re
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    expect(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    counts, mixes, cur = {}, {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            counts[cur] = dict.fromkeys(SASS_OPS, 0)
            mixes[cur] = collections.Counter()
        elif cur is not None:
            for op, pat in SASS_OPS.items():
                counts[cur][op] += bool(re.search(pat, ln))
            ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                            ln)
            if ins:
                mixes[cur][ins.group(1)] += 1
    return counts, mixes


def template_args(sym):
    """'<8,1,0>' from the integer and bool template arguments of a mangled
    kernel symbol"""
    import re
    targs = re.search(r"kernelI((?:L[ib]\d+E)+)E", sym)
    return "<" + ",".join(re.findall(r"L[ib](\d+)E", targs.group(1))) + ">" \
        if targs else ""


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
    rdzv = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run(torch, rdzv)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)


def run(torch, rdzv) -> int:
    t_start = time.perf_counter()
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import _kernels, crt, debug, golden, oracle
    from nfllib_tpu_torch.apps import lwe
    from nfllib_tpu_torch.ops import dft_mxu, modops, ntt, ntt_mxu, \
        ntt_mxu_u64, ntt_pallas, ntt_pallas_u64, pair_bridge
    from nfllib_tpu_torch.parallel import api as dist_api, ntt_dist
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

    # 2a. SASS: the square mod-matmuls K5, K9, K10 (and so the NTT routes
    # of every tier) on the int8 tensor cores; no dp4a anywhere
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    sass, sass_mix = sass_counts(cuobjdump, lib.path)
    for tag, (frag, count) in SASS_MMA.items():
        mine = {sym: c for sym, c in sass.items() if frag in sym}
        expect(len(mine) == count, f"sass: {len(mine)} instances of {tag}")
        for sym, c in mine.items():
            expect(c["IMMA"] + c["IGMMA"] + c["HGMMA"] > 0
                   and c["IDP4A"] == 0,
                   f"sass: {tag} {sym} not on the tensor cores: {c}")
        print(f"sass {tag} ({frag}...): " + "; ".join(
            f"{template_args(sym)} " + ", ".join(f"{op} {n}"
                                                 for op, n in c.items())
            for sym, c in sorted(mine.items())))
    dp4a = {sym: c["IDP4A"] for sym, c in sass.items() if c["IDP4A"]}
    expect(not dp4a, f"sass: IDP.4A in the library: {dp4a}")
    print(f"sass check: {', '.join(SASS_MMA)} issue tensor-core MMAs; no "
          f"IDP.4A in any of the {len(sass)} kernels of the library")
    # the stage engine's main instances (K3 forward at u32 2^14, K7 forward
    # and both encrypt chains at 2^14): static instruction mix, every loop
    # but SERIAL's group loop unrolled
    for frag in ENGINE_SASS:
        mine = [sym for sym in sass_mix if frag in sym]
        expect(len(mine) == 1, f"sass: {len(mine)} kernels match {frag}")
        mix = sass_mix[mine[0]]
        print(f"sass mix {frag}: {sum(mix.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in mix.most_common(14)))

    err = {name: 0 for name in (*KERNELS, *ROUTES)}
    rng = np.random.default_rng(2024)

    # 2b. the grid.z cap: the kernels put the batch on grid.z (at most
    # 65535), so the wrappers launch at most MAX_BATCH polynomials at a
    # time.  First the unchunked path (K3's C entry point called once on
    # the whole batch, as its wrapper did before the repair), then every
    # batched kernel at WIDE_POLYS against its twin, at the smallest ring
    # it admits
    rW = nfl.ring_from_modulus("u32", 256, 30)
    rW64 = nfl.ring_from_modulus("u64", 256, 62)
    cW, cW64 = rW.context(), rW64.context()
    xW = nfl.Poly.from_numpy(rW, rand_residues(rW, rng, WIDE_POLYS - 1),
                             dev).data
    tW, got = ntt_pallas.kernel_tables(rW, dev), torch.empty_like(xW)
    code = lib.lib.nfl_ntt_butterfly(
        tW.bits, 0, 1, 1, *map(_kernels._ptr, (
            xW, got, tW.wp, tW.twp, tW.p)),
        xW.shape[0], tW.m, tW.log_n,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    if code:
        outcome = (f"refused (CUDA error {code}, "
                   f"{lib.lib.nfl_cuda_error_string(code).decode()}): the "
                   f"fault is confirmed")
    elif torch.equal(got, ntt_pallas.ntt_fwd_plain(xW, cW)):
        outcome = "launched and exact: the fault is refuted"
    else:
        outcome = "launched with wrong output: the fault is confirmed"
    del got
    print(f"grid.z cap, one unchunked launch of K3 at {WIDE_POLYS - 1} "
          f"polynomials (u32 n=256 m=1, {nbytes(xW) >> 20} MiB): {outcome}")
    del xW

    def wide(r_):
        return nfl.Poly.from_numpy(r_, rand_residues(r_, rng, WIDE_POLYS),
                                   dev).data
    wide_counts = {}

    def wide_check(name, r_, got, want):
        torch.cuda.synchronize()
        e = max_err(got, want, r_)
        err[name] = max(err[name], e)
        expect(e == 0, f"{name} != twin at {WIDE_POLYS} polynomials")
        wide_counts[name] = k_by_name[name].launches

    for k in _kernels.KERNELS:
        k.launches = 0
    for mod, r_, c_, fwd, inv in (
            (ntt_pallas, rW, cW, "ntt_butterfly_fwd", "ntt_butterfly_inv"),
            (ntt_pallas_u64, rW64, cW64, "ntt_butterfly64_fwd",
             "ntt_butterfly64_inv")):
        x = wide(r_)
        wide_check(fwd, r_, mod.ntt_fwd(x, c_), mod.ntt_fwd_plain(x, c_))
        wide_check(inv, r_, mod.intt_bwd(x, c_), mod.intt_bwd_plain(x, c_))
    for r_, c_, enc, dec, mod in (
            (rW, cW, "lwe_encrypt", "lwe_decrypt", ntt_pallas),
            (rW64, cW64, "lwe64_encrypt", "lwe64_decrypt", ntt_pallas_u64)):
        u, e1, e2 = wide(r_), wide(r_), wide(r_)
        pka, pkb, sk = (nfl.Poly.from_numpy(
            r_, rand_residues(r_, rng, 1), dev).data[0] for _ in range(3))
        tabs = c_.to(dev)
        sp = modops.compute_shoup(sk, tabs.p_col, tabs.shoup_f)
        ra, rb = mod.lwe_encrypt_fused(u, e1, e2, pka, pkb, c_)
        pa, pb = mod.lwe_encrypt_plain(u, e1, e2, pka, pkb, c_)
        wide_check(enc, r_, ra, pa)
        wide_check(enc, r_, rb, pb)
        wide_check(dec, r_, mod.lwe_decrypt_fused(ra, rb, sk, sp, c_),
                   mod.lwe_decrypt_plain(ra, rb, sk, sp, c_))
        del u, e1, e2, ra, rb, pa, pb
    for r_, name in ((rW, "dft_mxu32"), (rW64, "dft_mxu64")):
        xs = rand_slab(r_, rng, (WIDE_POLYS, 1, 8, 8), dev)
        for axis in (-2, -1):
            wide_check(name, r_,
                       dft_mxu.matmul_mod(xs, r_, "dft_fwd", 8, axis=axis),
                       dft_mxu.matmul_mod_plain(xs, r_, "dft_fwd", 8,
                                                axis=axis))
    expect(all(v >= 2 for v in wide_counts.values()),
           f"wide launches not chunked: {wide_counts}")
    print(f"grid.z cap repaired: K3/K7 both ways, K6/K8 encrypt and "
          f"decrypt, K9 and K5 (size 8, both axes) at {WIDE_POLYS} "
          f"polynomials (n=256 m=1 rings) equal their twins; launches (one "
          f"a chunk of at most {_kernels.MAX_BATCH}) {wide_counts}")

    def harvey(x, ctx):
        """the plain Harvey path (plain torch ops) on the card"""
        tabs = ctx.to(dev)
        set_mode("plain")
        try:
            return ntt.ntt(modops.mulmod_shoup(x, tabs.phis, tabs.shoupphis,
                                               tabs.p_col), ctx)
        finally:
            set_mode("auto")

    # 3. the u16/u32 route (K1/K2 as two K9 launches a transform, the
    # twiddle in the first one's epilogue) against its twin, the plain
    # Harvey path and the round trip at every degree from 8 (sides 2 and
    # 4) to 2^15 (sides 128 and 256); the u16 rings (the small-p part
    # reduction) also at their extreme inputs x = 0 and x = p - 1
    def route32_check(ring, x, tag):
        ctx = ring.context()
        before = k_by_name["dft_mxu32"].launches
        f = ntt_mxu.ntt_pow_phi_fused(x, ctx)
        g = ntt_mxu.invntt_pow_invphi_fused(f, ctx)
        torch.cuda.synchronize()
        grew = k_by_name["dft_mxu32"].launches - before
        want = 4 * len(_kernels.batch_chunks(x.shape[0]))
        expect(grew == want, f"u32 route at {tag}: {grew} K9 launches, "
               f"not {want}")
        e_fwd = max_err(f, ntt_mxu.ntt_pow_phi_fused_plain(x, ctx), ring)
        e_inv = max_err(g, ntt_mxu.invntt_pow_invphi_fused_plain(f, ctx),
                        ring)
        err["ntt32_route_fwd"] = max(err["ntt32_route_fwd"], e_fwd)
        err["ntt32_route_inv"] = max(err["ntt32_route_inv"], e_inv)
        expect(e_fwd == 0, f"u32 route fwd != twin at {tag}")
        expect(e_inv == 0, f"u32 route inv != twin at {tag}")
        expect(torch.equal(f, harvey(x, ctx)), f"u32 route != Harvey at {tag}")
        expect(torch.equal(g, x), f"u32 route round trip at {tag}")
        return grew

    for limb, degree, bits, batch in SHAPES:
        ring = nfl.ring_from_modulus(limb, degree, bits)
        x = nfl.Poly.from_numpy(ring, rand_residues(ring, rng, batch), dev)
        tag = f"{limb} n={degree} m={ring.nmoduli} batch={batch}"
        grew = route32_check(ring, x.data, tag)
        fills = ""
        if limb == "u16":
            p_ = torch.tensor([int(q) for q in ring.moduli], device=dev,
                              dtype=torch.int32).view(1, -1, 1)
            for fill in (torch.zeros_like(x.data), (x.data * 0 + p_ - 1)
                         .to(x.data.dtype)):
                grew += route32_check(ring, fill, tag + " extreme")
            fills = ", and at x = 0 and x = p - 1"
        print(f"u32 route (K9 twice a transform) vs twin: {tag} (sides "
              f"{ntt_mxu._geometry(degree)}): fwd and inv exact, equal to "
              f"Harvey, round trip exact{fills}; K9 launches {grew}")
    # past grid.z's 65535 polynomials a launch: each stage in two chunks
    x = wide(rW)
    grew = route32_check(rW, x, f"u32 n=256 m=1 batch={WIDE_POLYS}")
    del x
    print(f"u32 route vs twin at {WIDE_POLYS} polynomials (u32 n=256 m=1): "
          f"fwd and inv exact, equal to Harvey, round trip exact; K9 "
          f"launches {grew} (one a chunk of at most {_kernels.MAX_BATCH})")

    # 4. K4's route (two K5 launches a transform, the twiddle in the first
    # one's epilogue) against its twin (_route(plain=True)), plain Harvey
    # and the round trip at every degree from 8 (sides 2 and 4 below 64)
    route64 = ROUTE_KERNELS["u64"]
    for degree, bits, batch in SHAPES64:
        ring = nfl.ring_from_modulus("u64", degree, bits)
        ctx = ring.context()
        x = nfl.Poly.from_numpy(ring, rand_residues(ring, rng, batch), dev)
        before = {n: k_by_name[n].launches for n in route64}
        f = ntt_mxu_u64.ntt_pow_phi_fused(x.data, ctx)
        g = ntt_mxu_u64.invntt_pow_invphi_fused(f, ctx)
        torch.cuda.synchronize()
        grew = {n: k_by_name[n].launches - before[n] for n in route64}
        expect(grew == dict.fromkeys(route64, 2),
               f"K4 route at n={degree}: launches {grew}")
        e_fwd = max_err(f, ntt_mxu_u64.ntt_pow_phi_fused_plain(x.data, ctx),
                        ring)
        e_inv = max_err(g, ntt_mxu_u64.invntt_pow_invphi_fused_plain(f, ctx),
                        ring)
        err["ntt64_route_fwd"] = max(err["ntt64_route_fwd"], e_fwd)
        err["ntt64_route_inv"] = max(err["ntt64_route_inv"], e_inv)
        expect(e_fwd == 0, f"K4 route fwd != twin at n={degree} bits={bits}")
        expect(e_inv == 0, f"K4 route inv != twin at n={degree} bits={bits}")
        expect(torch.equal(f, harvey(x.data, ctx)),
               f"K4 route != Harvey at n={degree} bits={bits}")
        expect(torch.equal(g, x.data), f"K4 route round trip at n={degree}")
        print(f"K4 route vs twins: u64 n={degree} (sides "
              f"{ntt_mxu_u64._geometry(degree)}) m={ring.nmoduli} "
              f"batch={batch}: fwd and inv equal the route's twin, equal to "
              f"Harvey, round trip exact; launches {grew}")

    # 4b. the same route with NFL_TORCH_DFT_PIPE=1, on K10 (both launches,
    # the first with its epilogue) at the sides-2 and -4 degrees and the
    # bench degree, against the twin
    os.environ["NFL_TORCH_DFT_PIPE"] = "1"
    try:
        for degree, bits, batch in (*SHAPES64[:3], BENCH64):
            ring = nfl.ring_from_modulus("u64", degree, bits)
            ctx = ring.context()
            x = nfl.Poly.from_numpy(ring, rand_residues(ring, rng, batch),
                                    dev)
            names = ("dft_mxu64_pipe", *route64)
            before = {n: k_by_name[n].launches for n in names}
            f = ntt_mxu_u64.ntt_pow_phi_fused(x.data, ctx)
            g = ntt_mxu_u64.invntt_pow_invphi_fused(f, ctx)
            torch.cuda.synchronize()
            grew = {n: k_by_name[n].launches - before[n] for n in names}
            expect(grew == {"dft_mxu64_pipe": 4,
                            **dict.fromkeys(route64, 0)},
                   f"K4 route on K10 at n={degree}: launches {grew}")
            for got, want in (
                    (f, ntt_mxu_u64.ntt_pow_phi_fused_plain(x.data, ctx)),
                    (g, ntt_mxu_u64.invntt_pow_invphi_fused_plain(f, ctx))):
                e = max_err(got, want, ring)
                err["dft_mxu64_pipe"] = max(err["dft_mxu64_pipe"], e)
                expect(e == 0, f"K4 route on K10 != twin at n={degree}")
            expect(torch.equal(g, x.data),
                   f"K4 route on K10: round trip at n={degree}")
            print(f"K4 route on K10 (NFL_TORCH_DFT_PIPE=1): u64 n={degree} "
                  f"(sides {ntt_mxu_u64._geometry(degree)}) m={ring.nmoduli} "
                  f"batch={batch}: fwd and inv equal the twin, round trip "
                  f"exact; launches {grew}")
    finally:
        os.environ.pop("NFL_TORCH_DFT_PIPE")

    # 5. K5 against its twin: matmul_mod on both axes, then _route
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
        f = ntt_mxu._route(x.data, ctx, False)
        f_plain = ntt_mxu._route(x.data, ctx, False, plain=True)
        g = ntt_mxu._route(f, ctx, True)
        g_plain = ntt_mxu._route(f, ctx, True, plain=True)
        torch.cuda.synchronize()
        expect(torch.equal(f, f_plain), f"_route fwd != twin n={degree}")
        expect(torch.equal(g, g_plain), f"_route inv != twin n={degree}")
        expect(torch.equal(g, x.data), f"_route round trip n={degree}")
        if degree == 1 << 17:
            expect(torch.equal(f, harvey(x.data, ctx)),
                   "_route != Harvey at 2^17")
        print(f"K5 with its epilogue, then K5, via _route: u64 "
              f"n={degree} m={ring.nmoduli} batch={batch}: fwd and inv equal "
              f"the twins, round trip exact"
              + (", equal to Harvey" if degree == 1 << 17 else ""))

    # 5a. K9 against its twin on the u32 bench ring: sizes 8/128/1024 on
    # both axes at the per-rank shard widths n2/d (d = 2, 4, 8), and with
    # the twiddle epilogue
    r32 = nfl.ring_from_modulus(*BENCH[:3])
    m32 = r32.nmoduli
    for size in DFT_SIZES:
        for axis in (-2, -1):
            for other in SHARD_OTHERS:
                shape = (2, m32, size, other) if axis == -2 \
                    else (2, m32, other, size)
                xs = rand_slab(r32, rng, shape, dev)
                tw = rand_twiddle(r32, rng, shape[2:], dev) \
                    if other == SHARD_OTHERS[0] else None
                out = dft_mxu.matmul_mod(xs, r32, "dft_fwd", size, axis=axis,
                                         twiddle=tw)
                plain = dft_mxu.matmul_mod_plain(xs, r32, "dft_fwd", size,
                                                 axis=axis, twiddle=tw)
                torch.cuda.synchronize()
                e = max_err(out, plain, r32)
                err["dft_mxu32"] = max(err["dft_mxu32"], e)
                expect(e == 0, f"K9 != twin at size {size} axis {axis} "
                       f"other {other} twiddle {tw is not None}")
    # the extreme inputs x = 0 (every offset digit -128) and x = p - 1 at
    # the largest size, both axes, with and without the epilogue
    p32 = torch.tensor([int(q) for q in r32.moduli], dtype=torch.int64,
                       device=dev).view(1, -1, 1, 1)
    size = DFT_SIZES[-1]
    for axis in (-2, -1):
        shape = (2, m32, size, 16) if axis == -2 else (2, m32, 16, size)
        tw = rand_twiddle(r32, rng, shape[2:], dev)
        for fill in ("0", "p-1"):
            xs = (torch.zeros(shape, dtype=torch.int64, device=dev)
                  + (p32 - 1 if fill == "p-1" else 0)).to(torch.int32)
            for t_ in (None, tw):
                out = dft_mxu.matmul_mod(xs, r32, "dft_fwd", size, axis=axis,
                                         twiddle=t_)
                plain = dft_mxu.matmul_mod_plain(xs, r32, "dft_fwd", size,
                                                 axis=axis, twiddle=t_)
                torch.cuda.synchronize()
                e = max_err(out, plain, r32)
                err["dft_mxu32"] = max(err["dft_mxu32"], e)
                expect(e == 0, f"K9 != twin at x={fill} size {size} axis "
                       f"{axis} twiddle {t_ is not None}")
    print(f"K9 vs twin: u32 m={m32} matmul_mod dft_fwd sizes {DFT_SIZES} on "
          f"both axes at other widths {SHARD_OTHERS}, with and without the "
          f"twiddle epilogue, and x = 0 and x = p - 1 at size {size} on both "
          f"axes with and without it: exact")

    # 5b. K5's epilogue and K10, with and without it, against the twin and
    # K5 on the 2^20 ring; at size 1024 also the extreme inputs x = 0 (all
    # offset digits -128) and x = p - 1
    ringL = nfl.ring_from_modulus("u64", LARGE_MAIN[0], LARGE_MAIN[1])
    pL = torch.tensor([int(q) for q in ringL.moduli], dtype=torch.int64,
                      device=dev).view(1, -1, 1, 1)
    cases5b = [(size, axis, None) for size in DFT_SIZES for axis in (-2, -1)]
    cases5b += [(DFT_SIZES[-1], axis, fill) for axis in (-2, -1)
                for fill in ("0", "p-1")]
    for size, axis, fill in cases5b:
        shape = (2, 2, size, 96) if axis == -2 else (2, 2, 96, size)
        xs = rand_slab(ringL, rng, shape, dev)
        if fill is not None:
            xs = torch.zeros_like(xs) + (pL - 1 if fill == "p-1" else 0)
        tw = rand_twiddle(ringL, rng, shape[2:], dev)
        k5 = dft_mxu.matmul_mod(xs, ringL, "dft_fwd", size, axis=axis)
        k5tw = dft_mxu.matmul_mod(xs, ringL, "dft_fwd", size, axis=axis,
                                  twiddle=tw)
        k10 = dft_mxu.matmul_mod(xs, ringL, "dft_fwd", size, axis=axis,
                                 pipelined=True)
        k10tw = dft_mxu.matmul_mod(xs, ringL, "dft_fwd", size, axis=axis,
                                   pipelined=True, twiddle=tw)
        plain = dft_mxu.matmul_mod_plain(xs, ringL, "dft_fwd", size,
                                         axis=axis)
        plaintw = dft_mxu.matmul_mod_plain(xs, ringL, "dft_fwd", size,
                                           axis=axis, twiddle=tw)
        torch.cuda.synchronize()
        e_tw = max_err(k5tw, plaintw, ringL)
        e_p = max(max_err(k10, plain, ringL),
                  max_err(k10tw, plaintw, ringL))
        e_5 = max_err(k5, plain, ringL)
        err["dft_mxu64"] = max(err["dft_mxu64"], e_5)
        err["dft_mxu64_twiddle"] = max(err["dft_mxu64_twiddle"], e_tw)
        err["dft_mxu64_pipe"] = max(err["dft_mxu64_pipe"], e_p)
        expect(e_5 == 0 and e_tw == 0 and e_p == 0,
               f"K5 / its epilogue / K10 != twin at size {size} axis "
               f"{axis} x={fill or 'random'}: {e_5}, {e_tw}, {e_p}")
        expect(torch.equal(k10, k5) and torch.equal(k10tw, k5tw),
               f"K10 != K5 at size {size} axis {axis}")
    # more slabs (batch x m) than one grid dimension holds (65535)
    xs = rand_slab(ringL, rng, (WIDE_BATCH, 2, 8, 8), dev)
    for axis in (-2, -1):
        k5 = dft_mxu.matmul_mod(xs, ringL, "dft_fwd", 8, axis=axis)
        k10 = dft_mxu.matmul_mod(xs, ringL, "dft_fwd", 8, axis=axis,
                                 pipelined=True)
        plain = dft_mxu.matmul_mod_plain(xs, ringL, "dft_fwd", 8, axis=axis)
        torch.cuda.synchronize()
        e_5, e_p = max_err(k5, plain, ringL), max_err(k10, plain, ringL)
        err["dft_mxu64"] = max(err["dft_mxu64"], e_5)
        err["dft_mxu64_pipe"] = max(err["dft_mxu64_pipe"], e_p)
        expect(e_5 == 0 and e_p == 0, f"K5 / K10 != twin at batch "
               f"{WIDE_BATCH} x m 2, axis {axis}: {e_5}, {e_p}")
    del xs, k5, k10, plain
    print(f"K5 epilogue and K10 vs twin: u64 m=2 sizes {DFT_SIZES} on both "
          f"axes, and x = 0 and x = p - 1 at size {DFT_SIZES[-1]} on both "
          f"axes (K5 too), K10 with and without the epilogue equal to K5; "
          f"K5 and K10 at batch {WIDE_BATCH} x m 2 (size 8, both axes): "
          f"exact")

    # 5c. K11 against its twin at the u64 2^20 x 2 x 2 twiddle shape
    n1L, n2L = ntt_mxu_u64._geometry(ringL.degree)
    xs = rand_slab(ringL, rng, (LARGE_MAIN[2], 2, n1L, n2L), dev)
    tw = rand_twiddle(ringL, rng, (n1L, n2L), dev)
    out = pair_bridge.mulmod_shoup_u64(xs, *tw, ringL)
    plain = pair_bridge.mulmod_shoup_u64_plain(xs, *tw, ringL)
    pairs = pair_bridge.mulmod_shoup_pairs(
        dft_mxu.split_pair(xs), *(dft_mxu.split_pair(t) for t in tw), ringL)
    torch.cuda.synchronize()
    err["pair_bridge64"] = max_err(out, plain, ringL)
    expect(err["pair_bridge64"] == 0, "K11 != twin")
    expect(torch.equal(dft_mxu.merge_pair(pairs), out), "K11 pairs != u64")
    print(f"K11 vs twin: u64 [{LARGE_MAIN[2]}, 2, {n1L}, {n2L}] x "
          f"[2, {n1L}, {n2L}] exact, pair I/O equal")

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

    # 5c. K6 and K8 against their twins: the LWE rings at batches 3 and 64,
    # the u16 rings, and u64 2^15 and 2^16 (the leading stages through
    # device memory, then one pass a segment); inputs with a polynomial of
    # zeros and one of p - 1 in every channel, and keys (pka, pkb, s) at
    # random, at p - 1 and at 0
    def top(r_):
        """[m, 1] p - 1 of each channel in the ring's dtype"""
        return (np.asarray(r_.moduli[:r_.nmoduli], dtype=np.uint64)
                - 1).astype(r_.dtype)[:, None]

    def chain_rows(r_, batch):
        x = rand_residues(r_, rng, batch)
        x[0] = 0
        if batch > 1:
            x[1] = top(r_)
        return nfl.Poly.from_numpy(r_, x, dev).data

    def chain_keys(r_, c_, fill):
        """pka, pkb, s, s': every word random (fill None), p - 1 (fill 1)
        or 0 (fill 0)"""
        keys = []
        for _ in range(3):
            k = rand_residues(r_, rng, 1)
            if fill is not None:
                k[...] = top(r_) * fill
            keys.append(nfl.Poly.from_numpy(r_, k, dev).data[0])
        tabs = c_.to(dev)
        return (*keys, modops.compute_shoup(keys[2], tabs.p_col,
                                            tabs.shoup_f))

    def chain_check(r_, batch):
        """K6/K8 against the twins at `batch` with keys at p - 1, at 0 and
        random; the inputs and outputs of the random keys"""
        c_ = r_.context()
        u64 = r_.limb == "u64"
        mod = ntt_pallas_u64 if u64 else ntt_pallas
        enc, dec = ("lwe64_encrypt", "lwe64_decrypt") if u64 \
            else ("lwe_encrypt", "lwe_decrypt")
        u, e1, e2 = (chain_rows(r_, batch) for _ in range(3))
        for fill in (1, 0, None):
            pka, pkb, sk, sp = chain_keys(r_, c_, fill)
            ra, rb = mod.lwe_encrypt_fused(u, e1, e2, pka, pkb, c_)
            pa, pb = mod.lwe_encrypt_plain(u, e1, e2, pka, pkb, c_)
            d = mod.lwe_decrypt_fused(ra, rb, sk, sp, c_)
            pd = mod.lwe_decrypt_plain(ra, rb, sk, sp, c_)
            torch.cuda.synchronize()
            e_e = max(max_err(ra, pa, r_), max_err(rb, pb, r_))
            e_d = max_err(d, pd, r_)
            err[enc], err[dec] = max(err[enc], e_e), max(err[dec], e_d)
            expect(e_e == 0 and e_d == 0,
                   f"{enc}/{dec} != twins at {r_.limb} n={r_.degree} batch "
                   f"{batch}, keys {fill}")
        print(f"K{8 if u64 else 6} vs twins: {r_.limb} n={r_.degree} "
              f"m={r_.nmoduli} batch={batch} (a polynomial of 0 and one of "
              f"p - 1): encrypt (resa, resb) and decrypt exact with random "
              f"keys, keys at p - 1 and at 0")
        return (u, e1, e2, pka, pkb), (ra, rb, sk, sp)

    lwe_args = {}
    for limb, degree, bits in LWE_RINGS:
        r_ = nfl.ring_from_modulus(limb, degree, bits)
        for batch in LWE_BATCHES:
            enc_args, dec_args = chain_check(r_, batch)
        lwe_args[limb] = (r_, enc_args, dec_args)
    for limb, degree, bits, batch in CHAIN_SHAPES:
        chain_check(nfl.ring_from_modulus(limb, degree, bits), batch)

    launches = {}
    fused_all = ("dft_mxu32", "dft_mxu64", "dft_mxu64_twiddle")
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

    def route_drive(tier, fwd_name, inv_name, x_, y_):
        """the product of x_ and y_, driven as its forward transforms,
        then the Shoup product and the inverse, so that the route counts
        its launches a direction"""
        names = ROUTE_KERNELS[tier]
        (fx, fy), got = drive(
            names, lambda: (x_.ntt_pow_phi(), y_.ntt_pow_phi()),
            zero=("dft_mxu64_pipe",), record=False)
        route_launches[fwd_name] = sum(got.get(n, 0) for n in names)
        out, got = drive(
            names, lambda: nfl.shoup(
                fx * fy, nfl.compute_shoup(fy)).invntt_pow_invphi(),
            zero=("dft_mxu64_pipe",), record=False)
        route_launches[inv_name] = sum(got.get(n, 0) for n in names)
        return fx, out

    # 6. the u32 main path through Poly at the bench shape: the product
    # a*b, its transforms on the route (two K9 launches each)
    limb, degree, bits, batch = BENCH
    ring = nfl.ring_from_modulus(limb, degree, bits)
    ctx = ring.context()
    stream = Salsa20Stream(bytes(range(32)))
    a, b = sample_batch(ring, batch, stream), sample_batch(ring, batch, stream)
    route_launches = {}
    fa, c = route_drive("u32", "ntt32_route_fwd", "ntt32_route_inv", a, b)
    expect(route_launches == {"ntt32_route_fwd": 4, "ntt32_route_inv": 2},
           f"u32 route launches {route_launches}")
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
          f"schoolbook at n=64 m=2, round trip; route launches (K9) "
          f"{route_launches}")
    u32_state = (ring, ctx, a, c)

    # 7. the u64 main path through Poly at n = 2^14 x 8 x 62-bit (496-bit q):
    # the product a*b, its transforms on K4's route (two K5 launches each)
    degree, bits, batch = BENCH64
    ring64 = nfl.ring_from_modulus("u64", degree, bits)
    ctx64 = ring64.context()
    stream = Salsa20Stream(bytes(range(32)))
    a64 = sample_batch(ring64, batch, stream)
    b64 = sample_batch(ring64, batch, stream)
    fa64, c64 = route_drive("u64", "ntt64_route_fwd", "ntt64_route_inv", a64,
                            b64)
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
          f"trip, schoolbook at n=32 m=2, round trip; K4 route launches "
          f"(K5 with the epilogue + K5) "
          f"{ {n: route_launches[n] for n in route_launches if '64' in n} }")

    # 8. the u64 main path at n = 2^20 x 2 moduli, batch 2 (K5 twice a way)
    degree, bits, batch = LARGE_MAIN
    ringL = nfl.ring_from_modulus("u64", degree, bits)
    ctxL = ringL.context()
    aL = sample_batch(ringL, batch, stream)
    bL = sample_batch(ringL, batch, stream)
    cL = drive(route64, lambda: product(nfl, aL, bL),
               zero=("dft_mxu64_pipe",))[0]
    expect(cL.data.shape == (batch, ringL.nmoduli, degree),
           "large product shape")
    check_coeffs(aL, bL, cL, ringL, 8)
    expect(aL.ntt_pow_phi().invntt_pow_invphi() == aL, "large round trip")
    print(f"main path u64: c = a*b at n={degree} m={ringL.nmoduli} "
          f"batch={batch}: 8 Python-int coefficients, round trip; launches "
          f"{ {n: launches[n] for n in route64} }")

    # 8a. the distributed four-step NTT under NCCL with one rank (the card
    # holds one; the sharded math at d = 2, 4, 8 is checked on the CPU with
    # gloo): forward, pointwise Shoup product, inverse
    torch.cuda.set_device(dev)
    got = dist_api.init_distributed(
        f"file://{rdzv}/rdzv", 1, 0, backend="nccl",
        timeout=datetime.timedelta(seconds=300))
    expect(got == (0, 1), f"process group {got}")

    def four_view(t, r_):
        """the rank's column block: at one rank the whole [B, m, n1, n2]"""
        n1_ = 1 << ((r_.degree.bit_length() - 1) // 2)
        return t.reshape(t.shape[:-1] + (n1_, r_.degree // n1_))

    def dist_product(r_, x_, y_, **kw):
        """(forward of x_, inverse of fwd(x_) * fwd(y_)) through the
        distributed entry points"""
        t_ = r_.context().to(dev)
        p3 = t_.p_col[..., None]
        fx = ntt_dist.distributed_ntt_pow_phi(four_view(x_.data, r_), r_,
                                              **kw)
        fy = ntt_dist.distributed_ntt_pow_phi(four_view(y_.data, r_), r_,
                                              **kw)
        prod = modops.mulmod_shoup(fx, fy, modops.compute_shoup(
            fy, p3, t_.shoup_f[..., None]), p3)
        return fx, ntt_dist.distributed_invntt_pow_invphi(prod, r_, **kw)

    def harvey_of(four, r_):
        """harvey[j] = E[bitrev(j)] with E[k1 + n1 k2] = four[k1, k2]"""
        E = four.transpose(-1, -2).reshape(four.shape[:-2] + (r_.degree,))
        return torch.index_select(E, -1, r_.context().to(dev).bitrev)

    def dist_checks(r_, x_, c_, fx, back, tag):
        vx = four_view(x_.data, r_)
        expect(torch.equal(back.reshape(c_.data.shape), c_.data),
               f"{tag}: distributed product != single-chip product")
        expect(torch.equal(harvey_of(fx, r_), x_.ntt_pow_phi().data),
               f"{tag}: forward != single-chip NTT by bit reversal")
        variants = {
            "ppermute": ntt_dist.distributed_ntt_pow_phi(
                vx, r_, transpose="ppermute"),
            "chunks=2": ntt_dist.distributed_ntt_pow_phi(vx, r_, chunks=2),
            "pipelined": ntt_dist.distributed_ntt_pow_phi_pipelined(vx, r_)}
        for name, v in variants.items():
            expect(torch.equal(v, fx), f"{tag}: {name} forward != a2a")
        for kw in ({"transpose": "ppermute"}, {"chunks": 2}):
            expect(torch.equal(ntt_dist.distributed_invntt_pow_invphi(
                fx, r_, **kw), vx), f"{tag}: inverse {kw} round trip")

    dist_state = {}
    for tag, r_, x_, y_, c_, kern in (
            (f"u32 n={BENCH[1]} m={ring.nmoduli} batch={BENCH[3]}", ring, a,
             b, c, "dft_mxu32"),
            (f"u64 n={degree} m={ringL.nmoduli} batch={batch}", ringL, aL,
             bL, cL, "dft_mxu64")):
        t0 = time.perf_counter()
        (fx, back), counts = drive(
            (kern,), lambda: dist_product(r_, x_, y_),
            zero=("dft_mxu64_pipe",))
        dist_checks(r_, x_, c_, fx, back, tag)
        dist_state[r_.limb] = (r_, four_view(x_.data, r_), back)
        print(f"main path distributed {tag} (NCCL, 1 rank): fwd, Shoup "
              f"product, inv equal the single-chip product; forward equals "
              f"ntt_pow_phi by bit reversal; ppermute, chunks=2 and the "
              f"pipelined entry equal a2a, inverse round trips; launches "
              f"{counts}; {time.perf_counter() - t0:.1f} s")

    # 8a'. the u64 path again with NFL_TORCH_DFT_PIPE=1: K10 in K5's place
    os.environ["NFL_TORCH_DFT_PIPE"] = "1"
    try:
        (fxp, backp), counts = drive(
            ("dft_mxu64_pipe",), lambda: dist_product(ringL, aL, bL),
            zero=("dft_mxu64",))
    finally:
        os.environ.pop("NFL_TORCH_DFT_PIPE")
    expect(torch.equal(backp, dist_state["u64"][2]),
           "K10 distributed product != K5's")
    print(f"main path distributed u64 with NFL_TORCH_DFT_PIPE=1: equal to "
          f"K5's; launches {counts}")

    # 8a''. the large-degree u64 forward with its twiddle in K11 (pair
    # I/O, matmul -> pair bridge -> matmul) and in K5's epilogue
    twL = ntt_mxu._twiddle_device(ringL, False, dev)
    xLv = aL.data.reshape(batch, ringL.nmoduli, n1L, n2L)

    def chain_bridge():
        f = dft_mxu.matmul_mod(xLv, ringL, "ntt64_e1_fwd", n1L, axis=-2,
                               pair_out=True)
        f = pair_bridge.mulmod_shoup_pairs(
            f, *(dft_mxu.split_pair(t) for t in twL), ringL)
        return dft_mxu.matmul_mod(f, ringL, "ntt64_e2_fwd", n2L, axis=-1)

    def chain_epilogue():
        f = dft_mxu.matmul_mod(xLv, ringL, "ntt64_e1_fwd", n1L, axis=-2,
                               twiddle=twL)
        return dft_mxu.matmul_mod(f, ringL, "ntt64_e2_fwd", n2L, axis=-1)

    want = aL.ntt_pow_phi().data.reshape(xLv.shape)
    for kern, chain in (("pair_bridge64", chain_bridge),
                        ("dft_mxu64_twiddle", chain_epilogue)):
        out, counts = drive((kern,), chain, record=kern == "pair_bridge64")
        expect(torch.equal(out, want), f"large forward via {kern} != "
               f"_route")
        expect(counts.get("dft_mxu64", 0) > 0,
               f"large forward via {kern}: K5 not launched ({counts})")
        print(f"main path u64 n={degree} forward with the twiddle in "
              f"{kern}: equal to _route; launches {counts}")

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
                    "auto": route64}
        else:
            want = {"butterfly": ("ntt_butterfly_fwd", "lwe_encrypt",
                                  "lwe_decrypt"),
                    "auto": ROUTE_KERNELS["u32"]}
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
    expect(torch.equal(cb.data, c.data),
           "butterfly u32 product != the u32 route's")
    expect(torch.equal(c64b.data, c64.data),
           "butterfly u64 product != the K4 route's")
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

    def raises(fn, *args):
        try:
            fn(*args)
        except AssertionError:
            return True
        return False
    debug.set_strictmod(True)
    try:
        r16 = nfl.ring_from_modulus("u16", 512, 14)
        x16 = nfl.Poly.from_numpy(r16, rand_residues(r16, rng, 2), dev).data
        for r_, x_ in ((ring, a.data), (r16, x16), (ring64, a64.data)):
            bad = x_.clone()
            bad[0, 0, 0] = int(r_.moduli[0])
            expect(raises(ntt.ntt_pow_phi, bad, r_.context()),
                   f"strict mode let a {r_.limb} residue p through")
        # a twiddle that disagrees with its Shoup companion breaks the first
        # launch's output contract: its epilogue flags the block, the
        # poison pass fills it with all-ones words, the second launch sees
        # the poisoned input and keeps it poisoned, and the bracket raises.
        # The route reads its twiddle through _twiddle_device, swapped here
        # for a broken one: the u32 and a u16 ring on K9, the u64 ring on
        # K5 and again on K10 (NFL_TORCH_DFT_PIPE=1)
        twiddle_device = ntt_mxu._twiddle_device
        try:
            for r_, x3, valid, pipe, first in (
                    (ring, a.data[:2].contiguous(), fa.data[:2], "0",
                     "dft_mxu32"),
                    (r16, x16, None, "0", "dft_mxu32"),
                    (ring64, a64.data[:2].contiguous(), fa64.data[:2], "0",
                     "dft_mxu64_twiddle"),
                    (ring64, a64.data[:2].contiguous(), None, "1",
                     "dft_mxu64_pipe")):
                ctx_ = r_.context()
                os.environ["NFL_TORCH_DFT_PIPE"] = pipe
                ntt_mxu._twiddle_device = twiddle_device
                if valid is not None:
                    expect(torch.equal(ntt_mxu._route(x3, ctx_, False),
                                       valid),
                           f"strict route changed a valid {r_.limb} "
                           f"transform")
                tw_, tws_ = twiddle_device(r_, False, dev)
                broken = (torch.full_like(tw_, (1 << 63) - 1
                                          if r_.limb == "u64"
                                          else 0x7FFFFFFF), tws_)
                ntt_mxu._twiddle_device = lambda *args, b=broken: b
                twin = ntt_mxu._route(x3, ctx_, False, plain=True)
                before = k_by_name[first].launches
                poisoned = ntt_mxu._route(x3, ctx_, False)
                expect(k_by_name[first].launches > before,
                       f"strict route did not launch {first}")
                expect(torch.equal(poisoned, twin)
                       and bool((poisoned == -1).all()),
                       f"the {r_.limb} route's poison on {first} differs "
                       f"from the twin's")
                expect(raises(ntt._strict_bracket,
                              lambda v: ntt_mxu._route(v, ctx_, False), x3,
                              ctx_),
                       f"strict bracket let the {r_.limb} route's poison "
                       f"through on {first}")
        finally:
            ntt_mxu._twiddle_device = twiddle_device
            os.environ.pop("NFL_TORCH_DFT_PIPE", None)
    finally:
        debug.set_strictmod(False)
    print("strict mode: a residue equal to p raises (u32, u16, u64); the "
          "broken-contract poison of the u32 and u16 routes (on K9's "
          "epilogue, then K9) and of the K4 route (on K5's epilogue, then "
          "K5; and on K10 twice) matches the twins and raises")

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
        "ntt32_route_fwd": (
            lambda v: ntt_mxu.ntt_pow_phi_fused(v, ctx),
            lambda v: ntt_mxu._route(v, ctx, False, plain=True),
            a.data, ring, BENCH[3], bench32 + " (K1 as two K9 launches, the "
            "route's twin)"),
        "ntt32_route_inv": (
            lambda v: ntt_mxu.invntt_pow_invphi_fused(v, ctx),
            lambda v: ntt_mxu._route(v, ctx, True, plain=True),
            c.data, ring, BENCH[3], bench32 + " (K2 as two K9 launches, the "
            "route's twin)"),
        "ntt64_route_fwd": (
            lambda v: ntt_mxu_u64.ntt_pow_phi_fused(v, ctx64),
            lambda v: ntt_mxu._route(v, ctx64, False, plain=True),
            a64.data, ring64, BENCH64[2], bench64 + " (K4 as two K5 "
            "launches, the route's twin)"),
        "ntt64_route_inv": (
            lambda v: ntt_mxu_u64.invntt_pow_invphi_fused(v, ctx64),
            lambda v: ntt_mxu._route(v, ctx64, True, plain=True),
            c64.data, ring64, BENCH64[2], bench64 + " (K4 as two K5 "
            "launches, the route's twin)"),
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
    v32 = dist_state["u32"][1]           # [64, 17, 128, 128]
    nb = v32.shape[-2]
    one_L = (f"one launch, size {n1} left, n={ringL.degree} "
             f"m={ringL.nmoduli} batch={LARGE_MAIN[2]}")
    cases.update({
        "dft_mxu32": (
            lambda v: dft_mxu.matmul_mod(v, ring, "fourstep_col_fwd_tw", nb,
                                         axis=-2),
            lambda v: dft_mxu.matmul_mod_plain(v, ring, "fourstep_col_fwd_tw",
                                               nb, axis=-2),
            v32, ring, BENCH[3], f"one launch, size {nb} left (the "
            f"distributed column DFT), {bench32}"),
        "dft_mxu64_twiddle": (
            lambda v: dft_mxu.matmul_mod(v, ringL, "ntt64_e1_fwd", n1,
                                         axis=-2, twiddle=twL),
            lambda v: dft_mxu.matmul_mod_plain(v, ringL, "ntt64_e1_fwd", n1,
                                               axis=-2, twiddle=twL),
            xL, ringL, LARGE_MAIN[2], one_L + " with the twiddle epilogue"),
        "dft_mxu64_pipe": (
            lambda v: dft_mxu.matmul_mod(v, ringL, "ntt64_e1_fwd", n1,
                                         axis=-2, pipelined=True),
            lambda v: dft_mxu.matmul_mod_plain(v, ringL, "ntt64_e1_fwd", n1,
                                               axis=-2),
            xL, ringL, LARGE_MAIN[2], one_L),
        "pair_bridge64": (
            lambda v: pair_bridge.mulmod_shoup_u64(v, *twL, ringL),
            lambda v: pair_bridge.mulmod_shoup_u64_plain(v, *twL, ringL),
            xL, ringL, LARGE_MAIN[2], f"[{LARGE_MAIN[2]}, 2, {n1}, {n2}] "
            f"by the _route twiddle"),
    })
    times = {}
    for name, (kern, plain, arg, r_, batch, what) in cases.items():
        times[name] = compare(kern, plain, arg)
        rate = batch * r_.nmoduli / (times[name][0] * 1e-3)
        unit = "channel-chains/s" if name.startswith("lwe") \
            else "channel-NTT/s" if name.startswith("ntt") \
            else "channel-twiddles/s" if name.startswith("pair") \
            else "channel-stages/s"
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
        print(f"timing _route {'inv' if inverse else 'fwd'}: K5 path "
              f"{tk:.4f} ms ({rate:.0f} channel-NTT/s), twin path "
              f"{tp:.4f} ms, median of {TIMING_RUNS}, n={ringL.degree} "
              f"m={ringL.nmoduli} batch={xL.shape[0]} | {card}")

    # 10a'. K11's launch path: its kernel is about as short as a launch
    # from Python, so its sample may time the host.  The host's ms a call
    # (100 calls, no sync between them), the events' ms a call over the same
    # 100 back-to-back, and the device's own ms a call (torch.profiler)
    k11 = cases["pair_bridge64"][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        k11(xL)
    t_host = (time.perf_counter() - t0) * 1e3 / 100
    torch.cuda.synchronize()
    t_ev = timed(k11, xL, 100)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            k11(xL)
        torch.cuda.synchronize()
    t_dev = "not measured (no device time in the profile)"
    for evt in prof.key_averages():
        us = max(getattr(evt, a, 0) or 0 for a in (
            "self_device_time_total", "self_cuda_time_total"))
        if "pair_bridge64_kernel" in evt.key and us > 0:
            t_dev = f"{us / evt.count / 1e3:.4f} ms ({evt.count} kernels)"
    print(f"K11 launch path: host {t_host:.4f} ms a call (100 calls, host "
          f"clock), events {t_ev:.4f} ms a call (100 back-to-back), device "
          f"{t_dev} (torch.profiler), [{LARGE_MAIN[2]}, 2, {n1}, {n2}] | "
          f"{card}")

    # 10a''. one encrypt call of K6 and of K8 on the LWE rings: its CUDA
    # kernel launches (torch.profiler; one a chunk of polynomials) and
    # device time, at batch 64 and at the app's batch 1; the kernel's
    # events time at batch 1 beside batch 64
    for limb, (r_, enc_args, dec_args) in lwe_args.items():
        c_ = r_.context()
        mod = ntt_pallas_u64 if limb == "u64" else ntt_pallas
        name = "lwe64_encrypt" if limb == "u64" else "lwe_encrypt"
        for batch in (enc_args[0].shape[0], 1):
            args = tuple(v[:batch] for v in enc_args[:3]) + enc_args[3:]
            mod.lwe_encrypt_fused(*args, c_)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                mod.lwe_encrypt_fused(*args, c_)
                torch.cuda.synchronize()
            kern = [(evt.key, evt.count, max(
                getattr(evt, a_, 0) or 0 for a_ in (
                    "self_device_time_total", "self_cuda_time_total")))
                    for evt in prof.key_averages()]
            kern = [(k_, n_, us) for k_, n_, us in kern if us > 0]
            n_launch = sum(n_ for _, n_, _ in kern)
            chunks = len(_kernels.batch_chunks(batch))
            expect(n_launch == chunks,
                   f"{name} at batch {batch}: {n_launch} CUDA launches, "
                   f"not {chunks}: {kern}")
            ms1 = timed(lambda v: mod.lwe_encrypt_fused(*v, c_), args,
                        KERNEL_REPS)
            ms_d = timed(lambda v: mod.lwe_decrypt_fused(*v, c_), tuple(
                v[:batch] for v in dec_args[:2]) + dec_args[2:],
                KERNEL_REPS)
            print(f"{name} {limb} n={r_.degree} m={r_.nmoduli} batch={batch}"
                  f": {n_launch} CUDA launch ({chunks} chunk): "
                  + "; ".join(f"{k_} x{n_} {us / n_ / 1e3:.4f} ms device"
                              for k_, n_, us in kern)
                  + f" (torch.profiler); events {ms1:.4f} ms an encrypt, "
                  f"{ms_d:.4f} ms a decrypt ({KERNEL_REPS} back to back) | "
                  f"{card}")

    # 10b. A/B of the two NTT formulations and of the LWE graphs' modes
    for tag, (k_b, k_f, arg, what) in {
            "K3 fwd vs the u32 route": (cases["ntt_butterfly_fwd"][0],
                                        cases["ntt32_route_fwd"][0], a.data,
                                        bench32),
            "K3 inv vs the u32 route": (cases["ntt_butterfly_inv"][0],
                                        cases["ntt32_route_inv"][0], c.data,
                                        bench32),
            "K7 fwd vs the K4 route": (cases["ntt_butterfly64_fwd"][0],
                                       cases["ntt64_route_fwd"][0], a64.data,
                                       bench64),
            "K7 inv vs the K4 route": (cases["ntt_butterfly64_inv"][0],
                                       cases["ntt64_route_inv"][0], c64.data,
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

    # 10c'. A/B of K10 against K5, and of the twiddle between the two
    # mod-matmuls of the large-degree forward: K5's epilogue, K5 then K11,
    # K5 then the plain modops.mulmod_shoup (ntt_dist._twiddle_mul, the JAX
    # package's _large_run64)
    p3L = ctxL.to(dev).p_col[..., None]

    def mm(v, **kw):
        return dft_mxu.matmul_mod(v, ringL, "ntt64_e1_fwd", n1, axis=-2,
                                  **kw)
    for tag, (k_1, k_2) in {
            "K10 vs K5": (lambda v: mm(v, pipelined=True), mm),
            "K10 vs K5, both with the epilogue": (
                lambda v: mm(v, pipelined=True, twiddle=twL),
                lambda v: mm(v, twiddle=twL)),
            "K5 epilogue vs K5 + plain twiddle": (
                lambda v: mm(v, twiddle=twL),
                lambda v: modops.mulmod_shoup(mm(v), *twL, p3L)),
            "K5 + K11 vs K5 + plain twiddle": (
                lambda v: pair_bridge.mulmod_shoup_u64(mm(v), *twL, ringL),
                lambda v: modops.mulmod_shoup(mm(v), *twL, p3L))}.items():
        t1, t2 = compare(k_1, k_2, xL, (KERNEL_REPS, KERNEL_REPS))
        print(f"A/B {tag}: {t1:.4f} ms vs {t2:.4f} ms, ratio "
              f"{t2 / t1:.4f}, medians of {TIMING_RUNS} samples of "
              f"{KERNEL_REPS} back-to-back calls in turns, {one_L} | {card}")
    # K10 against K5 at size 128, the K4 route's first stage at u64 2^14 x
    # 8 x 64 (8.4 M outputs a launch)
    n1b = ntt_mxu_u64._geometry(ring64.degree)[0]
    x128 = a64.data.reshape(BENCH64[2], ring64.nmoduli, n1b, -1)
    tw128 = ntt_mxu._twiddle_device(ring64, False, dev)

    def mm128(v, **kw):
        return dft_mxu.matmul_mod(v, ring64, "ntt64_e1_fwd", n1b, axis=-2,
                                  **kw)
    for tag, (k_1, k_2) in {
            "K10 vs K5": (lambda v: mm128(v, pipelined=True), mm128),
            "K10 vs K5, both with the epilogue": (
                lambda v: mm128(v, pipelined=True, twiddle=tw128),
                lambda v: mm128(v, twiddle=tw128))}.items():
        t1, t2 = compare(k_1, k_2, x128, (KERNEL_REPS, KERNEL_REPS))
        print(f"A/B {tag} at size {n1b}: {t1:.4f} ms vs {t2:.4f} ms, ratio "
              f"{t2 / t1:.4f}, medians of {TIMING_RUNS} samples of "
              f"{KERNEL_REPS} back-to-back calls in turns, one launch, "
              f"size {n1b} left, {bench64} | {card}")

    # 10c''''. A/B of K9's two finishes at the u32 route's first launch
    # (u32 64 x 17 x 128 x 128, size 128 left, with and without the twiddle
    # epilogue): the u32 part reduction (a28 with floor(2^60/p), exact for
    # p > 2^28) against the small-p one the u16 rings take (__umul64hi
    # with floor(2^64/p), exact for every p < 2^31), on the same u32 words
    t32 = dft_mxu.dft_tables(ring, "ntt64_e1_fwd", nb, True, dev)
    small = dataclasses.replace(t32, small_p=True, consts=t32.consts.clone())
    small.consts[:, 1] = torch.tensor([(1 << 64) // int(q)
                                       for q in ring.moduli], device=dev)
    tw32 = ntt_mxu._twiddle_device(ring, False, dev)
    for tw_ in (tw32, None):
        want = dft_mxu.matmul_plain(v32, t32, tw_)
        for t_ in (t32, small):
            got = _kernels.DFT_MXU32(v32, t_, tw_)
            torch.cuda.synchronize()
            expect(torch.equal(got, want), f"K9 (small_p={t_.small_p}) != "
                   f"twin at the u32 route's first launch")
        t_u, t_s = compare(lambda v: _kernels.DFT_MXU32(v, t32, tw_),
                           lambda v: _kernels.DFT_MXU32(v, small, tw_), v32,
                           (KERNEL_REPS, KERNEL_REPS))
        print(f"A/B K9 finish {'with' if tw_ else 'without'} the twiddle "
              f"epilogue: u32 (floor(2^60/p)) {t_u:.4f} ms, small-p "
              f"(floor(2^64/p)) {t_s:.4f} ms, small-p costs "
              f"{100 * (t_s / t_u - 1):+.2f} %, both equal the twin; medians "
              f"of {TIMING_RUNS} samples of {KERNEL_REPS} back-to-back calls "
              f"in turns, one launch, size {nb} left, {bench32} | {card}")
    del want, got

    # 10c'''. a yardstick the port never calls: the 64 digit products of one
    # K5 launch as one cuBLAS int8 product per channel (torch._int_mm,
    # [8 size, size] table planes @ [size, 8 B other] x digits).  It forms
    # no group sum and no residue, so library_ms stays null.
    dtL = dft_mxu.dft_tables(ringL, "ntt64_e1_fwd", n1, True, dev)
    digits = torch.stack([((xL >> (8 * b_)) & 0xFF) - 128
                          for b_ in range(8)]).to(torch.int8)
    wL = dtL.planes.view(torch.int8).view(ringL.nmoduli, n1, n1, 8)
    mm_a = [wL[ch].permute(2, 0, 1).reshape(8 * n1, n1)
            for ch in range(ringL.nmoduli)]
    mm_b = [digits[:, :, ch].permute(2, 0, 1, 3).reshape(n1, -1).contiguous()
            for ch in range(ringL.nmoduli)]

    mm_ops = sum(2 * a_.shape[0] * a_.shape[1] * b_.shape[1]
                 for a_, b_ in zip(mm_a, mm_b))
    layouts = {"row-major": mm_b,
               "column-major": [b_.t().contiguous().t() for b_ in mm_b]}
    ran = 0
    for layout, bs in layouts.items():
        def int_mm(_, bs=bs):
            return [torch._int_mm(a_, b_) for a_, b_ in zip(mm_a, bs)]
        try:
            int_mm(None)
        except RuntimeError as exc:
            print(f"yardstick torch._int_mm, mat2 {layout}: refused ({exc})")
            continue
        t_mm, t_k5 = compare(int_mm, mm, xL, (KERNEL_REPS, KERNEL_REPS))
        ran += 1
        rate = mm_ops / (t_mm * 1e-3)
        print(f"yardstick torch._int_mm, mat2 {layout}: {t_mm:.4f} ms for the "
              f"64 digit products of one K5 launch ({ringL.nmoduli} x "
              f"[{8 * n1}, {n1}] @ [{n1}, {bs[0].shape[1]}] int8 -> int32, "
              f"{mm_ops / 1e9:.1f} G ops: {rate / 1e12:.1f} T ops/s, "
              f"{100 * rate / INT8_OPS_PER_S:.1f} % of the dense peak), K5 "
              f"{t_k5:.4f} ms ({mm_ops / (t_k5 * 1e-3) / 1e12:.1f} T ops/s), "
              f"medians of {TIMING_RUNS} samples of {KERNEL_REPS} "
              f"back-to-back calls in turns, {one_L} | {card}")
    expect(ran > 0, "yardstick: torch._int_mm refused both mat2 layouts")
    del layouts
    del digits, wL, mm_a, mm_b

    # 10c''. the distributed round trips end to end (NCCL, one rank),
    # against the single-chip round trip of the same tensor
    for limb, (r_, vx, _) in dist_state.items():
        c_ = r_.context()

        def dist_rt(v, r_=r_):
            return ntt_dist.distributed_invntt_pow_invphi(
                ntt_dist.distributed_ntt_pow_phi(v, r_), r_)

        def single_rt(v, r_=r_, c_=c_):
            flat = v.reshape(v.shape[:-2] + (r_.degree,))
            return ntt.invntt_pow_invphi(ntt.ntt_pow_phi(flat, c_), c_)
        td, ts = compare(dist_rt, single_rt, vx, (1, 1))
        print(f"timing distributed round trip {limb} n={r_.degree} "
              f"m={r_.nmoduli} batch={vx.shape[0]} (fwd + inv, a2a, one "
              f"NCCL rank): {td:.4f} ms, single-chip round trip "
              f"{ts:.4f} ms, one call a sample, medians of {TIMING_RUNS} "
              f"in turns | {card}")

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
    # K5, its epilogue and K10: 64 digit products (128 int8 operations) a
    # multiply-add position; bytes: x, out and the tables (and the
    # twiddle).  What the design moves besides, the digit-split scratch
    # written and read and the route's intermediate, is not the function's
    # and is printed apart ("design traffic")
    design = {}

    def scratch(x, t):
        """bytes of one launch's digit-split scratch, written and read"""
        other = x.shape[-1] if t.left else x.shape[-2]
        return 2 * x.numel() // (x.shape[-1] * x.shape[-2]) * t.ndig \
            * t.kp * other
    dt = dft_mxu.dft_tables(ringL, "ntt64_e1_fwd", n1, True, dev)
    k5_ms = (128 * n1 * n1 * n2 * xL.shape[0] * ringL.nmoduli
             / INT8_OPS_PER_S * 1e3)
    k5_bytes = 2 * nbytes(xL) + nbytes(dt.mma_planes, dt.corr, dt.consts)
    bounds["dft_mxu64"] = bound(k5_ms, k5_bytes)
    bounds["dft_mxu64_pipe"] = bounds["dft_mxu64"]
    bounds["dft_mxu64_twiddle"] = bound(k5_ms, k5_bytes + nbytes(*twL))
    for name, tw_bytes in (("dft_mxu64", 0), ("dft_mxu64_pipe", 0),
                           ("dft_mxu64_twiddle", nbytes(*twL))):
        design[name] = ("the digit-split scratch", scratch(xL, dt), k5_ms,
                        k5_bytes + tw_bytes)
    # the routes: two launches a transform of K9 at u32 2^14 x 17 x 64 (16
    # digit products, 32 int8 operations a multiply-add position) and of
    # K5 at u64 2^14 x 8 x 64 (64, 128 operations), sizes n1, then n2;
    # bytes: x, out, both launches' tables and the twiddle
    for name, r_, x, inverse in (
            ("ntt32_route_fwd", ring, a.data, False),
            ("ntt32_route_inv", ring, c.data, True),
            ("ntt64_route_fwd", ring64, a64.data, False),
            ("ntt64_route_inv", ring64, c64.data, True)):
        n1_, n2_ = ntt_mxu._geometry(r_.degree)
        stages = ((("ntt64_e2_inv", n2_, False), ("ntt64_e1_inv", n1_, True))
                  if inverse else
                  (("ntt64_e1_fwd", n1_, True), ("ntt64_e2_fwd", n2_, False)))
        slabs = x.shape[0] * r_.nmoduli
        moved = 2 * nbytes(x) + nbytes(
            *ntt_mxu._twiddle_device(r_, inverse, dev))
        xv = x.reshape(slabs, n1_, n2_)
        extra = 2 * nbytes(x)                 # the intermediate
        for prov, size, left in stages:
            t = dft_mxu.dft_tables(r_, prov, size, left, dev)
            moved += nbytes(t.mma_planes, t.corr, t.consts)
            extra += scratch(xv, t)
        ops_ms = (2 * t.ndig ** 2 * slabs * (n1_ * n1_ * n2_ + n1_ * n2_ * n2_)
                  / INT8_OPS_PER_S * 1e3)
        bounds[name] = bound(ops_ms, moved)
        design[name] = ("the intermediate and both digit-split scratches",
                        extra, ops_ms, moved)
    # K9: 16 digit products (32 int8 operations) a multiply-add position;
    # bytes: x, out and the tables
    dt32 = dft_mxu.dft_tables(ring, "fourstep_col_fwd_tw", nb, True, dev)
    ops_ms = 32 * nb ** 3 * v32.shape[0] * ring.nmoduli / INT8_OPS_PER_S \
        * 1e3
    moved = 2 * nbytes(v32) + nbytes(dt32.mma_planes, dt32.corr, dt32.consts)
    bounds["dft_mxu32"] = bound(ops_ms, moved)
    design["dft_mxu32"] = ("the 4-plane digit-split scratch",
                           scratch(v32, dt32), ops_ms, moved)
    # K11: a lazy Shoup product and one conditional subtraction an element
    bounds["pair_bridge64"] = bound(
        int_ms(*(xL.numel() * steps("u64", "shoup", "red"))),
        2 * nbytes(xL) + nbytes(*twL, pair_bridge._p_words(ringL, dev)))
    # the default flags: forward with the canonical twist and the strict
    # reduction, inverse with the lazy untwist and the strict reduction
    for name, r_, x, inverse in (
            ("ntt_butterfly_fwd", ring, a.data, False),
            ("ntt_butterfly_inv", ring, c.data, True),
            ("ntt_butterfly64_fwd", ring64, a64.data, False),
            ("ntt_butterfly64_inv", ring64, c64.data, True)):
        t = ntt_pallas.kernel_tables(r_, dev)
        tw = (t.iwp, t.itwp) if inverse else (t.wp, t.twp)
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
            + nbytes(t.wp, t.twp, t.p, t.pn if limb == "u64" else t.bm))
        bounds[f"{pre}_decrypt"] = bound(
            int_ms(*dec), nbytes(*dec_args) + nbytes(dec_args[0])
            + nbytes(t.iwp, t.itwp, t.p))
    for name in (*KERNELS, *ROUTES):
        print(f"bound {name}: {bounds[name][0]:.4f} ms ({bounds[name][1]}), "
              f"kernel {times[name][0]:.4f} ms, "
              f"{100 * bounds[name][0] / times[name][0]:.1f} % of the bound "
              f"| {card}")
    for name, (what, extra, ops_ms, moved) in design.items():
        with_it = bound(ops_ms, moved + extra)
        print(f"design traffic {name}: {what}, {extra / 1e6:.1f} MB written "
              f"and read ({extra / HBM_BYTES_PER_S * 1e3:.4f} ms at HBM's "
              f"rate), not in the bound; the function's own bytes "
              f"{moved / 1e6:.1f} MB; counted in, the bound would be "
              f"{with_it[0]:.4f} ms ({with_it[1]}), "
              f"{100 * with_it[0] / times[name][0]:.1f} % of the kernel "
              f"| {card}")

    # 11. result
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    launches.update(route_launches)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, (src, rep) in {**KERNELS, **ROUTES}.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
