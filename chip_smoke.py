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
after, under NFL_TORCH_NTT=fused (the four-step routes) unless named:
  * u32: the R_q product a*b (forward NTT, Shoup product, inverse NTT) at
    n = 2^14 x 17 u32 moduli, batch 64 (the route of K1/K2: two K9
    launches a transform, the twiddle in the first one's epilogue);
  * u64: the same product at n = 2^14 x 8 62-bit moduli (a 496-bit q),
    batch 64, and at n = 2^20 x 2 moduli, batch 2 (both K4's route: two
    K5 launches a transform, the twiddle in the first one's epilogue);
  * the LWE demo (apps/lwe.py: keygen, 10 encryptions and decryptions of
    zero, the zero-sum gate) on u32 (16384, 510) and u64 (16384, 496) under
    NFL_TORCH_NTT=butterfly (K3/K7 in keygen, the chain kernels K6/K8),
    fused (K9, K5) and auto (K3/K7 and E1), with equal keys and
    ciphertexts in every mode;
  * the product of the first two paths under NFL_TORCH_NTT=butterfly and
    auto (the butterfly kernels K3, K7 both ways; in auto the 2^20
    product on the route), equal to the fused-mode products;
  * lwe.encrypt_on_device on the same rings, in butterfly, fused and auto
    modes, with the fixed-consumption and the stream-exact device
    Gaussian: S3
    (csrc/gaussian_fixed.cu, the three Gaussians of an encryption in one
    launch) or S4 (csrc/gaussian_exact.cu, two launches a sampler), each
    making its keystream in shared memory, feed K6/K8, the routes or K3/K7
    with no host <-> device copy and no synchronisation (torch.profiler: 2
    CUDA kernels a fixed call in butterfly mode, 7 an exact one; 15 and 20
    in fused mode, 6 and 11 in auto, two of them E1's muladds),
    the zero-sum gate holds and the exact ciphertexts equal the host
    encrypt's; Poly.sample_on_device with uniform (u64 2^20 x 2 and the
    LWE rings), non_uniform and ZO_dist (the LWE rings), each one launch
    of S1 (csrc/salsa20.cu) with the sampler's epilogue and one CUDA
    kernel a call, equal to the host sampler; and hwt_dist and
    device_hwt_exact, one launch of S5 or S6 (csrc/hwt.cu) each and at
    most two CUDA kernels a call at the LWE rings, the first over CTAs on
    more than one SM (the fixed one equal to its twin and its CPU run,
    the exact one to the host sampler and its nonce advance, each over
    HWT_NONCES nonces a ring);
  * the native host runtime (native.py over nfllib_tpu_torch/csrc/
    nfl_native.cpp, built with g++ at first use) under the host LWE path:
    keygen, encrypt and run_zero_sum_check on both LWE rings in butterfly
    mode at batch 1, timed with the native Gaussian walk and with the
    Python walk, after the native tier is held to the Python tier
    (keystream, uniform, Gaussian walk and samplers, the CRT round trip of
    the 496-bit product); and profiling.trace around encrypt_on_device,
    whose trace file must name the annotation and the chain kernel;
  * E1 (csrc/modops_expr.cu), the one launch of every named Poly op and
    every forced Expr tree (ops/expr_program.py): each opcode and 2 x
    E1_TREES random trees against the twin at u32 2^14 x 17 x 64 and u64
    2^14 x 8 x 64, on residues and extreme words, and a named op and a
    tree on an odd slab and a leaf off the 16-byte grid, so that each
    instance family runs (16-byte vector lanes or one word a step, the
    compiled named op or the interpreter); one CUDA kernel a named op and
    a tree (torch.profiler); the quick-start product in fused mode,
    two E1 launches beside the route's; and in fused and auto modes
    encrypt_on_device's two muladds and decrypt's one program;
  * the mesh's rns axis: on each LWE ring, keys and a batch of 64
    noise polynomials drawn on the whole ring and cut into 2 batch halves x
    2 channel blocks (Ring.channel_block: u32 channels 0-8 and 9-16, u64
    0-3 and 4-7); each block's encrypt and decrypt graphs, decrypt of
    uniform ciphertexts and forward and inverse NTT, in both modes, put
    back together equal the whole ring's bit for bit with the same kernel
    launches a step; and parallel/dryrun.py:dryrun_multichip (the root
    __graft_entry__.py's counterpart) on the NCCL group of one rank;
  * samplers on those channel blocks: every device sampler (S1's uniform,
    non-uniform and ZO instances, S3, S4, S5, S6) and encrypt_on_device
    (fixed and exact, both modes) drawn on each block equal the whole
    ring's rows bit for bit, with the same launches (and the exact
    samplers' advance); so do the host samplers, keygen and encrypt; S1's
    uniform instance also on blocks whose first limb lies off the 64-byte
    keystream grid (u16 n = 8 and 4, u32 n = 8) and on u64 2^20 x 2; the
    exact encryption also at u32 n = 16, where S4's fills hold 18 words,
    whole and on a block in both modes, equal to the host encrypt; each
    block draw is timed beside the whole's;
  * the distributed four-step NTT (parallel/ntt_dist.py) under an NCCL
    process group of one rank on this card: forward, pointwise Shoup
    product and inverse at u32 2^14 x 17 x 64 (local sub-DFTs on K9) and
    u64 2^20 x 2 x 2 (K5; again with NFL_TORCH_DFT_PIPE=1 on K10), equal
    to the single-chip products, with the a2a, ppermute and chunked
    transposes and the pipelined batch entry; and the large-degree u64
    forward chained through pair I/O and the pair bridge K11 (one launch
    of E1's u64 mulmod_shoup), and through K5's twiddle epilogue, equal to
    _route;
  * the repo's measuring scripts through their main(argv): bench_torch.py
    at the main shape in auto, fused and butterfly modes (bench.py's last
    line, each application one K3 launch or two K9), tools/bench_ops_torch.py
    at two points of the reference's matrix (every row finite, every
    device row on the port's kernels) and tools/prng_bench_torch.py with
    the host walk, S3 and S4 (mean and std of 10^6 samples);
and checks the results against the twins, exact Python-int arithmetic, the
CRT-lifted 496-bit big-integer product, the schoolbook oracle and the
golden LWE transcript of the compiled C++ NFLlib (16384_496_u64).  It
reads the built library's SASS (cuobjdump): K5's, K9's and K10's kernels
must issue int8 tensor-core MMAs, and no kernel dp4a; it prints the
instruction mix of the butterfly stage engine's main instances.  The
u16/u32 route runs at every degree from 8 (sides 2 and 4) to 2^15, u16 at
its extreme inputs, and at 65537 polynomials.  S4 runs against its twin
at n = 2 to 16 on every tier for four samplers, at and below its fill
size, where the JAX package's gathers' rule reads a sample's words.  The
LWE chain kernels K6/K8
are held to their twins on the LWE rings, the u16 rings and u64 2^15 and
2^16, with inputs and keys at 0 and p - 1; one encrypt call must issue one
CUDA launch a chunk (torch.profiler), and it is timed at batch 1 beside
batch 64.  It then checks strict mode and
times the kernels against their twins with CUDA events (and K11's launch
path on the host clock and in torch.profiler; each device sampler's
device time), and prints cuBLAS's int8
product (torch._int_mm, both mat2 layouts) on K5's 64 digit products as a
yardstick the port never calls.  Every phase prints one line; any failure
raises and exits nonzero.  The last line is {"ok": true, "device":
{...}}; the line before it lists the kernels, each with its time beside
its bound.

It imports nothing of JAX.  Without CUDA, or without the port beside it,
it exits nonzero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import datetime
import io
import itertools
import json
import os
import re
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
                 (32768, 124, 3), (65536, 124, 3), BENCH64,
                 (32768, 868, 64)]       # the u64 products cell's shape
K7_LARGE = (65536, 124, 8)               # degree, modulus bits, batch
LWE_RINGS = (("u32", 16384, 510), ("u64", 16384, 496))
LWE_REPS = 10
TRACE_ROUNDS = 3         # encrypt_on_device pairs under profiling.trace
LWE_BATCHES = (3, 64)
CHAIN_SHAPES = [("u16", 256, 14, 3), ("u16", 512, 28, 3),
                ("u64", 32768, 124, 3), ("u64", 65536, 124, 2)]
EXACT_GLOBAL = ("u32", 1 << 15, 60)     # S4's walk outgrows shared memory
# S4 at and below its fill size (fills of 2 to 29 words, innoise <=
# word_precision at n <= 8, the JAX package's gathers' rule): each sampler
# (None: apps/lwe.py's make_gaussian_prng(samples=256); else sigma,
# security, samples, in_bits, lu_depth) at each degree of EXACT_SMALL_N on
# each tier, at (EXACT_SMALL_KEY, nonce 7, amp 2), against its twin; and
# against the host walk at EXACT_SMALL_HOST, the cases where the JAX
# package's draw is the host walk's (tests/test_torch_device_sampling.py
# holds the port to the JAX package at the others, where the host walk
# reads past its fill); the exact encryption on EXACT_SMALL_RING whole and
# on its block (8h', 10f)
EXACT_SMALL_KEY = b"\x0b" * 32
EXACT_SMALL_SAMPLERS = {"demo": None,
                        "sigma20": (20.0, 128, 256, 8, 2),
                        "sigma3.2": (3.2, 80, 256, 8, 1),
                        "sigma20_in16": (20.0, 128, 256, 16, 2)}
EXACT_SMALL_N = (2, 4, 8, 16)
EXACT_SMALL_BITS = {"u16": 28, "u32": 60, "u64": 124}
EXACT_SMALL_HOST = ({("demo", lm, n) for lm in EXACT_SMALL_BITS
                     for n in (8, 16)} | {("sigma3.2", "u32", 8)})
EXACT_SMALL_RING = (("u32", 16, 150), (3, 5))
LWE_KEY = bytes(range(32, 64))
# the mesh's rns axis: each LWE ring cut into 2 batch halves x these
# channel blocks (Ring.channel_block); noise drawn on the whole ring from
# RNS_KEY, uniform ciphertexts from RNS_SEED; each step timed as the median
# of RNS_SAMPLES samples of RNS_REPS calls
RNS_BLOCKS = {"u32": ((0, 9), (9, 17)), "u64": ((0, 4), (4, 8))}
RNS_BATCH = 64
RNS_KEY = bytes(range(96, 128))
RNS_SEED = 19
RNS_SAMPLES, RNS_REPS = 5, 3
RNS_KERNELS = {   # (limb, mode): the kernels a step on a block launches
    ("u32", "butterfly"): ("ntt_butterfly_fwd", "ntt_butterfly_inv",
                           "lwe_encrypt", "lwe_decrypt"),
    ("u64", "butterfly"): ("ntt_butterfly64_fwd", "ntt_butterfly64_inv",
                           "lwe64_encrypt", "lwe64_decrypt"),
    ("u32", "fused"): ("dft_mxu32", "modops_expr"),
    ("u64", "fused"): ("dft_mxu64_twiddle", "dft_mxu64", "modops_expr"),
    ("u32", "auto"): ("ntt_butterfly_fwd", "ntt_butterfly_inv",
                      "modops_expr"),
    ("u64", "auto"): ("ntt_butterfly64_fwd", "ntt_butterfly64_inv",
                      "modops_expr")}
SAMPLER_KEY = bytes(range(64, 96))
UNIFORM64 = ("u64", 1 << 20, 124)        # device_uniform: 16 MB of keystream
PARTIAL16 = ("u16", 8, 14)               # a 16-byte uniform: a partial block
# samplers on a channel block (8h', 10f): every device sampler and
# encrypt_on_device on RNS_BLOCKS and the whole ring at nonce RNS_NONCE;
# S1's uniform also on blocks whose first limb lies off the 64-byte
# keystream grid (u16 and u32 n = 8; u16 n = 4, whose runs lie off the
# 16-byte grid of the vector stores too) and on u64 2^20 x 2: (whole
# ring, block)
RNS_NONCE = 3
UNIFORM_BLOCKS = ((("u16", 8, 28), (1, 2)), (("u32", 8, 150), (3, 5)),
                  (("u16", 4, 28), (1, 2)), (UNIFORM64, (1, 2)))
NON_UNIFORM_CASES = ((5, 1), (5, 3))     # (upper bound, amplifier)
ZO_RHOS = (127, 0, 255)
HWT_H = 64
HWT_SMALL = ("u32", 256, 60)             # S5/S6 at h = 1, n / 4 and n
HWT_MAX_KERNELS = 2      # CUDA kernels a device_hwt(_exact) call, LWE rings
HWT_FRAGS = {"hwt_fixed": ("hwt_cand_kernel", "hwt_store_kernel"),
             "hwt_exact": ("hwt_partial_kernel", "hwt_store_kernel")}
HWT_NONCES = 64          # S5/S6 held exact on each LWE ring at nonces 0..63
GOLDEN = ("16384_496_u64", "u64", 16384, 496)
# phase 10e, the measuring scripts: bench_torch.py's modes and the kernel
# launches each of its applications must make at the main shape;
# tools/bench_ops_torch.py's configs; tools/prng_bench_torch.py's samples
# a sampler, and how far their mean may lie from 0 and their std from sigma
# (a fraction of sigma)
BENCH_MODES = (("auto", {"ntt_butterfly_fwd": 1}),
               ("fused", {"dft_mxu32": 2}),
               ("butterfly", {"ntt_butterfly_fwd": 1}))
BENCH_OPS_CONFIGS = (2, 3)
PRNG_SAMPLES = 1_000_000
PRNG_MEAN, PRNG_STD = 0.05, 0.01
E1_TREES = 10            # random Expr trees a shape held to the twin
# E1's timed cases (tier, op): the product's pointwise step, the
# companion, the u32 and u64 mulmod
E1_TIMED = (("u32", "mulmod_shoup"), ("u32", "compute_shoup"),
            ("u32", "mulmod"), ("u64", "mulmod"))
# the STEP_OPS steps of E1's timed ops
E1_STEPS = {"mulmod_shoup": ("shoup", "red"),
            "compute_shoup": ("mulmod", "mulmod"), "mulmod": ("mulmod",)}
TIMING_RUNS = 25
HOST_REPS = 100          # calls on the host clock for the host's us a call
KERNEL_REPS = 10         # back-to-back kernel calls in one timing sample
# Peak rates of one H100 SXM at 700 W: HBM3 bytes/s and dense int8 tensor
# ops/s (NVIDIA's data sheet); 132 SMs at the 1.98 GHz boost clock, each
# issuing 4 warp instructions (128 lanes) a clock, at most 64 lanes of them
# on the ALU pipe and 64 on the FMA pipe.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
SM_CLOCKS_PER_S = 132 * 1.98e9
# shared-memory accesses: one warp instruction (32 lanes) an SM a clock
SMEM_LANES_PER_CLOCK = 32
KERNELS = {   # name: (source, TPU kernel it replaces)
    "dft_mxu64": ("nfllib_tpu_torch/csrc/dft_mxu64.cu",
                  "nfllib_tpu/ops/dft_mxu.py:317"),
    "dft_mxu64_twiddle": ("nfllib_tpu_torch/csrc/dft_mxu64.cu",
                          "nfllib_tpu/ops/dft_mxu.py:411"),
    "dft_mxu32": ("nfllib_tpu_torch/csrc/dft_mxu32.cu",
                  "nfllib_tpu/ops/dft_mxu.py:232"),
    "dft_mxu64_pipe": ("nfllib_tpu_torch/csrc/dft_mxu64_pipe.cu",
                       "nfllib_tpu/ops/dft_mxu.py:427"),
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
    # kernels in place of XLA code, not of a TPU kernel
    "modops_expr": ("nfllib_tpu_torch/csrc/modops_expr.cu",
                    "nfllib_tpu/poly.py:59 _jitted_impl / :320 "
                    "_chain_program_impl (XLA)"),
    "salsa20": ("nfllib_tpu_torch/csrc/salsa20.cu",
                "nfllib_tpu/prng/salsa20.py:130 device_stream_words (XLA)"),
    "salsa20_uniform": ("nfllib_tpu_torch/csrc/salsa20.cu",
                        "nfllib_tpu/prng/device_sampling.py:65 "
                        "device_uniform (XLA)"),
    "salsa20_non_uniform": ("nfllib_tpu_torch/csrc/salsa20.cu",
                            "nfllib_tpu/prng/device_sampling.py:78 "
                            "device_non_uniform (XLA)"),
    "salsa20_zo": ("nfllib_tpu_torch/csrc/salsa20.cu",
                   "nfllib_tpu/prng/device_sampling.py:101 device_zo "
                   "(XLA)"),
    "gaussian_fixed": ("nfllib_tpu_torch/csrc/gaussian_fixed.cu",
                       "nfllib_tpu/prng/device_sampling.py:116 "
                       "device_gaussian (XLA)"),
    "gaussian_exact": ("nfllib_tpu_torch/csrc/gaussian_exact.cu",
                       "nfllib_tpu/prng/device_sampling.py:207 "
                       "device_gaussian_exact (XLA)"),
    "hwt_fixed": ("nfllib_tpu_torch/csrc/hwt.cu",
                  "nfllib_tpu/prng/device_sampling.py:471 device_hwt (XLA)"),
    "hwt_exact": ("nfllib_tpu_torch/csrc/hwt.cu",
                  "nfllib_tpu/prng/device_sampling.py:424 "
                  "device_hwt_exact (XLA)"),
}
# TPU kernels that run as launches of another kernel of the port: name:
# (source, TPU kernel it replaces).  K4 (the u64 NTT) is two launches of K5
# (dft_mxu64, dft_mxu64_twiddle), K1/K2 (the u16/u32 NTT) two of K9
# (dft_mxu32), the first DFT with the twiddle in its epilogue, then the
# second (ops/ntt_mxu.py:_route, the four-step of every tier); K11 (the
# pair bridge) is one launch of E1 (modops_expr), its u64 mulmod_shoup
# (ops/pair_bridge.py:_route).
ROUTE_KERNELS = {"u64": ("dft_mxu64_twiddle", "dft_mxu64"),
                 "u32": ("dft_mxu32",)}
# The stage engine's transforms (K3, K7: forward, inverse) by tier, which
# NFL_TORCH_NTT=auto takes on the card wherever they serve the ring
BFLY_NTT = {"u64": ("ntt_butterfly64_fwd", "ntt_butterfly64_inv"),
            "u32": ("ntt_butterfly_fwd", "ntt_butterfly_inv")}
# The NTT modes the LWE phases (8b, 8e, 8h, 8h', 10) run in turn: the chain
# kernels K6/K8 (butterfly), the routes (fused), and K3/K7 beside E1 (auto)
LWE_MODES = ("butterfly", "fused", "auto")
ROUTES = {
    "ntt32_route_fwd": ("nfllib_tpu_torch/csrc/dft_mxu32.cu",
                        "nfllib_tpu/ops/ntt_mxu.py:547"),
    "ntt32_route_inv": ("nfllib_tpu_torch/csrc/dft_mxu32.cu",
                        "nfllib_tpu/ops/ntt_mxu.py:723"),
    "ntt64_route_fwd": ("nfllib_tpu_torch/csrc/dft_mxu64.cu",
                        "nfllib_tpu/ops/ntt_mxu_u64.py:274"),
    "ntt64_route_inv": ("nfllib_tpu_torch/csrc/dft_mxu64.cu",
                        "nfllib_tpu/ops/ntt_mxu_u64.py:274"),
    "pair_bridge64": ("nfllib_tpu_torch/csrc/modops_expr.cu",
                      "nfllib_tpu/ops/pair_bridge.py:48"),
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

def rlabel(ring):
    return f"{ring.limb} n={ring.degree} m={ring.nmoduli}"


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


# CUPTI can drop the device activity of the first launches of a
# torch.profiler session (a profile of one call has shown no kernel at
# all): a profile that counts launches first runs WARM_UP fill kernels,
# which the count leaves out by name
WARM_UP = 4
WARM_UP_KERNEL = "FillFunctor"


def warm_up(torch, dev):
    for _ in range(WARM_UP):
        torch.full((1,), 7, device=dev)


# CUPTI has also lost the device activity of a later launch in a session
# (a K8 encrypt profiled after the warm-up kernels has shown no kernel):
# a session that counts launches against an exact total (8g's E1 ops and
# trees, the fused encrypt of 10a'') and shows fewer runs again, at most
# PROFILE_TRIES sessions; one that shows more fails at once.  8e and 10d
# count launches by the wrappers' counters and hold the profile only to
# at most those, so their sessions do not run again.  Three sessions in a
# row have lost the batch-1 K8 encrypt on one card, so five are allowed
PROFILE_TRIES = 5


def profile_kernels(torch, dev, fn, want):
    """([(CUDA kernel, launches, device us)] of fn() in a CUDA-only
    torch.profiler session after the warm-up kernels, which it leaves
    out; the sessions it took): a session with fewer than `want` launches
    in all runs again, at most PROFILE_TRIES in all"""
    for tries in range(1, PROFILE_TRIES + 1):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            warm_up(torch, dev)
            fn()
            torch.cuda.synchronize()
        kern = [(evt.key, evt.count, max(
            getattr(evt, a_, 0) or 0 for a_ in (
                "self_device_time_total", "self_cuda_time_total")))
                for evt in prof.key_averages()
                if WARM_UP_KERNEL not in evt.key]
        kern = [(k_, n_, us) for k_, n_, us in kern if us > 0]
        if sum(n_ for _, n_, _ in kern) >= want:
            break
    return kern, tries


def raises(fn, *args):
    try:
        fn(*args)
    except AssertionError:
        return True
    return False


def special_words(ring, gen, shape, k, dev):
    """Operand k of an E1 check, made on `dev` from the torch generator
    `gen`: canonical residues, and in the first polynomial's first 64
    words of each channel the words 0, 1, p - 1, p, p + 1, 2^w - 1 (the
    strict mode's poison) and two arbitrary words, so that operands 0 and
    1 meet in every pair"""
    import torch
    w = ring.repr_bits
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    i = np.arange(64)
    pick = ((i // 8) % 8, i % 8, (3 * i + i // 8) % 8, (5 * i + 1) % 8)[k]
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        out[:, cm] = torch.randint(0, p, (shape[0], shape[2]),
                                   generator=gen, device=dev)
        free = [int(v) for v in torch.randint(
            0, min(1 << w, (1 << 63) - 1), (2,), generator=gen,
            device=dev)]
        words = np.array([0, 1, p - 1, p, p + 1, (1 << w) - 1] + free,
                         dtype=np.uint64)[pick]
        out[0, cm, :64] = torch.from_numpy(words.view(np.int64)).to(dev)
    if w < 64:      # the limb's bit pattern in the signed storage type
        out = torch.where(out >= 1 << (w - 1), out - (1 << w), out)
    return out.to(ring.torch_dtype)


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
# kernels whose SASS instruction mix is printed: the stage engine's main
# instances and E1's (modops_expr_kernel<BITS, VEC, OP>) vector-lane
# instances of the u32 named ops mulmod_shoup (OP 4), compute_shoup (7)
# and mulmod (2), the u64 mulmod, and the u32 and u64 interpreters (-1)
ENGINE_SASS = ("bfly_nttINS0_3U32ELi14ELi0E", "bfly_nttINS0_3U64ELi14ELi0E",
               "bfly_encryptINS0_3U32ELi14E", "bfly_encryptINS0_3U64ELi14E",
               "modops_expr_kernelILi32ELi4ELi4EE",
               "modops_expr_kernelILi32ELi4ELi7EE",
               "modops_expr_kernelILi32ELi4ELi2EE",
               "modops_expr_kernelILi64ELi2ELi2EE",
               "modops_expr_kernelILi32ELi4ELin1EE",
               "modops_expr_kernelILi64ELi2ELin1EE")
# E1's words a vector lane (16 bytes) by tier
E1_VEC = {"u16": 8, "u32": 4, "u64": 2}
E1_HOST_CALLS = 200      # E1 calls issued back to back for its host us
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
    from nfllib_tpu_torch import _kernels, crt, debug, golden, native, \
        oracle, profiling
    from nfllib_tpu_torch.apps import lwe
    from nfllib_tpu_torch.ops import dft_mxu, expr_program, modops, ntt, \
        ntt_mxu, ntt_mxu_u64, ntt_pallas, ntt_pallas_u64, pair_bridge
    from nfllib_tpu_torch.parallel import api as dist_api, ntt_dist
    from nfllib_tpu_torch.prng import Salsa20Stream, mpfr_barriers
    from nfllib_tpu_torch.prng import device_sampling as dsamp, \
        salsa20 as sal, sampling as samp
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
    set_mode("fused")
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
    # the native host tier (g++), before any stream is made: phase 8f
    # prints its build time and holds it to the Python tier
    t0 = time.perf_counter()
    native_cached = native._so_path().exists()
    expect(native.available(), "the native host tier did not build (g++)")
    native_s = time.perf_counter() - t0

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
            set_mode("fused")

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

    # 5c. K11 (one E1 launch, its u64 mulmod_shoup) against its twin at the
    # u64 2^20 x 2 x 2 twiddle shape
    n1L, n2L = ntt_mxu_u64._geometry(ringL.degree)
    xs = rand_slab(ringL, rng, (LARGE_MAIN[2], 2, n1L, n2L), dev)
    tw = rand_twiddle(ringL, rng, (n1L, n2L), dev)
    e1_before = k_by_name["modops_expr"].launches
    out = pair_bridge.mulmod_shoup_u64(xs, *tw, ringL)
    expect(k_by_name["modops_expr"].launches == e1_before + 1
           and k_by_name["modops_expr"].last_instance == ("named", 2),
           f"K11 is not one E1 launch of its u64 named instance "
           f"({k_by_name['modops_expr'].last_instance})")
    plain = pair_bridge.mulmod_shoup_u64_plain(xs, *tw, ringL)
    pairs = pair_bridge.mulmod_shoup_pairs(
        dft_mxu.split_pair(xs), *(dft_mxu.split_pair(t) for t in tw), ringL)
    torch.cuda.synchronize()
    err["pair_bridge64"] = max_err(out, plain, ringL)
    expect(err["pair_bridge64"] == 0, "K11 != twin")
    expect(torch.equal(dft_mxu.merge_pair(pairs), out), "K11 pairs != u64")
    print(f"K11 (one E1 launch, u64 mulmod_shoup with 16-byte lanes) vs "
          f"twin: u64 [{LARGE_MAIN[2]}, 2, {n1L}, {n2L}] x "
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
    # K7's calls in bfly_check: 9 forward, 5 inverse; each a launch of
    # two-block clusters where the engine's path says so (one stage beyond
    # a block: u64 2^15)
    k7 = (k_by_name["ntt_butterfly64_fwd"], k_by_name["ntt_butterfly64_inv"])
    for degree, bits, batch in BFLY64_SHAPES:
        r_ = nfl.ring_from_modulus("u64", degree, bits)
        x = nfl.Poly.from_numpy(r_, rand_residues(r_, rng, batch), dev).data
        for k in k7:
            k.cluster_launches = 0
        e_f, e_i = bfly_check(ntt_pallas_u64, r_, x, f"K7 n={degree}")
        err["ntt_butterfly64_fwd"] = max(err["ntt_butterfly64_fwd"], e_f)
        err["ntt_butterfly64_inv"] = max(err["ntt_butterfly64_inv"], e_i)
        clusters = tuple(k.cluster_launches for k in k7)
        t_ = ntt_pallas.kernel_tables(r_, dev)
        pair = _kernels.ntt_path(t_.bits, t_.log_n) == _kernels.PATH_CLUSTER
        expect(clusters == ((9, 5) if pair else (0, 0)),
               f"K7 n={degree}: cluster_launches {clusters}")
        print(f"K7 vs twin: u64 n={degree} m={r_.nmoduli} batch={batch}: "
              f"8 forward and 4 inverse flag sets exact, equal to Harvey, "
              f"round trip exact; cluster_launches fwd {clusters[0]}, inv "
              f"{clusters[1]}")

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
    # the kernels no call may launch in each of LWE_MODES
    zero_of = {"butterfly": fused_all, "fused": bfly_all,
               "auto": fused_all + tuple(n for n in bfly_all
                                         if n.startswith("lwe"))}

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
    main_inputs = {"u32": (ring, a, b), "u64": (ring64, a64, b64)}

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
    # I/O, matmul -> pair bridge, one E1 launch -> matmul) and in K5's
    # epilogue
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
    for tag, kern, chain in (
            ("pair_bridge64", "modops_expr", chain_bridge),
            ("dft_mxu64_twiddle", "dft_mxu64_twiddle", chain_epilogue)):
        out, counts = drive((kern,), chain, record=False)
        expect(torch.equal(out, want), f"large forward via {tag} != "
               f"_route")
        expect(counts.get("dft_mxu64", 0) > 0,
               f"large forward via {tag}: K5 not launched ({counts})")
        if tag == "pair_bridge64":
            expect(counts["modops_expr"] == 1,
                   f"large forward via K11: {counts}, not one E1 launch")
            route_launches[tag] = counts["modops_expr"]
        print(f"main path u64 n={degree} forward with the twiddle in "
              f"{tag}: equal to _route; launches {counts}")

    # 8b. the LWE demo through the app API in each of LWE_MODES
    def lwe_run(r_):
        """keygen, then LWE_REPS encryptions and decryptions of zero; the
        keys, the ciphertexts, the sum of the decryptions and the stream's
        nonce before each encryption"""
        stream_ = Salsa20Stream(LWE_KEY)
        g = lwe.make_gaussian_prng()
        keys = lwe.keygen(r_, stream_, g, dev)
        total = torch.zeros(r_.shape, dtype=torch.int64, device=dev)
        cts, nonces = [], []
        for _ in range(LWE_REPS):
            nonces.append(stream_.nonce)
            resa, resb = lwe.encrypt(keys, r_, stream_, g)
            total += lwe.decrypt(keys, r_, resa, resb).to(torch.int64)
            cts.append((resa.data, resb.data))
        return keys, cts, total, nonces

    lwe_host = {}

    for limb, degree, bits in LWE_RINGS:
        r_ = nfl.ring_from_modulus(limb, degree, bits)
        tier = "u64" if limb == "u64" else "u32"
        chain = ("lwe64_encrypt", "lwe64_decrypt") if limb == "u64" \
            else ("lwe_encrypt", "lwe_decrypt")
        want = {"butterfly": (BFLY_NTT[tier][0], *chain),
                "fused": ROUTE_KERNELS[tier],
                "auto": BFLY_NTT[tier] + ("modops_expr",)}
        runs, counts = {}, {}
        for mode in LWE_MODES:
            set_mode(mode)
            t0 = time.perf_counter()
            runs[mode], counts[mode] = drive(
                want[mode], lambda: lwe_run(r_), zero=zero_of[mode],
                record=mode == "butterfly")
            counts[mode]["seconds"] = round(time.perf_counter() - t0, 3)
        set_mode("fused")
        kb, cb, tb, nonces_b = runs["butterfly"]
        lwe_host[limb] = (r_, kb, cb, nonces_b)
        for mode, (ka, ca, ta, _) in runs.items():
            expect(ta.shape == r_.shape and not bool(ta.any()),
                   f"LWE zero-sum gate failed on {limb} in {mode} mode")
            for name in ("s", "sprime", "pka", "pkb"):
                expect(getattr(kb, name) == getattr(ka, name),
                       f"LWE key {name} differs between butterfly and "
                       f"{mode} modes on {limb}")
            expect(all(torch.equal(x, y) for pb, pa in zip(cb, ca)
                       for x, y in zip(pb, pa)),
                   f"LWE ciphertexts differ between butterfly and {mode} "
                   f"modes on {limb}")
        expect(cb[0][0].shape == r_.shape and cb[0][0].is_cuda,
               "ciphertext shape")
        print(f"main path LWE {limb} (n={degree}, {bits}-bit q): keygen, "
              f"{LWE_REPS} x encrypt/decrypt, zero-sum gate passed in "
              f"modes {', '.join(LWE_MODES)}; keys and ciphertexts equal "
              f"across modes; launches "
              + ", ".join(f"{md} {c}" for md, c in counts.items()))

    # 8h. the mesh's rns axis (a rank's (batch, rns) block, as
    # parallel/api.py:shard_poly gives it): 8b's keys and a batch of noise
    # drawn on the whole ring, cut into 2 batch halves x RNS_BLOCKS channel
    # blocks.  On each block's ring (Ring.channel_block: its own tables,
    # the whole ring's rows) a step runs the encrypt and decrypt graphs,
    # the decrypt of uniform random ciphertexts (its bits read the whole
    # ring's p0 on every block) and the forward and inverse NTT, in both
    # modes.  The blocks put back together equal the whole ring's step bit
    # for bit, the bits of zero are zero, and a block's step launches the
    # same kernels as many times as the whole ring's.  Then
    # parallel/dryrun.py on the one-rank NCCL group of 8a.
    from nfllib_tpu_torch.parallel import dryrun

    def rns_step(c_, pka, pkb, s_, sp, u, e1, e2, ua, ub):
        """(resa, resb, bits, bits of the uniform (ua, ub), NTT(u), its
        inverse)"""
        resa, resb = lwe._encrypt_graph(c_, pka, pkb, u, e1, e2)
        fu = ntt.ntt_pow_phi(u, c_)
        return (resa, resb, lwe._decrypt_graph(c_, resa, resb, s_, sp),
                lwe._decrypt_graph(c_, ua, ub, s_, sp), fu,
                ntt.invntt_pow_invphi(fu, c_))

    rns_calls = {}
    halves = (slice(0, RNS_BATCH // 2), slice(RNS_BATCH // 2, RNS_BATCH))
    for limb, degree, bits in LWE_RINGS:
        r_, keys, _, _ = lwe_host[limb]
        c_ = r_.context()
        stream_ = Salsa20Stream(RNS_KEY)
        g = lwe.make_gaussian_prng()
        noise = [torch.stack([
            nfl.Poly.sample(r_, nfl.gaussian(g, amp), stream_, dev).data
            for _ in range(RNS_BATCH)]) for amp in (1, 2, 2)]
        gen = torch.Generator(device=dev).manual_seed(RNS_SEED)
        cipher = [(torch.randint(0, 1 << 62, (RNS_BATCH,) + r_.shape,
                                 device=dev, generator=gen)
                   % c_.to(dev).p_col).to(r_.torch_dtype) for _ in range(2)]
        args = [keys.pka.data, keys.pkb.data, keys.s.data, keys.sprime.data,
                *noise, *cipher]
        for mode in LWE_MODES:
            zero = zero_of[mode]
            set_mode(mode)
            names = RNS_KERNELS[limb, mode]
            t0 = time.perf_counter()
            whole, n_whole = drive(names, lambda: rns_step(c_, *args),
                                   zero=zero, record=False)
            expect(not bool(whole[2].any()),
                   f"rns {limb} {mode}: decryption of zero is not zero")
            expect(torch.equal(whole[5], noise[0]),
                   f"rns {limb} {mode}: NTT round trip")
            rns_calls[f"{limb} {mode} whole"] = (mode, c_, args)
            parts = {}
            for bs in halves:
                for c0, c1 in RNS_BLOCKS[limb]:
                    rb_ = r_.channel_block(c0, c1)
                    bargs = [t[c0:c1].contiguous() for t in args[:4]] + [
                        t[bs, c0:c1].contiguous() for t in args[4:]]
                    parts[bs.start, c0], n_blk = drive(
                        names, lambda: rns_step(rb_.context(), *bargs),
                        zero=zero, record=False)
                    expect(n_blk == n_whole,
                           f"rns {limb} {mode} block [{bs.start}:{bs.stop},"
                           f" {c0}:{c1}]: launches {n_blk}, a whole step "
                           f"{n_whole}")
                    rns_calls[f"{limb} {mode} block [{bs.start}:{bs.stop}, "
                              f"{c0}:{c1}]"] = (mode, rb_.context(), bargs)
            for i, what in enumerate(("resa", "resb", "bits of zero",
                                      "bits of uniform ciphertexts",
                                      "forward NTT", "inverse NTT")):
                got = torch.cat([torch.cat(
                    [parts[bs.start, c0][i] for c0, _ in RNS_BLOCKS[limb]],
                    dim=-2) for bs in halves])
                expect(torch.equal(got, whole[i]),
                       f"rns {limb} {mode}: the blocks' {what} != the whole "
                       f"ring's")
            print(f"rns axis {limb} (n={degree}, {r_.nmoduli} channels) "
                  f"{mode} mode, batch {RNS_BATCH} as 2 halves x channel "
                  f"blocks {RNS_BLOCKS[limb]}: encrypt, decrypt (bits of "
                  f"zero all 0), decrypt of uniform ciphertexts, forward "
                  f"and inverse NTT on each block equal the whole ring's "
                  f"bit for bit; launches a step {n_whole} on the whole "
                  f"ring and on each block; "
                  f"{time.perf_counter() - t0:.1f} s")
    set_mode("fused")
    t0 = time.perf_counter()
    dry, counts = drive(("dft_mxu32", "dft_mxu64_twiddle", "dft_mxu64",
                         "modops_expr"), dryrun.dryrun_multichip,
                        zero=bfly_all, record=False)
    expect(dry["mesh"] == (1, 1, 1) and not bool(dry["bits"].data.any()),
           f"dryrun_multichip: mesh {dry['mesh']}, bits not zero")
    forward, f_args = dryrun.entry(dev)
    expect(not bool(forward(*f_args).any()), "dryrun.entry: bits not zero")
    print(f"parallel/dryrun.py on the NCCL group of 8a (mesh "
          f"{dry['mesh']}): LWE {dry['ring']} on the block "
          f"{dry['block_ring']}, zero gate and gathered ciphertexts equal to "
          f"the whole ring's; {dry['big_ring']} deg round trip exact, "
          f"exchanges {dry['exchanges']}; entry() forward decrypts to 0; "
          f"launches {counts}; {time.perf_counter() - t0:.1f} s")

    # 8h'. samplers on a channel block: on each LWE ring and each of its
    # RNS_BLOCKS (Ring.channel_block), every device sampler (S1's uniform,
    # non-uniform and ZO instances, S3, S4, S5, S6) and encrypt_on_device
    # (fixed and exact, in each of LWE_MODES; the keys 8b's, cut to the
    # block's rows) drawn on the block itself, with the launch counters set
    # to 0 before each call: the block's draw equals the whole ring's rows
    # bit for bit, the exact samplers' advance the whole's, and a block's
    # call launches the same kernels as many times as the whole's.  Then
    # the host samplers, keygen and encrypt on each block against the whole
    # ring's rows and the stream's nonce; and S1's uniform instance on the
    # UNIFORM_BLOCKS (the first three off the 64-byte keystream grid) against
    # its twin on the block, the whole ring's rows and the host sampler.
    # 10f times each device draw beside the whole's.
    g_blk = lwe.make_gaussian_prng()
    g_tabs = {ex: dsamp.gaussian_tables(g_blk, dev, ex)
              for ex in (False, True)}
    blk_draws = {   # name: (mode, fn(ring, keys) -> (tensors, advance))
        "uniform": lambda r2, k2: (
            [dsamp.device_uniform(r2, RNS_KEY, RNS_NONCE, dev)], None),
        "non_uniform": lambda r2, k2: ([dsamp.device_non_uniform(
            r2, RNS_KEY, RNS_NONCE, nfl.non_uniform(*NON_UNIFORM_CASES[1]),
            dev)], None),
        "ZO": lambda r2, k2: ([dsamp.device_zo(
            r2, RNS_KEY, RNS_NONCE, nfl.ZO_dist(ZO_RHOS[0]), dev)], None),
        "gaussian": lambda r2, k2: ([dsamp.device_gaussian(
            r2, RNS_KEY, RNS_NONCE, nfl.gaussian(g_blk), dev,
            g_tabs[False])], None),
        "gaussian_exact": lambda r2, k2: (lambda v, f: ([v], f))(
            *dsamp.device_gaussian_exact(
                r2, RNS_KEY, RNS_NONCE, nfl.gaussian(g_blk, 2), True, dev,
                g_tabs[True])),
        "hwt": lambda r2, k2: ([dsamp.device_hwt(
            r2, RNS_KEY, RNS_NONCE, nfl.hwt_dist(HWT_H), dev)], None),
        "hwt_exact": lambda r2, k2: (lambda v, a: ([v], a))(
            *dsamp.device_hwt_exact(r2, RNS_KEY, RNS_NONCE,
                                    nfl.hwt_dist(HWT_H), True, device=dev)),
        **{f"encrypt_on_device{' exact' if ex else ''} {mode}": (
            lambda r2, k2, ex=ex: ([c.data for c in lwe.encrypt_on_device(
                k2, r2, RNS_KEY, RNS_NONCE, g_blk, exact=ex)], None))
           for ex in (False, True) for mode in LWE_MODES},
    }

    def block_keys(keys, r2):
        rows = slice(r2.first, r2.first + r2.nmoduli)
        return lwe.LweKeys(*(nfl.Poly(getattr(keys, n_).data[rows]
                                      .contiguous(), r2)
                             for n_ in ("s", "sprime", "pka", "pkb")))

    def blk_kernels(name, limb):
        """the kernels a draw must launch"""
        one = {"uniform": "salsa20_uniform",
               "non_uniform": "salsa20_non_uniform", "ZO": "salsa20_zo",
               "gaussian": "gaussian_fixed",
               "gaussian_exact": "gaussian_exact", "hwt": "hwt_fixed",
               "hwt_exact": "hwt_exact"}
        if name in one:
            return (one[name],)
        sampler = "gaussian_exact" if " exact " in name else "gaussian_fixed"
        if name.endswith("butterfly"):
            return (sampler, "lwe64_encrypt" if limb == "u64"
                    else "lwe_encrypt")
        if name.endswith("auto"):
            return (sampler, BFLY_NTT[limb][0], "modops_expr")
        return (sampler, *ROUTE_KERNELS[limb], "modops_expr")

    blk_calls = {}     # (limb, draw, block or "whole"): (mode, fn)
    t0 = time.perf_counter()
    for limb, degree, bits in LWE_RINGS:
        r_, keys, _, _ = lwe_host[limb]
        rings_ = [("whole", r_)] + [(f"[{c0}:{c1}]", r_.channel_block(c0, c1))
                                    for c0, c1 in RNS_BLOCKS[limb]]
        for name, fn in blk_draws.items():
            mode = name.split()[-1] if name.startswith("encrypt") \
                else "fused"
            set_mode(mode)
            whole_out, n_whole = None, None
            for tag, r2 in rings_:
                k2 = block_keys(keys, r2)
                (out, adv), got = drive(blk_kernels(name, limb),
                                        lambda: fn(r2, k2), record=False)
                blk_calls[limb, name, tag] = (
                    mode, lambda fn=fn, r2=r2, k2=k2: fn(r2, k2))
                if whole_out is None:
                    whole_out, whole_adv, n_whole = out, adv, got
                    continue
                rows = slice(r2.first, r2.first + r2.nmoduli)
                expect(all(torch.equal(b_, w_[..., rows, :])
                           for b_, w_ in zip(out, whole_out)),
                       f"{name} on the {limb} block {tag} != the whole "
                       f"ring's rows")
                expect(adv is None or int(adv) == int(whole_adv),
                       f"{name} on the {limb} block {tag}: advance "
                       f"{adv}, the whole's {whole_adv}")
                expect(got == n_whole,
                       f"{name} on the {limb} block {tag}: launches {got}, "
                       f"the whole ring's {n_whole}")
            print(f"samplers on a block, {limb} (n={degree}) {name}: blocks "
                  f"{', '.join(t_ for t_, _ in rings_[1:])} equal the whole "
                  f"ring's rows bit for bit"
                  + (", the same advance" if whole_adv is not None else "")
                  + f"; launches a call {n_whole} on the whole ring and on "
                  f"each block")
        set_mode("fused")
        # the host samplers, keygen and encrypt on each block: the whole
        # ring's rows, the stream at the whole draw's nonce
        host_modes = (nfl.uniform(), nfl.non_uniform(*NON_UNIFORM_CASES[1]),
                      nfl.ZO_dist(ZO_RHOS[0]), nfl.hwt_dist(HWT_H),
                      nfl.gaussian(g_blk, 2))

        def host_draws(r2, k2):
            outs, nonces = [], []
            for md_ in host_modes:
                st = Salsa20Stream(RNS_KEY, RNS_NONCE)
                outs.append(nfl.Poly.sample(r2, md_, st, dev).data)
                nonces.append(st.nonce)
            st = Salsa20Stream(RNS_KEY, RNS_NONCE)
            kg = lwe.keygen(r2, st, g_blk, dev)
            outs += [kg.s.data, kg.sprime.data, kg.pka.data, kg.pkb.data]
            nonces.append(st.nonce)
            ct = lwe.encrypt(k2, r2, st, g_blk)
            outs += [c.data for c in ct]
            nonces.append(st.nonce)
            return outs, nonces

        w_out, w_nonces = host_draws(r_, keys)
        for tag, r2 in rings_[1:]:
            b_out, b_nonces = host_draws(r2, block_keys(keys, r2))
            rows = slice(r2.first, r2.first + r2.nmoduli)
            expect(b_nonces == w_nonces and all(
                torch.equal(b_, w_[rows]) for b_, w_ in zip(b_out, w_out)),
                f"host samplers / keygen / encrypt on the {limb} block "
                f"{tag} != the whole ring's rows (nonces {b_nonces}, the "
                f"whole's {w_nonces})")
        print(f"samplers on a block, {limb} host tier: Poly.sample with "
              f"{', '.join(type(m_).__name__ for m_ in host_modes)}, keygen "
              f"and encrypt (the keys of 8b cut to the block) on "
              f"{', '.join(t_ for t_, _ in rings_[1:])} equal the whole "
              f"ring's rows, the stream at the same nonces {w_nonces}")
    # the exact encryption at S4's fill size: EXACT_SMALL_RING with the
    # demo's sampler of EXACT_SMALL_SAMPLERS (fills of 18 words, a
    # full-precision sample's) whole and on its block, in both modes
    # (butterfly: no chain kernel serves n = 16, so the plain transform
    # with E1's twist; fused and auto: the route, as no stage engine serves
    # n = 16), each equal to the host encrypt's rows at the same (key,
    # nonce), a block's launches the whole's
    (spec_s, (c0s, c1s)) = EXACT_SMALL_RING
    r_s = nfl.ring_from_modulus(*spec_s)
    g_s = lwe.make_gaussian_prng(samples=256)
    keys_s = lwe.keygen(r_s, Salsa20Stream(RNS_KEY, RNS_NONCE + 100), g_s,
                        dev)
    host_s = [c.data for c in lwe.encrypt(
        keys_s, r_s, Salsa20Stream(RNS_KEY, RNS_NONCE), g_s)]
    small_launches = {}
    for mode in LWE_MODES:
        # auto as fused: no butterfly module serves n = 16
        zero = zero_of["butterfly" if mode == "butterfly" else "fused"]
        set_mode(mode)
        name = f"encrypt_on_device exact {mode} n={r_s.degree}"
        for tag, r2 in (("whole", r_s),
                        (f"[{c0s}:{c1s}]", r_s.channel_block(c0s, c1s))):
            def enc_s(r2=r2, k2=block_keys(keys_s, r2)):
                return [c.data for c in lwe.encrypt_on_device(
                    k2, r2, RNS_KEY, RNS_NONCE, g_s, exact=True)]
            out, got = drive(
                ("gaussian_exact", "modops_expr")
                + (ROUTE_KERNELS["u32"] if mode != "butterfly" else ()),
                enc_s,
                zero=zero + ("gaussian_fixed", "salsa20"), record=False)
            rows = slice(r2.first, r2.first + r2.nmoduli)
            expect(all(torch.equal(o_, h_[rows])
                       for o_, h_ in zip(out, host_s))
                   and got["gaussian_exact"] == 3
                   and got == small_launches.get(mode, got),
                   f"{name} on {tag} != the host encrypt's rows, or "
                   f"launches {got} (3 S4 launches a call, the whole's "
                   f"{small_launches.get(mode)})")
            small_launches.setdefault(mode, got)
            blk_calls["u32", name, tag] = (mode, enc_s)
    set_mode("fused")
    print(f"exact encrypt_on_device at S4's fill size, {rlabel(r_s)} "
          f"whole and [{c0s}:{c1s}], {', '.join(LWE_MODES)}: the host "
          f"encrypt's rows bit for bit; launches a call "
          + "; ".join(f"{md} {c}" for md, c in small_launches.items()))
    # S1's uniform instance on blocks off the 64-byte keystream grid and
    # at u64 2^20 x 2, int and tensor nonces
    t_nonce3 = torch.full((), RNS_NONCE, dtype=torch.int64, device=dev)
    uni_tags = []
    for spec, (c0, c1) in UNIFORM_BLOCKS:
        w_ = nfl.ring_from_modulus(*spec)
        r2 = w_.channel_block(c0, c1)
        uni_tags.append(f"[{c0}:{c1}] of {rlabel(w_)} (first limb at byte "
                        f"{c0 * w_.degree * r2.torch_dtype.itemsize})")
        for nonce in (RNS_NONCE, t_nonce3):
            got, n_got = drive(
                ("salsa20_uniform",),
                lambda: dsamp.device_uniform(r2, RNS_KEY, nonce, dev),
                zero=tuple(n_ for n_ in KERNELS if n_ != "salsa20_uniform"),
                record=False)
            want = dsamp.device_uniform_plain(r2, RNS_KEY, RNS_NONCE, dev)
            e = max_err(got, want, r2)
            err["salsa20_uniform"] = max(err["salsa20_uniform"], e)
            expect(e == 0 and n_got == {"salsa20_uniform": 1}
                   and torch.equal(got, dsamp.device_uniform(
                       w_, RNS_KEY, nonce, dev)[c0:c1]),
                   f"S1 uniform on the block [{c0}:{c1}] of {rlabel(w_)}: "
                   f"!= its twin or the whole ring's rows, or launches "
                   f"{n_got}")
        if w_.degree <= 1024:
            expect(got.cpu().numpy().view(r2.dtype).tolist()
                   == samp.sample_uniform(r2, Salsa20Stream(
                       RNS_KEY, RNS_NONCE)).tolist(),
                   f"S1 uniform on the block [{c0}:{c1}] of {rlabel(w_)} "
                   f"!= the host sampler")
    print(f"S1's uniform instance on blocks {', '.join(uni_tags)}: one "
          f"launch, equal to its twin on the block, the whole ring's "
          f"rows (int and tensor nonces) and the host sampler; "
          f"{time.perf_counter() - t0:.1f} s for 8h'")

    # 8c. the products of phases 6 and 7 in butterfly mode (K3, K7), then
    # in auto mode: K3/K7 where they serve the ring (two forward launches
    # and one inverse a product), the route at u64 2^20 (phase 8's product)
    set_mode("butterfly")
    try:
        cb = drive(BFLY_NTT["u32"], lambda: product(nfl, a, b),
                   zero=fused_all)[0]
        c64b = drive(BFLY_NTT["u64"], lambda: product(nfl, a64, b64),
                     zero=fused_all)[0]
    finally:
        set_mode("fused")
    expect(torch.equal(cb.data, c.data),
           "butterfly u32 product != the u32 route's")
    expect(torch.equal(c64b.data, c64.data),
           "butterfly u64 product != the K4 route's")
    print(f"main path products in butterfly mode: u32 n={BENCH[1]} x 17 x "
          f"{BENCH[3]} and u64 n={BENCH64[0]} x 8 x {BENCH64[2]} equal the "
          f"fused-kernel products; launches "
          f"{ {n: launches[n] for n in launches if 'butterfly' in n} }")
    set_mode("auto")
    try:
        auto_counts = {}
        for tier, (x_, y_, want_c) in (("u32", (a, b, c)),
                                       ("u64", (a64, b64, c64))):
            got_c, auto_counts[tier] = drive(
                BFLY_NTT[tier], lambda: product(nfl, x_, y_),
                zero=fused_all, record=False)
            expect(torch.equal(got_c.data, want_c.data)
                   and auto_counts[tier] == {BFLY_NTT[tier][0]: 2,
                                             BFLY_NTT[tier][1]: 1,
                                             "modops_expr": 2},
                   f"auto {tier} product != the route's, or launches "
                   f"{auto_counts[tier]}")
        got_c, auto_counts["u64 2^20"] = drive(
            route64, lambda: product(nfl, aL, bL), zero=bfly_all,
            record=False)
        expect(torch.equal(got_c.data, cL.data),
               "auto u64 2^20 product != the route's")
    finally:
        set_mode("fused")
    print(f"main path products in auto mode: the same two products on "
          f"K3/K7 and the u64 n={LARGE_MAIN[0]} product on the route (no "
          f"stage engine serves it) equal the fused-kernel products; "
          f"launches {auto_counts}")

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
        set_mode("fused")
    print(f"golden {gname}: {nrec} records replayed byte for byte in "
          f"butterfly mode (samplers, NTT, LWE keys, encryption, raw and bit "
          f"decryption); launches {gcounts}")

    # 8e. on-device sampling (prng/device_sampling.py; the JAX package's
    # encrypt_on_device).  S1's raw keystream (csrc/salsa20.cu) against its
    # twin, exact, at the LWE Gaussian's keystream shapes (one stream, the
    # exact sampler's refill streams), across the nonce wrap (int and
    # tensor nonces) and at the u64 2^20 x 2 uniform's 16 MB, and the
    # golden keystream on the card; S1's sampler instances (uniform,
    # non-uniform, ZO) against their twins; then the main paths
    # Poly.sample_on_device with uniform, non_uniform, ZO_dist (one launch
    # of the instance a call, equal to the host sampler) and hwt_dist and
    # device_hwt_exact (S5 and S6, csrc/hwt.cu: one launch each, equal to
    # the twin and to the host sampler), then S5 and S6 against their twins
    # at h = 1, n / 4 and n, in both instances of a call, the budget guard
    # and a chained pair.
    # S3 (csrc/gaussian_fixed.cu) and S4 (csrc/gaussian_exact.cu) against
    # their twins, exact: S3 at the
    # encryption's three samplers (amps 1, 2, 2) on both LWE rings, in_bits
    # 8 and 16, sigma 250 and across the nonce wrap (int and tensor); S4
    # (residues and its (fills, nonce + fills) word) on both LWE rings,
    # in_bits 8 and 16, lu_depth 1, sigma 250, the nonce wrap, and a degree
    # whose walk outgrows shared memory (its global-scratch instance).
    # Then the main path lwe.encrypt_on_device on both LWE rings in
    # each of LWE_MODES, fixed and exact, with the launch counters
    # reset before each: one S3 launch a fixed call, two S4 launches a
    # sampler, no S1; the zero-sum gate over LWE_REPS encryptions and the
    # exact ciphertexts equal to phase 8b's host encrypt at the same nonces
    # (the profile of one call, no host <-> device copy and no
    # synchronisation, is 10d's)
    g_demo = lwe.make_gaussian_prng()
    wp_demo = g_demo.word_precision
    innoise = int(np.float32(LWE_RINGS[0][1])
                  * np.float32(g_demo.innoise_multiplier))
    fills_exact = -(-LWE_RINGS[0][1] // max(1, (innoise - wp_demo)
                                           // wp_demo))
    s1_shapes = {        # name: (nonce, blocks a stream, streams)
        "fixed": (0, -(-LWE_RINGS[0][1] * wp_demo // 64), 1),
        "exact": (5, -(-innoise // 64), fills_exact),
        "wrap": ((1 << 64) - 2, 5, 3),
        "uniform64": (3, UNIFORM64[1] * UNIFORM64[2] // 496, 1)}

    def s1_check(what, got, want):
        torch.cuda.synchronize()
        e = 0 if torch.equal(got, want) else int(
            ((got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF))
            .abs().max())
        err["salsa20"] = max(err["salsa20"], e)
        expect(e == 0, f"salsa20 != twin at {what}")

    for what, (nonce, nbl, fills) in s1_shapes.items():
        s1_check(what, sal.keystream(SAMPLER_KEY, nonce, nbl, fills, dev),
                 sal.keystream_plain(SAMPLER_KEY, nonce, nbl, fills, dev))
    t_nonce = torch.full((), -2, dtype=torch.int64, device=dev)
    s1_check("a tensor nonce", sal.keystream(SAMPLER_KEY, t_nonce, 5, 3, dev),
             sal.keystream_plain(SAMPLER_KEY, (1 << 64) - 2, 5, 3, dev))
    # S1's sampler instances (the keystream and the residues in one
    # launch) against their plain twins (keystream_plain and torch ops) on
    # the card, exact: on both LWE rings and a 16-byte u16 ring (a partial
    # last block), at an int nonce and the tensor nonce -2 (2^64 - 2), the
    # non-uniform at ub 5 (amps 1 and 3) and at p - 1 of the smallest
    # modulus, the ZO at rho 127, 0 and 255; the uniform also at u64 2^20 x
    # 2
    r_u = nfl.ring_from_modulus(*UNIFORM64)
    lwe_rings = [nfl.ring_from_modulus(*r_) for r_ in LWE_RINGS]
    r_part = nfl.ring_from_modulus(*PARTIAL16)
    s1_twins = {"salsa20_uniform": dsamp.device_uniform_plain,
                "salsa20_non_uniform": dsamp.device_non_uniform_plain,
                "salsa20_zo": dsamp.device_zo_plain}
    s1_cases = {name: [(r_u, nfl.uniform(), 3)] if name == "salsa20_uniform"
                else [] for name in s1_twins}
    for r_ in (*lwe_rings, r_part):
        top = min(int(q) for q in r_.moduli) - 1
        for nonce in (7, t_nonce):
            s1_cases["salsa20_uniform"].append((r_, nfl.uniform(), nonce))
            s1_cases["salsa20_non_uniform"] += [
                (r_, nfl.non_uniform(ub, amp), nonce)
                for ub, amp in (*NON_UNIFORM_CASES, (top, 1))]
            s1_cases["salsa20_zo"] += [(r_, nfl.ZO_dist(rho), nonce)
                                       for rho in ZO_RHOS]
    for name, cases_ in s1_cases.items():
        for r_, md, nonce in cases_:
            got = dsamp.device_sample(r_, md, SAMPLER_KEY, nonce, dev)
            twin_args = (r_, SAMPLER_KEY, nonce) + (
                () if name == "salsa20_uniform" else (md,))
            want = s1_twins[name](*twin_args, dev)
            torch.cuda.synchronize()
            e = max_err(got, want, r_)
            err[name] = max(err[name], e)
            expect(e == 0 and got.dtype == want.dtype,
                   f"{name} != twin: {rlabel(r_)} {md} nonce {nonce}")
    print(f"S1's sampler instances vs twins (keystream_plain and torch "
          f"ops): " + "; ".join(f"{name} {len(c)} cases" for name, c in
                                s1_cases.items())
          + f" on {', '.join(rlabel(r_) for r_ in (*lwe_rings, r_part))} "
          f"(int and tensor nonces; the uniform also on {rlabel(r_u)}): "
          f"exact")

    # the main paths of the samplers that S1 serves: Poly.sample_on_device
    # with uniform (u64 2^20 x 2 and both LWE rings), non_uniform (ub 5,
    # amp 3) and ZO_dist (rho 127) on both LWE rings: one launch of the
    # sampler's instance a call and nothing else of the library, one CUDA
    # kernel a call (torch.profiler), equal to the host sampler at the
    # same (key, nonce); hwt_dist (device_hwt: S5) and device_hwt_exact
    # (S6) below
    main_s1 = [("salsa20_uniform", r_u, nfl.uniform())] + [
        (name, r_, md) for r_ in lwe_rings for name, md in (
            ("salsa20_uniform", nfl.uniform()),
            ("salsa20_non_uniform", nfl.non_uniform(*NON_UNIFORM_CASES[1])),
            ("salsa20_zo", nfl.ZO_dist(ZO_RHOS[0])))]
    sampler_kernels = {}     # (sampler, ring): CUDA kernels a call

    def cuda_kernels(fn):
        """the CUDA kernels of one call of fn (torch.profiler)"""
        kern, _ = profile_kernels(torch, dev, fn, 1)
        return sum(n_ for _, n_, _ in kern)

    for name, r_, md in main_s1:
        def sample_call(r_=r_, md=md):
            return nfl.Poly.sample_on_device(r_, md, SAMPLER_KEY, 3, dev)
        out, got = drive((name,), sample_call, zero=tuple(
            n_ for n_ in KERNELS if n_ != name), record=False)
        expect(got == {name: 1}, f"sample_on_device({md}) on "
               f"{rlabel(r_)}: launches {got}, not one {name}")
        launches[name] = launches.get(name, 0) + 1
        expect(out == nfl.Poly.sample(r_, md, Salsa20Stream(SAMPLER_KEY, 3),
                                      dev),
               f"sample_on_device({md}) on {rlabel(r_)} != the host "
               f"sampler")
        nk = cuda_kernels(sample_call)
        expect(nk == 1, f"sample_on_device({md}) on {rlabel(r_)}: {nk} "
               f"CUDA kernels a call")
        sampler_kernels[(type(md).__name__, rlabel(r_))] = nk
    del out
    print(f"main path Poly.sample_on_device: "
          + ", ".join(f"{type(md_).__name__} on {rlabel(r_)}"
                      for _, r_, md_ in main_s1)
          + ": one launch of the sampler's S1 instance a call, equal to "
          f"the host sampler; CUDA activities a call (torch.profiler) "
          + "; ".join(f"{k_[0]} {k_[1]} {v_}" for k_, v_ in
                      sampler_kernels.items()) + f" | {card}")

    # the hwt pair's main paths on both LWE rings at h = HWT_H:
    # Poly.sample_on_device(hwt_dist) is device_hwt, one launch of S5 and
    # nothing else of the library, equal to its twin on the card and to
    # its run on the CPU; device_hwt_exact is one launch of S6, equal to
    # the host sampler, its advance (a tensor) to the host stream's.  Each
    # call's CUDA kernels (torch.profiler) are all S5's or S6's, at most
    # HWT_MAX_KERNELS: no torch op, no memset, no copy.  The first launch
    # of each runs over many CTAs, whose last merges their work: its CTAs
    # and the distinct SMs they ran on (their %smid, read back) print, and
    # more than one SM is required
    md = nfl.hwt_dist(HWT_H)
    hwt_kernels, hwt_sms = {}, {}
    for r_ in lwe_rings:
        def hwt_fixed(r_=r_):
            return nfl.Poly.sample_on_device(r_, md, SAMPLER_KEY, 5, dev)

        def hwt_exact(r_=r_):
            return dsamp.device_hwt_exact(r_, SAMPLER_KEY, 5, md,
                                          return_fills=True, device=dev)
        for name, fn in (("hwt_fixed", hwt_fixed), ("hwt_exact", hwt_exact)):
            res, got = drive((name,), fn, zero=tuple(
                n_ for n_ in KERNELS if n_ != name), record=False)
            expect(got == {name: 1}, f"{name} on {rlabel(r_)}: launches "
                   f"{got}, not one {name}")
            kern_ = getattr(_kernels, name.upper())
            grid_, sms_ = kern_.plan(r_.degree, HWT_H).grid, \
                kern_.last_sms()
            hwt_sms[(name, rlabel(r_))] = (grid_, sms_)
            expect(sms_ > 1, f"{name} on {rlabel(r_)}: the first launch's "
                   f"{grid_} CTAs ran on {sms_} SM")
            launches[name] = launches.get(name, 0) + 1
            if name == "hwt_fixed":
                want = dsamp.device_hwt_plain(r_, SAMPLER_KEY, 5, md, dev)
                e = max_err(res.data, want, r_)
                expect(e == 0 and torch.equal(res.data.cpu(), dsamp.device_hwt(
                    r_, SAMPLER_KEY, 5, md, device="cpu")),
                    f"device_hwt on {rlabel(r_)} != its twin or its CPU run")
            else:
                (ex, adv), host_stream = res, Salsa20Stream(SAMPLER_KEY, 5)
                want = nfl.Poly.sample(r_, md, host_stream, dev).data
                e = max_err(ex, want, r_)
                expect(e == 0 and int(adv) == host_stream.nonce - 5,
                       f"device_hwt_exact on {rlabel(r_)} != the host "
                       f"sampler (nonce advance {int(adv)} vs "
                       f"{host_stream.nonce - 5})")
            err[name] = max(err[name], e)
            kern, tries = profile_kernels(torch, dev, fn, HWT_MAX_KERNELS)
            nk = sum(n_ for _, n_, _ in kern)
            foreign = [k_ for k_, _, _ in kern if "hwt_" not in k_]
            expect(0 < nk <= HWT_MAX_KERNELS and not foreign,
                   f"{name} on {rlabel(r_)}: {nk} CUDA activities a call, "
                   f"not S5/S6's: {foreign}")
            hwt_kernels[(name, rlabel(r_))] = (nk, tries)
        # exact over HWT_NONCES nonces: S5 against its twin on the card and
        # its run on the CPU, S6 against the host sampler and its advance
        # (many launches, so the last-CTA ticket's ordering under CTAs
        # that run at once is tested on the card)
        for nonce in range(HWT_NONCES):
            got = dsamp.device_hwt(r_, SAMPLER_KEY, nonce, md, dev)
            e5 = max_err(got, dsamp.device_hwt_plain(r_, SAMPLER_KEY, nonce,
                                                     md, dev), r_)
            expect(e5 == 0 and torch.equal(got.cpu(), dsamp.device_hwt(
                r_, SAMPLER_KEY, nonce, md, device="cpu")),
                f"device_hwt on {rlabel(r_)} nonce {nonce} != its twin or "
                f"its CPU run")
            ex, adv = dsamp.device_hwt_exact(r_, SAMPLER_KEY, nonce, md,
                                             return_fills=True, device=dev)
            host_stream = Salsa20Stream(SAMPLER_KEY, nonce)
            e6 = max_err(ex, nfl.Poly.sample(r_, md, host_stream, dev).data,
                         r_)
            expect(e6 == 0 and int(adv) == host_stream.nonce - nonce,
                   f"device_hwt_exact on {rlabel(r_)} nonce {nonce} != the "
                   f"host sampler (advance {int(adv)} vs "
                   f"{host_stream.nonce - nonce})")
            err["hwt_fixed"] = max(err["hwt_fixed"], e5)
            err["hwt_exact"] = max(err["hwt_exact"], e6)
    print(f"main path hwt (h = {HWT_H}) on "
          + ", ".join(rlabel(r_) for r_ in lwe_rings)
          + ": Poly.sample_on_device(hwt_dist) one hwt_fixed launch (S5), "
          f"equal to its twin and its CPU run; device_hwt_exact one "
          f"hwt_exact launch (S6), equal to the host sampler and its nonce "
          f"advance, both at nonces 0..{HWT_NONCES - 1}; CUDA activities "
          f"a call (torch.profiler, sessions) "
          + "; ".join(f"{k_[0]} {k_[1]} {v_[0]} ({v_[1]})"
                      for k_, v_ in hwt_kernels.items())
          + "; the first launch's CTAs on distinct SMs "
          + "; ".join(f"{k_[0]} {k_[1]} {v_[0]} on {v_[1]}"
                      for k_, v_ in hwt_sms.items()) + f" | {card}")

    # S5 and S6 against their twins beyond the main path, exact: h = 1, n /
    # 4 and n on HWT_SMALL, both LWE rings and u64 2^20 x 2, each in both
    # instances (the fast one, and the other with a cap of 0: S6's many-
    # block walk, S5's candidates in global memory); S6 also equal to the
    # host sampler and its advance, but at 2^20; the small ring at an int
    # and a tensor nonce across 2^64 - 1.  Then the words-in instance with
    # ambiguous words planted (S6 at the u32 LWE ring: rejected 2^64 - 1,
    # accepted 2^64 - n) and with the budget guard tripped (all words 2^64
    # - 1: all-ones residues, advance -1), S6 at _amb_cap 0 on the
    # keystream against its twin, and a chained pair: the second call at
    # nonce + the first's advance (a tensor) equal to a second host draw
    r_hs = nfl.ring_from_modulus(*HWT_SMALL)
    hwt_paths = collections.Counter()

    def hwt_case(r_, h_, nonce, cap, host):
        md_ = nfl.hwt_dist(h_)
        p_ = r_.context().to(dev).p_col
        args = (SAMPLER_KEY, nonce, p_, r_.degree, h_, r_.torch_dtype)
        got = _kernels.HWT_FIXED(*args, cap=cap)
        want = dsamp.device_hwt_plain(r_, SAMPLER_KEY, nonce, md_, dev)
        e5 = max_err(got, want, r_)
        (ex, adv) = _kernels.HWT_EXACT(*args, cap=cap)
        wx, wadv = dsamp.device_hwt_exact_plain(r_, SAMPLER_KEY, nonce, md_,
                                                True, device=dev)
        e6 = max_err(ex, wx, r_)
        err["hwt_fixed"] = max(err["hwt_fixed"], e5)
        err["hwt_exact"] = max(err["hwt_exact"], e6)
        what = f"{rlabel(r_)} h = {h_} nonce {nonce} cap {cap}"
        expect(e5 == 0, f"hwt_fixed != twin: {what}")
        expect(e6 == 0 and int(adv) == int(wadv),
               f"hwt_exact != twin: {what} (advance {int(adv)} vs "
               f"{int(wadv)})")
        if host:
            nonce_i = int(nonce) & ((1 << 64) - 1)
            st = Salsa20Stream(SAMPLER_KEY, nonce_i)
            hw = nfl.Poly.sample(r_, md_, st, dev).data
            expect(torch.equal(ex, hw) and int(adv)
                   == (st.nonce - nonce_i) % (1 << 64),
                   f"hwt_exact != the host sampler: {what}")
        for kern_ in (_kernels.HWT_FIXED, _kernels.HWT_EXACT):
            fast = kern_.plan(r_.degree, h_, cap=cap).fast
            hwt_paths[(kern_.name, "fast" if fast else "other")] += 1

    for r_ in (r_hs, *lwe_rings, r_u):
        for h_ in (1, r_.degree // 4, r_.degree):
            for cap in (None, 0):
                hwt_case(r_, h_, 9, cap, r_ is not r_u)
    for h_ in (1, r_hs.degree // 4, r_hs.degree):
        hwt_case(r_hs, h_, t_nonce, None, True)
    expect(len(hwt_paths) == 4, f"S5/S6 instances run: {dict(hwt_paths)}")
    r32 = lwe_rings[0]
    p32 = r32.context().to(dev).p_col
    wtot = dsamp._hwt_fills(r32.degree, HWT_H) * HWT_H
    planted = torch.randint(0, 1 << 62, (wtot,), generator=torch.Generator(
        device=dev).manual_seed(17), device=dev)
    q = r32.degree - HWT_H                      # the words a walk consumes
    planted[[3, q // 16, q // 2 + 7, q - 9]] = -1               # 2^64 - 1
    planted[[40, 3 * q // 4]] = -r32.degree                     # 2^64 - n
    guard_w = torch.full((dsamp._hwt_fills(r_hs.degree, 8) * 8,), -1,
                         dtype=torch.int64, device=dev)
    for cap in (None, 0):
        got, adv = _kernels.HWT_EXACT(SAMPLER_KEY, 9, p32, r32.degree,
                                      HWT_H, r32.torch_dtype, 8,
                                      words=planted, cap=cap)
        want, wadv = dsamp.hwt_exact_from_words(r32, SAMPLER_KEY, 9, planted,
                                                HWT_H, 8, dev)
        expect(torch.equal(got, want) and int(adv) == int(wadv) > 0,
               f"hwt_exact words-in (ambiguous words) != twin, cap {cap}")
        got, adv = _kernels.HWT_EXACT(
            SAMPLER_KEY, 9, r_hs.context().to(dev).p_col, r_hs.degree, 8,
            r_hs.torch_dtype, 64, words=guard_w, cap=cap)
        expect(bool((got == -1).all()) and int(adv) == -1,
               f"hwt_exact's budget guard did not poison, cap {cap}")
    got, adv = dsamp.device_hwt_exact(r32, SAMPLER_KEY, 9, md, True, 0, dev)
    want, wadv = dsamp.device_hwt_exact_plain(r32, SAMPLER_KEY, 9, md, True,
                                              0, dev)
    expect(torch.equal(got, want) and int(adv) == int(wadv),
           "hwt_exact at _amb_cap 0 != twin")
    st = Salsa20Stream(SAMPLER_KEY, 5)
    first = nfl.Poly.sample(r32, md, st, dev).data
    second = nfl.Poly.sample(r32, md, st, dev).data
    got1, adv1 = dsamp.device_hwt_exact(r32, SAMPLER_KEY, 5, md, True,
                                        device=dev)
    got2, adv2 = dsamp.device_hwt_exact(r32, SAMPLER_KEY, 5 + adv1, md,
                                        True, device=dev)
    expect(torch.equal(got1, first) and torch.equal(got2, second)
           and int(adv1) + int(adv2) == st.nonce - 5,
           "a chained pair of device_hwt_exact != two host draws")
    print(f"S5 and S6 vs twins at h = 1, n / 4, n on "
          + ", ".join(rlabel(r_) for r_ in (r_hs, *lwe_rings, r_u))
          + f" (instances run: {dict(hwt_paths)}), S6 vs the host sampler "
          f"and its advance but at 2^20, a tensor nonce across 2^64 - 1, "
          f"the words-in instance with planted ambiguous words, the budget "
          f"guard (all-ones residues, advance -1), _amb_cap 0 and a chained "
          f"pair: exact | {card}")
    # S1's raw keystream's main path: prng.device_stream_words (the JAX
    # package's device_stream_words), one launch, equal to the reference's
    # golden first 1 KB
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", "golden", "salsa20_golden.bin"),
              "rb") as f:
        golden_ks = f.read(1024)
    words, got = drive(("salsa20",), lambda: sal.device_stream_words(
        bytes(range(32)), 0, 16, dev), zero=tuple(
            n_ for n_ in KERNELS if n_ != "salsa20"))
    expect(got == {"salsa20": 1}
           and words.cpu().numpy().tobytes() == golden_ks,
           f"S1's keystream != the reference's golden first 1 KB, or "
           f"launches {got}")

    def fixed_args(r_, fg, nonce):
        """S3's arguments for the encryption's three samplers"""
        return (SAMPLER_KEY, nonce, [0, 1, 2], [1, 2, 2], r_.degree,
                fg.in_bits, fg.word_precision,
                dsamp.gaussian_tables(fg, dev).bw, fg.base_value,
                r_.context().to(dev).p_col, r_.torch_dtype)

    def exact_args(r_, fg, nonce, amp, key=SAMPLER_KEY):
        """S4's arguments for one sampler (device_sampling's)"""
        wp = fg.word_precision
        inn = int(np.float32(r_.degree) * np.float32(fg.innoise_multiplier))
        nbl = -(-r_.degree // max(1, (inn - wp) // wp))
        return (key, nonce, r_.degree, inn, nbl, fg.in_bits, wp,
                fg.lu_depth, dsamp.gaussian_tables(fg, dev, exact=True),
                fg.base_value, amp, r_.context().to(dev).p_col,
                r_.torch_dtype)

    fg16 = FastGaussianNoise(lwe.SIGMA, 128, 1 << 10, in_bits=16)
    fg250 = FastGaussianNoise(250.0, 128, 1 << 10)
    fg_d1 = FastGaussianNoise(3.2, 128, 1 << 10, lu_depth=1)
    r32 = nfl.ring_from_modulus(*LWE_RINGS[0])
    r_big = nfl.ring_from_modulus(*EXACT_GLOBAL)
    wrap_t = torch.full((), -2, dtype=torch.int64, device=dev)
    s3_cases, s4_cases = {}, {}
    for limb, degree, bits in LWE_RINGS:
        r_ = nfl.ring_from_modulus(limb, degree, bits)
        for fg, tag in ((g_demo, "in_bits 8"), (fg16, "in_bits 16")):
            s3_cases[f"{limb} {tag}"] = fixed_args(r_, fg, 9)
            s4_cases[f"{limb} {tag}"] = exact_args(r_, fg, 5, 2)
    s3_cases["u32 sigma 250"] = fixed_args(r32, fg250, 9)
    s3_cases["u32 nonce 2^64 - 2"] = fixed_args(r32, g_demo, (1 << 64) - 2)
    s3_cases["u32 tensor nonce -2"] = fixed_args(r32, g_demo, wrap_t)
    s4_cases["u32 lu_depth 1"] = exact_args(r32, fg_d1, 5, 1)
    s4_cases["u32 sigma 250"] = exact_args(r32, fg250, 5, 2)
    s4_cases["u32 nonce 2^64 - 2"] = exact_args(r32, g_demo,
                                                (1 << 64) - 2, 1)
    s4_cases["u32 tensor nonce -2"] = exact_args(r32, g_demo, wrap_t, 1)
    s4_cases[f"u32 n={r_big.degree}"] = exact_args(r_big, g_demo, 5, 1)
    for what, args in s3_cases.items():
        got = _kernels.GAUSSIAN_FIXED(*args)
        want = dsamp.gaussian_fixed_plain(*args)
        torch.cuda.synchronize()
        r_ = nfl.ring_from_modulus(*LWE_RINGS[what.startswith("u64")])
        e = max_err(got, want, r_)
        err["gaussian_fixed"] = max(err["gaussian_fixed"], e)
        expect(e == 0, f"gaussian_fixed != twin: {what}")
    planned = {}
    for what, args in s4_cases.items():
        (got, gf), (want, wf) = (_kernels.GAUSSIAN_EXACT(*args),
                                 dsamp.gaussian_exact_plain(*args))
        torch.cuda.synchronize()
        r_ = r_big if "n=" in what else nfl.ring_from_modulus(
            *LWE_RINGS[what.startswith("u64")])
        e = max_err(got, want, r_)
        err["gaussian_exact"] = max(err["gaussian_exact"], e)
        expect(e == 0 and torch.equal(gf, wf),
               f"gaussian_exact != twin: {what} (fills {gf.tolist()} vs "
               f"{wf.tolist()})")
        planned[what] = _kernels.GAUSSIAN_EXACT.plan(*args[2:6], args[6],
                                                     args[8].bw.shape[0])
    expect(all(planned[f"{lm} in_bits {ib}"][0] for lm in ("u32", "u64")
               for ib in (8, 16))
           and not planned[f"u32 n={r_big.degree}"][0],
           f"S4's instances: {planned} (the LWE samplers' walk in shared "
           f"memory, n = {r_big.degree}'s in global memory)")
    # below the fill size: every sampler, degree and tier against the twin
    # (and the host walk at EXACT_SMALL_HOST), then the nonce wrap at n = 8
    small_fgs = {k_: lwe.make_gaussian_prng(samples=256) if v_ is None
                 else FastGaussianNoise(*v_[:3], in_bits=v_[3],
                                        lu_depth=v_[4])
                 for k_, v_ in EXACT_SMALL_SAMPLERS.items()}
    small_cases = [(sm, lm, n_, 7) for sm in small_fgs
                   for lm in EXACT_SMALL_BITS for n_ in EXACT_SMALL_N] \
        + [("demo", "u32", 8, (1 << 64) - 2), ("demo", "u32", 8, wrap_t)]
    small_host = 0
    for sm, lm, n_, nonce in small_cases:
        r_ = nfl.ring_from_modulus(lm, n_, EXACT_SMALL_BITS[lm])
        args = exact_args(r_, small_fgs[sm], nonce, 2, EXACT_SMALL_KEY)
        (got, gf), (want, wf) = (_kernels.GAUSSIAN_EXACT(*args),
                                 dsamp.gaussian_exact_plain(*args))
        torch.cuda.synchronize()
        e = max_err(got, want, r_)
        err["gaussian_exact"] = max(err["gaussian_exact"], e)
        what = f"{sm} {lm} n={n_} nonce {int(nonce)} (innoise {args[3]})"
        expect(e == 0 and torch.equal(gf, wf),
               f"gaussian_exact != twin below the fill size: {what} "
               f"(fills {gf.tolist()} vs {wf.tolist()})")
        if (sm, lm, n_) in EXACT_SMALL_HOST and nonce == 7:
            st = Salsa20Stream(EXACT_SMALL_KEY, 7)
            host = samp.sample_gaussian(r_, st,
                                        nfl.gaussian(small_fgs[sm], 2))
            expect(got.cpu().numpy().view(r_.dtype).tolist()
                   == host.tolist() and int(gf[0]) == st.nonce - 7,
                   f"gaussian_exact != the host walk below the fill "
                   f"size: {what}")
            small_host += 1
    print(f"S1 vs twin: the Gaussian's stream shapes (one stream, "
          f"{fills_exact} refill streams), the nonce wrap (int and tensor "
          f"nonce), u64 2^20 x 2 uniform ({s1_shapes['uniform64'][1]} "
          f"blocks): exact; golden keystream's first 1 KB equal on the card; "
          f"S3 (3 samplers, amps 1, 2, 2) vs twin: {', '.join(s3_cases)}: "
          f"exact; S4 vs twin (residues, fills and next nonce): "
          + ", ".join(f"{w} ({'shared' if pl[0] else 'global'} walk, "
                      f"{pl[1]} B shared)" for w, pl in planned.items())
          + f": exact; below the fill size, {len(small_cases)} cases "
          f"({len(small_fgs)} samplers x n = {EXACT_SMALL_N} x "
          f"{len(EXACT_SMALL_BITS)} tiers, the nonce wrap at n = 8): exact, "
          f"{small_host} of them also the host walk's")

    ondev = {}
    for limb, (r_, keys, host_cts, nonces) in lwe_host.items():
        want = {"butterfly": ("lwe64_encrypt", "lwe64_decrypt")
                if limb == "u64" else ("lwe_encrypt", "lwe_decrypt"),
                "fused": ROUTE_KERNELS[limb], "auto": BFLY_NTT[limb]}
        for mode in LWE_MODES:
            zero = zero_of[mode]
            for exact in (False, True):
                def run_ondev():
                    total = torch.zeros(r_.shape, dtype=torch.int64,
                                        device=dev)
                    cts = []
                    for i in range(LWE_REPS):
                        nonce = nonces[i] if exact else 1000 + 3 * i
                        ra, rb = lwe.encrypt_on_device(
                            keys, r_, LWE_KEY, nonce, g_demo, exact=exact)
                        total += lwe.decrypt(keys, r_, ra, rb).to(
                            torch.int64)
                        cts.append((ra.data, rb.data))
                    return cts, total
                kern, other = ("gaussian_exact", "gaussian_fixed")[::(
                    1 if exact else -1)]
                set_mode(mode)
                try:
                    (cts, total), got = drive(
                        (kern,) + want[mode], run_ondev,
                        zero=zero + ("salsa20", other)
                        + (("modops_expr",) if mode == "butterfly" else ()),
                        record=False)
                finally:
                    set_mode("fused")
                launches[kern] = launches.get(kern, 0) + got[kern]
                expect(got[kern] == LWE_REPS * (3 if exact else 1),
                       f"encrypt_on_device {limb} {mode} exact={exact}: "
                       f"{got[kern]} {kern} launches in {LWE_REPS} calls")
                # fused, auto: E1 twice an encrypt (the muladds), once a
                # decrypt
                expect(got.get("modops_expr", 0)
                       == (0 if mode == "butterfly" else 3 * LWE_REPS),
                       f"encrypt_on_device {limb} {mode} exact={exact}: "
                       f"{got.get('modops_expr', 0)} E1 launches in "
                       f"{LWE_REPS} calls and decryptions")
                launches["modops_expr"] = launches.get("modops_expr", 0) \
                    + got.get("modops_expr", 0)
                expect(total.shape == r_.shape and not bool(total.any()),
                       f"encrypt_on_device zero-sum gate failed on {limb} "
                       f"{mode} exact={exact}")
                if exact:
                    expect(all(torch.equal(x, y) for pd, ph in
                               zip(cts, host_cts) for x, y in zip(pd, ph)),
                           f"exact encrypt_on_device != host encrypt on "
                           f"{limb} in {mode} mode")
                ondev[(limb, mode, exact)] = got

    print(f"main path encrypt_on_device: {LWE_REPS} x encrypt/decrypt on "
          f"u32 (16384, 510) and u64 (16384, 496), "
          f"{', '.join(LWE_MODES)}, "
          f"fixed and exact: zero-sum gate passed; exact ciphertexts equal "
          f"the host encrypt's of phase 8b; launches "
          + "; ".join(f"{lm} {md}{' exact' if ex else ''} {c}"
                      for (lm, md, ex), c in ondev.items()))

    # 8f. the native host runtime (native.py over csrc/nfl_native.cpp,
    # built with g++ in phase 2, before any stream) against the Python
    # tier on the LWE rings, exact: the keystream bytes (the Gaussian's
    # buffer, across the nonce wrap), the uniform residues, the Gaussian
    # walk's values and nonce at rlen 16384 and the samplers at amplifiers
    # 1 and 2, the CRT round trip of phase 7's 496-bit product.  Then the
    # host LWE path on both rings in butterfly mode at batch 1: keygen, one
    # host encrypt and a run_zero_sum_check of LWE_REPS repetitions, with
    # the native walk and with the Python walk (the stream and the uniform
    # sampler stay native), each the median of 5 on the host clock up to a
    # synchronize; both walks give phase 8b's keys and ciphertexts, which
    # 8e's exact encrypt_on_device matched.  (The profiling.trace check
    # runs after 10d: a profile with host activity loses the device events
    # of a later CUDA-only profile.)
    def python_walk(fn):
        """fn() with FastGaussianNoise.get_noise on the Python walk"""
        saved = FastGaussianNoise.get_noise
        FastGaussianNoise.get_noise = FastGaussianNoise._get_noise_py
        try:
            return fn()
        finally:
            FastGaussianNoise.get_noise = saved

    def host_ms(fn, runs=5):
        """median ms of `runs` calls of fn(), host clock to a synchronize"""
        out = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    def numpy_stream(key, nonce=0):
        s_ = Salsa20Stream(key, nonce)
        expect(s_._native is native, "Salsa20Stream is not on the native "
                                     "tier")
        s_._native = None
        return s_

    nbytes_g = int(np.float32(LWE_RINGS[0][1])
                   * np.float32(g_demo.innoise_multiplier))
    for nonce in (0, 5, (1 << 64) - 1):
        n8 = nonce.to_bytes(8, "little")
        expect(native.salsa20_stream(nbytes_g, n8, LWE_KEY)
               == sal.crypto_stream(nbytes_g, n8, LWE_KEY),
               f"native keystream != numpy tier at nonce {nonce}")
    s1_, s2_ = Salsa20Stream(LWE_KEY, 5), Salsa20Stream(LWE_KEY, 5)
    expect(np.array_equal(g_demo.get_noise(s1_, LWE_RINGS[0][1]),
                          g_demo._get_noise_py(s2_, LWE_RINGS[0][1]))
           and s1_.nonce == s2_.nonce,
           "native Gaussian walk != the Python walk at rlen 16384")
    for limb, degree, bits in LWE_RINGS:
        r_ = nfl.ring_from_modulus(limb, degree, bits)
        a_, b_ = Salsa20Stream(LWE_KEY, 9), numpy_stream(LWE_KEY, 9)
        expect(np.array_equal(samp.sample_uniform(r_, a_),
                              samp.sample_uniform(r_, b_))
               and a_.nonce == b_.nonce == 10,
               f"native uniform != Python tier on {limb}")
        for amp in (1, 2):
            a_, b_ = Salsa20Stream(LWE_KEY, 9), Salsa20Stream(LWE_KEY, 9)
            mode = nfl.gaussian(g_demo, amp)
            expect(np.array_equal(
                samp.sample_gaussian(r_, a_, mode),
                python_walk(lambda: samp.sample_gaussian(r_, b_, mode)))
                and a_.nonce == b_.nonce,
                f"native Gaussian != Python walk on {limb} amp {amp}")
    arr37 = nfl.Poly(c64.data[37].cpu(), ring64).numpy()
    lifted = crt.poly2mpz(nfl.Poly.from_numpy(ring64, arr37, "cpu"))
    expect(lifted == crt._poly2mpz_py(arr37, ctx64)
           and np.array_equal(crt.mpz2poly(ring64, lifted, "cpu").numpy(),
                              arr37)
           and np.array_equal(crt._reduce_rows(ring64, lambda cm: lifted),
                              arr37),
           "native CRT round trip != Python tier on the 496-bit product")
    how = "already built" if native_cached else \
        f"{os.environ.get('CXX', 'g++')} {' '.join(native.CXX_FLAGS)}"
    rings_ = " and ".join(f"{lm} ({n_}, {b_})" for lm, n_, b_ in LWE_RINGS)
    print(f"native host tier: built in {native_s:.2f} s ({how}) -> "
          f"{native._so_path().name}; equal to the Python tier: keystream "
          f"({nbytes_g} bytes at nonces 0, 5, 2^64 - 1), uniform and "
          f"Gaussian (amps 1, 2) on {rings_}, the walk's values and nonce "
          f"at rlen {LWE_RINGS[0][1]}, the CRT round trip of the 496-bit "
          f"product | {card}")
    set_mode("butterfly")
    try:
        for limb, degree, bits in LWE_RINGS:
            r_, keys_b, cts_b, nonces_b = lwe_host[limb]
            ms, ok = {}, {}
            for walk in ("native", "python"):
                run_ = (lambda f: f()) if walk == "native" else python_walk
                keys_ = run_(lambda: lwe.keygen(r_, Salsa20Stream(LWE_KEY),
                                                g_demo, dev))
                ct_ = run_(lambda: lwe.encrypt(
                    keys_, r_, Salsa20Stream(LWE_KEY, nonces_b[0]), g_demo))
                expect(all(getattr(keys_, k) == getattr(keys_b, k)
                           for k in ("s", "sprime", "pka", "pkb"))
                       and torch.equal(ct_[0].data, cts_b[0][0])
                       and torch.equal(ct_[1].data, cts_b[0][1]),
                       f"host keygen / encrypt on the {walk} walk != phase "
                       f"8b's on {limb}")
                ms[walk] = (
                    host_ms(lambda: run_(lambda: lwe.keygen(
                        r_, Salsa20Stream(LWE_KEY), g_demo, dev))),
                    host_ms(lambda: run_(lambda: lwe.encrypt(
                        keys_b, r_, Salsa20Stream(LWE_KEY, nonces_b[0]),
                        g_demo))),
                    host_ms(lambda: ok.__setitem__(walk, run_(
                        lambda: lwe.run_zero_sum_check(
                            r_, LWE_REPS, key=LWE_KEY, device=dev)))))
                expect(ok[walk], f"run_zero_sum_check failed on {limb} "
                                 f"with the {walk} walk")
            # where a native host encrypt's time goes: its three samplers'
            # walks, the walks with sample_gaussian's channel loop, and
            # Poly.sample (the storage conversion and the copy to the card)
            st_, gm_ = Salsa20Stream(LWE_KEY), nfl.gaussian(g_demo, 2)
            split = [host_ms(lambda: [fn() for _ in range(3)]) for fn in (
                lambda: g_demo.get_noise(st_, degree),
                lambda: samp.sample_gaussian(r_, st_, gm_),
                lambda: nfl.Poly.sample(r_, gm_, st_, dev))]
            print(f"host LWE path {limb} (n={degree}, {bits}-bit q), "
                  f"butterfly, batch 1 (median of 5, host clock to a "
                  f"synchronize; stream and uniform native): "
                  + "; ".join(f"{w_} walk: keygen {k_:.4f} ms, encrypt "
                              f"{e_:.4f} ms, run_zero_sum_check({LWE_REPS}) "
                              f"{z_:.4f} ms"
                              for w_, (k_, e_, z_) in ms.items())
                  + f"; of a native encrypt, three samplers: walks "
                  f"{split[0]:.4f} ms, with sample_gaussian's channel loop "
                  f"{split[1]:.4f} ms, Poly.sample to the card "
                  f"{split[2]:.4f} ms; keys and ciphertexts equal phase "
                  f"8b's | {card}")
    finally:
        set_mode("fused")

    # 8g. E1 (csrc/modops_expr.cu): the JAX package's jitted pointwise
    # programs, one launch a named op or a forced Expr tree.  Every opcode
    # against its twin (expr_program.run_plain on the card), exact, at
    # u32 2^14 x 17 x 64 and u64 2^14 x 8 x 64, on residues and on the
    # words 0, 1, p - 1, p, p + 1, 2^w - 1 and two arbitrary words, which
    # meet in every pair in the first polynomial (arbitrary Shoup
    # companions there, the residues' own elsewhere); E1_TREES random trees
    # a shape (shared subtrees, both muladd rewrites, shoup, [m, n] leaves
    # broadcast over the batch), each one launch and equal to the twin's
    # walk of its program; torch.profiler (CUDA only, before 10d's host
    # profiles): one CUDA kernel a named Poly op and a forced tree; strict
    # mode raises on a leaf p before the launch and still runs E1 on
    # residues.  Every instance family runs and is exact: the named ops at
    # these shapes take the compiled one-node instance with 16-byte vector
    # lanes, the trees the interpreter with them; a named op and a tree on
    # an odd slab (the first n - 1 words of each row) and on a leaf one
    # word off the 16-byte grid take the one-word instances.  Then the
    # main path: the quick-start product shoup(fa * fb,
    # compute_shoup(fb)).invntt_pow_invphi() in fused mode at both shapes,
    # two E1 launches beside the route's, exact against Python integers.
    t0 = time.perf_counter()
    e1 = k_by_name["modops_expr"]
    e1_ops = {}
    e1_seen = collections.Counter()
    for tier, (r_, x_, _) in main_inputs.items():
        tabs_ = r_.context().to(dev)
        shape = tuple(x_.data.shape)
        gen = torch.Generator(device=dev).manual_seed(13)
        words = [special_words(r_, gen, shape, k, dev) for k in range(4)]
        for op in expr_program.OPS:
            leaves = words[:expr_program.ARITY[op]]
            if "shoup" in op and op != "compute_shoup":
                own = modops.compute_shoup(leaves[-2], tabs_.p_col,
                                           tabs_.shoup_f)
                leaves[-1] = torch.where(
                    torch.arange(shape[0], device=dev)[:, None, None] == 0,
                    leaves[-1], own)
            prog = expr_program.op_program(op)
            before = e1.launches
            got = expr_program.run(prog, leaves, r_)
            want = expr_program.run_plain(prog, leaves, tabs_)
            torch.cuda.synchronize()
            e = max_err(got, want, r_)
            err["modops_expr"] = max(err["modops_expr"], e)
            expect(e == 0 and e1.launches == before + 1
                   and e1.last_instance == ("named", E1_VEC[tier]),
                   f"modops_expr {op} {tier}: max |err| {e}, "
                   f"{e1.launches - before} launches, instance "
                   f"{e1.last_instance}")
            e1_seen[(tier,) + e1.last_instance] += 1
            if (tier, op) in E1_TIMED:
                e1_ops[(tier, op)] = (prog, leaves)
    g = np.random.default_rng(31)
    ntrees = 0
    for tier, (r_, x_, y_) in main_inputs.items():
        tabs_ = r_.context().to(dev)
        polys = [x_, y_, nfl.Poly(x_.data[1], r_), nfl.Poly(y_.data[2], r_)]
        comps = {id(q): q.compute_shoup() for q in polys}

        def tree(depth, pool):
            if pool and g.random() < 0.15:
                return pool[int(g.integers(len(pool)))]
            if depth == 0 or g.random() < 0.25:
                return polys[int(g.integers(len(polys)))]
            if g.random() < 0.15:
                q = polys[int(g.integers(len(polys)))]
                e_ = nfl.shoup(tree(depth - 1, pool) * q, comps[id(q)])
            else:
                u_, v_ = tree(depth - 1, pool), tree(depth - 1, pool)
                e_ = (u_ + v_, u_ - v_, u_ * v_)[int(g.integers(3))]
            pool.append(e_)
            return e_
        for _ in range(E1_TREES):
            t_ = tree(int(g.integers(2, 6)), [])
            if not isinstance(t_, nfl.Expr):
                t_ = t_ * polys[1] + polys[3]
            prog, leaves = expr_program.from_expr(t_)
            want = expr_program.run_plain(prog, [q.data for q in leaves],
                                          tabs_)
            before = e1.launches
            got = t_.poly().data
            torch.cuda.synchronize()
            e = max_err(got, want, r_)
            err["modops_expr"] = max(err["modops_expr"], e)
            expect(e == 0 and e1.launches == before + 1
                   and e1.last_instance[1] == E1_VEC[tier],
                   f"modops_expr tree {ntrees} ({len(prog.nodes)} nodes): "
                   f"max |err| {e}, {e1.launches - before} launches, "
                   f"instance {e1.last_instance}")
            e1_seen[(tier,) + e1.last_instance] += 1
            ntrees += 1
        # the one-word instances: an odd slab, a leaf off the 16-byte grid
        words = [special_words(r_, torch.Generator(device=dev).manual_seed(
            17), tuple(x_.data.shape), k, dev) for k in range(3)]
        flat = torch.empty(words[1].numel() + 1, dtype=words[1].dtype,
                           device=dev)
        shifted = flat[1:].view(words[1].shape)
        shifted.copy_(words[1])
        expect(shifted.is_contiguous() and shifted.data_ptr() % 16,
               "the shifted leaf is on the 16-byte grid")
        odd = [w[..., :-1].contiguous() for w in words]
        named = expr_program.op_program("muladd")
        tree = expr_program.Program(3, (("muladd", (0, 1, 2)),
                                        ("submod", (3, 1))))
        for what, leaves, lanes in (
                ("aligned", words, E1_VEC[tier]), ("odd slab", odd, 1),
                ("shifted leaf", [words[0], shifted, words[2]], 1)):
            for prog, family in ((named, "named"), (tree, "tree")):
                before = e1.launches
                got = expr_program.run(prog, leaves, r_)
                want = expr_program.run_plain(prog, leaves, tabs_)
                torch.cuda.synchronize()
                e = max_err(got, want, r_)
                err["modops_expr"] = max(err["modops_expr"], e)
                expect(e == 0 and e1.launches == before + 1
                       and e1.last_instance == (family, lanes),
                       f"modops_expr {family} {tier} {what}: max |err| {e}, "
                       f"instance {e1.last_instance}")
                e1_seen[(tier,) + e1.last_instance] += 1
    for tier in main_inputs:
        for fam in (("named", E1_VEC[tier]), ("tree", E1_VEC[tier]),
                    ("named", 1), ("tree", 1)):
            expect(e1_seen[(tier,) + fam] > 0,
                   f"modops_expr {tier}: instance {fam} never ran "
                   f"({dict(e1_seen)})")

    def cuda_kernels(fn, per_call=1, reps=3):
        """{CUDA kernel: launches} of `reps` calls of fn(), which launches
        `per_call` kernels, in torch.profiler (profile_kernels: CUDA
        activity only, after the warm-up kernels; a session that shows
        fewer than per_call * reps launches runs again)"""
        fn()
        torch.cuda.synchronize()
        kern, _ = profile_kernels(torch, dev, lambda: [
            fn() for _ in range(reps)], per_call * reps)
        out = {}
        for key, count, _ in kern:
            name = key.replace("(anonymous namespace)::", "") \
                .replace("void ", "").split("(")[0][:48]
            out[name] = out.get(name, 0) + count
        return out

    r_, x_, y_ = main_inputs["u32"]
    yp_ = y_.compute_shoup()
    seen = {}
    for what, fn in (
            ("mulmod", lambda: x_.mulmod(y_)),
            ("mulmod_shoup", lambda: x_.mulmod_shoup(y_, yp_)),
            ("muladd", lambda: x_.muladd(y_, x_)),
            ("muladd_shoup", lambda: x_.muladd_shoup(y_, x_, yp_)),
            ("compute_shoup", lambda: y_.compute_shoup()),
            ("a forced tree", lambda: (((x_ * y_ + x_) - nfl.shoup(
                y_ * y_, yp_)) * x_).poly())):
        seen[what] = cuda_kernels(fn)
        expect(len(seen[what]) == 1 and all(
            "modops_expr_kernel" in k_ and v_ == 3
            for k_, v_ in seen[what].items()),
               f"{what} on the card, 3 calls: CUDA kernels {seen[what]}")
    bad = x_.data[:1].clone()
    bad[0, 0, 0] = int(r_.moduli[0])
    debug.set_strictmod(True)
    try:
        before = e1.launches
        expect(raises(lambda: nfl.Poly(bad, r_).mulmod(y_)),
               "strict mode let a leaf p through E1")
        expect(e1.launches == before, "E1 launched on a leaf p")
        strict_ok = x_.mulmod(y_)
        expect(e1.launches == before + 1, "strict mode did not launch E1")
    finally:
        debug.set_strictmod(False)
    expect(strict_ok == x_.mulmod(y_), "strict E1 != E1")
    e1_main = 0
    for tier, (r_, x_, y_) in main_inputs.items():
        c_, got = drive(("modops_expr",) + ROUTE_KERNELS[tier],
                        lambda: product(nfl, x_, y_),
                        zero=("dft_mxu64_pipe",), record=False)
        expect(got["modops_expr"] == 2,
               f"the {tier} product launched E1 {got['modops_expr']} times")
        check_coeffs(x_, y_, c_, r_, 8)
        e1_main += got["modops_expr"]
    launches["modops_expr"] = launches.get("modops_expr", 0) + e1_main
    print(f"modops_expr vs twin: {len(expr_program.OPS)} opcodes x u32 "
          f"{tuple(main_inputs['u32'][1].data.shape)} and u64 "
          f"{tuple(main_inputs['u64'][1].data.shape)} on residues and the "
          f"extreme words, {ntrees} random trees, a named op and a tree on "
          f"an odd slab and a shifted leaf: exact, one launch each; "
          f"instances (tier, kind, words a step): {dict(e1_seen)}; "
          f"torch.profiler: {seen}; strict mode raises before the launch "
          f"and launches on residues; main path: the quick-start product "
          f"at both shapes, 2 E1 launches each, exact coefficients; "
          f"{time.perf_counter() - t0:.1f} s | {card}")

    # 9. strict mode
    ring, ctx, a, c = u32_state

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

    # 10a'. K11's launch path (one E1 launch): its kernel is about as short
    # as a launch from Python, so its sample may time the host.  The host's
    # ms a call
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
        if "modops_expr_kernel" in evt.key and us > 0:
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
            chunks = len(_kernels.batch_chunks(batch))
            kern, tries = profile_kernels(
                torch, dev, lambda: mod.lwe_encrypt_fused(*args, c_), chunks)
            n_launch = sum(n_ for _, n_, _ in kern)
            expect(n_launch == chunks,
                   f"{name} at batch {batch}: {n_launch} CUDA launches, "
                   f"not {chunks}, in {tries} profiles: {kern}")
            ms1 = timed(lambda v: mod.lwe_encrypt_fused(*v, c_), args,
                        KERNEL_REPS)
            ms_d = timed(lambda v: mod.lwe_decrypt_fused(*v, c_), tuple(
                v[:batch] for v in dec_args[:2]) + dec_args[2:],
                KERNEL_REPS)
            print(f"{name} {limb} n={r_.degree} m={r_.nmoduli} batch={batch}"
                  f": {n_launch} CUDA launch ({chunks} chunk): "
                  + "; ".join(f"{k_} x{n_} {us / n_ / 1e3:.4f} ms device"
                              for k_, n_, us in kern)
                  + f" (torch.profiler, {tries} profiles); events "
                  f"{ms1:.4f} ms an encrypt, "
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

    # 10f. 8h's rns steps: events ms of the whole ring's step and of each
    # block's, in each mode, and the device ms and CUDA kernels of one step
    # (a CUDA-only profile)
    for tag, (mode, c_, args) in rns_calls.items():
        set_mode(mode)
        for _ in range(2):
            timed(lambda v: rns_step(c_, *v), args, 1)
        ms = statistics.median(timed(lambda v: rns_step(c_, *v), args,
                                     RNS_REPS) for _ in range(RNS_SAMPLES))
        kern, tries = profile_kernels(torch, dev,
                                      lambda: rns_step(c_, *args), 1)
        print(f"timing rns step {tag}: {ms:.4f} ms a step (encrypt, two "
              f"decrypts, forward and inverse NTT), median of {RNS_SAMPLES} "
              f"samples of {RNS_REPS} calls; device "
              f"{sum(us for _, _, us in kern) / 1e3:.4f} ms, "
              f"{sum(n_ for _, n_, _ in kern)} CUDA kernels a step "
              f"(torch.profiler, {tries} profiles) | {card}")
    set_mode("fused")
    # 8h''s draws on a block beside the whole ring's: CUDA kernels a call
    # and their device ms (a CUDA-only profile of one call; a block's
    # profile runs again while it shows fewer kernels than the whole's),
    # events ms (median of RNS_SAMPLES samples of KERNEL_REPS calls back to
    # back) and the host's us a call (HOST_REPS calls on the host clock
    # before the synchronize)
    blk_time = {}
    for (limb, name, tag), (mode, fn) in blk_calls.items():
        set_mode(mode)
        for _ in range(2):
            fn()
        ms = statistics.median(timed(lambda v, f2=fn: f2(), None,
                                     KERNEL_REPS)
                               for _ in range(RNS_SAMPLES))
        want_k = blk_time[limb, name, "whole"][0] if tag != "whole" else 1
        kern, tries = profile_kernels(torch, dev, fn, want_k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            fn()
        host_us = (time.perf_counter() - t0) / HOST_REPS * 1e6
        torch.cuda.synchronize()
        blk_time[limb, name, tag] = (sum(n_ for _, n_, _ in kern),
                                     sum(us for _, _, us in kern) / 1e3, ms,
                                     host_us, tries)
    set_mode("fused")
    for limb, name in dict.fromkeys((k_[0], k_[1]) for k_ in blk_time):
        rows_ = {t_: v_ for (l_, n_, t_), v_ in blk_time.items()
                 if (l_, n_) == (limb, name)}
        nk_w, dev_w = rows_["whole"][:2]
        parts = []
        for t_, (nk, dms, ms, hus, _) in rows_.items():
            same = "" if nk == nk_w else f" (the whole: {nk_w})"
            share = "" if t_ == "whole" else (
                f", {dms / dev_w:.3f} of the whole's device time" if dev_w
                else ", device share not measured")
            parts.append(f"{t_} {nk} CUDA kernels{same}, device {dms:.4f} "
                         f"ms{share}, events {ms:.4f} ms, host {hus:.1f} us")
        print(f"timing block draw {limb} {name}, a call: "
              + "; ".join(parts) + f" | {card}")

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
                set_mode("fused")
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
            tf_, ta2_ = compare(in_mode("fused", graph),
                                in_mode("auto", graph), args, (1, 1))
            print(f"timing LWE {gname_} {limb} n={r_.degree} m={r_.nmoduli} "
                  f"batch={args[0].shape[0]}: butterfly mode (chain kernel) "
                  f"{tb_:.4f} ms against auto mode (K3/K7 + E1) "
                  f"{ta_:.4f} ms; fused mode (the routes + E1) {tf_:.4f} ms "
                  f"against auto {ta2_:.4f} ms; one call a sample, medians "
                  f"of {TIMING_RUNS} in turns | {card}")
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
    # E1 against its twin at the main-path shapes (E1_TIMED): bytes, each
    # leaf read once and the output written once, against the integer
    # instructions of its math (STEP_OPS; a u64 product's high words
    # counted as sm_90 issues them)
    for (tier, op), (prog, leaves) in e1_ops.items():
        r_ = main_inputs[tier][0]
        tabs_ = r_.context().to(dev)
        tk, tp = compare(
            lambda v, p_=prog, r2=r_: expr_program.run(p_, v, r2),
            lambda v, p_=prog, t2=tabs_: expr_program.run_plain(p_, v, t2),
            leaves)
        moved = nbytes(*leaves) + nbytes(leaves[0])
        b_ = bound(int_ms(*(leaves[0].numel()
                            * steps(r_.limb, *E1_STEPS[op]))), moved)
        # the device's own time (torch.profiler, CUDA only): on events a
        # call also holds the wrapper's host path when that is longer
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            warm_up(torch, dev)
            for _ in range(KERNEL_REPS):
                expr_program.run(prog, leaves, r_)
            torch.cuda.synchronize()
        t_dev = "not measured (no device time in the profile)"
        for evt in prof.key_averages():
            us = max(getattr(evt, a_, 0) or 0 for a_ in (
                "self_device_time_total", "self_cuda_time_total"))
            if "modops_expr_kernel" in evt.key and us > 0:
                t_dev = (f"{us / evt.count / 1e3:.4f} ms "
                         f"({moved / (us / evt.count) / 1e3:.1f} GB/s, "
                         f"{100 * b_[0] * 1e3 / (us / evt.count):.1f} % of "
                         f"the bound; {evt.count} kernels)")
        # the host's us a call at batch 1: E1_HOST_CALLS calls issued back
        # to back on the host clock (a batch-1 kernel is a few us, so the
        # queue never fills), the median of 5
        one = [t[:1] for t in leaves]
        expr_program.run(prog, one, r_)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(E1_HOST_CALLS):
                expr_program.run(prog, one, r_)
            host.append((time.perf_counter() - t1) / E1_HOST_CALLS * 1e6)
            torch.cuda.synchronize()
        print(f"timing modops_expr {op} {tier} "
              f"{tuple(leaves[0].shape)}: kernel {tk:.4f} ms "
              f"({moved / tk / 1e6:.1f} GB/s), twin {tp:.4f} ms, medians of "
              f"{TIMING_RUNS}; device {t_dev} (torch.profiler); bound "
              f"{b_[0]:.4f} ms ({b_[1]}, {moved / 1e6:.1f} MB), "
              f"{100 * b_[0] / tk:.1f} % of the events' time; instance "
              f"{k_by_name['modops_expr'].last_instance}; host "
              f"{statistics.median(host):.1f} us a "
              f"call at {tuple(one[0].shape)} (median of 5 x "
              f"{E1_HOST_CALLS} calls, host clock) | {card}")
        if (tier, op) == E1_TIMED[0]:
            times["modops_expr"], bounds["modops_expr"] = (tk, tp), b_
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
    # 10e. the measuring scripts, each through its main(argv) in this
    # process with the launch counters at 0 before it, its output captured,
    # echoed and read: bench_torch.py at the main shape in BENCH_MODES
    # (bench.py's last-line keys and metric, a positive value, and every
    # application the mode's launches and no other kernel's);
    # tools/bench_ops_torch.py at BENCH_OPS_CONFIGS (every row finite,
    # every device row timed on the device and launching the port's
    # kernels: E1 alone for the elementwise rows, K3/K7 for the NTTs, in
    # its default auto mode); tools/prng_bench_torch.py with each sampler
    # at PRNG_SAMPLES (mean and std, and S3 or S4 launched for the device
    # samplers).
    # Before 10d: a profile with host activity made later CUDA-only
    # sessions, the scripts' kind, lose their device events
    def measuring_scripts():
        """phase 10e, in a scope of its own"""
        here = os.path.dirname(os.path.abspath(__file__))
        sys.path.insert(0, os.path.join(here, "tools"))
        import bench_ops_torch
        import bench_torch
        import prng_bench_torch

        def script(mod, argv):
            """(stdout, stderr) of mod.main(argv), echoed indented"""
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = mod.main(argv)
            for ln in (err.getvalue() + out.getvalue()).splitlines():
                print(f"  {ln}")
            print(f"  ({mod.__name__} {' '.join(argv)}: exit {rc}, "
                  f"{time.perf_counter() - t0:.1f} s)")
            expect(rc == 0, f"{mod.__name__} {argv} exited {rc}")
            return out.getvalue(), err.getvalue()

        t_scripts = time.perf_counter()
        for mode, per_app in BENCH_MODES:
            (out, err), got = drive(
                list(per_app), lambda: script(bench_torch, ["--mode", mode]),
                record=False)
            res = json.loads(out.strip().splitlines()[-1])
            apps = int(re.search(r"applications: (\d+)", err).group(1))
            expect(set(res) == {"metric", "value", "unit", "vs_baseline"}
                   and res["metric"] == "rns_ntt_n2pow14_per_sec_per_chip"
                   and res["value"] > 0, f"bench_torch --mode {mode}: {res}")
            expect(got == {k: n * apps for k, n in per_app.items()},
                   f"bench_torch --mode {mode}: {apps} applications launched "
                   f"{got}, not {per_app} each")
        ntt_names = set(BFLY_NTT["u32"] + BFLY_NTT["u64"])
        elementwise = {row[0] for row in bench_ops_torch.ELEMENTWISE}
        for config in BENCH_OPS_CONFIGS:
            (out, _), _ = drive((), lambda: script(
                bench_ops_torch, ["--config", str(config), "--csv"]),
                record=False)
            rows = [ln.split(",") for ln in out.strip().splitlines()[1:]]
            expect(len(rows) == 13, f"bench_ops_torch --config {config}: "
                                    f"{len(rows)} rows")
            for r in rows:
                name, us, dev_us, wrappers = r[3], r[4], r[5], r[7]
                ran = {w.split(":")[0] for w in wrappers.split(";") if w}
                expect(np.isfinite(float(us)), f"bench_ops_torch {r}")
                if name.endswith("(host)"):
                    continue
                want = ({"modops_expr"} if name in elementwise
                    else ntt_names if name.startswith(("ntt", "invntt"))
                    else ntt_names | {"modops_expr"})
                expect(float(dev_us) > 0 and ran and ran <= want,
                       f"bench_ops_torch --config {config} {name}: device "
                       f"{dev_us} us, launched {ran}, not in {want}")
        gaussians = ("gaussian_fixed", "gaussian_exact")
        for sampler, kern in (("host", ()), ("device", gaussians[:1]),
                              ("device_exact", gaussians[1:])):
            (out, _), _ = drive(kern, lambda: script(prng_bench_torch, [
                "--samples", str(PRNG_SAMPLES), "--sigma", str(lwe.SIGMA),
                "--sampler", sampler, "--key", SAMPLER_KEY.hex()]),
                zero=[k for k in gaussians if k not in kern], record=False)
            stats = re.search(r"^mean (\S+) \(expect 0\)\s+std (\S+) ", out,
                              re.M)
            mean, std = float(stats.group(1)), float(stats.group(2))
            expect(abs(mean) < PRNG_MEAN
                   and abs(std - lwe.SIGMA) < PRNG_STD * lwe.SIGMA,
                   f"prng_bench_torch --sampler {sampler}: mean {mean}, std "
                   f"{std}")
        print(f"measuring scripts: bench_torch {len(BENCH_MODES)} modes, "
              f"bench_ops_torch configs {list(BENCH_OPS_CONFIGS)}, "
              f"prng_bench_torch 3 samplers x {PRNG_SAMPLES} in "
              f"{time.perf_counter() - t_scripts:.1f} s | {card}")

    measuring_scripts()

    # 10d. the device samplers.  S1, S3 and S4 against their twins
    # (events, in turns): S1 at the u64 2^20 x 2 uniform's 16 MB of
    # keystream (its main path) and the Gaussian's stream shapes, S3 at the
    # encryption's three samplers and S4 at one sampler on both LWE rings;
    # encrypt_on_device at batch 1 (events, LWE_REPS calls back to back)
    # beside the host encrypt of the same ring and mode (host clock, to a
    # synchronize: its Gaussians are the host walk).  Bounds (operations
    # against the bytes each input is read and each output written once):
    # S1 640 rotates and xors a 64-byte block on the ALU pipe and 336 adds,
    # which issue on either pipe (IADD3 or IMAD), against its 64 bytes
    # written; S3 the Salsa20 blocks its samples read plus the integer
    # instructions its search needs on these inputs (counted from the data:
    # a halving 4 ALU + 1 FMA, a word compared 3 ALU, a sample's set-up 4
    # ALU + 2 FMA and its encoding 3 ALU + 1 FMA a channel) against the
    # residues written and the table and moduli read; S4 the same for the
    # fills the host walk makes and the samples it selects (a consumption
    # and lookup 4 ALU and 2 shared-memory loads a sample, the search where
    # the tables leave it open), with its shared-memory accesses (the
    # keystream stored, the words and tables loaded) at one warp
    # instruction an SM a clock, against the residues, the fill word and
    # the tables.  The pointer doubling's own shared-memory traffic is the
    # design's and prints apart.  S1 at the 16 MB uniform, S3 and S4 at
    # the u32 LWE sampler: their device time a call (torch.profiler, CUDA
    # only), apart from the host's launch path that the events include
    # S1's sampler instances at their main paths (the uniform at u64 2^20
    # x 2, the non-uniform and ZO at the u32 LWE ring), and the hwt pair at
    # both LWE rings (each of S5's or S6's two kernels, its mean a launch:
    # a profile may drop events), also profiled here
    nonce, nbl, fills = s1_shapes["uniform64"]
    f_args, x_args = s3_cases["u32 in_bits 8"], s4_cases["u32 in_bits 8"]
    inst_timed = (
        ("salsa20_uniform", r_u, nfl.uniform()),
        ("salsa20_non_uniform", lwe_rings[0],
         nfl.non_uniform(*NON_UNIFORM_CASES[1])),
        ("salsa20_zo", lwe_rings[0], nfl.ZO_dist(ZO_RHOS[0])))
    md = nfl.hwt_dist(HWT_H)
    hwt_timed = {(tag, limb): (r_, fn_, twin_)
                 for r_, limb in zip(lwe_rings, ("u32", "u64"))
                 for tag, fn_, twin_ in (
                     ("hwt_fixed", lambda r2=r_: dsamp.device_hwt(
                         r2, SAMPLER_KEY, 5, md, dev),
                      lambda r2=r_: dsamp.device_hwt_plain(
                          r2, SAMPLER_KEY, 5, md, dev)),
                     ("hwt_exact", lambda r2=r_: dsamp.device_hwt_exact(
                         r2, SAMPLER_KEY, 5, md, device=dev),
                      lambda r2=r_: dsamp.device_hwt_exact_plain(
                          r2, SAMPLER_KEY, 5, md, device=dev)))}
    dev_time = {}
    for name, fn, frags, work in (
            ("salsa20", lambda: sal.keystream(SAMPLER_KEY, nonce, nbl, fills,
                                              dev),
             ("salsa20_kernel",), f"{64 * nbl * fills / 1e6:.1f} MB"),
            ("gaussian_fixed", lambda: _kernels.GAUSSIAN_FIXED(*f_args),
             ("gaussian_fixed_kernel",),
             f"3 x {f_args[4]} samples"),
            ("gaussian_exact", lambda: _kernels.GAUSSIAN_EXACT(*x_args),
             ("gaussian_walk_kernel", "gaussian_select_kernel"),
             f"{x_args[2]} samples, {x_args[4]} refill blocks"),
            *((name, lambda r2=r_, m2=md_: dsamp.device_sample(
                r2, m2, SAMPLER_KEY, 3, dev), ("salsa20_kernel",),
               f"{rlabel(r_)}, {md_}") for name, r_, md_ in inst_timed),
            *((f"{tag} {limb}", fn_, HWT_FRAGS[tag], f"h = {HWT_H}")
              for (tag, limb), (_, fn_, _) in hwt_timed.items())):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        parts = {}    # a launch's mean: a profile may drop one event
        for evt in prof.key_averages():
            us = max(getattr(evt, a_, 0) or 0 for a_ in (
                "self_device_time_total", "self_cuda_time_total"))
            if frags is None and us > 0:      # every activity, a call's
                kind = ("copies" if "Memcpy" in evt.key else "memsets"
                        if "Memset" in evt.key else "kernels")
                ms0, n0 = parts.get(kind, (0.0, 0))
                parts[kind] = (ms0 + us / 10 / 1e3, n0 + evt.count)
            for frag in frags or ():
                if frag in evt.key and us > 0:
                    parts[frag] = (us / evt.count / 1e3, evt.count)
        t_dev = "not measured (no device time in the profile)"
        if frags is None and parts:
            t_dev = (f"{sum(v[0] for v in parts.values()):.4f} ms a call: "
                     + ", ".join(f"{v[1] / 10:g} {k_} ({v[0]:.4f} ms)"
                                 for k_, v in parts.items()) + " a call")
        elif frags is not None and len(parts) == len(frags):
            ms_ = sum(v[0] for v in parts.values())
            t_dev = f"{ms_:.4f} ms a call (" + ", ".join(
                f"{f_} {v[0]:.4f} ms, {v[1]} launches"
                for f_, v in parts.items()) + ")"
        dev_time[name] = t_dev
        print(f"device time {name} ({work}): {t_dev} (torch.profiler) "
              f"| {card}")

    # torch.profiler on one encrypt_on_device call of each ring, mode and
    # formulation (CPU and CUDA activities, last of the script's profiles:
    # profiling the host side loses device events of later sessions): no
    # host <-> device copy and no synchronisation beyond what a bare
    # synchronize shows; its CUDA kernels (2 for a fixed call in butterfly
    # mode: S3 and K6/K8; at most 7 for an exact one: S4 twice a sampler
    # and K6/K8; 15 and 20 in fused mode, 6 and 11 in auto) and device time
    def copies_and_syncs(fn, reps=3):
        """torch.profiler over `reps` calls of fn() then one synchronize:
        ({event: count} of host <-> device copies and synchronisations,
        {CUDA kernel: launches a call}, their device ms a call).  A
        profile may drop a kernel's first event, so a kernel's launches a
        call are its count over reps, rounded, and its ms a call its mean
        a launch times that; CPU ops (aten::*, and the port's nfl.* spans),
        whose device time is their kernels', are not counted"""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen, kernels, dev_us = {}, {}, 0.0
        for evt in prof.key_averages():
            if any(k in evt.key for k in ("Memcpy HtoD", "Memcpy DtoH",
                                          "Synchronize")):
                seen[evt.key] = evt.count
            us = max(getattr(evt, a_, 0) or 0 for a_ in (
                "self_device_time_total", "self_cuda_time_total"))
            # kernels only: a CPU op (aten::*, or a span nfl.* around a
            # wrapper's launch) carries its kernels' device time too
            if us > 0 and not evt.key.startswith(("aten::", "nfl.",
                                                  "Memcpy", "Memset")):
                a_call = round(evt.count / reps)
                name = evt.key.replace("(anonymous namespace)::", "") \
                    .replace("void ", "").split("(")[0][:48]
                kernels[name] = kernels.get(name, 0) + a_call
                dev_us += us / evt.count * a_call
        return seen, kernels, dev_us / 1e3

    baseline = copies_and_syncs(lambda: None)[0]
    profiled = {}
    for limb, (r_, keys, _, nonces) in lwe_host.items():
        for mode in LWE_MODES:
            for exact in (False, True):
                set_mode(mode)
                try:
                    seen, nk, dms = copies_and_syncs(
                        lambda: lwe.encrypt_on_device(
                            keys, r_, LWE_KEY, nonces[0], g_demo,
                            exact=exact))
                finally:
                    set_mode("fused")
                expect(seen == baseline,
                       f"encrypt_on_device {limb} {mode} exact={exact} "
                       f"copies or synchronises: {seen} (a synchronize "
                       f"alone: {baseline})")
                # CUDA kernels a call: butterfly S3 + K6/K8, or three S4
                # (two kernels each) + K6/K8; fused the same samplers,
                # three forward routes (two mod-matmul launches each, two
                # kernels a launch: the digit split and the products) and
                # two E1 muladds; auto the samplers, three K3/K7 forward
                # launches and the two muladds.  The counters also hold
                # the decryptions: K6/K8; the inverse route and one E1; an
                # inverse K3/K7 and one E1
                calls = ondev[(limb, mode, exact)]
                mm = sum(v_ for k_, v_ in calls.items()
                         if k_.startswith("dft_mxu")) // LWE_REPS
                wrapped = (sum(calls.values()) // LWE_REPS + mm
                           + (3 if exact else 0)
                           - {"butterfly": 1, "fused": 5, "auto": 2}[mode])
                want_k = {"butterfly": 2, "fused": 15, "auto": 6}[mode] \
                    + (5 if exact else 0)
                expect(wrapped == want_k and sum(nk.values()) <= wrapped,
                       f"encrypt_on_device {limb} {mode} exact={exact}: "
                       f"{wrapped} kernels a call by the launch counters, "
                       f"{nk} in the profile")
                profiled[(limb, mode, exact)] = (nk, dms)
    print("encrypt_on_device, one call at batch 1 (torch.profiler): no "
          "Memcpy HtoD/DtoH, no synchronisation beyond a bare synchronize's "
          f"{baseline}; "
          + "; ".join(f"{lm} {md}{' exact' if ex else ''} "
                      f"{sum(nk.values())} CUDA kernels a call "
                      f"{nk}, {dms:.4f} ms device, wrapper launches "
                      + ", ".join(f"{k_} {v_ / LWE_REPS:g}" for k_, v_ in
                                  ondev[(lm, md, ex)].items())
                      for (lm, md, ex), (nk, dms) in profiled.items())
          + f" | {card}")
    for what, (nonce, nbl, fills) in s1_shapes.items():
        if what == "wrap":
            continue
        tk, tp = compare(
            lambda v: sal.keystream(SAMPLER_KEY, nonce, nbl, fills, dev),
            lambda v: sal.keystream_plain(SAMPLER_KEY, nonce, nbl, fills,
                                          dev), None)
        blocks = nbl * fills
        b_ = bound(int_ms(640 * blocks, 336 * blocks), 64 * blocks)
        if what == "uniform64":
            times["salsa20"], bounds["salsa20"] = (tk, tp), b_
        print(f"timing salsa20 {what} ({fills} x {nbl} blocks): kernel "
              f"{tk:.4f} ms ({64 * blocks / tk / 1e6:.1f} GB/s of "
              f"keystream), twin {tp:.4f} ms; bound {b_[0]:.4f} ms "
              f"({b_[1]}), {100 * b_[0] / tk:.1f} % of it | {card}")

    # S1's sampler instances at their main paths against their twins
    # (events, in turns), beside the device's own ms a call (above) and the
    # bound: the Salsa20 instructions of the keystream blocks the sampler
    # reads (as S1's raw keystream above) against the residues written and
    # the moduli read once
    for name, r_, md_ in inst_timed:
        twin = s1_twins[name]
        twin_args = () if name == "salsa20_uniform" else (md_,)
        tk, tp = compare(
            lambda v, r2=r_, m2=md_: dsamp.device_sample(
                r2, m2, SAMPLER_KEY, 3, dev),
            lambda v, r2=r_, t2=twin, a2=twin_args: t2(r2, SAMPLER_KEY, 3,
                                                       *a2, dev), None)
        isz = r_.torch_dtype.itemsize
        stream_b = {"salsa20_uniform": r_.nmoduli * r_.degree * isz,
                    "salsa20_non_uniform": r_.degree * isz,
                    "salsa20_zo": r_.degree}[name]
        blocks = -(-stream_b // 64)
        b_ = bound(int_ms(640 * blocks, 336 * blocks),
                   r_.nmoduli * r_.degree * isz + 8 * r_.nmoduli)
        times[name], bounds[name] = (tk, tp), b_
        print(f"timing {name} {rlabel(r_)} ({md_}, {blocks} keystream "
              f"blocks): kernel {tk:.4f} ms, twin {tp:.4f} ms, device "
              f"{dev_time[name]}; bound {b_[0]:.4f} ms ({b_[1]}), "
              f"{100 * b_[0] / tk:.1f} % of the events' time | {card}")

    # the hwt pair at both LWE rings against its twins (events, in turns),
    # beside the device's own ms a kernel (above) and the host's us a call
    # (HOST_REPS calls back to back on the host clock, before the
    # synchronize; the CUDA activities a call are 8e's); the bound: the
    # Salsa20 instructions of the keystream blocks the call reads (S5: the
    # n keys and h signs, (n + h) / 8 blocks; S6: ceil(h / 8) a fill over
    # its budget of fills, and as many for the signs) against the residues
    # written and the moduli read once.  The u32 ring's numbers go into the
    # kernels line
    for (tag, limb), (r_, fn_, twin_) in hwt_timed.items():
        tk, tp = compare(lambda v, f2=fn_: f2(), lambda v, t2=twin_: t2(),
                         None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            fn_()
        host_us = (time.perf_counter() - t0) / HOST_REPS * 1e6
        torch.cuda.synchronize()
        n_, m_ = r_.degree, r_.nmoduli
        sign_blocks = -(-HWT_H // 8)
        blocks = -(-(n_ + HWT_H) // 8) if tag == "hwt_fixed" else \
            dsamp._hwt_fills(n_, HWT_H) * sign_blocks + sign_blocks
        b_ = bound(int_ms(640 * blocks, 336 * blocks),
                   m_ * n_ * r_.torch_dtype.itemsize + 8 * m_)
        if limb == "u32":
            times[tag], bounds[tag] = (tk, tp), b_
        print(f"timing {tag} {limb} (h = {HWT_H}, {blocks} keystream "
              f"blocks): kernel {tk:.4f} ms (events, {KERNEL_REPS} calls "
              f"back to back), twin {tp:.4f} ms, device "
              f"{dev_time[f'{tag} {limb}']}, host {host_us:.1f} us a call; "
              f"bound {b_[0]:.4f} ms ({b_[1]}), {100 * b_[0] / tk:.1f} % of "
              f"the events' time | {card}")

    def search_ops(stream_, ib, wp, bw, base, samples, m):
        """(ALU, FMA) instructions of the fixed sampler's search and
        encoding on these inputs"""
        r = dsamp._item_words(stream_, ib)[0, :samples * wp] \
            .reshape(samples, wp)
        bwl = bw.long() & 0xFFFF
        nb_ = bwl.shape[0]
        lo = torch.zeros(samples, dtype=torch.int64, device=dev)
        hi = torch.full((samples,), nb_, dtype=torch.int64, device=dev)
        words = halvings = 0
        for _ in range(max(1, (nb_ + 1).bit_length())):
            valid = lo < hi
            mid = (lo + hi) >> 1
            d = torch.sign(r - bwl[mid.clamp(max=nb_ - 1)])
            nz = d != 0
            first = torch.where(nz.any(1), nz.int().argmax(1), wp - 1)
            words += int(torch.where(valid, first + 1, 0).sum())
            halvings += int(valid.sum())
            le = torch.gather(d, 1, first[:, None])[:, 0] >= 0
            lo = torch.where(valid & le, mid + 1, lo)
            hi = torch.where(valid & ~le, mid, hi)
        return (4 * halvings + 3 * words + samples * (4 + 3 * m),
                halvings + samples * (2 + m))

    def smem_ms(accesses):
        """least ms for `accesses` shared-memory lane accesses"""
        return accesses / SMEM_LANES_PER_CLOCK / SM_CLOCKS_PER_S * 1e3

    def exact_work(args):
        """(ALU, FMA, shared-memory accesses, fills) the stream-exact
        sampler needs on these inputs, walking the host's way: the
        keystream of the fills it makes (stored once), a consumption and a
        lookup a selected sample, the search where the tables leave it
        open (halvings and words compared counted from the data), the
        encoding"""
        key, nonce, rlen, inn, nbl_, ib, wp, depth, t, base, _, p, _ = args
        nks = -(-inn * ib // 512)
        words = dsamp._item_words(sal.keystream(key, nonce, nks, nbl_, dev),
                                  ib)[:, :inn].tolist()
        luf = t.luf.tolist()
        slot = t.slot.tolist() if depth == 2 else None
        f2 = t.F2.tolist() if depth == 2 else None
        bw = (t.bw.long() & 0xFFFF).tolist()
        m, steps = p.numel(), max(1, (len(bw) + 1).bit_length())
        alu = fma = acc = done = fills_ = 0
        for w in words:
            if done >= rlen:
                break
            fills_ += 1
            q = 0
            while done < rlen:
                w0, c, full = w[q], 1, False
                alu, acc = alu + 4, acc + 2
                if luf[w0]:
                    if depth == 1:
                        c, full = wp, True
                    else:
                        full = f2[slot[w0]][w[q + 1]]
                        c, acc = (wp if full else 2), acc + 1
                if full:
                    lo, hi = 0, len(bw)
                    for _ in range(steps):
                        if lo >= hi:
                            break
                        mid, cmp = (lo + hi) >> 1, 0
                        alu, fma = alu + 4, fma + 1
                        for j in range(wp):
                            alu, acc = alu + 3, acc + 1
                            d = w[q + j] - bw[mid][j]
                            if d:
                                cmp = 1 if d > 0 else -1
                                break
                        lo, hi = (mid + 1, hi) if cmp >= 0 else (lo, mid)
                alu, fma = alu + 3 * m, fma + m
                done, q = done + 1, q + c
                if q + wp >= inn:
                    break
        blocks = fills_ * nks
        return (alu + 640 * blocks, fma + 336 * blocks, acc + 16 * blocks,
                fills_)

    for limb in ("u32", "u64"):
        r_ = nfl.ring_from_modulus(*LWE_RINGS[limb == "u64"])
        m, n_ = r_.nmoduli, r_.degree
        # S3: the encryption's three samplers
        args = s3_cases[f"{limb} in_bits 8"]
        tk, tp = compare(lambda v: _kernels.GAUSSIAN_FIXED(*args),
                         lambda v: dsamp.gaussian_fixed_plain(*args), None)
        key_, nonce_, offs, amps, _, ib, wp, bw, base, p_, dt = args
        nbl_ = -(-n_ * wp * ib // 512)
        alu = fma = 0
        for off in offs:
            a_, f_ = search_ops(sal.keystream_plain(
                key_, nonce_ + off, nbl_, 1, dev), ib, wp, bw, base, n_, m)
            alu, fma = alu + a_ + 640 * nbl_, fma + f_ + 336 * nbl_
        out_b = len(offs) * m * n_ * dt.itemsize
        b_ = bound(int_ms(alu, fma), out_b + nbytes(bw, p_))
        if limb == "u32":
            times["gaussian_fixed"], bounds["gaussian_fixed"] = (tk, tp), b_
        print(f"timing gaussian_fixed {limb} n={n_} m={m} (3 samplers, "
              f"in_bits {ib}): kernel {tk:.4f} ms "
              f"({3 * n_ / tk / 1e3:.1f} M samples/s), twin {tp:.4f} ms; "
              f"bound {b_[0]:.4f} ms ({b_[1]}), {100 * b_[0] / tk:.1f} % of "
              f"it | {card}")
        # S4: one sampler
        args = s4_cases[f"{limb} in_bits 8"]
        tk, tp = compare(lambda v: _kernels.GAUSSIAN_EXACT(*args),
                         lambda v: dsamp.gaussian_exact_plain(*args), None)
        alu, fma, acc, fills_ = exact_work(args)
        got_fills = int(_kernels.GAUSSIAN_EXACT(*args)[1][0])
        expect(fills_ == got_fills, f"gaussian_exact {limb}: the host walk "
               f"makes {fills_} fills, the kernel says {got_fills}")
        t = args[8]
        moved = m * n_ * args[12].itemsize + 16 + nbytes(
            t.luf, t.luv, t.slot, t.V2, t.F2, t.bw, args[11])
        b_ = bound(max(int_ms(alu, fma), smem_ms(acc)), moved)
        if limb == "u32":
            times["gaussian_exact"], bounds["gaussian_exact"] = (tk, tp), b_
        inn, nbl_ = args[3], args[4]
        jmax = min(inn, n_)
        rounds = max(1, (jmax - 1).bit_length())
        walk = nbl_ * (4 * inn + rounds * 3 * (inn + 1) + 3 * jmax)
        print(f"timing gaussian_exact {limb} n={n_} m={m} (one sampler, "
              f"in_bits {args[5]}, {fills_} fills of {nbl_} computed): "
              f"kernel {tk:.4f} ms ({n_ / tk / 1e3:.1f} M samples/s), twin "
              f"{tp:.4f} ms; bound {b_[0]:.4f} ms ({b_[1]}), "
              f"{100 * b_[0] / tk:.1f} % of it; design traffic: the walk's "
              f"successor table and {rounds} doubling rounds in {nbl_} "
              f"blocks, {walk / 1e6:.2f} M shared-memory accesses "
              f"({smem_ms(walk):.4f} ms at one warp instruction an SM a "
              f"clock; {smem_ms(walk / nbl_) * 132:.4f} ms on one SM), not "
              f"in the bound | {card}")
    for limb, (r_, keys, _, nonces) in lwe_host.items():
        for mode in LWE_MODES:
            set_mode(mode)
            try:
                host = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lwe.encrypt(keys, r_, Salsa20Stream(LWE_KEY, nonces[0]),
                                g_demo)
                    torch.cuda.synchronize()
                    host.append((time.perf_counter() - t0) * 1e3)
                ev = {exact: timed(lambda v: lwe.encrypt_on_device(
                    keys, r_, LWE_KEY, nonces[0], g_demo, exact=exact),
                    None, LWE_REPS) for exact in (False, True)}
            finally:
                set_mode("fused")
            print(f"encrypt at batch 1, {limb} n={r_.degree} m={r_.nmoduli} "
                  f"{mode}: encrypt_on_device fixed {ev[False]:.4f} ms a "
                  f"call, {profiled[(limb, mode, False)][1]:.4f} ms device; "
                  f"exact {ev[True]:.4f} ms, "
                  f"{profiled[(limb, mode, True)][1]:.4f} ms device (events, "
                  f"{LWE_REPS} back to back; torch.profiler); host encrypt "
                  f"{statistics.median(host):.4f} ms (median of 5, host "
                  f"clock to a synchronize) | {card}")
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

    # 8f'. profiling.trace (torch.profiler, CPU and CUDA activity) around
    # encrypt_on_device of each LWE ring in butterfly mode, each call under
    # profiling.annotate: the trace file names the annotation, the port's
    # spans nfl.sampler and nfl.lwe_graph once a call each (its S3 call and
    # its encrypt graph), and the chain kernel of both rings.  CUPTI can
    # miss the device activity of the first calls after a trace starts (one
    # run saw no u32 kernel and no device span of its annotation), so the
    # pair of calls runs TRACE_ROUNDS times and each ring's kernel must show
    # at least once; the rounds seen are printed.  Last of the script's
    # profiles (see 10d).
    trace_dir = os.path.join(rdzv, "trace")
    set_mode("butterfly")
    try:
        with profiling.trace(trace_dir):
            torch.cuda.synchronize()
            for _ in range(TRACE_ROUNDS):
                for limb, (r_, keys, _, nonces) in lwe_host.items():
                    with profiling.annotate("encrypt_on_device"):
                        lwe.encrypt_on_device(keys, r_, LWE_KEY, nonces[0],
                                              g_demo)
            torch.cuda.synchronize()
    finally:
        set_mode("fused")
    files = [f for f in os.listdir(trace_dir)
             if f.endswith(".pt.trace.json")]
    expect(len(files) == 1, f"profiling.trace wrote {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    marks = collections.Counter(
        e.get("cat") for e in events if e.get("name") == "encrypt_on_device")
    chains = collections.Counter(
        e["name"].replace("(anonymous namespace)::", "")
        .replace("void ", "").split("(")[0] for e in events
        if e.get("cat") == "kernel" and "bfly_encrypt" in e.get("name", ""))
    spans = collections.Counter(
        e["name"] for e in events if e.get("cat") == "cpu_op"
        and e.get("name", "").startswith("nfl."))
    rings = len(lwe_host)
    expect(marks["user_annotation"] == TRACE_ROUNDS * rings
           and len(chains) == rings
           and spans == {"nfl.sampler": TRACE_ROUNDS * rings,
                         "nfl.lwe_graph": TRACE_ROUNDS * rings},
           f"the trace lacks the annotation ({dict(marks)}), the port's "
           f"spans ({dict(spans)}) or the {rings} chain kernels "
           f"({dict(chains)})")
    print(f"profiling.trace: one file ({files[0]}, {len(events)} events) "
          f"names the annotation encrypt_on_device {dict(marks)}, the "
          f"port's spans {dict(spans)} and the chain kernels "
          f"{dict(chains)} ({TRACE_ROUNDS} rounds of {rings} calls) "
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
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
