#!/usr/bin/env python3
"""A/B of the device samplers that S1 (csrc/salsa20.cu) serves, and of K11
(the pair bridge), between two checkouts of the port, on one GPU.

Run from the root of a checkout, on a machine with the card, with the
other checkout's root (for example the commit a change starts from,
unpacked into a gitignored directory with
`git archive BASE nfllib_tpu_torch | tar -x -C _archive/s1_base`):

    python3 tools/chip_ab_s1.py OTHER_ROOT

Each tree's kernels of these paths (those of salsa20.cu, modops_expr.cu,
pair_bridge.cu and hwt.cu that it has) are built alone (nvcc, the port's own
flags) into its own directory, ROOT/nfllib_tpu_torch/_build/s1_only/,
through that tree's `_kernels.library` with its source list cut to them.
Both trees name their package nfllib_tpu_torch, so each run is a process
of its own, in the order OTHER, this tree, this tree, OTHER.  A run drives
the API both trees share, on the cases below, each result held to its
reference first (uniform, non-uniform, ZO and the exact hwt to the host
sampler at the same key and nonce, the fixed hwt to its own run on the
CPU, K11 to its twin):
  * `device_sampling.device_sample` with uniform at u64 2^20 x 2 (16.8 MB
    of keystream), and on u32 (16384, 510) and u64 (16384, 496) with
    uniform, non_uniform (ub 5, amp 1 and 3), ZO_dist (rho 127) and
    hwt_dist (h 64, device_hwt), and `device_hwt_exact` (h 64);
  * S1's raw keystream at 262,144 blocks (`salsa20.keystream`);
  * K11, `ops.pair_bridge.mulmod_shoup_u64` at u64 [2, 2, 1024, 1024].
Times: CUDA events over 10 calls back to back, the median of 25 samples
(K11 also over 100 calls back to back); the CUDA kernels a call and their
device ms a call from torch.profiler over 10 calls; the host's us a call,
the host clock over 200 calls issued back to back, the median of 11 such
samples.  It prints one JSON line a run, the card's name and power limit,
and a line a case with both trees' numbers.

Then the host's us a call of the uniform, non-uniform (ub 5, amp 3) and ZO
samplers and of the hwt pair (h 64) on both LWE rings in HOST_PAIRS pairs
of processes, one of each
tree, alternating which runs first: a line a case gives each side's
median and quartiles over the pairs, the pairs this tree wins and whether
that is a gain (this tree wins nine tenths of the pairs and the medians
differ by more than the other tree's interquartile range).
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from chip_ab_e1 import _Lib, _quartiles  # noqa: E402

SAMPLES = 25
REPS = 10
HOST_CALLS = 200
HOST_SAMPLES = 11
HOST_PAIRS = 8
KEY = bytes(range(64, 96))
UNIFORM64 = ("u64", 1 << 20, 124)
RINGS = {"u32": ("u32", 16384, 510), "u64": ("u64", 16384, 496)}
HWT_H = 64
RAW_BLOCKS = 262144
K11_SHAPE = (2, 2, 1024, 1024)
SOURCES = ("salsa20.cu", "modops_expr.cu", "pair_bridge.cu", "hwt.cu")


def _load(root: str):
    """The tree at root with the kernels of these paths built alone and
    loaded: (torch, the package, _kernels, the Library)"""
    sys.path.insert(0, root)
    import torch
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import _kernels

    _kernels._SOURCES = tuple(_kernels._CSRC / s for s in SOURCES
                              if (_kernels._CSRC / s).exists())
    _kernels._HEADERS = tuple(_kernels._CSRC / h for h in (
        "salsa20_block.cuh", "launch.cuh") if (_kernels._CSRC / h).exists())
    _kernels._BUILD_DIR = _kernels._PKG / "_build" / "s1_only"
    _Lib._cdll = ctypes.CDLL
    ctypes.CDLL = _Lib
    try:
        _kernels.library.cache_clear()
        lib = _kernels.library()
    finally:
        ctypes.CDLL = _Lib._cdll
    return torch, nfl, _kernels, lib


def _cases(torch, nfl, dev, host_only=False):
    """{case: (call, check)}: check() holds one call's result to its
    reference (raises on a difference)"""
    from nfllib_tpu_torch.ops import modops, pair_bridge
    from nfllib_tpu_torch.prng import Salsa20Stream
    from nfllib_tpu_torch.prng import device_sampling as dsamp
    from nfllib_tpu_torch.prng import salsa20 as sal

    def host_equal(ring, mode, nonce, out):
        want = nfl.Poly.sample(ring, mode, Salsa20Stream(KEY, nonce), dev)
        if not torch.equal(out, want.data):
            raise AssertionError(f"{mode} on {ring} != the host sampler")

    def sampler(ring, mode):
        def call():
            return dsamp.device_sample(ring, mode, KEY, 3, dev)
        return call, lambda: host_equal(ring, mode, 3, call())

    out = {}
    rings = {k: nfl.ring_from_modulus(*v) for k, v in RINGS.items()}
    modes = (("uniform", nfl.uniform()),
             ("non_uniform 5 3", nfl.non_uniform(5, 3)),
             ("ZO 127", nfl.ZO_dist(127)))
    for limb, ring in rings.items():
        for tag, mode in modes:
            out[f"{tag} {limb}"] = sampler(ring, mode)
        md = nfl.hwt_dist(HWT_H)

        def fixed(r_=ring, md=md):
            return dsamp.device_hwt(r_, KEY, 5, md, dev)

        def fixed_check(r_=ring, md=md, f=fixed):
            if not torch.equal(f().cpu(), dsamp.device_hwt(r_, KEY, 5, md,
                                                           device="cpu")):
                raise AssertionError(f"device_hwt on {r_} != its CPU run")

        def exact(r_=ring, md=md):
            return dsamp.device_hwt_exact(r_, KEY, 5, md, device=dev)
        out[f"hwt {HWT_H} {limb}"] = (fixed, fixed_check)
        out[f"hwt_exact {HWT_H} {limb}"] = (
            exact, lambda r_=ring, md=md, f=exact: host_equal(r_, md, 5, f()))
    if host_only:
        return out
    out["uniform u64 2^20 x 2"] = sampler(
        nfl.ring_from_modulus(*UNIFORM64), nfl.uniform())
    for limb, ring in rings.items():
        out[f"non_uniform 5 1 {limb}"] = sampler(ring, nfl.non_uniform(5, 1))

    def raw():
        return sal.keystream(KEY, 3, RAW_BLOCKS, 1, dev)

    def raw_check():
        if not torch.equal(raw(), sal.keystream_plain(KEY, 3, RAW_BLOCKS, 1,
                                                      dev)):
            raise AssertionError("S1's keystream != its twin")
    out[f"S1 raw {RAW_BLOCKS} blocks"] = (raw, raw_check)

    ringL = nfl.ring_from_modulus(*UNIFORM64)
    tabs = ringL.context().to(dev)
    gen = torch.Generator(device=dev).manual_seed(2026)
    p = tabs.p_col.reshape(-1, 1, 1)
    x = torch.randint(0, 1 << 62, K11_SHAPE, generator=gen, device=dev) % p
    tw = torch.randint(0, 1 << 62, K11_SHAPE[1:], generator=gen,
                       device=dev) % p
    tws = modops.compute_shoup(tw, p, tabs.shoup_f.reshape(-1, 1, 1))

    def k11():
        return pair_bridge.mulmod_shoup_u64(x, tw, tws, ringL)

    def k11_check():
        if not torch.equal(k11(), pair_bridge.mulmod_shoup_u64_plain(
                x, tw, tws, ringL)):
            raise AssertionError("K11 != its twin")
    out["K11 u64 [2, 2, 1024, 1024]"] = (k11, k11_check)
    return out


def _host_us(torch, fn):
    """the host's us a call over HOST_CALLS calls back to back"""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return us


def host_child(root: str) -> dict:
    """{case: median host us a call} of the fused samplers' and the hwt
    pair's cases"""
    torch, nfl, _, _ = _load(root)
    dev = torch.device("cuda", 0)
    res = {}
    for key, (fn, _) in _cases(torch, nfl, dev, host_only=True).items():
        for _ in range(20):
            fn()
        res[key] = statistics.median(_host_us(torch, fn)
                                     for _ in range(HOST_SAMPLES))
    return {"root": root, "host_us": res}


def child(root: str) -> dict:
    torch, nfl, _kernels, lib = _load(root)
    dev = torch.device("cuda", 0)
    res = {"root": root, "build_s": lib.build_seconds,
           "ptxas": [ln.strip() for ln in lib.log.splitlines()
                     if "salsa20" in ln or "spill" in ln]}

    def timed(fn, reps=REPS):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(SAMPLES):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e) / reps)
        return statistics.median(out)

    def device(fn):
        """(CUDA kernels a call, their device ms a call, {kernel: launches
        a call})"""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(4):            # CUPTI may drop the first events
                torch.full((1,), 7, device=dev)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        us, kinds = 0.0, {}
        for evt in prof.key_averages():
            t = max(getattr(evt, a, 0) or 0 for a in (
                "self_device_time_total", "self_cuda_time_total"))
            if t > 0 and "FillFunctor" not in evt.key:
                us += t
                name = evt.key.replace("(anonymous namespace)::", "") \
                    .replace("void ", "").split("(")[0][:40]
                kinds[name] = kinds.get(name, 0) + evt.count / REPS
        return sum(kinds.values()), us / REPS / 1e3, kinds

    for key, (fn, check) in _cases(torch, nfl, dev).items():
        check()
        torch.cuda.synchronize()
        kernels, dev_ms, kinds = device(fn)
        res[key] = {"ms": timed(fn), "device_ms": dev_ms,
                    "kernels": kernels, "kinds": kinds,
                    "host_us": statistics.median(
                        _host_us(torch, fn) for _ in range(HOST_SAMPLES))}
        if key.startswith("K11"):
            res[key]["ms_100"] = timed(fn, 100)
    return res


def host_pairs(here, other, card) -> int:
    """HOST_PAIRS pairs of host_child processes, alternating which tree
    runs first; a line a case"""
    a, b = [], []
    for i in range(HOST_PAIRS):
        order = (other, here) if i % 2 == 0 else (here, other)
        got = {}
        for root in order:
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--host-child", root], capture_output=True,
                                 text=True, timeout=600)
            if out.returncode:
                print(out.stdout, out.stderr, file=sys.stderr)
                return 1
            got[root] = json.loads(out.stdout.strip().splitlines()[-1])
        a.append(got[other])
        b.append(got[here])
    for key in a[0]["host_us"]:
        oa = [r["host_us"][key] for r in a]
        ob = [r["host_us"][key] for r in b]
        wins = sum(y < x for x, y in zip(oa, ob))
        q = statistics.quantiles(oa, n=4)
        gain = wins >= 0.9 * len(oa) and abs(
            statistics.median(oa) - statistics.median(ob)) > q[2] - q[0]
        print(f"host us a call, {key}, {len(oa)} pairs: other "
              f"{_quartiles(oa)}, this tree {_quartiles(ob)}, this tree "
              f"wins {wins} of {len(oa)}: "
              f"{'a gain' if gain else 'no gain shown'} | {card}")
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(os.path.abspath(sys.argv[2]))))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--host-child":
        print(json.dumps(host_child(os.path.abspath(sys.argv[2]))))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_ab_s1: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    runs = []
    for root in (other, here, here, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], capture_output=True,
                             text=True, timeout=900)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        line = out.stdout.strip().splitlines()[-1]
        print(line)
        runs.append(json.loads(line))
    for tag, r in (("other", runs[0]), ("this tree", runs[1])):
        print(f"build {tag}: {r['build_s']:.1f} s; ptxas: "
              + " | ".join(r["ptxas"]))
    for key in runs[0]:
        if not isinstance(runs[0][key], dict):
            continue
        a = [r[key] for r in (runs[0], runs[3])]
        b = [r[key] for r in (runs[1], runs[2])]

        def side(rs):
            extra = "".join(f", {r['ms_100']:.4f}" for r in rs
                            if "ms_100" in r)
            return (" / ".join(f"{r['ms']:.4f}" for r in rs) + " ms events"
                    + (f" (100 back to back{extra})" if extra else "")
                    + ", device " + " / ".join(f"{r['device_ms']:.4f}"
                                               for r in rs)
                    + f" ms, {rs[0]['kernels']:g} CUDA kernels a call, host "
                    + " / ".join(f"{r['host_us']:.1f}" for r in rs) + " us")
        print(f"{key}: other {side(a)}; this tree {side(b)} "
              f"({b[0]['kinds']}) | {card}")
    return host_pairs(here, other, card)


if __name__ == "__main__":
    sys.exit(main())
