#!/usr/bin/env python3
"""A/B of E1, the elementwise program kernel (csrc/modops_expr.cu), between
two checkouts of the port, on one GPU.

Run from the root of a checkout, on a machine with the card, with the
other checkout's root (for example the commit a change starts from,
unpacked into a gitignored directory with
`git archive BASE nfllib_tpu_torch | tar -x -C _archive/e1_base`):

    python3 tools/chip_ab_e1.py OTHER_ROOT

Each tree's modops_expr.cu is built alone (nvcc, the port's own flags)
into its own directory, OTHER_ROOT/nfllib_tpu_torch/_build/e1_only/ and
this tree's, through that tree's `_kernels.library` with its source list
cut to the one file.  Both trees name their package nfllib_tpu_torch, so
each run is a process of its own, in the order OTHER, this tree, this
tree, OTHER.  A run drives E1 through the API both trees share,
`ops.expr_program.run(op_program(op), leaves, ring)` (the wrapper, its host
path and the kernel), at the four ops that chip_smoke.py times (u32
mulmod_shoup, compute_shoup and mulmod at n = 2^14 x 17 moduli, u64
mulmod at 2^14 x 8) at batch 64 and at batch 1, on canonical residues
made from a seed on the card, each result held to the twin
(`expr_program.run_plain`) exactly.  Times: CUDA events over 10 calls back
to back, the median of 25 samples; the kernel's device ms a call from
torch.profiler over 10 calls; the host's us a call, the host clock over
200 calls issued back to back (the queue never fills at these sizes),
the median and the least of 11 such samples.  A run also prints the
static SASS instruction mix (cuobjdump) of each E1 kernel instance of
its build.  It prints one JSON
line a run, the card's name and power limit, and a line a case with both
trees' numbers and the bytes bound (each leaf read once, the output
written once, at 3.35 TB/s).

Then the host's us a call at batch 1 in HOST_PAIRS pairs of processes,
one of each tree, alternating which runs first: a process takes the
median of 11 samples of 200 calls an op.  A line an op gives each
side's median and quartiles over the pairs, the pairs this tree wins and
whether that is a gain: this tree wins nine tenths of the pairs and the
medians differ by more than the other tree's interquartile range.
"""
from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

SAMPLES = 25
REPS = 10
HOST_CALLS = 200
HOST_SAMPLES = 11
HBM_BYTES_PER_S = 3.35e12
RINGS = {"u32": (16384, 510), "u64": (16384, 496)}
OPS = (("u32", "mulmod_shoup"), ("u32", "compute_shoup"), ("u32", "mulmod"),
       ("u64", "mulmod"))
BATCHES = (64, 1)
HOST_PAIRS = 12


class _Lib:
    """A loaded library whose missing symbols (the kernels not built here)
    are stand-ins that take argtypes and raise when called."""

    class _Missing:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            raise RuntimeError(f"{self.name} is not in the E1-only build")

    def __init__(self, path):
        self._lib = _Lib._cdll(path)

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            missing = _Lib._Missing(name)
            setattr(self, name, missing)
            return missing


def sass_mix(lib_path, nvcc):
    """{E1 kernel instance: (instructions, top opcodes)} of the build"""
    out = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                          "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    mixes, cur = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            sym = m.group(1)
            t = re.search(r"modops_expr_kernelI((?:L[ib]n?\d+E)+)E", sym)
            cur = None
            if t:
                cur = "<" + ",".join(
                    a.replace("n", "-") for a in
                    re.findall(r"L[ib](n?\d+)E", t.group(1))) + ">"
                mixes[cur] = collections.Counter()
        elif cur is not None:
            ins = re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)", ln)
            if ins:
                mixes[cur][ins.group(1)] += 1
    return {k: (sum(v.values()), dict(v.most_common(8)))
            for k, v in sorted(mixes.items())}


def _load(root: str):
    """The tree at root with its E1 built alone and loaded: (torch, the
    package, _kernels, expr_program, modops, the Library)"""
    sys.path.insert(0, root)
    import torch
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import _kernels
    from nfllib_tpu_torch.ops import expr_program as ep
    from nfllib_tpu_torch.ops import modops

    _kernels._SOURCES = (_kernels._CSRC / "modops_expr.cu",)
    _kernels._HEADERS = tuple(h for h in (_kernels._CSRC / "launch.cuh",)
                              if h.exists())
    _kernels._BUILD_DIR = _kernels._PKG / "_build" / "e1_only"
    _Lib._cdll = ctypes.CDLL
    ctypes.CDLL = _Lib
    try:
        _kernels.library.cache_clear()
        lib = _kernels.library()
    finally:
        ctypes.CDLL = _Lib._cdll
    return torch, nfl, _kernels, ep, modops, lib


def _leaves(torch, nfl, ep, modops, tier, op, batch, gen, dev):
    """(ring, leaves): canonical residues of the op's operands at batch"""
    degree, bits = RINGS[tier]
    ring = nfl.ring_from_modulus(tier, degree, bits)
    tabs = ring.context().to(dev)
    p = tabs.p_col                                         # [m, 1] int64
    shape = (batch, ring.nmoduli, degree)
    leaves = [(torch.randint(0, 1 << 62, shape, generator=gen, device=dev)
               % p).to(ring.torch_dtype) for _ in range(ep.ARITY[op])]
    if op == "mulmod_shoup":
        leaves[2] = modops.compute_shoup(leaves[1], p, tabs.shoup_f)
    return ring, leaves


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
    """{op: median host us a call at batch 1} of the tree at root"""
    torch, nfl, _kernels, ep, modops, _ = _load(root)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2025)
    res = {}
    for tier, op in OPS:
        ring, leaves = _leaves(torch, nfl, ep, modops, tier, op, 1, gen, dev)
        prog = ep.op_program(op)

        def fn(p_=prog, v=leaves, r_=ring):
            return ep.run(p_, v, r_)
        for _ in range(20):
            fn()
        res[f"{tier} {op}"] = statistics.median(
            _host_us(torch, fn) for _ in range(HOST_SAMPLES))
    return {"root": root, "host_us": res}


def child(root: str) -> dict:
    torch, nfl, _kernels, ep, modops, lib = _load(root)
    dev = torch.device("cuda", 0)
    res = {"root": root, "build_s": lib.build_seconds,
           "ptxas": [ln.strip() for ln in lib.log.splitlines()
                     if "registers" in ln or "spill" in ln],
           "sass": sass_mix(lib.path, _kernels._nvcc())}
    e1 = _kernels.MODOPS_EXPR

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(SAMPLES):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(REPS):
                fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e) / REPS)
        return statistics.median(out)

    def host_us(fn):
        out = [_host_us(torch, fn) for _ in range(HOST_SAMPLES)]
        return statistics.median(out), min(out)

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(4):            # CUPTI may drop the first events
                torch.full((1,), 7, device=dev)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            us = max(getattr(evt, a, 0) or 0 for a in (
                "self_device_time_total", "self_cuda_time_total"))
            if "modops_expr_kernel" in evt.key and us > 0:
                return us / evt.count / 1e3
        return None

    gen = torch.Generator(device=dev).manual_seed(2024)
    for tier, op in OPS:
        for batch in BATCHES:
            ring, leaves = _leaves(torch, nfl, ep, modops, tier, op, batch,
                                   gen, dev)
            tabs = ring.context().to(dev)
            shape = tuple(leaves[0].shape)
            prog = ep.op_program(op)
            got = ep.run(prog, leaves, ring)
            want = ep.run_plain(prog, leaves, tabs)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{root}: E1 {op} {tier} {shape} != "
                                     f"the twin")
            fn = (lambda p_=prog, v=leaves, r_=ring: ep.run(p_, v, r_))
            moved = sum(t.numel() * t.element_size() for t in leaves) \
                + got.numel() * got.element_size()
            res[f"{tier} {op} {shape}"] = {
                "ms": timed(fn), "device_ms": device_ms(fn),
                "host_us": host_us(fn),
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "instance": getattr(e1, "last_instance", None)}
    return res


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return f"{statistics.median(xs):.1f} ({q[0]:.1f}-{q[2]:.1f})"


def host_pairs(here, other, card) -> int:
    """HOST_PAIRS pairs of host_child processes, alternating which tree
    runs first; a line an op"""
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
        print(f"host us a call at batch 1, {key}, {len(oa)} pairs: other "
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
        print("chip_ab_e1: no CUDA device", file=sys.stderr)
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
        for inst, (n, top) in r["sass"].items():
            print(f"sass {tag} modops_expr_kernel{inst}: {n} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in top.items()))
    for key in runs[0]:
        if not isinstance(runs[0][key], dict) or "ms" not in runs[0][key]:
            continue
        a = [r[key] for r in (runs[0], runs[3])]
        b = [r[key] for r in (runs[1], runs[2])]

        def dev_ms(x):
            return "not measured" if x is None else f"{x:.4f}"

        def host(runs_):
            return " / ".join(f"{r['host_us'][0]:.1f} (least "
                              f"{r['host_us'][1]:.1f})" for r in runs_)
        print(f"{key}: bound {a[0]['bound_ms']:.4f} ms; other "
              f"{a[0]['ms']:.4f} / {a[1]['ms']:.4f} ms events, device "
              f"{dev_ms(a[0]['device_ms'])} / {dev_ms(a[1]['device_ms'])}, "
              f"host {host(a)} us a call; this tree {b[0]['ms']:.4f} / "
              f"{b[1]['ms']:.4f} ms, device {dev_ms(b[0]['device_ms'])} / "
              f"{dev_ms(b[1]['device_ms'])}, host {host(b)} us "
              f"({b[0]['instance']}) | {card}")
    return host_pairs(here, other, card)


if __name__ == "__main__":
    sys.exit(main())
