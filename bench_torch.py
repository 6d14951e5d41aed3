#!/usr/bin/env python3
"""Benchmark of the PyTorch / CUDA port (nfllib_tpu_torch): RNS-NTT
throughput on one card, the counterpart of bench.py.

    python3 bench_torch.py [--inverse] [--limb L] [--degree N]
        [--nmoduli M] [--batch B] [--mode auto|fused|butterfly]
        [--chain K] [--samples S] [--device cuda|cpu]

The default run is bench.py's workload: the forward negacyclic NTT
ntt_pow_phi at n = 2^14, 17 u32 moduli, batch 64, on the input bench.py
makes (np.random.default_rng(42), one draw per channel below its modulus),
in NFL_TORCH_NTT=auto (one K3 launch a transform; --mode fused takes
the route, two K9 launches).  --inverse times
invntt_pow_invphi; --limb/--degree/--nmoduli/--batch pick another ring
Ring(limb, degree, nmoduli) and batch, and the metric's name then carries
the shape (rns_ntt_n2pow20_u64_m2_b2_per_sec_per_chip).

A sample is a pair of CUDA events around `chain` applications back to
back, the output of one the input of the next; 3 warm-up samples, then the
median of `samples`.  Beside it: the device time of one more sample in a
CUDA-only torch.profiler session (the kernels' own time; a session in
which CUPTI lost activity runs again) and the idle share, 1 - device /
events.  Stderr also gives the card (nvidia-smi), the first call (the
ring's context tables, the first application with the kernels' build or
load in it, whether the build directory was warm) and the kernel launches
an application.  The last line of stdout is one JSON object with
bench.py's keys: {"metric", "value" (channel-NTTs per second), "unit",
"vs_baseline" (value / 1e6)}.

It runs on the card unless given --device cpu; without a card it exits
nonzero.  On the CPU the same calls run the plain twins, timed on the
host clock, and the metric ends in "_per_sec_on_cpu": no CPU number
stands under a device metric's name.  It imports nothing of JAX.

tools/bench_ops_torch.py and tools/prng_bench_torch.py import the timing
helpers below (card_line, ntt_mode, median_ms, device_ms, time_host).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

DEFAULT_SHAPE = ("u32", 1 << 14, 17, 64)   # limb, degree, nmoduli, batch
WARMUP = 3            # samples before the timed ones
SAMPLES = 25          # timed samples; their median is the result
CHAIN = 16            # applications back to back in a sample
MODES = ("auto", "fused", "butterfly", "plain")

# CUPTI can drop the device activity of a profiling session's first
# launches: a session first runs WARM_UP fill kernels, which its counts
# leave out by name, and one that shows fewer kernels than the wrappers
# launched runs again, at most PROFILE_TRIES sessions
WARM_UP = 4
WARM_UP_KERNEL = "FillFunctor"
PROFILE_TRIES = 3


def log(prog: str, msg: str) -> None:
    print(f"[{prog}] {msg}", file=sys.stderr)


def open_device(prog: str, name: str):
    """torch.device for --device, or None (and one line on stderr) when it
    is cuda and the process sees no card"""
    import torch
    if name == "cuda":
        if not torch.cuda.is_available():
            print(f"{prog}: no CUDA device found (torch.cuda.is_available() "
                  f"is false); pass --device cpu to run the plain twins on "
                  f"the CPU", file=sys.stderr)
            return None
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(name)


def check_mode(mode: str, device) -> str | None:
    """Why --mode cannot run on `device`, or None"""
    if mode == "plain" and device.type == "cuda":
        return ("--mode plain runs the plain torch twins, not the port's "
                "kernels; it is for --device cpu only")
    return None


@contextlib.contextmanager
def ntt_mode(mode: str):
    """NFL_TORCH_NTT = mode for the block (ops/ntt.py reads it at call
    time), the caller's value restored after"""
    old = os.environ.get("NFL_TORCH_NTT")
    os.environ["NFL_TORCH_NTT"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["NFL_TORCH_NTT"]
        else:
            os.environ["NFL_TORCH_NTT"] = old


def card_line(device) -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` names it, or a line saying the run is on the
    CPU"""
    if device.type != "cuda":
        return "device: cpu (plain twins, host clock; no device metric)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def applied(fn, x, chain: int):
    """fn applied `chain` times, each on the previous output"""
    for _ in range(chain):
        x = fn(x)
    return x


def event_ms(run, device) -> float:
    """ms of run() between two CUDA events on the current stream (on the
    CPU the host clock)"""
    import torch
    if device.type != "cuda":
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(run, device, samples: int = SAMPLES,
              warmup: int = WARMUP) -> float:
    """The median of `samples` event_ms(run) after `warmup` more"""
    for _ in range(warmup):
        event_ms(run, device)
    return statistics.median(event_ms(run, device) for _ in range(samples))


def launch_counts() -> dict:
    """{kernel wrapper: launches so far} of the port's kernels"""
    from nfllib_tpu_torch import _kernels
    return {k.name: k.launches for k in _kernels.KERNELS}


def launches_since(before: dict) -> dict:
    """{wrapper: launches since `before`} of the wrappers that launched"""
    return {k: n - before[k] for k, n in launch_counts().items()
            if n > before[k]}


def device_ms(run, device):
    """(device ms, CUDA kernels, sessions) of run() in a CUDA-only
    torch.profiler session after the warm-up kernels, which it leaves out;
    None on the CPU.  A session that shows fewer CUDA kernels than the
    port's wrappers launched in it (each launch is at least one kernel)
    runs again, at most PROFILE_TRIES in all."""
    import torch
    if device.type != "cuda":
        return None
    for tries in range(1, PROFILE_TRIES + 1):
        before = launch_counts()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(WARM_UP):
                torch.full((1,), 7, device=device)
            run()
            torch.cuda.synchronize(device)
        want = sum(launches_since(before).values())
        kern = [(evt.count, max(getattr(evt, a, 0) or 0 for a in (
            "self_device_time_total", "self_cuda_time_total")))
            for evt in prof.key_averages() if WARM_UP_KERNEL not in evt.key]
        kern = [(n, us) for n, us in kern if us > 0]
        count = sum(n for n, _ in kern)
        if count >= want:
            break
    return sum(us for _, us in kern) / 1e3, count, tries


def time_host(fn, reps: int = 20) -> float:
    """µs a call of a host function, best of `reps` (profiling.WallTimer,
    as tools/bench_ops.py times its host rows)"""
    from nfllib_tpu_torch import profiling
    best = float("inf")
    for _ in range(reps):
        t = profiling.WallTimer()
        with t.measure():
            fn()
        best = min(best, t.mean_us)
    return best


def metric_name(limb: str, degree: int, nmoduli: int, batch: int,
                inverse: bool, on_card: bool = True) -> str:
    """bench.py's metric at its shape; other shapes carry theirs"""
    name = f"rns_{'intt' if inverse else 'ntt'}_n2pow{degree.bit_length() - 1}"
    if (limb, degree, nmoduli, batch) != DEFAULT_SHAPE:
        name += f"_{limb}_m{nmoduli}_b{batch}"
    return name + ("_per_sec_per_chip" if on_card else "_per_sec_on_cpu")


def make_input(ring, batch: int) -> np.ndarray:
    """[batch, m, n] residues of the ring's limb dtype, made as bench.py
    makes its input: default_rng(42), one draw per channel"""
    rng = np.random.default_rng(42)
    x = np.empty((batch, ring.nmoduli, ring.degree), dtype=ring.dtype)
    for cm in range(ring.nmoduli):
        x[:, cm, :] = rng.integers(0, int(ring.moduli[cm]),
                                   size=(batch, ring.degree),
                                   dtype=ring.dtype)
    return x


def workload(args, device):
    """(ring, the transform, its input on `device`) of a run"""
    sys.path.insert(0, ROOT)
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import interop
    from nfllib_tpu_torch.ops import ntt as ntt_mod
    ring = nfl.Ring(args.limb, args.degree, args.nmoduli)
    op = ntt_mod.invntt_pow_invphi if args.inverse else ntt_mod.ntt_pow_phi
    x = interop.poly_from_numpy(make_input(ring, args.batch), ring,
                                device).data
    return ring, op, x


def parse_args(argv):
    limb, degree, nmoduli, batch = DEFAULT_SHAPE
    ap = argparse.ArgumentParser(
        prog="bench_torch.py",
        description="RNS-NTT throughput of the PyTorch / CUDA port on one "
                    "card (CUDA events)")
    ap.add_argument("--inverse", action="store_true",
                    help="time invntt_pow_invphi")
    ap.add_argument("--limb", choices=("u16", "u32", "u64"), default=limb)
    ap.add_argument("--degree", type=int, default=degree)
    ap.add_argument("--nmoduli", type=int, default=nmoduli)
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--mode", choices=MODES, default="auto",
                    help="NFL_TORCH_NTT for the run (plain: --device cpu "
                         "only)")
    ap.add_argument("--chain", type=int, default=CHAIN,
                    help="applications back to back in a sample")
    ap.add_argument("--samples", type=int, default=SAMPLES,
                    help="timed samples (after 3 warm-up ones)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    prog = "bench_torch"
    device = open_device(prog, args.device)
    if device is None:
        return 1
    why = check_mode(args.mode, device)
    if why:
        print(f"{prog}: {why}", file=sys.stderr)
        return 2
    import torch
    from nfllib_tpu_torch import _kernels

    on_card = device.type == "cuda"
    log(prog, card_line(device))
    ring, op, x = workload(args, device)
    ntts = args.batch * ring.nmoduli

    with ntt_mode(args.mode):
        t0 = time.perf_counter()
        ctx = ring.context()
        ctx.to(device)
        tables_s = time.perf_counter() - t0
        loaded = _kernels.library.cache_info().currsize > 0
        applications = 0

        def fn(v):
            nonlocal applications
            applications += 1
            return op(v, ctx)

        t0 = time.perf_counter()
        fn(x)
        if on_card:
            torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
        if not on_card:
            build = "none (cpu: the plain twins)"
        elif loaded:
            build = "already loaded in this process"
        else:
            lib = _kernels.library()
            build = (f"built in {lib.build_seconds:.1f} s (cold build "
                     f"directory)" if lib.build_seconds else
                     "loaded from the warm build directory")
        log(prog, f"first call: context tables {tables_s:.3f} s, first "
                  f"application {first_s:.3f} s; kernels {build}")

        def sample():
            applied(fn, x, args.chain)

        apps0, before = applications, launch_counts()
        ms = median_ms(sample, device, args.samples) / args.chain
        per_app = {k: n / (applications - apps0)
                   for k, n in launches_since(before).items()}
        dev = device_ms(sample, device)

    clock = "CUDA events" if on_card else "host clock"
    log(prog, f"{'invntt_pow_invphi' if args.inverse else 'ntt_pow_phi'} "
              f"{args.limb} n={ring.degree} m={ring.nmoduli} "
              f"batch={args.batch} mode={args.mode}: {ntts} channel-NTTs "
              f"an application")
    log(prog, f"{clock}: {ms:.4f} ms an application (median of "
              f"{args.samples} samples of {args.chain} after {WARMUP})")
    if dev is None:
        log(prog, "device time: not measured (no card)")
    else:
        dms, kernels, tries = dev
        dms /= args.chain
        log(prog, f"device time: {dms:.4f} ms an application, "
                  f"{kernels / args.chain:g} CUDA kernels (torch.profiler, "
                  f"{tries} session{'s' if tries > 1 else ''}); idle share "
                  f"{1 - dms / ms:.3f}")
    log(prog, f"launches an application: {json.dumps(per_app)}; "
              f"applications: {applications}")
    rate = ntts / (ms / 1e3)
    print(json.dumps({
        "metric": metric_name(args.limb, ring.degree, ring.nmoduli,
                              args.batch, args.inverse, on_card),
        "value": round(rate, 1),
        "unit": "ntt/s",
        "vs_baseline": round(rate / 1e6, 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
