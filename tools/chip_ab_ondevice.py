#!/usr/bin/env python3
"""A/B of the device Gaussian and lwe.encrypt_on_device at batch 1 between
two checkouts of the port, on one GPU.

Run from the root of a checkout, on a machine with the card, with the
other checkout's root (for example the parent commit, unpacked with
`git archive` into a gitignored directory):

    python3 tools/chip_ab_ondevice.py OTHER_ROOT

Both trees name their package nfllib_tpu_torch, so each run is a process
of its own, in the order OTHER, this tree, this tree, OTHER.  A run builds
the tree's kernels, makes LWE keys on u32 (16384, 510) and u64 (16384,
496) and, under NFL_TORCH_NTT=butterfly, times through the API both trees
share: device_sampling.device_gaussian and device_gaussian_exact (one
sampler, sigma 4, the demo's tables cached) and encrypt_on_device, fixed
and exact.  Times: CUDA events over 10 calls back to back, the median of
15 samples; device ms a call and CUDA kernels a call from torch.profiler
over 3 calls (a kernel's launches a call its count over 3, rounded: a
profile may drop a first event).  It prints one JSON line a run and the
card's name and power limit.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

RINGS = (("u32", 16384, 510), ("u64", 16384, 496))
KEY = bytes(range(32, 64))
SAMPLES = 15
REPS = 10


def child(root: str) -> dict:
    sys.path.insert(0, root)
    os.environ["NFL_TORCH_NTT"] = "butterfly"
    import torch
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import _kernels
    from nfllib_tpu_torch.apps import lwe
    from nfllib_tpu_torch.prng import Salsa20Stream
    from nfllib_tpu_torch.prng import device_sampling as ds
    from nfllib_tpu_torch.prng.sampling import gaussian

    dev = torch.device("cuda", 0)
    _kernels.library()

    def timed(fn):
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

    def profiled(fn, reps=3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels, dev_us = 0, 0.0
        for evt in prof.key_averages():
            us = max(getattr(evt, a, 0) or 0 for a in (
                "self_device_time_total", "self_cuda_time_total"))
            if us > 0 and not evt.key.startswith(("aten::", "Memcpy",
                                                  "Memset")):
                a_call = round(evt.count / reps)
                kernels += a_call
                dev_us += us / evt.count * a_call
        return kernels, dev_us / 1e3

    g = lwe.make_gaussian_prng()
    res = {"root": root}
    for limb, degree, bits in RINGS:
        ring = nfl.ring_from_modulus(limb, degree, bits)
        keys = lwe.keygen(ring, Salsa20Stream(KEY), g, dev)
        tabs = ds.gaussian_tables(g, dev)
        xtabs = ds.gaussian_tables(g, dev, exact=True)
        cases = {
            "gaussian": lambda: ds.device_gaussian(
                ring, KEY, 7, gaussian(g), dev, tabs),
            "gaussian_exact": lambda: ds.device_gaussian_exact(
                ring, KEY, 7, gaussian(g), True, dev, xtabs),
            "encrypt_fixed": lambda: lwe.encrypt_on_device(
                keys, ring, KEY, 100, g),
            "encrypt_exact": lambda: lwe.encrypt_on_device(
                keys, ring, KEY, 100, g, exact=True)}
        for name, fn in cases.items():
            ms = timed(fn)
            nk, dms = profiled(fn)
            res[f"{limb} {name}"] = {"ms": ms, "device_ms": dms,
                                     "kernels": nk}
    return res


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(os.path.abspath(sys.argv[2]))))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_ab_ondevice: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
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
    for key in runs[0]:
        if key == "root":
            continue
        a = [r[key] for r in (runs[0], runs[3])]
        b = [r[key] for r in (runs[1], runs[2])]
        print(f"{key}: other {a[0]['ms']:.4f} / {a[1]['ms']:.4f} ms a call "
              f"({a[0]['device_ms']:.4f} ms device, {a[0]['kernels']} "
              f"kernels), this tree {b[0]['ms']:.4f} / {b[1]['ms']:.4f} ms "
              f"({b[0]['device_ms']:.4f} ms device, {b[0]['kernels']} "
              f"kernels) | {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
