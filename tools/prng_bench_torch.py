#!/usr/bin/env python3
"""Gaussian sampler statistical harness of the PyTorch / CUDA port, the
counterpart of tools/prng_bench.py (the reference's prng_demo_main,
tests/prng_demo_main.cpp:6-35: 5*10^7 samples, a sample dump for offline
distribution checks).

    python3 tools/prng_bench_torch.py [--samples N] [--sigma S]
        [--security B] [--dump FILE] [--key HEX]
        [--sampler host|device|device_exact] [--device cuda|cpu]

--sampler host (the default) is prng_bench.py's harness on the port:
FastGaussianNoise.get_noise over a Salsa20Stream, in chunks of 5,000,000.
--sampler device / device_exact run the same harness over the port's
device samplers, device_gaussian (S3) and device_gaussian_exact (S4),
drawn on the ring DEVICE_RING (the LWE demo's degree, one modulus): a
chunk is as many draws of DEVICE_RING's degree as it needs, the last one
cut; the fixed sampler's draws take successive nonces, the stream-exact
one's each start where the one before stopped (nonce + its fills, kept on
the device).  A sample is channel 0's residue r read as signed (r - p
where r > p / 2).  The device samplers also print the time of their
calls alone (CUDA events around them, the reading of the samples left
out) and the device time of one draw (torch.profiler).

--key HEX (32 bytes) replaces the system entropy, so that a run can be
repeated.  --dump FILE writes the samples as little-endian int64.  It
runs on the card unless given --device cpu (the device samplers' plain
twins there); without a card it exits nonzero, whatever the sampler.  It
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

CHUNK = 5_000_000
DEVICE_RING = ("u32", 1 << 14, 1)    # limb, degree, nmoduli


def device_sampler(fg, key: bytes, exact: bool, device):
    """(one() -> the next draw of DEVICE_RING, channel 0's residues on
    `device`; signed(r) -> them read as signed int64; the device tables'
    build s): draws from nonce 0 on"""
    import torch
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch.prng import device_sampling as dsamp
    ring = nfl.Ring(*DEVICE_RING)
    mode = nfl.gaussian(fg)
    t0 = time.perf_counter()
    tables = dsamp.gaussian_tables(fg, device, exact)
    tables_s = time.perf_counter() - t0
    p = int(ring.moduli[0])
    nonce = torch.zeros((), dtype=torch.int64, device=device) if exact else 0

    def one():
        nonlocal nonce
        if exact:
            vals, fills = dsamp.device_gaussian_exact(
                ring, key, nonce, mode, return_fills=True, device=device,
                tables=tables)
            nonce = nonce + fills
        else:
            vals = dsamp.device_gaussian(ring, key, nonce, mode, device,
                                         tables)
            nonce += 1
        return vals[0]

    def signed(r):
        r = r.to(torch.int64)
        return torch.where(r > p // 2, r - p, r)

    return one, signed, tables_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="prng_bench_torch.py",
        description="statistics and speed of the port's Gaussian samplers")
    ap.add_argument("--samples", type=int, default=50_000_000)
    ap.add_argument("--sigma", type=float, default=4.0)
    ap.add_argument("--security", type=int, default=128)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--key", default=None,
                    help="the 32-byte key in hex (default: system entropy)")
    ap.add_argument("--sampler", choices=("host", "device", "device_exact"),
                    default="host")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    prog = "prng_bench_torch"
    device = bench_torch.open_device(prog, args.device)
    if device is None:
        return 1
    import torch
    from nfllib_tpu_torch.prng import entropy
    from nfllib_tpu_torch.prng.gaussian import FastGaussianNoise
    from nfllib_tpu_torch.prng.salsa20 import Salsa20Stream
    key = bytes.fromhex(args.key) if args.key else entropy.randombytes(32)
    if len(key) != 32:
        print(f"{prog}: --key must be 32 bytes in hex", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"
    bench_torch.log(prog, bench_torch.card_line(device))

    t0 = time.perf_counter()
    fg = FastGaussianNoise(args.sigma, args.security,
                           max(args.samples, 1024))
    print(f"table build: {time.perf_counter() - t0:.2f}s "
          f"({fg.number_of_barriers} barriers, {fg.bit_precision} bits)")

    n = DEVICE_RING[1]
    if args.sampler == "host":
        stream = Salsa20Stream(key)
    else:
        one, signed, tables_s = device_sampler(
            fg, key, args.sampler == "device_exact", device)
        print(f"device tables: {tables_s:.2f}s ({args.sampler} on "
              f"{device.type}, draws of {DEVICE_RING[0]} n={n})")

    total = 0
    s1 = s2 = 0
    outliers = 0
    sampler_ms = 0.0
    t0 = time.perf_counter()
    dump = open(args.dump, "wb") if args.dump else None
    try:
        while total < args.samples:
            k = min(CHUNK, args.samples - total)
            if args.sampler == "host":
                out = fg.get_noise(stream, k)
                s1 += int(out.sum())
                s2 += int((out * out).sum())
                outliers += int(np.count_nonzero(
                    np.abs(out) > 6 * args.sigma + 1))
            else:
                draws = []
                sampler_ms += bench_torch.event_ms(lambda: draws.extend(
                    one() for _ in range(-(-k // n))), device)
                out = signed(torch.cat(draws)[:k])
                s1 += int(out.sum())
                s2 += int((out * out).sum())
                outliers += int((out.abs() > 6 * args.sigma + 1).sum())
                out = out.cpu().numpy()
            total += k
            if dump:
                dump.write(out.astype("<i8").tobytes())
    finally:
        if dump:
            dump.close()
    if on_card:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    mean = s1 / total
    std = (s2 / total - mean * mean) ** 0.5
    print(f"{total} samples in {dt:.2f}s -> {total/dt/1e6:.2f} Msamples/s")
    print(f"mean {mean:+.5f} (expect 0)   std {std:.5f} "
          f"(expect {args.sigma})   >6-sigma outliers: {outliers} "
          f"(~{total * 2e-9:.1f} expected)")
    if args.sampler != "host":
        clock = "CUDA events" if on_card else "host clock"
        print(f"sampler calls alone: {sampler_ms:.3f} ms on {clock} -> "
              f"{total / sampler_ms / 1e3:.2f} Msamples/s")
        dev = bench_torch.device_ms(one, device)
        if dev is not None:
            dms, kernels, _ = dev
            print(f"device time of one draw of {n}: {dms:.4f} ms, "
                  f"{kernels} CUDA kernels -> {n / dms / 1e3:.2f} "
                  f"Msamples/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
