#!/usr/bin/env python3
"""Four-step route against butterfly engine, by ring and batch, on one GPU.

Run from the root of a checkout, on a machine with the card:

    python3 tools/chip_ntt_crossover.py [OUT_JSON]

For each ring of GRID (u16 at 2^8 and 2^9, its largest degree; u32 at 2^8
to 2^15; u64 at 2^8 to 2^16; NMODULI channels, u16 its 2) and each batch
(one polynomial, and the OPERAND_MIB operand of the benchmark's cells) it
runs ntt_pow_phi and invntt_pow_invphi through ops/ntt.py under
NFL_TORCH_NTT=fused (the route: K9 twice for u16/u32, K5 twice for u64)
and NFL_TORCH_NTT=butterfly (K3/K7 with the twist fused), checks that both
give the same residues, and prints a line a case: device us a call (the
sum of every CUDA kernel's device time in a CUDA-only torch.profiler
session of REPS calls, chip_smoke.py's retrying profile, over REPS), events
us a call over REPS back-to-back calls (host work included), the kernel
wrappers' launches a call and the kernels' names.  Cases run in turns: for
each (ring, batch, direction) route, butterfly, butterfly, route, and each
figure is the mean of the two.  The results go to OUT_JSON as well
(default chiprun_out/ntt_crossover.json).
"""
from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRID = ([("u16", 1 << k) for k in (8, 9)]
        + [("u32", 1 << k) for k in (8, 10, 12, 13, 14, 15)]
        + [("u64", 1 << k) for k in range(8, 17)])
NMODULI = 14
BITS = {"u16": 14, "u32": 30, "u64": 62}
OPERAND_MIB = 224
REPS = {"one": 20, "operand": 5}
IMPLS = ("fused", "butterfly")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ntt_crossover: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import _kernels
    from nfllib_tpu_torch.ops import ntt
    from chip_smoke import profile_kernels

    out_path = pathlib.Path(argv[0] if argv else
                            ROOT / "chiprun_out" / "ntt_crossover.json")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    t0 = time.perf_counter()
    _kernels.library()
    print(f"library: {time.perf_counter() - t0:.1f} s")

    def launches():
        return {k.name: k.launches for k in _kernels.KERNELS}

    def measure(impl, fn, reps):
        os.environ["NFL_TORCH_NTT"] = impl
        before = launches()
        fn()
        torch.cuda.synchronize()
        per_call = {k: v - before[k] for k, v in launches().items()
                    if v != before[k]}
        kern, tries = profile_kernels(
            torch, dev, lambda: [fn() for _ in range(reps)],
            reps * sum(per_call.values()))
        dev_us = sum(us for _, _, us in kern) / reps
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return {"device_us": dev_us,
                "events_us": start.elapsed_time(end) * 1e3 / reps,
                "launches": per_call, "tries": tries,
                "kernels": sorted({k_[:48] for k_, _, _ in kern})}

    results = []
    for limb, degree in GRID:
        m = 2 if limb == "u16" else NMODULI
        ring = nfl.ring_from_modulus(limb, degree, BITS[limb] * m)
        ctx = ring.context()
        poly_bytes = m * degree * ring.torch_dtype.itemsize
        for batch_kind, batch in (("one", 1),
                                  ("operand", (OPERAND_MIB << 20)
                                   // poly_bytes)):
            gen = torch.Generator(device=dev).manual_seed(degree + batch)
            p = ctx.to(dev).p_col
            x = (torch.randint(0, 1 << 62, (batch, m, degree), device=dev,
                               generator=gen) % p).to(ring.torch_dtype)
            outs = {}
            for direction, call in (("fwd", ntt.ntt_pow_phi),
                                    ("inv", ntt.invntt_pow_invphi)):
                for impl in IMPLS:
                    os.environ["NFL_TORCH_NTT"] = impl
                    outs[direction, impl] = call(x, ctx)
                if not torch.equal(outs[direction, "fused"],
                                   outs[direction, "butterfly"]):
                    raise AssertionError(f"{limb} n={degree} batch={batch} "
                                         f"{direction}: route != butterfly")
                reps = REPS[batch_kind]
                runs = {impl: [] for impl in IMPLS}
                for impl in IMPLS + IMPLS[::-1]:
                    runs[impl].append(measure(impl, lambda: call(x, ctx),
                                              reps))
                row = {"limb": limb, "degree": degree, "nmoduli": m,
                       "batch": batch, "batch_kind": batch_kind,
                       "mib": batch * poly_bytes / (1 << 20),
                       "direction": direction}
                for impl, rs in runs.items():
                    row[impl] = {
                        "device_us": statistics.mean(r["device_us"]
                                                     for r in rs),
                        "device_us_runs": [r["device_us"] for r in rs],
                        "events_us": statistics.mean(r["events_us"]
                                                     for r in rs),
                        "launches": rs[0]["launches"],
                        "kernels": rs[0]["kernels"],
                        "tries": [r["tries"] for r in rs]}
                f_, b_ = row["fused"], row["butterfly"]
                row["route_over_butterfly_device"] = (
                    f_["device_us"] / b_["device_us"])
                results.append(row)
                print(f"{limb} n={degree} m={m} batch={batch} "
                      f"({row['mib']:.3f} MiB) {direction}: device us route "
                      f"{f_['device_us']:.2f} butterfly "
                      f"{b_['device_us']:.2f} (route/butterfly "
                      f"{row['route_over_butterfly_device']:.2f}); events us "
                      f"route {f_['events_us']:.2f} butterfly "
                      f"{b_['events_us']:.2f}; launches route "
                      f"{f_['launches']} butterfly {b_['launches']}; "
                      f"kernels route {f_['kernels']} butterfly "
                      f"{b_['kernels']}", flush=True)
            del x, outs
            torch.cuda.empty_cache()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({"card": card, "results": results},
                                   indent=1))
    wins = [r for r in results if r["route_over_butterfly_device"] < 1]
    print(json.dumps({"ok": True, "cases": len(results),
                      "route_wins": [(r["limb"], r["degree"], r["batch"],
                                      r["direction"]) for r in wins]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
