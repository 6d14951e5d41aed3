"""The control of a cell's comparison: the plain reference put in the
program's place, its modular products taken in float64 (the precision
below the exact integer arithmetic the configuration states).  The
comparison has to find it wrong.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]
        [--requests 2]

For each seed it makes the cell's inputs at the cell's own size, computes
`--requests` requests with the control, compares them as a run compares
the port's (traffic.py, the kind's `check`), and prints one JSON line:
the seed, each compared number and its limit.  Benchmark runs never run
it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .run import find_cell, load_manifest, log


def control_checks(kind, requests: int) -> dict:
    kind.control_setup()
    kept = {r: kind.control_request(r) for r in range(requests)}
    return kind.check(kept)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("the control runs on the card: no CUDA device")
        return 2
    import nfllib_tpu_torch as port
    from . import traffic
    _, cfg, mix = find_cell(load_manifest(), args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        cls = traffic.load_kind(mix["kind"])
        kind = cls(port, cfg, mix, seed, "cuda:0")
        checks = control_checks(kind, args.requests)
        limits = mix["limits"]
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "seconds": time.perf_counter() - t,
            "correct": all(checks[k] <= limits[k] for k in checks),
            "checks": {k: {"value": v, "limit": limits[k]}
                       for k, v in checks.items()}}), flush=True)
        del kind
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
