#!/usr/bin/env python3
"""Each kernel wrapper's launches a request in one cell of BENCHMARK.json.

Run from the root of a checkout, on a machine with the card:

    python3 tools/cell_counters.py --workload <cell> [--seed N] [--seconds S]

Runs the cell as `python3 -m portbench` does, untraced, with the wrappers'
counters (`launches`, and `cluster_launches` where a wrapper has it) set to
0 as the measured window starts, so set-up and warm-up are left out, and
prints one JSON line: the cell, whether its check passed, the window's
requests and, for each wrapper that launched, [launches, cluster launches]
a request.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cell_counters: no CUDA device", file=sys.stderr)
        return 1
    from nfllib_tpu_torch import _kernels
    from portbench import run as bench
    counts = {}
    measure = bench.measure

    def counted(*a, **k):
        for w in _kernels.KERNELS:
            w.launches = 0
            if hasattr(w, "cluster_launches"):
                w.cluster_launches = 0
        window = measure(*a, **k)
        n = window.requests
        counts["requests"] = n
        counts["per_request"] = {
            w.name: [w.launches / n, getattr(w, "cluster_launches", 0) / n]
            for w in _kernels.KERNELS if w.launches}
        return window

    bench.measure = counted
    manifest = bench.load_manifest()
    _, cfg, mix = bench.find_cell(manifest, args.workload)
    result = bench.run_cell(manifest, args.workload, cfg, mix, args.seed,
                            args.seconds, False, "cuda:0")
    print(json.dumps({"workload": args.workload,
                      "correct": result["correct"], **counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
