#!/usr/bin/env python3
"""Per-primitive microbenchmarks of the PyTorch / CUDA port, the
counterpart of tools/bench_ops.py (the reference's runtime benchmark
harness, tests/nfllib_demo_main_op.cpp:119-258): µs per polynomial of each
primitive at each point of the reference's 5-point matrix
(tests/CMakeLists.txt:1-7), the same rows in the same order.

    python3 tools/bench_ops_torch.py [--config N] [--csv] [--trace DIR]
        [--mode auto|fused|butterfly] [--chain K] [--samples S]
        [--device cuda|cpu]

Device rows call what a user's code runs on the card: the elementwise ops
one E1 launch each (ops/expr_program.py:apply, as Poly's named ops do),
the NTTs ops/ntt.py (K3/K7 in auto and butterfly modes where they
serve the ring; the routes, K9 or K5, under --mode fused), the LWE
graphs apps/lwe.py:_encrypt_graph / _decrypt_graph (K6/K8 under --mode
butterfly).  Each is timed as
bench_torch.py times an NTT: CUDA events around `chain` applications back
to back, the median of `samples` after 3 warm-ups, divided by the batch;
beside it the device µs per polynomial and the CUDA kernels a call
(torch.profiler; not measured under --trace, whose profile holds the
profiler) and the port's kernel wrappers that launched.  Host rows (the
samplers on the Salsa20 stream) are the best of their reps on
profiling.WallTimer.  --csv prints tools/bench_ops.py's columns (degree,
bits, limb, name, µs) and then device µs, CUDA kernels a call and the
wrappers' launches a call.

It runs on the card unless given --device cpu, where the same calls run
the plain twins on the host clock and no device column is filled.
Without a card it exits nonzero.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

CONFIGS = [
    (8, 60, "u32"),
    (128, 14, "u16"),
    (1024, 60, "u32"),
    (8192, 124, "u64"),
    (32768, 124, "u64"),
]

BATCH = 8   # polys per device op

# the elementwise rows: (row, E1's named op, its leaves after the chained
# operand; "a", "b" and "bprec" are the config's operands)
ELEMENTWISE = (
    ("add", "addmod", ("b",)),
    ("sub", "submod", ("b",)),
    ("mul (pointwise)", "mulmod", ("b",)),
    ("mulmod_shoup", "mulmod_shoup", ("b", "bprec")),
    ("muladd (fma)", "muladd", ("a", "b")),
    ("muladd_shoup", "muladd_shoup", ("a", "b", "bprec")),
)


class Row(NamedTuple):
    name: str
    fn: object      # device rows: one application fn(x); host rows: fn()
    x: object       # the first application's input; None for host rows
    reps: int = 20  # host rows: calls, the best of which is kept


def _rand(ring, rng, batch=BATCH):
    m, n = ring.nmoduli, ring.degree
    out = np.empty((batch, m, n), dtype=np.uint64)
    for cm in range(m):
        out[:, cm, :] = rng.integers(0, int(ring.moduli[cm]),
                                     size=(batch, n), dtype=np.uint64)
    return out.astype(ring.dtype)


def build_rows(ring, device) -> list:
    """The rows of one config in tools/bench_ops.py's order, on its inputs
    (default_rng(7) for the operands, the streams of its keys and host
    samplers), under the NFL_TORCH_NTT mode in force"""
    from nfllib_tpu_torch import interop
    from nfllib_tpu_torch.apps import lwe
    from nfllib_tpu_torch.ops import expr_program, ntt as ntt_mod
    from nfllib_tpu_torch.prng import sampling
    from nfllib_tpu_torch.prng.gaussian import FastGaussianNoise
    from nfllib_tpu_torch.prng.salsa20 import Salsa20Stream

    def put(arr):
        return interop.poly_from_numpy(arr, ring, device).data

    ctx = ring.context()
    rng = np.random.default_rng(7)
    ops = {"a": put(_rand(ring, rng)), "b": put(_rand(ring, rng))}
    ops["bprec"] = expr_program.apply("compute_shoup", (ops["b"],), ring)
    a, b = ops["a"], ops["b"]

    def named(op, leaves):
        rest = tuple(ops[k] for k in leaves)
        return lambda v: expr_program.apply(op, (v,) + rest, ring)

    rows = [Row(name, named(op, leaves), a)
            for name, op, leaves in ELEMENTWISE]
    rows.append(Row("ntt_pow_phi", lambda v: ntt_mod.ntt_pow_phi(v, ctx), a))
    rows.append(Row("invntt_pow_invphi",
                    lambda v: ntt_mod.invntt_pow_invphi(v, ctx), a))

    stream = Salsa20Stream(b"\x11" * 32)
    g = lwe.make_gaussian_prng(samples=max(ring.degree, 1 << 10))
    keys = lwe.keygen(ring, stream, g, device)
    pka, pkb, s, sprime = (keys.pka.data, keys.pkb.data, keys.s.data,
                           keys.sprime.data)
    e2 = put(_rand(ring, rng))
    resa, resb = lwe._encrypt_graph(ctx, pka, pkb, a, b, e2)
    rows.append(Row("lwe encrypt (chain)", lambda v: lwe._encrypt_graph(
        ctx, pka, pkb, v, b, e2)[0], a))
    rows.append(Row("lwe decrypt (chain)", lambda v: lwe._decrypt_graph(
        ctx, v, resb, s, sprime), resa))

    hs = Salsa20Stream(b"\x13" * 32)
    fg = FastGaussianNoise(4.0, 128, max(ring.degree, 1024))
    rows.append(Row("uniform (host)",
                    lambda: sampling.sample_uniform(ring, hs), None))
    rows.append(Row("non_uniform ub=7 (host)",
                    lambda: sampling.sample_non_uniform(
                        ring, hs, sampling.non_uniform(7)), None))
    rows.append(Row("gaussian (host)", lambda: sampling.sample_gaussian(
        ring, hs, sampling.gaussian(fg)), None, reps=5))
    return rows


def time_row(row, device, chain, samples, profile):
    """(µs, device µs or None, CUDA kernels a call or None, {wrapper:
    launches a call}) of one row, per polynomial for device rows"""
    if row.x is None:
        return bench_torch.time_host(row.fn, row.reps), None, None, {}

    def sample():
        bench_torch.applied(row.fn, row.x, chain)

    before = bench_torch.launch_counts()
    ms = bench_torch.median_ms(sample, device, samples) / chain
    calls = chain * (samples + bench_torch.WARMUP)
    per_call = {k: n / calls
                for k, n in bench_torch.launches_since(before).items()}
    dev = bench_torch.device_ms(sample, device) if profile else None
    if dev is None:
        return ms * 1e3 / BATCH, None, None, per_call
    dms, kernels, _ = dev
    return (ms * 1e3 / BATCH, dms * 1e3 / chain / BATCH, kernels / chain,
            per_call)


def _fmt(v, width=0, digits=3):
    return f"{'n/a':>{width}}" if v is None else f"{v:{width}.{digits}f}"


def bench_config(degree, agg, limb, device, mode, chain, samples, csv,
                 profile):
    import nfllib_tpu_torch as nfl
    ring = nfl.ring_from_modulus(limb, degree, agg)
    rows = build_rows(ring, device)
    print(f"== n={degree} {agg}-bit {limb} (batch={BATCH}, "
          f"device={device.type}, mode={mode}) ==")
    for row in rows:
        us, dev_us, kernels, per_call = time_row(row, device, chain, samples,
                                                 profile)
        wrappers = ";".join(f"{k}:{n:g}" for k, n in per_call.items())
        if csv:
            print(f"{degree},{agg},{limb},{row.name},{_fmt(us)},"
                  f"{_fmt(dev_us)},{_fmt(kernels, digits=1)},{wrappers}")
        elif row.x is None:
            print(f"  {row.name:26s} {_fmt(us, 12)} us/poly")
        else:
            print(f"  {row.name:26s} {_fmt(us, 12)} us/poly  device "
                  f"{_fmt(dev_us, 10)} us/poly, {_fmt(kernels, 0, 1)} CUDA "
                  f"kernels a call  [{wrappers or 'no kernel'}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bench_ops_torch.py",
        description="µs per polynomial of each primitive of the PyTorch / "
                    "CUDA port over the reference's 5-point matrix")
    ap.add_argument("--config", type=int, default=None,
                    help="index into the 5-point matrix (default: all)")
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="capture a torch.profiler trace to DIR "
                         "(profiling.trace; no device column then)")
    ap.add_argument("--mode", choices=bench_torch.MODES, default="auto",
                    help="NFL_TORCH_NTT for the run (plain: --device cpu "
                         "only)")
    ap.add_argument("--chain", type=int, default=bench_torch.CHAIN)
    ap.add_argument("--samples", type=int, default=bench_torch.SAMPLES)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    prog = "bench_ops_torch"
    device = bench_torch.open_device(prog, args.device)
    if device is None:
        return 1
    why = bench_torch.check_mode(args.mode, device)
    if why:
        print(f"{prog}: {why}", file=sys.stderr)
        return 2
    from nfllib_tpu_torch import profiling
    bench_torch.log(prog, bench_torch.card_line(device))
    cfgs = CONFIGS if args.config is None else [CONFIGS[args.config]]

    def run_all():
        for degree, agg, limb in cfgs:
            with profiling.annotate(f"bench_n{degree}_{limb}"):
                bench_config(degree, agg, limb, device, args.mode,
                             args.chain, args.samples, args.csv,
                             profile=args.trace is None)

    with bench_torch.ntt_mode(args.mode):
        if args.trace:
            with profiling.trace(args.trace):
                run_all()
        else:
            run_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
