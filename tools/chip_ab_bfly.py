#!/usr/bin/env python3
"""A/B of the butterfly stage engine's variants on one GPU.

Run from the root of a checkout, on a machine with the card:

    python3 tools/chip_ab_bfly.py [--base ROOT ...] [--variants a,b]

Each variant is nfllib_tpu_torch/csrc with string patches (VARIANTS below;
"tree" is the sources as they are; --variants picks some, default all);
--base adds each ROOT's csrc as it is, as a variant named after the
directory (another checkout, e.g. the parent commit unpacked under
_archive/base).  All variants
build at once (one nvcc per source) into _archive/build/ (gitignored), load
with ctypes and run the engine's entry points (ntt_butterfly.cu,
lwe_chain.cu) on the LWE rings u32 (16384, 510) and u64 (16384, 496) and
the u64 2^15 ring of 14 primes (868 bits) at batch 64: each is checked
exact against the plain twins, then the forward and inverse transforms
(K3/K7), the encrypt and the decrypt chains (K6/K8) are timed with CUDA
events, medians of 15 samples of 10 back-to-back calls, the variants in
turns.  It prints each variant's ptxas registers and spills for the 2^14
instances and the two-block cluster's (bfly_pair).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

# name: [(file in csrc, text, replacement)]
VARIANTS = {
    "tree": [],
    # every transform's groups unrolled (the tree runs u64's one at a time)
    "ntt_unrolled": [(
        "ntt_butterfly.cuh",
        "constexpr bool kSerial = sizeof(T) == 8;",
        "constexpr bool kSerial = false;")],
    # the two-block cluster's cross-half stage unrolled (the tree runs a
    # thread's vectors one at a time)
    "cross_unrolled": [(
        "ntt_butterfly.cuh",
        "#pragma unroll 1\n  for (int k = 0; k < kSteps; ++k) {",
        "#pragma unroll\n  for (int k = 0; k < kSteps; ++k) {")],
    "cross_unroll2": [(
        "ntt_butterfly.cuh",
        "#pragma unroll 1\n  for (int k = 0; k < kSteps; ++k) {",
        "#pragma unroll 2\n  for (int k = 0; k < kSteps; ++k) {")],

    # the encrypt chain's groups unrolled
    "enc_unrolled": [(
        "ntt_butterfly.cuh", f"transform<W, LOG_LEN, kThreads, false, true>"
        f"(c, sm, {a}, {b});", f"transform<W, LOG_LEN, kThreads, false, "
        f"false>(c, sm, {a}, {b});")
        for a, b in (("load_u", "keep"), ("load_e1", "store_a"),
                     ("load_e2", "store_b"))],
    # 1024-thread blocks (one group of 16 a thread at 2^14), one an SM
    "t1024": [
        ("ntt_butterfly.cuh",
         "  return ((1 << log_len) >> kRadixLog) < 512 ? (1 << log_len) >> "
         "kRadixLog\n                                             : 512;",
         "  return ((1 << log_len) >> kRadixLog) < 1024 ? (1 << log_len) >> "
         "kRadixLog\n                                             : 1024;"),
        ("ntt_butterfly.cuh",
         "  return !encrypt && (word_bytes << log_len) <= 65536 ? 2 : 1;",
         "  return 1;")],
}
SOURCES = ("ntt_butterfly.cu", "lwe_chain.cu", "dft_mxu64.cu")
RINGS = (("u32", 16384, 510), ("u64", 16384, 496), ("u64", 32768, 868))
BATCH = 64


def build(nvcc, flags, variants, bases=()):
    """{name: loaded library}, {(name, source): nvcc's output} of each
    variant (name: patches), and of each checkout root in `bases` as is,
    named after its directory."""
    root = pathlib.Path("_archive/build")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    srcs = {name: pathlib.Path("nfllib_tpu_torch/csrc") for name in variants}
    for base in bases:
        name = pathlib.Path(base).name
        variants = {**variants, name: []}
        srcs[name] = pathlib.Path(base) / "nfllib_tpu_torch" / "csrc"
    for name, patches in variants.items():
        d = root / name
        shutil.copytree(srcs[name], d)
        for fname, a, b in patches:
            f = d / fname
            s = f.read_text()
            if a not in s:
                raise SystemExit(f"{name}: patch target not in {fname}: {a}")
            f.write_text(s.replace(a, b))
        for src in SOURCES:
            procs[(name, src)] = subprocess.Popen(
                [nvcc, *flags, "-c", "-o", str(d / f"{src}.o"), str(d / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for key, p in procs.items():
        logs[key] = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"build of {key} failed:\n{logs[key][-3000:]}")
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in variants:
        d = root / name
        subprocess.run([nvcc, *flags[:2], "-shared", "-o", str(d / "lib.so")]
                       + [str(d / f"{s}.o") for s in SOURCES], check=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.nfl_ntt_butterfly.argtypes = [i32] * 4 + [ptr] * 5 + [i32] * 3 \
            + [ptr]
        lib.nfl_lwe_encrypt.argtypes = [i32] + [ptr] * 12 + [i32] * 3 + [ptr]
        lib.nfl_lwe_decrypt.argtypes = [i32] + [ptr] * 8 + [i32] * 3 + [ptr]
        libs[name] = lib
    return libs, logs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", nargs="*", default=[])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    variants = {n: VARIANTS[n] for n in args.variants.split(",")}
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_ab_bfly: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import _kernels
    from nfllib_tpu_torch.ops import modops, ntt_pallas as tp
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    libs, logs = build(_kernels._nvcc(), list(_kernels.NVCC_FLAGS),
                       variants, args.base)
    print(f"build: {time.perf_counter() - t0:.1f} s, {len(libs)} "
          f"variants in parallel")
    for (name, src), log in logs.items():
        cur = None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur = m.group(1)
            elif cur and re.search(r"bfly_(\w+Li14E|pair)", cur) and (
                    "registers" in ln or "spill" in ln):
                short = re.search(r"(bfly_\w+?Li\d+E(?:Li\dE)?)",
                                  cur).group(1)
                print(f"ptxas {name} {src} {short}: "
                      f"{ln.split(':', 1)[-1].strip()}")
    dev = "cuda"
    rng = np.random.default_rng(3)
    P = ctypes.c_void_p

    def p_(t):
        return P(None if t is None else t.data_ptr())

    def rows(r, b):
        out = np.empty((b, r.nmoduli, r.degree), dtype=np.uint64)
        for c in range(r.nmoduli):
            out[:, c] = rng.integers(0, int(r.moduli[c]), size=(b, r.degree),
                                     dtype=np.uint64)
        return nfl.Poly.from_numpy(r, out.astype(r.dtype), dev).data

    def timed(fn, reps=10):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    for limb, degree, bits in RINGS:
        r = nfl.ring_from_modulus(limb, degree, bits)
        c = r.context()
        t = tp.kernel_tables(r, dev)
        x, u, e1, e2 = (rows(r, BATCH) for _ in range(4))
        pka, pkb, s = (rows(r, 1)[0] for _ in range(3))
        tabs = c.to(dev)
        sp = modops.compute_shoup(s, tabs.p_col, tabs.shoup_f)
        ra, rb = tp.lwe_encrypt_plain(u, e1, e2, pka, pkb, c)
        out, out2 = torch.empty_like(x), torch.empty_like(x)
        scratch = torch.empty_like(x) if t.global_stages else None
        red = t.pn if limb == "u64" else t.bm
        ops = {}
        for name, lib in libs.items():
            def launch(code):
                if code:
                    raise SystemExit(f"{name}: CUDA error {code}")

            def fwd(lib=lib):
                launch(lib.nfl_ntt_butterfly(
                    t.bits, 0, 1, 1, p_(x), p_(out), p_(t.wp), p_(t.twp),
                    p_(t.p), BATCH,
                    t.m, t.log_n, P(torch.cuda.current_stream().cuda_stream)))

            def inv(lib=lib):
                launch(lib.nfl_ntt_butterfly(
                    t.bits, 1, 1, 1, p_(x), p_(out), p_(t.iwp), p_(t.itwp),
                    p_(t.p), BATCH, t.m, t.log_n,
                    P(torch.cuda.current_stream().cuda_stream)))

            def enc(lib=lib):
                launch(lib.nfl_lwe_encrypt(
                    t.bits, p_(u), p_(e1), p_(e2), p_(pka), p_(pkb),
                    p_(out), p_(out2), p_(scratch), p_(t.wp), p_(t.twp),
                    p_(t.p),
                    p_(red), BATCH,
                    t.m, t.log_n, P(torch.cuda.current_stream().cuda_stream)))

            def dec(lib=lib):
                launch(lib.nfl_lwe_decrypt(
                    t.bits, p_(ra), p_(rb), p_(s), p_(sp), p_(out), p_(t.iwp),
                    p_(t.itwp), p_(t.p), BATCH, t.m, t.log_n,
                    P(torch.cuda.current_stream().cuda_stream)))
            ops[name] = {"fwd": fwd, "inv": inv, "enc": enc, "dec": dec}
            exact = {}
            fwd()
            torch.cuda.synchronize()
            exact["fwd"] = torch.equal(out, tp.ntt_fwd_plain(x, c))
            inv()
            torch.cuda.synchronize()
            exact["inv"] = torch.equal(out, tp.intt_bwd_plain(x, c))
            enc()
            torch.cuda.synchronize()
            exact["enc"] = torch.equal(out, ra) and torch.equal(out2, rb)
            dec()
            torch.cuda.synchronize()
            exact["dec"] = torch.equal(out, tp.lwe_decrypt_plain(
                ra, rb, s, sp, c))
            if not all(exact.values()):
                raise SystemExit(f"{name} {limb}: not exact: {exact}")
        names = list(ops)
        for op in ("fwd", "inv", "enc", "dec"):
            ts = {n: [] for n in names}
            for n in names:
                timed(ops[n][op], 2)
            for j in range(15):
                for n in (names if j % 2 == 0 else names[::-1]):
                    ts[n].append(timed(ops[n][op]))
            print(f"{limb} n={degree} m={r.nmoduli} batch={BATCH} {op}: "
                  + ", ".join(f"{n} {statistics.median(v):.4f} ms"
                              for n, v in ts.items())
                  + f" (all exact) | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
