#!/usr/bin/env python3
"""Where a call of the hwt pair (S5 device_hwt, S6 device_hwt_exact;
nfllib_tpu_torch/csrc/hwt.cu) spends its time on one GPU: the device
phases of each kernel and the host's launch path.

Run from the root of a checkout, on a machine with the card:

    python3 tools/chip_hwt_split.py

Device phases: a copy of hwt.cu with a clock64() read by thread 0 of
each CTA at the boundaries below (the PHASES anchors, inserted into the
copy's text; the port's own build is untouched) is built alone with
nvcc into nfllib_tpu_torch/_build/hwt_split/ and driven through the
port's wrappers at u32 (16384, 510) and u64 (16384, 496), h = 64, after
a warm-up; each call's phases are the median over CALLS calls of the
clocks of CTA 0 and of the last CTA (the one that took the ticket last),
in SM cycles and in µs at the SM clock that nvidia-smi reads beside
them.  S6's hwt_partial_kernel: the keystream, the words (their mods,
the reservoir's atomics, the record), the ticket, the records resolved,
the reservoir read and reset, the bitmap and rank offsets.  S5's
hwt_cand_kernel: the keys and candidates, the ticket, the counts, the
candidates' copy, the selection among them, the bitmap and rank
offsets.
hwt_store_kernel: the ranks, the sign words' keystream, the codes, the
stores.

Host: the microseconds a call of each step of the wrappers' path, the
host clock over many calls issued back to back, on the same build (the
moduli's lookup, an
output's torch.empty, the current device and stream, the C entry point
alone with its two launches, the wrapper, the sampler's function).  It
prints a line a case, each with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CALLS = 21
HOST_CALLS = 1000
KEY = bytes(range(64, 96))
H = 64
RINGS = (("u32", 16384, 510), ("u64", 16384, 496))
KINDS = ("hwt_partial_kernel", "hwt_cand_kernel", "hwt_store_kernel")
MAX_CTAS = 1024
SLOTS = 8

# (anchor in hwt.cu, kind, phase, where): the probe goes before the
# anchor, after it, or after the line that holds it
PHASES = (
    ("const int h = P.h, q = P.n - P.h;", 0, 0, "line after"),
    ("      for (int i = i0 + t; i < i1; i += T) take(i, sw[i - i0]);", 0, 1,
     "before"),
    ("  if (!last_block(P.ticket, S.last)) return;\n  // the reservoir's",
     0, 2, "before"),
    ("  walk_resolve(P, S, true);\n", 0, 3, "before"),
    ("  walk_resolve(P, S, true);\n", 0, 4, "after"),
    ("  mark_hits(P.n, h, [&](int p)", 0, 5, "before"),
    ("const int len = P.len, x0 = v * len;", 1, 0, "line after"),
    ("  if (!last_block(P.ticket, S.last)) return;\n  const int G", 1, 1,
     "before"),
    ("  const int G = gridDim.x;", 1, 2, "before"),
    ("  const int total = S.total;", 1, 3, "before"),
    ("    radix_select(S, total,", 1, 4, "before"),
    ("    mark_hits(P.n, total, [&](int j) {", 1, 5, "before"),
    ("char* out = static_cast<char*>(P.out);", 2, 0, "line after"),
    ("  // the sign words of ranks", 2, 1, "before"),
    ("  for (int j = t; j < len; j += kStoreThreads) {\n    const uint32_t bw",
     2, 2, "before"),
    ("  for (int c = c_lo; c < c_hi; ++c) {\n    const uint64_t pm1", 2, 3,
     "before"),
)
# the probe at each kernel's end, before its closing brace
ENDS = ((0, "  mark_hits(P.n, h, [&](int p) { return hit[p]; }, P.bitmap, "
            "P.prefix,\n            S.seg, S.tmp);\n}\n", 6),
        (1, "    }, P.bitmap, P.prefix, S.seg, S.tmp);\n  }\n}\n", 6),
        (2, "                     });\n  }\n}\n", 4))
# the probes every CTA reaches (up to its ticket; the store's all)
EVERY = {0: 3, 1: 2, 2: 5}
NAMES = {0: ("keystream", "words (mods, reservoir, record)", "ticket",
             "records resolved", "reservoir read", "bitmap + rank offsets"),
         1: ("keys + candidates", "ticket", "counts", "candidates' copy",
             "selection", "bitmap + rank offsets"),
         2: ("ranks", "sign keystream", "codes", "stores")}

PROBE_DEFS = f"""
__device__ long long g_hwt_phase[3][{MAX_CTAS}][{SLOTS}];
#define HWT_PHASE(kind, i) do {{ if (threadIdx.x == 0 && blockIdx.y == 0 \\
    && blockIdx.x < {MAX_CTAS}) g_hwt_phase[kind][blockIdx.x][i] = \\
    clock64(); }} while (0)
"""
PROBE_EXPORTS = f"""
extern "C" int nfl_hwt_phases(long long* out, int reset) {{
  if (reset) {{
    static long long zero[3][{MAX_CTAS}][{SLOTS}];
    return static_cast<int>(cudaMemcpyToSymbol(g_hwt_phase, zero,
                                               sizeof(zero)));
  }}
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_hwt_phase, sizeof(long long) * 3 * {MAX_CTAS} * {SLOTS}));
}}
"""


def instrumented(src: str) -> str:
    """hwt.cu with the probes inserted"""
    s = src.replace('#include "salsa20_block.cuh"\n',
                    '#include "salsa20_block.cuh"\n' + PROBE_DEFS, 1)
    for anchor, kind, i, where in PHASES:
        probe = f"HWT_PHASE({kind}, {i});"
        at = s.index(anchor)
        if where == "before":
            s = s[:at] + f"  {probe}\n" + s[at:]
        elif where == "after":
            s = s[:at + len(anchor)] + f"  {probe}\n" + s[at + len(anchor):]
        else:
            end = s.index("\n", at) + 1
            s = s[:end] + f"  {probe}\n" + s[end:]
    for kind, anchor, i in ENDS:
        at = s.index(anchor) + len(anchor) - 2
        s = s[:at] + f"  HWT_PHASE({kind}, {i});\n" + s[at:]
    return s + PROBE_EXPORTS


def build(kernels):
    """the instrumented library, built alone; a stand-in for
    _kernels.library() that the wrappers call"""
    out = os.path.join(ROOT, "nfllib_tpu_torch", "_build", "hwt_split")
    os.makedirs(out, exist_ok=True)
    csrc = kernels._CSRC
    for h in ("launch.cuh", "salsa20_block.cuh"):
        shutil.copy(csrc / h, os.path.join(out, h))
    cu = os.path.join(out, "hwt_split.cu")
    with open(cu, "w") as f:
        f.write(instrumented((csrc / "hwt.cu").read_text()))
    so = os.path.join(out, "libhwt_split.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    so, cu], check=True, capture_output=True, text=True)

    class Lib:
        def __init__(self):
            self.lib = ctypes.CDLL(so)
            kernels.set_hwt_argtypes(self.lib)
            self.lib.nfl_hwt_phases.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int]
            self.lib.nfl_hwt_phases.restype = ctypes.c_int

        def check(self, err, what):
            if err:
                raise RuntimeError(f"{what}: CUDA error {err}")
    return Lib()


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_hwt_split: no CUDA device", file=sys.stderr)
        return 1
    import nfllib_tpu_torch as nfl
    from nfllib_tpu_torch import _kernels
    from nfllib_tpu_torch.prng import device_sampling as dsamp

    card = smi("name,power.limit")
    lib = build(_kernels)
    _kernels.library = lambda: lib
    dev = torch.device("cuda", 0)
    buf = np.zeros((3, MAX_CTAS, SLOTS), dtype=np.int64)

    def phases(fn):
        """{kind: (CTA 0's phase cycles, the last CTA's)} medians"""
        got = {k: ([], []) for k in range(3)}
        for _ in range(CALLS):
            torch.cuda.synchronize()
            assert lib.lib.nfl_hwt_phases(None, 1) == 0
            fn()
            torch.cuda.synchronize()
            assert lib.lib.nfl_hwt_phases(buf.ctypes.data, 0) == 0
            for k in range(3):
                ctas = np.nonzero(buf[k, :, 0])[0]
                if len(ctas) == 0:
                    continue
                nph = len(NAMES[k]) + 1
                # the last CTA: the one that got past its ticket
                tail = [c for c in ctas if buf[k, c, nph - 1] > 0]
                # every CTA's probes up to its ticket; the last CTA's all
                for side, c, upto in ((0, ctas[0], EVERY[k]),
                                      (1, tail[0] if tail else None, nph)):
                    if c is not None:
                        got[k][side].append(np.diff(buf[k, c, :upto]))
        return {k: tuple(np.median(np.stack(v), axis=0) if v else None
                         for v in sides)
                for k, sides in got.items() if sides[0]}

    for limb, n, bits in RINGS:
        ring = nfl.ring_from_modulus(limb, n, bits)
        md = nfl.hwt_dist(H)
        for tag, fn in (
                ("device_hwt (S5)", lambda: dsamp.device_hwt(
                    ring, KEY, 5, md, dev)),
                ("device_hwt_exact (S6)", lambda: dsamp.device_hwt_exact(
                    ring, KEY, 5, md, device=dev))):
            for _ in range(20):
                fn()
            res = phases(fn)
            mhz = float(smi("clocks.sm").split()[0])
            for k, (first, last) in res.items():
                for side, row in (("CTA 0", first), ("last CTA", last)):
                    if row is None:
                        continue
                    if k == 2 and side == "last CTA":
                        continue
                    parts = ", ".join(
                        f"{NAMES[k][i]} {c:.0f} ({c / mhz:.3f} us)"
                        for i, c in enumerate(row))
                    print(f"{tag} {limb}: {KINDS[k]}, {side}: {parts}; "
                          f"total {row.sum():.0f} cycles "
                          f"({row.sum() / mhz:.3f} us at {mhz:.0f} MHz) "
                          f"| {card}")

    # the host path (on the same build: its probes are device stores)
    def per(fn, n=HOST_CALLS):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    for limb, n, bits in RINGS:
        ring = nfl.ring_from_modulus(limb, n, bits)
        md = nfl.hwt_dist(H)
        m, dtype = ring.nmoduli, ring.torch_dtype
        p = ring.context().to(dev).p_col
        s5, s6 = _kernels.HWT_FIXED, _kernels.HWT_EXACT
        out = torch.empty((m, n), dtype=dtype, device=dev)
        adv = torch.empty((), dtype=torch.int64, device=dev)
        stream = _kernels._raw_stream(0)
        pl5, pl6 = s5.plan(n, H), s6.plan(n, H)
        state, scratch = s6._workspace(dev, stream,
                                       max(pl5.bytes, pl6.bytes))
        kw = _kernels._key_words(KEY)
        nb = _kernels.HwtFixedKernel._BYTES[dtype]
        lib_ = _kernels.library().lib
        args5 = (kw, None, 5, None, n, H, p.data_ptr(), m, nb,
                 out.data_ptr(), scratch.data_ptr(), state.data_ptr(),
                 s5.CAP, 0, stream)
        args6 = (kw, None, 5, None, n, H, 8, p.data_ptr(), m, nb,
                 out.data_ptr(), adv.data_ptr(), scratch.data_ptr(),
                 state.data_ptr(), s6.CAP, 0, stream)
        steps = (
            ("moduli lookup", lambda: ring.context().to(dev).p_col),
            ("torch.empty out", lambda: torch.empty((m, n), dtype=dtype,
                                                    device=dev)),
            ("torch.empty 0-d", lambda: torch.empty((), dtype=torch.int64,
                                                    device=dev)),
            ("current device", torch.cuda.current_device),
            ("current stream (object)", lambda: torch.cuda.current_stream()
             .cuda_stream),
            ("current stream (raw)", lambda: _kernels._raw_stream(0)),
            ("S5 entry point alone", lambda: lib_.nfl_hwt_fixed(*args5)),
            ("S6 entry point alone", lambda: lib_.nfl_hwt_exact(*args6)),
            ("S5 wrapper", lambda: s5(KEY, 5, p, n, H, dtype)),
            ("S6 wrapper", lambda: s6(KEY, 5, p, n, H, dtype)),
            ("device_hwt", lambda: dsamp.device_hwt(ring, KEY, 5, md, dev)),
            ("device_hwt_exact", lambda: dsamp.device_hwt_exact(
                ring, KEY, 5, md, device=dev)))
        print(f"host us a call, {limb} (median of 5 runs of {HOST_CALLS} "
              "calls back to back): " + ", ".join(
                  f"{name} {statistics.median(per(fn) for _ in range(5)):.2f}"
                  for name, fn in steps) + f" | {card}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
