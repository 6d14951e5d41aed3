"""The benchmark of nfllib_tpu_torch, the PyTorch / CUDA port, on one card.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once and prints its result as the last line
of standard output.  README.md in this folder says how a cell, a mix, a
configuration and a per-layer metric are added as files.
"""
import time

# process start as the harness sees it: setup_s counts from here
T0 = time.perf_counter()
