#!/bin/sh
# The port's measuring scripts on one card, in fresh processes, from the
# root of a checkout:
#
#     sh tools/chip_bench_scripts.sh [OUT_DIR]
#
# 1. first calls: bench_torch.py at u32 2^14 x 17 x 64 and at u64 2^20 x 2
#    x 2, each with the kernels' build directory emptied (cold: nvcc
#    builds the library), then again (warm: it loads it);
# 2. bench_torch.py at u32 2^14 x 17 x 64, u64 2^14 x 8 x 64 and u64 2^20
#    x 2 x 2, forward and inverse, in auto, fused and butterfly modes (K7
#    stops at u64 2^16: there auto runs the route, and butterfly mode the
#    plain transform, E1 for its twist);
# 3. tools/bench_ops_torch.py over the 5-point matrix in each mode (csv);
# 4. tools/prng_bench_torch.py with each sampler at its default size.
# Each command's stdout and stderr go to OUT_DIR (default
# chiprun_out/bench_scripts), one file each; a failing command is noted and
# the rest still run; the exit code is the number of failures.
out=${1:-chiprun_out/bench_scripts}
mkdir -p "$out"
fails=0

run() {   # run NAME COMMAND...: COMMAND's output to OUT_DIR/NAME.{out,err}
    name=$1
    shift
    echo "== $name: $*"
    if ! "$@" > "$out/$name.out" 2> "$out/$name.err"; then
        echo "FAILED: $name"
        fails=$((fails + 1))
    fi
    cat "$out/$name.err" "$out/$name.out"
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
u64large="--limb u64 --degree 1048576 --nmoduli 2 --batch 2"
u64main="--limb u64 --degree 16384 --nmoduli 8 --batch 64"

rm -rf nfllib_tpu_torch/_build
run first_u32_cold python3 bench_torch.py
run first_u32_warm python3 bench_torch.py
rm -rf nfllib_tpu_torch/_build
run first_u64_2p20_cold python3 bench_torch.py $u64large
run first_u64_2p20_warm python3 bench_torch.py $u64large

for mode in auto fused butterfly; do
    run "ntt_u32_$mode" python3 bench_torch.py --mode $mode
    run "intt_u32_$mode" python3 bench_torch.py --mode $mode --inverse
    run "ntt_u64_$mode" python3 bench_torch.py --mode $mode $u64main
    run "intt_u64_$mode" python3 bench_torch.py --mode $mode --inverse $u64main
    run "ntt_u64_2p20_$mode" python3 bench_torch.py --mode $mode $u64large
    run "intt_u64_2p20_$mode" python3 bench_torch.py --mode $mode --inverse \
        $u64large
    run "bench_ops_$mode" python3 tools/bench_ops_torch.py --mode $mode --csv
done
for sampler in host device device_exact; do
    run "prng_$sampler" python3 tools/prng_bench_torch.py --sampler $sampler
done
echo "failures: $fails"
exit $fails
