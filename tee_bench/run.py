#!/usr/bin/env python3
"""The confidential-serving benchmark of the PyTorch port, one run of one
cell on the card it is started on:

    python3 tee_bench/run.py --workload ds7b-chat --seed 7 --seconds 45 \
        --trace 0

It reads ``BENCHMARK.json`` at the checkout's root and the cell's files
under ``tee_bench/``, makes weights and traffic from ``--seed``, serves
them through ``repro_torch`` (sealed weights, attestation, the paged KV
cache with the B3 decode kernel, encrypted egress frames), measures the
window, checks the served tokens against the plain reference, and prints
one JSON result as the last line of standard output. ``--trace 1``
reports the cell's per-layer metrics from a profiler trace of a steady
stretch of the window instead of its end-to-end metrics. Without a CUDA
card (or with fewer than the cell needs) it exits 2 and prints no result;
if the process holds JAX or the JAX package once everything else is done,
it names them and exits 3 with no result.

``--control fp8`` (not one of the benchmark's runs) judges the fp8
control's first choices in the served tokens' place: a sound comparison
reads ``correct`` false.
"""

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT / "src"))
# every build and kernel cache lives at a fixed place inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    args = ap.parse_args(argv)

    import torch
    from teebench import runner, spec

    bench = spec.benchmark(ROOT)
    need = spec.workload(bench, args.workload)["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"{args.workload} needs {need} CUDA card(s); this machine has "
              f"{have}. No result.", file=sys.stderr)
        return 2
    result = runner.run_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda:0",
                             t_process0=T_PROCESS0,
                             control=args.control is not None)
    found = runner.forbidden_modules()
    if found:
        print(f"the process holds JAX or the JAX package: {found}. "
              f"No result.", file=sys.stderr)
        return 3
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
