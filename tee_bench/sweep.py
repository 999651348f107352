#!/usr/bin/env python3
"""The knee sweep behind an open-loop cell's fixed rate, in one process:
the weights are made, sealed and unsealed once, then every rate runs on a
fresh engine (warm-up, pre-roll, window) and prints one JSON line.

    python3 tee_bench/sweep.py --workload ds7b-chat --seed 11 \
        --rates 2,3,4,5 --seconds 30

The knee is the highest rate whose queue stays flat (nothing left waiting
at the window's close beyond what one step admits) and whose tokens per
second still follow the offered load. The cell's rate is about four
fifths of it. Runs on the card; not one of the benchmark's runs.
"""

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    import torch
    from teebench import runner, spec
    from teebench.program import System
    if not torch.cuda.is_available():
        print("the sweep runs on a CUDA card", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    cell, cfg, mix = (spec.cell(args.workload), spec.config(w["config"]),
                      spec.traffic(w["traffic"]))
    system = System(cfg, cell, args.seed, device="cuda:0")
    print(json.dumps({"setup": system.timings}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        system.new_engine()
        t0 = time.perf_counter()
        run = runner.serve(system, cfg, cell, mix, args.seed, args.seconds,
                           traced=False, t_process0=t0, rate=rate)
        out = runner.info(run)
        out.pop("timings_s")
        out["rate_per_s"] = rate
        out["output_tok_s"] = spec.reader("output_tok_s")(run)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
