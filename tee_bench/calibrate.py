#!/usr/bin/env python3
"""The readings a cell's correctness limit is set from, in one process on
the card: for each seed, the cell's traffic served at its own load for a
short window and the program's widest logit gap over the same sample a
run compares, judged as a run judges it; for the control seeds also the
fp8 control's gap on the same sequences, judged in the served tokens'
place (``control_correct``, false where the limit separates them). One
JSON line a seed.

    python3 tee_bench/calibrate.py --workload ds7b-chat \
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control-seeds 1,2,3 \
        --seconds 20

Sealing is the same bit-exact round trip every run makes; to spend the
card's time on seeds, only the first seed seals and unseals, and it checks
the unsealed weights equal the plaintext bit for bit; the others serve
the weights as made. Not one of the benchmark's runs.
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


def unsealed_equal(system, cfg, seed) -> bool:
    """Every unsealed leaf against the leaf made again from the seed."""
    import torch
    from repro_torch.core.sealing import tree_leaves_with_names
    from teebench.program import blocks_of, make_leaf
    blocks = blocks_of(system.params)
    for path, leaf in tree_leaves_with_names(system.params):
        want = make_leaf(cfg, seed, path, blocks, device=leaf.device)
        if not torch.equal(want.view(torch.uint8), leaf.view(torch.uint8)):
            return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    import torch
    from teebench import check, runner, spec
    from teebench.program import System
    if not torch.cuda.is_available():
        print("calibration runs on a CUDA card", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    cell, cfg, mix = (spec.cell(args.workload), spec.config(w["config"]),
                      spec.traffic(w["traffic"]))
    reference = spec.reference(cfg)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        system = System(cfg, cell, seed, device="cuda:0", seal=i == 0)
        exact = unsealed_equal(system, cfg, seed) if i == 0 else None
        run = runner.serve(system, cfg, cell, mix, seed, args.seconds,
                           traced=False, t_process0=t0)
        system.close()
        del system
        chk = cell["check"]
        picked = check.sample(run.records, seed, chk["min_tokens"],
                              chk["min_requests"], chk["max_requests"],
                              run.t_end)
        out = check.compare(reference, cfg, seed, picked, device="cuda:0",
                            control=seed in controls)
        failed = sum(1 for r in run.records if r.failed)
        for key in ("max_logit_gap", "control_max_logit_gap"):
            if key in out:
                judged = runner.judge(out, chk, failed, gap_key=key)
                out["correct" if key == "max_logit_gap"
                    else "control_correct"] = all(
                        c["ok"] for c in judged.values())
        out.update(seed=seed, unsealed_bit_exact=exact, failed=failed,
                   seconds_total=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
