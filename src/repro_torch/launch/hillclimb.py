"""Hill-climbing launcher (port of ``repro.launch.hillclimb``): dry-run a cell
under a named optimization variant and record its roofline, to compare
with the baseline's.

    python -m repro_torch.launch.hillclimb --arch deepseek-7b \\
        --shape decode_32k --variant baseline \\
        --out results/torch_perf_iterations.json

Variants are the reference's ``ParallelConfig`` overrides, name for name.
Two of them are choices of the reference's ``lax.scan`` that eager torch
does not have: ``decode_cache_carry`` (the decode cache as a scan carry)
and ``scan_layers``. The port's decode step always writes the cache in
place, and its layers are always a Python loop, so a variant that sets
only those (``cache-carry``) gives the baseline's numbers. ``remat:
dots_saveable`` is ``transformer.remat``'s policy that keeps the matmul
outputs for the backward pass.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import lower_cell

# name -> dict of ParallelConfig field overrides
VARIANTS = {
    "baseline": {},
    "attn-chunk": {"attention_chunk": 512},
    "loss-chunk": {"loss_chunk": 512},
    "attn+loss-chunk": {"attention_chunk": 512, "loss_chunk": 512},
    "attn+loss-chunk+mb8": {"attention_chunk": 512, "loss_chunk": 512,
                            "microbatches": 8},
    "attn+loss-chunk+mb4": {"attention_chunk": 512, "loss_chunk": 512,
                            "microbatches": 4},
    "remat-dots": {"remat": "dots_saveable"},
    "attn+loss-chunk+remat-dots": {"attention_chunk": 512, "loss_chunk": 512,
                                   "remat": "dots_saveable"},
    "attn+loss-chunk+mb8+remat-dots": {"attention_chunk": 512,
                                       "loss_chunk": 512, "microbatches": 8,
                                       "remat": "dots_saveable"},
    "dp-over-model": {"dp_over_model": True, "fsdp": True},
    "dp-over-model+loss-chunk": {"dp_over_model": True, "fsdp": True,
                                 "loss_chunk": 512},
    "dp-over-model+loss-chunk+mb4": {"dp_over_model": True, "fsdp": True,
                                     "loss_chunk": 512, "microbatches": 4},
    "opt-bf16": {"optimizer_dtype": "bfloat16"},
    "cache-carry": {"decode_cache_carry": True},
    "dp-over-model+zero1+loss-chunk": {"dp_over_model": True, "zero1": True,
                                       "loss_chunk": 512},
}


def run(arch: str, shape: str, variant: str, multi_pod: bool = False,
        device="cuda"):
    cfg = get_config(arch)
    overrides = VARIANTS[variant]
    cfg = dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, **overrides))
    cell = lower_cell(arch, shape, multi_pod=multi_pod, cfg_override=cfg,
                      device=device)
    rec = cell if isinstance(cell, dict) else cell.to_dict()
    rec["variant"] = variant
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/torch_perf_iterations.json")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors name (nothing is "
                         "allocated; no card is needed)")
    args = ap.parse_args(argv)

    rec = run(args.arch, args.shape, args.variant, args.multi_pod,
              args.device)
    out = Path(args.out)
    results = json.loads(out.read_text()) if out.exists() else []
    results = [r for r in results
               if not (r["arch"] == rec["arch"] and r["shape"] == rec["shape"]
                       and r.get("variant") == rec["variant"])]
    results.append(rec)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
