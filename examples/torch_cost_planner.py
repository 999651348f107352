"""Deployment cost planner on the PyTorch port's cost model (paper Figs
12-13 as a tool): given a workload, rank confidential deployment options
by $/Mtoken and show the CPU/GPU crossover for your batch size.

    PYTHONPATH=src python examples/torch_cost_planner.py --params 7e9 --batch 4
"""

import argparse
import dataclasses

from repro_torch.costs.model import (Workload, best_cpu_cost, crossover_batch,
                               tokens_per_second, usd_per_mtok)
from repro_torch.costs.pricing import SKUS


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", type=float, default=6.7e9)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--in-tokens", type=int, default=128)
    ap.add_argument("--confidential-only", action="store_true", default=True)
    args = ap.parse_args()

    w = Workload(n_params=args.params, batch=args.batch,
                 in_tokens=args.in_tokens, out_tokens=128)

    print(f"workload: {args.params / 1e9:.1f}B params, batch {args.batch}, "
          f"{args.in_tokens} input tokens\n")
    options = []
    for name, sku in SKUS.items():
        if args.confidential_only and sku.tee_mode is None:
            continue
        cost = (best_cpu_cost(w, name) if sku.kind == "cpu"
                else usd_per_mtok(w, name))
        tps = tokens_per_second(w, sku, 32 if sku.kind == "cpu" else None)
        options.append((cost, name, tps, sku))
    options.sort()
    print(f"{'rank':4s} {'sku':14s} {'$/Mtok':>9s} {'tok/s':>10s}  security notes")
    for i, (cost, name, tps, sku) in enumerate(options):
        print(f"{i + 1:4d} {name:14s} {cost:9.2f} {tps:10.1f}  "
              f"tee={sku.tee_mode}")
    x = crossover_batch(dataclasses.replace(w, batch=1), "emr-amx-tdx",
                        "h100-cc", [1, 2, 4, 8, 16, 32, 64, 128, 256, 512])
    print(f"\nCPU-TEE -> cGPU crossover batch for this model: {x} "
          f"(paper reports ~128 for Llama2-7B)")
    print("recommendation:", options[0][1])


if __name__ == "__main__":
    main()
