"""Render roofline result JSONs as markdown tables (port of
``repro.roofline.report``).

    PYTHONPATH=src python -m repro_torch.roofline.report results.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.core import overheads


def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.1f}"


def table(path: str) -> str:
    recs = json.loads(Path(path).read_text())
    out = ["| arch | shape | bound | compute_s | memory_s | collective_s | "
           "roofline_frac | bw_frac | useful_FLOPs | HBM GiB/dev | fits |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | SKIP — {r['reason']} "
                       "| | | | | | | | |")
            continue
        step = max(r["compute_s"], r["memory_s"], r["collective_s"])
        bw_frac = r.get("bw_fraction") or (r["arg_bytes"]
                                           / overheads.HBM_BYTES_PER_S / step
                                           if step else 0.0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['bound']} "
            f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} "
            f"| {r['collective_s']:.3f} | {r['roofline_fraction']:.3f} "
            f"| {bw_frac:.3f} | {r['useful_flops_ratio']:.2f} "
            f"| {fmt_bytes(r['hbm_bytes_per_dev'])} "
            f"| {'Y' if r['fits_hbm'] else 'N'} |")
    return "\n".join(out)


def perf_table(path: str) -> str:
    recs = json.loads(Path(path).read_text())
    out = ["| cell | variant | bound | compute_s | memory_s | collective_s | "
           "temp GiB | fits | useful |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        out.append(
            f"| {r['arch']} x {r['shape']} | {r.get('variant', '?')} "
            f"| {r['bound']} | {r['compute_s']:.3f} | {r['memory_s']:.3f} "
            f"| {r['collective_s']:.3f} | {r['temp_bytes'] / 2**30:.1f} "
            f"| {'Y' if r['fits_hbm'] else 'N'} "
            f"| {r['useful_flops_ratio']:.2f} |")
    return "\n".join(out)


if __name__ == "__main__":
    for p in sys.argv[1:]:
        print(f"### {p}\n")
        print(perf_table(p) if "perf" in p else table(p))
        print()
