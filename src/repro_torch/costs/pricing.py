"""Hardware & pricing catalog for the cost model (paper §V-D2, Figs 12-13),
a copy of ``repro.costs.pricing``: the catalog is data, the reference's
price model row for row.

CPU prices follow the paper's GCP spot methodology (per-vCPU + per-GB
pricing, US East 1); GPU/TPU prices are representative on-demand cloud
rates. All $ figures are parameters, not facts about today's market — the
cost *model* (crossover structure) is the contribution being reproduced.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HardwareSKU:
    name: str
    kind: str                      # "cpu" | "gpu" | "tpu"
    peak_flops: float              # bf16/int8-effective FLOP/s
    mem_bw: float                  # bytes/s
    mem_bytes: float
    usd_per_hour: float            # base (cGPU/TPU: whole accelerator)
    usd_per_vcpu_hour: float = 0.0 # CPU: per-core component
    usd_per_gb_hour: float = 0.0   # CPU: per-GB memory component
    tee_mode: Optional[str] = None # overheads.PROFILES key when TEE-enabled
    step_overhead_s: float = 0.0   # per-step floor (kernel launch/framework)
    bw_derate: float = 1.0         # achieved/peak decode bandwidth (measured
                                   # serving stacks run well below HBM roofline)
    notes: str = ""


SKUS: Dict[str, HardwareSKU] = {
    # Emerald Rapids with AMX (paper's EMR2, per-core GCP spot pricing model)
    "emr-amx": HardwareSKU(
        "emr-amx", "cpu",
        peak_flops=4.1e12,        # ~64 GFLOP/s/core bf16 AMX x 64 cores
        mem_bw=307e9, mem_bytes=512e9,
        usd_per_hour=0.0, usd_per_vcpu_hour=0.011, usd_per_gb_hour=0.0015,
        notes="AMX bf16; paper Fig 12 pricing shape"),
    "emr-amx-tdx": HardwareSKU(
        "emr-amx-tdx", "cpu",
        peak_flops=4.1e12, mem_bw=307e9, mem_bytes=512e9,
        usd_per_hour=0.0, usd_per_vcpu_hour=0.011, usd_per_gb_hour=0.0015,
        tee_mode="tdx", notes="same SKU, TDX enabled"),
    # Sapphire Rapids alternative (paper: ~2x cheaper, up to 40% slower)
    "spr-amx": HardwareSKU(
        "spr-amx", "cpu",
        peak_flops=2.6e12, mem_bw=250e9, mem_bytes=512e9,
        usd_per_hour=0.0, usd_per_vcpu_hour=0.006, usd_per_gb_hour=0.0009),
    # H100 NVL (the paper's ~$30k card; Azure NCCads rates)
    "h100": HardwareSKU(
        "h100", "gpu", peak_flops=990e12, mem_bw=3.9e12, mem_bytes=94e9,
        usd_per_hour=6.98, step_overhead_s=1.0e-3, bw_derate=0.30,
        notes="launch+framework floor per decode step"),
    "h100-cc": HardwareSKU(
        "h100-cc", "gpu", peak_flops=990e12, mem_bw=3.9e12, mem_bytes=94e9,
        usd_per_hour=6.98, tee_mode="cgpu", step_overhead_s=1.0e-3, bw_derate=0.30),
    # TPU v5e and a forward-looking confidential variant: catalog rows the
    # cost model prices, not a platform the port runs on
    "v5e": HardwareSKU(
        "v5e", "tpu", peak_flops=197e12, mem_bw=819e9, mem_bytes=16e9,
        usd_per_hour=1.20, step_overhead_s=3e-4, bw_derate=0.45),
    "v5e-cc": HardwareSKU(
        "v5e-cc", "tpu", peak_flops=197e12, mem_bw=819e9, mem_bytes=16e9,
        usd_per_hour=1.20, tee_mode="tpu_cc", step_overhead_s=3e-4, bw_derate=0.45),
}


def cpu_hourly_cost(sku: HardwareSKU, vcpus: int, mem_gb: float) -> float:
    return sku.usd_per_hour + vcpus * sku.usd_per_vcpu_hour + mem_gb * sku.usd_per_gb_hour
