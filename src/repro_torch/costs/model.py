"""$/Mtoken cost model (port of ``repro.costs.model``): the paper's Figs
12-13 crossover analysis, over every SKU of the catalog (TPU v5e rows
included).

Mechanics (paper §V-D2):
  * a workload = (model params, batch, in/out tokens, dtype bytes);
  * per-step time from the two-term roofline of the SKU (compute vs weight
    streaming), plus the TEE overhead model when the SKU is TEE-enabled;
  * CPU SKUs scale compute with vCPU count until memory-bound (Fig 12's
    32-core plateau); cost = hourly price / tokens-per-hour.

Validated against the paper's qualitative claims:
  * CPU TEE cost advantage at small batch fades and crosses over around
    batch ~128 (Fig 12);
  * doubling input size erodes CPU advantage faster than batch (Fig 13,
    quadratic attention);
  * throughput plateaus at ~32 cores (memory-bound; Insight: resource eff.).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import overheads
from repro_torch.costs.pricing import SKUS, HardwareSKU, cpu_hourly_cost


@dataclasses.dataclass(frozen=True)
class Workload:
    n_params: float
    batch: int
    in_tokens: int
    out_tokens: int
    bytes_per_param: float = 2.0   # bf16
    d_model: int = 4096
    n_layers: int = 32

    @property
    def kv_bytes_per_token(self) -> float:
        return 2 * self.n_layers * self.d_model * self.bytes_per_param


def step_terms(w: Workload, sku: HardwareSKU, vcpus: Optional[int] = None
               ) -> overheads.RooflineTerms:
    """Roofline terms for ONE decode step over the whole batch."""
    flops = 2 * w.n_params * w.batch
    # attention read: KV cache of current length (use in_tokens as proxy)
    attn_bytes = w.batch * w.in_tokens * w.kv_bytes_per_token
    weight_bytes = w.n_params * w.bytes_per_param  # streamed once per step
    peak = sku.peak_flops
    if sku.kind == "cpu" and vcpus is not None:
        peak = sku.peak_flops * min(vcpus, 64) / 64.0
    compute_s = flops / peak
    memory_s = (weight_bytes + attn_bytes) / (sku.mem_bw * sku.bw_derate)
    return overheads.RooflineTerms(compute_s=compute_s, memory_s=memory_s)


def tokens_per_second(w: Workload, sku: HardwareSKU,
                      vcpus: Optional[int] = None) -> float:
    terms = step_terms(w, sku, vcpus)
    step_s = max(terms.compute_s, terms.memory_s) + sku.step_overhead_s
    if sku.tee_mode:
        ov = overheads.predict(terms, sku.tee_mode).overhead
        step_s *= (1 + ov)
    return w.batch / step_s


def usd_per_mtok(w: Workload, sku_name: str, vcpus: int = 32,
                 mem_gb: float = 128.0) -> float:
    sku = SKUS[sku_name]
    tps = tokens_per_second(w, sku, vcpus if sku.kind == "cpu" else None)
    hourly = (cpu_hourly_cost(sku, vcpus, mem_gb) if sku.kind == "cpu"
              else sku.usd_per_hour)
    return hourly / (tps * 3600.0) * 1e6


def vcpu_sweep(w: Workload, sku_name: str, vcpu_counts: List[int],
               mem_gb: float = 128.0) -> Dict[int, Dict[str, float]]:
    """Fig 12 rows: throughput + $/Mtok across machine sizes."""
    out = {}
    for v in vcpu_counts:
        sku = SKUS[sku_name]
        tps = tokens_per_second(w, sku, v)
        out[v] = {"tokens_per_s": tps,
                  "usd_per_mtok": usd_per_mtok(w, sku_name, v, mem_gb)}
    return out


def best_cpu_cost(w: Workload, cpu_sku: str,
                  vcpu_grid=(4, 8, 16, 32, 64), mem_gb: float = 128.0) -> float:
    """The paper compares against the best CPU machine size per workload
    (Fig 12 picks the cost-optimal vCPU count)."""
    return min(usd_per_mtok(w, cpu_sku, v, mem_gb) for v in vcpu_grid)


def crossover_batch(w_base: Workload, cpu_sku: str, gpu_sku: str,
                    batches: List[int]) -> Optional[int]:
    """Smallest batch where the GPU's $/Mtok <= the best CPU config's
    (Fig 12's orange line)."""
    for b in batches:
        w = dataclasses.replace(w_base, batch=b)
        if usd_per_mtok(w, gpu_sku) <= best_cpu_cost(w, cpu_sku):
            return b
    return None
