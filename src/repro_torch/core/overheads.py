"""Calibrated TEE overhead model — the paper's measurements as an analytical
performance model over roofline terms.

Each TEE profile decomposes the paper's measured overheads into where they
land on the roofline (DESIGN.md §1):

    t_plain = t_compute + t_memory + t_collective
    t_tee   = t_compute * (1 + compute_tax)
            + t_memory  * (1 + mem_tax)
            + t_coll    * (1 + link_tax)
            + fixed_boundary_s                      (per step)
    overhead = t_tee / t_plain - 1

Calibration targets (from the paper, Llama2-7B on EMR unless noted):
  * TDX single-socket: 5.51–10.68% thr overhead, memory-encryption dominated
    (Fig 4); virtualization tax alone 1.82–5.38% (VM row).
  * SGX: 4.80–6.15% (Fig 4); multi-socket up to 230% (broken NUMA, Fig 5/6 —
    exposed as `numa_broken_tax`).
  * TDX 2-socket: 12.11–23.81% (encrypted UPI + no NUMA binding, Fig 6).
  * Hugepage loss: 3.19–5.20% of raw perf (Insight 7).
  * cGPU (H100): 4.4–8% shrinking with batch/input (Fig 11) — dominated by a
    fixed per-launch bounce-buffer + kernel-launch cost, not memory (HBM is
    NOT encrypted on H100, §V-A).
  * cGPU scale-out: host-routed transfers cap at 3 GB/s vs 40 GB/s RDMA
    (§V-D4) -> link_tax ≈ 12.3.
  * AMX (Insight 8): raises compute share => relative overhead drops; that
    falls out of the model because mem_tax applies to a smaller fraction.

The model reproduces the *paper's* platforms; the `tpu_cc` profile is our
forward-looking TPU estimate (B100-style: HBM + ICI encryption on by
default), used for the confidential roofline in EXPERIMENTS.md.

Port note: ``measured_link_tax``, ``fused_unseal_savings`` and
``store_restore_savings`` price from the reference package's TPU roofline
constants and serve mesh, paged and page-store paths this package does not
have yet (ROADMAP.md queue A, items 10, 11, 18 and 19); they are not copied.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-step times in seconds (from the dry-run roofline extraction)."""
    compute_s: float
    memory_s: float
    collective_s: float = 0.0

    @property
    def total_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def bound(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)


@dataclasses.dataclass(frozen=True)
class TEEProfile:
    name: str
    compute_tax: float          # TEEs do not slow ALUs; virt tax lands here
    mem_tax: float              # inline memory encryption bandwidth tax
    link_tax: float             # encrypted / host-routed interconnect tax
    fixed_boundary_s: float     # per-step enclave exit / bounce / launch cost
    numa_broken_tax: float = 0.0   # extra mem tax if placement is TEE-default
    hugepage_loss: float = 0.0     # extra mem tax (TDX ignores 1G pages)
    notes: str = ""


PROFILES: Dict[str, TEEProfile] = {
    # virtualization only (the paper's "VM" rows): 1.82-5.38%
    "vm": TEEProfile("vm", compute_tax=0.03, mem_tax=0.03, link_tax=0.03,
                     fixed_boundary_s=0.0,
                     notes="raw VM; virtualization tax only (Fig 4)"),
    # Gramine-SGX: 4.80-6.15% single socket; catastrophic multi-socket
    "sgx": TEEProfile("sgx", compute_tax=0.005, mem_tax=0.085, link_tax=0.10,
                      fixed_boundary_s=8e-5, numa_broken_tax=2.2,
                      notes="EPC paging+enclave exits; no NUMA support (230% 2-socket)"),
    # TDX: 5.51-10.68% single socket; 12.11-23.81% two sockets
    "tdx": TEEProfile("tdx", compute_tax=0.03, mem_tax=0.11, link_tax=0.16,
                      fixed_boundary_s=4e-5, numa_broken_tax=0.35,
                      hugepage_loss=0.042,
                      notes="virt tax + memcrypt + encrypted UPI + no 1G pages"),
    # H100 confidential GPU: 4.4-8%, fixed-cost dominated; HBM unencrypted.
    # link_tax provenance (Insight 12, §V-D4): with CC on, multi-GPU traffic
    # cannot use direct RDMA and is host-routed through encrypted bounce
    # buffers, capping at ~3 GB/s against ~40 GB/s plain — the same bytes
    # take 40/3 ≈ 13.3x longer, i.e. a tax of 40/3 - 1 ≈ 12.3 on whatever
    # time the collectives already cost. That collective time is the one
    # input ``predict`` will happily take *measured* (its ``collective_s``
    # override, fed from ChannelStats on a mesh-spanning engine) instead of
    # from the closed-form roofline estimate.
    "cgpu": TEEProfile("cgpu", compute_tax=0.0, mem_tax=0.0, link_tax=12.3,
                       fixed_boundary_s=3.5e-4,
                       notes="PCIe bounce buffer + launch latency; "
                             "host-routed scale-out 3 vs 40 GB/s (§V-D4)"),
    # forward-looking TPU confidential profile (B100-style full encryption)
    "tpu_cc": TEEProfile("tpu_cc", compute_tax=0.0, mem_tax=0.08, link_tax=0.15,
                         fixed_boundary_s=2e-5,
                         notes="hypothetical: HBM + ICI inline encryption, "
                               "DMA bounce for DCN"),
}


@dataclasses.dataclass(frozen=True)
class OverheadBreakdown:
    profile: str
    t_plain_s: float
    t_tee_s: float
    overhead: float
    per_term: Dict[str, float]

    def as_row(self) -> str:
        parts = ", ".join(f"{k}:{v * 100:.2f}%" for k, v in self.per_term.items())
        return (f"{self.profile}: {self.overhead * 100:.2f}% "
                f"({self.t_plain_s * 1e3:.3f} -> {self.t_tee_s * 1e3:.3f} ms; {parts})")


def predict(terms: RooflineTerms, profile: str | TEEProfile,
            *, numa_bound: bool = True, hugepages_fixed: bool = True,
            steps: int = 1,
            collective_s: Optional[float] = None) -> OverheadBreakdown:
    """TEE overhead for one step given plain roofline terms.

    ``numa_bound=False`` models the paper's broken-NUMA deployments (Fig 5/6);
    ``hugepages_fixed=False`` adds the TDX hugepage loss (Insight 7).

    ``collective_s`` overrides ``terms.collective_s`` with a *measured*
    per-step collective time — e.g. ``ChannelStats.collective_s_per_step``
    from a mesh-spanning engine, where the time comes from a real all-gather
    on the serving mesh rather than the bytes/ICI_BW closed form. link_tax
    then prices the encrypted interconnect from observation: the cgpu value
    of 12.3 is Insight 12's host-routed 3-vs-40 GB/s ratio (see PROFILES),
    and applying it to a measured baseline is exactly the §V-D4 experiment.
    """
    p = PROFILES[profile] if isinstance(profile, str) else profile
    if collective_s is not None:
        terms = dataclasses.replace(terms, collective_s=float(collective_s))
    mem_tax = p.mem_tax
    if not numa_bound:
        mem_tax += p.numa_broken_tax
    if not hugepages_fixed:
        mem_tax += p.hugepage_loss
    d_comp = terms.compute_s * p.compute_tax
    d_mem = terms.memory_s * mem_tax
    d_coll = terms.collective_s * p.link_tax
    d_fixed = p.fixed_boundary_s * steps
    t_plain = terms.total_s * steps
    t_tee = t_plain + (d_comp + d_mem + d_coll) * steps + d_fixed
    # per_term fractions are normalized by t_plain (not by the delta), so
    # they intentionally sum to `overhead` — each entry reads directly as
    # "percentage points of slowdown attributable to this term".
    per_term = {
        "compute": d_comp * steps / t_plain,
        "memory": d_mem * steps / t_plain,
        "collective": d_coll * steps / t_plain,
        "boundary": d_fixed / t_plain,
    }
    return OverheadBreakdown(p.name, t_plain, t_tee, t_tee / t_plain - 1.0, per_term)


# how an observed decode-step latency is apportioned between roofline terms
# when no per-term measurement exists (launchers' standing estimate for a
# decode-bound serving point: mostly memory, some compute, the remainder
# collective/boundary). One definition: serve.py's modeled-overhead block
# prices from this split.
STEP_COMPUTE_FRACTION = 0.3
STEP_MEMORY_FRACTION = 0.65


def sweep_batch(profile: str, compute_per_token_s: float, memory_s: float,
                batches: list[int]) -> Dict[int, float]:
    """Paper Fig 9/11 shape: overhead vs batch size. Compute scales with
    batch; weight-streaming memory time is ~flat until saturation."""
    out = {}
    for b in batches:
        terms = RooflineTerms(compute_s=compute_per_token_s * b, memory_s=memory_s)
        out[b] = predict(terms, profile).overhead
    return out
