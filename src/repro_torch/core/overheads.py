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

Port note: ``fused_unseal_savings`` and ``store_restore_savings`` price
device-memory traffic at the H100's rate, :data:`HBM_BYTES_PER_S`, and
``measured_link_tax`` prices its closed-form collective term at the H100's
link rate, :data:`LINK_BYTES_PER_S`, each read when the function is called,
where the reference used its TPU roofline constants; with those constants
set to the reference's rates they return the reference's floats.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# H100 SXM device-memory rate (NVIDIA data sheet), the card the port runs on
HBM_BYTES_PER_S = 3.35e12
# H100 SXM NVLink 4 bandwidth (NVIDIA H100 data sheet: 900 GB/s a GPU, the
# sum over its 18 links in both directions)
LINK_BYTES_PER_S = 900e9


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
# and measured_link_tax price from this split.
STEP_COMPUTE_FRACTION = 0.3
STEP_MEMORY_FRACTION = 0.65


def measured_link_tax(channel_stats, profile: str, step_s: float,
                      measures: Optional[str] = None
                      ) -> "tuple[OverheadBreakdown, OverheadBreakdown, str]":
    """Measured-vs-modeled link-tax comparison for a mesh engine.

    ``channel_stats`` is a :class:`~repro_torch.core.bounce.ChannelStats`
    (duck-typed): its ``collective_bytes``/``collective_steps`` give the
    per-step gather volume, priced once through the closed-form estimate
    (bytes / :data:`LINK_BYTES_PER_S`) and once through the *measured*
    per-step collective time (``collective_s_per_step``, the plan's timed
    gathers). ``step_s`` is the observed decode-step latency the
    compute/memory terms are apportioned from (the launcher's standing
    0.3/0.65 split). ``measures`` says what the collective time measured
    (a mesh plan's ``collective_measures``: on logical shards a copy or sum
    in device memory, over ranks sharing one card gloo through host memory,
    over NCCL the link); the line ends with it. Returns (modeled,
    measured, report line)."""
    steps = max(channel_stats.collective_steps, 1)
    per_step_b = channel_stats.collective_bytes // steps
    modeled_s = per_step_b / LINK_BYTES_PER_S
    measured_s = channel_stats.collective_s_per_step
    terms = RooflineTerms(compute_s=STEP_COMPUTE_FRACTION * step_s,
                          memory_s=STEP_MEMORY_FRACTION * step_s,
                          collective_s=modeled_s)
    modeled = predict(terms, profile)
    measured = predict(terms, profile, collective_s=measured_s)
    line = (f"{per_step_b} collective B/step over "
            f"{channel_stats.collective_steps} steps; collective_s modeled "
            f"{modeled_s * 1e6:.1f}us vs measured {measured_s * 1e6:.1f}us "
            f"-> TEE overhead {modeled.overhead * 100:.2f}% vs "
            f"{measured.overhead * 100:.2f}% "
            f"(delta {(measured.overhead - modeled.overhead) * 100:+.2f} pts)")
    if measures is not None:
        line += f" [measured: {measures}]"
    return modeled, measured, line


def sweep_batch(profile: str, compute_per_token_s: float, memory_s: float,
                batches: list[int]) -> Dict[int, float]:
    """Paper Fig 9/11 shape: overhead vs batch size. Compute scales with
    batch; weight-streaming memory time is ~flat until saturation."""
    out = {}
    for b in batches:
        terms = RooflineTerms(compute_s=compute_per_token_s * b, memory_s=memory_s)
        out[b] = predict(terms, profile).overhead
    return out


# standing per-token prefill compute estimate for the store pricer when the
# caller has no measurement (seconds per prompt token); benches override it
# with (cold prefill wall / tokens). One definition: serve.py and the
# retention policy price recompute from the same constant.
PREFILL_TOKEN_COMPUTE_S = 2e-5


def store_restore_savings(pages: int, stored_bytes: int, tokens: int,
                          profile: str | TEEProfile,
                          *, prefill_token_s: Optional[float] = None
                          ) -> "tuple[Optional[OverheadBreakdown], Optional[OverheadBreakdown], str]":
    """Price a sealed-page-store hit both ways: restore vs recompute.

    A store hit moves ``stored_bytes`` of content-named ciphertext back
    across the TEE boundary (one boundary event per page, a decrypt pass
    through device memory) instead of re-running the prefill that produced
    those ``tokens`` positions. Both sides are priced through
    :func:`predict`:

    * restore: a page-sized memory term per page (``steps=pages``, so
      ``fixed_boundary_s`` lands once per restored page, as in
      :func:`fused_unseal_savings`), zero compute;
    * recompute: ``tokens * prefill_token_s`` of compute plus the single
      KV write-out the prefill performs.

    Returns (restore, recompute, report line); (None, None, line) when
    nothing was restored. The retention policy's cost score and the
    launcher's report line both come from here."""
    if pages <= 0 or stored_bytes <= 0:
        return None, None, ("store restore-vs-recompute: none "
                            "(no store-restored pages)")
    per_tok = PREFILL_TOKEN_COMPUTE_S if prefill_token_s is None \
        else float(prefill_token_s)
    per_page = stored_bytes / pages
    restore = predict(RooflineTerms(compute_s=0.0,
                                    memory_s=2 * per_page / HBM_BYTES_PER_S),
                      profile, steps=pages)
    recompute = predict(RooflineTerms(compute_s=per_tok * tokens,
                                      memory_s=stored_bytes / HBM_BYTES_PER_S),
                        profile)
    net = recompute.t_tee_s - restore.t_tee_s
    verdict = "store wins" if net > 0 else "recompute wins"
    line = (f"store restore-vs-recompute ({restore.profile}): {pages} pages / "
            f"{stored_bytes} B sealed across the boundary vs {tokens} prefill "
            f"tokens recomputed -> restore {restore.t_tee_s * 1e6:.1f}us vs "
            f"recompute {recompute.t_tee_s * 1e6:.1f}us "
            f"({verdict}, net {abs(net) * 1e6:.1f}us)")
    return restore, recompute, line


def fused_unseal_savings(fused_pages: int, fused_bytes: int,
                         profile: str | TEEProfile
                         ) -> "tuple[Optional[OverheadBreakdown], str]":
    """Price what a sealed-KV restore avoided by admitting pages as
    ciphertext (the fused in-kernel unseal) instead of decrypting them
    into the pool: per page a 2x page-bytes round-trip through device memory
    and one boundary event, priced through :func:`predict` (one page-sized
    memory term per page, ``steps=pages``). Returns (breakdown | None,
    report line); None when nothing went fused."""
    if fused_pages <= 0 or fused_bytes <= 0:
        return None, "fused-unseal savings: none (no ciphertext-resident pages)"
    per_page = fused_bytes / fused_pages
    terms = RooflineTerms(compute_s=0.0, memory_s=2 * per_page / HBM_BYTES_PER_S)
    brk = predict(terms, profile, steps=fused_pages)
    line = (f"fused-unseal savings ({brk.profile}): {fused_pages} pages / "
            f"{fused_bytes} B stayed ciphertext-resident; avoided "
            f"{brk.t_tee_s * 1e6:.1f}us restore cost "
            f"({brk.t_plain_s * 1e6:.1f}us HBM round-trip + "
            f"{(brk.t_tee_s - brk.t_plain_s) * 1e6:.1f}us TEE tax incl. "
            f"{fused_pages} boundary events)")
    return brk, line
