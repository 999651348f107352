"""Serving launcher (port of ``repro.launch.serve``, single-engine path):
confidential batched inference for a registered dense architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --tee tdx --requests 8 --max-new-tokens 16 \
        --prefill-buckets 32,64,128 --priority-mix 0:3,5:1 --coalesce 4

Runs on the CUDA card unless ``--device cpu``. With a confidential mode the
launcher performs the whole paper pipeline: seal -> attest -> unseal on the
device -> encrypted serving, and prints the reference launcher's report
lines. ``--sample-temp/--top-k/--top-p/--seed`` turn on seeded
per-request sampling (greedy at temperature 0). ``--kv-backend paged``
swaps the dense slot cache for the page pool (``--page-size``,
``--num-pages``), ``--kv-decode kernel`` attends through the table-walking
paged-attention kernels, and ``--prefix-sharing`` (with
``--shared-prefix-len K`` to give the generated prompts a common K-token
opening) maps equal prompt pages onto shared pages with copy-on-write and
step-time page grants (``--kv-alloc ondemand``, implied). ``--page-store``
(implies ``--prefix-sharing``; ``--store-policy lru|cost``,
``--store-budget-pages N``) retains released pages as sealed ciphertext,
and ``--epochs N`` replays the workload so later epochs hit the store.
``--continuous-batching`` (``--step-tokens``) interleaves prefill into the
decode steps; ``--prefill-plan dedicated`` (``--handoff-batch N``)
prefills on its own plan and hands the KV rows over sealed.

``--workers N`` switches to fleet mode: N engine workers, each in its own
TrustDomain, behind an attested gateway (quote-gated per-tenant key
release, prompt envelopes) and an orchestrator (``--placement`` policy,
``--tenants M`` round-robin tenancy). ``--kill-worker-at STEP`` fails the
busiest worker mid-serve; its sealed KV migrates to a survivor under the
per-tenant key domains and every in-flight request still finishes with the
same tokens. The workers share one copy of the weights on the device.

``--mesh dp=N,tp=M`` spans the engine over an N x M mesh (``ShardedPlan``):
the weights sit at rest in per-shard chunks over ``data`` and are gathered
every decode step, ``tp=M`` splits the attention families' heads,
``d_ff`` and experts over ``model`` (dense, vlm and moe, MLA included),
and the report adds the measured-vs-modeled ``link-tax``
line, which says what its measured term timed. In one process the mesh is
logical shards on the one device (the measured term is copies and sums in
device memory, not a link). Under torchrun it spans the ranks::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve --arch deepseek-7b --smoke --mesh tp=2

with either KV backend: ``--kv-backend paged`` (and ``--prefix-sharing``,
``--page-store``) keeps each rank's KV heads of every page, every page
sealed whole by one rank (torchrun's standalone rendezvous is a loopback
store). Each rank takes
card ``LOCAL_RANK`` (modulo the cards present; ``--device cpu`` for CPU
ranks), every rank serves the same requests under rank 0's key material,
and only rank 0 prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, list_configs, smoke_config
from repro_torch.core import RooflineTerms, TrustDomain
from repro_torch.core.overheads import (STEP_COMPUTE_FRACTION,
                                        STEP_MEMORY_FRACTION,
                                        fused_unseal_savings,
                                        measured_link_tax,
                                        store_restore_savings)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import join_world, shared_keys
from repro_torch.models import build_model
from repro_torch.runtime import (Engine, FramePolicy, GenerationRequest,
                                 SamplingParams, parse_mesh)


def parse_buckets(spec: str):
    try:
        return tuple(int(b) for b in spec.split(",") if b.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--prefill-buckets wants comma-separated ints, got {spec!r}")


def parse_priority_mix(spec: str):
    """``prio:weight,prio:weight`` -> (priorities, weights)."""
    prios, weights = [], []
    try:
        for part in spec.split(","):
            p, w = part.split(":")
            prios.append(int(p))
            weights.append(float(w))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--priority-mix wants 'prio:weight,...', got {spec!r}")
    total = sum(weights)
    if total <= 0:
        raise argparse.ArgumentTypeError("--priority-mix weights must sum > 0")
    return prios, [w / total for w in weights]


def engine_kwargs(args, device):
    """Engine construction kwargs shared by the single-engine and fleet
    paths (the trust domain is path-specific)."""
    return dict(device=device, max_slots=args.slots, max_len=args.max_len,
                prefill_len=args.prefill_len,
                prefill_buckets=args.prefill_buckets,
                kv_backend=args.kv_backend, page_size=args.page_size,
                num_pages=args.num_pages, kv_decode=args.kv_decode,
                prefix_sharing=args.prefix_sharing,
                kv_alloc=args.kv_alloc,
                continuous_batching=args.continuous_batching,
                step_tokens=args.step_tokens,
                prefill_plan=args.prefill_plan,
                handoff_batch=args.handoff_batch,
                page_store=(args.store_policy if args.page_store else None),
                store_budget_pages=(args.store_budget_pages
                                    if args.page_store else None),
                reject_infeasible=args.reject_infeasible,
                step_time_hint_s=(None if args.step_time_hint_ms is None
                                  else args.step_time_hint_ms * 1e-3))


def join_ranks(args):
    """Under torchrun with ``--mesh``: :func:`join_world`. Returns the
    rank, or None outside torchrun."""
    if args.mesh is None or args.workers:
        return None     # fleet mode with a mesh is refused below
    rank, args.device = join_world(args.device)
    return rank


def build_requests(args, cfg, tenants: int = 0):
    """The generated workload: the reference launcher's rng stream, so both
    launchers serve the same prompts, priorities and lengths; fleet mode
    stamps round-robin tenants."""
    rng = np.random.default_rng(0)
    shared_head = rng.integers(
        1, min(cfg.vocab_size, 200),
        min(args.shared_prefix_len, args.prefill_len)).astype(np.int32)
    gens = []
    for i in range(args.requests):
        prompt = rng.integers(1, min(cfg.vocab_size, 200),
                              args.prefill_len).astype(np.int32)
        prompt[:len(shared_head)] = shared_head   # common K-token opening
        priority = 0
        if args.priority_mix is not None:
            prios, weights = args.priority_mix
            priority = int(rng.choice(prios, p=weights))
        sp = SamplingParams(temperature=args.sample_temp, top_k=args.top_k,
                            top_p=args.top_p,
                            seed=None if args.seed is None else args.seed + i)
        gens.append(GenerationRequest(
            prompt=prompt, max_new_tokens=args.max_new_tokens,
            priority=priority, params=sp,
            frame=FramePolicy(coalesce=args.coalesce),
            deadline_s=args.deadline_s,
            tenant=f"t{i % tenants}" if tenants else None))
    return gens


def serve_fleet(args, cfg, model, params, device):
    """Fleet mode: N attested workers behind a gateway + orchestrator."""
    from repro_torch.fleet import EngineWorker, Gateway, Orchestrator

    kw = engine_kwargs(args, device)
    workers = [EngineWorker(f"w{i}", model, params, tee=args.tee,
                            engine_kw=kw) for i in range(args.workers)]
    gateway = Gateway(config_repr=cfg.name)
    for t in range(args.tenants):
        gateway.register_tenant(f"t{t}")
    orch = Orchestrator(gateway, workers, placement=args.placement)

    t0 = time.monotonic()
    for gen in build_requests(args, cfg, tenants=args.tenants):
        orch.submit(gen)
    step_i = 0
    while not orch.idle and step_i < 10_000:
        if step_i == args.kill_worker_at:
            live = orch.ready_workers()
            if len(live) > 1:
                victim = max(live, key=lambda w: w.load()).name
                orch.kill(victim)
                print(f"[fleet] killed {victim} at step {step_i}; sealed KV "
                      f"migrated under the tenant key domains")
        orch.step()
        step_i += 1
    stats = orch.fleet_stats()
    wall = time.monotonic() - t0

    gs = gateway.stats
    fs = orch.stats
    print(f"served {stats.total_requests} requests / {stats.total_tokens} "
          f"tokens in {wall:.2f}s "
          f"[fleet={args.workers}x{args.tee}, kv={args.kv_backend}]")
    print(f"throughput {stats.throughput_tps:.1f} tok/s | next-token latency "
          f"p50 {stats.p50_latency_s * 1e3:.1f}ms "
          f"mean {stats.mean_latency_s * 1e3:.1f}ms "
          f"p99 {stats.p99_latency_s * 1e3:.1f}ms")
    print(f"fleet: {gs.attested_workers} workers attested / "
          f"{gs.rejected_quotes} quote rejections / "
          f"{gs.keys_released} tenant keys released / "
          f"{gs.envelopes} prompt envelopes ({gs.envelope_bytes} B)")
    print(f"migration: {fs.migrations} sealed moves / "
          f"{fs.migrated_bytes} B migrated / {fs.kills} kills, "
          f"{fs.drains} drains, {fs.requeued} requeued")
    if stats.rejected_infeasible:
        print(f"admission control: {stats.rejected_infeasible} "
              f"infeasible rejections")
    if stats.handoffs:
        print(f"sealed handoff: {stats.handoffs} prefill->decode handoffs / "
              f"{stats.handoff_bytes} B across the plan boundary "
              f"({stats.handoff_bytes // max(stats.handoffs, 1)} B/handoff)")
    tot = orch.channel_totals()
    print(f"fleet boundary: {tot['messages_out']} egress frames / "
          f"{tot['tokens_out']} tokens, "
          f"{tot['seal_events']} seals / {tot['seal_bytes']} B out, "
          f"{tot['restore_events']} restores / {tot['restore_bytes']} B back")
    if tot["store_hits"] or tot["store_evictions"]:
        print(f"fleet store: {tot['store_hits']} hits / "
              f"{tot['store_restored_bytes']} B restored / "
              f"{tot['store_evictions']} evictions")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    ap.add_argument("--tee", default="tdx")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prefill-len", type=int, default=16)
    ap.add_argument("--prefill-buckets", type=parse_buckets, default=None,
                    metavar="B0,B1,...",
                    help="power-of-two prefill buckets (default: one bucket "
                         "of --prefill-len)")
    ap.add_argument("--priority-mix", type=parse_priority_mix, default=None,
                    metavar="PRIO:WEIGHT,...",
                    help="weighted request priorities, e.g. 0:3,5:1")
    ap.add_argument("--coalesce", type=int, default=1,
                    help="tokens per encrypted egress frame (FramePolicy)")
    ap.add_argument("--sample-temp", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the top-k logits (0 = all)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling threshold (1.0 = off)")
    ap.add_argument("--seed", type=int, default=None,
                    help="sampling seed (reproducible per-request streams)")
    ap.add_argument("--kv-backend", default="slot", choices=["slot", "paged"],
                    help="KV layout: dense slots or page pool + page table")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged backend)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool size in pages (default: dense-equivalent)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="content-indexed shared prompt pages with "
                         "copy-on-write (paged backend; implies on-demand "
                         "page allocation)")
    ap.add_argument("--kv-alloc", default=None,
                    choices=["reserve", "ondemand"],
                    help="paged page-allocation mode: worst-case admission "
                         "reservations or step-time grants with capacity "
                         "preemption")
    ap.add_argument("--kv-decode", default="gather",
                    choices=["gather", "kernel"],
                    help="paged decode path: per-step dense gather "
                         "(reference) or the table-walking paged-attention "
                         "kernel with fused in-kernel page unseal")
    ap.add_argument("--page-store", action="store_true",
                    help="retain content-named sealed pages past the last "
                         "reference in a persistent prefix-cache tier "
                         "(implies --prefix-sharing); recurring prompts "
                         "restore MAC-verified pages instead of "
                         "re-prefilling")
    ap.add_argument("--store-budget-pages", type=int, default=None,
                    metavar="N",
                    help="page-store retention budget in pages "
                         "(default: unbounded)")
    ap.add_argument("--store-policy", default="lru",
                    choices=["lru", "cost"],
                    help="page-store retention policy: least-recently-used "
                         "or the restore-vs-recompute priced scoring")
    ap.add_argument("--epochs", type=int, default=1,
                    help="replay the generated workload this many times "
                         "(a recurring-prompt mix: epoch 2+ hits the "
                         "page store)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    metavar="K",
                    help="give every generated prompt the same K-token head")
    ap.add_argument("--mesh", default=None, metavar="dp=N[,tp=M]",
                    help="span the engine over N data x M tensor-parallel "
                         "shards (logical shards on the device, or the "
                         "ranks under torchrun; weights gathered every "
                         "step) and report the measured link tax")
    ap.add_argument("--continuous-batching", action="store_true",
                    help="step-level continuous batching: prefill admissions "
                         "interleave into decode steps under a per-step "
                         "token budget instead of filling a bucket first")
    ap.add_argument("--step-tokens", type=int, default=None,
                    help="per-step token budget for --continuous-batching "
                         "(default: largest prefill bucket + --slots)")
    ap.add_argument("--prefill-plan", default=None, choices=["dedicated"],
                    help="disaggregate prefill onto its own compute plan (its "
                         "own CUDA stream on the card); finished KV rows hand "
                         "off to the decode plan through a sealed channel "
                         "priced in ChannelStats")
    ap.add_argument("--handoff-batch", type=int, default=1,
                    help="finished prefill rows grouped per sealed "
                         "prefill->decode crossing (--prefill-plan dedicated)")
    ap.add_argument("--reject-infeasible", action="store_true",
                    help="reject deadline-infeasible requests at admission, "
                         "before any boundary crossing is spent on them")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds (stamped on every "
                         "generated request)")
    ap.add_argument("--step-time-hint-ms", type=float, default=None,
                    help="prior lower bound on decode step time for "
                         "--reject-infeasible before any step has run")
    ap.add_argument("--workers", type=int, default=0, metavar="N",
                    help="fleet mode: N engine workers (own TrustDomain "
                         "each) behind an attested gateway + orchestrator "
                         "(0 = single-engine path)")
    ap.add_argument("--tenants", type=int, default=2, metavar="M",
                    help="fleet mode: round-robin requests over M tenant "
                         "key domains")
    ap.add_argument("--placement", default="least_loaded",
                    choices=["least_loaded", "tenant_affinity",
                             "store_affinity"],
                    help="fleet placement policy")
    ap.add_argument("--kill-worker-at", type=int, default=None,
                    metavar="STEP",
                    help="fleet mode: kill the busiest worker at this step; "
                         "its sealed KV migrates to survivors")
    args = ap.parse_args(argv)
    if args.page_store:
        # the store is the tier behind the content index: it needs page keys
        args.prefix_sharing = True
    if args.workers and args.mesh is not None:
        raise SystemExit("--workers (fleet mode) and --mesh are mutually "
                         "exclusive: a mesh spans one engine")
    rank = join_ranks(args)
    if args.mesh is not None:
        dp, _ = parse_mesh(args.mesh)
        padded = args.slots + (-args.slots) % dp
        if padded != args.slots:
            # a batch that does not divide maps every row to shard 0: pad
            # instead so the sharded run really spans the shards
            print(f"[mesh] rounding --slots {args.slots} up to {padded} "
                  f"(a dp={dp} mesh shards whole slots per data-shard)")
            args.slots = padded
    device = resolve_device(args.device)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("the token-in/token-out server needs a decoder-family arch")
    model = build_model(cfg, device=device)
    params = model.init_params(0)

    if args.workers:
        serve_fleet(args, cfg, model, params, device)
        return

    td = (TrustDomain(args.tee, device=device) if rank is None
          else TrustDomain(args.tee, device=device, **shared_keys()))
    if td.confidential:
        sealed = td.seal_params(params)
        params = td.load_sealed(sealed, params)
        verifier = td.make_verifier(cfg.name)
        quote = td.quote(verifier.challenge(), cfg.name)
        verifier.verify(quote)
        print(f"[{args.tee}] attested; model digest bound "
              f"({quote.measurement[:16]}...)")

    engine = Engine(model, params, trust_domain=td, mesh=args.mesh,
                    **engine_kwargs(args, device))
    if args.mesh is not None:
        print(f"[mesh] engine spans {engine.plan.describe()}")
    t0 = time.monotonic()
    for epoch in range(max(args.epochs, 1)):
        pages0 = getattr(engine.kv, "pages_written", 0)
        hits0 = getattr(engine.kv, "store_hits", 0)
        for gen in build_requests(args, cfg):
            engine.submit(gen)
        stats = engine.run()
        if args.epochs > 1:
            print(f"epoch {epoch}: "
                  f"{getattr(engine.kv, 'pages_written', 0) - pages0} "
                  f"pages written, "
                  f"{getattr(engine.kv, 'store_hits', 0) - hits0} "
                  f"store hits")
    wall = time.monotonic() - t0

    print(f"served {stats.total_requests} requests / {stats.total_tokens} "
          f"tokens in {wall:.2f}s [kv={args.kv_backend}]")
    print(f"throughput {stats.throughput_tps:.1f} tok/s | next-token latency "
          f"p50 {stats.p50_latency_s * 1e3:.1f}ms "
          f"mean {stats.mean_latency_s * 1e3:.1f}ms "
          f"p99 {stats.p99_latency_s * 1e3:.1f}ms")
    if (stats.preemptions or stats.dropped_requests or stats.deadline_misses
            or stats.aborted_requests):
        print(f"SLO: {stats.preemptions} preemptions, "
              f"{stats.dropped_requests} dropped, "
              f"{stats.aborted_requests} aborted, "
              f"{stats.deadline_misses} deadline misses")
    ch = td.channel.stats
    if ch.seal_events:
        print(f"sealed-KV traffic: {ch.seal_events} evictions / "
              f"{ch.seal_bytes} B out ({ch.seal_bytes_per_event:.0f} B/seal), "
              f"{ch.restore_events} restores / {ch.restore_bytes} B back "
              f"[kv={args.kv_backend}]")
    if stats.rejected_infeasible:
        print(f"admission control: {stats.rejected_infeasible} "
              f"infeasible rejections (deadline unmeetable at submit)")
    if stats.handoffs:
        print(f"sealed handoff: {stats.handoffs} prefill->decode handoffs / "
              f"{stats.handoff_bytes} B across the plan boundary "
              f"({stats.handoff_bytes // max(stats.handoffs, 1)} B/handoff, "
              f"{engine.handoff_crossings} sealed crossings @ "
              f"batch={args.handoff_batch})")
    if args.continuous_batching:
        print(f"continuous batching: step budget "
              f"{engine._step_tokens} tokens, "
              f"{stats.backfilled_requests} backfilled admissions")
    if args.kv_backend == "paged":
        print(f"kv decode: mode={engine.kv.decode_mode} | fused-unseal "
              f"{engine.kv.fused_restore_pages} pages / "
              f"{engine.kv.fused_restore_bytes} B admitted as ciphertext")
        _, savings_line = fused_unseal_savings(
            engine.kv.fused_restore_pages, engine.kv.fused_restore_bytes,
            args.tee)
        print(savings_line)
    if engine.kv.supports_sharing:
        print(f"prefix sharing: {stats.shared_pages} shared-page maps, "
              f"{stats.cow_copies} CoW copies, "
              f"{engine.kv.pages_written} pages written "
              f"[alloc={'ondemand' if engine.kv.on_demand else 'reserve'}]")
    store = getattr(engine.kv, "page_store", None)
    if store is not None:
        print(f"store hits: {engine.kv.store_hits} / "
              f"{engine.kv.store_restored_bytes} B restored / "
              f"{store.publishes} publishes "
              f"({store.republish_noops} republish no-ops) / "
              f"{store.evictions} evictions / "
              f"{store.resident_pages} resident pages "
              f"[policy={store.policy}, budget={store.budget_pages}]")
        profile = args.tee if td.confidential else "cgpu"
        _, _, line = store_restore_savings(
            engine.kv.store_restored_pages, engine.kv.store_restored_bytes,
            engine.kv.store_restored_pages * engine.kv.page_size, profile)
        print(line)
    if args.mesh is not None:
        # measured-vs-modeled encrypted-interconnect (link_tax) comparison:
        # same roofline terms, collective time once from the closed form
        # (bytes / the card's link rate) and once from the plan's timed
        # gathers, which on one device copy the weights in device memory
        profile = args.tee if td.confidential else "cgpu"
        _, _, line = measured_link_tax(
            ch, profile, stats.mean_latency_s or 1e-3,
            measures=engine.plan.collective_measures)
        print(f"link-tax [{args.mesh}, {profile}]: {line}")
    if td.confidential:
        print(f"boundary: {ch}")
        print(f"frame coalescing: {ch.messages_out} egress frames / "
              f"{ch.tokens_out} tokens = "
              f"{ch.crossings_per_token:.3f} crossings/token "
              f"(coalesce={args.coalesce})")
        step = stats.mean_latency_s or 1e-3
        terms = RooflineTerms(compute_s=STEP_COMPUTE_FRACTION * step,
                              memory_s=STEP_MEMORY_FRACTION * step,
                              collective_s=0.05 * step)
        print("modeled platform overhead:", td.predict_overhead(terms).as_row())
    if rank is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
