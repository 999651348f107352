"""Serving launcher (port of ``repro.launch.serve``, single-engine path):
confidential batched inference for a registered dense architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --tee tdx --requests 8 --max-new-tokens 16 \
        --prefill-buckets 32,64,128 --priority-mix 0:3,5:1 --coalesce 4

Runs on the CUDA card unless ``--device cpu``. With a confidential mode the
launcher performs the whole paper pipeline: seal -> attest -> unseal on the
device -> encrypted serving, and prints the reference launcher's report
lines. Requests are greedy: ``--sample-temp`` above 0 raises until seeded
sampling is ported (ROADMAP.md queue A item 6). The reference's fleet, mesh,
paged-KV, page-store and two-phase flags are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, list_configs, smoke_config
from repro_torch.core import RooflineTerms, TrustDomain
from repro_torch.core.overheads import (STEP_COMPUTE_FRACTION,
                                        STEP_MEMORY_FRACTION)
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime import (Engine, FramePolicy, GenerationRequest,
                                 SamplingParams)


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


def build_requests(args, cfg):
    """The generated workload: the reference launcher's rng stream, so both
    launchers serve the same prompts, priorities and lengths."""
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
            deadline_s=args.deadline_s))
    return gens


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
                    help="sampling temperature (0 = greedy; only greedy is "
                         "ported)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the top-k logits (0 = all)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling threshold (1.0 = off)")
    ap.add_argument("--seed", type=int, default=None,
                    help="sampling seed (reproducible per-request streams)")
    ap.add_argument("--kv-backend", default="slot", choices=["slot", "paged"],
                    help="KV layout (only the dense slot layout is ported)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    metavar="K",
                    help="give every generated prompt the same K-token head")
    ap.add_argument("--reject-infeasible", action="store_true",
                    help="reject deadline-infeasible requests at admission, "
                         "before any boundary crossing is spent on them")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds (stamped on every "
                         "generated request)")
    ap.add_argument("--step-time-hint-ms", type=float, default=None,
                    help="prior lower bound on decode step time for "
                         "--reject-infeasible before any step has run")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("the token-in/token-out server needs a decoder-family arch")
    model = build_model(cfg, device=device)
    params = model.init_params(0)

    td = TrustDomain(args.tee, device=device)
    if td.confidential:
        sealed = td.seal_params(params)
        params = td.load_sealed(sealed, params)
        verifier = td.make_verifier(cfg.name)
        quote = td.quote(verifier.challenge(), cfg.name)
        verifier.verify(quote)
        print(f"[{args.tee}] attested; model digest bound "
              f"({quote.measurement[:16]}...)")

    engine = Engine(model, params, trust_domain=td, device=device,
                    max_slots=args.slots, max_len=args.max_len,
                    prefill_len=args.prefill_len,
                    prefill_buckets=args.prefill_buckets,
                    kv_backend=args.kv_backend,
                    reject_infeasible=args.reject_infeasible,
                    step_time_hint_s=(None if args.step_time_hint_ms is None
                                      else args.step_time_hint_ms * 1e-3))
    t0 = time.monotonic()
    for gen in build_requests(args, cfg):
        engine.submit(gen)
    stats = engine.run()
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


if __name__ == "__main__":
    main()
