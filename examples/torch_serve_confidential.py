"""End-to-end confidential serving example for the PyTorch port (the paper's
measured scenario), on the CUDA card unless ``--device cpu``.

Seals and attests a small Llama-family model, then serves a batch of
low-priority requests with seeded sampling and coalesced egress frames
while one high-priority request streams token by token (a full engine
seals a background request out as ciphertext and restores it later). The
serving mode is a flag:

* ``--mode batch``: bucket-grouped batched prefill, then decode;
* ``--mode continuous``: step-level continuous batching (prefill
  admissions share a per-step token budget with the decode rows);
* ``--mode disaggregated``: prompts prefill on a dedicated plan (its own
  CUDA stream on the card) and the KV rows hand over to the decode plan
  through a sealed channel, ``--handoff-batch`` rows a crossing.

``--kv-backend paged --page-store --epochs 2`` replays the mix on the
paged backend with the persistent sealed-page store: the second epoch
restores the shared system prompt's pages from the store instead of
re-prefilling them.

    PYTHONPATH=src python examples/torch_serve_confidential.py \
        [--device cpu] [--mode continuous] [--kv-backend paged --page-store]
"""

import argparse
import time

import numpy as np

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import PROFILES, RooflineTerms, TrustDomain, predict
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime import (Engine, FramePolicy, GenerationRequest,
                                 SamplingParams)

BOS = 257   # byte-level ids: 0-255 are the UTF-8 bytes
SYSTEM = "You are a confidential assistant. Answer briefly. "


def encode(text: str) -> np.ndarray:
    return np.asarray([BOS] + list(text.encode("utf-8")), np.int32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--coalesce", type=int, default=4,
                    help="tokens per encrypted egress frame for the batch")
    ap.add_argument("--tee", default="tdx",
                    choices=["none", "vm", "sgx", "tdx", "cgpu", "tpu_cc"])
    ap.add_argument("--mode", default="batch",
                    choices=["batch", "continuous", "disaggregated"])
    ap.add_argument("--handoff-batch", type=int, default=1)
    ap.add_argument("--kv-backend", default="slot", choices=["slot", "paged"])
    ap.add_argument("--page-store", action="store_true",
                    help="paged backend: prefix sharing plus the sealed "
                         "page store")
    ap.add_argument("--epochs", type=int, default=1)
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = ModelConfig(name="llama2-mini", family="dense", num_layers=4,
                      d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
                      d_ff=512, vocab_size=512, dtype="float32",
                      parallel=ParallelConfig(remat="none"))
    model = build_model(cfg, device=device)
    params = model.init_params(seed=0)

    td = TrustDomain(args.tee, device=device)
    if td.confidential:
        sealed = td.seal_params(params)
        params = td.load_sealed(sealed, params)
        v = td.make_verifier(cfg.name)
        quote = td.quote(v.challenge(), cfg.name)
        v.verify(quote)
        print(f"[attested {args.tee}] digest={quote.measurement[:16]}...")

    kw = dict(max_slots=4, max_len=256, prefill_buckets=(16, 32, 64, 128),
              kv_backend=args.kv_backend, device=device)
    if args.kv_backend == "paged":
        kw.update(page_size=16, prefix_sharing=args.page_store,
                  page_store=args.page_store or None)
    if args.mode == "continuous":
        kw["continuous_batching"] = True
    elif args.mode == "disaggregated":
        kw.update(prefill_plan="dedicated", handoff_batch=args.handoff_batch)
    engine = Engine(model, params, trust_domain=td, **kw)

    t0 = time.monotonic()
    for epoch in range(max(args.epochs, 1)):
        # background batch: low priority, coalesced frames, seeded sampling
        reqs = [engine.submit(GenerationRequest(
                    prompt=encode(SYSTEM + f"Request number {i}."),
                    max_new_tokens=args.max_new_tokens,
                    params=SamplingParams(temperature=0.7, top_k=40,
                                          seed=100 + i),
                    frame=FramePolicy(coalesce=args.coalesce)))
                for i in range(args.requests)]
        # one interactive high-priority request streams per token
        print(f"epoch {epoch} streaming (priority=5): ", end="", flush=True)
        for t in engine.stream(GenerationRequest(
                prompt=encode("interactive confidential chat"),
                max_new_tokens=args.max_new_tokens, priority=5)):
            print(t, end=" ", flush=True)
        print()
        stats = engine.run()
    wall = time.monotonic() - t0

    print(f"\nserved {stats.total_requests} requests / "
          f"{stats.total_tokens} tokens in {wall:.2f}s [{args.mode}, "
          f"kv={args.kv_backend}]")
    print(f"throughput: {stats.throughput_tps:.1f} tok/s   "
          f"next-token latency: p50 {stats.p50_latency_s * 1e3:.1f}ms "
          f"p99 {stats.p99_latency_s * 1e3:.1f}ms   "
          f"TTFT: mean {stats.mean_ttft_s * 1e3:.1f}ms")
    outs = [r.result() for r in reqs]
    if stats.preemptions:
        print(f"sealed-KV preemptions: {stats.preemptions} "
              f"(outputs unchanged; seeded sampling survives restore)")
    if stats.handoffs:
        print(f"sealed handoffs: {stats.handoffs} rows / "
              f"{stats.handoff_bytes} B in {engine.handoff_crossings} "
              f"crossings")
    if stats.backfilled_requests:
        print(f"backfilled admissions: {stats.backfilled_requests}")
    if getattr(engine.kv, "page_store", None) is not None:
        print(f"page store: {engine.kv.store_hits} hits / "
              f"{engine.kv.store_restored_bytes} B restored; "
              f"{engine.kv.page_store.describe()}")
    if td.confidential:
        ch = td.channel.stats
        print(f"boundary traffic: {ch}")
        print(f"frame coalescing: batch at {args.coalesce} tokens/frame, "
              f"stream at 1 -> {ch.crossings_per_token:.3f} crossings/token; "
              f"per-request frames: {[o.egress_frames for o in outs]}")
        # what this deployment would cost on each platform (modeled)
        step = stats.mean_latency_s or 1e-3
        terms = RooflineTerms(compute_s=0.25 * step, memory_s=0.7 * step,
                              collective_s=0.05 * step)
        print("\nmodeled TEE overheads for this operating point:")
        for prof in PROFILES:
            print(f"  {predict(terms, prof).as_row()}")


if __name__ == "__main__":
    main()
