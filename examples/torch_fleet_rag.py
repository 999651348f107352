"""Multi-tenant confidential fleet on the PyTorch port: two tenants' RAG
traffic over two attested workers, with a worker killed mid-serve.

  * the gateway attests each worker (quote -> transport key -> per-tenant
    key domains, one fresh quote per release) and envelope-encrypts every
    prompt to exactly the worker it routes to;
  * tenant-affinity placement steers each tenant's questions to the worker
    already holding that tenant's shared context, so the context pages are
    shared physically instead of stored again;
  * mid-serve, one worker is killed. Its sealed KV (ciphertext under the
    per-tenant key domains) migrates to the other worker, where every
    in-flight answer completes with the same tokens (seeded sampling
    travels with the request).

The model is the smoke deepseek-7b with a vocabulary that holds the byte
tokenizer's ids. Runs on the CUDA card unless ``--device cpu``; the two
workers share one copy of the weights.

    PYTHONPATH=src python examples/torch_fleet_rag.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.data import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.fleet import EngineWorker, Gateway, Orchestrator
from repro_torch.models import build_model
from repro_torch.runtime import GenerationRequest, SamplingParams

ENGINE_KW = dict(max_slots=2, max_len=128, prefill_buckets=(64,),
                 kv_backend="paged", page_size=16, prefix_sharing=True)

TENANT_CONTEXT = {
    "hospital": "context: enclave attestation protects patient records ",
    "bank": "context: sealed ledgers keep account balances private ",
}
QUESTIONS = ["summarize the policy", "who can read the data",
             "what is sealed at rest", "is the channel encrypted"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args().device)

    tok = ByteTokenizer()
    cfg = dataclasses.replace(smoke_config("deepseek-7b"),
                              vocab_size=tok.vocab_size)
    model = build_model(cfg, device=device)
    params = model.init_params(seed=0)

    kw = dict(ENGINE_KW, device=device)
    workers = [EngineWorker(f"w{i}", model, params, engine_kw=kw)
               for i in range(2)]
    gateway = Gateway(config_repr=cfg.name)
    for tenant in TENANT_CONTEXT:
        gateway.register_tenant(tenant)
    orch = Orchestrator(gateway, workers, placement="tenant_affinity")
    print(f"fleet: {gateway.stats.attested_workers} workers attested, "
          f"{gateway.stats.keys_released} tenant key-domain releases "
          f"(each on its own fresh quote)")

    # same-length prompts per tenant: shared context head + padded question
    # tail, so the head lands page-aligned and shares physically
    handles = []
    for tenant, ctx in TENANT_CONTEXT.items():
        width = 64 - len(tok.encode(ctx))
        for q in QUESTIONS:
            prompt = np.asarray(
                tok.encode(ctx + q.ljust(width)[:width]), np.int32)
            handles.append(orch.submit(GenerationRequest(
                prompt=prompt, max_new_tokens=8,
                params=SamplingParams(temperature=0.7, top_k=20,
                                      seed=10 * len(handles)),
                tenant=tenant)))
    for _ in range(4):                  # both workers mid-decode
        orch.step()
    by_worker = {w.name: [t for t in TENANT_CONTEXT if w.serves_tenant(t)]
                 for w in orch.ready_workers()}
    print(f"tenant affinity: {by_worker}")

    victim = max(orch.ready_workers(), key=lambda w: w.load())
    orch.kill(victim.name)
    print(f"killed {victim.name} mid-decode; its sealed KV migrated under "
          f"the tenant key domains")
    stats = orch.run()

    assert all(h.finished for h in handles)
    print(f"served {stats.total_requests} requests / {stats.total_tokens} "
          f"tokens across the failure")
    print(f"migration: {orch.stats.migrations} sealed moves / "
          f"{orch.stats.migrated_bytes} B "
          f"(priced per request in ServeStats: {stats.migrations} moves)")
    shared = sum(w.engine.kv.shared_page_maps for w in workers)
    print(f"prefix sharing across the fleet: {shared} shared page maps "
          f"(each tenant's context stored once per worker, not per request)")
    print(f"fleet boundary totals: {orch.channel_totals()}")


if __name__ == "__main__":
    main()
