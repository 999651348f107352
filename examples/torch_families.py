"""Every model family of the PyTorch port, served confidentially at toy scale.

One smoke model per family (chameleon-34b's vlm, dbrx-132b's and
deepseek-v3's moe, jamba's Mamba + attention hybrid, rwkv6's ssm): weights
sealed, attested and unsealed, then a preempting scenario on the family's
KV backend (paged with the table-walking kernel for chameleon, paged with
gather decode for the MoE and hybrid models, the slot backend for rwkv6,
which has no sequence-length leaf to page). whisper-small, the
encoder-decoder, has no token-in/token-out server: it runs through the
model's own prefill over frame embeddings and decode steps. On the CUDA
card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_families.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import TrustDomain
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime import Engine, GenerationRequest

BACKENDS = {
    "chameleon-34b": dict(kv_backend="paged", page_size=8,
                          kv_decode="kernel"),
    "dbrx-132b": dict(kv_backend="paged", page_size=8),
    "deepseek-v3-671b": dict(kv_backend="paged", page_size=8),
    "jamba-v0.1-52b": dict(kv_backend="paged", page_size=8),
    "rwkv6-3b": dict(kv_backend="slot"),
}


def serve(name, device):
    cfg = smoke_config(name)
    model = build_model(cfg, device=device)
    td = TrustDomain("tdx", device=device)
    params = model.init_params(seed=0)
    params = td.load_sealed(td.seal_params(params), params)
    verifier = td.make_verifier(cfg.name)
    verifier.verify(td.quote(verifier.challenge(), cfg.name))
    eng = Engine(model, params, trust_domain=td, max_slots=2, max_len=64,
                 prefill_buckets=(4, 8), device=device, **BACKENDS[name])
    low = [eng.submit(GenerationRequest(prompt=p.astype(np.int32),
                                        max_new_tokens=6))
           for p in (np.arange(1, 5), np.arange(1, 9), np.full(8, 7))]
    for _ in range(3):
        eng.step()
    high = eng.submit(GenerationRequest(
        prompt=np.arange(1, 13, dtype=np.int32), max_new_tokens=4,
        priority=5))
    stats = eng.run()
    ch = td.channel.stats
    print(f"{name} [{cfg.family}, {BACKENDS[name]['kv_backend']}]: "
          f"{stats.total_tokens} tokens, {stats.preemptions} preemption(s), "
          f"{ch.seal_bytes} B of KV and state sealed out; high request "
          f"{high.output}, first low {low[0].output}")


def whisper(device):
    cfg = smoke_config("whisper-small")
    model = build_model(cfg, device=device)
    td = TrustDomain("tdx", device=device)
    params = model.init_params(seed=0)
    params = td.load_sealed(td.seal_params(params), params)
    g = torch.Generator().manual_seed(0)
    frames = torch.randn(1, 30, cfg.d_model, generator=g).to(device)
    toks = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=device)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"frames": frames,
                                               "tokens": toks},
                                      model.init_cache(1, frames.shape[1]))
        out = []
        for _ in range(6):
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            out.append(int(nxt))
            logits, cache = model.decode_step(params, nxt, cache)
    print(f"whisper-small [encdec]: 30 frames + 3 prompt tokens -> {out}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args().device)
    for name in BACKENDS:
        serve(name, device)
    whisper(device)


if __name__ == "__main__":
    main()
