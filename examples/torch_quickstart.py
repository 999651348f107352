"""Quickstart for the PyTorch port: confidential LLM inference in ~40 lines.

Builds a tiny Llama-family model, seals its weights, attests the trust
domain, and serves a prompt: the full paper pipeline at toy scale, on the
CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.core import TrustDomain
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime import Engine, GenerationRequest


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args().device)

    # 1. model
    cfg = smoke_config("deepseek-7b")
    model = build_model(cfg, device=device)
    params = model.init_params(seed=0)

    # 2. trust domain: seal weights at rest, then load them back inside
    td = TrustDomain("tdx", device=device)
    sealed = td.seal_params(params)
    params_in_domain = td.load_sealed(sealed, params)
    print(f"sealed {len(sealed)} tensors; model digest bound to attestation")

    # 3. attestation: client verifies the domain before releasing anything
    verifier = td.make_verifier(config_repr=cfg.name)
    nonce = verifier.challenge()
    quote = td.quote(nonce, config_repr=cfg.name)
    verifier.verify(quote)
    print(f"attestation OK (measurement {quote.measurement[:16]}...)")

    # 4. serve: prompts cross the boundary encrypted
    engine = Engine(model, params_in_domain, max_slots=2, max_len=64,
                    prefill_len=8, trust_domain=td, device=device)
    out = engine.generate(GenerationRequest(
        prompt=np.arange(1, 9, dtype=np.int32), max_new_tokens=8))
    print(f"generated tokens: {out.tokens} ({out.finish_reason}, "
          f"{out.egress_frames} egress frames)")
    print(f"boundary traffic: {td.channel.stats}")
    print(f"audit log: {[e.kind for e in td.audit]}")


if __name__ == "__main__":
    main()
