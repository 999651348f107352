"""Confidential RAG on the PyTorch port (paper §VI): the corpus, index,
retrieval and generation all live inside the trust domain; queries arrive
encrypted.

The second half serves several questions over one retrieved context on a
prefix-sharing paged engine: the context prefix is stored once per page
pool, and every request past the first maps the resident pages instead of
storing (and, under preemption, sealing) its own copy.

The model is the smoke deepseek-7b with a vocabulary that holds the byte
tokenizer's ids. Runs on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_rag_confidential.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.core import TrustDomain
from repro_torch.data import ByteTokenizer, synthetic_text
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.rag import RAGPipeline
from repro_torch.runtime import Engine, GenerationRequest


def retrieval_demo(model, params, docs, device):
    td = TrustDomain("tdx", device=device)
    engine = Engine(model, params, max_slots=2, max_len=96, prefill_len=16,
                    trust_domain=td, device=device)
    for mode in ("bm25", "bm25+rerank"):
        rag = RAGPipeline(docs, mode=mode, engine=engine, trust_domain=td)
        res = rag.query("which enclave protects patient records?",
                        top_k=2, max_new_tokens=8)
        print(f"[{mode}] top docs: {[d for d, _ in res.retrieved]} "
              f"(retrieval {res.retrieval_s * 1e3:.1f}ms, "
              f"generation {res.generation_s * 1e3:.0f}ms)")
    print(f"boundary traffic: {td.channel.stats}")


def shared_context_demo(model, params, docs, device):
    """Many questions over one retrieved context: the context pages are
    shared across the batch (position-aligned because every prompt has the
    same length and the questions ride at the tail)."""
    tok = ByteTokenizer()
    td = TrustDomain("tdx", device=device)
    bucket, page_size = 128, 16
    engine = Engine(model, params, max_slots=4, max_len=192,
                    prefill_buckets=(bucket,), trust_domain=td,
                    kv_backend="paged", page_size=page_size,
                    prefix_sharing=True, device=device)
    context = "context: " + docs["policy"]
    questions = ["which enclave protects records?",
                 "what throughput is achievable?",
                 "who attests the llama model?",
                 "is patient data sealed at rest?"]
    width = bucket - len(tok.encode(context + " question: "))
    reqs = []
    for i, q in enumerate(questions):
        prompt = np.asarray(tok.encode(
            context + " question: " + q.ljust(width)[:width]), np.int32)
        assert len(prompt) == bucket
        need, eff = engine.effective_kv_need(prompt, 8)
        if i > 0:
            # the context pages went resident with the first request, so
            # later ones charge only their private tail against the pool
            assert eff < need
        reqs.append(engine.submit(GenerationRequest(prompt=prompt,
                                                    max_new_tokens=8)))
        if i == 0:
            engine.step()   # prefill the first: its context pages go resident
    stats = engine.run()
    print(f"[shared-context] {len(questions)} questions over one "
          f"{len(tok.encode(context))}-token context: "
          f"{stats.shared_pages} page mappings shared "
          f"(~{stats.shared_pages * page_size} context tokens never "
          f"re-stored), {stats.cow_copies} CoW copies, "
          f"{engine.kv.pages_written} pages written")
    assert all(r.finished for r in reqs)
    assert stats.shared_pages > 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args().device)

    docs = {f"doc{i}": synthetic_text(i, 10) for i in range(25)}
    docs["policy"] = ("confidential enclave attestation protects llama "
                      "inference and patient record throughput")
    cfg = dataclasses.replace(smoke_config("deepseek-7b"),
                              vocab_size=ByteTokenizer.vocab_size)
    model = build_model(cfg, device=device)
    params = model.init_params(seed=0)

    retrieval_demo(model, params, docs, device)
    shared_context_demo(model, params, docs, device)


if __name__ == "__main__":
    main()
