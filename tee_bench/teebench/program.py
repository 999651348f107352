"""The system under test: the PyTorch port's single-engine serving path,
built as ``repro_torch.launch.serve`` builds it, on the benchmark's
weights.

1. The benchmark makes the weights from the seed (``teebench.weights``)
   and lays them out as the port's parameter tree.
2. ``TrustDomain(mode).seal_params`` seals them; the plaintext is dropped.
3. ``load_sealed`` unseals into ``model.abstract_params()``'s structure.
4. The domain attests to a verifier.
5. ``Engine(..., kv_backend="paged", kv_decode="kernel", ...)`` serves.

This is the one module of the harness that imports ``repro_torch``, and it
imports it inside the functions that build the system. It wraps the paged
backend's ``decode`` (a call into the KV layer) to record each decode
call's live lengths, which the roofline and FLOP readers count from; the
wrapper calls through unchanged.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Optional

import numpy as np

from teebench import weights
from teebench.client import bucket_for, clock

# the configuration file's keys against the port's ModelConfig fields
_FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "num_layers",
           "num_attention_heads": "num_heads",
           "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim_",
           "intermediate_size": "d_ff", "vocab_size": "vocab_size",
           "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps"}
# The port ties the LM head to the embedding table whatever its config's
# ``tie_embeddings`` says (nothing reads that flag): a file may name only a
# tied head, which the parameter tree shows (no head leaf to make).


def program_config(cfg: dict):
    """The port's registered config for this configuration, held to the
    sizes in the configuration's file."""
    from repro_torch.configs import get_config
    mcfg = get_config(cfg["program_arch"])
    check_agrees(cfg, mcfg)
    return mcfg


def check_agrees(cfg: dict, mcfg) -> None:
    bad = {k: (cfg[k], getattr(mcfg, f)) for k, f in _FIELDS.items()
           if cfg[k] != getattr(mcfg, f)}
    if not cfg["tie_word_embeddings"]:
        bad["tie_word_embeddings"] = (False, "always tied")
    if bad or mcfg.family != "dense":
        raise ValueError(f"the port's {mcfg.name} differs from the "
                         f"configuration file: {bad} family={mcfg.family}")


def logical_name(path: str) -> (str, bool):
    """A port tree path (``['block']['slot_0']['attn']['wq']``) as the
    benchmark's leaf name (``attn.wq``), and whether it is stacked over
    layers."""
    parts = [p.strip("'") for p in path.strip("[]").split("][")]
    if len(parts) > 2 and parts[1].startswith("slot_"):
        return ".".join(parts[2:]), True
    return ".".join(parts), False


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class DecodeCall:
    __slots__ = ("t0", "t1", "valid", "pads")

    def __init__(self, t0, t1, valid, pads):
        self.t0, self.t1, self.valid, self.pads = t0, t1, valid, pads


class System:
    """The port, built and serving. ``timings`` holds the set-up's parts
    (host clock, each ending in a device synchronize)."""

    def __init__(self, cfg: dict, cell: dict, seed: int, *, device,
                 model_cfg=None, seal: bool = True,
                 fault: Optional[str] = None):
        import torch
        from repro_torch.core import TrustDomain
        from repro_torch.core.sealing import tree_map_with_names
        from repro_torch.models import build_model

        self.device = torch.device(device)
        self.cfg, self.cell = cfg, cell
        self.coalesce = 1          # tokens a frame; the mix sets it
        self.timings: Dict[str, float] = {}
        mcfg = model_cfg if model_cfg is not None else program_config(cfg)
        self.model = build_model(mcfg, device=self.device)

        t0 = clock()
        abstract = self.model.abstract_params()
        self.timings["abstract_s"] = clock() - t0
        t0 = clock()

        def make(path, meta):
            leaf, stacked = logical_name(path)
            w = (weights.stacked if stacked else weights.make)(
                cfg, seed, leaf, device=self.device)
            if tuple(w.shape) != tuple(meta.shape) or w.dtype != meta.dtype:
                raise ValueError(f"{path}: the benchmark makes "
                                 f"{tuple(w.shape)} {w.dtype}, the port "
                                 f"wants {tuple(meta.shape)} {meta.dtype}")
            return w

        params = tree_map_with_names(make, abstract)
        sync(self.device)
        self.timings["weights_s"] = clock() - t0
        self.param_bytes = sum(t.numel() * t.element_size() for t in
                               _leaves(params))

        self.td = TrustDomain(cell["trust_domain"], device=self.device)
        if seal:
            t0 = clock()
            sealed = self.td.seal_params(params)
            sync(self.device)
            self.timings["seal_s"] = clock() - t0
            del params
            gc.collect()
            t0 = clock()
            params = self.td.load_sealed(sealed, abstract)
            sync(self.device)
            self.timings["unseal_s"] = clock() - t0
            del sealed
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            verifier = self.td.make_verifier(mcfg.name)
            verifier.verify(self.td.quote(verifier.challenge(), mcfg.name))
        self.params = params
        self.buckets = tuple(cell["engine"]["prefill_buckets"])
        self.decode_calls: List[DecodeCall] = []
        self.fault = fault
        self.engine = None
        self.new_engine()

    def new_engine(self) -> None:
        """A fresh engine (and page pool) on the loaded weights."""
        import torch
        from repro_torch.runtime import Engine
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        eng = self.cell["engine"]
        self.engine = Engine(
            self.model, self.params, trust_domain=self.td, device=self.device,
            kv_backend="paged", kv_decode="kernel",
            page_size=eng["page_size"], num_pages=eng["num_pages"],
            max_slots=eng["max_slots"], max_len=eng["max_len"],
            prefill_buckets=self.buckets)
        self.decode_calls.clear()
        self._wrap_decode(self.fault)

    def _wrap_decode(self, fault: Optional[str]) -> None:
        kv, engine = self.engine.kv, self.engine
        inner = kv.decode
        calls = self.decode_calls
        buckets = self.buckets

        def decode(params, tokens, state, kmax, write_slots):
            valid = [int(kv.pos[s]) + 1 for s in write_slots]
            pads = []
            for s in write_slots:
                req = engine.scheduler.running.get(s)
                n = len(req.prompt) if req is not None else 0
                pads.append(bucket_for(buckets, n) - n if req is not None
                            else 0)
            t0 = clock()
            if fault == "kv_state":
                # a step that leaves its state unchanged: nothing appended
                out = inner(params, tokens, state, kmax, write_slots=[])
            else:
                out = inner(params, tokens, state, kmax,
                            write_slots=write_slots)
            if fault == "token" and len(calls) % 5 == 3:
                # a token altered where it is produced: every row's, on
                # every fifth step
                out = np.array(out)
                for s in write_slots:
                    out[s] = (out[s] + 1) % self.cfg["vocab_size"]
            calls.append(DecodeCall(t0, clock(), valid, pads))
            return out

        kv.decode = decode

    # -- requests -------------------------------------------------------------
    def submit(self, spec, on_token) -> None:
        from repro_torch.runtime import (FramePolicy, GenerationRequest,
                                         SamplingParams)
        self.engine.submit(GenerationRequest(
            prompt=spec.prompt, max_new_tokens=spec.max_new_tokens,
            params=SamplingParams(temperature=0.0),
            frame=FramePolicy(coalesce=self.coalesce), on_token=on_token))

    def warm_up(self, buckets, max_new_tokens: int = 2) -> None:
        """Every prefill bucket once and the decode step at the engine's
        full row count, through the engine itself (it also builds the
        kernels on a checkout's first run)."""
        from teebench.traffic import RequestSpec
        rng = np.random.default_rng(0)
        for b in buckets:
            prompt = rng.integers(1, self.cfg["vocab_size"], b,
                                  dtype=np.int64).astype(np.int32)
            self.submit(RequestSpec(None, prompt, max_new_tokens),
                        lambda *_: None)
        self.engine.run()
        sync(self.device)
        self.decode_calls.clear()

    def close(self) -> None:
        """Free the program's state (engine, pool, weights)."""
        import torch
        self.engine = None
        self.params = None
        self.model = None
        self.td = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
