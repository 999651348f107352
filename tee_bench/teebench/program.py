"""The system under test: the PyTorch port's single-engine serving path,
built as ``repro_torch.launch.serve`` builds it, on the benchmark's
weights.

1. The benchmark makes the weights from the seed (``teebench.weights``),
   each leaf by the configuration's reference's leaf table and each row of
   a stacked leaf for its model layer, laid out as the port's tree.
2. ``TrustDomain(mode).seal_params`` seals them; the plaintext is dropped.
3. ``load_sealed`` unseals into ``model.abstract_params()``'s structure.
4. The domain attests to a verifier.
5. ``Engine(..., kv_backend="paged", kv_decode=<the cell's>, ...)``
   serves.

This is the one module of the harness that imports ``repro_torch``, and it
imports it inside the functions that build the system. It wraps the paged
backend's ``decode`` (a call into the KV layer) to record each decode
call's live lengths, which the roofline and FLOP readers count from; the
wrapper calls through unchanged. In a traced stretch it records the port's
own spans and counters (``repro_torch.tracing``).
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict, List, Optional, Tuple

import numpy as np

from teebench import spec, weights
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
    check_agrees(cfg, mcfg, spec.reference(cfg))
    return mcfg


def _port_field(mcfg, dotted: str):
    """``mcfg``'s field ``dotted`` (``"moe.num_experts"``); None where a
    sub-config on the way is None."""
    value = mcfg
    for part in dotted.split("."):
        value = None if value is None else getattr(value, part)
    return value


def check_agrees(cfg: dict, mcfg, reference) -> None:
    """The port's config holds the configuration file's dense keys and the
    keys its reference declares (``PORT_FIELDS``), and is of the family
    the reference declares (``FAMILY``)."""
    fields = {**_FIELDS, **getattr(reference, "PORT_FIELDS", {})}
    bad = {}
    for key, field in fields.items():
        have = _port_field(mcfg, field)
        if cfg[key] != have:
            bad[key] = (cfg[key], have)
    if not cfg["tie_word_embeddings"]:
        bad["tie_word_embeddings"] = (False, "always tied")
    if bad or mcfg.family != reference.FAMILY:
        raise ValueError(f"the port's {mcfg.name} differs from the "
                         f"configuration file: {bad} family={mcfg.family}, "
                         f"the reference's {reference.FAMILY}")


def decode_path(cell: dict) -> str:
    """The cell's decode path: ``"kernel"`` (B3 over the paged pool, the
    default) or ``"gather"``."""
    return cell["engine"].get("kv_decode", "kernel")


Blocks = Dict[str, Tuple[int, int, int]]


def blocks_of(tree) -> Blocks:
    """The port tree's blocks of stacked layers, in the tree's order:
    name -> (the model layer of its first row, its repeats, its slots). A
    block is a top-level entry whose keys are all ``slot_<i>``."""
    out: Blocks = {}
    offset = 0
    for name, sub in tree.items():
        if isinstance(sub, dict) and sub and all(
                k.startswith("slot_") for k in sub):
            repeats = next(_leaves(sub)).shape[0]
            out[name] = (offset, repeats, len(sub))
            offset += repeats * len(sub)
    return out


def logical_name(path: str, blocks: Blocks) -> Tuple[str, Optional[List[int]]]:
    """A port tree path (``['moe_layers']['slot_0']['mla']['w_dq']``) as
    the benchmark's leaf name below the slot (``mla.w_dq``) and the model
    layer of each row it stacks: the block's first layer + repeat x slots
    + slot. A global leaf (``['embedding']['table']``) keeps its whole
    name and stacks nothing (None)."""
    parts = [p.strip("'") for p in path.strip("[]").split("][")]
    if parts[0] not in blocks:
        return ".".join(parts), None
    first, repeats, slots = blocks[parts[0]]
    slot = int(parts[1][len("slot_"):])
    return ".".join(parts[2:]), [first + r * slots + slot
                                 for r in range(repeats)]


def make_leaf(cfg: dict, seed: int, path: str, blocks: Blocks, *, device):
    """The leaf at ``path`` of the port's tree, made by the benchmark."""
    leaf, layers = logical_name(path, blocks)
    if layers is None:
        return weights.make(cfg, seed, leaf, device=device)
    return weights.stacked(cfg, seed, leaf, layers, device=device)


def make_params(cfg: dict, seed: int, abstract, *, device):
    """The port's parameter tree (``abstract``: its structure on the meta
    device), every leaf made by the benchmark in the shape and type the
    port asks for."""
    from repro_torch.core.sealing import tree_map_with_names
    blocks = blocks_of(abstract)

    def make(path, meta):
        w = make_leaf(cfg, seed, path, blocks, device=device)
        if tuple(w.shape) != tuple(meta.shape) or w.dtype != meta.dtype:
            raise ValueError(f"{path}: the benchmark makes "
                             f"{tuple(w.shape)} {w.dtype}, the port "
                             f"wants {tuple(meta.shape)} {meta.dtype}")
        return w

    return tree_map_with_names(make, abstract)


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

        params = make_params(cfg, seed, abstract, device=self.device)
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
        self._tracing: Optional[contextlib.ExitStack] = None
        self._tracer = None
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
            kv_backend="paged", kv_decode=decode_path(self.cell),
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
            # each row's context once this step appends: its prompt's
            # bucket (the left-padded prefill) and one position a token it
            # has produced, the newest fed now
            valid, pads = [], []
            for s in write_slots:
                req = engine.scheduler.running[s]
                bucket = bucket_for(buckets, len(req.prompt))
                valid.append(bucket + len(req.output))
                pads.append(bucket - len(req.prompt))
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

    # -- the port's own spans ------------------------------------------------
    def start_tracing(self) -> None:
        """Record the port's spans and counters (``repro_torch.tracing``)
        until :meth:`stop_tracing`; with a profiler recording, each span is
        also a range of its name."""
        from repro_torch import tracing
        self._tracing = contextlib.ExitStack()
        self._tracer = self._tracing.enter_context(
            tracing.active(tracing.Tracer()))

    def stop_tracing(self) -> Tuple[list, Dict[str, float]]:
        """(spans, counters) recorded since :meth:`start_tracing`."""
        self._tracing.close()
        tracer, self._tracer, self._tracing = self._tracer, None, None
        return tracer.spans, tracer.counters

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
