"""The engine's device-facing seam (port of ``repro.runtime.plan``, single
device only).

:class:`SingleDevicePlan` places the params on the model's device and hands
back eager callables that run under ``torch.inference_mode()``; PyTorch has
no ``jit`` step. :class:`PrefillOnlyPlan` is the prefill half of a
disaggregated engine (``Engine(prefill_plan=...)``). ``ShardedPlan``
(meshes) arrives with ROADMAP.md queue A item 18.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.sealing import tree_leaves_with_names, tree_map

Params = Any


class SingleDevicePlan:
    name = "single"

    def __init__(self, model):
        self.model = model
        self.device = model.device

    def place_params(self, params: Params) -> Params:
        """The params on the plan's device; a tensor already there is not
        copied (``.to`` returns it), so plans on one device share one copy
        of the weights."""
        return tree_map(lambda t: t.to(self.device), params)

    def compile_prefill(self):
        """(params, tokens [rows, s], cache) -> (logits [rows, vocab],
        cache). Each row prefills in a call of its own, into its rows of
        the batched cache: on the card cuBLAS picks its GEMM kernel, and
        with it the rounding, by the row count, so a row prefilled beside
        others would differ in the last bits from the same prompt prefilled
        alone (and a sampled token can tip). One row a call keeps every
        request's tokens a function of its own prompt, as the reference's
        are. A model whose rows are coupled anyway (MoE expert capacity is
        reckoned over every token of the call) prefills the whole group in
        one call, padded with zero rows to a power of two as the
        reference's group is, since the pad rows' tokens take capacity
        too; the pad rows are cut from what it returns."""
        model = self.model

        @torch.inference_mode()
        def _prefill(params, tokens, cache):
            if model.rows_coupled:
                b = tokens.shape[0]
                pad = (1 << (b - 1).bit_length()) - b
                if pad:
                    tokens = torch.cat([tokens, tokens.new_zeros(
                        (pad,) + tokens.shape[1:])])
                    cache = _pad_rows(cache, pad)
                logits, cache = model.prefill(params, {"tokens": tokens},
                                              cache)
                return logits[:b], _row_view(cache, 0, b)
            if tokens.shape[0] == 1:
                return model.prefill(params, {"tokens": tokens}, cache)
            logits = [model.prefill(params, {"tokens": tokens[i:i + 1]},
                                    _row_view(cache, i))[0]
                      for i in range(tokens.shape[0])]
            return torch.cat(logits), cache

        return _prefill

    def compile_decode(self, fn):
        """The backend's batched decode step."""
        return torch.inference_mode()(fn)


def _row_view(cache: Params, i: int, j: Optional[int] = None) -> Params:
    """Rows ``i:j`` (row ``i`` alone by default) of a batched cache as a
    cache of views (``pos`` is ``[b]``, every other leaf ``[L, b, ...]``),
    so a prefill into it writes the batched cache in place."""
    j = i + 1 if j is None else j
    return {k: (_row_view(v, i, j) if isinstance(v, dict)
                else v[i:j] if k == "pos" else v[:, i:j])
            for k, v in cache.items()}


def _pad_rows(cache: Params, n: int) -> Params:
    """The cache with ``n`` zeroed rows appended (a fresh cache is zeros)."""
    def pad(k, v):
        if isinstance(v, dict):
            return {kk: pad(kk, vv) for kk, vv in v.items()}
        axis = 0 if k == "pos" else 1
        shape = list(v.shape)
        shape[axis] = n
        return torch.cat([v, v.new_zeros(shape)], dim=axis)
    return {k: pad(k, v) for k, v in cache.items()}


class PrefillOnlyPlan(SingleDevicePlan):
    """The prefill half of a disaggregated engine: prompts prefill here
    while the decode plan keeps stepping, and the finished KV rows leave
    through the engine's sealed plan-to-plan handoff, so this plan has no
    decode surface.

    On a CUDA device the prefill runs on the plan's own stream: the call
    returns once its kernels are queued, and the decode step the engine
    issues next on the caller's stream overlaps it. The returned event
    marks its end; :meth:`join` orders the caller's stream after it before
    the handoff reads the cache. On the CPU the prefill runs inline."""

    name = "prefill-only"

    def __init__(self, model):
        super().__init__(model)
        self.stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(device=self.device)
            if self.device.type == "cuda" else None)

    def compile_prefill(self):
        """(params, tokens, cache) -> (logits, cache, ready): ``ready`` is
        the event recorded after the prefill on the plan's stream, or None
        on the CPU. ``tokens`` and the fresh ``cache`` come from the
        caller's stream, which the plan's stream waits for first."""
        prefill = super().compile_prefill()
        stream = self.stream

        def _dispatch(params, tokens, cache):
            if stream is None:
                logits, cache = prefill(params, tokens, cache)
                return logits, cache, None
            caller = torch.cuda.current_stream(stream.device)
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                logits, cache = prefill(params, tokens, cache)
                ready = torch.cuda.Event()
                ready.record(stream)
            # the caller's allocations that the prefill reads or writes must
            # not be handed out again until the prefill's stream is past them
            tokens.record_stream(stream)
            for _, leaf in tree_leaves_with_names(cache):
                leaf.record_stream(stream)
            return logits, cache, ready

        return _dispatch

    def join(self, ready: Optional[torch.cuda.Event],
             logits: torch.Tensor) -> None:
        """Order the caller's stream after a dispatched prefill (the
        handoff's seal reads the cache there) and tie the logits, which the
        prefill's stream allocated, to the caller's stream that reads and
        frees them."""
        if ready is None:
            return
        caller = torch.cuda.current_stream(self.device)
        caller.wait_event(ready)
        logits.record_stream(caller)

    def compile_decode(self, fn):
        raise RuntimeError(
            "PrefillOnlyPlan compiles no decode step: it is the dedicated "
            "prefill stream of a disaggregated engine, and finished KV rows "
            "hand off to the decode plan through the sealed channel "
            "(Engine(prefill_plan=...))")
