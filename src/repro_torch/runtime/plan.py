"""The engine's device-facing seam (port of ``repro.runtime.plan``).

:class:`SingleDevicePlan` places the params on the model's device and hands
back eager callables that run under ``torch.inference_mode()``; PyTorch has
no ``jit`` step. :class:`PrefillOnlyPlan` is the prefill half of a
disaggregated engine (``Engine(prefill_plan=...)``). :class:`ShardedPlan`
spans a mesh of logical shards on one device (``Engine(mesh="dp=2")``):
weights at rest in per-shard chunks, gathered at use, every gather counted
into ``ChannelStats.collective_*``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.sealing import tree_leaves_with_names, tree_map

Params = Any
Cache = Any


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``"dp=2,tp=1"`` (or just ``"dp=2"``) -> ``(dp, tp)``."""
    if not spec or not spec.strip():
        raise ValueError(
            "empty mesh spec: want 'dp=N' or 'dp=N,tp=M' (omit the mesh "
            "argument entirely for single-device)")
    dp, tp = 1, 1
    try:
        for part in spec.split(","):
            if not part.strip():
                continue
            k, v = part.split("=")
            k = k.strip()
            if k == "dp":
                dp = int(v)
            elif k == "tp":
                tp = int(v)
            else:
                raise ValueError(k)
    except ValueError:
        raise ValueError(
            f"bad mesh spec {spec!r}: want 'dp=N' or 'dp=N,tp=M'")
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp}, tp={tp}")
    return dp, tp


class ComputePlan:
    """The plan seam the engine and the KV backends compile through, and
    the single-device contract: the model on one device, a prefill that
    keeps every row's bits its own, a decode step under inference mode,
    no collective cost. A plan that places or moves weights differently
    (:class:`ShardedPlan`) overrides the placement, its step's wrappers and
    the collective accounting."""

    is_sharded = False
    name = "single"

    def __init__(self, model):
        self.model = model
        self.device = model.device

    def place_params(self, params: Params) -> Params:
        """The params on the plan's device; a tensor already there is not
        copied (``.to`` returns it), so plans on one device share one copy
        of the weights."""
        return tree_map(lambda t: t.to(self.device), params)

    def drain_collectives(self) -> Tuple[int, int, float]:
        """(steps, bytes, seconds) of collective cost accrued since the
        last drain; the engine feeds it to ``TrustDomain.record_collective``.
        One device moves nothing."""
        return 0, 0, 0.0

    def shard_of_slot(self, slot: int, max_slots: int) -> int:
        return 0

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


class SingleDevicePlan(ComputePlan):
    """One device, the engine's default plan."""


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


class PrefillOnlyPlan(ComputePlan):
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


class ShardedWeights:
    """A :class:`ShardedPlan`'s weights: each leaf that ``param_specs``
    shards over ``data`` at rest in ``dp`` separately allocated chunks
    (``chunks[name]``, split along ``dims[name]``), every other leaf whole.
    ``full`` is the whole tree, its sharded leaves being the gather buffers
    (``buffers[name]``), allocated once and refilled by every gather."""

    def __init__(self, full: Params, chunks: Dict[str, List[torch.Tensor]],
                 dims: Dict[str, int], buffers: Dict[str, torch.Tensor]):
        self.full = full
        self.chunks = chunks
        self.dims = dims
        self.buffers = buffers

    @property
    def sharded_bytes(self) -> int:
        """Bytes of the leaves sharded over ``data`` (what a gather
        writes)."""
        return sum(b.numel() * b.element_size() for b in self.buffers.values())


class ShardedPlan(ComputePlan):
    """One engine over a ``("data", "model")`` mesh of logical shards on one
    physical device (:func:`repro_torch.launch.mesh.make_host_mesh`):

      - **batch** rows map to shards over ``data``: slot ``s`` belongs to
        shard ``s // (max_slots / dp)`` (:meth:`shard_of_slot`), which names
        its sealed KV (``/s{shard}``);
      - **params** are placed per
        :func:`repro_torch.distributed.sharding.param_specs` with FSDP forced
        on: each leaf sharded over ``data`` sits at rest in ``dp`` chunks,
        and before every decode step and prefill call the plan gathers the
        chunks into full-size buffers (:meth:`gather`), so the weights are
        copied every step;
      - **compute** runs the backend's unchanged batched step on the
        gathered weights, over the whole batch, in one call on the device:
        every row's GEMM shapes, and with them its bits, are the
        single-device engine's (cuBLAS picks its kernel by the row count),
        and a MoE model's expert capacity is reckoned over the global batch
        as the reference's SPMD program reckons it;
      - the **KV cache** stays one copy on the device (the slot rows, the
        page pool and the slot-dense recurrent leaves alike): the
        reference's replicated pool, and its batch-sharded rows mapped to
        shards by :meth:`shard_of_slot`.

    Each decode step counts ``collective_bytes_per_step``, the bytes its
    gather moves into one shard: ``(dp - 1) / dp`` of every sharded leaf.
    The reference parses the bytes from its compiled HLO, where XLA does not
    gather every sharded leaf, so the two counts differ (ROADMAP.md queue
    C). Its seconds are the step's own gather, timed as it runs (CUDA events
    on the card, the host clock on the CPU): on one device that gather is a
    copy of every sharded leaf in device memory, not a transfer over a
    link, where the reference times an all-gather probe on its mesh.
    Prefill calls gather too and are not counted, as in the reference.
    Tensor parallelism (``tp > 1``) and a mesh over several devices are
    ROADMAP.md queue A item 21."""

    is_sharded = True
    name = "sharded"

    def __init__(self, model, *, dp: int = 1, tp: int = 1):
        super().__init__(model)
        # deferred so a single-device engine never touches the mesh modules
        from repro_torch.launch.mesh import make_host_mesh

        if tp > 1:
            raise NotImplementedError(
                f"tensor-parallel compute (tp={tp}) is not ported yet "
                f"(ROADMAP.md queue A item 21)")
        self.mesh = make_host_mesh(data=dp, model=tp, device=self.device)
        self.dp, self.tp = dp, tp
        # param_specs with FSDP forced on: the spec table only reads
        # cfg.parallel.{fsdp, dp_over_model}
        self._spec_cfg = SimpleNamespace(parallel=SimpleNamespace(
            fsdp=True, dp_over_model=model.cfg.parallel.dp_over_model,
            zero1=False))
        # one entry a decode step since the last drain: its gather's
        # (start, end) CUDA events, or its seconds on the host clock
        self._pending: List[Any] = []
        self.collective_bytes_per_step = 0

    @classmethod
    def from_spec(cls, model, spec: str) -> "ShardedPlan":
        dp, tp = parse_mesh(spec)
        return cls(model, dp=dp, tp=tp)

    def describe(self) -> str:
        return (f"dp={self.dp},tp={self.tp} ({self.mesh.size} shards on 1 "
                f"physical device, {self.device})")

    # -- placement ----------------------------------------------------------
    @torch.inference_mode()
    def place_params(self, params: Params) -> ShardedWeights:
        """Split every leaf ``param_specs`` shards over ``data`` into ``dp``
        chunks of its own, count the bytes a gather moves into one shard,
        then allocate the gather buffers."""
        from repro_torch.distributed import sharding

        params = super().place_params(params)
        specs = sharding.param_specs(self._spec_cfg, params, self.mesh)
        chunks: Dict[str, List[torch.Tensor]] = {}
        dims: Dict[str, int] = {}
        shapes: Dict[str, Tuple[int, ...]] = {}

        def place(node, spec, path):
            if isinstance(node, dict):
                return {k: place(v, spec[k], f"{path}[{k!r}]")
                        for k, v in node.items()}
            if "data" not in spec:
                return node
            dims[path] = spec.index("data")
            shapes[path] = tuple(node.shape)
            chunks[path] = [c.clone() for c in
                            node.chunk(self.dp, dim=dims[path])]
            return path

        skeleton = place(params, specs, "")
        buffers = {p: torch.empty(shapes[p], dtype=cs[0].dtype,
                                  device=self.device)
                   for p, cs in chunks.items()}
        weights = ShardedWeights(_fill(skeleton, buffers), chunks, dims,
                                 buffers)
        self.collective_bytes_per_step = (weights.sharded_bytes
                                          * (self.dp - 1) // self.dp)
        return weights

    @torch.inference_mode()
    def gather(self, weights: ShardedWeights) -> Params:
        """Rebuild the full weights: every sharded leaf's chunks copied
        into its buffer. Returns the whole tree."""
        for path, cs in weights.chunks.items():
            torch.cat(cs, dim=weights.dims[path], out=weights.buffers[path])
        return weights.full

    def _timed_gather(self, weights: ShardedWeights) -> Params:
        """:meth:`gather`, its time queued for the next drain."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            full = self.gather(weights)
            end.record()
            self._pending.append((start, end))
            return full
        t0 = time.perf_counter()
        full = self.gather(weights)
        self._pending.append(time.perf_counter() - t0)
        return full

    # -- callables ------------------------------------------------------------
    def compile_prefill(self):
        prefill = super().compile_prefill()

        def run(weights, tokens, cache):
            return prefill(self.gather(weights), tokens, cache)

        return run

    def compile_decode(self, fn):
        """The backend's batched decode step on the gathered weights; each
        call counts one step of collective cost, its gather timed."""
        step = super().compile_decode(fn)

        def run(weights, *args):
            return step(self._timed_gather(weights), *args)

        return run

    # -- collective accounting ------------------------------------------------
    def drain_collectives(self) -> Tuple[int, int, float]:
        """Steps, bytes and the gathers' measured seconds since the last
        drain (on the card this waits for the last step's gather to end;
        the engine drains after reading the step's tokens)."""
        pending, self._pending = self._pending, []
        return (len(pending), len(pending) * self.collective_bytes_per_step,
                sum(map(_seconds, pending)))

    def shard_of_slot(self, slot: int, max_slots: int) -> int:
        """Which data shard holds this slot's cache row: the ``/s{shard}``
        suffix per-shard sealing records."""
        if max_slots % self.dp != 0:
            return 0               # the rows do not split: replicated
        return int(slot) // (max_slots // self.dp)


def _seconds(mark) -> float:
    """A queued gather's seconds: host-clock seconds as they are, a pair of
    CUDA events read once the second has passed."""
    if isinstance(mark, float):
        return mark
    start, end = mark
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def _fill(skeleton: Params, buffers: Dict[str, torch.Tensor]) -> Params:
    """The skeleton tree with each sharded leaf's name replaced by its
    buffer."""
    if isinstance(skeleton, dict):
        return {k: _fill(v, buffers) for k, v in skeleton.items()}
    return buffers[skeleton] if isinstance(skeleton, str) else skeleton
