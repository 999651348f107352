"""The engine's device-facing seam (port of ``repro.runtime.plan``).

:class:`SingleDevicePlan` places the params on the model's device and hands
back eager callables that run under ``torch.inference_mode()``; PyTorch has
no ``jit`` step. :class:`PrefillOnlyPlan` is the prefill half of a
disaggregated engine (``Engine(prefill_plan=...)``). :class:`ShardedPlan`
spans a mesh (``Engine(mesh="dp=2,tp=2")``) of logical shards on one device
or of ranks, one device each: weights at rest in their ``data`` shards
(``sharding.Placed``, as a sharded train state rests), gathered at use, tensor-parallel compute over ``model``, every
step's gather and collectives counted into ``ChannelStats.collective_*``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.sealing import (tree_leaves_with_names, tree_map,
                                      tree_map_with_names)
from repro_torch.distributed.collectives import mark_seconds, take_all

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

    def place_dense_cache(self, cache: Cache) -> Cache:
        """A fresh dense cache (``model.init_cache``'s layout) as the plan
        holds it."""
        return cache

    def place_paged_cache(self, blocks: Cache, paged_paths) -> Cache:
        """The paged backend's pool and slot-dense leaves as the plan holds
        them."""
        return blocks

    def kv_dims(self, cache: Cache) -> Dict[str, int]:
        """Per leaf path of a whole cache (a dense cache, or the paged
        backend's pools, at their full shapes): the dim over which this
        process holds only its model block, -1 where it holds the leaf
        whole."""
        return {p: -1 for p, _ in tree_leaves_with_names(cache)}

    def share_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[L, b, ...]``, the rows a decode step wrote, with every
        row's values: the identity unless the step computed only some rows
        here (a rank of a data shard)."""
        return x

    @property
    def egresses(self) -> bool:
        """Does this process send the engine's egress frames?"""
        return True

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Cache):
        """The model's decode step on what :meth:`compile_decode` hands the
        backend's step as its params."""
        return self.model.decode_step(params, tokens, cache)

    def prefill_step(self, params: Params, tokens: torch.Tensor,
                     cache: Cache):
        return self.model.prefill(params, {"tokens": tokens}, cache)

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
        model, prefill = self.model, self.prefill_step

        @torch.inference_mode()
        def _prefill(params, tokens, cache):
            if model.rows_coupled:
                b = tokens.shape[0]
                pad = (1 << (b - 1).bit_length()) - b
                if pad:
                    tokens = torch.cat([tokens, tokens.new_zeros(
                        (pad,) + tokens.shape[1:])])
                    cache = _pad_rows(cache, pad)
                logits, cache = prefill(params, tokens, cache)
                return logits[:b], _row_view(cache, 0, b)
            if tokens.shape[0] == 1:
                return prefill(params, tokens, cache)
            logits = [prefill(params, tokens[i:i + 1], _row_view(cache, i))[0]
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
    shards over ``data`` at rest in its ``data`` shards as a
    :class:`~repro_torch.distributed.sharding.Placed` (``placed[name]``:
    every shard's block on logical shards, the rank's own on a rank), every
    other leaf whole. ``full`` is the whole tree (on a rank: its ``model``
    slice of every leaf), its sharded leaves being the gather buffers
    (``buffers[name]``), allocated once and refilled by every gather.
    ``compute`` is what the step reads: ``full``, or under tensor
    parallelism the per-shard layer views
    (:meth:`TensorParallel.layer_params`)."""

    def __init__(self, full: Params, placed: Dict[str, Any],
                 buffers: Dict[str, torch.Tensor]):
        self.full = full
        self.placed = placed
        self.buffers = buffers
        self.compute: Any = full

    @property
    def sharded_bytes(self) -> int:
        """Bytes of the leaves sharded over ``data`` (what a gather
        writes)."""
        return sum(b.numel() * b.element_size() for b in self.buffers.values())


class ShardedPlan(ComputePlan):
    """One engine over a ``("data", "model")`` mesh
    (:func:`repro_torch.launch.mesh.make_host_mesh`): logical shards on one
    physical device, or ranks of an initialized ``torch.distributed`` world,
    one device each.

      - **batch** rows map to shards over ``data``: slot ``s`` belongs to
        shard ``s // (max_slots / dp)`` (:meth:`shard_of_slot`), which names
        its sealed KV (``/s{shard}``);
      - **params** are placed per
        :func:`repro_torch.distributed.sharding.param_specs` with FSDP forced
        on: each leaf sharded over ``data`` sits at rest in its ``data``
        shards (:func:`~repro_torch.distributed.sharding.place_leaf`), and
        before every decode step and prefill call the plan gathers them
        into full-size buffers (:meth:`gather`, through
        :func:`~repro_torch.distributed.sharding.gather_leaf`: a copy in
        device memory on logical shards, the ``data`` group's all-gather on
        ranks). A rank keeps only its ``model`` slice of every leaf;
      - **compute**: with ``tp == 1`` on logical shards the backend's
        unchanged batched step runs on the gathered weights, over the whole
        batch, in one call: every row's GEMM shapes, and with them its bits,
        are the single-device engine's (cuBLAS picks its kernel by the row
        count), and a MoE model's expert capacity is reckoned over the
        global batch as the reference's SPMD program reckons it. With
        ``tp > 1``, or over ranks, the decoder families'
        :class:`~repro_torch.distributed.tensor_parallel.TensorParallel`
        compute runs instead: each data shard steps its rows, each model
        shard its heads, ``d_ff`` block, experts, Mamba channels or rwkv6
        heads, reduced over ``model``. A rank's block of Mamba's ``w_in``
        is its x columns followed by the matching z columns
        (:meth:`_rank_slice`); every other leaf's is its ``param_specs``
        block;
      - the **KV cache** follows ``cache_specs`` (:meth:`place_dense_cache`,
        :meth:`kv_dims`): one copy on logical shards, whose model shards
        take views of their heads (or position blocks); on a rank its own
        heads (or block) of every row, and MLA's latent whole (computed
        identically on every model shard). The paged pool is one copy on
        logical shards; on a rank it is the rank's KV heads of every page,
        or the whole pool where the heads do not divide ``tp`` and for the
        latent, as the reference replicates its pool
        (:meth:`place_paged_cache`). The recurrent state (Mamba's ``conv``
        and ``ssm``, rwkv6's ``wkv``) is slot-dense on either backend: on a
        rank its channels or heads of every row, ``tmix_x``/``cmix_x``
        whole; a preempted row's state is gathered over ``model`` and
        sealed once, whole, under the logical run's names
        (``kvcache.RankSealer``).

    Each decode step counts ``collective_bytes_per_step``, the bytes moved
    into one shard: ``(dp - 1) / dp`` of the shard's part of every leaf
    sharded over ``data`` (the gather), plus what the tensor-parallel
    collectives move (the reductions over ``model``, the logits gathered
    over the vocabulary and over ``data``). The reference parses the bytes from its
    compiled HLO, so the two counts differ (ROADMAP.md queue C). Its seconds
    are the step's own gather and collectives, timed as they run (CUDA
    events on the card, the host clock on the CPU and around gloo): on
    logical shards copies and sums in device memory, not a link
    (:attr:`collective_measures`). Prefill calls gather and reduce too and
    are not counted, as in the reference."""

    is_sharded = True
    name = "sharded"

    def __init__(self, model, *, dp: int = 1, tp: int = 1):
        super().__init__(model)
        # deferred so a single-device engine never touches the mesh modules
        from repro_torch.distributed.tensor_parallel import TensorParallel
        from repro_torch.launch.mesh import make_host_mesh

        self.mesh = make_host_mesh(data=dp, model=tp, device=self.device)
        self.dp, self.tp = dp, tp
        self.ranks = self.mesh.spans_ranks
        self.tensor_parallel: Optional[TensorParallel] = (
            TensorParallel(model, self.mesh, local_cache=self.ranks)
            if tp > 1 or self.ranks else None)
        # param_specs with FSDP forced on: the spec table only reads
        # cfg.parallel.{fsdp, dp_over_model}
        self._spec_cfg = SimpleNamespace(parallel=SimpleNamespace(
            fsdp=True, dp_over_model=model.cfg.parallel.dp_over_model,
            zero1=False))
        # one entry a decode step since the last drain: (the bytes its
        # collectives moved, the time marks of its gather and collectives)
        self._pending: List[Tuple[int, List[Any]]] = []
        self._gather_bytes = 0
        self.collective_bytes_per_step = 0
        # a rank's KV holds every position (a paged pool) rather than its
        # block of them under sequence parallelism
        self._whole_seq = False

    @classmethod
    def from_spec(cls, model, spec: str) -> "ShardedPlan":
        dp, tp = parse_mesh(spec)
        return cls(model, dp=dp, tp=tp)

    def describe(self) -> str:
        if not self.ranks:
            return (f"dp={self.dp},tp={self.tp} ({self.mesh.size} shards on "
                    f"1 physical device, {self.device})")
        return f"dp={self.dp},tp={self.tp} ({self.mesh.describe()})"

    @property
    def collective_measures(self) -> str:
        """What the measured collective time is on this mesh."""
        return (self.mesh.world or self.mesh.groups["model"]).measures

    @property
    def egresses(self) -> bool:
        """Over ranks only global rank 0 sends egress frames."""
        return not self.ranks or self.mesh.rank_of(*self.mesh.coords) == 0

    def _groups(self):
        yield self.mesh.groups["data"]
        yield self.mesh.groups["model"]
        if self.mesh.world is not None:
            yield self.mesh.world

    def _take(self) -> Tuple[int, List[Any]]:
        return take_all(self._groups())

    # -- placement ----------------------------------------------------------
    def _rank_slice(self, leaf: torch.Tensor, spec, names) -> torch.Tensor:
        """A rank's own block of ``leaf`` (at key path ``names``) over
        ``model``, a copy in ``leaf``'s rank
        (:func:`~repro_torch.distributed.tensor_parallel.shard_leaf`: of
        Mamba's ``w_in`` its block of x's columns, then the matching block
        of z's)."""
        from repro_torch.distributed.tensor_parallel import shard_leaf

        if self.tp == 1:
            return leaf
        block = shard_leaf(leaf, spec, names, self.tp, self.mesh.coords[1])
        if block is leaf:
            return leaf
        return (block.flatten(-2).contiguous() if block.dim() > leaf.dim()
                else block.clone())

    @torch.inference_mode()
    def place_params(self, params: Params) -> ShardedWeights:
        """Place every leaf ``param_specs`` shards over ``data`` in its
        ``data`` shards (:func:`~repro_torch.distributed.sharding.place_leaf`;
        a rank keeps its ``model`` slice and its own block), count the bytes
        a gather moves into one shard, allocate the gather buffers, and take
        the tensor-parallel views. Weights this plan placed already are
        returned as they are (a rank may place its slice in turn before the
        engine is built on them)."""
        from repro_torch.distributed import sharding
        from repro_torch.distributed.tensor_parallel import (model_dim,
                                                             shard_views)

        if isinstance(params, ShardedWeights):
            return params
        params = super().place_params(params)
        specs = sharding.param_specs(self._spec_cfg, params, self.mesh)
        placed: Dict[str, sharding.Placed] = {}
        split: Dict[str, int] = {}

        def place(node, spec, path, names=()):
            if isinstance(node, dict):
                return {k: place(v, spec[k], f"{path}[{k!r}]", names + (k,))
                        for k, v in node.items()}
            if self.ranks:
                node = self._rank_slice(node, spec, names)
            if self.dp == 1 or "data" not in spec:
                return node
            only = tuple(a if a == "data" else None for a in spec)
            placed[path] = sharding.place_leaf(
                node, sharding.NamedSharding(self.mesh, only))
            # a logical shard's gather moves its own model slice
            split[path] = (self.tp if not self.ranks and model_dim(spec) >= 0
                           else 1)
            return path

        skeleton = place(params, specs, "")
        buffers = {p: torch.empty(x.shape, dtype=x.dtype, device=self.device)
                   for p, x in placed.items()}
        weights = ShardedWeights(_fill(skeleton, buffers), placed, buffers)
        shard_b = sum(b.numel() * b.element_size() // split[p]
                      for p, b in buffers.items())
        self._gather_bytes = shard_b * (self.dp - 1) // self.dp
        self.collective_bytes_per_step = self._gather_bytes
        tpd = self.tensor_parallel
        if tpd is not None:
            # a rank's tree is its own block already: its one shard
            shards = ([shard_views(weights.full, specs, 1, 0)] if self.ranks
                      else [shard_views(weights.full, specs, self.tp, m)
                            for m in self.mesh.groups["model"].local])
            weights.compute = tpd.layer_params(shards)
        return weights

    def kv_dims(self, cache: Cache) -> Dict[str, int]:
        """On a rank: the dim ``cache_specs`` shards over ``model`` for
        each leaf (the recurrent state's channels or heads included),
        except MLA's latent (whole on every model shard) and, when the
        backend is paged, the sequence dim of sequence-parallel ``k``/``v``
        (a pool's pages hold any positions, so a rank keeps them all).
        Logical shards hold every leaf whole."""
        if not self.ranks or self.tp == 1:
            return super().kv_dims(cache)
        from repro_torch.distributed import sharding
        from repro_torch.distributed.tensor_parallel import model_dim

        specs = sharding.cache_specs(self._spec_cfg, cache, self.mesh)
        dims = {}
        for path, spec in tree_leaves_with_names(specs):
            dim = model_dim(spec)
            if (path.endswith(("['ckv']", "['krope']"))
                    or (self._whole_seq and path.endswith(("['k']", "['v']"))
                        and dim == 2)):
                dim = -1
            dims[path] = dim
        return dims

    def share_rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.ranks and self.tensor_parallel is not None:
            return self.tensor_parallel.share_rows(x)
        return x

    def _rank_cache(self, cache: Cache) -> Cache:
        """A rank's block of every cache leaf over ``model``
        (:meth:`kv_dims`), copied."""
        dims = self.kv_dims(cache)

        def mine(path, leaf):
            dim = dims[path]
            if dim < 0:
                return leaf
            n = leaf.shape[dim] // self.tp
            return leaf.narrow(dim, self.mesh.coords[1] * n, n).clone()

        return tree_map_with_names(mine, cache)

    def place_dense_cache(self, cache: Cache) -> Cache:
        """Logical shards keep the one cache (each model shard takes views
        of its heads or position block); a rank keeps its own block of
        every leaf :meth:`kv_dims` splits. A rank keeps every row: it
        writes only its data shard's rows in a decode step."""
        tpd = self.tensor_parallel
        if tpd is not None and tpd.sp:
            max_len = next(t for _, t in tree_leaves_with_names(cache)
                           if t.dim() == 5).shape[2]
            if max_len % self.tp:
                raise ValueError(
                    f"sequence-parallel KV needs max_len ({max_len}) to "
                    f"divide by tp={self.tp}")
        if not self.ranks:
            return cache
        return self._rank_cache(cache)

    def place_paged_cache(self, blocks: Cache, paged_paths) -> Cache:
        """Logical shards keep the one pool. A rank keeps its KV heads of
        every page ``[L, P+1, page, hk/tp, hd]``, or the whole pool where
        the heads do not divide ``tp`` and for MLA's latent; the backend's
        prefill caches then hold every position as well, and the
        tensor-parallel step writes and reads them whole."""
        if not self.ranks:
            return blocks
        tpd = self.tensor_parallel
        if tpd.sp:
            self._whole_seq = True
            tpd.local_cache = False
        return self._rank_cache(blocks)

    @torch.inference_mode()
    def gather(self, weights: ShardedWeights) -> Any:
        """Rebuild the full weights: every sharded leaf gathered over
        ``data`` into its buffer (:func:`~repro_torch.distributed.sharding.
        gather_leaf`: on logical shards a copy in device memory). Returns
        what the step computes on (``weights.compute``)."""
        from repro_torch.distributed import sharding

        for path, x in weights.placed.items():
            sharding.gather_leaf(x, out=weights.buffers[path])
        # counted once, as the plan's gather bytes, and timed as one
        self.mesh.groups["data"].take()
        return weights.compute

    def _timed_gather(self, weights: ShardedWeights) -> Tuple[Any, Any]:
        """:meth:`gather` and its time mark."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            full = self.gather(weights)
            end.record()
            return full, (start, end)
        t0 = time.perf_counter()
        full = self.gather(weights)
        return full, time.perf_counter() - t0

    # -- callables ------------------------------------------------------------
    def decode_step(self, params, tokens, cache):
        if self.tensor_parallel is None:
            return super().decode_step(params, tokens, cache)
        return self.tensor_parallel.decode_step(params, tokens, cache)

    def prefill_step(self, params, tokens, cache):
        if self.tensor_parallel is None:
            return super().prefill_step(params, tokens, cache)
        return self.tensor_parallel.prefill(params, tokens, cache)

    def compile_prefill(self):
        prefill = super().compile_prefill()

        def run(weights, tokens, cache):
            return prefill(self.gather(weights), tokens, cache)

        return run

    def compile_decode(self, fn):
        """The backend's batched decode step on the gathered weights; each
        call counts one step of collective cost: its gather and its
        collectives, timed (what ran since the last step -- prefill calls,
        seals -- is not counted)."""
        step = super().compile_decode(fn)

        def run(weights, *args):
            self._take()
            compute, mark = self._timed_gather(weights)
            out = step(compute, *args)
            nbytes, marks = self._take()
            self._pending.append((nbytes, [mark] + marks))
            return out

        return run

    # -- collective accounting ------------------------------------------------
    def drain_collectives(self) -> Tuple[int, int, float]:
        """Steps, bytes and the measured seconds of their gathers and
        collectives since the last drain (on the card this waits for the
        last step's events; the engine drains after reading the step's
        tokens)."""
        pending, self._pending = self._pending, []
        if pending:
            self.collective_bytes_per_step = (self._gather_bytes
                                              + pending[-1][0])
        return (len(pending),
                sum(self._gather_bytes + b for b, _ in pending),
                sum(mark_seconds(m) for _, marks in pending for m in marks))

    def shard_of_slot(self, slot: int, max_slots: int) -> int:
        """Which data shard holds this slot's cache row: the ``/s{shard}``
        suffix per-shard sealing records."""
        if max_slots % self.dp != 0:
            return 0               # the rows do not split: replicated
        return int(slot) // (max_slots // self.dp)


def _fill(skeleton: Params, buffers: Dict[str, torch.Tensor]) -> Params:
    """The skeleton tree with each sharded leaf's name replaced by its
    buffer."""
    if isinstance(skeleton, dict):
        return {k: _fill(v, buffers) for k, v in skeleton.items()}
    return buffers[skeleton] if isinstance(skeleton, str) else skeleton
