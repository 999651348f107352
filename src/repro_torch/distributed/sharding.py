"""Sharding rules (port of ``repro.distributed.sharding``): map every param,
train-state, batch and cache leaf to a spec, and place a tree on a mesh.

A spec is a plain tuple with one entry per dim: an axis name, a tuple of
axis names, or None (where the reference has a ``PartitionSpec``). The rules
are the reference's, table and all (the mesh plan places weights by
``param_specs`` and a rank's KV cache by ``cache_specs``; the sharded
trainer places its state by ``state_specs`` and splits its batch by
``batch_specs``):
  * TP over ``model``: attention heads, MLP hidden, MoE experts, vocab;
  * FSDP over ``data`` for the replicated remainder when
    ``cfg.parallel.fsdp`` (the embed/d_model dims);
  * DP over ``data`` (x ``pod`` when multi-pod) for the batch;
  * SP for long decode: the KV/latent cache's sequence dim over ``model``
    when the KV-head count does not divide the model axis.

Rules are structural, matched by leaf name and enclosing module path, so
one table covers every architecture. A dim that does not divide its mesh
axes falls back to replication. Only ``mesh.shape`` and
``mesh.axis_names`` are read. ``state_specs`` gives a train state's specs
(the moments follow their params, or shard over ``data`` alone under
``zero1``); ``to_named`` pairs a spec tree with its mesh.

:func:`place` is the port's ``jax.device_put(tree, named)``: every leaf
goes to rest in its shards as a :class:`Placed` leaf, which holds only the
blocks of the shards this process computes (every shard's on logical
shards, the rank's own on a rank); :func:`gather` rebuilds whole leaves
through the mesh's collective groups. :func:`block` is the block arithmetic
both share with the mesh plan's weights (``runtime/plan.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core.sealing import tree_leaves_with_names, tree_map

Params = Any
Spec = Tuple[Any, ...]

# spec symbols
M = "model"     # tensor-parallel axis
F = "__fsdp__"  # data axis iff cfg.parallel.fsdp else None
N = None

# top-level keys whose subtrees are layer-stacked (leading layer dim)
STACKED = {"layers", "moe_layers", "dense_layers", "groups",
           "enc_layers", "dec_layers"}

# (context key, leaf name) -> base spec (no stacking dim). Context "" matches
# any. First match wins; contexts are checked innermost-first.
RULES: Dict[Tuple[str, str], Tuple] = {
    # embedding / unembedding
    ("", "table"): (M, F),
    # attention (attn / self_attn / cross_attn share leaf names)
    ("", "wq"): (F, M, N),
    ("", "wk"): (F, M, N),
    ("", "wv"): (F, M, N),
    ("", "wo"): (M, N, F),
    # swiglu / shared experts
    ("", "w_gate"): (F, M),
    ("", "w_up"): (F, M),
    ("", "w_down"): (M, F),
    # gelu mlp
    ("", "w_in"): (F, M),
    ("", "b_in"): (M,),
    ("", "w_out"): (M, F),
    ("", "b_out"): (N,),
    # moe
    ("", "router"): (N, N),
    ("experts", "w_gate"): (M, F, N),
    ("experts", "w_up"): (M, F, N),
    ("experts", "w_down"): (M, N, F),
    # mla
    ("mla", "w_dq"): (F, N),
    ("mla", "w_uq"): (N, M, N),
    ("mla", "w_dkv"): (F, N),
    ("mla", "w_uk"): (N, M, N),
    ("mla", "w_uv"): (N, M, N),
    ("mla", "wo"): (M, N, F),
    # mamba
    ("mamba", "w_in"): (F, M),
    ("mamba", "conv_w"): (N, M),
    ("mamba", "conv_b"): (M,),
    ("mamba", "w_bcdt"): (M, N),
    ("mamba", "w_dt"): (N, M),
    ("mamba", "dt_bias"): (M,),
    ("mamba", "a_log"): (M, N),
    ("mamba", "d_skip"): (M,),
    ("mamba", "w_out"): (M, F),
    # rwkv time mix
    ("tmix", "w_r"): (N, M),
    ("tmix", "w_k"): (N, M),
    ("tmix", "w_v"): (N, M),
    ("tmix", "w_g"): (N, M),
    ("tmix", "w_o"): (M, N),
    ("decay_lora", "a"): (N, N),
    ("decay_lora", "b"): (N, M),
    ("tmix", "decay_base"): (M,),
    # rwkv channel mix
    ("cmix", "w_k"): (N, M),
    ("cmix", "w_v"): (M, N),
    ("cmix", "w_r"): (N, M),
}


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        size = 1
        for a in axis:
            size *= mesh.shape[a]
        return size
    return mesh.shape[axis]


def _fit(mesh, shape: Tuple[int, ...], spec: Tuple) -> Spec:
    """Replace any axis that does not evenly divide its dim with None; a
    one-axis tuple becomes that axis, as ``PartitionSpec`` normalizes it."""
    fitted = []
    for dim, axis in zip(shape, spec):
        if axis is None or dim % _axis_size(mesh, axis) != 0:
            fitted.append(None)
        elif isinstance(axis, tuple) and len(axis) == 1:
            fitted.append(axis[0])
        else:
            fitted.append(axis)
    return tuple(fitted)


def _map_with_names(fn, tree, names: Tuple[str, ...] = ()):
    """``fn(names, leaf)`` over a nested dict, ``names`` the keys from the
    root (the reference's ``_path_names`` of the leaf's path)."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    return fn(names, tree)


def _base_spec(names: Tuple[str, ...]) -> Optional[Tuple]:
    leaf = names[-1]
    context = names[:-1]
    for ctx in reversed(context):
        if (ctx, leaf) in RULES:
            return RULES[(ctx, leaf)]
    return RULES.get(("", leaf))


def param_specs(cfg, params: Params, mesh) -> Params:
    """Spec tree matching ``params`` (any leaves with ``.shape`` and
    ``.ndim``: tensors, meta tensors, numpy arrays).

    With ``dp_over_model`` (attention-free archs): the model axis joins data
    parallelism, so TP dims are dropped and FSDP over ``data`` is forced."""
    dp_over_model = cfg.parallel.dp_over_model
    fsdp_axis = "data" if (cfg.parallel.fsdp or dp_over_model) else None

    def spec_for(names, leaf):
        stacked = bool(names) and names[0] in STACKED
        base = _base_spec(names)
        if base is None:
            base = (N,) * (leaf.ndim - (1 if stacked else 0))
        if dp_over_model:
            base = tuple(None if a == M else a for a in base)
        base = tuple(fsdp_axis if a == F else a for a in base)
        full = ((None,) + base) if stacked else base
        # pad/truncate defensively to leaf rank
        full = (tuple(full) + (None,) * leaf.ndim)[:leaf.ndim]
        return _fit(mesh, tuple(leaf.shape), full)

    return _map_with_names(spec_for, params)


def state_specs(cfg, abstract_state, mesh):
    """TrainState(params, OptState(m, v, step)) -> the same structure of
    specs: the moments follow their params, the step is replicated (``()``).

    With ``zero1``: the params keep their layout, but a moment whose
    leading dim divides the ``data`` axis shards that dim over ``data``
    alone (ZeRO-1: reduce-scatter the grads, update a shard, all-gather the
    params, without FSDP's gathers at every use)."""
    p_specs = param_specs(cfg, abstract_state.params, mesh)
    if cfg.parallel.zero1:
        def m_spec(pspec, leaf):
            if leaf.ndim and leaf.shape[0] % mesh.shape["data"] == 0:
                return ("data",) + (None,) * (leaf.ndim - 1)
            return pspec
        m_specs = tree_map(m_spec, p_specs, abstract_state.opt.m)
    else:
        m_specs = p_specs
    return type(abstract_state)(
        params=p_specs,
        opt=type(abstract_state.opt)(m=m_specs, v=m_specs, step=()),
    )


def _batch_axis_for(cfg, mesh, batch_dim: int):
    """Pick the widest dp axis combo that divides the batch. With
    dp_over_model the model axis joins DP (flat data parallelism)."""
    dp = dp_axes(mesh)
    candidates = ([dp + ("model",), ("data", "model"), dp, ("data",)]
                  if cfg.parallel.dp_over_model else [dp, ("data",)])
    for cand in candidates:
        if all(a in mesh.axis_names for a in cand) \
                and batch_dim % _axis_size(mesh, cand) == 0:
            return cand
    return None


def batch_specs(cfg, batch: Dict[str, Any], mesh) -> Dict[str, Spec]:
    def spec_for(names, leaf):
        axis = _batch_axis_for(cfg, mesh, leaf.shape[0])
        base = (axis,) + (None,) * (leaf.ndim - 1)
        return _fit(mesh, tuple(leaf.shape), base)

    return _map_with_names(spec_for, batch)


def cache_specs(cfg, cache: Params, mesh) -> Params:
    """Decode/prefill cache sharding.

    Batch over dp; KV heads over ``model`` when they divide it, otherwise SP:
    the sequence dim shards over ``model`` (distributed-softmax attention).
    States (mamba/rwkv) shard their channel dim over ``model``.
    """
    model_size = mesh.shape.get("model", 1)
    if cfg.parallel.dp_over_model:
        model_size = 1  # model axis joins DP; no channel sharding

    def spec_for(names, leaf):
        shape = tuple(leaf.shape)
        leaf_name = names[-1]
        if leaf_name == "pos":
            dp = _batch_axis_for(cfg, mesh, shape[0])
            return _fit(mesh, shape, (dp,))
        dp = _batch_axis_for(cfg, mesh,
                             shape[1] if leaf.ndim > 1 else shape[0])
        M_ = None if cfg.parallel.dp_over_model else M
        if leaf_name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
            # [L, B, S, hk, hd]
            hk = shape[3]
            if model_size > 1 and hk % model_size == 0:
                return _fit(mesh, shape, (None, dp, None, M_, None))
            return _fit(mesh, shape, (None, dp, M_, None, None))
        if leaf_name in ("ckv", "krope"):
            # [L, B, S, r]: the latent is per-token shared, SP over model
            return _fit(mesh, shape, (None, dp, M_, None))
        if leaf_name == "conv":      # [L, B, d_conv-1, d_inner]
            return _fit(mesh, shape, (None, dp, None, M_))
        if leaf_name == "ssm":       # [L, B, d_inner, d_state]
            return _fit(mesh, shape, (None, dp, M_, None))
        if leaf_name == "wkv":       # [L, B, h, k, v]
            return _fit(mesh, shape, (None, dp, M_, None, None))
        if leaf_name in ("tmix_x", "cmix_x"):  # [L, B, d]
            return _fit(mesh, shape, (None, dp, None))
        return _fit(mesh, shape, (None,) * leaf.ndim)

    return _map_with_names(spec_for, cache)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Spec


def to_named(mesh, spec_tree: Params) -> Params:
    """Every spec of a spec tree (dicts and NamedTuples of tuples) paired
    with ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# placement: a tree at rest in its shards, and gathered back whole
# ---------------------------------------------------------------------------

def axis_index(mesh, axis, coords) -> int:
    """The block index along a spec entry of the shard at ``coords``
    (``(data, model)``): its coordinate on that axis, or on a tuple of axes
    their row-major combination (jax's order); 0 for None."""
    if axis is None:
        return 0
    idx = 0
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        idx = idx * mesh.shape[a] + coords[mesh.axis_names.index(a)]
    return idx


def block_key(mesh, spec: Spec, coords) -> Tuple[int, ...]:
    """The block index, one a dim, that the shard at ``coords`` holds."""
    return tuple(axis_index(mesh, a, coords) for a in spec)


def narrow(leaf: torch.Tensor, spec: Spec, mesh,
           key: Tuple[int, ...]) -> torch.Tensor:
    """The block of ``leaf`` at block index ``key`` (a view)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = leaf.shape[dim] // _axis_size(mesh, axis)
            leaf = leaf.narrow(dim, key[dim] * n, n)
    return leaf


def block(leaf: torch.Tensor, spec: Spec, mesh, coords,
          axes: Iterable[str] = ("data", "model")) -> torch.Tensor:
    """The block of ``leaf`` that the shard at ``coords`` holds under
    ``spec``, split over ``axes`` only (a view)."""
    axes = set(axes)
    kept = tuple(a if a is not None and set(
        a if isinstance(a, tuple) else (a,)) <= axes else None for a in spec)
    return narrow(leaf, kept, mesh, block_key(mesh, kept, coords))


def local_coords(mesh):
    """The coordinates (one index a mesh axis) this process computes:
    every shard's on logical shards, the rank's own on a rank."""
    if mesh.spans_ranks:
        return [tuple(mesh.coords)]
    return [(d, m) for d in range(mesh.shape["data"])
            for m in range(mesh.shape["model"])]


class Placed:
    """One leaf at rest in its shards (a ``NamedSharding``'s placement):
    ``blocks[key]`` is the block at block index ``key`` (one index a dim,
    :func:`block_key`), separately allocated on the mesh's device, for the
    shards this process computes. Logical shards that hold the same block
    (a replicated dim) share one copy of it."""

    def __init__(self, named: "NamedSharding", shape, dtype,
                 blocks: Dict[Tuple[int, ...], torch.Tensor]):
        self.named = named
        self.shape = tuple(shape)
        self.dtype = dtype
        self.blocks = blocks

    @property
    def device(self) -> torch.device:
        return self.named.mesh.device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def shard(self, coords) -> torch.Tensor:
        """The block the shard at ``coords`` holds."""
        return self.blocks[block_key(self.named.mesh, self.named.spec,
                                     coords)]

    def __repr__(self) -> str:
        return (f"Placed(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.named.spec}, blocks={len(self.blocks)})")


def place_leaf(leaf, named: "NamedSharding") -> Placed:
    """``leaf`` (a tensor or array, or a :class:`Placed` leaf, gathered
    first) at rest in the shards of ``named``."""
    if isinstance(leaf, Placed):
        leaf = gather_leaf(leaf)
    mesh, spec = named.mesh, tuple(named.spec)
    leaf = torch.as_tensor(leaf).to(mesh.device)
    blocks: Dict[Tuple[int, ...], torch.Tensor] = {}
    for coords in local_coords(mesh):
        key = block_key(mesh, spec, coords)
        if key not in blocks:
            blocks[key] = narrow(leaf, spec, mesh, key).clone(
                memory_format=torch.contiguous_format)
    return Placed(named, leaf.shape, leaf.dtype, blocks)


def place_abstract(tree: Params, named: Params) -> Params:
    """Every leaf of ``tree`` (shapes and dtypes: meta tensors) as a
    :class:`Placed` leaf of empty blocks on the mesh's device, the blocks
    of the shards this process computes (the dry run places its state so,
    under fake tensors)."""
    def one(leaf, nm):
        mesh, spec = nm.mesh, tuple(nm.spec)
        blocks: Dict[Tuple[int, ...], torch.Tensor] = {}
        shape = [d // _axis_size(mesh, a) for d, a in zip(leaf.shape, spec)]
        for coords in local_coords(mesh):
            key = block_key(mesh, spec, coords)
            if key not in blocks:
                blocks[key] = torch.empty(shape, dtype=leaf.dtype,
                                          device=mesh.device)
        return Placed(nm, leaf.shape, leaf.dtype, blocks)

    return tree_map(one, tree, named)


def _merge(x: Placed, dims, out: Optional[torch.Tensor] = None
           ) -> Dict[Tuple[int, ...], torch.Tensor]:
    """``x``'s blocks merged along ``dims`` (each all-gathered over its
    axis's group in turn; on logical shards a concatenation, on ranks the
    group's all-gather), the last one into ``out`` when given: {block key
    with those dims at 0: merged block}. The bytes into one shard are
    counted once (a logical mesh concatenates the same dim for every block
    of the others)."""
    mesh, spec = x.named.mesh, tuple(x.named.spec)
    blocks = x.blocks
    for dim in dims:
        group = mesh.group(spec[dim])
        counting = group.counting
        rests = sorted({k[:dim] + (0,) + k[dim + 1:] for k in blocks})
        merged = {}
        try:
            for j, rest in enumerate(rests):
                group.counting = counting and j == 0
                merged[rest] = group.all_gather(
                    [blocks[rest[:dim] + (i,) + rest[dim + 1:]]
                     for i in group.local], dim,
                    out=out if dim == dims[-1] else None)
        finally:
            group.counting = counting
        blocks = merged
    return blocks


@torch.no_grad()
def gather_leaf(x: Placed, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The whole leaf: every sharded dim merged (:func:`_merge`), the last
    one into ``out`` when given (a buffer refilled at every gather)."""
    (whole,) = _merge(x, [d for d, axis in enumerate(x.named.spec)
                          if axis is not None], out).values()
    if out is not None and whole is not out:
        out.copy_(whole)
    return whole if out is None else out


@torch.no_grad()
def gather_over(x: Placed, axis: str) -> Dict[int, torch.Tensor]:
    """``x`` gathered over ``axis`` alone, by its block index along the
    dim sharded over the other axis (0 where none is): on a mesh's
    ``data`` axis each local model shard's block whole over ``data``.
    Every spec entry of ``x`` names one axis at most."""
    spec = tuple(x.named.spec)
    if any(isinstance(a, tuple) for a in spec):
        raise ValueError(f"gather_over takes one axis a dim, not {spec}")
    other = [d for d, a in enumerate(spec) if a not in (None, axis)]
    merged = _merge(x, [d for d, a in enumerate(spec) if a == axis])
    return {(k[other[0]] if other else 0): t for k, t in merged.items()}


def place(tree: Params, named: Params) -> Params:
    """Every leaf of ``tree`` at rest in the shards of the matching
    ``NamedSharding`` of ``named`` (the reference's ``jax.tree.map(
    jax.device_put, tree, named)``); a leaf placed already moves to the new
    shards (gathered, then placed)."""
    return tree_map(place_leaf, tree, named)


def gather(tree: Params) -> Params:
    """``tree`` with every :class:`Placed` leaf gathered whole (a
    collective over ranks: every rank of the mesh calls it)."""
    return tree_map(lambda x: gather_leaf(x) if isinstance(x, Placed)
                    else x, tree)


def placement(tree: Params) -> Optional[Params]:
    """The ``NamedSharding`` tree a placed tree rests in, or None when no
    leaf is placed."""
    named = tree_map(lambda x: x.named if isinstance(x, Placed) else None,
                     tree)
    if all(n is None for _, n in tree_leaves_with_names(named)):
        return None
    return named


def mesh_of(tree: Params):
    """The mesh of a placed tree's first placed leaf, or None."""
    for _, leaf in tree_leaves_with_names(tree):
        if isinstance(leaf, Placed):
            return leaf.named.mesh
    return None


def shard_nbytes(tree: Params, coords) -> int:
    """Bytes the shard at ``coords`` holds of a placed tree."""
    return sum(leaf.shard(coords).numel() * leaf.shard(coords).element_size()
               for _, leaf in tree_leaves_with_names(tree)
               if isinstance(leaf, Placed))
