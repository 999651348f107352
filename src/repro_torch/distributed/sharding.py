"""Sharding rules (port of ``repro.distributed.sharding``): map every param
and cache leaf to a spec.

A spec is a plain tuple with one entry per dim: an axis name, a tuple of
axis names, or None (where the reference has a ``PartitionSpec``). The rules
are the reference's, table and all (the mesh plan places weights by
``param_specs`` and a rank's KV cache by ``cache_specs``; ``batch_specs``
is kept, tested against the reference, for the sharded trainer of
ROADMAP.md queue A item 21 part 2):
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
``zero1``); ``to_named`` pairs a spec tree with its mesh, the placement a
sharded trainer (ROADMAP.md queue A item 21 part 2) would read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.sealing import tree_map

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
