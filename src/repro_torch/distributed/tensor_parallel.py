"""Tensor-parallel compute over a mesh's ``model`` axis: serving the
decoder families (dense, vlm, moe with attention or MLA, hybrid: jamba's
Mamba + attention + MoE, and ssm: rwkv6; :class:`TensorParallel`) and
training every family, whisper included (:class:`TensorParallelLoss`).
The reference has no such file: XLA partitions its program by the specs
and inserts the collectives.

Each model shard holds the slices :func:`~repro_torch.distributed.sharding.
param_specs` gives it over ``model``: query heads ``[s*h/tp, (s+1)*h/tp)``
of ``wq`` and ``wo``, KV heads ``[s*hk/tp, (s+1)*hk/tp)`` of ``wk``/``wv``
(contiguous blocks keep GQA's grouping), the matching ``d_ff`` block of
``w_gate``/``w_up``/``w_down`` (a dense layer's, or the shared experts'),
experts ``[s*E/tp, (s+1)*E/tp)`` of a MoE layer, the heads of MLA's
``w_uq``/``w_uk``/``w_uv``/``wo``, Mamba's channels ``[s*di/tp,
(s+1)*di/tp)`` (of ``w_in`` the block of x's columns and the matching
block of z's, :func:`shard_leaf`), rwkv6's heads of the time mix and
``d_ff`` block of the channel mix, and a vocabulary block of the embedding
table. On logical shards these are views of the placed weights; on a rank
they are the rank's own tensors. :class:`TensorParallel` walks the
model's blocks (``transformer._blocks``) and dispatches each ``(mixer,
ffn)`` slot:

    norm -> every local shard's mixer partial -> all-reduce -> residual add
    norm -> every local shard's FFN partial   -> all-reduce -> residual add

with the all-reduce an all-gather and a sum in rank order
(:mod:`repro_torch.distributed.collectives`). The embedding is a masked
lookup in the shard's vocabulary block plus the all-reduce (exact: one
shard holds each row), the unembedding gives each shard's f32 logits for
its block, gathered along the vocabulary (exact).

  * **attn** (dense, vlm, dbrx): each shard's heads; qk-norm normalises
    each head on its own, so a shard's head slice normalises as the whole.
  * **mla** (deepseek-v3): each shard's query heads and its heads of
    ``w_uk``/``w_uv``/``wo``; ``w_dq`` and ``w_dkv`` are replicated, so
    every shard computes the same latent ``ckv``/``krope`` rows. The port
    keeps the latent whole on every model shard rather than splitting its
    sequence over ``model`` as the reference's ``cache_specs`` does: the
    rows are computed identically everywhere, the latent is a few hundred
    values a token (576 at deepseek-v3's width), and keeping it whole
    spares every layer of every step a distributed softmax and a gather of
    the absorbed queries. Each shard attends with its own heads over the
    whole latent, applies its ``w_uv`` and ``wo``, and the partials are
    reduced.
  * **swiglu**: the shard's ``d_ff`` block.
  * **moe**: every shard routes **all** the call's tokens with the
    replicated f32 router, so top-k, the stable sort, the capacity and the
    drops are one device's (:func:`~repro_torch.models.moe.moe_ffn_tokens`
    with the shard's expert range); a shard computes the kept pairs whose
    expert it holds plus its ``d_ff`` block of the shared experts.
  * **mamba** (jamba): each shard's channels, conv and scan included;
    ``xi @ w_bcdt`` contracts over the channels, so the shards' f32
    partials are reduced (and cast once) before B, C and dt split off
    (:func:`~repro_torch.models.ssm.mamba_shards`); ``w_out``'s rows give
    the partial the mixer's reduction sums.
  * **rwkv** (time mix): each shard's heads and its heads of the
    replicated ``bonus``; ``ln_out`` normalises over all of ``d``, so the
    heads' outputs are gathered over ``model`` and the one-device
    layernorm runs on the whole row; each shard gates its block and
    applies its ``w_o`` rows (:func:`~repro_torch.models.ssm.
    rwkv6_time_mix_shards`). Its norms are layernorms, and ``ln0`` follows
    the embedding (replicated: it moves nothing).
  * **cmix** (rwkv6's channel mix): ``vv`` is a ``d_ff`` partial, reduced;
    the receptance is a ``d`` block, gathered in f32; their product is
    whole on every shard (no reduction after it).

The recurrent state follows :func:`~repro_torch.distributed.sharding.
cache_specs`: a shard's channels of Mamba's ``conv`` and ``ssm``, its heads
of ``wkv``; rwkv6's ``tmix_x``/``cmix_x`` rows are whole and written once.
The KV cache follows :func:`~repro_torch.distributed.sharding.cache_specs`
for attention. When the KV heads divide the axis, shard ``s`` holds KV
heads ``s`` of the cache. Otherwise (sequence parallelism) every shard
attends over a contiguous block of ``max_len / tp`` positions for every KV
head: the query heads are gathered over ``model`` and attention is the
distributed softmax -- each shard's ``(o, max, sum)`` over its block,
merged in rank order. ``local_cache`` says what a rank holds: its own
heads or block (the slot layout), or every position (a paged pool over
ranks in the SP case, which a rank keeps whole), in which case every rank
writes every new row and attends over its block.

Over ``data`` each data shard computes its own rows of a decode step (the
batch split in ``dp`` contiguous blocks when it divides) and the rows'
logits are gathered over ``data``, so every shard samples every row with
the same bits. A MoE layer still routes the step's global rows, as the
reference's SPMD program does (capacity depends on the token count): the
data shards' normed inputs are gathered over ``data``, routed together,
and each data shard keeps its rows' outputs. A prefill call runs whole on
every data shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from torch.utils import checkpoint as torch_checkpoint

from repro_torch.distributed import collectives, sharding
from repro_torch.models import layers, mla, moe, ssm, transformer
from repro_torch.models.transformer import (_layer, _layers, _mamba_cfg,
                                            _mla_cfg, _moe_cfg, _rwkv_cfg,
                                            _store)

Params = Any


def refuse_family(cfg) -> None:
    """A serving mesh covers the decoder families: dense, vlm, moe
    (attention or MLA), hybrid and ssm. The encoder-decoder trains on a
    mesh (:class:`TensorParallelLoss`) but is served on none."""
    if cfg.family == "encdec" or cfg.embedding_inputs:
        raise NotImplementedError(
            f"serving the {cfg.family} family ({cfg.name}) on a mesh: "
            f"neither package serves this family (both serving launchers "
            f"refuse it), so a serving mesh takes the dense, vlm, moe, "
            f"hybrid and ssm families only")


def replicated_kinds(cfg, tp: int, kinds) -> set:
    """The layer kinds of ``kinds`` whose head count ``tp`` does not
    divide: attention's query heads (whisper-small's 12 on ``model=16``)
    or rwkv6's heads (rwkv6-3b's 40). As the reference's ``_fit`` leaves
    such a dim whole, the part runs whole on every model shard: its leaves
    that the spec still splits (rwkv6's ``d``-wide projections) are
    gathered over ``model`` first, its output is not reduced, and in
    training its gradients need no reduction over ``model``."""
    out = set()
    if kinds & {"attn", "mla"} and cfg.num_heads % tp:
        out.add("attn")
    if "rwkv" in kinds and _rwkv_cfg(cfg).num_heads % tp:
        out.add("rwkv")
    return out


def check_divides(cfg, tp: int, kinds) -> None:
    """Raise unless ``tp`` divides every count the layer kinds ``kinds``
    split over ``model``; a kind of :func:`replicated_kinds` runs whole and
    splits nothing."""
    kinds = set(kinds)
    rep = replicated_kinds(cfg, tp, kinds)
    need = {}
    if kinds & {"attn", "mla"} and "attn" not in rep:
        need["query heads"] = cfg.num_heads
    if kinds & {"swiglu", "cmix", "gelu"}:
        need["d_ff"] = cfg.d_ff
    if "moe" in kinds:
        need["experts"] = cfg.moe.num_experts
        if cfg.moe.num_shared_experts:
            need["shared experts' d_ff"] = (cfg.moe.d_ff_expert
                                            * cfg.moe.num_shared_experts)
    if "mamba" in kinds:
        need["Mamba's d_inner"] = _mamba_cfg(cfg).d_inner
    bad = {k: v for k, v in need.items() if v % tp}
    if bad:
        raise ValueError(
            f"tp={tp} must divide the "
            + " and ".join(f"{k} ({v})" for k, v in bad.items())
            + f" of {cfg.name}")


def whole_leaves(subs, full, gather):
    """A replicated part's params whole (:func:`replicated_kinds`): each
    leaf of the local shards' subtrees ``subs`` that is a block over
    ``model`` -- shorter on one dim than its ``full`` counterpart, a
    layer-stacked meta tree -- gathered along that dim by ``gather(parts,
    dim)``; a whole leaf is the first shard's."""
    out = {}
    for k, f in full.items():
        if isinstance(f, dict):
            out[k] = whole_leaves([t[k] for t in subs], f, gather)
            continue
        leaf, shape = subs[0][k], tuple(f.shape[1:])
        diff = [i for i, (a, b) in enumerate(zip(leaf.shape, shape))
                if a != b]
        out[k] = gather([t[k] for t in subs], diff[0]) if diff else leaf
    return out


def layer_kinds(impl) -> set:
    """The mixer and FFN kinds of a decoder's layer slots."""
    return {k for _, _, slots in impl.blocks for pair in slots for k in pair}


def model_dim(spec) -> int:
    """The dim a spec shards over ``model`` (-1 for none)."""
    for i, axis in enumerate(spec):
        if axis == "model" or (isinstance(axis, tuple) and "model" in axis):
            return i
    return -1


def shard_leaf(leaf: torch.Tensor, spec, names, tp: int,
               shard: int) -> torch.Tensor:
    """Shard ``shard``'s block over ``model`` of the leaf at key path
    ``names``, a view: its ``spec`` block, except that of Mamba's ``w_in``
    ``[..., d, 2 * di]`` (x's columns, then z's) it is the shard's block
    of x's columns and the matching block of z's, as ``[..., d, 2, di /
    tp]`` (a contiguous column block would give shard 0 all of x and shard
    1 all of z). A rank keeps that block flat, x's columns then z's, so
    ``tp=1, shard=0`` views a rank's own ``w_in`` so too."""
    dim = model_dim(spec)
    if dim < 0:
        return leaf
    if tuple(names[-2:]) == ("mamba", "w_in"):
        leaf, dim = leaf.unflatten(-1, (2, -1)), leaf.dim()
    n = leaf.shape[dim] // tp
    return leaf.narrow(dim, shard * n, n)


def shard_views(params: Params, specs: Params, tp: int, shard: int,
                names=()) -> Params:
    """Shard ``shard``'s slice of every leaf over ``model``
    (:func:`shard_leaf`): views, no copies."""
    if isinstance(params, dict):
        return {k: shard_views(v, specs[k], tp, shard, names + (k,))
                for k, v in params.items()}
    return shard_leaf(params, specs, names, tp, shard)


class TensorParallel:
    """The decoder families' decode step and prefill over a mesh's
    ``model`` (and ``data``) groups; see the module docstring.
    ``local_cache`` says whether the KV handed in holds this process's
    shard only (a rank) or every shard (logical shards: each takes its
    views; or a rank's whole paged pool under sequence parallelism). The
    recurrent-state leaves hold every shard's channels or heads on logical
    shards and a rank's own on a rank, whatever the backend."""

    def __init__(self, model, mesh, local_cache: bool):
        cfg = model.cfg
        refuse_family(cfg)
        self.cfg, self.impl = cfg, model._impl
        self.tp = mesh.shape["model"]
        # the batch's data shards: ``data``, led by ``pod`` on a multi-pod
        # mesh
        self.mg = mesh.groups["model"]
        self.dg = mesh.group(sharding.dp_axes(mesh))
        self.dp = self.dg.size
        # every layer in order: (block, repeat, slot key, mixer, ffn)
        self.slots = [(name, j, f"slot_{i}", m, f)
                      for name, n, slots in self.impl.blocks
                      for j in range(n) for i, (m, f) in enumerate(slots)]
        kinds = layer_kinds(self.impl)
        h, hk = cfg.num_heads, cfg.num_kv_heads
        check_divides(cfg, self.tp, kinds)
        self.replicated = replicated_kinds(cfg, self.tp, kinds)
        if "attn" in self.replicated:
            raise ValueError(f"tp={self.tp} must divide the query heads "
                             f"({h}) of {cfg.name} to serve it")
        # the layer-stacked meta params, for the replicated parts' shapes
        self.full = model.abstract_params() if self.replicated else None
        self.sp = "attn" in kinds and hk % self.tp != 0
        self.heads = h // self.tp
        self.acfg = dataclasses.replace(
            self.impl.acfg, num_heads=self.heads,
            num_kv_heads=hk if self.sp else hk // self.tp)
        self.mcfg = _moe_cfg(cfg) if "moe" in kinds else None
        self.vocab_split = cfg.vocab_size % self.tp == 0
        self.local_cache = local_cache
        self.mesh, self.ranks = mesh, mesh.spans_ranks
        self._dims: Dict[tuple, Dict[str, int]] = {}

    # -- params ----------------------------------------------------------------
    def layer_params(self, shards: List[Params]) -> List[Dict[str, Any]]:
        """Per local model shard: its embedding, final norm and per-layer
        dicts in :attr:`slots` order (views into ``shards``, stable across
        steps since the plan refills gathered weights in place) and
        rwkv6's ``ln0``."""
        return [{"embedding": tree["embedding"]["table"],
                 "final_norm": tree["final_norm"],
                 "ln0": tree.get("ln0"),
                 "layers": [_layer(tree[name], j)[slot]
                            for name, j, slot, _, _ in self.slots]}
                for tree in shards]

    # -- cache views ------------------------------------------------------------
    def _cache_dims(self, cl: Params) -> Dict[str, int]:
        """The dim of each of a layer's cache views ``[b, ...]`` that
        ``cache_specs`` shards over ``model`` past the batch (-1: none),
        except MLA's latent, whole on every shard."""
        dims = self._dims.get(tuple(cl))
        if dims is None:
            specs = sharding.cache_specs(
                self.cfg, {k: v[None] for k, v in cl.items()}, self.mesh)
            dims = {k: -1 if k in ("ckv", "krope") or model_dim(s[2:]) < 0
                    else model_dim(s[2:]) + 1 for k, s in specs.items()}
            self._dims[tuple(cl)] = dims
        return dims

    def _cache_shard(self, cl: Params, shard: int) -> Params:
        """Shard ``shard``'s part of a layer's cache views, by
        :meth:`_cache_dims`: of the ``[b, max_len, hk, hd]`` KV its heads,
        or under sequence parallelism its block of positions (unless the
        cache is local); of the recurrent state its channels or heads
        (unless on a rank, which holds only its own). rwkv6's
        ``tmix_x``/``cmix_x`` are whole on every shard."""
        if self.tp == 1:
            return cl
        out = dict(cl)
        for k, dim in self._cache_dims(cl).items():
            local = self.local_cache if k in ("k", "v") else self.ranks
            if dim >= 0 and not local:
                n = cl[k].shape[dim] // self.tp
                out[k] = cl[k].narrow(dim, shard * n, n)
        return out

    # -- embedding / unembedding ------------------------------------------------
    def _embed(self, lps, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding (a masked lookup in each shard's vocabulary
        block, reduced), then rwkv6's replicated ``ln0``."""
        if not self.vocab_split or self.tp == 1:
            x = layers.embed({"table": lps[0]["embedding"]}, tokens)
        else:
            x = self.mg.all_reduce(lookup_parts(
                [lp["embedding"] for lp in lps], self.mg.local, tokens))
        if self.cfg.family == "ssm":
            x = layers.layernorm(lps[0]["ln0"], x, self.cfg.norm_eps)
        return x

    def _unembed(self, lps, x: torch.Tensor) -> torch.Tensor:
        norm = layers.layernorm if self.cfg.family == "ssm" else layers.rmsnorm
        x = norm(lps[0]["final_norm"], x, self.cfg.norm_eps)
        if not self.vocab_split or self.tp == 1:
            return layers.unembed({"table": lps[0]["embedding"]}, x)
        return self.mg.all_gather(
            [layers.unembed({"table": lp["embedding"]}, x) for lp in lps],
            dim=-1)

    # -- mixers ------------------------------------------------------------------
    def _mix(self, lps, li, mixer, h, positions, mode, cl) -> torch.Tensor:
        """A layer's mixer half, reduced over ``model``."""
        if mixer == "attn" and self.sp:
            return self._attend_sp(lps, li, h, positions, mode, cl)
        if mixer == "mamba":
            return self._mamba(lps, li, h, mode, cl)
        if mixer == "rwkv":
            return self._time_mix(lps, li, h, cl)
        acfg = self.acfg if mixer == "attn" else None
        parts = [self.impl.mixer(mixer, lp["layers"][li], h, positions,
                                 mode, self._cache_shard(cl, s), acfg=acfg)
                 for lp, s in zip(lps, self.mg.local)]
        return self.mg.all_reduce(parts)

    def _mamba(self, lps, li, h, mode, cl) -> torch.Tensor:
        """Mamba over the shards' channels: the ``bcdt`` partials reduced
        in f32 inside, each shard's new state written into its views, the
        ``w_out`` partials reduced."""
        views = [self._cache_shard(cl, s) for s in self.mg.local]
        outs, states = ssm.mamba_shards(
            [lp["layers"][li]["mamba"] for lp in lps], _mamba_cfg(self.cfg),
            [h] * len(lps), views, mode,
            lambda parts: [self.mg.all_reduce(parts)] * len(parts))
        for view, st in zip(views, states):
            _store(view, st)
        return self.mg.all_reduce(outs)

    def _time_mix(self, lps, li, h, cl) -> torch.Tensor:
        """rwkv6's time mix over the shards' heads (prefill and decode both
        continue the cached segment): the heads' outputs gathered for
        ``ln_out``, the ``w_o`` partials reduced; ``tmix_x`` written
        once. When ``tp`` does not divide the heads the mix runs whole on
        every shard (its split leaves gathered over ``model``) on the
        whole ``wkv`` state."""
        if "rwkv" in self.replicated:
            name, _, slot = self.slots[li][:3]
            p = whole_leaves(
                [lp["layers"][li]["tmix"] for lp in lps],
                self.full[name][slot]["tmix"],
                lambda parts, dim: self.mg.all_gather(parts, dim=dim))
            mix, x_last, state = ssm.rwkv6_time_mix(
                p, _rwkv_cfg(self.cfg), h, cl["tmix_x"], cl["wkv"])
            _store(cl, {"tmix_x": x_last, "wkv": state})
            return mix
        views = [self._cache_shard(cl, s) for s in self.mg.local]
        outs, x_last, states = ssm.rwkv6_time_mix_shards(
            [lp["layers"][li]["tmix"] for lp in lps], _rwkv_cfg(self.cfg),
            self.mg.local, [h] * len(lps), cl["tmix_x"],
            [v["wkv"] for v in views],
            lambda parts: self.mg.all_gather(parts, dim=-1))
        for view, st in zip(views, states):
            view["wkv"].copy_(st)
        cl["tmix_x"].copy_(x_last)
        return self.mg.all_reduce(outs)

    def _attend_sp(self, lps, li, h, positions, mode, cl) -> torch.Tensor:
        qkv = [layers._qkv(lp["layers"][li]["attn"], self.acfg, h, positions)
               for lp in lps]
        q = self.mg.all_gather([t[0] for t in qkv], dim=2)   # every head
        k, v = qkv[0][1], qkv[0][2]
        if mode == "prefill":
            out = self._sp_prefill(q, k, v, cl)
        else:
            out = self._sp_decode(q, k, v, positions, cl)
        hs = self.heads
        parts = [torch.einsum("bshk,hkd->bsd", out[:, :, s * hs:(s + 1) * hs],
                              lp["layers"][li]["attn"]["wo"])
                 for lp, s in zip(lps, self.mg.local)]
        return self.mg.all_reduce(parts)

    def _sp_prefill(self, q, k, v, cl) -> torch.Tensor:
        """Full causal attention over the prompt from position 0 (every
        shard holds the whole row's q, k, v); each shard keeps its block of
        positions, or a whole cache takes every position."""
        s = q.shape[1]
        if not self.local_cache:
            cl["k"][:, :s] = k.to(cl["k"].dtype)
            cl["v"][:, :s] = v.to(cl["v"].dtype)
        else:
            block = cl["k"].shape[1]
            lo = self.mg.local[0] * block
            n = min(max(s - lo, 0), block)
            if n:
                cl["k"][:, :n] = k[:, lo:lo + n].to(cl["k"].dtype)
                cl["v"][:, :n] = v[:, lo:lo + n].to(cl["v"].dtype)
        return layers._attend_prompt(self.impl.acfg, q, k, v)

    def _sp_decode(self, q, k, v, positions, cl) -> torch.Tensor:
        """Write the new row (on the shard owning its position when a rank
        holds its block only), then the distributed softmax over every
        shard's block of positions."""
        b = q.shape[0]
        rows = torch.arange(b, device=q.device)
        block = (cl["k"].shape[1] if self.local_cache
                 else cl["k"].shape[1] // self.tp)
        pos = positions[:, 0].long().clamp(0, block * self.tp - 1)
        if not self.local_cache:
            for name, new in (("k", k), ("v", v)):
                cl[name][rows, pos] = new[:, 0].to(cl[name].dtype)
        kvs = []
        for shard in self.mg.local:
            cm = self._cache_shard(cl, shard)
            if self.local_cache:
                write_block(cm, k, v, rows, pos - shard * block, block)
            kv_pos = shard * block + torch.arange(block, device=q.device)
            kvs.append((cm["k"], cm["v"], kv_pos[None, :] <= pos[:, None]))
        return split_softmax(self.mg, q, kvs)

    # -- FFNs ----------------------------------------------------------------------
    def _ffn(self, lps, li, ffn, h, cl) -> torch.Tensor:
        """A layer's FFN half, reduced over ``model``: the shards' ``d_ff``
        blocks, or their expert ranges of a MoE routed over all of ``h``'s
        tokens; rwkv6's channel mix reduces and gathers inside and is whole
        (``cmix_x`` written once)."""
        if ffn == "cmix":
            out, x_last = ssm.rwkv6_channel_mix_shards(
                [lp["layers"][li]["cmix"] for lp in lps], h, cl["cmix_x"],
                self.mg.all_reduce,
                lambda parts: self.mg.all_gather(parts, dim=-1))
            cl["cmix_x"].copy_(x_last)
            return out
        if ffn == "swiglu":
            parts = [self.impl.ffn("swiglu", lp["layers"][li], h, "decode",
                                   None)[0] for lp in lps]
        else:
            n = self.mcfg.num_experts // self.tp
            parts = [moe.moe_forward(lp["layers"][li]["moe"], self.mcfg, h,
                                     experts=(s * n, (s + 1) * n))[0]
                     for lp, s in zip(lps, self.mg.local)]
        return self.mg.all_reduce(parts)

    # -- the layer loop ----------------------------------------------------------
    def _run(self, lps, xs, positions, caches, mode,
             split: bool = False) -> List[torch.Tensor]:
        """Every layer over the local data shards' rows in lockstep
        (``xs``, ``positions`` and ``caches`` one entry each; several only
        when a decode step's rows split over ``data``: ``split``). Each
        data shard runs its own mixers; a MoE layer routes every data
        shard's rows together."""
        eps = self.cfg.norm_eps
        xs = list(xs)
        for li, (name, j, slot, mixer, ffn) in enumerate(self.slots):
            lp0 = lps[0]["layers"][li]
            norm = layers.layernorm if mixer == "rwkv" else layers.rmsnorm
            cls = [_layer(c[name], j)[slot] for c in caches]
            for i, x in enumerate(xs):
                self._count(i)
                h = norm(lp0["pre_norm"], x, eps)
                xs[i] = x + self._mix(lps, li, mixer, h, positions[i], mode,
                                      cls[i])
            hs = [norm(lp0["post_norm"], x, eps) for x in xs]
            if ffn == "moe" and split:
                self._count(0)
                out = self._ffn(lps, li, ffn, self.dg.all_gather(hs, dim=0),
                                None)
                rows = hs[0].shape[0]
                for i, d in enumerate(self.dg.local):
                    xs[i] = xs[i] + out[d * rows:(d + 1) * rows]
                continue
            for i, h in enumerate(hs):
                self._count(i)
                xs[i] = xs[i] + self._ffn(lps, li, ffn, h, cls[i])
        self._count(0)
        return xs

    def _count(self, i: int) -> None:
        """Bytes count into one shard: one data shard's reductions."""
        self.mg.counting = i == 0

    def decode_step(self, lps, tokens: torch.Tensor, cache: Params):
        """tokens [b, 1] -> (logits [b, vocab] f32 for every row, cache):
        each local data shard steps its rows, the logits are gathered over
        ``data``; every row's ``pos`` advances, as on one device. The
        cache holds every row, or, on a rank, only its data shard's rows
        (``cache_specs``' split of the batch, as the dry run holds it);
        rows that do not split over ``data`` run whole on every shard."""
        b = tokens.shape[0]
        split = self.dp > 1 and b % self.dp == 0
        rows = b // self.dp if split else b
        spans = [(d * rows, (d + 1) * rows) if split else (0, b)
                 for d in (self.dg.local if split else self.dg.local[:1])]
        subs = ([cache] if cache["pos"].shape[0] != b
                else [_rows(cache, lo, hi) for lo, hi in spans])
        xs = []
        for i, (lo, hi) in enumerate(spans):
            self._count(i)
            xs.append(self._embed(lps, tokens[lo:hi]))
        xs = self._run(lps, xs, [sub["pos"][:, None].clone()
                                 for sub in subs], subs, "decode", split)
        outs = []
        for i, x in enumerate(xs):
            self._count(i)
            outs.append(self._unembed(lps, x)[:, 0])
        self._count(0)
        logits = self.dg.all_gather(outs, dim=0) if split else outs[0]
        cache["pos"] += 1
        return logits, cache

    def share_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[L, b, ...]`` with every row a decode step wrote: on a
        rank whose step computed only its data shard's rows, each data
        shard's block gathered over ``data``; elsewhere ``x`` itself."""
        b = x.shape[1]
        if len(self.dg.local) == self.dp or b % self.dp:
            return x
        rows = b // self.dp
        d = self.dg.local[0]
        return self.dg.all_gather([x[:, d * rows:(d + 1) * rows]], dim=1)

    def prefill(self, lps, tokens: torch.Tensor, cache: Params,
                split_rows: bool = False):
        """tokens [b, s] -> (last-position logits [b, vocab] f32, cache),
        the cache filled in place and ``pos`` set to s, as
        ``DecoderLM.prefill``. The call runs whole on every data shard, or
        with ``split_rows`` each data shard prefills its rows as a decode
        step steps them (the cache holding every row or the shard's own)
        and the logits are gathered over ``data``."""
        b, s = tokens.shape[:2]
        if split_rows and self.dp > 1 and b % self.dp == 0:
            return self._prefill_rows(lps, tokens, cache)
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        x = self._embed(lps, tokens)
        (x,) = self._run(lps, [x], [positions], [cache], "prefill")
        cache["pos"].fill_(s)
        return self._unembed(lps, x[:, -1:, :])[:, 0], cache

    def _prefill_rows(self, lps, tokens: torch.Tensor, cache: Params):
        b, s = tokens.shape[:2]
        rows = b // self.dp
        spans = [(d * rows, (d + 1) * rows) for d in self.dg.local]
        subs = ([cache] if cache["pos"].shape[0] != b
                else [_rows(cache, lo, hi) for lo, hi in spans])
        positions = torch.arange(s, device=tokens.device)[None, :].expand(
            rows, s)
        xs = []
        for i, (lo, hi) in enumerate(spans):
            self._count(i)
            xs.append(self._embed(lps, tokens[lo:hi]))
        xs = self._run(lps, xs, [positions] * len(xs), subs, "prefill", True)
        outs = []
        for i, (x, sub) in enumerate(zip(xs, subs)):
            self._count(i)
            sub["pos"].fill_(s)
            outs.append(self._unembed(lps, x[:, -1:, :])[:, 0])
        self._count(0)
        return self.dg.all_gather(outs, dim=0), cache


def gathered_shards(placed: Params, mesh) -> List[Params]:
    """Each local model shard's params, from a tree at rest in the shards
    of ``param_specs`` (:func:`~repro_torch.distributed.sharding.place`):
    every leaf gathered over ``data`` (FSDP); a leaf split over ``model``
    the shard's block (Mamba's ``w_in``: gathered over ``model`` too and
    viewed as :func:`shard_leaf`'s x and z blocks), any other leaf whole.
    The sharded serving steps (the dry run's prefill and decode) compute
    on these."""
    mg = mesh.groups["model"]
    trees: List[Dict[str, Any]] = [{} for _ in mg.local]

    def walk(node, outs, names):
        for k, x in node.items():
            if isinstance(x, dict):
                subs = [{} for _ in outs]
                walk(x, subs, names + (k,))
                for o, sub in zip(outs, subs):
                    o[k] = sub
                continue
            spec = tuple(x.named.spec)
            dim = model_dim(spec)
            if dim < 0:
                parts = [sharding.gather_leaf(x)] * len(outs)
            else:
                blocks = sharding.gather_over(x, "data")
                parts = [blocks[m] for m in mg.local]
                if names[-1:] + (k,) == ("mamba", "w_in") and mg.size > 1:
                    whole = mg.all_gather(parts, dim=dim)
                    parts = [shard_leaf(whole, spec, names + (k,), mg.size,
                                        m) for m in mg.local]
            for o, part in zip(outs, parts):
                o[k] = part

    walk(placed, trees, ())
    return trees


class EncDecParallel:
    """Whisper's prefill and decode step over a mesh's ``model`` (and
    ``data``) shards (``EncDecLM.prefill_shards`` / ``decode_shards``).
    No engine serves the encoder-decoder on a mesh (:func:`refuse_family`);
    the dry run lowers these steps and the tests hold them to the
    reference. Each model shard holds its heads of every attention and its
    ``d_ff`` block of each MLP; when ``tp`` does not divide the heads
    (whisper-small's 12 on ``model=16``) attention runs whole on every
    shard and the caches split their positions over ``model``, as
    ``cache_specs`` splits them (``sp``). The vocabulary splits when ``tp``
    divides it. Over ``data`` each data shard computes its rows (when they
    split) and the logits are gathered, as :class:`TensorParallel` does.
    ``local_cache``: the cache handed in is this rank's block (else one
    whole cache, each logical shard taking views)."""

    def __init__(self, model, mesh, local_cache: bool):
        cfg = model.cfg
        self.cfg, self.impl = cfg, model._impl
        self.tp = mesh.shape["model"]
        self.mg = mesh.groups["model"]
        self.dg = mesh.group(sharding.dp_axes(mesh))
        self.dp = self.dg.size
        check_divides(cfg, self.tp, {"attn", "gelu"})
        self.replicated = replicated_kinds(cfg, self.tp, {"attn"})
        self.sp = cfg.num_kv_heads % self.tp != 0
        if self.sp != bool(self.replicated):
            raise ValueError(
                f"tp={self.tp} divides one of the query ({cfg.num_heads}) "
                f"and KV ({cfg.num_kv_heads}) heads of {cfg.name} but not "
                f"the other")
        self.heads = (dict(num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads) if self.sp else
                      dict(num_heads=cfg.num_heads // self.tp,
                           num_kv_heads=cfg.num_kv_heads // self.tp))
        self.vocab_split = self.tp > 1 and cfg.vocab_size % self.tp == 0
        self.local_cache = local_cache

    # -- the pieces the model's shard steps call ---------------------------
    def embed(self, shards, tokens: torch.Tensor) -> torch.Tensor:
        if not self.vocab_split:
            return layers.embed(shards[0]["embedding"], tokens)
        return self.mg.all_reduce(lookup_parts(
            [t["embedding"]["table"] for t in shards], self.mg.local,
            tokens))

    def logits(self, shards, x: torch.Tensor) -> torch.Tensor:
        if not self.vocab_split:
            return layers.unembed(shards[0]["embedding"], x)
        return self.mg.all_gather([layers.unembed(t["embedding"], x)
                                   for t in shards], dim=-1)

    @staticmethod
    def layer_cache(cache: Params, j: int) -> Params:
        return {k: v[j] for k, v in cache.items() if k != "pos"}

    def store_block(self, cl: Params, key: str, new: torch.Tensor,
                    shard: int) -> None:
        """Write the positions of ``new`` ``[b, s, hk, hd]`` that fall in
        shard ``shard``'s block of the cache view ``cl[key]``."""
        block = cl[key].shape[1]
        lo = shard * block
        n = min(max(new.shape[1] - lo, 0), block)
        if n:
            cl[key][:, :n] = new[:, lo:lo + n].to(cl[key].dtype)

    def attend_blocks(self, q: torch.Tensor, blocks, positions=None,
                      new=None) -> torch.Tensor:
        """One query row over the local shards' blocks of positions
        ``blocks`` (each ``(k, v)``), merged over ``model``
        (:func:`split_softmax`). Causal when ``positions`` is given: the
        new row ``new`` is written into the block that owns its position
        first, and each shard attends up to it."""
        b = q.shape[0]
        rows = torch.arange(b, device=q.device)
        kvs = []
        for shard, (k, v) in zip(self.mg.local, blocks):
            block = k.shape[1]
            if positions is None:
                kvs.append((k, v, torch.ones((b, block), dtype=torch.bool,
                                             device=q.device)))
                continue
            pos = positions[:, 0].long()
            write_block({"k": k, "v": v}, *new, rows,
                        pos.clamp(0, block * self.tp - 1) - shard * block,
                        block)
            kv_pos = shard * block + torch.arange(block, device=q.device)
            kvs.append((k, v, kv_pos[None, :] <= pos[:, None]))
        return split_softmax(self.mg, q, kvs)

    def cache_views(self, cache: Params) -> List[Params]:
        """Each local model shard's view of ``cache`` (one data shard's
        rows): its heads, or its block of positions under ``sp``; a
        rank's block as it is."""
        if self.local_cache or self.tp == 1:
            return [cache]
        dim = 2 if self.sp else 3
        views = []
        for s in self.mg.local:
            v = {}
            for k, leaf in cache.items():
                if k == "pos":
                    v[k] = leaf
                    continue
                n = leaf.shape[dim] // self.tp
                v[k] = leaf.narrow(dim, s * n, n)
            views.append(v)
        return views

    # -- the steps -----------------------------------------------------------
    def _spans(self, b: int, cache: Params):
        split = self.dp > 1 and b % self.dp == 0
        rows = b // self.dp if split else b
        spans = [(d * rows, (d + 1) * rows) if split else (0, b)
                 for d in (self.dg.local if split else self.dg.local[:1])]
        subs = ([cache] if cache["pos"].shape[0] != b
                else [_rows(cache, lo, hi) for lo, hi in spans])
        return split, spans, subs

    def _count(self, i: int) -> None:
        self.mg.counting = i == 0

    def prefill(self, shards, frames: torch.Tensor, tokens: torch.Tensor,
                cache: Params):
        """frames [b, s, d], tokens [b, t] -> (last-position logits [b,
        vocab] f32, cache), each data shard prefilling its rows."""
        split, spans, subs = self._spans(tokens.shape[0], cache)
        outs = []
        for i, ((lo, hi), sub) in enumerate(zip(spans, subs)):
            self._count(i)
            outs.append(self.impl.prefill_shards(
                shards, frames[lo:hi], tokens[lo:hi], self.cache_views(sub),
                self))
        self._count(0)
        return (self.dg.all_gather(outs, dim=0) if split else outs[0]), cache

    def decode_step(self, shards, tokens: torch.Tensor, cache: Params):
        """tokens [b, 1] -> (logits [b, vocab] f32, cache)."""
        split, spans, subs = self._spans(tokens.shape[0], cache)
        outs = []
        for i, ((lo, hi), sub) in enumerate(zip(spans, subs)):
            self._count(i)
            outs.append(self.impl.decode_shards(
                shards, tokens[lo:hi], self.cache_views(sub), self))
        self._count(0)
        return (self.dg.all_gather(outs, dim=0) if split else outs[0]), cache


def write_block(cm, k, v, rows, idx, block: int) -> None:
    """Write the new ``k``/``v`` row ``[b, 1, hk, hd]`` into a shard's
    block of positions ``cm`` where its position ``idx`` (relative to the
    block) falls inside it, leaving the block as it is elsewhere."""
    own = ((idx >= 0) & (idx < block))[:, None, None]
    at = idx.clamp(0, block - 1)
    for name, new in (("k", k), ("v", v)):
        leaf = cm[name]
        leaf[rows, at] = torch.where(own, new[:, 0].to(leaf.dtype),
                                     leaf[rows, at])


def split_softmax(mg, q: torch.Tensor, kvs) -> torch.Tensor:
    """One query row ``q`` ``[b, 1, h, hd]`` attended over the positions
    split in blocks over ``mg`` (sequence parallelism): ``kvs`` holds each
    local shard's ``(k, v, mask)``, ``k``/``v`` ``[b, blk, hk, hd]`` and
    ``mask`` ``[b, blk]`` the positions attended. Each shard's f32 ``(o,
    max, sum)`` is gathered and merged in rank order."""
    b, hd = q.shape[0], q.shape[3]
    hk = kvs[0][0].shape[2]
    group = q.shape[2] // hk
    qg = q.reshape(b, 1, hk, group, hd).float()
    scale = 1.0 / np.sqrt(hd)
    parts = []
    for k, v, mask in kvs:
        logits = torch.einsum("bqhgk,bshk->bhgqs", qg, k.float()) * scale
        logits = torch.where(mask[:, None, None, None, :], logits,
                             torch.tensor(-1e30, dtype=torch.float32,
                                          device=q.device))
        mx = logits.amax(dim=-1, keepdim=True)               # [b,hk,g,1,1]
        e = torch.exp(logits - mx)
        o = torch.einsum("bhgqs,bshk->bhgqk", e, v.float())
        parts.append(torch.cat([o, mx, e.sum(dim=-1, keepdim=True)], dim=-1))
    got = mg.all_gather_list(parts)
    mx = torch.stack([g[..., hd:hd + 1] for g in got]).amax(dim=0)
    num = den = None
    for g in got:                                      # rank order
        w = torch.exp(g[..., hd:hd + 1] - mx)
        num = g[..., :hd] * w if num is None else num + g[..., :hd] * w
        den = (g[..., hd + 1:] * w if den is None
               else den + g[..., hd + 1:] * w)
    out = (num / den).permute(0, 3, 1, 2, 4)           # [b,1,hk,g,hd]
    return out.reshape(b, 1, hk * group, hd).to(q.dtype)


def lookup_parts(tables, ids, tokens: torch.Tensor) -> List[torch.Tensor]:
    """Each shard's part of the embedding: the rows of ``tokens`` that fall
    in its vocabulary block (shard ``s`` of ``ids`` holds block ``s``),
    zeros elsewhere; their sum is the lookup."""
    parts = []
    for table, s in zip(tables, ids):
        n = table.shape[0]
        idx = tokens.long() - s * n
        inside = (idx >= 0) & (idx < n)
        rows = table[idx.clamp(0, n - 1)]
        parts.append(torch.where(inside[..., None], rows, rows.new_zeros(())))
    return parts


# the replicated leaves (key paths) a layer kind's shards compute with:
# each shard takes its copy through copy_to, so their gradients sum the
# shards' parts
SHARD_COPIED = {
    "attn": [("q_norm", "scale"), ("k_norm", "scale")],
    "mla": [("w_dq",), ("q_norm", "scale"), ("w_dkv",),
            ("kv_norm", "scale")],
    "tmix": [("mix",), ("decay_lora", "a"), ("bonus",)],
}


def _dicts(tree):
    """``tree`` with its dicts copied and its leaves shared."""
    return ({k: _dicts(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree)


class TensorParallelLoss:
    """The training loss over a mesh's ``model`` shards, cache-free: the
    counterpart of :meth:`~repro_torch.models.transformer.DecoderLM.loss`
    (and ``EncDecLM.loss``) that each shard computes on its blocks of the
    split leaves, with :mod:`~repro_torch.distributed.collectives`'
    differentiable operators between them, so the backward pass reduces
    what the forward pass split.

    Each layer kind keeps its serving split (the module docstring):
    replicated compute (norms, residual adds, routing, the loss) runs once
    on each shard's identical values, and where a replicated value feeds
    per-shard compute it goes through ``copy_to`` (the normed row, the
    routing weights, the replicated leaves of :data:`SHARD_COPIED`, Mamba's
    reduced ``bcdt``, rwkv6's ``ln_out`` row, the channel mix's shifted
    rows), so its gradient sums the shards' parts in rank order. The
    partials are reduced by ``psum``; the vocabulary-split logits (f32) and
    rwkv6's head outputs and receptance are gathered by ``all_gather``.
    Mamba's ``w_in`` rests in contiguous column blocks over ``model`` (the
    reference's spec), so it is gathered whole and each shard takes its x
    and z blocks (:func:`shard_leaf`). Each repeat of a block runs under
    ``parallel.remat`` as ``DecoderLM._run`` does, its recompute rerunning
    every forward collective (early stop off).

    ``bg`` is the batch group when a MoE model's batch splits over it: the
    local batch shards then run in lockstep and at each MoE layer their
    normed rows are gathered over ``bg`` and routed together, so capacity
    and drops are one device's, and each batch shard keeps its rows (the
    gather's gradient sums over ``bg`` before each shard takes its block);
    each batch shard's aux loss is then the global batch's."""

    def __init__(self, model, mg, bg=None):
        cfg = model.cfg
        self.cfg, self.impl, self.mg, self.bg = cfg, model._impl, mg, bg
        self.tp = mg.size
        self.encdec = cfg.family == "encdec"
        kinds = {"attn", "gelu"} if self.encdec else layer_kinds(self.impl)
        check_divides(cfg, self.tp, kinds)
        self.replicated = replicated_kinds(cfg, self.tp, kinds)
        h, hk = cfg.num_heads, cfg.num_kv_heads
        if "attn" in self.replicated and not self.encdec:
            raise ValueError(f"tp={self.tp} must divide the query heads "
                             f"({h}) of {cfg.name} to train it")
        # the KV head each shard's query heads share when tp does not
        # divide the KV heads (None: the KV heads split with the queries)
        self.kv_head = None
        if "attn" in kinds and "attn" not in self.replicated and hk % self.tp:
            n, group = h // self.tp, h // hk
            if group % n:
                raise ValueError(
                    f"tp={self.tp}: a shard's {n} query heads of {cfg.name} "
                    f"span more than one of its {hk} KV heads")
            self.kv_head = lambda m: m * n // group
        self.heads = (dict(num_heads=h, num_kv_heads=hk)
                      if "attn" in self.replicated else
                      dict(num_heads=h // self.tp,
                           num_kv_heads=1 if self.kv_head else hk // self.tp))
        # the layer-stacked meta params, for the replicated parts' shapes
        self.full = (model.abstract_params() if self.replicated - {"attn"}
                     else None)
        if not self.encdec:
            self.acfg = dataclasses.replace(self.impl.acfg, **self.heads)
        self.mcfg = _moe_cfg(cfg) if cfg.moe is not None else None
        self.vocab_split = self.tp > 1 and cfg.vocab_size % self.tp == 0

    # -- the collectives, over model -------------------------------------------
    def copy(self, x: torch.Tensor) -> List[torch.Tensor]:
        return collectives.copy_to(x, self.mg)

    def psum(self, parts) -> torch.Tensor:
        return collectives.psum(parts, self.mg)

    def gather(self, parts, dim: int = -1) -> torch.Tensor:
        return collectives.all_gather(parts, self.mg, dim)

    def _count(self, i: int) -> None:
        """Bytes count into one shard: one batch shard's reductions."""
        self.mg.counting = i == 0

    def _copied(self, subs, kind: str):
        """The shards' subtrees with the replicated leaves of
        :data:`SHARD_COPIED` handed to each through ``copy_to``."""
        subs = [_dicts(t) for t in subs]
        for path in SHARD_COPIED.get(kind, ()):
            node = subs[0]
            for k in path:
                node = node.get(k) if isinstance(node, dict) else None
            if node is None:
                continue
            for t, c in zip(subs, self.copy(node)):
                for k in path[:-1]:
                    t = t[k]
                t[path[-1]] = c
        return subs

    # -- embedding / logits ------------------------------------------------------
    def lookup(self, lps, tokens: torch.Tensor) -> torch.Tensor:
        """The token embedding: each shard's masked lookup, reduced, when
        the vocabulary splits; else the whole table's."""
        if not self.vocab_split:
            return layers.embed(lps[0]["embedding"], tokens)
        return self.psum(lookup_parts([lp["embedding"]["table"] for lp in lps],
                                      self.mg.local, tokens))

    def logits(self, lps, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of the normed rows ``x``: each shard's vocabulary
        block, gathered, when the vocabulary splits."""
        if not self.vocab_split:
            return layers.unembed(lps[0]["embedding"], x)
        return self.gather([layers.unembed(lp["embedding"], xf)
                            for lp, xf in zip(lps, self.copy(x.float()))])

    # -- the layer kinds ---------------------------------------------------------
    def _mix(self, lps, mixer: str, h: torch.Tensor,
             positions: torch.Tensor, full=None) -> torch.Tensor:
        """A layer's mixer half on the normed ``h``: the shards' partials
        on their copies of ``h``, reduced; a replicated mixer
        (:func:`replicated_kinds`) runs once on ``h``, its split leaves
        gathered over ``model`` by their shapes in ``full`` (the slot's
        meta params)."""
        cfg = self.cfg
        if mixer == "rwkv" and "rwkv" in self.replicated:
            rcfg, b = _rwkv_cfg(cfg), h.shape[0]
            p = whole_leaves([lp["tmix"] for lp in lps], full["tmix"],
                             self.gather)
            state = torch.zeros((b, rcfg.num_heads, rcfg.head_dim,
                                 rcfg.head_dim), dtype=torch.float32,
                                device=h.device)
            mix, _, _ = ssm.rwkv6_time_mix(p, rcfg, h,
                                           h.new_zeros((b, cfg.d_model)),
                                           state)
            return mix
        hs = self.copy(h)
        if mixer == "attn":
            subs = self._copied([lp["attn"] for lp in lps], "attn")
            if self.kv_head is not None:
                # the replicated KV projections, each shard's KV head
                for name in ("wk", "wv"):
                    for p, w, m in zip(subs, self.copy(lps[0]["attn"][name]),
                                       self.mg.local):
                        p[name] = w.narrow(1, self.kv_head(m), 1)
            parts = [layers.attention_forward(p, self.acfg, x, positions)
                     for p, x in zip(subs, hs)]
        elif mixer == "mla":
            parts = [mla.mla_forward(p, _mla_cfg(cfg), x)
                     for p, x in zip(self._copied(
                         [lp["mla"] for lp in lps], "mla"), hs)]
        elif mixer == "mamba":
            parts, _ = ssm.mamba_shards(
                self._mamba_params([lp["mamba"] for lp in lps]),
                _mamba_cfg(cfg), hs, None, "train",
                lambda p: self.copy(self.psum(p)))
        elif mixer == "rwkv":
            rcfg = _rwkv_cfg(cfg)
            b, n = h.shape[0], rcfg.num_heads // self.tp
            state = torch.zeros((b, n, rcfg.head_dim, rcfg.head_dim),
                                dtype=torch.float32, device=h.device)
            parts, _, _ = ssm.rwkv6_time_mix_shards(
                self._copied([lp["tmix"] for lp in lps], "tmix"), rcfg,
                self.mg.local, hs, h.new_zeros((b, cfg.d_model)),
                [state] * len(lps), self.gather, self.copy)
        else:
            raise ValueError(mixer)
        return self.psum(parts)

    def _mamba_params(self, subs):
        """Each shard's Mamba params with ``w_in`` as :func:`shard_leaf`'s
        x and z blocks: the stored contiguous blocks gathered whole and
        handed to every shard through ``copy_to``."""
        whole = self.copy(self.gather([p["w_in"] for p in subs]))
        return [dict(p, w_in=shard_leaf(w, (None, "model"), ("mamba", "w_in"),
                                        self.tp, s))
                for p, w, s in zip(subs, whole, self.mg.local)]

    def _ffn(self, lps, ffn: str, h: torch.Tensor):
        """A layer's FFN half on the normed ``h``: (the reduced output, the
        MoE aux loss or None). A MoE routes ``h``'s tokens once with the
        replicated f32 router and hands each shard the weights."""
        if ffn == "cmix":
            out, _ = ssm.rwkv6_channel_mix_shards(
                [lp["cmix"] for lp in lps], h,
                h.new_zeros((h.shape[0], self.cfg.d_model)), self.psum,
                self.gather, self.copy)
            return out, None
        hs = self.copy(h)
        if ffn == "swiglu":
            return self.psum([layers.swiglu(lp["ffn"], x)
                              for lp, x in zip(lps, hs)]), None
        b, s, d = h.shape
        weights, indices, aux = moe.route(lps[0]["moe"], self.mcfg,
                                          h.reshape(b * s, d))
        n = self.mcfg.num_experts // self.tp
        parts = [moe.moe_forward(lp["moe"], self.mcfg, x,
                                 experts=(m * n, (m + 1) * n),
                                 routing=(w, indices, aux))[0]
                 for lp, x, w, m in zip(lps, hs, self.copy(weights),
                                        self.mg.local)]
        return self.psum(parts), aux

    def _unit(self, layer, slots, positions, xs, auxes, full=None):
        """One repeat of a block (every slot) over the local batch shards:
        ``layer[i][m]`` is batch shard ``i``'s model shard ``m``'s params of
        the repeat, ``full`` the block's meta params. Returns (xs, auxes).
        Leaves the byte counting as it found it (remat reruns it inside
        the backward pass)."""
        with self.mg.counted(self.mg.counting):
            return self._slots(layer, slots, positions, xs, auxes, full)

    def _slots(self, layer, slots, positions, xs, auxes, full=None):
        eps = self.cfg.norm_eps
        for si, (mixer, ffn) in enumerate(slots):
            lpss = [[lp[f"slot_{si}"] for lp in lps] for lps in layer]
            norm = layers.layernorm if mixer == "rwkv" else layers.rmsnorm
            sfull = full[f"slot_{si}"] if full is not None else None
            for i, lps in enumerate(lpss):
                self._count(i)
                h = norm(lps[0]["pre_norm"], xs[i], eps)
                xs[i] = xs[i] + self._mix(lps, mixer, h, positions, sfull)
            hs = [norm(lps[0]["post_norm"], x, eps)
                  for lps, x in zip(lpss, xs)]
            if ffn == "moe" and self.bg is not None:
                rows = hs[0].shape[0]
                whole = collectives.copy_to(
                    collectives.all_gather(hs, self.bg, 0), self.bg)
                outs = []
                for i, (lps, g) in enumerate(zip(lpss, whole)):
                    self._count(i)
                    out, a = self._ffn(lps, ffn, g)
                    k = self.bg.local[i]
                    outs.append((out[k * rows:(k + 1) * rows], a))
            else:
                outs = []
                for i, (lps, h) in enumerate(zip(lpss, hs)):
                    self._count(i)
                    outs.append(self._ffn(lps, ffn, h))
            for i, (out, a) in enumerate(outs):
                xs[i] = xs[i] + out
                if a is not None:
                    auxes[i] = a if auxes[i] is None else auxes[i] + a
        return xs, auxes

    # -- the loss ------------------------------------------------------------------
    def loss(self, trees, batches):
        """``trees[i][m]``: local batch shard ``i``'s params of local model
        shard ``m`` (its blocks of the split leaves, the replicated leaves
        whole); ``batches[i]`` the batch shard's rows. Returns, per local
        batch shard, (loss, ce_loss, aux_loss) of its rows, as
        ``Model.loss`` gives them."""
        try:
            with torch_checkpoint.set_checkpoint_early_stop(False):
                if self.encdec:
                    out = []
                    for i, (lps, batch) in enumerate(zip(trees, batches)):
                        self._count(i)
                        out.append(self.impl.loss_shards(lps, batch, self))
                    return out
                return self._decoder_loss(trees, batches)
        finally:
            self._count(0)

    def _decoder_loss(self, trees, batches):
        cfg = self.cfg
        xs = []
        for i, (lps, batch) in enumerate(zip(trees, batches)):
            self._count(i)
            tokens = batch["tokens"]
            x = tokens if cfg.embedding_inputs else self.lookup(lps, tokens)
            if cfg.family == "ssm":
                x = layers.layernorm(lps[0]["ln0"], x, cfg.norm_eps)
            xs.append(x)
        b, s = batches[0]["labels"].shape
        positions = torch.arange(s, device=xs[0].device)[None, :].expand(b, s)
        policy = cfg.parallel.remat if torch.is_grad_enabled() else "none"
        auxes = [None] * len(xs)
        n = len(xs)
        for name, reps, slots in self.impl.blocks:
            stacks = [[_layers(t[name], reps) for t in lps] for lps in trees]
            for j in range(reps):
                layer = [[s[j] for s in ss] for ss in stacks]

                def body(*args, layer=layer, slots=slots,
                         full=self.full and self.full[name]):
                    xs, auxes = self._unit(layer, slots, positions,
                                           list(args[:n]), list(args[n:]),
                                           full)
                    return tuple(xs) + tuple(auxes)

                out = transformer.remat(body, policy)(*xs, *auxes)
                xs, auxes = list(out[:n]), list(out[n:])
        out = []
        for i, (lps, batch, x) in enumerate(zip(trees, batches, xs)):
            self._count(i)
            loss = self._ce(lps, x, batch["labels"])
            aux = auxes[i] if auxes[i] is not None else torch.zeros(
                (), dtype=torch.float32, device=x.device)
            out.append((loss + aux, loss, aux))
        return out

    def _ce(self, lps, x: torch.Tensor, labels: torch.Tensor):
        """``DecoderLM.loss``'s mean masked NLL, ``parallel.loss_chunk`` at
        a time."""
        cfg = self.cfg
        norm = layers.layernorm if cfg.family == "ssm" else layers.rmsnorm
        chunk, s = cfg.parallel.loss_chunk, x.shape[1]
        tot = cnt = None
        for start in range(0, s, chunk if chunk and s > chunk else s):
            end = min(start + (chunk or s), s)
            logits = self.logits(lps, norm(lps[0]["final_norm"],
                                           x[:, start:end], cfg.norm_eps))
            t, c = transformer.masked_nll(logits, labels[:, start:end])
            tot, cnt = (t, c) if tot is None else (tot + t, cnt + c)
        return tot / cnt.clamp(min=1.0)


def _rows(cache: Params, lo: int, hi: int) -> Params:
    """Rows ``lo:hi`` of a batched cache as views (``pos`` is ``[b]``,
    every other leaf ``[L, b, ...]``)."""
    return {k: (_rows(v, lo, hi) if isinstance(v, dict)
                else v[lo:hi] if k == "pos" else v[:, lo:hi])
            for k, v in cache.items()}
