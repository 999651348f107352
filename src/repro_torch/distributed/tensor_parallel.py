"""Tensor-parallel compute for the dense family over a mesh's ``model``
axis (the reference has no such file: XLA partitions its program by the
specs and inserts the collectives).

Each model shard holds the slices :func:`~repro_torch.distributed.sharding.
param_specs` gives it over ``model``: query heads ``[s*h/tp, (s+1)*h/tp)``
of ``wq`` and ``wo``, KV heads ``[s*hk/tp, (s+1)*hk/tp)`` of ``wk``/``wv``
(contiguous blocks keep GQA's grouping), the matching ``d_ff`` block of
``w_gate``/``w_up``/``w_down`` and a vocabulary block of the embedding
table. On logical shards these are views of the placed weights; on a rank
they are the rank's own tensors. A layer is

    norm -> every local shard's mixer partial -> all-reduce -> residual add
    norm -> every local shard's FFN partial   -> all-reduce -> residual add

with the all-reduce an all-gather and a sum in rank order
(:mod:`repro_torch.distributed.collectives`). The embedding is a masked
lookup in the shard's vocabulary block plus the all-reduce (exact: one
shard holds each row), the unembedding gives each shard's f32 logits for
its block, gathered along the vocabulary (exact).

The KV cache follows :func:`~repro_torch.distributed.sharding.cache_specs`.
When the KV heads divide the axis, shard ``s`` holds KV heads ``s`` of the
cache. Otherwise (sequence parallelism) every shard holds a contiguous
block of ``max_len / tp`` positions for every KV head: the query heads are
gathered over ``model``, a step's new K/V row is written only by the shard
owning its position, and attention is the distributed softmax -- each
shard's ``(o, max, sum)`` over its block, merged in rank order.

Over ``data`` each data shard computes its own rows of a decode step (the
batch split in ``dp`` contiguous blocks when it divides) and the rows'
logits are gathered over ``data``, so every shard samples every row with
the same bits. A prefill call (one row) runs whole on every data shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models import layers
from repro_torch.models.transformer import BLOCK, SLOT, _layer

Params = Any

def refuse_family(cfg) -> None:
    """Tensor-parallel compute covers the dense family (the paper's Llama2
    configs) only."""
    if cfg.family != "dense" or cfg.embedding_inputs:
        raise NotImplementedError(
            f"tensor-parallel compute (or a mesh over ranks) for the "
            f"{cfg.family} family ({cfg.name}) is not ported yet "
            f"(ROADMAP.md queue A item 21 part 3); dense models only")


def model_dim(spec) -> int:
    """The dim a spec shards over ``model`` (-1 for none)."""
    for i, axis in enumerate(spec):
        if axis == "model" or (isinstance(axis, tuple) and "model" in axis):
            return i
    return -1


def shard_views(params: Params, specs: Params, tp: int, shard: int) -> Params:
    """Shard ``shard``'s slice of every leaf over ``model``: views, no
    copies."""
    if isinstance(params, dict):
        return {k: shard_views(v, specs[k], tp, shard)
                for k, v in params.items()}
    dim = model_dim(specs)
    if dim < 0:
        return params
    n = params.shape[dim] // tp
    return params.narrow(dim, shard * n, n)


class TensorParallel:
    """The dense family's decode step and prefill over a mesh's ``model``
    (and ``data``) groups; see the module docstring. ``local_cache`` says
    whether the cache handed in holds this process's shard only (a rank)
    or every shard (logical shards: each takes its views)."""

    def __init__(self, model, mesh, local_cache: bool):
        cfg = model.cfg
        refuse_family(cfg)
        self.cfg, self.impl = cfg, model._impl
        self.tp, self.dp = mesh.shape["model"], mesh.shape["data"]
        self.mg, self.dg = mesh.groups["model"], mesh.groups["data"]
        h, hk = cfg.num_heads, cfg.num_kv_heads
        if h % self.tp or cfg.d_ff % self.tp:
            raise ValueError(
                f"tp={self.tp} must divide the query heads ({h}) and d_ff "
                f"({cfg.d_ff}) of {cfg.name}")
        self.sp = hk % self.tp != 0
        self.heads = h // self.tp
        self.acfg = dataclasses.replace(
            self.impl.acfg, num_heads=self.heads,
            num_kv_heads=hk if self.sp else hk // self.tp)
        self.vocab_split = cfg.vocab_size % self.tp == 0
        self.local_cache = local_cache

    # -- params ----------------------------------------------------------------
    def layer_params(self, shards: List[Params]) -> List[Dict[str, Any]]:
        """Per local model shard: its embedding, final norm and per-layer
        dicts (views into ``shards``, stable across steps since the plan
        refills gathered weights in place)."""
        out = []
        for tree in shards:
            out.append({
                "embedding": tree["embedding"]["table"],
                "final_norm": tree["final_norm"],
                "layers": [_layer(tree[BLOCK], j)[SLOT]
                           for j in range(self.cfg.num_layers)]})
        return out

    # -- cache views ------------------------------------------------------------
    def _cache_shard(self, cl: Params, shard: int) -> Params:
        """Shard ``shard``'s part of a layer's ``[b, max_len, hk, hd]``
        cache views: its KV heads, or under sequence parallelism its block
        of positions."""
        if self.local_cache or self.tp == 1:
            return cl
        dim = 1 if self.sp else 2
        n = cl["k"].shape[dim] // self.tp
        return {k: v.narrow(dim, shard * n, n) for k, v in cl.items()}

    # -- embedding / unembedding ------------------------------------------------
    def _embed(self, lps, tokens: torch.Tensor) -> torch.Tensor:
        if not self.vocab_split or self.tp == 1:
            return layers.embed({"table": lps[0]["embedding"]}, tokens)
        parts = []
        for lp, s in zip(lps, self.mg.local):
            table = lp["embedding"]
            n = table.shape[0]
            idx = tokens.long() - s * n
            inside = (idx >= 0) & (idx < n)
            rows = table[idx.clamp(0, n - 1)]
            parts.append(torch.where(inside[..., None], rows,
                                     rows.new_zeros(())))
        return self.mg.all_reduce(parts)

    def _unembed(self, lps, x: torch.Tensor) -> torch.Tensor:
        x = layers.rmsnorm(lps[0]["final_norm"], x, self.cfg.norm_eps)
        if not self.vocab_split or self.tp == 1:
            return layers.unembed({"table": lps[0]["embedding"]}, x)
        return self.mg.all_gather(
            [layers.unembed({"table": lp["embedding"]}, x) for lp in lps],
            dim=-1)

    # -- attention ---------------------------------------------------------------
    def _attend(self, lps, j, h, positions, mode, cl) -> torch.Tensor:
        """The mixer half, reduced over ``model``."""
        if not self.sp:
            parts = [self.impl.mixer("attn", lp["layers"][j], h, positions,
                                     mode, self._cache_shard(cl, s),
                                     acfg=self.acfg)
                     for lp, s in zip(lps, self.mg.local)]
            return self.mg.all_reduce(parts)
        qkv = [layers._qkv(lp["layers"][j]["attn"], self.acfg, h, positions)
               for lp in lps]
        q = self.mg.all_gather([t[0] for t in qkv], dim=2)   # every head
        k, v = qkv[0][1], qkv[0][2]
        if mode == "prefill":
            out = self._sp_prefill(q, k, v, positions, cl)
        else:
            out = self._sp_decode(q, k, v, positions, cl)
        hs = self.heads
        parts = [torch.einsum("bshk,hkd->bsd", out[:, :, s * hs:(s + 1) * hs],
                              lp["layers"][j]["attn"]["wo"])
                 for lp, s in zip(lps, self.mg.local)]
        return self.mg.all_reduce(parts)

    def _sp_prefill(self, q, k, v, positions, cl) -> torch.Tensor:
        """Full causal attention over the prompt (every shard holds the
        whole row's q, k, v); each shard keeps its block of positions."""
        s = q.shape[1]
        for shard in self.mg.local:
            cm = self._cache_shard(cl, shard)
            block = cm["k"].shape[1]
            lo = shard * block
            n = min(max(s - lo, 0), block)
            if n:
                cm["k"][:, :n] = k[:, lo:lo + n].to(cm["k"].dtype)
                cm["v"][:, :n] = v[:, lo:lo + n].to(cm["v"].dtype)
        return layers._attend_full(self.impl.acfg, q, k, v, positions)

    def _sp_decode(self, q, k, v, positions, cl) -> torch.Tensor:
        """Write the new row on the shard owning its position, then the
        distributed softmax over every shard's block of positions."""
        b = q.shape[0]
        rows = torch.arange(b, device=q.device)
        block = (cl["k"].shape[1] if self.local_cache
                 else cl["k"].shape[1] // self.tp)
        pos = positions[:, 0].long().clamp(0, block * self.tp - 1)
        hk, hd = k.shape[2], k.shape[3]
        group = q.shape[2] // hk
        qg = q.reshape(b, 1, hk, group, hd).float()
        scale = 1.0 / np.sqrt(hd)
        parts = []
        for shard in self.mg.local:
            cm = self._cache_shard(cl, shard)
            idx = pos - shard * block
            own = ((idx >= 0) & (idx < block))[:, None, None]
            at = idx.clamp(0, block - 1)
            for name, new in (("k", k), ("v", v)):
                leaf = cm[name]
                leaf[rows, at] = torch.where(own, new[:, 0].to(leaf.dtype),
                                             leaf[rows, at])
            kv_pos = shard * block + torch.arange(block, device=q.device)
            mask = kv_pos[None, :] <= pos[:, None]                # [b, blk]
            logits = torch.einsum("bqhgk,bshk->bhgqs", qg,
                                  cm["k"].float()) * scale
            logits = torch.where(mask[:, None, None, None, :], logits,
                                 torch.tensor(-1e30, dtype=torch.float32,
                                              device=q.device))
            mx = logits.amax(dim=-1, keepdim=True)               # [b,hk,g,1,1]
            e = torch.exp(logits - mx)
            o = torch.einsum("bhgqs,bshk->bhgqk", e, cm["v"].float())
            parts.append(torch.cat([o, mx, e.sum(dim=-1, keepdim=True)],
                                   dim=-1))
        got = self.mg.all_gather_list(parts)
        mx = torch.stack([g[..., hd:hd + 1] for g in got]).amax(dim=0)
        num = den = None
        for g in got:                                      # rank order
            w = torch.exp(g[..., hd:hd + 1] - mx)
            num = g[..., :hd] * w if num is None else num + g[..., :hd] * w
            den = (g[..., hd + 1:] * w if den is None
                   else den + g[..., hd + 1:] * w)
        out = (num / den).permute(0, 3, 1, 2, 4)           # [b,1,hk,g,hd]
        return out.reshape(b, 1, hk * group, hd).to(q.dtype)

    # -- the layer loop ----------------------------------------------------------
    def _run(self, lps, x, positions, cache, mode) -> torch.Tensor:
        eps = self.cfg.norm_eps
        bc = cache[BLOCK]
        for j in range(self.cfg.num_layers):
            cl = _layer(bc, j)[SLOT]
            lp0 = lps[0]["layers"][j]
            h = layers.rmsnorm(lp0["pre_norm"], x, eps)
            x = x + self._attend(lps, j, h, positions, mode, cl)
            h = layers.rmsnorm(lp0["post_norm"], x, eps)
            x = x + self.mg.all_reduce(
                [self.impl.ffn("swiglu", lp["layers"][j], h, mode, None)[0]
                 for lp in lps])
        return x

    def decode_step(self, lps, tokens: torch.Tensor, cache: Params):
        """tokens [b, 1] -> (logits [b, vocab] f32 for every row, cache):
        each local data shard steps its rows, the logits are gathered over
        ``data``; every row's ``pos`` advances, as on one device."""
        b = tokens.shape[0]
        split = self.dp > 1 and b % self.dp == 0
        rows = b // self.dp if split else b
        outs = []
        for i, d in enumerate(self.dg.local if split else self.dg.local[:1]):
            lo, hi = (d * rows, (d + 1) * rows) if split else (0, b)
            sub = _rows(cache, lo, hi)
            positions = sub["pos"][:, None].clone()
            # bytes count into one shard: one data shard's reductions
            self.mg.counting = i == 0
            x = self._embed(lps, tokens[lo:hi])
            x = self._run(lps, x, positions, sub, "decode")
            outs.append(self._unembed(lps, x)[:, 0])
        self.mg.counting = True
        logits = self.dg.all_gather(outs, dim=0) if split else outs[0]
        cache["pos"] += 1
        return logits, cache

    def prefill(self, lps, tokens: torch.Tensor, cache: Params):
        """tokens [b, s] -> (last-position logits [b, vocab] f32, cache),
        the cache filled in place and ``pos`` set to s, as
        ``DecoderLM.prefill``."""
        b, s = tokens.shape[:2]
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        x = self._embed(lps, tokens)
        x = self._run(lps, x, positions, cache, "prefill")
        cache["pos"].fill_(s)
        return self._unembed(lps, x[:, -1:, :])[:, 0], cache


def _rows(cache: Params, lo: int, hi: int) -> Params:
    """Rows ``lo:hi`` of a batched cache as views (``pos`` is ``[b]``,
    every other leaf ``[L, b, ...]``)."""
    return {k: (_rows(v, lo, hi) if isinstance(v, dict)
                else v[lo:hi] if k == "pos" else v[:, lo:hi])
            for k, v in cache.items()}
