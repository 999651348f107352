"""Decoder-only LM trunk, dense family (port of ``repro.models.transformer``).

Params and caches keep the reference's tree layout: one block ``"layers"``
of ``num_layers`` stacked ``slot_0`` layers (attn + swiglu), e.g.
``params["layers"]["slot_0"]["attn"]["wq"]`` of shape ``[L, d, h, hd]`` and
``cache["layers"]["slot_0"]["k"]`` of shape ``[L, b, max_len, hk, hd]``, plus
``cache["pos"]`` ``[b]``. A Python loop over the stacked layers takes the
place of ``lax.scan``; prefill and decode write the cache in place and
return it (the reference returned a rebuilt cache).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

Params = Any

BLOCK = "layers"
SLOT = "slot_0"


def _attn_cfg(cfg: ModelConfig) -> layers.AttentionConfig:
    return layers.AttentionConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)


def _layer(tree: Params, j: int) -> Params:
    """Layer ``j``'s slice of a layer-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, j) for k, v in tree.items()}
    return tree[j]


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the port serves the dense family only; {cfg.family!r} "
                f"arrives with ROADMAP.md queue A item 17")
        if cfg.parallel.attention_chunk:
            raise NotImplementedError(
                "chunked attention (parallel.attention_chunk) is not ported "
                "(ROADMAP.md queue A item 9)")
        self.cfg = cfg
        self.acfg = _attn_cfg(cfg)

    # -- params ------------------------------------------------------------
    def init_params(self, seed: int, device) -> Params:
        """Random weights from ``seed`` on ``device`` (a torch generator:
        the bits differ from the reference's jax.random init; tests convert
        the reference's tree instead, see ``models/convert.py``)."""
        cfg = self.cfg
        dtype, L = cfg.torch_dtype, cfg.num_layers
        gen = torch.Generator(device=device).manual_seed(int(seed))
        kw = dict(dtype=dtype, device=device)
        return {
            "embedding": layers.init_embedding(gen, cfg.vocab_size,
                                               cfg.d_model, **kw),
            "final_norm": layers.init_rmsnorm(cfg.d_model, **kw),
            BLOCK: {SLOT: {
                "pre_norm": layers.init_rmsnorm(cfg.d_model, layers=L, **kw),
                "post_norm": layers.init_rmsnorm(cfg.d_model, layers=L, **kw),
                "attn": layers.init_attention(gen, self.acfg, layers=L, **kw),
                "ffn": layers.init_swiglu(gen, cfg.d_model, cfg.d_ff,
                                          layers=L, **kw),
            }},
        }

    # -- cache -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device) -> Params:
        cfg = self.cfg
        return {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            BLOCK: {SLOT: layers.init_kv_cache(
                batch, max_len, cfg.num_kv_heads, cfg.head_dim_,
                cfg.torch_dtype, device, layers=cfg.num_layers)},
        }

    # -- forward -----------------------------------------------------------
    def _layer_fwd(self, lp: Params, x: torch.Tensor, positions: torch.Tensor,
                   cache_sl: Params, mode: str) -> torch.Tensor:
        cfg = self.cfg
        h = layers.rmsnorm(lp["pre_norm"], x, cfg.norm_eps)
        attend = (layers.attention_prefill if mode == "prefill"
                  else layers.attention_decode)
        x = x + attend(lp["attn"], self.acfg, h, cache_sl, positions)
        h = layers.rmsnorm(lp["post_norm"], x, cfg.norm_eps)
        return x + layers.swiglu(lp["ffn"], h)

    def _run(self, params: Params, x: torch.Tensor, positions: torch.Tensor,
             cache: Params, mode: str) -> torch.Tensor:
        bp, bc = params[BLOCK], cache[BLOCK]
        for j in range(self.cfg.num_layers):
            x = self._layer_fwd(_layer(bp, j)[SLOT], x, positions,
                                _layer(bc, j)[SLOT], mode)
        return x

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = layers.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return layers.unembed(params["embedding"], x)

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params):
        """tokens [b, s] -> (last-position logits [b, vocab] f32, cache);
        fills cache[0, s) in place and sets ``pos`` to s. Positions are
        0..s-1 for every row: left-padded prompts attend to their pads, as
        in the reference."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        x = layers.embed(params["embedding"], tokens)
        x = self._run(params, x, positions, cache, "prefill")
        cache["pos"].fill_(s)
        logits = self._unembed(params, x[:, -1:, :])
        return logits[:, 0], cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params):
        """tokens [b, 1] -> (logits [b, vocab] f32, cache); appends one KV
        position per row in place and advances ``pos``."""
        positions = cache["pos"][:, None].clone()
        x = layers.embed(params["embedding"], tokens)
        x = self._run(params, x, positions, cache, "decode")
        cache["pos"] += 1
        logits = self._unembed(params, x)
        return logits[:, 0], cache

