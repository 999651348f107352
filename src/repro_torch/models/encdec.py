"""Encoder-decoder transformer, the Whisper backbone (port of
``repro.models.encdec``).

The audio conv frontend is a stub, as in the reference: precomputed frame
embeddings ``[b, frames, d_model]`` go straight into the encoder. RoPE
stands in for Whisper's sinusoidal and learned position tables; LayerNorm
and the tanh-approximated GELU match Whisper. Params and caches keep the
reference's layout: ``enc_layers``/``dec_layers`` stacked on a leading
layer axis, and a cache of ``self_k``/``self_v``
``[L, b, max_target_len, hk, hd]``, ``cross_k``/``cross_v``
``[L, b, enc_len, hk, hd]`` and ``pos`` ``[b]``, written in place.
Any ``parallel.remat`` but "none" recomputes each encoder and decoder
layer in the backward pass of a training pass, as the reference's
``jax.checkpoint`` of its scan bodies does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.transformer import (_layer, _layers, generator,
                                            masked_nll, remat)

Params = Any


def _attn_cfg(cfg: ModelConfig, causal: bool) -> layers.AttentionConfig:
    return layers.AttentionConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        qk_norm=False, rope_theta=cfg.rope_theta, causal=causal)


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.enc_cfg = _attn_cfg(cfg, causal=False)
        self.dec_cfg = _attn_cfg(cfg, causal=True)

    def init_params(self, seed: int, device) -> Params:
        """Random weights from ``seed`` on ``device`` (torch generator
        bits, not the reference's)."""
        cfg = self.cfg
        gen = generator(seed, device)
        kw = dict(dtype=cfg.torch_dtype, device=device)
        d, ff = cfg.d_model, cfg.d_ff
        le, ld = cfg.encoder_layers, cfg.decoder_layers
        enc = {
            "pre_norm": layers.init_layernorm(d, layers=le, **kw),
            "attn": layers.init_attention(gen, self.enc_cfg, layers=le, **kw),
            "post_norm": layers.init_layernorm(d, layers=le, **kw),
            "mlp": layers.init_gelu_mlp(gen, d, ff, layers=le, **kw),
        }
        dec = {
            "norm1": layers.init_layernorm(d, layers=ld, **kw),
            "self_attn": layers.init_attention(gen, self.dec_cfg, layers=ld,
                                               **kw),
            "norm2": layers.init_layernorm(d, layers=ld, **kw),
            "cross_attn": layers.init_cross_attention(gen, self.enc_cfg,
                                                      layers=ld, **kw),
            "norm3": layers.init_layernorm(d, layers=ld, **kw),
            "mlp": layers.init_gelu_mlp(gen, d, ff, layers=ld, **kw),
        }
        return {
            "embedding": layers.init_embedding(gen, cfg.vocab_size, d, **kw),
            "enc_layers": enc,
            "dec_layers": dec,
            "enc_final_norm": layers.init_layernorm(d, **kw),
            "dec_final_norm": layers.init_layernorm(d, **kw),
        }

    @staticmethod
    def _stack(tree: Params, n: int):
        """The layer slices a pass loops over: unbound once while
        gradients are recorded (``transformer._layers``), else views of
        each layer taken as the loop reaches it."""
        if torch.is_grad_enabled():
            return _layers(tree, n)
        return [_layer(tree, j) for j in range(n)]

    def _remat(self, fn):
        """``fn`` recomputed in the backward pass while gradients are
        recorded, unless ``parallel.remat`` is "none"."""
        on = self.cfg.parallel.remat != "none" and torch.is_grad_enabled()
        return remat(fn, "full" if on else "none")

    # -- encoder -----------------------------------------------------------
    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = frames.shape
        positions = torch.arange(s, device=frames.device)[None, :].expand(b, s)

        def body(x, lp):
            h = layers.layernorm(lp["pre_norm"], x, cfg.norm_eps)
            x = x + layers.attention_forward(lp["attn"], self.enc_cfg, h,
                                             positions)
            h = layers.layernorm(lp["post_norm"], x, cfg.norm_eps)
            return x + layers.gelu_mlp(lp["mlp"], h)

        x = frames
        lps = self._stack(params["enc_layers"], cfg.encoder_layers)
        for j in range(cfg.encoder_layers):
            x = self._remat(body)(x, lps[j])
        return layers.layernorm(params["enc_final_norm"], x, cfg.norm_eps)

    def _dec_tail(self, lp: Params, x: torch.Tensor, ek: torch.Tensor,
                  ev: torch.Tensor) -> torch.Tensor:
        """A decoder layer after its self-attention: cross-attention over
        the encoder's k/v, then the GELU MLP."""
        eps = self.cfg.norm_eps
        h = layers.layernorm(lp["norm2"], x, eps)
        x = x + layers.cross_attention(lp["cross_attn"], self.enc_cfg, h,
                                       ek, ev)
        h = layers.layernorm(lp["norm3"], x, eps)
        return x + layers.gelu_mlp(lp["mlp"], h)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = layers.layernorm(params["dec_final_norm"], x, self.cfg.norm_eps)
        return layers.unembed(params["embedding"], x)

    # -- teacher-forced decoder --------------------------------------------
    def forward(self, params: Params, frames: torch.Tensor,
                tokens: torch.Tensor):
        """-> (logits [b, t, vocab] f32, aux = f32 zero)."""
        cfg = self.cfg
        enc_out = self.encode(params, frames)
        b, t = tokens.shape
        positions = torch.arange(t, device=tokens.device)[None, :].expand(b, t)
        x = layers.embed(params["embedding"], tokens)

        def body(x, lp):
            h = layers.layernorm(lp["norm1"], x, cfg.norm_eps)
            x = x + layers.attention_forward(lp["self_attn"], self.dec_cfg, h,
                                             positions)
            ek, ev = layers.encode_kv(lp["cross_attn"], enc_out)
            return self._dec_tail(lp, x, ek, ev)

        lps = self._stack(params["dec_layers"], cfg.decoder_layers)
        for j in range(cfg.decoder_layers):
            x = self._remat(body)(x, lps[j])
        return (self._logits(params, x),
                torch.zeros((), dtype=torch.float32, device=tokens.device))

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """Teacher-forced cross-entropy of ``batch["labels"]`` (labels < 0
        masked out): (loss, {"ce_loss", "aux_loss"})."""
        logits, aux = self.forward(params, batch["frames"], batch["tokens"])
        tot, cnt = masked_nll(logits, batch["labels"])
        loss = tot / cnt.clamp(min=1.0)
        return loss + aux, {"ce_loss": loss, "aux_loss": aux}

    # -- tensor-parallel training ----------------------------------------------
    def _mlp_shards(self, lps, h: torch.Tensor, tp) -> torch.Tensor:
        """The GELU MLP over the shards' ``d_ff`` blocks: the partials
        reduced, ``b_out`` added once."""
        return tp.psum([layers.gelu_mlp(lp["mlp"], x, out_bias=False)
                        for lp, x in zip(lps, tp.copy(h))]) \
            + lps[0]["mlp"]["b_out"]

    def loss_shards(self, shards, batch: Dict[str, torch.Tensor], tp):
        """``loss`` over tensor-parallel shards: ``shards`` holds each local
        model shard's params (its heads of every attention, its ``d_ff``
        block of each MLP, its vocabulary block when the vocabulary splits;
        norms and ``b_out`` whole), ``tp`` the
        :class:`~repro_torch.distributed.tensor_parallel.TensorParallelLoss`
        whose collectives join them. The frames are replicated; each
        attention and MLP half runs on the shards' copies of its normed
        input and its partials are reduced; every decoder layer's
        cross-attention projects its own copy of the encoder output.
        Returns (loss, ce_loss, aux_loss)."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        counting = tp.mg.counting    # remat's recompute counts bytes so
        enc_cfg = dataclasses.replace(self.enc_cfg, **tp.heads)
        dec_cfg = dataclasses.replace(self.dec_cfg, **tp.heads)
        frames, tokens = batch["frames"], batch["tokens"]
        # heads tp does not divide: every attention runs whole, once
        whole = "attn" in tp.replicated

        def attend(lps, key, acfg, h, positions):
            if whole:
                return layers.attention_forward(lps[0][key], acfg, h,
                                                positions)
            return tp.psum([layers.attention_forward(lp[key], acfg, x,
                                                     positions)
                            for lp, x in zip(lps, tp.copy(h))])

        b, s, _ = frames.shape
        positions = torch.arange(s, device=frames.device)[None, :].expand(b,
                                                                          s)

        def enc_body(x, lps):
            with tp.mg.counted(counting):
                h = layers.layernorm(lps[0]["pre_norm"], x, eps)
                x = x + attend(lps, "attn", enc_cfg, h, positions)
                h = layers.layernorm(lps[0]["post_norm"], x, eps)
                return x + self._mlp_shards(lps, h, tp)

        x = frames
        stacks = [_layers(t["enc_layers"], cfg.encoder_layers) for t in shards]
        for j in range(cfg.encoder_layers):
            x = self._remat(enc_body)(x, [s[j] for s in stacks])
        enc_out = layers.layernorm(shards[0]["enc_final_norm"], x, eps)

        b, t = tokens.shape
        dec_pos = torch.arange(t, device=tokens.device)[None, :].expand(b, t)

        def dec_body(x, lps):
            with tp.mg.counted(counting):
                h = layers.layernorm(lps[0]["norm1"], x, eps)
                x = x + attend(lps, "self_attn", dec_cfg, h, dec_pos)
                h = layers.layernorm(lps[0]["norm2"], x, eps)
                if whole:
                    ek, ev = layers.encode_kv(lps[0]["cross_attn"], enc_out)
                    x = x + layers.cross_attention(lps[0]["cross_attn"],
                                                   enc_cfg, h, ek, ev)
                else:
                    parts = []
                    for lp, hx, enc in zip(lps, tp.copy(h),
                                           tp.copy(enc_out)):
                        ek, ev = layers.encode_kv(lp["cross_attn"], enc)
                        parts.append(layers.cross_attention(
                            lp["cross_attn"], enc_cfg, hx, ek, ev))
                    x = x + tp.psum(parts)
                h = layers.layernorm(lps[0]["norm3"], x, eps)
                return x + self._mlp_shards(lps, h, tp)

        x = tp.lookup(shards, tokens)
        stacks = [_layers(t["dec_layers"], cfg.decoder_layers) for t in shards]
        for j in range(cfg.decoder_layers):
            x = self._remat(dec_body)(x, [s[j] for s in stacks])
        logits = tp.logits(shards, layers.layernorm(
            shards[0]["dec_final_norm"], x, eps))
        tot, cnt = masked_nll(logits, batch["labels"])
        loss = tot / cnt.clamp(min=1.0)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return loss + aux, loss, aux

    # -- serving over model shards ----------------------------------------------
    # ``tp`` is a :class:`~repro_torch.distributed.tensor_parallel.
    # EncDecParallel`; ``cls`` holds each local model shard's cache views of
    # one layer. With the heads split each shard attends with its heads over
    # its heads of the cache and the partials are reduced; with the heads
    # whole (``tp.sp``: the caches split their positions over ``model``)
    # attention runs once on every shard, the prefill storing each shard's
    # block of positions and a decode step merging the shards' blocks.

    def _self_attend_shards(self, lps, acfg, h: torch.Tensor, tp, cls,
                            mode: str, positions: torch.Tensor):
        if not tp.sp:
            attend = (layers.attention_prefill if mode == "prefill"
                      else layers.attention_decode)
            return tp.mg.all_reduce([
                attend(lp["self_attn"], acfg, h,
                       {"k": cl["self_k"], "v": cl["self_v"]}, positions)
                for lp, cl in zip(lps, cls)])
        p = lps[0]["self_attn"]
        q, k, v = layers._qkv(p, acfg, h, positions)
        if mode == "prefill":
            for shard, cl in zip(tp.mg.local, cls):
                tp.store_block(cl, "self_k", k, shard)
                tp.store_block(cl, "self_v", v, shard)
            # the prefill's positions are 0..t-1
            out = layers._attend_prompt(acfg, q, k, v)
        else:
            out = tp.attend_blocks(q, [(cl["self_k"], cl["self_v"])
                                       for cl in cls], positions, (k, v))
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    def _cross_attend_shards(self, lps, acfg, h: torch.Tensor, tp, cls,
                             enc_out=None):
        """Cross-attention over the encoder's rows: the prefill projects
        ``enc_out`` and stores them, a decode step (``enc_out`` None)
        reads the cache."""
        if not tp.sp:
            parts = []
            for lp, cl in zip(lps, cls):
                p = lp["cross_attn"]
                if enc_out is None:
                    ek, ev = cl["cross_k"], cl["cross_v"]
                else:
                    ek, ev = layers.encode_kv(p, enc_out)
                    cl["cross_k"].copy_(ek.to(cl["cross_k"].dtype))
                    cl["cross_v"].copy_(ev.to(cl["cross_v"].dtype))
                parts.append(layers.cross_attention(p, acfg, h, ek, ev))
            return tp.mg.all_reduce(parts)
        p = lps[0]["cross_attn"]
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
        if enc_out is None:
            out = tp.attend_blocks(q, [(cl["cross_k"], cl["cross_v"])
                                       for cl in cls])
        else:
            k, v = layers.encode_kv(p, enc_out)
            for shard, cl in zip(tp.mg.local, cls):
                tp.store_block(cl, "cross_k", k, shard)
                tp.store_block(cl, "cross_v", v, shard)
            out = layers.sdpa(q, k, v, causal=False)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])

    def _mlp_serve(self, lps, h: torch.Tensor, tp) -> torch.Tensor:
        """The GELU MLP over the shards' ``d_ff`` blocks, reduced, with
        ``b_out`` added once."""
        return tp.mg.all_reduce([layers.gelu_mlp(lp["mlp"], h,
                                                 out_bias=False)
                                 for lp in lps]) + lps[0]["mlp"]["b_out"]

    def prefill_shards(self, shards, frames: torch.Tensor,
                       tokens: torch.Tensor, cache: Params, tp):
        """:meth:`prefill` over model shards: ``shards`` holds each local
        model shard's params (its heads of every attention unless ``tp``
        does not divide them, its ``d_ff`` block of each MLP, its
        vocabulary block when the vocabulary splits), ``cache`` the views
        each local shard holds (:meth:`EncDecParallel.cache_views`).
        Returns (last-position logits, whole on every shard)."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        enc_cfg = dataclasses.replace(self.enc_cfg, **tp.heads)
        dec_cfg = dataclasses.replace(self.dec_cfg, **tp.heads)
        b, s, _ = frames.shape
        positions = torch.arange(s, device=frames.device)[None, :].expand(b,
                                                                          s)
        x = frames
        for j in range(cfg.encoder_layers):
            lps = [_layer(t["enc_layers"], j) for t in shards]
            h = layers.layernorm(lps[0]["pre_norm"], x, eps)
            if tp.sp:
                x = x + layers.attention_forward(lps[0]["attn"], enc_cfg, h,
                                                 positions)
            else:
                x = x + tp.mg.all_reduce([layers.attention_forward(
                    lp["attn"], enc_cfg, h, positions) for lp in lps])
            h = layers.layernorm(lps[0]["post_norm"], x, eps)
            x = x + self._mlp_serve(lps, h, tp)
        enc_out = layers.layernorm(shards[0]["enc_final_norm"], x, eps)
        t = tokens.shape[1]
        dec_pos = torch.arange(t, device=tokens.device)[None, :].expand(b, t)
        x = tp.embed(shards, tokens)
        for j in range(cfg.decoder_layers):
            lps = [_layer(tr["dec_layers"], j) for tr in shards]
            cls = [tp.layer_cache(c, j) for c in cache]
            h = layers.layernorm(lps[0]["norm1"], x, eps)
            x = x + self._self_attend_shards(lps, dec_cfg, h, tp, cls,
                                             "prefill", dec_pos)
            h = layers.layernorm(lps[0]["norm2"], x, eps)
            x = x + self._cross_attend_shards(lps, enc_cfg, h, tp, cls,
                                              enc_out)
            h = layers.layernorm(lps[0]["norm3"], x, eps)
            x = x + self._mlp_serve(lps, h, tp)
        for c in cache:
            c["pos"].fill_(t)
        return tp.logits(shards, layers.layernorm(
            shards[0]["dec_final_norm"], x[:, -1:], eps))[:, 0]

    def decode_shards(self, shards, tokens: torch.Tensor, cache: Params,
                      tp):
        """:meth:`decode_step` over model shards (see
        :meth:`prefill_shards`): -> logits [b, vocab] f32, whole on every
        shard; ``pos`` advances."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        enc_cfg = dataclasses.replace(self.enc_cfg, **tp.heads)
        dec_cfg = dataclasses.replace(self.dec_cfg, **tp.heads)
        positions = cache[0]["pos"][:, None].clone()
        x = tp.embed(shards, tokens)
        for j in range(cfg.decoder_layers):
            lps = [_layer(tr["dec_layers"], j) for tr in shards]
            cls = [tp.layer_cache(c, j) for c in cache]
            h = layers.layernorm(lps[0]["norm1"], x, eps)
            x = x + self._self_attend_shards(lps, dec_cfg, h, tp, cls,
                                             "decode", positions)
            h = layers.layernorm(lps[0]["norm2"], x, eps)
            x = x + self._cross_attend_shards(lps, enc_cfg, h, tp, cls)
            h = layers.layernorm(lps[0]["norm3"], x, eps)
            x = x + self._mlp_serve(lps, h, tp)
        cache[0]["pos"] += 1
        return tp.logits(shards, layers.layernorm(
            shards[0]["dec_final_norm"], x, eps))[:, 0]

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, enc_len: int, device) -> Params:
        cfg = self.cfg
        L, hk, hd = cfg.decoder_layers, cfg.num_kv_heads, cfg.head_dim_
        kw = dict(dtype=cfg.torch_dtype, device=device)
        return {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "self_k": torch.zeros((L, batch, cfg.max_target_len, hk, hd), **kw),
            "self_v": torch.zeros((L, batch, cfg.max_target_len, hk, hd), **kw),
            "cross_k": torch.zeros((L, batch, enc_len, hk, hd), **kw),
            "cross_v": torch.zeros((L, batch, enc_len, hk, hd), **kw),
        }

    def prefill(self, params: Params, frames: torch.Tensor,
                tokens: torch.Tensor, cache: Params):
        """Encode the frames, store every decoder layer's cross k/v, and
        prefill the decoder's self k/v: -> (last-position logits, cache)."""
        cfg = self.cfg
        enc_out = self.encode(params, frames)
        b, t = tokens.shape
        positions = torch.arange(t, device=tokens.device)[None, :].expand(b, t)
        x = layers.embed(params["embedding"], tokens)
        for j in range(cfg.decoder_layers):
            lp = _layer(params["dec_layers"], j)
            h = layers.layernorm(lp["norm1"], x, cfg.norm_eps)
            x = x + layers.attention_prefill(
                lp["self_attn"], self.dec_cfg, h,
                {"k": cache["self_k"][j], "v": cache["self_v"][j]}, positions)
            ek, ev = layers.encode_kv(lp["cross_attn"], enc_out)
            cache["cross_k"][j] = ek.to(cache["cross_k"].dtype)
            cache["cross_v"][j] = ev.to(cache["cross_v"].dtype)
            x = self._dec_tail(lp, x, ek, ev)
        cache["pos"].fill_(t)
        return self._logits(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params):
        """tokens [b, 1] -> (logits [b, vocab] f32, cache), in place."""
        cfg = self.cfg
        positions = cache["pos"][:, None].clone()
        x = layers.embed(params["embedding"], tokens)
        for j in range(cfg.decoder_layers):
            lp = _layer(params["dec_layers"], j)
            h = layers.layernorm(lp["norm1"], x, cfg.norm_eps)
            x = x + layers.attention_decode(
                lp["self_attn"], self.dec_cfg, h,
                {"k": cache["self_k"][j], "v": cache["self_v"][j]}, positions)
            x = self._dec_tail(lp, x, cache["cross_k"][j], cache["cross_v"][j])
        cache["pos"] += 1
        return self._logits(params, x)[:, 0], cache
