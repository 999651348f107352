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
from repro_torch.models.transformer import (_layer, generator, masked_nll,
                                            remat)

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
        for j in range(cfg.encoder_layers):
            x = self._remat(body)(x, _layer(params["enc_layers"], j))
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

        for j in range(cfg.decoder_layers):
            x = self._remat(body)(x, _layer(params["dec_layers"], j))
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

        def attend(lps, key, acfg, h, positions):
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
        for j in range(cfg.encoder_layers):
            x = self._remat(enc_body)(x, [_layer(t["enc_layers"], j)
                                          for t in shards])
        enc_out = layers.layernorm(shards[0]["enc_final_norm"], x, eps)

        b, t = tokens.shape
        dec_pos = torch.arange(t, device=tokens.device)[None, :].expand(b, t)

        def dec_body(x, lps):
            with tp.mg.counted(counting):
                h = layers.layernorm(lps[0]["norm1"], x, eps)
                x = x + attend(lps, "self_attn", dec_cfg, h, dec_pos)
                h = layers.layernorm(lps[0]["norm2"], x, eps)
                parts = []
                for lp, hx, enc in zip(lps, tp.copy(h), tp.copy(enc_out)):
                    ek, ev = layers.encode_kv(lp["cross_attn"], enc)
                    parts.append(layers.cross_attention(
                        lp["cross_attn"], enc_cfg, hx, ek, ev))
                x = x + tp.psum(parts)
                h = layers.layernorm(lps[0]["norm3"], x, eps)
                return x + self._mlp_shards(lps, h, tp)

        x = tp.lookup(shards, tokens)
        for j in range(cfg.decoder_layers):
            x = self._remat(dec_body)(x, [_layer(t["dec_layers"], j)
                                          for t in shards])
        logits = tp.logits(shards, layers.layernorm(
            shards[0]["dec_final_norm"], x, eps))
        tot, cnt = masked_nll(logits, batch["labels"])
        loss = tot / cnt.clamp(min=1.0)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return loss + aux, loss, aux

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
