"""Multi-head Latent Attention, DeepSeek-V2/V3 (port of
``repro.models.mla``).

Queries and keys/values come from low-rank latent compressions; the decode
cache holds only the compressed KV latent and the decoupled RoPE key,
``{"ckv": [b, max_len, kv_rank], "krope": [b, max_len, rope_dim]}``, and
attention absorbs ``W_uk`` into the query so the per-key work is rank-wide.
Where the reference multiplied bf16 with ``preferred_element_type=f32``
(the two score products and the probabilities against the latent), the
port upcasts the operands and keeps the f32 result. With ``chunk`` set,
full-sequence attention runs over q chunks, so the [b, h, s, s] logits
are never materialized.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import layers

Params = Any


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    num_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_dim: int = 64
    nope_dim: int = 128      # per-head non-rope key/query dim
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    chunk: int = 0           # >0: q-chunked full-sequence attention


def init_mla(gen: torch.Generator, cfg: MLAConfig, dtype=torch.bfloat16,
             device=None, n_layers: int = 1) -> Params:
    d, h, L = cfg.d_model, cfg.num_heads, n_layers
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    kw = dict(dtype=dtype, device=device)
    return {
        "w_dq": layers.dense_init(gen, (L, d, qr), **kw),
        "q_norm": layers.init_rmsnorm(qr, layers=L, **kw),
        "w_uq": layers.dense_init(gen, (L, qr, h, cfg.nope_dim + cfg.rope_dim),
                                  in_axis_size=qr, **kw),
        "w_dkv": layers.dense_init(gen, (L, d, kr + cfg.rope_dim), **kw),
        "kv_norm": layers.init_rmsnorm(kr, layers=L, **kw),
        "w_uk": layers.dense_init(gen, (L, kr, h, cfg.nope_dim),
                                  in_axis_size=kr, **kw),
        "w_uv": layers.dense_init(gen, (L, kr, h, cfg.v_head_dim),
                                  in_axis_size=kr, **kw),
        "wo": layers.dense_init(gen, (L, h, cfg.v_head_dim, d),
                                in_axis_size=h * cfg.v_head_dim, **kw),
    }


def _compress(params: Params, cfg: MLAConfig, x: torch.Tensor,
              positions: torch.Tensor):
    """Per-token latent ckv [b, s, rank] and rotated shared key
    [b, s, rope]."""
    dkv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"])
    ckv, krope = dkv[..., :cfg.kv_lora_rank], dkv[..., cfg.kv_lora_rank:]
    ckv = layers.rmsnorm(params["kv_norm"], ckv)
    krope = layers.apply_rope(krope, positions, cfg.rope_theta)
    return ckv, krope


def _queries(params: Params, cfg: MLAConfig, x: torch.Tensor,
             positions: torch.Tensor):
    cq = layers.rmsnorm(params["q_norm"],
                        torch.einsum("bsd,dr->bsr", x, params["w_dq"]))
    q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"])
    q_nope, q_rope = q[..., :cfg.nope_dim], q[..., cfg.nope_dim:]
    q_rope = layers.apply_rope(q_rope.transpose(1, 2), positions[:, None, :],
                               cfg.rope_theta).transpose(1, 2)
    return q_nope, q_rope


def _attend(params: Params, cfg: MLAConfig, q_nope, q_rope, ckv, krope,
            q_positions, kv_valid_len: Optional[torch.Tensor] = None):
    """Attention over the latents: scores = q_nope . (W_uk ckv) +
    q_rope . krope, values = W_uv ckv, with W_uk absorbed into the
    query."""
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
    scale = 1.0 / np.sqrt(cfg.nope_dim + cfg.rope_dim)
    logits = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), ckv.float())
              + torch.einsum("bqhk,bsk->bhqs", q_rope.float(), krope.float())
              ) * scale
    skv = ckv.shape[1]
    kv_pos = torch.arange(skv, device=ckv.device)[None, :]
    mask = kv_pos[:, None, :] <= q_positions[:, :, None]
    if kv_valid_len is not None:
        mask &= kv_pos[:, None, :] < kv_valid_len[:, None, None]
    logits = torch.where(mask[:, None, :, :], logits,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=ckv.device))
    probs = torch.softmax(logits, dim=-1)
    out_lat = torch.einsum("bhqs,bsr->bqhr", probs.to(ckv.dtype).float(),
                           ckv.float())
    out = torch.einsum("bqhr,rhv->bqhv", out_lat.to(q_nope.dtype),
                       params["w_uv"])
    return torch.einsum("bqhv,hvd->bqd", out, params["wo"])


def _attend_maybe_chunked(params: Params, cfg: MLAConfig, q_nope, q_rope,
                          ckv, krope, positions) -> torch.Tensor:
    """Full-sequence attention; q-chunked when ``cfg.chunk`` is set, each
    chunk reading the latents up to its last position."""
    s = q_nope.shape[1]
    if not cfg.chunk or s <= cfg.chunk:
        return _attend(params, cfg, q_nope, q_rope, ckv, krope, positions)
    outs = []
    for start in range(0, s, cfg.chunk):
        end = min(start + cfg.chunk, s)
        outs.append(_attend(params, cfg, q_nope[:, start:end],
                            q_rope[:, start:end], ckv[:, :end],
                            krope[:, :end], positions[:, start:end]))
    return torch.cat(outs, dim=1)


def mla_forward(params: Params, cfg: MLAConfig, x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    ckv, krope = _compress(params, cfg, x, positions)
    q_nope, q_rope = _queries(params, cfg, x, positions)
    return _attend_maybe_chunked(params, cfg, q_nope, q_rope, ckv, krope,
                                 positions)


def init_mla_cache(batch: int, max_len: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, device=None,
                   n_layers: int = 1) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {
        "ckv": torch.zeros((n_layers, batch, max_len, cfg.kv_lora_rank), **kw),
        "krope": torch.zeros((n_layers, batch, max_len, cfg.rope_dim), **kw),
    }


def mla_prefill(params: Params, cfg: MLAConfig, x: torch.Tensor,
                cache: Params, positions: torch.Tensor) -> torch.Tensor:
    """Full causal attention over the prompt; ckv/krope written into
    ``cache`` (``[b, max_len, ...]`` views) at [0, s) in place."""
    ckv, krope = _compress(params, cfg, x, positions)
    s = x.shape[1]
    cache["ckv"][:, :s] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, :s] = krope.to(cache["krope"].dtype)
    q_nope, q_rope = _queries(params, cfg, x, positions)
    return _attend_maybe_chunked(params, cfg, q_nope, q_rope, ckv, krope,
                                 positions)


def mla_decode(params: Params, cfg: MLAConfig, x: torch.Tensor,
               cache: Params, positions: torch.Tensor) -> torch.Tensor:
    """One token per row: ckv/krope written at ``positions`` (clamped to
    ``max_len - 1`` as ``dynamic_update_slice`` clamps), then attention
    over the valid prefix."""
    ckv, krope = _compress(params, cfg, x, positions)
    b, max_len = cache["ckv"].shape[:2]
    rows = torch.arange(b, device=x.device)
    idx = positions[:, 0].long().clamp(0, max_len - 1)
    cache["ckv"][rows, idx] = ckv[:, 0].to(cache["ckv"].dtype)
    cache["krope"][rows, idx] = krope[:, 0].to(cache["krope"].dtype)
    q_nope, q_rope = _queries(params, cfg, x, positions)
    valid = positions[:, 0] + 1
    return _attend(params, cfg, q_nope, q_rope, cache["ckv"], cache["krope"],
                   positions, kv_valid_len=valid)
