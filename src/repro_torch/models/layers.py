"""Core transformer layers: norms, RoPE, GQA attention, MLPs (port of
``repro.models.layers``, dense path).

Plain functions over nested-dict params with the reference's layouts
(``wq [d, h, hd]``, ``wo [h, hd, d]``, ``w_gate [d, ff]``, caches
``[b, max_len, hk, hd]``). Compute dtype is the params' (bf16 for the full
configs) with f32 softmax, norm and logits, as in the reference: where JAX
multiplied bf16 with ``preferred_element_type=f32``, the port upcasts the
operands first, because a bf16 matmul in torch rounds its output to bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Any  # nested dict of tensors


# ---------------------------------------------------------------------------
# initializers (torch generators; the bits differ from jax.random's)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis_size: Optional[int] = None,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (matches Llama-family practice)."""
    fan_in = in_axis_size if in_axis_size is not None else shape[-2]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return w.mul_(1.0 / np.sqrt(fan_in)).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype=torch.bfloat16, device=None,
                 layers: Optional[int] = None) -> Params:
    shape = (d,) if layers is None else (layers, d)
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, head_dim]; positions: broadcastable to [..., seq].
    Rotates the two halves of the head dim (not interleaved pairs)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs  # [..., seq, hd/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    use_rope: bool = True


def init_attention(gen: torch.Generator, cfg: AttentionConfig,
                   dtype=torch.bfloat16, device=None, layers: int = 1) -> Params:
    """Params for ``layers`` stacked attention blocks (leading axis)."""
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(gen, (layers, d, h, hd), in_axis_size=d, **kw),
        "wk": dense_init(gen, (layers, d, hk, hd), in_axis_size=d, **kw),
        "wv": dense_init(gen, (layers, d, hk, hd), in_axis_size=d, **kw),
        "wo": dense_init(gen, (layers, h, hd, d), in_axis_size=h * hd, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, layers=layers, **kw)
        p["k_norm"] = init_rmsnorm(hd, layers=layers, **kw)
    return p


def _qkv(params: Params, cfg: AttentionConfig, x: torch.Tensor,
         positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cfg.use_rope:
        pos = positions[:, None, :]
        q = apply_rope(q.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
    return q, k, v


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
         q_positions: Optional[torch.Tensor] = None,
         kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention with GQA broadcast.

    q: [b, sq, h, hd]; k/v: [b, skv, hk, hd]. ``q_positions`` [b, sq] are the
    queries' absolute positions (causal masking against a cache);
    ``kv_valid_len`` [b] the number of valid cache entries. Logits and
    softmax in f32; probs cast to v's dtype before PV, which accumulates in
    f32, as in the reference."""
    b, sq, h, hd = q.shape
    hk = k.shape[2]
    group = h // hk
    qg = q.reshape(b, sq, hk, group, hd)
    scale = 1.0 / np.sqrt(hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.float(), k.float()) * scale
    skv = k.shape[1]
    kv_pos = torch.arange(skv, device=q.device)[None, :]  # [1, skv]
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        qp = q_positions if q_positions is not None else torch.arange(
            sq, device=q.device)[None, :].expand(b, sq)
        mask &= kv_pos[:, None, :] <= qp[:, :, None]
    if kv_valid_len is not None:
        mask &= kv_pos[:, None, :] < kv_valid_len[:, None, None]
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None, layers: int = 1) -> Params:
    shape = (layers, batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(params: Params, cfg: AttentionConfig, x: torch.Tensor,
                      cache: Params, positions: torch.Tensor):
    """Prefill: full causal attention, and k/v written into ``cache``
    (``[b, max_len, hk, hd]`` views) at [0, s) in place (the reference
    rebuilt the cache with ``dynamic_update_slice``)."""
    q, k, v = _qkv(params, cfg, x, positions)
    s = x.shape[1]
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    out = sdpa(q, k, v, causal=cfg.causal, q_positions=positions)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def attention_decode(params: Params, cfg: AttentionConfig, x: torch.Tensor,
                     cache: Params, positions: torch.Tensor):
    """One-token decode: x [b,1,d], positions [b,1] absolute position.

    Writes k/v into the cache at ``positions`` in place, then attends over
    the valid prefix. The write index is clamped to ``max_len - 1`` as
    ``dynamic_update_slice`` clamps it in the reference: idle slots keep
    advancing their position and must land on the last row, not fail."""
    q, k, v = _qkv(params, cfg, x, positions)
    b, max_len = cache["k"].shape[:2]
    rows = torch.arange(b, device=x.device)
    idx = positions[:, 0].long().clamp(0, max_len - 1)
    cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
    valid = positions[:, 0] + 1
    out = sdpa(q, cache["k"], cache["v"], causal=True,
               q_positions=positions, kv_valid_len=valid)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.bfloat16, device=None, layers: int = 1) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {
        "w_gate": dense_init(gen, (layers, d_model, d_ff), **kw),
        "w_up": dense_init(gen, (layers, d_model, d_ff), **kw),
        "w_down": dense_init(gen, (layers, d_ff, d_model), in_axis_size=d_ff,
                             **kw),
    }


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, params["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, params["w_up"])
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, params["w_down"])


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.bfloat16, device=None) -> Params:
    return {"table": embed_init(gen, (vocab, d_model), dtype, device)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding; f32 logits, the operands upcast before the product."""
    return torch.einsum("bsd,vd->bsv", x.float(), params["table"].float())
