"""Core transformer layers: norms, RoPE, GQA and cross attention, MLPs
(port of ``repro.models.layers``).

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
from torch._subclasses.fake_tensor import is_fake

from repro_torch import tracing
from repro_torch.kernels import flash_attention, ops

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


def init_layernorm(d: int, dtype=torch.bfloat16, device=None,
                   layers: Optional[int] = None) -> Params:
    shape = (d,) if layers is None else (layers, d)
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 over the population variance (``jnp.var``'s)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


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
    chunk: int = 0           # >0: q-chunked attention (sdpa_chunked)


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


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 chunk: int, causal: bool,
                 q_positions: torch.Tensor) -> torch.Tensor:
    """Q-chunked attention: peak score memory is [b, h, chunk, s] instead
    of [b, h, s, s]; causal chunks only read keys up to their last
    position."""
    s = q.shape[1]
    outs = []
    for start in range(0, s, chunk):
        end = min(start + chunk, s)
        kv_end = end if causal else s
        outs.append(sdpa(q[:, start:end], k[:, :kv_end], v[:, :kv_end],
                         causal=causal, q_positions=q_positions[:, start:end]))
    return torch.cat(outs, dim=1)


def _attend_full(cfg: AttentionConfig, q, k, v, positions) -> torch.Tensor:
    """Attention over a whole sequence: q-chunked when ``cfg.chunk`` is set
    and the sequence is longer than a chunk."""
    if cfg.chunk and q.shape[1] > cfg.chunk:
        return sdpa_chunked(q, k, v, chunk=cfg.chunk, causal=cfg.causal,
                            q_positions=positions)
    return sdpa(q, k, v, causal=cfg.causal, q_positions=positions)


def _attend_prompt(cfg: AttentionConfig, q, k, v) -> torch.Tensor:
    """A prompt's attention over itself: q, k and v [b, s, ., hd] all at
    positions 0..s-1, which is what a prefill computes from the start of a
    row (it writes its KV at [0, s)). A caller whose queries start
    elsewhere attends with :func:`_attend_full` and its positions.

    Causal attention of a CUDA tensor, in a dtype and head dim kernel B2
    takes, runs through B2 (``ops.mha_flash``): the same scores on the
    tensor cores with f32 sums, and no ``[h, s, s]`` logits in device
    memory (``cfg.chunk`` only bounds those, so it needs nothing here). B2
    gives each (row, head) its own CTAs, so a row's bits are the same alone
    and in a batch. Everything else goes through :func:`_attend_full`, the
    reference's arithmetic. Each call counts ``model:attn_b2`` or
    ``model:attn_plain`` on the active tracer."""
    b, s = q.shape[:2]
    assert k.shape[1] == s, "a prompt attends over its own s positions"
    # a fake tensor (the dry run's) has no memory for the kernel to read
    if (q.is_cuda and not is_fake(q) and cfg.causal
            and q.dtype in flash_attention.DTYPES
            and q.shape[-1] in flash_attention.KERNEL_HEAD_DIMS):
        tracing.count("model:attn_b2")
        return ops.mha_flash(q, k, v)
    tracing.count("model:attn_plain")
    positions = torch.arange(s, device=q.device)[None, :].expand(b, s)
    return _attend_full(cfg, q, k, v, positions)


def attention_forward(params: Params, cfg: AttentionConfig, x: torch.Tensor,
                      positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention without a cache (training, the encoder's
    trunk and a teacher-forced pass)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _qkv(params, cfg, x, positions)
    out = _attend_full(cfg, q, k, v, positions)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None, layers: int = 1) -> Params:
    shape = (layers, batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(params: Params, cfg: AttentionConfig, x: torch.Tensor,
                      cache: Params, positions: torch.Tensor):
    """Prefill from position 0 (``positions`` are 0..s-1 in every row):
    full causal attention (:func:`_attend_prompt`), and k/v written into
    ``cache`` (``[b, max_len, hk, hd]`` views) at [0, s) in place (the
    reference rebuilt the cache with ``dynamic_update_slice``)."""
    q, k, v = _qkv(params, cfg, x, positions)
    s = x.shape[1]
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    out = _attend_prompt(cfg, q, k, v)
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
# cross-attention (the encoder-decoder's decoder)
# ---------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg: AttentionConfig,
                         dtype=torch.bfloat16, device=None,
                         layers: int = 1) -> Params:
    return init_attention(gen, dataclasses.replace(cfg, qk_norm=False),
                          dtype, device, layers)


def cross_attention(params: Params, cfg: AttentionConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """x: [b, sq, d]; enc_k/enc_v: precomputed [b, skv, hk, hd]."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    out = sdpa(q, enc_k, enc_v, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def encode_kv(params: Params, enc_out: torch.Tensor):
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"])
    return k, v


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


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.bfloat16, device=None, layers: int = 1) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {
        "w_in": dense_init(gen, (layers, d_model, d_ff), **kw),
        "b_in": torch.zeros((layers, d_ff), **kw),
        "w_out": dense_init(gen, (layers, d_ff, d_model), in_axis_size=d_ff,
                            **kw),
        "b_out": torch.zeros((layers, d_model), **kw),
    }


def gelu_mlp(params: Params, x: torch.Tensor,
             out_bias: bool = True) -> torch.Tensor:
    """GELU in f32 with the tanh approximation (``jax.nn.gelu``'s
    default). A tensor-parallel shard holds a ``d_ff`` block of ``w_in``,
    ``b_in`` and ``w_out``'s rows and passes ``out_bias=False``: its
    product is a partial, and ``b_out`` is added once after the
    reduction."""
    h = torch.einsum("bsd,df->bsf", x, params["w_in"]) + params["b_in"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    out = torch.einsum("bsf,fd->bsd", h, params["w_out"])
    return out + params["b_out"] if out_bias else out


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
