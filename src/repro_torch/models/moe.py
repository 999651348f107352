"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro.models.moe``).

Each token picks its top-k experts; the (token, choice) pairs are sorted by
expert (stably), each pair's place in its expert's queue is its rank less
the start of the expert's run, and pairs past ``capacity`` are dropped
(Switch semantics). The kept pairs fill an ``[experts, capacity, d]``
buffer, the experts run as batched matrix products, and the outputs come
back weighted by the routing weights. Covers dbrx (16e top-4), deepseek-v3
(1 shared + 256 routed top-8, sigmoid gating) and jamba (16e top-2).

``capacity = max(1, int(capacity_factor * tokens * k / experts))`` depends
on the tokens in the call, so at a capacity factor that drops, a row's
output depends on its batch-mates, as in the reference.

Where the reference leaned on JAX semantics the port spells them out:
``lax.top_k`` keeps the lower index on a tie (a stable descending sort
here), ``jnp.argsort`` is stable (``stable=True``), ``.at[dest].set`` drops
out-of-range destinations (the dropped pairs are masked out), and the
combine is a fixed-order sum over each token's k choices in f32 instead of
a scatter-add, whose atomics on the card would change the bits from run to
run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Params = Any


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    gating: str = "softmax"  # "softmax" | "sigmoid" (deepseek-v3)
    router_aux_weight: float = 0.01


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.bfloat16, device=None, n_layers: int = 1) -> Params:
    """Params for ``n_layers`` stacked MoE FFNs (leading axis); the router
    is f32, as in the reference."""
    e, f, L = cfg.num_experts, cfg.d_ff_expert, n_layers
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": layers.dense_init(gen, (L, d_model, e), dtype=torch.float32,
                                    device=device),
        "experts": {
            "w_gate": layers.dense_init(gen, (L, e, d_model, f),
                                        in_axis_size=d_model, **kw),
            "w_up": layers.dense_init(gen, (L, e, d_model, f),
                                      in_axis_size=d_model, **kw),
            "w_down": layers.dense_init(gen, (L, e, f, d_model),
                                        in_axis_size=f, **kw),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = layers.init_swiglu(gen, d_model,
                                         f * cfg.num_shared_experts,
                                         layers=L, **kw)
    return p


def _expert_counts(flat_expert: torch.Tensor, e: int) -> torch.Tensor:
    """Pairs routed to each expert, [e] int64: an integer scatter-add
    (deterministic, and unlike ``bincount`` it sizes its output without
    reading the data back to the host)."""
    return torch.zeros(e, dtype=torch.int64, device=flat_expert.device
                       ).scatter_add_(0, flat_expert,
                                      torch.ones_like(flat_expert))


def route(params: Params, cfg: MoEConfig, x: torch.Tensor):
    """x: [t, d] -> (weights [t, k] f32, indices [t, k] int64, aux loss)."""
    logits = x.float() @ params["router"].float()
    if cfg.gating == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    # lax.top_k: largest first, the lower index first among equals
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    indices = order[:, :cfg.top_k]
    weights = torch.gather(scores, 1, indices)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-9)

    # Switch-style load-balance loss: E * sum_e(frac_tokens_e * frac_prob_e)
    probs = torch.softmax(logits, dim=-1)
    e = cfg.num_experts
    counts = _expert_counts(indices.reshape(-1), e).float()
    frac_tokens = counts / indices.numel()
    frac_probs = probs.mean(dim=0)
    aux = e * (frac_tokens * frac_probs).sum() * cfg.router_aux_weight
    return weights, indices, aux


def moe_ffn_tokens(params: Params, cfg: MoEConfig, xf: torch.Tensor,
                   experts: Optional[Tuple[int, int]] = None,
                   routing=None):
    """MoE over flat tokens xf: [t, d] -> ([t, d], aux). With ``experts=(lo,
    hi)``, ``params["experts"]`` holds experts ``[lo, hi)`` only and the
    output is their part of the sum (see the module docstring).
    ``routing`` is :func:`route`'s result for ``xf`` when the caller made
    it (a tensor-parallel training shard: the tokens are routed once, on
    replicated values)."""
    t, d = xf.shape
    e, k = cfg.num_experts, cfg.top_k
    lo, hi = experts or (0, e)
    n = hi - lo
    weights, indices, aux = routing or route(params, cfg, xf)

    tk = t * k
    capacity = max(1, int(cfg.capacity_factor * tk / e))
    dev = xf.device

    flat_expert = indices.reshape(tk)
    flat_weight = weights.reshape(tk)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)

    order = torch.argsort(flat_expert, stable=True)
    s_expert = flat_expert[order]
    s_token = flat_token[order]
    s_weight = flat_weight[order]

    # position within the expert's queue = rank - start of the expert's run
    counts = _expert_counts(flat_expert, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tk, device=dev) - starts[s_expert]
    keep = pos < capacity
    if experts is not None:
        keep = keep & (s_expert >= lo) & (s_expert < hi)
    # a dropped pair (or one whose expert another shard holds) writes to a
    # spare row past the experts' rows (the reference's out-of-range write,
    # which writes nothing) and reads back the clamped last row, weighted
    # by zero; no mask, so no host sync
    slot = (s_expert - lo) * capacity + pos
    dest = torch.where(keep, slot, n * capacity)

    buf = torch.zeros((n * capacity + 1, d), dtype=xf.dtype, device=dev)
    buf[dest] = xf[s_token]
    expert_in = buf[:-1].reshape(n, capacity, d)

    ex = params["experts"]
    g = torch.bmm(expert_in, ex["w_gate"])
    u = torch.bmm(expert_in, ex["w_up"])
    expert_out = torch.bmm(F.silu(g) * u, ex["w_down"])
    flat_out = expert_out.reshape(n * capacity, d)

    back = flat_out[torch.where(keep, slot, n * capacity - 1)].float()
    back = back * (s_weight * keep.float())[:, None]
    # combine in a fixed order: un-sort to [t, k, d] and sum the k choices
    # of each token in order
    pairs = torch.empty_like(back)
    pairs[order] = back
    pairs = pairs.reshape(t, k, d)
    out = pairs[:, 0]
    for j in range(1, k):
        out = out + pairs[:, j]
    return out.to(xf.dtype), aux


def moe_forward(params: Params, cfg: MoEConfig, x: torch.Tensor,
                experts: Optional[Tuple[int, int]] = None, routing=None):
    """x: [b, s, d] -> ([b, s, d], aux_loss); with ``experts`` a shard's
    part (its expert range and, given its ``d_ff`` block of them, its part
    of the shared experts), with ``routing`` the flat tokens' routing
    (:func:`moe_ffn_tokens`)."""
    b, s, d = x.shape
    out, aux = moe_ffn_tokens(params, cfg, x.reshape(b * s, d), experts,
                              routing)
    out = out.reshape(b, s, d)
    if cfg.num_shared_experts:
        out = out + layers.swiglu(params["shared"], x)
    return out, aux
