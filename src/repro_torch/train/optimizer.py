"""AdamW from scratch with a configurable moment dtype (port of
``repro.train.optimizer``).

``moment_dtype="bfloat16"`` halves the optimizer state's memory. The
moments are held in that dtype; each update is computed in f32 and cast
back to the parameter's dtype, as in the reference. Trees are nested
dicts of tensors; the update is functional (new tensors, the old state
left as it was), so a caller may keep an earlier state and step it again.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.sealing import tree_leaves_with_names, tree_map

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Params
    v: Params
    step: torch.Tensor      # int32 scalar


def init_opt_state(cfg: AdamWConfig, params: Params) -> OptState:
    dt = _DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = next(tree_leaves_with_names(params))[1].device
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac``, in f32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    progress = ((s - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, summed in the
    reference's leaf order."""
    sums = [leaf.float().square().sum()
            for _, leaf in tree_leaves_with_names(tree)]
    return torch.stack(sums).sum().sqrt()


def clip_by_global_norm(grads: Params, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm`` in their own
    dtypes, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_scalars(cfg: AdamWConfig, step: torch.Tensor):
    """(lr, bias corrections 1 and 2) of update number ``step``, f32."""
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    return lr, bc1, bc2


# elements a chunk of a leaf's update: bounds its f32 temporaries (a
# 1 G-element expert stack would otherwise hold about 20 GB of them)
ADAMW_CHUNK = 1 << 26


def adamw_leaf(cfg: AdamWConfig, scalars, p, g, m, v):
    """One leaf's (or any slice of it: the update is element by element)
    new (param, m, v), computed in f32 and cast back, ADAMW_CHUNK elements
    at a time; the chunks change no bit."""
    if p.numel() <= ADAMW_CHUNK:
        return _adamw(cfg, scalars, p, g, m, v)
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in (p, m, v)]
    flat = [t.reshape(-1) for t in (p, g, m, v)]
    for i in range(0, p.numel(), ADAMW_CHUNK):
        for out, part in zip(outs, _adamw(
                cfg, scalars, *(t[i:i + ADAMW_CHUNK] for t in flat))):
            out.view(-1)[i:i + ADAMW_CHUNK] = part
    return tuple(outs)


def _adamw(cfg: AdamWConfig, scalars, p, g, m, v):
    lr, bc1, bc2 = scalars
    gf = g.float()
    mf = m.float() * cfg.b1 + gf * (1 - cfg.b1)
    vf = v.float() * cfg.b2 + gf.square() * (1 - cfg.b2)
    delta = (mf / bc1) / ((vf / bc2).sqrt() + cfg.eps) \
        + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), mf.to(m.dtype), \
        vf.to(v.dtype)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: OptState):
    """Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    scalars = adamw_scalars(cfg, step)
    out = tree_map(lambda p, g, m, v: adamw_leaf(cfg, scalars, p, g, m, v),
                   params, grads, state.m, state.v)  # leaves: triples
    new_p, new_m, new_v = (tree_map(lambda o: o[i], out) for i in range(3))
    return new_p, OptState(new_m, new_v, step), {"grad_norm": gnorm,
                                                 "lr": scalars[0]}
