"""State-space sequence mixers: Mamba (selective SSM, for Jamba) and RWKV6
(port of ``repro.models.ssm``).

Both keep O(1) state per layer in sequence length. Mamba's full-sequence
pass is a chunked scan: a loop over chunks carries the state, and inside a
chunk the recurrence ``h_t = a_t * h_{t-1} + b_t`` is an inclusive scan
with the reference's ``combine``. JAX ran it as ``lax.associative_scan``;
torch has none, so the port runs a doubling (Hillis-Steele) pass, log2
(chunk) steps, which sums in another order: f32 results agree to about
1e-5 relative. RWKV6's ``lax.scan`` over time is a loop over time in f32.

Params are layer-stacked like the rest of the port (``n_layers`` leading
axis); the functions take one layer's slice. Mamba's state is
``{"conv": [b, d_conv - 1, d_inner], "ssm": [b, d_inner, d_state] f32}``,
RWKV6's ``tmix_x``/``cmix_x`` ``[b, d]`` and ``wkv`` ``[b, h, hd, hd]``
f32.

The ``*_shards`` functions are the tensor-parallel forms, for serving and
training (``distributed/tensor_parallel.py``): they take the local model
shards' params in a list, run the shards in lockstep and call the
collectives they are handed where a product contracts over the split dim
(and, in training, where a replicated value feeds each shard); their
sizes come from the shards' params. A Mamba shard holds a block of ``d_inner``
channels, an RWKV6 shard a block of heads and of the channel mix's
``d_ff``. Mamba's one-device functions keep their own operations (a shard
splits ``w_in``'s product and sums ``bcdt`` in f32); RWKV6's one-device
mixes are the shard forms over one shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers

Params = Any


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, (self.d_model + 15) // 16)


def init_mamba(gen: torch.Generator, cfg: MambaConfig, dtype=torch.bfloat16,
               device=None, n_layers: int = 1) -> Params:
    di, ds, dr, L = cfg.d_inner, cfg.d_state, cfg.dt_rank_, n_layers
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    # S4D-real initialization for A
    a = torch.arange(1, ds + 1, **f32)[None, None, :].expand(L, di, ds)
    conv_w = torch.randn((L, cfg.d_conv, di), generator=gen, **f32)
    return {
        "w_in": layers.dense_init(gen, (L, cfg.d_model, 2 * di), **kw),
        "conv_w": (conv_w / np.sqrt(cfg.d_conv)).to(dtype),
        "conv_b": torch.zeros((L, di), **kw),
        "w_bcdt": layers.dense_init(gen, (L, di, 2 * ds + dr), **kw),
        "w_dt": layers.dense_init(gen, (L, dr, di), in_axis_size=dr, **kw),
        "dt_bias": torch.log(torch.expm1(torch.full((L, di), 0.01, **f32))),
        "a_log": torch.log(a).contiguous(),
        "d_skip": torch.ones((L, di), **f32),
        "w_out": layers.dense_init(gen, (L, di, cfg.d_model), in_axis_size=di,
                                   **kw),
    }


def _selective_params(params: Params, cfg: MambaConfig, xi: torch.Tensor,
                      bcdt: Optional[torch.Tensor] = None):
    """xi: [b, s, d_inner] (post-conv); ``bcdt`` its [b, s, 2 ds + dr]
    projection by ``w_bcdt``, made here when None (a tensor-parallel shard
    passes the one reduced over every shard's channels). Returns dA
    [b, s, di, ds], dBx and C [b, s, ds], all f32."""
    ds = cfg.d_state
    if bcdt is None:
        bcdt = torch.einsum("bsd,de->bse", xi, params["w_bcdt"])
    b_sel, c_sel, dt = bcdt[..., :ds], bcdt[..., ds:2 * ds], bcdt[..., 2 * ds:]
    dt = torch.einsum("bsr,rd->bsd", dt, params["w_dt"]).float()
    dt = F.softplus(dt + params["dt_bias"])                   # [b, s, di]
    a = -torch.exp(params["a_log"])                           # [di, ds]
    dA = torch.exp(dt[..., None] * a[None, None])
    dBx = (dt * xi.float())[..., None] * b_sel.float()[:, :, None, :]
    return dA, dBx, c_sel.float()


def _inclusive_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over axis 1 of the pairs (a_t, b_t) under the
    reference's ``combine((a1, b1), (a2, b2)) = (a2 * a1, a2 * b1 + b2)``,
    by doubling: after the pass at offset o, element t holds the
    combination of elements (t - 2o, t]."""
    n = a.shape[1]
    o = 1
    while o < n:
        a_new, b_new = a.clone(), b.clone()
        a_new[:, o:] = a[:, o:] * a[:, :-o]
        b_new[:, o:] = a[:, o:] * b[:, :-o] + b[:, o:]
        a, b = a_new, b_new
        o *= 2
    return a, b


def _chunk_scan(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor):
    """The scan within a chunk given the entry state h0 [b, di, ds]:
    (states [b, c, di, ds], last state)."""
    aA, bB = _inclusive_scan(dA, dBx)
    h = aA * h0[:, None] + bB
    return h, h[:, -1]


def _causal_conv(params: Params, cfg: MambaConfig, x: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time. x: [b, s, di]; conv_state:
    [b, d_conv - 1, di]. Returns (silu(conv(x)), new conv state)."""
    pad = (torch.zeros((x.shape[0], cfg.d_conv - 1, x.shape[-1]),
                       dtype=x.dtype, device=x.device)
           if conv_state is None else conv_state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    w = params["conv_w"]                                      # [d_conv, di]
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i][None, None] for i in range(cfg.d_conv))
    new_state = xp[:, -(cfg.d_conv - 1):] if cfg.d_conv > 1 else pad
    return (F.silu((out + params["conv_b"]).float()).to(x.dtype), new_state)


def _gate_out(params: Params, y: torch.Tensor, xi: torch.Tensor,
              z: torch.Tensor, dtype) -> torch.Tensor:
    y = y + params["d_skip"][None, None] * xi.float()
    y = (y * F.silu(z.float())).to(dtype)
    return torch.einsum("bsd,de->bse", y, params["w_out"])


def _pad_chunks(cfg: MambaConfig, xi: torch.Tensor) -> torch.Tensor:
    """xi [b, s, di] zero-padded along s to whole chunks."""
    s = xi.shape[1]
    chunk = min(cfg.chunk, s)
    pad_to = (s + chunk - 1) // chunk * chunk
    return F.pad(xi, (0, 0, 0, pad_to - s)) if pad_to != s else xi


def _scan_seq(cfg: MambaConfig, sel, s: int, h0: Optional[torch.Tensor]):
    """The chunked scan over the selective params ``sel`` (dA, dBx, C of
    the chunk-padded sequence) from the entry state ``h0`` (zeros when
    None): (y [b, s, di] f32, last state)."""
    dA, dBx, c_sel = sel
    b, pad_to, di, ds = dA.shape
    chunk = min(cfg.chunk, s)
    if pad_to != s:
        # padded positions are identity steps (dA = 1, dBx = 0), else they
        # would decay the carried state handed to decode
        valid = (torch.arange(pad_to, device=dA.device) < s)[None, :, None,
                                                             None]
        dA = torch.where(valid, dA, torch.ones((), device=dA.device))
        dBx = torch.where(valid, dBx, torch.zeros((), device=dA.device))
    h = (torch.zeros((b, di, ds), dtype=torch.float32, device=dA.device)
         if h0 is None else h0)
    hs = []
    for c in range(pad_to // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        hc, h = _chunk_scan(dA[:, sl], dBx[:, sl], h)
        hs.append(hc)
    hs = torch.cat(hs, dim=1)[:, :s]
    return torch.einsum("bsdn,bsn->bsd", hs, c_sel[:, :s]), h


def _mamba_seq(params: Params, cfg: MambaConfig, x: torch.Tensor,
               conv_state: Optional[torch.Tensor],
               h0: Optional[torch.Tensor]):
    """The full-sequence path: (y, new conv state, last ssm state)."""
    di = cfg.d_inner
    xz = torch.einsum("bsd,de->bse", x, params["w_in"])
    xi, z = xz[..., :di], xz[..., di:]
    xi, new_conv = _causal_conv(params, cfg, xi, conv_state)
    xi_p = _pad_chunks(cfg, xi)
    y, h = _scan_seq(cfg, _selective_params(params, cfg, xi_p), x.shape[1],
                     h0)
    return _gate_out(params, y, xi, z, x.dtype), new_conv, h


def mamba_forward(params: Params, cfg: MambaConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """Full-sequence pass without state. x: [b, s, d]."""
    y, _, _ = _mamba_seq(params, cfg, x, None, None)
    return y


def mamba_prefill(params: Params, cfg: MambaConfig, x: torch.Tensor):
    """Full-sequence pass that also returns the decode state."""
    y, conv, h_last = _mamba_seq(params, cfg, x, None, None)
    return y, {"conv": conv, "ssm": h_last}


def init_mamba_state(batch: int, cfg: MambaConfig, dtype=torch.bfloat16,
                     device=None, n_layers: int = 1) -> Params:
    return {
        "conv": torch.zeros((n_layers, batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((n_layers, batch, cfg.d_inner, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_step(params: Params, cfg: MambaConfig, x: torch.Tensor,
               state: Params):
    """Single-token decode. x: [b, 1, d] -> (y, new state)."""
    di = cfg.d_inner
    xz = torch.einsum("bsd,de->bse", x, params["w_in"])
    xi, z = xz[..., :di], xz[..., di:]
    xi, conv_state = _causal_conv(params, cfg, xi, state["conv"])
    dA, dBx, c_sel = _selective_params(params, cfg, xi)
    h = dA[:, 0] * state["ssm"] + dBx[:, 0]
    y = torch.einsum("bdn,bn->bd", h, c_sel[:, 0])[:, None]
    out = _gate_out(params, y, xi, z, x.dtype)
    return out, {"conv": conv_state.to(state["conv"].dtype), "ssm": h}


def mamba_shards(shards, cfg: MambaConfig, xs, states, mode: str, reduce):
    """Mamba over the local model shards in lockstep: a training pass or a
    prefill from a zero state, or one decode step. ``shards`` holds each
    shard's layer params: channels ``[s*di/tp, (s+1)*di/tp)`` of every
    channel-indexed leaf, ``w_in`` as ``[d, 2, di/tp]``: the shard's block
    of x's columns and the matching block of z's; ``xs`` each shard's input
    (one replicated tensor); ``states`` each shard's state views (None in
    training). ``xi @ w_bcdt`` contracts over ``d_inner``: each shard's f32
    partial goes to ``reduce`` (the shards' list -> their sum, once a
    shard) and the sum is cast once to the compute dtype, as one device
    rounds its single product, before B, C and dt are split off. Returns
    each shard's output partial (its rows of ``w_out``; the caller reduces
    them) and new state (None in training)."""
    seq = mode in ("prefill", "train")
    states = states if states is not None else [None] * len(shards)
    x = xs[0]
    ins = []
    for p, st, xp in zip(shards, states, xs):
        xi = torch.einsum("bsd,de->bse", xp, p["w_in"][:, 0])
        z = torch.einsum("bsd,de->bse", xp, p["w_in"][:, 1])
        xi, conv = _causal_conv(p, cfg, xi, None if seq else st["conv"])
        ins.append((xi, z, conv, _pad_chunks(cfg, xi) if seq else xi))
    bcdts = reduce([torch.einsum("bsd,de->bse", xsel.float(),
                                 p["w_bcdt"].float())
                    for p, (_, _, _, xsel) in zip(shards, ins)])
    outs, new = [], []
    for p, st, bcdt, (xi, z, conv, xsel) in zip(shards, states, bcdts, ins):
        sel = _selective_params(p, cfg, xsel, bcdt.to(x.dtype))
        if seq:
            y, h = _scan_seq(cfg, sel, x.shape[1], None)
        else:
            dA, dBx, c_sel = sel
            h = dA[:, 0] * st["ssm"] + dBx[:, 0]
            y = torch.einsum("bdn,bn->bd", h, c_sel[:, 0])[:, None]
        outs.append(_gate_out(p, y, xi, z, x.dtype))
        new.append(None if mode == "train" else {"conv": conv, "ssm": h})
    return outs, new


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay linear attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    head_dim: int = 64
    lora_rank: int = 64
    d_ff: int = 0  # channel-mix hidden

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim


def _one(parts):
    """The collectives of a single shard: its own part."""
    return parts[0]


def _lora_init(gen, d: int, rank: int, out: int, dtype, device, L: int):
    b = torch.randn((L, rank, out), generator=gen, dtype=torch.float32,
                    device=device) * 0.01
    return {"a": layers.dense_init(gen, (L, d, rank), dtype=dtype,
                                   device=device),
            "b": b.to(dtype)}


def _lora(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...r,re->...e",
                        torch.tanh(torch.einsum("...d,dr->...r", x, p["a"])),
                        p["b"])


def _uniform(gen, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=device)


def init_rwkv6_time_mix(gen: torch.Generator, cfg: RWKV6Config,
                        dtype=torch.bfloat16, device=None,
                        n_layers: int = 1) -> Params:
    d, L = cfg.d_model, n_layers
    kw = dict(dtype=dtype, device=device)
    return {
        "mix": _uniform(gen, (L, 5, d), device).to(dtype),  # r,k,v,w,g mixes
        "w_r": layers.dense_init(gen, (L, d, d), **kw),
        "w_k": layers.dense_init(gen, (L, d, d), **kw),
        "w_v": layers.dense_init(gen, (L, d, d), **kw),
        "w_g": layers.dense_init(gen, (L, d, d), **kw),
        "w_o": layers.dense_init(gen, (L, d, d), **kw),
        "decay_lora": _lora_init(gen, d, cfg.lora_rank, d, dtype, device, L),
        "decay_base": torch.full((L, d), -6.0, dtype=torch.float32,
                                 device=device),
        "bonus": torch.randn((L, cfg.num_heads, cfg.head_dim), generator=gen,
                             dtype=torch.float32, device=device) * 0.05,
        "ln_out": layers.init_layernorm(d, layers=L, **kw),
    }


def _shift_mix(x: torch.Tensor, x_prev: torch.Tensor, mix: torch.Tensor,
               i: int) -> torch.Tensor:
    """Token-shift mix ``i`` in f32, cast back to x's dtype."""
    xf, xp = x.float(), x_prev.float()
    return (xf + (xp - xf) * mix[i].float()[None, None]).to(x.dtype)


def _rwkv_inputs(params: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shift mixes. x, x_prev: [b, s, d] (x_prev is x shifted right
    by one)."""
    mix = params["mix"]
    r = torch.einsum("bsd,de->bse", _shift_mix(x, x_prev, mix, 0),
                     params["w_r"])
    k = torch.einsum("bsd,de->bse", _shift_mix(x, x_prev, mix, 1),
                     params["w_k"])
    v = torch.einsum("bsd,de->bse", _shift_mix(x, x_prev, mix, 2),
                     params["w_v"])
    w = params["decay_base"] + _lora(params["decay_lora"],
                                     _shift_mix(x, x_prev, mix, 3)).float()
    g = F.silu(torch.einsum("bsd,de->bse", _shift_mix(x, x_prev, mix, 4),
                            params["w_g"]).float())
    decay = torch.exp(-torch.exp(w))  # data-dependent per-channel decay
    return r, k, v, decay, g


def _time_heads(params: Params, x: torch.Tensor, x_prev_last: torch.Tensor,
                wkv_state: torch.Tensor, bonus: torch.Tensor):
    """The token-shift inputs and the loop over time for the heads of
    ``bonus`` [h, hd]: (out [b, s, h * hd] f32, g, new state)."""
    b, s, _ = x.shape
    h, hd = bonus.shape
    x_prev = torch.cat([x_prev_last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    r, k, v, decay, g = _rwkv_inputs(params, x, x_prev)
    rh = r.reshape(b, s, h, hd).float()
    kh = k.reshape(b, s, h, hd).float()
    vh = v.reshape(b, s, h, hd).float()
    dh = decay.reshape(b, s, h, hd)
    u = bonus[None, :, :, None]                               # [1, h, hd, 1]
    state = wkv_state
    outs = []
    for t in range(s):
        kv = torch.einsum("bhk,bhv->bhkv", kh[:, t], vh[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", rh[:, t], state + u * kv))
        state = dh[:, t][..., None] * state + kv
    return torch.stack(outs, dim=1).reshape(b, s, h * hd), g, state


def rwkv6_time_mix_shards(shards, cfg: RWKV6Config, ids, xs,
                          x_prev_last: torch.Tensor, states, all_gather,
                          copy=None):
    """The time mix over the local model shards in lockstep: shard ``s``
    of ``ids`` holds heads ``[s*n, (s+1)*n)`` (``n`` from its ``w_r``'s
    width) of ``w_r``/``w_k``/``w_v``/``w_g``, ``decay_lora.b`` and
    ``decay_base``, and its rows of ``w_o``; ``bonus`` and ``ln_out`` are
    whole, and each shard takes its heads of ``bonus``. ``xs`` is each
    shard's input (one replicated tensor). ``ln_out`` normalises over all
    of ``d``, so the shards' head outputs are gathered along it
    (``all_gather``: the shards' list -> their concatenation) and the
    one-device layernorm runs on the whole row; ``copy`` hands the normed
    row to each shard (the row itself when None), which gates its block
    and applies its ``w_o`` rows. Returns (each shard's output partial,
    for the caller to reduce; the new x_last; each shard's new state)."""
    n = shards[0]["w_r"].shape[-1] // cfg.head_dim
    heads = [_time_heads(p, x, x_prev_last, st,
                         p["bonus"].narrow(0, s * n, n))
             for p, s, st, x in zip(shards, ids, states, xs)]
    x = xs[0]
    normed = layers.layernorm(shards[0]["ln_out"],
                              all_gather([o.to(x.dtype) for o, _, _ in heads]))
    normed = copy(normed) if copy else [normed] * len(shards)
    w = n * cfg.head_dim
    outs = [torch.einsum("bsd,de->bse",
                         (nd[..., s * w:(s + 1) * w].float() * g
                          ).to(x.dtype), p["w_o"])
            for p, s, nd, (_, g, _) in zip(shards, ids, normed, heads)]
    return outs, x[:, -1], [st for _, _, st in heads]


def rwkv6_time_mix(params: Params, cfg: RWKV6Config, x: torch.Tensor,
                   x_prev_last: torch.Tensor, wkv_state: torch.Tensor):
    """Full-sequence pass, a loop over time. x: [b, s, d]; x_prev_last
    [b, d] the previous segment's last token; wkv_state [b, h, k, v].
    Returns (out [b, s, d], new x_last [b, d], new state)."""
    outs, x_last, states = rwkv6_time_mix_shards(
        [params], cfg, [0], [x], x_prev_last, [wkv_state], _one)
    return outs[0], x_last, states[0]


def init_rwkv6_channel_mix(gen: torch.Generator, cfg: RWKV6Config,
                           dtype=torch.bfloat16, device=None,
                           n_layers: int = 1) -> Params:
    d, f, L = cfg.d_model, cfg.d_ff, n_layers
    kw = dict(dtype=dtype, device=device)
    return {
        "mix": _uniform(gen, (L, 2, d), device).to(dtype),
        "w_k": layers.dense_init(gen, (L, d, f), **kw),
        "w_v": layers.dense_init(gen, (L, f, d), in_axis_size=f, **kw),
        "w_r": layers.dense_init(gen, (L, d, d), **kw),
    }


def rwkv6_channel_mix_shards(shards, x: torch.Tensor,
                             x_prev_last: torch.Tensor, all_reduce,
                             all_gather, copy=None):
    """The channel mix over the local model shards in lockstep: each shard
    holds a ``d_ff`` block of ``w_k``'s columns and ``w_v``'s rows (its
    ``vv`` is a partial, reduced by ``all_reduce``) and a ``d`` block of
    ``w_r``'s columns (its receptance block, gathered in f32 by
    ``all_gather`` before ``rr * vv``). The token-shift mixes run once on
    the replicated ``x``; ``copy`` hands each to every shard (the mix
    itself when None). Returns (out [b, s, d], whole on every shard; the
    new x_last)."""
    x_prev = torch.cat([x_prev_last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    mix = shards[0]["mix"]
    copy = copy or (lambda t: [t] * len(shards))
    xks = copy(_shift_mix(x, x_prev, mix, 0))
    xrs = copy(_shift_mix(x, x_prev, mix, 1))
    parts, rrs = [], []
    for p, xk, xr in zip(shards, xks, xrs):
        kk = torch.einsum("bsd,df->bsf", xk, p["w_k"])
        kk = torch.square(F.relu(kk.float())).to(x.dtype)
        parts.append(torch.einsum("bsf,fd->bsd", kk, p["w_v"]))
        rrs.append(torch.sigmoid(torch.einsum("bsd,de->bse", xr,
                                              p["w_r"]).float()))
    vv = all_reduce(parts)
    rr = all_gather(rrs)
    return (rr * vv.float()).to(x.dtype), x[:, -1]


def rwkv6_channel_mix(params: Params, cfg: RWKV6Config, x: torch.Tensor,
                      x_prev_last: torch.Tensor):
    """The channel mix: (out [b, s, d], new x_last [b, d])."""
    return rwkv6_channel_mix_shards([params], x, x_prev_last, _one, _one)
