"""Decoder-only LM trunk for the dense, moe, hybrid, ssm and vlm families
(port of ``repro.models.transformer``).

A model is a sequence of blocks (:func:`_blocks`): each block repeats one
group of layer slots ``n`` times, and its params and caches are stacked on
a leading axis of length ``n``, as in the reference's tree:

  * dense / vlm: ``layers`` of ``num_layers`` x [attn + swiglu];
  * moe: ``dense_layers`` (deepseek-v3's ``first_k_dense``) and
    ``moe_layers``, the mixer MLA when the config has one;
  * hybrid (jamba): ``groups`` of ``num_layers // attn_period`` x
    ``slot_0..slot_{attn_period-1}``, Mamba everywhere but the last slot
    (attention, no RoPE), MoE on every ``moe_period``-th slot;
  * ssm (rwkv6): ``layers`` of ``num_layers`` x [time mix + channel mix],
    with layernorms and an ``ln0`` after the embedding.

E.g. ``params["layers"]["slot_0"]["attn"]["wq"]`` is ``[L, d, h, hd]`` and
``cache["groups"]["slot_7"]["k"]`` ``[n, b, max_len, hk, hd]``; the cache
also holds ``pos`` ``[b]``. A Python loop over the stacked layers takes the
place of ``lax.scan``; prefill and decode write the cache in place and
return it (the reference returned a rebuilt cache). ``forward`` is the
cache-free full-sequence pass and ``loss`` the training objective over it.
``parallel.attention_chunk`` q-chunks full-sequence attention,
``parallel.loss_chunk`` the cross-entropy over the sequence, and
``parallel.remat`` recomputes each layer in the backward pass (``"full"``)
or all of it but its matmul outputs (``"dots_saveable"``), as
``jax.checkpoint`` around the reference's scan body does.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, mla, moe, ssm

Params = Any

BLOCK = "layers"
SLOT = "slot_0"


# ---------------------------------------------------------------------------
# layer-slot helpers
# ---------------------------------------------------------------------------

def _attn_cfg(cfg: ModelConfig) -> layers.AttentionConfig:
    return layers.AttentionConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        use_rope=cfg.family != "hybrid", chunk=cfg.parallel.attention_chunk)


def _mla_cfg(cfg: ModelConfig) -> mla.MLAConfig:
    m = cfg.mla
    return mla.MLAConfig(d_model=cfg.d_model, num_heads=cfg.num_heads,
                         q_lora_rank=m.q_lora_rank, kv_lora_rank=m.kv_lora_rank,
                         rope_dim=m.rope_dim, nope_dim=m.nope_dim,
                         v_head_dim=m.v_head_dim, rope_theta=cfg.rope_theta,
                         chunk=cfg.parallel.attention_chunk)


def _mamba_cfg(cfg: ModelConfig) -> ssm.MambaConfig:
    s = cfg.ssm
    return ssm.MambaConfig(d_model=cfg.d_model, d_state=s.d_state,
                           d_conv=s.d_conv, expand=s.expand, chunk=s.chunk)


def _rwkv_cfg(cfg: ModelConfig) -> ssm.RWKV6Config:
    s = cfg.ssm
    return ssm.RWKV6Config(d_model=cfg.d_model, head_dim=s.head_dim,
                           lora_rank=s.lora_rank, d_ff=cfg.d_ff)


def _moe_cfg(cfg: ModelConfig) -> moe.MoEConfig:
    m = cfg.moe
    return moe.MoEConfig(num_experts=m.num_experts, top_k=m.top_k,
                         d_ff_expert=m.d_ff_expert,
                         num_shared_experts=m.num_shared_experts,
                         capacity_factor=m.capacity_factor, gating=m.gating)


def _blocks(cfg: ModelConfig):
    """[(block_name, n_repeats, [(mixer, ffn) per slot])]."""
    if cfg.family in ("dense", "vlm"):
        return [(BLOCK, cfg.num_layers, [("attn", "swiglu")])]
    if cfg.family == "ssm":  # rwkv6
        return [(BLOCK, cfg.num_layers, [("rwkv", "cmix")])]
    if cfg.family == "moe":
        mixer = "mla" if cfg.mla else "attn"
        fk = cfg.moe.first_k_dense
        blocks = []
        if fk:
            blocks.append(("dense_layers", fk, [(mixer, "swiglu")]))
        blocks.append(("moe_layers", cfg.num_layers - fk, [(mixer, "moe")]))
        return blocks
    if cfg.family == "hybrid":  # jamba: attention last, MoE on odd slots
        slots = []
        for i in range(cfg.attn_period):
            mixer = "attn" if i == cfg.attn_period - 1 else "mamba"
            ffn = ("moe" if cfg.moe_period
                   and i % cfg.moe_period == cfg.moe_period - 1 else "swiglu")
            slots.append((mixer, ffn))
        return [("groups", cfg.num_layers // cfg.attn_period, slots)]
    raise ValueError(cfg.family)


# the ops whose outputs "dots_saveable" keeps for the backward pass (the
# matmuls an einsum lowers to), as jax.checkpoint_policies.checkpoint_dots
# keeps every dot_general's
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def remat(fn, policy: str):
    """``fn`` recomputed in the backward pass under ``parallel.remat``:
    "none" leaves it as it is, "full" saves only its inputs, and
    "dots_saveable" also its matmul outputs."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(torch_checkpoint.checkpoint, fn,
                                 use_reentrant=False)
    if policy == "dots_saveable":
        return functools.partial(
            torch_checkpoint.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                torch_checkpoint.create_selective_checkpoint_contexts,
                _save_dots))
    raise ValueError(f"unknown remat policy {policy!r}")


def generator(seed: int, device) -> Optional[torch.Generator]:
    """The init's generator, or None on the meta device (no bits to
    draw)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def masked_nll(logits: torch.Tensor, labels: torch.Tensor):
    """(summed NLL of ``labels`` under the f32 ``logits``, their count);
    labels < 0 are masked out."""
    mask = (labels >= 0).float()
    safe = labels.long().clamp(min=0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def _layer(tree: Params, j: int) -> Params:
    """Layer ``j``'s slice of a layer-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, j) for k, v in tree.items()}
    return tree[j]


def _layers(tree: Params, n: int) -> List[Params]:
    """The ``n`` layer slices of a layer-stacked tree, each leaf unbound
    once along its layer axis (views). A loop that trains through them
    hands the stacked leaf one stack of the layers' gradients; a loop over
    ``_layer`` would hand it a zero-filled stacked-size gradient a layer,
    summed: traffic and time quadratic in the depth."""
    if isinstance(tree, dict):
        subs = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: subs[k][j] for k in tree} for j in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# one (mixer, ffn) slot: params, cache, forward
# ---------------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, mixer: str, ffn: str, gen, n: int,
                dtype, device) -> Params:
    """Params for ``n`` stacked layers of one slot."""
    kw = dict(dtype=dtype, device=device)
    norm = layers.init_layernorm if mixer == "rwkv" else layers.init_rmsnorm
    p: Dict[str, Params] = {"pre_norm": norm(cfg.d_model, layers=n, **kw),
                            "post_norm": norm(cfg.d_model, layers=n, **kw)}
    if mixer == "attn":
        p["attn"] = layers.init_attention(gen, _attn_cfg(cfg), layers=n, **kw)
    elif mixer == "mla":
        p["mla"] = mla.init_mla(gen, _mla_cfg(cfg), n_layers=n, **kw)
    elif mixer == "mamba":
        p["mamba"] = ssm.init_mamba(gen, _mamba_cfg(cfg), n_layers=n, **kw)
    elif mixer == "rwkv":
        p["tmix"] = ssm.init_rwkv6_time_mix(gen, _rwkv_cfg(cfg), n_layers=n,
                                            **kw)
    else:
        raise ValueError(mixer)
    if ffn == "swiglu":
        p["ffn"] = layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, layers=n,
                                      **kw)
    elif ffn == "moe":
        p["moe"] = moe.init_moe(gen, cfg.d_model, _moe_cfg(cfg), n_layers=n,
                                **kw)
    elif ffn == "cmix":
        p["cmix"] = ssm.init_rwkv6_channel_mix(gen, _rwkv_cfg(cfg),
                                               n_layers=n, **kw)
    else:
        raise ValueError(ffn)
    return p


def _init_cache_slot(cfg: ModelConfig, mixer: str, ffn: str, batch: int,
                     max_len: int, n: int, dtype, device) -> Params:
    c: Dict[str, torch.Tensor] = {}
    if mixer == "attn":
        c.update(layers.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                      cfg.head_dim_, dtype, device, layers=n))
    elif mixer == "mla":
        c.update(mla.init_mla_cache(batch, max_len, _mla_cfg(cfg), dtype,
                                    device, n_layers=n))
    elif mixer == "mamba":
        c.update(ssm.init_mamba_state(batch, _mamba_cfg(cfg), dtype, device,
                                      n_layers=n))
    elif mixer == "rwkv":
        rcfg = _rwkv_cfg(cfg)
        c["tmix_x"] = torch.zeros((n, batch, cfg.d_model), dtype=dtype,
                                  device=device)
        c["wkv"] = torch.zeros((n, batch, rcfg.num_heads, rcfg.head_dim,
                                rcfg.head_dim), dtype=torch.float32,
                               device=device)
    if ffn == "cmix":
        c["cmix_x"] = torch.zeros((n, batch, cfg.d_model), dtype=dtype,
                                  device=device)
    return c


def _store(cache_sl: Params, new: Dict[str, torch.Tensor]) -> None:
    """Write a mixer's new recurrent state into its cache views."""
    for k, v in new.items():
        cache_sl[k].copy_(v)


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.blocks = _blocks(cfg)
        self.acfg = _attn_cfg(cfg)

    # -- params ------------------------------------------------------------
    def init_params(self, seed: int, device) -> Params:
        """Random weights from ``seed`` on ``device`` (a torch generator:
        the bits differ from the reference's jax.random init; tests convert
        the reference's tree instead, see ``models/convert.py``)."""
        cfg = self.cfg
        dtype = cfg.torch_dtype
        gen = generator(seed, device)
        kw = dict(dtype=dtype, device=device)
        norm = (layers.init_layernorm if cfg.family == "ssm"
                else layers.init_rmsnorm)
        p: Dict[str, Params] = {
            "embedding": layers.init_embedding(gen, cfg.vocab_size,
                                               cfg.d_model, **kw),
            "final_norm": norm(cfg.d_model, **kw),
        }
        if cfg.family == "ssm":
            p["ln0"] = layers.init_layernorm(cfg.d_model, **kw)
        for name, n, slots in self.blocks:
            p[name] = {f"slot_{i}": _init_layer(cfg, m, f, gen, n, dtype,
                                                device)
                       for i, (m, f) in enumerate(slots)}
        return p

    # -- cache -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device) -> Params:
        cfg = self.cfg
        cache: Dict[str, Params] = {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
        for name, n, slots in self.blocks:
            cache[name] = {
                f"slot_{i}": _init_cache_slot(cfg, m, f, batch, max_len, n,
                                              cfg.torch_dtype, device)
                for i, (m, f) in enumerate(slots)}
        return cache

    # -- forward -----------------------------------------------------------
    def _layer_fwd(self, mixer: str, ffn: str, lp: Params, x: torch.Tensor,
                   positions: torch.Tensor, mode: str,
                   cache_sl: Optional[Params]):
        """One layer; mode is 'train' (no cache), 'prefill' or 'decode'.
        Returns (x, aux): aux is the MoE router's load-balance loss, None
        for any other FFN (no tensor, so a dense step launches nothing
        for it)."""
        norm = layers.layernorm if mixer == "rwkv" else layers.rmsnorm
        h = norm(lp["pre_norm"], x, self.cfg.norm_eps)
        x = x + self.mixer(mixer, lp, h, positions, mode, cache_sl)
        h = norm(lp["post_norm"], x, self.cfg.norm_eps)
        out, aux = self.ffn(ffn, lp, h, mode, cache_sl)
        return x + out, aux

    def mixer(self, mixer: str, lp: Params, h: torch.Tensor,
              positions: torch.Tensor, mode: str, cache_sl: Optional[Params],
              acfg: Optional[layers.AttentionConfig] = None) -> torch.Tensor:
        """A layer's mixer half on the normed input ``h``: what its
        residual adds (the attention's output projection for "attn"). Given
        a tensor-parallel shard's weights, cache and head counts
        (``acfg``), attention returns that shard's partial product."""
        cfg = self.cfg
        if mixer == "attn":
            acfg = acfg or self.acfg
            if mode == "train":
                return layers.attention_forward(lp["attn"], acfg, h, positions)
            attend = (layers.attention_prefill if mode == "prefill"
                      else layers.attention_decode)
            return attend(lp["attn"], acfg, h, cache_sl, positions)
        if mixer == "mla":
            mcfg = _mla_cfg(cfg)
            if mode == "train":
                return mla.mla_forward(lp["mla"], mcfg, h)
            attend = mla.mla_prefill if mode == "prefill" else mla.mla_decode
            return attend(lp["mla"], mcfg, h, cache_sl, positions)
        if mixer == "mamba":
            scfg = _mamba_cfg(cfg)
            if mode == "train":
                return ssm.mamba_forward(lp["mamba"], scfg, h)
            if mode == "prefill":
                mix, st = ssm.mamba_prefill(lp["mamba"], scfg, h)
            else:
                mix, st = ssm.mamba_step(lp["mamba"], scfg, h, cache_sl)
            _store(cache_sl, st)
            return mix
        if mixer == "rwkv":
            rcfg = _rwkv_cfg(cfg)
            if mode == "train":
                b = h.shape[0]
                x_last = torch.zeros((b, cfg.d_model), dtype=h.dtype,
                                     device=h.device)
                state = torch.zeros((b, rcfg.num_heads, rcfg.head_dim,
                                     rcfg.head_dim), dtype=torch.float32,
                                    device=h.device)
                mix, _, _ = ssm.rwkv6_time_mix(lp["tmix"], rcfg, h, x_last,
                                               state)
                return mix
            # prefill and decode continue the cached segment
            mix, x_last, state = ssm.rwkv6_time_mix(
                lp["tmix"], rcfg, h, cache_sl["tmix_x"], cache_sl["wkv"])
            _store(cache_sl, {"tmix_x": x_last, "wkv": state})
            return mix
        raise ValueError(mixer)

    def ffn(self, ffn: str, lp: Params, h: torch.Tensor, mode: str,
            cache_sl: Optional[Params]):
        """A layer's FFN half on the normed input ``h``: (what its residual
        adds, aux). Given a tensor-parallel shard's ``d_ff`` block of the
        SwiGLU weights it returns that shard's partial product."""
        cfg = self.cfg
        if ffn == "swiglu":
            return layers.swiglu(lp["ffn"], h), None
        if ffn == "moe":
            return moe.moe_forward(lp["moe"], _moe_cfg(cfg), h)
        if ffn == "cmix":
            rcfg = _rwkv_cfg(cfg)
            if mode == "train":
                x_last = torch.zeros((h.shape[0], cfg.d_model),
                                     dtype=h.dtype, device=h.device)
                out, _ = ssm.rwkv6_channel_mix(lp["cmix"], rcfg, h, x_last)
                return out, None
            out, x_last = ssm.rwkv6_channel_mix(lp["cmix"], rcfg, h,
                                                cache_sl["cmix_x"])
            _store(cache_sl, {"cmix_x": x_last})
            return out, None
        raise ValueError(ffn)

    def _run(self, params: Params, x: torch.Tensor, positions: torch.Tensor,
             cache: Optional[Params], mode: str):
        """Every block's layers in order: (x, summed aux, or None when no
        layer has one). A training pass that records gradients recomputes
        each repeat of a block (all its slots) under ``parallel.remat``,
        the unit the reference's scan body checkpoints."""
        training = mode == "train" and torch.is_grad_enabled()
        policy = self.cfg.parallel.remat if training else "none"
        aux = None
        for name, n, slots in self.blocks:
            bp = _layers(params[name], n) if training else None
            bc = cache[name] if cache is not None else None
            for j in range(n):
                lp = bp[j] if bp is not None else _layer(params[name], j)
                cl = _layer(bc, j) if bc is not None else None

                def body(x, aux, lp=lp, cl=cl, slots=slots):
                    for i, (m, f) in enumerate(slots):
                        slot = f"slot_{i}"
                        x, a = self._layer_fwd(m, f, lp[slot], x, positions,
                                               mode, cl[slot] if cl is not None
                                               else None)
                        if a is not None:
                            aux = a if aux is None else aux + a
                    return x, aux

                x, aux = remat(body, policy)(x, aux)
        return x, aux

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = (tokens if cfg.embedding_inputs
             else layers.embed(params["embedding"], tokens))
        if cfg.family == "ssm":
            x = layers.layernorm(params["ln0"], x, cfg.norm_eps)
        return x

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        norm = layers.layernorm if cfg.family == "ssm" else layers.rmsnorm
        x = norm(params["final_norm"], x, cfg.norm_eps)
        return layers.unembed(params["embedding"], x)

    def _trunk(self, params: Params, tokens: torch.Tensor):
        """Embed + every layer, no cache: (hidden [b, s, d], aux: an f32
        zero for a model without MoE)."""
        b, s = tokens.shape[:2]
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        x = self._embed(params, tokens)
        x, aux = self._run(params, x, positions, None, "train")
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    def forward(self, params: Params, tokens: torch.Tensor):
        """Teacher-forced full-sequence pass -> (logits [b, s, vocab] f32,
        aux)."""
        x, aux = self._trunk(params, tokens)
        return self._unembed(params, x), aux

    def _ce_chunk(self, params: Params, x: torch.Tensor,
                  labels: torch.Tensor):
        """Summed masked NLL and token count over a hidden-state chunk
        (labels < 0 are masked out)."""
        return masked_nll(self._unembed(params, x), labels)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """Next-token cross-entropy over ``batch["tokens"]`` and
        ``batch["labels"]`` plus the MoE aux loss: (loss, {"ce_loss",
        "aux_loss"}). With ``parallel.loss_chunk`` the [b, s, vocab]
        logits are made a chunk of the sequence at a time."""
        x, aux = self._trunk(params, batch["tokens"])
        labels = batch["labels"]
        chunk = self.cfg.parallel.loss_chunk
        s = x.shape[1]
        if chunk and s > chunk:
            tot = torch.zeros((), dtype=torch.float32, device=x.device)
            cnt = torch.zeros((), dtype=torch.float32, device=x.device)
            for start in range(0, s, chunk):
                end = min(start + chunk, s)
                t, c = self._ce_chunk(params, x[:, start:end],
                                      labels[:, start:end])
                tot, cnt = tot + t, cnt + c
        else:
            tot, cnt = self._ce_chunk(params, x, labels)
        loss = tot / cnt.clamp(min=1.0)
        return loss + aux, {"ce_loss": loss, "aux_loss": aux}

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params):
        """tokens [b, s] (or [b, s, d] embeddings) -> (last-position logits
        [b, vocab] f32, cache); fills the cache in place and sets ``pos``
        to s. Positions are 0..s-1 for every row: left-padded prompts
        attend to their pads, as in the reference."""
        b, s = tokens.shape[:2]
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        x = self._embed(params, tokens)
        x, _ = self._run(params, x, positions, cache, "prefill")
        cache["pos"].fill_(s)
        logits = self._unembed(params, x[:, -1:, :])
        return logits[:, 0], cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params):
        """tokens [b, 1] -> (logits [b, vocab] f32, cache); appends one
        position per row in place and advances ``pos``."""
        positions = cache["pos"][:, None].clone()
        x = self._embed(params, tokens)
        x, _ = self._run(params, x, positions, cache, "decode")
        cache["pos"] += 1
        logits = self._unembed(params, x)
        return logits[:, 0], cache
