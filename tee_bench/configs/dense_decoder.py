"""The plain reference of a dense decoder LM (Llama-style: pre-norm
RMSNorm, rotary embeddings on the two halves of each head, grouped-query
attention, SwiGLU, tied embeddings), in float32 with TF32 off.

It serves the configurations whose file names it as ``"reference"``
(deepseek-7b), and declares their family and leaf table (``spec``).
Weights come from the benchmark's own generator (``teebench.weights``),
made again one layer at a time, never from the program. It runs whole
sequences with causal attention from position 0, so a prompt left-padded
with token 0 into its prefill bucket is attended with its pads, as the
served path attends it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from teebench import weights

WeightFn = Callable[[str, torch.Tensor], torch.Tensor]

FAMILY = "dense"
LAYER_LEAVES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.w_gate",
                "ffn.w_up", "ffn.w_down", "pre_norm.scale", "post_norm.scale")


def leaves(cfg: dict) -> Dict[str, weights.Leaf]:
    """One layer's slice of each leaf: matrices by their fan-in, norm
    scales around 1, the (tied) embedding table at 0.02."""
    d, h, hk, hd, ff, v = (cfg["hidden_size"], cfg["num_attention_heads"],
                           cfg["num_key_value_heads"], cfg["head_dim"],
                           cfg["intermediate_size"], cfg["vocab_size"])
    Leaf = weights.Leaf
    return {
        "attn.wq": Leaf((d, h, hd), "fan_in", (0,)),
        "attn.wk": Leaf((d, hk, hd), "fan_in", (0,)),
        "attn.wv": Leaf((d, hk, hd), "fan_in", (0,)),
        "attn.wo": Leaf((h, hd, d), "fan_in", (0, 1)),
        "ffn.w_gate": Leaf((d, ff), "fan_in", (0,)),
        "ffn.w_up": Leaf((d, ff), "fan_in", (0,)),
        "ffn.w_down": Leaf((ff, d), "fan_in", (0,)),
        "pre_norm.scale": Leaf((d,), "norm"),
        "post_norm.scale": Leaf((d,), "norm"),
        "final_norm.scale": Leaf((d,), "norm"),
        "embedding.table": Leaf((v, d), "embedding", (1,)),
    }


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [s, heads, hd]; rotates the two halves of the head dim."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (pos.to(torch.float64)[:, None] * inv)[:, None, :]
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, q_chunk: int) -> torch.Tensor:
    """Causal attention of q [s, h, hd] over k, v [s, hk, hd]."""
    s, h, hd = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)     # [h, s, hd]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, s, q_chunk):
        b = min(a + q_chunk, s)
        scores = torch.matmul(q[:, a:b], k[:, :b].transpose(1, 2)) / hd ** 0.5
        mask = (torch.arange(b, device=q.device)[None, :]
                > torch.arange(a, b, device=q.device)[:, None])
        scores.masked_fill_(mask, float("-inf"))
        out[:, a:b] = torch.matmul(torch.softmax(scores, dim=-1), v[:, :b])
    return out.transpose(0, 1)


def logits(cfg: dict, seed: int, seqs: Sequence[np.ndarray],
           read: Sequence[Tuple[int, int]], *, device,
           weight_fn: Optional[WeightFn] = None,
           q_chunk: int = 1024) -> List[torch.Tensor]:
    """f32 logits ``[stop - start, vocab]`` at positions [start, stop) of
    each token sequence. ``weight_fn(leaf, w)`` may replace each f32
    weight before use (the lower-precision control does)."""
    if not cfg.get("tie_word_embeddings", False):
        raise ValueError("this reference ties the LM head to the embedding")
    fn = weight_fn or (lambda leaf, w: w)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h, hk, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            table = fn("embedding.table", weights.make(
                cfg, seed, "embedding.table", device=device).float())
            xs = [table[torch.as_tensor(np.asarray(t), dtype=torch.long,
                                        device=device)] for t in seqs]
            for layer in range(cfg["num_hidden_layers"]):
                w = {leaf: fn(leaf, weights.make(cfg, seed, leaf, layer,
                                                 device=device).float())
                     for leaf in LAYER_LEAVES}
                for i, x in enumerate(xs):
                    s = x.shape[0]
                    pos = torch.arange(s, device=device)
                    a = _rmsnorm(x, w["pre_norm.scale"], eps)
                    q = torch.matmul(a, w["attn.wq"].reshape(a.shape[1], -1))
                    k = torch.matmul(a, w["attn.wk"].reshape(a.shape[1], -1))
                    v = torch.matmul(a, w["attn.wv"].reshape(a.shape[1], -1))
                    q = _rope(q.reshape(s, h, hd), pos, theta)
                    k = _rope(k.reshape(s, hk, hd), pos, theta)
                    o = _attention(q, k, v.reshape(s, hk, hd), q_chunk)
                    x = x + torch.matmul(o.reshape(s, h * hd),
                                         w["attn.wo"].reshape(h * hd, -1))
                    a = _rmsnorm(x, w["post_norm.scale"], eps)
                    g = torch.nn.functional.silu(torch.matmul(a, w["ffn.w_gate"]))
                    x = x + torch.matmul(g * torch.matmul(a, w["ffn.w_up"]),
                                         w["ffn.w_down"])
                    xs[i] = x
                del w
            final = fn("final_norm.scale", weights.make(
                cfg, seed, "final_norm.scale", device=device).float())
            return [torch.matmul(_rmsnorm(x[a:b], final, eps), table.T)
                    for x, (a, b) in zip(xs, read)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
