"""The frozen yardstick: the card's peaks and the arithmetic that turns
counts into work. A change to the program cannot move any of it.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense
rates, no sparsity). FLOPs are model FLOPs of real tokens: a multiply-add
counts 2, bucket padding counts nothing, and attention counts the causal
context of real positions only. A configuration's reference may declare
its own per-token counts (``model_flops(cfg)``: the weights a token
passes through, only the experts it is routed to; the FLOPs of one
query-key pair over every layer); otherwise they are a dense decoder's.
Bytes are what the B3 decode-attention call must move at the slots' live
lengths: every live K and V row read once, the queries read once, the
output written once.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from teebench import spec

PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
PEAK_HBM_BYTES = 3.35e12      # HBM3 bytes/s
PEAK_POWER_W = 700.0          # the power limit those peaks assume
BF16_BYTES = 2


def layer_params(cfg: dict) -> int:
    """Weights of one dense decoder layer touched by a matmul (norm scales
    are vectors and left out)."""
    d, h, hk, hd, ff = (cfg["hidden_size"], cfg["num_attention_heads"],
                        cfg["num_key_value_heads"], cfg["head_dim"],
                        cfg["intermediate_size"])
    return d * h * hd + 2 * d * hk * hd + h * hd * d + 3 * d * ff


def _attn_flops_per_ctx(cfg: dict) -> int:
    """FLOPs of one query position against one key position over every
    layer: q.k and p.v, 2 FLOPs a multiply-add, per head."""
    return 4 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * \
        cfg["head_dim"]


def model_flops(cfg: dict) -> Tuple[int, int]:
    """(FLOPs of one token through every layer, FLOPs of one query
    position against one key position over every layer): what the
    configuration's reference declares, else a dense decoder's."""
    declared = (getattr(spec.reference(cfg), "model_flops", None)
                if "reference" in cfg else None)
    if declared is not None:
        return declared(cfg)
    return 2 * cfg["num_hidden_layers"] * layer_params(cfg), \
        _attn_flops_per_ctx(cfg)


def lm_head_flops(cfg: dict) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, n_real: int) -> int:
    """A prompt of ``n_real`` real tokens: every layer for each token,
    causal attention over real positions, and the LM head once (for the
    last position, whose logits pick the first token)."""
    token, pair = model_flops(cfg)
    return token * n_real + pair * n_real * (n_real + 1) // 2 + \
        lm_head_flops(cfg)


def decode_flops(cfg: dict, real_ctx: Iterable[int]) -> int:
    """One decode step of the rows whose real context (prompt tokens and
    the tokens fed so far, the new one included) is ``real_ctx``."""
    ctx = list(real_ctx)
    token, pair = model_flops(cfg)
    return (token + lm_head_flops(cfg)) * len(ctx) + pair * sum(ctx)


def b3_bytes(cfg: dict, valid: Iterable[int], page_size: int) -> int:
    """Bytes one decode step's B3 calls (one a layer) must move for slots
    attending to ``valid`` positions each: K and V rows read once, the
    page-table entries of the pages they span, the query read and the
    output written (bf16)."""
    h, hk, hd, layers = (cfg["num_attention_heads"],
                         cfg["num_key_value_heads"], cfg["head_dim"],
                         cfg["num_hidden_layers"])
    total = 0
    for v in valid:
        kv = 2 * v * hk * hd * BF16_BYTES
        table = 4 * (-(-v // page_size))
        qo = 2 * h * hd * BF16_BYTES
        total += kv + table + qo
    return total * layers


def hbm_bound_s(n_bytes: float) -> float:
    return n_bytes / PEAK_HBM_BYTES


def flops_bound_s(flops: float) -> float:
    return flops / PEAK_BF16_FLOPS
