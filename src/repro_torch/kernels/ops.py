"""Public wrappers around the kernels (port of ``repro.kernels.ops``).

Handles padding and packing so callers see natural shapes:
  * seal_u32 / unseal_u32 — arbitrary tensors <-> blocked ciphertext layout
  * qmm — bf16 activations x QTensor weights, padded as the kernel needs (B5)
  * mha_flash — [b, s, h, d] causal attention with GQA (kernel B2)

Sealing: the layout and padding are the reference's, byte for byte: bytes
are zero-padded to a multiple of 64 KiB (one :data:`BLOCKS_PER_TILE` tile),
read as little-endian uint32 words in blocks of 16, and stored word-major
as ``[16, N]``. The port packs and unpacks on the tensor's own device (the
reference did it on the host).

A CPU tensor goes through each kernel's plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.chacha20 import BLOCKS_PER_TILE, chacha20_xor_blocked
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.qmatmul import qmatmul
from repro_torch.quant.quantize import QTensor, quantize_activations

TILE_BYTES = 64 * BLOCKS_PER_TILE
# what the int8 kernel takes: K a multiple of 16, N of 4 (kernels/qmatmul.py)
QMM_K_MULTIPLE, QMM_N_MULTIPLE = 16, 4


def pack_u32(raw: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """uint8 bytes -> (int32 ``[16, N]`` blocked layout on raw's device,
    original byte length)."""
    n_bytes = raw.numel()
    padded = n_bytes + (-n_bytes) % TILE_BYTES
    buf = torch.zeros(padded, dtype=torch.uint8, device=raw.device)
    buf[:n_bytes] = raw.reshape(-1)
    # little-endian words (the card and x86 hosts are little-endian)
    words = buf.view(torch.int32).view(-1, 16).t().contiguous()
    return words, n_bytes


def unpack_u32(words: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """Inverse of :func:`pack_u32` -> uint8 ``[n_bytes]`` on words' device."""
    return words.t().contiguous().view(-1).view(torch.uint8)[:n_bytes]


def seal_u32(key_words, nonce_words, blocked: torch.Tensor,
             counter_base: int = 0,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """XOR blocked data with the keystream (seal == unseal: involution)."""
    return chacha20_xor_blocked(key_words, nonce_words, blocked,
                                counter_base=counter_base, out=out)


unseal_u32 = seal_u32  # stream-cipher involution


# ---------------------------------------------------------------------------
# quantized matmul
# ---------------------------------------------------------------------------

def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def qmm(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """bf16 [M, K] x QTensor([K, N]) -> [M, N] in x's dtype via the int8
    kernel.

    Dynamically quantizes activations per-tensor (AMX dataflow), folds the
    activation scale into the per-channel weight scale in f32, pads only as
    far as the kernel requires (K to a multiple of 16, N of 4; no M
    padding, so a decode-shaped call reaches the kernel's small-M regime),
    and un-pads the result. Zero padding adds exact zeros, so the bits are
    those of the reference's padding to 128. The kernel emits bf16, which
    is then cast to x's dtype, as in the reference.
    """
    m, kdim = x.shape
    k2, n = w.values.shape
    if kdim != k2:
        raise ValueError(f"x [{m}, {kdim}] does not contract with w "
                         f"[{k2}, {n}]")
    xq, xscale = quantize_activations(x)
    xq = _pad_to(xq, 1, QMM_K_MULTIPLE)
    wq = _pad_to(_pad_to(w.values, 0, QMM_K_MULTIPLE), 1, QMM_N_MULTIPLE)
    scale = _pad_to(w.scale.reshape(1, n) * xscale, 1, QMM_N_MULTIPLE)
    out = qmatmul(xq, wq, scale)
    return out[:, :n].to(x.dtype)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              bq: int = 128, bkv: int = 128) -> torch.Tensor:
    """Causal attention, [b, s, h, d] layout with GQA broadcast: kv head
    ``i // (h // hk)`` serves q head i, read in place (the reference
    repeats k and v)."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s, d)
    kf = k.transpose(1, 2).reshape(b * hk, s, d)
    vf = v.transpose(1, 2).reshape(b * hk, s, d)
    bq_ = min(bq, s)
    bkv_ = min(bkv, s)
    # non-block-multiple sequence: zero-pad to a common block multiple. The
    # causal mask sends every padded kv position (k_pos >= s > q_pos for all
    # real rows) to NEG_INF, and padded query rows are sliced away below, so
    # padding is invisible to the result.
    mult = math.lcm(bq_, bkv_)
    qf, kf, vf = (_pad_to(a, 1, mult).contiguous() for a in (qf, kf, vf))
    out = flash_attention(qf, kf, vf, bq=bq_, bkv=bkv_)
    return out[:, :s].reshape(b, h, s, d).transpose(1, 2)
