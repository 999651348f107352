"""Causal flash attention (blocked online softmax): kernel B2.

Port of ``repro.kernels.flash_attention`` (the Pallas kernel
``flash_attention``). q/k/v are ``[bh, s, d]`` (batch and heads folded
outside), causal, softmax scale ``1/sqrt(d)`` rounded to f32 as the
reference's weakly typed multiply rounds it. The running max, sum and
accumulator of each q block are f32; kv blocks wholly above the diagonal
are skipped, masked scores are :data:`NEG_INF`, and the emit is
``acc / max(l, 1e-30)`` in q's dtype.

On the card the work is the hand-written CUDA kernel
``csrc/flash_attention.cu``; a tensor on the CPU goes to the plain version,
:func:`flash_attention_plain`, the reference kernel's walk in torch (a loop
over q blocks and, inside it, over kv blocks up to the diagonal).
``chip_smoke.py`` also runs the plain version on the card, as the reference
the kernel is held to. Beyond the reference, k and v may carry fewer heads
than q (GQA): q head i reads kv head ``i // (bh // bhk)``, the values the
reference's ``jnp.repeat`` gives it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

NEG_INF = -1e30

DTYPES = (torch.float32, torch.bfloat16)
# head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

# Launches of the CUDA kernel since the last reset (the plain version never
# counts): a run reads it to show the main path went through the kernel.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def softmax_scale(d: int) -> float:
    """``1 / sqrt(d)`` as the f32 the reference multiplies by."""
    return float(np.float32(1.0 / np.sqrt(d)))


@torch.inference_mode()
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, bq: int = 128, bkv: int = 128) -> torch.Tensor:
    """The plain version of :func:`flash_attention`, on any device: the
    reference kernel's grid walk with its update per (q block, kv block)."""
    bh, s, d = q.shape
    group = bh // k.shape[0]
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    scale = softmax_scale(d)
    out = torch.empty_like(q)
    rows = torch.arange(bq, device=q.device)[:, None]
    cols = torch.arange(bkv, device=q.device)[None, :]
    for qi in range(s // bq):
        qb = q[:, qi * bq:(qi + 1) * bq].float()
        m = torch.full((bh, bq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bh, bq, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, bq, d), dtype=torch.float32, device=q.device)
        for ki in range(s // bkv):
            if ki * bkv > qi * bq + bq - 1:     # causal block skip
                break
            kb = k[:, ki * bkv:(ki + 1) * bkv].float()
            sc = torch.bmm(qb, kb.transpose(1, 2)) * scale
            sc = torch.where(ki * bkv + cols <= qi * bq + rows, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            vb = v[:, ki * bkv:(ki + 1) * bkv].float()
            acc = acc * alpha + torch.bmm(p, vb)
            m = m_new
        out[:, qi * bq:(qi + 1) * bq] = (acc / torch.clamp_min(l, 1e-30)
                                         ).to(q.dtype)
    return out


@functools.cache
def _kernel_fn():
    from repro_torch.kernels import build
    fn = build.load("flash_attention.cu").repro_flash_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, bq, bkv) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"want q [bh, s, d] and k/v [bhk, s, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    if k.shape[1:] != (s, d) or k.shape[0] == 0 or bh % k.shape[0]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype of {DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if s % bq or s % bkv:
        raise ValueError(f"s={s} is not a multiple of bq={bq} and bkv={bkv} "
                         f"(ops.mha_flash pads)")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must share one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bq: int = 128, bkv: int = 128) -> torch.Tensor:
    """Causal attention. q ``[bh, s, d]``, k/v ``[bhk, s, d]`` with bhk
    dividing bh, ``s % bq == s % bkv == 0``; returns ``[bh, s, d]`` in q's
    dtype. ``bq``/``bkv`` are the reference's blocks: the plain version
    walks them, the kernel keeps its own 64-row tiles (the result differs
    in the order of f32 sums and, in bf16, where the kernel's tensor-core
    p.v carries p as a bf16 pair hi + lo).

    A CUDA tensor launches the kernel (building it on first use) and raises
    if it cannot; a CPU tensor goes to the plain version."""
    global launches
    _check(q, k, v, bq, bkv)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bq=bq, bkv=bkv)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    bh, s, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    out = torch.empty_like(q)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, bh // k.shape[0], s, d, int(q.dtype == torch.bfloat16),
                softmax_scale(d), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
