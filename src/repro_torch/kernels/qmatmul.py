"""int8 x int8 -> int32 matrix product with a per-column scale: kernel B5.

Port of ``repro.kernels.qmatmul`` (the Pallas kernel ``qmatmul``). x_q int8
``[M, K]`` times w_q int8 ``[K, N]``, accumulated exactly in int32 over K,
then ``acc.astype(f32) * scale`` with scale f32 ``[1, N]`` (the activation
scale already folded in), rounded into ``out_dtype``.

On the card the work is the hand-written CUDA kernel ``csrc/qmatmul.cu``; a
tensor on the CPU goes to the plain version, :func:`qmatmul_plain`, which
computes the product in float64. That is exact (every partial sum is an
integer of magnitude at most K * 127**2 < 2**53), and it runs on the card
too, where torch has no int32 matrix product: ``chip_smoke.py`` holds the
kernel to it bit for bit. Unlike the reference, M, N and K need not be
multiples of a block size (the kernel masks its edges); the kernel takes K
a multiple of 16 and N of 4 (``ops.qmm`` pads that far).

:func:`qmm_plan` picks the kernel's regime, tiles and split of K from
(M, N, K) and the SM count; :func:`_split_sum` is the plan's split in torch,
for the tests only. Integer sums are exact, so no plan changes a bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

OUT_DTYPES = (torch.bfloat16, torch.float32)

# Launches of the CUDA kernel since the last reset (the plain version never
# counts): a run reads it to show the main path went through the kernel.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


# the kernel's tiles (csrc/qmatmul.cu): 128 output columns a CTA, K steps
# of 64; rows a CTA from BM_CHOICES
BN, BK = 128, 64
BM_CHOICES = (16, 32, 64, 128)
SMALL_M = 128        # M up to this: the bytes bound (decode, small batch)
MAX_SPLITS = 8       # the splits of a tile form one cluster (portable size)
MIN_SPLIT_STEPS = 4  # K steps a split walks at least
CTAS_PER_SM = 2      # CTAs the split aims for on every SM
H100_SMS = 132


class QmmPlan(NamedTuple):
    """How the kernel cuts one product: ``regime`` "small" (a 6-stage
    ring, bm the least of :data:`BM_CHOICES` that holds M) or "large"
    (128 x 128 tiles, a 4-stage ring); K in ``splits`` runs of
    ``k_per_split`` (a multiple of :data:`BK`), summed over a cluster."""
    regime: str
    bm: int
    stages: int
    splits: int
    k_per_split: int


def qmm_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> QmmPlan:
    """The kernel's plan for x ``[m, k]`` x w ``[k, n]`` on a card of
    ``sms`` SMs: K is split until about :data:`CTAS_PER_SM` CTAs stand on
    every SM (at most :data:`MAX_SPLITS` splits of at least
    :data:`MIN_SPLIT_STEPS` steps), so that w_down's 32 column tiles also
    keep every SM streaming at M = 1."""
    if m <= SMALL_M:
        regime, bm, stages = "small", min(b for b in BM_CHOICES if b >= m), 6
    else:
        regime, bm, stages = "large", BM_CHOICES[-1], 4
    steps = max(1, -(-k // BK))
    tiles = -(-n // BN) * -(-m // bm)
    splits = max(1, min(MAX_SPLITS, -(-CTAS_PER_SM * sms // tiles),
                        steps // MIN_SPLIT_STEPS))
    per = -(-steps // splits)
    return QmmPlan(regime, bm, stages, -(-steps // per), per * BK)


def _split_sum(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
               plan: QmmPlan, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plan's split in plain torch (tests only): each split's int64
    partial over its run of K, summed in split order, then the epilogue of
    :func:`qmatmul_plain`."""
    k = x_q.shape[1]
    acc = torch.zeros((x_q.shape[0], w_q.shape[1]), dtype=torch.int64)
    for i in range(plan.splits):
        lo, hi = i * plan.k_per_split, min(k, (i + 1) * plan.k_per_split)
        acc += (x_q[:, lo:hi].double() @ w_q[lo:hi].double()).long()
    return (acc.float() * scale).to(out_dtype)


def qmatmul_plain(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                  *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version of :func:`qmatmul`, on any device: the int32
    accumulation in float64 (exact), then int -> f32 rounded to nearest,
    one f32 multiply, and round to nearest even into ``out_dtype``."""
    acc = (x_q.double() @ w_q.double()).float()
    return (acc * scale).to(out_dtype)


@functools.cache
def _kernel_fn():
    from repro_torch.kernels import build
    fn = build.load("qmatmul.cu").repro_qmatmul
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i,     # x w scale out m n k bf16
                   i, i, i, i, p]              # bm stages splits k_per_split
                                               # stream
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x_q, w_q, scale, out_dtype) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype}, {w_q.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"want x_q [M, K] and w_q [K, N], got "
                         f"{tuple(x_q.shape)}, {tuple(w_q.shape)}")
    n = w_q.shape[1]
    if tuple(scale.shape) != (1, n):
        raise ValueError(f"want scale [1, {n}], got {tuple(scale.shape)}")
    if len({x_q.device, w_q.device, scale.device}) != 1:
        raise ValueError("x_q, w_q and scale must share one device")


def qmatmul(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, *,
            out_dtype=torch.bfloat16) -> torch.Tensor:
    """x_q int8 ``[M, K]`` x w_q int8 ``[K, N]`` * scale f32 ``[1, N]`` ->
    ``[M, N]`` in ``out_dtype`` (bf16 or f32).

    A CUDA tensor launches the kernel (building it on first use) and raises
    if it cannot; a CPU tensor goes to the plain version."""
    global launches
    _check(x_q, w_q, scale, out_dtype)
    if x_q.device.type == "cpu":
        return qmatmul_plain(x_q, w_q, scale, out_dtype=out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"no qmatmul kernel for device {x_q.device}")
    m, k = x_q.shape
    n = w_q.shape[1]
    if k % 16 or n % 4:
        raise ValueError(f"the kernel takes K % 16 == 0 and N % 4 == 0, got "
                         f"K={k}, N={n} (ops.qmm pads)")
    if not (x_q.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("x_q, w_q and scale must be contiguous")
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 4 or scale.data_ptr() % 16:
        raise ValueError("x_q and scale must be 16-byte and w_q 4-byte "
                         "aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    fn = _kernel_fn()
    plan = qmm_plan(m, n, k, _sms(x_q.device))
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        rc = fn(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                out.data_ptr(), m, n, k, int(out_dtype == torch.bfloat16),
                plan.bm, plan.stages, plan.splits, plan.k_per_split, stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
