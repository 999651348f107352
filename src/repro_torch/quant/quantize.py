"""Per-channel int8 absmax quantization: the paper's int8 weight path (port
of ``repro.quant.quantize``).

The paper (Insights 3/8) shows AMX's native int8 tiles both speed up
inference and shrink *relative* TEE overhead by raising arithmetic
intensity. Weights quantize to int8 with per-output-channel f32 scales,
products run int8 x int8 -> int32 (``kernels/qmatmul.py``, kernel B5), and
activations stay bf16 and are quantized per tensor on the fly
(``kernels/ops.py::qmm``).

Every function keeps the reference's arithmetic, so values and scales are
bit-equal to the JAX package's: f32 division, round half to even
(``torch.round`` rounds as ``jnp.round`` does), clip to [-127, 127].
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

Params = Any


class QTensor(NamedTuple):
    """int8 values + f32 per-channel scale over the LAST axis."""
    values: torch.Tensor   # int8
    scale: torch.Tensor    # f32, shape = values.shape[:-2] + (1, values.shape[-1])

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype


def _absmax_scale(xf: torch.Tensor, amax: torch.Tensor) -> tuple:
    """(int8 values, f32 scale): ``amax / 127`` (1.0 where amax is 0) and
    ``clip(round(x / scale), -127, 127)``."""
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(w: torch.Tensor, axis: int = -2) -> QTensor:
    """Quantize along ``axis`` (the contraction axis), per-channel on the rest.

    Default axis=-2 matches (in_features, out_features) weight layout: one
    scale per output channel.
    """
    wf = w.float()
    q, scale = _absmax_scale(wf, wf.abs().amax(dim=axis, keepdim=True))
    return QTensor(q, scale)


def quantize_activations(x: torch.Tensor) -> tuple:
    """Per-tensor dynamic int8 quantization of activations (the AMX int8
    GEMM dataflow): (int8 values, 0-d f32 scale)."""
    xf = x.float()
    return _absmax_scale(xf, xf.abs().max())


def dequantize(q: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.values.float() * q.scale).to(dtype)


def qmatmul_ref(x: torch.Tensor, q: QTensor) -> torch.Tensor:
    """bf16 activations x int8 weights -> x's dtype. Plain-torch oracle.

    The int32 accumulation is computed in float64, which is exact: every
    partial sum is an integer of magnitude at most K * 127**2 < 2**53.
    Scales apply as the reference's ``acc * xscale * q.scale``.
    """
    xq, xscale = quantize_activations(x)
    acc = (xq.double() @ q.values.double()).float()
    return (acc * xscale * q.scale.reshape(1, -1)).to(x.dtype)


def quantize_params(params: Params, min_size: int = 1 << 12) -> Params:
    """Quantize every >=2D float leaf of a param tree to a QTensor.

    Small tensors (norms, biases) stay in bf16 — matching IPEX int8 recipes,
    which keep normalization layers in higher precision. As in the
    reference, the test is on the leaf's total size, so layer-stacked norms
    ``[L, d]`` and the embedding quantize too.
    """
    # sealing imports this module (through kernels.ops), so its tree walk
    # is imported at call time
    from repro_torch.core.sealing import tree_map

    def q(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
                and leaf.numel() >= min_size and leaf.is_floating_point()):
            return quantize_int8(leaf)
        return leaf
    return tree_map(q, params)


def quantized_bytes(params: Params) -> int:
    """Total bytes of a (possibly quantized) param tree."""
    from repro_torch.core.sealing import tree_leaves_with_names
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in tree_leaves_with_names(params))
