"""Weights between the two packages: the reference's param tree (nested
dicts of numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives it)
to the port's and back. The layouts are the same, so each leaf converts
1:1. bfloat16 travels as its uint16 bits; the port does not import
``ml_dtypes``."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

Params = Any


def params_from_jax(tree: Params, device) -> Params:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    arr = np.ascontiguousarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_to_jax(tree: Params, bfloat16=None) -> Params:
    """Inverse of :func:`params_from_jax`: tensors -> numpy arrays. A bf16
    leaf comes back as its uint16 bits, viewed as ``bfloat16`` when the
    caller passes that numpy dtype (e.g. ``jnp.bfloat16``)."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v, bfloat16) for k, v in tree.items()}
    t = tree.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits.view(bfloat16) if bfloat16 is not None else bits
    return t.numpy()
