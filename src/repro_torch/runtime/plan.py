"""The engine's device-facing seam (port of ``repro.runtime.plan``, single
device only).

:class:`SingleDevicePlan` places the params on the model's device and hands
back eager callables that run under ``torch.inference_mode()``; PyTorch has
no ``jit`` step. ``PrefillOnlyPlan`` (disaggregated prefill) and
``ShardedPlan`` (meshes) arrive with ROADMAP.md queue A items 13 and 18.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.sealing import tree_map

Params = Any


class SingleDevicePlan:
    def __init__(self, model):
        self.model = model
        self.device = model.device

    def place_params(self, params: Params) -> Params:
        return tree_map(lambda t: t.to(self.device), params)

    def compile_prefill(self):
        model = self.model

        @torch.inference_mode()
        def _prefill(params, tokens, cache):
            return model.prefill(params, {"tokens": tokens}, cache)

        return _prefill

    def compile_decode(self, fn):
        """The backend's batched decode step."""
        return torch.inference_mode()(fn)
