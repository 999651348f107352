"""Model facade (port of ``repro.models.model``, dense decoders only).

``build_model(cfg)`` returns a :class:`Model` whose serving entry points the
engine calls: ``init_params``, ``init_cache``, ``prefill`` and
``decode_step``. A model lives on one device: the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import DecoderLM

Params = Any


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the port builds dense decoders only; the {cfg.family!r} "
                f"family arrives with ROADMAP.md queue A item 17")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._impl = DecoderLM(cfg)

    # -- params --------------------------------------------------------------
    def init_params(self, seed: int = 0) -> Params:
        """Random weights from ``seed``, made on the model's device."""
        return self._impl.init_params(seed, self.device)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Params:
        return self._impl.init_cache(batch, max_len, self.device)

    def abstract_cache(self, batch: int, max_len: int) -> Params:
        """The cache's structure with meta-device leaves (no memory)."""
        return self._impl.init_cache(batch, max_len, "meta")

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache: Params):
        return self._impl.prefill(params, batch["tokens"], cache)

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params):
        return self._impl.decode_step(params, tokens, cache)


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
