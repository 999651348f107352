"""Model facade over every family (port of ``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model` whose serving entry points the
engine calls: ``init_params``, ``init_cache``, ``prefill`` and
``decode_step``; ``forward`` is the cache-free teacher-forced pass and
``loss`` the trainer's objective. ``abstract_params``, ``abstract_cache``
and the ``*_specs`` methods give the same structures as meta-device
tensors (shapes and dtypes, no memory) where the reference gives
``jax.ShapeDtypeStruct``s. The
decoder families (dense, moe, hybrid, ssm, vlm) run through
:class:`~repro_torch.models.transformer.DecoderLM`, the encoder-decoder
(whisper) through :class:`~repro_torch.models.encdec.EncDecLM`, whose
batches carry ``frames`` beside ``tokens``. A model lives on one device:
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM

Params = Any


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.is_encdec = cfg.family == "encdec"
        self._impl = EncDecLM(cfg) if self.is_encdec else DecoderLM(cfg)

    @property
    def rows_coupled(self) -> bool:
        """Does a row's output depend on the other rows of its call? True
        for the MoE families: expert capacity is reckoned from every token
        in the call, so at a capacity factor that drops, batch-mates
        compete for the same expert slots (in the reference too)."""
        return self.cfg.moe is not None

    # -- params --------------------------------------------------------------
    def init_params(self, seed: int = 0) -> Params:
        """Random weights from ``seed``, made on the model's device."""
        return self._impl.init_params(seed, self.device)

    def abstract_params(self) -> Params:
        """The params' structure with meta-device leaves (no memory)."""
        return self._impl.init_params(0, "meta")

    # -- training ------------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """(loss, {"ce_loss", "aux_loss"}) of a batch of ``tokens`` and
        ``labels`` (and ``frames`` for the encoder-decoder)."""
        return self._impl.loss(params, batch)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Params:
        """A zeroed cache; for the encoder-decoder ``max_len`` is the
        encoder length (the decoder's is ``cfg.max_target_len``)."""
        return self._impl.init_cache(batch, max_len, self.device)

    def abstract_cache(self, batch: int, max_len: int) -> Params:
        """The cache's structure with meta-device leaves (no memory)."""
        return self._impl.init_cache(batch, max_len, "meta")

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache: Params):
        if self.is_encdec:
            return self._impl.prefill(params, batch["frames"],
                                      batch["tokens"], cache)
        return self._impl.prefill(params, batch["tokens"], cache)

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Params):
        return self._impl.decode_step(params, tokens, cache)

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]):
        """Teacher-forced full-sequence pass -> (logits [b, s, vocab] f32,
        aux loss)."""
        if self.is_encdec:
            return self._impl.forward(params, batch["frames"],
                                      batch["tokens"])
        return self._impl.forward(params, batch["tokens"])

    # -- input specs (meta tensors) ------------------------------------------
    def train_batch_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        if self.is_encdec:
            t = cfg.max_target_len
            return {"frames": _meta((b, s, cfg.d_model), cfg.torch_dtype),
                    "tokens": _meta((b, t), torch.int32),
                    "labels": _meta((b, t), torch.int32)}
        if cfg.embedding_inputs:
            return {"tokens": _meta((b, s, cfg.d_model), cfg.torch_dtype),
                    "labels": _meta((b, s), torch.int32)}
        return {"tokens": _meta((b, s), torch.int32),
                "labels": _meta((b, s), torch.int32)}

    def prefill_batch_specs(self, shape: ShapeConfig
                            ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        if self.is_encdec:
            return {"frames": _meta((b, s, cfg.d_model), cfg.torch_dtype),
                    "tokens": _meta((b, cfg.max_target_len), torch.int32)}
        return {"tokens": _meta((b, s), torch.int32)}

    def decode_token_specs(self, shape: ShapeConfig) -> torch.Tensor:
        return _meta((shape.global_batch, 1), torch.int32)

    def cache_specs(self, shape: ShapeConfig) -> Params:
        """The cache sized for the cell (``seq_len`` entries)."""
        return self.abstract_cache(shape.global_batch, shape.seq_len)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
