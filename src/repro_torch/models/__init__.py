"""Models (port of ``repro.models``; dense decoders in this slice)."""

from repro_torch.models.model import build_model, Model

__all__ = ["build_model", "Model"]
