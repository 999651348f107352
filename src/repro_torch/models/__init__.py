"""Models (port of ``repro.models``: every family)."""

from repro_torch.models.model import build_model, Model

__all__ = ["build_model", "Model"]
