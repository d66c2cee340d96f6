"""The model factory (``repro.models.model``)."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ModelConfig, **opts) -> TransformerLM:
    """The model of ``cfg`` (only the decoder-only ``TransformerLM`` is
    ported; it raises for what it does not run)."""
    return TransformerLM(cfg, **opts)
