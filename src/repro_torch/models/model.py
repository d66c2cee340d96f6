"""The model factory (``repro.models.model``)."""
from __future__ import annotations

from typing import Union

from repro_torch.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ModelConfig, **opts) -> Union[TransformerLM, EncDecLM]:
    """The model of ``cfg``: an ``EncDecLM`` for an encoder-decoder
    config (``opts`` may carry only ``attn_impl``), else a
    ``TransformerLM`` with ``opts`` (``attn_impl``, ``rwkv_mode``,
    ``moe_dispatch``) passed through; it raises for what it does not
    run."""
    if cfg.is_encdec:
        return EncDecLM(cfg, **opts)
    return TransformerLM(cfg, **opts)
