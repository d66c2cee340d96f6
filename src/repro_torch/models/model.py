"""The model factory and the step functions (``repro.models.model``).

``make_forward_loss``, ``make_prefill_step`` and ``make_decode_step``
wrap a model's ``loss_fn``, ``prefill`` and ``decode_step`` as functions
of (params, batch), the JAX package's step functions. ``input_specs``
and ``input_axes`` wait for the sharding rules.
"""
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


def make_forward_loss(model):
    """loss(params, batch) for training: ``model.loss_fn``."""
    def loss(params, batch):
        return model.loss_fn(params, batch)
    return loss


def make_prefill_step(model):
    """prefill_step(params, batch) -> (the last position's logits (b, V),
    the cache): batch {"frames", "tokens"} for an encoder-decoder model,
    else {"embeds"} for a model with a frontend or {"tokens"}."""
    if model.cfg.is_encdec:
        def prefill_step(params, batch):
            logits, cache = model.prefill(params, batch["frames"],
                                          batch["tokens"])
            return logits[:, -1], cache
        return prefill_step

    key = "embeds" if model.takes_embeds else "tokens"

    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch[key])
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(model):
    """decode_step(params, batch) -> (logits (b, V), the new cache):
    batch {"tokens" (b, 1), "pos", "cache"}."""
    def decode_step(params, batch):
        logits, cache = model.decode_step(params, batch["tokens"],
                                          batch["pos"], batch["cache"])
        return logits[:, -1], cache
    return decode_step
