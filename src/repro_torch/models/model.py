"""The model factory and the step functions (``repro.models.model``).

``make_forward_loss``, ``make_prefill_step`` and ``make_decode_step``
wrap a model's ``loss_fn``, ``prefill`` and ``decode_step`` as functions
of (params, batch), the JAX package's step functions. ``input_specs``
gives, for one step of an ``InputShape``, every model input as a meta
tensor (its shape and type, no storage), and ``input_axes`` the
matching logical-axes tree for the sharding rules (``sharding.rules``);
a decode step's inputs are the token, its position and the cache
(``cache_spec``). Token ids are int32, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.config import InputShape, ModelConfig
from repro_torch.models.common import dtype_of
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ModelConfig, **opts) -> Union[TransformerLM, EncDecLM]:
    """The model of ``cfg``: an ``EncDecLM`` for an encoder-decoder
    config (it reads ``attn_impl`` and ignores the other options), else a
    ``TransformerLM`` with ``opts`` (``attn_impl``, ``rwkv_mode``,
    ``causal_skip``, ``moe_dispatch``) passed through; it raises for what
    it does not run. ``causal_skip`` is ignored in both: the flash kernel
    skips masked tiles itself."""
    if cfg.is_encdec:
        return EncDecLM(cfg, **opts)
    return TransformerLM(cfg, **opts)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta tensors of every input of one step of ``shape``'s kind."""
    B, S = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg.dtype)
    i32 = torch.int32
    if shape.kind == "train":
        if cfg.is_encdec:
            return {"frames": _meta((B, S, cfg.d_model), dt),
                    "tokens": _meta((B, S), i32),
                    "labels": _meta((B, S), i32)}
        if cfg.frontend != "none":
            return {"embeds": _meta((B, S, cfg.d_model), dt),
                    "labels": _meta((B, S), i32)}
        return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.is_encdec:
            return {"frames": _meta((B, S, cfg.d_model), dt),
                    "tokens": _meta((B, S), i32)}
        if cfg.frontend != "none":
            return {"embeds": _meta((B, S, cfg.d_model), dt)}
        return {"tokens": _meta((B, S), i32)}
    if shape.kind == "decode":
        cache, _ = build_model(cfg).cache_spec(B, S)
        return {"tokens": _meta((B, 1), i32), "pos": _meta((), i32),
                "cache": cache}
    raise ValueError(shape.kind)


def input_axes(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Logical-axis tuples mirroring ``input_specs``."""
    if shape.kind == "train":
        if cfg.is_encdec:
            return {"frames": ("batch", "seq", "embed"),
                    "tokens": ("batch", "seq"),
                    "labels": ("batch", "seq")}
        if cfg.frontend != "none":
            return {"embeds": ("batch", "seq", "embed"),
                    "labels": ("batch", "seq")}
        return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if shape.kind == "prefill":
        if cfg.is_encdec:
            return {"frames": ("batch", "seq", "embed"),
                    "tokens": ("batch", "seq")}
        if cfg.frontend != "none":
            return {"embeds": ("batch", "seq", "embed")}
        return {"tokens": ("batch", "seq")}
    if shape.kind == "decode":
        _, cache_axes = build_model(cfg).cache_spec(shape.global_batch,
                                                    shape.seq_len)
        return {"tokens": ("batch", None), "pos": (), "cache": cache_axes}
    raise ValueError(shape.kind)


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
