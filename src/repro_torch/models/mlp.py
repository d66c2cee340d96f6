"""Gated (SwiGLU-family) MLP block (``repro.models.mlp``):
``(x wi) * act(x wg) wo``, the activation on the gate branch ``wg``."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.common import Params, activation, dense_init


def mlp_init(generator: torch.Generator, cfg: ModelConfig, dtype,
             d_ff: int = 0) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "wi": dense_init(generator, d, (f,), dtype),     # up
        "wg": dense_init(generator, d, (f,), dtype),     # gate
        "wo": dense_init(generator, f, (d,), dtype),     # down
    }


def mlp_apply(params: Params, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg.act)
    h = x @ params["wi"]
    g = act(x @ params["wg"])
    return (h * g) @ params["wo"]
