"""Initializers shared by the port's models (``repro.models.common``)."""
from __future__ import annotations

import math
from typing import Tuple

import torch


def dense_init(generator: torch.Generator, in_dim: int,
               out_shape: Tuple[int, ...],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut to [-2, 2],
    scaled by 1/sqrt(in_dim). Drawn on the generator's device."""
    w = torch.empty((in_dim,) + tuple(out_shape), dtype=dtype,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return w * (1.0 / math.sqrt(in_dim))
