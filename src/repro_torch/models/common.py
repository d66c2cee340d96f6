"""Shared building blocks of the port's models (``repro.models.common``).

Initializers draw on a ``torch.Generator`` and on its device. RMSNorm
and RoPE compute in float32 and cast back to the input's type, as the
JAX package does; RoPE rotates the two halves of each head
(``[x1 cos - x2 sin, x1 sin + x2 cos]``), not interleaved pairs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def tree_map(fn, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dictionary."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def dense_init(generator: torch.Generator, in_dim: int,
               out_shape: Tuple[int, ...],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut to [-2, 2],
    scaled by 1/sqrt(in_dim), drawn in float32 on the generator's device
    and cast to ``dtype``."""
    w = torch.empty((in_dim,) + tuple(out_shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """A standard normal times 0.02, drawn in float32 and scaled in place
    before the cast, so the table is never held twice in float32."""
    w = torch.randn((vocab, dim), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


def rmsnorm_init(dim: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(params: Params, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * freqs     # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                 # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def activation(name: str):
    """``jax.nn.gelu`` defaults to its tanh form, so ``"gelu"`` is tanh."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu,
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}[name]
