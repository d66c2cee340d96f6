"""GQA attention for full-sequence prefill (``repro.models.attention``).

Three execution strategies, as in the JAX package:
  * ``flash``   — the default: ``kernels.flash_attention.ops.attention``,
    the hand-written CUDA kernel on the card (its plain version on the
    CPU), reading the shared KV head of each query head in place;
  * ``blocked`` — the plain online softmax over KV blocks;
  * ``einsum``  — the plain quadratic masked softmax.
The two plain strategies take K/V expanded to one head per query head.
Decode, KV caches and cross-attention are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_blocked,
                                                     attention_einsum,
                                                     attention_mask)
from repro_torch.kernels.flash_attention.ref import expand_kv as _expand_kv
from repro_torch.models.common import Params, apply_rope, dense_init

IMPLS = ("flash", "blocked", "einsum")


def attn_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(generator, d, (nq, hd), dtype),
        "wk": dense_init(generator, d, (nkv, hd), dtype),
        "wv": dense_init(generator, d, (nkv, hd), dtype),
        "wo": dense_init(generator, nq * hd, (d,), dtype).reshape(nq, hd, d),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(
        b, s, w.shape[1], w.shape[2])


def attn_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, causal: bool = True,
               window: int = 0, impl: str = "flash") -> torch.Tensor:
    """Full-sequence attention with RoPE. x: (b, s, d) -> (b, s, d)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    b, s, d = x.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    if impl == "flash":
        out = flash_ops.attention(q, k, v, scale=scale, causal=causal,
                                  window=window)
    elif impl == "einsum":
        mask = attention_mask(s, s, causal=causal, window=window,
                              device=x.device)
        out = attention_einsum(q, _expand_kv(k, groups),
                               _expand_kv(v, groups), mask, scale)
    else:
        out = attention_blocked(q, _expand_kv(k, groups),
                                _expand_kv(v, groups), scale, causal=causal,
                                window=window)
    wo = params["wo"]
    y = out.reshape(b * s, -1) @ wo.reshape(-1, wo.shape[-1])
    return y.reshape(b, s, -1)
