"""Decoder-only LM for the offline embedding path
(``repro.models.transformer``).

Params layout, as in the JAX package (leaves stacked over the
``num_groups`` repeats of ``cfg.block_pattern``):
  embed.table           (V, d)
  blocks.p<i>.*         per pattern position i: norm1, attn, norm2, mlp
                        (attention blocks) or norm1, time, norm2, channel
                        (rwkv6 blocks)
  final_norm.scale
  lm_head.w             (V, d) unless cfg.tie_embeddings
Attention blocks (``attn``, ``local``) with the dense MLP and RWKV6
blocks are ported; MoE, mamba2 and shared-attention blocks raise
``NotImplementedError``, as do decode, KV caches and recurrent state.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import (BLOCK_ATTN, BLOCK_LOCAL_ATTN, BLOCK_RWKV6,
                                ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import (Params, dtype_of, embed_init,
                                       rmsnorm_apply, rmsnorm_init, tree_map)

ATTN_KINDS = (BLOCK_ATTN, BLOCK_LOCAL_ATTN)
PORTED_KINDS = ATTN_KINDS + (BLOCK_RWKV6,)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's model does not run yet."""
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported")
    if cfg.moe.enabled:
        raise NotImplementedError("MoE blocks are not ported")
    other = [k for k in cfg.block_pattern if k not in PORTED_KINDS]
    if other:
        raise NotImplementedError(f"block kinds {other} are not ported; "
                                  f"only {PORTED_KINDS}")
    if cfg.num_layers % len(cfg.block_pattern):
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} % "
                         f"pattern {len(cfg.block_pattern)} != 0")


def _block_init(generator, kind: str, cfg: ModelConfig, dtype) -> Params:
    dev = generator.device
    if kind == BLOCK_RWKV6:
        return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
                "time": rwkv_mod.timemix_init(generator, cfg, dtype),
                "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
                "channel": rwkv_mod.channelmix_init(generator, cfg, dtype)}
    return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
            "attn": attn.attn_init(generator, cfg, dtype),
            "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
            "mlp": mlp_mod.mlp_init(generator, cfg, dtype)}


def _fill(stacked: Params, tree: Params, g: int) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill(stacked[k], v, g)
        else:
            stacked[k][g].copy_(v)


def group_params(params: Params, g: int) -> Params:
    """The params of pattern group ``g``: views of the stacked leaves."""
    return tree_map(lambda t: t[g], params["blocks"])


class TransformerLM:
    """Decoder-only LM over a pattern of attention and RWKV6 blocks.

    ``attn_impl`` picks the attention path (``models.attention.IMPLS``),
    ``rwkv_mode`` the time-mix path (``models.rwkv.MODES``); the defaults
    are the hand-written kernels."""

    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "flash",
                 rwkv_mode: str = "kernel"):
        check_supported(cfg)
        rwkv_mod.check_mode(rwkv_mode)
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.rwkv_mode = rwkv_mode
        self.pattern = cfg.block_pattern
        self.num_groups = cfg.num_layers // len(cfg.block_pattern)

    def init(self, generator: torch.Generator) -> Params:
        """Random params drawn on ``generator`` and on its device. Each
        group's block is drawn on its own and copied into the stacked
        leaves, so the peak is one block beyond the model."""
        cfg = self.cfg
        dtype = dtype_of(cfg.dtype)
        dev = generator.device
        params: Params = {
            "embed": {"table": embed_init(generator, cfg.padded_vocab_size,
                                          cfg.d_model, dtype)},
            "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
            "blocks": {},
        }
        for i, kind in enumerate(self.pattern):
            stacked = None
            for g in range(self.num_groups):
                tree = _block_init(generator, kind, cfg, dtype)
                if stacked is None:
                    stacked = tree_map(lambda t: torch.empty(
                        (self.num_groups,) + tuple(t.shape), dtype=t.dtype,
                        device=t.device), tree)
                _fill(stacked, tree, g)
                del tree
            params["blocks"][f"p{i}"] = stacked
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": embed_init(
                generator, cfg.padded_vocab_size, cfg.d_model, dtype)}
        return params

    def embed_inputs(self, params: Params,
                     inputs: torch.Tensor) -> torch.Tensor:
        """Token ids -> embeddings; float inputs (precomputed frontend
        embeddings) are cast to the model's type."""
        if not inputs.is_floating_point():
            return F.embedding(inputs, params["embed"]["table"])
        return inputs.to(dtype_of(self.cfg.dtype))

    def _group_fullseq(self, x: torch.Tensor, group_params: Params,
                       shared: Optional[Params], *, positions: torch.Tensor,
                       collect_cache: bool
                       ) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
        """One pattern group over the full sequence: (x, caches, aux)."""
        if collect_cache:
            raise NotImplementedError("KV caches (prefill for decode) are "
                                      "not ported yet")
        cfg = self.cfg
        for i, kind in enumerate(self.pattern):
            p = group_params[f"p{i}"]
            if kind == BLOCK_RWKV6:
                h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
                x = x + rwkv_mod.timemix_apply(p["time"], h, cfg,
                                               mode=self.rwkv_mode)
                h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
                x = x + rwkv_mod.channelmix_apply(p["channel"], h, cfg)
                continue
            window = cfg.sliding_window if kind == BLOCK_LOCAL_ATTN else 0
            h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
            x = x + attn.attn_apply(p["attn"], h, cfg, positions=positions,
                                    causal=True, window=window,
                                    impl=self.attn_impl)
            h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
            x = x + mlp_mod.mlp_apply(p["mlp"], h, cfg)
        return x, {}, torch.zeros((), device=x.device)
