"""Decoder-only LM for the offline embedding path
(``repro.models.transformer``).

Params layout, as in the JAX package (leaves stacked over the
``num_groups`` repeats of ``cfg.block_pattern``):
  embed.table           (V, d)
  blocks.p<i>.*         per pattern position i: norm1, attn, norm2, mlp
  final_norm.scale
  lm_head.w             (V, d) unless cfg.tie_embeddings
Only attention blocks (``attn``, ``local``) with the dense MLP are
ported; MoE, mamba2, rwkv6 and shared-attention blocks raise
``NotImplementedError``, as do decode and KV caches.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import BLOCK_ATTN, BLOCK_LOCAL_ATTN, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (Params, dtype_of, embed_init,
                                       rmsnorm_apply, rmsnorm_init, tree_map)

ATTN_KINDS = (BLOCK_ATTN, BLOCK_LOCAL_ATTN)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's model does not run yet."""
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported")
    if cfg.moe.enabled:
        raise NotImplementedError("MoE blocks are not ported")
    other = [k for k in cfg.block_pattern if k not in ATTN_KINDS]
    if other:
        raise NotImplementedError(f"block kinds {other} are not ported; "
                                  f"only {ATTN_KINDS}")
    if cfg.num_layers % len(cfg.block_pattern):
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} % "
                         f"pattern {len(cfg.block_pattern)} != 0")


def _block_init(generator, cfg: ModelConfig, dtype) -> Params:
    dev = generator.device
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
    """Decoder-only LM over a pattern of attention blocks."""

    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "flash"):
        check_supported(cfg)
        self.cfg = cfg
        self.attn_impl = attn_impl
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
        for i in range(len(self.pattern)):
            stacked = None
            for g in range(self.num_groups):
                tree = _block_init(generator, cfg, dtype)
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
            window = cfg.sliding_window if kind == BLOCK_LOCAL_ATTN else 0
            h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
            x = x + attn.attn_apply(p["attn"], h, cfg, positions=positions,
                                    causal=True, window=window,
                                    impl=self.attn_impl)
            h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
            x = x + mlp_mod.mlp_apply(p["mlp"], h, cfg)
        return x, {}, torch.zeros((), device=x.device)
