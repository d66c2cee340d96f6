"""Whisper-style encoder-decoder LM (``repro.models.encdec``).

The audio frontend (a conv stem over mel spectrograms) is a stub, as in
the JAX package: the encoder's input is precomputed frame embeddings
(b, s, d). Sinusoidal absolute positions are added to the encoder's
frames and the decoder's token embeddings, computed in float32 and cast
to the model's type before the add; no layer rotates Q or K.

Params layout, as in the JAX package (leaves stacked over the layers):
  embed.table           (V, d), tied: the logits use it
  encoder.*             norm1, attn, norm2, mlp (``encoder_d_ff`` wide)
  enc_norm.scale
  decoder.*             norm1, self_attn, norm2, cross_attn, norm3, mlp
  final_norm.scale
The norms are RMSNorm and ``act="gelu"`` is tanh GELU, as in the JAX
package (not Whisper's LayerNorm). The encoder's attention is
non-causal, the decoder's self-attention causal, both through
``attn_impl``; the cross-attention always through the flash entry
(``attention.cross_attn_apply``). The decode cache is
{"self": {k, v}, "cross": {k, v}}, each (L, b, S, kv_heads, head_dim):
``prefill``'s self cache is as long as the prompt, so a step past it
writes to the last slot, as in the JAX package. ``loss_fn`` is the
training loss, the cross-entropy of the teacher-forced logits, on a
forward with gradients (the entries above run under
``torch.inference_mode``); with ``cfg.remat == "full"`` every encoder
layer and decoder layer is recomputed in the backward, as
``jax.checkpoint`` does. ``param_axes`` is the params' logical-axes
tree (``sharding.rules``); ``act_constraint``, None unless a launch plan
sets it (``launch.steps``), is applied to the hidden state at each
encoder and decoder layer's start in the full-sequence passes, as in
the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (Params, cross_entropy, dtype_of,
                                       embed_init, rmsnorm_apply,
                                       rmsnorm_axes, rmsnorm_init,
                                       sinusoidal_position_at,
                                       sinusoidal_positions, tree_map)
from repro_torch.models.transformer import (draw_stacked, lm_logits,
                                            prepend_axis, remat_wrap,
                                            stack_trees)


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s params (or cache): views of the stacked leaves."""
    return tree_map(lambda t: t[i], params)


class EncDecLM:
    """Encoder-decoder LM over stubbed frame embeddings. ``attn_impl``
    picks the encoder's and the decoder's self-attention path
    (``models.attention.IMPLS``; "flash", the hand-written kernel, by
    default). Every other option ``build_model`` passes (``rwkv_mode``,
    ``causal_skip``, ``moe_dispatch``) is accepted and ignored, as in the
    JAX package: the family has no RWKV6 or MoE block, and the flash
    kernel skips masked tiles itself. Every method runs where the params
    lie."""

    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "flash",
                 **_unused):
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} has no encoder layers")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.takes_embeds = True   # the encoder's input: frame embeddings
        # set by a launch plan (launch.steps): applied to the hidden state
        # at each layer's start
        self.act_constraint = None

    def init(self, generator: torch.Generator) -> Params:
        """Random params drawn on ``generator`` and on its device, one
        layer at a time into the stacked leaves."""
        cfg = self.cfg
        dtype = dtype_of(cfg.dtype)
        dev = generator.device
        d = cfg.d_model

        def enc_block():
            return {"norm1": rmsnorm_init(d, dtype, dev),
                    "attn": attn.attn_init(generator, cfg, dtype),
                    "norm2": rmsnorm_init(d, dtype, dev),
                    "mlp": mlp_mod.mlp_init(generator, cfg, dtype,
                                            cfg.encoder_d_ff or cfg.d_ff)}

        def dec_block():
            return {"norm1": rmsnorm_init(d, dtype, dev),
                    "self_attn": attn.attn_init(generator, cfg, dtype),
                    "norm2": rmsnorm_init(d, dtype, dev),
                    "cross_attn": attn.cross_attn_init(generator, cfg, dtype),
                    "norm3": rmsnorm_init(d, dtype, dev),
                    "mlp": mlp_mod.mlp_init(generator, cfg, dtype)}

        return {
            "embed": {"table": embed_init(generator, cfg.padded_vocab_size,
                                          d, dtype)},
            "encoder": draw_stacked(cfg.encoder_layers, enc_block),
            "enc_norm": rmsnorm_init(d, dtype, dev),
            "decoder": draw_stacked(cfg.num_layers, dec_block),
            "final_norm": rmsnorm_init(d, dtype, dev),
        }

    def param_axes(self) -> Params:
        """The params' logical axes, leaf for leaf."""
        cfg = self.cfg
        enc = {"norm1": rmsnorm_axes(), "attn": attn.attn_axes(cfg),
               "norm2": rmsnorm_axes(), "mlp": mlp_mod.mlp_axes(cfg)}
        dec = {"norm1": rmsnorm_axes(), "self_attn": attn.attn_axes(cfg),
               "norm2": rmsnorm_axes(), "cross_attn": attn.attn_axes(cfg),
               "norm3": rmsnorm_axes(), "mlp": mlp_mod.mlp_axes(cfg)}
        return {
            "embed": {"table": ("vocab", "fsdp_embed")},
            "encoder": prepend_axis(enc),
            "enc_norm": rmsnorm_axes(),
            "decoder": prepend_axis(dec),
            "final_norm": rmsnorm_axes(),
        }

    def _constrained(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.act_constraint is None else self.act_constraint(x)

    def _with_positions(self, x: torch.Tensor) -> torch.Tensor:
        """x (b, s, d) plus the sinusoidal table, cast to x's type."""
        pe = sinusoidal_positions(x.shape[1], self.cfg.d_model, x.device)
        return x + pe.to(x.dtype)[None]

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return lm_logits(self.cfg, params["final_norm"],
                         params["embed"]["table"], x)

    # -- encoder ------------------------------------------------------------
    @torch.inference_mode()
    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (b, s, d) -> the encoder's output (b, s, d)
        in the model's type."""
        return self._encode(params, frames)

    def _encode(self, params: Params, frames: torch.Tensor,
                remat: bool = False) -> torch.Tensor:
        cfg = self.cfg
        dev = params["embed"]["table"].device
        x = torch.as_tensor(frames, device=dev).to(dtype_of(cfg.dtype))
        x = self._with_positions(x)
        positions = torch.arange(x.shape[1], device=dev)

        def body(x, p):
            h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
            x = x + attn.attn_apply(p["attn"], h, cfg, positions=positions,
                                    causal=False, impl=self.attn_impl,
                                    use_rope=False)[0]
            h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
            return x + mlp_mod.mlp_apply(p["mlp"], h, cfg)

        body = remat_wrap(remat)(body)
        for i in range(cfg.encoder_layers):
            x = body(self._constrained(x), _layer(params["encoder"], i))
        return rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)

    # -- decoder, teacher-forced and prefill ----------------------------------
    def _decoder_fullseq(self, params: Params, enc_out: torch.Tensor,
                         tokens: torch.Tensor, collect_cache: bool,
                         remat: bool = False):
        """(logits (b, s, V) float32, the {"self", "cross"} cache stacked
        over the layers, or None)."""
        cfg = self.cfg
        dev = params["embed"]["table"].device
        tokens = torch.as_tensor(tokens, device=dev)
        x = self._with_positions(F.embedding(tokens,
                                             params["embed"]["table"]))
        positions = torch.arange(x.shape[1], device=dev)

        def body(x, p):
            h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
            y, kv = attn.attn_apply(p["self_attn"], h, cfg,
                                    positions=positions, causal=True,
                                    impl=self.attn_impl,
                                    kv_out=collect_cache, use_rope=False)
            x = x + y
            h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
            cross_kv = attn.encode_kv(p["cross_attn"], enc_out)
            x = x + attn.cross_attn_apply(p["cross_attn"], h, cfg,
                                          kv=cross_kv)
            h = rmsnorm_apply(p["norm3"], x, cfg.norm_eps)
            x = x + mlp_mod.mlp_apply(p["mlp"], h, cfg)
            return x, ({"self": kv, "cross": cross_kv} if collect_cache
                       else None)

        body = remat_wrap(remat and not collect_cache)(body)
        caches = []
        for i in range(cfg.num_layers):
            x, c = body(self._constrained(x), _layer(params["decoder"], i))
            if collect_cache:
                caches.append(c)
        return (self.logits(params, x),
                stack_trees(caches) if collect_cache else None)

    @torch.inference_mode()
    def forward(self, params: Params, frames: torch.Tensor,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward: (logits (b, s, V) float32, a 0-d
        float32 zero)."""
        enc_out = self.encode(params, frames)
        logits, _ = self._decoder_fullseq(params, enc_out, tokens, False)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def loss_fn(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """The cross-entropy of the teacher-forced logits on ``batch``
        ({"frames", "tokens", "labels", an optional "mask"}), a 0-d
        float32 tensor with its graph (``repro.models.encdec``'s
        ``loss_fn``)."""
        remat = self.cfg.remat == "full"
        enc_out = self._encode(params, batch["frames"], remat)
        logits, _ = self._decoder_fullseq(params, enc_out, batch["tokens"],
                                          False, remat)
        return cross_entropy(
            logits, torch.as_tensor(batch["labels"], device=logits.device),
            batch.get("mask"))

    @torch.inference_mode()
    def prefill(self, params: Params, frames: torch.Tensor,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(logits, {"self": the prompt's K/V, as long as the prompt,
        "cross": the encoder's K/V}), each stacked over the layers."""
        enc_out = self.encode(params, frames)
        return self._decoder_fullseq(params, enc_out, tokens, True)

    # -- decode ---------------------------------------------------------------
    def cache_spec(self, batch: int, seq_len: int
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(meta tensors of the cache's shapes and types, logical axes):
        "self" and "cross" each {k, v} of (L, batch, seq_len, kv_heads,
        head_dim)."""
        cfg = self.cfg
        s, a = attn.kv_cache_spec(cfg, batch, seq_len, 0,
                                  dtype_of(cfg.dtype))
        stack = lambda t: torch.empty((cfg.num_layers,) + tuple(t.shape),
                                      dtype=t.dtype, device="meta")
        axes = {k: (None,) + v for k, v in a.items()}
        return ({"self": tree_map(stack, s), "cross": tree_map(stack, s)},
                {"self": axes, "cross": dict(axes)})

    def init_cache(self, batch: int, seq_len: int,
                   device="cuda") -> Dict[str, Any]:
        """A zero cache of ``cache_spec``'s shapes on ``device``."""
        dev = resolve_device(device)
        spec, _ = self.cache_spec(batch, seq_len)
        return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=dev), spec)

    @torch.inference_mode()
    def decode_step(self, params: Params, tokens: torch.Tensor,
                    pos: Union[int, torch.Tensor], cache: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens (b, 1) at position ``pos`` (a Python int or a 0-d tensor;
        ``attention.position_on``, no host sync) -> (logits (b, 1, V)
        float32, the new cache: "self" updated, "cross" the input's). The
        input cache is not changed."""
        cfg = self.cfg
        dev = params["embed"]["table"].device
        tokens = torch.as_tensor(tokens, device=dev)
        x = F.embedding(tokens, params["embed"]["table"])
        pos = attn.position_on(pos, dev)
        x = x + sinusoidal_position_at(pos, cfg.d_model).to(x.dtype)
        new_self = []
        for i in range(cfg.num_layers):
            p = _layer(params["decoder"], i)
            h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
            y, nc = attn.attn_decode(p["self_attn"], h, cfg, pos=pos,
                                     cache=_layer(cache["self"], i),
                                     use_rope=False)
            x = x + y
            h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
            x = x + attn.cross_attn_decode(p["cross_attn"], h, cfg,
                                           kv=_layer(cache["cross"], i))
            h = rmsnorm_apply(p["norm3"], x, cfg.norm_eps)
            x = x + mlp_mod.mlp_apply(p["mlp"], h, cfg)
            new_self.append(nc)
        return self.logits(params, x), {"self": stack_trees(new_self),
                                        "cross": cache["cross"]}
