"""Decoder-only LM (``repro.models.transformer``): the offline embedding
path, the LM judge's forward and the decode path.

Params layout, as in the JAX package (leaves stacked over the
``num_groups`` repeats of ``cfg.block_pattern``):
  embed.table           (V, d)
  blocks.p<i>.*         per pattern position i: norm1, attn, norm2, and
                        mlp or, in an MoE model, moe (attention blocks),
                        norm1, time, norm2, channel (rwkv6 blocks),
                        norm1, mamba (mamba2 blocks), or nothing (a
                        shared block: its weights are ``shared``)
  shared.*              the Zamba2-style shared attention block (norm1,
                        attn, norm2, mlp), drawn once, when the pattern
                        has ``shared`` positions
  final_norm.scale
  lm_head.w             (V, d) unless cfg.tie_embeddings
Caches (decode) mirror the block layout, as in the JAX package:
``cache["p<i>"]`` leaves stacked over groups, {k, v} at attention
positions (a shared block's application at each depth keeps its own),
{ssm, conv} at mamba2 positions and {wkv, shift_t, shift_c} at rwkv6
positions, so a JAX cache carried by ``models.params_from_jax`` reads as
the port's.
Attention blocks (``attn``, ``local``: global and sliding-window) with
the dense MLP or the MoE (``models.moe``, ``moe_dispatch`` picking its
dispatch), RWKV6 blocks, Mamba2 blocks (``models.ssm``) and the shared
attention block are ported, so the model runs llama3-8b, smollm-360m,
codeqwen1.5-7b, gemma3-12b (five ``local`` layers of window 1024 a
global one, head_dim 240), internvl2-1b (float inputs are the stubbed
vision frontend's patch embeddings), rwkv6-7b, qwen3-moe-30b-a3b,
dbrx-132b and zamba2-2.7b (five mamba2 layers a shared one, head_dim
80); an encoder-decoder config raises ``NotImplementedError`` here
(``build_model`` gives it ``models.encdec.EncDecLM``). An unknown
block kind raises ``ValueError``. ``forward`` returns the MoE
auxiliary loss summed over the layers. ``loss_fn`` is the training
loss (cross-entropy plus ``router_aux_weight`` times the MoE auxiliary
loss) on a forward with gradients: ``forward``, ``hidden`` and
``prefill`` run under ``torch.inference_mode``, ``loss_fn`` does not,
and with ``cfg.remat == "full"`` it recomputes every block in the
backward (``torch.utils.checkpoint``, as ``jax.checkpoint`` does), so
only each block's input is kept. With DTensor params (a mesh of SPMD
ranks) ``prefill`` and ``decode_step`` run under ``no_grad`` instead
(``serving_context``), and their caches are DTensors
(``attention.prefill_kv_cache``, ``attn_decode``); an MoE block runs its
experts over the model axis (``moe.moe_apply_mesh``), and the embedding
table and the head are gathered over an FSDP shard of their width
(``common.whole_dim``). ``param_axes`` is the logical-axes
tree of the params (``sharding.rules``' input: the params' layout, each
leaf a tuple of names, a stacked leaf's first one None), and
``act_constraint``, None unless a launch plan sets it
(``launch.steps``), is applied to the hidden state at the start of each
pattern group, in the full-sequence passes and in decode, as in the JAX
package. ``causal_skip`` has no torch meaning (the flash kernel skips
the masked tiles itself).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.config import (BLOCK_ATTN, BLOCK_LOCAL_ATTN, BLOCK_MAMBA2,
                                BLOCK_RWKV6, BLOCK_SHARED_ATTN, ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (Params, cross_entropy, dtype_of,
                                       embed_init, resolve_partial,
                                       rmsnorm_apply, rmsnorm_axes,
                                       rmsnorm_init, tree_map, whole_dim)

ATTN_KINDS = (BLOCK_ATTN, BLOCK_LOCAL_ATTN, BLOCK_SHARED_ATTN)
BLOCK_KINDS = ATTN_KINDS + (BLOCK_MAMBA2, BLOCK_RWKV6)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's model does not run yet
    (``NotImplementedError``) and for a block kind no package knows
    (``ValueError``)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder model: TransformerLM runs "
            f"decoder-only ones; build_model gives it an EncDecLM")
    other = [k for k in cfg.block_pattern if k not in BLOCK_KINDS]
    if other:
        raise ValueError(f"unknown block kinds {other}; one of "
                         f"{BLOCK_KINDS}")
    if cfg.num_layers % len(cfg.block_pattern):
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} % "
                         f"pattern {len(cfg.block_pattern)} != 0")


def kernel_layers(cfg: ModelConfig) -> int:
    """Layers whose full-sequence pass launches the model's kernel once:
    every RWKV6 layer (WKV6), else every attention layer (flash; a shared
    block's every application). Mamba2 blocks launch none."""
    kinds = cfg.layer_kinds()
    if BLOCK_RWKV6 in kinds:
        return kinds.count(BLOCK_RWKV6)
    return sum(k in ATTN_KINDS for k in kinds)


def _block_init(generator, kind: str, cfg: ModelConfig, dtype) -> Params:
    dev = generator.device
    if kind in (BLOCK_ATTN, BLOCK_LOCAL_ATTN):
        p: Params = {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
                     "attn": attn.attn_init(generator, cfg, dtype),
                     "norm2": rmsnorm_init(cfg.d_model, dtype, dev)}
        if cfg.moe.enabled:
            p["moe"] = moe_mod.moe_init(generator, cfg, dtype)
        else:
            p["mlp"] = mlp_mod.mlp_init(generator, cfg, dtype)
        return p
    if kind == BLOCK_MAMBA2:
        return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
                "mamba": ssm_mod.mamba_init(generator, cfg, dtype)}
    if kind == BLOCK_RWKV6:
        return {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
                "time": rwkv_mod.timemix_init(generator, cfg, dtype),
                "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
                "channel": rwkv_mod.channelmix_init(generator, cfg, dtype)}
    if kind == BLOCK_SHARED_ATTN:
        return {}  # weights live in params["shared"]
    raise ValueError(kind)


def _block_axes(kind: str, cfg: ModelConfig) -> Params:
    if kind in (BLOCK_ATTN, BLOCK_LOCAL_ATTN):
        p: Params = {"norm1": rmsnorm_axes(), "attn": attn.attn_axes(cfg),
                     "norm2": rmsnorm_axes()}
        if cfg.moe.enabled:
            p["moe"] = moe_mod.moe_axes(cfg)
        else:
            p["mlp"] = mlp_mod.mlp_axes(cfg)
        return p
    if kind == BLOCK_MAMBA2:
        return {"norm1": rmsnorm_axes(), "mamba": ssm_mod.mamba_axes(cfg)}
    if kind == BLOCK_RWKV6:
        return {"norm1": rmsnorm_axes(), "time": rwkv_mod.timemix_axes(cfg),
                "norm2": rmsnorm_axes(),
                "channel": rwkv_mod.channelmix_axes(cfg)}
    if kind == BLOCK_SHARED_ATTN:
        return {}
    raise ValueError(kind)


def _shared_axes(cfg: ModelConfig) -> Params:
    return {"norm1": rmsnorm_axes(), "attn": attn.attn_axes(cfg),
            "norm2": rmsnorm_axes(), "mlp": mlp_mod.mlp_axes(cfg)}


def prepend_axis(tree, name=None):
    """Prepend a logical axis (default replicated) to every axes-tuple
    leaf of a dictionary tree."""
    return tree_map(lambda t: (name,) + t, tree)


def _shared_init(generator, cfg: ModelConfig, dtype) -> Params:
    """The shared attention block: drawn once, applied at every
    ``shared`` position (always the dense MLP)."""
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


def draw_stacked(n: int, draw) -> Params:
    """``n`` trees of ``draw()``, drawn one at a time and copied into
    leaves stacked over a leading axis of ``n``: the peak is one tree
    beyond the stack."""
    stacked = None
    for g in range(n):
        tree = draw()
        if stacked is None:
            stacked = tree_map(lambda t: torch.empty(
                (n,) + tuple(t.shape), dtype=t.dtype, device=t.device), tree)
        _fill(stacked, tree, g)
        del tree
    return stacked


def lm_logits(cfg: ModelConfig, final_norm: Params, table: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the product with the head ``table`` (V, d) in the
    model's type, cast to float32 after it (bf16 rounds before the cast,
    as the JAX package's einsum does), padded vocab ids set to -1e30.
    x: (b, s, d) -> (b, s, padded_vocab) float32."""
    x = rmsnorm_apply(final_norm, x, cfg.norm_eps)
    b, s, d = x.shape
    out = (x.reshape(b * s, d) @ table.T).reshape(b, s, -1).float()
    if cfg.padded_vocab_size != cfg.vocab_size:
        ids = torch.arange(cfg.padded_vocab_size, device=x.device)
        out = torch.where(ids < cfg.vocab_size, out,
                          torch.full_like(out, -1e30))
    return out


def remat_wrap(enabled: bool):
    """``jax.checkpoint`` for a block: with ``enabled`` and grad mode on,
    the block's activations are not kept but recomputed in the backward
    (non-reentrant ``torch.utils.checkpoint``); else the block as it
    is. The blocks draw no random numbers, so no RNG state is stashed
    for the recompute (the stash would be device-specific work)."""
    if not (enabled and torch.is_grad_enabled()):
        return lambda f: f
    return lambda f: (lambda *args: checkpoint(f, *args,
                                               use_reentrant=False,
                                               preserve_rng_state=False))


def serving_context(params: Params):
    """The context a serving call runs in: ``torch.inference_mode`` for
    params on one device. For DTensor params (a mesh of SPMD ranks)
    ``torch.no_grad``, because under inference mode DTensor's view
    operators (``t[g]`` of a stacked leaf, a slice, a transpose) of a
    tensor made outside it raise ("Cannot set version_counter for
    inference tensor": ``tools/gloo_probe.py --ops``, ``select_dim0``),
    with plain tensors (positions, masks, tokens) taken as replicated.
    Both modes compute the same values."""
    if not isinstance(params["embed"]["table"], DTensor):
        return torch.inference_mode()
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(torch.no_grad())
    stack.enter_context(implicit_replication())
    return stack


def serving_mode(fn):
    """A serving method (``prefill``, ``decode_step``) run in
    ``serving_context`` of its params."""
    @functools.wraps(fn)
    def run(self, params, *args, **kwargs):
        with serving_context(params):
            return fn(self, params, *args, **kwargs)
    return run


def group_params(params: Params, g: int) -> Params:
    """The params of pattern group ``g``: views of the stacked leaves."""
    return tree_map(lambda t: t[g], params["blocks"])


def stack_trees(trees: List[Params]) -> Params:
    """Trees of one layout (a group's, a layer's) -> one tree of leaves
    stacked over a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


class TransformerLM:
    """Decoder-only LM over a pattern of attention, shared-attention,
    Mamba2 and RWKV6 blocks.

    ``attn_impl`` picks the attention path (``models.attention.IMPLS``),
    ``rwkv_mode`` the time-mix path (``models.rwkv.MODES``); the defaults
    are the hand-written kernels. ``moe_dispatch`` picks an MoE model's
    dispatch (``models.moe.DISPATCH_IMPLS``; "onehot", the JAX package's
    default). Decode steps run in plain PyTorch (no kernel), as in the
    JAX package. ``causal_skip`` is accepted, as the JAX package's
    constructor takes it, and ignored: it selects static triangular KV
    extents for XLA's blocked attention, and the flash kernel skips the
    masked tiles itself. Every method runs where the params lie."""

    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "flash",
                 rwkv_mode: str = "kernel", causal_skip: bool = False,
                 moe_dispatch: str = "onehot"):
        del causal_skip
        check_supported(cfg)
        rwkv_mod.check_mode(rwkv_mode)
        moe_mod.check_dispatch(moe_dispatch)
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.rwkv_mode = rwkv_mode
        self.moe_dispatch = moe_dispatch
        self.pattern = cfg.block_pattern
        self.num_groups = cfg.num_layers // len(cfg.block_pattern)
        self.has_shared = BLOCK_SHARED_ATTN in self.pattern
        self.takes_embeds = cfg.frontend != "none"
        # serving option: prefill computes logits at the last position
        # only (decode needs no others)
        self.prefill_last_only = False
        # set by a launch plan (launch.steps): applied to the hidden state
        # at each pattern group's start
        self.act_constraint = None

    def init(self, generator: torch.Generator) -> Params:
        """Random params drawn on ``generator`` and on its device. Each
        group's block is drawn on its own and copied into the stacked
        leaves, so the peak is one block beyond the model. A shared
        block's weights are drawn once, after the blocks."""
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
            params["blocks"][f"p{i}"] = draw_stacked(
                self.num_groups,
                lambda: _block_init(generator, kind, cfg, dtype))
        if self.has_shared:
            params["shared"] = _shared_init(generator, cfg, dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": embed_init(
                generator, cfg.padded_vocab_size, cfg.d_model, dtype)}
        return params

    def param_axes(self) -> Params:
        """The params' logical axes, leaf for leaf."""
        cfg = self.cfg
        axes: Params = {
            "embed": {"table": ("vocab", "fsdp_embed")},
            "final_norm": rmsnorm_axes(),
            "blocks": {},
        }
        for i, kind in enumerate(self.pattern):
            axes["blocks"][f"p{i}"] = prepend_axis(_block_axes(kind, cfg))
        if self.has_shared:
            axes["shared"] = _shared_axes(cfg)
        if not cfg.tie_embeddings:
            axes["lm_head"] = {"w": ("vocab", "fsdp_embed")}
        return axes

    def _constrained(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.act_constraint is None else self.act_constraint(x)

    def embed_inputs(self, params: Params,
                     inputs: torch.Tensor) -> torch.Tensor:
        """Token ids -> embeddings; float inputs (precomputed frontend
        embeddings) are cast to the model's type. From a DTensor table
        sharded over the vocabulary the lookup's partial sums are
        reduced at once, keeping the rows' placement; a table sharded
        over its width (FSDP's ``"fsdp_embed": "data"``) is gathered
        there first."""
        if not inputs.is_floating_point():
            return resolve_partial(F.embedding(
                inputs, whole_dim(params["embed"]["table"], 1)))
        return inputs.to(dtype_of(self.cfg.dtype))

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``lm_logits`` with the tied or separate head (gathered over its
        width where FSDP shards it); a DTensor hidden state goes through
        ``act_constraint`` first."""
        table = whole_dim(params["embed"]["table"] if self.cfg.tie_embeddings
                          else params["lm_head"]["w"], 1)
        if isinstance(x, DTensor):
            # pinned as at a group's start, so that the head's product
            # gives logits sharded over the vocabulary, not partial sums
            x = self._constrained(x)
        return lm_logits(self.cfg, params["final_norm"], table, x)

    def _group_fullseq(self, x: torch.Tensor, group_params: Params,
                       shared: Optional[Params], *, positions: torch.Tensor,
                       collect_cache: bool, cache_len: int = 0,
                       remat: bool = False
                       ) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
        """One pattern group over the full sequence: (x, caches, aux),
        aux the group's MoE auxiliary losses summed (float32 zero without
        MoE). With ``collect_cache`` the caches are this group's decode
        state (an attention layer's K/V in a cache of ``cache_len`` slots,
        0 = the prompt's length; an rwkv6 or mamba2 block's final state).
        A shared position runs the attention body on ``shared``. With
        ``remat`` (and no caches to collect) each block is recomputed in
        the backward (``remat_wrap``)."""
        cfg = self.cfg
        caches: Dict[str, Any] = {}
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        wrap = remat_wrap(remat and not collect_cache)
        for i, kind in enumerate(self.pattern):
            key = f"p{i}"
            p = group_params.get(key, {})
            if kind in ATTN_KINDS:
                if kind == BLOCK_SHARED_ATTN:
                    p = shared
                window = cfg.sliding_window if kind == BLOCK_LOCAL_ATTN else 0

                def attn_block(x, p, window=window):
                    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
                    y, kv = attn.attn_apply(p["attn"], h, cfg,
                                            positions=positions, causal=True,
                                            window=window,
                                            impl=self.attn_impl,
                                            kv_out=collect_cache)
                    x = x + y
                    h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
                    aux = None
                    if "moe" in p:
                        y, aux = moe_mod.moe_apply(p["moe"], h, cfg,
                                                   self.moe_dispatch)
                    else:
                        y = mlp_mod.mlp_apply(p["mlp"], h, cfg)
                    return x + y, kv, aux

                x, kv, aux = wrap(attn_block)(x, p)
                if aux is not None:
                    aux_total = aux_total + aux
                if collect_cache:
                    caches[key] = attn.prefill_kv_cache(
                        cfg, kv, cache_len or x.shape[1], window)
            elif kind == BLOCK_MAMBA2:
                def mamba_block(x, p):
                    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
                    y = ssm_mod.mamba_apply(p["mamba"], h, cfg,
                                            return_state=collect_cache)
                    state = None
                    if collect_cache:
                        y, state = y
                    return x + y, state

                x, state = wrap(mamba_block)(x, p)
                if collect_cache:
                    caches[key] = state
            elif kind == BLOCK_RWKV6:
                def rwkv_block(x, p):
                    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
                    y = rwkv_mod.timemix_apply(p["time"], h, cfg,
                                               mode=self.rwkv_mode,
                                               return_state=collect_cache)
                    state = None
                    if collect_cache:
                        y, state = y
                    x = x + y
                    h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
                    if collect_cache:
                        state["shift_c"] = h[:, -1]
                    return x + rwkv_mod.channelmix_apply(p["channel"], h,
                                                         cfg), state

                x, state = wrap(rwkv_block)(x, p)
                if collect_cache:
                    caches[key] = state
            else:
                raise ValueError(kind)
        return x, caches, aux_total

    def _run_groups(self, params: Params, inputs: torch.Tensor, *,
                    collect_cache: bool, cache_len: int = 0,
                    remat: bool = False):
        """Every group over the full sequence: (hidden (b, s, d), the
        caches stacked over groups, or None, the MoE auxiliary loss summed
        over the groups)."""
        inputs = torch.as_tensor(inputs,
                                 device=params["embed"]["table"].device)
        x = self.embed_inputs(params, inputs)
        positions = torch.arange(x.shape[1], device=x.device)
        shared = params.get("shared")
        caches, auxes = [], []
        for g in range(self.num_groups):
            x = self._constrained(x)
            x, c, aux = self._group_fullseq(x, group_params(params, g),
                                            shared, positions=positions,
                                            collect_cache=collect_cache,
                                            cache_len=cache_len, remat=remat)
            caches.append(c)
            auxes.append(aux)
        return (x, (stack_trees(caches) if collect_cache else None),
                torch.stack(auxes).sum())

    def loss_fn(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """The training loss on ``batch`` ({"tokens" or, for a model with
        a frontend, "embeds"; "labels"; an optional "mask"}): the
        cross-entropy of the teacher-forced logits plus
        ``router_aux_weight`` times the MoE auxiliary loss, a 0-d float32
        tensor with its graph. Not under ``inference_mode``: gradients
        flow to every param that requires one, through the flash kernel's
        autograd Function on the kernel path; with ``cfg.remat ==
        "full"`` each block is recomputed in the backward."""
        inputs = batch["embeds"] if self.takes_embeds else batch["tokens"]
        x, _, aux = self._run_groups(params, inputs, collect_cache=False,
                                     remat=self.cfg.remat == "full")
        logits = self.logits(params, x)
        dev = logits.device
        loss = cross_entropy(logits,
                             torch.as_tensor(batch["labels"], device=dev),
                             batch.get("mask"))
        return loss + self.cfg.moe.router_aux_weight * aux

    @torch.inference_mode()
    def hidden(self, params: Params, inputs: torch.Tensor) -> torch.Tensor:
        """The last block's output (b, s, d), before the final norm:
        ``forward``'s logits are ``logits(params, hidden(...))``."""
        return self._run_groups(params, inputs, collect_cache=False)[0]

    @torch.inference_mode()
    def forward(self, params: Params, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward: (logits (b, s, V) float32, aux), aux the
        MoE auxiliary loss summed over the layers (zero without MoE)."""
        x, _, aux = self._run_groups(params, inputs, collect_cache=False)
        return self.logits(params, x), aux

    @serving_mode
    def prefill(self, params: Params, inputs: torch.Tensor,
                cache_len: int = 0) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process a prompt: (logits, cache stacked over groups).
        ``cache_len`` is the KV caches' capacity (>= the prompt's length)
        so decode can go on past the prompt; 0 = the prompt's length.
        With ``prefill_last_only`` the logits are the last position's,
        (b, 1, V)."""
        x, cache, _ = self._run_groups(params, inputs, collect_cache=True,
                                       cache_len=cache_len)
        if self.prefill_last_only:
            x = x[:, -1:]
        return self.logits(params, x), cache

    # -- decode ------------------------------------------------------------
    def cache_spec(self, batch: int, seq_len: int
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(tree of meta tensors of the cache's shapes and types, tree of
        logical axes), stacked over groups."""
        cfg = self.cfg
        dtype = dtype_of(cfg.dtype)
        spec: Dict[str, Any] = {}
        axes: Dict[str, Any] = {}
        for i, kind in enumerate(self.pattern):
            if kind in ATTN_KINDS:
                # a shared block's every application: a full cache
                window = cfg.sliding_window if kind == BLOCK_LOCAL_ATTN else 0
                s, a = attn.kv_cache_spec(cfg, batch, seq_len, window, dtype)
            elif kind == BLOCK_MAMBA2:
                s, a = ssm_mod.mamba_state_spec(cfg, batch, dtype)
            elif kind == BLOCK_RWKV6:
                s, a = rwkv_mod.rwkv_state_spec(cfg, batch, dtype)
            else:
                raise ValueError(kind)
            spec[f"p{i}"] = tree_map(lambda t: torch.empty(
                (self.num_groups,) + tuple(t.shape), dtype=t.dtype,
                device="meta"), s)
            axes[f"p{i}"] = {k: (None,) + v for k, v in a.items()}
        return spec, axes

    def init_cache(self, batch: int, seq_len: int,
                   device="cuda") -> Dict[str, Any]:
        """A zero cache of ``cache_spec``'s shapes on ``device``."""
        dev = resolve_device(device)
        spec, _ = self.cache_spec(batch, seq_len)
        return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=dev), spec)

    @serving_mode
    def decode_step(self, params: Params, inputs: torch.Tensor,
                    pos: Union[int, torch.Tensor], cache: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """inputs: tokens (b, 1) (or embeddings (b, 1, d)); ``pos`` the
        token's position, a Python int or a 0-d tensor (a Python int or a
        tensor on the params' device costs no host sync:
        ``attention.position_on``). Returns (logits (b, 1, V) float32,
        the new cache); the input cache is not changed."""
        cfg = self.cfg
        dev = params["embed"]["table"].device
        x = self.embed_inputs(params, torch.as_tensor(inputs, device=dev))
        pos = attn.position_on(pos, dev)
        shared = params.get("shared")
        new_caches = []
        for g in range(self.num_groups):
            x = self._constrained(x)
            gp = group_params(params, g)
            new: Dict[str, Any] = {}
            for i, kind in enumerate(self.pattern):
                key = f"p{i}"
                p = gp.get(key, {})
                c = tree_map(lambda t: t[g], cache[key])
                if kind in ATTN_KINDS:
                    if kind == BLOCK_SHARED_ATTN:
                        p = shared
                    window = (cfg.sliding_window
                              if kind == BLOCK_LOCAL_ATTN else 0)
                    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
                    y, nc = attn.attn_decode(p["attn"], h, cfg, pos=pos,
                                             cache=c, window=window)
                    x = x + y
                    h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
                    if "moe" in p:
                        # b tokens, one chunk
                        y, _ = moe_mod.moe_apply(p["moe"], h, cfg,
                                                 self.moe_dispatch)
                    else:
                        y = mlp_mod.mlp_apply(p["mlp"], h, cfg)
                elif kind == BLOCK_MAMBA2:
                    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
                    y, nc = ssm_mod.mamba_decode(p["mamba"], h, cfg, state=c)
                elif kind == BLOCK_RWKV6:
                    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
                    y, nc = rwkv_mod.timemix_decode(p["time"], h, cfg,
                                                    state=c)
                    x = x + y
                    h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
                    y, nc = rwkv_mod.channelmix_decode(p["channel"], h, cfg,
                                                       state=nc)
                else:
                    raise ValueError(kind)
                x = x + y
                new[key] = nc
            new_caches.append(new)
        return self.logits(params, x), stack_trees(new_caches)
