"""Cell plans (``repro.launch.steps``): the step function and its
sharding for one (arch x shape x mesh) cell.

``make_plan`` builds, for a cell:
  * the step function: ``train_step(state, batch) -> ((params,
    opt_state), {"loss", "grad_norm", "lr"})``, ``prefill_step(params,
    batch) -> (the last position's logits, cache)`` or
    ``decode_step(params, batch) -> (logits, cache)``;
  * ``arg_sds``: every argument as meta tensors (shapes and types, no
    storage: ``models.common.param_specs``, ``models.input_specs``);
  * the arguments' and outputs' ``NamedSharding`` trees, resolved through
    the logical-axis rules (``rules_for``: FSDP weight sharding for the
    multi-billion-parameter archs, KV-sequence sharding for decode cells
    whose batch or KV heads cannot fill the mesh).

The plan's model is ``build_model_for_scale``'s: the flash attention
(the hand-written kernel on the card) and the factored WKV6
(``rwkv_mode="factored"``), with ``act_constraint`` and, for the
duration of each step, the blocks' ``common.constrain`` hook resolving
the rules (recording divisibility fallbacks in the plan's ``ruleset``)
and redistributing a DTensor to the resolved placements (a plain
tensor passes through). A step runs on its mesh's one device, or on a
mesh of SPMD processes (``launch.mesh``: a ``DeviceMesh`` over the
world, any (data, model) shape), for the dense, MoE and RWKV6 families
(an MoE model's experts over the model axis,
``models.moe.moe_apply_mesh``; a microbatch routes its own dispatch
chunks, as the JAX package's scan does; an RWKV6 model's factored
recurrence on each rank's heads, ``models.rwkv.recurrence``, the decode
state's heads replicated over "model" as the JAX package lays it out):
there each step
places the params by its ``arg_shardings`` and runs on DTensors (each
rank its shards) inside ``spmd_context``. The train step places the
AdamW state as its params and the batch by the input shardings; the
prefill step places the tokens by the input shardings and returns the
last logits (sharded over the vocabulary) and the cache placed by its
``out_shardings``; the decode step takes replicated tokens and position
and moves the cache into its ``kv_seq`` layout on entry (one
redistribute from the prefill plan's, which has no ``kv_seq`` rule), and
returns the logits and the cache in that layout. The other families'
steps on such a mesh raise ``NotImplementedError`` naming the slices that
will take them (``device.FAMILY_SLICE``). A mesh of more than one device
from one controller (the production meshes are abstract) gives the
plan's specs and shardings, and its step on real tensors raises. On meta
tensors (the plan's own ``arg_sds``) a step traces over any mesh,
abstract ones included, resolving every constraint (recording its
fallbacks) and placing nothing: the dry run (``launch.dryrun``) counts
it so. A meta AdamW
step has no value to read on the host; the update's host arithmetic
(learning rate, bias corrections) then takes step 0, which changes no
operation the step runs. The train step accumulates the gradient
over ``microbatches`` contiguous row blocks of the batch in float32, in
block order, as the JAX package's scan does (each block placed by the
input shardings of its own shape), then applies AdamW
(``optimizer.adamw.apply_updates``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config.base import InputShape, ModelConfig, OptimizerConfig
from repro_torch.device import FAMILY_SLICE, SPMD_FAMILIES, check_one_device
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import MULTI_CARD
from repro_torch.models import build_model, input_axes, input_specs
from repro_torch.models.common import (constrainer, full_value,
                                       param_specs, tree_map)
from repro_torch.optimizer import adamw
from repro_torch.runtime.train_loop import grad_tree
from repro_torch.sharding.rules import (DEFAULT_RULES, NamedSharding, P,
                                        RuleSet, place, placements,
                                        tree_shardings)

# archs whose weights + optimizer state need ZeRO/FSDP sharding over `data`
FSDP_PARAM_THRESHOLD = 3e9


def needs_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count() > FSDP_PARAM_THRESHOLD


def rules_for(cfg: ModelConfig, shape: InputShape, mesh,
              overrides: Optional[Dict] = None) -> RuleSet:
    rules = dict(DEFAULT_RULES)
    if needs_fsdp(cfg):
        rules["embed"] = "data"       # FSDP: weight embed dims over data
        rules["fsdp_embed"] = "data"
        rules["expert_mlp"] = None
    if shape.kind == "decode":
        kv_axes = []
        if shape.global_batch < mesh.shape.get("data", 1):
            # long-context decode: the batch cannot fill the data axis, so
            # the KV cache's sequence dim takes it (flash-decoding layout)
            kv_axes.append("data")
        if cfg.num_kv_heads % mesh.shape.get("model", 1) != 0:
            # KV heads cannot split the model axis: spread the cache over
            # the sequence instead of replicating it on every device
            kv_axes.append("model")
        if kv_axes:
            rules["kv_seq"] = tuple(kv_axes)
    if overrides:
        rules.update(overrides)
    return RuleSet(mesh, rules)


def shardings_for_tree(ruleset: RuleSet, axes_tree, sds_tree):
    return tree_shardings(ruleset, axes_tree, sds_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


@dataclasses.dataclass
class CellPlan:
    """Everything needed to run one (arch x shape x mesh) cell."""
    step_fn: Callable
    arg_sds: Tuple
    arg_shardings: Tuple
    out_shardings: Any
    ruleset: RuleSet
    description: str


def _mesh_size(mesh) -> int:
    return math.prod(mesh.shape.values())


def _resolver(ruleset: RuleSet) -> Callable:
    """The plan's constraint: resolve ``logical_axes`` against the mesh
    (recording fallbacks) and redistribute a DTensor there; a plain
    tensor is returned as it is (on one device; on a mesh of SPMD ranks,
    where it is a rank's local piece, without resolving; on a mesh of
    more from one controller a real one raises)."""
    spmd = getattr(ruleset.mesh, "device_mesh", None) is not None

    def constrain(x, logical_axes):
        if spmd and not isinstance(x, DTensor):
            # a rank's local piece (a recurrence on its own heads): as it
            # is, and its local shape records no fallback
            return x
        sh = ruleset.sharding(logical_axes, x.shape)
        if isinstance(x, DTensor):
            return x.redistribute(x.device_mesh, placements(sh, x.shape))
        if (_mesh_size(ruleset.mesh) > 1 and not x.is_meta
                and getattr(ruleset.mesh, "device_mesh", None) is None):
            raise NotImplementedError(f"{dict(ruleset.mesh.shape)}: "
                                      f"{MULTI_CARD}")
        return x
    return constrain


def spmd_context(mesh, resolve: Callable):
    """The context a step runs in: the blocks' constraints resolved and,
    on a mesh of SPMD processes, plain tensors (positions, masks,
    scalars) taken as replicated beside DTensors."""
    stack = contextlib.ExitStack()
    stack.enter_context(constrainer(resolve))
    if getattr(mesh, "device_mesh", None) is not None:
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        stack.enter_context(implicit_replication())
    return stack


def _refuse_spmd(what: str, cfg: ModelConfig, mesh, params) -> None:
    """The steps left to later slices, on a mesh of SPMD processes of
    more than one device: every plan of a family outside
    ``device.SPMD_FAMILIES``."""
    if not _spmd(mesh, params):
        return
    if cfg.family not in SPMD_FAMILIES:
        check_one_device(f"the {what} plan of {cfg.name} (family "
                         f"{cfg.family!r})", mesh, waits_for=FAMILY_SLICE)


def _spmd(mesh, params) -> bool:
    """Whether a step places its arguments: real params on a mesh of
    SPMD processes (meta params, the dry run's, are counted unplaced)."""
    return (getattr(mesh, "device_mesh", None) is not None
            and not _is_meta(params))


def _is_meta(params) -> bool:
    return params["embed"]["table"].is_meta


def build_model_for_scale(cfg: ModelConfig, causal_skip: bool = False,
                          ruleset: Optional[RuleSet] = None,
                          moe_dispatch: str = "onehot"):
    """The model with the large-scale strategies selected: flash
    attention (recomputed in the backward) and the factored WKV6, and,
    with ``ruleset``, the activation constraint at every group's start.
    ``causal_skip`` is accepted and has no torch meaning: the flash
    kernel skips the masked tiles itself."""
    del causal_skip
    kw = {} if cfg.is_encdec else {"rwkv_mode": "factored",
                                   "moe_dispatch": moe_dispatch}
    model = build_model(cfg, attn_impl="flash", **kw)
    if ruleset is not None:
        resolve = _resolver(ruleset)
        model.act_constraint = lambda x: resolve(x, ("batch", "seq", None))
    return model


# target tokens per device per microbatch: bounds live activation memory
MICROBATCH_TOKENS_PER_DEVICE = 16384


def default_microbatches(shape: InputShape, mesh,
                         cfg: Optional[ModelConfig] = None) -> int:
    data_ways = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    local_tokens = shape.global_batch * shape.seq_len // max(data_ways, 1)
    k = max(1, local_tokens // MICROBATCH_TOKENS_PER_DEVICE)
    if cfg is not None and cfg.param_count() > 5e10:
        # 100B-class: halve live activations again
        k *= 2
    while k > 1 and shape.global_batch % k:
        k -= 1
    return k


def _device(mesh, params) -> torch.device:
    """The mesh's one device (a rank's own on a mesh of SPMD processes),
    which must hold the params; the meta device for meta params, on any
    mesh."""
    table = params["embed"]["table"]
    if table.is_meta:
        return table.device
    dev = mesh.device
    if isinstance(table, DTensor):
        table = table.to_local()
    if table.device.type != dev.type:
        raise ValueError(f"params are on {table.device}, the mesh on {dev}")
    return dev


def _value_and_grad(loss_fn, params, batch):
    """(loss, d loss / d every leaf of ``params``), as
    ``jax.value_and_grad``."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = loss_fn(live, batch)
    grads = grad_tree(loss, live)
    return loss.detach(), grads


def _place_batch(batch, cfg: ModelConfig, shape: InputShape,
                 rs: RuleSet):
    """A batch (or a microbatch: its own row count) placed by the input
    shardings of its shape."""
    rows = next(iter(batch.values())).shape[0]
    sub = dataclasses.replace(shape, global_batch=rows)
    sds = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
           for k, v in batch.items()}
    sh = shardings_for_tree(rs, input_axes(cfg, sub), sds)
    return {k: place(v, sh[k]) for k, v in batch.items()}


def make_train_plan(cfg: ModelConfig, shape: InputShape, mesh,
                    opt_cfg: Optional[OptimizerConfig] = None,
                    rule_overrides: Optional[Dict] = None,
                    causal_skip: bool = False,
                    microbatches: Optional[int] = None,
                    moe_dispatch: str = "onehot") -> CellPlan:
    opt_cfg = opt_cfg or OptimizerConfig()
    rs = rules_for(cfg, shape, mesh, rule_overrides)
    model = build_model_for_scale(cfg, causal_skip=causal_skip, ruleset=rs,
                                  moe_dispatch=moe_dispatch)
    if microbatches is None:
        microbatches = default_microbatches(shape, mesh, cfg)

    params_sds = param_specs(model)
    param_sh = shardings_for_tree(rs, model.param_axes(), params_sds)
    state_sh = (param_sh, adamw.AdamWState(step=replicated(mesh),
                                           mu=param_sh, nu=param_sh))
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    opt_sds = adamw.AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=tree_map(f32, params_sds), nu=tree_map(f32, params_sds))
    state_sds = (params_sds, opt_sds)

    batch_sds = input_specs(cfg, shape)
    batch_sh = shardings_for_tree(rs, input_axes(cfg, shape), batch_sds)
    nmicro = microbatches
    resolve = _resolver(rs)

    def train_step(state, batch):
        params, opt_state = state
        _refuse_spmd("train", cfg, mesh, params)
        dev = _device(mesh, params)
        spmd = _spmd(mesh, params)
        if isinstance(opt_state.step, torch.Tensor) and opt_state.step.is_meta:
            opt_state = opt_state._replace(step=0)
        if spmd:
            params = adamw.zip_map(place, params, param_sh)
            opt_state = opt_state._replace(
                mu=adamw.zip_map(place, opt_state.mu, param_sh),
                nu=adamw.zip_map(place, opt_state.nu, param_sh))
        batch = {k: v if isinstance(v, DTensor) else
                 torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with spmd_context(mesh, resolve):
            if nmicro <= 1:
                if spmd:
                    batch = _place_batch(batch, cfg, shape, rs)
                loss, grads = _value_and_grad(model.loss_fn, params, batch)
            else:
                # gradient accumulation over contiguous row blocks; the
                # gradients accumulate in float32
                rows = next(iter(batch.values())).shape[0]
                if rows % nmicro:
                    raise ValueError(f"a batch of {rows} rows does not "
                                     f"split into {nmicro} microbatches")
                per = rows // nmicro
                if not spmd:
                    batch = {k: v.reshape((nmicro, per) + v.shape[1:])
                             for k, v in batch.items()}
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                grads = tree_map(lambda p: (
                    torch.zeros_like(p, dtype=torch.float32) if spmd else
                    torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)), params)
                # identical trips, in live memory too (nothing of one
                # is held into the next): the dry run counts one, scaled
                for i in hlo_analysis.trips(nmicro):
                    if spmd:
                        # the global rows of block i, placed by its shape
                        mb = _place_batch({k: v[i * per:(i + 1) * per]
                                           for k, v in batch.items()},
                                          cfg, shape, rs)
                    else:
                        mb = {k: v[i] for k, v in batch.items()}
                    l_i, g_i = _value_and_grad(model.loss_fn, params, mb)
                    grads = adamw.zip_map(
                        lambda a, g: a + g.float() / nmicro, grads, g_i)
                    loss = loss + l_i / nmicro
                    del l_i, g_i
            params, opt_state, metrics = adamw.apply_updates(
                opt_cfg, params, grads, opt_state)
        metrics["loss"] = full_value(loss)
        metrics["grad_norm"] = full_value(metrics["grad_norm"])
        return (params, opt_state), metrics

    metrics_sh = {"loss": replicated(mesh), "grad_norm": replicated(mesh),
                  "lr": replicated(mesh)}
    return CellPlan(step_fn=train_step,
                    arg_sds=(state_sds, batch_sds),
                    arg_shardings=(state_sh, batch_sh),
                    out_shardings=(state_sh, metrics_sh),
                    ruleset=rs,
                    description=(f"train {cfg.name} {shape.name} "
                                 f"(microbatches={microbatches})"))


def make_prefill_plan(cfg: ModelConfig, shape: InputShape, mesh,
                      rule_overrides: Optional[Dict] = None,
                      causal_skip: bool = False,
                      moe_dispatch: str = "onehot",
                      last_logit: bool = False) -> CellPlan:
    rs = rules_for(cfg, shape, mesh, rule_overrides)
    model = build_model_for_scale(cfg, causal_skip=causal_skip, ruleset=rs,
                                  moe_dispatch=moe_dispatch)
    if last_logit and not cfg.is_encdec:
        model.prefill_last_only = True
    params_sds = param_specs(model)
    param_sh = shardings_for_tree(rs, model.param_axes(), params_sds)
    batch_sds = input_specs(cfg, shape)
    batch_sh = shardings_for_tree(rs, input_axes(cfg, shape), batch_sds)
    resolve = _resolver(rs)
    key = "embeds" if model.takes_embeds else "tokens"

    # output cache shardings via cache axes
    cache_sds, cache_axes = model.cache_spec(shape.global_batch,
                                             shape.seq_len)
    cache_sh = shardings_for_tree(rs, cache_axes, cache_sds)
    logits_sh = rs.sharding(("batch", "act_vocab"),
                            (shape.global_batch, cfg.padded_vocab_size))

    def prefill_step(params, batch):
        _refuse_spmd("prefill", cfg, mesh, params)
        dev = _device(mesh, params)
        spmd = _spmd(mesh, params)
        if spmd:
            params = adamw.zip_map(place, params, param_sh)
            batch = _place_batch({k: v if isinstance(v, DTensor) else
                                  torch.as_tensor(v, device=dev)
                                  for k, v in batch.items()}, cfg, shape, rs)
        with spmd_context(mesh, resolve):
            if cfg.is_encdec:
                logits, cache = model.prefill(params, batch["frames"],
                                              batch["tokens"])
            else:
                logits, cache = model.prefill(params, batch[key])
        logits = logits[:, -1]
        if spmd:
            logits = place(logits, logits_sh)
            cache = adamw.zip_map(place, cache, cache_sh)
        return logits, cache
    return CellPlan(step_fn=prefill_step,
                    arg_sds=(params_sds, batch_sds),
                    arg_shardings=(param_sh, batch_sh),
                    out_shardings=(logits_sh, cache_sh),
                    ruleset=rs,
                    description=f"prefill {cfg.name} {shape.name}")


def make_decode_plan(cfg: ModelConfig, shape: InputShape, mesh,
                     rule_overrides: Optional[Dict] = None,
                     moe_dispatch: str = "onehot") -> CellPlan:
    rs = rules_for(cfg, shape, mesh, rule_overrides)
    model = build_model_for_scale(cfg, ruleset=rs,
                                  moe_dispatch=moe_dispatch)
    params_sds = param_specs(model)
    param_sh = shardings_for_tree(rs, model.param_axes(), params_sds)
    batch_sds = input_specs(cfg, shape)          # tokens, pos, cache
    batch_sh = shardings_for_tree(rs, input_axes(cfg, shape), batch_sds)
    resolve = _resolver(rs)
    logits_sh = rs.sharding(("batch", "act_vocab"),
                            (shape.global_batch, cfg.padded_vocab_size))

    def decode_step(params, batch):
        _refuse_spmd("decode", cfg, mesh, params)
        dev = _device(mesh, params)
        tokens, pos, cache = batch["tokens"], batch["pos"], batch["cache"]
        spmd = _spmd(mesh, params)
        if spmd:
            # the cache into the decode layout (its kv_seq rule): one
            # redistribute from the prefill plan's
            params = adamw.zip_map(place, params, param_sh)
            cache = adamw.zip_map(place, cache, batch_sh["cache"])
            tokens = torch.as_tensor(full_value(tokens), device=dev)
            pos = full_value(pos)
        with spmd_context(mesh, resolve):
            logits, cache = model.decode_step(params, tokens, pos, cache)
        logits = logits[:, -1]
        if spmd:
            logits = place(logits, logits_sh)
            cache = adamw.zip_map(place, cache, batch_sh["cache"])
        return logits, cache
    return CellPlan(step_fn=decode_step,
                    arg_sds=(params_sds, batch_sds),
                    arg_shardings=(param_sh, batch_sh),
                    out_shardings=(logits_sh, batch_sh["cache"]),
                    ruleset=rs,
                    description=f"decode {cfg.name} {shape.name}")


def make_plan(cfg: ModelConfig, shape: InputShape, mesh,
              rule_overrides: Optional[Dict] = None,
              causal_skip: bool = False,
              moe_dispatch: str = "onehot",
              last_logit: bool = False) -> CellPlan:
    if shape.kind == "train":
        return make_train_plan(cfg, shape, mesh,
                               rule_overrides=rule_overrides,
                               causal_skip=causal_skip,
                               moe_dispatch=moe_dispatch)
    if shape.kind == "prefill":
        return make_prefill_plan(cfg, shape, mesh,
                                 rule_overrides=rule_overrides,
                                 causal_skip=causal_skip,
                                 moe_dispatch=moe_dispatch,
                                 last_logit=last_logit)
    return make_decode_plan(cfg, shape, mesh,
                            rule_overrides=rule_overrides,
                            moe_dispatch=moe_dispatch)
