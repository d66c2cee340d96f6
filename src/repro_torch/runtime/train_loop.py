"""The LM training loop (``repro.runtime.train_loop``): a train step,
checkpoint/restart fault tolerance, straggler detection and optional
int8 gradient compression, on one device.

Each step draws its batch from ``SyntheticLMLoader`` (a pure function
of (seed, step)), takes the loss and every parameter's gradient with
``loss.backward`` semantics (``torch.autograd.grad`` of
``model.loss_fn``: on the card the attention's forward is the flash
kernel with its log-sum-exp, its backward the plain port of the JAX
package's), optionally round-trips the gradients through
``optimizer.compression``, then applies ``adamw.apply_updates``. Every
``checkpoint_every`` steps the state (params, AdamW state, compression
residual) is written, by ``AsyncCheckpointer`` unless
``async_checkpoint`` is off. A failure inside a step goes to
``FailureDetector``: a retryable one (``WorkerFailure``, ``OSError``)
restores the latest checkpoint and replays from its step, so the losses
after a restart are the ones the first pass computed; any other is
raised. Step times (host clock, after the device has finished the step)
feed ``StragglerMonitor`` and the metrics JSONL.

What differs from the JAX package: the mesh may be None, span one
device, or be a mesh of SPMD processes (``launch.mesh.make_test_mesh``
under ``launch.dist.init_spmd`` or ``torchrun``: one process a mesh
position); a mesh of more than one device from one controller raises
``NotImplementedError``. The device is explicit (``device``, "cuda" by
default; a rank's own, ``Mesh.device``, on an SPMD mesh), and params
come from ``model.init`` on a ``torch.Generator`` of that device seeded
with ``train_cfg.seed``. The model is built as the JAX package builds
it, with the RWKV6 time-mix in its ``"direct"`` mode (the chunked scan
in plain PyTorch, which autograd differentiates; the WKV6 kernel has
no backward).

On a mesh, ``param_shardings`` and ``batch_shardings`` are the JAX
Trainer's (``rules_for``, ``shardings_for_tree``; ``ruleset`` keeps the
fallbacks). On an SPMD mesh every rank draws the full params from the
seed on its device and keeps its shard (``sharding.rules.place``), so
the mesh's params are the single device's, bit for bit; the batch is
placed by ``device_batch``; the step runs on DTensors (the hidden state
constrained to ("batch", "seq", None) at each group's start, flash on
each rank's heads, the loss from the vocabulary's shards), each
gradient placed as its param before AdamW; the loss and grad norm are
read replicated; checkpoints are gathered and written by rank 0 with
the JAX Trainer's ``mesh_signature``, and a restore places them on the
current mesh. The dense, MoE and RWKV6 families run on an SPMD mesh of
more than one device (``device.SPMD_FAMILIES``; an MoE model with its
experts over the model axis, its dispatch ``moe_dispatch``; an RWKV6
model's "direct" recurrence on each rank's heads,
``models.rwkv.recurrence``); the others raise ``NotImplementedError``
naming their slice.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.config import InputShape, ModelConfig, TrainConfig
from repro_torch.data.loader import (BatchSpec, SyntheticLMLoader,
                                     device_batch)
from repro_torch.device import (FAMILY_SLICE, SPMD_FAMILIES, DeviceLike,
                                check_one_device, resolve_device, spmd_mesh)
from repro_torch.models import build_model, input_axes
from repro_torch.models.common import full_value, param_specs, tree_map
from repro_torch.optimizer import adamw, compression
from repro_torch.runtime.fault import FailureDetector, StragglerMonitor
from repro_torch.runtime.metrics import Metrics
from repro_torch.sharding.rules import place


@dataclasses.dataclass
class TrainerReport:
    steps_run: int
    final_loss: float
    restarts: int
    straggler_events: int
    losses: list


def grad_tree(loss: torch.Tensor, params: Any) -> Any:
    """d loss / d every leaf of ``params`` (each requires grad), as a tree
    of the same layout; a leaf the loss does not reach gets zeros. A
    DTensor leaf's gradient is placed as the leaf (its partial sums
    reduced, or reduce-scattered to its shards)."""
    leaves = [t for _, t in ckpt.flatten_with_paths(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): _placed_as(t, g) for t, g in zip(leaves, grads)}
    return tree_map(lambda t: by_id[id(t)], params)


def _placed_as(t: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if g is None:
        return torch.zeros_like(t)
    if isinstance(g, DTensor) and g.placements != t.placements:
        return g.redistribute(t.device_mesh, t.placements)
    return g


class Trainer:
    def __init__(self, cfg: ModelConfig, train_cfg: TrainConfig, mesh=None,
                 shape: Optional[InputShape] = None,
                 metrics_path: Optional[str] = None,
                 attn_impl: str = "flash",
                 fail_injector: Optional[Callable[[int], None]] = None,
                 device: DeviceLike = "cuda", moe_dispatch: str = "onehot"):
        self.device_mesh = spmd_mesh("Trainer", mesh)
        self.mesh = mesh
        self.device = (mesh.device if self.device_mesh is not None
                       else resolve_device(device))
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.shape = shape or train_cfg.shape
        if self.device_mesh is not None and cfg.family not in SPMD_FAMILIES:
            check_one_device(f"Trainer ({cfg.name}, family "
                             f"{cfg.family!r})", mesh,
                             waits_for=FAMILY_SLICE)
        # RWKV6 time-mix in "direct" mode, the JAX package's default: the
        # chunked scan in plain PyTorch, which has a backward (the WKV6
        # kernel has none)
        self.model = build_model(cfg, attn_impl=attn_impl,
                                 rwkv_mode="direct",
                                 moe_dispatch=moe_dispatch)
        self.ruleset = self.param_shardings = self.batch_shardings = None
        self._resolve = None
        if mesh is not None:
            from repro_torch.launch.steps import (_resolver, rules_for,
                                                  shardings_for_tree)
            rs = rules_for(cfg, self.shape, mesh)
            self.ruleset = rs
            self.param_shardings = shardings_for_tree(
                rs, self.model.param_axes(), param_specs(self.model))
            tok = torch.empty((self.shape.global_batch, self.shape.seq_len),
                              dtype=torch.int32, device="meta")
            self.batch_shardings = shardings_for_tree(
                rs, input_axes(cfg, self.shape),
                {"tokens": tok, "labels": tok})
            if self.device_mesh is not None:
                self._resolve = _resolver(rs)
                self.model.act_constraint = (
                    lambda x: self._resolve(x, ("batch", "seq", None)))
        if self.device_mesh is not None and self.device_mesh.get_rank():
            metrics_path = None            # rank 0 logs
        self.metrics = Metrics(metrics_path)
        self.detector = FailureDetector()
        self.stragglers = StragglerMonitor()
        self.fail_injector = fail_injector
        self.compress = train_cfg.optimizer.compress_grads
        self.loader = SyntheticLMLoader(
            BatchSpec(self.shape.global_batch, self.shape.seq_len + 1,
                      cfg.vocab_size), seed=train_cfg.seed)
        self.checkpointer = ckpt.AsyncCheckpointer(
            train_cfg.checkpoint_dir, keep=train_cfg.keep_checkpoints)

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        """Drain pending checkpoints and release the metrics JSONL
        handle. Safe to call more than once; ``with Trainer(...) as tr``
        does it on exit."""
        self.checkpointer.wait()
        self.metrics.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- state ----------------------------------------------------------------
    def init_state(self):
        """(params, AdamW state, residual): params drawn by ``model.init``
        on the device from ``train_cfg.seed`` (on an SPMD mesh, the full
        params on every rank, each keeping its shard); the residual is
        the compression's float32 error feedback, or {} without it."""
        gen = torch.Generator(self.device).manual_seed(self.train_cfg.seed)
        params = self.model.init(gen)
        if self.device_mesh is not None:
            params = adamw.zip_map(place, params, self.param_shardings)
        residual = (compression.init_residual(params) if self.compress
                    else {})
        return (params, adamw.init(self.train_cfg.optimizer, params),
                residual)

    def restore_latest(self):
        """(the latest checkpoint's state, its step), or (None, 0)."""
        step = ckpt.latest_step(self.train_cfg.checkpoint_dir)
        if step is None:
            return None, 0
        params, opt, residual = self.init_state()
        target = (params, opt._replace(step=0), residual)
        (params, opt, residual), _ = ckpt.restore(
            self.train_cfg.checkpoint_dir, step, target,
            shardings=self.state_shardings())
        return (params, opt._replace(step=int(opt.step)), residual), step

    def state_shardings(self):
        """The (params, AdamW state, residual) tree's shardings on the
        mesh (the AdamW step replicated), or None without a mesh."""
        if self.param_shardings is None:
            return None
        from repro_torch.launch.steps import replicated as whole
        sh = self.param_shardings
        return (sh, adamw.AdamWState(step=whole(self.mesh), mu=sh, nu=sh),
                sh if self.compress else {})

    def mesh_signature(self) -> str:
        """The JAX Trainer's: "data=1xmodel=2"; "" without a mesh."""
        if self.mesh is None:
            return ""
        return "x".join(f"{k}={v}" for k, v in self.mesh.shape.items())

    def _spmd(self):
        """The context a step runs in on an SPMD mesh
        (``launch.steps.spmd_context``); nothing without one."""
        if self.device_mesh is None:
            return contextlib.nullcontext()
        from repro_torch.launch.steps import spmd_context
        return spmd_context(self.mesh, self._resolve)

    def _checkpoint_tree(self, state):
        """The state as the JAX Trainer checkpoints it: the AdamW step an
        int32 scalar."""
        params, opt, residual = state
        return (params, opt._replace(step=torch.tensor(opt.step,
                                                       dtype=torch.int32)),
                residual)

    # -- one step ---------------------------------------------------------------
    def _step(self, state, batch):
        params, opt_state, residual = state
        with self._spmd():
            live = tree_map(lambda t: t.detach().requires_grad_(True),
                            params)
            loss = self.model.loss_fn(live, batch)
            grads = grad_tree(loss, live)
            del live
            if self.compress:
                grads, residual = compression.compress_decompress(grads,
                                                                  residual)
            params, opt_state, metrics = adamw.apply_updates(
                self.train_cfg.optimizer, params, grads, opt_state)
        metrics["loss"] = full_value(loss.detach())
        metrics["grad_norm"] = full_value(metrics["grad_norm"])
        return (params, opt_state, residual), metrics

    # -- loop ----------------------------------------------------------------
    def run(self, num_steps: int, resume: bool = True) -> TrainerReport:
        state, start_step = (self.restore_latest() if resume
                             else (None, 0))
        if state is None:
            state = self.init_state()
            start_step = 0
        restarts = 0
        losses = []
        step = start_step
        tc = self.train_cfg
        while step < num_steps:
            try:
                t0 = time.time()
                if self.fail_injector is not None:
                    self.fail_injector(step)
                batch = device_batch(self.loader.batch(step),
                                     self.batch_shardings
                                     if self.device_mesh is not None
                                     else None, device=self.device)
                state, metrics = self._step(state, batch)
                loss = float(metrics["loss"])
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.time() - t0
                ev = self.stragglers.observe(step, dt)
                self.metrics.log(step, loss=loss, step_time_s=dt,
                                 straggler=bool(ev),
                                 grad_norm=float(metrics["grad_norm"]))
                losses.append(loss)
                step += 1
                if step % tc.checkpoint_every == 0:
                    tree = self._checkpoint_tree(state)
                    if tc.async_checkpoint:
                        self.checkpointer.save(
                            step, tree, metadata={"loss": loss},
                            mesh_signature=self.mesh_signature())
                    else:
                        ckpt.save(tc.checkpoint_dir, step, tree,
                                  {"loss": loss}, self.mesh_signature())
            except Exception as exc:  # noqa: BLE001 — fault boundary
                self.checkpointer.wait()
                latest = ckpt.latest_step(tc.checkpoint_dir)
                decision = self.detector.on_failure(exc, latest)
                if decision.action == "raise":
                    raise
                restarts += 1
                self.metrics.log(step, restart=True,
                                 reason=decision.reason)
                state, step = self.restore_latest()
                if state is None:
                    state, step = self.init_state(), 0
        self.checkpointer.wait()
        return TrainerReport(steps_run=num_steps - start_step,
                             final_loss=losses[-1] if losses else float("nan"),
                             restarts=restarts,
                             straggler_events=len(self.stragglers.events),
                             losses=losses)
