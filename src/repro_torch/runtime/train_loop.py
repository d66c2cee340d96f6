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

What differs from the JAX package: the mesh may be None or span one
device (a mesh of more raises ``NotImplementedError``: the model-axis
slice brings it), the device is explicit (``device``, "cuda" by
default) and params come from ``model.init`` on a ``torch.Generator``
of that device seeded with ``train_cfg.seed``. The model is built as
the JAX package builds it, with the RWKV6 time-mix in its ``"direct"``
mode (the chunked scan in plain PyTorch, which autograd differentiates;
the WKV6 kernel has no backward).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.config import InputShape, ModelConfig, TrainConfig
from repro_torch.data.loader import (BatchSpec, SyntheticLMLoader,
                                     device_batch)
from repro_torch.device import DeviceLike, check_one_device, resolve_device
from repro_torch.models import build_model
from repro_torch.models.common import tree_map
from repro_torch.optimizer import adamw, compression
from repro_torch.runtime.fault import FailureDetector, StragglerMonitor
from repro_torch.runtime.metrics import Metrics


@dataclasses.dataclass
class TrainerReport:
    steps_run: int
    final_loss: float
    restarts: int
    straggler_events: int
    losses: list


def grad_tree(loss: torch.Tensor, params: Any) -> Any:
    """d loss / d every leaf of ``params`` (each requires grad), as a tree
    of the same layout; a leaf the loss does not reach gets zeros."""
    leaves = [t for _, t in ckpt.flatten_with_paths(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): (g if g is not None else torch.zeros_like(t))
             for t, g in zip(leaves, grads)}
    return tree_map(lambda t: by_id[id(t)], params)


class Trainer:
    def __init__(self, cfg: ModelConfig, train_cfg: TrainConfig, mesh=None,
                 shape: Optional[InputShape] = None,
                 metrics_path: Optional[str] = None,
                 attn_impl: str = "flash",
                 fail_injector: Optional[Callable[[int], None]] = None,
                 device: DeviceLike = "cuda"):
        check_one_device("Trainer", mesh)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.shape = shape or train_cfg.shape
        # RWKV6 time-mix in "direct" mode, the JAX package's default: the
        # chunked scan in plain PyTorch, which has a backward (the WKV6
        # kernel has none)
        self.model = build_model(cfg, attn_impl=attn_impl,
                                 rwkv_mode="direct")
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
        on the device from ``train_cfg.seed``; the residual is the
        compression's float32 error feedback, or {} without it."""
        gen = torch.Generator(self.device).manual_seed(self.train_cfg.seed)
        params = self.model.init(gen)
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
            self.train_cfg.checkpoint_dir, step, target)
        return (params, opt._replace(step=int(opt.step)), residual), step

    def mesh_signature(self) -> str:
        return ""                  # one device

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
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = self.model.loss_fn(live, batch)
        grads = grad_tree(loss, live)
        del live
        if self.compress:
            grads, residual = compression.compress_decompress(grads,
                                                              residual)
        params, opt_state, metrics = adamw.apply_updates(
            self.train_cfg.optimizer, params, grads, opt_state)
        metrics["loss"] = loss.detach()
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
                                     device=self.device)
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
