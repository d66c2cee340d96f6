"""Port parity of LM training: the flash attention's autograd Function,
``adamw.apply_updates``, int8 gradient compression, the synthetic
loader, checkpoints (``AsyncCheckpointer``, bf16 leaves, the trainer
state's keys), the fault policies, the ``Trainer`` and the training
CLI, against the JAX package on the CPU. The losses and every family's
gradients are ``tests/test_torch_train_loss.py``.

Inputs come from a numpy seed; JAX params are carried across with
``params_from_jax``. The JAX ``Trainer`` is not the reference: it fails
under its 1x1 test mesh on this CPU (a sharding error in the embedding
gather), while the pieces of its step run without a mesh, so the port
is held to those: ``jax.value_and_grad(model.loss_fn)``,
``adamw.apply_updates``, ``compression.compress_decompress`` and
``SyntheticLMLoader.batch``. Tolerances, float32 throughout: the flash
value and (dq, dk, dv) within 1e-5 of max |JAX value|; AdamW within 1e-6 of max |JAX value| (the same float32
arithmetic, summed in another order); the loader, the compression's q
and residual and checkpoint round trips bitwise.
"""
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import get_smoke_arch as j_smoke
from repro.data import loader as j_loader
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.optimizer import adamw as j_adamw
from repro.optimizer import compression as j_comp
from repro.runtime import fault as j_fault
from repro_torch import checkpoint as t_ckpt
from repro_torch.config import (InputShape, OptimizerConfig, TrainConfig,
                                get_smoke_arch)
from repro_torch.data import loader as t_loader
from repro_torch.kernels.wkv6 import ops as w_ops
from repro_torch.models import attention as t_attn
from repro_torch.models.common import tree_map
from repro_torch.optimizer import adamw as t_adamw
from repro_torch.optimizer import compression as t_comp
from repro_torch.runtime import fault as t_fault
from repro_torch.runtime.train_loop import Trainer
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
TINY = InputShape("tiny", seq_len=32, global_batch=4, kind="train")


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- flash attention with its gradient -------------------------------------

# b, sq, skv, h, kv_heads, hd, causal, window, q_offset, q_block, kv_block
FLASH_GRAD_CASES = {
    "causal": (2, 32, 32, 4, 4, 8, True, 0, 0, 8, 8),
    "non-causal": (2, 32, 32, 4, 4, 8, False, 0, 0, 8, 8),
    "window": (2, 40, 40, 4, 2, 8, True, 7, 0, 16, 8),
    "GQA 3:1": (1, 24, 24, 6, 2, 16, True, 0, 0, 8, 8),
    "sq != skv, q_offset": (1, 16, 40, 4, 2, 8, True, 0, 24, 8, 16),
    "cross sq != skv": (2, 13, 29, 4, 4, 8, False, 0, 0, 8, 8),
    "ragged blocks": (2, 37, 37, 6, 2, 8, True, 0, 0, 16, 8),
}


@pytest.mark.parametrize("case", sorted(FLASH_GRAD_CASES))
def test_flash_autograd_matches_jax_vjp(case):
    b, sq, skv, h, kv, hd, causal, window, q_off, qb, kb = \
        FLASH_GRAD_CASES[case]
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kv, hd)).astype(np.float32)
    dout = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    opts = dict(causal=causal, window=window, q_offset=q_off, q_block=qb,
                kv_block=kb)
    out, vjp = jax.vjp(lambda q, k, v: j_attn.flash_attention(
        q, k, v, hd ** -0.5, **opts), q, k, v)
    want = vjp(dout)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = t_attn.flash_attention(tq, tk, tv, hd ** -0.5, **opts)
    got.backward(torch.tensor(dout))
    assert _rel(got, out) < REL
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        assert t.grad.shape == t.shape, name
        assert _rel(t.grad, w) < REL, (name, _rel(t.grad, w))


def test_flash_without_grad_is_the_plain_call():
    """No gradient wanted (grad mode off, or no input requiring one): the
    wrapper's plain call, the value the Function's forward gives."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.normal(size=s).astype(np.float32))
               for s in ((1, 20, 4, 8), (1, 20, 2, 8), (1, 20, 2, 8)))
    plain = t_attn.flash_attention(q, k, v, 0.3, causal=True)
    assert plain.grad_fn is None
    with torch.no_grad():
        off = t_attn.flash_attention(q.requires_grad_(), k, v, 0.3,
                                     causal=True)
    assert off.grad_fn is None
    with_grad = t_attn.flash_attention(q, k, v, 0.3, causal=True)
    assert with_grad.grad_fn is not None
    assert torch.equal(with_grad.detach(), plain)
    assert torch.equal(off, plain)


# -- optimizer --------------------------------------------------------------------

@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_apply_updates_matches_jax_over_three_steps(clip):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=clip)
    jcfg, tcfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": {"s": rng.normal(size=(4,)).astype(np.float32)}}
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(torch.tensor,
                                                         params)
    js, ts = j_adamw.init(jcfg, jp), t_adamw.init(tcfg, tp)
    for step in range(3):
        grads = {"w": rng.normal(size=(6, 4)).astype(np.float32) * 3,
                 "b": {"s": rng.normal(size=(4,)).astype(np.float32)}}
        jp, js, jm = j_adamw.apply_updates(jcfg, jp, jax.tree.map(
            jnp.asarray, grads), js)
        tp, ts, tm = t_adamw.apply_updates(tcfg, tp,
                                           tree_map(torch.tensor, grads), ts)
        assert ts.step == int(js.step) == step + 1
        assert _rel(tm["grad_norm"], jm["grad_norm"]) < 1e-6
        assert np.float32(tm["lr"]) == np.float32(jm["lr"])
        for name, got, want in (("params", tp, jp), ("mu", ts.mu, js.mu),
                                ("nu", ts.nu, js.nu)):
            want = dict(t_ckpt.flatten_with_paths(_np_tree(want)))
            for path, g in t_ckpt.flatten_with_paths(got):
                assert _rel(g, want[path]) < 1e-6, (name, path, step)


def test_compression_matches_jax_bitwise():
    rng = np.random.default_rng(6)
    grads = {"a": rng.normal(size=(40, 3)).astype(np.float32),
             "b": (rng.normal(size=(7,)) * 1e-3).astype(np.float32),
             "z": np.zeros((5,), np.float32)}
    # values on the half-way points of the int8 grid: round half to even
    grads["h"] = (np.arange(-6, 7, dtype=np.float32) + 0.5) / 127.0 * 2.0
    grads["h"][-1] = 2.0
    jr, tr = j_comp.init_residual(grads), t_comp.init_residual(
        tree_map(torch.tensor, grads))
    for leaf in grads:
        jq, js = j_comp._quantize(jnp.asarray(grads[leaf]))
        tq, ts = t_comp._quantize(torch.tensor(grads[leaf]))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts) == np.float32(js)
    for _ in range(2):
        jg, jr = j_comp.compress_decompress(jax.tree.map(jnp.asarray, grads),
                                            jr)
        tg, tr = t_comp.compress_decompress(tree_map(torch.tensor, grads),
                                            tr)
        for leaf in grads:
            np.testing.assert_array_equal(tg[leaf].numpy(),
                                          np.asarray(jg[leaf]))
            np.testing.assert_array_equal(tr[leaf].numpy(),
                                          np.asarray(jr[leaf]))
    assert t_comp.compression_ratio(grads) == j_comp.compression_ratio(
        grads) == 4.0
    assert t_comp.compression_ratio(grads, torch.bfloat16) == 2.0


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2)])
def test_loader_batches_are_the_jax_loaders_bitwise(index, count):
    spec = dict(global_batch=4, seq_len=33, vocab_size=211)
    jl = j_loader.SyntheticLMLoader(j_loader.BatchSpec(**spec), seed=7,
                                    process_index=index,
                                    process_count=count)
    tl = t_loader.SyntheticLMLoader(t_loader.BatchSpec(**spec), seed=7,
                                    process_index=index,
                                    process_count=count)
    for step in (0, 3, 17):
        want, got = jl.batch(step), tl.batch(step)
        assert sorted(got) == ["labels", "tokens"]
        for key in want:
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
    on = t_loader.device_batch(tl.batch(0), device="cpu")
    assert on["tokens"].dtype == torch.int32
    assert np.array_equal(on["labels"].numpy(), tl.batch(0)["labels"])
    for text in ("", "hello world", "x" * 40):
        np.testing.assert_array_equal(
            t_loader.hash_tokenize(text, 97, 16),
            j_loader.hash_tokenize(text, 97, 16))


# -- checkpoints -------------------------------------------------------------------

def test_async_checkpointer_saves_waits_and_collects(tmp_path):
    ck = t_ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    for step in (1, 2, 3):
        ck.save(step, tree, metadata={"loss": float(step)})
        tree["w"] += 1        # the save copied the tree before returning
    ck.wait()
    assert ck.last_saved == 3
    assert t_ckpt.list_steps(str(tmp_path)) == [2, 3]
    got, manifest = t_ckpt.restore(str(tmp_path), 3, tree)
    assert torch.equal(got["w"], torch.arange(6.).reshape(2, 3) + 2)
    assert manifest["metadata"] == {"loss": 3.0}
    assert manifest["mesh_signature"] == ""
    # the JAX package reads the port's checkpoint
    jgot, _ = j_ckpt.restore(str(tmp_path), 3, {"w": jnp.zeros((2, 3))})
    np.testing.assert_array_equal(np.asarray(jgot["w"]), got["w"].numpy())


def test_bf16_leaves_round_trip_bitwise(tmp_path):
    gen = torch.Generator().manual_seed(8)
    w = torch.randn((5, 7), generator=gen).to(torch.bfloat16) * 1e3
    w[0, :3] = torch.tensor([float("inf"), -0.0, 1e-38])
    t_ckpt.save(str(tmp_path), 4, {"w": w, "n": torch.tensor(3)},
                mesh_signature="data=1")
    manifest = json.loads((tmp_path / "step_000000004" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["w"] == {"shape": [5, 7], "dtype": "bfloat16"}
    assert manifest["mesh_signature"] == "data=1"
    got, _ = t_ckpt.restore(str(tmp_path), 4,
                            {"w": torch.zeros((5, 7), dtype=torch.bfloat16),
                             "n": torch.tensor(0)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert int(got["n"]) == 3
    jgot, _ = j_ckpt.restore(str(tmp_path), 4,
                             {"w": jnp.zeros((5, 7), jnp.bfloat16),
                              "n": jnp.zeros((), jnp.int32)})
    np.testing.assert_array_equal(
        np.asarray(jgot["w"]).view(np.int16), w.view(torch.int16).numpy())


@pytest.mark.parametrize("compress", [False, True])
def test_trainer_state_checkpoints_as_the_jax_trainers(compress, tmp_path):
    """The port's Trainer state saves under the JAX Trainer's keys
    (``_flatten_with_paths`` of (params, AdamWState, residual): the
    AdamW fields as ".step", ".mu", ".nu"), shapes and dtypes."""
    arch = "smollm-360m"
    opt = dict(compress_grads=compress)
    tc = TrainConfig(shape=TINY, optimizer=OptimizerConfig(**opt),
                     checkpoint_dir=str(tmp_path / "port"))
    with Trainer(get_smoke_arch(arch), tc, device="cpu") as tr:
        t_ckpt.save(str(tmp_path / "port"), 1,
                    tr._checkpoint_tree(tr.init_state()))
    jm = j_build_model(j_smoke(arch))
    jp = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      jax.eval_shape(jm.init, jax.random.key(0)))
    jstate = (jp, j_adamw.init(JOptimizerConfig(**opt), jp),
              j_comp.init_residual(jp) if compress else {})
    j_ckpt.save(str(tmp_path / "jax"), 1, jstate)
    keys = [k for k, _ in j_ckpt.checkpoint._flatten_with_paths(jstate)]
    assert keys[len(keys) // (3 if compress else 2)].startswith("1/.")
    read = lambda d: json.loads((tmp_path / d / "step_000000001" /
                                 "manifest.json").read_text())["leaves"]
    assert list(read("port")) == keys
    assert read("port") == read("jax")


# -- fault policies -----------------------------------------------------------------

def test_failure_detector_matches_jax():
    events = [(t_fault.WorkerFailure("a"), j_fault.WorkerFailure("a"), 10),
              (OSError("disk"), OSError("disk"), 10),
              (ValueError("bug"), ValueError("bug"), 10),
              (t_fault.WorkerFailure("b"), j_fault.WorkerFailure("b"), None),
              (t_fault.WorkerFailure("c"), j_fault.WorkerFailure("c"), 20),
              (t_fault.WorkerFailure("d"), j_fault.WorkerFailure("d"), 30)]
    td, jd = t_fault.FailureDetector(max_restarts=2), \
        j_fault.FailureDetector(max_restarts=2)
    for t_exc, j_exc, latest in events:
        got, want = td.on_failure(t_exc, latest), jd.on_failure(j_exc,
                                                                latest)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert len(td.events) == len(jd.events) == 4


def test_straggler_monitor_matches_jax():
    durations = [1.0, 1.1, 0.9, 5.0, 1.0, 1.2, 3.5, 0.8, 9.0, 1.0]
    tm = t_fault.StragglerMonitor(multiplier=3.0, history=4, warmup_steps=3)
    jm = j_fault.StragglerMonitor(multiplier=3.0, history=4, warmup_steps=3)
    for step, d in enumerate(durations):
        assert tm.deadline() == jm.deadline()
        got, want = tm.observe(step, d), jm.observe(step, d)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert len(tm.events) == len(jm.events) > 0


@pytest.mark.parametrize("devices,batch,orig", [
    (512, 256, 16), (448, 256, 16), (8, 8, 16), (7, 8, 16), (1, 1, 16),
    (96, 128, 8), (30, 12, 4), (3, 5, 16)])
def test_plan_elastic_remesh_matches_jax(devices, batch, orig):
    assert t_fault.plan_elastic_remesh(devices, batch, orig_model=orig) == \
        j_fault.plan_elastic_remesh(devices, batch, orig_model=orig)


# -- the trainer ----------------------------------------------------------------------

def test_trainer_checkpoint_restart_and_learning():
    """tests/test_runtime.py's scenario on the port: a failure injected
    at step 17, restart from step 10's checkpoint, 30 steps, then a
    resume to 35; the replayed steps give the first pass's losses."""
    cfg = get_smoke_arch("smollm-360m")
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(shape=TINY,
                         optimizer=OptimizerConfig(lr=3e-3, warmup_steps=5,
                                                   total_steps=60),
                         checkpoint_every=10, checkpoint_dir=d,
                         async_checkpoint=False)
        fails = {17}

        def injector(step):
            if step in fails:
                fails.discard(step)
                raise t_fault.WorkerFailure(f"injected at {step}")

        metrics_path = f"{d}/metrics.jsonl"
        with Trainer(cfg, tc, metrics_path=metrics_path,
                     fail_injector=injector, device="cpu") as tr:
            rep = tr.run(30, resume=False)
        assert rep.restarts == 1
        assert np.isfinite(rep.final_loss)
        assert t_ckpt.latest_step(d) == 30
        assert tr.metrics.closed
        records = [json.loads(line) for line in
                   open(metrics_path).read().splitlines()]
        assert sum(1 for r in records if r.get("restart")) == 1
        # steps 10-16 ran twice: the same losses, bit for bit
        assert len(rep.losses) == 37
        assert rep.losses[10:17] == rep.losses[17:24]
        assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5])
        tr2 = Trainer(cfg, tc, device="cpu")
        rep2 = tr2.run(35, resume=True)
        assert rep2.steps_run == 5
        tr2.close()
        assert tr2.metrics.closed


def test_trainer_grad_compression_trains():
    cfg = get_smoke_arch("smollm-360m")
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(shape=TINY,
                         optimizer=OptimizerConfig(
                             lr=3e-3, warmup_steps=5, total_steps=60,
                             compress_grads=True),
                         checkpoint_every=1000, checkpoint_dir=d)
        tr = Trainer(cfg, tc, device="cpu")
        rep = tr.run(40, resume=False)
        tr.close()
        assert np.isfinite(rep.final_loss)
        assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5])


def test_trainer_refuses_a_mesh_and_an_unknown_failure(tmp_path):
    cfg = get_smoke_arch("smollm-360m")
    tc = TrainConfig(shape=TINY, checkpoint_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="mesh"):
        Trainer(cfg, tc, object(), device="cpu")

    def bug(step):
        raise ValueError("not retryable")

    with Trainer(cfg, tc, fail_injector=bug, device="cpu") as tr:
        with pytest.raises(ValueError, match="not retryable"):
            tr.run(2, resume=False)


def test_train_cli_smoke_on_cpu(tmp_path):
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "2"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "final loss" in res.stdout and "0 restarts" in res.stdout
    assert t_ckpt.latest_step(str(tmp_path)) == 2
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 3
    assert time.time() - t0 < 120


# -- the WKV6 wrapper and gradients ----------------------------------------------------

def test_wkv6_with_grad_on_cpu_runs_the_plain_version():
    """A requires-grad CPU input still goes through the plain version,
    which is differentiable (a CUDA one raises: the kernel has no
    backward)."""
    rng = np.random.default_rng(9)
    b, s, h, k = 1, 20, 2, 8
    r, kk, v = (torch.tensor(rng.normal(size=(b, s, h, k)).astype(
        np.float32)) for _ in range(3))
    lw = torch.tensor(-np.exp(rng.normal(size=(b, s, h, k))).astype(
        np.float32))
    u = torch.tensor(rng.normal(size=(h, k)).astype(np.float32))
    want = w_ops.wkv6(r, kk, v, lw, u, chunk=8)
    r.requires_grad_(True)
    got = w_ops.wkv6(r, kk, v, lw, u, chunk=8)
    assert torch.equal(got.detach(), want)
    got.sum().backward()
    assert r.grad is not None and torch.isfinite(r.grad).all()
    assert r.grad.abs().sum() > 0
