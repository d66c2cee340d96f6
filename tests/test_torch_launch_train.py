"""Port parity of the launch layer's train plans
(``launch.steps.make_train_plan``, microbatching) against the JAX
package, on the CPU.

The JAX side is a composition of the functions the JAX ``train_step``
composes: the scale model's ``loss_fn`` (``attn_impl="flash"``,
``rwkv_mode="factored"``) and its gradient, accumulated over row blocks
as ``repro/launch/steps.py``'s scan body does, then
``adamw.apply_updates`` (the JAX package's own
``test_microbatched_train_step_matches_full_batch`` stops before the
step under this JAX version). Both run the JAX test's optimizer config,
weights and batch, in float32, carried across with
``params_from_jax``. Tolerances: loss rtol 1e-5; the accumulated
gradient GRAD_REL of each leaf's max |g|; params rtol = atol = 2e-4
where Adam's first step is well conditioned (ADAM_COND, below).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke_arch as j_smoke
from repro.config.base import OptimizerConfig as JOpt
from repro.models import build_model as j_build_model
from repro.optimizer import adamw as j_adamw
from repro_torch.checkpoint import flatten_with_paths
from repro_torch.config import InputShape, OptimizerConfig, get_smoke_arch
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps
from repro_torch.models import build_model, common, params_from_jax
from repro_torch.optimizer import adamw
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def _carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _opt():
    return dict(lr=1e-2, warmup_steps=0, total_steps=10,
                schedule="constant", grad_clip=0.0, weight_decay=0.0)


# Adam's first step moves a param by lr * g / (|g| + eps): where |g| is
# near eps (1e-8) a rounding difference in g moves the new param by up to
# lr, in the JAX package against itself as well
# (test_adam_first_step_amplifies_rounding_in_jax_itself). The params bar
# holds where |g| >= ADAM_COND: there the update's slope lr * eps / (|g|
# + eps)^2 is <= 1, so a gradient difference moves a param by no more
# than itself (<= 1e-5 here). Every param stays within lr of JAX's.
ADAM_COND = 1e-5
# the accumulated gradient, each leaf against its max |g|: 2e-4, twice
# tests/test_torch_train_loss.py's bar, because on the JAX test's batch
# one rwkv6-7b row carries the packages' ulp-level differences in exp and
# tanh up to 1.1e-5 in its logits (the other rows <= 2.7e-6) and 1.4e-4
# in the time-mix's wr gradient summed over four microbatches; the
# factored and the direct modes agree within 1e-5 in each package, and
# over 2 rows the packages within 7e-6
GRAD_REL = 2e-4


def _j_train(cfg, params, batch, opt, nmicro):
    """The JAX composition: the scale model's loss_fn and its gradient,
    accumulated over row blocks as steps.py's scan body does, then
    adamw.apply_updates. Returns (loss, new params, metrics, grads)."""
    model = j_build_model(cfg, attn_impl="flash", rwkv_mode="factored")
    vg = jax.jit(jax.value_and_grad(model.loss_fn))
    if nmicro <= 1:
        loss, grads = vg(params, batch)
    else:
        micro = jax.tree.map(lambda x: x.reshape(
            (nmicro, x.shape[0] // nmicro) + x.shape[1:]), batch)
        loss = jnp.zeros((), jnp.float32)
        grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             params)
        for i in range(nmicro):
            l_i, g_i = vg(params, jax.tree.map(lambda x: x[i], micro))
            grads = jax.tree.map(lambda a, g: a + g.astype(jnp.float32)
                                 / nmicro, grads, g_i)
            loss = loss + l_i / nmicro
    new, _, metrics = j_adamw.apply_updates(opt, params, grads,
                                            j_adamw.init(opt, params))
    return float(loss), new, metrics, grads


def _jax_test_batch(vocab):
    """The JAX microbatch test's own batch."""
    return {"tokens": jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                         vocab),
            "labels": jax.random.randint(jax.random.PRNGKey(2), (8, 16), 0,
                                         vocab)}


def _params_close(got, want, grads, lr):
    """Every param within lr of ``want``; within rtol = atol = 2e-4
    where |grad| >= ADAM_COND."""
    got, want, grads = (np.asarray(t, np.float32) for t in (got, want, grads))
    assert np.abs(got - want).max() <= lr * (1 + 1e-3)
    cond = np.abs(grads) >= ADAM_COND
    np.testing.assert_allclose(got[cond], want[cond], rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    return cfg, j_build_model(cfg).init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _j_result(arch, k):
    """The JAX composition on the JAX test's weights and batch."""
    cfg, jp = _weights(arch)
    return _j_train(cfg, jp, _jax_test_batch(cfg.vocab_size),
                    JOpt(**_opt()), k)


@functools.lru_cache(maxsize=None)
def _t_result(arch, k):
    """The port's train plan on the same: (plan, new params, AdamW state,
    metrics, the logical axes its ruleset resolved during the step)."""
    cfg_j, jp = _weights(arch)
    cfg_t = dataclasses.replace(get_smoke_arch(arch), dtype="float32")
    shape = InputShape("t", seq_len=16, global_batch=8, kind="train")
    batch = {n: np.array(v)
             for n, v in _jax_test_batch(cfg_j.vocab_size).items()}
    plan = steps.make_train_plan(cfg_t, shape,
                                 t_mesh.make_test_mesh(1, 1, device="cpu"),
                                 opt_cfg=OptimizerConfig(**_opt()),
                                 microbatches=k)
    seen = []
    inner = plan.ruleset.sharding
    plan.ruleset.sharding = lambda a, s=None: (seen.append(a),
                                               inner(a, s))[1]
    params = _carry(jp)
    (new, state), metrics = plan.step_fn(
        (params, adamw.init(OptimizerConfig(**_opt()), params)),
                                         batch)
    return plan, new, state, metrics, seen


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-7b",
                                  "qwen3-moe-30b-a3b"])
def test_train_plan_matches_the_jax_composition(arch, k):
    """make_train_plan at ``microbatches`` k against the JAX composition
    on the JAX test's weights and batch: loss rtol 1e-5, the accumulated
    gradient (the first step's AdamW mu / (1 - b1)) each leaf within
    GRAD_REL of its max |g|, grad_norm rtol 1e-4, the new params at rtol
    = atol = 2e-4 (``_params_close``); the plan's constraint hook is
    active in its step and only there."""
    plan, new, opt_state, metrics, seen = _t_result(arch, k)
    assert plan.description == \
        f"train {arch}-smoke t (microbatches={k})"
    assert common.constrain("x", ("batch",)) == "x"
    assert ("batch", "seq", None) in seen
    if arch == "rwkv6-7b":
        assert ("batch", None, "act_heads", None) in seen
    assert opt_state.step == 1
    assert set(metrics) == {"loss", "grad_norm", "lr"}
    j_loss, j_new, j_metrics, j_grads = _j_result(arch, k)
    opt = OptimizerConfig(**_opt())
    np.testing.assert_allclose(metrics["loss"].item(), j_loss, rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(j_metrics["grad_norm"]), rtol=1e-4)
    mine = dict(flatten_with_paths(new))
    mu = dict(flatten_with_paths(opt_state.mu))
    grads = dict(flatten_with_paths(_carry(j_grads)))
    for path, leaf in flatten_with_paths(_carry(j_new)):
        g = grads[path].numpy()
        got_g = mu[path].numpy() / (1 - opt.b1)
        assert np.abs(got_g - g).max() <= GRAD_REL * np.abs(g).max(), path
        _params_close(mine[path], leaf, g, opt.lr)


def test_microbatches_agree_on_the_port():
    """The JAX test's own check on the port (smollm-360m SMOKE, its
    weights and batch): microbatches 1 and 4 give the same loss (rtol
    1e-5) and params (``_params_close`` against the gradient of 1)."""
    opt = OptimizerConfig(**_opt())
    _, new1, state1, m1, _ = _t_result("smollm-360m", 1)
    _, new4, _, m4, _ = _t_result("smollm-360m", 4)
    np.testing.assert_allclose(m1["loss"].item(), m4["loss"].item(),
                               rtol=1e-5)
    four = dict(flatten_with_paths(new4))
    mu = dict(flatten_with_paths(state1.mu))
    for path, leaf in flatten_with_paths(new1):
        _params_close(four[path], leaf, mu[path].numpy() / (1 - opt.b1),
                      opt.lr)


def test_adam_first_step_amplifies_rounding_in_jax_itself():
    """Why the params bar holds only where |g| >= ADAM_COND: in the JAX
    package alone, microbatches 1 and 4 of rwkv6-7b SMOKE (the JAX
    test's config, weights and batch) give losses within 1e-6 and
    gradients within GRAD_REL of max |g|, yet params more than rtol =
    atol = 2e-4 apart, all where |g| < ADAM_COND. The MoE model's losses
    differ beyond 1e-5 as well: capacity is per dispatch chunk, so a
    microbatch routes and drops other pairs."""
    l1, p1, _, g1 = _j_result("rwkv6-7b", 1)
    l4, p4, _, g4 = _j_result("rwkv6-7b", 4)
    assert abs(l1 - l4) <= 1e-6 * abs(l1)
    off = 0
    for a, b, g, g_4 in zip(jax.tree.leaves(p1), jax.tree.leaves(p4),
                            jax.tree.leaves(g1), jax.tree.leaves(g4)):
        a, b, g, g_4 = (np.asarray(t, np.float32) for t in (a, b, g, g_4))
        assert np.abs(g - g_4).max() <= GRAD_REL * np.abs(g).max()
        bad = np.abs(a - b) > 2e-4 + 2e-4 * np.abs(b)
        assert (np.abs(g[bad]) < ADAM_COND).all()
        off += int(bad.sum())
    assert off > 0
    m1 = _j_result("qwen3-moe-30b-a3b", 1)[0]
    m4 = _j_result("qwen3-moe-30b-a3b", 4)[0]
    assert abs(m1 - m4) > 1e-5 * abs(m1)


def test_train_plan_splits_rows_in_jax_order():
    """Microbatch i is rows [i B/k, (i+1) B/k) of every batch leaf, a
    batch that does not split raises, and default_microbatches picks
    the count when none is given."""
    cfg = dataclasses.replace(get_smoke_arch("smollm-360m"), dtype="float32")
    mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
    shape = InputShape("t", seq_len=8, global_batch=6, kind="train")
    plan = steps.make_train_plan(cfg, shape, mesh, microbatches=3)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    seen = []
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 64, (6, 8)).astype(np.int32),
             "labels": rng.integers(0, 64, (6, 8)).astype(np.int32)}
    inner = type(model).loss_fn

    def recording(self, p, b):
        seen.append(b["tokens"].clone())
        return inner(self, p, b)
    type(model).loss_fn = recording
    try:
        plan.step_fn((params, adamw.init(OptimizerConfig(), params)), batch)
    finally:
        type(model).loss_fn = inner
    assert [t.tolist() for t in seen] == \
        [batch["tokens"][2 * i:2 * i + 2].tolist() for i in range(3)]
    bad = steps.make_train_plan(cfg, shape, mesh, microbatches=4)
    with pytest.raises(ValueError, match="microbatches"):
        bad.step_fn((params, adamw.init(OptimizerConfig(), params)), batch)
    assert "(microbatches=1)" in steps.make_train_plan(
        cfg, shape, mesh).description
