"""Port parity: proxy encoder, the three contrastive losses, their
autograd gradients and one AdamW step, against the JAX package on the
same numpy inputs, to 1e-5 in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import OptimizerConfig as JOptCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core import encoder as jenc
from repro.core import losses as jlosses
from repro.optimizer import adamw as jadamw
from repro_torch.config import OptimizerConfig, ProxyConfig
from repro_torch.core import encoder as tenc
from repro_torch.core import losses as tlosses
from repro_torch.optimizer import adamw as tadamw
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)   # float32, the reference kernel tolerance
CFG = dict(embed_dim=32, hidden_dim=64, latent_dim=32, proj_dim=16)


def _params(seed=0):
    return jax.tree.map(np.asarray,
                        jenc.encoder_init(jax.random.PRNGKey(seed),
                                          JProxyCfg(**CFG)))


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _batch(n=24, p=16, pos_frac=0.4, seed=1):
    rng = np.random.default_rng(seed)
    zq = rng.normal(size=p).astype(np.float32)
    zd = rng.normal(size=(n, p)).astype(np.float32)
    y = (rng.random(n) < pos_frac).astype(np.float32)
    y[0], y[1] = 1.0, 0.0
    return zq, zd, y


def test_encoder_matches_jax():
    params = _params()
    tp = tenc.params_from_jax(params)
    x = np.random.default_rng(0).normal(size=(20, 32)).astype(np.float32)
    z_j = jenc.encoder_apply(params, jnp.asarray(x))
    z_t = tenc.encoder_apply(tp, _t(x))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **TOL)
    np.testing.assert_allclose(
        tenc.projector_apply(tp, z_t).numpy(),
        np.asarray(jenc.projector_apply(params, z_j)), **TOL)
    np.testing.assert_allclose(
        tenc.decision_scores(tp, _t(x[0]), _t(x)).numpy(),
        np.asarray(jenc.decision_scores(params, jnp.asarray(x[0]),
                                        jnp.asarray(x))), **TOL)
    back = tenc.params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; the erf form
    differs by ~4e-4 on [-4, 4], far above the tolerance."""
    x = np.linspace(-4, 4, 801, dtype=np.float32)
    np.testing.assert_allclose(tenc.gelu(_t(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               **TOL)
    erf = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() > 1e-4


def test_encoder_init_distribution():
    """Truncated normal in [-2, 2] scaled by 1/sqrt(fan_in)."""
    g = torch.Generator().manual_seed(0)
    p = tenc.encoder_init(g, ProxyConfig(embed_dim=400, hidden_dim=256,
                                         latent_dim=128, proj_dim=64))
    w = p["layers"]["l0"]["w"].numpy() * np.sqrt(400)
    assert w.shape == (400, 256) and np.abs(w).max() <= 2.0
    assert abs(w.std() - 0.88) < 0.02      # std of N(0,1) cut to [-2, 2]
    assert not p["layers"]["l0"]["b"].any()


@pytest.mark.parametrize("variant", ["perpos", "sum"])
@pytest.mark.parametrize("pos_frac", [0.0, 0.4, 1.0])
def test_qsim_matches_jax(variant, pos_frac):
    zq, zd, y = _batch()
    if pos_frac in (0.0, 1.0):
        y[:] = pos_frac
    j = jlosses.qsim_loss(jnp.asarray(zq), jnp.asarray(zd), jnp.asarray(y),
                          0.07, variant)
    t = tlosses.qsim_loss(_t(zq), _t(zd), _t(y), 0.07, variant)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("case", ["mixed", "all_pos", "all_neg", "tie",
                                  "singleton_class"])
def test_supcon_polar_match_jax(case):
    zq, zd, y = _batch()
    if case == "all_pos":
        y[:] = 1.0
    elif case == "all_neg":
        y[:] = 0.0
    elif case == "tie":
        # two identical weakest positives / hardest negatives: the
        # bellwether is the first index, in both packages
        zd[5] = zd[3]
        y[3] = y[5] = 1.0
        zd[9] = zd[7]
        y[7] = y[9] = 0.0
    elif case == "singleton_class":
        y[:] = 0.0
        y[4] = 1.0          # anchor 4 has an empty U(i)
    args_j = (jnp.asarray(zq), jnp.asarray(zd), jnp.asarray(y))
    args_t = (_t(zq), _t(zd), _t(y))
    np.testing.assert_allclose(
        tlosses.supcon_loss(args_t[1], args_t[2], 0.07).numpy(),
        np.asarray(jlosses.supcon_loss(args_j[1], args_j[2], 0.07)), **TOL)
    np.testing.assert_allclose(
        tlosses.polar_loss(*args_t, 0.07).numpy(),
        np.asarray(jlosses.polar_loss(*args_j, 0.07)), **TOL)
    np.testing.assert_allclose(
        tlosses.phase2_loss(*args_t, 0.07, 0.2).numpy(),
        np.asarray(jlosses.phase2_loss(*args_j, 0.07, 0.2)), **TOL)


def test_losses_batch_over_lanes():
    """A leading lane axis gives each lane's own value."""
    lanes = [_batch(seed=s) for s in range(3)]
    zq = _t(np.stack([b[0] for b in lanes]))
    zd = _t(np.stack([b[1] for b in lanes]))
    y = _t(np.stack([b[2] for b in lanes]))
    batched = tlosses.phase2_loss(zq, zd, y, 0.07, 0.2)
    single = torch.stack([tlosses.phase2_loss(zq[i], zd[i], y[i], 0.07, 0.2)
                          for i in range(3)])
    np.testing.assert_allclose(batched.numpy(), single.numpy(), **TOL)


@pytest.mark.parametrize("phase", [1, 2])
def test_loss_gradients_match_jax(phase):
    """Gradients w.r.t. the encoder params of the phase losses, through
    the encoder and projector."""
    params = _params()
    rng = np.random.default_rng(3)
    e_q = rng.normal(size=32).astype(np.float32)
    xb = rng.normal(size=(24, 32)).astype(np.float32)
    yb = (rng.random(24) < 0.4).astype(np.float32)

    def jloss(p):
        zq = jenc.projector_apply(p, jenc.encoder_apply(p, e_q))
        zd = jenc.projector_apply(p, jenc.encoder_apply(p, xb))
        if phase == 1:
            return jlosses.phase1_loss(zq, zd, yb, 0.07)
        return jlosses.phase2_loss(zq, zd, yb, 0.07, 0.2)

    g_j = jax.grad(jloss)(params)
    tp = tenc.params_from_jax(params)
    tenc.tree_map(lambda t: t.requires_grad_(True), tp)
    zq = tenc.projector_apply(tp, tenc.encoder_apply(tp, _t(e_q)))
    zd = tenc.projector_apply(tp, tenc.encoder_apply(tp, _t(xb)))
    loss = (tlosses.phase1_loss(zq, zd, _t(yb), 0.07) if phase == 1
            else tlosses.phase2_loss(zq, zd, _t(yb), 0.07, 0.2))
    loss.backward()
    for a, b in zip(jax.tree.leaves(g_j), tenc.tree_leaves(tp)):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("step", [0, 3, 7, 40])
def test_schedule_matches_jax(step):
    cfg = dict(lr=1e-3, warmup_steps=5, total_steps=60, schedule="cosine")
    j = float(jadamw.schedule(JOptCfg(**cfg), jnp.asarray(step)))
    assert tadamw.schedule(OptimizerConfig(**cfg), step) == pytest.approx(
        j, rel=1e-6)


@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_adamw_step_matches_jax(clip):
    """One update with clipping (active at 1e-3), lr at step + 1, and
    decay on matrices only."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               grad_clip=clip)
    params = _params()
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    st_j = jadamw.init(JOptCfg(**cfg), params)
    st_t = tadamw.init(OptimizerConfig(**cfg), tenc.params_from_jax(params))
    p_t, g_t = tenc.params_from_jax(params), tenc.params_from_jax(grads)
    p_j = params
    for _ in range(2):
        p_j, st_j = jadamw.update(JOptCfg(**cfg), p_j, grads, st_j)
        p_t, st_t = tadamw.update(OptimizerConfig(**cfg), p_t, g_t, st_t)
    assert st_t.step == int(st_j.step) == 2
    for a, b in zip(jax.tree.leaves(p_j), tenc.tree_leaves(p_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    for a, b in zip(jax.tree.leaves(st_j.nu), tenc.tree_leaves(st_t.nu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_adamw_lanes_clip_each_lane_alone():
    """With a lane axis every lane is clipped by its own global norm:
    the stacked update equals per-lane updates."""
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                          grad_clip=0.5)
    rng = np.random.default_rng(0)
    p = {"w": _t(rng.normal(size=(3, 4, 5))), "b": _t(rng.normal(size=(3, 5)))}
    g = {"w": _t(rng.normal(size=(3, 4, 5)) * np.array([1, 10, 100])[:, None,
                                                                      None]),
         "b": _t(rng.normal(size=(3, 5)))}
    stacked, _ = tadamw.update(cfg, p, g, tadamw.init(cfg, p), lanes=True)
    for i in range(3):
        pi = {k: v[i] for k, v in p.items()}
        gi = {k: v[i] for k, v in g.items()}
        one, _ = tadamw.update(cfg, pi, gi, tadamw.init(cfg, pi))
        for k in p:
            np.testing.assert_allclose(stacked[k][i].numpy(),
                                       one[k].numpy(), **TOL)


def test_cosine_matches_jax():
    """``encoder.cosine`` over the last axis, broadcasting, 1e-6."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 3, 16)).astype(np.float32)
    b = rng.normal(size=(3, 16)).astype(np.float32)
    a[0, 0] = 0.0                          # a zero row: the eps clamp
    want = np.asarray(jenc.cosine(jnp.asarray(a), jnp.asarray(b)))
    got = tenc.cosine(_t(a), _t(b))
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
