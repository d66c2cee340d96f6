"""Port parity of the proxy trainer.

The JAX trainer draws its init, batch indices and augmentation noise
from threefry keys, which torch cannot reproduce; the port takes those
draws as an explicit ``DrawPlan``. Here the plan is built from JAX's own
keys, exactly as ``train_proxy(method="steps")`` and
``train_proxy_multi`` draw them, so both trainers see the same numbers
and must agree step by step.

Drift tolerance: every step's loss and the final params agree to 1e-5
(absolute and relative) after 16 steps. The differences are float32
rounding of matmuls summed in another order (measured on the CPU: at
most ~3e-6 in a loss, ~3e-7 in a param); Adam divides each gradient by
its running RMS, which amplifies them for entries whose gradient is
near zero, so longer runs drift further.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ProxyConfig as JProxyCfg
from repro.core import trainer as jtr
from repro.core.encoder import encoder_init
from repro_torch.config import ProxyConfig
from repro_torch.core import trainer as ttr
from repro_torch.core.encoder import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

DIM = 32
CFG = dict(embed_dim=DIM, hidden_dim=64, latent_dim=32, proj_dim=16,
           phase1_steps=8, phase2_steps=8, batch_size=32)
DRIFT = dict(rtol=1e-5, atol=1e-5)


def _sample(n=150, pos_frac=0.3, seed=0):
    rng = np.random.default_rng(seed)
    embeds = rng.normal(size=(n, DIM)).astype(np.float32)
    labels = (rng.random(n) < pos_frac).astype(np.float32)
    e_q = rng.normal(size=DIM).astype(np.float32)
    return e_q, embeds, labels


def _lane_draws(ktrain, n_valid, cfg):
    """Batch indices and noise of one lane, as the JAX trainer draws them
    (``trainer.py``: fold_in(ktrain, t) -> split -> randint / normal)."""
    idx, noise = [], []
    for t in range(cfg.phase1_steps + cfg.phase2_steps):
        kb, kn = jax.random.split(jax.random.fold_in(ktrain, t))
        idx.append(np.asarray(jax.random.randint(
            kb, (cfg.batch_size,), 0, jnp.asarray(n_valid, jnp.int32))))
        noise.append(np.asarray(jax.random.normal(
            kn, (cfg.batch_size, cfg.embed_dim), jnp.float32)))
    return np.stack(idx), np.stack(noise)


def _balanced_n(kbal, embeds, labels, cfg):
    e, _ = jtr.rebalance(kbal, np.asarray(embeds), np.asarray(labels), cfg)
    return e.shape[0]


def _single_plan(key, embeds, labels, jcfg):
    kinit, kbal, ktrain = jax.random.split(key, 3)
    params = jax.tree.map(lambda a: np.asarray(a)[None],
                          encoder_init(kinit, jcfg))
    idx, noise = _lane_draws(ktrain, _balanced_n(kbal, embeds, labels, jcfg),
                             jcfg)
    return ttr.DrawPlan(params=params, rebalance_seeds=[jtr._key_seed(kbal)],
                        idx=idx[None], noise=noise[None])


def _assert_params_close(jparams, tparams):
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **DRIFT)


@pytest.mark.parametrize("pos_frac", [0.3, 0.08])   # 0.08: rebalanced
def test_plan_matches_jax_step_loop(pos_frac):
    jcfg, cfg = JProxyCfg(**CFG), ProxyConfig(**CFG)
    e_q, embeds, labels = _sample(pos_frac=pos_frac)
    key = jax.random.PRNGKey(3)
    ref = jtr.train_proxy(key, e_q, embeds, labels, jcfg, method="steps")
    got = ttr.train_proxy(0, e_q, embeds, labels, cfg,
                          plan=_single_plan(key, embeds, labels, jcfg),
                          device="cpu")
    assert got.phase1_losses.shape == (8,) and got.phase2_losses.shape == (8,)
    np.testing.assert_allclose(got.phase1_losses, ref.phase1_losses, **DRIFT)
    np.testing.assert_allclose(got.phase2_losses, ref.phase2_losses, **DRIFT)
    _assert_params_close(ref.params, got.params)


def test_own_draws_are_per_lane_and_padding_invisible():
    """Without a plan each lane draws from its own seed: a lane trained
    beside others equals the lane trained alone, and is reproducible."""
    cfg = ProxyConfig(**CFG)
    a, b = _sample(seed=1), _sample(n=70, pos_frac=0.5, seed=2)
    multi = ttr.train_proxy_multi([7, 8], np.stack([a[0], b[0]]),
                                  [a[1], b[1]], [a[2], b[2]], cfg,
                                  device="cpu")
    alone = ttr.train_proxy(7, a[0], a[1], a[2], cfg, device="cpu")
    again = ttr.train_proxy(7, a[0], a[1], a[2], cfg, device="cpu")
    lane0 = ttr.unstack_params(multi.params)[0]
    for x, y, z in zip(tree_leaves(lane0), tree_leaves(alone.params),
                       tree_leaves(again.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(y, z)
    np.testing.assert_allclose(multi.phase2_losses[0], alone.phase2_losses,
                               rtol=1e-6, atol=1e-6)
    assert np.isfinite(multi.phase2_losses).all()


def test_rebalance_is_the_reference_numpy_stream():
    jcfg, cfg = JProxyCfg(**CFG), ProxyConfig(**CFG)
    _, embeds, labels = _sample(pos_frac=0.05)
    key = jax.random.PRNGKey(4)
    e_j, y_j = jtr.rebalance(key, embeds, labels, jcfg)
    e_t, y_t = ttr.rebalance(jtr._key_seed(key), embeds, labels, cfg)
    assert e_j.shape[0] > embeds.shape[0]
    np.testing.assert_array_equal(e_t, e_j)
    np.testing.assert_array_equal(y_t, y_j)
    assert ttr._bucket(65) == jtr._bucket(65) == 128


def test_plan_indices_are_checked():
    """Indices past a lane's n_valid would silently read padding rows."""
    jcfg, cfg = JProxyCfg(**CFG), ProxyConfig(**CFG)
    e_q, embeds, labels = _sample(n=100)
    plan = _single_plan(jax.random.PRNGKey(0), embeds, labels, jcfg)
    plan.idx[0, 3, 0] = 100
    with pytest.raises(ValueError, match="n_valid"):
        ttr.train_proxy(0, e_q, embeds, labels, cfg, plan=plan,
                        device="cpu")
