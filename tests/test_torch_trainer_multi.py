"""Port parity of the multi-lane proxy trainer: a ``DrawPlan`` built
from JAX's own keys, as ``train_proxy_multi`` draws them lane by lane,
against the vmapped JAX trainer (tolerance and its reason:
test_torch_trainer.py)."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.config.base import ProxyConfig as JProxyCfg
from repro.core import trainer as jtr
from repro_torch.config import ProxyConfig
from repro_torch.core import trainer as ttr
from test_torch_trainer import (CFG, DRIFT, _assert_params_close,
                                _balanced_n, _lane_draws, _sample)
from torch_threads import one_torch_thread  # noqa: F401


def test_plan_matches_jax_multi():
    """Ragged samples in one padded multi-lane run, against the vmapped
    JAX trainer lane by lane."""
    jcfg, cfg = JProxyCfg(**CFG), ProxyConfig(**CFG)
    sets = [_sample(n=n, pos_frac=f, seed=s)
            for s, (n, f) in enumerate([(150, 0.3), (90, 0.1), (200, 0.5)])]
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
    e_qs = np.stack([s[0] for s in sets])
    samples, labels = [s[1] for s in sets], [s[2] for s in sets]
    ref = jtr.train_proxy_multi(keys, e_qs, samples, labels, jcfg)
    params0, kbals, ktrains = jtr._compiled_multi_init(jcfg)(jnp.stack(keys))
    draws = [_lane_draws(ktrains[i], _balanced_n(kbals[i], samples[i],
                                                 labels[i], jcfg), jcfg)
             for i in range(3)]
    plan = ttr.DrawPlan(
        params=jax.tree.map(np.asarray, params0),
        rebalance_seeds=[jtr._key_seed(k) for k in kbals],
        idx=np.stack([d[0] for d in draws]),
        noise=np.stack([d[1] for d in draws]))
    got = ttr.train_proxy_multi([0, 0, 0], e_qs, samples, labels, cfg,
                                plan=plan, device="cpu")
    assert got.phase1_losses.shape == (3, 8)
    np.testing.assert_allclose(got.phase1_losses, ref.phase1_losses, **DRIFT)
    np.testing.assert_allclose(got.phase2_losses, ref.phase2_losses, **DRIFT)
    _assert_params_close(ref.params, got.params)
