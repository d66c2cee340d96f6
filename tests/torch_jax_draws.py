"""The JAX engine's proxy draws, handed to the port as a ``DrawPlan``.

The JAX engine trains a leaf from ``_train_key(seed, leaf)``, a threefry
key; the port trains from a torch seed, so the two packages' proxies
differ by design. ``engine_plan`` rebuilds the draws the JAX engine
makes for one leaf (initial params, rebalance seed, batch indices and
augmentation noise, as ``train_proxy_multi`` derives them from the
lane's key) and ``port_params`` trains the port's proxy on them, on the
same sample, so the port's params can be held to the JAX params.
Shared by tests/test_torch_leaf_rng.py and tests/torch_leaf_rng.py.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.core import trainer as jtr
from repro_torch.core import trainer as ttr


def lane_draws(ktrain, n_valid, cfg):
    """Batch indices and noise of one lane, as the JAX trainer draws them
    (fold_in(ktrain, t) -> split -> randint / normal)."""
    idx, noise = [], []
    for t in range(cfg.phase1_steps + cfg.phase2_steps):
        kb, kn = jax.random.split(jax.random.fold_in(ktrain, t))
        idx.append(np.asarray(jax.random.randint(
            kb, (cfg.batch_size,), 0, jnp.asarray(n_valid, jnp.int32))))
        noise.append(np.asarray(jax.random.normal(
            kn, (cfg.batch_size, cfg.embed_dim), jnp.float32)))
    return np.stack(idx), np.stack(noise)


def engine_sample(je, leaf, seed):
    """The JAX engine's training sample of ``leaf`` (indices, embeddings,
    labels from the leaf's truth) -- the port draws the same indices."""
    n = len(je.store)
    n_train = min(max(int(je.proxy_cfg.train_fraction * n), 16), n)
    idx = je._train_rng(seed, leaf).choice(n, size=n_train, replace=False)
    return idx, je.store.get(idx)


def engine_plan(je, leaf, seed, sample, labels):
    """One lane's DrawPlan from the key the JAX engine trains ``leaf``
    with at ``seed``."""
    jcfg = je.proxy_cfg
    key = je._train_key(seed, leaf)
    params0, kbals, ktrains = jtr._compiled_multi_init(jcfg)(
        jnp.stack([key]))
    e_bal, _ = (jtr.rebalance(kbals[0], np.asarray(sample),
                              np.asarray(labels), jcfg)
                if jcfg.rebalance else (sample, labels))
    idx, noise = lane_draws(ktrains[0], e_bal.shape[0], jcfg)
    return ttr.DrawPlan(params=jax.tree.map(np.asarray, params0),
                        rebalance_seeds=[jtr._key_seed(kbals[0])],
                        idx=idx[None], noise=noise[None])


def port_params(je, leaf, seed, labels_of, cfg):
    """The port's proxy for ``leaf`` trained on the JAX engine's sample
    and draws; ``labels_of(idx)`` labels the sample."""
    idx, sample = engine_sample(je, leaf, seed)
    labels = labels_of(idx)
    plan = engine_plan(je, leaf, seed, sample, labels)
    res = ttr.train_proxy_multi([0], np.asarray(leaf.e_q)[None], [sample],
                                [labels], cfg, plan=plan, device="cpu")
    return ttr.unstack_params(res.params)[0]
