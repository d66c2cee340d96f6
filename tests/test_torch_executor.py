"""Port parity of the scoring layer: the streaming executor over
in-memory and memory-mapped stores against the JAX package's
``ScoringExecutor(use_kernel=True, interpret=True)``, and the plain
scoring path against ``repro.core.scoring``; 1e-5 in float32
(tests/test_kernels.py's tolerance)."""
import jax
import numpy as np
import pytest

from repro.config.base import ProxyConfig as JProxyCfg
from repro.core import scoring as j_scoring
from repro.core.encoder import encoder_init
from repro.engine import store as j_store
from repro.engine.executor import ScoringExecutor as JExecutor
from repro_torch.core import scoring as t_scoring
from repro_torch.core.encoder import params_from_jax
from repro_torch.engine import (InMemoryStore, MemmapStore,
                                ScoringExecutor, as_store)

F32 = dict(rtol=1e-5, atol=1e-5)
D = 48


@pytest.fixture(scope="module")
def setup():
    cfg = JProxyCfg(embed_dim=D, hidden_dim=64, latent_dim=64, proj_dim=8)
    pa = jax.tree.map(np.asarray, encoder_init(jax.random.PRNGKey(0), cfg))
    pb = jax.tree.map(np.asarray, encoder_init(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(300, D)).astype(np.float32)
    e = rng.normal(size=(4, D)).astype(np.float32)
    return pa, pb, docs, e


def _stores(kind, docs, tmp_path):
    if kind == "memory":
        return j_store.InMemoryStore(docs), InMemoryStore(docs)
    if kind == "npy":
        np.save(tmp_path / "e.npy", docs)
        return (j_store.MemmapStore.from_npy(str(tmp_path / "e.npy")),
                MemmapStore.from_npy(str(tmp_path / "e.npy")))
    # a store directory written by the JAX package's StoreWriter
    with j_store.StoreWriter.open(tmp_path / "dir", dim=D) as w:
        w.append(docs)
        w.commit()
    return (j_store.MemmapStore.open(tmp_path / "dir"),
            MemmapStore.open(tmp_path / "dir"))


@pytest.mark.parametrize("kind", ["memory", "npy", "directory"])
def test_executor_matches_jax(setup, kind, tmp_path):
    pa, pb, docs, e = setup
    j_st, t_st = _stores(kind, docs, tmp_path)
    ta, tb = params_from_jax(pa), params_from_jax(pb)
    j_jobs = [(pa, e[0]), (None, e[1]), (pb, e[2]), (pa, e[3])]
    t_jobs = [(ta, e[0]), (None, e[1]), (tb, e[2]), (ta, e[3])]
    j_out, j_stats = JExecutor(chunk=128, use_kernel=True,
                               interpret=True).score_multi(j_jobs, j_st)
    t_out, t_stats = ScoringExecutor(chunk=128, device="cpu").score_multi(
        t_jobs, t_st)
    np.testing.assert_allclose(t_out, j_out, **F32)
    for f in ("docs_scored", "queries_scored", "tiles_scored",
              "bytes_streamed"):
        assert getattr(t_stats, f) == getattr(j_stats, f), f
    assert t_stats.paths == ("fused", "matmul")
    s, st = ScoringExecutor(chunk=128, device="cpu").score(ta, e[0], t_st)
    np.testing.assert_allclose(s, j_out[:, 0], **F32)
    assert st.tiles_scored == 3 and st.queries_scored == 1


def test_executor_surfaces_producer_errors():
    class Broken(InMemoryStore):
        def iter_chunks(self, chunk=8192):
            yield 0, self._embeds[:chunk]
            raise OSError("disk gone")

    store = Broken(np.zeros((300, D), np.float32))
    with pytest.raises(OSError, match="disk gone"):
        ScoringExecutor(chunk=128, device="cpu").score(None, np.ones(D),
                                                       store)


def test_plain_scoring_matches_jax(setup):
    pa, pb, docs, e = setup
    ta = params_from_jax(pa)
    np.testing.assert_allclose(
        t_scoring.score_collection(ta, e[0], docs, chunk=128, device="cpu"),
        j_scoring.score_collection(pa, e[0], docs, chunk=128), **F32)
    np.testing.assert_allclose(
        t_scoring.score_collection_multi([(ta, e[0]), (None, e[1])],
                                         as_store(docs), chunk=128,
                                         device="cpu"),
        j_scoring.score_collection_multi([(pa, e[0]), (None, e[1])], docs,
                                         chunk=128), **F32)
    np.testing.assert_allclose(
        t_scoring.direct_embedding_scores(e[0], docs, device="cpu"),
        j_scoring.direct_embedding_scores(e[0], docs), **F32)
    groups, stacks = t_scoring.group_jobs(
        [(ta, e[0]), (None, e[1]), (ta, e[2])], "cpu")
    assert [cols for _, cols in groups] == [[0, 2], [1]]
    assert tuple(stacks[0].shape) == (2, 64)
