"""Port parity of the RWKV6 blocks and the rwkv6-7b offline path: the
time-mix in both port modes and the channel-mix against the JAX
package's exact ``direct`` mode, the carry of an rwkv6 param tree, the
port's init layout, ``EmbeddingService`` and ``build_index`` on the
rwkv6-7b SMOKE config against the JAX package's, and ``from_corpus``
then ``query()`` on the CPU.

Weights are the JAX package's own init carried across with
``params_from_jax``; inputs are numpy. On the CPU the port's ``kernel``
mode takes the WKV6 wrapper's plain version. Tolerance: 1e-5 in float32
(relative to max |ref| for the blocks, rtol = atol for embeddings).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro.config import get_smoke_arch as j_smoke
from repro.engine import build_index as j_build_index
from repro.engine import ingest_fingerprint as j_fingerprint
from repro.models import build_model as j_build_model
from repro.models import rwkv as j_rwkv
from repro.runtime.serve_loop import EmbeddingService as JService
from repro_torch import checkpoint as t_ckpt
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.config import get_arch as t_arch
from repro_torch.config import get_smoke_arch as t_smoke
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (MemmapStore, ScaleDocEngine, SimulatedOracle,
                                build_index, ingest_fingerprint,
                                load_manifest)
from repro_torch.kernels.wkv6 import ops as w_ops
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import rwkv as t_rwkv
from repro_torch.runtime.serve_loop import EmbeddingService
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "rwkv6-7b"
REL = 1e-5
F32 = dict(rtol=1e-5, atol=1e-5)
# bfloat16 projections round at other places in XLA and PyTorch: two
# bf16 ulps (2 * 2^-8) of max |ref|
BF16_REL = 2 * 2.0 ** -8
N_DOCS, DOC_LEN, BATCH = 96, 12, 8   # above the engine's direct-label cutoff


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_smoke(ARCH), dtype=dtype),
            dataclasses.replace(t_smoke(ARCH), dtype=dtype))


def _carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def test_config_matches_jax():
    """The store's config_digest hashes asdict of the config."""
    from repro.config import get_arch as j_arch
    for full in (True, False):
        j = j_arch(ARCH) if full else j_smoke(ARCH)
        t = t_arch(ARCH) if full else t_smoke(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [40, 131, 200])
def test_timemix_matches_jax_direct(dtype, s):
    """Both port modes against JAX mode="direct". s=40 is one chunk,
    s=131 (prime) is 131 chunks of 1, s=200 is two of 100."""
    jcfg, tcfg = _cfgs(dtype)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = j_rwkv.timemix_init(jax.random.PRNGKey(0), jcfg, jd)
    tp = _carry(jp)
    x = np.random.default_rng(s).normal(size=(2, s, jcfg.d_model)).astype(
        np.float32)
    want = j_rwkv.timemix_apply(jp, jnp.asarray(x, jd), jcfg, mode="direct")
    tol = REL if dtype == "float32" else BF16_REL
    for mode in t_rwkv.MODES:
        got = t_rwkv.timemix_apply(tp, torch.tensor(x).to(tp["wr"].dtype),
                                   tcfg, mode=mode)
        assert got.dtype == tp["wr"].dtype and got.shape == x.shape
        assert _rel_err(got, want) < tol, (mode, _rel_err(got, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channelmix_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = j_rwkv.channelmix_init(jax.random.PRNGKey(1), jcfg, jd)
    x = np.random.default_rng(2).normal(size=(2, 33, jcfg.d_model)).astype(
        np.float32)
    want = j_rwkv.channelmix_apply(jp, jnp.asarray(x, jd), jcfg)
    got = t_rwkv.channelmix_apply(_carry(jp), torch.tensor(x).to(
        dtype=getattr(torch, dtype)), tcfg)
    assert _rel_err(got, want) < (REL if dtype == "float32" else BF16_REL)


def test_groupnorm_uses_the_population_variance():
    x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    scale = np.random.default_rng(4).normal(size=(64,)).astype(np.float32)
    want = j_rwkv._groupnorm_heads(jnp.asarray(x), jnp.asarray(scale), 4,
                                   1e-6)
    got = t_rwkv._groupnorm_heads(torch.tensor(x), torch.tensor(scale), 4,
                                  1e-6)
    assert _rel_err(got, want) < REL


def test_unported_modes_raise():
    """The factored mode runs (``tests/test_torch_factored.py`` holds it
    to JAX), the embedding service takes it, and a mode no package has
    raises ``ValueError``."""
    cfg = t_smoke(ARCH)
    x = torch.randn((1, 4, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    p = t_rwkv.timemix_init(torch.Generator().manual_seed(0), cfg,
                            torch.float32)
    y = t_rwkv.timemix_apply(p, x, cfg, mode="factored")
    assert y.shape == x.shape and torch.isfinite(y).all()
    with pytest.raises(ValueError):
        t_rwkv.timemix_apply(p, x, cfg, mode="pallas")
    service = EmbeddingService(cfg, build_model(cfg).init(
        torch.Generator().manual_seed(0)), device="cpu",
        rwkv_mode="factored")
    assert service.model.rwkv_mode == "factored"
    emb = service.embed_batch(np.array([[3, 1, 4, 1, 5, 9, 0, 0]]))
    assert emb.shape == (1, cfg.d_model) and torch.isfinite(emb).all()


def test_params_from_jax_carries_an_rwkv6_tree():
    """bf16 leaves keep their bits; the f32 leaves (w0, u, ln_x) stay
    f32 beside them."""
    jcfg, _ = _cfgs("bfloat16")
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = _carry(jp)
    flat_j = dict(j_ckpt.checkpoint._flatten_with_paths(jp))
    flat_t = dict(t_ckpt.flatten_with_paths(tp))
    assert sorted(flat_j) == sorted(flat_t)
    f32 = sorted(k for k, v in flat_t.items() if v.dtype == torch.float32)
    assert f32 == [f"blocks/p0/time/{n}" for n in ("ln_x", "u", "w0")]
    for key, leaf in flat_t.items():
        want = np.asarray(flat_j[key])
        assert tuple(leaf.shape) == want.shape, key
        if leaf.dtype == torch.bfloat16:
            np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(leaf.numpy(), want)


def test_params_from_jax_with_a_dtype_keeps_the_f32_leaves_and_state():
    """Carried into bf16 from an f32 tree, w0, u and ln_x stay f32 (as
    the port's own bf16 init draws them) and so does a carried cache's
    WKV state; the other leaves take the dtype."""
    jcfg, _ = _cfgs("float32")
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                         torch.bfloat16)
    f32 = sorted(k for k, v in t_ckpt.flatten_with_paths(tp)
                 if v.dtype == torch.float32)
    assert f32 == [f"blocks/p0/time/{n}" for n in ("ln_x", "u", "w0")]
    toks = np.random.default_rng(1).integers(1, 256, size=(2, 9))
    _, jcache = jm.prefill(jp, jnp.asarray(toks, jnp.int32))
    cache = params_from_jax(jax.tree.map(np.asarray, jcache), "cpu",
                            torch.bfloat16)
    assert cache["p0"]["wkv"].dtype == torch.float32
    assert cache["p0"]["shift_t"].dtype == torch.bfloat16
    np.testing.assert_array_equal(cache["p0"]["wkv"].numpy(),
                                  np.asarray(jcache["p0"]["wkv"]))


def test_port_init_has_the_jax_layout():
    jcfg, tcfg = _cfgs("bfloat16")
    tp = build_model(tcfg).init(torch.Generator().manual_seed(0))
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    want = {k: (v.shape, str(v.dtype)) for k, v in
            j_ckpt.checkpoint._flatten_with_paths(jp)}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in t_ckpt.flatten_with_paths(tp)}
    assert got == want


@pytest.fixture(scope="module")
def services():
    jcfg, tcfg = _cfgs()
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    return (JService(jcfg, jp, batch_size=BATCH),
            EmbeddingService(tcfg, _carry(jp), batch_size=BATCH,
                             device="cpu"))


@pytest.fixture(scope="module")
def docs():
    corpus = make_corpus(seed=0, n_docs=N_DOCS, dim=16, with_tokens=True,
                         vocab=256, doc_len=DOC_LEN)
    return [corpus.tokens[i] for i in range(N_DOCS)]


def test_embed_batch_matches_jax(services):
    j_svc, t_svc = services
    tokens = np.random.default_rng(0).integers(
        0, 256, size=(4, 21)).astype(np.int32)
    tokens[1, 9:] = 0                    # a short document
    tokens[2, :] = 0                     # a pad row pools to zeros
    want = np.asarray(j_svc.embed_batch(jnp.asarray(tokens)))
    before = w_ops.KERNEL.launches
    got = t_svc.embed_batch(tokens)
    assert w_ops.KERNEL.launches == before
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert not got[2].any()


def test_build_index_matches_jax(services, docs, tmp_path):
    """Manifest (fingerprint included) and stats equal. Rows: 99% of the
    elements to 1e-5 (rtol = atol), and all of them to twice the JAX
    package's own float32 spread. A head whose time-mix output is near
    zero at t = 0 (y_0 = (r.u.k) v_0 with r.u.k cancelling) is scaled by
    up to 1/sqrt(eps) = 1e3 in the group norm, so the order of a 16-term
    sum moves its row by ~1e-5: the JAX package's own embeddings of these
    documents one at a time differ from its batches of 8 by up to
    1.8e-5."""
    j_svc, t_svc = services
    fp = dict(commit_every_batches=2, pad_width_to=16, data_shards=1)
    assert ingest_fingerprint(t_svc, **fp) == j_fingerprint(j_svc, **fp)
    kw = dict(commit_every_batches=2)
    j_res = j_build_index(j_svc, docs, tmp_path / "jax", **kw)
    t_res = build_index(t_svc, docs, tmp_path / "torch", **kw)
    assert load_manifest(tmp_path / "torch") == load_manifest(
        tmp_path / "jax")
    assert (t_res.stats.docs, t_res.stats.batches, t_res.stats.commits) == (
        j_res.stats.docs, j_res.stats.batches, j_res.stats.commits)
    idx = np.arange(N_DOCS)
    want = j_res.store.get(idx)
    j_one = JService(j_svc.cfg, j_svc.params, batch_size=1)
    alone = np.concatenate([np.asarray(j_one.embed_batch(jnp.asarray(
        np.pad(d, (0, 16 - len(d)))[None]))) for d in docs])
    spread = np.abs(alone - want).max()
    err = np.abs(t_res.store.get(idx) - want)
    assert err.max() <= 2 * spread, (err.max(), spread)
    assert (err <= 1e-5 + 1e-5 * np.abs(want)).mean() > 0.99


def test_from_corpus_then_query_on_cpu(services, docs, tmp_path):
    _, t_svc = services
    pcfg = ProxyConfig(embed_dim=64, hidden_dim=64, latent_dim=32,
                       proj_dim=8, phase1_steps=8, phase2_steps=8,
                       batch_size=16)
    engine = ScaleDocEngine.from_corpus(
        t_svc, docs, tmp_path, proxy_cfg=pcfg,
        cascade_cfg=CascadeConfig(accuracy_target=0.85), chunk=16,
        device="cpu", ingest_kwargs=dict(commit_every_batches=2))
    assert isinstance(engine.store, MemmapStore)
    assert len(engine.store) == N_DOCS and engine.store.dim == 64
    corpus = make_corpus(seed=0, n_docs=N_DOCS, dim=16, with_tokens=True,
                         vocab=256, doc_len=DOC_LEN)
    query = make_query(corpus, seed=7, selectivity=0.3)
    e_q = engine.store.get(np.nonzero(query.truth)[0][:4]).mean(axis=0)
    e_q = (e_q / np.linalg.norm(e_q)).astype(np.float32)
    st = engine.query(e_q, SimulatedOracle(query.truth),
                      ground_truth=query.truth, seed=0)
    assert st.scores.shape == (N_DOCS,) and np.isfinite(st.scores).all()
    assert st.oracle_calls_total <= N_DOCS
