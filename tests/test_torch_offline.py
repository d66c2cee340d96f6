"""Port parity of the offline representation phase: tokens, the LM's
building blocks, ``EmbeddingService``, the store's write side, the
resumable ``Ingestor``/``build_index`` and ``ScaleDocEngine.from_corpus``.

The JAX package is the reference, run on the CPU as its own tests run it
(the model's default ``"blocked"`` attention there; the port's CPU path
takes the flash wrapper's plain version). Weights are the JAX package's
own init carried across with ``params_from_jax``; inputs are numpy.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro.config import get_smoke_arch as j_smoke
from repro.config.base import ModelConfig as JModelConfig
from repro.data import make_corpus as j_make_corpus
from repro.engine import MemmapStore as JMemmapStore
from repro.engine import build_index as j_build_index
from repro.engine import ingest_fingerprint as j_fingerprint
from repro.models import build_model as j_build_model
from repro.models import common as j_common
from repro.runtime.serve_loop import EmbeddingService as JService
from repro_torch import checkpoint as t_ckpt
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.config import ModelConfig
from repro_torch.config import get_smoke_arch as t_smoke
from repro_torch.data import make_corpus, make_query
from repro_torch.data.synthetic import sample_tokens
from repro_torch.engine import (Ingestor, MemmapStore, ScaleDocEngine,
                                SimulatedOracle, StoreFingerprintError,
                                StoreWriter, build_index, ingest_fingerprint,
                                load_manifest)
from repro_torch.engine.ingest import PRODUCER_NOTE, producer_note
from repro_torch.engine.store import DATA_NAME
from repro_torch.models import build_model
from repro_torch.models import common as t_common
from repro_torch.models import params_from_jax
from repro_torch.runtime.serve_loop import EmbeddingService

N_DOCS, DOC_LEN, BATCH = 96, 12, 8
# tests/test_ingest.py's service config
INGEST_CFG = dict(name="ingest-test", num_layers=2, d_model=32, num_heads=2,
                  num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
                  remat="none")
F32 = dict(rtol=1e-5, atol=1e-5)


def _services(jcfg, tcfg, batch_size=BATCH):
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return (JService(jcfg, jparams, batch_size=batch_size),
            EmbeddingService(tcfg, tparams, batch_size=batch_size,
                             device="cpu"))


@pytest.fixture(scope="module")
def services():
    return _services(JModelConfig(**INGEST_CFG), ModelConfig(**INGEST_CFG))


@pytest.fixture(scope="module")
def docs():
    corpus = make_corpus(seed=0, n_docs=N_DOCS, dim=16, with_tokens=True,
                         vocab=64, doc_len=DOC_LEN)
    return [corpus.tokens[i] for i in range(N_DOCS)]


def _bin_bytes(directory) -> bytes:
    return (pathlib.Path(directory) / DATA_NAME).read_bytes()


# -- tokens ---------------------------------------------------------------


@pytest.mark.parametrize("seed,vocab,doc_len", [(0, 64, 12), (1, 256, 48),
                                                (7, 1000, 5), (3, 32768, 64)])
def test_corpus_tokens_match_jax(seed, vocab, doc_len):
    kw = dict(n_docs=40, dim=16, with_tokens=True, vocab=vocab,
              doc_len=doc_len)
    want = j_make_corpus(seed, **kw)
    got = make_corpus(seed, **kw)
    assert got.tokens.dtype == np.int32 and got.tokens.shape == (40, doc_len)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.embeds, want.embeds)


def test_sample_tokens_maps_past_the_cdf_to_zero():
    """A u at or above the row's last cdf entry has no index whose cdf
    exceeds it: the JAX package's argmax of an all-false row gives 0."""
    cdf = np.array([[0.2, 0.5, 0.9]])
    u = np.array([[0.0, 0.2, 0.49, 0.5, 0.89, 0.9, 0.95]])
    got = sample_tokens(cdf, u)
    want = (u[..., None] < cdf[:, None, :]).argmax(-1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0, 1, 1, 2, 2, 0, 0]])


# -- building blocks ------------------------------------------------------


def test_rmsnorm_rope_activation_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        t_common.rmsnorm_apply({"scale": torch.tensor(scale)},
                               torch.tensor(x)).numpy(),
        np.asarray(j_common.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                          jnp.asarray(x))), **F32)
    pos = np.arange(7)
    np.testing.assert_allclose(
        t_common.apply_rope(torch.tensor(x), torch.tensor(pos),
                            500000.0).numpy(),
        np.asarray(j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       500000.0)), **F32)
    for name in ("silu", "gelu", "relu", "gelu_tanh"):
        np.testing.assert_allclose(
            t_common.activation(name)(torch.tensor(x)).numpy(),
            np.asarray(j_common.activation(name)(jnp.asarray(x))), **F32)


def test_params_from_jax_keeps_layout_and_bf16_bits():
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), dtype="bfloat16")
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    flat_j = dict(j_ckpt.checkpoint._flatten_with_paths(jp))
    flat_t = dict(t_ckpt.flatten_with_paths(tp))
    assert sorted(flat_j) == sorted(flat_t)
    for key, leaf in flat_t.items():
        assert leaf.dtype == torch.bfloat16
        assert tuple(leaf.shape) == flat_j[key].shape
        np.testing.assert_array_equal(
            leaf.view(torch.int16).numpy(),
            np.asarray(flat_j[key]).view(np.int16))


def test_port_init_has_the_jax_layout():
    cfg = t_smoke("llama3-8b")
    from repro_torch.models import build_model
    tp = build_model(cfg).init(torch.Generator().manual_seed(0))
    jp = j_build_model(j_smoke("llama3-8b")).init(jax.random.PRNGKey(0))
    shapes_j = {k: v.shape for k, v in j_ckpt.checkpoint
                ._flatten_with_paths(jp)}
    shapes_t = {k: tuple(v.shape) for k, v in t_ckpt.flatten_with_paths(tp)}
    assert shapes_t == shapes_j


# -- EmbeddingService -----------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3-8b-smoke", "ingest-test"])
def test_embed_batch_matches_jax(arch):
    if arch == "ingest-test":
        jcfg, tcfg = JModelConfig(**INGEST_CFG), ModelConfig(**INGEST_CFG)
    else:
        jcfg, tcfg = j_smoke("llama3-8b"), t_smoke("llama3-8b")
    j_svc, t_svc = _services(jcfg, tcfg, batch_size=4)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(4, 21)).astype(np.int32)
    tokens[1, 9:] = 0                    # a short document
    tokens[2, :] = 0                     # a pad row pools to zeros
    tokens[3, 4] = 0                     # id 0 inside a document is pad
    want = np.asarray(j_svc.embed_batch(jnp.asarray(tokens)))
    got = t_svc.embed_batch(tokens)
    assert got.dtype == torch.float32 and got.shape == (4, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert not got[2].any()


def test_embed_documents_matches_jax(services, docs):
    j_svc, t_svc = services
    ragged = [d[:n] for d, n in zip(docs[:11], range(2, 13))]
    np.testing.assert_allclose(t_svc.embed_documents(ragged),
                               j_svc.embed_documents(ragged), **F32)


# -- fingerprint and build_index across the two packages ------------------


def test_ingest_fingerprint_matches_jax(services):
    j_svc, t_svc = services
    kw = dict(commit_every_batches=2, pad_width_to=16, data_shards=1)
    assert ingest_fingerprint(t_svc, **kw) == j_fingerprint(j_svc, **kw)


def test_build_index_matches_jax_and_stores_interoperate(services, docs,
                                                         tmp_path):
    j_svc, t_svc = services
    j_res = j_build_index(j_svc, docs, tmp_path / "jax",
                          commit_every_batches=2)
    t_res = build_index(t_svc, docs, tmp_path / "torch",
                        commit_every_batches=2)
    assert load_manifest(tmp_path / "torch") == load_manifest(
        tmp_path / "jax")
    assert dataclasses.asdict(t_res.stats).keys() == dataclasses.asdict(
        j_res.stats).keys()
    assert (t_res.stats.docs, t_res.stats.batches, t_res.stats.commits) == (
        j_res.stats.docs, j_res.stats.batches, j_res.stats.commits)
    idx = np.arange(N_DOCS)
    np.testing.assert_allclose(t_res.store.get(idx), j_res.store.get(idx),
                               **F32)
    # each package reads the other's store
    np.testing.assert_array_equal(
        MemmapStore.open(tmp_path / "jax").get(idx), j_res.store.get(idx))
    np.testing.assert_array_equal(
        JMemmapStore.open(tmp_path / "torch").get(idx), t_res.store.get(idx))


def test_checkpoints_interoperate(tmp_path):
    tree = {"docs": np.int64(96), "wall": np.float64(1.5),
            "w": {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    t_ckpt.save(str(tmp_path / "t"), 7, tree, metadata={"rows": 7})
    j_tree, j_man = j_ckpt.restore(str(tmp_path / "t"), 7, tree)
    assert j_man["metadata"] == {"rows": 7}
    np.testing.assert_array_equal(np.asarray(j_tree["w"]["a"]),
                                  tree["w"]["a"])
    j_ckpt.save(str(tmp_path / "j"), 3, tree)
    got, _ = t_ckpt.restore(str(tmp_path / "j"), 3, tree)
    assert int(got["docs"]) == 96 and float(got["wall"]) == 1.5
    np.testing.assert_array_equal(got["w"]["a"], tree["w"]["a"])
    for s in (9, 11, 13):
        t_ckpt.save(str(tmp_path / "t"), s, tree)
    t_ckpt.gc_old_steps(str(tmp_path / "t"), 2)
    assert t_ckpt.list_steps(str(tmp_path / "t")) == [11, 13]
    assert t_ckpt.latest_step(str(tmp_path / "t")) == 13


# -- the port's own durability --------------------------------------------


def test_interrupted_resume_is_bit_identical(services, docs, tmp_path):
    """Kill mid-run (row-count cap), resume, and the final store is
    byte-identical to a single uninterrupted run."""
    _, t_svc = services
    ing = Ingestor(t_svc, commit_every_batches=2)
    full = ing.ingest(docs, tmp_path / "full")
    assert not full.interrupted and len(full.store) == N_DOCS
    kill_at = 37                        # mid-batch, mid-commit-group
    part = ing.ingest(docs, tmp_path / "killed", max_docs=kill_at)
    assert part.interrupted
    assert len(part.store) == (kill_at // (2 * BATCH)) * (2 * BATCH)
    torn = len(_bin_bytes(tmp_path / "killed")) - part.store.manifest.nbytes
    assert torn == (kill_at - len(part.store)) * 32 * 4
    resumed = ing.ingest(docs, tmp_path / "killed")
    assert not resumed.interrupted
    assert resumed.stats.resumed_rows == len(part.store)
    assert _bin_bytes(tmp_path / "killed") == _bin_bytes(tmp_path / "full")
    assert resumed.job_stats.docs == N_DOCS
    assert resumed.job_stats.commits == full.stats.commits
    again = ing.ingest(docs, tmp_path / "full")   # complete: no work
    assert again.stats.docs == 0 and again.stats.batches == 0


def test_ingest_guards_producer_and_corpus(services, docs, tmp_path):
    _, t_svc = services
    ing = Ingestor(t_svc, commit_every_batches=2)
    ing.ingest(docs, tmp_path, max_docs=BATCH * 2)
    with pytest.raises(StoreFingerprintError):
        Ingestor(t_svc, commit_every_batches=4).ingest(docs, tmp_path)
    other = [np.array(d) for d in docs]
    other[40] = other[40].copy()
    other[40][0] = (other[40][0] + 1) % 64
    with pytest.raises(StoreFingerprintError):
        ing.ingest(other, tmp_path)
    with pytest.raises(NotImplementedError):
        Ingestor(t_svc, mesh=object())


def _smoke_service(arch, **modes):
    cfg = t_smoke(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    return EmbeddingService(cfg, params, batch_size=4, device="cpu", **modes)


def _smoke_docs(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, size=10).astype(np.int32)
            for _ in range(16)]


@pytest.mark.parametrize("arch,modes,revisions", [
    ("rwkv6-7b", dict(rwkv_mode="direct"), {"wkv6": 2}),
    ("llama3-8b", dict(attn_impl="blocked"), {"flash_attention": 2})])
def test_resume_under_other_arithmetic_raises(arch, modes, revisions,
                                              tmp_path):
    """The manifest's fingerprint does not see the attention path or the
    time-mix mode; the producer note beside it does."""
    svc = _smoke_service(arch)
    docs = _smoke_docs(svc.cfg.vocab_size)
    ing = Ingestor(svc, commit_every_batches=1)
    assert ing.ingest(docs, tmp_path, max_docs=8).interrupted
    note = json.loads((tmp_path / PRODUCER_NOTE).read_text())
    assert note == producer_note(svc)
    assert note["revisions"] == revisions
    other = _smoke_service(arch, **modes)
    other.params = svc.params
    assert ingest_fingerprint(other, commit_every_batches=1,
                              pad_width_to=16, data_shards=1) == \
        ingest_fingerprint(svc, commit_every_batches=1, pad_width_to=16,
                           data_shards=1)
    with pytest.raises(StoreFingerprintError, match="other arithmetic"):
        Ingestor(other, commit_every_batches=1).ingest(docs, tmp_path)
    assert len(MemmapStore.open(tmp_path)) == 8


def test_resume_of_rows_without_a_producer_note_raises(tmp_path):
    svc = _smoke_service("rwkv6-7b")
    docs = _smoke_docs(svc.cfg.vocab_size)
    ing = Ingestor(svc, commit_every_batches=1)
    ing.ingest(docs, tmp_path, max_docs=8)
    (tmp_path / PRODUCER_NOTE).unlink()
    with pytest.raises(StoreFingerprintError, match="no producer.json"):
        ing.ingest(docs, tmp_path)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "llama3-8b"])
def test_unchanged_resume_at_smoke_is_bit_identical(arch, tmp_path):
    svc = _smoke_service(arch)
    docs = _smoke_docs(svc.cfg.vocab_size)
    ing = Ingestor(svc, commit_every_batches=1)
    full = ing.ingest(docs, tmp_path / "full")
    assert not full.interrupted
    assert ing.ingest(docs, tmp_path / "killed", max_docs=6).interrupted
    resumed = ing.ingest(docs, tmp_path / "killed")
    assert not resumed.interrupted and resumed.stats.resumed_rows == 4
    assert _bin_bytes(tmp_path / "killed") == _bin_bytes(tmp_path / "full")
    assert (tmp_path / "killed" / PRODUCER_NOTE).read_bytes() == \
        (tmp_path / "full" / PRODUCER_NOTE).read_bytes()


def test_writer_truncates_torn_tail(tmp_path):
    rng = np.random.default_rng(1)
    w = StoreWriter.open(tmp_path, dim=3)
    w.append(rng.normal(size=(4, 3)).astype(np.float32))
    w.commit()
    w.append(rng.normal(size=(2, 3)).astype(np.float32))  # never committed
    w.close()
    assert len(_bin_bytes(tmp_path)) == 6 * 3 * 4
    w2 = StoreWriter.open(tmp_path, dim=3)      # reopen truncates the tail
    assert w2.rows == 4 and len(_bin_bytes(tmp_path)) == 4 * 3 * 4
    w2.close()
    store = MemmapStore.open(tmp_path)
    assert len(store) == 4 and store.watermark == 4


def test_writer_rejects_mismatches(tmp_path):
    w = StoreWriter.open(tmp_path, dim=4, fingerprint={"model": "a"})
    with pytest.raises(ValueError):
        w.append(np.zeros((2, 5), np.float32))
    w.close()
    with pytest.raises(StoreFingerprintError):
        StoreWriter.open(tmp_path, dim=4, fingerprint={"model": "b"})
    with pytest.raises(ValueError):
        StoreWriter.open(tmp_path, dim=8, fingerprint={"model": "a"})
    with pytest.raises(ValueError):
        StoreWriter.open(tmp_path, dim=4, fingerprint={"model": "a"},
                         doc_id_start=100)


def test_memmap_refresh_follows_commits(tmp_path):
    w = StoreWriter.open(tmp_path, dim=2, fingerprint={"m": 1})
    w.append(np.ones((3, 2), np.float32))
    w.commit()
    store = MemmapStore.open(tmp_path)
    w.append(np.full((2, 2), 2.0, np.float32))
    assert store.refresh() == 3                 # uncommitted: invisible
    w.commit()
    assert store.refresh() == 5 and store.get([4]).tolist() == [[2.0, 2.0]]
    w.close()
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    manifest["fingerprint"] = {"m": 2}
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(StoreFingerprintError):
        store.refresh()


# -- from_corpus -> query ---------------------------------------------------


def test_from_corpus_then_query_on_cpu(services, tmp_path):
    _, t_svc = services
    corpus = make_corpus(seed=0, n_docs=N_DOCS, dim=16, with_tokens=True,
                         vocab=64, doc_len=DOC_LEN)
    tokens = [corpus.tokens[i] for i in range(N_DOCS)]
    pcfg = ProxyConfig(embed_dim=32, hidden_dim=64, latent_dim=64,
                       proj_dim=8, phase1_steps=8, phase2_steps=8,
                       batch_size=32)
    engine = ScaleDocEngine.from_corpus(
        t_svc, tokens, tmp_path, proxy_cfg=pcfg,
        cascade_cfg=CascadeConfig(accuracy_target=0.85), chunk=32,
        device="cpu", ingest_kwargs=dict(commit_every_batches=2))
    assert isinstance(engine.store, MemmapStore)
    assert len(engine.store) == N_DOCS and engine.proxy_cfg.embed_dim == 32
    assert engine.ingest_result.stats.docs == N_DOCS
    query = make_query(corpus, seed=7, selectivity=0.3)
    pos = np.nonzero(query.truth)[0][:4]
    e_q = engine.store.get(pos).mean(axis=0)
    e_q = (e_q / np.linalg.norm(e_q)).astype(np.float32)
    st = engine.query(e_q, SimulatedOracle(query.truth),
                      ground_truth=query.truth, seed=0)
    assert st.scores.shape == (N_DOCS,) and np.isfinite(st.scores).all()
    assert st.oracle_calls_total <= N_DOCS
    again = ScaleDocEngine.from_corpus(
        t_svc, tokens, tmp_path, proxy_cfg=pcfg, device="cpu",
        ingest_kwargs=dict(commit_every_batches=2))
    assert again.ingest_result.stats.docs == 0
    with pytest.raises(NotImplementedError):
        ScaleDocEngine.from_corpus(t_svc, tokens, tmp_path / "m",
                                   ingest_mesh=object(), device="cpu")
