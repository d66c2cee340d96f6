"""Port parity of the data axis: the streaming loops on a mesh of more
than one device (the executor's shard path, ``Ingestor(mesh=)``,
``EmbeddingService(mesh=)``, ``ScaleDocEngine(mesh=)`` and
``from_corpus(ingest_mesh=)``) against the JAX package.

The mesh is ``Mesh(OrderedDict(data=4), (cpu,) * 4)``: four entries of
the one CPU device, the counterpart of the JAX tests' four forced host
devices (``--xla_force_host_platform_device_count=4``). The shard path
runs each row shard through the plain chunk programs, so its rows are
held to the port's single-device pass at 1e-6 (the JAX tests' bar for a
sharded run against a single-device one; a shard of other row count
can round apart in the CPU's matmul) and to the JAX package at the
executor's stated 1e-5 (tests/test_torch_executor.py). The JAX
executor's (devices, paths) on four devices come from one subprocess,
as tests/test_executor.py runs its sharded test; the JAX package's own
sharded ingest fails (``ShardingTypeError`` in ``jnp.take``), so the
port's is held to JAX's single-device ``build_index``.
"""
import json
import os
import subprocess
import sys
import textwrap
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from repro.config.base import ModelConfig as JModelConfig
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core import scoring as j_scoring
from repro.core.encoder import encoder_init
from repro.data import make_corpus as j_make_corpus
from repro.engine import build_index as j_build_index
from repro.models import build_model as j_build_model
from repro.runtime.serve_loop import EmbeddingService as JService
from repro_torch.config import CascadeConfig, ModelConfig, ProxyConfig
from repro_torch.core.encoder import params_from_jax as proxy_from_jax
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (InMemoryStore, Ingestor, ScaleDocEngine,
                                ScoringExecutor, SimulatedOracle,
                                StoreFingerprintError, build_index,
                                load_manifest)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import params_from_jax
from repro_torch.runtime.serve_loop import EmbeddingService
from repro_torch.sharding.rules import shard_rows
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
MESH = Mesh(OrderedDict(data=4), (CPU,) * 4)
SHARD_TOL = dict(rtol=1e-6, atol=1e-6)     # against a single-device run
JAX_TOL = dict(rtol=1e-5, atol=1e-5)       # the executor's, against JAX
N, D, CHUNK = 1999, 64, 700                # N not divisible by 4
# tests/test_ingest.py's service config and corpus
INGEST_CFG = dict(name="ingest-test", num_layers=2, d_model=32, num_heads=2,
                  num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
                  remat="none")
N_INGEST, BATCH = 48, 8

_PATHS_SCRIPT = textwrap.dedent("""
    import json
    import numpy as np, jax
    assert len(jax.devices()) == 4, jax.devices()
    from repro.config.base import ProxyConfig
    from repro.core.encoder import encoder_init
    from repro.engine import InMemoryStore, ScoringExecutor
    from repro.launch.mesh import make_scoring_mesh

    rng = np.random.default_rng(0)
    D = 64
    store = InMemoryStore(rng.normal(size=(200, D)).astype(np.float32))
    params = encoder_init(jax.random.PRNGKey(0), ProxyConfig(
        embed_dim=D, hidden_dim=64, latent_dim=64, proj_dim=8))
    e_q = rng.normal(size=D).astype(np.float32)
    out = {}
    for use_kernel in (False, True):
        ex = ScoringExecutor(chunk=128, use_kernel=use_kernel,
                             interpret=use_kernel, mesh=make_scoring_mesh())
        for none in (False, True):
            p = None if none else params
            _, st = ex.score(p, e_q, store)
            _, stm = ex.score_multi([(p, e_q)], store)
            for call, s in (("score", st), ("score_multi", stm)):
                out[f"{use_kernel}/{none}/{call}"] = [
                    s.devices, "shard" in s.paths, "fused" in s.paths]
    print("PATHS " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_paths():
    """The JAX executor's (devices, "shard" in paths, "fused" in paths)
    for every case, on four forced host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep \
        + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PATHS_SCRIPT],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = [x for x in proc.stdout.splitlines() if x.startswith("PATHS ")]
    return json.loads(line[-1][len("PATHS "):])


@pytest.fixture(scope="module")
def scoring_setup():
    """tests/test_executor.py's sharded case: params from JAX's
    ``encoder_init``, carried across."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    cfg = JProxyCfg(embed_dim=D, hidden_dim=32, latent_dim=16, proj_dim=8)
    jparams = jax.tree.map(np.asarray,
                           encoder_init(jax.random.PRNGKey(0), cfg))
    e_q = rng.normal(size=D).astype(np.float32)
    e_q2 = rng.normal(size=D).astype(np.float32)
    return emb, jparams, proxy_from_jax(jparams), e_q, e_q2


# -- the rows' split ---------------------------------------------------------


def test_shard_rows_follow_the_batch_rule():
    """One slice a device in mesh order: rows over (pod, data) with pod
    major, a model axis holding copies, replication where the rows do
    not divide."""
    arr = np.arange(16).reshape(8, 2)
    pod_data = Mesh(OrderedDict(pod=2, data=2), (CPU,) * 4)
    assert [s[:, 0].tolist() for s in shard_rows(pod_data, arr)] == \
        [[0, 2], [4, 6], [8, 10], [12, 14]]
    data_model = Mesh(OrderedDict(data=2, model=2), (CPU,) * 4)
    assert [s[:, 0].tolist() for s in shard_rows(data_model, arr)] == \
        [[0, 2, 4, 6], [0, 2, 4, 6], [8, 10, 12, 14], [8, 10, 12, 14]]
    assert all(s.shape == (6, 2) for s in shard_rows(MESH, arr[:6]))


# -- the executor's shard path -----------------------------------------------


@pytest.mark.parametrize("call", ["score", "score_multi"])
def test_shard_path_matches_jax_and_single_device(scoring_setup, call):
    emb, jparams, params, e_q, e_q2 = scoring_setup
    store = InMemoryStore(emb)
    ex = ScoringExecutor(chunk=CHUNK, use_kernel=False, mesh=MESH,
                         device="cpu")
    one = ScoringExecutor(chunk=CHUNK, use_kernel=False, device="cpu")
    if call == "score":
        got, st = ex.score(params, e_q, store)
        single, _ = one.score(params, e_q, store)
        want = j_scoring.score_collection(jparams, e_q, emb, chunk=CHUNK)
    else:
        got, st = ex.score_multi(
            [(params, e_q), (None, e_q2), (params, e_q2)], store)
        single, _ = one.score_multi(
            [(params, e_q), (None, e_q2), (params, e_q2)], store)
        want = j_scoring.score_collection_multi(
            [(jparams, e_q), (None, e_q2), (jparams, e_q2)], emb,
            chunk=CHUNK)
    assert st.devices == 4 and st.paths == ("shard",)
    assert st.docs_scored == N and st.tiles_scored == 3
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, single, **SHARD_TOL)
    np.testing.assert_allclose(got, want, **JAX_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("none", [False, True])
@pytest.mark.parametrize("call", ["score", "score_multi"])
def test_paths_and_devices_match_the_jax_executor(jax_paths, scoring_setup,
                                                  use_kernel, none, call):
    emb, _, params, e_q, _ = scoring_setup
    store = InMemoryStore(emb[:200])
    ex = ScoringExecutor(chunk=128, use_kernel=use_kernel, mesh=MESH,
                         device="cpu")
    p = None if none else params
    _, st = (ex.score(p, e_q, store) if call == "score"
             else ex.score_multi([(p, e_q)], store))
    got = [st.devices, "shard" in st.paths, "fused" in st.paths]
    assert got == jax_paths[f"{use_kernel}/{none}/{call}"]


def test_a_pass_checks_out_one_stager_a_device():
    """A repeated device shares one stager, returned to the pool."""
    ex = ScoringExecutor(chunk=64, use_kernel=False, mesh=MESH, device="cpu")
    ex.score(None, np.ones(8, np.float32),
             InMemoryStore(np.ones((100, 8), np.float32)))
    assert list(ex._stagers) == [CPU] and len(ex._stagers[CPU]) == 1


# -- the offline indexer -----------------------------------------------------


@pytest.fixture(scope="module")
def ingest_setup():
    jcfg = JModelConfig(**INGEST_CFG)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    corpus = j_make_corpus(seed=0, n_docs=N_INGEST, dim=16, with_tokens=True,
                           vocab=64, doc_len=12)
    docs = [corpus.tokens[i] for i in range(N_INGEST)]
    return jcfg, jparams, tparams, docs


def _service(tparams, mesh=MESH, batch_size=BATCH):
    return EmbeddingService(ModelConfig(**INGEST_CFG), tparams,
                            batch_size=batch_size, mesh=mesh, device="cpu")


def test_sharded_ingest_matches_jax_single_device(ingest_setup, tmp_path):
    jcfg, jparams, tparams, docs = ingest_setup
    want = j_build_index(JService(jcfg, jparams, batch_size=BATCH), docs,
                         tmp_path / "jax", commit_every_batches=2)
    single = build_index(_service(tparams, mesh=None), docs, tmp_path / "one",
                         commit_every_batches=2)
    got = build_index(_service(tparams), docs, tmp_path / "mesh",
                      commit_every_batches=2, mesh=MESH)
    rows = np.arange(N_INGEST)
    assert got.stats.devices == 4 and single.stats.devices == 1
    assert got.stats.docs == N_INGEST and got.stats.batches == 6
    assert load_manifest(tmp_path / "mesh").fingerprint["data_shards"] == 4
    np.testing.assert_allclose(got.store.get(rows),
                               np.asarray(want.store.get(rows)), **SHARD_TOL)
    np.testing.assert_allclose(got.store.get(rows), single.store.get(rows),
                               **SHARD_TOL)


def test_sharded_ingest_resumes_only_under_its_mesh(ingest_setup, tmp_path):
    _, _, tparams, docs = ingest_setup
    svc = _service(tparams)
    killed = build_index(svc, docs, tmp_path, commit_every_batches=2,
                         mesh=MESH, max_docs=16)
    assert killed.interrupted and len(killed.store) == 16
    two = Mesh(OrderedDict(data=2), (CPU,) * 2)
    for mesh in (None, two):
        with pytest.raises(StoreFingerprintError):
            build_index(svc, docs, tmp_path, commit_every_batches=2,
                        mesh=mesh)
    resumed = build_index(svc, docs, tmp_path, commit_every_batches=2,
                          mesh=MESH)
    assert resumed.stats.resumed_rows == 16 and len(resumed.store) == N_INGEST
    full = build_index(svc, docs, tmp_path / "full", commit_every_batches=2,
                       mesh=MESH)
    np.testing.assert_array_equal(resumed.store.get(np.arange(N_INGEST)),
                                  full.store.get(np.arange(N_INGEST)))


def test_ingest_mesh_guards(ingest_setup):
    _, _, tparams, _ = ingest_setup
    three = Mesh(OrderedDict(data=3), (CPU,) * 3)
    with pytest.raises(ValueError, match="divide"):
        Ingestor(_service(tparams, mesh=three), mesh=three)
    assert Ingestor(_service(tparams), mesh=MESH).fingerprint()[
        "data_shards"] == 4
    abstract = Mesh(OrderedDict(data=4))
    with pytest.raises(ValueError, match="devices"):
        Ingestor(_service(tparams, mesh=None), mesh=abstract)
    with pytest.raises(NotImplementedError, match="model-axis"):
        Ingestor(_service(tparams, mesh=None),
                 mesh=Mesh(OrderedDict(data=2, model=2), (CPU,) * 4))


def test_service_keeps_one_params_copy_a_device(ingest_setup):
    """A repeated device shares the caller's params; the digest is the
    caller's; a row-sharded batch gives the whole batch's rows."""
    _, _, tparams, docs = ingest_setup
    svc = _service(tparams)
    assert svc.params_on(CPU) is tparams
    with pytest.raises(ValueError, match="holds its params on"):
        svc.params_on(torch.device("meta"))
    assert svc.params_digest() == _service(tparams, mesh=None).params_digest()
    batch = np.stack(docs[:BATCH]).astype(np.int32)
    shards = [torch.as_tensor(s) for s in shard_rows(MESH, batch)]
    np.testing.assert_allclose(svc.embed_batch(shards).numpy(),
                               svc.embed_batch(batch).numpy(), **SHARD_TOL)


# -- the engine ----------------------------------------------------------------

PROXY = dict(embed_dim=32, hidden_dim=64, latent_dim=32, proj_dim=16,
             phase1_steps=20, phase2_steps=20, batch_size=64)


def test_mesh_engine_query_matches_single_device():
    corpus = make_corpus(0, n_docs=1500, dim=32)
    q = make_query(corpus, 7, selectivity=0.3)
    runs = {}
    for name, mesh in (("one", None), ("mesh", MESH)):
        eng = ScaleDocEngine(InMemoryStore(corpus.embeds),
                             ProxyConfig(**PROXY),
                             CascadeConfig(accuracy_target=0.9), mesh=mesh,
                             use_kernel=False, chunk=512, device="cpu")
        oracle = SimulatedOracle(q.truth)
        st = eng.query(q.embed, oracle, ground_truth=q.truth, seed=0)
        runs[name] = (st, oracle.calls)
    (one, one_calls), (mesh, mesh_calls) = runs["one"], runs["mesh"]
    np.testing.assert_allclose(mesh.scores, one.scores, **SHARD_TOL)
    differ = np.nonzero(mesh.cascade.labels != one.cascade.labels)[0]
    near = np.minimum(np.abs(one.scores[differ] - one.cascade.l),
                      np.abs(one.scores[differ] - one.cascade.r))
    assert (near <= 1e-6).all()
    assert mesh.oracle_calls_total == one.oracle_calls_total
    assert mesh_calls == one_calls


def test_from_corpus_with_an_ingest_mesh(ingest_setup, tmp_path):
    _, _, tparams, docs = ingest_setup
    pcfg = ProxyConfig(embed_dim=32, hidden_dim=64, latent_dim=32,
                       proj_dim=16, phase1_steps=10, phase2_steps=10)
    eng = ScaleDocEngine.from_corpus(
        _service(tparams), docs, tmp_path / "mesh", proxy_cfg=pcfg,
        ingest_mesh=MESH, device="cpu", mesh=MESH, use_kernel=False,
        ingest_kwargs=dict(commit_every_batches=2))
    one = ScaleDocEngine.from_corpus(
        _service(tparams, mesh=None), docs, tmp_path / "one", proxy_cfg=pcfg,
        device="cpu", ingest_kwargs=dict(commit_every_batches=2))
    assert eng.ingest_result.stats.devices == 4
    assert eng.executor._mesh_size == 4
    rows = np.arange(N_INGEST)
    np.testing.assert_allclose(eng.store.get(rows), one.store.get(rows),
                               **SHARD_TOL)
    scores, st = eng.executor.score(None, eng.store.get([0])[0], eng.store)
    assert st.paths == ("shard",) and scores.shape == (N_INGEST,)
