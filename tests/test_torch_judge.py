"""Port parity of the LLM judge (``repro.core.oracle.LMOracle``) and the
cascade with the judge as its oracle.

The JAX package's own judge test runs on the port; labels and margins
(logit(yes) - logit(no) at the last position) and the last-position
logits are held to the JAX
``LMOracle`` on carried params; a label is a function of its prompt
alone, whatever the ask around it (the port's fixed micro-batch); and
``query()`` over a ``from_corpus`` store with the judge as its oracle
buys no more than N labels and keeps every label it bought. SMOKE width,
float32, on the CPU. Tolerance: margins within 1e-5 (rtol = atol),
labels equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke_arch as j_smoke
from repro.core.oracle import LMOracle as JLMOracle
from repro.core.oracle import LMOracleConfig as JLMOracleConfig
from repro.models import build_model as j_build_model
from repro_torch.config import CascadeConfig, ProxyConfig, get_smoke_arch
from repro_torch.core import LMOracle, LMOracleConfig
from repro_torch.core import oracle as oracle_mod
from repro_torch.data import make_corpus
from repro_torch.engine import ScaleDocEngine
from repro_torch.models import build_model, params_from_jax
from repro_torch.runtime.serve_loop import EmbeddingService
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)
N_ASK = 64


def test_lm_oracle_runs_and_is_deterministic():
    """The JAX package's test (``tests/test_serving_and_oracle.py``), on
    the port."""
    cfg = get_smoke_arch("smollm-360m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    corpus = make_corpus(0, n_docs=12, dim=32, with_tokens=True,
                         vocab=cfg.vocab_size, doc_len=12)
    query_tokens = np.array([5, 6, 7], np.int32)
    oracle = LMOracle(model, params, query_tokens, corpus.tokens,
                      LMOracleConfig(max_doc_tokens=8))
    l1 = oracle.label([0, 1, 2, 3])
    l2 = oracle.label([0, 1, 2, 3])
    np.testing.assert_array_equal(l1, l2)
    assert oracle.calls == 8
    assert l1.dtype == bool


def test_config_defaults_match_jax():
    assert dataclasses.asdict(LMOracleConfig()) == \
        dataclasses.asdict(JLMOracleConfig())


@pytest.fixture(scope="module", params=["llama3-8b", "smollm-360m"])
def judges(request):
    """The JAX judge and the port's on the same params, over a corpus of
    ragged-free token rows, with a query of 5 tokens."""
    arch = request.param
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_arch(arch), dtype="float32")
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    corpus = make_corpus(1, n_docs=150, dim=16, with_tokens=True,
                         vocab=jcfg.vocab_size, doc_len=14)
    q = np.array([9, 4, 17, 3, 30], np.int32)
    ocfg = dict(max_doc_tokens=10)
    return (jm, jp, JLMOracle(jm, jp, q, corpus.tokens,
                              JLMOracleConfig(**ocfg)),
            tm, tp, LMOracle(tm, tp, q, corpus.tokens,
                             LMOracleConfig(**ocfg)))


def test_labels_and_margins_match_jax(judges):
    jm, jp, joracle, tm, tp, oracle = judges
    idx = np.arange(N_ASK)
    want = np.asarray(joracle.label(idx))
    got = oracle.label(idx)
    assert got.dtype == bool and got.shape == (N_ASK,)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < N_ASK            # both classes present
    # the JAX judge's margins: forward over the same left-padded batch
    batch = oracle.prompts(idx)
    logits, _ = jm.forward(jp, jnp.asarray(batch))
    last = np.asarray(logits[:, -1])
    got = oracle.last_logits(idx).numpy()
    np.testing.assert_allclose(got[:, 1] - got[:, 2], last[:, 1] - last[:, 2],
                               **F32)
    np.testing.assert_allclose(got, last, **F32)


def test_prompts_are_left_padded_query_then_document(judges):
    *_, oracle = judges
    ragged = np.empty(2, object)
    ragged[:] = [np.array([7, 8]), np.array([1, 2, 3, 4, 5])]
    short = LMOracle(oracle.model, oracle.params, oracle.query_tokens,
                     ragged, LMOracleConfig(max_doc_tokens=4))
    np.testing.assert_array_equal(short.prompts([0, 1]), [
        [0, 0, 9, 4, 17, 3, 30, 7, 8], [9, 4, 17, 3, 30, 1, 2, 3, 4]])
    assert short.prompts([0]).shape == (1, 7)


def test_label_is_a_function_of_the_prompt(judges):
    """A document's label is the same asked alone, inside a larger ask
    (across micro-batch boundaries) and in reversed order."""
    *_, oracle = judges
    n = 2 * oracle_mod.JUDGE_BATCH + 9
    idx = np.arange(n)
    calls = oracle.calls
    whole = oracle.label(idx)
    logits = oracle.last_logits(idx)
    np.testing.assert_array_equal(oracle.label(idx[::-1]), whole[::-1])
    assert torch.equal(oracle.last_logits(idx[::-1]), logits.flip(0))
    for i in (0, 5, oracle_mod.JUDGE_BATCH, n - 1):
        assert oracle.label([i])[0] == whole[i]
        assert torch.equal(oracle.last_logits([i])[0], logits[i])
    assert oracle.calls == calls + 2 * n + 4


def test_an_empty_ask_costs_nothing(judges):
    *_, oracle = judges
    calls = oracle.calls
    out = oracle.label([])
    assert out.dtype == bool and out.shape == (0,)
    assert oracle.calls == calls


N_DOCS, DOC_LEN = 256, 12


def test_query_with_the_judge_as_oracle(tmp_path):
    """``query()`` over a ``from_corpus`` store of 256 documents on the
    SMOKE llama3-8b, the same model judging: no more than N labels
    bought, each document asked at most once, and every document the
    cascade sent to the judge carries the judge's label in the mask."""
    cfg = get_smoke_arch("llama3-8b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    corpus = make_corpus(0, n_docs=N_DOCS, dim=16, with_tokens=True,
                         vocab=cfg.vocab_size, doc_len=DOC_LEN)
    service = EmbeddingService(cfg, params, batch_size=8, device="cpu")
    pcfg = ProxyConfig(embed_dim=cfg.d_model, hidden_dim=64, latent_dim=32,
                       proj_dim=8, phase1_steps=8, phase2_steps=8,
                       batch_size=32)
    engine = ScaleDocEngine.from_corpus(
        service, list(corpus.tokens), tmp_path, proxy_cfg=pcfg,
        cascade_cfg=CascadeConfig(accuracy_target=0.9), chunk=64,
        device="cpu")
    query = np.random.default_rng(3).integers(
        3, cfg.vocab_size, size=16).astype(np.int32)
    e_q = service.embed_batch(query[None]).numpy()[0]
    e_q = (e_q / np.linalg.norm(e_q)).astype(np.float32)
    ocfg = LMOracleConfig(max_doc_tokens=8)
    truth = LMOracle(model, params, query, corpus.tokens,
                     ocfg).label(np.arange(N_DOCS))
    asked = []

    class Recording(LMOracle):
        def label(self, indices):
            asked.extend(int(i) for i in indices)
            return super().label(indices)

    judge = Recording(model, params, query, corpus.tokens, ocfg)
    st = engine.query(e_q, judge, ground_truth=truth, seed=0)
    assert st.oracle_calls_total <= N_DOCS
    assert judge.calls == len(asked) == len(set(asked)) <= N_DOCS
    band = (st.scores >= st.cascade.l) & (st.scores <= st.cascade.r)
    labels = st.cascade.labels
    np.testing.assert_array_equal(labels[band], truth[band])
    assert band.any() and 0 < truth.sum() < N_DOCS
    assert 0.0 <= st.cascade.achieved_f1 <= 1.0


def test_core_exports_the_jax_names():
    import repro.core as j_core
    import repro_torch.core as t_core
    want = {n for n in dir(j_core) if not n.startswith("_")
            and n not in ("cascade", "encoder", "oracle", "pipeline",
                          "trainer", "calibration", "thresholds",
                          "guarantees", "losses", "scoring", "annotations")}
    assert want <= set(dir(t_core))


def test_simulated_oracle_flops_and_reset_match_jax():
    from repro.core.oracle import SimulatedOracle as JSim
    from repro_torch.core import SimulatedOracle
    truth = np.arange(20) % 3 == 0
    j, t = JSim(truth), SimulatedOracle(truth)
    for o in (j, t):
        o.label([1, 2, 3])
        o.label([3])
    assert t.total_flops == j.total_flops and t.calls == 4
    t.reset()
    j.reset()
    assert (t.calls, t.queried) == (j.calls, j.queried) == (0, set())
