"""Port parity of the MoE family: ``models.moe`` (routing, capacity
drops chunk by chunk, both dispatches) and qwen3-moe-30b-a3b and
dbrx-132b at SMOKE through the embedding service, the forward, prefill
and decode, and ``generate``, against the JAX package.

Weights are the JAX package's own init carried across with
``params_from_jax``; inputs are numpy. Everything runs in float32 on the
CPU. Tolerances: ``moe_apply`` 1e-5 (rtol = atol), its auxiliary loss
1e-6 absolute; the model's logits, caches and embeddings 1e-5 of max
|JAX value|; decode against forward 5e-4 of max |logit|, the JAX
package's own bar, with capacity factor 8.0 as its test sets it
(``tests/test_models_consistency.py``); greedy tokens equal. Inputs of
the dispatch cases share a direction, so tokens crowd onto the same
experts and the capacity of 1.25 drops pairs; each such case asserts
that it does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.config import get_smoke_arch as j_smoke
from repro.config import replace as j_replace
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.runtime.serve_loop import EmbeddingService as JService
from repro.runtime.serve_loop import generate as j_generate
from repro_torch.config import get_smoke_arch as t_smoke
from repro_torch.config import replace as t_replace
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import moe as t_moe
from repro_torch.runtime.serve_loop import EmbeddingService, generate
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")
DISPATCHES = ("onehot", "sort")
F32 = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = 1e-6
REL = 1e-5
DECODE_REL = 5e-4
# (b, s, DISPATCH_CHUNK): two chunks of 1,024; three chunks of 16 (the
# chunk patched in both packages); 21 tokens that 16 does not divide,
# so one chunk of all of them
SHAPES = {"two_chunks": (2, 1024, 1024), "three_chunks": (2, 24, 16),
          "remainder": (3, 7, 16)}


def _carry(tree, dtype=None):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu", dtype)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / (np.abs(want).max() + 1e-9))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _assert_tree_close(got, want):
    got = dict(_leaves(got))
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert _rel(got[path], w) < REL, (path, _rel(got[path], w))


def _crowded(shape, seed=3):
    """Tokens around one shared direction: they favour the same experts,
    so a capacity of 1.25 drops pairs."""
    rng = np.random.default_rng(seed)
    b, s, d = shape
    return (rng.normal(size=(b, s, d)) * 0.5
            + 2.0 * rng.normal(size=(d,))).astype(np.float32)


def _moe_pair(arch, **moe):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    if moe:
        jcfg = j_replace(jcfg, **{f"moe.{k}": v for k, v in moe.items()})
        tcfg = t_replace(tcfg, **{f"moe.{k}": v for k, v in moe.items()})
    jp = j_moe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, jp, tcfg, _carry(jp)


# -- moe_apply against JAX --------------------------------------------------

@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, shape, dispatch, monkeypatch):
    b, s, chunk = SHAPES[shape]
    monkeypatch.setattr(j_moe, "DISPATCH_CHUNK", chunk)
    monkeypatch.setattr(t_moe, "DISPATCH_CHUNK", chunk)
    jcfg, jp, tcfg, tp = _moe_pair(arch)
    assert tcfg.moe.capacity_factor == 1.25
    x = _crowded((b, s, jcfg.d_model))
    want, want_aux = j_moe.moe_apply(jp, jnp.asarray(x), jcfg, dispatch)
    got, aux = t_moe.moe_apply(tp, torch.tensor(x), tcfg, dispatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) < AUX_TOL
    T, K = b * s, tcfg.moe.top_k
    n_chunks = {"two_chunks": 2, "three_chunks": 3, "remainder": 1}[shape]
    assert len(t_moe._chunks(T)) == n_chunks
    kept = t_moe.kept_pairs(tp, torch.tensor(x), tcfg, dispatch)
    assert kept.shape == (T, K) and int(kept.sum()) < T * K   # drops
    assert torch.equal(kept, t_moe.kept_pairs(tp, torch.tensor(x), tcfg,
                                              "sort" if dispatch == "onehot"
                                              else "onehot"))


def test_capacity_follows_the_chunk():
    """Python arithmetic, as the JAX package's: capacity per chunk, at
    least top_k; qwen3's decode step, embedding chunk and prefill."""
    from repro_torch.config import get_arch
    cfg = get_arch("qwen3-moe-30b-a3b")
    assert [t_moe._capacity(t, cfg) for t in (8, 1024, 640)] == [8, 80, 50]
    jcfg = j_smoke("qwen3-moe-30b-a3b")
    for t in (1, 2, 7, 21, 48, 1000):
        assert t_moe._capacity(t, t_smoke("qwen3-moe-30b-a3b")) == \
            j_moe._capacity(t, jcfg)
    assert [len(t_moe._chunks(t)) for t in (4096, 640, 8, 3000)] == \
        [4, 1, 1, 1]


# -- the JAX package's own dispatch tests, on the port ----------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sort_dispatch_matches_onehot(arch):
    cfg = t_replace(t_smoke(arch), **{"moe.capacity_factor": 8.0})
    p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    y1, a1 = t_moe.moe_apply(p, x, cfg, dispatch="onehot")
    y2, a2 = t_moe.moe_apply(p, x, cfg, dispatch="sort")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5, atol=1e-5)
    assert float(abs(a1 - a2)) < 1e-6


def test_sort_dispatch_matches_onehot_with_drops():
    """Capacity-overflow drop semantics must match exactly."""
    cfg = t_smoke("qwen3-moe-30b-a3b")  # cf=1.25
    p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.tensor(_crowded((2, 24, cfg.d_model)))
    y1, _ = t_moe.moe_apply(p, x, cfg, dispatch="onehot")
    y2, _ = t_moe.moe_apply(p, x, cfg, dispatch="sort")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5, atol=1e-5)
    assert int(t_moe.kept_pairs(p, x, cfg).sum()) < 48 * cfg.moe.top_k


def test_sort_dispatch_grads_match():
    cfg = t_replace(t_smoke("dbrx-132b"), **{"moe.capacity_factor": 8.0})
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    grads = []
    for dispatch in DISPATCHES:
        p = t_moe.moe_init(torch.Generator().manual_seed(0), cfg,
                           torch.float32)
        for t in p.values():
            t.requires_grad_(True)
        y, aux = t_moe.moe_apply(p, x, cfg, dispatch=dispatch)
        ((y ** 2).sum() + 0.01 * aux).backward()
        grads.append([p[k].grad for k in sorted(p)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-4)


# -- the one-hot tables built by scatter -------------------------------------

def _literal_tables(gates, experts, pos, keep, E, C):
    """The JAX package's form: one-hot of expert times one-hot of slot
    (C, all zeros, for a dropped pair), summed over k."""
    T, K = experts.shape
    flat_onehot = F.one_hot(experts.reshape(T * K), E).float()
    pos_oh = F.one_hot(torch.where(keep, pos, C), C + 1)[:, :C].float()
    prod = (flat_onehot[..., None] * pos_oh[:, None, :]).reshape(T, K, E, C)
    disp = prod.sum(1)
    comb = (prod * gates.reshape(T, K, 1, 1)).sum(1)
    return disp, comb


@pytest.mark.parametrize("arch", ARCHS)
def test_onehot_tables_are_bitwise_the_literal_einsum_form(arch):
    _, _, tcfg, tp = _moe_pair(arch)
    x = torch.tensor(_crowded((2, 24, tcfg.d_model))).reshape(48, -1)
    gates, experts, pos, keep, _, C = t_moe._route(tp, x, tcfg)
    assert not keep.all()
    disp, comb = t_moe._onehot_tables(gates, experts, pos, keep,
                                      tcfg.moe.num_experts, C)
    want_disp, want_comb = _literal_tables(gates, experts, pos, keep,
                                           tcfg.moe.num_experts, C)
    assert torch.equal(disp, want_disp) and torch.equal(comb, want_comb)


# -- params ----------------------------------------------------------------

def test_params_from_jax_keeps_the_router_float32():
    jcfg = dataclasses.replace(j_smoke("qwen3-moe-30b-a3b"),
                               dtype="bfloat16")
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    assert jp["blocks"]["p0"]["moe"]["router"].dtype == jnp.float32
    for dtype in (torch.bfloat16, None):
        tp = _carry(jp, dtype)
        moe = tp["blocks"]["p0"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["wi"].dtype == moe["wo"].dtype == torch.bfloat16
        assert tuple(moe["wi"].shape) == (2, 8, 64, 32)   # groups, E, d, f
        assert tp["embed"]["table"].dtype == torch.bfloat16
    tp = _carry(jp, torch.float32)
    assert tp["blocks"]["p0"]["moe"]["wg"].dtype == torch.float32
    tcfg = dataclasses.replace(t_smoke("qwen3-moe-30b-a3b"),
                               dtype="bfloat16")
    own = build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert own["blocks"]["p0"]["moe"]["router"].dtype == torch.float32
    assert own["blocks"]["p0"]["moe"]["wo"].dtype == torch.bfloat16
    assert {k: tuple(v.shape) for k, v in own["blocks"]["p0"]["moe"].items()} \
        == {k: tuple(v.shape) for k, v in jp["blocks"]["p0"]["moe"].items()}


# -- the SMOKE models against the JAX package ---------------------------------

def _pair(arch, dispatch="onehot", **moe):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    if moe:
        jcfg = j_replace(jcfg, **{f"moe.{k}": v for k, v in moe.items()})
        tcfg = t_replace(tcfg, **{f"moe.{k}": v for k, v in moe.items()})
    jm = j_build_model(jcfg, moe_dispatch=dispatch)
    tm = build_model(tcfg, moe_dispatch=dispatch)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, tcfg, tm, _carry(jp)


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        1, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_embed_documents_matches_jax(arch):
    """Ragged documents, a short last batch padded with all-zero rows
    that route through the MoE and take capacity, as in the JAX
    package."""
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    j_svc = JService(jcfg, jparams, batch_size=4)
    t_svc = EmbeddingService(tcfg, _carry(jparams), batch_size=4,
                             device="cpu")
    rng = np.random.default_rng(7)
    docs = [rng.integers(1, jcfg.vocab_size, size=n).astype(np.int32)
            for n in (30, 5, 17, 30, 12, 1, 29, 22, 9, 30)]   # 4 + 4 + 2
    want = j_svc.embed_documents(docs)
    got = t_svc.embed_documents(docs)
    assert got.shape == (10, jcfg.d_model)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_matches_jax(arch, dispatch):
    """Logits and the auxiliary loss summed over the layers, at the
    configs' capacity of 1.25 (40 tokens, one chunk)."""
    jcfg, jm, jp, tcfg, tm, tp = _pair(arch, dispatch)
    toks = _tokens(jcfg.vocab_size, 2, 20)
    want, want_aux = jm.forward(jp, jnp.asarray(toks))
    got, aux = tm.forward(tp, toks)
    assert got.shape == want.shape and _rel(got, want) < REL
    assert float(want_aux) > 0
    assert abs(float(aux) - float(want_aux)) < AUX_TOL
    assert torch.equal(tm.logits(tp, tm.hidden(tp, toks)), got)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_and_decode_match_jax(arch):
    """A prefill's caches, decode steps from the JAX cache, and each
    package's steps against its own forward; capacity factor 8.0, the
    JAX test's rule (a forward chunk and a decode chunk drop
    differently)."""
    jcfg, jm, jp, tcfg, tm, tp = _pair(arch, capacity_factor=8.0)
    pre, total = 12, 16
    toks = _tokens(jcfg.vocab_size, 2, total)
    j_full, _ = jm.forward(jp, jnp.asarray(toks))
    t_full, _ = tm.forward(tp, toks)
    _, jcache = jm.prefill(jp, jnp.asarray(toks[:, :pre]), cache_len=total)
    _, tcache = tm.prefill(tp, toks[:, :pre], cache_len=total)
    _assert_tree_close(tcache, jcache)
    tcache = _carry(jcache)
    for t in range(pre, total):
        j_step, jcache = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.array(t, jnp.int32), jcache)
        t_step, tcache = tm.decode_step(tp, toks[:, t:t + 1], t, tcache)
        assert _rel(t_step, j_step) < REL, t
        assert _rel(j_step[:, 0], j_full[:, t]) < DECODE_REL
        assert _rel(t_step[:, 0], t_full[:, t].numpy()) < DECODE_REL
    _assert_tree_close(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_generate_matches_jax(arch):
    jcfg, jm, jp, tcfg, tm, tp = _pair(arch)
    prompt = _tokens(jcfg.vocab_size, 2, 8, seed=5)
    np.testing.assert_array_equal(generate(tm, tp, prompt, 6),
                                  np.asarray(j_generate(jm, jp, prompt, 6)))
