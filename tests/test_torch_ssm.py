"""Port parity of the Mamba2 (SSD) block and the hybrid zamba2-2.7b:
``models.ssm`` against ``repro.models.ssm`` (the chunked pass, with and
without its final state, at chunks 4, 8 and 16 and at lengths where the
chunk adapts; decode steps), the port's chunked pass against its own
per-token recurrence, the carry of f32 leaves into a bf16 model, and
zamba2-2.7b at SMOKE (five mamba2 layers and one shared attention block
a period) through the forward, prefill and decode, ``generate``, the
embedding service and the store's fingerprint, against the JAX package.

Weights are the JAX package's own init carried across with
``params_from_jax`` (the block's f32 vectors redrawn from a numpy seed
in both, so the decay, skip and dt bias are not their constant inits);
inputs are numpy. Everything runs in float32 on the CPU. Tolerances:
1e-5 (rtol = atol) for the block and the embeddings, 1e-5 of max |JAX
value| for the model's logits and caches; the chunked pass against the
recurrence at ``tests/test_sequence_blocks.py``'s bars (1e-4 for y and
the SSD state, 1e-5 for the conv buffer); decode against forward 5e-4
of max |logit|, the JAX package's own bar
(``tests/test_models_consistency.py``); greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_arch
from repro.config import get_smoke_arch as j_smoke
from repro.config.base import ModelConfig as JModelConfig
from repro.config.base import SSMConfig as JSSMConfig
from repro.engine import ingest_fingerprint as j_fingerprint
from repro.models import build_model as j_build_model
from repro.models import ssm as j_ssm
from repro.runtime.serve_loop import EmbeddingService as JService
from repro.runtime.serve_loop import generate as j_generate
from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.config import get_arch as t_arch
from repro_torch.config import get_smoke_arch as t_smoke
from repro_torch.engine import ingest_fingerprint
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import ssm as t_ssm
from repro_torch.models.transformer import kernel_layers
from repro_torch.runtime.serve_loop import EmbeddingService, generate
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "zamba2-2.7b"
F32 = dict(rtol=1e-5, atol=1e-5)
REL = 1e-5
DECODE_REL = 5e-4
# tests/test_sequence_blocks.py's chunked-vs-recurrence bars
REC = dict(rtol=1e-4, atol=1e-4)
REC_CONV = dict(rtol=1e-5, atol=1e-5)
VECTORS = ("a_log", "d_skip", "dt_bias")


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
        assert str(got[path].dtype).removeprefix("torch.") == str(w.dtype)
        assert _rel(got[path], w) < REL, (path, _rel(got[path], w))


# -- the block against the JAX package ----------------------------------------

def _block_cfgs(chunk):
    """tests/test_sequence_blocks.py's block config, in both packages."""
    kw = dict(name="t", d_model=32, num_layers=1, num_heads=2,
              num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")
    ssm = dict(state_dim=8, conv_width=4, head_dim=8, expand=2, chunk=chunk)
    return (JModelConfig(**kw, ssm=JSSMConfig(**ssm)),
            ModelConfig(**kw, ssm=SSMConfig(**ssm)))


def _block(chunk, dt_bias=None, seed=0):
    """JAX params with the f32 vectors drawn from a numpy seed (or
    ``dt_bias`` given), and their carry."""
    jcfg, tcfg = _block_cfgs(chunk)
    jp = dict(j_ssm.mamba_init(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed + 100)
    H = jp["a_log"].shape[0]
    jp["a_log"] = jnp.asarray(rng.normal(size=H) * 0.5, jnp.float32)
    jp["d_skip"] = jnp.asarray(rng.normal(size=H), jnp.float32)
    jp["dt_bias"] = jnp.asarray(
        rng.normal(size=H) if dt_bias is None else np.full(H, dt_bias),
        jnp.float32)
    return jcfg, jp, tcfg, _carry(jp)


def _x(b, s, d, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(b, s, d))
            * scale).astype(np.float32)


# (chunk, s): whole chunks, one chunk shorter than the config's, and the
# awkward lengths: 17 (prime, Q = 1) and 30 (Q = 15, 10 or 6 by chunk)
BLOCK_CASES = [(c, s) for c in (4, 8, 16) for s in (16, 17, 30)] + [(16, 8)]


@pytest.mark.parametrize("chunk,s", BLOCK_CASES)
def test_mamba_apply_matches_jax(chunk, s):
    jcfg, jp, tcfg, tp = _block(chunk)
    x = _x(2, s, jcfg.d_model)
    want = j_ssm.mamba_apply(jp, jnp.asarray(x), jcfg)
    got = t_ssm.mamba_apply(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    want, want_st = j_ssm.mamba_apply(jp, jnp.asarray(x), jcfg,
                                      return_state=True)
    y, st = t_ssm.mamba_apply(tp, torch.tensor(x), tcfg, return_state=True)
    assert torch.equal(y, got)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **F32)
    assert st["ssm"].dtype == torch.float32
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(st[name].numpy(),
                                   np.asarray(want_st[name]), **F32)


@pytest.mark.parametrize("s,chunk,want", [(17, 8, 1), (30, 8, 6),
                                          (30, 16, 15), (300, 128, 100),
                                          (316, 128, 79), (2048, 128, 128),
                                          (5, 128, 5)])
def test_chunk_adapts_as_in_jax(s, chunk, want):
    assert t_ssm.chunk_length(s, chunk) == want


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mamba_decode_matches_jax(chunk):
    """Four steps from the JAX prefill's state of 13 tokens."""
    jcfg, jp, tcfg, tp = _block(chunk)
    x = _x(2, 17, jcfg.d_model)
    _, jst = j_ssm.mamba_apply(jp, jnp.asarray(x[:, :13]), jcfg,
                               return_state=True)
    tst = _carry(jst)
    for t in range(13, 17):
        want, jst = j_ssm.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                       state=jst)
        before = {k: v.clone() for k, v in tst.items()}
        got, tst = t_ssm.mamba_decode(tp, torch.tensor(x[:, t:t + 1]), tcfg,
                                      state=before)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(tst[name].numpy(),
                                       np.asarray(jst[name]), **F32)


def _recurrence(params, x, cfg):
    """The port's per-token recurrence through mamba_decode from a zero
    state."""
    spec, _ = t_ssm.mamba_state_spec(cfg, x.shape[0], x.dtype)
    state = {k: torch.zeros(t.shape, dtype=t.dtype) for k, t in spec.items()}
    outs = []
    for t in range(x.shape[1]):
        y, state = t_ssm.mamba_decode(params, x[:, t:t + 1], cfg,
                                      state=state)
        outs.append(y)
    return torch.cat(outs, dim=1), state


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("s", [16, 30])
def test_chunked_matches_the_ports_recurrence(chunk, s):
    """tests/test_sequence_blocks.py::test_ssd_chunked_matches_recurrence
    on the port alone."""
    _, _, tcfg, tp = _block(chunk)
    x = torch.tensor(_x(2, s, tcfg.d_model))
    y_par, st_par = t_ssm.mamba_apply(tp, x, tcfg, return_state=True)
    y_seq, st_seq = _recurrence(tp, x, tcfg)
    np.testing.assert_allclose(y_par.numpy(), y_seq.numpy(), **REC)
    np.testing.assert_allclose(st_par["ssm"].numpy(), st_seq["ssm"].numpy(),
                               **REC)
    np.testing.assert_allclose(st_par["conv"].numpy(),
                               st_seq["conv"].numpy(), **REC_CONV)


def test_overflowing_upper_triangle_stays_finite_and_matches_jax():
    """dt_bias = 30: dt ~ 30 a step, so above the diagonal seg reaches
    (Q - 1) x 30 > 88.7 and exp(seg) is inf in f32; the select leaves
    the output finite, where a product with a 0/1 mask would give NaN."""
    jcfg, jp, tcfg, tp = _block(16, dt_bias=30.0)
    x = _x(2, 32, jcfg.d_model)
    dt = t_ssm._split_in_proj(tcfg, torch.tensor(x) @ tp["in_proj"])[-1]
    dt = t_ssm._dt(dt, tp["dt_bias"])
    A = -torch.exp(tp["a_log"])
    assert (15 * (dt * -A).min()).item() > 88.8     # exp overflows in f32
    want, want_st = j_ssm.mamba_apply(jp, jnp.asarray(x), jcfg,
                                      return_state=True)
    got, st = t_ssm.mamba_apply(tp, torch.tensor(x), tcfg, return_state=True)
    assert torch.isfinite(got).all() and torch.isfinite(st["ssm"]).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(want_st["ssm"]),
                               **F32)


def test_state_spec_matches_jax():
    jcfg, tcfg = _block_cfgs(8)
    want, want_axes = j_ssm.mamba_state_spec(jcfg, 3, jnp.bfloat16)
    got, axes = t_ssm.mamba_state_spec(tcfg, 3, torch.bfloat16)
    assert axes == want_axes
    for name, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[name].shape
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype)


# -- params ---------------------------------------------------------------------

def test_params_from_jax_keeps_the_mamba_vectors_and_state_float32():
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="bfloat16")
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    for dtype in (torch.bfloat16, None):
        tp = _carry(jp, dtype)
        mamba = tp["blocks"]["p0"]["mamba"]
        for name in VECTORS:
            assert mamba[name].dtype == torch.float32, name
        for name in ("in_proj", "conv_w", "out_proj", "norm_z"):
            assert mamba[name].dtype == torch.bfloat16, name
        assert tp["shared"]["attn"]["wq"].dtype == torch.bfloat16
    assert _carry(jp, torch.float32)["blocks"]["p0"]["mamba"][
        "in_proj"].dtype == torch.float32
    toks = np.random.default_rng(1).integers(1, 256, size=(2, 9))
    _, jcache = jm.prefill(jp, jnp.asarray(toks, jnp.int32), cache_len=12)
    cache = _carry(jcache, torch.bfloat16)
    assert cache["p0"]["ssm"].dtype == torch.float32
    assert cache["p0"]["conv"].dtype == torch.bfloat16
    assert cache["p5"]["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(cache["p0"]["ssm"].numpy(),
                                  np.asarray(jcache["p0"]["ssm"]))
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16")
    own = build_model(tcfg).init(torch.Generator().manual_seed(0))
    for name in VECTORS:
        assert own["blocks"]["p2"]["mamba"][name].dtype == torch.float32
    assert own["blocks"]["p0"]["mamba"]["in_proj"].dtype == torch.bfloat16


def test_port_init_has_the_jax_layout():
    """The same leaves, shapes and types (p5 empty, ``shared`` drawn
    once), and the analytic count of both packages."""
    jp = j_build_model(j_smoke(ARCH)).init(jax.random.PRNGKey(0))
    tp = build_model(t_smoke(ARCH)).init(torch.Generator().manual_seed(0))
    want = dict(_leaves(jax.tree.map(np.asarray, jp)))
    got = dict(_leaves(tp))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(got[path].dtype).removeprefix("torch.") == str(w.dtype)
    assert tp["blocks"]["p5"] == {} and "shared" in tp


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_and_param_count_match_jax(size):
    """``param_count()`` is the JAX package's formula, kept as it is (it
    counts B and C once a head, where ``mamba_init`` draws them once a
    layer: FULL's formula gives 3,146,318,880, the drawn tree
    1,981,519,920)."""
    t, j = (t_arch, j_arch) if size == "full" else (t_smoke, j_smoke)
    assert dataclasses.asdict(t(ARCH)) == dataclasses.asdict(j(ARCH))
    assert t(ARCH).param_count() == j(ARCH).param_count()
    if size == "full":
        assert t(ARCH).param_count() == 3_146_318_880


@pytest.mark.parametrize("arch,want", [("zamba2-2.7b", 9), ("llama3-8b", 32),
                                       ("rwkv6-7b", 32), ("gemma3-12b", 48)])
def test_kernel_layers_counts_the_layers_that_launch(arch, want):
    """A mamba2 block launches no kernel; a shared block's every
    application launches flash."""
    assert kernel_layers(t_arch(arch)) == want


def _drawn_count(cfg) -> int:
    """Elements of the port's drawn tree, from its shapes alone."""
    model = build_model(cfg)
    d_inner, H, d_conv = t_ssm._dims(cfg)
    n, W = cfg.ssm.state_dim, cfg.ssm.conv_width
    mamba = (cfg.d_model * (2 * d_inner + 2 * n + H) + W * d_conv + 3 * H
             + d_inner * cfg.d_model + d_inner + cfg.d_model)
    hd, f = cfg.head_dim, cfg.d_ff
    shared = (2 * cfg.d_model + cfg.d_model * hd * (2 * cfg.num_heads
                                                     + 2 * cfg.num_kv_heads)
              + 3 * cfg.d_model * f)
    kinds = cfg.layer_kinds()
    return (cfg.padded_vocab_size * cfg.d_model + cfg.d_model
            + kinds.count("mamba2") * mamba + shared * model.has_shared)


def test_drawn_count_matches_jax():
    """The drawn tree's size (what the card holds) from shapes, against
    the JAX init's at SMOKE, and at FULL against the JAX init's
    eval_shape."""
    jp = j_build_model(j_smoke(ARCH)).init(jax.random.PRNGKey(0))
    assert _drawn_count(t_smoke(ARCH)) == sum(
        x.size for x in jax.tree.leaves(jp))
    shapes = jax.eval_shape(j_build_model(j_arch(ARCH)).init,
                            jax.random.PRNGKey(0))
    assert _drawn_count(t_arch(ARCH)) == sum(
        x.size for x in jax.tree.leaves(shapes)) == 1_981_519_920


# -- zamba2-2.7b SMOKE against the JAX package --------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, tcfg, tm, _carry(jp)


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        1, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("s", [16, 17, 30])
def test_smoke_forward_matches_jax(pair, s):
    """Whole chunks of 8, 17 tokens at Q = 1, 30 at Q = 6."""
    jcfg, jm, jp, tcfg, tm, tp = pair
    toks = _tokens(jcfg.vocab_size, 2, s)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, aux = tm.forward(tp, toks)
    assert got.shape == want.shape and _rel(got, want) < REL
    assert aux.item() == 0.0
    assert torch.equal(tm.logits(tp, tm.hidden(tp, toks)), got)


def test_smoke_cache_spec_matches_jax(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    want, want_axes = jm.cache_spec(3, 21)
    got, axes = tm.cache_spec(3, 21)
    assert axes == want_axes
    flat = dict(_leaves(want))
    assert [p for p, _ in _leaves(got)] == sorted(flat)
    for path, t in _leaves(got):
        assert tuple(t.shape) == flat[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == str(flat[path].dtype)
    assert tuple(got["p5"]["k"].shape) == (1, 3, 21, 4, 16)   # one a group


def test_smoke_prefill_and_decode_match_jax(pair):
    """tests/test_models_consistency.py::test_multi_step_decode's four
    steps after a 12-token prefill: the prefill's caches, steps from the
    JAX cache against JAX's, and each package's steps against its own
    forward."""
    jcfg, jm, jp, tcfg, tm, tp = pair
    pre, total = 12, 16
    toks = _tokens(jcfg.vocab_size, 2, total)
    j_full, _ = jm.forward(jp, jnp.asarray(toks))
    t_full, _ = tm.forward(tp, toks)
    _, jcache = jm.prefill(jp, jnp.asarray(toks[:, :pre]), cache_len=total)
    _, tcache = tm.prefill(tp, toks[:, :pre], cache_len=total)
    _assert_tree_close(tcache, jcache)
    own = tcache
    tcache = _carry(jcache)
    for t in range(pre, total):
        j_step, jcache = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.array(t, jnp.int32), jcache)
        t_step, tcache = tm.decode_step(tp, toks[:, t:t + 1], t, tcache)
        o_step, own = tm.decode_step(tp, toks[:, t:t + 1], t, own)
        assert _rel(t_step, j_step) < REL, t
        assert _rel(j_step[:, 0], j_full[:, t]) < DECODE_REL
        assert _rel(o_step[:, 0], t_full[:, t].numpy()) < DECODE_REL
    _assert_tree_close(tcache, jcache)


def test_smoke_decode_from_init_cache_matches_jax(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    toks = _tokens(jcfg.vocab_size, 2, 1)
    want, want_cache = jm.decode_step(jp, jnp.asarray(toks),
                                      jnp.array(0, jnp.int32),
                                      jm.init_cache(2, 8))
    got, cache = tm.decode_step(tp, toks, 0, tm.init_cache(2, 8, "cpu"))
    assert _rel(got, want) < REL
    _assert_tree_close(cache, want_cache)


def test_smoke_generate_matches_jax(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    prompt = _tokens(jcfg.vocab_size, 2, 8, seed=5)
    np.testing.assert_array_equal(generate(tm, tp, prompt, 6),
                                  np.asarray(j_generate(jm, jp, prompt, 6)))


@pytest.fixture(scope="module")
def services(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    return (JService(jcfg, jp, batch_size=4),
            EmbeddingService(tcfg, tp, batch_size=4, device="cpu"))


def test_smoke_embed_documents_matches_jax(services):
    """Ragged documents (the batch's width 30: Q = 6) and a short last
    batch padded with all-zero rows."""
    j_svc, t_svc = services
    rng = np.random.default_rng(7)
    docs = [rng.integers(1, 256, size=n).astype(np.int32)
            for n in (30, 5, 17, 30, 12, 1, 29, 22, 9, 30)]   # 4 + 4 + 2
    got = t_svc.embed_documents(docs)
    assert got.shape == (10, 64)
    np.testing.assert_allclose(got, j_svc.embed_documents(docs), **F32)


def test_smoke_ingest_fingerprint_matches_jax(services):
    """The config and params digests over the ``shared`` subtree and the
    empty ``blocks.p5``."""
    j_svc, t_svc = services
    kw = dict(commit_every_batches=2, pad_width_to=16, data_shards=1)
    got = ingest_fingerprint(t_svc, **kw)
    assert got == j_fingerprint(j_svc, **kw)
    assert got["params_digest"] == t_svc.params_digest()
