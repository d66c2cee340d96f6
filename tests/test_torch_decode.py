"""Port parity of the LM's serving surface: ``logits``/``forward``,
``prefill`` with KV caches and RWKV6 state, ``cache_spec``/``init_cache``,
``decode_step`` and ``serve_loop.generate``, against the JAX package's.

Weights are the JAX package's own init carried across with
``params_from_jax`` (a JAX cache is carried the same way); inputs are
numpy. Everything runs at SMOKE width in float32 on the CPU, where the
flash and WKV6 wrappers take their plain versions. Tolerances:
- port against JAX (logits, caches, decode from the JAX cache): 1e-5 of
  max |JAX value|, per leaf;
- decode against the teacher-forced forward, in each package alone:
  5e-4 of max |logit|, the JAX package's own bar
  (``tests/test_models_consistency.py``);
- greedy tokens: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_arch
from repro.config import get_smoke_arch as j_smoke
from repro.config import list_archs as j_list_archs
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import rwkv as j_rwkv
from repro.runtime.serve_loop import generate as j_generate
from repro_torch.config import get_arch as t_arch
from repro_torch.config import get_smoke_arch as t_smoke
from repro_torch.config import list_archs, replace
from repro_torch.kernels.wkv6 import ops as w_ops
from repro_torch.kernels.wkv6 import ref as w_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import rwkv as t_rwkv
from repro_torch.runtime.serve_loop import generate
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("llama3-8b", "rwkv6-7b", "smollm-360m")
REL = 1e-5
DECODE_REL = 5e-4
SEQ = 16


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / (np.abs(want).max() + 1e-9))


def _carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_tree_close(got, want, tol=REL):
    """Every leaf of the JAX tree ``want`` against the port's ``got``:
    same paths, shapes and types, values within ``tol`` of max |want|."""
    want_leaves = list(_leaves(jax.tree.map(np.asarray, want)))
    assert [p for p, _ in _leaves(got)] == [p for p, _ in want_leaves]
    for path, w in want_leaves:
        g = _get(got, path)
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        if np.abs(w).max() == 0:
            assert not g.any(), path
        else:
            assert _rel(g, w) < tol, (path, _rel(g, w))


def _pair(arch, **overrides):
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", **overrides)
    tcfg = dataclasses.replace(t_smoke(arch), dtype="float32", **overrides)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, tcfg, tm, _carry(jp)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


# -- configs ---------------------------------------------------------------

def test_smollm_config_matches_jax():
    """The store's config_digest hashes asdict of the config."""
    assert dataclasses.asdict(t_arch("smollm-360m")) == \
        dataclasses.asdict(j_arch("smollm-360m"))
    assert dataclasses.asdict(t_smoke("smollm-360m")) == \
        dataclasses.asdict(j_smoke("smollm-360m"))


def test_list_archs_is_sorted_and_known_to_jax():
    archs = list_archs()
    assert archs == sorted(archs) and set(ARCHS) <= set(archs)
    assert set(archs) <= set(j_list_archs())


# -- port against JAX ------------------------------------------------------

def test_forward_matches_jax(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    toks = _tokens(jcfg, 2, SEQ + 1)
    want, want_aux = jm.forward(jp, jnp.asarray(toks))
    got, aux = tm.forward(tp, toks)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) < REL
    assert float(aux) == float(want_aux) == 0.0


def test_logits_mask_the_padded_vocab():
    jcfg, jm, jp, tcfg, tm, tp = _pair("llama3-8b", vocab_size=250)
    x = np.random.default_rng(0).normal(
        size=(2, 3, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jm.logits(jp, jnp.asarray(x)))
    got = tm.logits(tp, torch.tensor(x))
    assert got.shape == (2, 3, 256)
    assert (got[..., 250:] == -1e30).all()
    np.testing.assert_array_equal(got[..., 250:].numpy(), want[..., 250:])
    assert _rel(got[..., :250], want[..., :250]) < REL


def test_logits_round_in_the_model_type_before_the_cast():
    """bf16: the product is rounded to bf16, then cast to f32."""
    cfg = dataclasses.replace(t_smoke("llama3-8b"), dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.randn((2, 3, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    got = model.logits(params, x)
    assert got.dtype == torch.float32
    assert torch.equal(got, got.to(torch.bfloat16).float())


def test_prefill_caches_match_jax(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    toks = _tokens(jcfg, 2, SEQ)
    want_logits, want_cache = jm.prefill(jp, jnp.asarray(toks),
                                         cache_len=SEQ + 4)
    logits, cache = tm.prefill(tp, toks, cache_len=SEQ + 4)
    assert _rel(logits, want_logits) < REL
    _assert_tree_close(cache, want_cache)


def test_prefill_last_only(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    toks = _tokens(jcfg, 2, SEQ)
    full, _ = tm.prefill(tp, toks)
    tm.prefill_last_only = True
    try:
        last, cache = tm.prefill(tp, toks)
    finally:
        tm.prefill_last_only = False
    assert last.shape == (2, 1, full.shape[-1])
    assert _rel(last[:, 0], full[:, -1].numpy()) < REL


def test_decode_step_from_the_jax_cache_matches_jax(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    toks = _tokens(jcfg, 2, SEQ + 1)
    _, jcache = jm.prefill(jp, jnp.asarray(toks[:, :SEQ]), cache_len=SEQ + 4)
    want, want_cache = jm.decode_step(jp, jnp.asarray(toks[:, SEQ:]),
                                      jnp.array(SEQ, jnp.int32), jcache)
    carried = _carry(jcache)
    before = {p: t.clone() for p, t in _leaves(carried)}
    got, cache = tm.decode_step(tp, toks[:, SEQ:], SEQ, carried)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < REL
    _assert_tree_close(cache, want_cache)
    for p, t in _leaves(carried):          # the input cache is unchanged
        assert torch.equal(t, before[p]), p


def test_cache_spec_matches_jax(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    want, want_axes = jm.cache_spec(3, 21)
    got, axes = tm.cache_spec(3, 21)
    assert axes == want_axes
    flat = dict(_leaves(want))
    assert [p for p, _ in _leaves(got)] == sorted(flat)
    for path, t in _leaves(got):
        assert t.device.type == "meta"
        assert tuple(t.shape) == flat[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == str(flat[path].dtype)
    zeros = tm.init_cache(3, 21, device="cpu")
    for path, t in _leaves(zeros):
        assert tuple(t.shape) == flat[path].shape and not t.any()


def test_decode_from_init_cache_matches_jax(pair):
    """Decoding from an empty cache at position 0, in both packages."""
    jcfg, jm, jp, tcfg, tm, tp = pair
    toks = _tokens(jcfg, 2, 1)
    want, want_cache = jm.decode_step(jp, jnp.asarray(toks),
                                      jnp.array(0, jnp.int32),
                                      jm.init_cache(2, 8))
    got, cache = tm.decode_step(tp, toks, 0, tm.init_cache(2, 8, "cpu"))
    assert _rel(got, want) < REL
    _assert_tree_close(cache, want_cache)


def test_decode_position_as_int_or_tensor_gives_the_same_bits(pair):
    jcfg, jm, jp, tcfg, tm, tp = pair
    toks = _tokens(jcfg, 2, SEQ + 1)
    _, cache = tm.prefill(tp, toks[:, :SEQ], cache_len=SEQ + 4)
    a, ca = tm.decode_step(tp, toks[:, SEQ:], SEQ, cache)
    b, cb = tm.decode_step(tp, toks[:, SEQ:], torch.tensor(SEQ), cache)
    assert torch.equal(a, b)
    for (p, x), (_, y) in zip(_leaves(ca), _leaves(cb)):
        assert torch.equal(x, y), p


# -- decode against forward (the JAX package's own tests, on the port) -----

def _port_model(arch, **overrides):
    cfg = dataclasses.replace(t_smoke(arch), dtype="float32", **overrides)
    if cfg.moe.enabled:
        # the JAX test's rule (tests/test_models_consistency.py): capacity
        # drops differ between a forward chunk and a decode chunk
        cfg = replace(cfg, **{"moe.capacity_factor": 8.0})
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _frames(cfg, b, s, seed=2):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _forward_and_prefill(cfg, model, params, toks, pre, cache_len):
    """(the teacher-forced logits over ``toks``, the prefill cache of its
    first ``pre`` tokens with room for ``cache_len``). An
    encoder-decoder model runs over frames of SEQ positions and its
    self cache, as long as the prompt, is padded by hand, as the JAX
    test pads it (tests/test_models_consistency.py)."""
    if not cfg.is_encdec:
        full, _ = model.forward(params, toks)
        return full, model.prefill(params, toks[:, :pre],
                                   cache_len=cache_len)[1]
    frames = _frames(cfg, toks.shape[0], SEQ)
    full, _ = model.forward(params, frames, toks)
    _, cache = model.prefill(params, frames, toks[:, :pre])
    spec, _ = model.cache_spec(toks.shape[0], cache_len)

    def pad(c, s):
        out = torch.zeros(s.shape, dtype=s.dtype)
        out[:, :, :c.shape[2]] = c
        return out
    return full, {"self": {n: pad(c, spec["self"][n])
                           for n, c in cache["self"].items()},
                  "cross": cache["cross"]}


@pytest.mark.parametrize("arch", list_archs())
def test_decode_matches_forward(arch):
    cfg, model, params = _port_model(arch)
    toks = _tokens(cfg, 2, SEQ + 1)
    full, cache = _forward_and_prefill(cfg, model, params, toks, SEQ,
                                       SEQ + 4)
    step, _ = model.decode_step(params, toks[:, SEQ:], SEQ, cache)
    assert _rel(step[:, 0], full[:, SEQ].numpy()) < DECODE_REL


@pytest.mark.parametrize("arch", list_archs())
def test_multi_step_decode(arch):
    """Decode 4 tokens in turn; each matches teacher forcing."""
    cfg, model, params = _port_model(arch)
    pre, total = 12, 16
    toks = _tokens(cfg, 2, total)
    full, cache = _forward_and_prefill(cfg, model, params, toks, pre, total)
    for t in range(pre, total):
        step, cache = model.decode_step(params, toks[:, t:t + 1], t, cache)
        err = _rel(step[:, 0], full[:, t].numpy())
        assert err < DECODE_REL, (arch, t, err)


RING = dict(block_pattern=("local",) * 5 + ("attn",), num_layers=6,
            sliding_window=16)


@pytest.mark.parametrize("arch,overrides", [("llama3-8b", RING),
                                            ("gemma3-12b", {})],
                         ids=["llama3-8b-local", "gemma3-12b"])
def test_sliding_window_ring_cache(arch, overrides):
    """Local layers' ring caches equal windowed full attention once the
    context exceeds the window, in both packages, and the port's steps
    equal the JAX package's: on gemma3-12b's SMOKE (its own 5:1 pattern,
    window 16) and on llama3-8b's SMOKE given that pattern."""
    jcfg, jm, jp, tcfg, tm, tp = _pair(arch, **overrides)
    b, pre, total = 1, 24, 28                  # pre > window
    toks = _tokens(jcfg, b, total)
    j_full, _ = jm.forward(jp, jnp.asarray(toks))
    t_full, _ = tm.forward(tp, toks)
    _, jcache = jm.prefill(jp, jnp.asarray(toks[:, :pre]), cache_len=total)
    _, tcache = tm.prefill(tp, toks[:, :pre], cache_len=total)
    assert tcache["p0"]["k"].shape[2] == 16 and \
        tcache["p5"]["k"].shape[2] == total
    _assert_tree_close(tcache, jcache)
    for t in range(pre, total):
        j_step, jcache = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.array(t, jnp.int32), jcache)
        t_step, tcache = tm.decode_step(tp, toks[:, t:t + 1], t, tcache)
        assert _rel(j_step[:, 0], j_full[:, t]) < DECODE_REL
        assert _rel(t_step[:, 0], t_full[:, t].numpy()) < DECODE_REL
        assert _rel(t_step, j_step) < REL
    _assert_tree_close(tcache, jcache)


# -- attention and rwkv6 pieces against JAX ---------------------------------

@pytest.mark.parametrize("window,s", [(0, 12), (8, 5), (8, 8), (8, 13),
                                      (8, 21)])
def test_fill_kv_cache_matches_jax(window, s):
    cfg = t_smoke("llama3-8b")
    rng = np.random.default_rng(s)
    kv = {n: rng.normal(size=(2, s, cfg.num_kv_heads, cfg.head_dim))
          .astype(np.float32) for n in ("k", "v")}
    jc = j_attn.init_kv_cache(j_smoke("llama3-8b"), 2, 24, window,
                              jnp.float32)
    want = j_attn.fill_kv_cache(jc, {n: jnp.asarray(a) for n, a in
                                     kv.items()}, window)
    empty = t_attn.init_kv_cache(cfg, 2, 24, window, torch.float32, "cpu")
    got = t_attn.fill_kv_cache(empty, {n: torch.tensor(a) for n, a in
                                       kv.items()}, window)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    assert not empty["k"].any()                # filled into a copy


@pytest.mark.parametrize("window,pos", [(0, 0), (0, 9), (0, 30), (8, 3),
                                        (8, 8), (8, 19)])
def test_attn_decode_matches_jax(window, pos):
    """Slot and mask of full and ring caches, at positions before and
    past the cache's length (a full cache of 24 slots clamps pos 30 to
    the last slot, as the JAX package does)."""
    jcfg, tcfg = j_smoke("llama3-8b"), t_smoke("llama3-8b")
    jp = j_attn.attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(pos)
    L = min(window, 24) if window else 24
    cache = {n: rng.normal(size=(2, L, tcfg.num_kv_heads, tcfg.head_dim))
             .astype(np.float32) for n in ("k", "v")}
    x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    want, want_c = j_attn.attn_decode(
        jp, jnp.asarray(x), jcfg, pos=jnp.array(pos, jnp.int32),
        cache={n: jnp.asarray(a) for n, a in cache.items()}, window=window)
    got, got_c = t_attn.attn_decode(
        _carry(jp), torch.tensor(x), tcfg, pos=pos,
        cache={n: torch.tensor(a) for n, a in cache.items()}, window=window)
    assert _rel(got, want) < REL
    for n in ("k", "v"):
        assert _rel(got_c[n], want_c[n]) < REL


def test_attn_apply_kv_out_matches_jax():
    jcfg, tcfg = j_smoke("llama3-8b"), t_smoke("llama3-8b")
    jp = j_attn.attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 9, tcfg.d_model)).astype(
        np.float32)
    pos = np.arange(9)
    want_y, want_kv = j_attn.attn_apply(jp, jnp.asarray(x), jcfg,
                                        positions=jnp.asarray(pos),
                                        kv_out=True)
    tp = _carry(jp)
    y, kv = t_attn.attn_apply(tp, torch.tensor(x), tcfg,
                              positions=torch.tensor(pos), kv_out=True)
    assert _rel(y, want_y) < REL
    for n in ("k", "v"):
        assert tuple(kv[n].shape) == (2, 9, tcfg.num_kv_heads, tcfg.head_dim)
        assert _rel(kv[n], want_kv[n]) < REL
    y_only, none = t_attn.attn_apply(tp, torch.tensor(x), tcfg,
                                     positions=torch.tensor(pos))
    assert torch.equal(y_only, y) and none is None


def test_rwkv_state_spec_matches_jax():
    jcfg, tcfg = j_smoke("rwkv6-7b"), t_smoke("rwkv6-7b")
    want, want_axes = j_rwkv.rwkv_state_spec(jcfg, 3, jnp.bfloat16)
    got, axes = t_rwkv.rwkv_state_spec(tcfg, 3, torch.bfloat16)
    assert axes == want_axes and sorted(got) == sorted(want)
    for n, t in got.items():
        assert tuple(t.shape) == want[n].shape
        assert str(t.dtype).removeprefix("torch.") == str(want[n].dtype)


def test_timemix_and_channelmix_decode_match_jax():
    jcfg, tcfg = j_smoke("rwkv6-7b"), t_smoke("rwkv6-7b")
    jt = j_rwkv.timemix_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    jc = j_rwkv.channelmix_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(2)
    d, H, K = tcfg.d_model, tcfg.d_model // 16, 16
    state = {"wkv": rng.normal(size=(2, H, K, K)).astype(np.float32),
             "shift_t": rng.normal(size=(2, d)).astype(np.float32),
             "shift_c": rng.normal(size=(2, d)).astype(np.float32)}
    x = rng.normal(size=(2, 1, d)).astype(np.float32)
    js = {n: jnp.asarray(a) for n, a in state.items()}
    ts = {n: torch.tensor(a) for n, a in state.items()}
    want, want_s = j_rwkv.timemix_decode(jt, jnp.asarray(x), jcfg, state=js)
    got, got_s = t_rwkv.timemix_decode(_carry(jt), torch.tensor(x), tcfg,
                                       state=ts)
    assert _rel(got, want) < REL
    _assert_tree_close(got_s, want_s)
    want, want_s = j_rwkv.channelmix_decode(jc, jnp.asarray(x), jcfg,
                                            state=js)
    got, got_s = t_rwkv.channelmix_decode(_carry(jc), torch.tensor(x), tcfg,
                                          state=ts)
    assert _rel(got, want) < REL
    _assert_tree_close(got_s, want_s)
    np.testing.assert_array_equal(ts["wkv"].numpy(), state["wkv"])


def test_timemix_state_matches_jax_in_both_modes():
    jcfg, tcfg = j_smoke("rwkv6-7b"), t_smoke("rwkv6-7b")
    jp = j_rwkv.timemix_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = np.random.default_rng(3).normal(size=(2, 40, tcfg.d_model)).astype(
        np.float32)
    want, want_s = j_rwkv.timemix_apply(jp, jnp.asarray(x), jcfg,
                                        mode="direct", return_state=True)
    for mode in t_rwkv.MODES:
        got, state = t_rwkv.timemix_apply(_carry(jp), torch.tensor(x), tcfg,
                                          mode=mode, return_state=True)
        assert _rel(got, want) < REL
        _assert_tree_close(state, want_s)


def test_channelmix_x_prev_matches_jax():
    jcfg, tcfg = j_smoke("rwkv6-7b"), t_smoke("rwkv6-7b")
    jp = j_rwkv.channelmix_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    prev = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    want = j_rwkv.channelmix_apply(jp, jnp.asarray(x), jcfg,
                                   x_prev=jnp.asarray(prev))
    got = t_rwkv.channelmix_apply(_carry(jp), torch.tensor(x), tcfg,
                                  x_prev=torch.tensor(prev))
    assert _rel(got, want) < REL


@pytest.mark.parametrize("s", [40, 131, 200])
def test_state_flag_leaves_the_kernel_path_y_bitwise(s):
    """rwkv6-7b: ``return_state`` adds the final state and changes no bit
    of y, in the time-mix's kernel mode and in ``ops.wkv6`` and the plain
    ``wkv6_by_chunks``; the state is the sequential recurrence's."""
    cfg = t_smoke("rwkv6-7b")
    p = t_rwkv.timemix_init(torch.Generator().manual_seed(0), cfg,
                            torch.float32)
    x = torch.tensor(np.random.default_rng(s).normal(
        size=(2, s, cfg.d_model)).astype(np.float32))
    y = t_rwkv.timemix_apply(p, x, cfg, mode="kernel")
    y2, state = t_rwkv.timemix_apply(p, x, cfg, mode="kernel",
                                     return_state=True)
    assert torch.equal(y, y2)
    assert torch.equal(state["shift_t"], x[:, -1])
    r, k, v, lw, _ = t_rwkv.timemix_inputs(p, x, cfg)
    for fn in (w_ops.wkv6, w_ref.wkv6_by_chunks):
        a = fn(r, k, v, lw, p["u"], chunk=t_rwkv.CHUNK)
        b, S = fn(r, k, v, lw, p["u"], chunk=t_rwkv.CHUNK,
                  return_state=True)
        assert torch.equal(a, b)
        if fn is w_ops.wkv6:               # the time-mix's kernel mode
            assert torch.equal(S, state["wkv"])
        else:
            assert _rel(S, state["wkv"].numpy()) < REL
    # the sequential recurrence's state after the last token
    w = torch.exp(lw)
    S = torch.zeros_like(state["wkv"])
    for t in range(s):
        S = w[:, t, ..., None] * S + k[:, t, ..., None] * v[:, t, :, None, :]
    assert _rel(state["wkv"], S.numpy()) < REL


# -- generate ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    jcfg, jm, jp, tcfg, tm, tp = _pair(arch)
    prompt = _tokens(jcfg, 2, 8, seed=5)
    want = j_generate(jm, jp, prompt, 6)
    got = generate(tm, tp, prompt, 6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_generate_matches_manual_decode():
    """The JAX package's test on the port: generate() equals a hand-rolled
    prefill + decode_step loop."""
    cfg, model, params = _port_model("smollm-360m")
    prompt = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)
    steps = 5
    out = generate(model, params, prompt, steps)
    assert out.shape == (1, steps)
    logits, cache = model.prefill(params, prompt,
                                  cache_len=prompt.shape[1] + steps)
    manual = [int(torch.argmax(logits[:, -1], dim=-1)[0])]
    pos = prompt.shape[1]
    for t in range(steps - 1):
        step, cache = model.decode_step(params, [[manual[-1]]], pos + t,
                                        cache)
        manual.append(int(torch.argmax(step[:, -1], dim=-1)[0]))
    np.testing.assert_array_equal(out[0], np.array(manual))


def test_generate_rwkv_state_based():
    cfg, model, params = _port_model("rwkv6-7b")
    out = generate(model, params, np.array([[3, 1, 4, 1, 5, 9, 2, 6]]), 4)
    assert out.shape == (1, 4)
    assert (out >= 0).all() and (out < cfg.vocab_size).all()


def test_sampled_generate_follows_its_generator():
    cfg, model, params = _port_model("llama3-8b")
    prompt = _tokens(cfg, 3, 6)
    a = generate(model, params, prompt, 5, greedy=False,
                 generator=torch.Generator().manual_seed(7))
    b = generate(model, params, prompt, 5, greedy=False,
                 generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 5) and (a >= 0).all() and \
        (a < cfg.vocab_size).all()
    # the first token is the prefill's argmax either way, as in JAX
    greedy = generate(model, params, prompt, 5)
    np.testing.assert_array_equal(a[:, 0], greedy[:, 0])



def test_position_on_makes_a_long_scalar_on_the_device():
    for pos in (5, torch.tensor(5, dtype=torch.int32), torch.tensor(5)):
        got = t_attn.position_on(pos, torch.device("cpu"))
        assert got.shape == () and got.dtype == torch.long and int(got) == 5
