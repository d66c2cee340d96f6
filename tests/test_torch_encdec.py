"""Port parity of the encoder-decoder family: ``models.common``'s
sinusoidal positions, ``models.attention``'s ``use_rope=False`` and
cross-attention, and ``models.encdec.EncDecLM`` (``encode``, ``forward``,
``prefill``, ``cache_spec``/``init_cache``, ``decode_step``), against the
JAX package's.

whisper-base SMOKE in float32 (2 + 2 layers, d 48, head_dim 12) on the
CPU, where the flash wrapper computes its plain version. Weights are the
JAX package's own init carried across with ``params_from_jax`` (a JAX
cache is carried the same way); inputs come from a numpy seed.
Tolerances: 1e-5 of max |JAX value|; decode against teacher forcing, in
each package alone, 5e-4 of max |logit|, the JAX package's own bar
(``tests/test_models_consistency.py``). The sinusoidal positions (values
in [-1, 1]) are held to 1e-5 + pos * 2^-22 absolute at position pos:
both packages compute ``div = exp(2i * -log(10000) / dim)`` in float32
from the same arguments, but XLA's CPU exp and torch's round some of
them to neighbouring floats (at dim 512, 25 and 5 of the 256 entries
differ from the correctly rounded exp), and a one-ulp change of ``div``
(<= 2^-23 div <= 2^-23) moves the angle ``pos * div`` by up to pos *
2^-23, plus half an ulp of the angle where the two products round apart.
At pos <= 40 that is within 1e-5; at 1499 it is 3.7e-4 (6.1e-5 seen).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke_arch as j_smoke
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import common as j_common
from repro_torch.config import get_arch as t_arch
from repro_torch.config import get_smoke_arch as t_smoke
from repro_torch.models import EncDecLM, build_model, params_from_jax
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models.common import tree_map
from repro_torch.runtime.serve_loop import EmbeddingService, generate
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-base"
REL = 1e-5
DECODE_REL = 5e-4
FRAMES, SEQ = 19, 16


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


def _assert_tree_close(got, want, tol=REL):
    """Every leaf of the JAX tree ``want`` against the port's ``got``:
    same paths, shapes and types, values within ``tol`` of max |want|."""
    want_leaves = list(_leaves(jax.tree.map(np.asarray, want)))
    got_leaves = dict(_leaves(got))
    assert sorted(got_leaves) == [p for p, _ in want_leaves]
    for path, w in want_leaves:
        g = got_leaves[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        if np.abs(w).max() == 0:
            assert not g.any(), path
        else:
            assert _rel(g, w) < tol, (path, _rel(g, w))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, tcfg, _carry(jp)


def _inputs(cfg, b=2, frames=FRAMES, seq=SEQ + 1, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, frames, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab_size, size=(b, seq)).astype(np.int32))


def _pad_self_jax(cache, length):
    """The self cache padded by hand with zeros to ``length`` slots, as
    the JAX test pads it; "cross" as it is."""
    return {"self": jax.tree.map(
        lambda c: jnp.zeros(c.shape[:2] + (length,) + c.shape[3:], c.dtype)
        .at[:, :, :c.shape[2]].set(c), cache["self"]),
        "cross": cache["cross"]}


def _pad_self_port(cache, length):
    """``_pad_self_jax`` on the port's cache."""
    grow = lambda c: torch.cat([c, c.new_zeros(
        c.shape[:2] + (length - c.shape[2],) + c.shape[3:])], dim=2)
    return {"self": tree_map(grow, cache["self"]), "cross": cache["cross"]}


# -- configs and positions ----------------------------------------------------

def _pos_tol(pos):
    """The positions' bound at ``pos`` (the module docstring)."""
    return REL + np.asarray(pos, np.float64) * 2.0 ** -22


def test_whisper_configs_match_jax():
    from repro.config import get_arch as j_arch
    for t, j in ((t_arch, j_arch), (t_smoke, j_smoke)):
        assert dataclasses.asdict(t(ARCH)) == dataclasses.asdict(j(ARCH))
    assert t_arch(ARCH).is_encdec and t_arch(ARCH).head_dim == 64


@pytest.mark.parametrize("seq,dim", [(1, 48), (40, 48), (1500, 512),
                                     (449, 10)])
def test_sinusoidal_positions_match_jax(seq, dim):
    want = np.asarray(j_common.sinusoidal_positions(seq, dim))
    got = t_common.sinusoidal_positions(seq, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, dim)
    err = np.abs(got.numpy() - want)
    assert (err <= _pos_tol(np.arange(seq))[:, None]).all(), err.max()
    # sin at the even columns, cos at the odd ones
    np.testing.assert_array_equal(got[0].numpy(), np.tile([0.0, 1.0],
                                                          dim // 2))


@pytest.mark.parametrize("pos", [0, 1, 447, 448, 1499, 4000])
def test_sinusoidal_position_at_matches_jax(pos):
    dim = 512
    want = np.asarray(j_common.sinusoidal_position_at(
        jnp.array(pos, jnp.int32), dim))
    got = t_common.sinusoidal_position_at(torch.tensor(pos), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (dim,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_pos_tol(pos))
    if pos < 1500:            # the row of the table, bit for bit
        table = t_common.sinusoidal_positions(1500, dim)
        assert torch.equal(got, table[pos])


# -- attention without RoPE, and cross-attention ------------------------------

@pytest.mark.parametrize("impl", t_attn.IMPLS)
@pytest.mark.parametrize("causal", [True, False])
def test_attn_apply_without_rope_matches_jax(pair, impl, causal):
    jcfg, _, jp, tcfg, tp = pair
    jl, tl = jp["decoder"]["self_attn"], tp["decoder"]["self_attn"]
    jl = jax.tree.map(lambda t: t[0], jl)
    tl = tree_map(lambda t: t[0], tl)
    x = np.random.default_rng(2).normal(size=(2, 9, tcfg.d_model)).astype(
        np.float32)
    pos = np.arange(9)
    want_y, want_kv = j_attn.attn_apply(
        jl, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), causal=causal,
        impl="blocked", kv_out=True, use_rope=False)
    y, kv = t_attn.attn_apply(tl, torch.tensor(x), tcfg,
                              positions=torch.tensor(pos), causal=causal,
                              impl=impl, kv_out=True, use_rope=False)
    assert _rel(y, want_y) < REL
    for n in ("k", "v"):
        assert _rel(kv[n], want_kv[n]) < REL
    # the unrotated K is the plain projection; RoPE moves it
    rotated = t_attn.attn_apply(tl, torch.tensor(x), tcfg,
                                positions=torch.tensor(pos), causal=causal,
                                impl=impl, kv_out=True)[1]
    assert torch.equal(rotated["v"], kv["v"])
    assert not torch.allclose(rotated["k"], kv["k"])


@pytest.mark.parametrize("pos", [0, 5, 11, 30])
def test_attn_decode_without_rope_matches_jax(pair, pos):
    """A full cache of 12 slots: positions inside it and past it (30
    clamps to the last slot)."""
    jcfg, _, jp, tcfg, tp = pair
    jl = jax.tree.map(lambda t: t[1], jp["decoder"]["self_attn"])
    tl = tree_map(lambda t: t[1], tp["decoder"]["self_attn"])
    rng = np.random.default_rng(pos)
    cache = {n: rng.normal(size=(2, 12, tcfg.num_kv_heads, tcfg.head_dim))
             .astype(np.float32) for n in ("k", "v")}
    x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    want, want_c = j_attn.attn_decode(
        jl, jnp.asarray(x), jcfg, pos=jnp.array(pos, jnp.int32),
        cache={n: jnp.asarray(a) for n, a in cache.items()}, use_rope=False)
    got, got_c = t_attn.attn_decode(
        tl, torch.tensor(x), tcfg, pos=pos,
        cache={n: torch.tensor(a) for n, a in cache.items()},
        use_rope=False)
    assert _rel(got, want) < REL
    for n in ("k", "v"):
        assert _rel(got_c[n], want_c[n]) < REL


def _cross_layer(pair, i=0):
    jcfg, _, jp, tcfg, tp = pair
    return (jcfg, jax.tree.map(lambda t: t[i], jp["decoder"]["cross_attn"]),
            tcfg, tree_map(lambda t: t[i], tp["decoder"]["cross_attn"]))


def test_cross_attn_init_draws_the_attention_weights(pair):
    cfg = t_smoke(ARCH)
    got = t_attn.cross_attn_init(torch.Generator().manual_seed(0), cfg,
                                 torch.float32)
    want = t_attn.attn_init(torch.Generator().manual_seed(0), cfg,
                            torch.float32)
    assert sorted(got) == ["wk", "wo", "wq", "wv"]
    for n in got:
        assert torch.equal(got[n], want[n])
    jcross = jax.tree.map(lambda t: t[0], pair[2]["decoder"]["cross_attn"])
    for n in got:
        assert tuple(got[n].shape) == jcross[n].shape


@pytest.mark.parametrize("sq,skv", [(7, 19), (1, 19), (19, 7)])
def test_encode_kv_and_cross_attn_apply_match_jax(pair, sq, skv):
    jcfg, jl, tcfg, tl = _cross_layer(pair)
    rng = np.random.default_rng(sq * 100 + skv)
    enc = rng.normal(size=(2, skv, tcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, sq, tcfg.d_model)).astype(np.float32)
    want_kv = j_attn.encode_kv(jl, jnp.asarray(enc))
    kv = t_attn.encode_kv(tl, torch.tensor(enc))
    for n in ("k", "v"):
        assert tuple(kv[n].shape) == (2, skv, tcfg.num_kv_heads,
                                      tcfg.head_dim)
        assert _rel(kv[n], want_kv[n]) < REL
    want = j_attn.cross_attn_apply(jl, jnp.asarray(x), jcfg, kv=want_kv)
    got = t_attn.cross_attn_apply(tl, torch.tensor(x), tcfg, kv=kv)
    assert tuple(got.shape) == (2, sq, tcfg.d_model)
    assert _rel(got, want) < REL


def test_cross_attn_apply_goes_through_the_flash_entry(pair, monkeypatch):
    """Whatever the model's attn_impl: the flash entry, non-causal."""
    from repro_torch.kernels.flash_attention import ops as f_ops
    _, _, tcfg, tl = _cross_layer(pair)
    calls = []
    inner = f_ops.attention

    def counted(*args, **kw):
        calls.append(kw)
        return inner(*args, **kw)
    monkeypatch.setattr(f_ops, "attention", counted)
    x = torch.randn(2, 7, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    enc = torch.randn(2, 19, tcfg.d_model, generator=torch.Generator()
                      .manual_seed(1))
    t_attn.cross_attn_apply(tl, x, tcfg, kv=t_attn.encode_kv(tl, enc))
    assert len(calls) == 1 and calls[0]["causal"] is False


@pytest.mark.parametrize("zero", [False, True], ids=["cache", "zero-cache"])
def test_cross_attn_decode_matches_jax(pair, zero):
    """Against a random cross cache, and against a zero one (as
    ``init_cache`` gives): no mask, so it attends uniformly over zeros
    in both packages."""
    jcfg, jl, tcfg, tl = _cross_layer(pair, 1)
    rng = np.random.default_rng(5)
    shape = (2, 19, tcfg.num_kv_heads, tcfg.head_dim)
    cache = {n: (np.zeros(shape) if zero else rng.normal(size=shape))
             .astype(np.float32) for n in ("k", "v")}
    x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    want = j_attn.cross_attn_decode(jl, jnp.asarray(x), jcfg, kv={
        n: jnp.asarray(a) for n, a in cache.items()})
    got = t_attn.cross_attn_decode(tl, torch.tensor(x), tcfg, kv={
        n: torch.tensor(a) for n, a in cache.items()})
    assert tuple(got.shape) == (2, 1, tcfg.d_model)
    if zero:
        assert not got.any() and not np.asarray(want).any()
    else:
        assert _rel(got, want) < REL
    # one query row over the cache: the full-sequence form, the same
    full = t_attn.cross_attn_apply(tl, torch.tensor(x), tcfg, kv={
        n: torch.tensor(a) for n, a in cache.items()})
    torch.testing.assert_close(got, full, rtol=REL, atol=REL)


# -- the model ----------------------------------------------------------------

def test_build_model_returns_an_encdec_lm(pair):
    cfg = t_smoke(ARCH)
    model = build_model(cfg)
    assert isinstance(model, EncDecLM) and model.takes_embeds
    assert model.attn_impl == "flash"
    assert build_model(cfg, attn_impl="blocked").attn_impl == "blocked"
    with pytest.raises(ValueError, match="attention impl"):
        build_model(cfg, attn_impl="dense").encode(
            pair[4], np.zeros((1, 3, cfg.d_model), np.float32))
    # the JAX EncDecLM takes and ignores the decoder-only options
    assert isinstance(build_model(cfg, rwkv_mode="direct", causal_skip=True,
                                  moe_dispatch="sort"), EncDecLM)
    from repro_torch.models.transformer import TransformerLM
    with pytest.raises(NotImplementedError, match="build_model"):
        TransformerLM(cfg)


def test_init_draws_the_jax_tree(pair):
    """The port's init: the JAX tree's paths, shapes and types, the
    norms ones, on the generator's device; the drawn count at SMOKE
    against JAX's."""
    _, jm, jp, tcfg, _ = pair
    params = EncDecLM(tcfg).init(torch.Generator().manual_seed(0))
    want = dict(_leaves(jax.tree.map(np.asarray, jp)))
    got = dict(_leaves(params))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert got[path].dtype == torch.float32, path
        if path[-1] == "scale":
            assert bool((got[path] == 1).all()), path
    assert sum(t.numel() for _, t in _leaves(params)) == \
        sum(w.size for w in want.values())


def test_full_drawn_count_against_param_count():
    """whisper-base FULL's drawn params (jax.eval_shape of the JAX init,
    nothing allocated): param_count() leaves out the 103 padded
    vocabulary rows and eight norms (each decoder layer's norm3,
    enc_norm and final_norm)."""
    from repro.config import get_arch as j_arch
    cfg = j_arch(ARCH)
    shapes = jax.eval_shape(j_build_model(cfg).init, jax.random.PRNGKey(0))
    drawn = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    d = cfg.d_model
    assert drawn == 83_247_104
    assert t_arch(ARCH).param_count() == cfg.param_count() == 83_190_272
    assert drawn - cfg.param_count() == (cfg.padded_vocab_size
                                         - cfg.vocab_size) * d \
        + (cfg.num_layers + 2) * d


def test_encode_matches_jax(pair):
    jcfg, jm, jp, tcfg, tp = pair
    frames, _ = _inputs(tcfg)
    want = jm.encode(jp, jnp.asarray(frames))
    got = EncDecLM(tcfg).encode(tp, frames)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got, want) < REL


@pytest.mark.parametrize("impl", t_attn.IMPLS)
def test_forward_matches_jax(pair, impl):
    jcfg, jm, jp, tcfg, tp = pair
    frames, toks = _inputs(tcfg)
    want, want_aux = jm.forward(jp, jnp.asarray(frames), jnp.asarray(toks))
    got, aux = EncDecLM(tcfg, attn_impl=impl).forward(tp, frames, toks)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got, want) < REL
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert float(aux) == float(want_aux) == 0.0


def test_logits_mask_the_padded_vocab(pair):
    """vocab 250 (padded to 256): the padded ids hold -1e30, as in JAX."""
    _, _, jp, _, tp = pair
    jcfg = dataclasses.replace(j_smoke(ARCH), vocab_size=250)
    tcfg = dataclasses.replace(t_smoke(ARCH), vocab_size=250)
    frames, toks = _inputs(tcfg)
    want, _ = j_build_model(jcfg).forward(jp, jnp.asarray(frames),
                                          jnp.asarray(toks))
    got, _ = EncDecLM(tcfg).forward(tp, frames, toks)
    assert (got[..., 250:] == -1e30).all()
    np.testing.assert_array_equal(got[..., 250:].numpy(),
                                  np.asarray(want)[..., 250:])
    assert _rel(got[..., :250], np.asarray(want)[..., :250]) < REL


def test_prefill_matches_jax(pair):
    """Logits and both caches: "self" as long as the prompt, "cross" as
    long as the frames."""
    jcfg, jm, jp, tcfg, tp = pair
    frames, toks = _inputs(tcfg, seq=SEQ)
    want, want_cache = jm.prefill(jp, jnp.asarray(frames), jnp.asarray(toks))
    got, cache = EncDecLM(tcfg).prefill(tp, frames, toks)
    assert _rel(got, want) < REL
    _assert_tree_close(cache, want_cache)
    L, kv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    assert tuple(cache["self"]["k"].shape) == (L, 2, SEQ, kv, hd)
    assert tuple(cache["cross"]["v"].shape) == (L, 2, FRAMES, kv, hd)


def test_cache_spec_and_init_cache_match_jax(pair):
    """Both "self" and "cross" sized by seq_len, stacked over the
    decoder layers."""
    jcfg, jm, jp, tcfg, tp = pair
    model = EncDecLM(tcfg)
    want, want_axes = jm.cache_spec(3, 21)
    got, axes = model.cache_spec(3, 21)
    assert axes == want_axes
    flat = dict(_leaves(want))
    assert sorted(dict(_leaves(got))) == sorted(flat)
    for path, t in _leaves(got):
        assert t.device.type == "meta"
        assert tuple(t.shape) == flat[path].shape == (
            tcfg.num_layers, 3, 21, tcfg.num_kv_heads, tcfg.head_dim)
        assert str(t.dtype).removeprefix("torch.") == str(flat[path].dtype)
    zeros = model.init_cache(3, 21, device="cpu")
    for path, t in _leaves(zeros):
        assert tuple(t.shape) == flat[path].shape and not t.any()
        assert t.device.type == "cpu"


def test_decode_from_init_cache_matches_jax(pair):
    """A step at position 0 from the zero cache (its cross half zeros:
    uniform attention over zeros), in both packages."""
    jcfg, jm, jp, tcfg, tp = pair
    _, toks = _inputs(tcfg, seq=1)
    want, want_cache = jm.decode_step(jp, jnp.asarray(toks),
                                      jnp.array(0, jnp.int32),
                                      jm.init_cache(2, 8))
    got, cache = EncDecLM(tcfg).decode_step(
        tp, toks, 0, EncDecLM(tcfg).init_cache(2, 8, device="cpu"))
    assert _rel(got, want) < REL
    _assert_tree_close(cache, want_cache)


def test_decode_step_after_a_padded_cache_matches_jax(pair):
    """The JAX test's form: prefill SEQ tokens, pad the self cache by
    hand to SEQ + 4, step at SEQ; from the carried JAX cache too. The
    input cache is not changed, and "cross" comes back as it went in."""
    jcfg, jm, jp, tcfg, tp = pair
    model = EncDecLM(tcfg)
    frames, toks = _inputs(tcfg)
    _, jcache = jm.prefill(jp, jnp.asarray(frames),
                           jnp.asarray(toks[:, :SEQ]))
    jcache = _pad_self_jax(jcache, SEQ + 4)
    want, want_cache = jm.decode_step(jp, jnp.asarray(toks[:, SEQ:]),
                                      jnp.array(SEQ, jnp.int32), jcache)
    _, cache = model.prefill(tp, frames, toks[:, :SEQ])
    cache = _pad_self_port(cache, SEQ + 4)
    _assert_tree_close(cache, jcache)
    for start in (cache, _carry(jcache)):
        before = {p: t.clone() for p, t in _leaves(start)}
        got, new = model.decode_step(tp, toks[:, SEQ:], SEQ, start)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(got, want) < REL
        _assert_tree_close(new, want_cache)
        assert new["cross"] is start["cross"]
        for p, t in _leaves(start):
            assert torch.equal(t, before[p]), p
    a, _ = model.decode_step(tp, toks[:, SEQ:], torch.tensor(SEQ), cache)
    b, _ = model.decode_step(tp, toks[:, SEQ:], SEQ, cache)
    assert torch.equal(a, b)


def test_four_decode_steps_match_teacher_forcing(pair):
    """Four steps in turn after a 12-token prefill padded to 16: each
    step's logits against the teacher-forced forward (5e-4 of max
    |logit|, in each package) and against the JAX step (1e-5)."""
    jcfg, jm, jp, tcfg, tp = pair
    model = EncDecLM(tcfg)
    pre, total = 12, 16
    frames, toks = _inputs(tcfg, seq=total)
    j_full, _ = jm.forward(jp, jnp.asarray(frames), jnp.asarray(toks))
    t_full, _ = model.forward(tp, frames, toks)
    _, jcache = jm.prefill(jp, jnp.asarray(frames),
                           jnp.asarray(toks[:, :pre]))
    _, tcache = model.prefill(tp, frames, toks[:, :pre])
    jcache, tcache = _pad_self_jax(jcache, total), _pad_self_port(tcache,
                                                                  total)
    for t in range(pre, total):
        j_step, jcache = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.array(t, jnp.int32), jcache)
        t_step, tcache = model.decode_step(tp, toks[:, t:t + 1], t, tcache)
        assert _rel(j_step[:, 0], j_full[:, t]) < DECODE_REL
        assert _rel(t_step[:, 0], t_full[:, t].numpy()) < DECODE_REL
        assert _rel(t_step, j_step) < REL
    _assert_tree_close(tcache, jcache)


def test_decode_past_an_unpadded_prefill_cache_matches_jax(pair):
    """No padding: the self cache is as long as the prompt, so steps at
    pos >= its length write to slot L - 1 (the clamp), the same in both
    packages."""
    jcfg, jm, jp, tcfg, tp = pair
    model = EncDecLM(tcfg)
    frames, toks = _inputs(tcfg, seq=SEQ + 3)
    _, jcache = jm.prefill(jp, jnp.asarray(frames),
                           jnp.asarray(toks[:, :SEQ]))
    _, tcache = model.prefill(tp, frames, toks[:, :SEQ])
    for t in range(SEQ, SEQ + 3):
        want, jcache = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.array(t, jnp.int32), jcache)
        got, tcache = model.decode_step(tp, toks[:, t:t + 1], t, tcache)
        assert tuple(tcache["self"]["k"].shape)[2] == SEQ
        assert _rel(got, want) < REL
        _assert_tree_close(tcache, jcache)
    # the last slot holds the last step's K
    last = model.decode_step(tp, toks[:, SEQ - 1:SEQ], SEQ + 5, tcache)[1]
    assert not torch.equal(last["self"]["k"][:, :, -1],
                           tcache["self"]["k"][:, :, -1])
    assert torch.equal(last["self"]["k"][:, :, :-1],
                       tcache["self"]["k"][:, :, :-1])


def test_params_from_jax_keeps_the_tree_in_bf16():
    """A bf16 JAX tree is carried leaf for leaf in bf16: no leaf of the
    encoder-decoder LM is kept float32."""
    cfg = dataclasses.replace(j_smoke(ARCH), dtype="bfloat16")
    jp = j_build_model(cfg).init(jax.random.PRNGKey(0))
    tp = _carry(jp)
    for path, t in _leaves(tp):
        assert t.dtype == torch.bfloat16, path
    np.testing.assert_array_equal(
        tp["embed"]["table"].float().numpy(),
        np.asarray(jp["embed"]["table"].astype(jnp.float32)))


def test_embedding_service_and_generate_refuse_an_encdec_model(pair):
    _, _, _, tcfg, tp = pair
    with pytest.raises(TypeError, match="decoder-only"):
        EmbeddingService(tcfg, tp, device="cpu")
    with pytest.raises(TypeError, match="decoder-only"):
        generate(EncDecLM(tcfg), tp, np.ones((2, 4), np.int32), 3)
