"""Port parity of the configuration surface and of the configs added
with gemma3-12b.

Every config class both packages have (``asdict`` of every registered
arch, FULL and SMOKE, with the analytic parameter counts; defaults of
each class), ``ProxyConfig.contrastive_impl``,
``OptimizerConfig.compress_grads`` and the ``config.{base, registry}``
modules; then gemma3-12b (5:1 sliding-window and global attention,
head_dim 240), codeqwen1.5-7b (MHA, an untied head) and internvl2-1b (a
GQA group of 7, a vocab that is not a multiple of the padding, float
patch embeddings through the stubbed vision frontend).

Configs are compared field by field (the store's ``config_digest``
hashes ``asdict``). Weights are the JAX package's own init carried
across with ``params_from_jax``; inputs are numpy. Everything runs in
float32 on the CPU, where the flash wrapper computes its plain version;
the JAX package's Pallas flash kernel runs in interpret mode, as
tests/test_kernels.py runs it. The CUDA kernels at head_dim 240 are held
to these plain versions on the card by test_torch_cuda.py (``-k
"hd240 or configs"``). Tolerances: 1e-5 (EmbeddingService, the model's
logits and caches, of max |JAX value|), 2e-5 (flash, f32) and 3e-2
(flash, bf16), tests/test_kernels.py's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_arch
from repro.config import get_smoke_arch as j_smoke
from repro.kernels.flash_attention.flash import flash_attention_fwd as j_flash
from repro.kernels.flash_attention.ref import ref_attention as j_ref
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.runtime.serve_loop import EmbeddingService as JService
from repro.runtime.serve_loop import generate as j_generate
from repro_torch.config import BLOCK_LOCAL_ATTN
from repro_torch.config import get_arch as t_arch
from repro_torch.config import get_smoke_arch as t_smoke
from repro_torch.config import list_archs as t_list_archs
from repro_torch.kernels.flash_attention import ops as f_ops
from repro_torch.kernels.flash_attention import ref as f_ref
from repro_torch.models import build_model, params_from_jax
from repro_torch.runtime.serve_loop import EmbeddingService, generate
from torch_kernel_inputs import FLASH, _attention_inputs
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

NEW_ARCHS = ("gemma3-12b", "codeqwen1.5-7b", "internvl2-1b")
REL = 1e-5
F32 = dict(rtol=1e-5, atol=1e-5)
# gemma3-12b's head width, at a model small enough for the CPU: d 480 over
# 2 query heads and 1 KV head, the 6-layer 5:1 pattern, window 16
WIDE = dict(d_model=480, num_heads=2, num_kv_heads=1, head_dim=240,
            d_ff=320, vocab_size=256)


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


def _assert_tree_close(got, want):
    got = dict(_leaves(got))
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert _rel(got[path], w) < REL, (path, _rel(got[path], w))


def _pair(arch, **overrides):
    jcfg = dataclasses.replace(j_smoke(arch), **overrides)
    tcfg = dataclasses.replace(t_smoke(arch), **overrides)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jm, jp, tcfg, tm, _carry(jp)


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        1, vocab, size=(b, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_matches_jax(arch, size):
    """asdict field by field, FULL and SMOKE: the store's config_digest
    hashes it."""
    t, j = (t_arch, j_arch) if size == "full" else (t_smoke, j_smoke)
    assert dataclasses.asdict(t(arch)) == dataclasses.asdict(j(arch))


SHARED_CLASSES = ("ModelConfig", "MoEConfig", "SSMConfig", "RWKVConfig",
                  "OptimizerConfig", "ProxyConfig", "CascadeConfig")


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", t_list_archs())
def test_every_registered_config_matches_jax(arch, size):
    """Every arch the port registers (the MoE configs too), FULL and
    SMOKE: asdict of the config and of its MoE, SSM and RWKV parts, and
    the analytic counts and layer kinds."""
    t, j = (t_arch, j_arch) if size == "full" else (t_smoke, j_smoke)
    tc, jc = t(arch), j(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for part in ("moe", "ssm", "rwkv"):
        assert dataclasses.asdict(getattr(tc, part)) == \
            dataclasses.asdict(getattr(jc, part))
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.layer_kinds() == jc.layer_kinds()
    assert tc.attention_free == jc.attention_free


def test_moe_configs_are_registered_with_their_sizes():
    assert {"qwen3-moe-30b-a3b", "dbrx-132b"} <= set(t_list_archs())
    qwen = t_arch("qwen3-moe-30b-a3b")
    assert qwen.param_count() == 30_532_108_288
    assert qwen.active_param_count() < qwen.param_count() // 8
    assert round(t_arch("dbrx-132b").param_count() / 1e9, 1) == 131.6
    assert t_arch("rwkv6-7b").attention_free
    assert not qwen.attention_free and len(qwen.layer_kinds()) == 48


@pytest.mark.parametrize("name", SHARED_CLASSES)
def test_shared_config_class_defaults_match_jax(name):
    """Each config class both packages have: the same fields, in order,
    and the same defaults."""
    from repro.config import base as j_base
    from repro_torch.config import base as t_base
    t_cls, j_cls = getattr(t_base, name), getattr(j_base, name)
    assert [f.name for f in dataclasses.fields(t_cls)] == \
        [f.name for f in dataclasses.fields(j_cls)]
    assert dataclasses.asdict(t_cls()) == dataclasses.asdict(j_cls())


@pytest.mark.parametrize("impl", ["auto", "kernel", "ref"])
def test_proxy_config_takes_the_contrastive_impl_names(impl):
    from repro.config import ProxyConfig as JProxy
    from repro_torch.config import ProxyConfig
    cfg = ProxyConfig(contrastive_impl=impl)
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(JProxy(contrastive_impl=impl))


def test_proxy_config_refuses_interpret_by_name():
    from repro_torch.config import ProxyConfig
    with pytest.raises(ValueError, match="interpret"):
        ProxyConfig(contrastive_impl="interpret")
    with pytest.raises(ValueError, match="unknown"):
        ProxyConfig(contrastive_impl="pallas")


def test_optimizer_config_has_compress_grads():
    from repro.config import OptimizerConfig as JOpt
    from repro_torch.config import OptimizerConfig
    assert OptimizerConfig().compress_grads is False
    assert dataclasses.asdict(OptimizerConfig(compress_grads=True)) == \
        dataclasses.asdict(JOpt(compress_grads=True))


def test_config_package_has_base_and_registry():
    """``repro_torch.config.{base, registry}`` mirror the JAX package's
    modules, and ``repro_torch.config`` re-exports both."""
    import repro_torch.config as t_config
    from repro_torch.config.base import (CascadeConfig, ModelConfig,
                                         ProxyConfig, replace)
    from repro_torch.config.registry import (get_arch, get_smoke_arch,
                                             list_archs, register)
    assert t_config.ModelConfig is ModelConfig
    assert t_config.ProxyConfig is ProxyConfig
    assert t_config.CascadeConfig is CascadeConfig
    assert t_config.replace is replace and t_config.register is register
    assert t_config.get_arch is get_arch and \
        t_config.get_smoke_arch is get_smoke_arch
    assert list_archs() == t_config.list_archs()


def test_gemma3_is_the_shape_the_kernel_was_widened_for():
    cfg = t_arch("gemma3-12b")
    assert cfg.head_dim == 240 <= f_ops.MAX_HEAD_DIM
    assert cfg.block_pattern.count(BLOCK_LOCAL_ATTN) == 5
    assert cfg.num_layers // len(cfg.block_pattern) == 8
    assert t_arch("internvl2-1b").padded_vocab_size == 151808


# -- EmbeddingService at SMOKE ------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_embed_batch_matches_jax(arch):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    j_svc = JService(jcfg, jparams, batch_size=4)
    t_svc = EmbeddingService(tcfg, _carry(jparams), batch_size=4,
                             device="cpu")
    tokens = _tokens(jcfg.vocab_size, 4, 40)   # past gemma3's window of 16
    tokens[1, 25:] = 0                   # a short document
    tokens[2, :] = 0                     # a pad row pools to zeros
    want = np.asarray(j_svc.embed_batch(jnp.asarray(tokens)))
    got = t_svc.embed_batch(tokens)
    assert got.shape == (4, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert not got[2].any()


# -- flash attention at head_dim 240 ------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 16), (True, 0),
                                           (False, 0)])
def test_plain_flash_hd240_matches_pallas(causal, window):
    """The port's flash at gemma3's head width, GQA 2:1, on the CPU (its
    plain version) against the Pallas kernel in interpret mode over
    K/V expanded by the JAX model's _expand_kv."""
    b, s, h, kv, hd = 1, 64, 4, 2, 240
    arrays = _attention_inputs(b, s, s, h, kv, hd)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    tq, tk, tv = (torch.tensor(a) for a in arrays)
    scale = hd ** -0.5
    want = j_flash(jq, j_attn._expand_kv(jk, h // kv),
                   j_attn._expand_kv(jv, h // kv), scale=scale,
                   causal=causal, window=window, q_block=16, kv_block=16,
                   interpret=True)
    before = f_ops.KERNEL.launches
    got = f_ops.flash_attention_fwd(tq, tk, tv, scale=scale, causal=causal,
                                    window=window)
    assert f_ops.KERNEL.launches == before       # the CPU never launches
    np.testing.assert_allclose(_np(got), _np(want), **FLASH[torch.float32])


@pytest.mark.parametrize("causal,window,q_offset", [(True, 16, 0),
                                                    (True, 0, 0),
                                                    (True, 16, 40)])
def test_plain_with_rounded_p_bf16_hd240_matches_jax(causal, window,
                                                     q_offset):
    """The bf16 kernel's plain version at head_dim 240, on the wide
    kernel's 64-row, 32-key tiles, against the Pallas kernel (interpret
    mode) and the JAX einsum path, at the bf16 tolerance."""
    sq, skv, h, hd = 64, 40 + 64 if q_offset else 64, 2, 240
    arrays = _attention_inputs(1, sq, skv, h, h, hd)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in arrays)
    scale = hd ** -0.5
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = f_ref.attention_blocked(tq, tk, tv, scale, q_block=64,
                                  kv_block=f_ops.bf16_tile_keys(hd),
                                  round_p=True, **kw)
    assert got.dtype == torch.bfloat16
    want_flash = j_flash(jq, jk, jv, scale=scale, q_block=16, kv_block=16,
                         interpret=True, **kw)
    want_einsum = j_ref(jq, jk, jv, scale=scale, **kw)
    np.testing.assert_allclose(_np(got), _np(want_flash),
                               **FLASH[torch.bfloat16])
    np.testing.assert_allclose(_np(got), _np(want_einsum),
                               **FLASH[torch.bfloat16])


@pytest.mark.parametrize("dtype,hd,match", [
    (torch.float32, 264, "head_dim"), (torch.bfloat16, 264, "head_dim"),
    (torch.bfloat16, 244, "multiple of 8")])
def test_flash_check_refuses_what_the_wide_kernels_do_not_take(dtype, hd,
                                                               match):
    """Heads past 256 (both kernels) and a bf16 head that is not whole
    16-byte rows; 240 and 256 pass. The check runs on CPU tensors, with
    no launch."""
    before = f_ops.KERNEL.launches
    q = torch.zeros((1, 16, 2, hd), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        f_ops._check(q, q, q, window=0, q_offset=0)
    for ok in (240, 256):
        q = torch.zeros((1, 16, 2, ok), dtype=dtype)
        f_ops._check(q, q, q, window=0, q_offset=0)
    assert f_ops.KERNEL.launches == before


# -- the models against JAX ---------------------------------------------

def test_gemma3_shaped_hd240_prefill_and_decode_past_the_window():
    """head_dim 240 (d 480, 2 heads over 1 KV head), gemma3's 6-layer 5:1
    pattern, window 16: the forward, a prefill of 24 tokens past the
    window (ring caches of 16 for the local layers, a full cache for the
    global one) and 4 decode steps, each against JAX within 1e-5."""
    jcfg, jm, jp, tcfg, tm, tp = _pair("gemma3-12b", **WIDE)
    assert tcfg.head_dim == 240 and tcfg.sliding_window == 16
    pre, total = 24, 28
    toks = _tokens(jcfg.vocab_size, 2, total)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = tm.forward(tp, toks)
    assert _rel(got, want) < REL
    j_logits, jcache = jm.prefill(jp, jnp.asarray(toks[:, :pre]),
                                  cache_len=total)
    t_logits, tcache = tm.prefill(tp, toks[:, :pre], cache_len=total)
    assert _rel(t_logits, j_logits) < REL
    assert tcache["p0"]["k"].shape[2] == 16
    assert tcache["p5"]["k"].shape[2] == total
    _assert_tree_close(tcache, jcache)
    for t in range(pre, total):
        j_step, jcache = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.array(t, jnp.int32), jcache)
        t_step, tcache = tm.decode_step(tp, toks[:, t:t + 1], t, tcache)
        assert _rel(t_step, j_step) < REL, t
    _assert_tree_close(tcache, jcache)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_forward_prefill_and_generate_match_jax(arch):
    """At SMOKE: the logits (codeqwen's untied head, internvl2's masked
    padded vocab), a prefill's caches, and greedy tokens."""
    jcfg, jm, jp, tcfg, tm, tp = _pair(arch)
    toks = _tokens(jcfg.vocab_size, 2, 20)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = tm.forward(tp, toks)
    assert got.shape == want.shape and _rel(got, want) < REL
    _, jcache = jm.prefill(jp, jnp.asarray(toks), cache_len=24)
    _, tcache = tm.prefill(tp, toks, cache_len=24)
    _assert_tree_close(tcache, jcache)
    prompt = _tokens(jcfg.vocab_size, 2, 8, seed=5)
    np.testing.assert_array_equal(generate(tm, tp, prompt, 6),
                                  np.asarray(j_generate(jm, jp, prompt, 6)))


def test_internvl2_forward_on_float_embeddings_matches_jax():
    """internvl2-1b takes precomputed patch embeddings (its vision
    frontend stubbed, as in the JAX package): float inputs are cast to
    the model's type and skip the embedding table."""
    jcfg, jm, jp, tcfg, tm, tp = _pair("internvl2-1b")
    patches = np.random.default_rng(3).normal(
        size=(2, 24, jcfg.d_model)).astype(np.float32)
    want, _ = jm.forward(jp, jnp.asarray(patches))
    got, _ = tm.forward(tp, torch.tensor(patches))
    assert got.shape == (2, 24, tcfg.padded_vocab_size)
    assert _rel(got, want) < REL
    assert (got[..., tcfg.vocab_size:] == -1e30).all()
    # the embedding path's hidden states are the forward's, before the head
    hidden = tm.hidden(tp, torch.tensor(patches))
    assert hidden.shape == (2, 24, tcfg.d_model)
    assert torch.equal(tm.logits(tp, hidden), got)
