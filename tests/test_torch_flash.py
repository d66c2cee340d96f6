"""Port parity of the flash attention forward and the attention layer.

On the CPU the port's ``flash_attention_fwd`` computes its plain version
(the online softmax over GQA-expanded K/V); it is held against the JAX
package's Pallas kernel in interpret mode, as tests/test_kernels.py runs
it, on the same numpy inputs. So is the plain version of the bfloat16
tensor-core kernel (``attention_blocked(..., round_p=True)``). The CUDA
kernels themselves are held against the plain versions on the card by
test_torch_cuda.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ModelConfig as JModelConfig
from repro.kernels.flash_attention.flash import flash_attention_fwd as j_flash
from repro.kernels.flash_attention.ref import ref_attention as j_ref
from repro.models import attention as j_attn
from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention import ops as f_ops
from repro_torch.kernels.flash_attention import ref as f_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import params_from_jax
from torch_kernel_inputs import (FLASH, _attention_inputs,
                                 assert_flash_long_close)
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

F32 = FLASH[torch.float32]


def _both(*arrays, dtype=np.float32):
    """numpy arrays -> (jax arrays, torch CPU tensors) of one dtype."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.tensor(a).to(td) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,h,hd", [(2, 64, 3, 16), (1, 48, 2, 8),
                                      (2, 128, 4, 32)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_plain_flash_matches_pallas(b, s, h, hd, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _both(*_attention_inputs(b, s, s, h, h, hd))
    scale = hd ** -0.5
    want = j_flash(jq, jk, jv, scale=scale, causal=causal, window=window,
                   q_block=16, kv_block=16, interpret=True)
    before = f_ops.KERNEL.launches
    got = f_ops.flash_attention_fwd(tq, tk, tv, scale=scale, causal=causal,
                                    window=window)
    assert f_ops.KERNEL.launches == before       # the CPU never launches
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_plain_flash_q_offset_matches_pallas():
    """chunked-prefill continuation: q_offset > 0, skv > sq."""
    (jq, jk, jv), (tq, tk, tv) = _both(*_attention_inputs(1, 32, 96, 2, 2,
                                                          16))
    want = j_flash(jq, jk, jv, scale=0.25, causal=True, q_offset=64,
                   q_block=16, kv_block=16, interpret=True)
    got = f_ops.flash_attention_fwd(tq, tk, tv, scale=0.25, causal=True,
                                    q_offset=64)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_plain_flash_gqa_matches_pallas_on_expanded_kv(causal, window):
    """K/V with fewer heads than Q: the port reads KV head j // groups,
    the Pallas kernel takes K/V expanded by the model's _expand_kv."""
    (jq, jk, jv), (tq, tk, tv) = _both(*_attention_inputs(2, 80, 80, 8, 2,
                                                          16))
    want = j_flash(jq, j_attn._expand_kv(jk, 4), j_attn._expand_kv(jv, 4),
                   scale=0.25, causal=causal, window=window, q_block=16,
                   kv_block=16, interpret=True)
    got = f_ops.flash_attention_fwd(tq, tk, tv, scale=0.25, causal=causal,
                                    window=window)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_array_equal(
        f_ref.expand_kv(tk, 4).numpy(),
        np.asarray(j_attn._expand_kv(jk, 4)))


def test_plain_flash_bf16_matches_pallas():
    (jq, jk, jv), (tq, tk, tv) = _both(*_attention_inputs(1, 64, 64, 2, 2,
                                                          16),
                                       dtype="bfloat16")
    want = j_flash(jq, jk, jv, scale=0.25, causal=True, q_block=32,
                   kv_block=32, interpret=True)
    got = f_ops.flash_attention_fwd(tq, tk, tv, scale=0.25, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want),
                               **FLASH[torch.bfloat16])


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (False, 0, 0),
                                                    (True, 24, 0),
                                                    (True, 0, 40)])
def test_plain_versions_match_jax(causal, window, q_offset):
    """ref_attention (masked einsum) and attention_blocked over several
    KV blocks, each against its JAX namesake."""
    (jq, jk, jv), (tq, tk, tv) = _both(*_attention_inputs(2, 40, 80, 3, 3,
                                                          16))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_allclose(
        _np(f_ref.ref_attention(tq, tk, tv, scale=0.25, **kw)),
        _np(j_ref(jq, jk, jv, scale=0.25, **kw)), **F32)
    np.testing.assert_allclose(
        _np(f_ref.attention_blocked(tq, tk, tv, 0.25, q_block=16,
                                    kv_block=32, **kw)),
        _np(j_attn.attention_blocked(jq, jk, jv, 0.25, q_block=16,
                                     kv_block=32, **kw)), **F32)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (False, 0, 0),
                                                    (True, 24, 0),
                                                    (True, 0, 40)])
def test_plain_with_rounded_p_is_blocked_at_f32(causal, window, q_offset):
    """The bf16 kernel's plain version (P rounded to v.dtype for P V) is
    attention_blocked bit for bit on f32 inputs, where that rounding is
    the identity."""
    tq, tk, tv = (torch.tensor(a) for a in _attention_inputs(2, 40, 80, 3,
                                                              3, 16))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=16,
              kv_block=32)
    want = f_ref.attention_blocked(tq, tk, tv, 0.25, **kw)
    got = f_ref.attention_blocked(tq, tk, tv, 0.25, round_p=True, **kw)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("sq,skv,h,hd,causal,window,q_offset", [
    (64, 64, 2, 16, True, 0, 0),
    (48, 48, 2, 8, False, 0, 0),
    (64, 64, 2, 32, True, 24, 0),
    (32, 96, 2, 16, True, 0, 64),
    (77, 200, 2, 16, True, 24, 123),
])
def test_plain_with_rounded_p_bf16_matches_jax(sq, skv, h, hd, causal,
                                               window, q_offset):
    """On bf16 inputs, on the kernel's 64-row, 64-key tiles, the bf16
    kernel's plain version against the Pallas kernel (interpret mode)
    and the JAX einsum path, at the bf16 tolerance."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        *_attention_inputs(1, sq, skv, h, h, hd), dtype="bfloat16")
    scale = hd ** -0.5
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = f_ref.attention_blocked(tq, tk, tv, scale, q_block=64,
                                  kv_block=64, round_p=True, **kw)
    assert got.dtype == torch.bfloat16
    want_flash = j_flash(jq, jk, jv, scale=scale, q_block=16, kv_block=16,
                         interpret=True, **kw)
    want_einsum = j_ref(jq, jk, jv, scale=scale, **kw)
    np.testing.assert_allclose(_np(got), _np(want_flash),
                               **FLASH[torch.bfloat16])
    np.testing.assert_allclose(_np(got), _np(want_einsum),
                               **FLASH[torch.bfloat16])


def test_long_row_bar_holds_two_tilings_and_catches_a_lost_tile():
    """The bar the 32,768-key flash call is held to on the card: the bf16
    kernel's plain version on its 64 x 64 tiles passes against the
    512-row, 512-key pass; with the first 64 keys' values lost from P V
    (what a dropped K/V tile does) it fails."""
    q, k, v = (torch.tensor(a).to(torch.bfloat16)
               for a in _attention_inputs(1, 2048, 2048, 4, 4, 128))
    scale = 128 ** -0.5
    tiles = f_ref.attention_blocked(q, k, v, scale, causal=True, q_block=64,
                                    kv_block=64, round_p=True)
    blocks = f_ref.attention_blocked(q, k, v, scale, causal=True,
                                     round_p=True)
    assert_flash_long_close(tiles, blocks)
    lost = v.clone()
    lost[:, :64] = 0
    dropped = f_ref.attention_blocked(q, k, lost, scale, causal=True,
                                      round_p=True)
    with pytest.raises(AssertionError):
        assert_flash_long_close(dropped[:, -64:], blocks[:, -64:])


@pytest.mark.parametrize("impl", ["flash", "blocked", "einsum"])
@pytest.mark.parametrize("window", [0, 6])
def test_attn_apply_matches_jax(impl, window):
    """The attention layer (projections, half-split RoPE, GQA, output
    projection) with carried weights, every impl against the JAX
    layer's blocked path."""
    kw = dict(name="attn-test", d_model=32, num_heads=4, num_kv_heads=2,
              d_ff=64, vocab_size=64, dtype="float32", rope_theta=500000.0)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = j_attn.attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(1).normal(size=(2, 19, 32)).astype(np.float32)
    want, _ = j_attn.attn_apply(jp, jnp.asarray(x), jcfg,
                                positions=jnp.arange(19), window=window)
    got, _ = t_attn.attn_apply(tp, torch.tensor(x), tcfg,
                               positions=torch.arange(19), window=window,
                               impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_unported_model_paths_raise():
    """The clamped "factored" RWKV6 lowering builds and runs
    (``tests/test_torch_factored.py`` holds it to JAX); an unknown block
    kind raises ``ValueError``. An encoder-decoder config builds an ``EncDecLM``
    that runs a prefill and a decode step (``tests/test_torch_encdec.py``
    holds it to JAX), Mamba2 and shared-attention patterns build and
    run a prefill and a decode step (``tests/test_torch_ssm.py`` holds
    them to JAX).
    KV caches are ported: a group's full-sequence pass collects its
    layer's cache (``tests/test_torch_decode.py`` holds it to JAX)."""
    from repro_torch.config import MoEConfig, SSMConfig
    from repro_torch.models import build_model
    from repro_torch.models.transformer import group_params
    cfg = ModelConfig(d_model=16, num_heads=2, num_kv_heads=2, d_ff=32,
                      vocab_size=32, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    _, caches, _ = model._group_fullseq(
        torch.zeros(1, 2, 16), group_params(params, 0), None,
        positions=torch.arange(2), collect_cache=True, cache_len=5)
    assert {n: tuple(t.shape) for n, t in caches["p0"].items()} == \
        {"k": (1, 5, 2, 8), "v": (1, 5, 2, 8)}
    # the factored WKV6 (the launch plans' mode) builds and runs
    rcfg = ModelConfig(d_model=16, num_heads=2, num_kv_heads=2, d_ff=32,
                       vocab_size=32, dtype="float32",
                       block_pattern=("rwkv6",),
                       rwkv=dataclasses.replace(ModelConfig().rwkv,
                                                head_dim=8))
    rmodel = build_model(rcfg, rwkv_mode="factored")
    assert rmodel.rwkv_mode == "factored"
    rlogits, _ = rmodel.forward(rmodel.init(torch.Generator().manual_seed(0)),
                                torch.tensor([[3, 1, 4, 1, 5]]))
    assert rlogits.shape == (1, 5, rcfg.padded_vocab_size)
    assert torch.isfinite(rlogits[..., :32]).all()
    from repro_torch.models import EncDecLM
    encdec = build_model(ModelConfig(d_model=16, num_heads=2, num_kv_heads=2,
                                     d_ff=32, vocab_size=32, dtype="float32",
                                     encoder_layers=2))
    assert isinstance(encdec, EncDecLM)
    params = encdec.init(torch.Generator().manual_seed(0))
    frames = torch.randn(1, 7, 16, generator=torch.Generator().manual_seed(1))
    toks = torch.tensor([[3, 1, 4, 1, 5]])
    logits, cache = encdec.prefill(params, frames, toks)
    assert logits.shape == (1, 5, 256) and torch.isfinite(logits).all()
    step, cache = encdec.decode_step(params, toks[:, :1], 5, cache)
    assert step.shape == (1, 1, 256) and torch.isfinite(step).all()
    assert cache["self"]["k"].shape == (2, 1, 5, 2, 8)
    assert cache["cross"]["v"].shape == (2, 1, 7, 2, 8)
    with pytest.raises(ValueError, match="unknown block kinds"):
        build_model(ModelConfig(d_model=16, num_heads=2, num_kv_heads=2,
                                block_pattern=("attn", "mamba3")))
    for pattern in (("attn", "mamba2"), ("mamba2", "shared")):
        hybrid = build_model(ModelConfig(
            d_model=16, num_heads=2, num_kv_heads=2, d_ff=32,
            vocab_size=32, dtype="float32", block_pattern=pattern,
            ssm=SSMConfig(state_dim=8, head_dim=8, chunk=4)))
        params = hybrid.init(torch.Generator().manual_seed(0))
        assert ("shared" in params) == ("shared" in pattern)
        toks = torch.tensor([[3, 1, 4, 1, 5]])
        logits, cache = hybrid.prefill(params, toks, cache_len=6)
        step, cache = hybrid.decode_step(params, toks[:, :1], 5, cache)
        assert step.shape == (1, 1, 256) and torch.isfinite(step).all()
        assert cache["p1" if pattern[1] == "shared" else "p0"]["k"].shape \
            == (1, 1, 6, 2, 8)
        assert cache["p0" if pattern[0] == "mamba2" else "p1"]["ssm"].dtype \
            == torch.float32
    # MoE blocks are ported (tests/test_torch_moe.py holds them to JAX)
    moe = build_model(ModelConfig(d_model=16, num_heads=2, num_kv_heads=2,
                                  moe=MoEConfig(num_experts=4, top_k=2)))
    assert moe.moe_dispatch == "onehot"


def test_grid_check_follows_each_kernel_y_axis():
    """The FP32 kernel puts batch * heads on the grid's y (at most
    65,535), the bf16 kernel its 64-row Q tiles; the check runs on CPU
    tensors, with no launch."""
    before = f_ops.KERNEL.launches
    q = torch.zeros((1, 1, 65536, 8), dtype=torch.bfloat16)
    f_ops._check(q, q, q, window=0, q_offset=0)
    q = torch.zeros((1, 1, 65536, 8))
    with pytest.raises(ValueError, match="batch \\* heads"):
        f_ops._check(q, q, q, window=0, q_offset=0)
    f_ops._check(q[:, :, :65535], q[:, :, :65535], q[:, :, :65535],
                 window=0, q_offset=0)
    q = torch.zeros((1, 64 * 65535 + 1, 1, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="query tiles"):
        f_ops._check(q, q, q, window=0, q_offset=0)
    f_ops._check(q[:, :64 * 65535], q[:, :64 * 65535], q[:, :64 * 65535],
                 window=0, q_offset=0)
    assert f_ops.KERNEL.launches == before
