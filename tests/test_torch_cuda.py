"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips without a card. The file imports no JAX, so it runs on
a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels.contrastive import ops as c_ops
from repro_torch.kernels.contrastive import ref as c_ref
from repro_torch.kernels.flash_attention import ops as f_ops
from repro_torch.kernels.flash_attention import ref as f_ref
from repro_torch.kernels.fused_scoring import ops as s_ops
from repro_torch.kernels.fused_scoring import ref as s_ref
from repro_torch.kernels.wkv6 import ops as w_ops
from repro_torch.kernels.wkv6 import ref as w_ref
from repro_torch.models.transformer import kernel_layers
from torch_kernel_inputs import (F32, FLASH, FLASH_BF16_PLAIN,
                                 FUSED_RAGGED_N, FUSED_WIDTHS, LOSS,
                                 _attention_inputs, _contrastive_inputs,
                                 _degenerate, _scoring_inputs, _t,
                                 _t_misaligned, assert_flash_long_close)
from torch_wkv6_inputs import wkv6_inputs, wkv6_sequence


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


# (n, d, h, l, q, docs 4 bytes off 16-byte alignment): the path's shape
# and two small ones at Q in {1, 4, 5}; n cutting the kernel's 64-row
# tile (1, 63, 64, 65, 8191) at the path's widths; every (H, L) pair;
# D = 99 and a misaligned docs view (the 4-byte-copy instantiation); Q=33
FUSED_CASES = [(n, d, h, l, q, False)
               for q in (1, 4, 5)
               for n, d, h, l in ((8192, 4096, 512, 128), (300, 96, 128, 64),
                                  (33, 64, 64, 64))]
FUSED_CASES += [(n, 4096 if n > 1000 else 256, 512, 128, 1, False)
                for n in (1, 63, 64, 65, 8191)]
FUSED_CASES += [(130, 96, h, l, 3, False) for h, l in FUSED_WIDTHS]
FUSED_CASES += [(n, 99, h, l, 2, False) for n in FUSED_RAGGED_N
                for h, l in ((512, 128), (128, 64))]
FUSED_CASES += [(129, 96, 512, 128, 1, True), (65, 99, 128, 64, 3, True),
                (8192, 4096, 512, 128, 1, True), (200, 256, 512, 128, 33,
                                                  False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,h,l,q,misaligned", FUSED_CASES)
def test_fused_kernel_matches_plain(cuda, n, d, h, l, q, misaligned):
    docs, w, zq = _scoring_inputs(n, d, h, l, q)
    args = [(_t_misaligned if misaligned else _t)(docs, cuda)] + \
        [_t(x, cuda) for x in w + [zq]]
    assert (args[0].data_ptr() % 16 != 0) == misaligned
    before = s_ops.KERNEL.launches
    got = s_ops.fused_scores_multi(*args)
    torch.cuda.synchronize()
    assert s_ops.KERNEL.launches == before + 1
    want = s_ref.ref_scores_multi(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **F32)
    one = s_ops.fused_scores(*args[:7], args[7][0])
    np.testing.assert_allclose(one.cpu().numpy(),
                               s_ref.ref_scores(*args[:7], args[7][0])
                               .cpu().numpy(), **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,h,l,q,misaligned",
                         [(8192, 4096, 512, 128, 1, False),
                          (65, 99, 128, 64, 3, True)])
def test_fused_kernel_repeats_bitwise(cuda, n, d, h, l, q, misaligned):
    """Fixed summation orders and no atomics: two calls on the same
    inputs give the same bits, on both copy paths."""
    docs, w, zq = _scoring_inputs(n, d, h, l, q)
    args = [(_t_misaligned if misaligned else _t)(docs, cuda)] + \
        [_t(x, cuda) for x in w + [zq]]
    first = s_ops.fused_scores_multi(*args)
    second = s_ops.fused_scores_multi(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (q, n, p): the training path's shape, the kernel's limits, a small one,
# and n cutting the kernel's 8-row anchor blocks and 256-row tiles raggedly
# (1, 7, 100, 129, 511) at p cutting its 32-column tiles (1, 5, 256)
CONTRASTIVE_SHAPES = [(4, 128, 64), (1, 512, 256), (3, 7, 5)] + [
    (1 if n * p > 65536 else 2, n, p)
    for n in (1, 7, 100, 129, 511) for p in (1, 5, 256)]
# tie needs rows 0-3, tie_far rows 0-17; empty_u is the n=2 batch
CONTRASTIVE_CASES = [
    pytest.param(q, n, p, case, id=f"{case}-{q}-{n}-{p}")
    for q, n, p in CONTRASTIVE_SHAPES
    for case, n_min in (("0.3", 1), ("all_pos", 1), ("all_neg", 1),
                        ("tie", 4), ("tie_far", 18))
    if n >= n_min] + [pytest.param(3, 2, 5, "empty_u", id="empty_u-3-2-5")]


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,p,case", CONTRASTIVE_CASES)
def test_contrastive_kernel_matches_plain(cuda, q, n, p, case):
    frac = float(case) if case[0].isdigit() else 0.5
    zq, zd, y = _degenerate(case, *_contrastive_inputs(n, p, frac, q=q))
    args = [_t(x, cuda) for x in (zq, zd, y)]
    before = c_ops.KERNEL.launches
    got = c_ops.contrastive_losses(*args, 0.07, 0.2)
    torch.cuda.synchronize()
    assert c_ops.KERNEL.launches == before + 1
    assert torch.isfinite(got).all()
    want = c_ref.ref_losses(*args, 0.07, 0.2)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **LOSS)
    if case == "empty_u":
        assert not got[:, 1].any()        # no valid anchor: supcon is 0


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,p", [(4, 128, 64), (1, 512, 256),
                                   (2, 129, 5)])
def test_contrastive_kernel_repeats_bitwise(cuda, q, n, p):
    """Fixed summation orders and no atomics: two calls on the same
    inputs give the same bits."""
    args = [_t(x, cuda) for x in _contrastive_inputs(n, p, 0.3, q=q)]
    first = c_ops.contrastive_losses(*args, 0.07, 0.2)
    second = c_ops.contrastive_losses(*args, 0.07, 0.2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_phase2_function_on_card(cuda):
    zq, zd, y = _contrastive_inputs(128, 64, 0.3, q=4)
    a = [_t(zq, cuda).requires_grad_(), _t(zd, cuda).requires_grad_()]
    val = c_ops.phase2_loss(a[0], a[1], _t(y, cuda), 0.07, 0.2)
    val.sum().backward()
    b = [_t(zq, cuda).requires_grad_(), _t(zd, cuda).requires_grad_()]
    ref = c_ref.ref_phase2(b[0], b[1], _t(y, cuda), 0.07, 0.2)
    ref.sum().backward()
    np.testing.assert_allclose(val.detach().cpu().numpy(),
                               ref.detach().cpu().numpy(), **LOSS)
    assert not a[0].grad.any()
    np.testing.assert_allclose(a[1].grad.cpu().numpy(),
                               b[1].grad.cpu().numpy(), **F32)


@pytest.mark.cuda
def test_contrastive_ref_launches_nothing_on_card(cuda):
    """The JAX package's switches on the card: ``phase2_loss(impl="ref")``,
    ``losses(force_ref=True)`` and a proxy trained with
    ``ProxyConfig(contrastive_impl="ref")`` launch no contrastive kernel
    (``KERNEL.launches`` unchanged) and give the plain values;
    ``impl="kernel"`` and ``"auto"`` launch it once a call."""
    from repro_torch.config import ProxyConfig
    from repro_torch.core import trainer as t_trainer
    zq, zd, y = (_t(x, cuda) for x in _contrastive_inputs(128, 64, 0.3,
                                                          q=4))
    want = c_ref.ref_phase2(zq, zd, y, 0.07, 0.2)
    for impl, launches in (("ref", 0), ("kernel", 1), ("auto", 1)):
        before = c_ops.KERNEL.launches
        got = c_ops.phase2_loss(zq, zd, y, 0.07, 0.2, impl=impl)
        torch.cuda.synchronize()
        assert c_ops.KERNEL.launches - before == launches, impl
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **LOSS)
    before = c_ops.KERNEL.launches
    plain = c_ops.losses(zq, zd, y, 0.07, 0.2, force_ref=True)
    assert c_ops.KERNEL.launches == before
    assert torch.equal(plain, c_ref.ref_losses(zq, zd, y, 0.07, 0.2))
    rng = np.random.default_rng(3)
    embeds = rng.normal(size=(300, 32)).astype(np.float32)
    labels = (rng.random(300) < 0.4).astype(np.int32)
    for impl, per_step in (("ref", 0), ("auto", 1)):
        cfg = ProxyConfig(embed_dim=32, hidden_dim=64, latent_dim=64,
                          proj_dim=16, phase1_steps=3, phase2_steps=4,
                          contrastive_impl=impl)
        before = c_ops.KERNEL.launches
        t_trainer.train_proxy(0, embeds[0], embeds, labels, cfg,
                              device=cuda)
        torch.cuda.synchronize()
        assert c_ops.KERNEL.launches - before == per_step * 4, impl


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["memory", "memmap"])
def test_executor_on_card_matches_cpu(cuda, kind, tmp_path):
    """The pinned-staging, side-stream pipeline on the card gives the
    CPU pipeline's scores, for proxy groups (fused kernel) and raw
    cosine (matmul), over a tail chunk shorter than the rest."""
    from repro_torch.config import ProxyConfig
    from repro_torch.core.encoder import encoder_init, tree_map
    from repro_torch.engine import (InMemoryStore, MemmapStore,
                                    ScoringExecutor)
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(10_000, 256)).astype(np.float32)
    if kind == "memmap":
        np.save(tmp_path / "e.npy", docs)
        store = MemmapStore.from_npy(str(tmp_path / "e.npy"))
    else:
        store = InMemoryStore(docs)
    params = encoder_init(torch.Generator().manual_seed(0),
                          ProxyConfig(embed_dim=256, hidden_dim=128,
                                      latent_dim=64, proj_dim=16))
    e = rng.normal(size=(3, 256)).astype(np.float32)
    outs = []
    for dev in (cuda, "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        ex = ScoringExecutor(chunk=4096, device=dev)
        before = s_ops.KERNEL.launches
        scores, stats = ex.score_multi([(p, e[0]), (None, e[1]),
                                        (p, e[2])], store)
        assert stats.tiles_scored == 3
        assert stats.paths == ("fused", "matmul")
        if dev is cuda:
            assert s_ops.KERNEL.launches == before + 3
        outs.append(scores)
    np.testing.assert_allclose(outs[0], outs[1], **F32)


def _in_threads(n, fn, timeout=300):
    """Run ``fn(i)`` on ``n`` threads released together, under a short
    interpreter switch interval; every thread must finish."""
    start = threading.Barrier(n)
    errors = []

    def run(i):
        try:
            start.wait()
            fn(i)
        except BaseException as exc:  # surfaced below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors


@pytest.mark.cuda
def test_one_executor_scores_from_threads_as_it_does_serially(cuda):
    """Session views share one ScoringExecutor: two threads scoring
    distinct stores through it at once get each store's serial bits
    (each pass owns its pinned staging buffers and copy events)."""
    from repro_torch.config import ProxyConfig
    from repro_torch.core.encoder import encoder_init, tree_map
    from repro_torch.engine import InMemoryStore, ScoringExecutor
    rng = np.random.default_rng(0)
    stores = [InMemoryStore(rng.normal(size=(40_000, 512))
                            .astype(np.float32)) for _ in range(2)]
    params = tree_map(lambda t: t.to(cuda), encoder_init(
        torch.Generator().manual_seed(0), ProxyConfig(embed_dim=512)))
    e = rng.normal(size=512).astype(np.float32)
    ex = ScoringExecutor(chunk=4096, device=cuda)
    serial = [ex.score(params, e, st)[0] for st in stores]
    for _ in range(3):
        out = [None, None]

        def work(i):
            out[i] = ex.score(params, e, stores[i])[0]
        _in_threads(2, work)
        for got, want in zip(out, serial):
            np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_launch_count_is_exact_across_threads(cuda):
    """Every launch gate of chip_smoke.py reads KERNEL.launches after
    the server's worker threads launched: the count must be exact."""
    docs, w, zq = _scoring_inputs(64, 96, 128, 64, 1)
    args = [_t(x, cuda) for x in [docs] + w + [zq]]
    s_ops.fused_scores_multi(*args)
    before = s_ops.KERNEL.launches

    def work(i):
        for _ in range(100):
            s_ops.fused_scores_multi(*args)
    _in_threads(4, work)
    torch.cuda.synchronize()
    assert s_ops.KERNEL.launches == before + 400


# (b, sq, skv, h, kv_heads, hd, causal, window, q_offset): the embedding
# path's shape (llama3-8b's GQA 4:1 and qwen3-moe-30b-a3b's 8:1),
# tests/test_kernels.py's grid and q_offset case, GQA, ragged lengths and
# a head narrower than the kernel's tile
FLASH_CASES = [
    (8, 512, 512, 32, 8, 128, True, 0, 0),
    (8, 512, 512, 32, 4, 128, True, 0, 0),
    (2, 64, 64, 3, 3, 16, True, 0, 0),
    (1, 48, 48, 2, 2, 8, False, 0, 0),
    (2, 128, 128, 4, 4, 32, True, 24, 0),
    (1, 32, 96, 2, 2, 16, True, 0, 64),
    (2, 200, 200, 8, 2, 64, True, 0, 0),
    (1, 200, 200, 4, 1, 128, False, 0, 0),
    (1, 77, 200, 4, 2, 128, True, 24, 123),
]
# the wide kernels (-k hd240): gemma3-12b's head, causal, with a window
# that masks, GQA 2:1, ragged s = 200, non-causal, q_offset; a head
# between 128 and 240 (zero columns of the 240 instantiation) and the 256
# instantiation
FLASH_HD240_CASES = [pytest.param(case, id=f"hd240-{i}")
                     for i, case in enumerate([
    (2, 256, 256, 4, 2, 240, True, 0, 0),
    (2, 256, 256, 4, 2, 240, True, 64, 0),
    (1, 200, 200, 4, 2, 240, True, 0, 0),
    (1, 200, 200, 2, 1, 240, True, 24, 0),
    (1, 200, 200, 4, 2, 240, False, 0, 0),
    (1, 77, 200, 4, 2, 240, True, 24, 123),
    (2, 1, 300, 4, 2, 240, True, 0, 299),
    (1, 130, 130, 2, 2, 136, True, 0, 0),
    (1, 130, 130, 4, 2, 256, True, 40, 0),
])]
# zamba2-2.7b's head of 80 (-k hd80), on the hd-128 instantiations (zero
# columns past 80): MHA 32 over 32 at s 512, a ragged s = 200 with GQA
# 2:1, non-causal, and q_offset with a window
FLASH_HD80_CASES = [pytest.param(case, id=f"hd80-{i}")
                    for i, case in enumerate([
    (2, 512, 512, 32, 32, 80, True, 0, 0),
    (1, 200, 200, 4, 2, 80, True, 0, 0),
    (1, 200, 200, 4, 4, 80, False, 0, 0),
    (1, 77, 200, 4, 2, 80, True, 24, 123),
])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_HD240_CASES
                         + FLASH_HD80_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, skv, h, kv, hd, causal, window, q_offset = case
    q, k, v = (_t(x, cuda).to(dtype)
               for x in _attention_inputs(b, sq, skv, h, kv, hd))
    scale = hd ** -0.5
    before = f_ops.KERNEL.launches
    got = f_ops.flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                    window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert f_ops.KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    g = h // kv
    want = f_ref.ref_attention(q, f_ref.expand_kv(k, g),
                               f_ref.expand_kv(v, g), scale=scale,
                               causal=causal, window=window,
                               q_offset=q_offset)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **FLASH[dtype])


# FLASH_CASES and two edges of the tensor-core kernel: one query row over
# a long prefix (q_offset = skv - 1), and non-causal tiles that do not
# fill the 2-stage K/V ring evenly (3 whole tiles, or 3 and a ragged one)
FLASH_BF16_CASES = FLASH_CASES + [
    (2, 1, 300, 8, 2, 128, True, 0, 299),
    (1, 64, 3 * 64 + 5, 4, 2, 128, False, 0, 0),
    (1, 64, 3 * 64, 4, 4, 64, False, 0, 0),
] + FLASH_HD240_CASES + FLASH_HD80_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BF16_CASES)
def test_flash_bf16_kernel_matches_its_plain_version(cuda, case):
    b, sq, skv, h, kv, hd, causal, window, q_offset = case
    q, k, v = (_t(x, cuda).to(torch.bfloat16)
               for x in _attention_inputs(b, sq, skv, h, kv, hd))
    scale = hd ** -0.5
    before = f_ops.KERNEL.launches
    got = f_ops.flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                    window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert f_ops.KERNEL.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    g = h // kv
    want = f_ref.attention_blocked(
        q, f_ref.expand_kv(k, g), f_ref.expand_kv(v, g), scale,
        causal=causal, window=window, q_offset=q_offset, q_block=64,
        kv_block=f_ops.bf16_tile_keys(hd), round_p=True)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **FLASH_BF16_PLAIN)


@pytest.mark.cuda
def test_flash_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 16, 2, 264), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        f_ops.flash_attention_fwd(q, q, q, scale=1.0)
    q = torch.zeros((1, 16, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        f_ops.flash_attention_fwd(q, q, q, scale=1.0)
    q = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="see none"):
        f_ops.flash_attention_fwd(q, q, q, scale=1.0, window=4, q_offset=40)
    # the tensor-core kernel copies 16-byte rows: bf16 head_dim % 8 == 0
    q = torch.zeros((1, 16, 2, 12), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        f_ops.flash_attention_fwd(q, q, q, scale=1.0)
    q = torch.zeros(1 + 16 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    q = q[1:].view(1, 16, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        f_ops.flash_attention_fwd(q, q, q, scale=1.0)


@pytest.mark.cuda
def test_flash_hd240_repeats_bitwise_and_refuses_wider_heads(cuda):
    """The wide kernel gives the same bits twice; heads past 256 and a
    bf16 head that is not whole 16-byte rows are refused."""
    q, k, v = (_t(x, cuda).to(torch.bfloat16)
               for x in _attention_inputs(1, 128, 128, 4, 2, 240))
    first = f_ops.flash_attention_fwd(q, k, v, scale=240 ** -0.5, window=32)
    second = f_ops.flash_attention_fwd(q, k, v, scale=240 ** -0.5, window=32)
    assert torch.equal(first, second)
    for dtype, hd, match in ((torch.float32, 264, "head_dim"),
                             (torch.bfloat16, 264, "head_dim"),
                             (torch.bfloat16, 244, "multiple of 8")):
        q = torch.zeros((1, 16, 2, hd), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match=match):
            f_ops.flash_attention_fwd(q, q, q, scale=1.0)


@pytest.mark.cuda
def test_embedding_service_runs_the_kernel(cuda):
    """On the card every attention layer of the prefill launches the
    kernel, and the pooled embeddings agree with the plain einsum path."""
    from repro_torch.config import get_smoke_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import EmbeddingService
    cfg = get_smoke_arch("llama3-8b")
    params = build_model(cfg).init(torch.Generator(cuda).manual_seed(0))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 40)).astype(np.int32)
    tokens[1, 25:] = 0
    before = f_ops.KERNEL.launches
    got = EmbeddingService(cfg, params, device=cuda).embed_batch(tokens)
    torch.cuda.synchronize()
    assert f_ops.KERNEL.launches == before + cfg.num_layers
    want = EmbeddingService(cfg, params, device=cuda,
                            attn_impl="einsum").embed_batch(tokens)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **F32)


@pytest.mark.cuda
def test_build_index_on_card_matches_cpu(cuda, tmp_path):
    """The ingest's pinned-staging, side-stream feeder on the card gives
    the CPU run's store, and every layer of every batch launches the
    flash kernel."""
    from repro_torch.config import get_smoke_arch
    from repro_torch.data import make_corpus
    from repro_torch.engine import build_index
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.runtime.serve_loop import EmbeddingService
    cfg = get_smoke_arch("llama3-8b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    corpus = make_corpus(0, n_docs=40, dim=16, with_tokens=True,
                         vocab=cfg.vocab_size, doc_len=30)
    docs = [corpus.tokens[i][:10 + i % 20] for i in range(40)]
    stores = []
    for dev in (cuda, torch.device("cpu")):
        svc = EmbeddingService(cfg, tree_map(lambda t: t.to(dev), params),
                               batch_size=8, device=dev)
        before = f_ops.KERNEL.launches
        res = build_index(svc, docs, tmp_path / dev.type,
                          commit_every_batches=2)
        if dev is cuda:
            assert f_ops.KERNEL.launches == before + \
                cfg.num_layers * res.stats.batches
        stores.append(res.store.get(np.arange(40)))
    np.testing.assert_allclose(stores[0], stores[1], **F32)


# (b, nc, Q, H, K, extreme decay): the rwkv6-7b embedding path's shape
# (b=8, s=512), a ragged chunk (s=200 -> Q=100), K=16, Q=1, and lw = -200
# at tests/test_kernels.py:213's shape and at a full chunk
WKV6_CASES = [
    (8, 4, 128, 64, 64, False),
    (2, 2, 100, 4, 64, False),
    (2, 4, 64, 8, 16, False),
    (1, 37, 1, 4, 64, False),
    (1, 2, 16, 1, 16, True),
    (1, 2, 128, 2, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV6_CASES)
def test_wkv6_kernel_matches_plain(cuda, case):
    """All four outputs against the plain version of the kernel's
    sub-chunk form, to 1e-5 of max |plain| (tests/test_kernels.py's bar
    for the Pallas kernel)."""
    *shape, extreme = case
    args = [_t(x, cuda) for x in wkv6_inputs(*shape, extreme=extreme)]
    before = w_ops.KERNEL.launches
    got = w_ops.wkv6_intra_chunk(*args)
    torch.cuda.synchronize()
    assert w_ops.KERNEL.launches == before + 1
    want = w_ref.wkv6_intra_chunk(*args, sub=w_ref.SUB)
    for name, g, w in zip(("y_intra", "s_inj", "a_end", "r_dec"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        err = ((g - w).abs().max() / (w.abs().max() + 1e-9)).item()
        assert err < 1e-5, (name, err)


@pytest.mark.cuda
def test_wkv6_kernel_matches_the_pairwise_arithmetic(cuda):
    """At the path's shape, all four outputs against ``sub=None``, one
    exponential per term as the Pallas kernel takes them, to the same
    1e-5 of max |plain|."""
    args = [_t(x, cuda) for x in wkv6_inputs(*WKV6_CASES[0][:5])]
    got = w_ops.wkv6_intra_chunk(*args)
    want = w_ref.wkv6_intra_chunk(*args, sub=None)
    torch.cuda.synchronize()
    for name, g, w in zip(("y_intra", "s_inj", "a_end", "r_dec"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        err = ((g - w).abs().max() / (w.abs().max() + 1e-9)).item()
        assert err < 1e-5, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,k,chunk", [(2, 64, 2, 16, 16),
                                           (1, 96, 4, 32, 32),
                                           (2, 40, 2, 16, 16)])
def test_wkv6_matches_sequential_on_card(cuda, b, s, h, k, chunk):
    """tests/test_kernels.py's shapes: the kernel, then the combine."""
    r, kk, v, lw, u = (_t(x, cuda) for x in wkv6_sequence(b, s, h, k))
    before = w_ops.KERNEL.launches
    got = w_ops.wkv6(r, kk, v, lw, u, chunk=chunk)
    torch.cuda.synchronize()
    assert w_ops.KERNEL.launches == before + 1
    want = w_ref.ref_wkv6(r, kk, v, lw, u)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err < 1e-5, err


@pytest.mark.cuda
def test_wkv6_refuses_what_it_does_not_take(cuda):
    def args(shape=(1, 2, 16, 2, 16), dtype=torch.float32):
        x = torch.zeros(shape, dtype=dtype, device=cuda)
        return [x, x, x, x, x, torch.zeros(shape[3:], dtype=dtype,
                                           device=cuda)]
    before = w_ops.KERNEL.launches
    with pytest.raises(ValueError, match="head_dim"):
        w_ops.wkv6_intra_chunk(*args((1, 1, 16, 1, 80)))
    with pytest.raises(ValueError, match="chunk length"):
        w_ops.wkv6_intra_chunk(*args((1, 1, 129, 1, 16)))
    with pytest.raises(TypeError):
        w_ops.wkv6_intra_chunk(*args(dtype=torch.bfloat16))
    a = args()
    a[0] = torch.zeros((1, 2, 16, 16, 2), device=cuda).transpose(3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        w_ops.wkv6_intra_chunk(*a)
    assert w_ops.KERNEL.launches == before


@pytest.mark.cuda
def test_rwkv_embedding_service_runs_the_kernel(cuda):
    """On the card every RWKV6 layer of the prefill launches the WKV6
    kernel once, and the pooled embeddings agree with the plain direct
    scan's."""
    from repro_torch.config import get_smoke_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import EmbeddingService
    cfg = get_smoke_arch("rwkv6-7b")
    params = build_model(cfg).init(torch.Generator(cuda).manual_seed(0))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 200)).astype(np.int32)
    tokens[1, 25:] = 0
    before = w_ops.KERNEL.launches
    got = EmbeddingService(cfg, params, device=cuda).embed_batch(tokens)
    torch.cuda.synchronize()
    assert w_ops.KERNEL.launches == before + cfg.num_layers
    want = EmbeddingService(cfg, params, device=cuda,
                            rwkv_mode="direct").embed_batch(tokens)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **F32)


@pytest.mark.cuda
def test_compound_filter_on_card_is_the_kleene_of_single_leaves(cuda):
    """p1 & ~p2 on the card: both leaves train in one padded run (the
    contrastive kernel launched phase2_steps times for the plan), and the
    mask is bitwise the Kleene combination of each leaf filtered alone
    (each trained beside three dummy lanes) on another engine."""
    from repro_torch.config import CascadeConfig, ProxyConfig
    from repro_torch.data import make_corpus, make_query
    from repro_torch.engine import (InMemoryStore, ScaleDocEngine,
                                    SemanticPredicate, SimulatedOracle)
    corpus = make_corpus(0, n_docs=4096, dim=256)
    qs = [make_query(corpus, 100 + j, selectivity=s)
          for j, s in enumerate((0.1, 0.2))]
    pcfg = ProxyConfig(phase1_steps=20, phase2_steps=20)

    def engine():
        return ScaleDocEngine(InMemoryStore(corpus.embeds), pcfg,
                              CascadeConfig(accuracy_target=0.9),
                              device=cuda)

    def leaves():
        return [SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                                  name=f"p{j + 1}")
                for j, q in enumerate(qs)]

    p = leaves()
    before = c_ops.KERNEL.launches
    res = engine().filter(p[0] & ~p[1], seed=0)
    torch.cuda.synchronize()
    assert c_ops.KERNEL.launches == before + pcfg.phase2_steps
    assert len(res.leaf_reports) == 2 and res.provenance.complete()
    alone = engine()
    m1, m2 = (alone.filter(lf, seed=0).mask for lf in leaves())
    np.testing.assert_array_equal(res.mask, m1 & ~m2)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [False, True])
def test_live_delta_scores_are_row_local_on_card(cuda, pad):
    """``_score_rows`` over ragged ranges at odd offsets, through the
    fused kernel with and without the pad to the executor's chunk, gives
    bitwise the scores of one pass over all the rows (the live plane's
    row-local contract; the card's rule keeps no pad)."""
    from repro_torch.config import ProxyConfig
    from repro_torch.core.encoder import encoder_init, tree_map
    from repro_torch.engine import InMemoryStore, ScoringExecutor
    from repro_torch.engine.live import _score_rows
    rng = np.random.default_rng(0)
    docs = (rng.normal(size=(4096, 256)) / 16).astype(np.float32)
    params = tree_map(lambda p: p.to(cuda), encoder_init(
        torch.Generator().manual_seed(0), ProxyConfig(embed_dim=256)))
    e_q = docs[7]
    store = InMemoryStore(docs)
    executor = ScoringExecutor(chunk=1024, device=cuda)
    full, _ = _score_rows(executor, params, e_q, store, 0, 4096, pad=False)
    before = s_ops.KERNEL.launches
    for lo, m in ((129, 1), (131, 2), (133, 3), (171, 7), (195, 37),
                  (271, 150), (1023, 1025), (2047, 2049)):
        got, stats = _score_rows(executor, params, e_q, store, lo, lo + m,
                                 pad=pad)
        np.testing.assert_array_equal(got, full[lo:lo + m])
        assert stats.paths == ("fused",)
    assert s_ops.KERNEL.launches > before


@pytest.mark.cuda
def test_live_pumps_on_card_equal_standing_filter(cuda, tmp_path):
    """Ragged commit groups pumped on the card: decisions bitwise a
    one-shot standing_filter at the same calibration watermark, the fused
    kernel launched once a tile a scorable leaf."""
    from repro_torch.config import CascadeConfig, ProxyConfig
    from repro_torch.data import make_corpus, make_query
    from repro_torch.engine import (DriftConfig, LiveEngine, MemmapStore,
                                    SemanticPredicate, SimulatedOracle,
                                    StoreWriter, standing_filter)
    corpus = make_corpus(0, n_docs=4096, dim=256)
    q1, q2 = (make_query(corpus, 100 + j, selectivity=s)
              for j, s in enumerate((0.1, 0.2)))
    pcfg = ProxyConfig(phase1_steps=20, phase2_steps=20)
    ccfg = CascadeConfig(accuracy_target=0.9)

    def pred():
        return (SemanticPredicate(q1.embed, SimulatedOracle(q1.truth),
                                  name="p1")
                & ~SemanticPredicate(q2.embed, SimulatedOracle(q2.truth),
                                     name="p2"))

    w = StoreWriter.open(tmp_path, dim=256, fingerprint={"model": "card"})
    w.append(corpus.embeds[:2048])
    w.commit()
    live = LiveEngine(MemmapStore.open(tmp_path), pcfg, ccfg,
                      drift=DriftConfig(auto=False), chunk=1024,
                      device=cuda)
    sp = live.register(pred(), seed=0)
    n_scorable = sum(ls.scorable for ls in sp._leaves)
    hi = 2048
    for size in (1, 3, 37, 1023, 984):        # to the end of the corpus
        w.append(corpus.embeds[hi:hi + size])
        w.commit()
        hi += size
        before = s_ops.KERNEL.launches
        live.pump()
        assert s_ops.KERNEL.launches - before == \
            n_scorable * -(-size // 1024)
    w.close()
    ref = standing_filter(MemmapStore.open(tmp_path), pred(), seed=0,
                          calib_rows=2048, proxy_cfg=pcfg, cascade_cfg=ccfg,
                          chunk=1024, device=cuda)
    np.testing.assert_array_equal(sp.decisions, ref.decisions)
    live.close()


# -- the LLM judge and the decode path (-k "judge or decode") -------------

# decode against the teacher-forced forward: the JAX package's own bar
# (tests/test_models_consistency.py), of max |logit|
DECODE_REL = 5e-4


def _full_width(arch, dev):
    """The full-width config in f32, drawn on ``dev``: at 2 layers, or
    for a model with sliding-window layers at one pattern period with the
    window cut to 16, so that a short context crosses it, or for a longer
    pattern (zamba2-2.7b's 5 mamba2 layers and a shared one) at one
    pattern period."""
    import dataclasses
    from repro_torch.config import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    resolve_device(dev)                      # TF32 off
    cfg = get_arch(arch)
    cut = (dict(num_layers=len(cfg.block_pattern), sliding_window=16)
           if cfg.sliding_window else
           dict(num_layers=max(2, len(cfg.block_pattern))))
    cfg = dataclasses.replace(cfg, dtype="float32", **cut)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator(dev).manual_seed(0))


# the configs added with gemma3-12b (-k configs), and zamba2-2.7b
CONFIGS = [pytest.param(a, id=f"configs-{a}")
           for a in ("gemma3-12b", "codeqwen1.5-7b", "internvl2-1b")]
CONFIGS += [pytest.param("zamba2-2.7b", id="zamba2")]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b"] + CONFIGS)
def test_decode_matches_forward_on_card(cuda, arch):
    """Full width in f32 (``_full_width``): 4 decode steps after a
    12-token prefill through the kernels (6 after 18 tokens, past the
    window of 16, with sliding-window layers), each step's logits against
    the kernel path's teacher-forced forward."""
    cfg, model, params = _full_width(arch, cuda)
    kernel = w_ops.KERNEL if arch == "rwkv6-7b" else f_ops.KERNEL
    pre, total = (18, 24) if cfg.sliding_window else (12, 16)
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, total)), device=cuda)
    full, _ = model.forward(params, toks)
    before = kernel.launches
    _, cache = model.prefill(params, toks[:, :pre], cache_len=total)
    torch.cuda.synchronize()
    assert kernel.launches == before + kernel_layers(cfg)
    for t in range(pre, total):
        step, cache = model.decode_step(params, toks[:, t:t + 1], t, cache)
        err = ((step[:, 0] - full[:, t]).abs().max()
               / full[:, t].abs().max()).item()
        assert err < DECODE_REL, (arch, t, err)
    assert kernel.launches == before + kernel_layers(cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b"] + CONFIGS)
def test_decode_generate_on_card_equals_the_hand_rolled_loop(cuda, arch):
    from repro_torch.config import get_smoke_arch
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import generate
    cfg = get_smoke_arch(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(0))
    prompt = np.random.default_rng(2).integers(
        1, cfg.vocab_size, size=(3, 40)).astype(np.int32)
    steps = 8
    out = generate(model, params, prompt, steps)
    logits, cache = model.prefill(params, prompt, cache_len=40 + steps)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    manual = [tok]
    for t in range(1, steps):
        logits, cache = model.decode_step(params, tok, 40 + t - 1, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        manual.append(tok)
    np.testing.assert_array_equal(out, torch.cat(manual, 1).cpu().numpy())


def _judges(cuda, n_docs=128):
    from repro_torch.core import LMOracle
    from repro_torch.models import build_model
    cfg, model, params = _full_width("llama3-8b", cuda)
    rng = np.random.default_rng(3)
    docs = rng.integers(3, cfg.vocab_size, size=(n_docs, 80))
    query = rng.integers(3, cfg.vocab_size, size=16)
    plain = build_model(cfg, attn_impl="einsum")
    return (cfg, LMOracle(model, params, query, docs),
            LMOracle(plain, params, query, docs))


@pytest.mark.cuda
def test_judge_kernel_path_matches_plain(cuda):
    """llama3-8b at full width, 2 layers, f32: the judge's last-position
    logits through the flash kernel against the plain einsum path on the
    same prompts; per-row cosine >= 0.99999 and >= 98% of decisions the
    same (the rest within f32 rounding of a zero margin)."""
    from repro_torch.core.oracle import JUDGE_BATCH
    cfg, kernel, plain = _judges(cuda)
    idx = np.arange(128)
    before = f_ops.KERNEL.launches
    got = kernel.last_logits(idx)
    torch.cuda.synchronize()
    assert f_ops.KERNEL.launches == before + cfg.num_layers * (
        -(-128 // JUDGE_BATCH))
    want = plain.last_logits(idx)
    assert f_ops.KERNEL.launches == before + cfg.num_layers * 2
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert cos.min().item() >= 0.99999
    agree = (kernel.label(idx) == plain.label(idx)).mean()
    assert agree >= 0.98


@pytest.mark.cuda
def test_judge_label_is_a_function_of_the_prompt_on_card(cuda):
    """Alone, inside a larger ask and in reversed order: the same bits."""
    _, judge, _ = _judges(cuda, n_docs=150)
    idx = np.arange(150)
    logits = judge.last_logits(idx)
    assert torch.equal(judge.last_logits(idx[::-1]), logits.flip(0))
    for i in (0, 63, 64, 149):
        assert torch.equal(judge.last_logits([i])[0], logits[i])


# -- MoE (-k moe): routing, capacity drops and both dispatches on the card.
# It has no kernel of its own (einsums, batched products and gathers);
# these hold the card's arithmetic to the CPU's and the sort form's
# combine (a gather summed in k order, not an atomic scatter-add) to
# bitwise repeats.

def _moe_case(arch, shape=(2, 24)):
    from repro_torch.config import get_smoke_arch
    from repro_torch.models import moe
    cfg = get_smoke_arch(arch)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg,
                          torch.float32)
    # tokens around one shared direction crowd onto the same experts, so
    # the configs' capacity factor of 1.25 drops pairs
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape + (cfg.d_model,)) * 0.5
         + 2.0 * rng.normal(size=cfg.d_model)).astype(np.float32)
    return cfg, params, torch.tensor(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
@pytest.mark.parametrize("shape", [(2, 24), (2, 1024)],
                         ids=["one_chunk", "two_chunks"])
def test_moe_apply_on_card_matches_cpu(cuda, arch, dispatch, shape):
    from repro_torch.models import moe
    cfg, params, x = _moe_case(arch, shape)
    want, want_aux = moe.moe_apply(params, x, cfg, dispatch)
    on_card = {k: v.to(cuda) for k, v in params.items()}
    got, aux = moe.moe_apply(on_card, x.to(cuda), cfg, dispatch)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **F32)
    assert abs(aux.item() - want_aux.item()) < 1e-6
    kept = moe.kept_pairs(on_card, x.to(cuda), cfg, dispatch)
    assert torch.equal(kept.cpu(), moe.kept_pairs(params, x, cfg, dispatch))
    assert not kept.all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_sort_dispatch_repeats_bitwise_on_card(cuda, dtype):
    from repro_torch.models import moe
    cfg, params, x = _moe_case("qwen3-moe-30b-a3b", (2, 1024))
    on_card = {k: (v if k == "router" else v.to(dtype)).to(cuda)
               for k, v in params.items()}
    x = x.to(cuda, dtype)
    first, aux = moe.moe_apply(on_card, x, cfg, "sort")
    for _ in range(3):
        again, aux2 = moe.moe_apply(on_card, x, cfg, "sort")
        assert torch.equal(again, first) and torch.equal(aux2, aux)


# -- zamba2-2.7b: Mamba2 blocks and the shared attention block (-k zamba2)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [17, 40])
def test_zamba2_smoke_forward_on_card_matches_cpu(cuda, s):
    """The SMOKE model (f32) on the card, its shared layer through the
    flash kernel, against the same params on the CPU (the flash wrapper's
    plain version there): logits within the flash kernel's f32 bar of max
    |logit|, 17 tokens at chunk 1 and 40 at chunk 8; the flash kernel
    launched once a shared layer."""
    from repro_torch.config import get_smoke_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    resolve_device(cuda)                     # TF32 off
    cfg = get_smoke_arch("zamba2-2.7b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = np.random.default_rng(4).integers(
        1, cfg.vocab_size, size=(3, s)).astype(np.int32)
    want, _ = model.forward(params, toks)
    before = f_ops.KERNEL.launches
    got, _ = model.forward(on_card, toks)
    torch.cuda.synchronize()
    assert f_ops.KERNEL.launches == before + kernel_layers(cfg) == \
        before + 1
    err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    assert err < FLASH[torch.float32]["rtol"], err


# -- whisper-base: the encoder-decoder family (-k whisper) --------------------

# head_dim 64, non-causal with sq != skv: a cross-attention's 70 queries
# over 1500 keys (23 whole 64-key tiles and a partial one of 28), the
# encoder's 1500 over 1500, and GQA 2:1 over a ragged 130 x 1500
WHISPER_FLASH_CASES = [pytest.param(case, id=f"whisper-{i}")
                       for i, case in enumerate([
    (2, 70, 1500, 8, 8, 64, False, 0, 0),
    (1, 1500, 1500, 8, 8, 64, False, 0, 0),
    (1, 130, 1500, 4, 2, 64, False, 0, 0),
])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WHISPER_FLASH_CASES)
def test_flash_whisper_shapes_match_plain(cuda, case, dtype):
    """Against the einsum oracle (f32 and bf16) and, in bf16, against the
    tensor-core kernel's plain version on its 64-row, 64-key tiles."""
    b, sq, skv, h, kv, hd, causal, window, q_offset = case
    q, k, v = (_t(x, cuda).to(dtype)
               for x in _attention_inputs(b, sq, skv, h, kv, hd))
    scale = hd ** -0.5
    before = f_ops.KERNEL.launches
    got = f_ops.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert f_ops.KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    g = h // kv
    kf, vf = f_ref.expand_kv(k, g), f_ref.expand_kv(v, g)
    want = f_ref.ref_attention(q, kf, vf, scale=scale, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **FLASH[dtype])
    if dtype == torch.bfloat16:
        plain = f_ref.attention_blocked(
            q, kf, vf, scale, causal=causal, q_block=64,
            kv_block=f_ops.bf16_tile_keys(hd), round_p=True)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   plain.float().cpu().numpy(),
                                   **FLASH_BF16_PLAIN)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["flash", "blocked"])
def test_whisper_smoke_on_card_matches_cpu(cuda, impl):
    """whisper-base SMOKE (f32, head_dim 12: the FP32 kernel) on the card
    against the same params on the CPU (the flash wrapper's plain version
    there): the forward's logits, a prefill and a decode step after the
    self cache is padded by hand, within the flash kernel's f32 bar of
    max |logit|. Flash launches 3 a layer pair on the kernel path
    (encoder, self, cross) and 1 (the cross-attention) on the blocked
    path; the decode step launches none."""
    from repro_torch.config import get_smoke_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import EncDecLM
    from repro_torch.models.common import tree_map
    resolve_device(cuda)                     # TF32 off
    cfg = get_smoke_arch("whisper-base")
    model = EncDecLM(cfg, attn_impl=impl)
    params = model.init(torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(5)
    frames = rng.normal(size=(3, 70, cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size, size=(3, 17)).astype(np.int32)
    per_layer = 3 if impl == "flash" else 1
    want, _ = model.forward(params, frames, toks)
    before = f_ops.KERNEL.launches
    got, _ = model.forward(on_card, frames, toks)
    torch.cuda.synchronize()
    assert f_ops.KERNEL.launches == before + per_layer * cfg.num_layers
    bar = FLASH[torch.float32]["rtol"]
    assert ((got.cpu() - want).abs().max() / want.abs().max()).item() < bar

    def padded(cache):
        grow = lambda c: torch.cat([c, torch.zeros_like(c[:, :, :4])], 2)
        return {"self": tree_map(grow, cache["self"]),
                "cross": cache["cross"]}
    steps = {}
    for name, p in (("cpu", params), ("card", on_card)):
        _, cache = model.prefill(p, frames, toks[:, :16])
        before = f_ops.KERNEL.launches
        steps[name], _ = model.decode_step(p, toks[:, 16:], 16,
                                           padded(cache))
        torch.cuda.synchronize()
        assert f_ops.KERNEL.launches == before
    ref = steps["cpu"]
    assert ((steps["card"].cpu() - ref).abs().max()
            / ref.abs().max()).item() < bar
    # the step against the forward at that position, on the card
    err = ((steps["card"][:, 0] - got[:, 16]).abs().max()
           / got[:, 16].abs().max()).item()
    assert err < DECODE_REL, err


# -- training: the flash kernel's log-sum-exp, gradients on the card -----------

# the LSE against its plain version's: the kernels' m and l are those of
# the plain online softmax; the bf16 kernel keeps m in base 2 and sums
# ex2.approx values (~2 f32 ulps each), so lse = m ln 2 + log l differs
# from the plain f32 exp's by ~1e-6 at scores of a few units
LSE_TOL = dict(rtol=1e-5, atol=1e-4)
# (b, sq, skv, h, kv, hd, causal, window, q_offset) at heads 64
# (smollm-360m's 15 over 5), 80 (zamba2-2.7b, on the hd-128
# instantiations), 128 and 240: causal, windowed, non-causal, q_offset,
# ragged
FLASH_LSE_CASES = [pytest.param(c, id=f"lse-hd{c[5]}-{i}")
                   for i, c in enumerate([
    (2, 256, 256, 15, 5, 64, True, 0, 0),
    (1, 200, 200, 4, 2, 64, True, 24, 0),
    (1, 77, 200, 4, 2, 64, False, 0, 0),
    (2, 130, 130, 4, 4, 80, True, 0, 0),
    (1, 77, 200, 4, 2, 128, True, 24, 123),
    (2, 256, 256, 4, 2, 128, True, 0, 0),
    (2, 256, 256, 4, 2, 240, True, 64, 0),
    (1, 200, 200, 4, 2, 240, False, 0, 0),
])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_LSE_CASES)
def test_flash_lse_matches_plain_and_leaves_out_bitwise(cuda, case, dtype):
    """Each instantiation's LSE form: lse (b, h, sq) float32 against the
    plain version's on the kernel's own tiles, and out bitwise the form
    without it."""
    b, sq, skv, h, kv, hd, causal, window, q_offset = case
    q, k, v = (_t(x, cuda).to(dtype)
               for x in _attention_inputs(b, sq, skv, h, kv, hd))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              q_offset=q_offset)
    before = f_ops.KERNEL.launches
    out = f_ops.flash_attention_fwd(q, k, v, **kw)
    out_lse, lse = f_ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert f_ops.KERNEL.launches == before + 2
    assert torch.equal(out, out_lse)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    g = h // kv
    bf16 = dtype == torch.bfloat16
    _, want = f_ref.attention_blocked(
        q, f_ref.expand_kv(k, g), f_ref.expand_kv(v, g), kw["scale"],
        causal=causal, window=window, q_offset=q_offset, q_block=64,
        kv_block=f_ops.bf16_tile_keys(hd) if bf16 else 64, round_p=bf16,
        return_lse=True)
    np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(),
                               **LSE_TOL)


# (b, sq, skv, h, kv, hd, causal, window): smollm-360m's heads, a window,
# a cross-attention (sq != skv, non-causal); blocks of 32 so that every
# case runs several tiles
FLASH_GRAD_CARD_CASES = [
    (2, 100, 100, 15, 5, 64, True, 0),
    (1, 96, 96, 4, 2, 64, True, 24),
    (2, 40, 75, 4, 4, 32, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_GRAD_CARD_CASES)
def test_flash_autograd_on_card_matches_cpu(cuda, case):
    """``models.attention.flash_attention`` with a gradient: on the card
    one kernel launch (its LSE form) and the plain backward there,
    against the plain forward and backward on the CPU. float32 (the FP32
    kernel): out and (dq, dk, dv) within 1e-4 of max |CPU value|; bf16
    (the tensor-core kernel) against the CPU's float32 on the same
    bf16-rounded inputs: cosine >= 0.999 each."""
    from repro_torch.models import attention as t_attn
    b, sq, skv, h, kv, hd, causal, window = case
    base = _attention_inputs(b, sq, skv, h, kv, hd)
    dout = np.random.default_rng(3).normal(size=(b, sq, h, hd)).astype(
        np.float32)
    opts = dict(causal=causal, window=window, q_block=32, kv_block=32)

    def run(dev, dtype):
        qkv = [torch.tensor(x, device=dev).to(dtype).requires_grad_()
               for x in base]
        out = t_attn.flash_attention(*qkv, hd ** -0.5, **opts)
        out.backward(torch.tensor(dout, device=dev).to(dtype))
        return [t.detach().float().cpu() for t in [out] + [x.grad
                                                          for x in qkv]]

    want = run("cpu", torch.float32)
    before = f_ops.KERNEL.launches
    got = run(cuda, torch.float32)
    assert f_ops.KERNEL.launches == before + 1
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        err = ((g - w).abs().max() / w.abs().max()).item()
        assert err < 1e-4, (name, err)
    want = [t.float() for t in run("cpu", torch.bfloat16)]
    got = run(cuda, torch.bfloat16)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        cos = torch.nn.functional.cosine_similarity(
            g.flatten(), w.flatten(), dim=0).item()
        assert cos >= 0.999, (name, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-12b",
                                  "qwen3-moe-30b-a3b", "zamba2-2.7b",
                                  "whisper-base"])
def test_loss_gradient_on_card_matches_cpu(cuda, arch):
    """One SMOKE ``loss_fn`` and every leaf's gradient on the card (the
    flash kernel's LSE form forward, the plain backward) against the same
    params and batch on the CPU: loss within 1e-5 relative, each leaf
    within 1e-4 of its max |CPU gradient|."""
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.config import get_smoke_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.runtime.train_loop import grad_tree
    resolve_device(cuda)                     # TF32 off
    cfg = get_smoke_arch(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(2, 40, cfg.d_model)).astype(
            np.float32)

    def run(dev):
        live = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        loss = model.loss_fn(live, {k: torch.as_tensor(v, device=dev)
                                    for k, v in batch.items()})
        return loss.item(), dict(flatten_with_paths(tree_map(
            lambda g: g.cpu(), grad_tree(loss, live))))

    want_loss, want = run("cpu")
    before = f_ops.KERNEL.launches
    got_loss, got = run(cuda)
    assert f_ops.KERNEL.launches > before
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    for path, w in want.items():
        err = ((got[path] - w).abs().max() / (w.abs().max() + 1e-30)).item()
        assert err < 1e-4, (path, err)


@pytest.mark.cuda
def test_rwkv_does_not_train_on_the_card(cuda, tmp_path):
    """The WKV6 kernel has no backward: a CUDA input that requires grad
    raises. The Trainer builds RWKV6 in the time-mix's "direct" mode
    instead, as the JAX package does, and launches no WKV6 kernel
    (``test_rwkv_trainer_step_on_card_matches_cpu``)."""
    from repro_torch.config import TrainConfig, get_smoke_arch
    from repro_torch.runtime.train_loop import Trainer
    r, k, v, cum, lw, u = (torch.tensor(x, device=cuda)
                           for x in wkv6_inputs(1, 2, 16, 2, 16))
    with pytest.raises(NotImplementedError, match="WKV6 backward"):
        w_ops.wkv6_intra_chunk(r.requires_grad_(), k, v, cum, lw, u)
    with torch.no_grad():
        w_ops.wkv6_intra_chunk(r, k, v, cum, lw, u)
    with Trainer(get_smoke_arch("rwkv6-7b"),
                 TrainConfig(checkpoint_dir=str(tmp_path)),
                 device=cuda) as tr:
        assert tr.model.rwkv_mode == "direct"


@pytest.mark.cuda
def test_rwkv_trainer_step_on_card_matches_cpu(cuda, tmp_path):
    """One SMOKE rwkv6-7b Trainer step (direct mode, float32) on the card
    against the CPU from the same params and batch: the loss rtol 1e-5,
    each gradient leaf 1e-4 of its max |g|, params as ``_same_step``."""
    import dataclasses
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.config import (InputShape, OptimizerConfig,
                                    TrainConfig, get_smoke_arch)
    from repro_torch.data.loader import device_batch
    from repro_torch.device import resolve_device
    from repro_torch.models.common import tree_map
    from repro_torch.optimizer import adamw
    from repro_torch.runtime.train_loop import Trainer
    resolve_device(cuda)                     # TF32 off
    cfg = dataclasses.replace(get_smoke_arch("rwkv6-7b"), dtype="float32")
    opt = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                          schedule="constant", grad_clip=0.0,
                          weight_decay=0.0)
    tc = TrainConfig(shape=InputShape("t", 32, 4, "train"), optimizer=opt,
                     checkpoint_dir=str(tmp_path))
    steps = {}
    with Trainer(cfg, tc, device="cpu") as cpu:
        params = cpu.init_state()[0]
        host_batch = cpu.loader.batch(0)
    for dev in ("cpu", cuda):
        with Trainer(cfg, tc, device=dev) as tr:
            p = tree_map(lambda t: t.to(dev), params)
            before = w_ops.KERNEL.launches
            (new, state, _), metrics = tr._step(
                (p, adamw.init(opt, p), {}),
                device_batch(host_batch, device=dev))
            assert w_ops.KERNEL.launches == before
            steps[str(dev)] = (
                metrics["loss"].item(),
                {k: t.cpu() for k, t in flatten_with_paths(new)},
                {k: (t / (1 - opt.b1)).cpu()
                 for k, t in flatten_with_paths(state.mu)}, opt.lr)
    _same_step(steps[str(cuda)], steps["cpu"])


# the launch layer's prefill cell (llama3-8b PREFILL_32K at batch 1): one
# flash call over 32,768 causal keys, held to the plain version on the
# kernel's own tiles for three 64-row query blocks (first, middle, last),
# each against the keys it sees (q_offset), and every row to the plain
# version's pass on 512-row, 512-key blocks (the kernel-tile pass at this
# length would be 512 x 512 tile steps), at the long-row bar
LONG_FLASH_SHAPE = (1, 32768, 32, 8, 128)    # b, s, heads, KV heads, hd


@pytest.mark.cuda
def test_flash_at_32k_keys_matches_its_plain_version(cuda):
    b, s, h, kv, hd = LONG_FLASH_SHAPE
    gen = torch.Generator(cuda).manual_seed(32)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, kv, hd), generator=gen, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    scale = hd ** -0.5
    before = f_ops.KERNEL.launches
    got = f_ops.flash_attention_fwd(q, k, v, scale=scale, causal=True)
    torch.cuda.synchronize()
    assert f_ops.KERNEL.launches == before + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    for start in (0, s // 2, s - 64):
        end = start + 64
        want = f_ref.attention_blocked(
            q[:, start:end], f_ref.expand_kv(k[:, :end], h // kv),
            f_ref.expand_kv(v[:, :end], h // kv), scale, causal=True,
            q_offset=start, q_block=64, kv_block=f_ops.bf16_tile_keys(hd),
            round_p=True)
        assert_flash_long_close(got[:, start:end], want)
    assert_flash_long_close(got, f_ref.attention_blocked(
        q, f_ref.expand_kv(k, h // kv), f_ref.expand_kv(v, h // kv), scale,
        causal=True, round_p=True))


# Adam's first step moves a param by lr * g / (|g| + eps), so where |g|
# is near eps two roundings of g give params up to lr apart; where |g| >=
# 1e-5 the step's slope is <= 1 (tests/test_torch_launch_train.py)
ADAM_COND = 1e-5


def _train_plan_step(arch, dev, microbatches):
    """One SMOKE train-plan step in float32 on ``dev`` from seed-0 params
    and a seeded batch: (loss, params, the gradient from AdamW's mu)."""
    import dataclasses
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.config import (InputShape, OptimizerConfig,
                                    get_smoke_arch)
    from repro_torch.launch import mesh, steps
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.optimizer import adamw
    cfg = dataclasses.replace(get_smoke_arch(arch), dtype="float32")
    opt = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                          schedule="constant", grad_clip=0.0,
                          weight_decay=0.0)
    plan = steps.make_train_plan(
        cfg, InputShape("t", seq_len=32, global_batch=4, kind="train"),
        mesh.make_test_mesh(1, 1, device=dev), opt_cfg=opt,
        microbatches=microbatches)
    params = tree_map(lambda t: t.to(dev), build_model(cfg).init(
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(7)
    batch = {n: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
             for n in ("tokens", "labels")}
    (new, state), metrics = plan.step_fn((params, adamw.init(opt, params)),
                                         batch)
    grads = {p: (t / (1 - opt.b1)).cpu()
             for p, t in flatten_with_paths(state.mu)}
    return (metrics["loss"].item(),
            {p: t.cpu() for p, t in flatten_with_paths(new)}, grads,
            opt.lr)


def _same_step(a, b):
    """Loss rtol 1e-5, each gradient leaf within 1e-4 of its max |g|,
    params within lr everywhere and rtol = atol = 2e-4 where |g| >=
    ADAM_COND."""
    (la, pa, ga, lr), (lb, pb, gb, _) = a, b
    assert abs(la - lb) <= 1e-5 * abs(lb)
    for path, g in gb.items():
        assert (ga[path] - g).abs().max() <= 1e-4 * g.abs().max(), path
        assert (pa[path] - pb[path]).abs().max() <= lr * (1 + 1e-3), path
        cond = g.abs() >= ADAM_COND
        np.testing.assert_allclose(pa[path][cond].numpy(),
                                   pb[path][cond].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=path)


@pytest.mark.cuda
def test_rwkv_train_plan_on_card_matches_cpu(cuda):
    """The plan's factored WKV6 trains on the card (plain PyTorch through
    autograd, no kernel): one rwkv6-7b SMOKE step against the CPU's."""
    from repro_torch.device import resolve_device
    resolve_device(cuda)                     # TF32 off
    before = w_ops.KERNEL.launches
    on_card = _train_plan_step("rwkv6-7b", cuda, 2)
    assert w_ops.KERNEL.launches == before
    _same_step(on_card, _train_plan_step("rwkv6-7b", "cpu", 2))


@pytest.mark.cuda
def test_microbatches_agree_on_card(cuda):
    """smollm-360m SMOKE on the card: microbatches 1 and 2 give the same
    step, and the flash kernel runs both."""
    from repro_torch.device import resolve_device
    resolve_device(cuda)
    before = f_ops.KERNEL.launches
    one = _train_plan_step("smollm-360m", cuda, 1)
    mid = f_ops.KERNEL.launches
    two = _train_plan_step("smollm-360m", cuda, 2)
    assert mid > before and f_ops.KERNEL.launches - mid == 2 * (mid - before)
    _same_step(two, one)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-7b",
                                  "qwen3-moe-30b-a3b", "zamba2-2.7b"])
def test_cost_counter_counts_the_card_as_meta(cuda, arch):
    """A SMOKE train-plan step (2 microbatches) counts the same operators,
    FLOPs, bytes and transcendentals on the card as on meta tensors:
    the traced program is the card's. The flash kernel is one operator
    on both."""
    from repro_torch.config import get_smoke_arch
    _counts_equal_on_meta_and_card(cuda, get_smoke_arch(arch))


@pytest.mark.cuda
def test_cost_counter_counts_a_remat_backward_on_the_card(cuda):
    """With remat "full" the backward recomputes each block's forward,
    flash calls included, on the autograd engine's thread for the card:
    the counter still sees every flash call there as one operator."""
    import dataclasses
    from repro_torch.config import get_smoke_arch
    _counts_equal_on_meta_and_card(cuda, dataclasses.replace(
        get_smoke_arch("smollm-360m"), remat="full"))


def _counts_equal_on_meta_and_card(cuda, cfg):
    from repro_torch.config import InputShape, OptimizerConfig
    from repro_torch.launch import mesh, steps
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.optimizer import adamw
    plan = steps.make_train_plan(cfg, InputShape("t", 64, 4, "train"),
                                 mesh.make_test_mesh(1, 1, device=cuda),
                                 microbatches=2)
    meta = analyze_step(plan.step_fn, *plan.arg_sds)
    params = tree_map(lambda t: t.to(cuda), build_model(cfg).init(
        torch.Generator().manual_seed(0)))
    batch = {k: torch.randint(0, cfg.vocab_size, v.shape, dtype=v.dtype,
                              device=cuda)
             for k, v in plan.arg_sds[1].items()}
    card = analyze_step(plan.step_fn,
                        (params, adamw.init(OptimizerConfig(), params)),
                        batch)
    fields = ("ops", "flops", "product_flops", "bytes", "transcendental")
    assert {f: getattr(meta, f) for f in fields} == \
        {f: getattr(card, f) for f in fields}


def _card_kernel_calls(cuda):
    """name -> (the wrapper's module, a call of it on small CUDA inputs,
    the float input that is made to require grad)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g).to(cuda)
    q, k = r(2, 128, 4, 16), r(2, 128, 2, 16)
    lw = -torch.rand((1, 2, 16, 2, 8), generator=g).to(cuda)
    wkv = [r(1, 2, 16, 2, 8) for _ in range(3)] + [lw.cumsum(2), lw, r(2, 8)]
    con = [r(3, 16), r(3, 32, 16), (r(3, 32) > 0).float()]
    mlp = [r(50, 32), r(32, 128), r(128), r(128, 128), r(128), r(128, 64),
           r(64), torch.nn.functional.normalize(r(3, 64), dim=1)]
    return {
        "flash": (f_ops, lambda: f_ops.flash_attention_fwd(
            q, k, k, scale=0.25, causal=True), q),
        "wkv6": (w_ops, lambda: w_ops.wkv6_intra_chunk(*wkv), wkv[0]),
        "contrastive": (c_ops, lambda: c_ops.contrastive_losses(
            *con, 0.07, 0.2), con[1]),
        "fused": (s_ops, lambda: s_ops.fused_scores_multi(*mlp), mlp[0]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash", "wkv6", "contrastive", "fused"])
def test_a_kernel_call_that_needs_a_gradient_raises_on_the_card(cuda, name):
    """No wrapper falls back to its plain version on the card: a call on
    CUDA inputs that require grad, with grad mode on, raises and launches
    nothing (the kernels have no backward); the same call with grad off
    launches once, and once more under the cost counter."""
    from repro_torch.launch.hlo_analysis import CostCounter
    mod, call, leaf = _card_kernel_calls(cuda)[name]
    before = mod.KERNEL.launches
    leaf.requires_grad_(True)
    with torch.enable_grad(), pytest.raises(NotImplementedError,
                                            match="no backward"):
        call()
    assert mod.KERNEL.launches == before
    with torch.no_grad():
        call()
        with CostCounter() as counter:
            call()
    torch.cuda.synchronize(cuda)
    assert mod.KERNEL.launches == before + 2
    assert counter.report().ops == 1


# -- the data axis: a mesh of two entries ------------------------------------

def _card_mesh(kind):
    """A ("data",) mesh of two entries: cuda:0 twice, or two distinct
    cards (skipped where the process has one)."""
    from collections import OrderedDict
    from repro_torch.launch.mesh import Mesh, make_scoring_mesh
    if kind == "distinct":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards: the distinct-device mesh runs a "
                        "row shard on cuda:1")
        return make_scoring_mesh(2)
    return Mesh(OrderedDict(data=2), (torch.device("cuda", 0),) * 2)


MESH_KINDS = ["repeated", "distinct"]
MESH_TOL = dict(rtol=1e-6, atol=1e-6)    # a sharded run against one device


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MESH_KINDS)
def test_shard_path_on_a_card_mesh(cuda, kind):
    """The executor's shard path (use_kernel=False) against the
    single-device plain pass, and use_kernel=True on the same mesh
    running the fused kernel on one device."""
    from repro_torch.config import ProxyConfig
    from repro_torch.core.encoder import encoder_init
    from repro_torch.engine import InMemoryStore, ScoringExecutor
    from repro_torch.models.common import tree_map
    mesh = _card_mesh(kind)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    store = InMemoryStore(rng.normal(size=(1999, 256)).astype(np.float32))
    params = tree_map(lambda t: t.to(dev), encoder_init(
        torch.Generator().manual_seed(0), ProxyConfig(embed_dim=256)))
    e = rng.normal(size=(2, 256)).astype(np.float32)
    jobs = [(params, e[0]), (None, e[1]), (params, e[1])]
    single, _ = ScoringExecutor(chunk=700, use_kernel=False,
                                device=dev).score_multi(jobs, store)
    ex = ScoringExecutor(chunk=700, use_kernel=False, mesh=mesh, device=dev)
    got, st = ex.score_multi(jobs, store)
    assert st.devices == 2 and st.paths == ("shard",)
    np.testing.assert_allclose(got, single, **MESH_TOL)
    one, st1 = ex.score(params, e[0], store)
    assert st1.devices == 2 and st1.paths == ("shard",)
    np.testing.assert_allclose(one, single[:, 0], **MESH_TOL)
    before = s_ops.KERNEL.launches
    fused, stf = ScoringExecutor(chunk=700, mesh=mesh, device=dev).score(
        params, e[0], store)
    assert stf.devices == 1 and stf.paths == ("fused",)
    assert s_ops.KERNEL.launches == before + stf.tiles_scored
    np.testing.assert_allclose(fused, single[:, 0], **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MESH_KINDS)
@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b"])
def test_sharded_ingest_on_a_card_mesh(cuda, tmp_path, kind, arch):
    """build_index on the mesh gives the single-device store's rows, the
    path's kernel launched once a layer a shard a batch, and the
    service's params copied once a distinct card."""
    from repro_torch.config import get_smoke_arch
    from repro_torch.data import make_corpus
    from repro_torch.engine import build_index
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import EmbeddingService
    mesh = _card_mesh(kind)
    dev = torch.device("cuda", 0)
    cfg = get_smoke_arch(arch)
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
    corpus = make_corpus(0, n_docs=32, dim=16, with_tokens=True,
                         vocab=cfg.vocab_size, doc_len=40)
    docs = [corpus.tokens[i][:12 + i % 28] for i in range(32)]
    single = build_index(EmbeddingService(cfg, params, 8, device=dev), docs,
                         tmp_path / "one")
    svc = EmbeddingService(cfg, params, 8, mesh=mesh, device=dev)
    assert svc.params_on(dev) is params
    kern = w_ops.KERNEL if arch == "rwkv6-7b" else f_ops.KERNEL
    before = kern.launches
    got = build_index(svc, docs, tmp_path / "mesh", mesh=mesh)
    torch.cuda.synchronize()
    assert got.stats.devices == 2 and got.stats.batches == 4
    assert kern.launches == before + kernel_layers(cfg) * 4 * 2
    rows = np.arange(32)
    np.testing.assert_allclose(got.store.get(rows), single.store.get(rows),
                               **F32)


@pytest.mark.cuda
def test_kernels_launch_on_a_second_card(cuda):
    """Each kernel on cuda:1 while cuda:0 is current, at the path's
    shapes, whose shared memory needs the per-device attribute: the
    wrapper launches under the tensors' device, and the attribute is set
    there too."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the kernels run on cuda:1")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    # flash, bf16 and f32, at the offline path's shape on cuda:0 first
    for card in (torch.device("cuda", 0), dev):
        q, k, v = (_t(x, card) for x in _attention_inputs(8, 512, 512, 32,
                                                          8, 128))
        for dtype in (torch.bfloat16, torch.float32):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            scale = 128 ** -0.5
            got = f_ops.flash_attention_fwd(qd, kd, vd, scale=scale,
                                            causal=True)
            kx, vx = f_ref.expand_kv(kd, 4), f_ref.expand_kv(vd, 4)
            if dtype == torch.bfloat16:
                want = f_ref.attention_blocked(
                    qd, kx, vx, scale, causal=True, q_block=64,
                    kv_block=f_ops.bf16_tile_keys(128), round_p=True)
                tol = FLASH_BF16_PLAIN
            else:
                want = f_ref.ref_attention(qd, kx, vx, scale=scale,
                                           causal=True)
                tol = FLASH[dtype]
            torch.cuda.synchronize(card)
            assert got.device == card and torch.cuda.current_device() == 0
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(), **tol)
    args = [_t(x, dev) for x in wkv6_inputs(*WKV6_CASES[0][:5])]
    got = w_ops.wkv6_intra_chunk(*args)
    want = w_ref.wkv6_intra_chunk(*args, sub=w_ref.SUB)
    torch.cuda.synchronize(dev)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / (w.abs().max() + 1e-9)).item() < 1e-5
    docs, w, zq = _scoring_inputs(8192, 4096, 512, 128, 4)
    sargs = [_t(x, dev) for x in [docs] + w + [zq]]
    np.testing.assert_allclose(
        s_ops.fused_scores_multi(*sargs).cpu().numpy(),
        s_ref.ref_scores_multi(*sargs).cpu().numpy(), **F32)
    cargs = [_t(x, dev) for x in _contrastive_inputs(128, 64, 0.3, q=4)]
    np.testing.assert_allclose(
        c_ops.contrastive_losses(*cargs, 0.07, 0.2).cpu().numpy(),
        c_ref.ref_losses(*cargs, 0.07, 0.2).cpu().numpy(), **LOSS)


# -- the model axis: SPMD ranks of the Trainer --------------------------------


def _model_axis_ranks(tmp_path, env: dict) -> list:
    """Two ranks of tests/torch_model_axis_ranks.py on a (1, 2) mesh of
    the card(s) ``env`` shows, training smollm-360m and llama3-8b SMOKE;
    their results, in rank order."""
    import os
    import socket
    import subprocess
    from pathlib import Path
    here = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    full_env = dict(os.environ, **env, PYTHONPATH=str(here.parent / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_model_axis_ranks.py"), "--rank",
         str(r), "--world", "2", "--port", str(port), "--device", "cuda",
         "--out", str(tmp_path), "--jobs", "trainer", "--archs",
         "smollm-360m,llama3-8b"], env=full_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        t[-3000:] for t in logs)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["cuda:0 twice", "two cards"])
def test_model_axis_trainer_against_one_device(cuda, tmp_path, where):
    """The (1, 2) Trainer's step on SPMD ranks (cuda:0 twice over the
    port's repro_gloo backend, or cuda:0 and cuda:1 over NCCL) against
    the single-device Trainer on the card: step 0's loss (rtol 1e-5),
    five steps' losses (rtol 1e-4), the params after one step (within lr;
    rtol = atol = 2e-4 where |g| >= 1e-5), flash launched on each rank."""
    import torch_model_axis_ranks as R
    from repro_torch.config import get_smoke_arch
    from repro_torch.data.loader import device_batch
    from repro_torch.runtime.train_loop import Trainer
    if where == "two cards":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards: the ranks take cuda:0 and "
                        "cuda:1")
        env, want = {}, ["cuda:0", "cuda:1"]
    else:
        env, want = {"CUDA_VISIBLE_DEVICES": "0"}, ["cuda:0", "cuda:0"]
    ranks = _model_axis_ranks(tmp_path, env)
    assert [r["device"] for r in ranks] == want
    b1 = 0.9
    for arch in ("smollm-360m", "llama3-8b"):
        cfg = get_smoke_arch(arch)
        with Trainer(cfg, R.train_config(tmp_path / "one" / arch),
                     device=cuda) as tr:
            s0 = tr.init_state()
            s1, m = tr._step(s0, device_batch(tr.loader.batch(0),
                                              device=cuda))
            losses = tr.run(R.STEPS, resume=False).losses
        got = ranks[0][arch]
        assert all(r[arch]["flash_launches"] > 0 for r in ranks)
        np.testing.assert_allclose(got["loss0"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
        mu = dict(R.leaves(s1[1].mu))
        for path, t in R.leaves(s1[0]):
            want_p, g = R.full(t), R.full(mu[path]) / (1 - b1)
            diff = np.abs(got["params1"][path] - want_p)
            assert diff.max() <= R.OPT["lr"] * (1 + 1e-3)
            cond = np.abs(g) >= 1e-5
            np.testing.assert_allclose(got["params1"][path][cond],
                                       want_p[cond], rtol=2e-4, atol=2e-4)


# -- the model axis: SPMD ranks of the prefill and decode plans ------------

DECODE_AXIS_CASES = [
    dict(arch="llama3-8b", batch=2, prompt=12, cache_len=32, steps=8),
    dict(arch="smollm-360m", batch=2, prompt=12, cache_len=32, steps=3)]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["cuda:0 twice", "two cards"])
def test_model_axis_decode_against_one_device(cuda, tmp_path, where):
    """The prefill and decode plans and ``generate`` on a (1, 2) mesh of
    SPMD ranks (cuda:0 twice over repro_gloo, or cuda:0 and cuda:1 over
    NCCL; ``tests/torch_decode_axis_ranks.py``) against the one-device
    model on the card, SMOKE in f32: llama3-8b (4 heads over 1: the
    decode cache's sequence over "model", its softmax combined across
    the ranks) and smollm-360m (a head-sharded cache). The prefill's last
    logits, each step's logits and the final cache within 1e-5 of max
    |one device| a leaf; every step's cache placed as the plan says;
    ``generate``'s tokens the one device's (a near-tie excepted);
    ``softmax_over_shards`` against ``torch.softmax`` at 1e-6."""
    import json
    import os
    import socket
    import subprocess
    from pathlib import Path

    import torch_decode_axis_ranks as D
    from repro_torch.config import get_smoke_arch
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.runtime.serve_loop import generate
    if where == "two cards":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards: the ranks take cuda:0 and "
                        "cuda:1")
        env, want_dev = {}, ["cuda:0", "cuda:1"]
    else:
        env, want_dev = {"CUDA_VISIBLE_DEVICES": "0"}, ["cuda:0", "cuda:0"]
    archs = sorted({c["arch"] for c in DECODE_AXIS_CASES})
    params_np = {a: _np_tree(build_model(get_smoke_arch(a)).init(
        torch.Generator().manual_seed(0))) for a in archs}
    torch.save(params_np, tmp_path / "params.pt")
    here = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    full_env = dict(os.environ, **env, PYTHONPATH=str(here.parent / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_decode_axis_ranks.py"), "--rank",
         str(r), "--world", "2", "--port", str(port), "--device", "cuda",
         "--params", str(tmp_path / "params.pt"), "--cases",
         json.dumps(DECODE_AXIS_CASES), "--out", str(tmp_path)],
        env=full_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        t[-3000:] for t in logs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert [r["device"] for r in ranks] == want_dev

    def rel(got, want):
        want = want.float().cpu().numpy()
        return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))

    for case in DECODE_AXIS_CASES:
        cfg = get_smoke_arch(case["arch"])
        model = build_model(cfg)
        params = params_from_jax(params_np[case["arch"]], cuda)
        toks = D.case_tokens(cfg, case)
        P, L = case["prompt"], case["cache_len"]
        logits, cache = model.prefill(params, torch.as_tensor(
            toks[:, :P], device=cuda), cache_len=L)
        got = ranks[0][D.case_name(case)]
        for last in (True, False):
            assert rel(got["prefill"][last]["logits"]["full"][""],
                       logits[:, -1]) <= 1e-5
        for t, step in enumerate(got["decode"]):
            logits, cache = model.decode_step(
                params, torch.as_tensor(toks[:, P + t:P + t + 1],
                                        device=cuda), P + t, cache)
            assert rel(step["logits"]["full"][""], logits[:, -1]) <= 1e-5
            for res in ranks:
                rec = res[D.case_name(case)]["decode"][t]["cache"]
                assert rec["placements"] == rec["plan_placements"]
        final = dict(D.flatten_with_paths(cache))
        for path, arr in got["decode"][-1]["cache"]["full"].items():
            assert rel(arr, final[path]) <= 1e-5, path
        want = generate(model, params, toks[:, :P], D.GEN_STEPS,
                        cache_len=L)
        for res in ranks:
            tokens = res[D.case_name(case)]["generate"]
            differ = np.argwhere(tokens != want)
            if len(differ):
                # a near-tie on one device: its top-2 margin there is
                # under 1e-4, so either token is accepted
                b, t = differ[0]
                lg, c = model.prefill(params, torch.as_tensor(
                    toks[b:b + 1, :P], device=cuda), cache_len=L)
                for i in range(t):
                    lg, c = model.decode_step(params, torch.as_tensor(
                        want[b:b + 1, i:i + 1], device=cuda), P + i, c)
                top = torch.topk(lg[0, -1], 2).values
                assert (top[0] - top[1]) < 1e-4, (tokens, want)
    for valid in D.COMBINE_VALID:
        c = ranks[0]["combine"]
        scores, v = torch.as_tensor(c["scores"]), torch.as_tensor(c["v"])
        keep = torch.arange(scores.shape[-1]) < valid
        s = torch.where(keep, scores, torch.full_like(scores, -1e30))
        want = torch.einsum("bhql,blhk->bqhk", torch.softmax(s, dim=-1), v)
        for res in ranks:
            np.testing.assert_allclose(res["combine"][valid]["out"],
                                       want.numpy(), rtol=1e-6, atol=1e-6)


# -- the model axis: the MoE block with its experts over "model" -------------


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["cuda:0 twice", "two cards"])
def test_model_axis_moe_block_against_one_device(cuda, tmp_path, where):
    """The MoE block alone (``models.moe.moe_apply_mesh``) on a (1, 2)
    mesh of SPMD ranks (cuda:0 twice over repro_gloo, or cuda:0 and
    cuda:1 over NCCL; ``tests/torch_moe_axis_ranks.py``'s ``layer`` job),
    each rank running half the experts, against ``moe_apply`` on one
    card, for qwen3-moe-30b-a3b and dbrx-132b SMOKE in f32 with both
    dispatches, on crowded inputs that drop pairs: y and the gradients
    of x and the router within 1e-5 of max |one device|, aux within
    1e-6, every rank's experts and kept pairs the one device's, bitwise.
    """
    import json
    import os
    import socket
    import subprocess
    from pathlib import Path

    import torch_moe_axis_ranks as M
    from repro_torch.config import get_smoke_arch
    from repro_torch.models import build_model, moe, params_from_jax
    if where == "two cards":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards: the ranks take cuda:0 and "
                        "cuda:1")
        env, want_dev = {}, ["cuda:0", "cuda:1"]
    else:
        env, want_dev = {"CUDA_VISIBLE_DEVICES": "0"}, ["cuda:0", "cuda:0"]
    params_np = {a: _np_tree(build_model(get_smoke_arch(a)).init(
        torch.Generator().manual_seed(0))) for a in M.ARCHS}
    torch.save(params_np, tmp_path / "params.pt")
    cases = [dict(arch=a, dispatch=d, rules="default", jobs=["layer"])
             for a in M.ARCHS for d in M.DISPATCHES]
    here = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    full_env = dict(os.environ, **env, PYTHONPATH=str(here.parent / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_moe_axis_ranks.py"), "--rank",
         str(r), "--world", "2", "--port", str(port), "--device", "cuda",
         "--params", str(tmp_path / "params.pt"), "--cases",
         json.dumps(cases), "--out", str(tmp_path)],
        env=full_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        t[-3000:] for t in logs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert [r["device"] for r in ranks] == want_dev

    def rel(got, want):
        want = want.detach().float().cpu().numpy()
        return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))

    for case in cases:
        cfg = get_smoke_arch(case["arch"])
        tree = params_from_jax(params_np[case["arch"]], cuda)
        p = {k: v[0].detach().requires_grad_(True)
             for k, v in tree["blocks"]["p0"]["moe"].items()}
        for shape in M.LAYER_SHAPES.values():
            name = "span" if shape == M.LAYER_SHAPES["span"] else "whole"
            x, r = M.layer_input(cfg, params_np[case["arch"]]["blocks"]
                                 ["p0"]["moe"]["router"][0], shape)
            xt = torch.as_tensor(x, device=cuda).requires_grad_(True)
            y, aux = moe.moe_apply(p, xt, cfg, case["dispatch"])
            loss = (y * torch.as_tensor(r, device=cuda)).sum() \
                + M.AUX_W * aux
            gx, gr = torch.autograd.grad(loss, (xt, p["router"]))
            kept = moe.kept_pairs(p, xt.detach(), cfg, case["dispatch"])
            assert int(kept.sum()) < kept.numel()            # drops
            flat = xt.detach().reshape(-1, cfg.d_model)
            experts = torch.cat([moe._route(p, flat[sl], cfg)[1]
                                 for sl in moe._chunks(flat.shape[0])])
            for res in ranks:
                got = res[M.case_name(case)]["layer"][name]
                assert rel(got["y"], y) <= 1e-5
                assert rel(got["grad_x"], gx) <= 1e-5
                assert rel(got["grad_router"], gr) <= 1e-5
                assert abs(got["aux"] - float(aux)) <= 1e-6
                np.testing.assert_array_equal(got["kept"],
                                              kept.cpu().numpy())
                np.testing.assert_array_equal(got["experts"],
                                              experts.cpu().numpy())


# -- the model axis: the RWKV6 recurrence on each rank's heads ---------------


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["cuda:0 twice", "two cards"])
def test_model_axis_rwkv_block_against_one_device(cuda, tmp_path, where):
    """The WKV6 recurrence alone (``models.rwkv.recurrence``, each rank on
    its heads through ``kernels.wkv6.ops.RankHeads``) on a (1, 2) mesh of
    SPMD ranks (cuda:0 twice over repro_gloo, or cuda:0 and cuda:1 over
    NCCL; ``tests/torch_rwkv_axis_ranks.py``'s ``layer`` job) against
    one card, rwkv6-7b SMOKE's 4 heads of 16: in the kernel mode each
    rank's rows of y (its 2 heads) bitwise the one-device launch's, one
    launch a rank; the direct and factored modes within 1e-5 of max
    |one device| and launching nothing; y and the state within 1e-5
    gathered; no collective inside the call."""
    import json
    import os
    import socket
    import subprocess
    from pathlib import Path

    import torch_rwkv_axis_ranks as W
    from repro_torch.config import get_smoke_arch
    from repro_torch.models import build_model, rwkv
    if where == "two cards":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards: the ranks take cuda:0 and "
                        "cuda:1")
        env, want_dev = {}, ["cuda:0", "cuda:1"]
    else:
        env, want_dev = {"CUDA_VISIBLE_DEVICES": "0"}, ["cuda:0", "cuda:0"]
    cfg = get_smoke_arch(W.ARCH)
    torch.save(_np_tree(build_model(cfg).init(
        torch.Generator().manual_seed(0))), tmp_path / "params.pt")
    here = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    full_env = dict(os.environ, **env, PYTHONPATH=str(here.parent / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_rwkv_axis_ranks.py"), "--rank",
         str(r), "--world", "2", "--port", str(port), "--device", "cuda",
         "--params", str(tmp_path / "params.pt"), "--cases",
         json.dumps([dict(rules="default", jobs=["layer"])]), "--out",
         str(tmp_path)], env=full_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        t[-3000:] for t in logs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert [r["device"] for r in ranks] == want_dev
    inputs = [torch.as_tensor(t, device=cuda) for t in W.layer_input(cfg)]

    def rel(got, want):
        want = want.float().cpu().numpy()
        return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))

    for mode in rwkv.MODES:
        before = w_ops.KERNEL.launches
        with torch.no_grad():
            y, S = rwkv.recurrence(mode, *inputs, return_state=True)
        torch.cuda.synchronize(cuda)
        assert w_ops.KERNEL.launches - before == int(mode == "kernel")
        H = y.shape[2] // 2
        for res in ranks:
            got = res["default"]["layer"][mode]
            j = res["coordinate"][1]
            mine = y[:, :, j * H:(j + 1) * H].cpu().numpy()
            assert got["collectives"] == 0
            assert got["launches"] == int(mode == "kernel")
            assert rel(got["y"], y) <= 1e-5 and rel(got["state"], S) <= 1e-5
            if mode == "kernel":
                np.testing.assert_array_equal(got["y_local"], mine)
            else:
                assert float(np.abs(got["y_local"] - mine).max()) <= \
                    1e-5 * float(np.abs(mine).max())
