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
from torch_kernel_inputs import (F32, FLASH, FLASH_BF16_PLAIN,
                                 FUSED_RAGGED_N, FUSED_WIDTHS, LOSS,
                                 _attention_inputs, _contrastive_inputs,
                                 _degenerate, _scoring_inputs, _t,
                                 _t_misaligned)
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
# path's shape, tests/test_kernels.py's grid and q_offset case, GQA,
# ragged lengths and a head narrower than the kernel's tile
FLASH_CASES = [
    (8, 512, 512, 32, 8, 128, True, 0, 0),
    (2, 64, 64, 3, 3, 16, True, 0, 0),
    (1, 48, 48, 2, 2, 8, False, 0, 0),
    (2, 128, 128, 4, 4, 32, True, 24, 0),
    (1, 32, 96, 2, 2, 16, True, 0, 64),
    (2, 200, 200, 8, 2, 64, True, 0, 0),
    (1, 200, 200, 4, 1, 128, False, 0, 0),
    (1, 77, 200, 4, 2, 128, True, 24, 123),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
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
]


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
        kv_block=64, round_p=True)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **FLASH_BF16_PLAIN)


@pytest.mark.cuda
def test_flash_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 16, 2, 256), device=cuda)
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
