"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips without a card. The file imports no JAX, so it runs on
a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.contrastive import ops as c_ops
from repro_torch.kernels.contrastive import ref as c_ref
from repro_torch.kernels.fused_scoring import ops as s_ops
from repro_torch.kernels.fused_scoring import ref as s_ref

F32 = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels.py's f32 tolerance
# the contrastive losses are sums of up to n LSE terms of size 1/tau ~ 14;
# tests/test_kernels.py holds the Pallas kernel to its reference with this
LOSS = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _t(x, device="cpu"):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _contrastive_inputs(n, p, pos_frac, seed=0, q=None):
    rng = np.random.default_rng(seed)
    lead = () if q is None else (q,)
    zq = rng.normal(size=lead + (p,)).astype(np.float32)
    zd = rng.normal(size=lead + (n, p)).astype(np.float32)
    y = (rng.random(lead + (n,)) < pos_frac).astype(np.float32)
    return zq, zd, y


def _degenerate(case, zq, zd, y):
    if case == "all_pos":
        y[...] = 1.0
    elif case == "all_neg":
        y[...] = 0.0
    elif case == "tie":
        y[..., :4] = [1, 0, 1, 0]
        zd[..., 2, :] = zd[..., 0, :]     # tied weakest-positive candidates
        zd[..., 3, :] = zd[..., 1, :]     # tied hardest-negative candidates
        zq[...] = -zd[..., 0, :]          # pushes row 0 (and 2) to the min
    return zq, zd, y


def _scoring_inputs(n, d, h, l, q, seed=0):
    rng = np.random.default_rng(seed)
    docs = rng.normal(size=(n, d)).astype(np.float32)
    ws = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
          for s in [(d, h), (h, h), (h, l)]]
    bs = [(0.1 * rng.normal(size=s)).astype(np.float32) for s in (h, h, l)]
    zq = rng.normal(size=(q, l)).astype(np.float32)
    zq /= np.linalg.norm(zq, axis=1, keepdims=True)
    return docs, [ws[0], bs[0], ws[1], bs[1], ws[2], bs[2]], zq


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 4, 5])
@pytest.mark.parametrize("n,d,h,l", [(8192, 4096, 512, 128),
                                     (300, 96, 128, 64), (33, 64, 64, 64)])
def test_fused_kernel_matches_plain(cuda, q, n, d, h, l):
    docs, w, zq = _scoring_inputs(n, d, h, l, q)
    args = [_t(x, cuda) for x in [docs] + w + [zq]]
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
@pytest.mark.parametrize("q,n,p", [(4, 128, 64), (1, 512, 256), (3, 7, 5)])
@pytest.mark.parametrize("case", ["0.3", "all_pos", "all_neg", "tie"])
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
