"""Port parity of the two kernels on the main path.

On the CPU each wrapper computes its plain PyTorch version; those are
held against the JAX package's Pallas kernels in interpret mode on the
same numpy inputs. The CUDA kernels themselves have no CPU mode; they
are held against these plain versions on the card by
test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.contrastive.contrastive import contrastive_losses as \
    j_contrastive
from repro.kernels.fused_scoring import ops as j_sops
from repro.kernels.fused_scoring.scoring import (fused_scores as j_fused,
                                                 fused_scores_multi as
                                                 j_fused_multi)
from repro_torch.engine import executor as t_exec
from repro_torch.kernels.contrastive import ops as c_ops
from repro_torch.kernels.contrastive import ref as c_ref
from repro_torch.kernels.fused_scoring import ops as s_ops
from torch_kernel_inputs import (F32, FUSED_RAGGED_N, FUSED_WIDTHS, LOSS,
                                 _contrastive_inputs, _degenerate,
                                 _scoring_inputs, _t)
from torch_threads import one_torch_thread  # noqa: F401

# ---------------------------------------------------------------------------
# contrastive: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,p", [(32, 16), (128, 64)])
@pytest.mark.parametrize("case", ["0.1", "0.5", "0.9", "all_pos", "all_neg",
                                  "tie", "tie_far"])
def test_contrastive_plain_matches_pallas(n, p, case):
    frac = float(case) if case[0].isdigit() else 0.5
    zq, zd, y = _degenerate(case, *_contrastive_inputs(n, p, frac))
    out_j = j_contrastive(jnp.asarray(zq), jnp.asarray(zd), jnp.asarray(y),
                          0.07, 0.2, interpret=True)
    out_t = c_ops.contrastive_losses(_t(zq), _t(zd), _t(y), 0.07, 0.2)
    assert out_t.shape == (4,) and torch.isfinite(out_t).all()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **LOSS)


def test_contrastive_lanes_are_independent():
    zq, zd, y = _contrastive_inputs(64, 32, 0.3, q=4)
    out = c_ops.contrastive_losses(_t(zq), _t(zd), _t(y), 0.07, 0.2)
    assert out.shape == (4, 4)
    for i in range(4):
        one = c_ops.contrastive_losses(_t(zq[i]), _t(zd[i]), _t(y[i]),
                                       0.07, 0.2)
        np.testing.assert_allclose(out[i].numpy(), one.numpy(), **F32)


def test_phase2_function_gradient_is_the_plain_gradient():
    """The autograd.Function's backward replays the plain objective: the
    gradient equals plain autograd's, and the labels get none."""
    zq, zd, y = _contrastive_inputs(48, 16, 0.4, q=2)
    a = [_t(zq).requires_grad_(), _t(zd).requires_grad_()]
    yt = _t(y).requires_grad_()
    c_ops.phase2_loss(a[0], a[1], yt, 0.07, 0.2).sum().backward()
    b = [_t(zq).requires_grad_(), _t(zd).requires_grad_()]
    c_ref.ref_phase2(b[0], b[1], _t(y), 0.07, 0.2).sum().backward()
    # z_q only selects the bellwether rows: plain autograd leaves it
    # unused, the Function returns zeros, as the JAX custom_vjp does
    assert b[0].grad is None and not a[0].grad.any()
    np.testing.assert_allclose(a[1].grad.numpy(), b[1].grad.numpy(), **F32)
    assert yt.grad is None


# ---------------------------------------------------------------------------
# fused scoring: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [1, 3, 9])
def test_fused_scores_multi_plain_matches_pallas(q):
    docs, w, zq = _scoring_inputs(300, 96, 128, 64, q)   # 300 % 128 != 0
    out_j = j_fused_multi(jnp.asarray(docs), *map(jnp.asarray, w),
                          jnp.asarray(zq), interpret=True)
    out_t = s_ops.fused_scores_multi(_t(docs), *map(_t, w), _t(zq))
    assert out_t.shape == (300, q)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)


def _fused_parity(n, d, h, l, q):
    docs, w, zq = _scoring_inputs(n, d, h, l, q)
    out_j = j_fused_multi(jnp.asarray(docs), *map(jnp.asarray, w),
                          jnp.asarray(zq), interpret=True)
    out_t = s_ops.fused_scores_multi(_t(docs), *map(_t, w), _t(zq))
    assert out_t.shape == (n, q)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)


@pytest.mark.parametrize("n", FUSED_RAGGED_N)
def test_fused_plain_matches_pallas_at_ragged_n(n):
    """n cutting the CUDA kernel's 64-row tile (and the Pallas kernel's
    128-row one) at a D that no 4- or 16-wide slice divides, Q=33."""
    _fused_parity(n, 99, 128, 64, 33)


@pytest.mark.parametrize("h,l", FUSED_WIDTHS)
def test_fused_plain_matches_pallas_at_every_width(h, l):
    _fused_parity(65, 99, h, l, 2)


def test_fused_scores_single_query_plain_matches_pallas():
    docs, w, zq = _scoring_inputs(200, 64, 64, 64, 1)
    out_j = j_fused(jnp.asarray(docs), *map(jnp.asarray, w),
                    jnp.asarray(zq[0]), interpret=True)
    out_t = s_ops.fused_scores(_t(docs), *map(_t, w), _t(zq[0]))
    assert out_t.shape == (200,)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)


def test_score_collection_entries_match_jax():
    from repro_torch.core.encoder import params_from_jax
    import jax
    from repro.config.base import ProxyConfig as JCfg
    from repro.core.encoder import encoder_init
    params = jax.tree.map(np.asarray, encoder_init(
        jax.random.PRNGKey(0), JCfg(embed_dim=48, hidden_dim=64,
                                    latent_dim=64, proj_dim=8)))
    rng = np.random.default_rng(1)
    docs = rng.normal(size=(150, 48)).astype(np.float32)
    e_qs = rng.normal(size=(3, 48)).astype(np.float32)
    tp = params_from_jax(params)
    np.testing.assert_allclose(
        s_ops.score_collection(tp, e_qs[0], docs, chunk=64, device="cpu"),
        j_sops.score_collection(params, e_qs[0], docs, chunk=64,
                                interpret=True), **F32)
    np.testing.assert_allclose(
        s_ops.score_collection_multi(tp, e_qs, docs, chunk=64,
                                     device="cpu"),
        j_sops.score_collection_multi(params, e_qs, docs, chunk=64,
                                      interpret=True), **F32)


def test_fused_wrapper_rejects_what_the_kernel_does_not_take():
    docs, w, zq = _scoring_inputs(8, 32, 64, 64, 2)
    t = [_t(x) for x in w]
    s_ops._check(_t(docs), *t, _t(zq))                 # accepted shapes
    with pytest.raises(ValueError, match="widths"):
        d2, w2, z2 = _scoring_inputs(8, 32, 96, 64, 2)
        s_ops._check(_t(d2), *map(_t, w2), _t(z2))
    with pytest.raises(ValueError, match="shape"):
        s_ops._check(_t(docs), *t, _t(zq[:, :32]))
    with pytest.raises(TypeError, match="float32"):
        s_ops._check(_t(docs).double(), *t, _t(zq))
    with pytest.raises(ValueError, match="contiguous"):
        s_ops._check(_t(docs.T.copy()).T, *t, _t(zq))


def test_contrastive_wrapper_rejects_what_the_kernel_does_not_take():
    zq, zd, y = _contrastive_inputs(16, 8, 0.5, q=2)
    c_ops._check(_t(zq), _t(zd), _t(y))
    with pytest.raises(ValueError, match="n <= 512"):
        a, b, c = _contrastive_inputs(513, 8, 0.5, q=1)
        c_ops._check(_t(a), _t(b), _t(c))
    with pytest.raises(ValueError, match="mismatch"):
        c_ops._check(_t(zq), _t(zd), _t(y[:, :8]))


def test_staging_ring_waits_for_the_copy_before_reuse():
    """A pinned buffer is handed out again only after the event of the
    copy that read it has completed."""
    class Event:
        def __init__(self):
            self.waited = False

        def synchronize(self):
            self.waited = True

    stager = t_exec.HostStager(torch.device("cpu"))
    stager._bufs = [torch.empty(12) for _ in range(t_exec.STAGING_SLOTS)]
    s0, b0 = stager._acquire(12)
    e0 = Event()
    stager._events[s0] = e0
    s1, b1 = stager._acquire(12)
    stager._events[s1] = Event()
    assert not e0.waited and s1 != s0
    s2, b2 = stager._acquire(12)
    assert s2 == s0 and b2 is b0 and e0.waited


@pytest.mark.parametrize("case", ["mixed", "all_pos"])
def test_contrastive_losses_entry_matches_jax(case):
    """``ops.losses``, the evaluation entry (all four values), against the
    JAX package's ``ops.losses`` on the CPU (its reference), 1e-6."""
    from repro.kernels.contrastive import ops as j_cops
    rng = np.random.default_rng(11)
    zq = rng.normal(size=32).astype(np.float32)
    zd = rng.normal(size=(48, 32)).astype(np.float32)
    y = (rng.random(48) < 0.3).astype(np.float32)
    y[:2] = 1.0, 0.0
    if case == "all_pos":
        y[:] = 1.0
    want = np.asarray(j_cops.losses(jnp.asarray(zq), jnp.asarray(zd),
                                    jnp.asarray(y), 0.07, 0.2))
    got = c_ops.losses(torch.tensor(zq), torch.tensor(zd), torch.tensor(y),
                       0.07, 0.2)
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
