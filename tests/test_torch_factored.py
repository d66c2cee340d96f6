"""Port parity of the factored WKV6 (``rwkv_mode="factored"``), the
launch plans' RWKV6 lowering: the time-mix, its gradients and the
rwkv6-7b SMOKE model against the JAX package's ``mode="factored"``.

The decay bias ``w0`` is raised on half the channels, so that there the
per-step log-decay passes ``-FACTORED_CLAMP / Q`` and the clamp bites
(the count of clamped entries is asserted, neither none nor all).
Weights are the JAX package's own init carried across with
``params_from_jax``; inputs are numpy, float32. Tolerances: forward
1e-5 of max |ref|, each gradient 1e-4 of its max |ref|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke_arch as j_smoke
from repro.models import build_model as j_build_model
from repro.models import rwkv as j_rwkv
from repro_torch.config import get_smoke_arch as t_smoke
from repro_torch.kernels.wkv6 import ops as w_ops
from repro_torch.kernels.wkv6 import ref as w_ref
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import rwkv as t_rwkv
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "rwkv6-7b"
REL = 1e-5
GRAD_REL = 1e-4
# w0 on the biting half: -exp(1.5 + lora) ~ -4.5 < -80 / Q for Q >= 18
W0_BITE = 1.5


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


def _carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _biting(w0):
    """w0 raised to W0_BITE on every other channel."""
    w0 = np.array(w0, np.float32)
    w0[::2] = W0_BITE
    return jnp.asarray(w0)


def _timemix(s, seed=0):
    cfg_j, cfg_t = j_smoke(ARCH), t_smoke(ARCH)
    jp = j_rwkv.timemix_init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    jp["w0"] = _biting(jp["w0"])
    x = np.random.default_rng(seed).normal(
        size=(2, s, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, jp, x


def _clamped(tp, x, cfg):
    """(entries the clamp changes, all entries) of the log-decay."""
    _, _, _, lw, _ = t_rwkv.timemix_inputs(tp, torch.tensor(x), cfg)
    q = w_ref.chunk_len(x.shape[1], t_rwkv.CHUNK)
    return int((lw < -t_rwkv.FACTORED_CLAMP / q).sum()), lw.numel()


@pytest.mark.parametrize("s", [40, 200, 256])
def test_timemix_factored_matches_jax(s):
    """s=40 is one chunk of 40, s=200 two of 100, s=256 two of 128; the
    final state too."""
    cfg_j, cfg_t, jp, x = _timemix(s)
    want, want_s = j_rwkv.timemix_apply(jp, jnp.asarray(x), cfg_j,
                                        mode="factored", return_state=True)
    tp = _carry(jp)
    n, total = _clamped(tp, x, cfg_t)
    assert 0 < n < total, (n, total)
    before = w_ops.KERNEL.launches
    got, got_s = t_rwkv.timemix_apply(tp, torch.tensor(x), cfg_t,
                                      mode="factored", return_state=True)
    assert w_ops.KERNEL.launches == before     # no kernel in this mode
    assert _rel_err(got, want) < REL
    assert _rel_err(got_s["wkv"], want_s["wkv"]) < REL
    assert torch.equal(got_s["shift_t"], torch.tensor(x)[:, -1])
    # the clamp changes the function: the exact mode differs
    exact = t_rwkv.timemix_apply(tp, torch.tensor(x), cfg_t, mode="direct")
    assert _rel_err(exact, want) > 1e3 * REL


def test_timemix_factored_gradients_match_jax():
    """d sum(y * c) / d (every param, x) against ``jax.grad``, through the
    per-chunk recompute."""
    cfg_j, cfg_t, jp, x = _timemix(200, seed=1)
    c = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def j_loss(p, xx):
        y = j_rwkv.timemix_apply(p, xx, cfg_j, mode="factored")
        return jnp.sum(y * c)
    jg, jgx = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _carry(jp).items()}
    xt = torch.tensor(x, requires_grad=True)
    y = t_rwkv.timemix_apply(tp, xt, cfg_t, mode="factored")
    (y * torch.tensor(c)).sum().backward()
    for name, g in jg.items():
        assert _rel_err(tp[name].grad, g) < GRAD_REL, name
    assert _rel_err(xt.grad, jgx) < GRAD_REL


def test_factored_chunks_are_recomputed_in_the_backward():
    """With grad mode on each chunk runs under ``torch.utils.checkpoint``:
    the backward runs every chunk's forward again."""
    cfg_j, cfg_t, jp, x = _timemix(256)
    tp = {k: v.requires_grad_(True) for k, v in _carry(jp).items()}
    calls = []
    inner = t_rwkv._factored_chunk

    def counting(*a):
        calls.append(1)
        return inner(*a)
    t_rwkv._factored_chunk = counting
    try:
        y = t_rwkv.timemix_apply(tp, torch.tensor(x), cfg_t, mode="factored")
        forward = len(calls)
        y.sum().backward()
    finally:
        t_rwkv._factored_chunk = inner
    assert forward == 2 and len(calls) == 4


def test_smoke_model_factored_matches_jax():
    """rwkv6-7b SMOKE in factored mode, the clamp biting in every layer:
    forward logits and the prefill's last logits and states."""
    cfg_j, cfg_t = j_smoke(ARCH), t_smoke(ARCH)
    jm = j_build_model(cfg_j, rwkv_mode="factored")
    jp = jm.init(jax.random.PRNGKey(3))
    jp["blocks"]["p0"]["time"]["w0"] = jnp.stack(
        [_biting(w) for w in jp["blocks"]["p0"]["time"]["w0"]])
    tokens = np.random.default_rng(4).integers(
        1, cfg_j.vocab_size, (2, 200)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(tokens))
    want_pre, want_cache = jm.prefill(jp, jnp.asarray(tokens))
    tm = build_model(cfg_t, rwkv_mode="factored")
    tp = _carry(jp)
    got, _ = tm.forward(tp, torch.tensor(tokens))
    assert _rel_err(got[..., :cfg_t.vocab_size],
                    np.asarray(want)[..., :cfg_t.vocab_size]) < REL
    got_pre, got_cache = tm.prefill(tp, torch.tensor(tokens))
    assert _rel_err(got_pre[:, -1], np.asarray(want_pre)[:, -1]) < REL
    assert _rel_err(got_cache["p0"]["wkv"],
                    want_cache["p0"]["wkv"]) < REL
    kernel, _ = build_model(cfg_t).forward(tp, torch.tensor(tokens))
    assert _rel_err(kernel, np.asarray(want)) > 1e3 * REL


def test_factored_mode_bf16_model_runs_finite():
    """A bf16 rwkv6 SMOKE model in factored mode: finite logits, the
    recurrence in float32 as in the other modes."""
    cfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16")
    model = build_model(cfg, rwkv_mode="factored")
    params = model.init(torch.Generator().manual_seed(0))
    logits, _ = model.forward(params, torch.randint(
        1, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1)))
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
