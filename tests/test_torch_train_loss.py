"""Port parity of the LM training losses: ``cross_entropy``, every
family's ``loss_fn`` and the gradient of every leaf (the SMOKE configs
of smollm-360m, gemma3-12b, qwen3-moe-30b-a3b, zamba2-2.7b and
whisper-base), remat, and the step functions of ``models.model``,
against the JAX package on the CPU (``jax.value_and_grad(model.loss_fn)``:
the JAX ``Trainer`` is not the reference, see ``test_torch_train.py``).

Inputs come from a numpy seed; JAX params are carried across with
``params_from_jax``. Tolerances, float32 throughout: a loss within 1e-5
relative and each gradient leaf within 1e-4 of its max |JAX gradient|.
The rest of the training path is ``tests/test_torch_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke_arch as j_smoke
from repro.models import build_model as j_build_model
from repro.models import common as j_common
from repro_torch import checkpoint as t_ckpt
from repro_torch.config import get_smoke_arch
from repro_torch.models import (build_model, make_decode_step,
                                make_forward_loss, make_prefill_step,
                                params_from_jax)
from repro_torch.models import common as t_common
from repro_torch.models.common import tree_map
from repro_torch.runtime.train_loop import grad_tree
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
GRAD_REL = 1e-4


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- the loss ------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = j_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  None if mask is None else jnp.asarray(mask))
    got = t_common.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                                 None if mask is None else torch.tensor(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - float(want)) <= REL * abs(float(want))
    # an all-zero mask divides by max(0, 1)
    zero = t_common.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                                  torch.zeros((3, 7)))
    assert float(zero) == 0.0


LOSS_ARCHS = ["smollm-360m", "gemma3-12b", "qwen3-moe-30b-a3b",
              "zamba2-2.7b", "whisper-base"]


def _batch(cfg, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(b, 19, cfg.d_model)).astype(
            np.float32)
    return batch


def _port_loss_and_grads(model, params, batch):
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = model.loss_fn(live, {k: torch.as_tensor(v)
                                for k, v in batch.items()})
    return loss, grad_tree(loss, live)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_fn_and_every_gradient_match_jax(arch):
    """The SMOKE config's loss (cross-entropy; qwen3-moe-30b-a3b adds the
    router's auxiliary loss, gemma3-12b has windows that bite at its
    SMOKE window of 16, zamba2-2.7b runs Mamba2 blocks and the shared
    block, whisper-base is an EncDecLM) and the gradient of every leaf,
    through the flash entry."""
    jcfg = j_smoke(arch)
    jm = j_build_model(jcfg, attn_impl="flash")
    jp = jm.init(jax.random.key(0))
    batch = _batch(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, batch)
    model = build_model(get_smoke_arch(arch), attn_impl="flash")
    loss, grads = _port_loss_and_grads(model,
                                       params_from_jax(_np_tree(jp), "cpu"),
                                       batch)
    assert abs(loss.item() - float(jl)) <= REL * abs(float(jl))
    want = dict(t_ckpt.flatten_with_paths(_np_tree(jg)))
    got = dict(t_ckpt.flatten_with_paths(grads))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert _rel(got[path], w) < GRAD_REL, (path, _rel(got[path], w))
    # make_forward_loss is the model's loss_fn
    again = make_forward_loss(model)(
        params_from_jax(_np_tree(jp), "cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert torch.equal(again.detach(), loss.detach())


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-base"])
def test_remat_full_gives_the_gradients_of_none(arch):
    """``remat="full"`` recomputes each block in the backward: the same
    ops on the same inputs, so the same loss and gradients."""
    cfg = get_smoke_arch(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(3))
    batch = _batch(cfg)
    out = {}
    for remat in ("none", "full"):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        out[remat] = _port_loss_and_grads(model, params, batch)
    assert torch.equal(out["full"][0], out["none"][0])
    want = dict(t_ckpt.flatten_with_paths(out["none"][1]))
    for path, g in t_ckpt.flatten_with_paths(out["full"][1]):
        assert torch.allclose(g, want[path], rtol=0, atol=1e-7), path


def test_prefill_and_decode_step_functions():
    """make_prefill_step / make_decode_step: the last position's logits
    of ``prefill`` and ``decode_step`` and their caches."""
    cfg = get_smoke_arch("smollm-360m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(4))
    toks = torch.tensor(_batch(cfg, s=9)["tokens"])
    logits, cache = make_prefill_step(model)(params, {"tokens": toks})
    full, want_cache = model.prefill(params, toks)
    assert torch.equal(logits, full[:, -1])
    step, new = make_decode_step(model)(
        params, {"tokens": toks[:, -1:], "pos": 8, "cache": cache})
    ref_logits, ref_cache = model.decode_step(params, toks[:, -1:], 8, cache)
    assert torch.equal(step, ref_logits[:, -1])
    assert tuple(step.shape) == (2, cfg.padded_vocab_size)
