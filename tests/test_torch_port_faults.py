"""The port's repaired faults against the JAX package (one test or more
for each):

1. the ``Trainer`` builds its model in ``rwkv_mode="direct"``, as the
   JAX ``Trainer`` does, and trains RWKV6 (loss 1e-5 of the JAX
   ``loss_fn`` on carried params);
2. ``build_model``, ``TransformerLM`` and ``EncDecLM`` accept and ignore
   what the JAX versions accept and ignore (``causal_skip``; every other
   option for the encoder-decoder);
3. ``optimizer.adamw.init(cfg, params)``, as in JAX;
4. the JAX arguments the port had dropped: ``force_ref=True`` (the
   plain version on any device), ``use_kernel=False`` (the plain path on
   the device), ``interpret=True`` (refused with a stated message) and
   ``mesh``/``shardings`` (one device accepted, more refused);
5. the contrastive kernel's switches: ``losses(force_ref=, interpret=)``,
   ``phase2_loss(impl=)`` and ``ProxyConfig.contrastive_impl`` passed
   through by the proxy trainer (``"ref"`` launches nothing);
6. signatures and a return as in JAX: ``attn_apply`` returns ``(y, kv
   or None)`` and takes ``causal_skip`` (as ``flash_attention`` does),
   the proxy trainer's entry points take ``method``, ``encoder_init``
   takes ``dtype``.
"""
import inspect
import dataclasses
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import ProxyConfig as JProxy
from repro.core import encoder as j_encoder
from repro.core import trainer as j_trainer
from repro.kernels.contrastive import ops as j_c_ops
from repro.models import attention as j_attn
from repro.config import get_smoke_arch as j_smoke
from repro.models import build_model as j_build_model
from repro.optimizer import adamw as j_adamw
from repro_torch import checkpoint as ckpt
from repro_torch.config import (CascadeConfig, InputShape, OptimizerConfig,
                                ProxyConfig, TrainConfig, get_smoke_arch)
from repro_torch.core import scoring as t_scoring
from repro_torch.core import trainer as t_trainer
from repro_torch.core.encoder import encoder_init
from repro_torch.core.pipeline import ScaleDocPipeline
from repro_torch.data import make_corpus
from repro_torch.data.loader import device_batch
from repro_torch.engine import ScaleDocEngine
from repro_torch.engine.executor import ScoringExecutor
from repro_torch.kernels.contrastive import ops as c_ops
from repro_torch.kernels.contrastive import ref as c_ref
from repro_torch.kernels.flash_attention import ops as f_ops
from repro_torch.kernels.flash_attention import ref as f_ref
from repro_torch.kernels.fused_scoring import ops as s_ops
from repro_torch.kernels.wkv6 import ops as w_ops
from repro_torch.kernels.wkv6 import ref as w_ref
from repro_torch.launch.hlo_analysis import CostCounter
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models import EncDecLM, TransformerLM, build_model
from repro_torch.models import attention as t_attn
from repro_torch.models import params_from_jax
from repro_torch.models.common import tree_map
from repro_torch.optimizer import adamw
from repro_torch.runtime.serve_loop import EmbeddingService
from repro_torch.runtime.train_loop import Trainer
from repro_torch.sharding.rules import NamedSharding, P
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

TINY = InputShape("tiny", seq_len=32, global_batch=4, kind="train")
MANY = make_production_mesh()                 # 16 x 16, abstract
ONE = make_test_mesh(1, 1, device="cpu")
DATA = Mesh(OrderedDict(data=4), (torch.device("cpu"),) * 4)


def _rng_tensor(rng, *shape):
    return torch.tensor(rng.normal(size=shape).astype(np.float32))


def _kernel_ops(fn) -> int:
    """Operators of the hand-written kernels that ``fn()`` dispatches."""
    seen = []

    class Spy(CostCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.namespace)
            return super().__torch_dispatch__(func, types, args, kwargs)

    with Spy():
        fn()
    return seen.count("repro_torch")


# -- 1. RWKV6 trains through the Trainer in "direct" mode ---------------------

def test_trainer_trains_rwkv6_in_direct_mode_as_jax(tmp_path):
    arch = "rwkv6-7b"
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_arch(arch), dtype="float32")
    jm = j_build_model(jcfg)
    assert jm.rwkv_mode == "direct"
    jp = jm.init(jax.random.PRNGKey(3))
    tc = TrainConfig(shape=TINY, checkpoint_dir=str(tmp_path))
    with Trainer(tcfg, tc, device="cpu") as tr:
        assert tr.model.rwkv_mode == "direct"
        params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        batch = device_batch(tr.loader.batch(0), device="cpu")
        before = w_ops.KERNEL.launches
        (new, opt, _), metrics = tr._step(
            (params, adamw.init(tc.optimizer, params), {}), batch)
        assert w_ops.KERNEL.launches == before
    want = float(jm.loss_fn(jp, {k: jnp.asarray(v.numpy())
                                 for k, v in batch.items()}))
    got = metrics["loss"].item()
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert opt.step == 1
    moved = [not torch.equal(a, b) for (_, a), (_, b) in
             zip(ckpt.flatten_with_paths(new),
                 ckpt.flatten_with_paths(params))]
    assert all(moved) and np.isfinite(metrics["grad_norm"].item())


# -- 2. options accepted and ignored as in JAX --------------------------------

def test_build_model_takes_the_jax_options():
    opts = dict(rwkv_mode="factored", causal_skip=True, moe_dispatch="onehot")
    assert j_build_model(j_smoke("whisper-base"), **opts) is not None
    model = build_model(get_smoke_arch("whisper-base"), **opts)
    assert isinstance(model, EncDecLM) and model.attn_impl == "flash"
    assert isinstance(EncDecLM(get_smoke_arch("whisper-base"),
                               attn_impl="blocked", anything=1), EncDecLM)
    for arch in ("llama3-8b", "qwen3-moe-30b-a3b", "rwkv6-7b"):
        assert isinstance(build_model(get_smoke_arch(arch), **opts),
                          TransformerLM)


def test_causal_skip_changes_nothing():
    cfg = dataclasses.replace(get_smoke_arch("llama3-8b"), dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    tokens = torch.randint(1, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    got = [TransformerLM(cfg, causal_skip=skip).forward(params, tokens)[0]
           for skip in (False, True)]
    assert torch.equal(got[0], got[1])


# -- 3. adamw.init(cfg, params) -----------------------------------------------

def test_adamw_init_takes_cfg_first_as_jax():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": {"s": rng.normal(size=(4,)).astype(np.float32)}}
    cfg = dict(lr=1e-3, warmup_steps=2)
    want = j_adamw.init(JOpt(**cfg), jax.tree.map(jnp.asarray, params))
    got = adamw.init(OptimizerConfig(**cfg), tree_map(torch.tensor, params))
    assert got.step == int(want.step) == 0
    for name in ("mu", "nu"):
        for key, leaf in (("w", None), ("b", "s")):
            g = getattr(got, name)[key] if leaf is None \
                else getattr(got, name)[key][leaf]
            w = getattr(want, name)[key] if leaf is None \
                else getattr(want, name)[key][leaf]
            assert g.dtype == torch.float32 and g.shape == w.shape
            assert not g.any() and not np.asarray(w).any()
    with pytest.raises(TypeError):
        adamw.init(tree_map(torch.tensor, params))


# -- 4. force_ref, use_kernel, interpret, mesh and shardings ------------------

def test_force_ref_runs_the_plain_version():
    rng = np.random.default_rng(1)
    q, k = _rng_tensor(rng, 2, 70, 4, 16), _rng_tensor(rng, 2, 70, 2, 16)
    got = f_ops.attention(q, k, k, scale=0.25, force_ref=True)
    assert _kernel_ops(lambda: f_ops.attention(q, k, k, scale=0.25,
                                               force_ref=True)) == 0
    assert _kernel_ops(lambda: f_ops.attention(q, k, k, scale=0.25)) == 1
    assert torch.equal(got, f_ref.attention_blocked(
        q, f_ref.expand_kv(k, 2), f_ref.expand_kv(k, 2), 0.25, causal=True))

    r, kk, v = (_rng_tensor(rng, 1, 40, 2, 8) for _ in range(3))
    lw = -torch.exp(_rng_tensor(rng, 1, 40, 2, 8))
    u = _rng_tensor(rng, 2, 8)
    plain = w_ops.wkv6(r, kk, v, lw, u, chunk=8, force_ref=True)
    assert _kernel_ops(lambda: w_ops.wkv6(r, kk, v, lw, u, chunk=8,
                                          force_ref=True)) == 0
    assert torch.equal(plain, w_ref.wkv6_by_chunks(r, kk, v, lw, u, chunk=8))
    torch.testing.assert_close(plain, w_ref.ref_wkv6(r, kk, v, lw, u),
                               rtol=1e-5, atol=1e-5)

    params = encoder_init(torch.Generator().manual_seed(0),
                          ProxyConfig(embed_dim=32, hidden_dim=64,
                                      latent_dim=64))
    docs = rng.normal(size=(300, 32)).astype(np.float32)
    zq = torch.nn.functional.normalize(_rng_tensor(rng, 2, 64), dim=1)
    tile = torch.tensor(docs)
    assert _kernel_ops(lambda: s_ops.score_tile_multi(
        params, zq, tile, force_ref=True)) == 0
    torch.testing.assert_close(
        s_ops.score_tile_multi(params, zq, tile, force_ref=True),
        s_ops.score_tile_multi(params, zq, tile), rtol=1e-6, atol=1e-6)
    for fn, e in ((s_ops.score_collection, docs[0]),
                  (s_ops.score_collection_multi, docs[:2])):
        np.testing.assert_allclose(
            fn(params, e, docs, chunk=128, force_ref=True, device="cpu"),
            fn(params, e, docs, chunk=128, device="cpu"), rtol=1e-6,
            atol=1e-6)


def test_interpret_is_refused_with_the_stated_message():
    q = torch.zeros((1, 8, 2, 8))
    params = encoder_init(torch.Generator().manual_seed(0),
                          ProxyConfig(embed_dim=8, hidden_dim=64,
                                      latent_dim=64))
    docs = np.zeros((4, 8), np.float32)
    calls = [
        lambda: f_ops.attention(q, q, q, scale=1.0, interpret=True),
        lambda: w_ops.wkv6(q, q, q, q, q[0, 0], interpret=True),
        lambda: s_ops.score_tile_multi(params, q[0, 0], torch.zeros(4, 8),
                                       interpret=True),
        lambda: s_ops.score_collection(params, docs[0], docs,
                                       interpret=True, device="cpu"),
        lambda: s_ops.score_collection_multi(params, docs[:1], docs,
                                             interpret=True, device="cpu"),
        lambda: ScoringExecutor(interpret=True, device="cpu"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="interpret mode"):
            call()


def test_use_kernel_false_scores_with_the_plain_path():
    corpus = make_corpus(0, n_docs=600, dim=32)
    pcfg = ProxyConfig(embed_dim=32, hidden_dim=64, latent_dim=64)
    params = encoder_init(torch.Generator().manual_seed(0), pcfg)
    e_q = corpus.embeds[0]
    runs = {}
    for use_kernel in (True, False):
        eng = ScaleDocEngine(corpus.embeds, pcfg, use_kernel=use_kernel,
                             chunk=256, device="cpu")
        assert eng.use_kernel is eng.executor.use_kernel is use_kernel
        kernel_ops = _kernel_ops(lambda: runs.__setitem__(
            use_kernel, eng.executor.score(params, e_q, eng.store)))
        assert kernel_ops == (3 if use_kernel else 0)
    (on, st_on), (off, st_off) = runs[True], runs[False]
    assert st_on.paths == ("fused",) and st_off.paths == ("plain",)
    np.testing.assert_allclose(off, on, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t_scoring.score_collection(params, e_q, corpus.embeds,
                                   use_kernel=True, device="cpu"),
        t_scoring.score_collection(params, e_q, corpus.embeds,
                                   device="cpu"), rtol=1e-5, atol=1e-6)
    pipe = ScaleDocPipeline(corpus.embeds, pcfg, CascadeConfig(), False,
                            device="cpu")
    assert pipe.use_kernel is False
    assert pipe._engine.executor.use_kernel is False


def test_a_mesh_of_one_device_is_taken_and_more_refused(tmp_path):
    """The data loops take a mesh of one device and a data mesh of more
    (the engine's executor, the embedding service); a model axis over 1
    stays refused there. The Trainer, device_batch and
    restore(shardings=) take a mesh of one device and, under SPMD
    processes, a DeviceMesh-backed mesh of any shape
    (tests/test_torch_model_axis.py); a mesh of more than one device
    from one controller, as here, stays refused by them."""
    corpus = make_corpus(0, n_docs=64, dim=16)
    ScaleDocEngine(corpus.embeds, mesh=ONE, device="cpu")
    assert ScaleDocEngine(corpus.embeds, mesh=DATA, device="cpu"
                          ).executor._mesh_size == 4
    with pytest.raises(NotImplementedError, match="more than one device"):
        ScaleDocEngine(corpus.embeds, mesh=MANY, device="cpu")

    cfg = get_smoke_arch("smollm-360m")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert EmbeddingService(cfg, params, 4, ONE, device="cpu").mesh is ONE
    svc = EmbeddingService(cfg, params, 4, DATA, device="cpu")
    assert svc.mesh_devices == DATA.devices and svc.params_on(
        torch.device("cpu")) is params
    with pytest.raises(NotImplementedError, match="more than one device"):
        EmbeddingService(cfg, params, 4, MANY, device="cpu")

    tc = TrainConfig(shape=TINY, checkpoint_dir=str(tmp_path / "t"))
    Trainer(cfg, tc, ONE, device="cpu").close()
    for mesh in (MANY, DATA):
        with pytest.raises(NotImplementedError, match="mesh"):
            Trainer(cfg, tc, mesh, device="cpu")

    batch = {"tokens": np.ones((2, 4), np.int32)}
    one = {"tokens": NamedSharding(ONE, P("data"))}
    many = {"tokens": NamedSharding(MANY, P("data"))}
    assert device_batch(batch, one, device="cpu")["tokens"].dtype == \
        torch.int32
    with pytest.raises(NotImplementedError, match="more than one device"):
        device_batch(batch, many, device="cpu")

    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    ckpt.save(str(tmp_path / "c"), 1, tree)
    got, _ = ckpt.restore(str(tmp_path / "c"), 1, tree,
                          shardings={"w": NamedSharding(ONE, P())})
    assert torch.equal(got["w"], tree["w"])
    with pytest.raises(NotImplementedError, match="more than one device"):
        ckpt.restore(str(tmp_path / "c"), 1, tree,
                     shardings={"w": NamedSharding(MANY, P("data"))})


# -- 5. the contrastive kernel's switches --------------------------------------

def _contrastive_inputs(seed=0, q=3, n=24, p=16):
    rng = np.random.default_rng(seed)
    z_q = rng.normal(size=(q, p)).astype(np.float32)
    z_d = rng.normal(size=(q, n, p)).astype(np.float32)
    z_q /= np.linalg.norm(z_q, axis=-1, keepdims=True)
    z_d /= np.linalg.norm(z_d, axis=-1, keepdims=True)
    y = (rng.random((q, n)) < 0.4).astype(np.float32)
    return z_q, z_d, y


def test_contrastive_switches_are_jaxs():
    """``losses(force_ref=True)`` is the plain version and launches
    nothing, its default the kernel's operator (the plain version on the
    CPU), both equal to JAX's ``losses``; ``phase2_loss(impl="ref")`` is
    plain autograd of the plain objective (value and gradient against
    JAX's ``impl="ref"``, no launch), ``"auto"`` the kernel's Function,
    ``"kernel"`` raises for CPU latents; ``interpret`` is refused."""
    z_q, z_d, y = _contrastive_inputs()
    tq, td, ty = (torch.tensor(a) for a in (z_q, z_d, y))
    tau, lam = 0.1, 0.5
    want = np.asarray(jax.vmap(lambda a, b, c: j_c_ops.losses(
        a, b, c, tau, lam, force_ref=True))(jnp.asarray(z_q),
                                            jnp.asarray(z_d), jnp.asarray(y)))
    plain = c_ops.losses(tq, td, ty, tau, lam, force_ref=True)
    assert torch.equal(plain, c_ref.ref_losses(tq, td, ty, tau, lam))
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-6)
    assert _kernel_ops(lambda: c_ops.losses(tq, td, ty, tau, lam,
                                            force_ref=True)) == 0
    assert _kernel_ops(lambda: c_ops.losses(tq, td, ty, tau, lam)) == 1
    np.testing.assert_allclose(c_ops.losses(tq, td, ty, tau, lam).numpy(),
                               want, rtol=1e-5, atol=1e-6)

    def jax_phase2(zd):
        return jnp.sum(jax.vmap(lambda a, b, c: j_c_ops.phase2_loss(
            a, b, c, tau, lam, impl="ref"))(jnp.asarray(z_q), zd,
                                            jnp.asarray(y)))
    jval, jgrad = jax.value_and_grad(jax_phase2)(jnp.asarray(z_d))
    for impl, launches in (("ref", 0), ("auto", 1)):
        zd = td.clone().requires_grad_(True)
        assert _kernel_ops(lambda: c_ops.phase2_loss(
            tq, zd, ty, tau, lam, impl=impl)) == launches
        val = c_ops.phase2_loss(tq, zd, ty, tau, lam, impl=impl).sum()
        (grad,) = torch.autograd.grad(val, zd)
        np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="on the CPU"):
        c_ops.phase2_loss(tq, td, ty, tau, lam, impl="kernel")
    with pytest.raises(ValueError, match="interpret mode, which the port "
                                         "has no counterpart of"):
        c_ops.phase2_loss(tq, td, ty, tau, lam, impl="interpret")
    with pytest.raises(ValueError, match="unknown contrastive impl"):
        c_ops.phase2_loss(tq, td, ty, tau, lam, impl="pallas")
    with pytest.raises(ValueError, match="interpret mode"):
        c_ops.losses(tq, td, ty, tau, lam, interpret=True)
    with pytest.raises(ValueError, match="interpret mode, which the port "
                                         "has no counterpart of"):
        ProxyConfig(contrastive_impl="interpret")


def test_proxy_trainer_passes_contrastive_impl():
    """The proxy trainer's phase-2 loss takes ``ProxyConfig.
    contrastive_impl`` as its ``impl``, as JAX's ``_loss_phase2`` does:
    ``"ref"`` launches nothing, ``"auto"`` the kernel once a step, and
    both give the same loss and gradients; ``"kernel"`` raises on CPU
    latents."""
    rng = np.random.default_rng(4)
    base = ProxyConfig(embed_dim=16, hidden_dim=32, latent_dim=32,
                       proj_dim=8)
    params = encoder_init(torch.Generator().manual_seed(0), base)
    e_qs = torch.tensor(rng.normal(size=(1, 16)).astype(np.float32))
    xb = torch.tensor(rng.normal(size=(1, 12, 16)).astype(np.float32))
    yb = torch.tensor((rng.random((1, 12)) < 0.5).astype(np.float32))
    got = {}
    for impl, launches in (("ref", 0), ("auto", 1)):
        cfg = dataclasses.replace(base, contrastive_impl=impl)
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        assert _kernel_ops(lambda: t_trainer._loss_phase2(
            live, e_qs, xb, yb, cfg)) == launches
        loss = t_trainer._loss_phase2(live, e_qs, xb, yb, cfg).sum()
        got[impl] = (loss.item(), torch.autograd.grad(
            loss, live["layers"]["l0"]["w"]))
    np.testing.assert_allclose(got["ref"][0], got["auto"][0], rtol=1e-6)
    torch.testing.assert_close(got["ref"][1], got["auto"][1], rtol=1e-5,
                               atol=1e-7)
    with pytest.raises(ValueError, match="on the CPU"):
        t_trainer._loss_phase2(params, e_qs, xb, yb, dataclasses.replace(
            base, contrastive_impl="kernel"))


# -- 6. signatures and a return as in JAX --------------------------------------

def test_attn_apply_returns_y_and_kv_or_none_and_takes_causal_skip():
    """``attn_apply`` returns ``(y, kv or None)`` as JAX's does, and takes
    ``causal_skip`` (as does ``flash_attention``), which changes no
    value."""
    cfg = dataclasses.replace(get_smoke_arch("llama3-8b"), dtype="float32")
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), dtype="float32")
    jp = j_attn.attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(5).normal(size=(2, 11, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(11)
    for impl in t_attn.IMPLS:
        for kv_out in (False, True):
            want = j_attn.attn_apply(jp, jnp.asarray(x), jcfg,
                                     positions=jnp.asarray(pos),
                                     kv_out=kv_out, causal_skip=True)
            outs = [t_attn.attn_apply(tp, torch.tensor(x), cfg,
                                      positions=torch.tensor(pos),
                                      impl=impl, kv_out=kv_out,
                                      causal_skip=skip)
                    for skip in (False, True)]
            for got in outs:
                assert isinstance(got, tuple) and len(got) == 2
                assert (got[1] is None) == (want[1] is None) == (not kv_out)
                np.testing.assert_allclose(got[0].numpy(),
                                           np.asarray(want[0]), rtol=1e-5,
                                           atol=1e-5)
            assert torch.equal(outs[0][0], outs[1][0])
    q = torch.tensor(x[:, :, :32]).reshape(2, 11, 2, 16)
    assert torch.equal(
        t_attn.flash_attention(q, q, q, 0.25, causal=True, causal_skip=True),
        t_attn.flash_attention(q, q, q, 0.25, causal=True))
    for fn in (t_attn.attn_apply, t_attn.flash_attention):
        assert "causal_skip" in inspect.signature(fn).parameters


def test_proxy_trainer_entry_points_take_method():
    """``train_proxy``, ``train_proxy_variant`` and
    ``_train_mlp_classifier`` take JAX's ``method`` with its default;
    "scan" and "steps" run the same loop (bitwise equal params), another
    value raises as in JAX."""
    for name in ("train_proxy", "train_proxy_variant",
                 "_train_mlp_classifier"):
        want = inspect.signature(getattr(j_trainer, name)).parameters
        got = inspect.signature(getattr(t_trainer, name)).parameters
        assert got["method"].default == want["method"].default == "scan"
    cfg = ProxyConfig(embed_dim=16, hidden_dim=32, latent_dim=32,
                      proj_dim=8, phase1_steps=3, phase2_steps=3,
                      batch_size=16)
    rng = np.random.default_rng(6)
    embeds = rng.normal(size=(40, 16)).astype(np.float32)
    labels = (rng.random(40) < 0.4).astype(np.int32)
    runs = {m: [t_trainer.train_proxy(1, embeds[0], embeds, labels, cfg,
                                      device="cpu", method=m).params,
                t_trainer.train_proxy_variant(1, embeds[0], embeds, labels,
                                              cfg, "qsim", device="cpu",
                                              method=m),
                t_trainer._train_mlp_classifier(1, embeds, labels, cfg,
                                                device="cpu", method=m)]
            for m in ("scan", "steps")}
    for a, b in zip(runs["scan"], runs["steps"]):
        for (_, x), (_, y) in zip(ckpt.flatten_with_paths(a),
                                  ckpt.flatten_with_paths(b)):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unknown method"):
        t_trainer.train_proxy(1, embeds[0], embeds, labels, cfg,
                              device="cpu", method="loop")
    with pytest.raises(ValueError, match="unknown method"):
        t_trainer.train_proxy_variant(1, embeds[0], embeds, labels, cfg,
                                      "mlp", device="cpu", method="loop")


def test_encoder_init_takes_dtype():
    """``encoder_init(generator, cfg, dtype=torch.float32)`` as JAX's
    ``encoder_init(key, cfg, dtype=jnp.float32)``: float32 by default
    (the same draws as before the argument), every leaf of ``dtype``
    otherwise, the weights the float32 draws cast."""
    assert inspect.signature(j_encoder.encoder_init).parameters[
        "dtype"].default == jnp.float32
    assert inspect.signature(encoder_init).parameters[
        "dtype"].default == torch.float32
    cfg = ProxyConfig(embed_dim=16, hidden_dim=32, latent_dim=32, proj_dim=8)
    f32 = encoder_init(torch.Generator().manual_seed(2), cfg)
    bf16 = encoder_init(torch.Generator().manual_seed(2), cfg,
                        dtype=torch.bfloat16)
    jf = j_encoder.encoder_init(jax.random.PRNGKey(0), JProxy(
        embed_dim=16, hidden_dim=32, latent_dim=32, proj_dim=8),
        dtype=jnp.bfloat16)
    want = {k for k, _ in ckpt.flatten_with_paths(jax.tree.map(
        np.asarray, jf))}
    assert {k for k, _ in ckpt.flatten_with_paths(bf16)} == want
    for (_, a), (_, b) in zip(ckpt.flatten_with_paths(f32),
                              ckpt.flatten_with_paths(bf16)):
        assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), b)
