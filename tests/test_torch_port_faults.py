"""The port's four repaired faults against the JAX package (one test or
more for each):

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
   ``mesh``/``shardings`` (one device accepted, more refused).
"""
import dataclasses
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import get_smoke_arch as j_smoke
from repro.models import build_model as j_build_model
from repro.optimizer import adamw as j_adamw
from repro_torch import checkpoint as ckpt
from repro_torch.config import (CascadeConfig, InputShape, OptimizerConfig,
                                ProxyConfig, TrainConfig, get_smoke_arch)
from repro_torch.core import scoring as t_scoring
from repro_torch.core.encoder import encoder_init
from repro_torch.core.pipeline import ScaleDocPipeline
from repro_torch.data import make_corpus
from repro_torch.data.loader import device_batch
from repro_torch.engine import ScaleDocEngine
from repro_torch.engine.executor import ScoringExecutor
from repro_torch.kernels.flash_attention import ops as f_ops
from repro_torch.kernels.flash_attention import ref as f_ref
from repro_torch.kernels.fused_scoring import ops as s_ops
from repro_torch.kernels.wkv6 import ops as w_ops
from repro_torch.kernels.wkv6 import ref as w_ref
from repro_torch.launch.hlo_analysis import CostCounter
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models import EncDecLM, TransformerLM, build_model
from repro_torch.models import params_from_jax
from repro_torch.models.common import tree_map
from repro_torch.optimizer import adamw
from repro_torch.runtime.serve_loop import EmbeddingService
from repro_torch.runtime.train_loop import Trainer
from repro_torch.sharding.rules import NamedSharding, P
from torch_jax_state import no_jax_constrainer  # noqa: F401

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
