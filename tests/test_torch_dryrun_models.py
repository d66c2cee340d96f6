"""The cost counter (``repro_torch.launch.hlo_analysis``) on the SMOKE
models, against the JAX package's analyzer and against itself.

JAX's forwards are compiled as ``jax.jit`` compiles them, apart from
zamba2-2.7b's: there XLA's ``fusion`` pass duplicates cheap elementwise
producers into each consumer fusion, and ``analyze_hlo_text`` counts
every copy (its depthwise conv feeds three slices, so its multiplies
count several times: 6.2% of the SMOKE forward's FLOPs). Eager PyTorch
runs each operator once, so zamba2 is held to the compile without that
pass, and a test of its own pins the cause: the products equal under
both compiles and the port's, the gap there only with the pass on.

Bars: the seven families' SMOKE forwards within 5% of JAX's FLOPs; a
train step's products 3 to 5 times its forward's (remat "full"); the
same step's operators, FLOPs, bytes, transcendentals and peak equal on
meta and CPU tensors (the meta count scales one microbatch of two); the
scaled microbatch count equal to the full one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke_arch as j_smoke
from repro.launch.hlo_analysis import (analyze_computation,
                                       analyze_hlo_text, parse_hlo)
from repro.models import build_model as j_build_model
from repro_torch.config import InputShape, OptimizerConfig, get_smoke_arch
from repro_torch.launch import hlo_analysis, steps
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.models.common import param_specs
from repro_torch.optimizer import adamw
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

META = torch.device("meta")
B, S = 4, 64
FAMILIES = ["smollm-360m", "llama3-8b", "rwkv6-7b", "qwen3-moe-30b-a3b",
            "zamba2-2.7b", "gemma3-12b", "whisper-base"]
FIELDS = ("ops", "flops", "product_flops", "bytes", "transcendental")
# families whose default compile duplicates producers into fusions
DUPLICATING = {"zamba2-2.7b"}
NO_FUSION = {"xla_disable_hlo_passes": "fusion"}
# the HLO operators that hold products, and those that call computations
PRODUCT_HLO = {"dot", "convolution", "while", "fusion", "call",
               "async-start", "conditional"}


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _hlo(fn, *sds, fusion=True):
    """The jitted function's compiled HLO text, with or without XLA's
    ``fusion`` pass."""
    lowered = jax.jit(fn).lower(*sds)
    return (lowered.compile() if fusion
            else lowered.compile(NO_FUSION)).as_text()


def _hlo_products(text):
    """``analyze_hlo_text``'s FLOPs of the products alone: the HLO with
    every operator but the products and the calls into them dropped."""
    comps, entry = parse_hlo(text)
    for comp in comps.values():
        comp.instrs = [i for i in comp.instrs if i.opcode in PRODUCT_HLO]
    return analyze_computation(entry, comps, {}).flops


def _same(a, b, fields=FIELDS):
    assert {f: getattr(a, f) for f in fields} == \
        {f: getattr(b, f) for f in fields}


# -- SMOKE models against the JAX analyzer ------------------------------------

def _forwards(arch, dtype=None):
    """(port forward, its meta args, JAX forward, its abstract args)."""
    jcfg, tcfg = j_smoke(arch), get_smoke_arch(arch)
    kw = {} if tcfg.is_encdec else {"rwkv_mode": "factored",
                                    "moe_dispatch": "onehot"}
    jm, tm = j_build_model(jcfg, **kw), build_model(tcfg, **kw)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tokens = (jax.ShapeDtypeStruct((B, S), jnp.int32),
              _meta((B, S), torch.int32))
    if tcfg.is_encdec:
        jd, td = jnp.dtype(jcfg.dtype), getattr(torch, tcfg.dtype)
        frames = (jax.ShapeDtypeStruct((B, S, jcfg.d_model), jd),
                  _meta((B, S, tcfg.d_model), td))
        return (tm.forward, (param_specs(tm), frames[1], tokens[1]),
                jm.forward, (jp, frames[0], tokens[0]))
    return (tm.forward, (param_specs(tm), tokens[1]), jm.forward,
            (jp, tokens[0]))


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_forward_flops_within_5pct_of_the_jax_analyzer(arch):
    fn, args, jfn, jargs = _forwards(arch)
    rep = analyze_step(fn, *args)
    want = analyze_hlo_text(
        _hlo(jfn, *jargs, fusion=arch not in DUPLICATING)).flops
    assert abs(rep.flops / want - 1) < 0.05, (rep.flops, want)


def test_zamba2_gap_is_the_fusion_pass_duplicating_producers():
    """Under the default compile the port reads more than 5% under JAX,
    and the gap is the ``fusion`` pass's copies alone: JAX's product
    FLOPs are the same under both compiles and equal the port's, and
    without the pass the totals agree within 5%."""
    fn, args, jfn, jargs = _forwards("zamba2-2.7b")
    rep = analyze_step(fn, *args)
    fused, unfused = _hlo(jfn, *jargs), _hlo(jfn, *jargs, fusion=False)
    assert _hlo_products(fused) == _hlo_products(unfused) \
        == rep.product_flops
    assert rep.flops / analyze_hlo_text(fused).flops < 0.95
    assert abs(rep.flops / analyze_hlo_text(unfused).flops - 1) < 0.05


def _train_plan(arch, microbatches=None, **cfg_kw):
    """A SMOKE train plan on a 1 x 1 CPU mesh: its step traces meta
    arguments and runs CPU tensors."""
    cfg = dataclasses.replace(get_smoke_arch(arch), **cfg_kw)
    return cfg, steps.make_train_plan(
        cfg, InputShape("t", seq_len=S, global_batch=B, kind="train"),
        make_test_mesh(1, 1, device="cpu"), microbatches=microbatches)


@pytest.mark.parametrize("arch", ["smollm-360m", "llama3-8b", "gemma3-12b",
                                  "whisper-base"])
def test_train_step_products_are_3_to_5_forwards(arch):
    """A backward of twice the forward's products, plus the remat's
    recompute of the forward."""
    cfg, plan = _train_plan(arch, remat="full")
    train = analyze_step(plan.step_fn, *plan.arg_sds)
    fn, args, _, _ = _forwards(arch)
    fwd = analyze_step(fn, *args)
    assert 3 < train.product_flops / fwd.product_flops < 5


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-7b",
                                  "qwen3-moe-30b-a3b", "whisper-base"])
def test_a_step_counts_the_same_on_meta_and_on_the_cpu(arch):
    cfg, plan = _train_plan(arch, microbatches=2)
    meta = analyze_step(plan.step_fn, *plan.arg_sds)
    cpu = analyze_step(plan.step_fn, *_cpu_args(cfg, plan))
    _same(meta, cpu, FIELDS + ("peak_bytes",))


def _cpu_args(cfg, plan):
    """The train plan's (state, batch) as CPU tensors, from a seed."""
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    state = (params, adamw.init(OptimizerConfig(), params))
    rng = np.random.default_rng(0)
    batch = {k: (torch.tensor(rng.integers(0, cfg.vocab_size, v.shape),
                              dtype=v.dtype) if v.dtype == torch.int32
                 else torch.randn(v.shape, dtype=v.dtype))
             for k, v in plan.arg_sds[1].items()}
    return state, batch


def test_scaled_microbatches_count_as_the_full_step():
    """A counter of meta arguments runs one microbatch of four and scales
    it, to the count and peak of all four run on CPU tensors. A counter
    of real tensors never scales: every trip runs."""
    cfg, plan = _train_plan("smollm-360m", microbatches=4)
    scaled = analyze_step(plan.step_fn, *plan.arg_sds)
    full = analyze_step(plan.step_fn, *_cpu_args(cfg, plan))
    _same(full, scaled, FIELDS + ("peak_bytes",))
    assert full.ops > 4 * 100
    assert list(hlo_analysis.trips(3)) == [0, 1, 2]
    with hlo_analysis.CostCounter(_meta((2,))):
        assert list(hlo_analysis.trips(3)) == [0]
    with hlo_analysis.CostCounter((_meta((2,)), torch.zeros(2))):
        assert list(hlo_analysis.trips(3)) == [0, 1, 2]
