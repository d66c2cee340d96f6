"""The dry run and roofline as torch analogs
(``repro_torch.launch.{hlo_analysis, roofline, dryrun}``) against the
JAX package's functions.

The JAX dry run (``repro.launch.dryrun``) needs 512 host devices and its
own test fails in the JAX package (``test_dryrun_cellplan_on_test_mesh``),
so the port is held to the reference functions: ``analyze_hlo_text`` of
jitted JAX functions without a mesh, ``model_flops``, ``summarize``,
``render_table``, ``load_cells`` and the cells' skip reasons.
``repro.launch.dryrun`` is never imported here (it sets ``XLA_FLAGS``).

The SMOKE models' counts are tests/test_torch_dryrun_models.py.

Bars: the analyzer cases exact, or within 1% of JAX; a kernel call one
operator, charged alike on meta and CPU tensors; ``model_flops`` and
``summarize`` equal (the roofline fraction scales by 197e12 / 989e12,
the two chips' peaks); the full-size cells' keys and argument bytes
exact, the skipped cells' reasons JAX's word for word.
"""
import ast
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.shapes import skip_reason as j_skip_reason
from repro.launch import roofline as j_roofline
from repro.launch.hlo_analysis import analyze_hlo_text
from repro_torch.checkpoint import flatten_with_paths
from repro_torch.config import (ALL_SHAPES, SHAPES_BY_NAME, InputShape,
                                get_arch, get_smoke_arch, list_archs)
from repro_torch.kernels import _cost
from repro_torch.kernels.contrastive import ops as c_ops
from repro_torch.kernels.flash_attention import ops as f_ops
from repro_torch.kernels.fused_scoring import ops as s_ops
from repro_torch.kernels.wkv6 import ops as w_ops
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.hlo_analysis import CostCounter, analyze_step
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import build_model
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
B, S = 4, 64
CELLS = [(a, s.name) for a in list_archs() for s in ALL_SHAPES]
FIELDS = ("ops", "flops", "product_flops", "bytes", "transcendental")


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _jax_report(fn, *sds):
    return analyze_hlo_text(jax.jit(fn).lower(*sds).compile().as_text())


def _same(a, b, fields=FIELDS):
    assert {f: getattr(a, f) for f in fields} == \
        {f: getattr(b, f) for f in fields}


# -- the JAX analyzer's cases (tests/test_sharding_and_analysis.py) ----------

def test_loop_of_products_is_exact_and_within_1pct_of_the_jax_scan():
    """Eager runs every trip of a Python loop: 8 tanh(c @ w_i)."""
    def f(c, w):
        for i in range(8):
            c = torch.tanh(c @ w[i])
        return c

    rep = analyze_step(f, _meta((64, 128)), _meta((8, 128, 128)))
    assert rep.flops == 8 * (2 * 64 * 128 * 128 + 64 * 128)
    assert rep.transcendental == 8 * 64 * 128
    assert rep.ops == 16 and rep.unknown_trip_whiles == 0

    def jf(x, w):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        return jax.lax.scan(body, x, w)[0]

    j = _jax_report(jf, jax.ShapeDtypeStruct((64, 128), jnp.float32),
                    jax.ShapeDtypeStruct((8, 128, 128), jnp.float32))
    assert abs(rep.flops - j.flops) / j.flops < 0.01


def test_matmul_is_exact():
    rep = analyze_step(torch.matmul, _meta((128, 256)), _meta((256, 512)))
    assert rep.flops == rep.product_flops == 2 * 128 * 256 * 512
    assert rep.bytes == 4 * (128 * 256 + 256 * 512 + 128 * 512)
    j = _jax_report(jnp.matmul, jax.ShapeDtypeStruct((128, 256), jnp.float32),
                    jax.ShapeDtypeStruct((256, 512), jnp.float32))
    assert rep.flops == j.flops


def test_tanh_counts_one_flop_and_one_transcendental_an_element():
    rep = analyze_step(torch.tanh, _meta((4, 4)))
    assert (rep.flops, rep.transcendental) == (16, 16)
    j = analyze_hlo_text("""
ENTRY %main.1 (a: f32[4,4]) -> f32[4,4] {
  %a = f32[4,4]{1,0} parameter(0)
  ROOT %t = f32[4,4]{1,0} tanh(%a)
}
""")
    assert (rep.flops, rep.transcendental) == (j.flops, j.transcendental)


def test_views_are_free_and_the_peak_counts_each_storage_once():
    x = torch.ones(1000)
    with CostCounter((x,)) as c:
        for _ in range(3):
            y = x * 2                     # 4000 B, freed each trip
            z = y.view(10, 100).t()       # views: free, same storage
            del y, z
        keep = x + 1
    rep = c.report()
    assert rep.ops == 4 and rep.bytes == 4 * 8000
    assert rep.peak_bytes == 4000 and rep.argument_bytes == 4000
    assert c.live_bytes == 4000 and keep.shape == (1000,)


# -- kernels: one operator, charged at the kernel's work on every device ------

def _kernel_calls(dev, grad=False):
    """name -> (a call of the kernel's wrapper on ``dev``, its outputs'
    shapes); with ``grad``, a float input of each requires grad."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g).to(dev)
    q, k = r(2, 128, 4, 16), r(2, 128, 2, 16)
    lw = -torch.rand((1, 2, 16, 2, 8), generator=g).to(dev)
    wkv = [r(1, 2, 16, 2, 8) for _ in range(3)] + [lw.cumsum(2), lw, r(2, 8)]
    con = [r(3, 16), r(3, 32, 16), (r(3, 32) > 0).float()]
    mlp = [r(50, 32), r(32, 128), r(128), r(128, 128), r(128), r(128, 64),
           r(64), torch.nn.functional.normalize(r(3, 64), dim=1)]
    for t in (q, wkv[0], con[1], mlp[0]):
        t.requires_grad_(grad)
    return {
        "flash": (lambda: f_ops.flash_attention_fwd(
            q, k, k, scale=0.25, causal=True, window=48, return_lse=True),
                  [(2, 128, 4, 16), (2, 4, 128)]),
        "wkv6": (lambda: w_ops.wkv6_intra_chunk(*wkv),
                 [(1, 2, 16, 2, 8), (1, 2, 2, 8, 8), (1, 2, 2, 8),
                  (1, 2, 16, 2, 8)]),
        "contrastive": (lambda: c_ops.contrastive_losses(*con, 0.07, 0.2),
                        [(3, 4)]),
        "fused": (lambda: s_ops.fused_scores_multi(*mlp), [(50, 3)]),
    }


@pytest.mark.parametrize("name", ["flash", "wkv6", "contrastive", "fused"])
def test_a_kernel_call_is_one_operator_charged_alike_on_meta_and_cpu(name):
    """On meta tensors the wrapper returns empty outputs of the kernel's
    shapes; on both devices the counter sees one operator, charged at
    the kernel's own work, and none of the plain version's ops."""
    reports = {}
    for dev in (META, torch.device("cpu")):
        call, shapes = _kernel_calls(dev)[name]
        with CostCounter() as c:
            out = call()
        out = out if isinstance(out, tuple) else (out,)
        assert [tuple(t.shape) for t in out] == shapes
        assert all(t.device.type == dev.type for t in out)
        reports[dev.type] = c.report()
    assert reports["meta"].ops == 1
    _same(reports["meta"], reports["cpu"])
    assert reports["meta"].product_flops > 0


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


# each wrapper's module and the name of its torch.library operator there
OPERATORS = {"flash": (f_ops, "_flash_op"), "wkv6": (w_ops, "_wkv6_op"),
             "contrastive": (c_ops, "_contrastive_op"),
             "fused": (s_ops, "_fused_op")}


@pytest.mark.parametrize("name", ["flash", "wkv6", "contrastive", "fused"])
def test_a_kernel_call_skips_its_operator_outside_the_counter(name,
                                                              monkeypatch):
    """Outside a dispatch mode a CPU call runs the operator's body with no
    operator dispatch on the host, and gives the outputs the operator
    gives under the counter; a meta call always goes through the
    operator. A CPU call that needs a gradient runs the differentiable
    plain version (on the card it raises: tests/test_torch_cuda.py)."""
    module, attr = OPERATORS[name]
    op, calls = getattr(module, attr), []
    monkeypatch.setattr(module, attr,
                        lambda *a: calls.append(a) or op(*a))
    call, _ = _kernel_calls(torch.device("cpu"))[name]
    direct = _tuple(call())
    assert calls == []
    with CostCounter() as counter:
        counted = _tuple(call())
    assert len(calls) == 1 and counter.report().ops == 1
    assert all(torch.equal(a, b) for a, b in zip(direct, counted))
    meta_call, _ = _kernel_calls(META)[name]
    meta_call()
    assert len(calls) == 2
    grad_call, _ = _kernel_calls(torch.device("cpu"), grad=True)[name]
    with torch.enable_grad():
        out = _tuple(grad_call())
    assert out[0].grad_fn is not None


def test_flash_is_charged_for_the_tiles_it_visits():
    """Causal and windowed calls skip the K/V tiles no row of a 64-row
    query tile sees; at 32,768 keys the charge is the bound column's
    8.8e12 FLOP (llama3-8b's prefill call)."""
    full = f_ops.visited_pairs(512, 512, causal=False, window=0,
                               q_offset=0, tile=64)
    causal = f_ops.visited_pairs(512, 512, causal=True, window=0,
                                 q_offset=0, tile=64)
    window = f_ops.visited_pairs(512, 512, causal=True, window=64,
                                 q_offset=0, tile=64)
    assert full == 512 * 512
    assert causal == 64 * 64 * (8 * 9 // 2)
    assert window == 64 * 64 * (1 + 7 * 2)
    w = f_ops.flash_work(_meta((1, 32768, 32, 128), torch.bfloat16),
                         _meta((1, 32768, 8, 128), torch.bfloat16),
                         _meta((1, 32768, 8, 128), torch.bfloat16),
                         0.1, True, 0, 0, False)
    assert w.products == 4 * 32 * 128 * 64 * 64 * (512 * 513 // 2)
    assert abs(w.products / 8.8e12 - 1) < 0.01
    assert _cost.cost_of(torch.ops.repro_torch.flash_attention_fwd.default) \
        is f_ops.flash_work


# -- roofline against the JAX module ------------------------------------------

def test_model_flops_equal_jax_for_all_40_cells():
    assert len(CELLS) == 40
    for arch, shape in CELLS:
        assert roofline.model_flops(arch, shape) == \
            j_roofline.model_flops(arch, shape), (arch, shape)


def _cell(arch, shape, mesh, rng, status="ok"):
    """A cell dict in the JAX dry run's layout with random figures."""
    if status != "ok":
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": status, "reason": "because"}
    t = rng.uniform(1e-4, 10, size=3)
    t[2] = t[2] if rng.random() < 0.3 else 0.0
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "chips": 512 if mesh == "multi" else 256,
            "analyzer": {"flops_per_device": float(rng.uniform(1e12, 1e16))},
            "roofline": {"t_compute_s": t[0], "t_memory_s": t[1],
                         "t_collective_s": t[2],
                         "dominant": ["compute", "memory", "collective"][
                             int(np.argmax(t))]},
            "sharding_fallbacks": ["x"] * int(rng.integers(0, 4)),
            "memory": {"temp_bytes_per_device":
                       None if rng.random() < 0.2 else
                       float(rng.uniform(0, 1e11))}}


def _cells(seed=0):
    rng = np.random.default_rng(seed)
    return [_cell(a, s, m, rng, "ok" if i % 7 else "skipped")
            for i, (a, s) in enumerate(CELLS) for m in ("single", "multi")]


def test_summarize_and_render_table_match_jax():
    ratio = j_roofline.PEAK_FLOPS / roofline.PEAK_FLOPS
    assert ratio == 197e12 / 989e12
    rows, jrows = [], []
    for cell in _cells():
        got, want = roofline.summarize(cell), j_roofline.summarize(cell)
        if want is None:
            assert got is None
            continue
        assert got["nudge"] == roofline.NUDGES[want["dominant"]]
        assert got["roofline_fraction"] == pytest.approx(
            want["roofline_fraction"] * ratio, rel=1e-12)
        strip = lambda r: {k: v for k, v in r.items()
                           if k not in ("roofline_fraction", "nudge")}
        assert strip(got) == strip(want)
        rows.append(got)
        jrows.append(want)
    assert set(roofline.NUDGES) == set(j_roofline.NUDGES)
    table, jtable = (r(x).splitlines() for r, x in
                     ((roofline.render_table, rows),
                      (j_roofline.render_table, jrows)))
    assert len(table) == len(jtable) == len(rows) + 2
    frac = table[0].split("|").index(" roofline-frac ")
    for a, b in zip(table, jtable):
        a, b = a.split("|"), b.split("|")
        assert a[:frac] + a[frac + 1:] == b[:frac] + b[frac + 1:]
    # the --memory table: render_table's rows, then the memory columns
    ok = [c for c in _cells() if c["status"] == "ok"]
    for c in ok:
        c["memory"]["argument_bytes_per_device"] = 4e9
    mem = roofline.render_memory_table(ok).splitlines()
    assert len(mem) == len(table)
    for a, b in zip(mem[2:], table[2:]):
        assert a.startswith(b)
        assert a.split("|")[-5].strip() == "4.00"


def test_load_cells_reads_the_jax_layout_with_tags(tmp_path):
    for i, cell in enumerate(_cells(1)[:12]):
        stem = f"{cell['arch']}__{cell['shape']}__{cell['mesh']}"
        (tmp_path / f"{stem}.json").write_text(json.dumps(cell))
        if i % 3 == 0:
            (tmp_path / f"{stem}__v2.json").write_text(json.dumps(
                dict(cell, tag="v2")))
    for tag in ("", "v2", "nope"):
        assert roofline.load_cells(str(tmp_path), tag) == \
            j_roofline.load_cells(str(tmp_path), tag)
    assert len(roofline.load_cells(str(tmp_path), "v2")) == 4


# -- full-size cells on the meta device ---------------------------------------

def _jax_result_keys():
    """The keys (nested under "memory", "analyzer", ...) of the result
    dict ``repro.launch.dryrun.run_cell`` builds, read from its source."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "result"
                        for t in node.targets)):
            return {k.value: ({kk.value for kk in v.keys}
                              if isinstance(v, ast.Dict) else None)
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no result dict in the JAX dry run")


def _hand_bytes(tree, shardings, mesh):
    total = 0
    for (path, t), (_, sh) in zip(flatten_with_paths(tree),
                                  flatten_with_paths(shardings)):
        n = t.element_size()
        for i, dim in enumerate(t.shape):
            axes = sh.spec[i] if i < len(sh.spec) else None
            axes = (axes,) if isinstance(axes, str) else (axes or ())
            n *= dim // math.prod(mesh.shape[a] for a in axes)
        total += n
    return total


@pytest.mark.parametrize("arch,shape", [("smollm-360m", "train_4k"),
                                        ("llama3-8b", "prefill_32k"),
                                        ("gemma3-12b", "long_500k")])
def test_full_size_cell_on_meta(arch, shape):
    res = dryrun.run_cell(arch, shape, multi_pod=False)
    assert res["status"] == "ok"
    for key, sub in _jax_result_keys().items():
        assert key in res, key
        if sub is not None:
            assert sub <= set(res[key]), (key, sub - set(res[key]))
    assert res["per_device"] == "even split until multi-card"
    assert res["xla_cost_analysis_flops_per_device"] is None
    assert res["timings"]["compile_s"] == 0
    assert res["chips"] == 256 and res["analyzer"]["ops"] > 0
    mesh = make_production_mesh()
    plan = steps.make_plan(get_arch(arch), SHAPES_BY_NAME[shape], mesh)
    state, batch = plan.arg_sds
    sh_state, sh_batch = plan.arg_shardings
    if SHAPES_BY_NAME[shape].kind == "train":
        params, opt = state
        want = (_hand_bytes(params, sh_state[0], mesh)
                + 2 * _hand_bytes(opt.mu, sh_state[1].mu, mesh) + 4
                + _hand_bytes(batch, sh_batch, mesh))
    else:
        want = (_hand_bytes(state, sh_state, mesh)
                + _hand_bytes(batch, sh_batch, mesh))
    assert res["memory"]["argument_bytes_per_device"] == want
    assert 0 < res["memory"]["temp_bytes_per_device"]
    r = res["roofline"]
    assert r["t_compute_s"] == pytest.approx(
        res["analyzer"]["flops_per_device"] / roofline.PEAK_FLOPS)


def test_skipped_cells_carry_the_jax_reasons():
    skipped = 0
    for arch, shape in CELLS:
        reason = j_skip_reason(arch, SHAPES_BY_NAME[shape])
        if reason is None:
            continue
        for multi in (False, True):
            res = dryrun.run_cell(arch, shape, multi_pod=multi)
            assert (res["status"], res["reason"]) == ("skipped", reason)
        skipped += 1
    assert skipped == 7


def test_a_real_step_on_a_mesh_of_many_devices_still_raises():
    """Meta tensors trace over the abstract 16 x 16 mesh; real ones have
    no device there, and no device work is hidden."""
    cfg = get_smoke_arch("llama3-8b")
    plan = steps.make_plan(cfg, InputShape("p", S, B, "prefill"),
                           make_production_mesh())
    plan.step_fn(*plan.arg_sds)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    tokens = {"tokens": torch.ones((B, S), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="more than one device"):
        plan.step_fn(params, tokens)
    one = steps.make_plan(cfg, InputShape("p", S, B, "prefill"),
                          make_test_mesh(1, 1, device="cpu"))
    logits, _ = one.step_fn(params, tokens)
    assert logits.shape == (B, cfg.padded_vocab_size)
