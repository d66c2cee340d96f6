"""The dry run (``repro.launch.dryrun``): every (architecture x input
shape) cell on the production meshes (16 x 16 single pod, 2 x 16 x 16
multi-pod), its memory and cost, and the roofline terms
(``launch.roofline``'s inputs).

The JAX module lowers and compiles each cell's step for 256 or 512
devices and reads XLA's memory analysis and the HLO. Eager PyTorch
compiles nothing: here each cell's plan (``launch.steps.make_plan``) is
built on the abstract production mesh (``launch.mesh``), and its step
runs once on the plan's own meta arguments (``arg_sds``: shapes and
types, no storage) under the cost counter (``launch.hlo_analysis``),
which needs no card and no device memory at any size; a train step's
microbatches are counted once and scaled (``hlo_analysis.trips``). The
result has the JAX module's keys:

  * ``argument_bytes_per_device`` and ``output_bytes_per_device`` are
    exact: each leaf's shard shape under its ``NamedSharding``;
  * the FLOPs, bytes and temporary bytes per device are the global
    counts divided by the chips, an even split until the model-axis
    slice shards the step (``"per_device"`` says so);
  * ``xla_cost_analysis_flops_per_device``, ``code_bytes`` and
    ``hlo_text_bytes`` are None (no compiler); ``timings.lower_s`` is
    the trace's seconds and ``compile_s`` 0.

The JAX module's ``XLA_FLAGS`` line (512 host devices) has no
counterpart.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.config import SHAPES_BY_NAME, get_arch, list_archs
from repro_torch.configs.shapes import skip_reason
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import HBM_BW, ICI_BW, PEAK_FLOPS
from repro_torch.launch.steps import (default_microbatches, make_plan,
                                      needs_fsdp)
from repro_torch.sharding.rules import NamedSharding

PER_DEVICE = "even split until multi-card"


def shard_shape(shape, sharding: NamedSharding):
    """The shape of one device's shard of a tensor of ``shape``."""
    sizes = dict(sharding.mesh.shape)
    out = list(shape)
    for i, axes in enumerate(sharding.spec):
        if axes is None:
            continue
        ways = math.prod(sizes[a] for a in
                         ((axes,) if isinstance(axes, str) else axes))
        out[i] = -(-out[i] // ways)
    return tuple(out)


def _pairs(tree, shardings):
    """[(tensor, sharding)] of matching trees; the shardings lead."""
    if isinstance(shardings, NamedSharding):
        return [] if tree is None else [(tree, shardings)]
    if isinstance(shardings, dict):
        return [p for k in shardings for p in _pairs(tree[k], shardings[k])]
    return [p for t, s in zip(tree, shardings) for p in _pairs(t, s)]


def bytes_per_device(tree, shardings) -> int:
    """Bytes one device holds of ``tree`` (meta tensors) placed by
    ``shardings``."""
    return sum(math.prod(shard_shape(t.shape, s)) * t.element_size()
               for t, s in _pairs(tree, shardings))


def _scalar():
    return torch.empty((), dtype=torch.float32, device="meta")


def _outputs(plan, kind: str, out):
    """The step's outputs as meta tensors: a train step returns the
    state it was given (the AdamW step an int32 scalar) and three float32
    scalar metrics, as the JAX step does."""
    if kind != "train":
        return out
    params, opt = plan.arg_sds[0]
    return ((params, opt), {"loss": _scalar(), "grad_norm": _scalar(),
                            "lr": _scalar()})


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             causal_skip: bool = False, rule_overrides=None,
             moe_dispatch: str = "onehot", pad_heads: int = 0,
             last_logit: bool = False) -> dict:
    cfg = get_arch(arch)
    if pad_heads:
        # TP alignment: zero-padded attention heads (mathematically
        # identical outputs; +pad/nq attention params)
        up = lambda n: ((n + pad_heads - 1) // pad_heads) * pad_heads
        cfg = dataclasses.replace(cfg, num_heads=up(cfg.num_heads),
                                  num_kv_heads=up(cfg.num_kv_heads))
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    reason = skip_reason(arch, shape)
    if reason is not None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    plan = make_plan(cfg, shape, mesh, rule_overrides=rule_overrides,
                     causal_skip=causal_skip, moe_dispatch=moe_dispatch,
                     last_logit=last_logit)
    with hlo_analysis.CostCounter(plan.arg_sds) as counter:
        out = plan.step_fn(*plan.arg_sds)
    t_lower = time.time() - t0
    rep = counter.report()

    # roofline terms (totals across chips / aggregate peaks)
    t_compute = rep.flops / (chips * PEAK_FLOPS)
    t_memory = rep.bytes / (chips * HBM_BW)
    t_coll = rep.collective_bytes / (chips * ICI_BW)

    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
        "kind": shape.kind,
        "chips": chips,
        "fsdp": needs_fsdp(cfg),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "per_device": PER_DEVICE,
        "microbatches": (default_microbatches(shape, mesh, cfg)
                         if shape.kind == "train" else None),
        "memory": {
            "argument_bytes_per_device": bytes_per_device(
                plan.arg_sds, plan.arg_shardings),
            "output_bytes_per_device": bytes_per_device(
                _outputs(plan, shape.kind, out), plan.out_shardings),
            "temp_bytes_per_device": rep.peak_bytes / chips,
            "code_bytes": None,
        },
        "xla_cost_analysis_flops_per_device": None,
        "analyzer": {
            "flops_per_device": rep.flops / chips,
            "bytes_per_device": rep.bytes / chips,
            "collective_bytes_per_device": rep.collective_bytes / chips,
            "transcendental_per_device": rep.transcendental / chips,
            "unknown_trip_whiles": rep.unknown_trip_whiles,
            "ops": rep.ops,
            "product_flops_per_device": rep.product_flops / chips,
        },
        "roofline": {
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "dominant": max(
                [("compute", t_compute), ("memory", t_memory),
                 ("collective", t_coll)], key=lambda kv: kv[1])[0],
        },
        "sharding_fallbacks": plan.ruleset.fallback_report(),
        "timings": {"lower_s": t_lower, "compile_s": 0.0},
        "hlo_text_bytes": None,
    }
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: all)")
    ap.add_argument("--shape", default=None,
                    help="input shape name (default: all four)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--causal-skip", action="store_true",
                    help="accepted as the JAX module takes it; the flash "
                         "kernel skips masked tiles itself")
    ap.add_argument("--tag", default="",
                    help="suffix for the output file (perf variants)")
    ap.add_argument("--moe-dispatch", default="onehot",
                    choices=["onehot", "sort"])
    ap.add_argument("--dp-over-model", action="store_true",
                    help="small-arch mode: fold the model axis into data "
                         "parallelism (batch over data+model)")
    ap.add_argument("--last-logit", action="store_true",
                    help="prefill computes logits only at the last position")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="pad head counts up to a multiple of N "
                         "(TP alignment for awkward head counts)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="disable ZeRO/FSDP weight sharding (pure TP): "
                         "correct for <=15B params on 256 chips")
    args = ap.parse_args()

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES_BY_NAME)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                mesh_name = "multi" if multi else "single"
                tag = f"_{args.tag}" if args.tag else ""
                fn = outdir / f"{arch}__{shape_name}__{mesh_name}{tag}.json"
                if fn.exists() and not args.force:
                    print(f"[cached] {fn}")
                    continue
                print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ...",
                      flush=True)
                overrides = None
                if args.dp_over_model:
                    overrides = {"batch": ("pod", "data", "model"),
                                 "heads": None, "kv_heads": None,
                                 "mlp": None, "vocab": None,
                                 "act_vocab": None, "qkv_out": None}
                if args.no_fsdp:
                    overrides = dict(overrides or {})
                    overrides.update({"embed": None, "fsdp_embed": None})
                try:
                    res = run_cell(arch, shape_name, multi,
                                   causal_skip=args.causal_skip,
                                   rule_overrides=overrides,
                                   moe_dispatch=args.moe_dispatch,
                                   pad_heads=args.pad_heads,
                                   last_logit=args.last_logit)
                except Exception as e:  # record the failure — it's a bug
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                fn.write_text(json.dumps(res, indent=2, default=str))
                status = res["status"]
                extra = ""
                if status == "ok":
                    r = res["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" tc={r['t_compute_s']:.3e}"
                             f" tm={r['t_memory_s']:.3e}"
                             f" tx={r['t_collective_s']:.3e}"
                             f" trace={res['timings']['lower_s']:.0f}s")
                elif status == "error":
                    extra = " " + res["error"][:160]
                print(f"  -> {status}{extra}", flush=True)
    print(f"done ({failures} failures)")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
