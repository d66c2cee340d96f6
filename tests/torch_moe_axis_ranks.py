"""One SPMD rank of the MoE model-axis tests (``tests/test_torch_moe_axis.py``
on the CPU, ``tests/test_torch_cuda.py`` on the card): run as

    python tests/torch_moe_axis_ranks.py --rank R --world W --port P \\
        --data D --device cpu --params PARAMS --cases CASES --out DIR

once a rank, all ranks at once. ``PARAMS`` is a ``torch.save`` file of
each arch's JAX-drawn params as numpy trees (carried with
``models.params_from_jax``), ``CASES`` a JSON list of cases (``arch``,
``dispatch``, ``rules``: a key of ``RULES``, and ``jobs``). The ranks
start a process group (``launch.dist.init_spmd``: gloo on the CPU,
``repro_gloo`` for ranks sharing a card), build the (D, W / D) mesh and,
per case, run its jobs:

  * ``grad``: the model's ``loss_fn`` on the mesh (params placed by the
    train rules) and every leaf's gradient, gathered;
  * ``layer``: ``models.moe.moe_apply`` alone on crowded inputs
    (``layer_input``) of each of ``LAYER_SHAPES``: y, aux and the
    gradients of ``sum(y * r) + AUX_W * aux`` with respect to x and the
    router, each rank's own experts and kept pairs, and how many chunks
    it routed alone (``_route`` calls) with how many all-reduces;
  * ``trainer``: ``Trainer(cfg, tc, mesh, moe_dispatch=)`` one step from
    its own init (loss, the gathered params, mu and nu, the MoE leaves'
    own shards) and ``STEPS`` steps' losses;
  * ``plan``: the train plan at ``MICRO`` microbatches from the carried
    params (the loss, the gathered params and mu, the MoE leaves' and
    their mu's and nu's own shards);
  * ``serve``: the prefill plan (every position's logits), the model's
    prefill of ``cache_len`` slots on the placed params, the decode
    plan's steps teacher-forced on the case's tokens, and ``generate``.

Each rank writes ``DIR/rank{R}.pt``: full values (gathered: a
collective, every rank calls it) kept by rank 0, every rank's own
shards where a job keeps them, and its mesh coordinate. Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import flatten_with_paths  # noqa: E402
from repro_torch.config import (InputShape, OptimizerConfig,  # noqa: E402
                                TrainConfig, get_smoke_arch)
from repro_torch.data.loader import device_batch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.dist import init_spmd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import moe, params_from_jax  # noqa: E402
from repro_torch.models.common import param_specs, tree_map  # noqa: E402
from repro_torch.optimizer import adamw  # noqa: E402
from repro_torch.runtime.serve_loop import generate  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, grad_tree  # noqa: E402
from repro_torch.sharding.rules import (place, placements,  # noqa: E402
                                        tree_shardings)

ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")
DISPATCHES = ("onehot", "sort")
SHAPE = InputShape("tiny", seq_len=8, global_batch=4, kind="train")
OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10, schedule="constant")
STEPS = 3
MICRO = 2
# the serving case: prompt, the caches' slots, decode steps, generate's
# tokens
SERVE = dict(batch=2, prompt=8, cache_len=16, steps=3)
GEN_STEPS = 4
# the layer alone: (batch, seq) of x. "span": 16 tokens, one chunk over
# both row shards of a (2, x) mesh; "whole": 2 x 1,024, one chunk a row
# shard there
LAYER_SHAPES = {"span": (2, 8), "whole": (2, 1024)}
AUX_W = 0.25
# rule overrides: what rules_for gives the full MoE configs (FSDP), and
# the experts replicated (the rule's fallback)
RULES = {"default": None,
         "fsdp": {"embed": "data", "fsdp_embed": "data",
                  "expert_mlp": None},
         "replicated": {"experts": None}}
MOE_LEAVES = ("router", "wi", "wg", "wo")


def case_name(case: dict) -> str:
    return "{arch}/{dispatch}/{rules}".format(**case)


def batch_tokens(cfg, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size,
                        (SHAPE.global_batch, SHAPE.seq_len + 1)
                        ).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def serve_tokens(cfg) -> np.ndarray:
    rng = np.random.default_rng(11)
    return rng.integers(1, cfg.vocab_size,
                        (SERVE["batch"], SERVE["prompt"] + SERVE["steps"])
                        ).astype(np.int32)


def layer_input(cfg, router: np.ndarray, shape) -> tuple:
    """(x, r): tokens around the direction of expert 0's router column,
    so they crowd onto the same experts and a capacity factor of 1.25
    drops pairs, and the weights of the loss sum(y * r)."""
    rng = np.random.default_rng(shape[1])
    d = cfg.d_model
    u = router[:, 0] / np.linalg.norm(router[:, 0])
    x = rng.normal(size=shape + (d,)) * 0.5 + 3.0 * u
    r = rng.normal(size=shape + (d,))
    return x.astype(np.float32), r.astype(np.float32)


def full(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def local(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.detach().float().cpu().numpy()


def gathered(tree, rank: int) -> dict:
    """Every leaf gathered (a collective: every rank calls it), kept by
    rank 0."""
    got = {k: full(t) for k, t in flatten_with_paths(tree)}
    return got if rank == 0 else {}


def moe_shards(tree) -> dict:
    """The MoE leaves' own shards and placements."""
    return {k: (local(t), str(list(t.placements)))
            for k, t in flatten_with_paths(tree)
            if k.split("/")[-1] in MOE_LEAVES and "/moe/" in f"/{k}"}


def train_config(work: Path) -> TrainConfig:
    return TrainConfig(shape=SHAPE, optimizer=OptimizerConfig(**OPT),
                       checkpoint_dir=str(work), checkpoint_every=100)


def grad_job(rank, mesh, device, params, cfg, case) -> dict:
    """loss_fn and every gradient on the mesh, the params placed by the
    train rules (the Trainer's)."""
    rs = steps.rules_for(cfg, SHAPE, mesh, RULES[case["rules"]])
    model = steps.build_model_for_scale(cfg, ruleset=rs,
                                        moe_dispatch=case["dispatch"])
    sh = tree_shardings(rs, model.param_axes(), param_specs(model))
    placed = adamw.zip_map(place, params, sh)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in batch_tokens(cfg).items()}
    live = tree_map(lambda t: t.detach().requires_grad_(True), placed)
    with steps.spmd_context(mesh, steps._resolver(rs)):
        batch = steps._place_batch(batch, cfg, SHAPE, rs)
        loss = model.loss_fn(live, batch)
        grads = grad_tree(loss, live)
    return {"loss": float(full(loss)), "grads": gathered(grads, rank)}


def layer_job(rank, mesh, device, params, cfg, case) -> dict:
    """moe_apply alone on each of LAYER_SHAPES' crowded inputs."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    rs = steps.rules_for(cfg, SHAPE, mesh, RULES[case["rules"]])
    model = steps.build_model_for_scale(cfg)
    sh = tree_shardings(rs, model.param_axes(), param_specs(model))
    out = {}
    for name, shape in LAYER_SHAPES.items():
        x, r = layer_input(cfg, params["blocks"]["p0"]["moe"]["router"][0]
                           .cpu().numpy(), shape)
        xs = rs.sharding(("batch", "seq", None), x.shape)
        pm = adamw.zip_map(place, params["blocks"]["p0"]["moe"],
                           sh["blocks"]["p0"]["moe"])
        pm = tree_map(lambda t: t.detach().requires_grad_(True), pm)
        xm = place(torch.as_tensor(x, device=device), xs).requires_grad_(True)
        rm = place(torch.as_tensor(r, device=device), xs)
        calls = {"route": 0, "all_reduce": 0}
        inner_route, inner_ar = moe._route, dist.all_reduce

        def route(*a, **kw):
            calls["route"] += 1
            return inner_route(*a, **kw)

        def all_reduce(*a, **kw):
            calls["all_reduce"] += 1
            return inner_ar(*a, **kw)
        moe._route, dist.all_reduce = route, all_reduce
        try:
            with implicit_replication():
                p0 = tree_map(lambda t: t[0], pm)
                y, aux = moe.moe_apply(p0, xm, cfg, case["dispatch"])
                counted = dict(calls)
                loss = (y * rm).sum() + AUX_W * aux
                gx, gr = torch.autograd.grad(loss, (xm, pm["router"]))
        finally:
            moe._route, dist.all_reduce = inner_route, inner_ar
        with implicit_replication():
            experts, kept = moe.mesh_routing(p0, xm.detach(), cfg)
        out[name] = {"y": full(y), "aux": float(full(aux)),
                     "y_placements": str(list(y.placements)),
                     "grad_x": full(gx), "grad_router": full(gr)[0],
                     "experts": experts.cpu().numpy(),
                     "kept": kept.cpu().numpy(), "calls": counted,
                     "wi_placements": str(list(p0["wi"].placements))}
    return out


def trainer_job(rank, mesh, device, cfg, case, work: Path) -> dict:
    with Trainer(cfg, train_config(work / case_name(case)), mesh,
                 device=device, moe_dispatch=case["dispatch"]) as tr:
        s0 = tr.init_state()
        b0 = device_batch(tr.loader.batch(0), tr.batch_shardings,
                          device=device)
        s1, m = tr._step(s0, b0)
        out = {"loss0": float(m["loss"]), "fallbacks":
               tr.ruleset.fallback_report()}
        for name, tree in (("params1", s1[0]), ("mu1", s1[1].mu),
                           ("nu1", s1[1].nu)):
            out[name] = gathered(tree, rank)
            out[name + "_shards"] = moe_shards(tree)
        out["losses"] = tr.run(STEPS, resume=False).losses
    return out


def plan_job(rank, mesh, device, params, cfg, case) -> dict:
    """The train plan's step from the carried params (the step places
    them), at MICRO microbatches (one for other rules than the
    default)."""
    micro = MICRO if case["rules"] == "default" else 1
    opt = OptimizerConfig(**OPT)
    plan = steps.make_train_plan(cfg, SHAPE, mesh, opt_cfg=opt,
                                 microbatches=micro,
                                 rule_overrides=RULES[case["rules"]],
                                 moe_dispatch=case["dispatch"])
    (new, state), m = plan.step_fn((params, adamw.init(opt, params)),
                                   batch_tokens(cfg))
    out = {"loss": float(m["loss"]), "micro": micro,
           "params": gathered(new, rank), "mu": gathered(state.mu, rank),
           "fallbacks": plan.ruleset.fallback_report()}
    for name, tree in (("params", new), ("mu", state.mu), ("nu", state.nu)):
        out[name + "_shards"] = moe_shards(tree)
    return out


def serve_job(rank, mesh, device, params, cfg, case) -> dict:
    toks = serve_tokens(cfg)
    b, P, L = SERVE["batch"], SERVE["prompt"], SERVE["cache_len"]
    rules, dispatch = RULES[case["rules"]], case["dispatch"]
    plan = steps.make_prefill_plan(cfg, InputShape("prefill", P, b,
                                                   "prefill"), mesh,
                                   rule_overrides=rules,
                                   moe_dispatch=dispatch)
    logits, cache = plan.step_fn(params, {"tokens": toks[:, :P]})
    out = {"prefill_last": full(logits),
           "prefill_cache": gathered(cache, rank)}
    dshape = InputShape("decode", L, b, "decode")
    dplan = steps.make_plan(cfg, dshape, mesh, rule_overrides=rules,
                            moe_dispatch=dispatch)
    model = steps.build_model_for_scale(cfg, ruleset=dplan.ruleset,
                                        moe_dispatch=dispatch)
    placed = adamw.zip_map(place, params, dplan.arg_shardings[0])
    _, cache = model.prefill(placed, torch.as_tensor(toks[:, :P],
                                                     device=device),
                             cache_len=L)
    out["decode"] = []
    for t in range(SERVE["steps"]):
        pos = P + t
        logits, cache = dplan.step_fn(params, {
            "tokens": toks[:, pos:pos + 1], "pos": pos, "cache": cache})
        out["decode"].append(full(logits))
    out["decode_cache"] = gathered(cache, rank)
    out["cache_placements"] = {
        k: (str(list(t.placements)), str(placements(s, t.shape)))
        for (k, t), (_, s) in zip(flatten_with_paths(cache),
                                  flatten_with_paths(dplan.out_shardings[1]))}
    out["generate"] = generate(model, placed, toks[:, :P], GEN_STEPS,
                               cache_len=L)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--params", required=True)
    ap.add_argument("--cases", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    device = init_spmd(args.device, rank=args.rank, world_size=args.world,
                       init_method=f"tcp://localhost:{args.port}",
                       timeout_s=args.timeout)
    mesh = make_test_mesh(args.data, args.world // args.data, args.device)
    params_np = torch.load(args.params, weights_only=False)
    out = Path(args.out)
    res = {"coordinate": list(mesh.device_mesh.get_coordinate()),
           "device": str(device)}
    for case in json.loads(args.cases):
        cfg = get_smoke_arch(case["arch"])
        params = params_from_jax(params_np[case["arch"]], device)
        got = {}
        for job in case["jobs"]:
            if job == "grad":
                got[job] = grad_job(args.rank, mesh, device, params, cfg,
                                    case)
            elif job == "layer":
                got[job] = layer_job(args.rank, mesh, device, params, cfg,
                                     case)
            elif job == "trainer":
                got[job] = trainer_job(args.rank, mesh, device, cfg, case,
                                       out / "work")
            elif job == "plan":
                got[job] = plan_job(args.rank, mesh, device, params, cfg,
                                    case)
            elif job == "serve":
                got[job] = serve_job(args.rank, mesh, device, params, cfg,
                                     case)
            else:
                raise ValueError(job)
        res[case_name(case)] = got
    torch.save(res, out / f"rank{args.rank}.pt")
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
