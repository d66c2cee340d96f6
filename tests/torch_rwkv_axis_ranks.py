"""One SPMD rank of the RWKV6 model-axis tests
(``tests/test_torch_rwkv_axis.py`` on the CPU, ``tests/test_torch_cuda.py``
on the card): run as

    python tests/torch_rwkv_axis_ranks.py --rank R --world W --port P \\
        --data D --device cpu --params PARAMS --cases CASES --out DIR

once a rank, all ranks at once. ``PARAMS`` is a ``torch.save`` file of
the JAX-drawn params as a numpy tree (carried with
``models.params_from_jax``), ``CASES`` a JSON list of cases (``rules``: a
key of ``RULES``, and ``jobs``). The ranks start a process group
(``launch.dist.init_spmd``: gloo on the CPU, ``repro_gloo`` for ranks
sharing a card), build the (D, W / D) mesh and, per case, run its jobs:

  * ``grad``: the model's ``loss_fn`` on the mesh (params placed by the
    train rules) in each of ``GRAD_MODES`` and every leaf's gradient,
    gathered;
  * ``layer``: the time-mix's recurrence alone (``rwkv.recurrence``) on
    the inputs of ``layer_input`` in each of ``rwkv.MODES``: y and the
    final state gathered, the rank's own rows of y, and the collectives
    counted around the call (``CommDebugMode`` and
    ``launch.dist.COMM``); then layer 0's whole time-mix on a placed
    input, its output gathered and its collectives by kind;
  * ``trainer``: ``Trainer(cfg, tc, mesh)`` one step from its own init
    (loss, the gathered params, mu and nu, the time-mix's and
    channel-mix's own shards) and ``STEPS`` steps' losses;
  * ``plan``: the train plan at ``MICRO`` microbatches from the carried
    params (the loss, the gathered params and mu, the blocks' and their
    mu's and nu's own shards);
  * ``serve``: the prefill plan (its last logits and state), the decode
    plan's steps teacher-forced on the case's tokens from the prefill
    plan's state (each step's logits, state and its layout), and
    ``generate`` with a factored model (the plans') and with the default
    kernel-mode one (``build_model(cfg)``), counting the WKV6 kernel's
    calls in its prefill.

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
from repro_torch.kernels.wkv6 import ops as wkv6_ops  # noqa: E402
from repro_torch.launch import dist as t_dist  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.dist import init_spmd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models.common import param_specs, tree_map  # noqa: E402
from repro_torch.optimizer import adamw  # noqa: E402
from repro_torch.runtime.serve_loop import generate  # noqa: E402
from repro_torch.runtime.train_loop import Trainer, grad_tree  # noqa: E402
from repro_torch.sharding.rules import (place, placements,  # noqa: E402
                                        tree_shardings)

ARCH = "rwkv6-7b"
GRAD_MODES = ("direct", "factored")
SHAPE = InputShape("tiny", seq_len=16, global_batch=4, kind="train")
OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10, schedule="constant")
STEPS = 3
MICRO = 2
# the serving case: batch, prompt, decode steps, generate's tokens
SERVE = dict(batch=2, prompt=16, steps=3)
GEN_STEPS = 4
# the recurrence alone: (batch, seq) of its inputs, 3 chunks of 8 rows;
# and its first UNEVEN_HEADS heads, which do not split over "model"
LAYER_SHAPE = (2, 24)
UNEVEN_HEADS = 3
# rule overrides: what rules_for gives the full rwkv6-7b config (FSDP)
RULES = {"default": None,
         "fsdp": {"embed": "data", "fsdp_embed": "data",
                  "expert_mlp": None}}
BLOCK_PREFIXES = ("blocks/p0/time/", "blocks/p0/channel/")


def case_name(case: dict) -> str:
    return case["rules"]


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


def layer_input(cfg) -> tuple:
    """r, k, v, lw (b, s, H, K) float32 as a time-mix hands them to its
    recurrence (a log-decay around -exp(-1)), and u (H, K)."""
    rng = np.random.default_rng(7)
    H, K = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    shape = LAYER_SHAPE + (H, K)
    r, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    lw = -np.exp(rng.normal(-1.0, 0.5, size=shape)).astype(np.float32)
    u = (0.1 * rng.normal(size=(H, K))).astype(np.float32)
    return r, k, v, lw, u


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


def block_shards(tree) -> dict:
    """The time-mix's and channel-mix's own shards and placements."""
    return {k: (local(t), str(list(t.placements)))
            for k, t in flatten_with_paths(tree)
            if k.startswith(BLOCK_PREFIXES)}


def train_config(work: Path) -> TrainConfig:
    return TrainConfig(shape=SHAPE, optimizer=OptimizerConfig(**OPT),
                       checkpoint_dir=str(work), checkpoint_every=100)


def grad_job(rank, mesh, device, params, cfg, case) -> dict:
    """loss_fn and every gradient on the mesh in each of GRAD_MODES, the
    params placed by the train rules (the Trainer's)."""
    rs = steps.rules_for(cfg, SHAPE, mesh, RULES[case["rules"]])
    out = {}
    for mode in GRAD_MODES:
        model = build_model(cfg, rwkv_mode=mode)
        resolve = steps._resolver(rs)
        model.act_constraint = lambda x: resolve(x, ("batch", "seq", None))
        sh = tree_shardings(rs, model.param_axes(), param_specs(model))
        placed = adamw.zip_map(place, params, sh)
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch_tokens(cfg).items()}
        live = tree_map(lambda t: t.detach().requires_grad_(True), placed)
        with steps.spmd_context(mesh, resolve):
            batch = steps._place_batch(batch, cfg, SHAPE, rs)
            loss = model.loss_fn(live, batch)
            grads = grad_tree(loss, live)
        out[mode] = {"loss": float(full(loss)),
                     "grads": gathered(grads, rank)}
    return out


def layer_job(rank, mesh, device, params, cfg, case) -> dict:
    """The recurrence alone in each mode on placed inputs: y and the
    state gathered, the rank's own rows of y and where they lie, and the
    collectives inside the call; then layer 0's whole time-mix on a
    placed input and its collectives."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    rs = steps.rules_for(cfg, SHAPE, mesh, RULES[case["rules"]])
    r, k, v, lw, u = layer_input(cfg)
    body = rs.sharding(rwkv._BODY_AXES, r.shape)
    placed = [place(torch.as_tensor(t, device=device), body)
              for t in (r, k, v, lw)]
    uu = place(torch.as_tensor(u, device=device),
               rs.sharding(("act_heads", "head_dim"), u.shape))
    out = {}
    for mode in rwkv.MODES:
        with torch.no_grad(), implicit_replication():
            comm0, launches0 = t_dist.COMM.calls, wkv6_ops.KERNEL.launches
            with CommDebugMode() as cm:
                y, S = rwkv.recurrence(mode, *placed, uu, return_state=True)
            out[mode] = {
                "collectives": cm.get_total_counts(),
                "comm_calls": t_dist.COMM.calls - comm0,
                "launches": wkv6_ops.KERNEL.launches - launches0,
                "y": full(y), "state": full(S), "y_local": local(y),
                "y_placements": str(list(y.placements)),
                "state_placements": str(list(S.placements))}
    # UNEVEN_HEADS heads sharded unevenly over "model": gathered, each
    # rank runs them all
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    pl = [Shard(0) if n == "data" and mesh.shape[n] > 1 else
          Shard(2) if n == "model" else Replicate() for n in mesh.shape]
    uneven = [distribute_tensor(torch.as_tensor(t[:, :, :UNEVEN_HEADS],
                                                device=device),
                                mesh.device_mesh, pl, src_data_rank=None)
              for t in (r, k, v, lw)]
    uu = place(torch.as_tensor(u[:UNEVEN_HEADS], device=device),
               rs.sharding(("act_heads", "head_dim"), (UNEVEN_HEADS,)
                           + u.shape[1:]))
    for mode in rwkv.MODES:
        with torch.no_grad(), implicit_replication():
            y = rwkv.recurrence(mode, *uneven, uu)
            out[mode]["uneven"] = {"y": full(y),
                                   "y_placements": str(list(y.placements))}
    # the whole time-mix of layer 0 on a placed input: the reshape to
    # heads, the group norm and the recurrence exchange nothing, the
    # output's partial sums over "model" are reduced once
    model = build_model(cfg)
    sh = tree_shardings(rs, model.param_axes(), param_specs(model))
    p = tree_map(lambda t: t[0], adamw.zip_map(
        place, params["blocks"], sh["blocks"])["p0"]["time"])
    x = np.random.default_rng(8).normal(
        size=LAYER_SHAPE + (cfg.d_model,)).astype(np.float32)
    xm = place(torch.as_tensor(x, device=device),
               rs.sharding(("batch", "seq", None), x.shape))
    with torch.no_grad(), implicit_replication(), CommDebugMode() as cm:
        y = rwkv.timemix_apply(p, xm, cfg, mode="kernel")
    out["timemix"] = {"collectives": {str(op): n for op, n in
                                      cm.get_comm_counts().items()},
                      "y": full(y)}
    return out


def trainer_job(rank, mesh, device, cfg, case, work: Path) -> dict:
    with Trainer(cfg, train_config(work / case_name(case)), mesh,
                 device=device) as tr:
        s0 = tr.init_state()
        b0 = device_batch(tr.loader.batch(0), tr.batch_shardings,
                          device=device)
        s1, m = tr._step(s0, b0)
        out = {"loss0": float(m["loss"]), "fallbacks":
               tr.ruleset.fallback_report(), "mode": tr.model.rwkv_mode}
        for name, tree in (("params1", s1[0]), ("mu1", s1[1].mu),
                           ("nu1", s1[1].nu)):
            out[name] = gathered(tree, rank)
            out[name + "_shards"] = block_shards(tree)
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
                                 rule_overrides=RULES[case["rules"]])
    (new, state), m = plan.step_fn((params, adamw.init(opt, params)),
                                   batch_tokens(cfg))
    out = {"loss": float(m["loss"]), "micro": micro,
           "params": gathered(new, rank), "mu": gathered(state.mu, rank),
           "fallbacks": plan.ruleset.fallback_report()}
    for name, tree in (("params", new), ("mu", state.mu), ("nu", state.nu)):
        out[name + "_shards"] = block_shards(tree)
    return out


def _state_record(cache, shardings) -> dict:
    """Each state leaf's own shard and placements beside the plan's."""
    return {k: (local(t), str(list(t.placements)),
                str(placements(s, t.shape)))
            for (k, t), (_, s) in zip(flatten_with_paths(cache),
                                      flatten_with_paths(shardings))}


def serve_job(rank, mesh, device, params, cfg, case) -> dict:
    toks = serve_tokens(cfg)
    b, P = SERVE["batch"], SERVE["prompt"]
    rules = RULES[case["rules"]]
    plan = steps.make_prefill_plan(cfg, InputShape("prefill", P, b,
                                                   "prefill"), mesh,
                                   rule_overrides=rules)
    logits, cache = plan.step_fn(params, {"tokens": toks[:, :P]})
    out = {"prefill_last": full(logits),
           "prefill_state": gathered(cache, rank),
           "prefill_layout": _state_record(cache, plan.out_shardings[1])}
    dshape = InputShape("decode", P + SERVE["steps"], b, "decode")
    dplan = steps.make_plan(cfg, dshape, mesh, rule_overrides=rules)
    out["decode"], out["decode_layout"] = [], []
    for t in range(SERVE["steps"]):
        pos = P + t
        logits, cache = dplan.step_fn(params, {
            "tokens": toks[:, pos:pos + 1], "pos": pos, "cache": cache})
        out["decode"].append(full(logits))
        out["decode_layout"].append(_state_record(cache,
                                                  dplan.out_shardings[1]))
    out["decode_state"] = gathered(cache, rank)
    placed = adamw.zip_map(place, params, dplan.arg_shardings[0])
    factored = steps.build_model_for_scale(cfg, ruleset=dplan.ruleset)
    out["generate"] = generate(factored, placed, toks[:, :P], GEN_STEPS)
    kernel = build_model(cfg)
    calls = {"n": 0}
    inner = wkv6_ops.wkv6_intra_chunk

    def counted(*a):
        calls["n"] += 1
        return inner(*a)
    wkv6_ops.wkv6_intra_chunk = counted
    try:
        out["generate_kernel"] = generate(kernel, placed, toks[:, :P],
                                          GEN_STEPS)
    finally:
        wkv6_ops.wkv6_intra_chunk = inner
    out["kernel_calls"] = calls["n"]
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
    cfg = get_smoke_arch(ARCH)
    params = params_from_jax(params_np, device)
    for case in json.loads(args.cases):
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
