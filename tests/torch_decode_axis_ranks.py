"""One SPMD rank of the decode-axis tests (``tests/test_torch_decode_axis.py``
on the CPU, ``tests/test_torch_cuda.py`` on the card): run as

    python tests/torch_decode_axis_ranks.py --rank R --world W --port P \\
        --data D --device cpu --params PARAMS --cases CASES --out DIR \\
        [--jobs serve,combine]

once a rank, all ranks at once. ``PARAMS`` is a ``torch.save`` file of
each arch's JAX-drawn params as numpy trees (carried with
``models.params_from_jax``), ``CASES`` a JSON list of cases (``CASE_KEYS``).
The ranks start a process group (``launch.dist.init_spmd``: gloo on the
CPU, ``repro_gloo`` for ranks sharing a card), build the (D, W / D) mesh
and, per case (``serve_job``): the prefill plan's step (the prompt's
slots) with ``last_logit`` off (every position's logits, as the JAX
package's plan) and on, then the model's prefill of ``cache_len`` slots
on the params placed by that plan (as ``generate`` fills its cache), the
decode plan's step over that cache ``steps`` times (teacher-forced on
the case's tokens), and ``generate`` on the mesh; ``combine_job`` runs
``models.attention.softmax_over_shards`` on scores split over the mesh.
Each rank writes ``DIR/rank{R}.pt``: full values (gathered: a collective,
every rank calls it) kept by rank 0, every rank's own shards, their
placements and the plan's placements for them. Imports no JAX.
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
from repro_torch.config import InputShape, get_smoke_arch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.dist import init_spmd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models.attention import softmax_over_shards  # noqa: E402
from repro_torch.optimizer.adamw import zip_map  # noqa: E402
from repro_torch.runtime.serve_loop import generate  # noqa: E402
from repro_torch.sharding.rules import placements, place  # noqa: E402

CASE_KEYS = ("arch", "batch", "prompt", "cache_len", "steps")
GEN_STEPS = 6
# softmax_over_shards: (b, heads, keys, head_dim), and the valid key
# counts (a prefix), one of which leaves whole shards masked
COMBINE_SHAPE = (2, 3, 16, 8)
COMBINE_VALID = (5, 16)


def case_name(case: dict) -> str:
    return "{arch}/b{batch}/p{prompt}/l{cache_len}".format(**case)


def case_tokens(cfg, case: dict) -> np.ndarray:
    """(batch, prompt + steps) token ids: the prompt, then the tokens
    the decode steps take."""
    rng = np.random.default_rng(case["prompt"] * 100 + case["batch"])
    return rng.integers(1, cfg.vocab_size, (case["batch"], case["prompt"]
                                            + case["steps"])).astype(np.int32)


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


def record(tree, shardings, rank: int) -> dict:
    """Every leaf's own shard, its placements and the plan's for it, and
    (rank 0) its gathered value."""
    flat = flatten_with_paths(tree) if isinstance(tree, dict) else [
        ("", tree)]
    want = (dict(flatten_with_paths(shardings)) if isinstance(tree, dict)
            else {"": shardings})
    out = {"local": {}, "placements": {}, "plan_placements": {}, "full": {}}
    for path, t in flat:
        out["local"][path] = local(t)
        out["placements"][path] = str(list(t.placements))
        out["plan_placements"][path] = str(placements(want[path], t.shape))
        gathered = full(t)
        if rank == 0:
            out["full"][path] = gathered
    return out


def serve_job(rank, mesh, device, params_np, case, res) -> None:
    cfg = get_smoke_arch(case["arch"])
    params = params_from_jax(params_np[case["arch"]], device)
    toks = case_tokens(cfg, case)
    b, P, L = case["batch"], case["prompt"], case["cache_len"]
    out = {"prefill": {}, "decode": []}
    pshape = InputShape("prefill", P, b, "prefill")
    for last in (False, True):
        plan = steps.make_prefill_plan(cfg, pshape, mesh, last_logit=last)
        out["prefill_fallbacks"] = plan.ruleset.fallback_report()
        logits, cache = plan.step_fn(params, {"tokens": toks[:, :P]})
        out["prefill"][last] = {
            "logits": record(logits, plan.out_shardings[0], rank),
            "cache": record(cache, plan.out_shardings[1], rank)}
    # the cache the decode steps go on from (cache_len slots), filled as
    # generate fills it: the model's prefill on the placed params
    model = steps.build_model_for_scale(cfg, ruleset=plan.ruleset)
    _, cache = model.prefill(zip_map(place, params, plan.arg_shardings[0]),
                             torch.as_tensor(toks[:, :P], device=device),
                             cache_len=L)
    out["prefill_cache"] = {path: full(t)
                            for path, t in flatten_with_paths(cache)}
    dshape = InputShape("decode", L, b, "decode")
    dplan = steps.make_plan(cfg, dshape, mesh)
    out["decode_fallbacks"] = dplan.ruleset.fallback_report()
    out["kv_seq"] = dplan.ruleset.rules.get("kv_seq")
    cache_sh = dplan.arg_shardings[1]["cache"]
    # the layout the decode step moves the cache into on entry
    out["decode_entry"] = record(zip_map(place, cache, cache_sh), cache_sh,
                                 rank)
    for t in range(case["steps"]):
        pos = P + t
        logits, cache = dplan.step_fn(params, {
            "tokens": toks[:, pos:pos + 1], "pos": pos, "cache": cache})
        out["decode"].append({
            "logits": record(logits, dplan.out_shardings[0], rank),
            "cache": record(cache, dplan.out_shardings[1], rank)})
    model = steps.build_model_for_scale(
        cfg, ruleset=steps.rules_for(cfg, dshape, mesh))
    placed = zip_map(place, params, dplan.arg_shardings[0])
    out["generate"] = generate(model, placed, toks[:, :P], GEN_STEPS,
                               cache_len=L)
    res[case_name(case)] = out


def combine_job(rank, mesh, device, res) -> None:
    """``softmax_over_shards`` with the keys split over every mesh
    dimension (both of a (2, 2) mesh, in mesh order), for each of
    ``COMBINE_VALID`` valid key prefixes; the inputs and rank 0's out."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    dm = mesh.device_mesh
    b, h, n, hd = COMBINE_SHAPE
    rng = np.random.default_rng(7)
    scores = torch.as_tensor(rng.standard_normal((b, h, 1, n)),
                             dtype=torch.float32, device=device)
    v = torch.as_tensor(rng.standard_normal((b, n, h, hd)),
                        dtype=torch.float32, device=device)
    dims = [i for i in range(dm.ndim) if dm.size(i) > 1]
    s_pl = [Shard(3) if i in dims else Replicate() for i in range(dm.ndim)]
    v_pl = [Shard(1) if i in dims else Replicate() for i in range(dm.ndim)]
    out = {"scores": scores.cpu().numpy(), "v": v.cpu().numpy()}
    for valid in COMBINE_VALID:
        keep = torch.arange(n, device=device) < valid
        s = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
        sl = distribute_tensor(s, dm, s_pl, src_data_rank=None).to_local()
        vl = distribute_tensor(v, dm, v_pl, src_data_rank=None).to_local()
        got = softmax_over_shards(sl, vl, [dm.get_group(i) for i in dims])
        out[valid] = {"out": got.cpu().numpy(),
                      "masked_shard": bool((sl <= NEG_INF).all())}
    res["combine"] = out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--params", required=True)
    ap.add_argument("--cases", default="[]")
    ap.add_argument("--jobs", default="serve,combine")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    device = init_spmd(args.device, rank=args.rank, world_size=args.world,
                       init_method=f"tcp://localhost:{args.port}",
                       timeout_s=args.timeout)
    mesh = make_test_mesh(args.data, args.world // args.data, args.device)
    params_np = torch.load(args.params, weights_only=False)
    jobs = args.jobs.split(",")
    res = {"coordinate": list(mesh.device_mesh.get_coordinate()),
           "device": str(device)}
    if "serve" in jobs:
        for case in json.loads(args.cases):
            serve_job(args.rank, mesh, device, params_np, case, res)
    if "combine" in jobs:
        combine_job(args.rank, mesh, device, res)
    out = Path(args.out)
    torch.save(res, out / f"rank{args.rank}.pt")
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
