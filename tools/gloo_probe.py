#!/usr/bin/env python3
"""Which collectives, and which DTensor redistributions, the gloo
process group carries for tensors on the card: two SPMD ranks on
``cuda:0`` (NCCL refuses two ranks on one card).

    python3 tools/gloo_probe.py               # on the card
    python3 tools/gloo_probe.py --device cpu  # the same probe on the CPU
    python3 tools/gloo_probe.py --backend repro_gloo  # through the port's
                                              # own backend (launch.dist)

Each rank runs every probe in turn and records "ok", "wrong" (ran, gave
another answer) or the exception it raised; a probe whose collective
is missing raises on both ranks before any message moves, so the next
one still pairs up. Then it times an all-reduce of one activation of
smollm-360m's (1, 2) step (2 x 4,096 x 960 bf16, 15.7 MB) and of a
quarter of it. Rank 0 prints one JSON object and writes it to
``chiprun_out/gloo_probe_<backend>_all.json`` (with ``--isolate``, one
pair of ranks a probe, ``gloo_probe_<backend>.json``); the exit code is
0 when the ranks ran to their end, whatever the probes found.

    python3 tools/gloo_probe.py --ops --backend repro_gloo

runs, instead, what DTensor's own rules do with the operators of a
cached decode step on a (1, 2) mesh (``OPS``): on a (2, 8, 2, 4) cache
placed ``Shard(1)`` (its sequence) and ``Shard(2)`` (its heads),
``index_copy`` along dim 1, ``torch.where`` with a plain mask, ``roll``
along dim 1 and a slice assignment; ``softmax`` over dim -1 of a
``Shard(3)`` score tensor; ``argmax`` over a ``Shard(-1)`` logits
tensor; and what the model-axis prefill and decode run besides (a
product leaving partial sums reduced to replicated, a lookup into a
vocabulary-sharded table, ``torch.stack`` and ``t[g]`` of sharded
layers, a process-group all-reduce of the maximum over one mesh
dimension), and the RWKV6 token shift of a replicated activation, by
``F.pad`` and by a concatenation (``models.rwkv._shift``). Each runs under ``torch.inference_mode()`` and under
``torch.no_grad()``, and records its output's placements (or its
exception) and whether the gathered value equals the operator on the
full tensors. Rank 0 writes ``gloo_probe_ops_<backend>.json``.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _probe(name, fn, results, only=""):
    if only and name != only:
        return
    print(f"probe {name}", file=sys.stderr, flush=True)
    try:
        results[name] = "ok" if fn() else "wrong"
    except Exception as exc:  # noqa: BLE001 — a probe records what it met
        results[name] = f"{type(exc).__name__}: {str(exc)[:240]}"


PROBES = ("all_reduce", "broadcast", "all_gather_list",
          "all_gather_into_tensor", "reduce_scatter_tensor",
          "all_to_all_single", "barrier", "shard_to_replicate",
          "partial_to_replicate", "partial_to_shard", "replicate_to_shard",
          "shard_to_shard", "row_then_column_product")


def rank_main(rank: int, world: int, port: int, device: str,
              backend: str, only: str = "") -> dict:
    import faulthandler
    faulthandler.enable()
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    sys.path.insert(0, str(ROOT / "src"))
    if backend == "repro_gloo":
        import repro_torch.launch.dist  # noqa: F401 — registers it
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    res: dict = {"torch": torch.__version__,
                 "cuda": torch.version.cuda, "device": str(dev),
                 "backend": backend}
    if dev.type == "cuda":
        res["card"] = torch.cuda.get_device_name(0)
    r = rank

    def full(n=8):
        return torch.arange(world * n, dtype=torch.float32, device=dev)

    raw = {}

    def all_reduce():
        x = torch.full((4,), float(r + 1), device=dev)
        dist.all_reduce(x)
        return torch.equal(x, torch.full((4,), float(sum(range(1, world + 1))),
                                         device=dev))

    def broadcast():
        x = torch.full((4,), float(r), device=dev)
        dist.broadcast(x, 0)
        return torch.equal(x, torch.zeros(4, device=dev))

    def all_gather_list():
        x = full().chunk(world)[r].clone()
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return torch.equal(torch.cat(out), full())

    def all_gather_into_tensor():
        x = full().chunk(world)[r].clone()
        out = torch.empty(full().shape, device=dev)
        dist.all_gather_into_tensor(out, x)
        return torch.equal(out, full())

    def reduce_scatter_tensor():
        x = full() * (r + 1)
        out = torch.empty(full().shape[0] // world, device=dev)
        dist.reduce_scatter_tensor(out, x)
        want = (full() * sum(range(1, world + 1))).chunk(world)[r]
        return torch.equal(out, want)

    def all_to_all_single():
        x = full() + 100 * r
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        n = x.shape[0] // world
        want = torch.cat([full()[r * n:(r + 1) * n] + 100 * s
                          for s in range(world)])
        return torch.equal(out, want)

    def barrier():
        dist.barrier()
        return True

    for fn in (all_reduce, broadcast, all_gather_list,
               all_gather_into_tensor, reduce_scatter_tensor,
               all_to_all_single, barrier):
        _probe(fn.__name__, fn, raw, only)
    res["collectives"] = raw

    red = {}
    mesh = init_device_mesh(dev.type, (1, world),
                            mesh_dim_names=("data", "model"))
    torch.manual_seed(0)
    a = torch.randn(8, 6, device=dev)
    b = torch.randn(6, 4, device=dev)

    def shard_to_replicate():
        t = distribute_tensor(a, mesh, [Replicate(), Shard(0)],
                              src_data_rank=None)
        return torch.equal(t.redistribute(mesh, [Replicate(), Replicate()])
                           .to_local(), a)

    def partial_to_replicate():
        t = DTensor.from_local(a * (r + 1), mesh, [Replicate(), Partial()])
        want = a * sum(range(1, world + 1))
        got = t.redistribute(mesh, [Replicate(), Replicate()]).to_local()
        return torch.allclose(got, want)

    def partial_to_shard():
        t = DTensor.from_local(a * (r + 1), mesh, [Replicate(), Partial()])
        want = (a * sum(range(1, world + 1))).chunk(world)[r]
        got = t.redistribute(mesh, [Replicate(), Shard(0)]).to_local()
        return torch.allclose(got, want)

    def replicate_to_shard():
        t = DTensor.from_local(a, mesh, [Replicate(), Replicate()])
        got = t.redistribute(mesh, [Replicate(), Shard(1)]).to_local()
        return torch.equal(got, a.chunk(world, 1)[r])

    def shard_to_shard():
        t = distribute_tensor(a, mesh, [Replicate(), Shard(0)],
                              src_data_rank=None)
        got = t.redistribute(mesh, [Replicate(), Shard(1)]).to_local()
        return torch.equal(got, a.chunk(world, 1)[r])

    def row_then_column_product():
        ta = distribute_tensor(a, mesh, [Replicate(), Shard(1)],
                               src_data_rank=None)
        tb = distribute_tensor(b, mesh, [Replicate(), Shard(0)],
                               src_data_rank=None)
        return torch.allclose((ta @ tb).full_tensor(), a @ b, atol=1e-5)

    for fn in (shard_to_replicate, partial_to_replicate, partial_to_shard,
               replicate_to_shard, shard_to_shard, row_then_column_product):
        _probe(fn.__name__, fn, red, only)
    res["redistributions"] = red

    times = {}
    if raw.get("all_reduce") == "ok" and not only:
        for label, numel in (("15.7MB", 2 * 4096 * 960),
                             ("3.9MB", 2 * 4096 * 960 // 4)):
            x = torch.ones(numel, dtype=torch.bfloat16, device=dev)
            dist.all_reduce(x)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                dist.all_reduce(x)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times[f"all_reduce_bf16_{label}_ms"] = (
                (time.perf_counter() - t0) / 10 * 1e3)
    res["times"] = times
    dist.barrier()
    dist.destroy_process_group()
    return res


OPS = ("index_copy_dim1", "where_plain_mask", "roll_dim1",
       "slice_assign_dim1", "softmax_shard3", "argmax_shard_last",
       "partial_to_replicate_product", "embedding_vocab_sharded",
       "stack_dim0", "select_dim0", "all_reduce_max_group",
       "pad_shift_dim1", "cat_shift_dim1")


def ops_main(rank: int, world: int, port: int, device: str,
             backend: str) -> dict:
    """``OPS`` on DTensors under each grad mode (see the docstring)."""
    import faulthandler
    faulthandler.enable()
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication
    sys.path.insert(0, str(ROOT / "src"))
    if backend == "repro_gloo":
        import repro_torch.launch.dist  # noqa: F401 — registers it
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    mesh = init_device_mesh(dev.type, (1, world),
                            mesh_dim_names=("data", "model"))
    res: dict = {"torch": torch.__version__, "cuda": torch.version.cuda,
                 "device": str(dev), "backend": backend,
                 "mesh": [1, world]}
    if dev.type == "cuda":
        res["card"] = torch.cuda.get_device_name(0)
    gen = torch.Generator(dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def put(t, *pl):
        return distribute_tensor(t, mesh, list(pl), src_data_rank=None)

    cache, k_new, rows = rnd(2, 8, 2, 4), rnd(2, 1, 2, 4), rnd(2, 4, 2, 4)
    mask = torch.arange(8, device=dev) <= 5
    scores, logits = rnd(2, 2, 1, 8), rnd(2, 16)
    a, b = rnd(8, 6), rnd(6, 4)
    act = rnd(2, 8, 6)
    table, ids = rnd(16, 4), torch.tensor([[1, 9, 15]], device=dev)
    slot = torch.tensor([5], device=dev)

    def assign(c, r):
        c = c.clone()
        c[:, :4] = r
        return c

    def cases(cache_pl):
        """{name: (a function of DTensors, its DTensor arguments, the
        same function's arguments as plain full tensors)}"""
        R = Replicate()
        c = put(cache, R, cache_pl)
        out = {
            "index_copy_dim1": (lambda c, k: c.index_copy(1, slot, k),
                                (c, put(k_new, R, R)), (cache, k_new)),
            "where_plain_mask": (
                lambda c: torch.where(mask[None, :, None, None], c,
                                      torch.zeros_like(c)), (c,), (cache,)),
            "roll_dim1": (lambda c: torch.roll(c, 3, 1), (c,), (cache,)),
            "slice_assign_dim1": (assign, (c, put(rows, R, R)),
                                  (cache, rows)),
            "stack_dim0": (lambda c: torch.stack([c, c + 1]), (c,),
                           (cache,)),
            "select_dim0": (lambda s: s[1], (put(torch.stack(
                [cache, cache + 1]), R, Shard(cache_pl.dim + 1)),),
                (torch.stack([cache, cache + 1]),))}
        return out

    def replicated(t):
        return (t.redistribute(mesh, [Replicate()] * 2)
                if isinstance(t, DTensor) else t)

    def others():
        R = Replicate()
        return {
            "softmax_shard3": (lambda s: torch.softmax(s, dim=-1),
                               (put(scores, R, Shard(3)),), (scores,)),
            "argmax_shard_last": (lambda x: torch.argmax(x, dim=-1),
                                  (put(logits, R, Shard(1)),), (logits,)),
            "partial_to_replicate_product": (
                lambda x, y: replicated(x @ y),
                (put(a, R, Shard(1)), put(b, R, Shard(0))), (a, b)),
            "embedding_vocab_sharded": (
                lambda t: replicated(torch.nn.functional.embedding(ids, t)),
                (put(table, R, Shard(0)),), (table,)),
            "pad_shift_dim1": (
                lambda x: torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
                - x, (put(act, R, R),), (act,)),
            "cat_shift_dim1": (
                lambda x: torch.cat([torch.zeros_like(x[:, :1]),
                                     x[:, :-1]], dim=1) - x,
                (put(act, R, R),), (act,))}

    def run(name, fn, args, plain, mode):
        entry = {}
        try:
            with mode(), implicit_replication():
                got = fn(*args)
                entry["placements"] = (str(list(got.placements))
                                       if isinstance(got, DTensor)
                                       else "a plain tensor")
            with torch.no_grad(), implicit_replication():
                full = got.full_tensor() if isinstance(got, DTensor) else got
                want = fn(*plain)
                if isinstance(want, DTensor):
                    want = want.full_tensor()
            entry["value"] = ("ok" if full.shape == want.shape and
                              torch.allclose(full.float(), want.float(),
                                             atol=1e-5) else "wrong")
        except Exception as exc:  # noqa: BLE001 — a probe records it
            entry["error"] = f"{type(exc).__name__}: {str(exc)[:240]}"
        return entry

    modes = {"inference_mode": torch.inference_mode,
             "no_grad": torch.no_grad}
    found: dict = {}
    for label, pl in (("cache Shard(1)", Shard(1)),
                      ("cache Shard(2)", Shard(2))):
        for name, (fn, args, plain) in cases(pl).items():
            for mname, mode in modes.items():
                print(f"ops {name} {label} {mname}", file=sys.stderr,
                      flush=True)
                found.setdefault(name, {}).setdefault(label, {})[mname] = \
                    run(name, fn, args, plain, mode)
    for name, (fn, args, plain) in others().items():
        for mname, mode in modes.items():
            found.setdefault(name, {})[mname] = run(name, fn, args, plain,
                                                    mode)
    group = mesh.get_group(1)
    for mname, mode in modes.items():
        entry = {}
        try:
            with mode():
                x = torch.full((3,), float(rank), device=dev)
                dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
            entry = {"placements": "a plain tensor",
                     "value": "ok" if torch.equal(
                         x, torch.full((3,), float(world - 1),
                                       device=dev)) else "wrong"}
        except Exception as exc:  # noqa: BLE001
            entry["error"] = f"{type(exc).__name__}: {str(exc)[:240]}"
        found.setdefault("all_reduce_max_group", {})[mname] = entry
    res["ops"] = found
    dist.barrier()
    dist.destroy_process_group()
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--work", default="",
                    help="where the ranks' files and the JSON go (default "
                    "build/gloo_probe and chiprun_out)")
    ap.add_argument("--only", default="",
                    help="run this one probe (a rank's argument)")
    ap.add_argument("--isolate", action="store_true",
                    help="each probe in a pair of ranks of its own, all "
                    "pairs at once: a probe that kills its ranks leaves "
                    "the others' answers")
    ap.add_argument("--ops", action="store_true",
                    help="the DTensor operators of a cached decode step "
                    "(OPS) under inference_mode and no_grad, instead")
    args = ap.parse_args()
    if args.rank is not None:
        if args.ops:
            res = ops_main(args.rank, args.world, args.port, args.device,
                           args.backend)
        else:
            res = rank_main(args.rank, args.world, args.port, args.device,
                            args.backend, args.only)
        Path(args.out).write_text(json.dumps(res))
        return
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("gloo_probe: no card", file=sys.stderr)
            sys.exit(1)
    work = (Path(args.work) if args.work else
            ROOT / "build" / "gloo_probe") / args.backend
    record = Path(args.work) if args.work else ROOT / "chiprun_out"
    work.mkdir(parents=True, exist_ok=True)
    names = PROBES if args.isolate and not args.ops else ("",)
    procs = {}
    for name in names:
        port = _free_port()
        for r in range(args.world):
            env = dict(os.environ, OMP_NUM_THREADS="1")
            procs[name, r] = subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--world",
                 str(args.world), "--port", str(port), "--device",
                 args.device, "--backend", args.backend, "--only", name,
                 "--out", str(work / f"{name or 'all'}_rank{r}.json")]
                + (["--ops"] if args.ops else []), env=env)
    codes = {}
    for key, p in procs.items():
        try:
            codes[key] = p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            codes[key] = "timeout"
    if args.ops:
        if list(codes.values()) != [0] * args.world:
            print(f"gloo_probe: ranks ended {list(codes.values())}",
                  file=sys.stderr)
            sys.exit(1)
        ranks = [json.loads((work / f"all_rank{r}.json").read_text())
                 for r in range(args.world)]
        out = dict(ranks[0], ranks_agree=all(x["ops"] == ranks[0]["ops"]
                                             for x in ranks))
        print(json.dumps(out, indent=1))
        record.mkdir(exist_ok=True)
        (record / f"gloo_probe_ops_{args.backend}.json").write_text(
            json.dumps(out, indent=1))
        return
    if args.isolate:
        out = {"backend": args.backend, "exit_codes": {}}
        for name in names:
            got = [codes[name, r] for r in range(args.world)]
            if got != [0] * args.world:
                out["exit_codes"][name] = got
                continue
            res = json.loads((work / f"{name}_rank0.json").read_text())
            out.setdefault("versions", {k: res[k] for k in
                                        ("torch", "cuda", "device")})
            for group in ("collectives", "redistributions"):
                out.setdefault(group, {}).update(res[group])
        print(json.dumps(out, indent=1))
        record.mkdir(exist_ok=True)
        (record / f"gloo_probe_{args.backend}.json").write_text(
            json.dumps(out, indent=1))
        return
    if list(codes.values()) != [0] * args.world:
        print(f"gloo_probe: ranks ended {list(codes.values())}",
              file=sys.stderr)
        sys.exit(1)
    ranks = [json.loads((work / f"all_rank{r}.json").read_text())
             for r in range(args.world)]
    out = {"rank0": ranks[0],
           "ranks_agree": all(x["collectives"] == ranks[0]["collectives"]
                              and x["redistributions"]
                              == ranks[0]["redistributions"]
                              for x in ranks)}
    print(json.dumps(out, indent=1))
    record.mkdir(exist_ok=True)
    (record / f"gloo_probe_{args.backend}_all.json").write_text(
        json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
