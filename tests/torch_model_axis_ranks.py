"""One SPMD rank of the model-axis tests (``tests/test_torch_model_axis.py``
on the CPU, ``tests/test_torch_cuda.py`` on the card): run as

    python tests/torch_model_axis_ranks.py --rank R --world W --port P \\
        --data D --device cpu --out DIR [--restore CKPT] [--jobs a,b]
    python tests/torch_model_axis_ranks.py --single --out DIR

once a rank, all ranks at once (``--single``: the single-device
references instead, no process group, beside them). The ranks start a process group
(``launch.dist.init_spmd``: gloo on the CPU, the port's own
``repro_gloo`` for ranks that share a card), build the (D, W / D) mesh
(``launch.mesh.make_test_mesh``), run the chosen jobs and each write
``DIR/rank{R}.pt``: a dict of numpy arrays, floats and strings. Full
tensors (gathered) are kept by rank 0 only; every rank keeps its own
shards and its mesh coordinate. Imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.config import (InputShape, OptimizerConfig,  # noqa: E402
                                TrainConfig, get_smoke_arch)
from repro_torch.data.loader import device_batch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.dist import init_spmd  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.optimizer import adamw, compression  # noqa: E402
from repro_torch.runtime.fault import WorkerFailure  # noqa: E402
from repro_torch.sharding.rules import place  # noqa: E402

DENSE = ("smollm-360m", "llama3-8b", "codeqwen1.5-7b", "gemma3-12b")
SHAPE = InputShape("tiny", seq_len=16, global_batch=4, kind="train")
OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10, schedule="constant")
STEPS = 5
# flash's rule: (query heads, KV heads) over the mesh's model axis
FLASH_CASES = ((4, 1), (4, 2), (6, 3))


def train_config(work: Path, **kw) -> TrainConfig:
    return TrainConfig(shape=SHAPE, optimizer=OptimizerConfig(**OPT),
                       checkpoint_dir=str(work), checkpoint_every=100,
                       **kw)


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


def leaves(tree) -> list:
    return ckpt.flatten_with_paths(tree)


def gathered(tree, rank: int) -> dict:
    """Every leaf gathered (a collective: every rank calls it), kept by
    rank 0."""
    got = {k: full(t) for k, t in leaves(tree)}
    return got if rank == 0 else {}


def trainer_job(rank, mesh, device, work, res, archs=DENSE) -> None:
    """Per dense arch: the initial shards, the placed batch, one step (the
    loss, the shards and the gathered params, mu and nu after it), the
    ruleset's fallbacks, then ``STEPS`` steps' losses from ``run``."""
    from repro_torch.runtime.train_loop import Trainer
    for arch in archs:
        cfg = get_smoke_arch(arch)
        with Trainer(cfg, train_config(work / arch), mesh,
                     device=device) as tr:
            s0 = tr.init_state()
            out = {"init": {k: local(t) for k, t in leaves(s0[0])},
                   "fallbacks": tr.ruleset.fallback_report(),
                   "signature": tr.mesh_signature()}
            b0 = device_batch(tr.loader.batch(0), tr.batch_shardings,
                              device=device)
            out["batch"] = {k: local(t) for k, t in b0.items()}
            from repro_torch.kernels.flash_attention import ops as f_ops
            before = f_ops.KERNEL.launches
            s1, m = tr._step(s0, b0)
            out["flash_launches"] = f_ops.KERNEL.launches - before
            out["loss0"] = float(m["loss"])
            out["grad_norm0"] = float(m["grad_norm"])
            for name, tree in (("params1", s1[0]), ("mu1", s1[1].mu),
                               ("nu1", s1[1].nu)):
                out[name + "_local"] = {k: local(t) for k, t in leaves(tree)}
                out[name] = gathered(tree, rank)
            out["losses"] = tr.run(STEPS, resume=False).losses
        res[arch] = out


def plan_job(rank, mesh, device, res) -> None:
    """The train plan's step on the mesh for smollm-360m SMOKE at
    microbatches 1 and 2, from plain params (the step places them)."""
    cfg = get_smoke_arch("smollm-360m")
    opt = OptimizerConfig(**OPT)
    for k in (1, 2):
        plan = steps.make_train_plan(cfg, SHAPE, mesh, opt_cfg=opt,
                                     microbatches=k)
        from repro_torch.models import build_model
        params = build_model(cfg).init(
            torch.Generator(device).manual_seed(0))
        batch = {n: v for n, v in _batch(cfg).items()}
        (new, _), m = plan.step_fn((params, adamw.init(opt, params)), batch)
        res[f"plan{k}"] = {"loss": float(m["loss"]),
                           "params": gathered(new, rank)}
        if k == 1:
            res["plan_local"] = {p: local(t) for p, t in leaves(new)}


def _batch(cfg):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size,
                        (SHAPE.global_batch, SHAPE.seq_len + 1)
                        ).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def compress_job(rank, mesh, device, res) -> None:
    """Two rounds of ``compress_decompress`` on DTensor gradients placed
    as llama3-8b SMOKE's params."""
    from repro_torch.runtime.train_loop import Trainer
    cfg = get_smoke_arch("llama3-8b")
    tr = Trainer(cfg, train_config(Path("unused")), mesh, device=device)
    shapes = tr.param_shardings
    rng = np.random.default_rng(11)
    params = tr.init_state()[0]
    residual = compression.init_residual(params)
    out = []
    for _ in range(2):
        raw = tree_map(lambda p: torch.as_tensor(
            rng.standard_normal(p.shape).astype(np.float32) * 1e-3,
            device=tr.device), params)
        grads = adamw.zip_map(place, raw, shapes)
        ghat, residual = compression.compress_decompress(grads, residual)
        out.append(({k: full(t) for k, t in leaves(ghat)},
                    {k: full(t) for k, t in leaves(residual)},
                    {k: full(t) for k, t in leaves(raw)}))
    tr.close()
    res["compress"] = out if rank == 0 else []
    res["residual_placed"] = all(
        str(r.placements) == str(p.placements)
        for (_, r), (_, p) in zip(leaves(residual), leaves(params)))


def flash_job(rank, mesh, device, res) -> None:
    """Flash's sharding rule: q heads over the model axis (rows over
    data), K and V heads over it where they split, else replicated;
    forward and the three gradients, gathered."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dm = mesh.device_mesh
    out = {}
    for h, kvh in FLASH_CASES:
        rng = np.random.default_rng(h * 10 + kvh)
        b, s, hd = 2, 24, 16
        q, k, v, dout = (torch.as_tensor(
            rng.standard_normal(shape).astype(np.float32), device=device)
            for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd),
                          (b, s, h, hd)))
        model = mesh.shape["model"]
        q_pl = [Shard(0), Shard(2)]
        kv_pl = [Shard(0), Shard(2) if kvh % model == 0 else Replicate()]
        qd = distribute_tensor(q, dm, q_pl, src_data_rank=None)
        kd, vd = (distribute_tensor(t, dm, kv_pl, src_data_rank=None)
                  for t in (k, v))
        qd, kd, vd = (t.detach().requires_grad_(True) for t in (qd, kd, vd))
        o = attention.flash_attention(qd, kd, vd, hd ** -0.5, causal=True,
                                      q_block=8, kv_block=8)
        od = distribute_tensor(dout, dm, q_pl, src_data_rank=None)
        dq, dk, dv = torch.autograd.grad(o, (qd, kd, vd), od)
        no_grad = attention.flash_attention(qd.detach(), kd.detach(),
                                            vd.detach(), hd ** -0.5,
                                            causal=True)
        out[h, kvh] = {"inputs": [t.numpy() for t in (q, k, v, dout)],
                       "out": full(o), "no_grad": full(no_grad),
                       "grads": [full(t) for t in (dq, dk, dv)],
                       "kv_placements": str(kd.placements)}
    res["flash"] = out


def checkpoint_job(rank, mesh, device, work, res) -> None:
    """smollm-360m SMOKE: two steps, then a save from the async thread;
    the gathered state; then a run with checkpoints every 2 steps and a
    WorkerFailure injected once at step 3, against a clean run."""
    from repro_torch.runtime.train_loop import Trainer
    cfg = get_smoke_arch("smollm-360m")
    tr = Trainer(cfg, train_config(work / "saved"), mesh, device=device)
    s = tr.init_state()
    for step in range(2):
        s, _ = tr._step(s, device_batch(tr.loader.batch(step),
                                        tr.batch_shardings, device=device))
    tr.checkpointer.save(2, tr._checkpoint_tree(s),
                         mesh_signature=tr.mesh_signature())
    tr.checkpointer.wait()
    res["saved_dir"] = str(work / "saved")
    res["saved"] = gathered(tr._checkpoint_tree(s), rank)
    res["async_write"] = tr.checkpointer.write_seconds is not None \
        if rank == 0 else None
    tr.close()

    fired = []

    def fail_once(step):
        if step == 3 and not fired:
            fired.append(step)
            raise WorkerFailure("injected")

    tc = dataclasses.replace(train_config(work / "replay"),
                             checkpoint_every=2)
    with Trainer(cfg, tc, mesh, fail_injector=fail_once,
                 device=device) as tr2:
        rep = tr2.run(STEPS, resume=False)
    res["replay"] = {"losses": rep.losses, "restarts": rep.restarts}
    with Trainer(cfg, train_config(work / "clean"), mesh,
                 device=device) as tr3:
        res["clean"] = tr3.run(STEPS, resume=False).losses


def restore_job(rank, mesh, device, src: Path, res) -> None:
    """The checkpoint ``src`` (written on another mesh, by ranks that may
    still be running: it is waited for) restored onto this one by the
    Trainer's shardings, gathered."""
    import time
    from repro_torch.runtime.train_loop import Trainer
    deadline = time.monotonic() + 120
    while not ckpt.list_steps(str(src)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint in {src}")
        time.sleep(0.2)
    cfg = get_smoke_arch("smollm-360m")
    tr = Trainer(cfg, train_config(src), mesh, device=device)
    state, step = tr.restore_latest()
    res["restored_step"] = step
    res["restored"] = gathered(tr._checkpoint_tree(state), rank)
    res["restored_local"] = {k: local(t) for k, t in leaves(state[0])}
    tr.close()


def refusal_job(mesh, device, res) -> None:
    """What the model axis leaves refused, each message: the prefill and
    decode plans' steps and the Trainer of a family outside the dense,
    MoE and RWKV6 ones; and that llama3-8b's, qwen3-moe-30b-a3b's and
    rwkv6-7b's prefill and decode plans, and rwkv6-7b's Trainer, run
    ("ran")."""
    from repro_torch.config import get_smoke_arch as smoke
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import Trainer
    shapes = (("prefill", InputShape("p", 16, 2, "prefill")),
              ("decode", InputShape("d", 16, 2, "decode")))
    msgs = {}
    for arch in ("llama3-8b", "qwen3-moe-30b-a3b", "rwkv6-7b",
                 "zamba2-2.7b", "internvl2-1b"):
        cfg = smoke(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator(device).manual_seed(0))
        batches = {"prefill": {"tokens": np.ones((2, 16), np.int32)},
                   "decode": {"tokens": np.ones((2, 1), np.int32),
                              "pos": 3,
                              "cache": model.init_cache(2, 16, device)}}
        for kind, shape in shapes:
            plan = steps.make_plan(cfg, shape, mesh)
            try:
                plan.step_fn(params, batches[kind])
                msgs[f"{arch}/{kind}"] = "ran"
            except NotImplementedError as exc:
                msgs[f"{arch}/{kind}"] = str(exc)
    for arch in ("rwkv6-7b", "zamba2-2.7b", "internvl2-1b"):
        try:
            Trainer(smoke(arch), train_config(Path("unused")), mesh,
                    device=device).close()
            msgs[arch] = "ran"
        except NotImplementedError as exc:
            msgs[arch] = str(exc)
    res["refusals"] = msgs


def single_job(out: Path) -> None:
    """The single-device references, with no process group: per dense
    arch the port's Trainer's initial params, step-0 batch, params and
    mu after one step, step 0's loss and ``STEPS`` steps' losses; and
    the losses of the Trainer ``launch.train --smoke --steps 3`` builds
    (its defaults), all on the CPU."""
    from repro_torch.runtime.train_loop import Trainer
    res = {}
    for arch in DENSE:
        with Trainer(get_smoke_arch(arch), train_config(out / arch),
                     device="cpu") as tr:
            s0 = tr.init_state()
            batch = tr.loader.batch(0)
            s1, m = tr._step(s0, device_batch(batch, device="cpu"))
            res[arch] = {
                "init": {k: full(t) for k, t in leaves(s0[0])},
                "batch": batch,
                "params1": {k: full(t) for k, t in leaves(s1[0])},
                "mu1": {k: full(t) for k, t in leaves(s1[1].mu)},
                "loss0": float(m["loss"]),
                "losses": tr.run(STEPS, resume=False).losses}
    cli = TrainConfig(
        shape=InputShape("smoke", seq_len=64, global_batch=8, kind="train"),
        optimizer=OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=3),
        checkpoint_every=1_000_000, checkpoint_dir=str(out / "cli"))
    with Trainer(get_smoke_arch("smollm-360m"), cli, device="cpu") as tr:
        res["cli_losses"] = tr.run(3, resume=False).losses
    torch.save(res, out / "single.pt")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--single", action="store_true",
                    help="the single-device references (single_job) only")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", required=True)
    ap.add_argument("--restore", default="")
    ap.add_argument("--jobs", default="trainer,plan,compress,flash")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--archs", default=",".join(DENSE))
    args = ap.parse_args()
    torch.set_num_threads(1)
    torch.manual_seed(0)
    if args.single:
        single_job(Path(args.out))
        return
    device = init_spmd(args.device, rank=args.rank, world_size=args.world,
                       init_method=f"tcp://localhost:{args.port}",
                       timeout_s=args.timeout)
    mesh = make_test_mesh(args.data, args.world // args.data, args.device)
    out = Path(args.out)
    work = out / "work"
    jobs = args.jobs.split(",")
    res = {"coordinate": list(mesh.device_mesh.get_coordinate()),
           "device": str(device)}
    if "trainer" in jobs:
        trainer_job(args.rank, mesh, device, work, res,
                    args.archs.split(","))
    if "plan" in jobs:
        plan_job(args.rank, mesh, device, res)
    if "compress" in jobs:
        compress_job(args.rank, mesh, device, res)
    if "flash" in jobs:
        flash_job(args.rank, mesh, device, res)
    if "checkpoint" in jobs:
        checkpoint_job(args.rank, mesh, device, work, res)
    if "refusals" in jobs:
        refusal_job(mesh, device, res)
    if args.restore:
        restore_job(args.rank, mesh, device, Path(args.restore), res)
    torch.save(res, out / f"rank{args.rank}.pt")
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
