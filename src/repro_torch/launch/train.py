"""The LM training CLI (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 100 [--smoke] [--compress-grads] [--resume] [--device cpu]

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch smollm-360m --mesh 1,2 [...]

With ``--smoke`` the arch's reduced config at ``--seq`` x ``--batch``,
else its full config at ``--shape`` (``train_4k`` by default: 256 x
4,096). Without a process group the port trains on one device, the
card unless ``--device cpu``. Under ``torchrun`` (``RANK`` and
``WORLD_SIZE`` set) every process is a rank of the (data, model) mesh
``--mesh`` over the world (``launch.dist.init_spmd``: NCCL on distinct
cards, the port's ``repro_gloo`` when ranks share a card, gloo with
``--device cpu``; ``launch.mesh.make_test_mesh``), and the Trainer
shards over it; rank 0 prints. Checkpoints and the metrics JSONL go
under ``--ckpt-dir`` (by default a directory under the system's
temporary directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.config import (SHAPES_BY_NAME, InputShape, OptimizerConfig,
                                TrainConfig, get_arch, get_smoke_arch)
from repro_torch.runtime.train_loop import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config at --seq x --batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="",
                    help="data,model: the mesh over torchrun's world "
                    "(default 1,WORLD_SIZE)")
    args = ap.parse_args(argv)

    mesh, rank = None, 0
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        from repro_torch.launch.dist import init_spmd
        from repro_torch.launch.mesh import make_test_mesh
        world = int(os.environ["WORLD_SIZE"])
        data, model = (map(int, args.mesh.split(",")) if args.mesh
                       else (1, world))
        init_spmd(args.device)
        mesh = make_test_mesh(data, model, device=args.device)
        rank = int(os.environ["RANK"])

    if args.smoke:
        cfg = get_smoke_arch(args.arch)
        shape = InputShape("smoke", seq_len=args.seq,
                           global_batch=args.batch, kind="train")
    else:
        cfg = get_arch(args.arch)
        shape = SHAPES_BY_NAME[args.shape]

    tc = TrainConfig(
        shape=shape,
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=20,
                                  total_steps=args.steps,
                                  compress_grads=args.compress_grads),
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir)
    with Trainer(cfg, tc, mesh, metrics_path=f"{args.ckpt_dir}/metrics.jsonl",
                 device=args.device) as trainer:
        report = trainer.run(args.steps, resume=args.resume)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    if rank:
        return
    print(f"final loss {report.final_loss:.4f} after {args.steps} steps "
          f"({report.restarts} restarts, "
          f"{report.straggler_events} straggler events)")


if __name__ == "__main__":
    main()
