#!/usr/bin/env python3
"""Split one embedding batch of a full-width model on one card.

    python3 tools/batch_profile.py [--arch qwen3-moe-30b-a3b] [--rows 15]

Draws the arch's FULL config on the card from seed 0, as chip_smoke.py's
phase of that model does, and takes its first batch of chip_smoke.py's
corpus: for qwen3-moe-30b-a3b ([moe]: 48 layers, 128 experts top 8; 61
GB bf16) 8 documents of 512 tokens, for zamba2-2.7b ([zamba2]: 45
Mamba2 layers and 9 shared attention ones; 3.96 GB) 4 of 2048 (ids below
its vocabulary of 32,000). It times ``EmbeddingService.embed_batch``
with CUDA events (an MoE model under each dispatch: "onehot", the
path's, and "sort"), then records one batch with ``torch.profiler`` and
prints the ``aten`` operators with the most device time (their calls,
device and host milliseconds), the batch's device time in all and its
kernel launches. It prints one JSON line (also written to
chiprun_out/) and the card's name and power limit, and exits 1 without
a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# each arch's batch (documents, tokens) in chip_smoke.py; ids below
# chip_smoke.py's OFF_VOCAB or the model's vocabulary
BATCHES = {"qwen3-moe-30b-a3b": (8, 512), "zamba2-2.7b": (4, 2048)}
VOCAB = 32768


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(BATCHES),
                    default="qwen3-moe-30b-a3b")
    ap.add_argument("--rows", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("batch_profile: no CUDA card", file=sys.stderr)
        sys.exit(1)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import get_arch
    from repro_torch.data import make_corpus
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import EmbeddingService

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cfg = get_arch(args.arch)
    docs, doc_len = BATCHES[args.arch]
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
    corpus = make_corpus(0, n_docs=docs, dim=128, with_tokens=True,
                         vocab=min(VOCAB, cfg.vocab_size), doc_len=doc_len)
    batch = torch.as_tensor(np.stack([corpus.tokens[i] for i in range(docs)])
                            .astype(np.int32), device=dev)
    dispatches = ("onehot", "sort") if cfg.moe.enabled else ("onehot",)
    services = {d: EmbeddingService(cfg, params, batch_size=docs,
                                    device=dev) for d in dispatches}
    for d, s in services.items():
        s.model.moe_dispatch = d
    ms = {d: cuda_ms(lambda: s.embed_batch(batch), 5)
          for d, s in services.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        services["onehot"].embed_batch(batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = sorted((e for e in events if e.key.startswith("aten::")),
                  key=lambda e: -e.device_time_total)[:args.rows]
    # the kernels' own rows (an operator's row repeats its kernels' time)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = [{"op": e.key, "calls": e.count,
            "device_ms": e.device_time_total / 1e3,
            "cpu_ms": e.cpu_time_total / 1e3} for e in rows]
    out = {"arch": args.arch, "batch": [docs, doc_len], "nvidia_smi": smi,
           "batch_ms": ms, "profiled_device_ms": device_ms,
           "kernel_launches": launches, "top_ops": top}
    for row in top:
        print(f"{row['op']:<28} {row['calls']:>6} calls  device "
              f"{row['device_ms']:9.3f} ms  cpu {row['cpu_ms']:9.3f} ms")
    line = json.dumps(out)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"batch_profile_{args.arch}.json").write_text(
        line)
    print(line)
    print(smi)


if __name__ == "__main__":
    main()
