#!/usr/bin/env python3
"""Split one qwen3-moe-30b-a3b embedding batch on one card.

    python3 tools/moe_batch_profile.py [--rows 15]

Draws qwen3-moe-30b-a3b FULL (48 layers, 128 experts top 8; 61 GB bf16)
on the card from seed 0, as chip_smoke.py's [moe] phase does, and takes
its first batch: 8 documents of 512 tokens of chip_smoke.py's corpus.
It times ``EmbeddingService.embed_batch`` with CUDA events under each
MoE dispatch ("onehot", the path's, and "sort"), then records one
"onehot" batch with ``torch.profiler`` and prints the ``aten``
operators with the most device time (their calls, device and host
milliseconds) and the batch's device time in all. It prints one JSON
line (also written to chiprun_out/) and the card's name and power
limit, and exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-moe-30b-a3b"
DOCS, DOC_LEN, VOCAB = 8, 512, 32768     # chip_smoke.py's OFF_* corpus


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
    ap.add_argument("--rows", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("moe_batch_profile: no CUDA card", file=sys.stderr)
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
    cfg = get_arch(ARCH)
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
    corpus = make_corpus(0, n_docs=DOCS, dim=128, with_tokens=True,
                         vocab=VOCAB, doc_len=DOC_LEN)
    batch = torch.as_tensor(np.stack([corpus.tokens[i] for i in range(DOCS)])
                            .astype(np.int32), device=dev)
    services = {d: EmbeddingService(cfg, params, batch_size=DOCS,
                                    device=dev) for d in ("onehot", "sort")}
    services["sort"].model.moe_dispatch = "sort"
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
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    top = [{"op": e.key, "calls": e.count,
            "device_ms": e.device_time_total / 1e3,
            "cpu_ms": e.cpu_time_total / 1e3} for e in rows]
    out = {"arch": ARCH, "batch": [DOCS, DOC_LEN], "nvidia_smi": smi,
           "batch_ms": ms, "profiled_device_ms": device_ms,
           "top_ops": top}
    for row in top:
        print(f"{row['op']:<28} {row['calls']:>6} calls  device "
              f"{row['device_ms']:9.3f} ms  cpu {row['cpu_ms']:9.3f} ms")
    line = json.dumps(out)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "moe_batch_profile.json").write_text(line)
    print(line)
    print(smi)


if __name__ == "__main__":
    main()
