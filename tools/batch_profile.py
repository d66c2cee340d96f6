#!/usr/bin/env python3
"""Split one embedding batch (or forward) of a full-width model on one
card.

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
kernel launches. For whisper-base ([whisper]: an encoder-decoder model
the embedding service does not run; 0.166 GB) the batch is
chip_smoke.py's teacher-forced forward over 32 clips of 1500 frames and
448 tokens, and one decode step (from a 4-token prefill, the self cache
padded to 448) is timed and recorded too: its device time against its
wall time. It prints one JSON line (also written to
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
BATCHES = {"qwen3-moe-30b-a3b": (8, 512), "zamba2-2.7b": (4, 2048),
           "whisper-base": (32, 448)}
VOCAB = 32768
WHISPER_FRAMES, WHISPER_PROMPT = 1500, 4


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


def device_split(fn):
    """``fn`` run once under ``torch.profiler``: (its key averages, the
    kernels' device milliseconds in all, their launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the kernels' own rows (an operator's row repeats its kernels' time)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    return (events, sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def encdec_runs(cfg, params, docs, tokens_len, dev) -> dict:
    """The whisper forward, and one decode step from the 4-token prefill
    with the self cache padded to ``tokens_len``, as chip_smoke.py draws
    them."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    model = build_model(cfg)
    gen = torch.Generator(dev).manual_seed(1)
    frames = torch.randn((docs, WHISPER_FRAMES, cfg.d_model), generator=gen,
                         device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (docs, tokens_len),
                           generator=gen, device=dev)
    logits, cache = model.prefill(params, frames, tokens[:, :WHISPER_PROMPT])
    grow = lambda c: torch.cat([c, c.new_zeros(
        c.shape[:2] + (tokens_len - c.shape[2],) + c.shape[3:])], dim=2)
    cache = {"self": tree_map(grow, cache["self"]), "cross": cache["cross"]}
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    return {"forward": lambda: model.forward(params, frames, tokens),
            "decode_step": lambda: model.decode_step(
                params, tok, WHISPER_PROMPT, cache)}


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
    if cfg.is_encdec:
        runs = encdec_runs(cfg, params, docs, doc_len, dev)
    else:
        corpus = make_corpus(0, n_docs=docs, dim=128, with_tokens=True,
                             vocab=min(VOCAB, cfg.vocab_size),
                             doc_len=doc_len)
        batch = torch.as_tensor(np.stack([corpus.tokens[i]
                                          for i in range(docs)])
                                .astype(np.int32), device=dev)
        dispatches = ("onehot", "sort") if cfg.moe.enabled else ("onehot",)
        runs = {}
        for d in dispatches:
            service = EmbeddingService(cfg, params, batch_size=docs,
                                       device=dev)
            service.model.moe_dispatch = d
            runs[d] = lambda s=service: s.embed_batch(batch)
    ms = {name: cuda_ms(fn, 5) for name, fn in runs.items()}
    events, device_ms, launches = device_split(next(iter(runs.values())))
    rows = sorted((e for e in events if e.key.startswith("aten::")),
                  key=lambda e: -e.device_time_total)[:args.rows]
    top = [{"op": e.key, "calls": e.count,
            "device_ms": e.device_time_total / 1e3,
            "cpu_ms": e.cpu_time_total / 1e3} for e in rows]
    out = {"arch": args.arch, "batch": [docs, doc_len], "nvidia_smi": smi,
           "batch_ms": ms, "profiled_device_ms": device_ms,
           "kernel_launches": launches, "top_ops": top}
    if "decode_step" in runs:
        _, step_device_ms, step_launches = device_split(runs["decode_step"])
        out.update(decode_step_device_ms=step_device_ms,
                   decode_step_launches=step_launches)
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
