#!/usr/bin/env python3
"""chip_smoke.py's [rwkv_axis] phase alone, at its full sizes.

    python3 tools/rwkv_axis_phase.py     # from the repo root, on the card

Builds the kernels and runs ``chip_smoke.rwkv_axis_phase``: two SPMD
ranks on a (1, 2) mesh (``cuda:0`` twice over the port's ``repro_gloo``
backend on one card; ``cuda:0`` and ``cuda:1`` over NCCL where there are
two or more) holding half of rwkv6-7b's heads each, (a) the Trainer
("direct" mode) on ``RWKV_AXIS_TRAIN_LAYERS`` layers at 1 x 4,096, (b)
the factored prefill plan at 32,768 tokens, the decode plan's steps from
its state and ``generate`` on ``RWKV_AXIS_SERVE_LAYERS`` layers, (c) the
same layers in the kernel mode (the prefill, ``generate``, layer 1's
time-mix in float32 and the kernel's rows on a rank's heads), each
against one device, and the ``wkv6_intra_chunk_rwkv_axis`` kernel entry.
It prints the phase's lines and the entry, and writes
``chiprun_out/rwkv_axis_phase.json``; it exits 1 without a card or when
a gate fails.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("rwkv_axis_phase: no card", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    _build.build_all(("fused_scoring", "contrastive", "flash_attention",
                      "wkv6"))
    dev = torch.device("cuda", 0)
    resolve_device(dev)
    cs.log(f"[device] {torch.cuda.get_device_name(0)} "
           f"x{torch.cuda.device_count()}")
    kernels = []
    report = cs.rwkv_axis_phase(dev, kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    cs.log(f"[total] {time.perf_counter() - t_all:.1f} s")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "rwkv_axis_phase.json").write_text(
        json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
