#!/usr/bin/env python3
"""chip_smoke.py's [model_axis] phase alone, at its full sizes (~2 minutes).

    python3 tools/model_axis_phase.py     # from the repo root, on the card
    python3 tools/model_axis_phase.py --mesh 2,2   # four ranks (four cards)

Builds the kernels and runs ``chip_smoke.model_axis_phase``: two SPMD
ranks on a (1, 2) mesh (``cuda:0`` twice over the port's ``repro_gloo``
backend on one card; ``cuda:0`` and ``cuda:1`` over NCCL where there are
two or more), (a) smollm-360m FULL for ``AXIS_STEPS`` Trainer steps at
``AXIS_BATCH`` x 4,096 against the single-device Trainer, (b) llama3-8b
at full width cut to ``AXIS_LLAMA_LAYERS`` layers for one step at
``AXIS_LLAMA_SHAPE``, (c) (a)'s checkpoint restored onto a one-device
mesh, and the ``flash_attention_model_axis`` kernel entry; ``--mesh
D,M`` another (data, model) mesh of D x M ranks (one a card where there
are as many, else sharing them in turn). It prints the
phase's lines and the entry, and writes
``chiprun_out/model_axis_phase_<D>x<M>.json``; it exits 1 without a card or when
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
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,2", help="data,model")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("model_axis_phase: no card", file=sys.stderr)
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
    cs.AXIS_MESH = tuple(int(n) for n in args.mesh.split(","))
    kernels = []
    report = cs.model_axis_phase(dev, kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    cs.log(f"[total] {time.perf_counter() - t_all:.1f} s")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "model_axis_phase_{}x{}.json".format(*cs.AXIS_MESH)
    (out / name).write_text(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
