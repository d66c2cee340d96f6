"""Roofline report (``repro.launch.roofline``).

Aggregates the per-cell dry-run JSONs (``launch.dryrun``; the JAX
package's cell layout, read as it is) into a table: per (arch x shape x
mesh) the three roofline terms, the dominant one, MODEL_FLOPS (6·N·D
train / 2·N_active·D serve) against the counted FLOPs, and a one-line
"what would move the dominant term" nudge.

The denominators are one NVIDIA H100 SXM's, from NVIDIA's data sheet:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3 and 450
GB/s each way over NVLink.

    PYTHONPATH=src python -m repro_torch.launch.roofline --dir runs/dryrun_torch

``--memory`` adds to each row the port's dry-run memory per device
(arguments and the peak of temporaries, against one card's 80 GB), the
train cells' microbatch count and the rules' divisibility fallbacks
(``render_memory_table``).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.config import SHAPES_BY_NAME, get_arch

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
ICI_BW = 450e9


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_arch(arch)
    shape = SHAPES_BY_NAME[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


NUDGES = {
    "compute": "raise tensor-core utilization: larger per-device batch, "
               "fewer eager elementwise kernels between the products "
               "(fuse them), drop remat where memory allows",
    "memory": "cut HBM round-trips: keep attention/WKV tiles in shared "
              "memory and registers (hand-written kernels), bf16 "
              "intermediates, avoid one-hot dispatch materialization",
    "collective": "overlap or shrink collectives: 2D-shard weights to "
                  "reduce all-gather volume over NVLink, int8-compress DP "
                  "grads, schedule all-reduce during backward",
}


def load_cells(directory: str, tag: str = "") -> List[Dict]:
    cells = []
    for p in sorted(Path(directory).glob("*.json")):
        parts = p.stem.split("__")
        if tag:
            if len(parts) < 4 or parts[3] != tag:
                continue
        elif len(parts) != 3:
            continue
        cells.append(json.loads(p.read_text()))
    return cells


def summarize(cell: Dict) -> Optional[Dict]:
    if cell.get("status") != "ok":
        return None
    arch, shape = cell["arch"], cell["shape"]
    mf = model_flops(arch, shape)
    per_dev = cell["analyzer"]["flops_per_device"]
    chips = cell["chips"]
    hlo_total = per_dev * chips
    r = cell["roofline"]
    t_total = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
    # roofline fraction: useful-FLOPs time at peak vs modeled bottleneck time
    t_ideal = mf / (chips * PEAK_FLOPS)
    return {
        "arch": arch, "shape": shape, "mesh": cell["mesh"],
        "t_compute": r["t_compute_s"], "t_memory": r["t_memory_s"],
        "t_collective": r["t_collective_s"], "dominant": r["dominant"],
        "model_flops": mf, "hlo_flops": hlo_total,
        "useful_ratio": mf / hlo_total if hlo_total else 0.0,
        "roofline_fraction": t_ideal / t_total if t_total else 0.0,
        "fallbacks": len(cell.get("sharding_fallbacks", [])),
        "temp_gb": (cell["memory"]["temp_bytes_per_device"] or 0) / 1e9,
        "nudge": NUDGES[r["dominant"]],
    }


def render_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | t_comp(s) | t_mem(s) | t_coll(s) | "
           "dominant | MODEL/HLO | roofline-frac | temp GB/dev |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute']:.3g} | {r['t_memory']:.3g} "
            f"| {r['t_collective']:.3g} | {r['dominant']} "
            f"| {r['useful_ratio']:.3f} | {r['roofline_fraction']:.4f} "
            f"| {r['temp_gb']:.1f} |")
    return "\n".join(lines)


CARD_GB = 80.0


def render_memory_table(cells: List[Dict]) -> str:
    """``render_table``'s columns (its last the temporaries' peak a
    device), then the arguments a device, the two's sum as a share of
    ``CARD_GB``, the microbatches and the fallbacks, for the dry run's ok
    cells."""
    ok = [c for c in cells if c.get("status") == "ok"]
    table = render_table([summarize(c) for c in ok]).splitlines()
    lines = [table[0] + " args GB/dev | (args+temp)/80 GB | microbatches "
             "| fallbacks |", "|" + "---|" * 14]
    for c, line in zip(ok, table[2:]):
        args = c["memory"]["argument_bytes_per_device"] / 1e9
        temp = (c["memory"]["temp_bytes_per_device"] or 0) / 1e9
        lines.append(f"{line} {args:.2f} | {(args + temp) / CARD_GB:.3f} | "
                     f"{c.get('microbatches') or '-'} | "
                     f"{len(c.get('sharding_fallbacks', []))} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--memory", action="store_true",
                    help="add per-device memory, microbatches, fallbacks")
    args = ap.parse_args()
    if args.memory:
        cells = sorted((c for c in load_cells(args.dir, args.tag)
                        if c["mesh"] == args.mesh),
                       key=lambda c: (c["arch"], c["shape"]))
        print(render_memory_table(cells))
    else:
        rows = [s for c in load_cells(args.dir, args.tag)
                if (s := summarize(c)) and s["mesh"] == args.mesh]
        rows.sort(key=lambda r: (r["arch"], r["shape"]))
        print(render_table(rows))
    skips = [c for c in load_cells(args.dir, args.tag)
             if c.get("status") == "skipped" and c["mesh"] == args.mesh]
    if skips:
        print("\nSkipped cells:")
        for c in skips:
            print(f"  - {c['arch']} x {c['shape']}: {c['reason']}")


if __name__ == "__main__":
    main()
