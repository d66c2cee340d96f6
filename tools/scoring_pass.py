#!/usr/bin/env python3
"""Time one scoring pass of the port's executor on one card, for one
source tree or for two in turns.

    python3 tools/scoring_pass.py                      # this checkout
    python3 tools/scoring_pass.py --against OTHER_ROOT # two trees in turns

A pass is ``ScoringExecutor.score`` over the main path's collection
(131,072 documents of width 4096, f32 random normals in memory) with a
``ProxyConfig()`` proxy drawn from a seed: the host stages each 8192-row
tile in pinned memory, copies it to the card on a side stream, and the
fused kernel scores it. Each tree runs in a process of its own (it
imports that tree's ``src/repro_torch``), which times one warm-up pass and
then ``--passes`` passes, and reports ``ScoringStats``'s split of each:
``host_io_seconds``, ``compute_seconds``, ``stall_seconds``,
``overlap_fraction`` and the wall. With ``--against``, the trees run in
the order this, other, other, this. It prints one JSON line per process
and the card's name and power limit, and exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_DOCS, DIM = 131_072, 4096


def one_tree(passes: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.config import ProxyConfig
    from repro_torch.core.encoder import encoder_init, tree_map
    from repro_torch.engine import InMemoryStore, ScoringExecutor
    if not torch.cuda.is_available():
        raise SystemExit("no card")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    store = InMemoryStore(rng.standard_normal((N_DOCS, DIM),
                                              dtype=np.float32))
    params = tree_map(lambda t: t.to(dev), encoder_init(
        torch.Generator().manual_seed(0), ProxyConfig(embed_dim=DIM)))
    e_q = rng.standard_normal(DIM, dtype=np.float32)
    ex = ScoringExecutor(device=dev)
    ex.score(params, e_q, store)
    rows = []
    for _ in range(passes):
        torch.cuda.synchronize()
        _, st = ex.score(params, e_q, store)
        rows.append({"host_io_seconds": st.host_io_seconds,
                     "compute_seconds": st.compute_seconds,
                     "stall_seconds": st.stall_seconds,
                     "overlap_fraction": st.overlap_fraction,
                     "wall_seconds": st.wall_seconds})
    return {"passes": rows}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", default=None)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--child-src", default=None)
    args = ap.parse_args()
    if args.child_src:
        sys.path.insert(0, args.child_src)
        print(json.dumps(one_tree(args.passes)), flush=True)
        return
    trees = [ROOT]
    if args.against:
        other = Path(args.against).resolve()
        trees = [ROOT, other, other, ROOT]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for tree in trees:
        res = subprocess.run(
            [sys.executable, __file__, "--child-src", str(tree / "src"),
             "--passes", str(args.passes)],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-2000:], file=sys.stderr)
            sys.exit(1)
        out = json.loads(res.stdout.strip().splitlines()[-1])
        out["tree"] = str(tree)
        print(json.dumps(out), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
