#!/usr/bin/env python3
"""Time variants of the fused scoring kernel against each other on one card.

    python3 tools/fused_variants.py          # from the root of the repository

Each variant is ``src/repro_torch/csrc/fused_scoring.cu`` with some of its
``constexpr int`` tiling constants replaced, or some lines of its main
loop. All are built at once, one nvcc each, into
``build/variants/``; each is called through its C entry point at the main
path's shape (n=8192, D=4096, H=512, L=128, Q=1), checked against the
plain version (``ref.ref_scores_multi``) to 1e-5 unless it is a
diagnostic, and timed with CUDA events in turns (every variant and the
plain version, then the same in reverse order, then forward again). It
prints one line a variant and writes ``build/variants/fused_variants.json``.
It exits 1 without a card, or when a variant fails to build or disagrees.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (8192, 4096, 512, 128, 1)            # n, d, h, l, q
TOL = 1e-5
# name -> constants to replace, and under "sub" (old, new) lines: the
# line that fetches the next slice, swapped for one that fetches only the
# first ones; the FMA loop nest, with its two loops swapped
NO_COPIES = ("    fetch(t + STAGES - 1);",
             "    fetch(t + STAGES - 1 < STAGES ? t + STAGES - 1 : nt);")
COLUMNS_OUTER = ("""        for (int r = 0; r < T::ROWS; ++r)
#pragma unroll
          for (int j = 0; j < T::COLS; ++j)
""", """        for (int j = 0; j < T::COLS; ++j)
#pragma unroll
          for (int r = 0; r < T::ROWS; ++r)
""")
VARIANTS = {
    "as committed": {},
    "first design: 256 threads of 8 x 16, layer 1 in 16-deep slices, "
    "2 stages": {"THREADS": 256, "BK1": 16, "STAGES1": 2},
    "256 threads of 8 x 16": {"THREADS": 256},
    "layer 1 in 32-deep slices, 2 stages": {"STAGES1": 2},
    "layer 1 in 16-deep slices, 2 stages": {"BK1": 16, "STAGES1": 2},
    "layer 1 in 16-deep slices, 4 stages": {"BK1": 16, "STAGES1": 4},
    "FMA loop over columns outside rows": {"sub": [COLUMNS_OUTER]},
    "diagnostic: no copies after the first slices": {"sub": [NO_COPIES]},
}


def variant_source(src: str, spec: dict) -> str:
    for key, value in spec.items():
        if key == "sub":
            for old, new in value:
                assert src.count(old) == 1, old
                src = src.replace(old, new)
            continue
        src, count = re.subn(rf"constexpr int {key} = \d+;",
                             f"constexpr int {key} = {value};", src)
        assert count == 1, key
    return src


def ptxas(log: str) -> dict:
    """Registers of the path's instantiation (H=512, L=128, 16-byte
    copies) and the spill stores summed over all instantiations."""
    import chip_smoke
    entries = chip_smoke.ptxas_entries(log)
    path = [r for name, r in entries.items()
            if "ILi512ELi128ELb1E" in name]
    return {"registers": path[0]["registers"] if path else None,
            "spill_stores_all": sum(r["spill_stores"]
                                    for r in entries.values())}


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fused_variants: no card", file=sys.stderr)
        sys.exit(1)
    import chip_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_scoring import ref
    dev = torch.device("cuda", 0)
    resolve_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[variants] {torch.cuda.get_device_name(0)}; {smi}", flush=True)

    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_scoring.cu").read_text()
    procs = {}
    for i, (name, spec) in enumerate(VARIANTS.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(variant_source(src, spec))
        with open(out_dir / f"v{i}.log", "w") as log:
            procs[name] = (i, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(out_dir / f"libv{i}.so"), str(cu)],
                stdout=log, stderr=subprocess.STDOUT))
    fns, report = {}, {"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": smi, "shape": SHAPE, "variants": {}}
    for name, (i, proc) in procs.items():
        rc = proc.wait()
        log = (out_dir / f"v{i}.log").read_text()
        if rc != 0:
            print(f"[variants] {name}: build failed\n{log[-3000:]}",
                  file=sys.stderr)
            sys.exit(1)
        fn = ctypes.CDLL(str(out_dir / f"libv{i}.so")).fused_scores_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        report["variants"][name] = {"spec": VARIANTS[name], **ptxas(log)}

    n, d, h, l, q = SHAPE
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(n, d)) / np.sqrt(d)
    ws = [rng.normal(size=s) / np.sqrt(s[0]) for s in ((d, h), (h, h),
                                                        (h, l))]
    bs = [0.1 * rng.normal(size=s) for s in (h, h, l)]
    zq = rng.normal(size=(q, l))
    zq /= np.linalg.norm(zq, axis=1, keepdims=True)
    args = [torch.tensor(x, dtype=torch.float32, device=dev) for x in
            [docs, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], zq]]
    want = ref.ref_scores_multi(*args)

    def call(fn):
        out = torch.empty((n, q), dtype=torch.float32, device=dev)
        err = fn(*[a.data_ptr() for a in args], out.data_ptr(), n, d, h, l,
                 q, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    for name, fn in fns.items():
        got = call(fn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        report["variants"][name]["max_abs_err"] = err
        if "diagnostic" not in name and not err <= TOL:
            print(f"[variants] {name}: max abs err {err:.3e} > {TOL}",
                  file=sys.stderr)
            sys.exit(1)
    timed = {name: (lambda fn=fn: call(fn)) for name, fn in fns.items()}
    timed["plain version"] = lambda: ref.ref_scores_multi(*args)
    times = {name: [] for name in timed}
    order = list(timed)
    for rnd in range(3):
        for name in order if rnd % 2 == 0 else order[::-1]:
            times[name].append(chip_smoke.cuda_ms(timed[name], 30))
    for name, ms in times.items():
        entry = report["variants"].setdefault(name, {})
        entry["ms"] = ms
        extra = "" if name == "plain version" else (
            f"; {entry['registers']} registers (path instantiation), "
            f"{entry['spill_stores_all']} B spill stores (all); max abs err "
            f"{entry['max_abs_err']:.3e}")
        print(f"[variants] {name}: " + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms{extra}", flush=True)
    (out_dir / "fused_variants.json").write_text(json.dumps(report,
                                                            indent=2))


if __name__ == "__main__":
    main()
