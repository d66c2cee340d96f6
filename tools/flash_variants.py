#!/usr/bin/env python3
"""Time variants of the bf16 flash kernel at wide heads on one card.

    python3 tools/flash_variants.py                    # from the repo root
    python3 tools/flash_variants.py --against OLD.cu   # and compare SASS

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` with some of
its lines replaced. All are built at once, one nvcc each, into
``build/variants/``; ptxas's registers and spills of each variant's
hd-240 bf16 entry are read from its build log; each is called through its
C entry point at gemma3-12b's shape (b 4, s 2048, 16 heads over 8 KV
heads, head_dim 240, causal, with window 1024 and without), checked
against the plain version (``ref.attention_blocked(..., round_p=True)``
on the kernel's tiles, rtol = atol = 8e-3), and timed with CUDA events in
turns (every variant, then the same in reverse order, then forward
again). With ``--against``, the SASS of every instantiation that both the
committed source and OLD.cu build is compared, instruction by
instruction (``cuobjdump -sass``); a kernel with its LSE flag off is
matched to the same kernel of a source from before the flag
(``sass_key``). It prints one line a variant and
writes ``build/variants/flash_variants.json``. It exits 1 without a card,
or when a variant fails to build or disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (4, 2048, 16, 8, 240)             # b, s, heads, KV heads, head_dim
WINDOWS = (0, 1024)
TOL = 8e-3
# the two choices of the wide kernel, each taken back: K/V tiles of 64
# keys (one block an SM), and Q's fragments held in registers; and the
# k-steps of S = Q K^T unrolled less than fully (every head width), to
# see whether the spill at HD 240 comes from loads hoisted ahead
TILE_KEYS = "  return HD <= 128 ? BK : 32;\n"
Q_REGS = ("  constexpr bool Q_IN_REGS = HD <= 128;   "
          "// else read at each k-step\n")
QK_LOOP = ("#pragma unroll\n    for (int kk = 0; kk < KSTEPS; ++kk) {\n"
           "      if constexpr (Q_IN_REGS) {\n")
VARIANTS = {
    "as committed": [],
    "64-key tiles (one block an SM)": [
        (TILE_KEYS, TILE_KEYS.replace(": 32", ": 64"))],
    "Q held in registers": [(Q_REGS, Q_REGS.replace("HD <= 128", "true"))],
    "Q K^T k-steps unrolled by 5": [
        (QK_LOOP, QK_LOOP.replace("unroll\n", "unroll 5\n"))],
    "Q K^T k-steps not unrolled": [
        (QK_LOOP, QK_LOOP.replace("unroll\n", "unroll 1\n"))],
}


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def ptxas_wide_entry(log: str) -> dict:
    """Registers and spills of the bf16 kernel's HD 240 entry (the form
    without the LSE output)."""
    for chunk in log.split("Compiling entry function")[1:]:
        if not re.search(r"flash_fwd_bf16_kernelILi240E(Lb0E)?E",
                         chunk.split("\n", 1)[0]):
            continue
        get = lambda pat: int(m.group(1)) if (m := re.search(pat, chunk)) \
            else 0
        return {"registers": get(r"Used (\d+) registers"),
                "spill_stores": get(r"(\d+) bytes spill stores"),
                "spill_loads": get(r"(\d+) bytes spill loads")}
    return {}


def sass_key(mangled: str):
    """A kernel's key for the comparison: its mangled name with the
    file's own anonymous-namespace prefix taken off, and for a kernel
    with the LSE flag off the flag (``Lb0E``) and its trailing ``float*
    lse`` parameter (``Pf``) taken off too, so it matches the same
    kernel of a source from before the flag. An LSE form (``Lb1E``) has
    no counterpart there: None."""
    name = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}", "", mangled)
    if "Lb1E" in name:
        return None
    if "Lb0E" in name and name.endswith("Pf"):
        name = name.replace("Lb0E", "")[:-2]
    return name


def sass_functions(lib: Path) -> dict:
    """Each kernel's SASS instructions, keyed by ``sass_key``."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                          str(lib)], capture_output=True, text=True,
                         check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = sass_key(m.group(1))
            if cur is not None:
                funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(.*?)\s*;", line)
        if cur is not None and m:
            funcs[cur].append(m.group(1))
    return funcs


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--against", type=Path, default=None,
                        help="an older flash_attention.cu whose SASS to "
                             "compare with the committed source's")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no card", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention import ref as f_ref

    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    sources = {name: variant_source(src, subs)
               for name, subs in VARIANTS.items()}
    if args.against is not None:
        sources["against"] = args.against.read_text()
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out_dir / f"flash_v{i}.cu"
        cu.write_text(text)
        log = open(out_dir / f"flash_v{i}.log", "w")
        procs[name] = (i, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"libflash_v{i}.so"), str(cu)],
            stdout=log, stderr=subprocess.STDOUT))
        log.close()
    libs, regs = {}, {}
    for name, (i, proc) in procs.items():
        rc = proc.wait()
        text = (out_dir / f"flash_v{i}.log").read_text()
        if rc != 0:
            print(f"flash_variants: {name} failed to build:\n{text}",
                  file=sys.stderr)
            sys.exit(1)
        libs[name] = out_dir / f"libflash_v{i}.so"
        regs[name] = ptxas_wide_entry(text)
    report = {"shape": SHAPE, "windows": WINDOWS, "ptxas": regs}

    if args.against is not None:
        new, old = (sass_functions(libs[n]) for n in ("as committed",
                                                      "against"))
        same = {n: new[n] == old[n] for n in sorted(set(new) & set(old))}
        report["sass_same_as_against"] = same
        for n, eq in same.items():
            print(f"SASS {'identical' if eq else 'DIFFERS'}: {n} "
                  f"({len(new[n])} instructions here, {len(old[n])} in "
                  f"{args.against.name})")
        del libs["against"]

    dev = torch.device("cuda", 0)
    b, s, h, kv, hd = SHAPE
    gen = torch.Generator(dev).manual_seed(0)
    q = torch.randn((b, s, h, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, kv, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    scale = hd ** -0.5
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.flash_attention_launch
        fn.argtypes = f_ops.KERNEL.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(fn, out, window):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None, b, s, s, h, kv, hd, 1, window, 0, 1, scale,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    out = torch.empty_like(q)
    errs = {}
    for window in WINDOWS:
        plain = f_ref.attention_blocked(
            q, f_ref.expand_kv(k, h // kv), f_ref.expand_kv(v, h // kv),
            scale, causal=True, window=window, q_block=64, kv_block=32,
            round_p=True).float()
        for name, fn in fns.items():
            call(fn, out, window)
            torch.cuda.synchronize()
            ok = torch.allclose(out.float(), plain, rtol=TOL, atol=TOL)
            errs[f"{name} window={window}"] = (out.float() - plain).abs() \
                .max().item()
            if not ok:
                print(f"flash_variants: {name} (window {window}) disagrees "
                      f"with the plain version", file=sys.stderr)
                sys.exit(1)
        del plain
    report["max_abs_err"] = errs

    times = {f"{n} window={w}": [] for n in fns for w in WINDOWS}
    order = list(fns)
    for turn in (order, order[::-1], order):
        for name in turn:
            for window in WINDOWS:
                for _ in range(3):
                    call(fns[name], out, window)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call(fns[name], out, window)
                end.record()
                torch.cuda.synchronize()
                times[f"{name} window={window}"].append(
                    start.elapsed_time(end) / 20)
    report["ms"] = times
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report["nvidia_smi"] = smi
    print(smi)
    for name in fns:
        ms = ", ".join(f"window {w}: " + "/".join(
            f"{t:.4f}" for t in times[f"{name} window={w}"]) + " ms"
            for w in WINDOWS)
        print(f"{name}: {json.dumps(regs[name])}; {ms}")
    (out_dir / "flash_variants.json").write_text(json.dumps(report,
                                                            indent=2))


if __name__ == "__main__":
    main()
