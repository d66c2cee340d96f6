#!/usr/bin/env python3
"""Compare the SASS of every kernel in one of the port's CUDA sources
with an older copy's, instruction by instruction (``cuobjdump -sass``),
as ``tools/flash_variants.py --against`` does for the flash source: how
to show that a change to host-side set-up left the device code as it
was.

    python3 tools/sass_against.py wkv6 build/parent_wkv6.cu   # on the card's machine

Both are built with ``kernels._build``'s flags into ``build/sass/``. It
prints one line a kernel and exits 1 when any differs or is missing on
one side.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))


def main() -> None:
    from flash_variants import sass_functions
    from repro_torch.kernels import _build
    name, older = sys.argv[1], Path(sys.argv[2])
    out = ROOT / "build" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    funcs = {}
    for side, src in (("new", _build.CSRC / f"{name}.cu"), ("old", older)):
        lib = out / f"lib{name}_{side}.so"
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
        funcs[side] = sass_functions(lib)
    new, old = funcs["new"], funcs["old"]
    same_all = True
    for fn in sorted(set(new) | set(old)):
        same = new.get(fn) == old.get(fn)
        same_all &= same
        print(f"SASS {'identical' if same else 'DIFFERS'}: {fn} "
              f"({len(new.get(fn, []))} instructions here, "
              f"{len(old.get(fn, []))} in {older.name})")
    sys.exit(0 if same_all else 1)


if __name__ == "__main__":
    main()
