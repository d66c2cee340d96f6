"""Build the port's CUDA sources and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/kernels/lib<name>_<digest>.so`` under the repository root (a
directory ``.gitignore`` lists). The digest covers the source and the
flags, so an edited source never loads a stale library. Nothing is built
when a module is imported: a library is built at its first launch, or
all at once, in parallel, by ``build_all``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def _tmp_path(name: str) -> Path:
    out = library_path(name)
    return out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    if library_path(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_path(name)
    log = open(BUILD_DIR / f"{name}.log", "w")
    try:
        return subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {rc}):\n"
                           f"{build_log(name)}")
    os.replace(_tmp_path(name), library_path(name))


def build_all(names: Iterable[str]) -> float:
    """Build every named library not yet built, one nvcc each, all
    started together; returns the wall seconds spent."""
    t0 = time.perf_counter()
    names = list(names)
    with _lock:
        procs = [(n, _start(n)) for n in names]
        for n, p in procs:
            _finish(n, p)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


class CudaKernel:
    """One C entry point of a built library, with a count of launches.

    ``launch`` passes tensors as device pointers, appends the current
    stream of ``device``, raises on a non-zero CUDA error code, and only
    then adds one to ``launches``, under a lock, so that a count taken
    while several threads launch is exact.
    """

    def __init__(self, library: str, symbol: str,
                 argtypes: Sequence):
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self._count_lock = threading.Lock()
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._entry()
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*conv, stream)
        if err != 0:
            msg = load(self.library).kernel_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err} "
                               f"({msg})")
        with self._count_lock:
            self.launches += 1
