"""Checkpointing of numpy trees: atomic save/restore and step GC
(``repro.checkpoint.checkpoint`` without its async writer and its
re-sharding onto a mesh, which are not ported).

Layout (one directory per step), the JAX package's own, so either
package reads the other's checkpoints:
    <dir>/step_000123/manifest.json   — leaf shapes and dtypes, mesh
                                        signature, user metadata
    <dir>/step_000123/arrays.npz      — flat leaves by "/"-joined path
    <dir>/step_000123/.complete      — commit marker (atomicity)
A step is written under ``.tmp_step_*`` and renamed into place.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_STORED = (np.float64, np.float32, np.float16, np.int64, np.int32,
           np.int16, np.int8, np.uint8, np.bool_)


def flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict/list tree in the order
    ``jax.tree_util.tree_flatten_with_path`` gives them (dict keys
    sorted), with the path's keys joined by "/"."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in flatten_with_paths(x, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _map_with_paths(fn, tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, x, prefix + (str(i),))
                          for i, x in enumerate(tree))
    return fn("/".join(prefix), tree)


def save(directory: str, step: int, tree: Any,
         metadata: Optional[Dict] = None) -> Path:
    """Synchronous atomic save of a tree of numpy arrays or scalars."""
    base = Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:09d}"
    tmp = base / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {}
    # one device: the mesh signature the JAX package records is empty
    manifest = {"step": step, "mesh_signature": "",
                "metadata": metadata or {}, "leaves": {}}
    for key, leaf in flatten_with_paths(tree):
        arr = np.asarray(leaf)
        dtype_name = str(arr.dtype)
        if arr.dtype not in _STORED:
            arr = arr.astype(np.float32)  # bf16/fp8: store widened
        arrays[key] = arr
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": dtype_name}
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    (tmp / ".complete").write_text(str(time.time()))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def list_steps(directory: str) -> List[int]:
    base = Path(directory)
    if not base.exists():
        return []
    steps = []
    for p in base.iterdir():
        if p.name.startswith("step_") and (p / ".complete").exists():
            steps.append(int(p.name.split("_")[1]))
    return sorted(steps)


def gc_old_steps(directory: str, keep: int) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(Path(directory) / f"step_{s:09d}", ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int,
            target_tree: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree`` (shapes validated,
    each leaf cast to its target's dtype); returns (tree, manifest)."""
    path = Path(directory) / f"step_{step:09d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as data:
        def load(key, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            expect = tuple(np.shape(leaf))
            if tuple(arr.shape) != expect:
                raise ValueError(
                    f"leaf {key!r} shape {arr.shape} != expected {expect}")
            dtype = np.asarray(leaf).dtype
            return arr.astype(dtype) if arr.dtype != dtype else arr
        tree = _map_with_paths(load, target_tree)
    return tree, manifest
