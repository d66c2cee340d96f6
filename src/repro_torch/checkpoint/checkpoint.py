"""Checkpointing: atomic tree save/restore, an async writer and step GC
(``repro.checkpoint.checkpoint``).

Layout (one directory per step), the JAX package's own, so either
package reads the other's checkpoints:
    <dir>/step_000123/manifest.json   — leaf shapes and dtypes, mesh
                                        signature, user metadata
    <dir>/step_000123/arrays.npz      — flat leaves by "/"-joined path
    <dir>/step_000123/.complete      — commit marker (atomicity)
A step is written under ``.tmp_step_*`` and renamed into place.

Leaves are numpy arrays, scalars or torch tensors (copied to the host).
A bfloat16 leaf is stored widened to float32 with "bfloat16" in the
manifest, as the JAX package stores it; bf16 -> f32 -> bf16 is exact,
so the round trip is bitwise. Paths follow
``jax.tree_util.tree_flatten_with_path``: dict keys sorted, a list or
tuple's items by index, and a NamedTuple's fields as ".<name>" (JAX's
``GetAttrKey``), so an ``AdamWState`` reads "1/.mu/..." in a trainer's
(params, opt_state, residual) in both packages.

Under SPMD processes (an initialised process group; DTensor leaves
over ``launch.mesh``'s ``DeviceMesh``) every rank calls ``save``,
``AsyncCheckpointer.save``, ``AsyncCheckpointer.wait`` and
``latest_step`` in the same order: a save gathers each DTensor leaf to
the host on the calling thread (a collective, in the tree's order on
every rank; none runs on the writer thread, where it could deadlock
against the next step's), and rank 0 alone writes. ``wait`` and
``latest_step`` end at a barrier, so no rank reads the directory before
rank 0's write is in it. ``restore(..., shardings=)`` places each leaf
on the current mesh (each rank keeps its slice), whatever mesh wrote
it: a checkpoint of a (1, 2) mesh restores on (1, 1) or (2, 1).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import spmd_mesh

_STORED = (np.float64, np.float32, np.float16, np.int64, np.int32,
           np.int16, np.int8, np.uint8, np.bool_)


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """(key, child) pairs of a node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the order, and with the keys,
    ``jax.tree_util.tree_flatten_with_path`` gives them, the path's keys
    joined by "/" (the JAX package's ``_flatten_with_paths``)."""
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    return [kv for k, x in kids for kv in flatten_with_paths(x, prefix + (k,))]



def _map_with_paths(fn, tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_paths(fn, getattr(tree, f),
                                            prefix + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, x, prefix + (str(i),))
                          for i, x in enumerate(tree))
    return fn("/".join(prefix), tree)


def to_host(leaf) -> Tuple[np.ndarray, str]:
    """(the numpy array stored for ``leaf``, its dtype name for the
    manifest): always a copy, so the caller may change the leaf while an
    async write runs; bfloat16 and other types numpy cannot store are
    widened to float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        elif not t.is_cuda:
            t = t.clone()
        return t.cpu().numpy(), name
    arr = np.array(leaf)
    name = str(arr.dtype)
    if arr.dtype not in _STORED:
        arr = arr.astype(np.float32)  # bf16/fp8: store widened
    return arr, name


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _spmd_rank() -> Optional[int]:
    """This process's rank in the initialised process group, or None."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else None


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _host_leaves(tree) -> List[Tuple[str, np.ndarray, str]]:
    """(path, stored array, dtype name) of every leaf, on the host."""
    return [(key, *to_host(leaf)) for key, leaf in flatten_with_paths(tree)]


def save(directory: str, step: int, tree: Any,
         metadata: Optional[Dict] = None, mesh_signature: str = "") -> Path:
    """Synchronous atomic save of a tree of numpy arrays, scalars or
    tensors (DTensor leaves gathered; rank 0 writes, then every rank
    waits at a barrier). ``mesh_signature`` is "" unless given."""
    leaves = _host_leaves(tree)
    path = Path(directory) / f"step_{step:09d}"
    if _spmd_rank() in (None, 0):
        path = _save_host(directory, step, leaves, metadata, mesh_signature)
    _barrier()
    return path


def _save_host(directory: str, step: int, leaves: List,
               metadata: Optional[Dict], mesh_signature: str) -> Path:
    base = Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:09d}"
    tmp = base / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {}
    manifest = {"step": step, "mesh_signature": mesh_signature,
                "metadata": metadata or {}, "leaves": {}}
    for key, arr, dtype_name in leaves:
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


class AsyncCheckpointer:
    """Saves on a background thread, at most one pending: a newer save
    first waits for the previous one. The tree is copied to the host
    before ``save`` returns, so the caller may go on changing its
    tensors; the write and the GC to the newest ``keep`` steps run on the
    thread. ``host_seconds`` and ``write_seconds`` hold the last save's
    two parts: the copy to the host (the caller waits for it) and the
    write (on the thread)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None
        self.host_seconds: Optional[float] = None
        self.write_seconds: Optional[float] = None

    def save(self, step: int, tree: Any, metadata=None,
             mesh_signature: str = "") -> None:
        self.wait()
        t0 = time.perf_counter()
        leaves = _host_leaves(tree)
        self.host_seconds = time.perf_counter() - t0

        if _spmd_rank() not in (None, 0):
            self.last_saved = step
            return

        def work():
            try:
                t1 = time.perf_counter()
                _save_host(self.directory, step, leaves, metadata,
                           mesh_signature)
                self.write_seconds = time.perf_counter() - t1
                self.last_saved = step
                gc_old_steps(self.directory, self.keep)
            except BaseException as exc:  # noqa: BLE001 — raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the pending write, if any, is on disk; re-raise an
        error the write met. Under SPMD processes every rank then waits
        at a barrier (rank 0's write is on disk for all)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err


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
    """The newest complete step, or None. Under SPMD processes every
    rank calls it: it reads after a barrier."""
    _barrier()
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, target_tree: Any,
            shardings: Any = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree`` (shapes validated);
    returns (tree, manifest). A tensor leaf of the target comes back as
    a tensor of its dtype on its device, any other leaf as a numpy array
    of its dtype. ``shardings`` (a matching tree of ``NamedSharding``s,
    the JAX package's placement onto the current mesh) over a mesh of
    SPMD processes places each tensor leaf there as a DTensor (each rank
    keeps its slice); a DTensor leaf of the target without a sharding
    keeps the target's placement. Shardings over one device change
    nothing; over more from one controller they raise
    ``NotImplementedError``."""
    spmd_mesh("restore", shardings=shardings)
    flat_sh = (None if shardings is None else
               dict(flatten_with_paths(shardings)))
    path = Path(directory) / f"step_{step:09d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as data:
        def load(key, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            expect = tuple(leaf.shape if isinstance(leaf, torch.Tensor)
                           else np.shape(leaf))
            if tuple(arr.shape) != expect:
                raise ValueError(
                    f"leaf {key!r} shape {arr.shape} != expected {expect}")
            if not isinstance(leaf, torch.Tensor):
                dtype = np.asarray(leaf).dtype
                return arr.astype(dtype) if arr.dtype != dtype else arr
            where = leaf.to_local() if _is_dtensor(leaf) else leaf
            t = torch.from_numpy(arr).to(device=where.device,
                                         dtype=leaf.dtype)
            sh = None if flat_sh is None else flat_sh.get(key)
            if sh is not None and getattr(sh.mesh, "device_mesh",
                                          None) is not None:
                from repro_torch.sharding.rules import place
                return place(t, sh)
            if _is_dtensor(leaf):
                from torch.distributed.tensor import distribute_tensor
                return distribute_tensor(t, leaf.device_mesh,
                                         leaf.placements, src_data_rank=None)
            return t
        tree = _map_with_paths(load, target_tree)
    return tree, manifest
