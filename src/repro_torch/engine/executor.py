"""Double-buffered scoring executor — the engine's hot path.

Every scoring pass is a three-stage streaming pipeline:

    chunk k+1: host read into a pinned staging buffer + async copy to
               the card on a side stream           (background thread)
    chunk k:   device compute                       (fused CUDA kernel)
    chunk k-1: host write of scores

The JAX package's ``device_put`` double buffering becomes: the prefetch
thread copies each chunk off the ``DocumentStore`` into one of two
pinned host buffers, issues a ``non_blocking`` host-to-device copy on a
side stream and records an event after it; the compute stream waits on
that event before it reads the chunk (``HostStager``, which the offline
ingest's batch feeder shares). A pinned buffer is refilled only after
the event of the copy that last read it has completed. A scoring pass
checks a stager out of the executor's pool and returns it when the pass
ends: session views share one executor, and two passes scoring at once
from two threads must never take the same buffer or event, while one
session's passes keep reusing the same pinned buffers.

Proxy groups always go through the fused multi-query kernel
(``repro_torch.kernels.fused_scoring``), one MLP pass per tile for all
of a proxy's pending query latents; raw-cosine jobs (``params=None``)
are one plain matmul, as in the JAX package. On a CPU device the same
pipeline runs without streams and the kernel wrapper computes its plain
version. ``use_kernel=False`` scores proxy groups with the plain
version on the device instead (path "plain"); the JAX package defaults
to False because its Pallas kernel runs only on a TPU, the port to True.
``interpret=True`` (Pallas interpret mode) has no counterpart and
raises.

A ``mesh`` of more than one device over the ``("pod", "data")`` axes
(``launch.mesh``) takes the shard path, as the JAX package's
``shard_map`` does: each tile is padded to divide the mesh, cut into the
row shards of the logical ``"batch"`` rule (``sharding.rules
.shard_rows``) and each shard copied to its device through that
device's own ``HostStager``; every shard runs the plain chunk programs
(``core.scoring``: ``_proxy_chunk_scores``, also for one query, as
``score_collection`` runs it, and ``_raw_chunk_scores``) on its
device's current stream, under that device, with the proxy params and
query latents copied to each distinct device once a pass; the scores
come back to the host in row order, the padding dropped. No
collective: the shards are independent. A device the mesh repeats
shares its stager, stream and params copy. The path is chosen as in
the JAX package: ``score`` shards whenever the mesh has more than one
device, unless ``use_kernel`` and a proxy (then the fused kernel runs
on ``device`` alone); ``score_multi`` shards only with ``use_kernel``
off. A mesh of one device is the single-device path. Both paths share
one pass loop (``_pass``) and differ in their put and tile program.

Every pass returns a ``ScoringStats`` record with the JAX package's
fields (bytes streamed, tiles scored, per-stage wall clock).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.scoring import (_iter_chunks, _num_docs,
                                      _proxy_chunk_scores, _raw_chunk_scores,
                                      group_jobs)
from repro_torch.device import data_mesh_devices, on_device, resolve_device
from repro_torch.kernels import INTERPRET
from repro_torch.kernels.fused_scoring.ops import score_tile_multi
from repro_torch.models.common import tree_map
from repro_torch.runtime import trace as trace_mod
from repro_torch.sharding.rules import row_shard_ids, shard_rows

DEFAULT_PREFETCH_DEPTH = 2   # chunks the prefetch thread may run ahead
STAGING_SLOTS = 2


@dataclasses.dataclass
class ScoringStats:
    """Per-stage accounting for one (or several merged) scoring passes."""
    docs_scored: int = 0
    queries_scored: int = 0
    tiles_scored: int = 0           # document chunks consumed
    bytes_streamed: int = 0         # host bytes read off the store
    host_io_seconds: float = 0.0    # prefetch thread: store read + copy issue
    compute_seconds: float = 0.0    # consumer: blocked on device compute
    stall_seconds: float = 0.0      # consumer: waiting on an empty queue
    wall_seconds: float = 0.0
    devices: int = 1
    paths: Tuple[str, ...] = ()     # "fused"|"plain"|"matmul"|"shard"

    def merge(self, other: "ScoringStats") -> "ScoringStats":
        """Accumulate another pass into this record (in place)."""
        self.docs_scored += other.docs_scored
        self.queries_scored += other.queries_scored
        self.tiles_scored += other.tiles_scored
        self.bytes_streamed += other.bytes_streamed
        self.host_io_seconds += other.host_io_seconds
        self.compute_seconds += other.compute_seconds
        self.stall_seconds += other.stall_seconds
        self.wall_seconds += other.wall_seconds
        self.devices = max(self.devices, other.devices)
        for p in other.paths:
            if p not in self.paths:
                self.paths = self.paths + (p,)
        return self

    @property
    def overlap_fraction(self) -> float:
        """How much of host I/O hid behind compute (1.0 = fully hidden)."""
        if self.host_io_seconds <= 0:
            return 1.0
        return max(0.0, 1.0 - self.stall_seconds / self.host_io_seconds)


class PrefetchThread:
    """Background producer thread feeding a bounded queue ahead of a
    device-compute consumer (``repro.engine.executor.PrefetchThread``).

    ``depth`` bounds how many items may be resident beyond the one being
    consumed (2 = double buffering). Exceptions in the producer are
    re-raised in the consumer; if the consumer dies (or abandons the
    iterator), the stop event unblocks the producer so the thread and its
    queued buffers are released. The consumer records how long it
    stalled on an empty queue (``stall_seconds``); the producer its
    host-side work (``io_seconds``). Subclasses implement
    ``_produce(*args)`` (the arguments given after ``depth``), pushing
    items through ``_put`` and returning when it reports the consumer
    gone. The scoring ``_Prefetcher`` and the ingest batch feeder share
    this lifecycle.
    """

    _DONE = object()

    def __init__(self, depth: int, *args):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self.io_seconds = 0.0
        self.stall_seconds = 0.0
        self._thread = threading.Thread(target=self._run, args=args,
                                        daemon=True)
        self._thread.start()

    def _run(self, *args):
        try:
            self._produce(*args)
            self._put(self._DONE)
        except BaseException as exc:  # surfaced on the consumer side
            self._put(exc)

    def _produce(self, *args):
        raise NotImplementedError

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        try:
            while True:
                t0 = time.perf_counter()
                item = self._queue.get()
                self.stall_seconds += time.perf_counter() - t0
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self._stop.set()
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=5.0)


class _Prefetcher(PrefetchThread):
    """Pages store chunks host -> device ahead of the scoring compute."""

    def __init__(self, store, chunk: int, depth: int, put_fn):
        super().__init__(depth, store, chunk, put_fn)

    def _produce(self, store, chunk, put_fn):
        for start, block in _iter_chunks(store, chunk):
            if self._stop.is_set():
                return
            t0 = time.perf_counter()
            staged = put_fn(block)
            self.io_seconds += time.perf_counter() - t0
            nbytes = block.shape[0] * block.shape[1] * 4
            if not self._put((start, block.shape[0], nbytes, staged)):
                return


class HostStager:
    """Copies (rows, cols) host arrays to ``device`` as ``dtype``.

    On the card each array goes into one of ``STAGING_SLOTS`` pinned
    host buffers, reused round-robin (a buffer is refilled only after the
    event of the copy that last read it has completed, and grows to the
    largest array seen), and a ``non_blocking`` copy is started on a side
    stream; the call returns ``(tensor, event)``. The consumer calls
    ``wait`` before it reads the tensor. On the CPU it returns a copy
    and no event.
    """

    def __init__(self, device: torch.device, dtype=torch.float32):
        self.device = device
        self.dtype = dtype
        self._np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self._bufs: List[torch.Tensor] = []
        self._events: List[Optional[object]] = [None] * STAGING_SLOTS
        self._next = 0
        self._stream = None

    def _acquire(self, numel: int) -> Tuple[int, torch.Tensor]:
        slot = self._next
        self._next = (slot + 1) % STAGING_SLOTS
        event = self._events[slot]
        if event is not None:
            event.synchronize()
            self._events[slot] = None
        if self._bufs[slot].numel() < numel:
            self._bufs[slot] = torch.empty(numel, dtype=self.dtype,
                                           pin_memory=True)
        return slot, self._bufs[slot]

    def __call__(self, block: np.ndarray):
        if self.device.type == "cpu":
            return torch.tensor(np.asarray(block, self._np_dtype)), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._bufs = [torch.empty(0, dtype=self.dtype, pin_memory=True)
                          for _ in range(STAGING_SLOTS)]
        rows, cols = block.shape
        slot, buf = self._acquire(rows * cols)
        host = buf[:rows * cols].view(rows, cols)
        np.copyto(host.numpy(), block, casting="same_kind")
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev = torch.empty((rows, cols), dtype=self.dtype,
                              device=self.device)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._events[slot] = event
        return dev, event

    def wait(self, tensor: torch.Tensor, event) -> None:
        """Make the current stream wait for ``tensor``'s copy."""
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            tensor.record_stream(compute)


def stage_row_shards(mesh, devices, stagers: Dict[torch.device, HostStager],
                     block: np.ndarray) -> list:
    """A host block whose rows divide ``mesh`` -> ``[(device, shard,
    event)]`` in row order: the row shards of the logical "batch" rule's
    spec (``sharding.rules.row_shard_ids``), each distinct one staged
    once, through the stager of the first of ``devices`` (the mesh's, in
    its order) that holds it."""
    ids, _ = row_shard_ids(mesh, block.shape)
    staged = {}
    for dev, idx, part in zip(devices, ids, shard_rows(mesh, block)):
        if idx not in staged:
            staged[idx] = (dev,) + stagers[dev](part)
    return [staged[i] for i in sorted(staged)]


class ScoringExecutor:
    """Streams a document collection through proxy scoring.

    chunk:          documents per streamed tile.
    use_kernel:     proxy groups through the fused kernel (True) or its
                    plain version on the device (False).
    interpret:      refused: Pallas interpret mode has no counterpart.
    mesh:           None, or a ``launch.mesh.Mesh`` over the ("pod",
                    "data") axes whose devices are of ``device``'s kind:
                    tiles are row-sharded over it (the shard path).
    device:         where scoring runs off the shard path; ``"cuda"`` by
                    default, and it raises when no card is present.
    prefetch_depth: chunks the background thread may run ahead
                    (2 = double buffering; 0/1 = no lookahead). It
                    changes when tiles are read, never their values.
    """

    def __init__(self, *, chunk: int = 8192, use_kernel: bool = True,
                 interpret: bool = False, mesh=None, device="cuda",
                 prefetch_depth: int = DEFAULT_PREFETCH_DEPTH):
        if interpret:
            raise ValueError(INTERPRET)
        self.device = resolve_device(device)
        # the shard path's devices in mesh order; () off the mesh
        self._devices = data_mesh_devices("ScoringExecutor", mesh,
                                          self.device)
        self.use_kernel = use_kernel
        self.mesh = mesh
        self.chunk = chunk
        self.prefetch_depth = prefetch_depth
        # idle stagers by device; a pass owns the ones it checked out
        self._stagers: Dict[torch.device, List[HostStager]] = {}
        self._stager_lock = threading.Lock()

    @property
    def _mesh_size(self) -> int:
        return len(self._devices) or 1

    # -- stagers ----------------------------------------------------------

    def _checkout(self, devices) -> Dict[torch.device, HostStager]:
        """One idle stager a distinct device, for one pass."""
        with self._stager_lock:
            out = {}
            for dev in dict.fromkeys(devices):
                idle = self._stagers.get(dev)
                out[dev] = idle.pop() if idle else HostStager(dev)
            return out

    def _checkin(self, stagers: Dict[torch.device, HostStager],
                 pre: PrefetchThread) -> None:
        # a producer still running (a consumer that died mid-pass) may
        # yet write into the stagers: they are dropped, not returned
        if pre._thread.is_alive():
            return
        with self._stager_lock:
            for dev, stager in stagers.items():
                self._stagers.setdefault(dev, []).append(stager)

    # -- the shard path ---------------------------------------------------

    def _put(self, stagers: Dict[torch.device, HostStager]):
        """The prefetcher's put for the shard path: a tile padded to
        divide the mesh, then ``stage_row_shards``."""
        mesh, devices = self.mesh, self._devices

        def put(block):
            pad = (-block.shape[0]) % len(devices)
            if pad:
                block = np.pad(block, ((0, pad), (0, 0)))
            return stage_row_shards(mesh, devices, stagers, block)
        return put

    def _sharded_fn(self, groups, zq_stacks,
                    stagers: Dict[torch.device, HostStager]):
        """The shard path's tile program: each row shard runs the plain
        chunk programs under its device, with the proxies and query
        latents copied once a pass to each distinct device; every shard
        is launched before any is read, and each group's rows come back
        to the host in order."""
        placed = {dev: [(None if params is None else
                         tree_map(lambda t, d=dev: t.to(d), params),
                         zq.T.to(dev))
                        for (params, _), zq in zip(groups, zq_stacks)]
                  for dev in dict.fromkeys(self._devices)}

        def run(shards):
            parts = []
            for dev, tile, event in shards:
                with on_device(dev):
                    stagers[dev].wait(tile, event)
                    parts.append([
                        _raw_chunk_scores(tile, zq_t) if params is None
                        else _proxy_chunk_scores(params, tile, zq_t)
                        for params, zq_t in placed[dev]])
            return [torch.cat([part[g].cpu() for part in parts])
                    for g in range(len(groups))]
        return run

    def _device_fn(self, groups, zq_stacks, stager: HostStager):
        """The single-device tile program: each group through the fused
        kernel, or its plain version with ``use_kernel`` off."""
        def run(staged):
            tile, event = staged
            stager.wait(tile, event)
            return [score_tile_multi(params, zq, tile,
                                     force_ref=not self.use_kernel).cpu()
                    for (params, _), zq in zip(groups, zq_stacks)]
        return run

    def _pass(self, jobs, store, sharded: bool
              ) -> Tuple[np.ndarray, ScoringStats]:
        """One streaming pass of ``jobs`` over ``store``, on the shard
        path or on ``device``: the two differ in their put and their
        tile program only."""
        n = _num_docs(store)
        t0 = time.perf_counter()
        groups, zq_stacks = group_jobs(jobs, self.device)
        stagers = self._checkout(self._devices if sharded
                                 else (self.device,))
        if sharded:
            put = self._put(stagers)
            run = self._sharded_fn(groups, zq_stacks, stagers)
            paths = ("shard",)
        else:
            put = stagers[self.device]
            run = self._device_fn(groups, zq_stacks, put)
            paths = tuple(sorted({"matmul" if params is None else
                                  "fused" if self.use_kernel else "plain"
                                  for params, _ in groups}))
        pre = _Prefetcher(store, self.chunk, self.prefetch_depth, put)
        out = np.empty((n, len(jobs)), np.float32)
        tiles = nbytes = 0
        compute_s = 0.0
        try:
            for start, rows, tile_bytes, staged in pre:
                tc = time.perf_counter()
                for (_, cols), s in zip(groups, run(staged)):
                    out[start:start + rows, np.asarray(cols)] = \
                        s[:rows].numpy()
                compute_s += time.perf_counter() - tc
                tiles += 1
                nbytes += tile_bytes
        finally:
            self._checkin(stagers, pre)
        stats = ScoringStats(
            docs_scored=n, queries_scored=len(jobs), tiles_scored=tiles,
            bytes_streamed=nbytes, host_io_seconds=pre.io_seconds,
            compute_seconds=compute_s, stall_seconds=pre.stall_seconds,
            wall_seconds=time.perf_counter() - t0,
            devices=self._mesh_size if sharded else 1,
            paths=paths if tiles else ())
        return out, stats

    # -- public API -------------------------------------------------------

    def score(self, params, e_q, store) -> Tuple[np.ndarray, ScoringStats]:
        """One predicate over the collection -> ((N,) scores, stats)."""
        scores, stats = self._pass(
            [(params, e_q)], store, self._mesh_size > 1 and (
                params is None or not self.use_kernel))
        # ambient annotation: lands on the enclosing "score" span (the
        # engine opens one per scoring pass); no-op outside a trace
        trace_mod.annotate(tiles=stats.tiles_scored,
                           bytes_streamed=stats.bytes_streamed,
                           io_seconds=round(stats.host_io_seconds, 6),
                           stall_seconds=round(stats.stall_seconds, 6))
        return scores[:, 0], stats

    def score_multi(self, jobs: Sequence[Tuple[Optional[Dict], np.ndarray]],
                    store) -> Tuple[np.ndarray, ScoringStats]:
        """Many predicates in ONE streaming pass -> ((N, Q) scores, stats).

        jobs: sequence of (params, e_q); ``params=None`` means raw
        cosine. Jobs sharing one params object are grouped and run in
        one kernel launch per tile. Column order follows job order.
        """
        n = _num_docs(store)
        if not jobs:
            return (np.zeros((n, 0), np.float32),
                    ScoringStats(docs_scored=n))
        return self._pass(jobs, store,
                          self._mesh_size > 1 and not self.use_kernel)
