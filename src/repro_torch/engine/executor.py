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
version. One device only: the ``shard_map`` mesh path is not ported.

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

from repro_torch.core.scoring import _iter_chunks, _num_docs, group_jobs
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_scoring.ops import score_tile_multi
from repro_torch.runtime import trace as trace_mod

PREFETCH_DEPTH = 2      # chunks the prefetch thread may run ahead
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
    paths: Tuple[str, ...] = ()     # compute paths used ("fused"|"matmul")

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

    def __init__(self, store, chunk: int, put_fn):
        super().__init__(PREFETCH_DEPTH, store, chunk, put_fn)

    def _produce(self, store, chunk, put_fn):
        for start, block in _iter_chunks(store, chunk):
            if self._stop.is_set():
                return
            t0 = time.perf_counter()
            dev, event = put_fn(block)
            self.io_seconds += time.perf_counter() - t0
            nbytes = block.shape[0] * block.shape[1] * 4
            if not self._put((start, block.shape[0], nbytes, dev, event)):
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
        with torch.cuda.stream(self._stream):
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


class ScoringExecutor:
    """Streams a document collection through proxy scoring.

    chunk:  documents per streamed tile.
    device: where scoring runs; ``"cuda"`` by default, and it raises
            when no card is present.
    """

    def __init__(self, *, chunk: int = 8192, device="cuda"):
        self.device = resolve_device(device)
        self.chunk = chunk
        # idle stagers; a pass owns the one it checked out
        self._stagers: List[HostStager] = []
        self._stager_lock = threading.Lock()

    def score(self, params, e_q, store) -> Tuple[np.ndarray, ScoringStats]:
        """One predicate over the collection -> ((N,) scores, stats)."""
        scores, stats = self.score_multi([(params, e_q)], store)
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
        t0 = time.perf_counter()
        groups, zq_stacks = group_jobs(jobs, self.device)
        with self._stager_lock:
            stager = (self._stagers.pop() if self._stagers
                      else HostStager(self.device))
        pre = _Prefetcher(store, self.chunk, stager)
        out = np.empty((n, len(jobs)), np.float32)
        tiles = nbytes = 0
        compute_s = 0.0
        paths = set()
        try:
            for start, rows, tile_bytes, tile, event in pre:
                tc = time.perf_counter()
                stager.wait(tile, event)
                for (params, cols), zq in zip(groups, zq_stacks):
                    s = score_tile_multi(params, zq, tile)
                    paths.add("matmul" if params is None else "fused")
                    out[start:start + rows, np.asarray(cols)] = \
                        s.cpu().numpy()
                compute_s += time.perf_counter() - tc
                tiles += 1
                nbytes += tile_bytes
        finally:
            # a producer still running (a consumer that died mid-pass)
            # may yet write into the stager: it is dropped, not returned
            if not pre._thread.is_alive():
                with self._stager_lock:
                    self._stagers.append(stager)
        stats = ScoringStats(
            docs_scored=n, queries_scored=len(jobs), tiles_scored=tiles,
            bytes_streamed=nbytes, host_io_seconds=pre.io_seconds,
            compute_seconds=compute_s, stall_seconds=pre.stall_seconds,
            wall_seconds=time.perf_counter() - t0, devices=1,
            paths=tuple(sorted(paths)))
        return out, stats
