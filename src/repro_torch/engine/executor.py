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
that event before it reads the chunk. A pinned buffer is refilled only
after the event of the copy that last read it has completed.

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


class _Prefetcher:
    """Background thread that pages store chunks host -> device ahead of
    the scoring compute, through a bounded queue.

    ``PREFETCH_DEPTH`` bounds how many chunks may be resident beyond the
    one being consumed. Exceptions in the producer are re-raised in the
    consumer; if the consumer dies (or abandons the iterator), the stop
    event unblocks the producer so the thread and its queued buffers are
    released. The consumer records how long it stalled on an empty queue
    (``stall_seconds``); the producer its host-side work (``io_seconds``).
    """

    _DONE = object()

    def __init__(self, store, chunk: int, put_fn):
        self._queue: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._stop = threading.Event()
        self.io_seconds = 0.0
        self.stall_seconds = 0.0
        self._thread = threading.Thread(target=self._run,
                                        args=(store, chunk, put_fn),
                                        daemon=True)
        self._thread.start()

    def _run(self, store, chunk, put_fn):
        try:
            for start, block in _iter_chunks(store, chunk):
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                dev, event = put_fn(block)
                self.io_seconds += time.perf_counter() - t0
                nbytes = block.shape[0] * block.shape[1] * 4
                if not self._put((start, block.shape[0], nbytes, dev,
                                  event)):
                    return
            self._put(self._DONE)
        except BaseException as exc:  # surfaced on the consumer side
            self._put(exc)

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


class _StagingRing:
    """Pinned host buffers reused round-robin. ``acquire`` hands out the
    next buffer only after the event recorded by its last ``release``
    (the copy that read it) has completed."""

    def __init__(self, slots: int, shape: Tuple[int, int], pin: bool):
        self.shape = shape
        self._bufs = [torch.empty(shape, dtype=torch.float32,
                                  pin_memory=pin) for _ in range(slots)]
        self._events: List[Optional[object]] = [None] * slots
        self._next = 0

    def acquire(self) -> Tuple[int, torch.Tensor]:
        slot = self._next
        self._next = (slot + 1) % len(self._bufs)
        event = self._events[slot]
        if event is not None:
            event.synchronize()
            self._events[slot] = None
        return slot, self._bufs[slot]

    def release(self, slot: int, event) -> None:
        self._events[slot] = event


class ScoringExecutor:
    """Streams a document collection through proxy scoring.

    chunk:  documents per streamed tile.
    device: where scoring runs; ``"cuda"`` by default, and it raises
            when no card is present.
    """

    def __init__(self, *, chunk: int = 8192, device="cuda"):
        self.device = resolve_device(device)
        self.chunk = chunk
        self._ring: Optional[_StagingRing] = None
        self._copy_stream = None

    def _put(self, dim: int):
        if self.device.type == "cpu":
            return lambda block: (torch.tensor(
                np.asarray(block, np.float32)), None)
        if self._ring is None or self._ring.shape != (self.chunk, dim):
            self._ring = _StagingRing(STAGING_SLOTS, (self.chunk, dim),
                                      pin=True)
            self._copy_stream = torch.cuda.Stream(self.device)
        ring, stream, dev = self._ring, self._copy_stream, self.device

        def put(block: np.ndarray):
            rows = block.shape[0]
            slot, buf = ring.acquire()
            np.copyto(buf[:rows].numpy(), block, casting="same_kind")
            with torch.cuda.stream(stream):
                tile = torch.empty((rows, dim), dtype=torch.float32,
                                   device=dev)
                tile.copy_(buf[:rows], non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            ring.release(slot, event)
            return tile, event
        return put

    def score(self, params, e_q, store) -> Tuple[np.ndarray, ScoringStats]:
        """One predicate over the collection -> ((N,) scores, stats)."""
        scores, stats = self.score_multi([(params, e_q)], store)
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
        pre = _Prefetcher(store, self.chunk,
                          self._put(store.dim if hasattr(store, "dim")
                                    else store.shape[1]))
        out = np.empty((n, len(jobs)), np.float32)
        tiles = nbytes = 0
        compute_s = 0.0
        paths = set()
        for start, rows, tile_bytes, tile, event in pre:
            tc = time.perf_counter()
            if event is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(event)
                tile.record_stream(compute)
            for (params, cols), zq in zip(groups, zq_stacks):
                s = score_tile_multi(params, zq, tile)
                paths.add("matmul" if params is None else "fused")
                out[start:start + rows, np.asarray(cols)] = s.cpu().numpy()
            compute_s += time.perf_counter() - tc
            tiles += 1
            nbytes += tile_bytes
        stats = ScoringStats(
            docs_scored=n, queries_scored=len(jobs), tiles_scored=tiles,
            bytes_streamed=nbytes, host_io_seconds=pre.io_seconds,
            compute_seconds=compute_s, stall_seconds=pre.stall_seconds,
            wall_seconds=time.perf_counter() - t0, devices=1,
            paths=tuple(sorted(paths)))
        return out, stats
