"""Streaming offline indexer — the representation phase as a durable job
(``repro.engine.ingest``).

ScaleDoc's offline phase embeds every document once so that every
future predicate amortizes the cost; that only works if the embeddings
survive the job that produced them. ``Ingestor`` turns the compute
service (``repro_torch.runtime.serve_loop.EmbeddingService``) into a
restartable batch job writing a manifest-backed store directory
(``repro_torch.engine.store.StoreWriter``):

    tokens ──► pad into pinned buffer ──► LM prefill + mean-pool ──►
               + copy on a side stream    (the card; flash kernel)
               (background feeder thread)
                                   append-only write ──► commit groups
                                   (embeddings.bin)      (manifest.json)

The loop mirrors the ``ScoringExecutor``: a background feeder pads
batch *k+1* into a pinned host buffer and copies it to the card on a
side stream while batch *k* embeds (``HostStager``), so host work hides
behind compute (``IngestStats.overlap_fraction`` reports how well). One
card only: a ``mesh`` raises ``NotImplementedError``.

Durability & resume
-------------------
Rows become durable in commit groups of ``commit_every_batches *
batch_size`` documents: the data file is fsynced, then the manifest row
count is atomically bumped (``StoreWriter.commit``). A killed job leaves
the store at the last commit boundary plus an uncommitted torn tail,
which the next run truncates before re-embedding from the last durable
row. Batch boundaries and pad widths are functions of the absolute
document index only (batch *i* always covers docs ``[i*B, (i+1)*B)``
padded to that batch's bucketed max length), so a resumed run replays
the same device programs as an uninterrupted one and the final store is
bit-identical either way.

Every commit (cadence: ``checkpoint_every_commits``) also drops a
marker through ``repro_torch.checkpoint`` under ``<store>/ingest_ckpt/``
holding cumulative job counters, so ``IngestResult.job_stats`` reports
totals across preemptions. The manifest, not the checkpoint, is the
source of truth for data.

A ``fingerprint`` (config digest + params digest + batching geometry +
corpus digest, with the JAX package's keys and digests) is recorded in
the manifest at creation and validated on every resume. The manifest
stays byte-compatible with the JAX package's, so the arithmetic the
port's producer runs goes into a note of its own beside it
(``PRODUCER_NOTE``, see ``producer_note``): a resume under another
attention path, time-mix mode or kernel revision, or of rows with no
note (a store the JAX package wrote), raises ``StoreFingerprintError``
instead of mixing rows of different arithmetic.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.engine.executor import HostStager, PrefetchThread
from repro_torch.config import BLOCK_RWKV6
from repro_torch.engine.store import (MANIFEST_NAME, MemmapStore,
                                      StoreFingerprintError, StoreWriter,
                                      load_manifest)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.runtime.serve_loop import EmbeddingService

DEFAULT_COMMIT_EVERY_BATCHES = 8
DEFAULT_PREFETCH_DEPTH = 2
CKPT_DIRNAME = "ingest_ckpt"


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IngestStats:
    """Per-run accounting, symmetric to the executor's ScoringStats."""
    docs: int = 0
    batches: int = 0
    commits: int = 0
    checkpoints: int = 0
    bytes_written: int = 0          # embedding bytes appended to disk
    pad_tokens: int = 0
    tokens: int = 0                 # incl. padding
    host_io_seconds: float = 0.0    # feeder thread: batch build + copy start
    write_seconds: float = 0.0      # disk append + commit fsync
    compute_seconds: float = 0.0    # consumer: blocked on device embed
    stall_seconds: float = 0.0      # consumer: waiting on an empty queue
    wall_seconds: float = 0.0
    resumed_rows: int = 0           # durable rows found at start
    devices: int = 1

    def merge(self, other: "IngestStats") -> "IngestStats":
        """Accumulate another run into this record (in place)."""
        self.docs += other.docs
        self.batches += other.batches
        self.commits += other.commits
        self.checkpoints += other.checkpoints
        self.bytes_written += other.bytes_written
        self.pad_tokens += other.pad_tokens
        self.tokens += other.tokens
        self.host_io_seconds += other.host_io_seconds
        self.write_seconds += other.write_seconds
        self.compute_seconds += other.compute_seconds
        self.stall_seconds += other.stall_seconds
        self.wall_seconds += other.wall_seconds
        self.resumed_rows = max(self.resumed_rows, other.resumed_rows)
        self.devices = max(self.devices, other.devices)
        return self

    @property
    def docs_per_second(self) -> float:
        return self.docs / self.wall_seconds if self.wall_seconds > 0 else 0.0

    @property
    def pad_waste_frac(self) -> float:
        return self.pad_tokens / max(self.tokens, 1)

    @property
    def overlap_fraction(self) -> float:
        """How much of host batch-prep I/O hid behind device compute."""
        if self.host_io_seconds <= 0:
            return 1.0
        return max(0.0, 1.0 - self.stall_seconds / self.host_io_seconds)


@dataclasses.dataclass
class IngestResult:
    store: MemmapStore              # committed rows, memory-mapped
    stats: IngestStats              # this run only
    job_stats: IngestStats          # cumulative across resumed runs
    path: str
    interrupted: bool               # True when max_docs stopped the run


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------

def corpus_digest(docs_tokens) -> str:
    """Content digest of a token corpus (length-framed so shifted doc
    boundaries can't collide). Hashing is orders of magnitude cheaper
    than one LM prefill over the same tokens, so it runs on every
    ingest call — including resumes, where it is the guard against
    silently mixing two different corpora in one store."""
    h = hashlib.blake2b(digest_size=8)
    for d in docs_tokens:
        arr = np.ascontiguousarray(np.asarray(d, np.int32).ravel())
        h.update(len(arr).to_bytes(4, "little"))
        h.update(arr.tobytes())
    return h.hexdigest()


def ingest_fingerprint(service: EmbeddingService, *,
                       commit_every_batches: int,
                       pad_width_to: int, data_shards: int) -> Dict:
    """Identity of the embedding producer, recorded in the manifest.

    Anything that changes output bytes belongs here: the architecture
    (config digest), the weights (``service.params_digest()``, over
    every leaf's host bytes, computed once per service), and the batching
    geometry (batch size / commit group / pad bucket decide batch
    boundaries and pad widths, which the bit-identical-resume guarantee
    depends on). ``Ingestor.ingest`` additionally records the corpus
    identity (``corpus_digest`` + doc count) next to this producer
    identity, so a resume must present both the same producer AND the
    same documents.
    """
    cfg_json = json.dumps(dataclasses.asdict(service.cfg), sort_keys=True,
                          default=str)
    return {
        "model": service.cfg.name,
        "d_model": service.cfg.d_model,
        "config_digest": hashlib.sha1(cfg_json.encode()).hexdigest()[:16],
        "params_digest": service.params_digest(),
        "batch_size": service.batch_size,
        "commit_every_batches": commit_every_batches,
        "pad_width_to": pad_width_to,
        "data_shards": data_shards,
    }


PRODUCER_NOTE = "producer.json"


def producer_note(service: EmbeddingService) -> Dict:
    """The arithmetic of the port's producer, which the manifest's
    fingerprint does not see: the attention path, the time-mix mode, and
    the ``REVISION`` of each kernel whose arithmetic the model runs."""
    model = service.model
    kinds = set(model.pattern)
    revisions = {}
    if kinds - {BLOCK_RWKV6} and model.attn_impl == "flash":
        revisions["flash_attention"] = flash_ops.REVISION
    if BLOCK_RWKV6 in kinds and model.rwkv_mode == "kernel":
        revisions["wkv6"] = wkv6_ops.REVISION
    return {"attn_impl": model.attn_impl, "rwkv_mode": model.rwkv_mode,
            "revisions": revisions}


def _check_producer_note(directory: Path, note: Dict) -> None:
    """Raise ``StoreFingerprintError`` when an existing store's note is not
    ``note``, or when it has rows and no note."""
    if not (directory / MANIFEST_NAME).exists():
        return
    path = directory / PRODUCER_NOTE
    if path.exists():
        stored = json.loads(path.read_text())
        if stored != note:
            raise StoreFingerprintError(
                f"store {directory} was written by a producer of other "
                f"arithmetic:\n  stored:  {stored}\n  current: {note}")
    elif load_manifest(directory).rows:
        raise StoreFingerprintError(
            f"store {directory} has rows and no {PRODUCER_NOTE}: the "
            "arithmetic that wrote them is unknown")


def _write_producer_note(directory: Path, note: Dict) -> None:
    tmp = directory / (PRODUCER_NOTE + ".tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps(note, sort_keys=True))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, directory / PRODUCER_NOTE)


# ---------------------------------------------------------------------------
# background batch feeder (the ingest twin of executor._Prefetcher)
# ---------------------------------------------------------------------------

class _BatchFeeder(PrefetchThread):
    """Background thread that pads token batches and stages them onto the
    device ahead of compute (the ingest twin of the executor's
    ``_Prefetcher``; lifecycle shared via ``PrefetchThread``). Batch
    *i* always covers documents ``[i*B, (i+1)*B)`` and is padded to
    that batch's own bucketed max length — both functions of absolute
    index only, which is what makes interrupted-and-resumed ingestion
    bit-identical."""

    def __init__(self, docs_tokens, start_batch: int, n_docs: int,
                 batch_size: int, pad_width_to: int, depth: int, put_fn):
        super().__init__(depth, docs_tokens, start_batch, n_docs,
                         batch_size, pad_width_to, put_fn)

    def _produce(self, docs_tokens, start_batch, n_docs, bs,
                 pad_width_to, put_fn):
        n_batches = (n_docs + bs - 1) // bs
        for b_idx in range(start_batch, n_batches):
            if self._stop.is_set():
                return
            t0 = time.perf_counter()
            lo, hi = b_idx * bs, min((b_idx + 1) * bs, n_docs)
            docs = [np.asarray(docs_tokens[i], np.int32).ravel()
                    for i in range(lo, hi)]
            width = max(max(len(d) for d in docs), 1)
            width = ((width + pad_width_to - 1)
                     // pad_width_to) * pad_width_to
            batch = np.zeros((bs, width), np.int32)
            for i, d in enumerate(docs):
                batch[i, :len(d)] = d
            pad = bs * width - sum(len(d) for d in docs)
            dev, event = put_fn(batch)
            self.io_seconds += time.perf_counter() - t0
            if not self._put((b_idx, len(docs), pad, bs * width, dev,
                              event)):
                return


# ---------------------------------------------------------------------------
# ingestor
# ---------------------------------------------------------------------------

class Ingestor:
    """Resumable offline indexer over one embedding service.

    Parameters
    ----------
    service:              the ``EmbeddingService`` producing embeddings.
    commit_every_batches: batches per durable commit group. Smaller =
                          finer resume granularity, more fsyncs.
    mesh:                 must be None: multi-card ingest is not ported.
    prefetch_depth:       batches the feeder thread may run ahead
                          (2 = double buffering).
    pad_width_to:         bucket batch pad widths to this multiple, so
                          batches take few distinct shapes.
    checkpoint_every_commits: job-counter marker cadence through
                          ``repro_torch.checkpoint`` (0 disables markers).
    """

    def __init__(self, service: EmbeddingService, *,
                 commit_every_batches: int = DEFAULT_COMMIT_EVERY_BATCHES,
                 mesh=None,
                 prefetch_depth: int = DEFAULT_PREFETCH_DEPTH,
                 pad_width_to: int = 16,
                 checkpoint_every_commits: int = 1,
                 checkpoint_keep: int = 3):
        if commit_every_batches < 1:
            raise ValueError("commit_every_batches must be >= 1")
        if mesh is not None:
            raise NotImplementedError("multi-card ingest (a mesh) is not "
                                      "ported yet")
        self.service = service
        self.commit_every_batches = commit_every_batches
        self.prefetch_depth = prefetch_depth
        self.pad_width_to = pad_width_to
        self.checkpoint_every_commits = checkpoint_every_commits
        self.checkpoint_keep = checkpoint_keep
        self._stager = HostStager(service.device, torch.int32)

    def fingerprint(self) -> Dict:
        return ingest_fingerprint(
            self.service, commit_every_batches=self.commit_every_batches,
            pad_width_to=self.pad_width_to, data_shards=1)

    # -- checkpoint markers -------------------------------------------------

    @staticmethod
    def _counter_tree(job: IngestStats) -> Dict:
        return {"docs": np.int64(job.docs),
                "batches": np.int64(job.batches),
                "commits": np.int64(job.commits),
                "bytes_written": np.int64(job.bytes_written),
                "wall_seconds": np.float64(job.wall_seconds)}

    def _restore_job_counters(self, ckpt_dir: str) -> IngestStats:
        prior = IngestStats()
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            return prior
        tree, _ = ckpt.restore(ckpt_dir, step, self._counter_tree(prior))
        prior.docs = int(tree["docs"])
        prior.batches = int(tree["batches"])
        prior.commits = int(tree["commits"])
        prior.bytes_written = int(tree["bytes_written"])
        prior.wall_seconds = float(tree["wall_seconds"])
        return prior

    def _save_marker(self, ckpt_dir: str, rows: int, job: IngestStats,
                     fingerprint: Dict) -> None:
        ckpt.save(ckpt_dir, rows, self._counter_tree(job),
                  metadata={"rows": rows, "fingerprint": fingerprint})
        ckpt.gc_old_steps(ckpt_dir, self.checkpoint_keep)

    # -- the job ------------------------------------------------------------

    def ingest(self, docs_tokens: Sequence[np.ndarray], directory, *,
               max_docs: Optional[int] = None,
               doc_id_start: int = 0) -> IngestResult:
        """Embed ``docs_tokens`` into the store at ``directory``.

        Resumes from the last durable row when the store already exists
        (fingerprint-checked); returns immediately when it is complete.
        ``max_docs`` caps the rows *appended this run* and then stops
        WITHOUT a final commit — exactly the durable state a kill at
        that point leaves behind (tests and preemption drills use it).
        ``doc_id_start`` records the range offset for multi-job sharded
        ingestion (one store directory per doc-id range).
        """
        t0 = time.perf_counter()
        n = len(docs_tokens)
        bs = self.service.batch_size
        fp = dict(self.fingerprint(),
                  corpus_digest=corpus_digest(docs_tokens), n_docs=n)
        note = producer_note(self.service)
        _check_producer_note(Path(directory), note)
        writer = StoreWriter.open(directory, dim=self.service.cfg.d_model,
                                  fingerprint=fp,
                                  doc_id_start=doc_id_start)
        if not (Path(directory) / PRODUCER_NOTE).exists():
            _write_producer_note(Path(directory), note)
        ckpt_dir = str(Path(directory) / CKPT_DIRNAME)
        row_bytes = self.service.cfg.d_model * 4
        prior = self._restore_job_counters(ckpt_dir)
        # markers are cadence-granular; the manifest is the source of
        # truth for durable progress, so floor the cumulative counters
        # to it (commits/batches between the last marker and a kill
        # stay marker-granular lower bounds)
        prior.docs = max(prior.docs, writer.rows)
        prior.bytes_written = max(prior.bytes_written,
                                  writer.rows * row_bytes)
        stats = IngestStats(resumed_rows=writer.rows, devices=1)
        start = writer.rows

        if start >= n:                      # store already complete
            writer.close()
            stats.wall_seconds = time.perf_counter() - t0
            return IngestResult(store=MemmapStore.open(directory),
                                stats=stats, job_stats=prior,
                                path=str(directory), interrupted=False)
        if start % bs:
            raise ValueError(
                f"store has {start} committed rows, not a multiple of "
                f"batch_size={bs}; it was finished under a different "
                "corpus length — re-ingest into a fresh directory")

        cap = n - start if max_docs is None else min(max_docs, n - start)
        feeder = _BatchFeeder(docs_tokens, start // bs, n, bs,
                              self.pad_width_to, self.prefetch_depth,
                              self._stager)
        appended = 0
        try:
            for b_idx, n_valid, pad, toks, dev, event in feeder:
                tc = time.perf_counter()
                self._stager.wait(dev, event)
                emb = self.service.embed_batch(dev).cpu().numpy()
                stats.compute_seconds += time.perf_counter() - tc
                take = min(n_valid, cap - appended)
                tw = time.perf_counter()
                writer.append(emb[:take])
                stats.write_seconds += time.perf_counter() - tw
                appended += take
                stats.docs += take
                stats.batches += 1
                stats.bytes_written += take * row_bytes
                stats.pad_tokens += pad
                stats.tokens += toks
                if (take == n_valid
                        and (b_idx + 1) % self.commit_every_batches == 0):
                    self._commit(writer, stats, ckpt_dir, prior, fp, t0)
                if appended >= cap:
                    break
        finally:
            interrupted = start + appended < n
            if not interrupted:             # ran to the end: durable tail
                self._commit(writer, stats, ckpt_dir, prior, fp, t0,
                             final=True)
            writer.close()
            stats.host_io_seconds = feeder.io_seconds
            stats.stall_seconds = feeder.stall_seconds
        stats.wall_seconds = time.perf_counter() - t0
        job = dataclasses.replace(prior).merge(stats)
        return IngestResult(store=MemmapStore.open(directory), stats=stats,
                            job_stats=job, path=str(directory),
                            interrupted=interrupted)

    def _commit(self, writer: StoreWriter, stats: IngestStats,
                ckpt_dir: str, prior: IngestStats, fingerprint: Dict,
                t0: float, final: bool = False) -> None:
        tw = time.perf_counter()
        before = writer.rows
        rows = writer.commit()
        stats.write_seconds += time.perf_counter() - tw
        if rows > before:
            stats.commits += 1
        elif not final:
            return
        cadence = self.checkpoint_every_commits
        # cadence counts absolute job commits, so it does not reset on
        # every resumed run
        job_commits = prior.commits + stats.commits
        if (final and rows == before
                and ckpt.latest_step(ckpt_dir) == rows):
            return      # the last in-loop commit already marked this row
        if cadence and (final or (rows > before
                                  and job_commits % cadence == 0)):
            stats.wall_seconds = time.perf_counter() - t0
            job = dataclasses.replace(prior).merge(stats)
            self._save_marker(ckpt_dir, rows, job, fingerprint)
            stats.checkpoints += 1


def build_index(service: EmbeddingService, docs_tokens, directory, *,
                max_docs: Optional[int] = None, doc_id_start: int = 0,
                **ingestor_kwargs) -> IngestResult:
    """One-call offline phase: embed ``docs_tokens`` into a persistent
    store directory (resuming any prior partial run) and return the
    opened ``MemmapStore`` plus accounting. Keyword arguments configure
    the ``Ingestor``."""
    ing = Ingestor(service, **ingestor_kwargs)
    return ing.ingest(docs_tokens, directory, max_docs=max_docs,
                      doc_id_start=doc_id_start)
