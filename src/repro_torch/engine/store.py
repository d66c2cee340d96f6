"""Document stores — how embeddings are written offline and read online
(``repro.engine.store``).

A ``DocumentStore`` hides the storage layout behind three operations:

  * ``len(store)`` / ``store.dim`` — collection extent;
  * ``store.get(indices)``         — random access (training samples);
  * ``store.iter_chunks(chunk)``   — streaming sequential access for
                                     full-collection scoring passes.

``InMemoryStore`` wraps an array; ``MemmapStore`` memory-maps on-disk
embeddings.

Persistent store directories (the offline phase's durable artifact)
----------------------------------------------------------------------
``repro_torch.engine.ingest`` writes embeddings *append-only* into a
store directory, byte for byte in the JAX package's format
(``STORE_VERSION = 1``), so either package reads the other's stores::

    <dir>/manifest.json     row count, dim, dtype, doc-id range, and
                            the producing model/config fingerprint
    <dir>/embeddings.bin    raw row-major (rows, dim) float32 data

``StoreWriter`` appends blocks and makes them durable with an atomic
two-step ``commit()``: the data file is flushed + fsynced first, then
``manifest.json`` is atomically replaced (tmp file + ``os.replace``)
with the new row count. The manifest row count is therefore the only
source of truth for how much of ``embeddings.bin`` is valid: bytes
beyond ``rows * dim * itemsize`` are an uncommitted torn tail from an
interrupted writer, and reopening the directory truncates them before
appending resumes. ``MemmapStore.open(dir)`` maps exactly the committed
rows. A ``fingerprint`` dict recorded at creation is validated on every
reopen, so a resumed ingestion can never mix embeddings from two
different producers in one store.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np

DEFAULT_CHUNK = 8192

MANIFEST_NAME = "manifest.json"
DATA_NAME = "embeddings.bin"
STORE_VERSION = 1


class DocumentStore:
    """Base class: chunked access to (N, D) float32 document embeddings."""

    def __len__(self) -> int:
        raise NotImplementedError

    @property
    def dim(self) -> int:
        raise NotImplementedError

    def get(self, indices) -> np.ndarray:
        """Materialize rows for ``indices`` (any integer array-like)."""
        raise NotImplementedError

    def iter_chunks(self, chunk: int = DEFAULT_CHUNK
                    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (start_row, block) covering the collection in order."""
        n = len(self)
        for start in range(0, n, chunk):
            yield start, self.get(np.arange(start, min(start + chunk, n)))


class InMemoryStore(DocumentStore):
    def __init__(self, embeds: np.ndarray):
        arr = np.asarray(embeds, np.float32)
        if arr.ndim != 2:
            raise ValueError(f"embeds must be (N, D), got {arr.shape}")
        self._embeds = arr

    def __len__(self) -> int:
        return self._embeds.shape[0]

    @property
    def dim(self) -> int:
        return self._embeds.shape[1]

    def get(self, indices) -> np.ndarray:
        return self._embeds[np.asarray(indices, np.int64)]

    def iter_chunks(self, chunk: int = DEFAULT_CHUNK):
        n = len(self)
        for start in range(0, n, chunk):
            yield start, self._embeds[start:start + chunk]


@dataclasses.dataclass
class StoreManifest:
    """What ``manifest.json`` records about a persistent store directory.

    ``rows`` is the durable row count: it only advances on
    ``StoreWriter.commit()``, after the data file has been fsynced, so
    every row it covers is guaranteed readable. ``fingerprint``
    identifies the producer (model name, config digest, params digest,
    batching geometry — whatever the writer chose to record); reopening
    with a different fingerprint raises ``StoreFingerprintError``.
    """
    dim: int
    rows: int = 0
    dtype: str = "float32"
    doc_id_start: int = 0
    fingerprint: Dict = dataclasses.field(default_factory=dict)
    version: int = STORE_VERSION

    @property
    def doc_id_end(self) -> int:
        """One past the last doc id covered by the committed rows."""
        return self.doc_id_start + self.rows

    @property
    def itemsize(self) -> int:
        return np.dtype(self.dtype).itemsize

    @property
    def nbytes(self) -> int:
        """Valid bytes in the data file (committed rows only)."""
        return self.rows * self.dim * self.itemsize

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2,
                          sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "StoreManifest":
        raw = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


class StoreFingerprintError(ValueError):
    """Reopened store was produced by a different model/config."""


def load_manifest(directory) -> StoreManifest:
    return StoreManifest.from_json(
        (Path(directory) / MANIFEST_NAME).read_text())


def _write_manifest(directory: Path, manifest: StoreManifest) -> None:
    """Atomic manifest replacement: readers and resumed writers either
    see the old row count or the new one, never a torn file."""
    tmp = directory / (MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        f.write(manifest.to_json())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, directory / MANIFEST_NAME)


class StoreWriter:
    """Append-only writer for a persistent store directory.

    Usage::

        w = StoreWriter.open(dir, dim=64, fingerprint={...})
        w.append(block)        # (B, dim) float32 — buffered, NOT durable
        w.commit()             # fsync data, then atomically bump manifest
        w.close()

    ``open`` creates the directory on first use and *resumes* it
    afterwards: the data file is truncated to the manifest's committed
    byte count (discarding any torn tail a killed writer left behind)
    and appending continues from ``w.rows``. The recorded fingerprint
    must match on resume — mismatches raise ``StoreFingerprintError``
    instead of mixing incompatible embeddings.
    """

    def __init__(self, directory: Path, manifest: StoreManifest):
        self.directory = Path(directory)
        self.manifest = manifest
        self.pending_rows = 0
        data = self.directory / DATA_NAME
        if not data.exists():
            data.touch()
        # discard any uncommitted torn tail, then append from the end
        with open(data, "r+b") as f:
            f.truncate(manifest.nbytes)
        self._f = open(data, "ab")
        assert self._f.tell() == manifest.nbytes

    @classmethod
    def open(cls, directory, dim: int, *,
             fingerprint: Optional[Dict] = None,
             doc_id_start: int = 0) -> "StoreWriter":
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        if (directory / MANIFEST_NAME).exists():
            manifest = load_manifest(directory)
            if manifest.dim != dim:
                raise ValueError(
                    f"store {directory} has dim={manifest.dim}, "
                    f"writer wants dim={dim}")
            if manifest.doc_id_start != doc_id_start:
                raise ValueError(
                    f"store {directory} covers doc ids starting at "
                    f"{manifest.doc_id_start}, writer wants "
                    f"{doc_id_start}; resuming a range shard must "
                    "present the range it was created with")
            if fingerprint is not None \
                    and manifest.fingerprint != fingerprint:
                raise StoreFingerprintError(
                    f"store {directory} was written by a different "
                    f"producer:\n  stored:  {manifest.fingerprint}\n"
                    f"  current: {fingerprint}")
        else:
            manifest = StoreManifest(dim=dim, rows=0,
                                     doc_id_start=doc_id_start,
                                     fingerprint=dict(fingerprint or {}))
            _write_manifest(directory, manifest)
        return cls(directory, manifest)

    @property
    def rows(self) -> int:
        """Durable (committed) row count."""
        return self.manifest.rows

    def append(self, block: np.ndarray) -> int:
        """Buffer a block of rows; returns total rows incl. uncommitted."""
        block = np.ascontiguousarray(block, dtype=self.manifest.dtype)
        if block.ndim != 2 or block.shape[1] != self.manifest.dim:
            raise ValueError(f"append expects (B, {self.manifest.dim}), "
                             f"got {block.shape}")
        self._f.write(block.tobytes())
        self.pending_rows += block.shape[0]
        return self.manifest.rows + self.pending_rows

    def commit(self) -> int:
        """Make every appended row durable; returns the new row count.

        Order matters: data is flushed + fsynced *before* the manifest
        is atomically replaced, so the manifest never covers bytes that
        could still be lost.
        """
        if self.pending_rows:
            self._f.flush()
            os.fsync(self._f.fileno())
            self.manifest.rows += self.pending_rows
            self.pending_rows = 0
            _write_manifest(self.directory, self.manifest)
        return self.manifest.rows

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "StoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MemmapStore(DocumentStore):
    """Memory-mapped store: scoring passes stream from disk, so the
    collection can exceed RAM. Rows are copied (and cast to float32) on
    access, so callers never hold the map open.

    ``MemmapStore.open(dir)`` reads a manifest-backed store directory
    (the appendable layout ``StoreWriter`` / ``repro_torch.engine.ingest``
    produce), mapping exactly the committed rows; ``from_npy`` /
    ``from_raw`` read legacy single-file layouts.

    A directory-backed store is *watermark-aware*: a concurrent
    ``StoreWriter`` may keep committing rows after ``open()``, and
    ``refresh()`` re-reads the manifest and remaps the data file so the
    reader advances to the new committed row count. The manifest
    identity (fingerprint, dim, doc_id_start) is re-validated on every
    refresh — if another producer swapped the directory out from under
    us, ``refresh()`` raises ``StoreFingerprintError`` instead of
    silently serving mixed-corpus rows."""

    def __init__(self, mmap: np.ndarray,
                 manifest: Optional[StoreManifest] = None,
                 directory=None):
        if mmap.ndim != 2:
            raise ValueError(f"memmap must be (N, D), got {mmap.shape}")
        self._mmap = mmap
        self.manifest = manifest
        self.directory = Path(directory) if directory is not None else None

    @classmethod
    def from_npy(cls, path: str) -> "MemmapStore":
        return cls(np.load(path, mmap_mode="r"))

    @classmethod
    def from_raw(cls, path: str, shape, dtype=np.float32) -> "MemmapStore":
        return cls(np.memmap(path, mode="r", dtype=dtype, shape=tuple(shape)))

    @classmethod
    def open(cls, directory) -> "MemmapStore":
        """Open a manifest-backed store directory (committed rows only)."""
        manifest = load_manifest(directory)
        mmap = cls._map(directory, manifest)
        return cls(mmap, manifest, directory=directory)

    @staticmethod
    def _map(directory, manifest: StoreManifest) -> np.ndarray:
        if manifest.rows == 0:
            return np.empty((0, manifest.dim), manifest.dtype)
        return np.memmap(Path(directory) / DATA_NAME, mode="r",
                         dtype=manifest.dtype,
                         shape=(manifest.rows, manifest.dim))

    @property
    def watermark(self) -> int:
        """Committed rows currently visible to this reader."""
        return self._mmap.shape[0]

    def refresh(self) -> int:
        """Advance to the latest committed row count; returns it.

        Re-reads the manifest and, when rows grew, remaps the data file
        to cover them. The new manifest must describe the *same* store:
        any change to the producer fingerprint, dim, or doc-id range
        means a concurrent producer swapped the directory, and we raise
        ``StoreFingerprintError`` rather than mix corpora. A shrinking
        row count is the same error — committed rows never retract.
        """
        if self.directory is None:
            return len(self)          # non-directory stores are frozen
        new = load_manifest(self.directory)
        old = self.manifest
        if (new.fingerprint != old.fingerprint or new.dim != old.dim
                or new.doc_id_start != old.doc_id_start):
            raise StoreFingerprintError(
                f"store {self.directory} changed identity while open:\n"
                f"  opened:  fingerprint={old.fingerprint} dim={old.dim}"
                f" doc_id_start={old.doc_id_start}\n"
                f"  current: fingerprint={new.fingerprint} dim={new.dim}"
                f" doc_id_start={new.doc_id_start}")
        if new.rows < old.rows:
            raise StoreFingerprintError(
                f"store {self.directory} shrank from {old.rows} to "
                f"{new.rows} committed rows; a committed row count "
                "never retracts, so the directory was rewritten")
        if new.rows > old.rows:
            self._mmap = self._map(self.directory, new)
            self.manifest = new
        return len(self)

    def __len__(self) -> int:
        return self._mmap.shape[0]

    @property
    def dim(self) -> int:
        return self._mmap.shape[1]

    def get(self, indices) -> np.ndarray:
        return np.asarray(self._mmap[np.asarray(indices, np.int64)],
                          np.float32)

    def iter_chunks(self, chunk: int = DEFAULT_CHUNK):
        n = len(self)
        for start in range(0, n, chunk):
            yield start, np.asarray(self._mmap[start:start + chunk],
                                    np.float32)


def as_store(obj: Union[DocumentStore, np.ndarray]) -> DocumentStore:
    """Coerce an ndarray (or memmap) to a DocumentStore; pass stores
    through unchanged."""
    if isinstance(obj, DocumentStore):
        return obj
    if isinstance(obj, np.memmap):
        return MemmapStore(obj)
    return InMemoryStore(obj)
