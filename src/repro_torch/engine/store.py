"""Document stores — how the engine reads embeddings (read side of
``repro.engine.store``).

A ``DocumentStore`` hides the storage layout behind three operations:

  * ``len(store)`` / ``store.dim`` — collection extent;
  * ``store.get(indices)``         — random access (training samples);
  * ``store.iter_chunks(chunk)``   — streaming sequential access for
                                     full-collection scoring passes.

``InMemoryStore`` wraps an array; ``MemmapStore`` memory-maps on-disk
embeddings (a ``.npy`` file, or a store directory the JAX
package's ingestion wrote: ``manifest.json`` + ``embeddings.bin``, of
which only the committed rows are mapped). Writing stores is not ported.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Tuple, Union

import numpy as np

DEFAULT_CHUNK = 8192

MANIFEST_NAME = "manifest.json"
DATA_NAME = "embeddings.bin"


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


class MemmapStore(DocumentStore):
    """Memory-mapped store: scoring passes stream from disk, so the
    collection can exceed RAM. Rows are copied (and cast to float32) on
    access."""

    def __init__(self, mmap: np.ndarray):
        if mmap.ndim != 2:
            raise ValueError(f"memmap must be (N, D), got {mmap.shape}")
        self._mmap = mmap

    @classmethod
    def from_npy(cls, path: str) -> "MemmapStore":
        return cls(np.load(path, mmap_mode="r"))

    @classmethod
    def open(cls, directory) -> "MemmapStore":
        """Open a manifest-backed store directory (committed rows only)."""
        manifest = json.loads((Path(directory) / MANIFEST_NAME).read_text())
        rows, dim = int(manifest["rows"]), int(manifest["dim"])
        dtype = manifest.get("dtype", "float32")
        if rows == 0:
            return cls(np.empty((0, dim), dtype))
        return cls(np.memmap(Path(directory) / DATA_NAME, mode="r",
                             dtype=dtype, shape=(rows, dim)))

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
