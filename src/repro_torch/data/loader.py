"""Deterministic LM batches (``repro.data.loader``).

Batch contents are a pure function of (seed, step), so a restarted job
resumes mid-epoch with no state beyond the step counter (the checkpoint
already has it). Each process materializes only its slice of the global
batch (``process_index`` of ``process_count``, explicit here and 0 of 1
by default: the port runs on one card). The batches are numpy arrays
drawn exactly as the JAX package draws them, so the two loaders give the
same bits; ``device_batch`` moves one onto a device or, under SPMD
processes, places it over a mesh (each rank keeps its rows).

Sources: synthetic token corpora with planted bigram structure, or an
on-the-fly hash tokenizer over text.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import (DeviceLike, rank_device, resolve_device,
                                spmd_mesh)


def hash_tokenize(text: str, vocab_size: int, length: int) -> np.ndarray:
    """Stateless rolling-hash tokenizer (no external vocab files)."""
    toks = np.zeros(length, np.int32)
    h = 2166136261
    for i, ch in enumerate(text[:length]):
        h = ((h ^ ord(ch)) * 16777619) & 0xFFFFFFFF
        toks[i] = h % vocab_size
    return toks


@dataclasses.dataclass
class BatchSpec:
    global_batch: int
    seq_len: int
    vocab_size: int
    kind: str = "tokens"        # tokens | embeds | frames
    d_model: int = 0


class SyntheticLMLoader:
    """Deterministic synthetic LM batches with planted bigram structure
    (so training loss actually decreases and restarts are bit-exact)."""

    def __init__(self, spec: BatchSpec, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.spec = spec
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        if spec.global_batch % process_count:
            raise ValueError(f"global batch {spec.global_batch} does not "
                             f"split over {process_count} processes")
        self.local_batch = spec.global_batch // process_count
        rng = np.random.default_rng(seed)
        v = spec.vocab_size
        # sparse-ish bigram transition table: each token has ~8 successors
        self._succ = rng.integers(0, v, size=(v, 8)).astype(np.int32)

    def _local_tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step, self.process_index))
        b, s = self.local_batch, self.spec.seq_len
        v = self.spec.vocab_size
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        choices = rng.integers(0, 8, size=(b, s))
        noise = rng.random((b, s)) < 0.05
        rand = rng.integers(0, v, size=(b, s))
        for t in range(1, s):
            nxt = self._succ[toks[:, t - 1], choices[:, t]]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """{"tokens": (b, seq_len - 1), "labels": the same shifted by one},
        int32."""
        toks = self._local_tokens(step)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def device_batch(batch: Dict[str, np.ndarray], shardings=None, *,
                 device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """A host batch -> tensors on ``device`` (int32 stays int32).
    ``shardings`` (the JAX package's second argument: a NamedSharding a
    key) over a mesh of SPMD processes (``launch.mesh``) places each key
    as ``jax.device_put`` does: rows over ("pod", "data") by its spec,
    each rank keeping its slice on its own device, as a DTensor. Over
    one device they change nothing (``device`` names it); a mesh of more
    than one device from one controller raises
    ``NotImplementedError``."""
    if spmd_mesh("device_batch", shardings=shardings) is None:
        dev = resolve_device(device)
        return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
                for k, v in batch.items()}
    from repro_torch.sharding.rules import place
    dev = rank_device(device)
    return {k: place(torch.as_tensor(np.ascontiguousarray(v), device=dev),
                     shardings[k]) for k, v in batch.items()}
