"""Full-collection proxy scoring in plain PyTorch — the reference path.

For every ad-hoc query ScaleDoc scores all N document embeddings with
the freshly trained proxy: ``z_d = MLP(e_d); s = (1 + cos(z_q, z_d)) / 2``.
This module is the plain path (``repro.core.scoring``'s counterpart);
the engine's hot path is ``repro_torch.engine.executor.ScoringExecutor``,
which streams through pinned staging buffers and runs proxy groups in
the fused CUDA kernel (``repro_torch.kernels.fused_scoring``).

``embeds`` may be a raw (N, D) array or anything exposing
``iter_chunks(chunk)`` (see ``repro_torch.engine.store``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.encoder import encoder_apply, l2_normalize
from repro_torch.device import resolve_device


def _iter_chunks(embeds, chunk: int):
    if hasattr(embeds, "iter_chunks"):
        yield from embeds.iter_chunks(chunk)
        return
    n = embeds.shape[0]
    for start in range(0, n, chunk):
        yield start, embeds[start:start + chunk]


def _num_docs(embeds) -> int:
    return len(embeds) if hasattr(embeds, "iter_chunks") else embeds.shape[0]


def _tensor(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)


def _proxy_chunk_scores(params, block, zq_t):
    """block: (B, D); zq_t: (latent, Q) of unit query latents."""
    z = l2_normalize(encoder_apply(params, block))
    return (1.0 + z @ zq_t) * 0.5


def _raw_chunk_scores(block, zq_t):
    return (1.0 + l2_normalize(block) @ zq_t) * 0.5


def score_collection(params: Dict, e_q, embeds, chunk: int = 8192, *,
                     device="cuda") -> np.ndarray:
    """Scores for all docs. embeds: (N, D) array or DocumentStore ->
    (N,) float32 in [0, 1]."""
    dev = resolve_device(device)
    z_q = l2_normalize(encoder_apply(params, _tensor(e_q, dev)))
    outs = [_proxy_chunk_scores(params, _tensor(block, dev),
                                z_q[:, None])[:, 0].cpu().numpy()
            for _, block in _iter_chunks(embeds, chunk)]
    return np.concatenate(outs).astype(np.float32)


def group_jobs(jobs: Sequence[Tuple[Optional[Dict], np.ndarray]],
               device) -> Tuple[List[Tuple[Optional[Dict], List[int]]],
                                List[torch.Tensor]]:
    """Group (params, e_q) jobs by proxy identity for batched scoring.

    Returns ``(groups, zq_stacks)``: per distinct params object (or
    None = raw cosine) the job-column indices it covers, plus the
    matching (Q_g, latent) stack of unit query latents on ``device``.
    Shared by ``score_collection_multi`` and the streaming executor so
    grouping key and column order cannot drift between the two paths.
    """
    groups: List[Tuple[Optional[Dict], List[int]]] = []
    by_id: Dict[int, int] = {}
    for j, (params, _) in enumerate(jobs):
        key = -1 if params is None else id(params)
        if key not in by_id:
            by_id[key] = len(groups)
            groups.append((params, []))
        groups[by_id[key]][1].append(j)

    zq_stacks = []
    for params, cols in groups:
        e_qs = _tensor(np.stack([np.asarray(jobs[j][1]) for j in cols]),
                       device)
        if params is None:
            zq_stacks.append(l2_normalize(e_qs))
        else:
            zq_stacks.append(l2_normalize(encoder_apply(params, e_qs)))
    return groups, zq_stacks


def score_collection_multi(jobs: Sequence[Tuple[Optional[Dict], np.ndarray]],
                           embeds, chunk: int = 8192, *,
                           device="cuda") -> np.ndarray:
    """Score many predicates in one streaming pass over the collection.

    jobs: sequence of (params, e_q); ``params=None`` means raw-embedding
    cosine (no proxy). Returns (N, len(jobs)) float32 scores in [0, 1],
    columns in job order.
    """
    dev = resolve_device(device)
    if not jobs:
        return np.zeros((_num_docs(embeds), 0), np.float32)
    groups, zq_stacks = group_jobs(jobs, dev)
    out = np.empty((_num_docs(embeds), len(jobs)), np.float32)
    for start, block in _iter_chunks(embeds, chunk):
        block = _tensor(block, dev)
        for (params, cols), zq in zip(groups, zq_stacks):
            s = (_raw_chunk_scores(block, zq.T) if params is None
                 else _proxy_chunk_scores(params, block, zq.T))
            out[start:start + block.shape[0], np.asarray(cols)] = \
                s.cpu().numpy()
    return out


def direct_embedding_scores(e_q, embeds, *, device="cuda") -> np.ndarray:
    """Baseline: off-the-shelf embedding matching (paper §6.4 / Table 3),
    cosine between raw embeddings, no trained proxy."""
    dev = resolve_device(device)
    cos = l2_normalize(_tensor(embeds, dev)) @ l2_normalize(_tensor(e_q, dev))
    return ((1.0 + cos) * 0.5).cpu().numpy().astype(np.float32)
