"""Batched embedding service — the compute side of the offline phase
(``repro.runtime.serve_loop``).

``EmbeddingService`` is tokens in, pooled embeddings out, nothing
persisted: a prefill over every pattern group of the LM, then a mean
over the non-pad positions of the last block's raw output (no final
norm; token id 0 is padding wherever it appears). The durable offline
job that writes those embeddings into a store lives in
``repro_torch.engine.ingest``, which drives this service batch by batch
(``embed_batch``). On the card the attention of every attention layer
is the hand-written flash kernel, and the WKV6 recurrence of every
RWKV6 layer the hand-written intra-chunk kernel. ``generate`` (decode)
is not ported.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import flatten_with_paths
from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import group_params

# elements hashed per host copy when digesting the params
_DIGEST_CHUNK = 1 << 26


@dataclasses.dataclass
class ServeStats:
    documents: int = 0
    batches: int = 0
    pad_waste_frac: float = 0.0
    wall_s: float = 0.0


def params_digest(params) -> str:
    """blake2b over every leaf's "/"-joined path and raw host bytes, in
    sorted path order: the JAX package's params digest (bf16 leaves hash
    as their 2-byte words)."""
    h = hashlib.blake2b(digest_size=8)
    for key, leaf in sorted(flatten_with_paths(params),
                            key=lambda kv: kv[0]):
        h.update(key.encode())
        flat = leaf.detach().reshape(-1)
        if flat.dtype == torch.bfloat16:
            flat = flat.view(torch.int16)
        for start in range(0, flat.numel(), _DIGEST_CHUNK):
            h.update(flat[start:start + _DIGEST_CHUNK].cpu().numpy())
    return h.hexdigest()


class EmbeddingService:
    """LM-as-embedder: prefill the document, mean-pool the last block's
    hidden states (the paper's NvEmbed role).

    ``params`` must lie on ``device`` (``"cuda"`` by default; it raises
    without a card unless given ``device="cpu"``). The service treats
    them as read-only: their digest is computed once.
    ``attn_impl="einsum"`` or ``"blocked"`` runs a plain attention path
    in place of the flash kernel, and ``rwkv_mode="direct"`` the plain
    chunked WKV6 scan in place of the WKV6 kernel, for comparison.
    """

    def __init__(self, cfg: ModelConfig, params, batch_size: int = 8,
                 device="cuda", attn_impl: str = "flash",
                 rwkv_mode: str = "kernel"):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the service "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.model = build_model(cfg, attn_impl=attn_impl,
                                 rwkv_mode=rwkv_mode)
        self.params = params
        self.batch_size = batch_size
        self._digest: Optional[str] = None

    def params_digest(self) -> str:
        if self._digest is None:
            self._digest = params_digest(self.params)
        return self._digest

    @torch.inference_mode()
    def embed_batch(self, batch) -> torch.Tensor:
        """One already-padded (B, W) int token batch (array or tensor) ->
        (B, d_model) float32 pooled embeddings, on the service's device.
        Rows of all-zero (pad) tokens pool to zero vectors; callers slice
        them off."""
        tokens = torch.as_tensor(batch, device=self.device)
        model, params = self.model, self.params
        x = model.embed_inputs(params, tokens)
        positions = torch.arange(x.shape[1], device=self.device)
        shared = params.get("shared")
        for g in range(model.num_groups):
            x, _, _ = model._group_fullseq(x, group_params(params, g), shared,
                                           positions=positions,
                                           collect_cache=False)
        mask = (tokens > 0).to(x.dtype)[..., None]
        pooled = torch.sum(x * mask, dim=1) / torch.clamp(
            torch.sum(mask, dim=1), min=1.0)
        return pooled.float()

    def embed_documents(self, docs_tokens: Iterable[np.ndarray],
                        stats: Optional[ServeStats] = None) -> np.ndarray:
        """docs_tokens: iterable of 1-D int arrays (ragged). Returns
        (N, d_model) float32 embeddings."""
        docs = list(docs_tokens)
        t0 = time.time()
        n = len(docs)
        width = max(len(d) for d in docs)
        out = np.zeros((n, self.cfg.d_model), np.float32)
        pad_total, tok_total = 0, 0
        for start in range(0, n, self.batch_size):
            chunk = docs[start:start + self.batch_size]
            bs = len(chunk)
            batch = np.zeros((self.batch_size, width), np.int32)
            for i, d in enumerate(chunk):
                batch[i, :len(d)] = d
                pad_total += width - len(d)
                tok_total += width
            emb = self.embed_batch(batch).cpu().numpy()
            out[start:start + bs] = emb[:bs]
        if stats is not None:
            stats.documents += n
            stats.batches += (n + self.batch_size - 1) // self.batch_size
            stats.pad_waste_frac = pad_total / max(tok_total, 1)
            stats.wall_s += time.time() - t0
        return out
