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
RWKV6 layer the hand-written intra-chunk kernel. ``generate`` is the
autoregressive decode driver: a prefill through those kernels, then
plain-PyTorch decode steps over its caches. Both drive decoder-only
models, as in the JAX package: an encoder-decoder model raises
``TypeError`` (its prefill takes frames and has no ``cache_len``).
With a ``mesh`` over the ``("pod", "data")`` axes, ``embed_batch`` takes
a row-sharded batch (one token tensor a shard, each on its device, as
``engine.ingest`` stages them) and runs each shard on its own device,
under that device, against a copy of the params there.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpoint import flatten_with_paths
from repro_torch.config import ModelConfig
from repro_torch.device import data_mesh_devices, on_device, resolve_device
from repro_torch.models import EncDecLM, build_model
from repro_torch.models.transformer import serving_context
from repro_torch.models.common import full_value, tree_map, vocab_argmax

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
    ``mesh`` (the JAX package's data-parallel placement) is None, a mesh
    of one device, or a ``launch.mesh.Mesh`` over the ("pod", "data")
    axes whose devices are of ``device``'s kind: the service keeps one
    copy of the params on each distinct device of it (the caller's
    tensors where the device is ``device``; a repeated device shares
    its copy), and its digest is of the caller's params.
    ``embed_documents`` stays on ``device``, as in the JAX package.
    """

    def __init__(self, cfg: ModelConfig, params, batch_size: int = 8,
                 mesh=None, device="cuda", attn_impl: str = "flash",
                 rwkv_mode: str = "kernel"):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.mesh_devices = data_mesh_devices("EmbeddingService", mesh,
                                              self.device)
        if cfg.is_encdec:
            raise TypeError(f"{cfg.name} is an encoder-decoder model; the "
                            f"embedding service runs decoder-only blocks, "
                            f"as the JAX package's does")
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
        # the params by device: the caller's on the service's device, one
        # copy on each other distinct device of the mesh
        self._params_on: Dict[torch.device, object] = {self.device: params}
        for dev in self.mesh_devices:
            if dev not in self._params_on:
                self._params_on[dev] = tree_map(lambda t: t.to(dev), params)

    def params_on(self, dev: torch.device):
        """The params on ``dev``, the service's device or one of its
        mesh's; ``ValueError`` for any other device."""
        params = self._params_on.get(dev)
        if params is None:
            raise ValueError(f"a shard on {dev}; the service holds its "
                             f"params on {tuple(self._params_on)}")
        return params

    def params_digest(self) -> str:
        if self._digest is None:
            self._digest = params_digest(self.params)
        return self._digest

    @torch.inference_mode()
    def embed_batch(self, batch: Union[np.ndarray, torch.Tensor,
                                       Sequence[torch.Tensor]]
                    ) -> torch.Tensor:
        """One already-padded (B, W) int token batch (array or tensor) ->
        (B, d_model) float32 pooled embeddings, on the service's device.
        Rows of all-zero (pad) tokens pool to zero vectors; callers slice
        them off. A list or tuple of tensors is a row-sharded batch, in
        row order, each shard on a device of the mesh: every shard is
        launched on its device before any is gathered, and the pooled
        rows come back in order on the service's device."""
        if isinstance(batch, (list, tuple)):
            pooled = []
            for shard in batch:
                with on_device(shard.device):
                    pooled.append(self._pool(self.params_on(shard.device),
                                             shard))
            return torch.cat([p.to(self.device) for p in pooled])
        return self._pool(self.params,
                          torch.as_tensor(batch, device=self.device))

    def _pool(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = self.model.hidden(params, tokens)
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


def generate(model, params, prompt_tokens, steps: int, cache_len: int = 0,
             greedy: bool = True,
             generator: Optional[torch.Generator] = None) -> np.ndarray:
    """Autoregressive decode: prefill the prompt, then ``steps - 1``
    decode steps. prompt_tokens: (b, s) ints (array or tensor). Returns
    (b, steps) int32 generated ids, as a numpy array. Runs where the
    params lie.

    The first token is the argmax of the prefill's last logits; each
    later one the argmax of the step's logits (ties take the first
    index), or with ``greedy=False`` a draw from their softmax on
    ``generator`` (one on the params' device; a fresh one seeded 0 if
    None). Those draws are torch's, not the JAX package's threefry
    draws, so sampled tokens differ from its; greedy tokens are the
    same. Token t (1-based) is decoded at position s + t - 1. The tokens
    stay on the device until the end: the loop makes no host sync. An
    ``EncDecLM`` raises ``TypeError``, as the JAX package's
    ``generate`` does (it prefills with ``cache_len=``).

    With params placed on a mesh of SPMD ranks (DTensors: a plan's
    ``arg_shardings``) every rank calls it alike: the prompt and each
    token are replicated, the model runs on DTensors under ``no_grad``
    (``models.transformer.serving_context``) with the cache kept in the
    layout the prefill gives it, the greedy argmax is taken over the
    logits' vocabulary shards (``common.vocab_argmax``: only each
    shard's max and index move), and every rank returns the same array.
    A draw gathers the last logits (b x vocab floats a step) and draws on
    every rank alike from ``generator``'s seed."""
    if isinstance(model, EncDecLM):
        raise TypeError(f"generate drives a decoder-only model; "
                        f"{model.cfg.name} is an encoder-decoder one, whose "
                        f"prefill takes frames and no cache_len")
    dev = params["embed"]["table"].device
    with serving_context(params):
        prompt = torch.as_tensor(prompt_tokens, device=dev)
        b, s = prompt.shape
        total = cache_len or (s + steps)
        logits, cache = model.prefill(params, prompt, cache_len=total)
        if generator is None and not greedy:
            generator = torch.Generator(dev).manual_seed(0)
        tok = vocab_argmax(logits[:, -1])[:, None]
        out = [tok]
        for t in range(1, steps):
            logits, cache = model.decode_step(params, tok, s + t - 1, cache)
            last = logits[:, -1]
            if greedy:
                tok = vocab_argmax(last)[:, None]
            else:
                tok = torch.multinomial(torch.softmax(full_value(last), dim=-1),
                                        1, generator=generator)
            out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
