"""ScaleDoc's lightweight query-aware proxy encoder (paper §3.2, §5).

A 3-layer MLP ``E : R^D -> R^l`` maps LLM embeddings of documents and
the query into a shared latent space; the decision score is
``(1 + cos(z_q, z_d)) / 2``. A projector head is used in training only.

Parameters are a plain dictionary shaped like the JAX package's tree,
``{"layers": {"l0": {"w", "b"}, ...}, "proj": {"w", "b"}}``, with every
``w`` laid out ``(in, out)`` as in JAX, so ``params_from_jax`` is a
straight copy. A stacked tree (each leaf with a leading lane axis, as
``train_proxy_multi`` trains it) applies lane by lane to a ``(Q, n, D)``
input.

The hidden activation is GELU in its tanh form, ``jax.nn.gelu``'s
default; ``F.gelu`` defaults to the erf form, which differs by ~4e-4.
``encoder_init`` draws on a ``torch.Generator`` where the JAX package
takes a PRNG key, in float32 only (its ``dtype`` argument has no use
here). ``encoder_axes`` is the proxy's logical-axes table
(``sharding.rules``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ProxyConfig
from repro_torch.models.common import dense_init, tree_map

Params = Dict[str, Any]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def encoder_init(generator: torch.Generator, cfg: ProxyConfig,
                 dtype: torch.dtype = torch.float32) -> Params:
    """Random params of ``dtype`` drawn on ``generator`` (and on its
    device; the weights drawn in float32 and cast)."""
    dims = [cfg.embed_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) \
        + [cfg.latent_dim]
    dev = generator.device
    layers = {}
    for i in range(cfg.num_layers):
        layers[f"l{i}"] = {
            "w": dense_init(generator, dims[i], (dims[i + 1],), dtype),
            "b": torch.zeros(dims[i + 1], dtype=dtype, device=dev),
        }
    proj = {"w": dense_init(generator, cfg.latent_dim, (cfg.proj_dim,),
                            dtype),
            "b": torch.zeros(cfg.proj_dim, dtype=dtype, device=dev)}
    return {"layers": layers, "proj": proj}


def _dense(layer: Params, x: torch.Tensor) -> torch.Tensor:
    w, b = layer["w"], layer["b"]
    # a stacked (lane-axis) tree adds each lane's bias to all its rows
    return x @ w + (b.unsqueeze(-2) if w.dim() == 3 else b)


def encoder_axes(cfg: ProxyConfig) -> Params:
    layers = {f"l{i}": {"w": ("proxy_in", "proxy_out"), "b": ("proxy_out",)}
              for i in range(cfg.num_layers)}
    return {"layers": layers,
            "proj": {"w": ("proxy_in", "proxy_out"), "b": ("proxy_out",)}}


def encoder_apply(params: Params, e: torch.Tensor) -> torch.Tensor:
    """e: (..., D) -> latent z: (..., l)."""
    x = e
    n = len(params["layers"])
    for i in range(n):
        x = _dense(params["layers"][f"l{i}"], x)
        if i < n - 1:
            x = gelu(x)
    return x


def projector_apply(params: Params, z: torch.Tensor) -> torch.Tensor:
    """Training-only projector head."""
    return _dense(params["proj"], z)


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity over the last axis (broadcasting)."""
    return torch.sum(l2_normalize(a) * l2_normalize(b), dim=-1)


def decision_scores(params: Params, e_q: torch.Tensor,
                    e_docs: torch.Tensor) -> torch.Tensor:
    """(1 + cos(z_q, z_d)) / 2 in [0, 1]. e_q: (D,); e_docs: (N, D)."""
    z_q = encoder_apply(params, e_q)
    z_d = encoder_apply(params, e_docs)
    cos = l2_normalize(z_d) @ l2_normalize(z_q)
    return (1.0 + cos) / 2.0


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (the order ``jax.tree.leaves`` uses)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def params_from_jax(tree, device="cpu") -> Params:
    """The JAX package's param tree (numpy or jax arrays) -> the port's
    float32 params on ``device``. Both keep ``w`` as ``(in, out)``."""
    from repro_torch.models import params_from_jax as carry
    return carry(tree, device, torch.float32)


def params_to_numpy(params: Params):
    """The port's params -> a tree of numpy arrays the JAX package takes."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
