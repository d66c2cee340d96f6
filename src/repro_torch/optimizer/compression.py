"""int8 gradient compression with error feedback
(``repro.optimizer.compression``).

Each gradient leaf is quantized to int8 with one scale per tensor,
max(|x|, 1e-12) / 127, and the quantization error is kept as a float32
residual that is added to the next step's gradient (error feedback), so
the scheme stays unbiased in the long run. In the JAX package the
data-parallel all-reduce then moves the int8 tensors; on one card the
round trip is what the optimizer sees, as it is there. ``torch.round``
rounds half to even, as ``jnp.round`` does, so q and the residual are
the JAX package's bits. On DTensor gradients (SPMD ranks,
``launch.mesh``) the scale is that of the global gradient, as in the
JAX package on a global array: ``max|x|`` of a sharded leaf is reduced
over the ranks (DTensor's partial max), so a shard's q and residual are
the single-device result's own slice; ``init_residual`` places each
residual as its param.

Usage inside a train step:
    grads_q, new_residual = compress_decompress(grads, residual)
    ... apply the optimizer to grads_q ...
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.common import resolve_partial, tree_map
from repro_torch.optimizer.adamw import zip_map


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp(resolve_partial(xf.abs().max()), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_residual(params: Any) -> Any:
    """float32 zeros shaped, and on a mesh placed, as each param."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


@torch.no_grad()
def compress_decompress(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Error-feedback int8 round trip over matching trees of gradients
    and float32 residuals. Returns (grads_hat, new_residual), both
    float32."""
    def one(g, r):
        corrected = g.float() + r
        q, scale = _quantize(corrected)
        ghat = _dequantize(q, scale)
        return ghat, corrected - ghat

    out = zip_map(one, grads, residual)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def compression_ratio(params: Any, from_dtype=torch.float32) -> float:
    """Bytes saved on the wire for one gradient all-reduce."""
    return from_dtype.itemsize / torch.int8.itemsize
