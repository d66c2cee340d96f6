"""Shared building blocks of the port's models (``repro.models.common``).

Initializers draw on a ``torch.Generator`` and on its device. RMSNorm
and RoPE compute in float32 and cast back to the input's type, as the
JAX package does; RoPE rotates the two halves of each head
(``[x1 cos - x2 sin, x1 sin + x2 cos]``), not interleaved pairs.
The sinusoidal positions of the encoder-decoder models compute in
float32 with the JAX package's ``div`` expression. ``cross_entropy``
is the LM loss. ``rmsnorm_axes`` is RMSNorm's logical-axes table (the
sharding rules' input, ``sharding.rules``).

``constrain(x, logical_axes)`` is the activation-sharding hook the
blocks call inside their chunk scans, where the JAX package calls its
own. The JAX package installs its resolver in a module global
(``set_constrainer``) that nothing resets; here ``constrainer(fn)``
installs ``fn`` in a ``contextvars.ContextVar`` for the duration of a
``with`` block (a launch plan's step, ``launch.steps``) and resets it
on leaving, so no state outlives the call and another thread or
context never sees it. With none installed ``constrain`` returns ``x``.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# the resolver of the active launch step, if any (``constrainer``)
_CONSTRAINER: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("repro_torch_constrainer", default=None)


@contextlib.contextmanager
def constrainer(fn: Callable) -> Iterator[None]:
    """Within the block, ``constrain(x, axes)`` is ``fn(x, axes)``."""
    token = _CONSTRAINER.set(fn)
    try:
        yield
    finally:
        _CONSTRAINER.reset(token)


def constrain(x, logical_axes):
    """``x`` through the active step's resolver (``constrainer``), or
    ``x`` itself when none is installed."""
    fn = _CONSTRAINER.get()
    return x if fn is None else fn(x, logical_axes)


def tree_map(fn, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dictionary."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


class _ShapeOnly:
    """A stand-in for a ``torch.Generator`` on the meta device: an init
    given it draws nothing and returns meta tensors of the params' shapes
    and types (``param_specs``), as ``jax.eval_shape`` of an init does."""
    device = torch.device("meta")


SHAPE_ONLY = _ShapeOnly()


def param_specs(model) -> Params:
    """``model.init``'s tree as meta tensors: shapes and types, no
    storage and no draws, at any size."""
    return model.init(SHAPE_ONLY)


def randn(shape: Tuple[int, ...], generator) -> torch.Tensor:
    """A float32 standard normal of ``shape`` drawn on ``generator``'s
    device (empty on the meta device)."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)


def dense_init(generator: torch.Generator, in_dim: int,
               out_shape: Tuple[int, ...],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut to [-2, 2],
    scaled by 1/sqrt(in_dim), drawn in float32 on the generator's device
    and cast to ``dtype``."""
    w = torch.empty((in_dim,) + tuple(out_shape), dtype=torch.float32,
                    device=generator.device)
    if w.device.type != "meta":
        torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=generator)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """A standard normal times 0.02, drawn in float32 and scaled in place
    before the cast, so the table is never held twice in float32."""
    return randn((vocab, dim), generator).mul_(0.02).to(dtype)


def rmsnorm_init(dim: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_axes() -> Params:
    return {"scale": ("embed",)}


def rmsnorm_apply(params: Params, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * freqs     # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                 # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _sinusoid_div(dim: int, device) -> torch.Tensor:
    return torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device)
                     * (-math.log(10000.0) / dim))


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """(seq, dim) float32: sin at the even columns, cos at the odd ones,
    of position times ``exp(2i * -log(10000) / dim)``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    ang = pos * _sinusoid_div(dim, device)
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def sinusoidal_position_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """The (dim,) float32 row of ``sinusoidal_positions`` for a 0-d
    position tensor, on its device: nothing is read back to the host."""
    ang = pos.float() * _sinusoid_div(dim, pos.device)
    pe = torch.zeros((dim,), dtype=torch.float32, device=pos.device)
    pe[0::2] = torch.sin(ang)
    pe[1::2] = torch.cos(ang)
    return pe


def activation(name: str):
    """``jax.nn.gelu`` defaults to its tanh form, so ``"gelu"`` is tanh."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu,
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}[name]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Softmax cross-entropy: logits (..., V) taken in float32, labels
    int (...). The mean over every position, or with ``mask`` (...) the
    masked sum over ``max(sum(mask), 1)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = torch.as_tensor(mask, device=nll.device).to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
