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


def resolve_partial(x):
    """A DTensor with partial sums (a lookup into a sharded table, a
    product over a sharded dimension) reduced to replicated on those
    mesh dimensions, its other placements kept; anything else as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def whole_dim(w, dim: int):
    """A DTensor weight with its dimension ``dim`` brought together on
    every rank (its shards all-gathered, as FSDP gathers a weight's
    "data" shards before a product; the backward reduce-scatters the
    gradient to them), its other placements kept; anything else as it
    is. A lookup or product whose weight is sharded over a mesh dimension
    that also shards the tokens' batch has no sharding rule of DTensor's
    that keeps the batch split (an embedding lookup raises; the head's
    product gives partial sums over the batch's axis)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor) or not any(p.is_shard(dim)
                                             for p in w.placements):
        return w
    return w.redistribute(w.device_mesh, [Replicate() if p.is_shard(dim)
                                          else p for p in w.placements])


def full_value(x):
    """A DTensor's value as a plain tensor, the same on every rank (its
    partial sums reduced, its shards gathered); anything else as it
    is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


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
    masked sum over ``max(sum(mask), 1)``. Logits that are a DTensor
    (sharded over the vocabulary by the ``"vocab": "model"`` rule, or
    not) go through ``vocab_nll``: they never come together on one rank,
    each position's loss taken from per-shard maxima, sums and the
    label's owner."""
    if _is_dtensor(logits):
        nll = vocab_nll(logits, labels)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if mask is not None:
        mask = torch.as_tensor(mask, device=nll.device).to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _VocabNLL(torch.autograd.Function):
    """Per-position negative log-likelihood of vocabulary-sharded
    logits. Forward: each rank's max over its vocabulary slice, the
    maxima all-gathered (the global max M), sum exp(l - M) all-reduced,
    and the label's logit taken by the rank that owns it and
    all-reduced: every message is one float a position. Backward:
    softmax - one-hot on each rank's own slice."""

    @staticmethod
    def forward(ctx, logits, labels):
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Replicate

        from repro_torch.sharding.rules import block_index
        mesh = logits.device_mesh
        last = logits.dim() - 1
        vdims = [i for i, p in enumerate(logits.placements)
                 if p.is_shard(last)]
        out_pl = [Replicate() if p.is_shard(last) else p
                  for p in logits.placements]
        if any(not (p.is_shard() or p.is_replicate()) for p in out_pl):
            raise ValueError(f"vocab_nll: logits placed {logits.placements}")
        if isinstance(labels, DTensor):
            labels = labels.redistribute(mesh, out_pl).to_local()
        else:
            labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim
                                        ).redistribute(mesh, out_pl).to_local()
        local = logits.to_local().float()
        vl = local.shape[-1]
        offset = vl * block_index(mesh, vdims)
        groups = [mesh.get_group(d) for d in vdims]
        m = local.max(dim=-1).values
        for g in groups:
            gathered = [torch.empty_like(m) for _ in range(dist.get_world_size(g))]
            dist.all_gather(gathered, m.contiguous(), group=g)
            m = torch.stack(gathered).max(dim=0).values
        lab = labels.long()
        own = (lab >= offset) & (lab < offset + vl)
        idx = (lab - offset).clamp(0, vl - 1)
        picked = torch.where(own, torch.gather(local, -1, idx[..., None])[..., 0],
                             torch.zeros_like(m))
        sums = torch.exp(local - m[..., None]).sum(-1)
        both = torch.stack([sums, picked])
        for g in groups:
            dist.all_reduce(both, group=g)
        lse = m + torch.log(both[0])
        ctx.save_for_backward(local, lse, idx, own)
        ctx.placements = (logits.placements, out_pl)
        ctx.mesh = mesh
        ctx.dtype = logits.dtype
        return DTensor.from_local(lse - both[1], mesh, out_pl)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        local, lse, idx, own = ctx.saved_tensors
        in_pl, out_pl = ctx.placements
        g = g.redistribute(ctx.mesh, out_pl).to_local()
        grad = torch.exp(local - lse[..., None])
        grad.scatter_add_(-1, idx[..., None], -own.to(grad.dtype)[..., None])
        grad = (grad * g[..., None]).to(ctx.dtype)
        return DTensor.from_local(grad, ctx.mesh, in_pl), None


def vocab_nll(logits, labels) -> torch.Tensor:
    """(...,) float32 negative log-likelihoods of a DTensor of logits
    (..., V), sharded over V or not, as a DTensor placed as the logits
    without the vocabulary's sharding; ``labels`` (...) int, plain (the
    same on every rank) or a DTensor."""
    return _VocabNLL.apply(logits, labels)


def vocab_argmax(x) -> torch.Tensor:
    """The index of each row's max over the last dimension, ties taking
    the first, as ``torch.argmax``: a plain tensor of ``x``'s leading
    shape. A DTensor's vocabulary shards never come together: each rank
    takes its slice's max and the first (global) index of it, the max is
    all-reduced over the mesh dimensions that shard the vocabulary, then
    the least index reaching it; rows sharded over a mesh dimension are
    gathered at the end (one index a row), so every rank holds them
    all."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return torch.argmax(x, dim=-1)
    import torch.distributed as dist

    from repro_torch.sharding.rules import local_range
    x = resolve_partial(x)
    mesh, last = x.device_mesh, x.dim() - 1
    local = x.to_local()
    idx = torch.argmax(local, dim=-1)
    best = torch.gather(local, -1, idx[..., None])[..., 0]
    idx = idx + local_range(x, last)[0]
    groups = [mesh.get_group(i) for i, p in enumerate(x.placements)
              if p.is_shard(last)]
    top = best.clone()
    for g in groups:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
    idx = torch.where(best == top, idx,
                      torch.full_like(idx, torch.iinfo(idx.dtype).max))
    for g in groups:
        dist.all_reduce(idx, op=dist.ReduceOp.MIN, group=g)
    rows = [p if p.is_shard() and p.dim < last else Replicate()
            for p in x.placements]
    if all(p.is_replicate() for p in rows):
        return idx
    return DTensor.from_local(idx, mesh, rows, run_check=False).full_tensor()
