"""Wrappers of the fused scoring kernel (``csrc/fused_scoring.cu``).

``fused_scores_multi`` launches the CUDA kernel for CUDA tensors and
computes the plain PyTorch version (``ref.ref_scores_multi``) for CPU
tensors; it never falls back from one to the other. ``fused_scores`` is
the single-query form: the Q=1 launch of the same kernel. The engine's
streaming hot path (``repro_torch.engine.executor``) calls
``score_tile_multi`` per prefetched tile; ``score_collection`` and
``score_collection_multi`` score a whole in-memory collection. These
three take the JAX package's switches: ``force_ref=True`` computes the
plain version on any device; ``interpret=True`` (Pallas interpret mode)
has no counterpart and raises. On meta tensors and under the cost
counter a call is one operator, ``repro_torch::fused_scores_multi``
(``kernels._cost``): meta tensors get an empty output and the counter
charges ``fused_work``. A CUDA call whose inputs require grad raises
(the kernel has no backward); on the CPU it runs the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.encoder import encoder_apply, l2_normalize
from repro_torch.device import resolve_device
from repro_torch.kernels import INTERPRET, _cost
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.fused_scoring import ref

KERNEL = CudaKernel(
    "fused_scoring", "fused_scores_launch",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5)

# widths the kernel is built for (fused_scores_supported in the source)
WIDTHS = (64, 128, 256, 512)


def _unpack(params):
    ls = params["layers"]
    if len(ls) != 3:
        raise ValueError("the fused kernel is specialized for 3-layer "
                         f"proxies, got {len(ls)} layers")
    return (ls["l0"]["w"], ls["l0"]["b"], ls["l1"]["w"], ls["l1"]["b"],
            ls["l2"]["w"], ls["l2"]["b"])


def _check(docs, w1, b1, w2, b2, w3, b3, zq):
    n, d = docs.shape
    h, l, q = w1.shape[1], w3.shape[1], zq.shape[0]
    shapes = {"w1": (d, h), "b1": (h,), "w2": (h, h), "b2": (h,),
              "w3": (h, l), "b3": (l,), "zq": (q, l)}
    tensors = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3,
               "zq": zq}
    for name, t in [("docs", docs)] + list(tensors.items()):
        if name != "docs" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.device != docs.device:
            raise ValueError(f"{name} is on {t.device}, docs on "
                             f"{docs.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h not in WIDTHS or l not in WIDTHS or l > h:
        raise ValueError(f"fused kernel takes hidden and latent widths in "
                         f"{WIDTHS} with latent <= hidden; got H={h}, L={l}")
    if q < 1:
        raise ValueError("need at least one query latent")


def fused_scores_multi(docs, w1, b1, w2, b2, w3, b3,
                       zq_stack) -> torch.Tensor:
    """docs (N, D), zq_stack (Q, L) unit rows -> scores (N, Q) in [0, 1]."""
    if _cost.plain_for_grad("fused_scores_multi", docs, w1, b1, w2, b2,
                            w3, b3, zq_stack):
        return ref.ref_scores_multi(docs, w1, b1, w2, b2, w3, b3, zq_stack)
    run = _fused_op if _cost.through_op(docs) else _fused_run
    return run(docs, w1, b1, w2, b2, w3, b3, zq_stack, False)


def _fused_run(docs: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
               b3: torch.Tensor, zq_stack: torch.Tensor,
               single: bool) -> torch.Tensor:
    """(N, Q) scores; ``single``: the Q = 1 form, whose plain version is
    ``ref.ref_scores``."""
    if not docs.is_cuda:
        if single:
            return ref.ref_scores(docs, w1, b1, w2, b2, w3, b3,
                                  zq_stack[0])[:, None].contiguous()
        return ref.ref_scores_multi(docs, w1, b1, w2, b2, w3, b3,
                                    zq_stack).contiguous()
    _check(docs, w1, b1, w2, b2, w3, b3, zq_stack)
    n, d = docs.shape
    out = torch.empty((n, zq_stack.shape[0]), dtype=torch.float32,
                      device=docs.device)
    if n == 0:
        return out
    KERNEL.launch(docs.device, docs, w1, b1, w2, b2, w3, b3, zq_stack, out,
                  n, d, w1.shape[1], w3.shape[1], zq_stack.shape[0])
    return out


_fused_op = torch.library.custom_op("repro_torch::fused_scores_multi",
                                    _fused_run, mutates_args=())


@_fused_op.register_fake
def _(docs, w1, b1, w2, b2, w3, b3, zq_stack, single):
    return docs.new_empty((docs.shape[0], zq_stack.shape[0]))


def fused_work(docs, w1, b1, w2, b2, w3, b3, zq_stack,
               single=False) -> _cost.KernelWork:
    """The kernel's work a call: the three layers' products and the
    cosine against each query latent, two tanh GELUs (one tanh an
    element) and a norm a row; every input read once, (N, Q) written
    once."""
    n, d = docs.shape
    h, lat, q = w1.shape[1], w3.shape[1], zq_stack.shape[0]
    products = 2.0 * n * (d * h + h * h + h * lat + lat * q)
    return _cost.KernelWork(
        flops=products, products=products, transcendental=2.0 * n * h + n,
        bytes=_cost.nbytes(docs, w1, b1, w2, b2, w3, b3, zq_stack)
        + 4.0 * n * q)


_cost.register_cost(_fused_op, fused_work)


def fused_scores(docs, w1, b1, w2, b2, w3, b3,
                 zq_normalized) -> torch.Tensor:
    """docs (N, D), zq_normalized (L,) unit -> (N,) scores in [0, 1]."""
    if _cost.plain_for_grad("fused_scores", docs, w1, b1, w2, b2, w3, b3,
                            zq_normalized):
        return ref.ref_scores(docs, w1, b1, w2, b2, w3, b3, zq_normalized)
    run = _fused_op if _cost.through_op(docs) else _fused_run
    return run(docs, w1, b1, w2, b2, w3, b3, zq_normalized.reshape(1, -1),
               True)[:, 0]


def normalized_query_latents(params, e_qs: torch.Tensor) -> torch.Tensor:
    """(Q, D) query embeddings -> (Q, L) unit latents for the kernel;
    ``params=None`` means raw-embedding cosine (no proxy)."""
    e_qs = torch.atleast_2d(e_qs)
    if params is None:
        return l2_normalize(e_qs)
    return l2_normalize(encoder_apply(params, e_qs))


def score_tile_multi(params, zq_stack: torch.Tensor,
                     tile: torch.Tensor, *, force_ref: bool = False,
                     interpret: bool = False) -> torch.Tensor:
    """One document tile (B, D) x (Q, L) unit latents -> (B, Q).

    Proxy groups go through the fused kernel (the plain version with
    ``force_ref``). ``params=None`` (raw cosine) has no MLP to fuse and
    stays a plain matmul, as it is plain jnp in the JAX package.
    """
    if interpret:
        raise ValueError(INTERPRET)
    if params is None:
        return 0.5 * (1.0 + l2_normalize(tile) @ zq_stack.T)
    if force_ref:
        return ref.ref_scores_multi(tile, *_unpack(params), zq_stack)
    return fused_scores_multi(tile, *_unpack(params), zq_stack)


def score_collection(params, e_q, embeds, *, chunk: int = 65536,
                     force_ref: bool = False, interpret: bool = False,
                     device="cuda") -> np.ndarray:
    """(N, D) document embeddings -> (N,) scores via the fused kernel
    (the plain version with ``force_ref``)."""
    if interpret:
        raise ValueError(INTERPRET)
    dev = resolve_device(device)
    w = _unpack(params)
    zq = l2_normalize(encoder_apply(params, torch.as_tensor(
        np.asarray(e_q, np.float32), device=dev)))
    score = ref.ref_scores if force_ref else fused_scores
    outs = []
    for start in range(0, embeds.shape[0], chunk):
        tile = torch.as_tensor(np.ascontiguousarray(
            embeds[start:start + chunk], np.float32), device=dev)
        outs.append(score(tile, *w, zq).cpu().numpy())
    return np.concatenate(outs).astype(np.float32)


def score_collection_multi(params, e_qs, embeds, *, chunk: int = 65536,
                           force_ref: bool = False, interpret: bool = False,
                           device="cuda") -> np.ndarray:
    """(N, D) documents x (Q, D) query embeddings sharing one proxy ->
    (N, Q) scores via the fused kernel (the plain version with
    ``force_ref``)."""
    if interpret:
        raise ValueError(INTERPRET)
    dev = resolve_device(device)
    zq = normalized_query_latents(params, torch.as_tensor(
        np.asarray(e_qs, np.float32), device=dev))
    outs = []
    for start in range(0, embeds.shape[0], chunk):
        tile = torch.as_tensor(np.ascontiguousarray(
            embeds[start:start + chunk], np.float32), device=dev)
        outs.append(score_tile_multi(params, zq, tile,
                                     force_ref=force_ref).cpu().numpy())
    return np.concatenate(outs).astype(np.float32)
