"""Wrapper of the WKV6 intra-chunk kernel (``csrc/wkv6.cu``) and the
chunked recurrence built on it (``repro.kernels.wkv6.{wkv6,ops}``).

``wkv6_intra_chunk`` launches the CUDA kernel for CUDA tensors and
computes its plain PyTorch version (``ref.wkv6_intra_chunk`` in the
sub-chunk form, ``sub=ref.SUB``) for CPU tensors; it never falls back
from one to the other. ``wkv6_chunked`` is
the kernel followed by the inter-chunk combine (plain PyTorch, as the
JAX package leaves its ``lax.scan`` outside the Pallas kernel), and
``wkv6`` the entry the RWKV6 time-mix calls: ``ref.wkv6_by_chunks``
over ``wkv6_chunked``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.wkv6 import ref

KERNEL = CudaKernel("wkv6", "wkv6_intra_chunk_launch",
                    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5)

# the arithmetic's revision, recorded beside every store this kernel
# writes: 2 is the sub-chunk form
REVISION = 2
MAX_CHUNK = 128             # the longest chunk (rows of a block)
MAX_HEAD_DIM = 64           # the widest head (channels of a row)


def _check(r, k, v, cum, lw, u) -> None:
    for name, t in (("r", r), ("k", k), ("v", v), ("cum", cum), ("lw", lw),
                    ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "u" and t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}")
    if r.dim() != 5:
        raise ValueError(f"r must be (b, nc, Q, H, K), got {tuple(r.shape)}")
    b, nc, Q, H, K = r.shape
    if u.shape != (H, K):
        raise ValueError(f"u {tuple(u.shape)} is not (H, K) = ({H}, {K})")
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk length {Q} > {MAX_CHUNK}")
    if K > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {K} > {MAX_HEAD_DIM}")


def wkv6_intra_chunk(r, k, v, cum, lw, u):
    """r, k, v, cum, lw: (b, nc, Q, H, K); u: (H, K) -> (y_intra (b, nc,
    Q, H, K), s_inj (b, nc, H, K, K), a_end (b, nc, H, K), r_dec (b, nc,
    Q, H, K)), all float32 (see ``ref.wkv6_intra_chunk``)."""
    if not r.is_cuda:
        return ref.wkv6_intra_chunk(r, k, v, cum, lw, u, sub=ref.SUB)
    _check(r, k, v, cum, lw, u)
    b, nc, Q, H, K = r.shape
    y = torch.empty_like(r)
    r_dec = torch.empty_like(r)
    s_inj = r.new_empty((b, nc, H, K, K))
    a_end = r.new_empty((b, nc, H, K))
    if r.numel() == 0:
        return y, s_inj, a_end, r_dec
    KERNEL.launch(r.device, r, k, v, cum, lw, u, y, s_inj, a_end, r_dec,
                  b, nc, Q, H, K)
    return y, s_inj, a_end, r_dec


def wkv6_chunked(r, k, v, cum, lw, u) -> torch.Tensor:
    """The full recurrence over chunked inputs (b, nc, Q, H, K): the
    kernel, then the inter-chunk combine. Returns y (b, nc, Q, H, K)."""
    return ref.chunk_combine(*wkv6_intra_chunk(r, k, v, cum, lw, u))


def wkv6(r, k, v, lw, u, *, chunk: int = 128) -> torch.Tensor:
    """r, k, v, lw: (b, s, H, K) float32; u: (H, K) -> y (b, s, H, K)
    float32: S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T, y_t = r_t^T
    S_{t-1} + (r_t . u . k_t) v_t, through the kernel."""
    return ref.wkv6_by_chunks(r, k, v, lw, u, chunk=chunk,
                              chunked=wkv6_chunked)
