"""Plain PyTorch versions of the WKV6 recurrence
(``repro.kernels.wkv6.ref`` and the math of ``repro.kernels.wkv6.wkv6``).

``ref_wkv6`` is the sequential recurrence, the tests' oracle.
``wkv6_intra_chunk`` is the plain version of the CUDA kernel
(``csrc/wkv6.cu``): the Pallas kernel's arithmetic, batched over every
(batch, chunk, head) at once, with the pairwise decay built one slab of
``K_SLAB`` channels at a time as the Pallas kernel builds it.
``chunk_combine`` is the inter-chunk state scan that follows the kernel,
the JAX ``wkv6_chunked``'s ``lax.scan`` written as a loop over chunks;
``wkv6_chunked`` is the two in turn, and ``wkv6_by_chunks`` the whole
recurrence over a sequence with a given chunked step: with
``wkv6_chunked`` it is the exact plain scan (the time-mix's ``direct``
mode), with the kernel's ``ops.wkv6_chunked`` it is ``ops.wkv6``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

K_SLAB = 16


def ref_wkv6(r, k, v, lw, u) -> torch.Tensor:
    """Sequential WKV6. r, k, v, lw: (b, s, H, K) f32; u: (H, K).
    Returns y (b, s, H, K):
        S_t = diag(w_t) S_{t-1} + k_t v_t^T;  w = exp(lw)
        y_t = r_t^T S_{t-1} + (r_t . u . k_t) v_t
    """
    b, s, H, K = r.shape
    w = torch.exp(lw)
    S = torch.zeros((b, H, K, K), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (b, H, K)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, S)
                  + torch.einsum("bhk,hk,bhk->bh", rt, u, kt)[..., None]
                  * vt)
        S = wt[..., None] * S + kt[..., None] * vt[:, :, None, :]
    return torch.stack(ys, dim=1)


def wkv6_intra_chunk(r, k, v, cum, lw, u, k_slab: int = K_SLAB
                     ) -> Tuple[torch.Tensor, ...]:
    """r, k, v, cum, lw: (b, nc, Q, H, K) (cum = within-chunk cumsum of
    the log-decay lw); u: (H, K). Returns, all float32,
        y_intra (b, nc, Q, H, K) = A v + (r.u.k) v
        s_inj   (b, nc, H, K, K) = (k * exp(cum_Q - cum))^T v
        a_end   (b, nc, H, K)    = exp(cum_Q)
        r_dec   (b, nc, Q, H, K) = r * exp(cum_{t-1})
    with A[t, j] = sum_k r[t,k] exp(cum_{t-1}[t,k] - cum[j,k]) k[j,k] for
    j < t. cum_{t-1} is cum - lw, every exponent is of a difference, and
    the strictly lower triangle is taken by a select."""
    r, k, v, cum, lw, u = (t.float() for t in (r, k, v, cum, lw, u))
    b, nc, Q, H, K = r.shape
    cum_tm1 = cum - lw
    iota = torch.arange(Q, device=r.device)
    tri = (iota[:, None] > iota[None, :])[:, :, None, None]   # (Q, Q, 1, 1)
    A = torch.zeros((b, nc, Q, Q, H), dtype=torch.float32, device=r.device)
    ks = min(k_slab, K)
    for i in range(0, K, ks):
        sl = slice(i, i + ks)
        seg = cum_tm1[:, :, :, None, :, sl] - cum[:, :, None, :, :, sl]
        dec = torch.where(tri, torch.exp(seg), 0.0)   # (b,nc,Q,Q,H,ks)
        A = A + torch.einsum("bcqhs,bcqjhs,bcjhs->bcqjh", r[..., sl], dec,
                             k[..., sl])
    diag = torch.sum(r * u * k, dim=-1)                   # (b, nc, Q, H)
    y = torch.einsum("bcqjh,bcjhk->bcqhk", A, v) + diag[..., None] * v
    dec_end = torch.exp(cum[:, :, -1:] - cum)
    s_inj = torch.einsum("bcqhk,bcqhv->bchkv", k * dec_end, v)
    a_end = torch.exp(cum[:, :, -1])
    r_dec = r * torch.exp(cum_tm1)
    return y, s_inj, a_end, r_dec


def chunk_combine(y_intra, s_inj, a_end, r_dec) -> torch.Tensor:
    """The inter-chunk scan over the intra-chunk outputs: chunk c adds
    r_dec_c S to its y_intra, then S = a_end_c S + s_inj_c. Returns y
    (b, nc, Q, H, K) float32."""
    b, nc, Q, H, K = y_intra.shape
    S = torch.zeros((b, H, K, K), dtype=torch.float32,
                    device=y_intra.device)
    ys = torch.empty_like(y_intra)
    for c in range(nc):
        ys[:, c] = y_intra[:, c] + torch.einsum("bqhk,bhkv->bqhv",
                                                r_dec[:, c], S)
        S = a_end[:, c, :, :, None] * S + s_inj[:, c]
    return ys


def chunk_len(s: int, chunk: int = 128) -> int:
    """The chunk length for a sequence of ``s`` tokens: ``min(chunk, s)``,
    decremented until it divides ``s`` (s=200 gives 100; a prime s above
    ``chunk`` gives 1), as ``repro.models.rwkv`` and ``repro.kernels.wkv6
    .ops`` pick it."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def wkv6_chunked(r, k, v, cum, lw, u) -> torch.Tensor:
    """The full recurrence over chunked inputs (b, nc, Q, H, K): the
    plain intra-chunk step, then the combine."""
    return chunk_combine(*wkv6_intra_chunk(r, k, v, cum, lw, u))


def wkv6_by_chunks(r, k, v, lw, u, *, chunk: int = 128,
                   chunked: Callable = wkv6_chunked) -> torch.Tensor:
    """r, k, v, lw: (b, s, H, K) float32; u: (H, K) -> y (b, s, H, K)
    float32: S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T, y_t = r_t^T
    S_{t-1} + (r_t . u . k_t) v_t. The sequence is cut into chunks of
    ``chunk_len(s, chunk)`` tokens, the log-decay summed within each and
    ``chunked`` applied to them."""
    b, s, H, K = r.shape
    Q = chunk_len(s, chunk)
    rs, ks, vs, lws = (t.reshape(b, s // Q, Q, H, K) for t in (r, k, v, lw))
    cum = torch.cumsum(lws, dim=2)
    return chunked(rs, ks, vs, cum, lws, u).reshape(b, s, H, K)
