"""Plain PyTorch versions of the WKV6 recurrence
(``repro.kernels.wkv6.ref`` and the math of ``repro.kernels.wkv6.wkv6``).

``ref_wkv6`` is the sequential recurrence, the tests' oracle.
``wkv6_intra_chunk`` computes the intra-chunk step batched over every
(batch, chunk, head) at once, in one of two arithmetics: with
``sub=None`` the Pallas kernel's, one exponential per (row, row,
channel) term, the pairwise decay built one slab of ``K_SLAB`` channels
at a time as the Pallas kernel builds it; with ``sub=SUB`` the CUDA
kernel's (``csrc/wkv6.cu``), the sub-chunk form, which is its plain
version.
``chunk_combine`` is the inter-chunk state scan that follows the kernel,
the JAX ``wkv6_chunked``'s ``lax.scan`` written as a loop over chunks;
``wkv6_chunked`` is the two in turn, and ``wkv6_by_chunks`` the whole
recurrence over a sequence with a given chunked step: with
``wkv6_chunked`` it is the exact plain scan (the time-mix's ``direct``
mode), with the kernel's ``ops.wkv6_chunked`` it is ``ops.wkv6``. Each
of the three takes ``return_state=True`` to return the scan's final
state ``S`` (b, H, K, K) beside ``y``, which the combine computes in
every case; ``y`` is the same either way.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

K_SLAB = 16
SUB = 16                    # rows of a sub-chunk in the CUDA kernel's form


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


def wkv6_intra_chunk(r, k, v, cum, lw, u, k_slab: int = K_SLAB,
                     sub: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """r, k, v, cum, lw: (b, nc, Q, H, K) (cum = within-chunk cumsum of
    the log-decay lw); u: (H, K). Returns, all float32,
        y_intra (b, nc, Q, H, K) = A v + (r.u.k) v
        s_inj   (b, nc, H, K, K) = (k * exp(cum_Q - cum))^T v
        a_end   (b, nc, H, K)    = exp(cum_Q)
        r_dec   (b, nc, Q, H, K) = r * exp(cum_{t-1})
    with A[t, j] = sum_k r[t,k] exp(cum_{t-1}[t,k] - cum[j,k]) k[j,k] for
    j < t. cum_{t-1} is cum - lw, every exponent is of a difference, and
    the strictly lower triangle is taken by a select.

    ``sub`` cuts the rows into sub-chunks of ``sub`` rows, e_s the last
    row of sub-chunk s. A pair inside one sub-chunk is computed as above;
    a pair (t, j) with j in an earlier sub-chunk s factors through e_s:
    A[t, j] = sum_k rd[t,s,k] kd[j,k], rd = r[t] exp(cum_{t-1}[t] -
    cum[e_s]) and kd = k[j] exp(cum[e_s] - cum[j]), both exponents <= 0.
    """
    r, k, v, cum, lw, u = (t.float() for t in (r, k, v, cum, lw, u))
    b, nc, Q, H, K = r.shape
    cum_tm1 = cum - lw
    A = (_pairs(r, k, cum, cum_tm1, k_slab) if sub is None else
         _pairs_by_sub_chunks(r, k, cum, cum_tm1, k_slab, sub))
    diag = torch.sum(r * u * k, dim=-1)                   # (b, nc, Q, H)
    y = torch.einsum("bcqjh,bcjhk->bcqhk", A, v) + diag[..., None] * v
    dec_end = torch.exp(cum[:, :, -1:] - cum)
    s_inj = torch.einsum("bcqhk,bcqhv->bchkv", k * dec_end, v)
    a_end = torch.exp(cum[:, :, -1])
    r_dec = r * torch.exp(cum_tm1)
    return y, s_inj, a_end, r_dec


def _pairs(r, k, cum, cum_tm1, k_slab: int) -> torch.Tensor:
    """A (b, nc, Q, Q, H), one exponential per (t, j, channel) term."""
    b, nc, Q, H, K = r.shape
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
    return A


def _pairs_by_sub_chunks(r, k, cum, cum_tm1, k_slab: int,
                         sub: int) -> torch.Tensor:
    """A (b, nc, Q, Q, H) in the sub-chunk form: the pairs inside each
    sub-chunk as ``_pairs`` computes them, the pairs across sub-chunks as
    the dot product rd . kd."""
    b, nc, Q, H, K = r.shape
    n = -(-Q // sub)                        # sub-chunks, the last ragged
    pad = n * sub - Q
    dev = r.device
    iota = torch.arange(n * sub, device=dev)
    blk = iota // sub                                       # (n*sub,)
    last = torch.clamp(blk * sub + sub - 1, max=Q - 1)      # e_s of each row
    cum_e = cum[:, :, last[::sub]]                          # (b,nc,n,H,K)
    # across sub-chunks: j in s < s_t; exponents masked to 0 elsewhere so
    # that nothing overflows, and the pairs then taken by a select
    below = (torch.arange(n, device=dev)[None, :]
             < blk[:Q, None])[None, None, :, :, None, None]  # (1,1,Q,n,1,1)
    rd = r[:, :, :, None] * torch.exp(torch.where(
        below, cum_tm1[:, :, :, None] - cum_e[:, :, None], 0.0))
    kd = k * torch.exp(cum[:, :, last[:Q]] - cum)            # (b,nc,Q,H,K)
    kd = F.pad(kd, (0, 0, 0, 0, 0, pad)).reshape(b, nc, n, sub, H, K)
    A = torch.einsum("bcqnhk,bcnjhk->bcqnjh", rd, kd).reshape(
        b, nc, Q, n * sub, H)
    cross = (blk[None, :] < blk[:Q, None])[None, None, :, :, None]
    A = torch.where(cross, A, 0.0)
    # inside one sub-chunk: (b, nc, n, sub, sub, H) blocks of the diagonal
    ri, ki, ci, ti = (F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(
        b, nc, n, sub, H, K) for x in (r, k, cum, cum_tm1))
    loc = torch.arange(sub, device=dev)
    tri = ((loc[:, None] > loc[None, :])[None]
           & (iota.reshape(n, sub) < Q)[:, :, None])[..., None, None]
    A_in = torch.zeros((b, nc, n, sub, sub, H), dtype=torch.float32,
                       device=dev)
    ks = min(k_slab, K)
    for i in range(0, K, ks):
        sl = slice(i, i + ks)
        seg = ti[:, :, :, :, None, :, sl] - ci[:, :, :, None, :, :, sl]
        dec = torch.where(tri, torch.exp(seg), 0.0)   # (b,nc,n,sub,sub,H,ks)
        A_in = A_in + torch.einsum("bcnqhs,bcnqjhs,bcnjhs->bcnqjh",
                                   ri[..., sl], dec, ki[..., sl])
    # row t's own sub-chunk: block blk[t] of its columns
    A = A.reshape(b, nc, Q, n, sub, H)
    A[:, :, torch.arange(Q, device=dev), blk[:Q]] = A_in.reshape(
        b, nc, n * sub, sub, H)[:, :, :Q]
    return A.reshape(b, nc, Q, n * sub, H)[:, :, :, :Q]


def chunk_combine(y_intra, s_inj, a_end, r_dec, return_state: bool = False):
    """The inter-chunk scan over the intra-chunk outputs: chunk c adds
    r_dec_c S to its y_intra, then S = a_end_c S + s_inj_c. Returns y
    (b, nc, Q, H, K) float32, or (y, S) with ``return_state``: S the
    state after the last chunk (b, H, K, K) float32."""
    b, nc, Q, H, K = y_intra.shape
    S = torch.zeros((b, H, K, K), dtype=torch.float32,
                    device=y_intra.device)
    ys = torch.empty_like(y_intra)
    for c in range(nc):
        ys[:, c] = y_intra[:, c] + torch.einsum("bqhk,bhkv->bqhv",
                                                r_dec[:, c], S)
        S = a_end[:, c, :, :, None] * S + s_inj[:, c]
    return (ys, S) if return_state else ys


def chunk_len(s: int, chunk: int = 128) -> int:
    """The chunk length for a sequence of ``s`` tokens: ``min(chunk, s)``,
    decremented until it divides ``s`` (s=200 gives 100; a prime s above
    ``chunk`` gives 1), as ``repro.models.rwkv`` and ``repro.kernels.wkv6
    .ops`` pick it."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def wkv6_chunked(r, k, v, cum, lw, u, return_state: bool = False):
    """The full recurrence over chunked inputs (b, nc, Q, H, K): the
    plain intra-chunk step, then the combine (y, or (y, S))."""
    return chunk_combine(*wkv6_intra_chunk(r, k, v, cum, lw, u),
                         return_state=return_state)


def wkv6_by_chunks(r, k, v, lw, u, *, chunk: int = 128,
                   chunked: Callable = wkv6_chunked,
                   return_state: bool = False):
    """r, k, v, lw: (b, s, H, K) float32; u: (H, K) -> y (b, s, H, K)
    float32: S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T, y_t = r_t^T
    S_{t-1} + (r_t . u . k_t) v_t. The sequence is cut into chunks of
    ``chunk_len(s, chunk)`` tokens, the log-decay summed within each and
    ``chunked`` applied to them. With ``return_state`` it returns (y,
    S_s), the state after the last token (b, H, K, K), and passes
    ``return_state=True`` on to ``chunked``."""
    b, s, H, K = r.shape
    Q = chunk_len(s, chunk)
    rs, ks, vs, lws = (t.reshape(b, s // Q, Q, H, K) for t in (r, k, v, lw))
    cum = torch.cumsum(lws, dim=2)
    if not return_state:
        return chunked(rs, ks, vs, cum, lws, u).reshape(b, s, H, K)
    y, S = chunked(rs, ks, vs, cum, lws, u, return_state=True)
    return y.reshape(b, s, H, K), S
