"""Wrapper of the WKV6 intra-chunk kernel (``csrc/wkv6.cu``) and the
chunked recurrence built on it (``repro.kernels.wkv6.{wkv6,ops}``).

``wkv6_intra_chunk`` launches the CUDA kernel for CUDA tensors and
computes its plain PyTorch version (``ref.wkv6_intra_chunk`` in the
sub-chunk form, ``sub=ref.SUB``) for CPU tensors; it never falls back
from one to the other. ``wkv6_chunked`` is
the kernel followed by the inter-chunk combine (plain PyTorch, as the
JAX package leaves its ``lax.scan`` outside the Pallas kernel), and
``wkv6`` the entry the RWKV6 time-mix calls: ``ref.wkv6_by_chunks``
over ``wkv6_chunked``. Both take ``return_state=True`` to return the
combine's final state beside ``y`` (the prefill of a decode); the
kernel's launch and ``y`` are the same either way.

The kernel has no backward (nor has the Pallas kernel it replaces): a
CUDA input that requires grad, with grad mode on, raises rather than
leave the inputs with no gradient. RWKV training on the card runs the
time-mix's ``"direct"`` mode (``runtime.train_loop.Trainer``), the JAX
package's default, which launches no kernel; on the CPU the plain
version is differentiable.

On meta tensors and under the cost counter a call is one operator,
``repro_torch::wkv6_intra_chunk`` (``kernels._cost``): meta tensors get
empty outputs and the counter charges ``wkv6_work``. ``wkv6`` takes
the JAX package's switches: ``force_ref=True`` runs the plain chunked
recurrence (``ref.wkv6_chunked``, the pairwise form: the time-mix's
``"direct"`` mode) on any device; ``interpret=True`` (Pallas interpret
mode) has no counterpart and raises.

On a mesh of SPMD ranks the recurrence runs on each rank's heads
(``RankHeads``, the WKV6 counterpart of the flash wrapper's
``HeadShards``): r, k, v and the log-decay (b, s, H, K) with the batch
over their row dimensions and H over the model axis, u (H, K) by its
rows, go to plain local tensors, any of the three recurrences runs on
them (this kernel's grid is one block a (batch, chunk, head), so a
rank's launch computes exactly its heads' rows), and y and the final
state are wrapped back with the same placements. Nothing is exchanged
inside the recurrence. Where H does not split over the model axis the
heads are gathered instead, and every rank of that axis runs them all.
The local tensors declare their gradients' placements, so the plain
recurrences stay differentiable through them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import INTERPRET, _cost
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
    if _cost.plain_for_grad(
            "wkv6_intra_chunk", r, k, v, cum, lw, u,
            hint="; with no WKV6 backward, train RWKV6 in the time-mix's "
                 "\"direct\" mode"):
        return ref.wkv6_intra_chunk(r, k, v, cum, lw, u, sub=ref.SUB)
    run = _wkv6_op if _cost.through_op(r) else _wkv6_run
    return tuple(run(r, k, v, cum, lw, u))


def _wkv6_run(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cum: torch.Tensor, lw: torch.Tensor, u: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    if not r.is_cuda:
        return tuple(t.contiguous() for t in ref.wkv6_intra_chunk(
            r, k, v, cum, lw, u, sub=ref.SUB))
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


_wkv6_op = torch.library.custom_op("repro_torch::wkv6_intra_chunk",
                                   _wkv6_run, mutates_args=())


@_wkv6_op.register_fake
def _(r, k, v, cum, lw, u):
    b, nc, Q, H, K = r.shape
    return (torch.empty_like(r), r.new_empty((b, nc, H, K, K)),
            r.new_empty((b, nc, H, K)), torch.empty_like(r))


def wkv6_work(r, k, v, cum, lw, u) -> _cost.KernelWork:
    """The kernel's work in the sub-chunk form (``ref.SUB``-row
    sub-chunks). The least exponentials that keep every exponent <= 0:
    one a channel for a pair inside a sub-chunk; a pair (t, j) across
    sub-chunks factors through the last row e of j's sub-chunk,
    exp(cum_{t-1}[t] - cum[e]) * exp(cum[e] - cum[j]), one a (t, earlier
    sub-chunk, channel) and one a (j, channel); then r_dec and dec_end,
    one an element, and a_end, one a channel. FLOPs, a channel: 4 an
    inner pair (the difference, r * exp, * k, the sum), 2 a crossing pair
    (a dot product) and 2 a factor (its difference and scale); A v, 2 a
    pair and channel; r.u.k and its v term, cum - lw, r_dec, dec_end and
    k * dec_end, 9 an element; the (K, Q) x (Q, K) s_inj product. Bytes:
    each input read once, each output written once."""
    b, nc, q, h, kd = r.shape
    blocks, sub = b * nc * h, ref.SUB
    pairs = q * (q - 1) // 2
    sizes = [min(sub, q - i) for i in range(0, q, sub)]
    inner = sum(m * (m - 1) // 2 for m in sizes)
    t_side = sum(i * m for i, m in enumerate(sizes))
    products = blocks * (2 * pairs * kd + 2 * q * kd * kd)
    flops = blocks * (4 * inner * kd + 2 * (pairs - inner) * kd
                      + 2 * (t_side + q) * kd + 9 * q * kd) + products
    return _cost.KernelWork(
        flops=float(flops), products=float(products),
        transcendental=float(blocks * kd * (inner + t_side + 3 * q + 1)),
        bytes=4.0 * (blocks * (7 * q * kd + kd * kd + kd) + h * kd))


_cost.register_cost(_wkv6_op, wkv6_work)


class RankHeads:
    """Where each rank's share of a DTensor WKV6 lies: ``local(r, k, v,
    lw, u)`` gives the rank's rows of its heads as plain tensors (the
    batch over the mesh dimensions that shard it, H over those that
    shard the heads, everything else gathered), ``y`` and ``state``
    wrap the results back."""

    def __init__(self, r):
        from torch.distributed.tensor import Partial, Replicate, Shard
        self.mesh = r.device_mesh
        self.shape = tuple(r.shape)
        pl = [p if (p.is_shard(0) or p.is_shard(2)) else Replicate()
              for p in r.placements]
        hdims = [i for i, p in enumerate(pl) if p.is_shard(2)]
        if self.shape[2] % math.prod(self.mesh.size(d) for d in hdims):
            # uneven head shards: the heads are gathered instead
            pl = [Replicate() if p.is_shard(2) else p for p in pl]
        self.pl = tuple(pl)
        per = lambda row, head, other: tuple(
            row if p.is_shard(0) else head if p.is_shard(2) else other
            for p in pl)
        self.u_pl = per(Replicate(), Shard(0), Replicate())
        # u's gradient: each row shard's sum over its own batch rows
        self.u_grad = per(Partial(), Shard(0), Replicate())
        self.state_pl = per(Shard(0), Shard(1), Replicate())

    def local(self, r, k, v, lw, u):
        """The rank's r, k, v, lw (b_l, s, H_l, K) and u (H_l, K)."""
        out = [t.redistribute(self.mesh, self.pl).to_local(
            grad_placements=self.pl).contiguous() for t in (r, k, v, lw)]
        return out + [u.redistribute(self.mesh, self.u_pl).to_local(
            grad_placements=self.u_grad).contiguous()]

    def _wrap(self, t, pl, shape):
        from torch.distributed.tensor import DTensor
        # contiguous, as the global shape's strides say it is
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t.contiguous(), self.mesh, pl,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    def y(self, y):
        return self._wrap(y, self.pl, self.shape)

    def state(self, S):
        b, _, H, K = self.shape
        return self._wrap(S, self.state_pl, (b, H, K, K))


def wkv6_chunked(r, k, v, cum, lw, u, return_state: bool = False):
    """The full recurrence over chunked inputs (b, nc, Q, H, K): the
    kernel, then the inter-chunk combine. Returns y (b, nc, Q, H, K), or
    (y, S) with ``return_state``: S (b, H, K, K) after the last chunk."""
    return ref.chunk_combine(*wkv6_intra_chunk(r, k, v, cum, lw, u),
                             return_state=return_state)


def wkv6(r, k, v, lw, u, *, chunk: int = 128, return_state: bool = False,
         force_ref: bool = False, interpret: bool = False):
    """r, k, v, lw: (b, s, H, K) float32; u: (H, K) -> y (b, s, H, K)
    float32: S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T, y_t = r_t^T
    S_{t-1} + (r_t . u . k_t) v_t, through the kernel (the plain
    recurrence with ``force_ref``); (y, S_s) with ``return_state``."""
    if interpret:
        raise ValueError(INTERPRET)
    chunked = ref.wkv6_chunked if force_ref else wkv6_chunked
    return ref.wkv6_by_chunks(r, k, v, lw, u, chunk=chunk, chunked=chunked,
                              return_state=return_state)
