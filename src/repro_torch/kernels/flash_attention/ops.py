"""Wrapper of the flash attention forward kernel
(``csrc/flash_attention.cu``).

``flash_attention_fwd`` launches the CUDA kernel for CUDA tensors (the
tensor-core kernel for bfloat16, the FP32 kernel for float32) and
computes the plain PyTorch version (``ref.attention_blocked`` over
GQA-expanded K/V, the JAX package's own non-TPU path) for CPU tensors;
it never falls back from one to the other. K and V may have fewer heads
than Q (GQA): query head ``j`` reads KV head ``j // (h // kv_heads)``,
which the kernel does in place of a copy. With ``return_lse`` it also
returns each row's log-sum-exp (b, h, sq) float32 (the kernels' LSE
instantiations on the card, ``attention_blocked(..., return_lse=True)``
on the CPU), the residual of the attention layer's autograd Function
(``models.attention.flash_attention``). ``attention`` is the entry the
model's attention layer calls when no gradient is wanted.

On meta tensors and under the cost counter (``launch.hlo_analysis``) a
call is one operator, ``repro_torch::flash_attention_fwd``
(``kernels._cost``): meta tensors get empty outputs, and the counter
charges the kernel's own work, ``flash_work``, on every device. A CUDA
call whose inputs require grad raises: the gradient goes through the
attention layer's autograd Function, whose forward runs with grad off.
``attention`` takes the JAX package's switches: ``force_ref=True``
computes the plain version on any device; ``interpret=True`` (Pallas
interpret mode) has no counterpart and raises.

On DTensors (SPMD ranks over a mesh, ``launch.mesh``) the sharding rule
is ``HeadShards``: each rank launches the kernel on its own query
heads, batch rows and the whole sequence, with the KV heads of its own
query groups. Query heads sharded over a model axis of n ways keep
their layout; K and V follow them when their heads split n ways too
(rank c's KV heads c kvh/n .. are then exactly its query groups', the
kernel's ``j / (h / kv_heads)`` read locally). When the KV heads do not
split (llama3-8b SMOKE's 4 query heads over 1 on 2 ranks), K and V are
replicated and each rank takes the KV heads of its own query heads:
one when its heads lie in one group, else one a query head; the
kernel's in-place grouping would otherwise pair a rank's query heads
with the wrong KV heads. Every other placement (sequence or head_dim
sharded, partial sums) is redistributed to that layout first. Both the
no-grad entry (``flash_attention_fwd``) and the attention layer's
autograd Function (``models.attention.flash_attention``, whose
backward scatters a replicated K's gradient back to its heads as a
partial sum) take it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import INTERPRET, _cost
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.flash_attention import ref

KERNEL = CudaKernel(
    "flash_attention", "flash_attention_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float])

# the arithmetic's revision, recorded beside every store this kernel
# writes: 2 is the bf16 kernel on the tensor cores
REVISION = 2
# the widest head the kernels are built for (their widest
# instantiation; gemma3-12b's head is 240, an instantiation of its own)
MAX_HEAD_DIM = 256
MAX_GRID_Y = 65535          # blocks along a grid's y
BLOCK_Q = 64                # query rows of a block, both kernels


def bf16_tile_keys(hd: int) -> int:
    """Keys of the bf16 kernel's K/V tiles at head width ``hd``: 64, or
    32 past 128 (the tiles its plain version is compared on)."""
    return 64 if hd <= 128 else 32


def _check(q, k, v, window: int, q_offset: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (b, s, heads, head_dim), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel copies whole 16-byte rows of 8 values
        if hd % 8:
            raise ValueError(f"bfloat16 head_dim {hd} is not a multiple "
                             f"of 8")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("bfloat16 q, k and v must be 16-byte aligned")
    # the FP32 kernel puts batch * heads on the grid's y, the bf16 kernel
    # its Q tiles
    if q.dtype == torch.float32 and b * h > MAX_GRID_Y:
        raise ValueError(f"batch * heads = {b * h} > {MAX_GRID_Y}")
    if q.dtype == torch.bfloat16 and -(-sq // BLOCK_Q) > MAX_GRID_Y:
        raise ValueError(f"{-(-sq // BLOCK_Q)} query tiles > {MAX_GRID_Y}")
    if window < 0 or q_offset < 0:
        raise ValueError("window and q_offset must be >= 0")
    skv = k.shape[1]
    # the kernel skips KV tiles no row of a Q tile sees; a row that sees
    # no key at all would then be zeros, where the plain version
    # averages V, so such inputs are refused
    if window > 0 and q_offset + sq - 1 >= skv - 1 + window:
        raise ValueError(f"with window={window} and q_offset={q_offset} "
                         f"the last query rows see none of the {skv} keys")


def _plain(q, k, v, scale, causal, window, q_offset, return_lse,
           q_block=512, kv_block=512):
    groups = q.shape[2] // k.shape[2]
    return ref.attention_blocked(
        q, ref.expand_kv(k, groups), ref.expand_kv(v, groups), scale,
        causal=causal, window=window, q_offset=q_offset, q_block=q_block,
        kv_block=kv_block, return_lse=return_lse)


class HeadShards:
    """Where each rank's share of a DTensor attention lies (see the
    module's docstring): ``local(q, k, v)`` gives the rank's q, k and v
    as plain tensors, ``out``/``lse`` wrap its results, ``grads`` its
    dq, dk, dv."""

    def __init__(self, q, k):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh = q.device_mesh
        h, kvh = q.shape[2], k.shape[2]
        self.q_pl = [p if (p.is_shard(0) or p.is_shard(2)) else Replicate()
                     for p in q.placements]
        hdims = [i for i, p in enumerate(self.q_pl) if p.is_shard(2)]
        ways = math.prod(self.mesh.size(d) for d in hdims)
        if h % ways:
            # uneven head shards: the query heads are gathered instead
            self.q_pl = [Replicate() if p.is_shard(2) else p
                         for p in self.q_pl]
            hdims, ways = [], 1
        self.kv_split = kvh % ways == 0
        self.kv_pl = (list(self.q_pl) if self.kv_split else
                      [Replicate() if p.is_shard(2) else p
                       for p in self.q_pl])
        self.kv_index = None
        if not self.kv_split:
            from repro_torch.sharding.rules import block_index
            hl, groups = h // ways, h // kvh
            c = block_index(self.mesh, hdims)
            heads = (c * hl + torch.arange(hl)) // groups
            # one KV head when the rank's heads lie in one group
            self.kv_index = heads[:1] if groups % hl == 0 else heads
        self.lse_pl = [Shard(1) if p.is_shard(2) else p for p in self.q_pl]
        self.kvh = kvh

    def local(self, q, k, v):
        ql = q.redistribute(self.mesh, self.q_pl).to_local().contiguous()
        kl, vl = (t.redistribute(self.mesh, self.kv_pl).to_local()
                  for t in (k, v))
        if self.kv_index is not None:
            idx = self.kv_index.to(kl.device)
            kl, vl = (t.index_select(2, idx) for t in (kl, vl))
        return ql, kl.contiguous(), vl.contiguous()

    def out(self, out, lse=None):
        from torch.distributed.tensor import DTensor
        o = DTensor.from_local(out, self.mesh, self.q_pl, run_check=False)
        if lse is None:
            return o
        return o, DTensor.from_local(lse, self.mesh, self.lse_pl,
                                     run_check=False)

    def dout(self, g):
        return g.redistribute(self.mesh, self.q_pl).to_local().contiguous()

    def grads(self, dq, dk, dv):
        """DTensors of the full q, k and v's gradients: a replicated
        K's (and V's) a partial sum of each rank's heads."""
        from torch.distributed.tensor import DTensor, Partial
        wrap = lambda t, pl: DTensor.from_local(t, self.mesh, pl,
                                                run_check=False)
        if self.kv_index is None:
            return (wrap(dq, self.q_pl), wrap(dk, self.kv_pl),
                    wrap(dv, self.kv_pl))
        idx = self.kv_index.to(dk.device)
        partial = [Partial() if p.is_shard(2) else p for p in self.q_pl]

        def full(t):
            z = torch.zeros(t.shape[:2] + (self.kvh,) + t.shape[3:],
                            dtype=t.dtype, device=t.device)
            return wrap(z.index_add_(2, idx, t), partial)
        return wrap(dq, self.q_pl), full(dk), full(dv)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        return_lse: bool = False, q_block: int = 512,
                        kv_block: int = 512):
    """q: (b, sq, h, hd); k, v: (b, skv, kv_heads, hd) -> (b, sq, h, hd)
    in ``q.dtype``: masked online softmax, f32 inside; with
    ``return_lse``, (out, lse (b, h, sq) float32). ``q_block`` and
    ``kv_block`` are the plain version's tiles (the kernel's are its
    own). DTensors go through ``HeadShards``: the kernel on each rank's
    heads."""
    if _is_dtensor(q):
        shards = HeadShards(q, k)
        res = flash_attention_fwd(*shards.local(q, k, v), scale=scale,
                                  causal=causal, window=window,
                                  q_offset=q_offset, return_lse=return_lse,
                                  q_block=q_block, kv_block=kv_block)
        return shards.out(*res) if return_lse else shards.out(res)
    if _cost.plain_for_grad(
            "flash_attention_fwd", q, k, v,
            hint="; train through models.attention.flash_attention"):
        return _plain(q, k, v, scale, causal, window, q_offset, return_lse,
                      q_block, kv_block)
    run = _flash_op if _cost.through_op(q) else _flash_run
    out, lse = run(q, k, v, float(scale), bool(causal), int(window),
                   int(q_offset), bool(return_lse), int(q_block),
                   int(kv_block))
    return (out, lse) if return_lse else out


def _flash_run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, causal: bool, window: int, q_offset: int,
               return_lse: bool, q_block: int, kv_block: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): lse is (0,) without ``return_lse``. Both are
    contiguous, as the kernel writes them, so what runs after the call is
    the same on every device."""
    if not q.is_cuda:
        res = _plain(q, k, v, scale, causal, window, q_offset, return_lse,
                     q_block, kv_block)
        out, lse = res if return_lse else (res, _no_lse(q))
        return out.contiguous(), lse.contiguous()
    _check(q, k, v, window, q_offset)
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        KERNEL.launch(q.device, q, k, v, out, lse, b, sq, k.shape[1], h,
                      k.shape[2], hd, int(causal), int(window),
                      int(q_offset), int(q.dtype == torch.bfloat16),
                      float(scale))
    return out, (lse if return_lse else _no_lse(q))


def _no_lse(q):
    return torch.empty((0,), dtype=torch.float32, device=q.device)


_flash_op = torch.library.custom_op("repro_torch::flash_attention_fwd",
                                    _flash_run, mutates_args=())


@_flash_op.register_fake
def _(q, k, v, scale, causal, window, q_offset, return_lse, q_block,
      kv_block):
    b, sq, h, _ = q.shape
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else _no_lse(q))
    return torch.empty_like(q), lse


def key_tile(hd: int, dtype: torch.dtype) -> int:
    """Keys of a K/V tile of the kernel that takes ``dtype``."""
    return bf16_tile_keys(hd) if dtype == torch.bfloat16 else BLOCK_Q


def visited_pairs(sq: int, skv: int, *, causal: bool, window: int,
                  q_offset: int, tile: int) -> int:
    """(query, key) pairs a (batch, head) computes: each 64-row query
    tile runs every key of the K/V tiles that hold a key one of its rows
    sees (the tiles wholly masked are skipped, as the kernel does)."""
    q0 = np.arange(0, sq, BLOCK_Q, dtype=np.int64)
    nq = np.minimum(BLOCK_Q, sq - q0)
    p_lo, p_hi = q_offset + q0, q_offset + q0 + nq - 1
    kv_hi = np.minimum(skv, p_hi + 1) if causal else np.full_like(q0, skv)
    kv_lo = (np.maximum(0, p_lo - window + 1) if window > 0
             else np.zeros_like(q0))
    t_lo, t_hi = kv_lo // tile, -(-kv_hi // tile)
    keys = np.where(t_lo < t_hi,
                    np.minimum(t_hi * tile, skv) - t_lo * tile, 0)
    return int((nq * keys).sum())


def flash_work(q, k, v, scale, causal, window, q_offset, return_lse,
               q_block=512, kv_block=512) -> _cost.KernelWork:
    """The kernel's work: 4 hd FLOP (Q K^T and P V) and one exponential a
    visited pair; Q, K and V read once, out (and lse) written once."""
    b, sq, h, hd = q.shape
    pairs = b * h * visited_pairs(sq, k.shape[1], causal=causal,
                                  window=window, q_offset=q_offset,
                                  tile=key_tile(hd, q.dtype))
    products = 4.0 * hd * pairs
    lse = 4.0 * b * h * sq if return_lse else 0.0
    return _cost.KernelWork(
        flops=products + pairs, products=products, transcendental=pairs,
        bytes=2 * _cost.nbytes(q) + _cost.nbytes(k, v) + lse)


_cost.register_cost(_flash_op, flash_work)


def attention(q, k, v, *, scale, causal=True, window=0, q_offset=0,
              force_ref: bool = False, interpret: bool = False):
    """The attention layer's entry (``repro.kernels.flash_attention.ops
    .attention``): the kernel on the card, the plain version on the CPU
    or with ``force_ref``."""
    if interpret:
        raise ValueError(INTERPRET)
    if force_ref:
        return _plain(q, k, v, scale, causal, window, q_offset, False)
    return flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                               window=window, q_offset=q_offset)
