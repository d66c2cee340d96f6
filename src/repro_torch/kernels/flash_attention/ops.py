"""Wrapper of the flash attention forward kernel
(``csrc/flash_attention.cu``).

``flash_attention_fwd`` launches the CUDA kernel for CUDA tensors (the
tensor-core kernel for bfloat16, the FP32 kernel for float32) and
computes the plain PyTorch version (``ref.attention_blocked`` over
GQA-expanded K/V, the JAX package's own non-TPU path) for CPU tensors;
it never falls back from one to the other. K and V may have fewer heads
than Q (GQA): query head ``j`` reads KV head ``j // (h // kv_heads)``,
which the kernel does in place of a copy. ``attention`` is the entry
the model's attention layer calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.flash_attention import ref

KERNEL = CudaKernel(
    "flash_attention", "flash_attention_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float])

# the arithmetic's revision, recorded beside every store this kernel
# writes: 2 is the bf16 kernel on the tensor cores
REVISION = 2
MAX_HEAD_DIM = 128          # the widest head the kernel is built for
MAX_GRID_Y = 65535          # blocks along a grid's y
BLOCK_Q = 64                # query rows of a block, both kernels


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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """q: (b, sq, h, hd); k, v: (b, skv, kv_heads, hd) -> (b, sq, h, hd)
    in ``q.dtype``: masked online softmax, f32 inside."""
    if not q.is_cuda:
        groups = q.shape[2] // k.shape[2]
        return ref.attention_blocked(
            q, ref.expand_kv(k, groups), ref.expand_kv(v, groups), scale,
            causal=causal, window=window, q_offset=q_offset)
    _check(q, k, v, window, q_offset)
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    KERNEL.launch(q.device, q, k, v, out, b, sq, k.shape[1], h, k.shape[2],
                  hd, int(causal), int(window), int(q_offset),
                  int(q.dtype == torch.bfloat16), float(scale))
    return out


def attention(q, k, v, *, scale, causal=True, window=0, q_offset=0):
    """The attention layer's entry (``repro.kernels.flash_attention.ops
    .attention``): the kernel on the card, the plain version on the
    CPU."""
    return flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                               window=window, q_offset=q_offset)
