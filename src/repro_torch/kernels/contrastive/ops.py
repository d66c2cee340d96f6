"""Wrappers of the contrastive kernel (``csrc/contrastive.cu``).

``contrastive_losses`` launches the CUDA kernel for CUDA tensors and
computes the plain PyTorch version (``ref.ref_losses``) for CPU tensors;
it never falls back from one to the other. ``phase2_loss`` is the
trainable entry the proxy trainer puts on its hot path: an
``autograd.Function`` whose forward value is the kernel's and whose
backward replays the plain objective under autograd (the batch is
small, so recomputing beats plumbing residuals out of the kernel),
returning no gradient for the labels, as the JAX package's custom_vjp
does (``repro/kernels/contrastive/ops.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.contrastive import ref

MAX_N = 512      # the Pallas kernel's limits, kept by the CUDA kernel
MAX_P = 256

KERNEL = CudaKernel(
    "contrastive", "contrastive_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2)


def _check(z_q, z_d, y):
    if z_d.dim() != 3 or z_q.dim() != 2 or y.dim() != 2:
        raise ValueError("contrastive kernel takes z_q (Q, p), z_d (Q, n, p),"
                         f" y (Q, n); got {tuple(z_q.shape)}, "
                         f"{tuple(z_d.shape)}, {tuple(y.shape)}")
    q, n, p = z_d.shape
    if z_q.shape != (q, p) or y.shape != (q, n):
        raise ValueError(f"shape mismatch: z_q {tuple(z_q.shape)}, z_d "
                         f"{tuple(z_d.shape)}, y {tuple(y.shape)}")
    if not (1 <= n <= MAX_N and 1 <= p <= MAX_P):
        raise ValueError(f"contrastive kernel takes n <= {MAX_N}, "
                         f"p <= {MAX_P}; got n={n}, p={p}")
    for name, t in (("z_q", z_q), ("z_d", z_d), ("y", y)):
        if t.device != z_d.device:
            raise ValueError(f"{name} is on {t.device}, z_d on {z_d.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def contrastive_losses(z_q: torch.Tensor, z_d: torch.Tensor,
                       y: torch.Tensor, tau: float,
                       lam: float) -> torch.Tensor:
    """z_q (Q, p), z_d (Q, n, p), y (Q, n) float {0,1} -> (Q, 4) float32
    [qsim, supcon, polar, lam * supcon + (1 - lam) * polar]; unbatched
    (p,), (n, p), (n,) -> (4,)."""
    if z_d.dim() == 2:
        return contrastive_losses(z_q[None], z_d[None], y[None], tau,
                                  lam)[0]
    if not z_d.is_cuda:
        return ref.ref_losses(z_q, z_d, y, tau, lam)
    _check(z_q, z_d, y)
    q, n, p = z_d.shape
    out = torch.empty((q, 4), dtype=torch.float32, device=z_d.device)
    # the partials the rows kernel hands the finish kernel, laid out in
    # csrc/contrastive.cu
    part = torch.empty((q, 2 * n + 4), dtype=torch.float32,
                       device=z_d.device)
    KERNEL.launch(z_d.device, z_q, z_d, y, part, out, q, n, p,
                  float(tau), float(lam))
    return out


class _Phase2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z_q, z_d, y, tau, lam):
        ctx.save_for_backward(z_q, z_d, y)
        ctx.tau, ctx.lam = tau, lam
        return contrastive_losses(z_q.detach().contiguous(),
                                  z_d.detach().contiguous(),
                                  y.detach().float().contiguous(),
                                  tau, lam)[..., 3]

    @staticmethod
    def backward(ctx, g):
        z_q, z_d, y = ctx.saved_tensors
        with torch.enable_grad():
            zq = z_q.detach().requires_grad_(True)
            zd = z_d.detach().requires_grad_(True)
            val = ref.ref_phase2(zq, zd, y, ctx.tau, ctx.lam)
            # z_q only picks the bellwether rows (an argmin/argmax), so
            # the objective's gradient w.r.t. it is zero
            gq, gd = torch.autograd.grad(val, (zq, zd), g, allow_unused=True)
        if gq is None:
            gq = torch.zeros_like(z_q)
        return gq, gd, None, None, None


def phase2_loss(z_q, z_d, y, tau: float, lam: float) -> torch.Tensor:
    """lam * L_supcon + (1 - lam) * L_polar per lane, differentiable
    w.r.t. the latents; the forward value comes from the kernel on the
    card and from the plain version on the CPU."""
    return _Phase2.apply(z_q, z_d, y, tau, lam)
