"""Plain PyTorch version of the contrastive kernel: the training path's
losses (``repro_torch.core.losses``), per lane."""
from __future__ import annotations

import torch

from repro_torch.core import losses


def ref_losses(z_q, z_d, y, tau, lam) -> torch.Tensor:
    """(..., 4) = [qsim, supcon, polar, lam * supcon + (1 - lam) * polar]."""
    qsim = losses.qsim_loss(z_q, z_d, y, tau)
    supcon = losses.supcon_loss(z_d, y, tau)
    polar = losses.polar_loss(z_q, z_d, y, tau)
    return torch.stack([qsim, supcon, polar,
                        lam * supcon + (1 - lam) * polar], dim=-1)


def ref_phase2(z_q, z_d, y, tau, lam) -> torch.Tensor:
    """The phase-2 objective alone (what the trainer differentiates)."""
    return losses.phase2_loss(z_q, z_d, y, tau, lam)
