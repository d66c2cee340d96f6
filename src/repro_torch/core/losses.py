"""ScaleDoc's three contrastive objectives (paper §3.2, Fig. 3).

All losses operate on projected latents, L2-normalized here:
  z_q : (..., p)     query anchor
  z_d : (..., n, p)  documents in the mini-batch
  y   : (..., n)     binary labels (1 = positive)
Leading axes are independent lanes (``train_proxy_multi`` trains Q
proxies at once); each returns one value per lane.

  L_qsim   (eq. 1): InfoNCE with the query as anchor.
  L_supcon (eq. 2): supervised contrastive, intra-class clustering.
  L_polar  (eq. 3): bellwether polarization around the weakest positive
           and the hardest negative (first index on a tie, as
           ``jnp.argmin``/``jnp.argmax`` and ``torch.argmin`` take it).

Degenerate batches (no positives / no negatives) contribute 0 to the
affected terms (guarded with a masked logsumexp whose empty value is
``NEG``, then a select).
"""
from __future__ import annotations

import torch

from repro_torch.core.encoder import l2_normalize

NEG = -1e30


def _masked_lse(logits: torch.Tensor, mask: torch.Tensor,
                dim: int = -1) -> torch.Tensor:
    """log sum_{i in mask} exp(logits_i); NEG (not -inf) if mask empty."""
    return torch.logsumexp(torch.where(mask, logits, NEG), dim=dim)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., n, p) x (..., p) -> (..., n)."""
    return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1)


def qsim_loss(z_q: torch.Tensor, z_d: torch.Tensor, y: torch.Tensor,
              tau: float, variant: str = "perpos") -> torch.Tensor:
    """Eq. (1). ``variant="perpos"``: mean over positives of
    ``-log(e^{sim_i/tau} / sum_all e^{sim/tau})`` (the DPR form);
    ``"sum"``: the literal eq. (1) with the positive sum inside the log."""
    zq = l2_normalize(z_q)
    zd = l2_normalize(z_d)
    sims = _matvec(zd, zq) / tau                        # (..., n)
    pos = y > 0.5
    any_pos = pos.any(-1)
    lse_all = torch.logsumexp(sims, dim=-1)
    if variant == "sum":
        loss = -(_masked_lse(sims, pos) - lse_all)
    else:
        per = -(sims - lse_all.unsqueeze(-1))
        loss = (torch.where(pos, per, 0.0).sum(-1)
                / torch.clamp(pos.sum(-1), min=1))
    return torch.where(any_pos, loss, 0.0)


def supcon_loss(z_d: torch.Tensor, y: torch.Tensor,
                tau: float) -> torch.Tensor:
    """Eq. (2): for each anchor i,
    -1/|U(i)| log( sum_{p in U(i)} e^{sim_ip/tau} / sum_{k in A(i)} ... )."""
    n = z_d.shape[-2]
    zd = l2_normalize(z_d)
    sims = zd @ zd.transpose(-1, -2) / tau              # (..., n, n)
    eye = torch.eye(n, dtype=torch.bool, device=z_d.device)
    pos = y > 0.5
    same = pos.unsqueeze(-1) == pos.unsqueeze(-2)
    u_mask = same & ~eye                                 # U(i)
    a_mask = (~eye).expand_as(sims)                      # A(i)
    u_count = u_mask.sum(-1)
    lse_u = _masked_lse(sims, u_mask)
    lse_a = _masked_lse(sims, a_mask)
    per_anchor = -(lse_u - lse_a) / torch.clamp(u_count, min=1)
    valid = u_count > 0
    return (torch.where(valid, per_anchor, 0.0).sum(-1)
            / torch.clamp(valid.sum(-1), min=1))


def polar_loss(z_q: torch.Tensor, z_d: torch.Tensor, y: torch.Tensor,
               tau: float) -> torch.Tensor:
    """Eq. (3): bellwether-anchored bipolarization."""
    zq = l2_normalize(z_q)
    zd = l2_normalize(z_d)
    sim_q = _matvec(zd, zq)                              # (..., n)
    pos = y > 0.5
    neg = ~pos
    # bellwethers: weakest positive / hardest negative w.r.t. the query
    i_pos = torch.argmin(torch.where(pos, sim_q, float("inf")), dim=-1)
    i_neg = torch.argmax(torch.where(neg, sim_q, float("-inf")), dim=-1)
    z_bp = torch.take_along_dim(zd, i_pos[..., None, None], dim=-2)
    z_bn = torch.take_along_dim(zd, i_neg[..., None, None], dim=-2)
    sims_bp = _matvec(zd, z_bp.squeeze(-2)) / tau
    sims_bn = _matvec(zd, z_bn.squeeze(-2)) / tau
    loss_p = -(_masked_lse(sims_bp, pos) - torch.logsumexp(sims_bp, -1))
    loss_n = -(_masked_lse(sims_bn, neg) - torch.logsumexp(sims_bn, -1))
    return (torch.where(pos.any(-1), loss_p, 0.0)
            + torch.where(neg.any(-1), loss_n, 0.0))


def phase1_loss(z_q, z_d, y, tau, variant: str = "perpos"):
    return qsim_loss(z_q, z_d, y, tau, variant)


def phase2_loss(z_q, z_d, y, tau, lam):
    """L2 = lam * L_supcon + (1 - lam) * L_polar (paper §5, lam=0.2)."""
    return (lam * supcon_loss(z_d, y, tau)
            + (1.0 - lam) * polar_loss(z_q, z_d, y, tau))
