"""Plain PyTorch versions of the flash attention forward
(``repro.kernels.flash_attention.ref`` and the attention math of
``repro.models.attention``).

``attention_einsum`` is the quadratic masked softmax, ``ref_attention``
the oracle built on it, ``attention_blocked`` the online softmax over
KV blocks that the CUDA kernels compute (f32 inside, output in
``v.dtype``; with ``round_p=True`` the probabilities are rounded to
``v.dtype`` as the operand of P V, as the bfloat16 tensor-core kernel
rounds them), and ``expand_kv`` the GQA repeat the JAX package applies
before either. All take q (b, sq, h, hd) and k, v (b, skv, h, hd).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(b, s, kv, hd) -> (b, s, kv*groups, hd) by repeat (GQA share):
    expanded head j reads KV head j // groups."""
    if groups == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(
        b, s, kv * groups, hd)


def attention_mask(sq: int, skv: int, *, causal: bool, window: int = 0,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """(sq, skv) bool: which keys each query row sees."""
    iq = torch.arange(sq, device=device)[:, None] + q_offset
    ik = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (ik <= iq)
    if window > 0:
        mask = mask & (ik > iq - window)
    return mask


def attention_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor],
                     scale: float) -> torch.Tensor:
    """q: (b, sq, h, hd); k, v: (b, skv, h, hd); mask: (sq, skv) or None.
    The probabilities are cast to ``v.dtype`` before the product with v,
    as the JAX package casts them."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def ref_attention(q, k, v, *, scale, causal=True, window=0, q_offset=0):
    """The masked-einsum oracle of the flash kernel."""
    mask = attention_mask(q.shape[1], k.shape[1], causal=causal,
                          window=window, q_offset=q_offset, device=q.device)
    return attention_einsum(q, k, v, mask, scale)


def attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, *, causal: bool, window: int = 0,
                      q_offset: int = 0, q_block: int = 512,
                      kv_block: int = 512, round_p: bool = False,
                      return_lse: bool = False):
    """Online-softmax attention over KV blocks (flash-equivalent).

    Every (q block, kv block) pair is visited, masked keys score
    ``NEG_INF`` (finite, so a wholly masked block gives p = 1 that the
    next valid block's ``alpha = 0`` wipes out), and the sum is divided
    by ``max(l, 1e-30)``, as in the JAX package's ``attention_blocked``.
    ``round_p``: the probabilities enter P V rounded to ``v.dtype`` while
    ``l`` sums them in f32 (the bfloat16 kernel's arithmetic; at f32 the
    rounding is the identity). ``return_lse``: (out, lse), lse = m +
    log(max(l, 1e-30)) (b, h, sq) float32, each row's log-sum-exp of its
    scaled scores, what the JAX package's ``_flash_fwd`` returns beside
    ``out`` for its backward.
    """
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    nq = -(-sq // q_block)
    nk = -(-skv // kv_block)
    outs, lses = [], []
    for qi in range(nq):
        qblk = q[:, qi * q_block:(qi + 1) * q_block].float()
        rows = qblk.shape[1]
        qpos = q_offset + qi * q_block + torch.arange(rows, device=q.device)
        m = torch.full((b, h, rows), NEG_INF, device=q.device)
        l = torch.zeros((b, h, rows), device=q.device)
        acc = torch.zeros((b, h, rows, hd), device=q.device)
        for ki in range(nk):
            kblk = k[:, ki * kv_block:(ki + 1) * kv_block].float()
            vblk = v[:, ki * kv_block:(ki + 1) * kv_block].float()
            # the JAX version pads the last block with masked zero rows
            pad = kv_block - kblk.shape[1]
            if pad:
                kblk = torch.nn.functional.pad(kblk, (0, 0, 0, 0, 0, pad))
                vblk = torch.nn.functional.pad(vblk, (0, 0, 0, 0, 0, pad))
            s = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk) * scale
            kpos = ki * kv_block + torch.arange(kv_block, device=q.device)
            valid = kpos[None, :] < skv
            if causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                valid = valid & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(valid[None, None], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            if round_p:
                p = p.to(v.dtype).float()
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                        p, vblk)
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
        if return_lse:
            lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.cat(outs, dim=2)                      # (b, h, sq, hd)
    out = out.transpose(1, 2).to(v.dtype)
    return (out, torch.cat(lses, dim=2)) if return_lse else out
