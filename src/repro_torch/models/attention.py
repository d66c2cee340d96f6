"""GQA attention: full-sequence prefill and cached decode
(``repro.models.attention``).

Three execution strategies for the full sequence, as in the JAX package:
  * ``flash``   — the default: ``kernels.flash_attention.ops.attention``,
    the hand-written CUDA kernel on the card (its plain version on the
    CPU), reading the shared KV head of each query head in place;
  * ``blocked`` — the plain online softmax over KV blocks;
  * ``einsum``  — the plain quadratic masked softmax.
The two plain strategies take K/V expanded to one head per query head.

Decode reads a KV cache: a full cache (one slot a position) for global
layers, a ring of ``window`` slots for sliding-window layers. Decode
attention is plain PyTorch, as in the JAX package, where it lies outside
any Pallas kernel: f32 scores and softmax, masked by a select with
``NEG_INF``. ``use_rope=False`` leaves Q and K unrotated (the
encoder-decoder models add sinusoidal positions to their inputs).

On a mesh of SPMD ranks the cache is a DTensor (``launch.steps``' decode
plan places it by its ``kv_seq`` rule: the sequence over "data" when the
batch cannot fill that axis, over "model" when the KV heads cannot split
it), and decode runs on each rank's shard, as GSPMD partitions the JAX
step; DTensor's own rules would gather the cache (or, for ``index_copy``
and ``roll`` on the card's torch, have none: ``tools/gloo_probe.py
--ops``). ``prefill_kv_cache`` fills each rank's batch rows and KV heads;
the new token's K/V go to slot ``min(pos, L - 1)`` (``pos % L`` for a
ring) on the rank whose sequence range holds it, a select on the clamped
local slot, with ``pos`` kept on the device; a head-sharded or
replicated cache attends over the rank's own heads; a sequence-sharded
one gives each rank the scores of its slots (global slot indices in the
mask), combined across the shards by ``softmax_over_shards``: two
all-reduces of (b, heads) rows, never the cache or the scores.

Cross-attention (``cross_attn_{init, apply, decode}``, ``encode_kv``)
reads K/V projected once from the encoder's output, with no RoPE and no
mask. Its full-sequence form always goes through the flash entry,
non-causal, whatever the model's ``attn_impl``, as in the JAX package;
its decode form is plain f32 scores and softmax. ``attn_axes`` is the
projections' logical-axes table (``sharding.rules``); a cross-attention
block has the same.

The flash entry is ``flash_attention``, the port of the JAX package's
custom VJP (``_make_flash``): with no gradient wanted it is the plain
kernel call (``flash_ops.attention``); with one, a
``torch.autograd.Function`` whose forward is the kernel with its
log-sum-exp output on the card (the plain online softmax over blocks
of ``q_block`` x ``kv_block`` on the CPU) and keeps q, the unexpanded
k and v, out and lse, and whose backward (``flash_backward``) is the
JAX package's: P = exp(s - lse) recomputed per (q block, kv block) in
float32, delta = rowsum(dO * O), dK and dV for each KV head summed
over its query group. The JAX backward is XLA, not a Pallas kernel, so
the backward here is plain PyTorch too.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     attention_blocked,
                                                     attention_einsum,
                                                     attention_mask)
from repro_torch.kernels.flash_attention.ref import expand_kv as _expand_kv
from repro_torch.models.common import Params, apply_rope, dense_init
from repro_torch.sharding.rules import local_range

IMPLS = ("flash", "blocked", "einsum")


def attn_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(generator, d, (nq, hd), dtype),
        "wk": dense_init(generator, d, (nkv, hd), dtype),
        "wv": dense_init(generator, d, (nkv, hd), dtype),
        "wo": dense_init(generator, nq * hd, (d,), dtype).reshape(nq, hd, d),
    }


def attn_axes(cfg: ModelConfig) -> Params:
    return {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }


def cross_attn_init(generator: torch.Generator, cfg: ModelConfig,
                    dtype) -> Params:
    """The same four weights as ``attn_init``."""
    return attn_init(generator, cfg, dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).reshape(
        b, s, w.shape[1], w.shape[2])


# -- flash attention with its gradient ------------------------------------------

def _tile_valid(qpos: torch.Tensor, kpos: torch.Tensor, skv: int,
                causal: bool, window: int) -> torch.Tensor:
    """(rows, cols) bool: which keys each query row of a tile sees
    (``_tile_mask`` of the JAX package)."""
    valid = (kpos[None, :] < skv).expand(qpos.shape[0], -1)
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    return valid


def flash_backward(q, k, v, out, lse, dout, scale: float, *, causal: bool,
                   window: int = 0, q_offset: int = 0, q_block: int = 512,
                   kv_block: int = 512):
    """The gradient of ``flash_attention`` (the JAX package's ``bwd`` of
    ``_make_flash``), in plain PyTorch. q, dout, out (b, sq, h, hd); k, v
    (b, skv, kv_heads, hd), unexpanded; lse (b, h, sq) float32. For each
    (q block, kv block) tile it recomputes s in float32, masks it as the
    forward did, takes P = exp(s - lse), and adds P^T dO to dV, dS^T Q to
    dK and dS K to dQ, dS = P (dO V^T - delta) scale, delta = rowsum(dO
    O); query head j's share goes to KV head j // (h / kv_heads). Tiles
    that no row of the q block sees are skipped: every P there is 0
    (exp(-1e30 - lse)), so skipping them changes no sum. Returns (dq, dk,
    dv) in the types of q, k and v."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qb, kb = min(q_block, sq), min(kv_block, skv)
    f32 = torch.float32
    dev = q.device
    dout = dout.float()
    delta = torch.einsum("bqhd,bqhd->bhq", dout, out.float())
    q5 = q.reshape(b, sq, kvh, g, hd)
    do5 = dout.reshape(b, sq, kvh, g, hd)
    lse4 = lse.reshape(b, kvh, g, sq)
    dt4 = delta.reshape(b, kvh, g, sq)
    dq = torch.zeros((b, sq, kvh, g, hd), dtype=f32, device=dev)
    dk = torch.zeros((b, skv, kvh, hd), dtype=f32, device=dev)
    dv = torch.zeros((b, skv, kvh, hd), dtype=f32, device=dev)
    for q0 in range(0, sq, qb):
        rows = min(qb, sq - q0)
        p_lo, p_hi = q_offset + q0, q_offset + q0 + rows - 1
        qblk = q5[:, q0:q0 + rows].float()
        doblk = do5[:, q0:q0 + rows]
        lseblk = lse4[..., q0:q0 + rows, None]
        dtblk = dt4[..., q0:q0 + rows, None]
        qpos = p_lo + torch.arange(rows, device=dev)
        for k0 in range(0, skv, kb):
            cols = min(kb, skv - k0)
            if causal and k0 > p_hi:
                break
            if window > 0 and k0 + cols - 1 <= p_lo - window:
                continue
            kblk = k[:, k0:k0 + cols].float()
            vblk = v[:, k0:k0 + cols].float()
            s = torch.einsum("bqkgd,bjkd->bkgqj", qblk, kblk) * scale
            valid = _tile_valid(qpos, k0 + torch.arange(cols, device=dev),
                                skv, causal, window)
            s = torch.where(valid, s, torch.full_like(s, NEG_INF))
            p = torch.exp(s - lseblk)                      # (b,kv,g,qb,kb)
            dv[:, k0:k0 + cols] += torch.einsum("bkgqj,bqkgd->bjkd", p,
                                                doblk)
            dp = torch.einsum("bqkgd,bjkd->bkgqj", doblk, vblk)
            ds = p * (dp - dtblk) * scale
            dq[:, q0:q0 + rows] += torch.einsum("bkgqj,bjkd->bqkgd", ds,
                                                kblk)
            dk[:, k0:k0 + cols] += torch.einsum("bkgqj,bqkgd->bjkd", ds,
                                                qblk)
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel with its LSE (card) or the plain blocked online
    softmax over ``q_block`` x ``kv_block`` tiles (CPU), one
    ``flash_ops.flash_attention_fwd`` call either way; backward:
    ``flash_backward``. On DTensors both run on each rank's heads
    (``flash_ops.HeadShards``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, q_offset, q_block,
                kv_block):
        shards = None
        if isinstance(q, DTensor):
            shards = flash_ops.HeadShards(q, k)
            q, k, v = shards.local(q, k, v)
        out, lse = flash_ops.flash_attention_fwd(
            q, k, v, scale=scale, causal=causal, window=window,
            q_offset=q_offset, return_lse=True, q_block=q_block,
            kv_block=kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        q_block=q_block, kv_block=kv_block)
        ctx.scale = scale
        ctx.shards = shards
        return out if shards is None else shards.out(out)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        shards = ctx.shards
        if shards is not None:
            dout = shards.dout(dout)
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.scale,
                                    **ctx.opts)
        if shards is not None:
            dq, dk, dv = shards.grads(dq, dk, dv)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, *, causal: bool, window: int = 0,
                    q_offset: int = 0, q_block: int = 512,
                    kv_block: int = 512,
                    causal_skip: bool = False) -> torch.Tensor:
    """Memory-efficient attention with recompute in the backward, GQA
    residuals unexpanded (``repro.models.attention.flash_attention``).
    q: (b, sq, h, hd); k, v: (b, skv, kv_heads, hd) -> (b, sq, h, hd) in
    v's type. Without a gradient to take (grad mode off, or no input
    requiring one) it is ``flash_ops.attention``, the kernel on the card
    and its plain version on the CPU; with one, ``_FlashAttention``.
    ``q_block`` and ``kv_block`` set the backward's tiles and, on the CPU,
    the forward's. ``causal_skip`` (the JAX package's switch to skip the
    masked tiles) is accepted and changes nothing: the kernel skips them
    itself."""
    del causal_skip
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return flash_ops.attention(q, k, v, scale=scale, causal=causal,
                                   window=window, q_offset=q_offset)
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 int(window), int(q_offset), int(q_block),
                                 int(kv_block))


def attn_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, causal: bool = True,
               window: int = 0, impl: str = "flash", kv_out: bool = False,
               causal_skip: bool = False, use_rope: bool = True
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence attention, with RoPE unless ``use_rope`` is False.
    x: (b, s, d) -> (y (b, s, d), kv or None), as the JAX package returns
    it: with ``kv_out`` kv is {"k": K (after RoPE), "v": V}, both
    unexpanded (b, s, kv_heads, head_dim), for a KV cache.
    ``causal_skip`` is accepted and changes nothing (``flash_attention``;
    the plain paths compute every tile)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    b, s, d = x.shape
    groups = cfg.num_heads // cfg.num_kv_heads
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    if impl == "flash":
        out = flash_attention(q, k, v, scale, causal=causal, window=window,
                              causal_skip=causal_skip)
    elif impl == "einsum":
        mask = attention_mask(s, s, causal=causal, window=window,
                              device=x.device)
        out = attention_einsum(q, _expand_kv(k, groups),
                               _expand_kv(v, groups), mask, scale)
    else:
        out = attention_blocked(q, _expand_kv(k, groups),
                                _expand_kv(v, groups), scale, causal=causal,
                                window=window)
    y = _out_proj(out, params["wo"])
    return y, ({"k": k, "v": v} if kv_out else None)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    b, s = out.shape[:2]
    return (out.reshape(b * s, -1) @ wo.reshape(-1, wo.shape[-1])).reshape(
        b, s, -1)


def cross_attn_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     kv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cross-attention of x (b, s, d) over ``encode_kv``'s K/V (b, skv,
    kv_heads, head_dim): the flash entry, non-causal (the kernel on the
    card whatever the model's ``attn_impl``, as in the JAX package)."""
    q = _project(x, params["wq"])
    out = flash_attention(q, kv["k"], kv["v"], 1.0 / (cfg.head_dim ** 0.5),
                          causal=False)
    return _out_proj(out, params["wo"])


def encode_kv(params: Params, x_enc: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """The encoder output (b, skv, d) projected to cross-attention K/V,
    unexpanded (b, skv, kv_heads, head_dim): once a layer, then cached."""
    return {"k": _project(x_enc, params["wk"]),
            "v": _project(x_enc, params["wv"])}


# -- KV caches and decode ------------------------------------------------------

CACHE_AXES = ("batch", "kv_seq", "act_kv_heads", "head_dim")


def kv_cache_spec(cfg: ModelConfig, batch: int, seq_len: int, window: int,
                  dtype) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """One attention layer's cache as (meta tensors of its shape and type,
    logical axes): (batch, L, kv_heads, head_dim) for k and v, L =
    ``seq_len`` for a full cache, ``min(window, seq_len)`` for a ring."""
    length = min(window, seq_len) if window > 0 else seq_len
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    meta = lambda: torch.empty(shape, dtype=dtype, device="meta")
    return {"k": meta(), "v": meta()}, {"k": CACHE_AXES, "v": CACHE_AXES}


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, window: int,
                  dtype, device) -> Dict[str, torch.Tensor]:
    """An empty (zero) cache of ``kv_cache_spec``'s shape on ``device``."""
    spec, _ = kv_cache_spec(cfg, batch, seq_len, window, dtype)
    return {n: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for n, t in spec.items()}


def fill_kv_cache(cache: Dict[str, torch.Tensor], kv: Dict[str, torch.Tensor],
                  window: int) -> Dict[str, torch.Tensor]:
    """Prefill K/V (b, s, kv, hd) written into a copy of ``cache``: at
    slots 0..s-1, or for a ring (window > 0) shorter than the prompt the
    last ``window`` rows rolled by ``start % window`` (start = s -
    window), so that slot ``p % window`` holds position p."""
    s = kv["k"].shape[1]
    out = {}
    for n in ("k", "v"):
        rows = kv[n]
        if window > 0 and s > window:
            start = s - window
            rows = torch.roll(rows[:, start:], shifts=start % window, dims=1)
        c = cache[n].clone()
        c[:, :rows.shape[1]] = rows
        out[n] = c
    return out


def prefill_kv_cache(cfg: ModelConfig, kv: Dict[str, torch.Tensor],
                     seq_len: int, window: int) -> Dict[str, torch.Tensor]:
    """An attention layer's decode cache of ``seq_len`` positions
    (``kv_cache_spec``) holding a prefill's K/V (``fill_kv_cache``).
    DTensor K/V (a prefill on a mesh, its sequence whole on every rank)
    give a DTensor cache of their placements with the sequence whole
    (where DTensor's rules left K/V split over the sequence or as
    partial sums, as they may inside a pattern group, they are brought
    together first): each rank fills its own batch rows and KV heads."""
    if not isinstance(kv["k"], DTensor):
        empty = init_kv_cache(cfg, kv["k"].shape[0], seq_len, window,
                              kv["k"].dtype, kv["k"].device)
        return fill_kv_cache(empty, kv, window)
    mesh = kv["k"].device_mesh
    pl = [Replicate() if p.is_shard(1) or p.is_partial() else p
          for p in kv["k"].placements]
    local = {n: t.redistribute(mesh, pl).to_local() for n, t in kv.items()}
    b, _, h, hd = local["k"].shape
    length = min(window, seq_len) if window > 0 else seq_len
    empty = {n: torch.zeros((b, length, h, hd), dtype=t.dtype,
                            device=t.device) for n, t in local.items()}
    return {n: DTensor.from_local(t, mesh, pl, run_check=False)
            for n, t in fill_kv_cache(empty, local, window).items()}


def position_on(pos: Union[int, torch.Tensor], device) -> torch.Tensor:
    """A decode position as a 0-d int64 tensor on ``device``. A Python
    int becomes one by a fill on the device, with no copy from the host,
    so it costs no host sync; so does a tensor already on the device.
    A CPU tensor is copied there, and a copy from pageable host memory
    waits for the device's queue: keep such a position on the device.
    The position is never read back to the host."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.long)
    return torch.full((), pos, dtype=torch.long, device=device)


def attn_decode(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                pos: Union[int, torch.Tensor], cache: Dict[str, torch.Tensor],
                window: int = 0, use_rope: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (b, 1, d); ``pos`` the token's absolute
    position (see ``position_on``); cache k/v (b, L, kv, hd). Returns (y
    (b, 1, d), the new cache); the input cache is not changed. The
    token's K/V (rotated unless ``use_rope`` is False) go to slot
    ``min(pos, L - 1)`` of a full cache, ``pos % L`` of a ring."""
    b = x.shape[0]
    groups = cfg.num_heads // cfg.num_kv_heads
    dev = x.device
    pos = position_on(pos, dev)
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if use_rope:
        posb = pos.expand(b)[:, None]                       # (b, 1)
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)

    L = cache["k"].shape[1]
    slot = (pos % L) if window > 0 else torch.clamp(pos, max=L - 1)
    if isinstance(cache["k"], DTensor):
        return _decode_on_shards(params, x, cfg, q, k, v, pos, slot, cache,
                                 window)
    ck = cache["k"].index_copy(1, slot.reshape(1), k)
    cv = cache["v"].index_copy(1, slot.reshape(1), v)

    valid = _valid_slots(torch.arange(L, device=dev), pos, L, window)
    kf = _expand_kv(ck, groups)                             # (b, L, h, hd)
    vf = _expand_kv(cv, groups)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    scores = torch.einsum("bqhk,blhk->bhql", q.float(), kf.float()) * scale
    scores = torch.where(valid[None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhql,blhk->bqhk", probs, vf.float())
    return _out_proj(out.to(x.dtype), params["wo"]), {"k": ck, "v": cv}


def _valid_slots(idx: torch.Tensor, pos: torch.Tensor, L: int,
                 window: int) -> torch.Tensor:
    """Which of the cache slots ``idx`` (global indices) hold a position
    the token at ``pos`` attends to, in a cache of ``L`` slots."""
    if window > 0:
        # slot j holds position p = j (mod L), p <= pos, p > pos - L
        p_of_slot = pos - torch.remainder(pos - idx, L)
        return (p_of_slot >= 0) & (p_of_slot > pos - window)
    return idx <= pos


def _decode_on_shards(params: Params, x, cfg: ModelConfig, q, k, v,
                      pos: torch.Tensor, slot: torch.Tensor,
                      cache: Dict[str, torch.Tensor], window: int):
    """``attn_decode`` over a DTensor cache, on each rank's shard of it
    (see the module's docstring): the new token's K/V written by the
    rank that holds ``slot``, the scores of the rank's slots, and, over a
    sequence-sharded cache, their softmax combined across the shards
    (``softmax_over_shards``). The cache keeps its placements."""
    mesh, pl = cache["k"].device_mesh, list(cache["k"].placements)
    # the token's q, k and v laid out as the cache's batch rows and KV
    # heads (a rank's query heads are its KV heads' groups), whole on the
    # mesh dimensions that split the cache's sequence
    tok_pl = [Replicate() if p.is_shard(1) else p for p in pl]
    ql, kl, vl = (t.redistribute(mesh, tok_pl).to_local()
                  if isinstance(t, DTensor) else t for t in (q, k, v))
    L = cache["k"].shape[1]
    offset, length = local_range(cache["k"], 1)
    rel = slot - offset
    mine = (rel >= 0) & (rel < length)
    at = rel.clamp(0, length - 1).reshape(1)
    new = {}
    for n, t in (("k", kl), ("v", vl)):
        c = cache[n].to_local()
        # a select on the clamped local slot: only its owner writes
        row = torch.where(mine, t, c.index_select(1, at))
        new[n] = c.index_copy(1, at, row)
    idx = offset + torch.arange(length, device=ql.device)
    valid = _valid_slots(idx, pos, L, window)
    groups = ql.shape[2] // new["k"].shape[2]
    kf = _expand_kv(new["k"], groups)
    vf = _expand_kv(new["v"], groups)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    scores = torch.einsum("bqhk,blhk->bhql", ql.float(), kf.float()) * scale
    scores = torch.where(valid[None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    seq_dims = [i for i, p in enumerate(pl) if p.is_shard(1)]
    if seq_dims:
        out = softmax_over_shards(scores, vf,
                                  [mesh.get_group(i) for i in seq_dims])
    else:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhql,blhk->bqhk", probs, vf.float())
    out = DTensor.from_local(out.to(x.dtype), mesh, tok_pl, run_check=False)
    return _out_proj(out, params["wo"]), {
        n: DTensor.from_local(t, mesh, pl, run_check=False)
        for n, t in new.items()}


def softmax_over_shards(scores: torch.Tensor, v: torch.Tensor,
                        groups) -> torch.Tensor:
    """``softmax(scores) @ v`` over a key axis split across the ranks of
    the process ``groups`` (each a mesh dimension that splits it), from
    each rank's keys alone: scores (b, h, 1, L_local) float32, masked by
    a select with ``NEG_INF``; v (b, L_local, h, hd). Each rank takes its
    max m_r, l_r = sum exp(s - m_r) and o_r = sum exp(s - m_r) v in
    float32; the max M is all-reduced, l_r and o_r are rescaled by
    exp(m_r - M) and all-reduced as sums, and the result is o / l (b, 1,
    h, hd) float32, the same on every rank of the groups. A rank whose
    keys are all masked (m_r = NEG_INF) adds exactly 0. Two all-reduces
    over the groups (b * h maxima, then b * h * (hd + 1) sums); the
    scores and the keys never move."""
    import torch.distributed as dist
    m = scores.amax(dim=-1, keepdim=True)                   # (b, h, 1, 1)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhql,blhk->bhqk", p, v.float())      # (b, h, 1, hd)
    big = m.clone()
    for g in groups:
        dist.all_reduce(big, op=dist.ReduceOp.MAX, group=g)
    w = torch.exp(m - big)
    both = torch.cat([o * w, l * w], dim=-1)               # (b, h, 1, hd+1)
    for g in groups:
        dist.all_reduce(both, group=g)
    out = both[..., :-1] / both[..., -1:]
    return out.permute(0, 2, 1, 3)                          # (b, 1, h, hd)


def cross_attn_decode(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      kv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One-token cross-attention, x (b, 1, d), over cached encoder K/V
    (b, L, kv, hd): f32 scores and softmax over every slot, no mask (a
    zero cache attends uniformly over zeros, as in the JAX package)."""
    groups = cfg.num_heads // cfg.num_kv_heads
    q = _project(x, params["wq"])
    kf = _expand_kv(kv["k"], groups)
    vf = _expand_kv(kv["v"], groups)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    scores = torch.einsum("bqhk,blhk->bhql", q.float(), kf.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhql,blhk->bqhk", probs, vf.float())
    return _out_proj(out.to(x.dtype), params["wo"])
