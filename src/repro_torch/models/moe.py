"""Top-k Mixture-of-Experts with GShard capacity dispatch
(``repro.models.moe``).

Tokens are routed in chunks of ``DISPATCH_CHUNK`` = 1024, the JAX
package's default. Each chunk routes on its own with ``_capacity(chunk)``
slots an expert, so which (token, k) pairs are dropped depends on the
chunk boundaries, and these follow the JAX package's exactly: chunks of
``min(DISPATCH_CHUNK, T)`` tokens, or one chunk of all T tokens when that
does not divide T. Pad rows of a batch
route like any other token and take capacity. The router is float32
whatever the model's type, and so are its logits; the gates are rounded
to the model's type before the combine. The Switch Transformer
auxiliary loss is the mean over the chunks.

Two dispatches, as in the JAX package:
- ``"onehot"``: GShard's dispatch and combine products with (T, E, C)
  tables. The tables are built here by scatter, which is bitwise the
  sum over k of the one-hot products the JAX package forms, since a
  token picks each expert at most once and so each (token, expert)
  receives at most one non-zero term.
- ``"sort"``: the tokens gathered into their experts' slots. Where the
  JAX package scatter-adds the slots back to their tokens, each token
  here gathers its K slots and sums them in k order, which is
  deterministic on the card (``index_add_`` in bf16 is not).

The expert products are batched matrix products on tensors, and the
loop over chunks is a Python loop (``lax.scan`` in the JAX package);
``jax.checkpoint`` is a training-only remat with no inference meaning.
An unknown ``dispatch`` raises (the JAX package takes it as
``"onehot"``). The chunk is a constant: the JAX package reads
``REPRO_MOE_CHUNK`` from the environment as a tuning knob, but the chunk
decides which pairs are dropped, so a store's rows would change with the
environment. ``moe_axes`` is the block's logical-axes table
(``sharding.rules``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.common import Params, activation, dense_init

# tokens per dispatch chunk (bounds the (chunk, E, C) tensors)
DISPATCH_CHUNK = 1024


def moe_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    """Random params drawn on ``generator``: the router (d, E) in float32
    whatever ``dtype`` is, the experts' ``wi``/``wg`` (E, d, f) and
    ``wo`` (E, f, d), each drawn as the JAX package draws it, fan-in
    first, then transposed."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts

    def experts(in_dim, out_dim):
        w = dense_init(generator, in_dim, (e, out_dim), dtype)
        return w.permute(1, 0, 2).contiguous()

    return {"router": dense_init(generator, d, (e,), torch.float32),
            "wi": experts(d, f), "wg": experts(d, f), "wo": experts(f, d)}


def moe_axes(cfg: ModelConfig) -> Params:
    return {
        "router": ("embed", None),
        "wi": ("experts", "embed", "expert_mlp"),
        "wg": ("experts", "embed", "expert_mlp"),
        "wo": ("experts", "expert_mlp", "embed"),
    }


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    cap = int(m.capacity_factor * tokens * m.top_k / m.num_experts)
    return max(cap, m.top_k)


def _route(params: Params, x: torch.Tensor, cfg: ModelConfig):
    """The router of one chunk x (T, d): the renormalized gates (T, K)
    float32, the experts (T, K), each (token, k) pair's position in its
    expert's buffer in (t, k)-major order (T*K,), whether it fits the
    capacity (T*K,), the auxiliary loss and the capacity C."""
    m = cfg.moe
    T = x.shape[0]
    E, K = m.num_experts, m.top_k
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    # lax.top_k keeps the lower index on a tie, and so does a stable
    # descending sort. Only a tie at the K-th place changes the routing:
    # the order within a token's K does not move pos_in_expert, since a
    # token picks each expert at most once.
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :K], experts[:, :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # Switch aux loss: E * sum_e f_e * p_e
    # the one-hot as a compare: F.one_hot validates its indices with a
    # host sync on the CPU only, so its operators differ by device
    sel = (experts[..., None] == torch.arange(
        E, device=experts.device)).float()                    # (T, K, E)
    frac_tokens = sel.sum(1).mean(0)
    aux = E * torch.sum(frac_tokens * probs.mean(0))

    # each pair's position in its expert's buffer: the pairs of the same
    # expert before it in (t, k)-major order, counted exactly in int32.
    # The one-hot is laid out (E, T*K) so the scan runs along the inner
    # dimension (along the outer one of a (T*K, E) tensor it is a slow
    # sequential kernel on the card)
    flat_e = experts.reshape(T * K)
    onehot = (flat_e[None, :] == torch.arange(E, device=x.device)[:, None]
              ).to(torch.int32)
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = before.gather(0, flat_e[None, :])[0].long()
    C = _capacity(T, cfg)
    return gates, experts, pos, pos < C, aux, C


def _onehot_tables(gates, experts, pos, keep, E: int, C: int):
    """The GShard dispatch and combine tensors (T, E, C) float32:
    ``disp[t, e, c]`` is 1 where token t holds slot c of expert e,
    ``comb`` the gate there. A token picks an expert at most once, so a
    dropped pair's (t, e) row holds nothing else: it writes a selected
    zero there, as the JAX package's one-hot of C is all zeros."""
    T, K = experts.shape
    t = torch.arange(T, device=experts.device).repeat_interleave(K)
    e = experts.reshape(T * K)
    p = torch.clamp(pos, max=C - 1)
    disp = torch.zeros((T, E, C), dtype=torch.float32, device=experts.device)
    comb = torch.zeros_like(disp)
    disp[t, e, p] = torch.where(keep, 1.0, 0.0)
    comb[t, e, p] = torch.where(keep, gates.reshape(T * K), 0.0)
    return disp, comb


def _experts(params: Params, xin: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """(E, C, d) -> (E, C, d): each expert's gated MLP, the activation on
    the ``wg`` branch."""
    act = activation(cfg.act)
    h = torch.bmm(xin, params["wi"])
    g = act(torch.bmm(xin, params["wg"]))
    return torch.bmm(h * g, params["wo"])


def _dispatch_chunk(params: Params, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) one chunk of tokens -> (y (T, d), aux)."""
    E = cfg.moe.num_experts
    gates, experts, pos, keep, aux, C = _route(params, x, cfg)
    disp, comb = _onehot_tables(gates, experts, pos, keep, E, C)
    T, d = x.shape
    # "tec,td->ecd" and "ecd,tec->td" as plain matrix products
    xin = (disp.reshape(T, E * C).to(x.dtype).T @ x).reshape(E, C, d)
    out = _experts(params, xin, cfg)
    y = comb.reshape(T, E * C).to(out.dtype) @ out.reshape(E * C, d)
    return y, aux


def _sort_slots(gates, experts, pos, keep, E: int, C: int):
    """Slot e*C + p of each kept (token, k) pair, and the token and gate
    in each of the E*C slots (token T and gate 0 where a slot is empty).
    A dropped pair's slot is an overflow slot of its own, past E*C, so
    no two pairs write one slot."""
    T, K = experts.shape
    dev = experts.device
    n = T * K
    slot = torch.where(keep, experts.reshape(n) * C + pos,
                       E * C + torch.arange(n, device=dev))
    slot_tok = torch.full((E * C + n,), T, dtype=torch.long, device=dev)
    slot_tok[slot] = torch.arange(T, device=dev).repeat_interleave(K)
    slot_gate = torch.zeros((E * C + n,), dtype=torch.float32, device=dev)
    slot_gate[slot] = gates.reshape(n)
    return slot, slot_tok[:E * C], slot_gate[:E * C]


def _dispatch_chunk_sort(params: Params, x: torch.Tensor, cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather dispatch: each expert's first C (token, k) pairs, in
    (t, k)-major order, gathered into its slots; the same drops as the
    one-hot form."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T, d = x.shape
    gates, experts, pos, keep, aux, C = _route(params, x, cfg)
    slot, slot_tok, slot_gate = _sort_slots(gates, experts, pos, keep, E, C)
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    xin = x_pad[slot_tok].reshape(E, C, d)
    out = _experts(params, xin, cfg)
    out_flat = out.reshape(E * C, d) * slot_gate[:, None].to(out.dtype)
    # combine: each token gathers its K slots (a dropped pair the zero
    # row at E*C) and sums them in k order
    out_pad = torch.cat([out_flat, out_flat.new_zeros((1, d))])
    contrib = out_pad[torch.where(keep, slot, E * C)].reshape(T, K, d)
    y = contrib[:, 0]
    for k in range(1, K):
        y = y + contrib[:, k]
    return y, aux


DISPATCH_IMPLS = {"onehot": _dispatch_chunk, "sort": _dispatch_chunk_sort}


def check_dispatch(dispatch: str) -> None:
    if dispatch not in DISPATCH_IMPLS:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}; one of "
                         f"{sorted(DISPATCH_IMPLS)}")


def _chunks(T: int) -> List[slice]:
    """The token chunks of a (T, d) input, the JAX package's: chunks of
    min(DISPATCH_CHUNK, T), or all T in one when that does not divide
    T."""
    chunk = min(DISPATCH_CHUNK, T)
    if T % chunk != 0:
        return [slice(0, T)]
    return [slice(s, s + chunk) for s in range(0, T, chunk)]


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
              dispatch: str = "onehot") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y (b, s, d), aux float32), routed chunk by
    chunk; aux is the mean of the chunks' auxiliary losses."""
    check_dispatch(dispatch)
    fn = DISPATCH_IMPLS[dispatch]
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    chunks = _chunks(b * s)
    ys, aux_sum = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for sl in chunks:
        y, aux = fn(params, flat[sl], cfg)
        ys.append(y)
        aux_sum = aux_sum + aux
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    return y.reshape(b, s, d), aux_sum / len(chunks)


@torch.inference_mode()
def kept_pairs(params: Params, x: torch.Tensor, cfg: ModelConfig,
               dispatch: str = "onehot") -> torch.Tensor:
    """(b*s, K) bool: which (token, k) pairs of x (b, s, d) the
    dispatch kept, read off its own tables (``disp`` for "onehot", the
    slots' tokens for "sort"), chunk by chunk as ``moe_apply`` routes."""
    check_dispatch(dispatch)
    E = cfg.moe.num_experts
    flat = x.reshape(-1, x.shape[-1])
    out = []
    for sl in _chunks(flat.shape[0]):
        gates, experts, pos, keep, _, C = _route(params, flat[sl], cfg)
        T, K = experts.shape
        if dispatch == "onehot":
            disp, _ = _onehot_tables(gates, experts, pos, keep, E, C)
            held = disp.sum(-1)                              # (T, E)
            out.append(held.gather(1, experts) > 0)
        else:
            _, slot_tok, _ = _sort_slots(gates, experts, pos, keep, E, C)
            # (token, expert) of every filled slot; empty slots (token T)
            # land in a row that is cut off
            held = torch.zeros((T + 1, E), dtype=torch.bool,
                               device=x.device)
            held[slot_tok, torch.arange(E * C, device=x.device) // C] = True
            out.append(held[:T].gather(1, experts))
    return torch.cat(out)
