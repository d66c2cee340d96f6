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

On a mesh of SPMD ranks (DTensor inputs) ``moe_apply`` is
``moe_apply_mesh``: expert parallelism, the experts over "model" as the
rules place them. A dispatch chunk is cut from the global token list, as
on one device; a rank routes its rows, and a chunk that spans the row
shards of "data" (or "pod") routes as one (the shards' expert indices
all-gathered, each pair's position counted over the whole chunk against
its capacity, the auxiliary loss's per-expert sums all-reduced). Each
rank runs only its experts' slots (an FSDP shard of a weight gathered
over "data" first) and keeps its partial combine; the partial sums are
all-reduced over "model" once a call, where the JAX package's GSPMD
lowers the dispatch and combine to all-to-alls of the slots. With the
experts replicated (the rule's fallback) every rank runs them all and
nothing is summed. In the backward the block's input and the router
take each rank's partial gradient, summed once over "model", and the
auxiliary loss, computed alike on every rank, enters once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
from torch.distributed.tensor import DTensor

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


def _gate(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """The router on tokens x (T, d): the probabilities (T, E) float32,
    the renormalized gates (T, K) float32 and the experts (T, K)."""
    K = cfg.moe.top_k
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    # lax.top_k keeps the lower index on a tie, and so does a stable
    # descending sort. Only a tie at the K-th place changes the routing:
    # the order within a token's K does not move pos_in_expert, since a
    # token picks each expert at most once.
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :K], experts[:, :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, experts


def _selected(experts: torch.Tensor, E: int) -> torch.Tensor:
    """(T, K, E) float32: the one-hot of each pair's expert, as a compare
    (F.one_hot validates its indices with a host sync on the CPU only,
    so its operators differ by device)."""
    return (experts[..., None] == torch.arange(
        E, device=experts.device)).float()


def _positions(experts: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, k) pair's position in its expert's buffer (T*K,): the
    pairs of the same expert before it in (t, k)-major order, counted
    exactly in int32. The one-hot is laid out (E, T*K) so the scan runs
    along the inner dimension (along the outer one of a (T*K, E) tensor
    it is a slow sequential kernel on the card)."""
    flat_e = experts.reshape(-1)
    onehot = (flat_e[None, :] == torch.arange(E, device=experts.device)[:, None]
              ).to(torch.int32)
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    return before.gather(0, flat_e[None, :])[0].long()


def _route(params: Params, x: torch.Tensor, cfg: ModelConfig):
    """The router of one chunk x (T, d): the renormalized gates (T, K)
    float32, the experts (T, K), each (token, k) pair's position in its
    expert's buffer in (t, k)-major order (T*K,), whether it fits the
    capacity (T*K,), the auxiliary loss and the capacity C."""
    E = cfg.moe.num_experts
    T = x.shape[0]
    probs, gates, experts = _gate(params["router"], x, cfg)
    # Switch aux loss: E * sum_e f_e * p_e
    frac_tokens = _selected(experts, E).sum(1).mean(0)
    aux = E * torch.sum(frac_tokens * probs.mean(0))
    pos = _positions(experts, E)
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


# -- the mesh form: experts over the model axis -------------------------------

class _SumOver(torch.autograd.Function):
    """A sum over the ranks of ``groups`` (all-reduces, one a group) in
    the forward, the identity in the backward: every rank of the groups
    holds the same sum, so each receives the same gradient of it, which
    is its own term's."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist
        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Once(torch.autograd.Function):
    """The identity, whose backward passes the gradient on where ``first``
    and zero elsewhere: a value that every rank of some mesh dimensions
    computes alike, from inputs whose gradients are summed over those
    ranks, then enters the sum once."""

    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.first else torch.zeros_like(grad)), None


@dataclasses.dataclass
class _MeshLayout:
    """Where an MoE block's work lies on a ``DeviceMesh``: ``rows``, the
    mesh dimensions that shard the tokens' batch (each rank routes and
    combines its rows), and ``experts``, those that shard the experts
    (each rank runs the slots of its ``el`` experts from ``e0``; the
    combine's partial sums are reduced over them). Every other dimension
    replicates the work. The placements (one a mesh dimension): ``x`` of
    the input and output rows, ``w`` of an expert weight brought together
    over every dimension but ``experts`` (an FSDP shard over "data"
    gathered), and the gradients of the local tensors: Partial where
    other ranks hold other terms of the sum."""
    mesh: Any
    rows: List[int]
    experts: List[int]
    e0: int
    el: int
    x: tuple
    x_grad: tuple
    router_grad: tuple
    w: tuple
    w_grad: tuple
    replicate: tuple

    @classmethod
    def of(cls, x, wi) -> "_MeshLayout":
        from torch.distributed.tensor import Partial, Replicate, Shard

        from repro_torch.sharding.rules import local_range
        ex = [i for i, p in enumerate(wi.placements) if p.is_shard(0)]
        rows = [i for i, p in enumerate(x.placements)
                if p.is_shard(0) and i not in ex]
        n = x.device_mesh.ndim

        def per_dim(row, expert, other):
            return tuple(row if i in rows else expert if i in ex else other
                         for i in range(n))
        e0, el = local_range(wi, 0)
        return cls(mesh=x.device_mesh, rows=rows, experts=ex, e0=e0, el=el,
                   x=per_dim(Shard(0), Replicate(), Replicate()),
                   x_grad=per_dim(Shard(0), Partial(), Replicate()),
                   router_grad=per_dim(Partial(), Partial(), Replicate()),
                   w=per_dim(Replicate(), Shard(0), Replicate()),
                   w_grad=per_dim(Partial(), Shard(0), Replicate()),
                   replicate=(Replicate(),) * n)

    def groups(self, dims: List[int]) -> list:
        return [self.mesh.get_group(d) for d in dims]

    def first_on_experts(self) -> bool:
        coord = self.mesh.get_coordinate()
        return all(coord[d] == 0 for d in self.experts)


def _segments(T: int, offset: int, local: int) -> List[Tuple[int, int, slice]]:
    """The pieces of the global chunks (``_chunks(T)``) that the local
    tokens [offset, offset + local) hold: (start, stop) in local token
    indices and the chunk's global slice, in order."""
    out = []
    for c in _chunks(T):
        a, e = max(c.start, offset), min(c.stop, offset + local)
        if a < e:
            out.append((a - offset, e - offset, c))
    return out


def _mesh_routes(router: torch.Tensor, flat: torch.Tensor, T: int,
                 lay: _MeshLayout, cfg: ModelConfig):
    """The routing of a rank's tokens ``flat`` (T_l, d), which are global
    tokens [o, o + T_l) of T (o: the rank's block over ``lay.rows``),
    chunk by global chunk: [(start, stop, gates, experts, pos, keep, C)]
    a local piece of a chunk, and the auxiliary loss over every chunk
    (the same value on every rank, its gradient entering once over the
    expert dimensions). Where every piece is a whole chunk each routes
    alone, as on one device, and only the auxiliary losses' sum is
    reduced over the row dimensions. Where a chunk spans row shards it
    routes as one: the ranks' (T_l, K) experts are all-gathered, each
    pair's position counted over the whole chunk in (t, k)-major order
    against the whole chunk's capacity, and the auxiliary loss's
    per-expert sums all-reduced."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import block_index
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    Tl = flat.shape[0]
    offset = block_index(lay.mesh, lay.rows) * Tl
    chunks = _chunks(T)
    segs = _segments(T, offset, Tl)
    rows = lay.groups(lay.rows)
    if all(e - a == c.stop - c.start for a, e, c in segs):
        routes, auxes = [], []
        for a, e, _ in segs:
            gates, experts, pos, keep, aux, C = _route({"router": router},
                                                       flat[a:e], cfg)
            routes.append((a, e, gates, experts, pos, keep, C))
            auxes.append(aux)
        aux = torch.stack(auxes).sum()
        if rows:
            aux = _SumOver.apply(aux, rows)
    else:
        gated = [_gate(router, flat[a:e], cfg) for a, e, _ in segs]
        mine = torch.cat([g[2] for g in gated])                # (T_l, K)
        every = DTensor.from_local(mine, lay.mesh, lay.x,
                                   run_check=False).full_tensor()
        zero = flat.new_zeros((2, E), dtype=torch.float32)
        sums = [zero] * len(chunks)
        for (a, e, c), (probs, _, experts) in zip(segs, gated):
            sums[c.start // (c.stop - c.start)] = torch.stack(
                [_selected(experts, E).sum((0, 1)), probs.sum(0)])
        sums = _SumOver.apply(torch.stack(sums), rows)         # (n, 2, E)
        n = chunks[0].stop - chunks[0].start
        aux = (E * torch.sum((sums[:, 0] / n) * (sums[:, 1] / n), -1)).sum()
        routes = []
        for (a, e, c), (_, gates, experts) in zip(segs, gated):
            lo = (offset + a - c.start) * K
            pos = _positions(every[c], E)[lo:lo + (e - a) * K]
            C = _capacity(n, cfg)
            routes.append((a, e, gates, experts, pos, pos < C, C))
    aux = _Once.apply(aux / len(chunks), lay.first_on_experts())
    return routes, aux


def _local_pairs(experts, keep, e0: int, el: int) -> torch.Tensor:
    """(T*K,) which kept pairs go to experts [e0, e0 + el)."""
    flat_e = experts.reshape(-1)
    return keep & (flat_e >= e0) & (flat_e < e0 + el)


def _mesh_onehot(w: Params, x, gates, experts, pos, keep, C: int, e0: int,
                 el: int, cfg: ModelConfig) -> torch.Tensor:
    """The one-hot dispatch of one piece x (T, d) on a rank's experts: the
    (T, el, C) slice of the tables (a pair of another rank's expert adds
    an exact zero), the rank's (el, C, d) products, and its partial sum
    of the combine (T, d)."""
    T, K = experts.shape
    d = x.shape[1]
    mine = _local_pairs(experts, keep, e0, el)
    t = torch.arange(T, device=x.device).repeat_interleave(K)
    e = torch.clamp(experts.reshape(T * K) - e0, 0, el - 1)
    p = torch.clamp(pos, max=C - 1)
    disp = torch.zeros((T, el, C), dtype=torch.float32, device=x.device)
    comb = torch.zeros_like(disp)
    disp.index_put_((t, e, p), torch.where(mine, 1.0, 0.0), accumulate=True)
    comb.index_put_((t, e, p), torch.where(mine, gates.reshape(T * K), 0.0),
                    accumulate=True)
    xin = (disp.reshape(T, el * C).to(x.dtype).T @ x).reshape(el, C, d)
    out = _experts(w, xin, cfg)
    return comb.reshape(T, el * C).to(out.dtype) @ out.reshape(el * C, d)


def _mesh_sort(w: Params, x, gates, experts, pos, keep, C: int, e0: int,
               el: int, cfg: ModelConfig) -> torch.Tensor:
    """The gather dispatch of one piece x (T, d) on a rank's experts: its
    el * C slots, the products, and each token's sum in k order over its
    pairs that this rank holds (the rank's partial sum, (T, d))."""
    T, K = experts.shape
    d = x.shape[1]
    n = T * K
    mine = _local_pairs(experts, keep, e0, el)
    slot = torch.where(mine, (experts.reshape(n) - e0) * C + pos,
                       el * C + torch.arange(n, device=x.device))
    slot_tok = torch.full((el * C + n,), T, dtype=torch.long, device=x.device)
    slot_tok[slot] = torch.arange(T, device=x.device).repeat_interleave(K)
    slot_gate = torch.zeros((el * C + n,), dtype=torch.float32,
                            device=x.device)
    slot_gate[slot] = gates.reshape(n)
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    out = _experts(w, x_pad[slot_tok[:el * C]].reshape(el, C, d), cfg)
    out_flat = out.reshape(el * C, d) * slot_gate[:el * C, None].to(out.dtype)
    out_pad = torch.cat([out_flat, out_flat.new_zeros((1, d))])
    contrib = out_pad[torch.where(mine, slot, el * C)].reshape(T, K, d)
    y = contrib[:, 0]
    for k in range(1, K):
        y = y + contrib[:, k]
    return y


MESH_IMPLS = {"onehot": _mesh_onehot, "sort": _mesh_sort}


def _mesh_local(params: Params, x, lay: _MeshLayout):
    """The rank's tokens (T_l, d) and its router and experts as plain
    tensors, each declaring its gradient's placements."""
    mesh = lay.mesh
    xl = x.redistribute(mesh, lay.x).to_local(grad_placements=lay.x_grad)
    local = {"router": params["router"].redistribute(
        mesh, lay.replicate).to_local(grad_placements=lay.router_grad)}
    for n in ("wi", "wg", "wo"):
        local[n] = params[n].redistribute(mesh, lay.w).to_local(
            grad_placements=lay.w_grad)
    return xl, local


def moe_apply_mesh(params: Params, x, cfg: ModelConfig,
                   dispatch: str = "onehot"):
    """``moe_apply`` on DTensors (SPMD ranks): x (b, s, d) placed with
    its batch over the row dimensions, the experts over the model axis
    (``moe_axes``). Each rank routes its rows (``_mesh_routes``: the
    global chunks, a chunk that spans row shards routed as one), runs
    only its own experts' slots, and adds its partial combine; the
    partial sums are all-reduced once a call over the expert dimensions
    (none where the rule left the experts replicated: every rank then
    runs them all). Returns (y (b, s, d) placed as the rows, aux
    replicated), the same function as on one device, to rounding: the
    combine's sum over experts is a sum of per-rank partial sums."""
    from torch.distributed.tensor import DTensor
    check_dispatch(dispatch)
    lay = _MeshLayout.of(x, params["wi"])
    xl, local = _mesh_local(params, x, lay)
    b, s, d = x.shape
    flat = xl.reshape(-1, d)
    routes, aux = _mesh_routes(local["router"], flat, b * s, lay, cfg)
    fn = MESH_IMPLS[dispatch]
    ys = [fn(local, flat[a:e], gates, experts, pos, keep, C, lay.e0,
             lay.el, cfg)
          for a, e, gates, experts, pos, keep, C in routes]
    y = ys[0] if len(ys) == 1 else torch.cat(ys)
    if lay.experts:
        y = _SumOver.apply(y, lay.groups(lay.experts))
    y = DTensor.from_local(y.reshape(xl.shape), lay.mesh, lay.x,
                           run_check=False)
    return y, DTensor.from_local(aux, lay.mesh, lay.replicate,
                                 run_check=False)


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
              dispatch: str = "onehot") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y (b, s, d), aux float32), routed chunk by
    chunk; aux is the mean of the chunks' auxiliary losses."""
    check_dispatch(dispatch)
    if isinstance(x, DTensor):
        return moe_apply_mesh(params, x, cfg, dispatch)
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


def mesh_routing(params: Params, x, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts (T_l, K), kept (T_l, K) bool) of this rank's rows of the
    DTensor x, as ``moe_apply_mesh`` routes them (the same on every rank
    of the model axis). Every rank calls it: a chunk that spans row
    shards gathers the experts."""
    K = cfg.moe.top_k
    with torch.no_grad():
        lay = _MeshLayout.of(x, params["wi"])
        xl, local = _mesh_local(params, x, lay)
        routes, _ = _mesh_routes(local["router"], xl.reshape(-1, x.shape[-1]),
                                 x.shape[0] * x.shape[1], lay, cfg)
    return (torch.cat([r[3] for r in routes]),
            torch.cat([r[5].reshape(-1, K) for r in routes]))


def kept_pairs(params: Params, x: torch.Tensor, cfg: ModelConfig,
               dispatch: str = "onehot") -> torch.Tensor:
    """(b*s, K) bool: which (token, k) pairs of x (b, s, d) the
    dispatch kept, read off its own tables (``disp`` for "onehot", the
    slots' tokens for "sort"), chunk by chunk as ``moe_apply`` routes.
    For a DTensor x, this rank's rows' pairs (``mesh_routing``)."""
    check_dispatch(dispatch)
    if isinstance(x, DTensor):
        return mesh_routing(params, x, cfg)[1]
    with torch.inference_mode():
        return _kept_on_one_device(params, x, cfg, dispatch)


def _kept_on_one_device(params: Params, x: torch.Tensor, cfg: ModelConfig,
                        dispatch: str) -> torch.Tensor:
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
