"""RWKV6 (Finch) blocks for full-sequence prefill (``repro.models.rwkv``):
data-dependent decay time-mix and channel-mix.

The WKV6 recurrence per head (K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T S_{t-1} + (r_t . (u * k_t)) v_t
with w_t in (0, 1) produced per channel by a LoRA on the shifted input.
``timemix_apply`` runs it in one of three modes:
  * ``kernel`` — the default: ``kernels.wkv6.ops.wkv6``, the hand-written
    CUDA intra-chunk kernel on the card (its plain version on the CPU)
    followed by the inter-chunk combine; exact;
  * ``direct`` — the same exact chunked scan in plain PyTorch
    (``kernels.wkv6.ref.wkv6_by_chunks``: the kernel's plain version and
    the same combine), as the JAX package's ``direct`` mode computes it;
  * ``factored`` — the JAX package's large-scale lowering
    (``wkv6_factored``), in plain PyTorch as the JAX package writes it
    in XLA ops (it reaches no Pallas kernel, so it launches no kernel
    here either): each per-step log-decay is clamped to
    ``-FACTORED_CLAMP / Q`` so that ``exp(-cum_j)`` stays finite in
    float32, and the intra-chunk pairs factor as ``A = (r exp(cum_{t-1}))
    (k exp(-cum_j))^T`` under the strict lower triangle (a select). Its
    chunk loop recomputes each chunk in the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint(body)`` does), so a
    gradient does not hold every chunk's (b, Q, Q, H) tile. The clamp
    changes the function wherever a decay passes it: no mode falls back
    to another.
Types follow the JAX package: projections in the model's type, the
log-decay and the recurrence in float32, y cast back before the per-head
group norm (float32 inside). The log-decay, and in factored mode each
chunk's inputs and the carried state, go through ``common.constrain``
where the JAX package constrains them (the kernel modes' chunking lies
inside their wrappers, so there the whole sequence's r, k, v and
log-decay go through it before the recurrence).

Decode is recurrent, one token at a time, in plain PyTorch as in the JAX
package (no kernel): ``timemix_apply(..., return_state=True)`` ends a
prefill with the state ``{"wkv": S (b, H, K, K) f32, "shift_t": x[:,
-1]}``; the model adds ``shift_c``, the channel-mix input at the last
token. ``timemix_decode`` and ``channelmix_decode`` step it
(``rwkv_state_spec`` gives its shapes). ``timemix_axes`` and
``channelmix_axes`` are the blocks' logical-axes tables
(``sharding.rules``).

On a mesh of SPMD ranks (DTensor params and inputs, the rules'
placements: the inner channels and heads over "model", the batch over
the data axes) the blocks run on DTensors, and each mode's recurrence
on each rank's heads (``wkv6_ops.RankHeads``): the factored mode's
chunk loop and the kernel's launch see plain local tensors, so the
chunk constraints are no-ops there, and nothing is exchanged inside the
recurrence. A weight's "embed" dimension, which FSDP shards over the
same axis as the batch, is gathered before its products
(``common.whole_dim``; its gradient reduce-scattered back). The
channel-mix's second product is a partial sum over "model": it is
reduced once, onto the receptance's shards, before the gate's product,
and the output gathered to the input's placements. The decode state
keeps the JAX package's layout (``STATE_AXES``: the WKV state's heads
replicated over "model"): a prefill's final state and each decode
step's new one are computed on the rank's heads and brought together
once a layer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6 import ref as wkv6_ref
from repro_torch.models.common import (Params, constrain, dense_init,
                                       randn, whole_dim)

LORA_RANK = 64
CHUNK = 128
MIX_NAMES = ("w", "k", "v", "r", "g")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown rwkv mode {mode!r}; one of {MODES}")


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv.head_dim


def timemix_init(generator: torch.Generator, cfg: ModelConfig,
                 dtype) -> Params:
    d = cfg.d_model
    H, K = _heads(cfg), cfg.rwkv.head_dim
    dev = generator.device
    full = lambda shape, val, dt: torch.full(shape, val, dtype=dt,
                                             device=dev)
    return {
        "mu_x": full((d,), 0.5, dtype),
        "mu": full((5, d), 0.5, dtype),
        "lora_a": dense_init(generator, d, (5, LORA_RANK), dtype),
        "lora_b": dense_init(generator, LORA_RANK, (5, d), dtype),
        "w0": full((d,), -6.0, torch.float32),
        "wa": dense_init(generator, d, (LORA_RANK,), dtype),
        "wb": dense_init(generator, LORA_RANK, (d,), dtype),
        "u": randn((H, K), generator).mul_(0.1),
        "wr": dense_init(generator, d, (d,), dtype),
        "wk": dense_init(generator, d, (d,), dtype),
        "wv": dense_init(generator, d, (d,), dtype),
        "wg": dense_init(generator, d, (d,), dtype),
        "wo": dense_init(generator, d, (d,), dtype),
        "ln_x": full((d,), 1.0, torch.float32),
    }


def timemix_axes(cfg: ModelConfig) -> Params:
    return {
        "mu_x": ("embed",), "mu": (None, "embed"),
        "lora_a": ("embed", None, None), "lora_b": (None, None, "embed"),
        # decay / bonus / groupnorm are per channel of the head layout:
        # sharded like the inner (model) dim
        "w0": ("inner",), "wa": ("embed", None), "wb": (None, "inner"),
        "u": ("act_heads", "head_dim"),
        "wr": ("embed", "inner"), "wk": ("embed", "inner"),
        "wv": ("embed", "inner"), "wg": ("embed", "inner"),
        "wo": ("inner", "embed"), "ln_x": ("inner",),
    }


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x_prev: x moved one token later, zeros at the first."""
    if isinstance(x, DTensor):
        # the same values by a concatenation: DTensor's pad (torch 2.11)
        # gives a tensor on a 2-D mesh a single placement
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _embed_whole(p: Params, axes: Params) -> Params:
    """The block's weights with every "embed" dimension brought together
    (``common.whole_dim``: an FSDP shard over "data" all-gathered); a
    plain tensor, or a weight whose "embed" dimension is not sharded, as
    it is."""
    out = {}
    for name, w in p.items():
        for dim, logical in enumerate(axes[name]):
            if logical == "embed":
                w = whole_dim(w, dim)
        out[name] = w
    return out


def _token_shift_mix(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift (ddlerp). x, x_prev: (b, s, d).
    Returns dict name -> mixed input (b, s, d)."""
    b, s, d = x.shape
    sx = x_prev - x
    xx = x + sx * p["mu_x"]
    la = p["lora_a"]
    t = torch.tanh(xx @ la.reshape(d, -1)).reshape(b, s, *la.shape[1:])
    dd = torch.einsum("bsmr,rmd->bsmd", t, p["lora_b"])
    mixed = x[:, :, None, :] + sx[:, :, None, :] * (p["mu"][None, None] + dd)
    return {n: mixed[:, :, i, :] for i, n in enumerate(MIX_NAMES)}


def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """log w_t (negative), per channel. xw: (b, s, d) -> (b, s, d) f32."""
    lora = xw @ p["wa"]
    ww = p["w0"] + (torch.tanh(lora) @ p["wb"]).float()
    return -torch.exp(ww)


def _groupnorm_heads(x: torch.Tensor, scale: torch.Tensor, H: int,
                     eps: float) -> torch.Tensor:
    """Per-head group norm (population variance), float32 inside.
    x: (b, s, d)."""
    b, s, d = x.shape
    xf = x.float().reshape(b, s, H, d // H)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y.reshape(b, s, d) * scale).to(x.dtype)


# Per-step log-decay clamp of the factored mode: with chunk Q the factored
# exponent -cum_j is bounded by Q * FACTORED_CLAMP / Q = 80 < 88 (float32
# exp overflow). The exact modes have no clamp.
FACTORED_CLAMP = 80.0

# the (b, Q, H, K) chunk tensors and the carried (b, H, K, K) state
_BODY_AXES = ("batch", None, "act_heads", None)
_STATE_AXES = ("batch", "act_heads", None, None)


def _factored_chunk(S_prev, r_c, k_c, v_c, cum_c, lw_c, u, tri_strict):
    """One chunk of the factored WKV6, float32: r_c, k_c, v_c, cum_c,
    lw_c (b, Q, H, K), S_prev (b, H, K, K) -> (S_new, y_c (b, Q, H, K))."""
    r_c, k_c, v_c, cum_c, lw_c = (constrain(t, _BODY_AXES)
                                  for t in (r_c, k_c, v_c, cum_c, lw_c))
    S_prev = constrain(S_prev, _STATE_AXES)
    cum_tm1 = cum_c - lw_c
    r_fac = r_c * torch.exp(cum_tm1)
    k_fac = k_c * torch.exp(-cum_c)
    A = torch.einsum("bqhk,bjhk->bqjh", r_fac, k_fac)
    A = torch.where(tri_strict[None, :, :, None], A, A.new_zeros(()))
    diag = torch.einsum("bqhk,hk,bqhk->bqh", r_c, u, k_c)
    y_c = torch.einsum("bqjh,bjhk->bqhk", A, v_c) + diag[..., None] * v_c
    # inter-chunk, from the carried state
    y_c = y_c + torch.einsum("bqhk,bhkv->bqhv", r_fac, S_prev)
    dec_end = torch.exp(cum_c[:, -1:] - cum_c)
    S_inj = torch.einsum("bqhk,bqhv->bhkv", k_c * dec_end, v_c)
    a_end = torch.exp(cum_c[:, -1])
    return a_end[..., None] * S_prev + S_inj, y_c


def wkv6_factored(r, k, v, lw, u, *, chunk: int = CHUNK,
                  return_state: bool = False):
    """The factored WKV6 (``repro.models.rwkv``'s ``mode="factored"``):
    r, k, v, lw (b, s, H, K) float32, u (H, K) -> y (b, s, H, K), or (y,
    S) with ``return_state``. Chunks of ``chunk_len(s, chunk)`` tokens;
    each log-decay clamped to ``-FACTORED_CLAMP / Q`` first. With grad
    mode on, each chunk is recomputed in the backward."""
    b, s, H, K = r.shape
    Q = wkv6_ref.chunk_len(s, chunk)
    nc = s // Q
    lw = torch.clamp(lw, min=-FACTORED_CLAMP / Q)
    rs, ks, vs, lws = (t.reshape(b, nc, Q, H, K) for t in (r, k, v, lw))
    cum = torch.cumsum(lws, dim=2)
    chunk_axes = ("batch", None, None, "act_heads", None)
    rs, ks, vs, lws, cum = (constrain(t, chunk_axes)
                            for t in (rs, ks, vs, lws, cum))
    tri_strict = torch.ones((Q, Q), dtype=torch.bool,
                            device=r.device).tril(-1)
    step = _factored_chunk
    if torch.is_grad_enabled():
        step = lambda *a: checkpoint(_factored_chunk, *a,
                                     use_reentrant=False)
    S = r.new_zeros((b, H, K, K))
    ys = []
    for c in range(nc):
        S, y_c = step(S, rs[:, c], ks[:, c], vs[:, c], cum[:, c], lws[:, c],
                      u, tri_strict)
        ys.append(y_c)
    y = torch.stack(ys, dim=1).reshape(b, s, H, K)
    return (y, S) if return_state else y


# the recurrence of each mode: (r, k, v, lw, u, *, chunk) -> y
WKV6 = {"kernel": wkv6_ops.wkv6, "direct": wkv6_ref.wkv6_by_chunks,
        "factored": wkv6_factored}
MODES = tuple(WKV6)


def recurrence(mode: str, r, k, v, lw, u, return_state: bool = False):
    """Mode ``mode``'s WKV6 on r, k, v, lw (b, s, H, K) float32 and u (H,
    K): y, or (y, the final state (b, H, K, K)) with ``return_state``.
    DTensors run on each rank's heads (``wkv6_ops.RankHeads``), placed
    as the JAX package's chunk constraints place them first."""
    fn = WKV6[mode]
    if not isinstance(r, DTensor):
        return fn(r, k, v, lw, u, chunk=CHUNK, return_state=return_state)
    r, k, v, lw = (constrain(t, _BODY_AXES) for t in (r, k, v, lw))
    heads = wkv6_ops.RankHeads(r)
    out = fn(*heads.local(r, k, v, lw, u), chunk=CHUNK,
             return_state=return_state)
    if not return_state:
        return heads.y(out)
    return heads.y(out[0]), heads.state(out[1])


def timemix_inputs(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   x_prev: torch.Tensor = None):
    """The time-mix up to the recurrence. x: (b, s, d) -> r, k, v and the
    log-decay lw per head, each (b, s, H, K) float32, and the gate g
    (b, s, d) in x's type. ``x_prev`` is each token's previous input
    (b, s, d); None takes ``x`` shifted one token, zeros at the first."""
    b, s, d = x.shape
    H, K = _heads(cfg), cfg.rwkv.head_dim
    p = _embed_whole(p, timemix_axes(cfg))
    m = _token_shift_mix(p, x, _shift(x) if x_prev is None else x_prev)
    lw = _decay(p, m["w"])                                 # (b, s, d) f32
    lw = constrain(lw, ("batch", None, "act_mlp"))
    r = m["r"] @ p["wr"]
    k = m["k"] @ p["wk"]
    v = m["v"] @ p["wv"]
    g = F.silu((m["g"] @ p["wg"]).float()).to(x.dtype)
    rh, kh, vh, lwh = (t.float().reshape(b, s, H, K) for t in (r, k, v, lw))
    return rh, kh, vh, lwh, g


def timemix_output(p: Params, y: torch.Tensor, g: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """The time-mix after the recurrence. y: (b, s, H, K) float32, g: the
    gate (b, s, d) -> (b, s, d) in g's type."""
    b, s = g.shape[:2]
    y = _groupnorm_heads(y.reshape(b, s, -1).to(g.dtype), p["ln_x"],
                         _heads(cfg), cfg.norm_eps)
    out = (y * g) @ whole_dim(p["wo"], 1)
    if isinstance(out, DTensor):
        # a partial sum over "model", reduced once and placed as g's rows
        out = out.redistribute(out.device_mesh, _rows(g))
    return out


def timemix_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  mode: str = "kernel", return_state: bool = False):
    """Full-sequence WKV6 time-mix. x: (b, s, d) -> (b, s, d); with
    ``return_state``, (out, {"wkv": the recurrence's final state (b, H,
    K, K) float32, "shift_t": x[:, -1]}). ``out`` is the same either
    way."""
    check_mode(mode)
    r, k, v, lw, g = timemix_inputs(p, x, cfg)
    if mode != "factored":
        r, k, v, lw = (constrain(t, _BODY_AXES) for t in (r, k, v, lw))
    if not return_state:
        return timemix_output(p, recurrence(mode, r, k, v, lw, p["u"]), g,
                              cfg)
    y, S = recurrence(mode, r, k, v, lw, p["u"], return_state=True)
    return (timemix_output(p, y, g, cfg),
            {"wkv": _state_layout(S, r), "shift_t": x[:, -1]})


def channelmix_init(generator: torch.Generator, cfg: ModelConfig,
                    dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dev = generator.device
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "wk": dense_init(generator, d, (f,), dtype),
        "wv": dense_init(generator, f, (d,), dtype),
        "wr": dense_init(generator, d, (d,), dtype),
    }


def channelmix_axes(cfg: ModelConfig) -> Params:
    return {"mu_k": ("embed",), "mu_r": ("embed",),
            "wk": ("embed", "mlp"), "wv": ("mlp", "embed"),
            "wr": ("embed", "inner")}


def channelmix_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     x_prev: torch.Tensor = None) -> torch.Tensor:
    """Squared-ReLU channel-mix with a sigmoid receptance gate, both
    taken in float32 and cast back. x: (b, s, d) -> (b, s, d);
    ``x_prev`` as in ``timemix_inputs``."""
    p = _embed_whole(p, channelmix_axes(cfg))
    sx = (_shift(x) if x_prev is None else x_prev) - x
    xk = x + sx * p["mu_k"]
    xr = x + sx * p["mu_r"]
    k = torch.square(F.relu((xk @ p["wk"]).float())).to(x.dtype)
    r = torch.sigmoid((xr @ p["wr"]).float()).to(x.dtype)
    kv = k @ p["wv"]
    if not isinstance(kv, DTensor):
        return r * kv
    # a partial sum over "model": reduced onto r's shards (a
    # reduce-scatter where r is sharded), and the product gathered
    # everywhere but over x's rows
    kv = kv.redistribute(kv.device_mesh, r.placements)
    return (r * kv).redistribute(x.device_mesh, _rows(x))


# -- decode (recurrent, one token) -------------------------------------------

STATE_AXES = {"wkv": ("batch", None, None, None),
              "shift_t": ("batch", "embed"), "shift_c": ("batch", "embed")}


def _rows(x) -> list:
    """Placements of a DTensor laid out as ``x``'s rows: Shard(0) where x
    has it, Replicate elsewhere."""
    return [p if p.is_shard(0) else Replicate() for p in x.placements]


def _state_layout(S, like):
    """A DTensor WKV state (b, H, K, K) computed on each rank's heads in
    ``STATE_AXES``' layout: its batch placed as ``like``'s (b, ...)
    rows, everything else brought together (one all-gather over the
    heads' axis); a plain tensor as it is."""
    if not isinstance(S, DTensor):
        return S
    return S.redistribute(S.device_mesh, _rows(like))


def rwkv_state_spec(cfg: ModelConfig, batch: int, dtype
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """One block's decode state as (meta tensors of its shapes and types,
    logical axes): the WKV state in float32, the two token shifts (the
    time-mix's and the channel-mix's last input) in ``dtype``."""
    d = cfg.d_model
    H, K = _heads(cfg), cfg.rwkv.head_dim
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    spec = {"wkv": meta((batch, H, K, K), torch.float32),
            "shift_t": meta((batch, d), dtype),
            "shift_c": meta((batch, d), dtype)}
    return spec, dict(STATE_AXES)


def timemix_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   state: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token. x: (b, 1, d) -> (out (b, 1, d), the state with new
    "wkv" and "shift_t"); the input state is not changed."""
    b, _, d = x.shape
    H, K = _heads(cfg), cfg.rwkv.head_dim
    r, k, v, lw, g = timemix_inputs(p, x, cfg,
                                    x_prev=state["shift_t"][:, None, :])
    rh, kh, vh = (t[:, 0] for t in (r, k, v))                # (b, H, K)
    w = torch.exp(lw[:, 0])
    S = state["wkv"]
    o = (torch.einsum("bhk,bhkv->bhv", rh, S)
         + torch.einsum("bhk,hk,bhk->bh", rh, p["u"], kh)[..., None] * vh)
    new = dict(state)
    S_new = w[..., None] * S + kh[..., None] * vh[:, :, None, :]
    if isinstance(S, DTensor):
        # computed on the rank's heads, brought back to the state's layout
        S_new = S_new.redistribute(S.device_mesh, S.placements)
    new["wkv"] = S_new
    new["shift_t"] = x[:, 0]
    return timemix_output(p, o[:, None], g, cfg), new


def channelmix_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      state: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token. x: (b, 1, d) -> (out, the state with a new "shift_c")."""
    out = channelmix_apply(p, x, cfg, x_prev=state["shift_c"][:, None, :])
    new = dict(state)
    new["shift_c"] = x[:, 0]
    return out, new
