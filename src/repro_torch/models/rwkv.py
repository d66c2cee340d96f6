"""RWKV6 (Finch) blocks for full-sequence prefill (``repro.models.rwkv``):
data-dependent decay time-mix and channel-mix.

The WKV6 recurrence per head (K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T S_{t-1} + (r_t . (u * k_t)) v_t
with w_t in (0, 1) produced per channel by a LoRA on the shifted input.
``timemix_apply`` runs it in one of two exact modes:
  * ``kernel`` — the default: ``kernels.wkv6.ops.wkv6``, the hand-written
    CUDA intra-chunk kernel on the card (its plain version on the CPU)
    followed by the inter-chunk combine;
  * ``direct`` — the same exact chunked scan in plain PyTorch
    (``kernels.wkv6.ref.wkv6_by_chunks``: the kernel's plain version and
    the same combine), as the JAX package's ``direct`` mode computes it.
The JAX package's third mode, ``factored``, clamps the decay for a
lossy training lowering; it is not ported and raises. Types follow the
JAX package: projections in the model's type, the log-decay and the
recurrence in float32, y cast back before the per-head group norm
(float32 inside).

Decode is recurrent, one token at a time, in plain PyTorch as in the JAX
package (no kernel): ``timemix_apply(..., return_state=True)`` ends a
prefill with the state ``{"wkv": S (b, H, K, K) f32, "shift_t": x[:,
-1]}``; the model adds ``shift_c``, the channel-mix input at the last
token. ``timemix_decode`` and ``channelmix_decode`` step it
(``rwkv_state_spec`` gives its shapes). ``timemix_axes`` and
``channelmix_axes`` wait for the sharding rules.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6 import ref as wkv6_ref
from repro_torch.models.common import Params, dense_init

LORA_RANK = 64
CHUNK = 128
MIX_NAMES = ("w", "k", "v", "r", "g")


def check_mode(mode: str) -> None:
    if mode == "factored":
        raise NotImplementedError("rwkv_mode='factored' (the clamped "
                                  "training lowering) is not ported")
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
        "u": torch.randn((H, K), generator=generator, device=dev).mul_(0.1),
        "wr": dense_init(generator, d, (d,), dtype),
        "wk": dense_init(generator, d, (d,), dtype),
        "wv": dense_init(generator, d, (d,), dtype),
        "wg": dense_init(generator, d, (d,), dtype),
        "wo": dense_init(generator, d, (d,), dtype),
        "ln_x": full((d,), 1.0, torch.float32),
    }


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x_prev: x moved one token later, zeros at the first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


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


# the recurrence of each mode: (r, k, v, lw, u, *, chunk) -> y, exact both
WKV6 = {"kernel": wkv6_ops.wkv6, "direct": wkv6_ref.wkv6_by_chunks}
MODES = tuple(WKV6)


def timemix_inputs(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   x_prev: torch.Tensor = None):
    """The time-mix up to the recurrence. x: (b, s, d) -> r, k, v and the
    log-decay lw per head, each (b, s, H, K) float32, and the gate g
    (b, s, d) in x's type. ``x_prev`` is each token's previous input
    (b, s, d); None takes ``x`` shifted one token, zeros at the first."""
    b, s, d = x.shape
    H, K = _heads(cfg), cfg.rwkv.head_dim
    m = _token_shift_mix(p, x, _shift(x) if x_prev is None else x_prev)
    lw = _decay(p, m["w"])                                 # (b, s, d) f32
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
    return (y * g) @ p["wo"]


def timemix_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  mode: str = "kernel", return_state: bool = False):
    """Full-sequence WKV6 time-mix. x: (b, s, d) -> (b, s, d); with
    ``return_state``, (out, {"wkv": the recurrence's final state (b, H,
    K, K) float32, "shift_t": x[:, -1]}). ``out`` is the same either
    way."""
    check_mode(mode)
    r, k, v, lw, g = timemix_inputs(p, x, cfg)
    if not return_state:
        return timemix_output(p, WKV6[mode](r, k, v, lw, p["u"],
                                            chunk=CHUNK), g, cfg)
    y, S = WKV6[mode](r, k, v, lw, p["u"], chunk=CHUNK, return_state=True)
    return timemix_output(p, y, g, cfg), {"wkv": S, "shift_t": x[:, -1]}


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


def channelmix_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     x_prev: torch.Tensor = None) -> torch.Tensor:
    """Squared-ReLU channel-mix with a sigmoid receptance gate, both
    taken in float32 and cast back. x: (b, s, d) -> (b, s, d);
    ``x_prev`` as in ``timemix_inputs``."""
    sx = (_shift(x) if x_prev is None else x_prev) - x
    xk = x + sx * p["mu_k"]
    xr = x + sx * p["mu_r"]
    k = torch.square(F.relu((xk @ p["wk"]).float())).to(x.dtype)
    r = torch.sigmoid((xr @ p["wr"]).float()).to(x.dtype)
    return r * (k @ p["wv"])


# -- decode (recurrent, one token) -------------------------------------------

STATE_AXES = {"wkv": ("batch", None, None, None),
              "shift_t": ("batch", "embed"), "shift_c": ("batch", "embed")}


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
    new["wkv"] = w[..., None] * S + kh[..., None] * vh[:, :, None, :]
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
