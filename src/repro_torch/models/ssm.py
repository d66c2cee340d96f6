"""Mamba2 (SSD) block (``repro.models.ssm``): the chunked scan for the
full sequence, the recurrent decode step.

The state-space-duality form: within a chunk of Q tokens a quadratic
(attention-like) term, between chunks a recurrence over the chunk
states, carried by a Python loop over the chunks (the JAX package's
``lax.scan``; its ``jax.checkpoint`` is a training remat with no
inference meaning). The JAX Mamba2 block has no Pallas kernel, so this
is plain PyTorch on the card too.

Types follow the JAX package: the projections and the causal conv in
the model's type (the conv sums its W shifted products in that type over
the full sequence, in float32 in decode), the SSD in float32, ``a_log``,
``d_skip`` and ``dt_bias`` float32 whatever the model's type, y cast back
before the gated RMS norm (float32 inside).

State layout (per layer):
  ssm : (b, heads, head_dim, state) float32 — the SSD hidden state
  conv: (b, conv_width-1, d_conv)    — rolling buffer of the causal conv
``mamba_axes`` is the block's logical-axes table (``sharding.rules``);
each chunk's inputs and the carried state go through
``common.constrain``, where the JAX package constrains them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.common import Params, constrain, dense_init, randn

STATE_AXES = {"ssm": ("batch", None, None, None),
              "conv": ("batch", None, None)}


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    nheads = d_inner // cfg.ssm.head_dim
    d_conv = d_inner + 2 * cfg.ssm.state_dim   # conv over [x, B, C]
    return d_inner, nheads, d_conv


def chunk_length(s: int, chunk: int) -> int:
    """The JAX package's adaptive chunk: ``min(chunk, s)``, stepped down
    until it divides ``s`` (a prime length runs at 1)."""
    q = min(chunk, s)
    while s % q != 0:
        q -= 1
    return q


def mamba_init(generator: torch.Generator, cfg: ModelConfig,
               dtype) -> Params:
    d = cfg.d_model
    n = cfg.ssm.state_dim
    d_inner, nheads, d_conv = _dims(cfg)
    dev = generator.device
    # in_proj emits [z (gate), x, B, C, dt]
    out_dim = 2 * d_inner + 2 * n + nheads
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(generator, d, (out_dim,), dtype),
        "conv_w": randn((cfg.ssm.conv_width, d_conv), generator).mul_(0.1)
                  .to(dtype),
        "a_log": torch.zeros((nheads,), **f32),         # A = -exp(a_log)
        "d_skip": torch.ones((nheads,), **f32),
        "dt_bias": torch.zeros((nheads,), **f32),
        "out_proj": dense_init(generator, d_inner, (d,), dtype),
        "norm_z": torch.ones((d_inner,), dtype=dtype, device=dev),
    }


def mamba_axes(cfg: ModelConfig) -> Params:
    return {
        "in_proj": ("embed", "inner"),
        "conv_w": ("conv", None),
        "a_log": (None,),
        "d_skip": (None,),
        "dt_bias": (None,),
        "out_proj": ("inner", "embed"),
        "norm_z": ("inner",),
    }


def _split_in_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, nheads, _ = _dims(cfg)
    n = cfg.ssm.state_dim
    z = proj[..., :d_inner]
    x = proj[..., d_inner:2 * d_inner]
    B = proj[..., 2 * d_inner:2 * d_inner + n]
    C = proj[..., 2 * d_inner + n:2 * d_inner + 2 * n]
    dt = proj[..., 2 * d_inner + 2 * n:]
    return z, x, B, C, dt


def _gated_norm(z: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """RMSNorm(y * silu(z)), the Mamba2 output gate: the gate in float32,
    cast to y's type before the product; the norm in float32."""
    g = y * F.silu(z.float()).to(y.dtype)
    gf = g.float()
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _dt(dt: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """softplus(dt + dt_bias) in float32, as ``jax.nn.softplus`` computes
    it: logaddexp(x, 0), with no linear cut-off."""
    x = dt.float() + dt_bias
    return torch.logaddexp(x, x.new_zeros(()))


def _ssd_chunk(S_prev, x_c, dt_c, B_c, C_c, cum_c, tri):
    """One chunk of the SSD, float32. x_c (b, Q, H, P), dt_c and cum_c
    (b, Q, H), B_c and C_c (b, Q, n), S_prev (b, H, P, n) -> (y_c (b, Q,
    H, P), S_new)."""
    # intra-chunk: M[t,j] = (C_t.B_j) dt_j exp(cum_t - cum_j), j <= t
    cb = torch.einsum("bqn,bjn->bqj", C_c, B_c)
    seg = cum_c[:, :, None, :] - cum_c[:, None, :, :]           # (b,Q,Q,H)
    # above the diagonal seg > 0 and exp(seg) may be inf: a select, not a
    # product with a 0/1 mask (inf * 0 = NaN)
    decay = torch.where(tri[None, :, :, None], torch.exp(seg),
                        seg.new_zeros(()))
    M = cb[..., None] * decay * dt_c[:, None, :, :]
    y_c = torch.einsum("bqjh,bjhp->bqhp", M, x_c)
    # inter-chunk: y_t += exp(cum_t) C_t . S_prev
    y_int = torch.einsum("bqn,bhpn->bqhp", C_c, S_prev)
    y_c = y_c + y_int * torch.exp(cum_c)[..., None]
    # S = exp(cum_Q) S_prev + sum_j exp(cum_Q - cum_j) dt_j B_j x_j
    dec_end = torch.exp(cum_c[:, -1:, :] - cum_c)               # (b, Q, H)
    dB = (dt_c * dec_end)[..., None] * B_c[:, :, None, :]       # (b,Q,H,n)
    S_inj = torch.einsum("bqhn,bqhp->bhpn", dB, x_c)
    a_c = torch.exp(cum_c[:, -1, :])                            # (b, H)
    return y_c, a_c[:, :, None, None] * S_prev + S_inj


def mamba_apply(params: Params, x_in: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Full-sequence SSD. x_in: (b, s, d) -> (b, s, d); with
    ``return_state``, (out, {"ssm": the final state (b, H, P, n) float32,
    "conv": the last conv_width - 1 conv inputs in x_in's type}). ``out``
    is the same either way. The chunk is ``chunk_length(s,
    cfg.ssm.chunk)``."""
    b, s, d = x_in.shape
    n = cfg.ssm.state_dim
    P = cfg.ssm.head_dim
    d_inner, H, d_conv = _dims(cfg)
    Q = chunk_length(s, cfg.ssm.chunk)

    proj = x_in @ params["in_proj"]
    z, xs, B, C, dt = _split_in_proj(cfg, proj)

    # causal depthwise conv over [x, B, C]: W shifted products summed in
    # the input's type, as the JAX package's Python sum
    xbc = torch.cat([xs, B, C], dim=-1)                        # (b, s, dc)
    w = params["conv_w"]                                       # (W, dc)
    W = w.shape[0]
    conv_state = xbc[:, s - (W - 1):, :]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(W))
    conv = F.silu(conv.float()).to(x_in.dtype)
    xs = conv[..., :d_inner]
    B = conv[..., d_inner:d_inner + n].float()
    C = conv[..., d_inner + n:].float()

    dt = _dt(dt, params["dt_bias"])                            # (b, s, H)
    A = -torch.exp(params["a_log"])                            # (H,)
    xh = xs.reshape(b, s, H, P).float()

    nc = s // Q
    xc = xh.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H)
    Bc = B.reshape(b, nc, Q, n)
    Cc = C.reshape(b, nc, Q, n)
    cum = torch.cumsum(dtc * A, dim=2)                         # (b,nc,Q,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x_in.device).tril()
    S = torch.zeros((b, H, P, n), dtype=torch.float32, device=x_in.device)
    ys = []
    for c in range(nc):
        x_c = constrain(xc[:, c], ("batch", None, "act_heads", None))
        dt_c = constrain(dtc[:, c], ("batch", None, "act_heads"))
        cum_c = constrain(cum[:, c], ("batch", None, "act_heads"))
        S = constrain(S, ("batch", "act_heads", None, None))
        y_c, S = _ssd_chunk(S, x_c, dt_c, Bc[:, c], Cc[:, c], cum_c, tri)
        ys.append(y_c)
    y = torch.stack(ys, dim=1).reshape(b, s, H, P)
    y = y + params["d_skip"][None, None, :, None] * xh
    y = y.reshape(b, s, d_inner).to(x_in.dtype)
    y = _gated_norm(z, y, params["norm_z"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        return out, {"ssm": S, "conv": conv_state.to(x_in.dtype)}
    return out


# -- decode (recurrent, one token) -------------------------------------------

def mamba_state_spec(cfg: ModelConfig, batch: int, dtype
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """One block's decode state as (meta tensors of its shapes and types,
    logical axes): the SSD state in float32, the conv buffer in
    ``dtype``."""
    _, H, d_conv = _dims(cfg)
    P, n, W = cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.conv_width
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    spec = {"ssm": meta((batch, H, P, n), torch.float32),
            "conv": meta((batch, W - 1, d_conv), dtype)}
    return spec, dict(STATE_AXES)


def mamba_decode(params: Params, x_in: torch.Tensor, cfg: ModelConfig, *,
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token. x_in: (b, 1, d) -> (out (b, 1, d), the new state); the
    input state is not changed. The conv is a float32 product over the
    buffer and the token, unlike the full-sequence pass."""
    b = x_in.shape[0]
    n, P = cfg.ssm.state_dim, cfg.ssm.head_dim
    d_inner, H, _ = _dims(cfg)

    proj = (x_in @ params["in_proj"])[:, 0]
    z, xs, B, C, dt = _split_in_proj(cfg, proj)

    xbc = torch.cat([xs, B, C], dim=-1)                          # (b, dc)
    hist = torch.cat([state["conv"], xbc[:, None, :]], dim=1)    # (b, W, dc)
    conv = torch.einsum("bwc,wc->bc", hist.float(),
                        params["conv_w"].float())
    conv = F.silu(conv).to(x_in.dtype)
    new_conv = hist[:, 1:, :]
    xs = conv[..., :d_inner]
    B = conv[..., d_inner:d_inner + n].float()
    C = conv[..., d_inner + n:].float()

    dt = _dt(dt, params["dt_bias"])                              # (b, H)
    A = -torch.exp(params["a_log"])
    a = torch.exp(dt * A[None, :])                               # (b, H)
    xh = xs.reshape(b, H, P).float()

    S = state["ssm"]
    S_new = (a[:, :, None, None] * S
             + (dt[:, :, None, None]
                * xh[..., None] * B[:, None, None, :]))
    y = torch.einsum("bn,bhpn->bhp", C, S_new)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(b, 1, d_inner).to(x_in.dtype)
    y = _gated_norm(z[:, None, :], y, params["norm_z"], cfg.norm_eps)
    out = y @ params["out_proj"]
    return out, {"ssm": S_new, "conv": new_conv}
