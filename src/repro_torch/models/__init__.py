"""The port's models (``repro.models``): the decoder-only LM of the
offline embedding path, the LM judge and decode (dense attention, MoE,
RWKV6, Mamba2 and shared attention blocks), the encoder-decoder LM
(prefill and decode over stubbed frame embeddings), their training
losses and step functions, and the carry of JAX weights and caches into
them."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.encdec import EncDecLM  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    build_model,
    input_axes,
    input_specs,
    make_decode_step,
    make_forward_loss,
    make_prefill_step,
)
from repro_torch.models.transformer import TransformerLM  # noqa: F401


def _leaf_to_torch(leaf) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: carry the raw 2-byte words
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


# leaves both packages draw and run in float32 whatever the model's type,
# by (parent key, key): the MoE router, the Mamba2 decay, skip and dt
# bias, and the RWKV6 time-mix's decay bias, bonus and group-norm scale;
# and the decode caches' recurrent states (Mamba2's SSD, RWKV6's WKV)
F32_LEAVES = {("moe", "router"), ("mamba", "a_log"), ("mamba", "d_skip"),
              ("mamba", "dt_bias"), ("time", "w0"), ("time", "u"),
              ("time", "ln_x")}
F32_CACHE_KEYS = {"ssm", "wkv"}


def params_from_jax(tree, device, dtype=None):
    """A JAX ``TransformerLM`` or ``EncDecLM`` param tree (numpy or JAX
    leaves) -> the port's, on ``device``. The layout is the same; each
    leaf keeps its type unless ``dtype`` is given, except the leaves of
    ``F32_LEAVES`` (an MoE router, a Mamba2 block's ``a_log``,
    ``d_skip`` and ``dt_bias``, an RWKV6 time-mix's ``w0``, ``u`` and
    ``ln_x``), which stay float32 as both packages draw and run them. A
    JAX decode cache (``prefill``'s or ``init_cache``'s; an
    ``EncDecLM``'s {"self", "cross"}) has the port's layout too and is
    carried the same way, its Mamba2 ``ssm`` and RWKV6 ``wkv`` states
    kept float32: a carry in the model's type would change what the
    model computes."""
    def carry(sub, parent):
        out = {}
        for key, val in sub.items():
            if isinstance(val, dict):
                out[key] = carry(val, key)
                continue
            keep = (parent, key) in F32_LEAVES or key in F32_CACHE_KEYS
            out[key] = _leaf_to_torch(val).to(
                device=device, dtype=torch.float32 if keep else dtype)
        return out
    return carry(tree, None)
