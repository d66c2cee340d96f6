"""The port's models (``repro.models``): the decoder-only LM of the
offline embedding path, the LM judge and decode (dense attention, MoE
and RWKV6 blocks), and the carry of JAX weights and caches into it."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import build_model  # noqa: F401
from repro_torch.models.transformer import TransformerLM  # noqa: F401


def _leaf_to_torch(leaf) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: carry the raw 2-byte words
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_jax(tree, device, dtype=None):
    """The JAX ``TransformerLM`` param tree (numpy or JAX leaves) -> the
    port's, on ``device``. The layout is the same; each leaf keeps its
    type unless ``dtype`` is given, except an MoE router
    (``blocks.p<i>.moe.router``), which stays float32 as both packages
    draw and run it. A JAX decode cache (``prefill``'s or
    ``init_cache``'s) has the port's layout too and is carried the same
    way, unchanged."""
    def carry(sub, in_moe):
        out = {}
        for key, val in sub.items():
            if isinstance(val, dict):
                out[key] = carry(val, key == "moe")
                continue
            leaf_dtype = torch.float32 if (in_moe and key == "router") \
                else dtype
            out[key] = _leaf_to_torch(val).to(device=device,
                                              dtype=leaf_dtype)
        return out
    return carry(tree, False)
