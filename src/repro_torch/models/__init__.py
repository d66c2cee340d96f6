"""The port's models (``repro.models``): the decoder-only LM of the
offline embedding path (dense attention and RWKV6 blocks), and the carry
of JAX weights into it."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_map
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
    type unless ``dtype`` is given."""
    return tree_map(lambda a: _leaf_to_torch(a).to(device=device,
                                                   dtype=dtype), tree)
