"""Device selection for the port's entry points.

Every public entry point takes ``device`` and defaults to ``"cuda"``.
Without a card it raises: the port never carries on quietly on the CPU.
The CPU runs only when the caller names it, as the tests do; there every
kernel wrapper computes its plain PyTorch version.

On the card float32 matrix products run in full float32: TF32 is off for
both matmuls and cuDNN, set here explicitly, because the reference
tolerance of the scoring and loss kernels (1e-5) is below TF32's three
decimal digits.

``check_one_device`` is how entry points that take the JAX package's
``mesh`` or ``shardings`` treat them: a mesh of one device is accepted
(the entry point runs on its ``device``), a mesh of more raises
``NotImplementedError`` until the multi-card port.
"""
from __future__ import annotations

import math
from typing import Any, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_one_device(what: str, mesh: Any = None,
                     shardings: Any = None) -> None:
    """Raise ``NotImplementedError`` when ``mesh``, or the mesh of any
    sharding in the ``shardings`` tree (a dict, list or tuple of
    ``NamedSharding``s), spans more than one device; an object without a
    mesh's ``shape`` counts as more."""
    meshes = [] if mesh is None else [mesh]
    stack = [shardings]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif node is not None:
            meshes.append(node.mesh)
    for m in meshes:
        shape = dict(getattr(m, "shape", {"?": 2}))
        if math.prod(shape.values()) > 1:
            raise NotImplementedError(
                f"{what}: a mesh of more than one device ({shape}) waits "
                f"for the multi-card port")
