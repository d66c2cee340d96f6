"""Device selection for the port's entry points.

Every public entry point takes ``device`` and defaults to ``"cuda"``.
Without a card it raises: the port never carries on quietly on the CPU.
The CPU runs only when the caller names it, as the tests do; there every
kernel wrapper computes its plain PyTorch version.

On the card float32 matrix products run in full float32: TF32 is off for
both matmuls and cuDNN, set here explicitly, because the reference
tolerance of the scoring and loss kernels (1e-5) is below TF32's three
decimal digits.
"""
from __future__ import annotations

from typing import Union

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
