"""The hand-written kernels as single operators, charged at their own
work by the cost counter (``launch.hlo_analysis``).

Each wrapper that launches a kernel (``kernels/*/ops.py``) registers its
launch as a ``torch.library.custom_op`` named ``repro_torch::<kernel>``
with a fake (meta) implementation that returns empty outputs of the
right shapes, and a cost function: the work the kernel itself does (the
arithmetic of ``PERF.md``'s bound column; flash's over the K/V tiles it
visits, not the exact pairs). The operator's real
implementation is the wrapper's: the kernel on the card (counted in
``KERNEL.launches``), the plain version on the CPU. A call goes through
the operator on meta tensors and while a dispatch mode such as the cost
counter is active (``through_op``), so the counter sees one operator a
call on every device, never the plain version's ops, and meta tensors
take the fake; any other call runs the operator's body directly,
without the operator's dispatch on the host. A CPU call that needs a gradient runs
the differentiable plain version; a CUDA one raises, since the kernels
have no backward (``plain_for_grad``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode


@dataclass(frozen=True)
class KernelWork:
    """What one kernel call does: FLOPs (``products`` of them in matrix
    products), transcendental operations, and the bytes it must move
    (each input read once, each output written once)."""
    flops: float
    products: float
    transcendental: float
    bytes: float


# op name ("repro_torch::flash_attention_fwd") -> (args, kwargs) -> work
COSTS: Dict[str, Callable[..., KernelWork]] = {}


def register_cost(op, cost: Callable[..., KernelWork]) -> None:
    """Charge every call of the custom op ``op`` at ``cost(*args,
    **kwargs)``."""
    COSTS[op._qualname] = cost


def cost_of(func) -> Optional[Callable[..., KernelWork]]:
    """The cost function of an ``OpOverload``, or None for a library
    op."""
    return COSTS.get(func._schema.name)


def nbytes(*tensors: torch.Tensor) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def through_op(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` goes through its operator: on meta
    tensors (the fake gives the outputs) and while a dispatch mode is
    active (the cost counter charges the kernel's work). The mode stack
    reaches the autograd engine's threads, where a card backward's
    recompute (remat) calls the kernels; a context variable would not."""
    return t.is_meta or _get_current_dispatch_mode() is not None


def plain_for_grad(kernel: str, *tensors: torch.Tensor,
                   hint: str = "") -> bool:
    """True when autograd would record a call on these CPU inputs: the
    call then runs the differentiable plain version. On CUDA inputs such
    a call raises, since the kernel has no backward and a launch would
    leave the inputs with no gradient."""
    if not (torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors)):
        return False
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel has no backward and its inputs "
            f"require grad{hint}")
    return True
