"""Meshes (``repro.launch.mesh``).

A ``Mesh`` is a plain record: ``shape``, an ordered mapping of axis name
-> size, and ``devices``, the devices it spans (None for an abstract
mesh). It does not use ``torch.distributed``; the multi-card port backs
it with a ``DeviceMesh``. The sharding rules (``sharding.rules``) read
only ``shape``, so ``make_production_mesh`` gives the production layouts
(16 x 16 over data and model, or 2 x 16 x 16 with pods) as abstract
meshes with no devices, for the rules and the launch plans
(``launch.steps``). A mesh that would place tensors over more than one
device raises ``NotImplementedError``: that waits for the multi-card
port. The others span one device, the card by default (``device``;
"cpu" only when asked, as every entry point of the port).
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.config.base import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.device import DeviceLike, resolve_device

MULTI_CARD = ("a mesh of more than one device: placing tensors over "
              "several devices waits for the multi-card port")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    shape: "OrderedDict[str, int]"
    devices: Optional[Tuple[torch.device, ...]] = None

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device(self) -> torch.device:
        """The one device a step on this mesh runs on."""
        if self.size > 1:
            raise NotImplementedError(f"{dict(self.shape)}: {MULTI_CARD}")
        if not self.devices:
            raise ValueError(f"the abstract mesh {dict(self.shape)} has no "
                             f"device to run on")
        return self.devices[0]


def _mesh(shape: Sequence[int], axes: Sequence[str],
          device: DeviceLike) -> Mesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    if math.prod(shape) > 1:
        raise NotImplementedError(f"{dict(zip(axes, shape))}: {MULTI_CARD}")
    return Mesh(OrderedDict(zip(axes, shape)), (resolve_device(device),))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production layout as an abstract mesh (no devices)."""
    cfg = MULTI_POD if multi_pod else SINGLE_POD
    return Mesh(OrderedDict(zip(cfg.axes, cfg.shape)))


def make_mesh(cfg: MeshConfig, device: DeviceLike = "cuda") -> Mesh:
    return _mesh(cfg.shape, cfg.axes, device)


def make_test_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = "cuda") -> Mesh:
    """A (data, model) mesh over ``device``: 1 x 1 on one device."""
    return _mesh((data, model), ("data", "model"), device)


def make_scoring_mesh(num_devices: Optional[int] = None,
                      device: DeviceLike = "cuda") -> Mesh:
    """The 1-D ("data",) mesh of the streaming data-parallel loops (the
    scoring executor, the offline indexer): every device the process
    owns, ``None`` = all local devices of ``device``'s kind. One device
    is the single-device path; more raise."""
    dev = resolve_device(device)
    n = num_devices or (torch.cuda.device_count() if dev.type == "cuda"
                        else 1)
    return _mesh((n,), ("data",), dev)
