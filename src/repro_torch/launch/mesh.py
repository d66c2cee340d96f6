"""Meshes (``repro.launch.mesh``).

A ``Mesh`` is a record: ``shape``, an ordered mapping of axis name ->
size, ``devices``, the devices it spans in row-major order over
``shape`` (None for an abstract mesh), and, under SPMD processes,
``device_mesh``, the ``torch.distributed`` ``DeviceMesh`` over them.
The sharding rules (``sharding.rules``) read only ``shape``, so
``make_production_mesh`` gives the production layouts (16 x 16 over
data and model, or 2 x 16 x 16 with pods) as abstract meshes with no
devices, for the rules and the launch plans (``launch.steps``).

Two kinds of mesh run:

  * SPMD (a process group is initialised: ``launch.dist.init_spmd``, or
    ``torchrun``): ``make_mesh(cfg)`` and ``make_test_mesh(data,
    model)`` build a ``DeviceMesh`` over the world, one rank a mesh
    position, and raise ``ValueError`` naming both counts when the
    mesh's size is not the world's. Each rank runs on its own device
    (``Mesh.device``: ``device.rank_device``, ``cuda:{rank %
    device_count}``, so ranks may share a card), holding its shard of
    every tensor as a DTensor. The ``Trainer``, the train plan,
    ``device_batch`` and ``restore(shardings=)`` run on such a mesh,
    model axis included.
  * One controller (no process group): a mesh over the ``("pod",
    "data")`` axes may span several devices of one process: the
    streaming data loops (``engine.executor``, ``engine.ingest``,
    ``runtime.serve_loop``) run a row shard on each, as the JAX
    package's ``shard_map`` and ``device_put`` do. The constructors take
    distinct devices of ``device``'s kind (``cuda:0`` .. ``cuda:n-1``)
    and raise ``ValueError`` when the process has fewer; they never
    repeat a device. A mesh that repeats one (the counterpart of JAX's
    ``--xla_force_host_platform_device_count``, as the CPU tests use it)
    is built directly, ``Mesh(OrderedDict(data=4), (cpu,) * 4)``. A
    model axis over 1 raises ``NotImplementedError`` there (it needs
    SPMD processes), and so does ``Mesh.device`` on a mesh of more than
    one device (a launch plan runs on one device, or on a rank's).
    ``make_scoring_mesh`` always builds this kind.

The CPU runs only when asked (``device="cpu"``), as in every entry
point of the port.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.device import (DATA_AXES, DeviceLike, rank_device,
                                resolve_device)

SPMD_ONLY = ("a model axis over 1 runs under SPMD processes, one a mesh "
             "position: start the process group first "
             "(launch.dist.init_spmd, or torchrun)")
MULTI_CARD = ("a mesh of more than one device from one controller: a "
              "step runs on one device, or on each rank's under SPMD "
              "processes (" + SPMD_ONLY + ")")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    shape: "OrderedDict[str, int]"
    devices: Optional[Tuple[torch.device, ...]] = None
    device_mesh: Any = None

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device(self) -> torch.device:
        """The device a step on this mesh runs on: this rank's own under
        SPMD processes, else the mesh's one device."""
        if self.device_mesh is not None:
            return rank_device(self.device_mesh.device_type)
        if self.size > 1:
            raise NotImplementedError(f"{dict(self.shape)}: {MULTI_CARD}")
        if not self.devices:
            raise ValueError(f"the abstract mesh {dict(self.shape)} has no "
                             f"device to run on")
        return self.devices[0]


def _devices(n: int, device: DeviceLike) -> Tuple[torch.device, ...]:
    """``n`` distinct devices of ``device``'s kind, from index 0 (the one
    CPU device for ``n = 1``)."""
    dev = resolve_device(device)
    if n == 1:
        return (dev,)
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n > have:
        raise ValueError(f"a mesh of {n} {dev.type} devices: the process "
                         f"has {have}")
    return tuple(torch.device(dev.type, i) for i in range(n))


def _spmd_mesh(shape: Sequence[int], axes: Sequence[str],
               device: DeviceLike) -> Mesh:
    """A ``DeviceMesh``-backed mesh over the world of the initialised
    process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    size = math.prod(shape)
    if size != world:
        raise ValueError(f"a mesh {dict(zip(axes, shape))} of {size} "
                         f"devices over a world of {world} processes")
    kind = torch.device(device).type
    dm = init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(OrderedDict(zip(axes, shape)),
                tuple(rank_device(kind, r) for r in range(world)), dm)


def _mesh(shape: Sequence[int], axes: Sequence[str],
          device: DeviceLike, spmd: bool = True) -> Mesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    from repro_torch.launch.dist import spmd as spmd_running
    if spmd and spmd_running():
        return _spmd_mesh(shape, axes, device)
    model = {a: n for a, n in zip(axes, shape)
             if a not in DATA_AXES and n > 1}
    if model:
        raise NotImplementedError(f"{dict(zip(axes, shape))}: the axes "
                                  f"{model}: {SPMD_ONLY}")
    return Mesh(OrderedDict(zip(axes, shape)),
                _devices(math.prod(shape), device))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production layout as an abstract mesh (no devices)."""
    cfg = MULTI_POD if multi_pod else SINGLE_POD
    return Mesh(OrderedDict(zip(cfg.axes, cfg.shape)))


def make_mesh(cfg: MeshConfig, device: DeviceLike = "cuda") -> Mesh:
    """``cfg``'s mesh: over the world under SPMD processes, else over
    distinct devices of one controller."""
    return _mesh(cfg.shape, cfg.axes, device)


def make_test_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = "cuda") -> Mesh:
    """A (data, model) mesh: over the world under SPMD processes (data x
    model ranks); else over ``data`` distinct devices of one
    controller, where ``model`` over 1 raises."""
    return _mesh((data, model), ("data", "model"), device)


def make_scoring_mesh(num_devices: Optional[int] = None,
                      device: DeviceLike = "cuda") -> Mesh:
    """The 1-D ("data",) mesh of the streaming data-parallel loops (the
    scoring executor, the offline indexer): ``num_devices`` distinct
    devices of ``device``'s kind, ``None`` = every one the process owns
    (the one CPU device). One device is the loops' single-device path."""
    dev = resolve_device(device)
    n = num_devices or (torch.cuda.device_count() if dev.type == "cuda"
                        else 1)
    return _mesh((n,), ("data",), dev, spmd=False)
