"""Device selection for the port's entry points.

Every public entry point takes ``device`` and defaults to ``"cuda"``.
Without a card it raises: the port never carries on quietly on the CPU.
The CPU runs only when the caller names it, as the tests do; there every
kernel wrapper computes its plain PyTorch version.

On the card float32 matrix products run in full float32: TF32 is off for
both matmuls and cuDNN, set here explicitly, because the reference
tolerance of the scoring and loss kernels (1e-5) is below TF32's three
decimal digits.

Meshes. A mesh backed by a ``torch.distributed`` ``DeviceMesh`` (SPMD
processes, one a mesh position: ``launch.mesh``) is taken by the
``Trainer``, the train, prefill and decode plans, ``generate`` (through
its params), ``device_batch`` and ``restore(shardings=)``, which place
every tensor's shard on its rank's device (``rank_device``);
``spmd_mesh`` finds it in a mesh or a tree of shardings, and refuses a
mesh of more than one device from one controller there. On such a mesh
the dense, MoE and RWKV6 families run (``SPMD_FAMILIES``; an MoE
model's experts over the model axis, ``models.moe.moe_apply_mesh``; an
RWKV6 model's recurrence on each rank's heads,
``kernels.wkv6.ops.RankHeads``); the Mamba2/zamba2, encoder-decoder and
vlm families' ``Trainer`` and plans raise ``NotImplementedError`` naming
the slices that will take them
(``FAMILY_SLICE``), through ``check_one_device``, which accepts a mesh
of one device. The streaming data loops (the scoring executor, the
embedding service and the offline indexer) accept a mesh of any size
over the ``("pod", "data")`` axes from one controller:
``data_mesh_devices`` checks it and lists the devices they run row
shards on.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]

# mesh axes a data-parallel loop shards rows over (the logical "batch"
# rule's axes, ``sharding.rules.DEFAULT_RULES``)
DATA_AXES = ("pod", "data")
MODEL_AXIS_SLICE = ("needs SPMD processes, one a mesh position "
                    "(launch.dist.init_spmd, or torchrun), and a mesh over "
                    "their world (launch.mesh.make_test_mesh or make_mesh)")
# the model families whose Trainer and plans run on a mesh of SPMD ranks
SPMD_FAMILIES = ("dense", "moe", "ssm")
FAMILY_SLICE = (
    "waits for the next model-axis slices: the Mamba2/zamba2, "
    "encoder-decoder and vlm families under a model axis")


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


def rank_device(device: DeviceLike = "cuda",
                rank: Optional[int] = None) -> torch.device:
    """An SPMD rank's own device: ``cuda:{rank % device_count}`` (ranks
    share the cards in turn when there are more ranks than cards), or
    the CPU when ``device`` names it. ``rank`` defaults to this
    process's rank in the initialised process group (0 without one)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return resolve_device(dev)
    if rank is None:
        import torch.distributed as dist
        rank = dist.get_rank() if dist.is_initialized() else 0
    resolve_device("cuda")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def on_device(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device (nothing
    for the CPU): the kernels launch on the current device's stream, so
    a row shard's forward runs under its own device."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _meshes(mesh: Any, shardings: Any) -> list:
    """``mesh`` and the mesh of every sharding in the ``shardings`` tree
    (a dict, list or tuple of ``NamedSharding``s)."""
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
    return meshes


def _size(m: Any) -> int:
    """A mesh's device count; an object without a mesh's ``shape``
    counts as more than one."""
    return math.prod(dict(getattr(m, "shape", {"?": 2})).values())


def check_one_device(what: str, mesh: Any = None, shardings: Any = None,
                     waits_for: str = MODEL_AXIS_SLICE) -> None:
    """Raise ``NotImplementedError`` (``what`` ``waits_for`` ...) when
    ``mesh``, or the mesh of any sharding in ``shardings``, spans more
    than one device."""
    for m in _meshes(mesh, shardings):
        if _size(m) > 1:
            raise NotImplementedError(
                f"{what}: a mesh of more than one device "
                f"({dict(getattr(m, 'shape', {'?': 2}))}) {waits_for}")


def spmd_mesh(what: str, mesh: Any = None, shardings: Any = None):
    """The ``DeviceMesh`` that ``mesh`` and ``shardings`` place over (SPMD
    processes), or None for no mesh or a mesh of one device. A mesh of
    more than one device without a ``DeviceMesh`` (one controller, or not
    a mesh) raises ``NotImplementedError``; meshes of two worlds raise
    ``ValueError``."""
    found = None
    for m in _meshes(mesh, shardings):
        dm = getattr(m, "device_mesh", None)
        if dm is None:
            check_one_device(what, m)
            continue
        if found is not None and dm is not found:
            raise ValueError(f"{what}: shardings over two device meshes")
        found = dm
    return found


def data_mesh_devices(what: str, mesh: Any,
                      device: torch.device) -> Tuple[torch.device, ...]:
    """The devices of ``mesh``, in its order, that a streaming
    data-parallel loop runs row shards on; ``()`` for no mesh or a mesh
    of one device (the loop's single-device path on ``device``).

    Raises ``NotImplementedError`` for an object without a mesh's
    ``shape`` and for an axis other than "pod" or "data" over one device
    (the model axis waits for its slice), ``ValueError`` for an abstract
    mesh (no devices) or one whose devices are not of ``device``'s kind.
    A device may repeat: its row shards share the card."""
    if mesh is None:
        return ()
    shape = getattr(mesh, "shape", None)
    if not hasattr(shape, "items"):
        raise NotImplementedError(f"{what}: {mesh!r} is not a mesh "
                                  f"(launch.mesh.Mesh)")
    size = math.prod(shape.values())
    if size == 1:
        return ()
    model = {a: n for a, n in shape.items() if a not in DATA_AXES and n > 1}
    if model:
        raise NotImplementedError(
            f"{what}: a mesh of more than one device over the axes "
            f"{model}: a streaming data loop runs row shards over "
            f"(\"pod\", \"data\") from one controller; the model-axis "
            f"path (the Trainer, the train plan) runs under SPMD "
            f"processes (launch.dist)")
    devices = tuple(getattr(mesh, "devices", None) or ())
    if len(devices) != size:
        raise ValueError(f"{what}: the mesh {dict(shape)} has "
                         f"{len(devices)} devices to run on, not {size}")
    other = [d for d in devices if d.type != device.type]
    if other:
        raise ValueError(f"{what}: the mesh holds {other[0]}, the loop "
                         f"runs on {device.type} devices")
    return devices
