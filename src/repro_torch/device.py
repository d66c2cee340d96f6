"""Device selection for the port's entry points.

Every public entry point takes ``device`` and defaults to ``"cuda"``.
Without a card it raises: the port never carries on quietly on the CPU.
The CPU runs only when the caller names it, as the tests do; there every
kernel wrapper computes its plain PyTorch version.

On the card float32 matrix products run in full float32: TF32 is off for
both matmuls and cuDNN, set here explicitly, because the reference
tolerance of the scoring and loss kernels (1e-5) is below TF32's three
decimal digits.

``check_one_device`` is how the entry points that place tensors over
a mesh's model axis treat the JAX package's ``mesh`` or ``shardings``
(the ``Trainer``, ``device_batch``, ``restore(shardings=)`` and the
launch plans): a mesh of one device is accepted (the entry point runs
on its ``device``), a mesh of more raises ``NotImplementedError``; they
wait for the model-axis slice (``torch.distributed``'s ``DeviceMesh``
under SPMD processes). The streaming data loops (the scoring executor,
the embedding service and the offline indexer) accept a mesh of any
size over the ``("pod", "data")`` axes: ``data_mesh_devices`` checks it
and lists the devices they run row shards on, from one process.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]

# mesh axes a data-parallel loop shards rows over (the logical "batch"
# rule's axes, ``sharding.rules.DEFAULT_RULES``)
DATA_AXES = ("pod", "data")
MODEL_AXIS_SLICE = ("waits for the model-axis slice (torch.distributed's "
                    "DeviceMesh under SPMD processes)")


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


def on_device(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device (nothing
    for the CPU): the kernels launch on the current device's stream, so
    a row shard's forward runs under its own device."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


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
                f"{what}: a mesh of more than one device ({shape}) "
                f"{MODEL_AXIS_SLICE}")


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
            f"{model} {MODEL_AXIS_SLICE}")
    devices = tuple(getattr(mesh, "devices", None) or ())
    if len(devices) != size:
        raise ValueError(f"{what}: the mesh {dict(shape)} has "
                         f"{len(devices)} devices to run on, not {size}")
    other = [d for d in devices if d.type != device.type]
    if other:
        raise ValueError(f"{what}: the mesh holds {other[0]}, the loop "
                         f"runs on {device.type} devices")
    return devices
