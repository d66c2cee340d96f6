"""Logical-axis sharding rules with divisibility fallback
(``repro.sharding.rules``).

Every tensor dimension is annotated with a *logical* name ("batch",
"heads", "mlp", ...). A rule table maps logical names to mesh axes.
``RuleSet.spec`` resolves a tuple of logical names into a ``P`` (the
partition spec: one mesh-axis assignment a dimension) against a mesh,
**dropping** any mesh axis that does not evenly divide the dimension
(replicating instead) and recording the fallback, never using one mesh
axis twice, and trimming trailing ``None``s, as the JAX package
resolves them. A ``RuleSet`` reads only ``mesh.shape`` (an ordered
mapping of axis -> size), so it resolves an abstract production mesh
with no devices (``launch.mesh.make_production_mesh``) as well as the
one-device mesh a plan runs on. ``P`` and ``NamedSharding`` are the
port's own records of JAX's ``PartitionSpec`` and ``NamedSharding``.
``shard_rows`` cuts a host array into the row shards of the logical
``("batch", None)`` spec, one a mesh device, which the streaming data
loops place each on its device (``jax.device_put`` of a
``NamedSharding`` in the JAX package). Under SPMD processes
(``launch.mesh.Mesh`` backed by a ``DeviceMesh``) ``placements`` turns
a ``NamedSharding`` into DTensor placements, one a mesh dimension, and
``place`` puts a full tensor there (each rank keeps its own shard:
``jax.device_put`` of the sharding); ``dim_range`` and ``local_range``
give a mesh position's (offset, length) along one dimension, the slice
``devices_indices_map`` gives it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

AxisAssignment = Union[str, Tuple[str, ...], None]

# Default logical->mesh rules. "fsdp" behaviour: weights' embed/mlp dims are
# additionally sharded over the data axis when enabled (ZeRO-3 style).
DEFAULT_RULES: Dict[str, AxisAssignment] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "act_mlp": "model",
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_vocab": "model",
    "kv_seq": None,
    # weights (tensor parallel)
    "heads": "model",
    "kv_heads": "model",
    "qkv_out": "model",      # fused head*dim output dim
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "head_dim": None,
    "state": None,           # SSM state dim
    "conv": None,
    "inner": "model",        # mamba/rwkv inner channels
    # fsdp shard dim for weights (opt-in per arch)
    "fsdp_embed": None,
}

FSDP_RULES: Dict[str, AxisAssignment] = dict(DEFAULT_RULES)
FSDP_RULES.update({"fsdp_embed": "data"})


class P(tuple):
    """A partition spec: one entry a tensor dimension, each a mesh axis,
    a tuple of mesh axes, or None (replicated). Equal, as a tuple, to
    the JAX ``PartitionSpec`` of the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A (mesh, spec) record: where each dimension of a tensor lies."""
    mesh: Any
    spec: P


@dataclasses.dataclass
class FallbackEvent:
    logical: str
    dim: int
    axis: str
    axis_size: int


class RuleSet:
    """Resolves logical dimension names into partition specs for a mesh."""

    def __init__(self, mesh, rules: Optional[Dict[str, AxisAssignment]] = None,
                 overrides: Optional[Dict[str, AxisAssignment]] = None):
        self.mesh = mesh
        self.rules: Dict[str, AxisAssignment] = dict(rules or DEFAULT_RULES)
        if overrides:
            self.rules.update(overrides)
        self.fallbacks: List[FallbackEvent] = []

    def _axis_size(self, axis: str) -> int:
        return self.mesh.shape.get(axis, 1)

    def _resolve_dim(self, logical: Optional[str], dim: Optional[int],
                     used: set) -> AxisAssignment:
        if logical is None:
            return None
        assignment = self.rules.get(logical)
        if assignment is None:
            return None
        axes = ((assignment,) if isinstance(assignment, str)
                else tuple(assignment))
        kept: List[str] = []
        size_so_far = 1
        for ax in axes:
            if ax not in self.mesh.shape or ax in used:
                continue
            axsz = self._axis_size(ax)
            if dim is not None and dim % (size_so_far * axsz) != 0:
                self.fallbacks.append(FallbackEvent(logical, dim, ax, axsz))
                continue
            kept.append(ax)
            size_so_far *= axsz
        used.update(kept)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else tuple(kept)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> P:
        """Resolve logical axis names (+ optional concrete shape) to a
        spec."""
        used: set = set()
        parts = [self._resolve_dim(name, None if shape is None else shape[i],
                                   used)
                 for i, name in enumerate(logical_axes)]
        # trim trailing Nones for a tidy spec
        while parts and parts[-1] is None:
            parts.pop()
        return P(*parts)

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical_axes, shape))

    def fallback_report(self) -> List[str]:
        seen = set()
        out = []
        for ev in self.fallbacks:
            key = (ev.logical, ev.dim, ev.axis)
            if key in seen:
                continue
            seen.add(key)
            out.append(
                f"replicated {ev.logical}(dim={ev.dim}) over mesh axis "
                f"{ev.axis!r}(size={ev.axis_size}): not divisible")
        return out


def placements(sharding: NamedSharding, shape: Sequence[int]) -> list:
    """DTensor placements of ``sharding`` for a tensor of ``shape``, one
    a mesh dimension in the mesh's axis order: ``Shard(i)`` where tensor
    dimension ``i``'s spec entry names the axis, ``Replicate()`` where
    none does or the axis has one device (its one shard is the whole
    dimension). An entry of several axes (``("pod", "data")``) shards its
    dimension over them major to minor, which DTensor does in mesh
    order, so the entry must list them in mesh order; each sharded
    dimension must split evenly (``RuleSet`` drops an axis that does
    not divide, so a resolved spec always does)."""
    from torch.distributed.tensor import Replicate, Shard
    axes = list(sharding.mesh.shape)
    out = [Replicate() for _ in axes]
    for i, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [axes.index(n) for n in names]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"{sharding.spec}: dimension {i} lists the axes {names} out "
                f"of the mesh's order {tuple(axes)}")
        ways = math.prod(sharding.mesh.shape[n] for n in names)
        if shape[i] % ways:
            raise ValueError(f"{sharding.spec}: dimension {i} of "
                             f"{tuple(shape)} does not split {ways} ways")
        for j in idx:
            if sharding.mesh.shape[axes[j]] > 1:
                out[j] = Shard(i)
    return out


def place(t, sharding: NamedSharding):
    """A full tensor (the same on every rank) as a DTensor laid out by
    ``sharding`` on its mesh's ``device_mesh``: each rank keeps its
    slice, nothing is sent. A DTensor is redistributed there."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh = sharding.mesh
    pl = placements(sharding, t.shape)
    if isinstance(t, DTensor):
        return t.redistribute(mesh.device_mesh, pl)
    return distribute_tensor(t, mesh.device_mesh, pl, src_data_rank=None)


def block_index(device_mesh, dims) -> int:
    """This rank's block of a tensor dimension sharded over the
    ``DeviceMesh`` dimensions ``dims``, major to minor (DTensor's order
    of the shards of one dimension)."""
    coord = device_mesh.get_coordinate()
    idx = 0
    for d in dims:
        idx = idx * device_mesh.size(d) + coord[d]
    return idx


def dim_range(mesh_shape, entry: AxisAssignment, coordinate,
              size: int) -> Tuple[int, int]:
    """(offset, length) of the block of a tensor dimension of ``size``
    that the mesh position ``coordinate`` (axis -> index) holds, where
    the dimension's spec entry is ``entry`` (None, one mesh axis, or
    several) over a mesh of ``mesh_shape`` (axis -> size, in the mesh's
    order): the entry's axes split the dimension major to minor in the
    mesh's order, as ``placements`` and ``block_index`` take them (an
    entry out of that order raises ``NotImplementedError``; one that does
    not split ``size`` evenly, ``ValueError``). A position's slice is the
    one ``NamedSharding.devices_indices_map`` gives it."""
    names = (() if entry is None else (entry,) if isinstance(entry, str)
             else tuple(entry))
    axes = list(mesh_shape)
    idx = [axes.index(n) for n in names]
    if idx != sorted(idx):
        raise NotImplementedError(f"{names}: out of the mesh's order "
                                  f"{tuple(axes)}")
    ways = math.prod(mesh_shape[n] for n in names)
    if size % ways:
        raise ValueError(f"a dimension of {size} does not split {ways} ways "
                         f"over {names}")
    block = 0
    for n in names:
        block = block * mesh_shape[n] + coordinate[n]
    length = size // ways
    return block * length, length


def local_range(x, dim: int) -> Tuple[int, int]:
    """(offset, length) of this rank's block of dimension ``dim`` of the
    DTensor ``x`` (``dim_range`` over the mesh dimensions whose
    placement shards ``dim``)."""
    dm = x.device_mesh
    names = dm.mesh_dim_names or tuple(str(i) for i in range(dm.ndim))
    coord = dm.get_coordinate()
    entry = tuple(names[i] for i, p in enumerate(x.placements)
                  if p.is_shard(dim))
    return dim_range({n: dm.size(i) for i, n in enumerate(names)},
                     entry or None, dict(zip(names, coord)), x.shape[dim])


def row_shard_ids(mesh, shape: Sequence[int]) -> Tuple[List[int], int]:
    """Where the rows of an array of ``shape`` lie on ``mesh`` under the
    logical ``("batch", None, ...)`` spec: each mesh device's row-shard
    index, in the mesh's device order (row-major over ``mesh.shape``),
    and the number of shards. The spec's mesh axes split the rows with
    the first one major, as a ``PartitionSpec`` entry of several axes
    does (a pod x data mesh over both), and every device of an axis the
    spec leaves out holds the same shard; where the rule falls back to
    replication there is one shard, on every device."""
    spec = RuleSet(mesh).spec(("batch",) + (None,) * (len(shape) - 1),
                              shape)
    row = spec[0] if len(spec) else None
    axes = () if row is None else ((row,) if isinstance(row, str)
                                   else tuple(row))
    names, sizes = list(mesh.shape), list(mesh.shape.values())
    ids = []
    for flat in range(math.prod(sizes)):
        coords = {}
        for name, size in zip(reversed(names), reversed(sizes)):
            flat, coords[name] = divmod(flat, size)
        idx = 0
        for ax in axes:
            idx = idx * mesh.shape[ax] + coords[ax]
        ids.append(idx)
    return ids, math.prod(mesh.shape[ax] for ax in axes)


def shard_rows(mesh, arr) -> list:
    """A host array (rows first) -> one row slice a mesh device, in the
    mesh's device order (``row_shard_ids``): views, no copies."""
    ids, n = row_shard_ids(mesh, arr.shape)
    per = arr.shape[0] // n
    return [arr[i * per:(i + 1) * per] for i in ids]


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of names and Nones (``()``
    for a 0-d tensor)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def map_axes(fn: Callable, axes_tree, *trees):
    """``fn(axes, *leaves)`` at every leaf of a logical-axes tree, with
    the matching subtrees of ``trees`` (dictionaries, lists, tuples and
    NamedTuples of the same layout), as ``jax.tree.map`` with axes tuples
    as leaves."""
    if is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        out = [map_axes(fn, v, *(t[i] for t in trees))
               for i, v in enumerate(axes_tree)]
        if hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*out)
        return type(axes_tree)(out)
    raise TypeError(f"not a logical-axes tree node: {axes_tree!r}")


def tree_shardings(ruleset: RuleSet, logical_tree, shape_tree):
    """A tree of logical-axis tuples (+ the matching tree of tensors or
    meta tensors, or None leaves) -> the tree of ``NamedSharding``s."""
    def one(axes, t):
        return ruleset.sharding(axes, None if t is None else t.shape)
    return map_axes(one, logical_tree, shape_tree)
