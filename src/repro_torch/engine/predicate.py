"""Declarative predicate algebra over a document collection
(a copy of ``repro.engine.predicate``).

A ``SemanticPredicate`` is one LLM predicate — a query embedding plus
the oracle that can label documents against it. Its ``key``
fingerprints ``(e_q, oracle)`` exactly as the JAX package does (``sha1``
of the float32 bytes, first 12 hex digits, then ``id(oracle)``), and the
engine derives its sample streams from that digest, so the same
embedding draws the same samples in both packages. Predicates compose
with ``&``, ``|`` and ``~`` into an expression tree the engine compiles
into a cost-ordered plan (QUEST-style: most decisive leaf first,
decided documents short-circuit out of later leaves).

Evaluation is three-valued (Kleene logic): a document's value under a
node is TRUE/FALSE once enough leaves have been resolved to decide it,
UNKNOWN until then. UNKNOWN documents are exactly the ones the engine
still has to spend proxy/oracle budget on.

Wire format: every predicate serializes to a pure-JSON AST via
``to_wire()`` and reconstructs via ``from_wire()``; the grammar and the
limits are the JAX package's, so a payload made by either package
decodes in the other to the same leaf keys. Leaves carry their query
either as a raw embedding (base64 of the float32 bytes — *bit-exact*,
so the reconstructed leaf has the same cache ``key`` and the engine
makes identical decisions) or as a ``prompt`` string resolved by a
server-side embedder; oracles never travel — leaves reference them by
name against a server-side registry.

``SemanticTopK`` builds, validates and travels on the wire here; the
port's engine does not execute it yet (``filter`` raises).
"""
from __future__ import annotations

import base64
import hashlib
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

TRUE = np.int8(1)
FALSE = np.int8(0)
UNKNOWN = np.int8(-1)

# version 2 added the "topk" root operator (SemanticTopK)
WIRE_VERSION = 2
# bombs a client could mail in: a deeply right-nested AST recurses the
# decoder, a wide one explodes the plan — both are rejected up front
MAX_WIRE_DEPTH = 32
MAX_WIRE_NODES = 512
# k is bounded on the wire: a mask over N docs can never need more
MAX_WIRE_TOPK = 1_000_000_000


class WireFormatError(ValueError):
    """Malformed predicate AST received over the wire."""


def kleene_not(v: np.ndarray) -> np.ndarray:
    out = np.where(v == UNKNOWN, UNKNOWN, 1 - v)
    return out.astype(np.int8)


def kleene_and(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.full(a.shape, UNKNOWN, np.int8)
    out[(a == FALSE) | (b == FALSE)] = FALSE
    out[(a == TRUE) & (b == TRUE)] = TRUE
    return out


def kleene_or(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.full(a.shape, UNKNOWN, np.int8)
    out[(a == TRUE) | (b == TRUE)] = TRUE
    out[(a == FALSE) & (b == FALSE)] = FALSE
    return out


class Predicate:
    """Expression-tree node. Subclasses: SemanticPredicate, And, Or, Not."""

    def __and__(self, other: "Predicate") -> "Predicate":
        return And(self, other)

    def __or__(self, other: "Predicate") -> "Predicate":
        return Or(self, other)

    def __invert__(self) -> "Predicate":
        return Not(self)

    def leaves(self) -> List["SemanticPredicate"]:
        """Unique leaves in first-appearance order (dedup by key)."""
        seen: Dict[str, SemanticPredicate] = {}
        self._collect(seen)
        return list(seen.values())

    def _collect(self, seen: Dict[str, "SemanticPredicate"]) -> None:
        raise NotImplementedError

    def evaluate(self, leaf_values: Mapping[str, np.ndarray]) -> np.ndarray:
        """Kleene-evaluate given per-leaf int8 value arrays keyed by
        leaf key; leaves absent from the mapping count as UNKNOWN."""
        raise NotImplementedError

    def plan(self, selectivity: Mapping[str, float]
             ) -> Tuple[List["SemanticPredicate"], float]:
        """Compile a cost-ordered execution plan.

        ``selectivity`` estimates each leaf's positive rate. Returns the
        leaves in execution order plus this node's estimated positive
        rate. AND nodes run their most selective child first (it rules
        out the most documents, so later children see the smallest
        pending set); OR nodes run their least selective child first
        (it rules documents *in*). Estimates assume independence — they
        only order the plan, never affect correctness.
        """
        raise NotImplementedError

    def to_wire(self, oracles: Optional[Mapping[str, object]] = None
                ) -> Dict:
        """Serialize to the pure-JSON wire AST.

        ``oracles`` is the name -> oracle registry the *receiving* side
        holds (same mapping ``from_wire`` takes); each leaf's oracle is
        resolved to its name by identity (the leaf's own oracle or, for
        a leaf built over a ``CachedOracle``, its ``inner``). Without a
        registry, an oracle exposing a ``wire_name`` attribute
        self-identifies. Unresolvable oracles raise ``WireFormatError``
        — an oracle is a priced labeling service and cannot travel in a
        request body.
        """
        reverse: Dict[int, str] = {}
        for name, oracle in (oracles or {}).items():
            reverse[id(oracle)] = name
            inner = getattr(oracle, "inner", None)
            if inner is not None:
                reverse.setdefault(id(inner), name)
        return self._to_wire(reverse)

    def _to_wire(self, reverse: Dict[int, str]) -> Dict:
        raise NotImplementedError


class SemanticPredicate(Predicate):
    """One LLM predicate: query embedding + oracle labeler.

    The ``key`` fingerprints (e_q, oracle) so the engine can cache the
    trained proxy and reuse it across queries touching the same
    predicate; two structurally identical leaves inside one expression
    collapse into a single evaluation.
    """

    def __init__(self, e_q: np.ndarray, oracle, name: Optional[str] = None):
        self.e_q = np.asarray(e_q, np.float32)
        if self.e_q.ndim != 1:
            raise ValueError(f"e_q must be (D,), got {self.e_q.shape}")
        self.oracle = oracle
        digest = hashlib.sha1(self.e_q.tobytes()).hexdigest()[:12]
        self.key = f"{digest}:{id(oracle)}"
        self.name = name or f"pred-{digest[:6]}"

    def _collect(self, seen):
        seen.setdefault(self.key, self)

    def evaluate(self, leaf_values):
        v = leaf_values.get(self.key)
        if v is None:
            raise KeyError(f"no values recorded for leaf {self.name}")
        return np.asarray(v, np.int8)

    def plan(self, selectivity):
        return [self], float(selectivity.get(self.key, 0.5))

    def _to_wire(self, reverse):
        oracle_name = reverse.get(id(self.oracle))
        if oracle_name is None:
            inner = getattr(self.oracle, "inner", None)
            oracle_name = (reverse.get(id(inner))
                           or getattr(self.oracle, "wire_name", None))
        if oracle_name is None:
            raise WireFormatError(
                f"leaf {self.name!r}: oracle not in the registry and has "
                "no wire_name — register it under a name first")
        return {"op": "leaf", "name": self.name, "oracle": oracle_name,
                "embed": {"dtype": "float32",
                          "shape": list(self.e_q.shape),
                          "b64": base64.b64encode(
                              self.e_q.tobytes()).decode("ascii")}}

    def __repr__(self):
        return self.name


class Not(Predicate):
    def __init__(self, child: Predicate):
        if isinstance(child, SemanticTopK):
            raise TypeError("SemanticTopK is a root-only operator and "
                            "cannot be composed with & / | / ~")
        self.child = child

    def _collect(self, seen):
        self.child._collect(seen)

    def evaluate(self, leaf_values):
        return kleene_not(self.child.evaluate(leaf_values))

    def plan(self, selectivity):
        order, sel = self.child.plan(selectivity)
        return order, 1.0 - sel

    def _to_wire(self, reverse):
        return {"op": "not", "child": self.child._to_wire(reverse)}

    def __repr__(self):
        return f"~{self.child!r}"


class _NaryOp(Predicate):
    combine = None       # kleene_and / kleene_or
    ascending = True     # AND: most selective (lowest sel) first
    symbol = "?"

    def __init__(self, *children: Predicate):
        if len(children) < 2:
            raise ValueError("need at least two operands")
        if any(isinstance(c, SemanticTopK) for c in children):
            raise TypeError("SemanticTopK is a root-only operator and "
                            "cannot be composed with & / | / ~")
        self.children = tuple(children)

    def _collect(self, seen):
        for c in self.children:
            c._collect(seen)

    def evaluate(self, leaf_values):
        vals = [c.evaluate(leaf_values) for c in self.children]
        out = vals[0]
        for v in vals[1:]:
            out = type(self).combine(out, v)
        return out

    def plan(self, selectivity):
        plans = [c.plan(selectivity) for c in self.children]
        plans.sort(key=lambda p: p[1], reverse=not self.ascending)
        order: List[SemanticPredicate] = []
        seen = set()
        for leaves, _ in plans:
            for leaf in leaves:
                if leaf.key not in seen:
                    seen.add(leaf.key)
                    order.append(leaf)
        sels = [p[1] for p in plans]
        return order, self._combine_sel(sels)

    def _combine_sel(self, sels):
        raise NotImplementedError

    def _to_wire(self, reverse):
        return {"op": "and" if type(self).combine is kleene_and else "or",
                "children": [c._to_wire(reverse) for c in self.children]}

    def __repr__(self):
        return "(" + f" {self.symbol} ".join(map(repr, self.children)) + ")"


class And(_NaryOp):
    combine = staticmethod(kleene_and)
    ascending = True
    symbol = "&"

    def _combine_sel(self, sels):
        out = 1.0
        for s in sels:
            out *= s
        return out


class Or(_NaryOp):
    combine = staticmethod(kleene_or)
    ascending = False     # least selective first: rules documents in

    symbol = "|"

    def _combine_sel(self, sels):
        out = 1.0
        for s in sels:
            out *= (1.0 - s)
        return 1.0 - out


class SemanticTopK(Predicate):
    """Root-only semantic operator: the ``k`` best-matching documents
    among those satisfying ``child`` — the algebra's first non-filter
    member.

    Ranking uses a fuzzy combination of the child's per-leaf proxy
    scores (AND -> min, OR -> max, NOT -> 1 - s); membership of each
    candidate is decided by the ordinary cascade machinery, walking
    candidates in descending rank and buying oracle labels only inside
    the ambiguous band until ``k`` members are confirmed (docs/
    optimizer.md). The result mask has at most ``k`` bits set — exactly
    ``k`` unless fewer documents satisfy the child.

    Top-k does not compose: ``(topk & p)`` has no Kleene semantics, so
    ``&``/``|``/``~`` over it raise. On the wire it is the outermost
    node only (op ``"topk"``, wire version >= 2).
    """

    def __init__(self, child: Predicate, k: int):
        if not isinstance(child, Predicate):
            raise TypeError("SemanticTopK child must be a Predicate")
        if isinstance(child, SemanticTopK):
            raise TypeError("SemanticTopK cannot nest")
        if isinstance(k, bool) or not isinstance(k, (int, np.integer)):
            raise TypeError(f"k must be an int, got {type(k).__name__}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.child = child
        self.k = int(k)

    def __and__(self, other):
        raise TypeError("SemanticTopK is a root-only operator and cannot "
                        "be composed with & / | / ~")

    __rand__ = __and__
    __or__ = __and__
    __ror__ = __and__

    def __invert__(self):
        raise TypeError("SemanticTopK is a root-only operator and cannot "
                        "be composed with & / | / ~")

    def _collect(self, seen):
        self.child._collect(seen)

    def evaluate(self, leaf_values):
        # membership of the underlying filter; the engine applies the
        # rank cut on top of this (it never decides top-k from here)
        return self.child.evaluate(leaf_values)

    def plan(self, selectivity):
        order, sel = self.child.plan(selectivity)
        return order, sel

    def _to_wire(self, reverse):
        return {"op": "topk", "k": self.k,
                "child": self.child._to_wire(reverse)}

    def __repr__(self):
        return f"topk({self.child!r}, k={self.k})"


# -- wire decoding ------------------------------------------------------------

def _decode_embed(node: Mapping, where: str) -> np.ndarray:
    spec = node["embed"]
    if not isinstance(spec, Mapping):
        raise WireFormatError(f"{where}: embed must be an object")
    dtype = spec.get("dtype", "float32")
    if dtype != "float32":
        raise WireFormatError(f"{where}: unsupported embed dtype {dtype!r}")
    try:
        raw = base64.b64decode(spec["b64"], validate=True)
    except (KeyError, TypeError, ValueError) as exc:
        raise WireFormatError(f"{where}: bad embed.b64: {exc}") from None
    shape = spec.get("shape")
    if (not isinstance(shape, (list, tuple)) or len(shape) != 1
            or not isinstance(shape[0], int) or shape[0] < 1):
        raise WireFormatError(f"{where}: embed.shape must be [D]")
    try:
        e_q = np.frombuffer(raw, np.float32)
    except ValueError as exc:            # buffer not a multiple of 4 bytes
        raise WireFormatError(f"{where}: bad embed bytes: {exc}") from None
    if e_q.shape != tuple(shape):
        raise WireFormatError(
            f"{where}: embed bytes decode to shape {e_q.shape}, "
            f"declared {tuple(shape)}")
    return e_q


def _from_wire(node, oracles: Mapping[str, object],
               embedder: Optional[Callable[[str], np.ndarray]],
               depth: int, budget: List[int]) -> Predicate:
    if depth > MAX_WIRE_DEPTH:
        raise WireFormatError(f"AST deeper than {MAX_WIRE_DEPTH}")
    budget[0] -= 1
    if budget[0] < 0:
        raise WireFormatError(f"AST larger than {MAX_WIRE_NODES} nodes")
    if not isinstance(node, Mapping):
        raise WireFormatError(f"node must be an object, got "
                              f"{type(node).__name__}")
    op = node.get("op")
    if op == "leaf":
        name = node.get("name")
        oracle_name = node.get("oracle")
        if not isinstance(oracle_name, str):
            raise WireFormatError("leaf: missing oracle name")
        oracle = oracles.get(oracle_name)
        if oracle is None:
            raise WireFormatError(
                f"leaf: unknown oracle {oracle_name!r} (registered: "
                f"{sorted(oracles)})")
        if "embed" in node:
            e_q = _decode_embed(node, f"leaf {name!r}")
        elif "prompt" in node:
            if embedder is None:
                raise WireFormatError(
                    f"leaf {name!r}: prompt leaves need a server-side "
                    "embedder; send an embed instead")
            if not isinstance(node["prompt"], str):
                raise WireFormatError(f"leaf {name!r}: prompt must be a "
                                      "string")
            e_q = np.asarray(embedder(node["prompt"]), np.float32)
        else:
            raise WireFormatError(
                f"leaf {name!r}: needs a prompt or an embed")
        return SemanticPredicate(e_q, oracle, name=name)
    if op == "not":
        if "child" not in node:
            raise WireFormatError("not: missing child")
        return Not(_from_wire(node["child"], oracles, embedder,
                              depth + 1, budget))
    if op in ("and", "or"):
        children = node.get("children")
        if not isinstance(children, list) or len(children) < 2:
            raise WireFormatError(f"{op}: needs a list of >= 2 children")
        built = [_from_wire(c, oracles, embedder, depth + 1, budget)
                 for c in children]
        return (And if op == "and" else Or)(*built)
    if op == "topk":
        if depth != 1:
            raise WireFormatError("topk: root-only operator (wire "
                                  "version >= 2)")
        k = node.get("k")
        if isinstance(k, bool) or not isinstance(k, int):
            raise WireFormatError(f"topk: k must be an integer, got "
                                  f"{type(k).__name__}")
        if not 1 <= k <= MAX_WIRE_TOPK:
            raise WireFormatError(
                f"topk: k must be in [1, {MAX_WIRE_TOPK}], got {k}")
        if "child" not in node:
            raise WireFormatError("topk: missing child")
        child = _from_wire(node["child"], oracles, embedder,
                           depth + 1, budget)
        return SemanticTopK(child, k)
    raise WireFormatError(f"unknown op {op!r}")


def from_wire(node, *, oracles: Mapping[str, object],
              embedder: Optional[Callable[[str], np.ndarray]] = None
              ) -> Predicate:
    """Reconstruct a predicate from its wire AST (``to_wire`` output).

    ``oracles`` maps wire names to the oracle objects this side labels
    with; ``embedder`` (prompt str -> (D,) embedding) enables ``prompt``
    leaves. Raises ``WireFormatError`` on any malformed node — unknown
    op, unregistered oracle, missing prompt/embed, byte/shape mismatch,
    or an AST exceeding ``MAX_WIRE_DEPTH`` / ``MAX_WIRE_NODES``.

    Round-trip guarantee: embeds travel as raw float32 bytes, so
    ``from_wire(p.to_wire(reg), oracles=reg)`` rebuilds every leaf with
    a bit-identical ``e_q`` *and* the same oracle object — hence the
    same cache ``key``, the same RNG streams, and bitwise-identical
    ``filter()`` decisions as the original predicate.
    """
    return _from_wire(node, oracles, embedder, 1, [MAX_WIRE_NODES])
