"""Decision provenance (the provenance section of
``repro.runtime.trace``).

``ProvenanceMap`` is the per-document decision provenance a
``filter()`` call emits: for every doc, which class of mechanism decided
it (proxy threshold, oracle purchase, cached label, short circuit, ...)
and at which leaf. The codes and class names are the JAX package's, so
a map from either package reads the same.

The rest of the JAX module (spans, the ``Tracer``, ``traceparent``
propagation and the ``CostLedger``) comes with the serving planes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "PROVENANCE_CLASSES", "PROXY_ACCEPT", "PROXY_REJECT", "ORACLE",
    "CACHED_LABEL", "TOPK_SKIP", "PROXY_FALLBACK", "SHORT_CIRCUIT",
    "UNRESOLVED", "UNCLASSIFIED", "ProvenanceMap",
]


# Per-document decision classes. Codes are indices into
# PROVENANCE_CLASSES and are what FilterResult.provenance.class_of
# holds (int8; -1 = unclassified, which a completed filter never
# leaves behind).
PROVENANCE_CLASSES = ("proxy_accept", "proxy_reject", "oracle",
                      "cached_label", "topk_skip", "proxy_fallback",
                      "short_circuit", "unresolved")
PROXY_ACCEPT = 0     # root decided True by a leaf threshold (s > r)
PROXY_REJECT = 1     # root decided False by a leaf threshold (s < l)
ORACLE = 2           # ambiguous band, label purchased (or joined)
CACHED_LABEL = 3     # ambiguous band, label already in the shared cache
TOPK_SKIP = 4        # top-k: never walked, or a member beyond k
PROXY_FALLBACK = 5   # degraded: decided by raw proxy score
SHORT_CIRCUIT = 6    # threshold-decided while skipping >=1 later leaf
UNRESOLVED = 7       # degraded defer: parked for post-heal repair
UNCLASSIFIED = -1


@dataclasses.dataclass
class ProvenanceMap:
    """Per-document decision provenance for one ``filter()`` call.

    ``class_of[d]`` is the PROVENANCE_CLASSES index of the mechanism
    that decided document ``d`` at the root; ``leaf_of[d]`` indexes
    ``leaf_names`` (the deciding leaf; -1 when no single leaf applies —
    top-k skips, unresolved parks). Classes are root-relative: with
    negation in the tree, a leaf-level auto-accept can decide the root
    False and is reported as ``proxy_reject`` — the map answers "why is
    doc d in/out of the result", not "what did leaf L score".
    """

    class_of: np.ndarray                  # (n,) int8 codes
    leaf_of: np.ndarray                   # (n,) int16 leaf index or -1
    leaf_names: List[str]
    classes: Tuple[str, ...] = PROVENANCE_CLASSES

    @property
    def n_docs(self) -> int:
        return len(self.class_of)

    def complete(self) -> bool:
        return bool(np.all(self.class_of >= 0))

    def counts(self) -> Dict[str, int]:
        out = {}
        for code, name in enumerate(self.classes):
            c = int(np.sum(self.class_of == code))
            if c:
                out[name] = c
        unknown = int(np.sum(self.class_of < 0))
        if unknown:
            out["unclassified"] = unknown
        return out

    def docs_in(self, name: str) -> np.ndarray:
        code = self.classes.index(name)
        return np.nonzero(self.class_of == code)[0]

    def to_payload(self, mask: Optional[np.ndarray] = None,
                   include_docs: bool = True) -> Dict:
        """The ``/v1/queries/<id>/explain`` body."""
        out = {"n_docs": self.n_docs,
               "legend": list(self.classes),
               "leaves": list(self.leaf_names),
               "counts": self.counts(),
               "complete": self.complete()}
        if include_docs:
            out["class_of"] = self.class_of.astype(int).tolist()
            out["leaf_of"] = self.leaf_of.astype(int).tolist()
        if mask is not None:
            out["accepted_count"] = int(np.sum(mask))
        return out
