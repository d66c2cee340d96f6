"""Predicates over a document collection (``repro.engine.predicate``).

A ``SemanticPredicate`` is one LLM predicate: a query embedding plus the
oracle that can label documents against it. Its ``key`` fingerprints
``(e_q, oracle)`` exactly as the JAX package does (``sha1`` of the
float32 bytes, first 12 hex digits, then ``id(oracle)``), and the
engine derives its sample streams from that digest, so the same
embedding draws the same samples in both packages.

Values are three-valued (Kleene logic): TRUE/FALSE once decided,
UNKNOWN until then. Composition with ``&``, ``|`` and ``~`` is not
ported yet and raises ``NotImplementedError``; nor is ``SemanticTopK``.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

TRUE = np.int8(1)
FALSE = np.int8(0)
UNKNOWN = np.int8(-1)

_COMPOUND = ("compound predicates (&, |, ~) are not ported yet; "
             "see ROADMAP.md")


class Predicate:
    """Expression-tree node. The port has one kind: SemanticPredicate."""

    def __and__(self, other: "Predicate") -> "Predicate":
        raise NotImplementedError(_COMPOUND)

    __or__ = __and__

    def __invert__(self) -> "Predicate":
        raise NotImplementedError(_COMPOUND)


class SemanticPredicate(Predicate):
    """One LLM predicate: query embedding + oracle labeler."""

    def __init__(self, e_q: np.ndarray, oracle, name: Optional[str] = None):
        self.e_q = np.asarray(e_q, np.float32)
        if self.e_q.ndim != 1:
            raise ValueError(f"e_q must be (D,), got {self.e_q.shape}")
        self.oracle = oracle
        digest = hashlib.sha1(self.e_q.tobytes()).hexdigest()[:12]
        self.key = f"{digest}:{id(oracle)}"
        self.name = name or f"pred-{digest[:6]}"

    def __repr__(self):
        return self.name
