"""Synthetic document corpora with planted semantics.

A numpy copy of ``repro.data.synthetic`` (``make_corpus``,
``make_query``, ``make_workload``): the same seed gives the same arrays
in both packages, the token sequences of ``with_tokens=True`` included.

Topic-mixture embeddings ``e_d = normalize(W_d @ T + noise)``; queries
plant a concept over three topics (two drivers the query embedding
points at, one hidden negative topic, a mild interaction term) whose
threshold is set by the requested selectivity. Token sequences come
from topic-dependent unigram tables (the offline LM's input).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Corpus:
    embeds: np.ndarray        # (N, D) float32, L2-normalized
    topic_weights: np.ndarray  # (N, k)
    topics: np.ndarray        # (k, D)
    tokens: Optional[np.ndarray] = None  # (N, L) int32


@dataclasses.dataclass
class Query:
    embed: np.ndarray         # (D,)
    truth: np.ndarray         # (N,) bool ground truth
    selectivity: float
    topic_a: int = 0
    topic_b: int = 0


def sample_tokens(cdf: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Inverse-CDF draws: per row, the first index whose cdf exceeds u.

    cdf (N, V), u (N, L) -> (N, L) int32. This is the JAX package's
    ``(u[..., None] < cdf[:, None, :]).argmax(-1)`` without its
    (N, L, V) array: ``searchsorted(side="right")`` gives the same first
    index, and a u at or above the row's last cdf entry (no index
    exceeds it, so ``argmax`` of an all-false row is 0) maps to 0.
    """
    vocab = cdf.shape[1]
    out = np.empty(u.shape, np.int32)
    for i in range(u.shape[0]):
        idx = np.searchsorted(cdf[i], u[i], side="right")
        out[i] = np.where(idx >= vocab, 0, idx)
    return out


def make_corpus(seed: int, n_docs: int = 10_000, dim: int = 256,
                n_topics: int = 16, noise: float = 0.03,
                with_tokens: bool = False, vocab: int = 256,
                doc_len: int = 64) -> Corpus:
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(n_topics, dim)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)
    # sparse-ish topic weights (2-4 active topics per doc)
    w = rng.gamma(0.5, 1.0, size=(n_docs, n_topics)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    e = w @ topics + noise * rng.normal(size=(n_docs, dim)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    tokens = None
    if with_tokens:
        # topic-dependent unigram tables
        tables = rng.dirichlet(np.full(vocab, 0.05), size=n_topics)
        probs = w @ tables
        probs /= probs.sum(axis=1, keepdims=True)
        cdf = np.cumsum(probs, axis=1)
        u = rng.random((n_docs, doc_len))
        tokens = sample_tokens(cdf, u)
    return Corpus(embeds=e, topic_weights=w, topics=topics, tokens=tokens)


def make_query(corpus: Corpus, seed: int, selectivity: float = 0.3,
               nonlinearity: float = 0.3, label_noise: float = 0.0,
               query_noise: float = 0.25, neg_weight: float = 0.8) -> Query:
    """Plant a concept over three topics: two positive drivers (which the
    query embedding points at), one hidden negative topic plus a mild
    interaction term, both invisible to raw cosine matching but learnable
    from oracle labels."""
    rng = np.random.default_rng(seed)
    k = corpus.topics.shape[0]
    ta, tb, tc = rng.choice(k, size=3, replace=False)

    def z(i):
        s = corpus.topic_weights[:, i]
        return (s - s.mean()) / (s.std() + 1e-9)

    raw = (z(ta) + 0.6 * z(tb) - neg_weight * z(tc)
           + nonlinearity * z(ta) * z(tb))
    if label_noise > 0:
        raw = raw + label_noise * rng.normal(size=len(raw))
    theta = np.quantile(raw, 1.0 - selectivity)
    truth = raw > theta
    q = (corpus.topics[ta] + 0.6 * corpus.topics[tb]
         + query_noise * rng.normal(size=corpus.topics.shape[1]))
    q = (q / np.linalg.norm(q)).astype(np.float32)
    return Query(embed=q, truth=truth,
                 selectivity=float(truth.mean()), topic_a=int(ta),
                 topic_b=int(tb))


def make_workload(seed: int, n_docs: int = 10_000, dim: int = 256,
                  n_queries: int = 5, selectivities=None
                  ) -> Tuple[Corpus, list]:
    """A corpus + a batch of queries with varied selectivity (paper uses
    20 queries x 3 datasets; benchmarks scale this down for CPU)."""
    corpus = make_corpus(seed, n_docs=n_docs, dim=dim)
    if selectivities is None:
        rng = np.random.default_rng(seed + 1)
        selectivities = rng.uniform(0.1, 0.5, size=n_queries)
    queries = [make_query(corpus, seed + 100 + i, selectivity=float(s))
               for i, s in enumerate(selectivities)]
    return corpus, queries
