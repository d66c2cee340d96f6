"""Synthetic document corpora with planted semantics.

A numpy copy of ``repro.data.synthetic``'s ``make_corpus`` and
``make_query``: the same seed gives the same arrays in both packages
(the token sequences the JAX package can add for its LM examples are
not ported).

Topic-mixture embeddings ``e_d = normalize(W_d @ T + noise)``; queries
plant a concept over three topics (two drivers the query embedding
points at, one hidden negative topic, a mild interaction term) whose
threshold is set by the requested selectivity.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Corpus:
    embeds: np.ndarray        # (N, D) float32, L2-normalized
    topic_weights: np.ndarray  # (N, k)
    topics: np.ndarray        # (k, D)


@dataclasses.dataclass
class Query:
    embed: np.ndarray         # (D,)
    truth: np.ndarray         # (N,) bool ground truth
    selectivity: float
    topic_a: int = 0
    topic_b: int = 0


def make_corpus(seed: int, n_docs: int = 10_000, dim: int = 256,
                n_topics: int = 16, noise: float = 0.03) -> Corpus:
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(n_topics, dim)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)
    # sparse-ish topic weights (2-4 active topics per doc)
    w = rng.gamma(0.5, 1.0, size=(n_docs, n_topics)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    e = w @ topics + noise * rng.normal(size=(n_docs, dim)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    return Corpus(embeds=e, topic_weights=w, topics=topics)


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
