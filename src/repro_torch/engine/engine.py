"""ScaleDocEngine — the persistent predicate engine, one leaf at a time.

The port of ``repro.engine.engine`` for the paper's online phase,
``filter(SemanticPredicate)`` and its convenience form ``query()``:

  1. draw a ~10% oracle-labelled training sample of the collection;
  2. train the two-phase contrastive proxy (``train_proxy_multi``, the
     contrastive CUDA kernel in phase 2), padded to ``TRAIN_BATCH_PAD``
     lanes so every training run has one fixed shape;
  3. score the whole collection through the ``ScoringExecutor`` (the
     fused scoring CUDA kernel);
  4. calibrate, pick the cascade thresholds ``(l, r)``, and send only the
     ambiguous band to the oracle.

The engine keeps its state across queries: one ``DocumentStore``, a
``CachedOracle`` per oracle (a label bought once is never paid for
again), and per-leaf caches of trained proxies and leaf evaluations.

The sample streams are numpy generators seeded by ``(seed, leaf
fingerprint)``, exactly as in the JAX package, so both packages draw the
same training and calibration samples; the proxy's own draws come from a
torch seed derived from the same pair (the JAX package folds it into a
threefry key, which torch cannot reproduce).

``from_corpus`` runs the offline phase first (``repro_torch.engine
.ingest``: the LM embeds every document into a persistent store) and
builds the engine over that store.

Not ported yet (each raises ``NotImplementedError``): compound
predicates and their planner, ``SemanticTopK``, ``degrade`` other than
``"fail"``, the cross-query ``QueryOptimizer``, ``session_view`` and
decision provenance.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.config import CascadeConfig, ProxyConfig, replace
from repro_torch.core import oracle as oracle_mod
from repro_torch.core.cascade import CascadeResult, f1_score
from repro_torch.core.oracle import CachedOracle
from repro_torch.core.pipeline import QueryStats
from repro_torch.core.trainer import train_proxy_multi, unstack_params
from repro_torch.device import resolve_device
from repro_torch.engine.executor import ScoringExecutor, ScoringStats
from repro_torch.engine.predicate import Predicate, SemanticPredicate
from repro_torch.engine.registry import get_calibrator, get_strategy
from repro_torch.engine.store import DocumentStore, as_store

# below this many documents in the collection the cascade machinery
# costs more than it saves: label every document directly
DIRECT_LABEL_CUTOFF = 64

# every proxy-training run is padded to this many lanes, so it always
# has one shape (the JAX package pads for bitwise batch invariance; the
# port keeps the shape so both run the same work per query)
TRAIN_BATCH_PAD = 4


@dataclasses.dataclass
class LeafArtifact:
    """One leaf's full-collection evaluation: proxy scores, thresholds
    and the labelled calibration sample (``labels_full`` instead, for
    strategies without a threshold split)."""
    key: str
    name: str
    scores: np.ndarray                  # (N,) proxy scores
    params: Optional[Dict]              # proxy params scored with
    l: float = 0.0
    r: float = 1.0
    sample_idx: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    sample_labels: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, bool))
    est_accuracy: Optional[float] = None
    certified: Optional[bool] = None
    calib_calls: int = 0                # labels its construction bought
    labels_full: Optional[np.ndarray] = None
    online_calls_full: int = 0          # band labels bought eagerly


@dataclasses.dataclass
class LeafReport:
    """What one leaf cost inside a filter() call."""
    name: str
    key: str
    n_pending: int
    oracle_calls_train: int
    oracle_calls_calib: int
    oracle_calls_online: int
    proxy_reused: bool
    cascade: Optional[CascadeResult]    # None on the direct-label path
    pending: np.ndarray                 # global doc indices this leaf saw
    scores: Optional[np.ndarray]        # proxy scores over `pending`
    labels: Optional[np.ndarray] = None  # leaf decisions over `pending`

    @property
    def oracle_calls(self) -> int:
        return (self.oracle_calls_train + self.oracle_calls_calib
                + self.oracle_calls_online)


@dataclasses.dataclass
class FilterResult:
    mask: np.ndarray                    # (N,) bool — docs matching
    oracle_calls_total: int
    oracle_calls_train: int
    leaf_reports: List[LeafReport]
    plan: str
    wall_seconds: float
    n_docs: int
    achieved_f1: Optional[float] = None
    achieved_exact: Optional[float] = None
    scoring_stats: ScoringStats = dataclasses.field(
        default_factory=ScoringStats)


class ScaleDocEngine:
    """Persistent engine over one document collection, on ``device``
    (``"cuda"`` by default; it raises when no card is present)."""

    def __init__(self, store, proxy_cfg: Optional[ProxyConfig] = None,
                 cascade_cfg: Optional[CascadeConfig] = None, *,
                 strategy: str = "scaledoc", chunk: int = 8192,
                 degrade: str = "fail", device="cuda"):
        if degrade != "fail":
            raise NotImplementedError(
                f"degrade={degrade!r} is not ported yet; only 'fail'")
        self.device = resolve_device(device)
        self.store: DocumentStore = as_store(store)
        proxy_cfg = proxy_cfg or ProxyConfig()
        self.proxy_cfg = replace(proxy_cfg, embed_dim=self.store.dim)
        self.cascade_cfg = cascade_cfg or CascadeConfig()
        self.strategy = strategy
        self.executor = ScoringExecutor(chunk=chunk, device=self.device)
        self._oracles: Dict[int, CachedOracle] = {}
        self._proxies: Dict[str, Dict] = {}          # leaf.key -> params
        self._decisions: Dict[tuple, LeafArtifact] = {}
        self._lock = threading.RLock()
        # populated by from_corpus(): the offline phase's accounting
        self.ingest_result = None

    # -- construction from a raw corpus (offline phase) ------------------

    @classmethod
    def from_corpus(cls, service, docs_tokens, path, *,
                    proxy_cfg: Optional[ProxyConfig] = None,
                    cascade_cfg: Optional[CascadeConfig] = None,
                    ingest_mesh=None, max_docs: Optional[int] = None,
                    ingest_kwargs: Optional[Dict] = None,
                    device="cuda", **engine_kwargs) -> "ScaleDocEngine":
        """Run (or resume) the offline representation phase, then build
        an engine over the persisted store.

        ``service`` is a ``repro_torch.runtime.serve_loop
        .EmbeddingService``; ``docs_tokens`` a sequence of 1-D int token
        arrays; ``path`` a store directory (created on first use, resumed
        from the last durable row afterwards; a completed store skips
        embedding entirely). ``ingest_kwargs`` reach the ``Ingestor``
        (``commit_every_batches``, ``prefetch_depth``, ...);
        ``ingest_mesh`` must be None (multi-card ingest is not ported).
        The engine runs on ``device`` over the ``MemmapStore`` and keeps
        the offline accounting as ``engine.ingest_result``.
        """
        from repro_torch.engine.ingest import build_index
        result = build_index(service, docs_tokens, path,
                             max_docs=max_docs, mesh=ingest_mesh,
                             **(ingest_kwargs or {}))
        engine = cls(result.store, proxy_cfg, cascade_cfg, device=device,
                     **engine_kwargs)
        engine.ingest_result = result
        return engine

    def session_view(self, *args, **kwargs):
        raise NotImplementedError("session views (the serving planes) are "
                                  "not ported yet; see ROADMAP.md")

    # -- caches ---------------------------------------------------------

    def _cached_oracle(self, oracle) -> CachedOracle:
        # every oracle stays pinned in _oracles: leaf keys embed
        # id(oracle), so a collected oracle's id must never be reused
        with self._lock:
            if isinstance(oracle, CachedOracle):
                self._oracles.setdefault(id(oracle), oracle)
                return oracle
            got = self._oracles.get(id(oracle))
            if got is None or got.inner is not oracle:
                got = CachedOracle(oracle)
                self._oracles[id(oracle)] = got
            return got

    # -- per-leaf sample streams -------------------------------------------

    @staticmethod
    def _leaf_fingerprint(leaf: SemanticPredicate) -> int:
        """The sha1 half of ``leaf.key`` as an integer (the oracle id is
        left out so fresh oracle objects derive the same streams)."""
        return int(leaf.key.split(":")[0], 16)

    def _train_rng(self, seed: int, leaf: SemanticPredicate
                   ) -> np.random.Generator:
        return np.random.default_rng((seed, self._leaf_fingerprint(leaf)))

    def _calib_rng(self, seed: int, leaf: SemanticPredicate
                   ) -> np.random.Generator:
        return np.random.default_rng(
            (seed, self._leaf_fingerprint(leaf), 1))

    def _train_seed(self, seed: int, leaf: SemanticPredicate) -> int:
        """The torch seed of the leaf's proxy draws."""
        ss = np.random.SeedSequence((seed, self._leaf_fingerprint(leaf)))
        return int(ss.generate_state(1)[0])

    # -- proxy training ---------------------------------------------------

    def _train_pending_leaves(self, order: List[SemanticPredicate],
                              ccfg: CascadeConfig, seed: int):
        """Train every leaf of ``order`` that still needs a proxy.

        Returns ``(info, local_params)``: ``info`` maps ``leaf.key ->
        (oracle_calls_train, proxy_reused)`` and ``local_params`` pins
        the params this filter() call scores with.
        """
        n = len(self.store)
        info: Dict[str, tuple] = {}
        local_params: Dict[str, Dict] = {}
        jobs: List[SemanticPredicate] = []
        with self._lock:
            proxies_snapshot = dict(self._proxies)
            decision_keys = set(self._decisions)
        for leaf in order:
            reused = leaf.key in proxies_snapshot
            if reused:
                local_params[leaf.key] = proxies_snapshot[leaf.key]
            dkey = (leaf.key, self.strategy, ccfg, seed)
            if reused or dkey in decision_keys or n <= DIRECT_LABEL_CUTOFF:
                info[leaf.key] = (0, reused)
                continue
            jobs.append(leaf)
        seeds, samples, labels = [], [], []
        for leaf in jobs:
            oracle = self._cached_oracle(leaf.oracle)
            calls0 = oracle.calls
            n_train = min(max(int(self.proxy_cfg.train_fraction * n), 16), n)
            train_idx = self._train_rng(seed, leaf).choice(
                n, size=n_train, replace=False)
            seeds.append(self._train_seed(seed, leaf))
            samples.append(self.store.get(train_idx))
            labels.append(oracle.label(train_idx))
            info[leaf.key] = (oracle.calls - calls0, False)
        for i in range(0, len(jobs), TRAIN_BATCH_PAD):
            part = slice(i, i + TRAIN_BATCH_PAD)
            chunk = jobs[part]
            params_list = self._train_padded(
                seeds[part], [lf.e_q for lf in chunk], samples[part],
                labels[part])
            with self._lock:
                for leaf, params in zip(chunk, params_list):
                    local_params[leaf.key] = params
                    self._proxies[leaf.key] = params
        return info, local_params

    def _train_padded(self, seeds, e_qs, samples, labels) -> List[Dict]:
        """Train up to TRAIN_BATCH_PAD leaves in one run of the fixed
        lane count: real jobs padded with inert dummies (they cost device
        work, never oracle labels) that are sliced off."""
        k = len(seeds)
        if k > TRAIN_BATCH_PAD:
            raise ValueError(f"at most {TRAIN_BATCH_PAD} jobs per "
                             f"training run, got {k}")
        n_train, dim = samples[0].shape
        npad = TRAIN_BATCH_PAD - k
        seeds = list(seeds) + [0] * npad
        e_qs = list(e_qs) + [np.zeros(dim, np.float32)] * npad
        samples = list(samples) + [np.zeros((n_train, dim),
                                            np.float32)] * npad
        # mixed dummy labels keep the padded lanes' loss well-posed
        labels = list(labels) + [np.arange(n_train) % 2 == 0] * npad
        res = train_proxy_multi(seeds, np.stack(e_qs), samples, labels,
                                self.proxy_cfg, device=self.device)
        return unstack_params(res.params)[:k]

    # -- leaf execution ---------------------------------------------------

    def _execute_leaf(self, leaf: SemanticPredicate, pending: np.ndarray,
                      ccfg: CascadeConfig, train_info: Dict[str, tuple],
                      local_params: Dict[str, Dict],
                      truth_local: Optional[np.ndarray], seed: int,
                      stats: ScoringStats) -> LeafReport:
        oracle = self._cached_oracle(leaf.oracle)
        n = len(self.store)
        train_calls, reused = train_info.get(
            leaf.key, (0, leaf.key in local_params))

        if n <= DIRECT_LABEL_CUTOFF:
            calls0 = oracle.calls
            labels = oracle.label(pending)
            return LeafReport(
                name=leaf.name, key=leaf.key, n_pending=len(pending),
                oracle_calls_train=train_calls, oracle_calls_calib=0,
                oracle_calls_online=oracle.calls - calls0,
                proxy_reused=reused, cascade=None, pending=pending,
                scores=None, labels=labels)

        dkey = (leaf.key, self.strategy, ccfg, seed)
        art, calib_calls, online_build = self._leaf_artifact(
            leaf, dkey, ccfg, seed, local_params, stats)
        labels, ambiguous, online_calls = self._decide_pending(
            art, oracle, pending)
        online_calls += online_build
        cres = CascadeResult(
            labels=labels, l=art.l, r=art.r,
            unfiltered_rate=(float(ambiguous.mean()) if len(pending)
                             else 0.0),
            oracle_calls_online=online_calls,
            oracle_calls_calib=calib_calls,
            est_accuracy=art.est_accuracy,
            data_reduction=1.0 - (online_calls + calib_calls)
            / max(len(pending), 1),
            certified=art.certified)
        if truth_local is not None:
            truth = np.asarray(truth_local).astype(bool)
            cres.achieved_f1 = f1_score(labels, truth)
            cres.achieved_exact = float(np.mean(labels == truth))
        return LeafReport(
            name=leaf.name, key=leaf.key, n_pending=len(pending),
            oracle_calls_train=train_calls, oracle_calls_calib=calib_calls,
            oracle_calls_online=online_calls, proxy_reused=reused,
            cascade=cres, pending=pending, scores=art.scores[pending],
            labels=labels)

    def _leaf_artifact(self, leaf: SemanticPredicate, dkey: tuple,
                       ccfg: CascadeConfig, seed: int,
                       local_params: Dict[str, Dict], stats: ScoringStats):
        """The leaf's full-collection evaluation, from the cache or built
        now. Returns ``(artifact, calib_calls_paid, online_calls_paid)``."""
        with self._lock:
            art = self._decisions.get(dkey)
        if art is not None:
            return art, 0, 0
        art, calib, online = self._build_artifact(leaf, ccfg, seed,
                                                  local_params, stats)
        with self._lock:
            self._decisions[dkey] = art
        return art, calib, online

    def _build_artifact(self, leaf: SemanticPredicate, ccfg: CascadeConfig,
                        seed: int, local_params: Dict[str, Dict],
                        stats: ScoringStats):
        """Score the full collection and calibrate."""
        params = local_params.get(leaf.key)
        if params is None:
            raise RuntimeError(
                f"no trained proxy for leaf {leaf.name!r}; "
                "_train_pending_leaves must run before leaf execution")
        oracle = self._cached_oracle(leaf.oracle)
        scores, pass_stats = self.executor.score(params, leaf.e_q,
                                                 self.store)
        stats.merge(pass_stats)
        rng = self._calib_rng(seed, leaf)
        calls0 = oracle.calls
        calibrator = get_calibrator(self.strategy)
        if calibrator is not None:
            spec = calibrator(scores, oracle, ccfg, rng)
            art = LeafArtifact(
                key=leaf.key, name=leaf.name, scores=scores, params=params,
                l=spec.l, r=spec.r,
                sample_idx=np.asarray(spec.sample_idx, np.int64),
                sample_labels=np.asarray(spec.sample_labels, bool),
                est_accuracy=spec.est_accuracy, certified=spec.certified,
                calib_calls=oracle.calls - calls0)
            return art, art.calib_calls, 0
        # whole strategy (probe, ad-hoc registrations): decisions
        # materialize eagerly over the full collection
        cres = get_strategy(self.strategy)(scores, oracle, ccfg,
                                           ground_truth=None, rng=rng)
        art = LeafArtifact(
            key=leaf.key, name=leaf.name, scores=scores, params=params,
            l=cres.l, r=cres.r, est_accuracy=cres.est_accuracy,
            certified=cres.certified, calib_calls=cres.oracle_calls_calib,
            labels_full=np.asarray(cres.labels, bool),
            online_calls_full=cres.oracle_calls_online)
        return art, cres.oracle_calls_calib, cres.oracle_calls_online

    @staticmethod
    def _decide_pending(art: LeafArtifact, oracle, pending: np.ndarray):
        """Accept above ``r``, reject below ``l``, oracle the ambiguous
        remainder (reusing calibration labels already purchased).
        Returns ``(labels, ambiguous, purchased)``."""
        if art.labels_full is not None:
            return (art.labels_full[pending],
                    np.zeros(len(pending), bool), 0)
        s = art.scores[pending]
        labels = s > art.r
        ambiguous = ~(labels | (s < art.l))
        known = {int(i): bool(y) for i, y in zip(art.sample_idx,
                                                 art.sample_labels)}
        amb_local = np.nonzero(ambiguous)[0]
        need = np.array([i for i in amb_local
                         if int(pending[i]) not in known], np.int64)
        if len(need):
            labels[need] = np.asarray(oracle.label(pending[need]), bool)
        for i in amb_local:
            g = int(pending[i])
            if g in known:
                labels[i] = known[g]
        return labels, ambiguous, int(len(need))

    # -- public API -------------------------------------------------------

    def filter(self, predicate: Predicate, *,
               accuracy_target: Optional[float] = None,
               ground_truth: Optional[np.ndarray] = None,
               seed: int = 0, degrade: Optional[str] = None,
               name: Optional[str] = None) -> FilterResult:
        """Evaluate one ``SemanticPredicate`` over the collection: a
        boolean mask over all documents plus per-leaf cost accounting.
        ``ground_truth``, if given, is used only to report achieved F1 /
        exact accuracy. ``name`` is accepted for the JAX package's
        signature; it names nothing in the port yet."""
        if not isinstance(predicate, Predicate):
            raise TypeError("predicate must be a repro_torch Predicate; "
                            "wrap raw (e_q, oracle) in SemanticPredicate")
        if not isinstance(predicate, SemanticPredicate):
            raise NotImplementedError(
                f"{type(predicate).__name__} is not ported yet; the port "
                "filters one SemanticPredicate")
        if degrade not in (None, "fail"):
            raise NotImplementedError(
                f"degrade={degrade!r} is not ported yet; only 'fail'")
        t0 = time.time()
        ccfg = self.cascade_cfg
        if accuracy_target is not None:
            ccfg = replace(ccfg, accuracy_target=accuracy_target)
        n = len(self.store)
        leaf = predicate
        oracle = self._cached_oracle(leaf.oracle)
        calls_before = oracle.calls
        scoring_stats = ScoringStats()
        train_info, local_params = self._train_pending_leaves(
            [leaf], ccfg, seed)
        report = self._execute_leaf(
            leaf, np.arange(n), ccfg, train_info, local_params,
            ground_truth, seed, scoring_stats)
        result = FilterResult(
            mask=np.asarray(report.labels, bool),
            oracle_calls_total=oracle.calls - calls_before,
            oracle_calls_train=sum(c for c, _ in train_info.values()),
            leaf_reports=[report], plan=report.name,
            wall_seconds=time.time() - t0, n_docs=n,
            scoring_stats=scoring_stats)
        if ground_truth is not None:
            truth = np.asarray(ground_truth).astype(bool)
            result.achieved_f1 = f1_score(result.mask, truth)
            result.achieved_exact = float(np.mean(result.mask == truth))
        return result

    def query(self, e_q: np.ndarray, oracle, *,
              accuracy_target: Optional[float] = None,
              ground_truth: Optional[np.ndarray] = None,
              seed: int = 0, name: Optional[str] = None,
              degrade: Optional[str] = None) -> QueryStats:
        """Single-predicate convenience; returns the pipeline-shaped
        ``QueryStats``."""
        t0 = time.time()
        pred = SemanticPredicate(e_q, oracle, name=name)
        res = self.filter(pred, accuracy_target=accuracy_target,
                          ground_truth=ground_truth, seed=seed,
                          degrade=degrade)
        leaf = res.leaf_reports[0]
        proxy_flops = res.n_docs * oracle_mod.OUR_PROXY_FLOPS_PER_DOC
        oracle_flops = res.oracle_calls_total * getattr(
            oracle, "flops_per_doc", oracle_mod.ORACLE_FLOPS_PER_DOC)
        cascade = leaf.cascade
        if cascade is None:     # tiny collection: direct-label fallback
            cascade = CascadeResult(
                labels=res.mask, l=0.0, r=1.0, unfiltered_rate=1.0,
                oracle_calls_online=leaf.oracle_calls_online,
                oracle_calls_calib=0, est_accuracy=1.0,
                achieved_f1=res.achieved_f1,
                achieved_exact=res.achieved_exact)
        return QueryStats(
            cascade=cascade,
            oracle_calls_total=res.oracle_calls_total,
            oracle_calls_train=leaf.oracle_calls_train,
            proxy_flops=proxy_flops,
            oracle_flops=oracle_flops,
            total_flops=proxy_flops + oracle_flops,
            wall_seconds=time.time() - t0,
            scores=leaf.scores)
