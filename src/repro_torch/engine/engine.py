"""ScaleDocEngine — the persistent multi-predicate engine.

The port of ``repro.engine.engine``. The engine keeps state across
queries:

  * one ``DocumentStore`` (in memory or memory-mapped);
  * a cross-query oracle label cache (``CachedOracle`` per oracle): a
    label purchased for any query's training, calibration or ambiguous
    band is never paid for again;
  * a per-predicate trained-proxy cache keyed by (e_q, oracle), so
    repeating a predicate skips training entirely, and canonical
    full-collection leaf artifacts keyed by (leaf, strategy, cascade
    config, seed);
  * composed predicates (``p1 & ~p2``) compile into a cost-ordered plan:
    the most decisive leaf runs first and documents it decides
    short-circuit out of every later leaf's cascade (QUEST-style
    compound-predicate optimization);
  * the planning pass scores every leaf without a measured selectivity
    in one streaming pass over the store (``ScoringExecutor
    .score_multi``): a trained leaf through the fused scoring CUDA
    kernel, an untrained one as raw cosine;
  * proxy training is collect-then-batch: every leaf that still needs a
    proxy gets its labelled sample drawn from the full collection up
    front, and groups of them train in one run of ``train_proxy_multi``
    (the contrastive CUDA kernel in phase 2). Every run is padded to
    the fixed ``TRAIN_BATCH_PAD`` lanes, and each lane draws from its
    own seed alone, so trained params are a pure function of ``(leaf,
    seed)``, whatever the plan position, the sibling lanes or the
    session. ``batch_training=False`` trains one leaf a run (still
    padded): the same params, more runs;
  * session views (``session_view``) share the label caches and, with a
    ``QueryOptimizer``, trained proxies and leaf artifacts across
    sessions (cross-session CSE); every shared value is a pure function
    of its key, so sharing changes cost, never decisions;
  * every ``filter()`` returns per-document decision provenance
    (``FilterResult.provenance``);
  * ``SemanticTopK(child, k)`` walks documents in descending fuzzy rank
    of the child's leaf scores and decides each batch through the
    canonical leaf artifacts, stopping once ``k`` members are confirmed;
  * when the oracle plane fails mid-filter (an ``OracleError``), the
    ``degrade`` policy decides: ``"fail"`` re-raises, ``"defer"`` parks
    the undecided documents and a ``RepairTicket`` whose replay
    (``repair_pending``) is bitwise the fault-free run, and
    ``"proxy_fallback"`` decides the rest by proxy score alone.

The sample streams are numpy generators seeded by ``(seed, leaf
fingerprint)``, exactly as in the JAX package, so both packages draw the
same training and calibration samples; the proxy's own draws come from a
torch seed derived from the same pair (the JAX package folds it into a
threefry key, which torch cannot reproduce).

``from_corpus`` runs the offline phase first (``repro_torch.engine
.ingest``: the LM embeds every document into a persistent store) and
builds the engine over that store.

Not ported yet (see ROADMAP.md): ``session_view(tracer=)`` and the
cost ledger, which come with the tracer.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.config import CascadeConfig, ProxyConfig, replace
from repro_torch.core import oracle as oracle_mod
from repro_torch.core.cascade import CascadeResult, f1_score
from repro_torch.core.oracle import CachedOracle, OracleError
from repro_torch.core.pipeline import QueryStats
from repro_torch.core.trainer import train_proxy_multi, unstack_params
from repro_torch.device import resolve_device
from repro_torch.engine.executor import ScoringExecutor, ScoringStats
from repro_torch.engine.optimizer import (LeafArtifact, QueryOptimizer,
                                          SelectivityStats)
from repro_torch.engine.predicate import (FALSE, TRUE, UNKNOWN, And, Not,
                                          Or, Predicate, SemanticPredicate,
                                          SemanticTopK)
from repro_torch.engine.registry import get_calibrator, get_strategy
from repro_torch.engine.store import DocumentStore, InMemoryStore, as_store
from repro_torch.runtime import trace as trace_mod

# below this many documents in the COLLECTION the cascade machinery
# costs more than it saves: label pending docs directly. Keyed to the
# collection size, not the pending-set size, so a document's decision
# stays a pure function of (leaf, strategy, config, seed) whatever its
# plan position (the canonical evaluation cross-session CSE rests on)
DIRECT_LABEL_CUTOFF = 64

# every proxy-training run is padded to this many lanes, so it always
# has one shape: a lane's params then depend on its own seed and sample
# alone, never on how many leaves happened to co-train
TRAIN_BATCH_PAD = 4

DEGRADE_MODES = ("fail", "defer", "proxy_fallback")


class _PendingView:
    """Streaming view of a pending subset of a store: scoring iterates it
    chunk by chunk, so only one chunk of embeddings is resident at a time
    even when the pending set spans an out-of-core collection."""

    def __init__(self, store: "DocumentStore", pending: np.ndarray,
                 chunk: int):
        self._store = store
        self._pending = pending
        self._chunk = chunk

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def dim(self) -> int:
        return self._store.dim

    def iter_chunks(self, chunk: int = 0):
        chunk = chunk or self._chunk
        for start in range(0, len(self._pending), chunk):
            yield start, self._store.get(self._pending[start:start + chunk])


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
    # per-pending-doc decision mechanism at THIS leaf (trace_mod codes:
    # PROXY_ACCEPT/PROXY_REJECT for threshold auto-decisions, ORACLE for
    # purchased band labels, CACHED_LABEL for band labels already in the
    # shared cache): the raw material of FilterResult.provenance
    mech: Optional[np.ndarray] = None
    # oracle docs this session was actually CHARGED for at this leaf
    # beyond training (calibration + online band), measured as a
    # ``calls`` delta: cache hits are free. The ``oracle_calls_*``
    # fields above keep ask-level accounting (docs the cascade *sent* to
    # the oracle stage), the paper's data-reduction metric.
    oracle_docs_charged: int = 0

    @property
    def oracle_calls(self) -> int:
        return (self.oracle_calls_train + self.oracle_calls_calib
                + self.oracle_calls_online)


@dataclasses.dataclass
class FilterResult:
    mask: np.ndarray                    # (N,) bool — docs matching the root
    oracle_calls_total: int
    oracle_calls_train: int
    leaf_reports: List[LeafReport]
    plan: str
    wall_seconds: float
    n_docs: int
    achieved_f1: Optional[float] = None
    achieved_exact: Optional[float] = None
    # aggregated executor accounting over every scoring pass this filter()
    # ran (planning + per-leaf); zeroed fields when no pass was needed
    scoring_stats: ScoringStats = dataclasses.field(
        default_factory=ScoringStats)
    # degraded-mode accounting (oracle outage mid-filter):
    #   degraded        — the oracle plane failed and a degrade policy ran
    #   degrade_mode    — "defer" | "proxy_fallback" when degraded
    #   unresolved      — doc ids parked UNRESOLVED (defer: not in mask,
    #                     a RepairTicket re-decides them after heal)
    #   fallback_docs   — docs decided by raw proxy score (proxy_fallback)
    #   est_accuracy_debit — heuristic accuracy give-up from fallback
    #   error           — stringified oracle failure
    degraded: bool = False
    degrade_mode: Optional[str] = None
    unresolved: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    fallback_docs: int = 0
    est_accuracy_debit: float = 0.0
    error: Optional[str] = None
    # decision provenance: for every doc, which mechanism decided it at
    # the root and at which leaf
    provenance: Optional[trace_mod.ProvenanceMap] = None

    @property
    def data_reduction(self) -> float:
        return 1.0 - self.oracle_calls_total / max(self.n_docs, 1)


@dataclasses.dataclass
class RepairTicket:
    """A deferred query parked by ``degrade="defer"``: everything needed
    to replay ``filter()`` bit-identically once the oracle heals. The
    replay runs on a *fresh* session view (fresh proxy/decision caches,
    shared label caches), so its sample streams and proxy seeds match a
    fault-free run; that, plus ``CachedOracle``'s at-most-once purchase,
    is the parity argument."""
    predicate: Predicate
    accuracy_target: Optional[float]
    ground_truth: Optional[np.ndarray]
    seed: int
    unresolved: np.ndarray
    error: str
    name: Optional[str] = None


class ScaleDocEngine:
    """Persistent engine over one document collection, on ``device``
    (``"cuda"`` by default; it raises when no card is present)."""

    def __init__(self, store, proxy_cfg: Optional[ProxyConfig] = None,
                 cascade_cfg: Optional[CascadeConfig] = None, *,
                 strategy: str = "scaledoc", chunk: int = 8192,
                 executor: Optional[ScoringExecutor] = None,
                 batch_training: bool = True,
                 degrade: str = "fail",
                 optimizer: Optional[QueryOptimizer] = None,
                 device="cuda"):
        # what happens when the oracle plane fails mid-filter:
        #   "fail"           — raise
        #   "defer"          — park undecided docs + a RepairTicket
        #   "proxy_fallback" — decide the rest by proxy score, flagged
        if degrade not in DEGRADE_MODES:
            raise ValueError(f"unknown degrade policy {degrade!r}")
        self.degrade = degrade
        self._repairs: List[RepairTicket] = []
        self.device = resolve_device(device)
        self.store: DocumentStore = as_store(store)
        proxy_cfg = proxy_cfg or ProxyConfig()
        self.proxy_cfg = replace(proxy_cfg, embed_dim=self.store.dim)
        self.cascade_cfg = cascade_cfg or CascadeConfig()
        self.strategy = strategy
        # True: one padded run trains up to TRAIN_BATCH_PAD of a plan's
        # untrained leaves; False: one leaf a run (the same params, more
        # runs; kept for parity testing)
        self.batch_training = batch_training
        # a caller-built executor wins over chunk / device
        self.executor = executor or ScoringExecutor(chunk=chunk,
                                                    device=self.device)
        self._oracles: Dict[int, CachedOracle] = {}
        self._proxies: Dict[str, Dict] = {}          # leaf.key -> params
        # cross-query optimizer (shared caches + single-flight): None =
        # this engine/session evaluates every leaf itself
        self._optimizer = optimizer
        # per-leaf selectivity table feeding plan ordering; with an
        # optimizer attached it is the optimizer's shared instance
        self._selstats: SelectivityStats = (
            optimizer.stats if optimizer is not None else SelectivityStats())
        # canonical full-collection leaf artifacts, keyed by
        # (leaf.key, strategy, cascade cfg, seed)
        self._decisions: Dict[tuple, LeafArtifact] = {}
        # session views copy the reference, so one lock guards them all
        self._lock = threading.RLock()
        # session-view injection points: _oracle_wrap maps each
        # CachedOracle to the label handle the session calls; _observer
        # receives phase / partial-result callbacks
        self._oracle_wrap: Optional[Callable] = None
        self._observer = None
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

    # -- session views ----------------------------------------------------

    def session_view(self, *, oracle_wrap: Optional[Callable] = None,
                     observer=None, share_caches: bool = False,
                     optimizer: Optional[QueryOptimizer] = None
                     ) -> "ScaleDocEngine":
        """A lightweight per-session view over this engine.

        The view shares the store, executor, configs, lock and the
        ``_oracles`` label caches (a label purchased by any session is
        free for every other), but gets *fresh* proxy/decision/
        selectivity caches unless ``share_caches=True``. Isolated caches
        make each session behave exactly like a serial ``filter()`` on a
        fresh engine sharing the ``CachedOracle``s.

        ``oracle_wrap`` (CachedOracle -> label handle) routes every label
        purchase this session makes through the returned handle.
        ``observer`` receives ``on_phase(name)`` and
        ``on_partial(accepted_ids, rejected_ids)`` callbacks from
        ``filter()``.

        ``optimizer`` attaches a shared ``QueryOptimizer``: the view
        resolves trained proxies and leaf artifacts through its
        single-flight caches (cross-session CSE) and reads/writes its
        ``SelectivityStats``. Every shared value is a pure function of
        its key, so attaching an optimizer changes cost, never
        decisions.
        """
        view = copy.copy(self)
        view._oracle_wrap = oracle_wrap
        view._observer = observer
        if optimizer is not None:
            view._optimizer = optimizer
        if not share_caches:
            view._proxies = {}
            view._decisions = {}
            view._selstats = (view._optimizer.stats
                              if view._optimizer is not None
                              else SelectivityStats())
        return view

    def _notify(self, phase: str) -> None:
        obs = self._observer
        if obs is not None:
            on_phase = getattr(obs, "on_phase", None)
            if on_phase is not None:
                on_phase(phase)

    def _partial(self, accepted: np.ndarray, rejected: np.ndarray) -> None:
        obs = self._observer
        if obs is not None:
            on_partial = getattr(obs, "on_partial", None)
            if on_partial is not None:
                on_partial(accepted, rejected)

    # -- caches ---------------------------------------------------------

    def _cached_oracle(self, oracle) -> CachedOracle:
        # every oracle stays pinned in _oracles: leaf keys embed
        # id(oracle), so a collected oracle's id must never be reused
        with self._lock:
            # a ResilientOracle (repro_torch.serve.resilience) presents
            # the full CachedOracle surface plus its retry/breaker
            # policy; adopting it here routes every purchase through it
            if (isinstance(oracle, CachedOracle)
                    or getattr(oracle, "acts_as_cached", False)):
                self._oracles.setdefault(id(oracle), oracle)
                return oracle
            got = self._oracles.get(id(oracle))
            if got is None or got.inner is not oracle:
                got = CachedOracle(oracle)
                self._oracles[id(oracle)] = got
            return got

    def _session_oracle(self, oracle):
        """The label handle a filter() call uses for ``oracle``: the
        shared CachedOracle itself, or the ``oracle_wrap`` handle around
        it on a session view that has one."""
        cached = self._cached_oracle(oracle)
        if self._oracle_wrap is None:
            return cached
        return self._oracle_wrap(cached)

    # -- repair queue (degrade="defer") ----------------------------------

    @property
    def repair_count(self) -> int:
        with self._lock:
            return len(self._repairs)

    def take_repairs(self) -> List[RepairTicket]:
        """Pop every parked ticket (shared across session views)."""
        with self._lock:
            out, self._repairs = self._repairs, []
            return out

    def repark(self, ticket: RepairTicket) -> None:
        with self._lock:
            self._repairs.append(ticket)

    def repair_pending(self) -> List[FilterResult]:
        """Replay every parked ticket on a fresh session view.

        Each replay is a full ``filter()`` from the ticket's seed: fresh
        proxy/decision caches so the sample streams and proxy seeds match
        a fault-free run, shared label caches so nothing already
        purchased is paid again. A replay that degrades again re-parks
        itself (views share the repair list). Call after the oracle
        heals."""
        out: List[FilterResult] = []
        for ticket in self.take_repairs():
            view = self.session_view()
            out.append(view.filter(
                ticket.predicate, accuracy_target=ticket.accuracy_target,
                ground_truth=ticket.ground_truth, seed=ticket.seed,
                degrade="defer", name=ticket.name))
        return out

    def clear_caches(self) -> None:
        """Drop all cross-query state (labels, proxies, decisions).

        The caches grow with the number of distinct (predicate, config)
        pairs served; each pins its oracle and an (N,) score vector.
        Long-lived engines serving unbounded ad-hoc workloads should
        call this periodically."""
        with self._lock:
            self._oracles.clear()
            self._proxies.clear()
            self._decisions.clear()
        self._selstats.clear()

    # -- planning -------------------------------------------------------

    def _estimate_selectivities(self, leaves: List[SemanticPredicate],
                                stats: ScoringStats) -> Dict[str, float]:
        """Per-leaf positive-rate estimates for plan ordering only.

        Leaves with a *measured* selectivity in the stats table (their
        leaf artifact completed, in this session or, with a shared
        optimizer, any session) use it; measured always beats estimated.
        The rest are estimated oracle-free in one streaming pass over
        the store: trained cached proxies give calibrated bipolar scores
        (count > 0.5, through the fused kernel); untrained leaves fall
        back to min-max-normalized raw cosine mass. Heuristic estimates
        are published at the ``estimated`` level for observability;
        planning never reads them back.
        """
        est: Dict[str, float] = {}
        jobs, job_leaves = [], []
        with self._lock:
            proxies_snapshot = dict(self._proxies)
        for leaf in leaves:
            measured = self._selstats.get(leaf.key, measured_only=True)
            if measured is not None:
                est[leaf.key] = measured
            else:
                jobs.append((proxies_snapshot.get(leaf.key), leaf.e_q))
                job_leaves.append(leaf)
        if jobs:
            cols, pass_stats = self.executor.score_multi(jobs, self.store)
            stats.merge(pass_stats)
            for j, leaf in enumerate(job_leaves):
                s = cols[:, j]
                if jobs[j][0] is not None:
                    est[leaf.key] = float(np.mean(s > 0.5))
                else:
                    span = float(s.max() - s.min())
                    est[leaf.key] = (float(np.mean((s - s.min()) / span))
                                     if span > 0 else 0.5)
                self._selstats.observe(leaf.key, est[leaf.key],
                                       measured=False, name=leaf.name)
        return est

    # -- per-leaf sample streams (canonical evaluation) ------------------

    @staticmethod
    def _leaf_fingerprint(leaf: SemanticPredicate) -> int:
        """The sha1 half of ``leaf.key`` as an integer (the oracle id is
        left out so fresh oracle objects derive the same streams)."""
        return int(leaf.key.split(":")[0], 16)

    def _train_rng(self, seed: int, leaf: SemanticPredicate
                   ) -> np.random.Generator:
        """Training-sample stream: a pure function of (seed, embedding),
        independent of plan position and of every other leaf."""
        return np.random.default_rng((seed, self._leaf_fingerprint(leaf)))

    def _calib_rng(self, seed: int, leaf: SemanticPredicate
                   ) -> np.random.Generator:
        """Calibration stream, derived apart from the training stream
        (trailing 1) so a cached-proxy hit cannot shift it."""
        return np.random.default_rng(
            (seed, self._leaf_fingerprint(leaf), 1))

    def _train_seed(self, seed: int, leaf: SemanticPredicate) -> int:
        """The torch seed of the leaf's proxy draws."""
        ss = np.random.SeedSequence((seed, self._leaf_fingerprint(leaf)))
        return int(ss.generate_state(1)[0])

    # -- proxy training (collect-then-batch) ----------------------------

    def _train_pending_leaves(self, order: List[SemanticPredicate],
                              ccfg: CascadeConfig, seed: int):
        """Train every leaf of the plan that still needs a proxy, up to
        TRAIN_BATCH_PAD leaves a run.

        Each leaf's labelled sample and torch seed derive purely from
        ``(seed, leaf fingerprint)``, so the trained params are a pure
        function of ``(leaf, seed)``. With an optimizer, single-flight
        claims are taken per missing proxy; this call trains the leaves
        it owns, publishes them, and only then joins foreign flights
        (publishing before waiting keeps the flights deadlock-free).

        Returns ``(info, local_params)``: ``info`` maps ``leaf.key ->
        (oracle_calls_train, proxy_reused)`` and ``local_params`` pins
        the params this filter() call scores with. Leaves with a cached
        proxy or artifact, and tiny collections that direct-label, skip
        training.
        """
        n = len(self.store)
        info: Dict[str, tuple] = {}
        local_params: Dict[str, Dict] = {}
        opt = self._optimizer
        jobs: List[SemanticPredicate] = []
        waits: List[tuple] = []             # (leaf, foreign flight)
        claimed: List[SemanticPredicate] = []
        with self._lock:
            proxies_snapshot = dict(self._proxies)
            decision_keys = set(self._decisions)
        for leaf in order:
            reused = leaf.key in proxies_snapshot
            dkey = (leaf.key, self.strategy, ccfg, seed)
            if reused:
                local_params[leaf.key] = proxies_snapshot[leaf.key]
            if reused or dkey in decision_keys or n <= DIRECT_LABEL_CUTOFF:
                info[leaf.key] = (0, reused)
                continue
            if opt is not None:
                if opt.has_artifact(dkey):
                    # the full leaf evaluation exists: no params needed
                    info[leaf.key] = (0, True)
                    continue
                kind, val = opt.claim_proxy(leaf.key, seed)
                if kind == "hit":
                    local_params[leaf.key] = val
                    info[leaf.key] = (0, True)
                    continue
                if kind == "wait":
                    waits.append((leaf, val))
                    continue
                claimed.append(leaf)
            jobs.append(leaf)
        seeds, samples, labels = [], [], []
        try:
            for leaf in jobs:
                oracle = self._session_oracle(leaf.oracle)
                calls0 = oracle.calls
                train_idx = self._train_idx(seed, leaf, n)
                seeds.append(self._train_seed(seed, leaf))
                samples.append(self.store.get(train_idx))
                labels.append(oracle.label(train_idx))
                info[leaf.key] = (oracle.calls - calls0, False)
            # the batched mode groups up to TRAIN_BATCH_PAD leaves a
            # run, the sequential mode one; both run the same padded
            # shape, so the params are the same either way
            step = (min(len(jobs), TRAIN_BATCH_PAD)
                    if self.batch_training else 1) or 1
            trained = []
            for i in range(0, len(jobs), step):
                chunk = jobs[i:i + step]
                params_list = self._train_padded(
                    seeds[i:i + step], [lf.e_q for lf in chunk],
                    samples[i:i + step], labels[i:i + step])
                trained.extend(zip(chunk, params_list))
        except BaseException as exc:
            if opt is not None:
                for leaf in claimed:
                    opt.abort_proxy(leaf.key, seed, exc)
            raise
        with self._lock:
            for leaf, params in trained:
                local_params[leaf.key] = params
                self._proxies[leaf.key] = params
        if opt is not None:
            for leaf, params in trained:
                opt.publish_proxy(leaf.key, seed, params)
            for leaf, flight in waits:
                params = opt.wait(flight)
                if params is None:
                    # owner aborted or timed out: compute locally; the
                    # result is the same pure function of (leaf, seed)
                    params = self._train_leaf_local(leaf, seed, n, info)
                    opt.publish_proxy(leaf.key, seed, params)
                else:
                    info[leaf.key] = (0, True)
                with self._lock:
                    local_params[leaf.key] = params
                    self._proxies[leaf.key] = params
        return info, local_params

    def _train_idx(self, seed: int, leaf: SemanticPredicate,
                   n: int) -> np.ndarray:
        n_train = min(max(int(self.proxy_cfg.train_fraction * n), 16), n)
        return self._train_rng(seed, leaf).choice(n, size=n_train,
                                                  replace=False)

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

    def _train_leaf_local(self, leaf: SemanticPredicate, seed: int,
                          n: int, info: Dict[str, tuple]) -> Dict:
        """Single-leaf training, the waiter's fallback when a foreign
        proxy flight dies: the same sample, seed and padded run, hence
        the same params the dead owner would have built."""
        oracle = self._session_oracle(leaf.oracle)
        calls0 = oracle.calls
        idx = self._train_idx(seed, leaf, n)
        y = oracle.label(idx)
        params = self._train_padded([self._train_seed(seed, leaf)],
                                    [leaf.e_q], [self.store.get(idx)],
                                    [y])[0]
        info[leaf.key] = (oracle.calls - calls0, False)
        return params

    # -- leaf execution (canonical artifacts + lazy resolution) -----------

    def _execute_leaf(self, leaf: SemanticPredicate, pending: np.ndarray,
                      ccfg: CascadeConfig, train_info: Dict[str, tuple],
                      local_params: Dict[str, Dict],
                      truth_local: Optional[np.ndarray], seed: int,
                      stats: ScoringStats) -> LeafReport:
        oracle = self._session_oracle(leaf.oracle)
        n = len(self.store)
        train_calls, reused = train_info.get(
            leaf.key, (0, leaf.key in local_params))

        if n <= DIRECT_LABEL_CUTOFF:
            # tiny collection: a document's decision IS its oracle label
            mech = self._peek_mech(oracle, pending)
            calls0 = oracle.calls
            labels = oracle.label(pending)
            return LeafReport(
                name=leaf.name, key=leaf.key, n_pending=len(pending),
                oracle_calls_train=train_calls, oracle_calls_calib=0,
                oracle_calls_online=oracle.calls - calls0,
                proxy_reused=reused, cascade=None, pending=pending,
                scores=None, labels=labels, mech=mech,
                oracle_docs_charged=oracle.calls - calls0)

        dkey = (leaf.key, self.strategy, ccfg, seed)
        charged0 = oracle.calls
        art, calib_calls, online_build = self._leaf_artifact(
            leaf, dkey, ccfg, seed, local_params, stats)
        labels, ambiguous, online_calls, mech = self._decide_pending(
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
            labels=labels, mech=mech,
            oracle_docs_charged=oracle.calls - charged0)

    def _leaf_artifact(self, leaf: SemanticPredicate, dkey: tuple,
                       ccfg: CascadeConfig, seed: int,
                       local_params: Dict[str, Dict], stats: ScoringStats):
        """The canonical full-collection evaluation of one leaf: local
        cache, then the shared optimizer (hit / join flight / own the
        build), then a local build. Returns ``(artifact,
        calib_calls_paid, online_calls_paid)``, both zero when the
        artifact came from a cache or another session's flight."""
        with self._lock:
            art = self._decisions.get(dkey)
        if art is not None:
            return art, 0, 0
        opt = self._optimizer
        if opt is not None:
            kind, val = opt.claim_artifact(dkey)
            if kind == "owner":
                try:
                    art, calib, online = self._build_artifact(
                        leaf, ccfg, seed, local_params, stats)
                except BaseException as exc:
                    opt.abort_artifact(dkey, exc)
                    raise
                opt.publish_artifact(dkey, art)
                with self._lock:
                    self._decisions[dkey] = art
                return art, calib, online
            art = val if kind == "hit" else opt.wait(val)
            if art is not None:
                with self._lock:
                    self._decisions[dkey] = art
                self._selstats.observe(art.key, art.measured_sel,
                                       measured=True, name=leaf.name)
                return art, 0, 0
            # foreign flight died: fall through to a local build
        art, calib, online = self._build_artifact(leaf, ccfg, seed,
                                                  local_params, stats)
        with self._lock:
            self._decisions[dkey] = art
        self._selstats.observe(art.key, art.measured_sel, measured=True,
                               name=leaf.name)
        return art, calib, online

    def _build_artifact(self, leaf: SemanticPredicate, ccfg: CascadeConfig,
                        seed: int, local_params: Dict[str, Dict],
                        stats: ScoringStats):
        """Score the full collection and calibrate: every input derives
        from ``(leaf, strategy, ccfg, seed)`` plus the oracle's labels,
        so the artifact is the same whichever session builds it."""
        params = local_params.get(leaf.key)
        if params is None:
            raise RuntimeError(
                f"no trained proxy for leaf {leaf.name!r}; "
                "_train_pending_leaves must run before leaf execution")
        oracle = self._session_oracle(leaf.oracle)
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
                calib_calls=oracle.calls - calls0,
                measured_sel=self._measured_selectivity(scores, spec),
                trained=True)
            return art, art.calib_calls, 0
        # whole strategy (probe, ad-hoc registrations): decisions
        # materialize eagerly over the full collection
        cres = get_strategy(self.strategy)(scores, oracle, ccfg,
                                           ground_truth=None, rng=rng)
        labels_full = np.asarray(cres.labels, bool)
        art = LeafArtifact(
            key=leaf.key, name=leaf.name, scores=scores, params=params,
            l=cres.l, r=cres.r, est_accuracy=cres.est_accuracy,
            certified=cres.certified, calib_calls=cres.oracle_calls_calib,
            labels_full=labels_full,
            online_calls_full=cres.oracle_calls_online,
            measured_sel=float(labels_full.mean()), trained=True)
        return art, cres.oracle_calls_calib, cres.oracle_calls_online

    @staticmethod
    def _measured_selectivity(scores: np.ndarray, spec) -> float:
        """Analytic positive rate of a calibrated leaf: P(s > r) plus the
        band mass weighted by the calibration sample's positive rate
        inside the band."""
        auto_pos = scores > spec.r
        band = ~(auto_pos | (scores < spec.l))
        pos = float(np.mean(auto_pos))
        band_frac = float(np.mean(band))
        if band_frac == 0.0:
            return pos
        band_rate = 0.5
        if len(spec.sample_idx):
            s_samp = scores[spec.sample_idx]
            samp_band = ~((s_samp > spec.r) | (s_samp < spec.l))
            y = np.asarray(spec.sample_labels, bool)
            band_rate = (float(np.mean(y[samp_band])) if samp_band.any()
                         else float(np.mean(y)))
        return float(min(max(pos + band_frac * band_rate, 0.0), 1.0))

    @staticmethod
    def _peek_mech(oracle, docs: np.ndarray) -> np.ndarray:
        """Mechanism codes for docs about to be labelled: ORACLE for
        labels the cache doesn't hold yet (a purchase), CACHED_LABEL for
        the rest. Must run *before* ``oracle.label`` (which fills the
        cache); ``peek`` never mutates."""
        mech = np.full(len(docs), trace_mod.CACHED_LABEL, np.int8)
        peek = getattr(oracle, "peek", None)
        if peek is None:
            mech[:] = trace_mod.ORACLE
            return mech
        uncached = set(int(g) for g in peek(docs))
        if uncached:
            fresh = np.array([j for j, g in enumerate(docs)
                              if int(g) in uncached], np.int64)
            mech[fresh] = trace_mod.ORACLE
        return mech

    def _decide_pending(self, art: LeafArtifact, oracle,
                        pending: np.ndarray):
        """Resolve a pending subset against a leaf artifact: accept
        above ``r``, reject below ``l``, oracle the ambiguous remainder
        (reusing calibration labels already purchased). Per-doc
        decisions are pure functions of the artifact plus the shared
        label cache, so any partition of documents across sessions or
        plan positions gives the same values.

        Returns ``(labels, ambiguous, purchased, mech)``, ``mech`` the
        per-doc decision mechanism (trace_mod codes)."""
        if art.labels_full is not None:
            # whole-strategy artifact: decisions were materialized at
            # build time; to this session they are cache reads
            return (art.labels_full[pending],
                    np.zeros(len(pending), bool), 0,
                    np.full(len(pending), trace_mod.CACHED_LABEL,
                            np.int8))
        s = art.scores[pending]
        labels = s > art.r
        ambiguous = ~(labels | (s < art.l))
        mech = np.where(labels, trace_mod.PROXY_ACCEPT,
                        trace_mod.PROXY_REJECT).astype(np.int8)
        mech[ambiguous] = trace_mod.CACHED_LABEL
        known = {int(i): bool(y) for i, y in zip(art.sample_idx,
                                                 art.sample_labels)}
        amb_local = np.nonzero(ambiguous)[0]
        need = np.array([i for i in amb_local
                         if int(pending[i]) not in known], np.int64)
        if len(need):
            # classify before labelling: label() fills the cache
            mech[need] = self._peek_mech(oracle, pending[need])
            labels[need] = np.asarray(oracle.label(pending[need]), bool)
        for i in amb_local:
            g = int(pending[i])
            if g in known:
                labels[i] = known[g]
        return labels, ambiguous, int(len(need)), mech

    # -- degraded-mode resolution ----------------------------------------

    def _proxy_fallback(self, predicate: Predicate,
                        order: List[SemanticPredicate],
                        leaves: List[SemanticPredicate],
                        leaf_values: Dict[str, np.ndarray],
                        local_params: Dict[str, Dict],
                        root: np.ndarray, stats: ScoringStats,
                        last_mech: Optional[np.ndarray] = None,
                        last_writer: Optional[np.ndarray] = None):
        """Decide every still-UNKNOWN document by proxy score alone.

        The cut placement uses the best oracle-free selectivity signal
        available: a measured selectivity from a past completed cascade,
        else the positive rate of the labels this query *already
        purchased* (training/calibration samples in the shared cache),
        accepting the matching top score-quantile. With neither, trained
        proxies cut at 0.5 and untrained leaves at 0.5 of
        min-max-normalized raw cosine (the planner's heuristic). The
        stranded documents are scored through the fused kernel (the raw
        cosine product for an untrained leaf). No oracle is touched, so
        this always completes during an outage; the caller flags the
        result, since these decisions carry no accuracy contract."""
        n = len(self.store)
        before = int(np.sum(root == UNKNOWN))
        for oi, leaf in enumerate(order):
            pending = np.nonzero(root == UNKNOWN)[0]
            if not len(pending):
                break
            vals = leaf_values.get(leaf.key)
            if vals is None:
                vals = np.full(n, UNKNOWN, np.int8)
            need = pending[vals[pending] == UNKNOWN]
            if len(need):
                if isinstance(self.store, InMemoryStore):
                    view = self.store.get(need)
                else:
                    view = _PendingView(self.store, need,
                                        self.executor.chunk)
                params = local_params.get(leaf.key)
                s, pass_stats = self.executor.score(params, leaf.e_q,
                                                    view)
                stats.merge(pass_stats)
                if params is None:
                    span = float(s.max() - s.min())
                    s = ((s - s.min()) / span if span > 0
                         else np.full(len(s), 0.5, np.float32))
                alpha = self._selstats.get(leaf.key, measured_only=True)
                if alpha is None:
                    cached = self._cached_oracle(leaf.oracle)
                    alpha = getattr(cached, "cached_positive_rate",
                                    lambda: None)()
                if alpha is not None and 0.0 < alpha < 1.0 and \
                        len(need) > 1:
                    cut = float(np.quantile(s, 1.0 - alpha))
                else:
                    cut = 0.5
                vals = vals.copy()
                vals[need] = (s > cut).astype(np.int8)
                leaf_values[leaf.key] = vals
                if last_mech is not None:
                    # every doc the outage stranded receives at least
                    # one fallback write before its root decides, so
                    # last-writer-wins marks exactly the fallback set
                    last_mech[need] = trace_mod.PROXY_FALLBACK
                    last_writer[need] = oi
            full = {lf.key: leaf_values.get(
                lf.key, np.full(n, UNKNOWN, np.int8)) for lf in leaves}
            prev_root = root
            root = predicate.evaluate(full)
            newly = prev_root == UNKNOWN
            self._partial(np.nonzero(newly & (root == TRUE))[0],
                          np.nonzero(newly & (root == FALSE))[0])
        assert not (root == UNKNOWN).any(), \
            "proxy fallback visited every leaf yet left docs undecided"
        return root, before

    @staticmethod
    def _fallback_debit(reports: List[LeafReport], fallback_docs: int,
                        n: int) -> float:
        """Heuristic accuracy give-up: the fraction of docs decided by
        raw proxy, weighted by how far the completed leaves' estimated
        accuracy sat from a coin flip (no completed cascade -> assume
        the full 0.5 gap)."""
        if not fallback_docs:
            return 0.0
        accs = [r.cascade.est_accuracy for r in reports
                if r.cascade is not None
                and r.cascade.est_accuracy is not None]
        gap = 1.0 - (float(np.mean(accs)) if accs else 0.5)
        return float(fallback_docs) / max(n, 1) * gap

    # -- public API -------------------------------------------------------

    def filter(self, predicate: Predicate, *,
               accuracy_target: Optional[float] = None,
               ground_truth: Optional[np.ndarray] = None,
               seed: int = 0, degrade: Optional[str] = None,
               name: Optional[str] = None) -> FilterResult:
        """Evaluate a (possibly composed) predicate, or a
        ``SemanticTopK`` over one, over the collection.

        Returns a boolean mask over all documents plus full per-leaf
        cost accounting and decision provenance. ``ground_truth``, if
        given, is the root-level truth used only for reporting achieved
        F1 / exact accuracy.

        ``degrade`` overrides the engine-level policy for this call:
        when an ``OracleError`` escapes the oracle plane mid-filter,
        ``"fail"`` re-raises it, ``"defer"`` returns a partial degraded
        result (undecided docs in ``result.unresolved``, a
        ``RepairTicket`` parked for post-heal replay), and
        ``"proxy_fallback"`` decides the remaining docs by proxy score
        alone (flagged via ``fallback_docs``/``est_accuracy_debit``).
        ``name`` carries the caller's query identity onto any parked
        ``RepairTicket``."""
        if not isinstance(predicate, Predicate):
            raise TypeError("predicate must be a repro_torch Predicate; "
                            "wrap raw (e_q, oracle) in SemanticPredicate")
        mode = self.degrade if degrade is None else degrade
        if mode not in DEGRADE_MODES:
            raise ValueError(f"unknown degrade policy {mode!r}")
        t0 = time.time()
        ccfg = self.cascade_cfg
        if accuracy_target is not None:
            ccfg = replace(ccfg, accuracy_target=accuracy_target)
        if isinstance(predicate, SemanticTopK):
            return self._filter_topk(predicate, ccfg=ccfg,
                                     ground_truth=ground_truth, seed=seed,
                                     mode=mode, name=name, t0=t0)
        return self._filter_compound(predicate, ccfg=ccfg,
                                     accuracy_target=accuracy_target,
                                     ground_truth=ground_truth, seed=seed,
                                     mode=mode, name=name, t0=t0)

    def _filter_compound(self, predicate: Predicate, *, ccfg: CascadeConfig,
                         accuracy_target: Optional[float],
                         ground_truth: Optional[np.ndarray], seed: int,
                         mode: str, name: Optional[str],
                         t0: float) -> FilterResult:
        n = len(self.store)
        leaves = predicate.leaves()
        scoring_stats = ScoringStats()
        # single-leaf predicates have nothing to reorder: skip the
        # estimation pass over the collection
        self._notify("planning")
        sel = (self._estimate_selectivities(leaves, scoring_stats)
               if len(leaves) > 1 else {})
        order, _ = predicate.plan(sel)
        leaf_truth = _derivable_leaf_truth(predicate, ground_truth)

        calls_before = {}
        for leaf in leaves:
            o = self._session_oracle(leaf.oracle)
            calls_before.setdefault(id(self._cached_oracle(leaf.oracle)),
                                    (o, o.calls))

        train_info: Dict[str, tuple] = {}
        local_params: Dict[str, Dict] = {}
        leaf_values: Dict[str, np.ndarray] = {}
        root = predicate.evaluate({lf.key: np.full(n, UNKNOWN, np.int8)
                                   for lf in leaves})
        reports: List[LeafReport] = []
        degrade_error: Optional[OracleError] = None
        fallback_docs = 0
        unresolved = np.zeros(0, np.int64)
        # decision provenance, last-writer-wins: once the root decides a
        # doc it leaves every later leaf's pending set, so the last leaf
        # to write a doc's mechanism/index is its deciding leaf
        last_mech = np.full(n, -1, np.int8)
        last_writer = np.full(n, -1, np.int16)
        order_pos = {lf.key: i for i, lf in enumerate(order)}
        try:
            # collect-then-batch: train every leaf proxy this plan still
            # needs before any cascade runs
            self._notify("training")
            train_info, local_params = self._train_pending_leaves(
                order, ccfg, seed)
            self._notify("scoring")
            for leaf in order:
                pending = np.nonzero(root == UNKNOWN)[0]
                if not len(pending):
                    break
                truth_local = leaf_truth.get(leaf.key)
                if truth_local is not None:
                    truth_local = truth_local[pending]
                report = self._execute_leaf(leaf, pending, ccfg, train_info,
                                            local_params, truth_local, seed,
                                            scoring_stats)
                reports.append(report)
                if report.mech is not None:
                    last_mech[pending] = report.mech
                    last_writer[pending] = order_pos[leaf.key]
                vals = np.full(n, UNKNOWN, np.int8)
                vals[pending] = report.labels.astype(np.int8)
                leaf_values[leaf.key] = vals
                full = {lf.key: leaf_values.get(
                    lf.key, np.full(n, UNKNOWN, np.int8)) for lf in leaves}
                prev_root = root
                root = predicate.evaluate(full)
                # stream newly decided doc ids to any session observer
                newly = prev_root == UNKNOWN
                self._partial(np.nonzero(newly & (root == TRUE))[0],
                              np.nonzero(newly & (root == FALSE))[0])
            assert not (root == UNKNOWN).any(), \
                "plan executed every leaf yet left documents undecided"
        except OracleError as exc:
            # the oracle plane gave up below us. Everything decided so
            # far is committed (caches only store completed artifacts and
            # labels), so the degrade policies work on a clean prefix of
            # the plan.
            if mode == "fail":
                raise
            degrade_error = exc
            self._notify("degraded")
            if mode == "defer":
                unresolved = np.nonzero(root == UNKNOWN)[0]
                self.repark(RepairTicket(
                    predicate=predicate, accuracy_target=accuracy_target,
                    ground_truth=ground_truth, seed=seed,
                    unresolved=unresolved, error=str(exc), name=name))
            else:  # proxy_fallback
                root, fallback_docs = self._proxy_fallback(
                    predicate, order, leaves, leaf_values, local_params,
                    root, scoring_stats, last_mech, last_writer)

        total = sum(o.calls - before for o, before in calls_before.values())
        mask = root == TRUE
        provenance = self._assemble_provenance(
            mask, last_mech, last_writer, [lf.name for lf in order],
            leaves=leaves, leaf_values=leaf_values, unresolved=unresolved)
        result = FilterResult(
            mask=mask,
            oracle_calls_total=total,
            oracle_calls_train=sum(c for c, _ in train_info.values()),
            leaf_reports=reports,
            plan=" -> ".join(r.name for r in reports) or "(decided)",
            wall_seconds=time.time() - t0,
            n_docs=n,
            scoring_stats=scoring_stats,
            **self._degrade_fields(mode, degrade_error, unresolved,
                                   fallback_docs, reports, n),
            provenance=provenance)
        return self._finish(result, ground_truth)

    def _degrade_fields(self, mode: str, error: Optional[OracleError],
                        unresolved: np.ndarray, fallback_docs: int,
                        reports: List[LeafReport], n: int) -> Dict:
        """FilterResult's degraded-mode fields."""
        return dict(
            degraded=error is not None,
            degrade_mode=mode if error is not None else None,
            unresolved=unresolved, fallback_docs=fallback_docs,
            est_accuracy_debit=self._fallback_debit(reports, fallback_docs,
                                                    n),
            error=str(error) if error is not None else None)

    def _finish(self, result: FilterResult,
                ground_truth: Optional[np.ndarray]) -> FilterResult:
        if ground_truth is not None:
            truth = np.asarray(ground_truth).astype(bool)
            result.achieved_f1 = f1_score(result.mask, truth)
            result.achieved_exact = float(np.mean(result.mask == truth))
        self._notify("done")
        return result

    @staticmethod
    def _assemble_provenance(mask: np.ndarray, last_mech: np.ndarray,
                             last_writer: np.ndarray,
                             leaf_names: List[str], *,
                             leaves: Optional[List[SemanticPredicate]]
                             = None,
                             leaf_values: Optional[Dict[str, np.ndarray]]
                             = None,
                             unresolved: Optional[np.ndarray] = None,
                             topk_skip: Optional[np.ndarray] = None
                             ) -> trace_mod.ProvenanceMap:
        """Finalize the last-writer mechanism track into root-relative
        provenance classes.

        Leaf-level threshold codes are remapped against the root mask
        (with negation in the tree, a leaf auto-accept can decide the
        root False -> ``proxy_reject``); a threshold decision that
        short-circuited at least one later leaf (some leaf value still
        UNKNOWN for that doc) becomes ``short_circuit``. Oracle /
        cached-label decisions keep their mechanism even when they
        short-circuit: the purchased label is what decided the doc.
        ``unresolved`` (defer) and ``topk_skip`` overrides come last.
        """
        class_of = last_mech.copy()
        leaf_of = last_writer.copy()
        thresh = ((class_of == trace_mod.PROXY_ACCEPT)
                  | (class_of == trace_mod.PROXY_REJECT))
        if leaves is not None and leaf_values is not None \
                and len(leaves) > 1:
            skipped = np.zeros(len(mask), bool)
            for lf in leaves:
                vals = leaf_values.get(lf.key)
                if vals is None:
                    skipped[:] = True
                    break
                skipped |= vals == UNKNOWN
            class_of[thresh & skipped] = trace_mod.SHORT_CIRCUIT
            thresh &= ~skipped
        class_of[thresh & mask] = trace_mod.PROXY_ACCEPT
        class_of[thresh & ~mask] = trace_mod.PROXY_REJECT
        if topk_skip is not None and len(topk_skip):
            class_of[topk_skip] = trace_mod.TOPK_SKIP
            leaf_of[topk_skip] = -1
        if unresolved is not None and len(unresolved):
            class_of[unresolved] = trace_mod.UNRESOLVED
            leaf_of[unresolved] = -1
        return trace_mod.ProvenanceMap(class_of=class_of,
                                       leaf_of=leaf_of,
                                       leaf_names=list(leaf_names))

    # -- semantic top-k ----------------------------------------------------

    def _fuzzy_rank(self, pred: Predicate,
                    scores_by_key: Dict[str, np.ndarray]) -> np.ndarray:
        """Top-k ranking signal: fuzzy-logic combination of the per-leaf
        proxy scores (AND -> min, OR -> max, NOT -> 1 - s). Pure ordering
        heuristic: membership is still decided by the cascade, so ranking
        quality affects oracle cost, never correctness. The scores stay
        float32, so ``1 - s`` rounds as in the JAX package."""
        if isinstance(pred, SemanticPredicate):
            return scores_by_key[pred.key]
        if isinstance(pred, Not):
            return 1.0 - self._fuzzy_rank(pred.child, scores_by_key)
        if isinstance(pred, (And, Or)):
            vals = [self._fuzzy_rank(c, scores_by_key)
                    for c in pred.children]
            combine = np.minimum if isinstance(pred, And) else np.maximum
            out = vals[0]
            for v in vals[1:]:
                out = combine(out, v)
            return out
        raise TypeError(f"cannot rank over {type(pred).__name__}")

    def _filter_topk(self, predicate: SemanticTopK, *, ccfg: CascadeConfig,
                     ground_truth: Optional[np.ndarray], seed: int,
                     mode: str, name: Optional[str],
                     t0: float) -> FilterResult:
        """Execute ``SemanticTopK(child, k)`` as a cascade over ranks:
        walk candidates in stable descending fuzzy-rank order, decide
        each batch's child membership through the canonical leaf
        artifacts (thresholds free, oracle only in the ambiguous band),
        and stop once ``k`` members are confirmed. Documents never walked
        are excluded without any oracle spend: that is the saving over
        filter-then-sort, which resolves the whole collection first."""
        n = len(self.store)
        child = predicate.child
        k = min(predicate.k, n)
        opt = self._optimizer
        if opt is not None:
            with opt._lock:
                opt.topk_queries += 1
        leaves = child.leaves()
        scoring_stats = ScoringStats()
        self._notify("planning")
        sel = (self._estimate_selectivities(leaves, scoring_stats)
               if len(leaves) > 1 else {})
        order, _ = child.plan(sel)

        calls_before = {}
        for leaf in leaves:
            o = self._session_oracle(leaf.oracle)
            calls_before.setdefault(id(self._cached_oracle(leaf.oracle)),
                                    (o, o.calls))

        leaf_vals = {leaf.key: np.full(n, UNKNOWN, np.int8)
                     for leaf in leaves}
        online_by_key = {leaf.key: 0 for leaf in leaves}
        build_calib = {leaf.key: 0 for leaf in leaves}
        charged_by_key = {leaf.key: 0 for leaf in leaves}
        arts: Dict[str, LeafArtifact] = {}
        train_info: Dict[str, tuple] = {}
        accepted: List[int] = []
        walked = 0
        order_idx: Optional[np.ndarray] = None
        degrade_error: Optional[OracleError] = None
        fallback_docs = 0
        unresolved = np.zeros(0, np.int64)
        # provenance (last-writer-wins, the same argument as filter())
        last_mech = np.full(n, -1, np.int8)
        last_writer = np.full(n, -1, np.int16)
        try:
            self._notify("training")
            train_info, local_params = self._train_pending_leaves(
                order, ccfg, seed)
            self._notify("scoring")
            if n <= DIRECT_LABEL_CUTOFF:
                # tiny collection: label everything, keep the k lowest
                # doc ids among members (stable, canonical)
                for oi, leaf in enumerate(order):
                    oracle = self._session_oracle(leaf.oracle)
                    mech = self._peek_mech(oracle, np.arange(n))
                    calls0 = oracle.calls
                    leaf_vals[leaf.key][:] = np.asarray(
                        oracle.label(np.arange(n)), bool).astype(np.int8)
                    online_by_key[leaf.key] += oracle.calls - calls0
                    charged_by_key[leaf.key] += oracle.calls - calls0
                    last_mech[:] = mech
                    last_writer[:] = oi
                order_idx = np.arange(n)
                walked = n
                member = child.evaluate(leaf_vals) == TRUE
                accepted = [int(d) for d in np.nonzero(member)[0][:k]]
            else:
                for leaf in order:
                    dkey = (leaf.key, self.strategy, ccfg, seed)
                    o = self._session_oracle(leaf.oracle)
                    c0 = o.calls
                    art, calib, online = self._leaf_artifact(
                        leaf, dkey, ccfg, seed, local_params, scoring_stats)
                    arts[leaf.key] = art
                    build_calib[leaf.key] = calib
                    online_by_key[leaf.key] += online
                    charged_by_key[leaf.key] += o.calls - c0
                rank = self._fuzzy_rank(
                    child, {key: a.scores for key, a in arts.items()})
                # stable argsort on -rank: ties break by ascending doc
                # id, so the walk order is bitwise reproducible
                order_idx = np.argsort(-rank, kind="stable")
                batch = max(2 * k, 128)
                while len(accepted) < k and walked < n:
                    cand = order_idx[walked:walked + batch]
                    walked += len(cand)
                    for oi, leaf in enumerate(order):
                        root_vals = child.evaluate(leaf_vals)
                        pend = cand[root_vals[cand] == UNKNOWN]
                        if not len(pend):
                            break
                        vals = leaf_vals[leaf.key]
                        need = pend[vals[pend] == UNKNOWN]
                        if not len(need):
                            continue
                        oracle = self._session_oracle(leaf.oracle)
                        c0 = oracle.calls
                        dec, _, online, dmech = self._decide_pending(
                            arts[leaf.key], oracle, need)
                        vals[need] = np.asarray(dec, bool).astype(np.int8)
                        last_mech[need] = dmech
                        last_writer[need] = oi
                        online_by_key[leaf.key] += online
                        charged_by_key[leaf.key] += oracle.calls - c0
                    member = child.evaluate(leaf_vals)[cand] == TRUE
                    newly = []
                    for doc in cand[member]:
                        if len(accepted) < k:
                            accepted.append(int(doc))
                            newly.append(int(doc))
                    rejected_now = np.setdiff1d(cand, np.asarray(
                        newly, np.int64), assume_unique=True)
                    self._partial(np.asarray(newly, np.int64), rejected_now)
        except OracleError as exc:
            if mode == "fail":
                raise
            degrade_error = exc
            self._notify("degraded")
            if mode == "defer":
                if order_idx is None:
                    unresolved = np.arange(n, dtype=np.int64)
                else:
                    rest = order_idx[walked:]
                    done_vals = child.evaluate(leaf_vals)
                    undecided = np.nonzero(done_vals == UNKNOWN)[0]
                    unresolved = np.union1d(rest, undecided).astype(
                        np.int64)
                self.repark(RepairTicket(
                    predicate=predicate,
                    accuracy_target=ccfg.accuracy_target,
                    ground_truth=ground_truth, seed=seed,
                    unresolved=unresolved, error=str(exc), name=name))
            else:  # proxy_fallback: 0.5-cut membership, rank cut on top
                filled_any = np.zeros(n, bool)
                for oi, leaf in enumerate(order):
                    art = arts.get(leaf.key)
                    if art is None:
                        continue
                    vals = leaf_vals[leaf.key]
                    unk = np.nonzero(vals == UNKNOWN)[0]
                    vals[unk] = (art.scores[unk] > 0.5).astype(np.int8)
                    filled_any[unk] = True
                    last_mech[unk] = trace_mod.PROXY_FALLBACK
                    last_writer[unk] = oi
                if order_idx is not None and len(arts) == len(leaves):
                    member_vals = child.evaluate(leaf_vals)
                    in_order = order_idx[member_vals[order_idx] == TRUE]
                    accepted = [int(d) for d in in_order[:k]]
                    fallback_docs = int(filled_any.sum())

        mask = np.zeros(n, bool)
        if accepted:
            mask[np.asarray(accepted, np.int64)] = True

        walked_docs = (order_idx[:walked] if order_idx is not None
                       else np.zeros(0, np.int64))
        # provenance: docs never walked, and walked members beyond k,
        # were excluded by the rank cut itself -> topk_skip. Short-
        # circuit remapping is skipped (the rank walk short-circuits by
        # design; topk_skip is the informative class).
        walked_mask = np.zeros(n, bool)
        if len(walked_docs):
            walked_mask[walked_docs] = True
        member_vals = child.evaluate(leaf_vals)
        skip_idx = np.nonzero(~mask & (~walked_mask
                                       | (member_vals == TRUE)))[0]
        provenance = self._assemble_provenance(
            mask, last_mech, last_writer, [lf.name for lf in order],
            unresolved=unresolved, topk_skip=skip_idx)
        reports: List[LeafReport] = []
        for leaf in order:
            art = arts.get(leaf.key)
            vals = leaf_vals[leaf.key]
            decided = (walked_docs[vals[walked_docs] != UNKNOWN]
                       if len(walked_docs) else walked_docs)
            tc, reused = train_info.get(leaf.key, (0, False))
            cres = None
            if art is not None:
                cres = CascadeResult(
                    labels=vals[decided] == TRUE, l=art.l, r=art.r,
                    unfiltered_rate=(online_by_key[leaf.key]
                                     / max(len(decided), 1)),
                    oracle_calls_online=online_by_key[leaf.key],
                    oracle_calls_calib=build_calib[leaf.key],
                    est_accuracy=art.est_accuracy,
                    certified=art.certified)
            reports.append(LeafReport(
                name=leaf.name, key=leaf.key, n_pending=int(len(decided)),
                oracle_calls_train=tc,
                oracle_calls_calib=build_calib[leaf.key],
                oracle_calls_online=online_by_key[leaf.key],
                proxy_reused=reused, cascade=cres,
                pending=np.asarray(decided, np.int64),
                scores=(art.scores[decided] if art is not None else None),
                labels=(vals[decided] == TRUE),
                oracle_docs_charged=charged_by_key[leaf.key]))

        total = sum(o.calls - before for o, before in calls_before.values())
        result = FilterResult(
            mask=mask,
            oracle_calls_total=total,
            oracle_calls_train=sum(c for c, _ in train_info.values()),
            leaf_reports=reports,
            plan=(f"topk[k={k}]: "
                  + (" -> ".join(r.name for r in reports) or "(decided)")),
            wall_seconds=time.time() - t0,
            n_docs=n,
            scoring_stats=scoring_stats,
            **self._degrade_fields(mode, degrade_error, unresolved,
                                   fallback_docs, reports, n),
            provenance=provenance)
        return self._finish(result, ground_truth)

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
        if not res.leaf_reports:
            # outage before the leaf completed (degrade swallowed it)
            leaf = LeafReport(
                name=pred.name, key=pred.key, n_pending=res.n_docs,
                oracle_calls_train=res.oracle_calls_train,
                oracle_calls_calib=0, oracle_calls_online=0,
                proxy_reused=False, cascade=None,
                pending=np.arange(res.n_docs), scores=None, labels=None)
        else:
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
            scores=leaf.scores,
            degraded=res.degraded,
            degrade_mode=res.degrade_mode,
            unresolved_docs=len(res.unresolved),
            fallback_docs=res.fallback_docs,
            est_accuracy_debit=res.est_accuracy_debit)


def _derivable_leaf_truth(predicate: Predicate,
                          ground_truth: Optional[np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """Root truth maps onto a leaf only for trivial shapes (leaf, ~leaf);
    composed predicates report F1 at the root instead."""
    if ground_truth is None:
        return {}
    truth = np.asarray(ground_truth).astype(bool)
    if isinstance(predicate, SemanticPredicate):
        return {predicate.key: truth}
    if isinstance(predicate, Not) and isinstance(predicate.child,
                                                 SemanticPredicate):
        return {predicate.child.key: ~truth}
    return {}
