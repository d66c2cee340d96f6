"""The port's live plane (``repro_torch.engine.live``): standing
predicates with delta-only scoring.

(a) The JAX package's tests/test_live.py runs on the port, on the CPU:
    incremental decisions bitwise a one-shot ``standing_filter()`` at
    the same calibration watermark, exact delta-only ``rows_scored``,
    ``revalidate()`` bitwise a fresh ``filter()``, the drift monitor,
    ``MemmapStore.refresh()``, and a killed-and-resumed ingest
    delivering subscribers an uninterrupted run's deltas. Its 20-case
    interleaving soak stays under ``soak``, with cases 0 and 1 also in
    tier-1.
(b) Row locality of the delta scores themselves: ``_score_rows`` over
    ragged ranges at odd offsets gives bitwise the scores of one pass
    over the whole store. On the CPU the plain version's matrix products
    are blocked by row count, so a row scored in a tile of another
    length can differ by 1-2 ulp (at this file's D=32, H=32, L=16 and
    chunk 64, tiles of 21-23, 31, 62 and 63 rows do against 64); the
    JAX package's rule, which pads only a 1-row delta to 2 rows, leaves
    such tiles, and the test fails under it. The port pads every tail
    tile to the executor's chunk on the CPU.
(c) Parity with the JAX package: the same commit groups of one store
    directory (written by the port's ``StoreWriter``, read by both
    packages' ``MemmapStore``) through both packages' ``LiveEngine``,
    the JAX engine's trained params injected into every session view of
    both. Equal thresholds ``(l, r)``, decisions, per-batch
    ``rows_scored`` and ``oracle_calls``, and label sets bought; the
    delta scores agree to SCORE_TOL. Stated preconditions, as in
    tests/test_torch_compound.py: no registration score lies within
    SCORE_TOL of a calibration bin edge and no delta score within
    SCORE_TOL of its leaf's ``l`` or ``r``, so SCORE_TOL cannot move a
    threshold or flip a decision.
"""
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import DriftConfig as JDrift
from repro.engine import InMemoryStore as JStore
from repro.engine import LiveEngine as JLive
from repro.engine import MemmapStore as JMemmap
from repro.engine import ScaleDocEngine as JEngine
from repro.engine import SemanticPredicate as JPred
from repro.engine.live import _score_rows as j_score_rows
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.encoder import encoder_init, params_from_jax
from repro_torch.core.oracle import SimulatedOracle
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (DriftConfig, InMemoryStore, LiveEngine,
                                LiveEngineClosed, MemmapStore, RangeView,
                                ScaleDocEngine, ScoringExecutor,
                                SemanticPredicate, SemanticTopK,
                                StandingCancelled, StoreFingerprintError,
                                StoreWriter, load_manifest, standing_filter)
from repro_torch.engine.live import _score_rows
from repro_torch.engine.store import MANIFEST_NAME
from torch_threads import one_torch_thread  # noqa: F401

import torch

N_DOCS, DIM = 512, 32
FPR = {"model": "live-test"}
SCORE_TOL = 1e-6


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(3, n_docs=N_DOCS, dim=DIM)


PROXY = dict(embed_dim=DIM, hidden_dim=32, latent_dim=16, proj_dim=8,
             phase1_steps=8, phase2_steps=8, batch_size=32)


@pytest.fixture(scope="module")
def cfgs():
    return ProxyConfig(**PROXY), CascadeConfig(accuracy_target=0.85)


def _open_live(directory, cfgs, **kwargs):
    pcfg, ccfg = cfgs
    kwargs.setdefault("drift", DriftConfig(auto=False))
    return LiveEngine(MemmapStore.open(directory), pcfg, ccfg,
                      chunk=64, device="cpu", **kwargs)


def _drain(sub):
    out = []
    while True:
        try:
            out.append(sub._q.get_nowait())
        except queue.Empty:
            return out


def _replay(batches, n):
    """Reconstruct a decision mask from a delta stream the way a
    subscriber must: append delta batches, *replace* on revalidated."""
    dec = np.zeros(n, bool)
    for b in batches:
        if b.final:
            continue
        dec[np.asarray(b.accepted, np.int64)] = True
        dec[np.asarray(b.rejected, np.int64)] = False
    return dec


# -- (a) store views -----------------------------------------------------------


def test_rangeview_window_semantics(corpus):
    store = InMemoryStore(corpus.embeds)
    view = RangeView(store, 100, 260)
    assert len(view) == 160 and view.dim == DIM
    np.testing.assert_array_equal(view.get([0, 5]),
                                  corpus.embeds[[100, 105]])
    blocks = list(view.iter_chunks(chunk=64))
    assert [start for start, _ in blocks] == [0, 64, 128]
    np.testing.assert_array_equal(
        np.concatenate([b for _, b in blocks]), corpus.embeds[100:260])
    with pytest.raises(ValueError):
        RangeView(store, 10, 5)


# -- (a) watermark-aware refresh + fingerprint guard ---------------------------


def test_refresh_tracks_commits_only(corpus, tmp_path):
    E = corpus.embeds
    w = StoreWriter.open(tmp_path, dim=DIM, fingerprint=FPR)
    w.append(E[:8])
    w.commit()
    store = MemmapStore.open(tmp_path)
    assert len(store) == 8 and store.watermark == 8

    w.append(E[8:12])
    w.commit()
    w.append(E[12:20])              # appended but never committed
    assert len(store) == 8          # a reader never moves on its own
    assert store.refresh() == 12    # committed rows only: torn tail invisible
    assert store.watermark == 12
    np.testing.assert_array_equal(store.get(np.arange(12)), E[:12])
    assert store.refresh() == 12    # idempotent with no new commits
    w.close()


def test_refresh_rejects_producer_swap(corpus, tmp_path):
    w = StoreWriter.open(tmp_path, dim=DIM, fingerprint=FPR)
    w.append(corpus.embeds[:16])
    w.commit()
    w.close()
    store = MemmapStore.open(tmp_path)

    # a different producer re-created the directory under the reader
    manifest = load_manifest(tmp_path)
    swapped = manifest.to_json().replace("live-test", "other-producer")
    (tmp_path / MANIFEST_NAME).write_text(swapped)
    with pytest.raises(StoreFingerprintError):
        store.refresh()

    # a shrinking committed row count is the same corruption signal
    (tmp_path / MANIFEST_NAME).write_text(
        manifest.to_json().replace('"rows": 16', '"rows": 4'))
    fresh = MemmapStore.open(tmp_path)      # opens fine at 4 rows...
    assert len(fresh) == 4
    (tmp_path / MANIFEST_NAME).write_text(
        manifest.to_json().replace('"rows": 16', '"rows": 2'))
    with pytest.raises(StoreFingerprintError):
        fresh.refresh()                     # ...but never retracts


# -- (a) incremental == one-shot, with exact scored-row accounting ------------


def test_incremental_bitwise_equals_one_shot(corpus, cfgs, tmp_path):
    """Ragged commit groups (a single row among them), one pump per
    group: decisions bitwise equal a single registration at the same
    calibration watermark, and each batch's ``rows_scored`` counter
    shows exactly (hi - lo) * scorable leaves — delta rows only, never
    the prefix."""
    E = corpus.embeds
    w0 = 128
    qa = make_query(corpus, 21)
    qb = make_query(corpus, 22)
    oa, ob = SimulatedOracle(qa.truth), SimulatedOracle(qb.truth)
    pred = (SemanticPredicate(qa.embed, oa, name="a")
            & ~SemanticPredicate(qb.embed, ob, name="b"))

    w = StoreWriter.open(tmp_path, dim=DIM, fingerprint=FPR)
    w.append(E[:w0])
    w.commit()
    live = _open_live(tmp_path, cfgs)
    sp = live.register(pred, seed=5)
    assert (sp.calib_rows, sp.watermark) == (w0, w0)
    sub = sp.subscribe()

    hi = w0
    for size in (1, 37, 96, 3, 150, 97):    # sums to N_DOCS - w0
        w.append(E[hi:hi + size])
        w.commit()
        hi += size
        assert live.pump() == hi
    w.close()
    assert hi == N_DOCS and sp.watermark == N_DOCS

    n_scorable = sum(ls.scorable for ls in sp._leaves)
    assert n_scorable >= 1
    batches = _drain(sub)
    assert [(b.lo, b.hi) for b in batches] == [
        (128, 129), (129, 166), (166, 262), (262, 265), (265, 415),
        (415, 512)]
    for b in batches:
        assert b.rows_scored == (b.hi - b.lo) * n_scorable
        assert len(b.accepted) + len(b.rejected) == b.hi - b.lo
    assert sp.rows_scored_total == (N_DOCS - w0) * n_scorable
    assert sp.delta_batches == 6

    # the one-shot reference: same predicate object (leaf identity
    # drives calibration sampling), same calibration watermark
    ref = standing_filter(MemmapStore.open(tmp_path), pred, seed=5,
                          calib_rows=w0, proxy_cfg=cfgs[0],
                          cascade_cfg=cfgs[1], chunk=64, device="cpu")
    np.testing.assert_array_equal(sp.decisions, ref.decisions)
    # and the subscriber's replayed stream reconstructs the same mask
    replayed = _replay(batches, N_DOCS)
    np.testing.assert_array_equal(replayed[w0:], sp.decisions[w0:])
    live.close()
    assert _drain(sub)[-1].final            # close() pushed the sentinel


def test_revalidate_matches_fresh_filter(corpus, cfgs, tmp_path):
    E = corpus.embeds
    q = make_query(corpus, 31)
    pred = SemanticPredicate(q.embed, SimulatedOracle(q.truth), name="r")

    w = StoreWriter.open(tmp_path, dim=DIM, fingerprint=FPR)
    w.append(E[:192])
    w.commit()
    live = _open_live(tmp_path, cfgs)
    sp = live.register(pred, seed=2)
    sub = sp.subscribe()
    w.append(E[192:])
    w.commit()
    w.close()
    live.pump()

    batch = sp.revalidate()
    assert batch.revalidated and (batch.lo, batch.hi) == (0, N_DOCS)
    assert sp.calib_rows == N_DOCS and sp.revalidations == 1
    assert len(batch.accepted) + len(batch.rejected) == N_DOCS

    pcfg, ccfg = cfgs
    fresh = ScaleDocEngine(MemmapStore.open(tmp_path), pcfg, ccfg,
                           chunk=64, device="cpu").filter(pred, seed=2)
    np.testing.assert_array_equal(sp.decisions, fresh.mask.astype(bool))
    # the stream replays to the same mask (revalidated batch replaces)
    np.testing.assert_array_equal(_replay(_drain(sub), N_DOCS),
                                  sp.decisions)
    live.close()


def test_lifecycle_and_cancel_semantics(corpus, cfgs):
    q = make_query(corpus, 41)
    pred = SemanticPredicate(q.embed, SimulatedOracle(q.truth), name="c")
    live = LiveEngine(InMemoryStore(corpus.embeds), *cfgs,
                      drift=DriftConfig(auto=False), chunk=64, device="cpu")
    sp = live.register(pred, seed=0)
    sub = sp.subscribe()
    assert live.get(sp.id) is sp and live.standing() == [sp]
    with pytest.raises(TypeError, match="SemanticTopK"):
        live.register(SemanticTopK(pred, k=5))

    assert sp.cancel() is True
    assert sp.cancel() is False             # idempotent
    assert live.get(sp.id) is None
    assert _drain(sub)[-1].final
    with pytest.raises(StandingCancelled):
        sp.subscribe()
    with pytest.raises(StandingCancelled):
        live.revalidate(sp)

    live.close()
    with pytest.raises(LiveEngineClosed):
        live.register(pred)
    with pytest.raises(LiveEngineClosed):
        live.pump()


# -- (a) drift monitor ---------------------------------------------------------


def _drifted_layout(corpus, seed):
    """A store ordering whose tail breaks calibration: mixed prefix,
    then a pure-positive suffix (delta selectivity -> 1.0)."""
    q = make_query(corpus, seed, selectivity=0.3)
    rng = np.random.default_rng(seed)
    pos = np.nonzero(q.truth)[0]
    neg = np.nonzero(~q.truth)[0]
    prefix = np.concatenate([pos[:64], neg[:192]])
    rng.shuffle(prefix)
    tail = pos[64:192]                      # 128 rows, all positive
    perm = np.concatenate([prefix, tail])
    return corpus.embeds[perm], q.truth[perm], len(prefix)


def test_drift_trips_and_auto_revalidates(corpus, cfgs, tmp_path):
    E, truth, w0 = _drifted_layout(corpus, 61)
    q = make_query(corpus, 61, selectivity=0.3)
    pred = SemanticPredicate(q.embed, SimulatedOracle(truth), name="d")
    drift = DriftConfig(window=256, min_rows=64, selectivity_slack=0.2,
                        ambiguous_slack=0.5, auto=True)

    w = StoreWriter.open(tmp_path, dim=DIM, fingerprint=FPR)
    w.append(E[:w0])
    w.commit()
    live = _open_live(tmp_path, cfgs, drift=drift)
    sp = live.register(pred, seed=4)
    sub = sp.subscribe()
    status = sp.drift_status()
    assert not status["triggered"] and status["rows"] == 0

    w.append(E[w0:])
    w.commit()
    w.close()
    live.pump()

    # the all-positive tail trips the selectivity gate and auto mode
    # immediately recalibrates over the full collection
    assert sp.drift_trips == 1 and sp.revalidations == 1
    assert sp.calib_rows == len(E)
    batches = _drain(sub)
    assert [b.revalidated for b in batches] == [False, True]
    pcfg, ccfg = cfgs
    fresh = ScaleDocEngine(MemmapStore.open(tmp_path), pcfg, ccfg,
                           chunk=64, device="cpu").filter(pred, seed=4)
    np.testing.assert_array_equal(sp.decisions, fresh.mask.astype(bool))
    live.close()


def test_drift_manual_mode_only_surfaces_trigger(corpus, cfgs):
    E, truth, w0 = _drifted_layout(corpus, 62)
    q = make_query(corpus, 62, selectivity=0.3)
    pred = SemanticPredicate(q.embed, SimulatedOracle(truth), name="m")
    drift = DriftConfig(window=256, min_rows=64, selectivity_slack=0.2,
                        ambiguous_slack=0.5, auto=False)

    store = InMemoryStore(E[:w0])
    live = LiveEngine(store, *cfgs, drift=drift, chunk=64, device="cpu")
    sp = live.register(pred, seed=4)
    store._embeds = np.asarray(E, np.float32)     # "commit" the tail
    live.pump()

    status = sp.drift_status()
    assert status["triggered"]
    assert status["selectivity_drift"] > drift.selectivity_slack
    assert sp.drift_trips == 0 and sp.revalidations == 0
    assert sp.watermark == len(E)           # deltas still processed
    live.close()


# -- (a) the interleaving/soak parity harness ----------------------------------


def _check_stream(sp, batches, calib0, n_docs):
    """Structural invariants of one registration-time subscription:
    contiguous coverage from the registration watermark, replace-on-
    revalidate, and — for every batch under the final calibration —
    exact delta-only scored-row accounting."""
    assert batches or calib0 == n_docs, "subscription saw no batches"
    deltas = [b for b in batches if not b.final and not b.revalidated]
    revals = [b for b in batches if b.revalidated]
    watermark = calib0
    for b in batches:
        if b.final:
            continue
        if b.revalidated:
            assert b.lo == 0
        else:
            assert b.lo == watermark, "delta stream skipped or re-sent rows"
        watermark = b.hi
        assert len(b.accepted) + len(b.rejected) == (
            b.hi - b.lo if not b.revalidated else b.hi)
    assert watermark == n_docs

    # batches after the last revalidation ran under the final frozen
    # calibration: exact counter check, delta rows only
    n_scorable = sum(ls.scorable for ls in sp._leaves)
    tail = deltas if not revals else [
        b for b in deltas if b.seq > revals[-1].seq]
    assert sum(b.hi - b.lo for b in tail) == n_docs - sp.calib_rows
    for b in tail:
        assert b.rows_scored == (b.hi - b.lo) * n_scorable
    assert sp.rows_scored_total == sum(b.rows_scored for b in deltas)


@pytest.mark.parametrize("case", [
    c if c < 2 else pytest.param(c, marks=pytest.mark.soak)
    for c in range(20)])
def test_interleaving_soak_parity(corpus, cfgs, tmp_path, case):
    """Acceptance gate: a seeded random schedule of {ingest batch,
    register, subscribe, revalidate, cancel, pump} on the main thread
    while two chaos threads pump concurrently. Whatever interleaving
    the scheduler produces, every surviving standing predicate's
    decisions are bitwise what a one-shot ``standing_filter()`` at its
    (final) calibration watermark computes over the final store."""
    rng = np.random.default_rng(1000 + case)
    pcfg, ccfg = cfgs
    E = corpus.embeds

    qa = make_query(corpus, 200 + case)
    qb = make_query(corpus, 300 + case)
    pa = SemanticPredicate(qa.embed, SimulatedOracle(qa.truth), name="a")
    pb = SemanticPredicate(qb.embed, SimulatedOracle(qb.truth), name="b")
    preds = [pa, pb, pa & ~pb, pa | pb]

    w = StoreWriter.open(tmp_path, dim=DIM, fingerprint=FPR)
    written = int(rng.choice([128, 192, 256]))
    w.append(E[:written])
    w.commit()
    live = _open_live(tmp_path, cfgs)

    registered = []                 # (sp, registration sub, calib0)
    stop = threading.Event()
    errors = []

    def chaos_pump():
        while not stop.is_set():
            try:
                live.pump()
            except Exception as exc:    # surfaced after join
                errors.append(exc)
                return
            time.sleep(0.002)

    threads = [threading.Thread(target=chaos_pump, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()

    ops = rng.choice(["ingest", "register", "subscribe", "revalidate",
                      "cancel", "pump"],
                     size=10, p=[.3, .2, .15, .1, .1, .15])
    for op in ops:
        if op == "ingest" and written < N_DOCS:
            step = int(rng.choice([1, 32, 64, 96]))
            nxt = min(written + step, N_DOCS)
            w.append(E[written:nxt])
            w.commit()
            written = nxt
        elif op == "register" and len(registered) < 2:
            sp = live.register(preds[int(rng.integers(len(preds)))],
                               seed=int(rng.integers(4)))
            registered.append((sp, sp.subscribe(), sp.calib_rows))
        elif op == "subscribe" and registered:
            sp = registered[int(rng.integers(len(registered)))][0]
            if not sp.cancelled:
                sp.subscribe()
        elif op == "revalidate" and registered:
            sp = registered[int(rng.integers(len(registered)))][0]
            if not sp.cancelled:
                sp.revalidate()
        elif op == "cancel" and len(registered) > 1:
            sp, sub, _ = registered.pop(0)
            sp.cancel()
            assert _drain(sub)[-1].final
        elif op == "pump":
            live.pump()
        time.sleep(float(rng.uniform(0, 0.004)))

    if not registered:              # every schedule must test something
        sp = live.register(preds[0], seed=0)
        registered.append((sp, sp.subscribe(), sp.calib_rows))
    if written < N_DOCS:
        w.append(E[written:])
        w.commit()
        written = N_DOCS
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    live.pump()                     # drain to the final watermark
    w.close()

    for sp, sub, calib0 in registered:
        assert sp.watermark == N_DOCS
        ref = standing_filter(MemmapStore.open(tmp_path), sp.predicate,
                              seed=sp.seed, calib_rows=sp.calib_rows,
                              proxy_cfg=pcfg, cascade_cfg=ccfg, chunk=64,
                              device="cpu")
        np.testing.assert_array_equal(sp.decisions, ref.decisions)
        batches = _drain(sub)
        _check_stream(sp, batches, calib0, N_DOCS)
        np.testing.assert_array_equal(
            _replay(batches, N_DOCS)[calib0:], sp.decisions[calib0:])
    live.close()


# -- (a) kill/resume with live subscribers -------------------------------------

_WRITER_SCRIPT = r"""
import os, signal, sys
from repro_torch.data import make_corpus
from repro_torch.engine.store import StoreWriter

directory, mode = sys.argv[1], sys.argv[2]
E = make_corpus(5, n_docs=384, dim=32).embeds
w = StoreWriter.open(directory, dim=32, fingerprint={"model": "live-test"})
if mode == "kill":
    # two committed groups, then a torn (uncommitted) tail, then die
    w.append(E[160:224]); w.commit()
    w.append(E[224:288]); w.commit()
    w.append(E[288:317])
    w._f.flush()
    os.kill(os.getpid(), signal.SIGKILL)
else:
    assert w.rows == 288, w.rows        # resume truncated the torn tail
    w.append(E[288:384]); w.commit()
    w.close()
    print("RESUME-OK")
"""


def _run_writer(directory, mode):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = (os.path.abspath(src) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-c", _WRITER_SCRIPT, str(directory), mode],
        capture_output=True, text=True, env=env, timeout=600)


def test_kill_resume_delivers_identical_deltas(cfgs, tmp_path):
    """SIGKILL the ingest mid-commit-group while a standing predicate is
    subscribed; resume; the delivered delta batches — boundaries,
    accepted/rejected ids, scored-row counters — are identical to an
    uninterrupted run over the same corpus."""
    corpus5 = make_corpus(5, n_docs=384, dim=DIM)
    E = corpus5.embeds
    q = make_query(corpus5, 9)
    # one predicate object shared by both runs: leaf identity drives
    # calibration sampling, and the oracle is deterministic
    pred = SemanticPredicate(q.embed, SimulatedOracle(q.truth), name="k")

    def run(directory, interrupted):
        w = StoreWriter.open(directory, dim=DIM, fingerprint=FPR)
        w.append(E[:160])
        w.commit()
        w.close()
        live = _open_live(directory, cfgs)
        sp = live.register(pred, seed=1)
        sub = sp.subscribe()
        if interrupted:
            proc = _run_writer(directory, "kill")
            assert proc.returncode == -signal.SIGKILL, proc.stderr
            live.pump()
            assert sp.watermark == 288      # torn tail stays invisible
            proc = _run_writer(directory, "resume")
            assert proc.returncode == 0, proc.stderr
            assert "RESUME-OK" in proc.stdout
            live.pump()
        else:
            w = StoreWriter.open(directory, dim=DIM, fingerprint=FPR)
            w.append(E[160:224])
            w.commit()
            w.append(E[224:288])
            w.commit()
            live.pump()                     # folds both commit groups
            w.append(E[288:384])
            w.commit()
            w.close()
            live.pump()
        assert sp.watermark == 384
        batches = [b for b in _drain(sub) if not b.final]
        live.close()
        return sp, batches

    sp_ref, ref = run(tmp_path / "uninterrupted", interrupted=False)
    sp_got, got = run(tmp_path / "killed", interrupted=True)

    assert [(b.lo, b.hi) for b in got] == [(160, 288), (288, 384)]
    assert len(got) == len(ref)
    for b_got, b_ref in zip(got, ref):
        assert (b_got.lo, b_got.hi) == (b_ref.lo, b_ref.hi)
        np.testing.assert_array_equal(b_got.accepted, b_ref.accepted)
        np.testing.assert_array_equal(b_got.rejected, b_ref.rejected)
        assert b_got.rows_scored == b_ref.rows_scored
        assert b_got.oracle_calls == b_ref.oracle_calls
    np.testing.assert_array_equal(sp_got.decisions, sp_ref.decisions)


# -- (b) row locality of the delta scores --------------------------------------

RAGGED = [(129, 1), (131, 2), (133, 3), (171, 7), (195, 37), (271, 150)]


@pytest.mark.parametrize("lo, m", RAGGED)
def test_score_rows_is_row_local_over_ragged_ranges(corpus, lo, m):
    """The delta scores of rows ``[lo, lo + m)`` equal, bit for bit,
    their scores in one pass over the whole store (512 rows: eight full
    tiles of the executor's 64), whatever ``m`` and offset."""
    pcfg = ProxyConfig(**PROXY)
    params = encoder_init(torch.Generator().manual_seed(7), pcfg)
    e_q = make_query(corpus, 21).embed
    store = InMemoryStore(corpus.embeds)
    executor = ScoringExecutor(chunk=64, device="cpu")
    full, _ = _score_rows(executor, params, e_q, store, 0, N_DOCS)
    got, stats = _score_rows(executor, params, e_q, store, lo, lo + m)
    assert got.shape == (m,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, full[lo:lo + m])
    # the pad: every tile of the range scored at the executor's chunk
    assert stats.docs_scored == -(-m // 64) * 64
    assert stats.tiles_scored == -(-m // 64)


# -- (c) parity with the JAX package -------------------------------------------

GROUPS = (1, 3, 37, 64, 150, 129)           # sums to N_DOCS - W0
W0 = 128


def _inject(engine, params, views):
    """Every session view the live engine opens starts from ``params``
    (leaf key -> proxy) as cached proxies, so neither package trains;
    each view is kept for the precondition checks."""
    open_view = engine.session_view

    def session_view(**kw):
        view = open_view(**kw)
        view._proxies.update(params)
        views.append(view)
        return view
    engine.session_view = session_view


@pytest.fixture(scope="module")
def jax_params(corpus):
    """The two leaves, trained once by the JAX engine over the corpus."""
    qs = [make_query(corpus, 21), make_query(corpus, 22)]
    je = JEngine(JStore(corpus.embeds), JProxyCfg(**PROXY),
                 JCascadeCfg(accuracy_target=0.85))
    leaves = [JPred(q.embed, JOracle(q.truth)) for q in qs]
    je.filter(leaves[0] & leaves[1], seed=0)
    return qs, [je._proxies[p.key] for p in leaves]


@pytest.mark.parametrize("form", ["leaf", "and_not"])
def test_live_decisions_match_the_jax_package(corpus, jax_params, tmp_path,
                                              form):
    qs, params = jax_params
    E = corpus.embeds
    j_sims = [JOracle(q.truth) for q in qs]
    t_sims = [SimulatedOracle(q.truth) for q in qs]
    jl = [JPred(q.embed, o, name=f"p{i}")
          for i, (q, o) in enumerate(zip(qs, j_sims))]
    tl = [SemanticPredicate(q.embed, o, name=f"p{i}")
          for i, (q, o) in enumerate(zip(qs, t_sims))]
    shape = (lambda p: p[0]) if form == "leaf" else (lambda p: p[0] & ~p[1])

    w = StoreWriter.open(tmp_path, dim=DIM, fingerprint=FPR)
    w.append(E[:W0])
    w.commit()
    jlive = JLive(JMemmap.open(tmp_path), JProxyCfg(**PROXY),
                  JCascadeCfg(accuracy_target=0.85),
                  drift=JDrift(auto=False), chunk=64)
    tlive = _open_live(tmp_path, (ProxyConfig(**PROXY),
                                  CascadeConfig(accuracy_target=0.85)))
    jviews, tviews = [], []
    _inject(jlive.engine, {a.key: p for a, p in zip(jl, params)}, jviews)
    _inject(tlive.engine, {b.key: params_from_jax(p)
                           for b, p in zip(tl, params)}, tviews)
    jsp = jlive.register(shape(jl), seed=0)
    tsp = tlive.register(shape(tl), seed=0)
    jsub, tsub = jsp.subscribe(), tsp.subscribe()
    hi = W0
    for size in GROUPS:
        w.append(E[hi:hi + size])
        w.commit()
        hi += size
        assert jlive.pump() == tlive.pump() == hi
    w.close()
    assert hi == N_DOCS

    # preconditions: no registration score near a calibration bin edge,
    # no delta score near its leaf's thresholds
    edges = np.linspace(0.0, 1.0, JCascadeCfg().num_bins + 1)
    for view in jviews:
        for art in view._decisions.values():
            gap = np.abs(art.scores[:, None] - edges[None, :]).min()
            assert gap > SCORE_TOL, f"precondition: a score {gap:g} " \
                "from a calibration bin edge"
    assert len(jsp._leaves) == len(tsp._leaves)
    for a, b in zip(jsp._leaves, tsp._leaves):
        assert a.name == b.name and a.scorable == b.scorable
        assert (a.l, a.r) == (b.l, b.r)
        if not a.scorable:
            continue
        js, _ = j_score_rows(jlive.engine.executor, a.params, a.e_q,
                             jlive.store, W0, N_DOCS)
        ts, _ = _score_rows(tlive.engine.executor, b.params, b.e_q,
                            tlive.store, W0, N_DOCS)
        assert np.abs(ts - js).max() <= SCORE_TOL
        near = np.minimum(np.abs(js - a.l), np.abs(js - a.r)).min()
        assert near > SCORE_TOL, f"precondition: a delta score {near:g} " \
            "from a threshold"

    np.testing.assert_array_equal(tsp.decisions, jsp.decisions)
    assert tsp.calibration_oracle_calls == jsp.calibration_oracle_calls
    jb = [b for b in _drain(jsub) if not b.final]
    tb = [b for b in _drain(tsub) if not b.final]
    assert [(b.lo, b.hi) for b in tb] == [(b.lo, b.hi) for b in jb]
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b.accepted, a.accepted)
        np.testing.assert_array_equal(b.rejected, a.rejected)
        assert (b.rows_scored, b.oracle_calls) == \
            (a.rows_scored, a.oracle_calls)
    for a, b in zip(j_sims, t_sims):
        assert a.queried == b.queried
        assert a.calls == b.calls
    jlive.close()
    tlive.close()
