"""The port's resilient oracle plane (``repro_torch.serve.resilience``).

(a) The JAX package's own gates for ChaosOracle and ResilientOracle
    (tests/test_resilience.py, the ChaosOracle and ResilientOracle
    sections), run on the port's modules. Retries sleep through the
    injectable ``sleep`` (a recorder, so no test waits on the wall
    clock), and the breaker's cooldown passes on an injected clock.
(b) Parity: the same ChaosConfig, RetryPolicy, BreakerConfig and seed
    give, in both packages, the same fault schedule invocation by
    invocation, the same outcome of every ask (labels, or the
    OracleUnavailable's docs, retry_after and breaker_open), the same
    jitter delays (bitwise: both draw them from one numpy stream) and the
    same ``resilience_stats()`` and purchase counters.
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro.core.oracle import CachedOracle as JCachedOracle
from repro.core.oracle import SimulatedOracle as JOracle
from repro.serve import resilience as jres
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.serve import (BreakerConfig, ChaosConfig, ChaosOracle,
                               OracleFault, OracleTimeout,
                               OracleUnavailable, ResilientOracle,
                               RetryPolicy, decorrelated_jitter)
from torch_threads import one_torch_thread  # noqa: F401


class CountingOracle:
    """Per-doc purchase ledger around a raw oracle: the witness for the
    no-double-purchase invariant."""

    def __init__(self, inner):
        self.inner = inner
        self.per_doc = {}
        self._lock = threading.Lock()

    @property
    def calls(self):
        return self.inner.calls

    def label(self, indices):
        indices = np.asarray(indices, np.int64)
        with self._lock:
            for i in indices:
                self.per_doc[int(i)] = self.per_doc.get(int(i), 0) + 1
        return self.inner.label(indices)


FAST_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.0005,
                         max_delay_s=0.002, deadline_s=10.0)
FAST_BREAKER = BreakerConfig(failure_threshold=3, cooldown_s=0.05,
                             probe_retry_after_s=0.01)


class Clock:
    """A clock the test advances; ``sleep`` records and advances it."""

    def __init__(self):
        self.t = 0.0
        self.slept = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.slept.append(s)
        self.t += s


def _resilient(truth, chaos=None, *, retry=FAST_RETRY,
               breaker=FAST_BREAKER, seed=0, clock=None, **kw):
    """(resilient, chaos_oracle, counting, clock) over a SimulatedOracle."""
    clock = clock or Clock()
    counting = CountingOracle(SimulatedOracle(truth))
    chaos_o = ChaosOracle(counting, chaos or ChaosConfig())
    kw.setdefault("sleep", clock.sleep)
    res = ResilientOracle(CachedOracle(chaos_o), retry=retry,
                          breaker=breaker, seed=seed, clock=clock, **kw)
    return res, chaos_o, counting, clock


# -- ChaosOracle -------------------------------------------------------------


def test_chaos_schedule_is_seeded_and_interleaving_independent():
    """The fault an invocation sees depends only on (seed, k): two
    replays agree invocation by invocation."""
    truth = np.arange(64) % 2 == 0
    cfg = ChaosConfig(seed=7, fail_rate=0.3, timeout_rate=0.2)

    def schedule(chaos):
        out = []
        for _ in range(40):
            try:
                chaos.label([1, 2, 3])
                out.append("ok")
            except OracleTimeout:
                out.append("timeout")
            except OracleFault:
                out.append("drop")
        return out

    a = schedule(ChaosOracle(SimulatedOracle(truth), cfg))
    b = schedule(ChaosOracle(SimulatedOracle(truth), cfg))
    assert a == b
    assert "timeout" in a and "drop" in a and "ok" in a
    c = schedule(ChaosOracle(SimulatedOracle(truth),
                             dataclasses.replace(cfg, seed=8)))
    assert c != a


def test_chaos_faults_never_purchase():
    """Faults are raised before the inner oracle runs: a failed
    invocation buys nothing."""
    truth = np.ones(32, bool)
    counting = CountingOracle(SimulatedOracle(truth))
    chaos = ChaosOracle(counting, ChaosConfig(seed=1, fail_rate=1.0))
    for _ in range(5):
        with pytest.raises(OracleFault):
            chaos.label([0, 1, 2])
    assert counting.per_doc == {} and chaos.inner.calls == 0
    assert chaos.faults["drop"] == 5 and chaos.invocations == 5
    chaos.heal()
    np.testing.assert_array_equal(chaos.label([0, 1, 2]), truth[:3])
    assert chaos.faults["drop"] == 5    # healing stops the injection


def test_chaos_spike_sleeps_through_the_injected_sleep():
    slept = []
    chaos = ChaosOracle(SimulatedOracle(np.ones(8, bool)),
                        ChaosConfig(seed=0, spike_rate=1.0,
                                    spike_seconds=0.25),
                        sleep=slept.append)
    chaos.label([0, 1])
    assert slept == [0.25] and chaos.faults["spike"] == 1


# -- ResilientOracle ---------------------------------------------------------


def test_retry_rides_through_transients_without_double_purchase():
    truth = np.arange(128) % 3 == 0
    res, chaos, counting, clock = _resilient(
        truth, ChaosConfig(seed=3, fail_rate=0.35, timeout_rate=0.1))
    for lo in range(0, 128, 16):
        np.testing.assert_array_equal(res.label(np.arange(lo, lo + 16)),
                                      truth[lo:lo + 16])
    stats = res.resilience_stats()
    assert stats["retries"] + stats["faults"] + stats["timeouts"] > 0
    assert stats["breaker"]["state"] == "closed"
    # every backoff went through the injected sleep, within its bounds
    assert len(clock.slept) == stats["retries"] > 0
    assert all(FAST_RETRY.base_delay_s <= d <= FAST_RETRY.max_delay_s
               for d in clock.slept)
    # every doc purchased exactly once despite the retries
    assert set(counting.per_doc) == set(range(128))
    assert all(v == 1 for v in counting.per_doc.values())
    assert res.docs_purchased == 128


def test_bisect_isolates_poison_doc():
    """One poison doc in a 16-doc batch: the other 15 get labeled, the
    poison id is surfaced in OracleUnavailable.docs, the lane counts as
    alive (breaker stays closed), and the cost is O(log B)."""
    truth = np.ones(32, bool)
    res, chaos, counting, _ = _resilient(
        truth, ChaosConfig(seed=2, poison_docs=(13,)))
    with pytest.raises(OracleUnavailable) as info:
        res.label(np.arange(16))
    assert list(info.value.docs) == [13]
    assert not info.value.breaker_open
    assert res.breaker.status()["state"] == "closed"
    healthy = sorted(set(range(16)) - {13})
    assert sorted(counting.per_doc) == healthy
    assert all(v == 1 for v in counting.per_doc.values())
    assert chaos.invocations <= 3 + 2 * 5
    assert res.resilience_stats()["bisects"] >= 1
    # the healthy docs are cached: relabeling them is a pure read
    before = chaos.invocations
    np.testing.assert_array_equal(res.label(healthy), truth[healthy])
    assert chaos.invocations == before


def test_blackout_fails_whole_batch_in_logarithmic_invocations():
    truth = np.ones(64, bool)
    res, chaos, _, _ = _resilient(
        truth, ChaosConfig(seed=0, blackouts=((0, 10_000),)))
    with pytest.raises(OracleUnavailable) as info:
        res.label(np.arange(64))
    assert len(info.value.docs) == 64 and info.value.retry_after > 0
    # a fully-failing half short-circuits its sibling: max_attempts +
    # O(log B) probes, not O(B)
    assert chaos.invocations <= FAST_RETRY.max_attempts + 2 * 6 + 2
    assert res.breaker.status()["failures"] == 1


def test_breaker_opens_rejects_fast_probes_and_recloses():
    probes = []
    clock = Clock()
    truth = np.ones(16, bool)
    res, chaos, counting, _ = _resilient(
        truth, ChaosConfig(seed=0, blackouts=((0, 10_000),)), clock=clock,
        sleep=lambda s: None, on_half_open=lambda: probes.append(clock.t))
    for k in range(FAST_BREAKER.failure_threshold):
        with pytest.raises(OracleUnavailable):
            res.label([k])
    assert res.breaker.status() == {"state": "open", "failures": 3,
                                    "opens": 1}
    # open: instant reject, no invocation reaches the chaos layer
    before = chaos.invocations
    with pytest.raises(OracleUnavailable) as info:
        res.label([9])
    assert info.value.breaker_open and info.value.retry_after > 0
    assert chaos.invocations == before
    assert res.resilience_stats()["breaker_rejects"] == 1
    # cooldown elapses -> half-open admits exactly one probe purchase
    clock.t += FAST_BREAKER.cooldown_s + 0.01
    chaos.heal()
    np.testing.assert_array_equal(res.label([9]), truth[[9]])
    assert probes == [clock.t]             # on_half_open fired once
    assert res.breaker.status()["state"] == "closed"
    assert counting.per_doc == {9: 1}


def test_half_open_probe_failure_reopens():
    truth = np.ones(8, bool)
    res, chaos, _, clock = _resilient(
        truth, ChaosConfig(seed=0, blackouts=((0, 10_000),)),
        sleep=lambda s: None)
    for k in range(3):
        with pytest.raises(OracleUnavailable):
            res.label([k])
    clock.t += FAST_BREAKER.cooldown_s + 0.01
    with pytest.raises(OracleUnavailable):   # probe admitted, still down
        res.label([5])
    assert res.breaker.status()["state"] == "open"
    assert res.breaker.status()["opens"] == 2


def test_cache_reads_work_while_breaker_open():
    truth = np.arange(16) % 2 == 0
    res, chaos, _, _ = _resilient(truth, ChaosConfig(),
                                  sleep=lambda s: None)
    np.testing.assert_array_equal(res.label(np.arange(8)), truth[:8])
    chaos.chaos = ChaosConfig(blackouts=((chaos.invocations, 10_000),))
    for k in range(8, 11):
        with pytest.raises(OracleUnavailable):
            res.label([k])
    assert res.breaker.status()["state"] == "open"
    # already-purchased labels replay fine during the outage
    np.testing.assert_array_equal(res.label(np.arange(8)), truth[:8])


def test_retry_deadline_stops_the_attempts():
    """An ask whose deadline has passed takes no further retry."""
    truth = np.ones(8, bool)
    res, chaos, _, clock = _resilient(
        truth, ChaosConfig(seed=0, fail_rate=1.0),
        retry=dataclasses.replace(FAST_RETRY, deadline_s=0.0,
                                  bisect=False))
    with pytest.raises(OracleUnavailable):
        res.label([0])
    assert chaos.invocations == 1 and clock.slept == []


# -- parity with the JAX package ---------------------------------------------


def _stack(pkg, truth, chaos_cfg, retry, breaker, seed):
    """(resilient, chaos, counting, clock) of package ``pkg``, built
    from the port's configs (the JAX ones are field-for-field copies)."""
    clock = Clock()
    if pkg == "jax":
        counting = CountingOracle(JOracle(truth))
        chaos = jres.ChaosOracle(counting, jres.ChaosConfig(
            **dataclasses.asdict(chaos_cfg)))
        res = jres.ResilientOracle(
            JCachedOracle(chaos),
            retry=jres.RetryPolicy(**dataclasses.asdict(retry)),
            breaker=jres.BreakerConfig(**dataclasses.asdict(breaker)),
            seed=seed, clock=clock, sleep=clock.sleep)
    else:
        counting = CountingOracle(SimulatedOracle(truth))
        chaos = ChaosOracle(counting, chaos_cfg)
        res = ResilientOracle(CachedOracle(chaos), retry=retry,
                              breaker=breaker, seed=seed, clock=clock,
                              sleep=clock.sleep)
    return res, chaos, counting, clock


def _drive(stack, asks, heal_at):
    """Every ask's outcome, then the stack's counters."""
    res, chaos, counting, clock = stack
    out = []
    for j, ask in enumerate(asks):
        if j == heal_at:
            chaos.heal()
            clock.t += 1.0          # past any cooldown
        try:
            out.append(("ok", res.label(ask).tolist()))
        except Exception as exc:    # OracleUnavailable of either package
            out.append((type(exc).__name__, list(exc.docs),
                        exc.retry_after, exc.breaker_open))
    return dict(outcomes=out, slept=clock.slept,
                invocations=chaos.invocations, faults=dict(chaos.faults),
                stats=res.resilience_stats(), purchase=res.stats(),
                per_doc=counting.per_doc)


PARITY = {
    "transients": (ChaosConfig(seed=3, fail_rate=0.35, timeout_rate=0.1),
                   FAST_RETRY, None),
    "poison": (ChaosConfig(seed=2, fail_rate=0.2, poison_docs=(13, 40)),
               FAST_RETRY, None),
    "blackout_then_heal": (ChaosConfig(seed=5, fail_rate=0.1,
                                       blackouts=((4, 30),)),
                           dataclasses.replace(FAST_RETRY, max_attempts=4),
                           7),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_same_schedule_retries_and_delays_as_the_reference(case):
    chaos_cfg, retry, heal_at = PARITY[case]
    truth = np.arange(96) % 3 == 0
    asks = [np.arange(lo, lo + 12) for lo in range(0, 96, 12)]
    asks += [np.arange(0, 96, 5)]
    got = {pkg: _drive(_stack(pkg, truth, chaos_cfg, retry, FAST_BREAKER,
                              seed=11), asks, heal_at)
           for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert got["port"]["stats"]["retries"] > 0
    assert all(v == 1 for v in got["port"]["per_doc"].values())


def test_jitter_draws_are_the_reference_stream():
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    prev_a = prev_b = 0.001
    for _ in range(50):
        prev_a = decorrelated_jitter(a, prev_a, 0.001, 0.05)
        prev_b = jres.decorrelated_jitter(b, prev_b, 0.001, 0.05)
        assert prev_a == prev_b and 0.001 <= prev_a <= 0.05

