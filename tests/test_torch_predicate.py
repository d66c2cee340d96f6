"""Port parity of the predicate algebra, the wire codec, the optimizer's
shared caches and the provenance map against the JAX package.

The algebra (tree shape, leaf dedup, Kleene tables, plan order and
estimates) runs on both packages and must give the same orders and
estimates within 1e-12. A ``repro`` ``to_wire`` payload (v1, and v2 with
a ``topk`` root) decodes in ``repro_torch`` to the same leaf keys and
re-encodes to an equal JSON dict; malformed payloads raise
``WireFormatError`` in both. ``SelectivityStats`` and ``QueryOptimizer``
keep the JAX package's unit tests.
"""
import base64
import json
import sys
import threading
import time

import numpy as np
import pytest

from repro.core.oracle import CachedOracle as JCachedOracle
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import predicate as jp
from repro.runtime import trace as jtrace
from repro_torch.core.oracle import CachedOracle, SimulatedOracle
from repro_torch.engine import predicate as tp
from repro_torch.engine.optimizer import QueryOptimizer, SelectivityStats
from repro_torch.runtime import trace as ttrace

try:
    from hypothesis import given, settings, strategies as st
except ImportError:         # a dev-only dependency (requirements-dev.txt)
    given = None

PLAN_TOL = 1e-12


class _NamedOracle:
    def __init__(self, name):
        self.wire_name = name


_REGISTRY = {f"o{j}": _NamedOracle(f"o{j}") for j in range(3)}


def _embed(seed, dim=8):
    return np.random.default_rng(seed).normal(size=dim).astype(np.float32)


def _leaves(mod, names=("a", "b", "c")):
    """One leaf per name in ``mod`` (either package), over the shared
    registry's oracles, so both packages' keys are equal."""
    return [mod.SemanticPredicate(_embed(j), _REGISTRY[f"o{j}"], name=nm)
            for j, nm in enumerate(names)]


def _instantiate(shape, leaves):
    op = shape[0]
    if op == "leaf":
        return leaves[shape[1]]
    if op == "not":
        return ~_instantiate(shape[1], leaves)
    a, b = _instantiate(shape[1], leaves), _instantiate(shape[2], leaves)
    return a & b if op == "and" else a | b


# -- the algebra (tests/test_engine.py's cases on both packages) --------------

@pytest.mark.parametrize("mod", [jp, tp], ids=["repro", "repro_torch"])
def test_operators_build_expected_tree(mod):
    a, b, c = _leaves(mod)
    expr = (a & ~b) | c
    assert isinstance(expr, mod.Or)
    assert isinstance(expr.children[0], mod.And)
    assert isinstance(expr.children[0].children[1], mod.Not)
    assert [lf.name for lf in expr.leaves()] == ["a", "b", "c"]


def test_leaf_keys_and_dedup_match_the_reference():
    e_q = _embed(3)
    oracle = object()
    a1, a2 = tp.SemanticPredicate(e_q, oracle), \
        tp.SemanticPredicate(e_q.copy(), oracle)
    assert a1.key == a2.key == jp.SemanticPredicate(e_q, oracle).key
    assert a1.name == jp.SemanticPredicate(e_q, oracle).name
    assert len((a1 & a2).leaves()) == 1
    with pytest.raises(ValueError):
        tp.SemanticPredicate(np.zeros((2, 2), np.float32), oracle)


def test_kleene_tables_match_the_reference():
    vals = np.array([tp.TRUE, tp.FALSE, tp.UNKNOWN], np.int8)
    a, b = np.repeat(vals, 3), np.tile(vals, 3)
    for fn in ("kleene_and", "kleene_or"):
        np.testing.assert_array_equal(getattr(tp, fn)(a, b),
                                      getattr(jp, fn)(a, b))
    np.testing.assert_array_equal(tp.kleene_not(vals), jp.kleene_not(vals))
    ta, tb = _leaves(tp)[:2]
    leaf_vals = {ta.key: np.array([tp.TRUE, tp.FALSE, tp.UNKNOWN,
                                   tp.UNKNOWN], np.int8),
                 tb.key: np.array([tp.UNKNOWN, tp.UNKNOWN, tp.FALSE,
                                   tp.TRUE], np.int8)}
    np.testing.assert_array_equal((ta & tb).evaluate(leaf_vals),
                                  [tp.UNKNOWN, tp.FALSE, tp.FALSE,
                                   tp.UNKNOWN])
    np.testing.assert_array_equal((ta | tb).evaluate(leaf_vals),
                                  [tp.TRUE, tp.UNKNOWN, tp.UNKNOWN, tp.TRUE])
    np.testing.assert_array_equal((~ta).evaluate(leaf_vals),
                                  [tp.FALSE, tp.TRUE, tp.UNKNOWN,
                                   tp.UNKNOWN])
    with pytest.raises(KeyError):
        ta.evaluate({})


PLAN_SHAPES = [
    ("and", ("and", ("leaf", 0), ("leaf", 1)), ("leaf", 2)),
    ("or", ("leaf", 0), ("leaf", 1)),
    ("not", ("leaf", 1)),
    ("or", ("and", ("leaf", 0), ("not", ("leaf", 1))), ("leaf", 2)),
    ("and", ("leaf", 2), ("or", ("leaf", 0), ("not", ("leaf", 2)))),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
@pytest.mark.parametrize("sels", [(0.6, 0.2, 0.9), (0.05, 0.5, 0.31),
                                  (0.7, 0.7, 0.1)])
def test_plan_order_and_estimate_match_the_reference(shape, sels):
    jl, tl = _leaves(jp), _leaves(tp)
    sel = {lf.key: s for lf, s in zip(jl, sels)}
    j_order, j_est = _instantiate(shape, jl).plan(sel)
    t_order, t_est = _instantiate(shape, tl).plan(sel)
    assert [lf.key for lf in t_order] == [lf.key for lf in j_order]
    assert abs(t_est - j_est) <= PLAN_TOL


def test_plan_orders_and_by_selectivity():
    a, b, c = _leaves(tp)
    sel = {a.key: 0.6, b.key: 0.2, c.key: 0.9}
    order, est = (a & b & c).plan(sel)
    assert [lf.name for lf in order] == ["b", "a", "c"]
    assert est == pytest.approx(0.6 * 0.2 * 0.9, abs=PLAN_TOL)
    order_or, est_or = (a | b).plan(sel)
    assert [lf.name for lf in order_or] == ["a", "b"]
    assert est_or == pytest.approx(1 - 0.4 * 0.8, abs=PLAN_TOL)
    assert (~b).plan(sel)[1] == pytest.approx(0.8, abs=PLAN_TOL)
    assert a.plan({})[1] == 0.5              # unknown leaves plan at 0.5


def test_topk_rejects_composition_and_bad_k():
    leaf = _leaves(tp)[0]
    tk = tp.SemanticTopK(leaf, k=5)
    for bad in (lambda: tk & leaf, lambda: leaf | tk, lambda: ~tk,
                lambda: tp.SemanticTopK(tk, k=3), lambda: tp.Not(tk),
                lambda: tp.And(leaf, tk)):
        with pytest.raises(TypeError):
            bad()
    with pytest.raises(ValueError):
        tp.SemanticTopK(leaf, k=0)
    for k in (True, 2.5):
        with pytest.raises(TypeError):
            tp.SemanticTopK(leaf, k=k)
    with pytest.raises(ValueError):
        tp.And(leaf)
    assert tp.SemanticTopK(leaf & ~leaf, k=np.int64(3)).k == 3


# -- the wire codec -----------------------------------------------------------

def _roundtrip(jpred):
    wire = jpred.to_wire(_REGISTRY)
    back = tp.from_wire(json.loads(json.dumps(wire)), oracles=_REGISTRY)
    assert [lf.key for lf in back.leaves()] == \
        [lf.key for lf in jpred.leaves()]
    assert back.to_wire(_REGISTRY) == wire
    return back


def test_wire_payloads_of_the_reference_decode_to_the_same_keys():
    a, b, c = _leaves(jp)
    for pred in (a, ~a, (a & ~b) | c, jp.Or(a, b, c),
                 jp.SemanticTopK((a | b) & ~c, k=7)):
        back = _roundtrip(pred)
        assert type(back).__name__ == type(pred).__name__
    topk = _roundtrip(jp.SemanticTopK(a, k=jp.MAX_WIRE_TOPK))
    assert isinstance(topk, tp.SemanticTopK) and topk.k == tp.MAX_WIRE_TOPK
    # and back: a port payload decodes in the reference
    wire = ((_leaves(tp)[0] & ~_leaves(tp)[1])).to_wire(_REGISTRY)
    assert [lf.key for lf in jp.from_wire(wire, oracles=_REGISTRY)
            .leaves()] == [lf.key for lf in tp.from_wire(
                wire, oracles=_REGISTRY).leaves()]


def test_wire_resolves_oracles_like_the_reference():
    inner = SimulatedOracle(np.ones(4, bool))
    reg = {"judge": CachedOracle(inner)}
    leaf = tp.SemanticPredicate(_embed(0), inner, name="x")
    assert leaf.to_wire(reg)["oracle"] == "judge"
    assert jp.SemanticPredicate(_embed(0), inner, name="x").to_wire(reg) \
        == leaf.to_wire(reg)
    for mod in (jp, tp):
        with pytest.raises(mod.WireFormatError):
            mod.SemanticPredicate(_embed(0), object()).to_wire({})
    back = tp.from_wire({"op": "leaf", "name": "p", "oracle": "judge",
                         "prompt": "about gpus"}, oracles=reg,
                        embedder=lambda s: _embed(len(s)))
    np.testing.assert_array_equal(back.e_q, _embed(len("about gpus")))


def _b64(arr):
    return base64.b64encode(np.asarray(arr).tobytes()).decode("ascii")


def _leaf_node(**embed):
    spec = {"dtype": "float32", "shape": [2], "b64": _b64(
        np.ones(2, np.float32))}
    spec.update(embed)
    return {"op": "leaf", "name": "x", "oracle": "o0", "embed": spec}


def _deep(depth):
    node = _leaf_node()
    for _ in range(depth):
        node = {"op": "not", "child": node}
    return node


MALFORMED = {
    "not_an_object": [1, 2],
    "unknown_op": {"op": "xor"},
    "no_oracle": {"op": "leaf", "embed": {}},
    "unknown_oracle": {"op": "leaf", "oracle": "nope", "embed": {}},
    "no_query": {"op": "leaf", "oracle": "o0"},
    "prompt_without_embedder": {"op": "leaf", "oracle": "o0",
                                "prompt": "x"},
    "embed_not_object": {"op": "leaf", "oracle": "o0", "embed": [1]},
    "embed_dtype": _leaf_node(dtype="float64"),
    "embed_b64": _leaf_node(b64="***"),
    "embed_shape": _leaf_node(shape=[2, 1]),
    "embed_bytes": _leaf_node(b64=_b64(np.ones(3, np.int8))),
    "embed_shape_mismatch": _leaf_node(shape=[3]),
    "not_without_child": {"op": "not"},
    "and_one_child": {"op": "and", "children": [_leaf_node()]},
    "or_children_not_list": {"op": "or", "children": "ab"},
    "too_deep": _deep(jp.MAX_WIRE_DEPTH + 1),
    "too_wide": {"op": "or", "children": [_leaf_node()]
                 * (jp.MAX_WIRE_NODES + 1)},
    "topk_not_root": {"op": "not", "child": {"op": "topk", "k": 1,
                                             "child": _leaf_node()}},
    "topk_k_bool": {"op": "topk", "k": True, "child": _leaf_node()},
    "topk_k_zero": {"op": "topk", "k": 0, "child": _leaf_node()},
    "topk_k_huge": {"op": "topk", "k": jp.MAX_WIRE_TOPK + 1,
                    "child": _leaf_node()},
    "topk_no_child": {"op": "topk", "k": 3},
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_payloads_raise_in_both(name):
    node = MALFORMED[name]
    for mod in (jp, tp):
        with pytest.raises(mod.WireFormatError):
            mod.from_wire(node, oracles=_REGISTRY)
    assert (tp.MAX_WIRE_DEPTH, tp.MAX_WIRE_NODES, tp.MAX_WIRE_TOPK,
            tp.WIRE_VERSION) == (jp.MAX_WIRE_DEPTH, jp.MAX_WIRE_NODES,
                                 jp.MAX_WIRE_TOPK, jp.WIRE_VERSION)


if given is not None:
    _SHAPES = st.recursive(
        st.tuples(st.just("leaf"), st.integers(0, 2)),
        lambda ch: st.one_of(
            st.tuples(st.just("not"), ch),
            st.tuples(st.just("and"), ch, ch),
            st.tuples(st.just("or"), ch, ch)),
        max_leaves=8)

    @settings(max_examples=15, deadline=None)
    @given(shape=_SHAPES, seed=st.integers(0, 1000),
           k=st.one_of(st.none(), st.integers(1, 10_000)))
    def test_reference_payloads_roundtrip_through_the_port(shape, seed, k):
        pred = _instantiate(shape, _leaves(jp))
        if k is not None:
            pred = jp.SemanticTopK(pred, k=k)
        back = _roundtrip(pred)
        rng = np.random.default_rng(seed)
        vals = {lf.key: rng.choice([tp.TRUE, tp.FALSE, tp.UNKNOWN],
                                   size=16).astype(np.int8)
                for lf in pred.leaves()}
        np.testing.assert_array_equal(back.evaluate(vals),
                                      pred.evaluate(vals))
        sel = {lf.key: float(rng.random()) for lf in pred.leaves()}
        (j_order, j_est), (t_order, t_est) = pred.plan(sel), back.plan(sel)
        assert [lf.key for lf in t_order] == [lf.key for lf in j_order]
        assert abs(t_est - j_est) <= PLAN_TOL


# -- SelectivityStats and QueryOptimizer (tests/test_optimizer.py) ------------

def test_selectivity_stats_precedence():
    st_ = SelectivityStats()
    assert st_.get("a") is None and st_.level("a") is None
    st_.observe("a", 0.4, measured=False, name="A")
    assert st_.get("a") == pytest.approx(0.4)
    assert st_.get("a", measured_only=True) is None   # estimated only
    st_.observe("a", 0.2, measured=True)
    assert st_.get("a", measured_only=True) == pytest.approx(0.2)
    st_.observe("a", 0.9, measured=False)             # must not demote
    assert st_.get("a") == pytest.approx(0.2)
    assert st_.level("a") == "measured"
    snap = st_.snapshot()
    assert snap["leaves"] == 1 and snap["measured"] == 1
    assert snap["observations"] == {"measured": 1, "estimated": 2}
    assert snap["entries"]["a"]["name"] == "A"       # name survives updates
    st_.clear()
    assert st_.get("a") is None


def test_single_flight_coalesces_and_caches():
    opt = QueryOptimizer()
    kind, _ = opt.claim_proxy("K", 0)
    assert kind == "owner"
    got = []

    def waiter():
        k2, fl = opt.claim_proxy("K", 0)
        assert k2 == "wait"
        got.append(QueryOptimizer.wait(fl))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    opt.publish_proxy("K", 0, {"w": 1})
    t.join(timeout=10)
    assert got == [{"w": 1}]
    k3, val = opt.claim_proxy("K", 0)
    assert k3 == "hit" and val == {"w": 1}
    assert opt.proxy("K", 0) == {"w": 1}
    snap = opt.snapshot()
    assert snap["flights_joined"] == 1
    assert snap["proxies_trained"] == 1 and snap["proxy_hits"] == 2


def test_aborted_flight_waiter_computes_locally():
    opt = QueryOptimizer()
    akey = ("K", "scaledoc", "ccfg", 0)
    kind, _ = opt.claim_artifact(akey)
    assert kind == "owner"
    got = []

    def waiter():
        k2, fl = opt.claim_artifact(akey)
        assert k2 == "wait"
        got.append(QueryOptimizer.wait(fl))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    opt.abort_artifact(akey, RuntimeError("boom"))
    t.join(timeout=10)
    assert got == [None]                 # waiter falls back to computing
    assert opt.snapshot()["flight_fallbacks"] == 1
    assert not opt.has_artifact(akey)    # nothing was published
    assert opt.artifact(akey) is None


def test_single_flight_under_contention_trains_each_key_once():
    """More threads than cores race claims on a few keys with a short
    switch interval: every key is published by exactly one owner, and
    every thread ends with that key's value."""
    opt = QueryOptimizer()
    keys = [f"K{j}" for j in range(4)]
    got, errors = [], []

    def session(i):
        key = keys[i % len(keys)]
        try:
            kind, val = opt.claim_proxy(key, 0)
            if kind == "owner":
                time.sleep(0.001)
                opt.publish_proxy(key, 0, {"key": key})
                val = {"key": key}
            elif kind == "wait":
                val = QueryOptimizer.wait(val)
            got.append((key, val))
        except BaseException as exc:          # surfaced below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=session, args=(i,))
                   for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(got, key=str) == sorted(
        [(keys[i % 4], {"key": keys[i % 4]}) for i in range(64)], key=str)
    snap = opt.snapshot()
    assert snap["proxies_trained"] == len(keys)
    assert snap["proxy_hits"] + snap["flights_joined"] == 64 - len(keys)


def test_cse_off_disables_sharing_keeps_counters():
    opt = QueryOptimizer(cse=False)
    assert opt.claim_proxy("K", 0) == ("owner", None)
    opt.publish_proxy("K", 0, {"w": 1})
    assert opt.proxy("K", 0) is None                  # never cached
    assert opt.claim_proxy("K", 0) == ("owner", None)  # never a hit
    assert opt.claim_artifact(("K",)) == ("owner", None)
    assert not opt.has_artifact(("K",))
    snap = opt.snapshot()
    assert snap["cse"] is False
    assert snap["proxies_trained"] == 1 and snap["proxy_hits"] == 0
    opt.clear()
    assert opt.snapshot()["cached_proxies"] == 0


# -- CachedOracle's surface and the provenance map ----------------------------

def test_cached_oracle_surface_matches_the_reference():
    truth = np.random.default_rng(0).random(50) < 0.3
    jo, to = JCachedOracle(JOracle(truth)), CachedOracle(SimulatedOracle(truth))
    for o in (jo, to):
        assert o.cached_positive_rate() is None and o.cached_count == 0
    asks = [np.array([3, 1, 3, 7]), np.array([1, 9, 9, 2]), np.arange(10)]
    for ask in asks:
        assert to.peek(ask) == jo.peek(ask)
        np.testing.assert_array_equal(to.label(ask), jo.label(ask))
    assert to.stats() == jo.stats()
    assert to.cached_count == jo.cached_count == 10
    assert to.cached_positive_rate() == jo.cached_positive_rate()
    assert to.peek(np.arange(12)) == [10, 11]


def test_provenance_map_matches_the_reference():
    rng = np.random.default_rng(1)
    class_of = rng.integers(-1, 8, size=40).astype(np.int8)
    leaf_of = rng.integers(-1, 3, size=40).astype(np.int16)
    mask = rng.random(40) < 0.5
    names = ["a", "b", "c"]
    jm = jtrace.ProvenanceMap(class_of, leaf_of, names)
    tm = ttrace.ProvenanceMap(class_of, leaf_of, names)
    assert ttrace.PROVENANCE_CLASSES == jtrace.PROVENANCE_CLASSES
    assert tm.counts() == jm.counts() and tm.complete() == jm.complete()
    assert tm.to_payload(mask) == jm.to_payload(mask)
    for name in ttrace.PROVENANCE_CLASSES:
        np.testing.assert_array_equal(tm.docs_in(name), jm.docs_in(name))
    done = ttrace.ProvenanceMap(np.abs(class_of), leaf_of, names)
    assert done.complete() and "unclassified" not in done.counts()
