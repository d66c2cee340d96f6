"""Oracle calls of single leaves and of the compound forms at D = 4096,
in the JAX package and in the port, on the CPU.

    PYTHONPATH=src python tests/torch_compound_calls.py [N]

The corpus and leaves are chip_smoke.py's (make_corpus(0, dim=4096,
noise=0.03 * sqrt(256 / 4096)), make_query(corpus, 100 + i) at
selectivity 0.1, 0.2, 0.3), cut to N documents (16,384 by default) so
both packages run here; ProxyConfig() and CascadeConfig(accuracy_target
=0.9) as chip_smoke.py. It prints each leaf filtered alone (seed 0:
calls, l, r, F1) and the forms p1 & ~p2 (seed 0) and p2 | p3 (seed 1):
plan, calls and calls / N, per leaf (pending, calls). A script, not a
test: it takes minutes and needs both packages.
"""
import sys

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import InMemoryStore as JStore
from repro.engine import ScaleDocEngine as JEngine
from repro.engine import SemanticPredicate as JPred
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (InMemoryStore, ScaleDocEngine,
                                SemanticPredicate, SimulatedOracle)

DIM = 4096
NOISE = 0.03 * (256 / DIM) ** 0.5
PACKAGES = {
    "jax": lambda st: JEngine(JStore(st), JProxyCfg(),
                              JCascadeCfg(accuracy_target=0.9)),
    "port": lambda st: ScaleDocEngine(InMemoryStore(st), ProxyConfig(),
                                      CascadeConfig(accuracy_target=0.9),
                                      device="cpu"),
}
LEAF = {"jax": (JPred, JOracle), "port": (SemanticPredicate,
                                          SimulatedOracle)}


def main(n: int) -> None:
    corpus = make_corpus(0, n_docs=n, dim=DIM, noise=NOISE)
    qs = [make_query(corpus, 100 + i, selectivity=s)
          for i, s in enumerate((0.1, 0.2, 0.3))]
    forms = {"and_not": (lambda p: p[0] & ~p[1],
                         qs[0].truth & ~qs[1].truth, 0),
             "or": (lambda p: p[1] | p[2], qs[1].truth | qs[2].truth, 1)}
    for pkg, make_engine in PACKAGES.items():
        pred, oracle = LEAF[pkg]
        for i, q in enumerate(qs):
            res = make_engine(corpus.embeds).filter(
                pred(q.embed, oracle(q.truth)), ground_truth=q.truth,
                seed=0)
            c = res.leaf_reports[0].cascade
            print(f"{pkg} p{i + 1} (sel {q.selectivity:.2f}) alone: "
                  f"{res.oracle_calls_total} calls, l={c.l:.5f} "
                  f"r={c.r:.5f}, F1 {res.achieved_f1:.4f}", flush=True)
        for form, (build, truth, seed) in forms.items():
            leaves = [pred(q.embed, oracle(q.truth), name=f"p{i + 1}")
                      for i, q in enumerate(qs)]
            res = make_engine(corpus.embeds).filter(
                build(leaves), ground_truth=truth, seed=seed)
            print(f"{pkg} {form} (seed {seed}): plan {res.plan}, "
                  f"{res.oracle_calls_total} calls = "
                  f"{res.oracle_calls_total / n:.3f} N, F1 "
                  f"{res.achieved_f1:.4f}; per leaf "
                  f"{[(r.name, r.n_pending, r.oracle_calls) for r in res.leaf_reports]}",
                  flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16_384)
