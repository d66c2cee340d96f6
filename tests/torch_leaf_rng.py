"""One leaf's proxy, scores and thresholds in both packages, with the
port trained on the JAX engine's own draws, on the CPU.

    PYTHONPATH=src:tests python tests/torch_leaf_rng.py [N] [SEL]

The corpus and leaf are tests/torch_compound_calls.py's (chip_smoke.py's
D = 4096 corpus cut to N documents, 16,384 by default; the leaf
make_query(corpus, 102, selectivity=SEL), 0.3 by default; ProxyConfig()
and accuracy target 0.9; seed 0). It prints, for the JAX engine, the
port trained on its own torch seed, and the port trained on the JAX
keys through a DrawPlan (tests/torch_jax_draws.py): calls, l, r and F1,
then the largest param and score differences of the DrawPlan arm from
the JAX arm. A script, not a test: it takes minutes and needs both
packages.
"""
import sys
import time

import numpy as np

from repro.config.base import CascadeConfig as JCascadeCfg
from repro.config.base import ProxyConfig as JProxyCfg
from repro.core.oracle import SimulatedOracle as JOracle
from repro.engine import InMemoryStore as JStore
from repro.engine import ScaleDocEngine as JEngine
from repro.engine import SemanticPredicate as JPred
from repro_torch.config import CascadeConfig, ProxyConfig
from repro_torch.core.encoder import params_from_jax, tree_leaves
from repro_torch.data import make_corpus, make_query
from repro_torch.engine import (InMemoryStore, ScaleDocEngine,
                                SemanticPredicate, SimulatedOracle)
from torch_jax_draws import port_params

DIM = 4096
NOISE = 0.03 * (256 / DIM) ** 0.5


def _line(arm, res):
    c = res.leaf_reports[0].cascade
    print(f"{arm}: {res.oracle_calls_total} calls (train "
          f"{res.oracle_calls_train}, calib {c.oracle_calls_calib}, online "
          f"{c.oracle_calls_online}), l={c.l:.5f} r={c.r:.5f}, F1 "
          f"{res.achieved_f1:.4f}", flush=True)


def main(n: int, sel: float) -> None:
    corpus = make_corpus(0, n_docs=n, dim=DIM, noise=NOISE)
    q = make_query(corpus, 102, selectivity=sel)
    t0 = time.time()
    je = JEngine(JStore(corpus.embeds), JProxyCfg(),
                 JCascadeCfg(accuracy_target=0.9))
    jleaf = JPred(q.embed, JOracle(q.truth))
    rj = je.filter(jleaf, ground_truth=q.truth, seed=0)
    _line("jax", rj)

    def port_engine():
        return ScaleDocEngine(InMemoryStore(corpus.embeds), ProxyConfig(),
                              CascadeConfig(accuracy_target=0.9),
                              device="cpu")

    own = port_engine().filter(
        SemanticPredicate(q.embed, SimulatedOracle(q.truth)),
        ground_truth=q.truth, seed=0)
    _line("port, own torch seed", own)

    # the training sample is labelled through the engine's own label
    # cache, as the engine's training would, so the calibration and band
    # asks see the same cached labels as in the JAX arm
    te = port_engine()
    tleaf = SemanticPredicate(q.embed, SimulatedOracle(q.truth))
    cached = te._cached_oracle(tleaf.oracle)
    params = port_params(je, jleaf, 0, cached.label, ProxyConfig())
    te._proxies[tleaf.key] = params
    train_calls = tleaf.oracle.calls
    rt = te.filter(tleaf, ground_truth=q.truth, seed=0)
    rt.oracle_calls_train = train_calls
    rt.oracle_calls_total += train_calls
    _line("port, JAX draws", rt)

    ref = params_from_jax(je._proxies[jleaf.key])
    dp = max(float((a - b).abs().max())
             for a, b in zip(tree_leaves(ref), tree_leaves(params)))
    ds = float(np.abs(rt.leaf_reports[0].scores
                      - rj.leaf_reports[0].scores).max())
    agree = float(np.mean(rt.mask == rj.mask))
    print(f"max |param diff| {dp:.3e}, max |score diff| {ds:.3e}, masks "
          f"agree on {agree:.6f} of docs; {time.time() - t0:.0f} s",
          flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16_384,
         float(sys.argv[2]) if len(sys.argv) > 2 else 0.3)
