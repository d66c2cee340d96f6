#!/usr/bin/env python3
"""chip_smoke.py's [mesh] phase alone, at its full sizes (~1 minute).

    python3 tools/mesh_phase.py          # from the repo root, on the card

Builds the kernels, trains one leaf over the main corpus (131,072 x
4096, query 0) and runs ``chip_smoke.mesh_phase`` ((a) the scoring pass
on the shard path, (b) one ``query()`` of the mesh engine); then for
llama3-8b and rwkv6-7b at full width (random bf16 weights) a
single-device ``build_index`` of ``MESH_DOCS`` documents of a fresh
corpus and ``chip_smoke.mesh_ingest`` ((c) the same documents on the
mesh; the params digest is not taken, as the fingerprint needs it only
to name the store); and the two mesh kernel entries' times at a shard's
batch. The mesh is two distinct cards where the machine has them, else
``cuda:0`` twice (``chip_smoke.scoring_mesh``). It prints the phase's
lines and writes ``chiprun_out/mesh_phase.json``; it exits 1 without a
card or when a gate fails.
"""
import gc
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase: no card", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs
    from repro_torch.config import CascadeConfig, ProxyConfig, get_arch
    from repro_torch.core.oracle import SimulatedOracle
    from repro_torch.data import make_corpus, make_query
    from repro_torch.device import resolve_device
    from repro_torch.engine import InMemoryStore, ScaleDocEngine, build_index
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import EmbeddingService

    t_all = time.perf_counter()
    _build.build_all(("fused_scoring", "contrastive", "flash_attention",
                      "wkv6"))
    dev = torch.device("cuda", 0)
    resolve_device(dev)
    cs.log(f"[device] {torch.cuda.get_device_name(0)} "
           f"x{torch.cuda.device_count()}")
    corpus = make_corpus(0, n_docs=cs.N_DOCS, dim=cs.DIM, noise=cs.NOISE)
    q = make_query(corpus, 100, selectivity=cs.SELECTIVITIES[0])
    eng = ScaleDocEngine(InMemoryStore(corpus.embeds), ProxyConfig(),
                         CascadeConfig(accuracy_target=0.9), device=dev)
    eng.query(q.embed, SimulatedOracle(q.truth), ground_truth=q.truth,
              seed=0)
    params = next(iter(eng._proxies.values()))
    report = {"scoring_and_query": cs.mesh_phase(dev, corpus.embeds, q,
                                                 params)}
    del eng, corpus, params
    work = ROOT / "build" / "mesh_phase"
    for arch in (cs.OFF_ARCH, cs.RWKV_ARCH):
        cfg = get_arch(arch)
        weights = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
        svc = EmbeddingService(cfg, weights, batch_size=cs.OFF_BATCH,
                               device=dev)
        svc._digest = "not taken"
        toks = make_corpus(0, n_docs=cs.MESH_DOCS, dim=128, with_tokens=True,
                           vocab=min(cs.OFF_VOCAB, cfg.vocab_size),
                           doc_len=cs.OFF_DOC_LEN).tokens
        docs = [toks[i] for i in range(cs.MESH_DOCS)]
        # a store left by an earlier run would be resumed, not rebuilt
        shutil.rmtree(work / arch, ignore_errors=True)
        t0 = time.perf_counter()
        single = build_index(svc, docs, work / arch)
        torch.cuda.synchronize()
        cs.log(f"[mesh] {arch}: the single-device ingest "
               f"{time.perf_counter() - t0:.2f} s")
        engine = type("Rows", (), {"store": single.store})
        report[arch] = cs.mesh_ingest(dev, svc, engine, docs)
        del svc, weights, single, engine
        gc.collect()
        torch.cuda.empty_cache()
    shard_b = cs.MESH_SHARD_B
    report["flash"] = cs.flash_times(dev, (shard_b,) + cs.FLASH_SHAPE[1:])
    report["wkv6"] = cs.wkv6_times(dev, (shard_b,) + cs.WKV6_SHAPE[1:])
    for name in ("flash", "wkv6"):
        t = report[name]
        cs.log(f"[times] {name} at a shard's batch of {shard_b}: "
               f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
               f"{t['bound_ms']:.5f} ms ({t['bound_by']})")
    cs.log(f"[total] {time.perf_counter() - t_all:.1f} s")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_phase.json").write_text(json.dumps(report, indent=1,
                                                    default=str))


if __name__ == "__main__":
    main()
