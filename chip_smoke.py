#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ScaleDoc on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which exits non-zero when it fails:
  1. device  — the card's name and power limit (no card: exit 1);
  2. build   — both CUDA kernels from src/repro_torch/csrc, one nvcc each,
               in parallel;
  3. kernels — each kernel against its plain PyTorch version on the card:
               fused scoring at D=4096, H=512, L=128 over an 8192-doc tile
               for Q in {1, 4, 5} (and its Q=1 single-query form);
               contrastive at (Q=4, n=128, p=64) and (Q=1, n=512, p=256),
               all-positive, all-negative and tied batches; the phase-2
               autograd.Function's gradient against plain autograd;
  4. main    — ScaleDocEngine.query() for three queries over a synthetic
               corpus of 131,072 documents at D=4096 (noise: see NOISE),
               with ProxyConfig() defaults and
               CascadeConfig(accuracy_target=0.9): F1 >= 0.85,
               oracle calls < N, both kernels launched, and the engine's
               scores equal to the plain scoring path's;
  5. times   — each kernel and its plain version with CUDA events at the
               main path's shapes, their bounds, the per-stage split of
               one scoring pass, and the train / score / calibrate split of
               one query.

It prints a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}; details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM published peaks (data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

N_DOCS = 131_072
DIM = 4096
# make_corpus's noise is per dimension: its default 0.03 is set for the
# default 256-dim corpus (noise norm 0.48 against a unit-scale topic
# mixture). At 4096 dims the same 0.03 gives a noise norm of 1.9, and the
# proxy (in both packages) then scores every document within 0.993-0.999,
# so the cascade sends all of them to the oracle. Scaling the noise by
# sqrt(256 / D) keeps the default corpus's signal-to-noise ratio.
NOISE = 0.03 * (256 / DIM) ** 0.5
SELECTIVITIES = (0.1, 0.2, 0.3)
TILE = 8192
F1_MIN = 0.85
F32_TOL = 1e-5                       # the reference kernels' f32 tolerance
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(f"[device] {kind} x{torch.cuda.device_count()}; {smi_line}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.config import CascadeConfig, ProxyConfig
    from repro_torch.core import scoring as plain_scoring
    from repro_torch.core.encoder import encoder_init, tree_map
    from repro_torch.core.cascade import calibrate_thresholds
    from repro_torch.core.oracle import CachedOracle, SimulatedOracle
    from repro_torch.data import make_corpus, make_query
    from repro_torch.device import resolve_device
    from repro_torch.engine import InMemoryStore, ScaleDocEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.contrastive import ref as c_ref
    from repro_torch.kernels.fused_scoring import ops as s_ops
    from repro_torch.kernels.fused_scoring import ref as s_ref

    resolve_device(dev)         # TF32 off for matmuls and cuDNN
    report = {"device": kind, "nvidia_smi": smi_line,
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 2. build ----------------------------------------------------------
    build_s = _build.build_all(["fused_scoring", "contrastive"])
    log(f"[build] fused_scoring.cu + contrastive.cu in {build_s:.1f} s")
    for name in ("fused_scoring", "contrastive"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    report["build_seconds"] = build_s

    # -- 3. kernels against plain versions --------------------------------
    rng = np.random.default_rng(0)
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    params = tree_map(lambda p: p.to(dev), encoder_init(
        torch.Generator().manual_seed(0), ProxyConfig(embed_dim=DIM)))
    w = s_ops._unpack(params)
    docs = t(rng.normal(size=(TILE, DIM)) / np.sqrt(DIM))
    checks = {}
    for q in (1, 4, 5):
        zq = torch.nn.functional.normalize(t(rng.normal(size=(q, 128))), dim=1)
        err = (s_ops.fused_scores_multi(docs, *w, zq)
               - s_ref.ref_scores_multi(docs, *w, zq)).abs().max().item()
        checks[f"fused_scoring Q={q}"] = err
        err1 = (s_ops.fused_scores(docs, *w, zq[0])
                - s_ref.ref_scores(docs, *w, zq[0])).abs().max().item()
        checks[f"fused_scores (Q=1 form) with zq[0] of Q={q}"] = err1
    for key, err in checks.items():
        log(f"[kernels] {key}: max abs err {err:.3e} (tol {F32_TOL:g})")
        if not err <= F32_TOL:
            fail(f"{key} disagrees with its plain version: {err}")

    def contrastive_case(q, n, p, case):
        zq = rng.normal(size=(q, p))
        zd = rng.normal(size=(q, n, p))
        y = (rng.random((q, n)) < 0.3).astype(np.float32)
        if case == "all_pos":
            y[:] = 1
        elif case == "all_neg":
            y[:] = 0
        elif case == "tie":
            y[:, :4] = [1, 0, 1, 0]
            zd[:, 2] = zd[:, 0]
            zd[:, 3] = zd[:, 1]
            zq[:] = -zd[:, 0]
        return t(zq), t(zd), t(y)

    c_errs = {}
    for q, n, p in ((4, 128, 64), (1, 512, 256)):
        for case in ("mixed", "all_pos", "all_neg", "tie"):
            args = contrastive_case(q, n, p, case)
            got = c_ops.contrastive_losses(*args, 0.07, 0.2)
            want = c_ref.ref_losses(*args, 0.07, 0.2)
            if not torch.isfinite(got).all():
                fail(f"contrastive {case} Q={q} n={n} p={p}: non-finite")
            ok = torch.allclose(got, want, **LOSS_TOL)
            err = (got - want).abs().max().item()
            c_errs[f"contrastive Q={q} n={n} p={p} {case}"] = err
            log(f"[kernels] contrastive Q={q} n={n} p={p} {case}: max abs "
                f"err {err:.3e} (rtol {LOSS_TOL['rtol']:g}, "
                f"atol {LOSS_TOL['atol']:g})")
            if not ok:
                fail(f"contrastive {case} Q={q} n={n} p={p} disagrees")
    args = contrastive_case(4, 128, 64, "mixed")
    a = [args[0].clone().requires_grad_(), args[1].clone().requires_grad_()]
    b = [args[0].clone().requires_grad_(), args[1].clone().requires_grad_()]
    c_ops.phase2_loss(a[0], a[1], args[2], 0.07, 0.2).sum().backward()
    c_ref.ref_phase2(b[0], b[1], args[2], 0.07, 0.2).sum().backward()
    g_err = (a[1].grad - b[1].grad).abs().max().item()
    log(f"[kernels] phase2 autograd.Function grad vs plain autograd: max abs "
        f"err {g_err:.3e} (tol {F32_TOL:g}); z_q grad is zero: "
        f"{not a[0].grad.any().item()}")
    if not (g_err <= F32_TOL and not a[0].grad.any().item()):
        fail("phase2 gradient disagrees with plain autograd")
    report["checks"] = {**checks, **c_errs, "phase2 grad": g_err}

    # -- 4. main path: ScaleDocEngine.query() ------------------------------
    t0 = time.perf_counter()
    corpus = make_corpus(0, n_docs=N_DOCS, dim=DIM, noise=NOISE)
    gen_s = time.perf_counter() - t0
    n = corpus.embeds.shape[0]
    log(f"[main] corpus: N={n} D={DIM} noise={NOISE:g} "
        f"({corpus.embeds.nbytes / 1e9:.2f} GB f32) made in {gen_s:.1f} s")
    store = InMemoryStore(corpus.embeds)
    engine = ScaleDocEngine(store, ProxyConfig(),
                            CascadeConfig(accuracy_target=0.9), device=dev)
    queries = [make_query(corpus, 100 + i, selectivity=s)
               for i, s in enumerate(SELECTIVITIES)]
    s_ops.KERNEL.launches = 0
    c_ops.KERNEL.launches = 0
    results = []
    for i, q in enumerate(queries):
        oracle = SimulatedOracle(q.truth)
        tq = time.perf_counter()
        st = engine.query(q.embed, oracle, ground_truth=q.truth, seed=0)
        wall = time.perf_counter() - tq
        f1 = st.cascade.achieved_f1
        results.append({"selectivity": q.selectivity, "f1": f1,
                        "oracle_calls": st.oracle_calls_total,
                        "train_calls": st.oracle_calls_train,
                        "l": st.cascade.l, "r": st.cascade.r,
                        "wall_seconds": wall})
        log(f"[main] query {i} (sel {q.selectivity:.2f}): F1 {f1:.4f}, "
            f"oracle calls {st.oracle_calls_total} of {n} "
            f"({st.oracle_calls_train} train), l={st.cascade.l:.4f} "
            f"r={st.cascade.r:.4f}, {wall:.2f} s")
        if not np.isfinite(st.scores).all() or st.scores.shape != (n,):
            fail(f"query {i}: scores not finite or not ({n},)")
        if f1 < F1_MIN:
            fail(f"query {i}: F1 {f1:.4f} < {F1_MIN}")
        if st.oracle_calls_total >= n:
            fail(f"query {i}: {st.oracle_calls_total} oracle calls >= N")
    launches = {"fused_scoring": s_ops.KERNEL.launches,
                "contrastive": c_ops.KERNEL.launches}
    log(f"[main] launches over {len(queries)} queries: {launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was never launched on the main path")

    # the engine's scores against the plain scoring path, same proxy
    leaf_params = next(iter(engine._proxies.values()))
    first = engine.query(queries[0].embed, SimulatedOracle(queries[0].truth),
                         ground_truth=queries[0].truth, seed=0)
    plain = plain_scoring.score_collection(leaf_params, queries[0].embed,
                                           corpus.embeds, device=dev)
    s_err = float(np.abs(first.scores - plain).max())
    log(f"[main] engine scores vs plain scoring path: max abs err "
        f"{s_err:.3e} (tol {F32_TOL:g})")
    if not s_err <= F32_TOL:
        fail("engine scores disagree with the plain scoring path")
    report["main"] = {"n_docs": n, "dim": DIM, "corpus_seconds": gen_s,
                      "queries": results, "launches": launches,
                      "scores_vs_plain": s_err}

    # -- 5. times ----------------------------------------------------------
    zq1 = torch.nn.functional.normalize(t(rng.normal(size=(1, 128))), dim=1)
    fused_ms = cuda_ms(lambda: s_ops.fused_scores_multi(docs, *w, zq1), 20)
    fused_plain_ms = cuda_ms(lambda: s_ref.ref_scores_multi(docs, *w, zq1),
                             20)
    h, lat = 512, 128
    fused_flops = 2 * TILE * (DIM * h + h * h + h * lat + lat)
    fused_bytes = 4 * (TILE * DIM + DIM * h + h * h + h * lat + 2 * h + lat
                       + lat + TILE)
    fused_bound = max(fused_flops / PEAK_FP32_FLOPS,
                      fused_bytes / PEAK_BYTES) * 1e3
    args = contrastive_case(4, 128, 64, "mixed")
    con_ms = cuda_ms(lambda: c_ops.contrastive_losses(*args, 0.07, 0.2), 200)
    con_plain_ms = cuda_ms(lambda: c_ref.ref_losses(*args, 0.07, 0.2), 50)
    qn, nn_, pp = 4, 128, 64
    # pairwise and query dots, row norms and divides, and the online LSEs
    con_flops = qn * (2 * nn_ * nn_ * pp + 2 * nn_ * pp + 3 * nn_ * pp
                      + 4 * nn_ * nn_)
    con_bytes = 4 * (qn * nn_ * pp + qn * pp + qn * nn_ + qn * 4)
    con_bound = max(con_flops / PEAK_FP32_FLOPS,
                    con_bytes / PEAK_BYTES) * 1e3
    n_q = len(queries)
    kernels = [
        {"name": "fused_scoring", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_scoring.cu",
         "replaces": "src/repro/kernels/fused_scoring/scoring.py:138",
         "launches": launches["fused_scoring"],
         "max_abs_err": max(checks.values()),
         "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": fused_bound,
         "bound_by": ("operations" if fused_flops / PEAK_FP32_FLOPS
                      >= fused_bytes / PEAK_BYTES else "bytes"),
         "library_ms": None},
        {"name": "contrastive", "route": "cuda",
         "source": "src/repro_torch/csrc/contrastive.cu",
         "replaces": "src/repro/kernels/contrastive/contrastive.py:110",
         "launches": launches["contrastive"],
         "max_abs_err": max(c_errs.values()),
         "ms": con_ms, "plain_ms": con_plain_ms, "bound_ms": con_bound,
         "bound_by": ("operations" if con_flops / PEAK_FP32_FLOPS
                      >= con_bytes / PEAK_BYTES else "bytes"),
         "library_ms": None},
    ]
    for k in kernels:
        log(f"[times] {k['name']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f}"
            f" ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']}), "
            f"{k['launches'] / n_q:.1f} launches per query()")
    torch.cuda.synchronize()
    scores, stats = engine.executor.score(leaf_params, queries[0].embed,
                                          store)
    split = {f: getattr(stats, f) for f in (
        "tiles_scored", "bytes_streamed", "host_io_seconds",
        "compute_seconds", "stall_seconds", "wall_seconds")}
    split["overlap_fraction"] = stats.overlap_fraction
    log(f"[times] one scoring pass: {json.dumps(split)}")
    # the other stages of one query(): a training run (4 padded lanes, as
    # the engine dispatches it) and the calibration, on query 0's inputs
    q0 = queries[0]
    idx = np.random.default_rng(0).choice(n, size=n // 10, replace=False)
    torch.cuda.synchronize()
    tt = time.perf_counter()
    engine._train_padded([1], [q0.embed], [store.get(idx)], [q0.truth[idx]])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - tt
    tc = time.perf_counter()
    calibrate_thresholds(scores, CachedOracle(SimulatedOracle(q0.truth)),
                         engine.cascade_cfg, np.random.default_rng(1))
    calib_s = time.perf_counter() - tc
    stages = {"train_seconds": train_s, "score_seconds": stats.wall_seconds,
              "calibrate_seconds": calib_s,
              "query_wall_seconds": results[0]["wall_seconds"]}
    log(f"[times] one query's stages: {json.dumps(stages)}")
    report["times"] = {"kernels": kernels, "scoring_pass": split,
                       "query_stages": stages,
                       "fused_flops": fused_flops, "fused_bytes": fused_bytes,
                       "contrastive_flops": con_flops,
                       "contrastive_bytes": con_bytes}

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=2))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
