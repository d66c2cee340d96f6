#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ScaleDoc on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which exits non-zero when it fails:
  1. device  — the card's name and power limit (no card: exit 1);
  2. build   — the four CUDA kernels from src/repro_torch/csrc, one nvcc
               each, all started together; ptxas's registers and spills
               (fused scoring: per instantiation, none may spill) and
               the fused kernel's shared memory a block;
  3. kernels — each kernel against its plain PyTorch version on the card:
               fused scoring at D=4096, H=512, L=128 over an 8192-doc tile
               for Q in {1, 4, 5} (and its Q=1 single-query form), at
               n that cuts its 64-row tile (1, 63, 64, 65, 8191), at
               D=99 and on a docs view 4 bytes off 16-byte alignment
               (its 4-byte-copy instantiation), and a second call on
               the path's inputs giving the same bits;
               contrastive at (Q=4, n=128, p=64) and (Q=1, n=512, p=256),
               all-positive, all-negative and tied batches (bellwether
               candidates tied within one 8-row anchor block and across
               blocks), n and p that cut its row blocks and tiles
               raggedly, a batch whose every U(i) is empty, and a second
               call on the same inputs giving the same bits; the phase-2
               autograd.Function's gradient against plain autograd;
               flash attention against the masked-einsum oracle at the
               offline path's shape (b=8, s=512, 32 heads over 8 KV heads,
               head_dim 128, causal) and at small window / q_offset /
               ragged / non-causal shapes, in f32 (the FP32 kernel) and
               bf16 (the tensor-core kernel, also against its plain
               version, which rounds where it rounds, and, logged but not
               a gate, against the rounding of flash.py, P in f32);
               the WKV6 intra-chunk kernel against its plain version (the
               sub-chunk form), all four outputs, at the rwkv6-7b path's
               shape (b=8, nc=4, Q=128, H=64, K=64), a ragged chunk
               (Q=100), K=16, Q=1 and lw = -200, at the path's shape also
               against the pairwise form (one exp per term, as the Pallas
               kernel), and ops.wkv6 against the sequential recurrence;
  4. main    — ScaleDocEngine.query() for three queries over a synthetic
               corpus of 131,072 documents at D=4096 (noise: see NOISE),
               with ProxyConfig() defaults and
               CascadeConfig(accuracy_target=0.9): F1 >= 0.85,
               oracle calls < N, both kernels launched, and the engine's
               scores equal to the plain scoring path's;
  5. times   — each kernel and its plain version with CUDA events at the
               main path's shapes (fused scoring also from a replayed
               CUDA graph), their bounds, the per-stage split of one
               scoring pass (its compute_seconds beside
               host_io_seconds), and the train / score / calibrate split
               of one query; the contrastive kernel's device time per call
               (a replayed CUDA graph; torch.profiler per kernel) at
               (Q=4, n=128, p=64) and (Q=1, n=512, p=256) beside the time
               of one ops.contrastive_losses call, host included; one
               training run's mean phase-1 and phase-2 step,
               synchronized;
  6. compound — on the main path's corpus and queries (leaves p1, p2, p3
               at selectivity 0.1, 0.2, 0.3), each filter() on a fresh
               engine: p1 & ~p2 and p2 | p3 with root F1 >= 0.85, each
               leaf's oracle calls < N, the AND-NOT form's calls < N and
               the OR form's fewer than its two leaves' alone (one
               ScaleDocPipeline each), a complete provenance map, the
               contrastive kernel launched phase2_steps times for the
               plan (both leaves in one padded training run) and the
               fused kernel 16 times per leaf artifact; p1 and p2
               filtered alone on a third engine (each trained beside
               three dummy lanes): the Kleene p1 & ~p2 of their masks
               and their trained params bitwise equal to the compound's,
               and the compound's calls at most theirs; then
               cross-session CSE on the first CSE_DOCS documents: two
               session views of one engine run p1 & ~p2 and p2 | p3
               through QueryOptimizer() and through
               QueryOptimizer(cse=False), with bitwise equal masks, three
               proxies trained and something shared in the CSE arm, and
               no more oracle calls there; the plan, per-leaf pending
               sizes and calls, provenance counts and the stage split
               (plan, train, each leaf) of each filter() are logged;
  7. topk    — SemanticTopK(p1, k=100) and SemanticTopK(p1 & ~p2, k=100)
               (the latter through a QueryOptimizer), each on a fresh
               engine at seed 0: k members, every one in the mask of the
               same predicate's full filter() at seed 0 (phase 4's p1,
               phase 6's p1 & ~p2), fewer oracle calls than that filter(),
               topk_queries == 1, a complete provenance map, both kernels
               launched; the documents walked, the calls (train, calib,
               walk), the launches and the wall time are logged;
  8. degrade — p1 at seed 0 over ResilientOracle(CachedOracle(
               ChaosOracle(counting(SimulatedOracle)))), blacked out from
               invocation 2 on (after the training and calibration
               samples): degrade="defer" parks one ticket and its partial
               mask accepts no unresolved document; after heal(),
               repair_pending() gives a mask bitwise equal to phase 4's
               fault-free p1 run, with no document bought twice; on a
               fresh stack degrade="proxy_fallback" leaves nothing
               unresolved, 0 < est_accuracy_debit <= 1 and agrees with the
               truth on more than 60% of the documents; both kernels
               launched in each run;
  9. serve   — the serving plane: one resident ScaleDocEngine behind
               PredicateServer(workers=4) answers four sessions submitted
               at once (p1 and p3 at seed 0, p1 & ~p2 at seed 0, p2 | p3
               at seed 1) over fresh CachedOracles: every session DONE,
               each mask bitwise its serial run's (phases 4 and 6), no
               more documents bought than those runs and none twice, the
               cost ledger's oracle documents equal to the oracles', the
               broker's and the caches' purchases, each session's trace
               one "session" root over one engine.filter, complete
               provenance, the fused kernel launched 16 times per leaf
               artifact (96) and the contrastive kernel 60 times per
               training run (240); then the same sessions on a fresh
               engine behind PredicateServer(optimize=True): masks
               bitwise the first arm's and one proxy trained per distinct
               (leaf, seed); makespans, session latency p50/p95, oracle
               invocations and documents per invocation, the per-tenant
               ledger, one session's span tree and the metrics snapshot
               are logged;
 10. ablation — the five train_proxy_variant variants on p1 (10% sample
               drawn as benchmarks/bench_ablation.py draws it, seed 0,
               ProxyConfig()), the contrastive ones scored through the
               fused kernel, the classifier by mlp_classifier_scores:
               finite scores, the contrastive kernel launched 0 times for
               qsim and mlp and 60 times for the others; each variant's
               unfiltered fraction under the brute-force optimal cascade
               on the true labels at F1 0.9 (the paper's Fig. 9) logged;
 11. offline — the offline path: ScaleDocEngine.from_corpus with an
               EmbeddingService over llama3-8b at full width (32 layers,
               bf16, weights drawn on the card from a seed) into a store of
               2,048 documents of 512 tokens: 2048 finite rows of width
               4096, flash launched 32 times per batch, the kernel path's
               pooled embeddings against the plain einsum path's (per-row
               cosine >= COS_MIN), a killed-and-resumed ingest bit-identical
               to an uninterrupted one, and one query() over the store;
 12. flash   — the bf16 flash kernel (and the same call non-causal), the
               FP32 kernel on the same inputs in f32, the plain version
               and PyTorch's scaled_dot_product_attention under each
               backend that takes the call (a yardstick the port never
               calls) at the offline path's shape, and the kernel's share
               of one embedding batch;
 13. rwkv    — the llama3-8b weights freed, the same offline path over
               rwkv6-7b at full width (32 layers, bf16, weights drawn on
               the card) and the same corpus: 2048 finite rows of width
               4096, the WKV6 kernel launched 32 times per batch, the
               kernel path's pooled embeddings against the plain direct
               scan's (per-row cosine >= RWKV_COS_MIN), the kill/resume
               drill and one query() over the store; then the 32 blocks
               run by hand on one batch: each layer's recurrence through
               the kernel and the direct scan on the kernel path's inputs
               (relative error and f32 ulp distance; time-mix outputs at
               a per-row cosine >= LAYER_COS_MIN), and how three other
               exact evaluations (the direct scan, the kernel with each
               output one f32 ulp up, the kernel at chunk 64) drift from
               the kernel path with depth (the direct scan's after
               RWKV_DEPTH layers >= RWKV_DEPTH_COS_MIN);
 14. wkv6    — the WKV6 kernel, its plain version and the plain
               pairwise form at the rwkv6-7b path's shape, its bound
               (exponentials in the sub-chunk form, FP32 operations and
               bytes), and its share of one embedding batch.

It prints a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}; details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM published peaks (data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# exponentials: 16 MUFU results per clock per SM, 132 SMs at the 1.98 GHz
# boost clock that the FP32 peak above implies (132 * 128 * 2 * 1.98e9)
PEAK_EXP = 132 * 16 * 1.98e9

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
# tests/test_kernels.py's flash attention tolerances (rtol = atol)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# the bf16 kernel against its plain version (attention_blocked with P
# rounded to bf16 for P V, on the kernel's 64-row, 64-key tiles): the same
# rounding points, f32 sums in another order, so a rounding of P or of
# the output may move by one bf16 ulp; rtol covers one ulp (2^-7
# relative at most) at every |out|, atol the outputs near zero
FLASH_BF16_PLAIN_TOL = 8e-3
# the offline path: llama3-8b over make_corpus's tokens
OFF_ARCH = "llama3-8b"
OFF_DOCS, OFF_DOC_LEN, OFF_VOCAB, OFF_BATCH = 2048, 512, 32768, 8
RESUME_DOCS, RESUME_CUT = 128, 64    # the kill/resume drill
# 32 bf16 layers of random weights: the kernel (f32 softmax, bf16 out)
# and the einsum path (probabilities rounded to bf16) round at other
# places, so pooled embeddings agree in direction, not to the last bit
COS_MIN = 0.999
FLASH_SHAPE = (8, 512, 32, 8, 128)   # b, s, heads, KV heads, head_dim
# the rwkv6-7b offline path (same corpus and batch as llama3-8b)
RWKV_ARCH = "rwkv6-7b"
WKV6_TOL = 1e-5            # of max |plain|: tests/test_kernels.py's bar
WKV6_SHAPE = (8, 4, 128, 64, 64)     # b, chunks, Q, heads, head_dim
# Each time-mix layer, fed the kernel path's hidden state, with the
# recurrence through the kernel and through the direct scan: their f32
# outputs differ in summation order only, so after the bf16 cast a row's
# direction moves by 1 - cos ~ 1e-7 (measured); a kernel that drops or
# misweights one term moves it by orders of magnitude more
LAYER_COS_MIN = 0.999999
# The pooled embeddings after 32 random bf16 RWKV6 layers: the model
# amplifies a last-bit difference of the time-mix's f32 output with
# depth, so two exact evaluations that only round differently drift
# apart. The run measures that drift at each depth for the direct scan
# and for two perturbations of the kernel path itself; this bar only
# rules out gross faults, and the per-layer check above holds the kernel
RWKV_COS_MIN = 0.95
# ... and the drift from the direct scan after the first few layers,
# before the amplification takes over (1 - cos measured at 2.2e-5)
RWKV_DEPTH, RWKV_DEPTH_COS_MIN = 4, 0.9999
SPREAD_CHUNK = 64          # the other chunk length of the drift check
# the compound phase's cross-session CSE arms run on this many of the
# main path's documents, to bound the phase's time
CSE_DOCS = 32_768
TOPK_K = 100
# the degrade phase's outage: the oracle answers the training sample
# (invocation 0) and the calibration sample (1), then fails until healed
DEGRADE_BLACKOUT = 2
DEGRADE_AGREE_MIN = 0.6     # proxy-only decisions against the truth


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


def flash_checks(dev, rng) -> tuple:
    """The flash kernels against the masked-einsum oracle on the card,
    and the bf16 kernel against its plain version (gates); and the bf16
    kernel against attention_blocked(..., round_p=False), stated."""
    import torch
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention import ref as f_ref
    b, s, h, kv, hd = FLASH_SHAPE
    cases = [  # name, (b, sq, skv, h, kv, hd), causal, window, q_offset
        ("path shape causal", (b, s, s, h, kv, hd), True, 0, 0),
        ("window=24", (2, 128, 128, 4, 4, 32), True, 24, 0),
        ("q_offset=skv-sq", (1, 32, 96, 2, 2, 16), True, 0, 64),
        ("ragged s=200 GQA 4:1", (2, 200, 200, 8, 2, 128), True, 0, 0),
        ("non-causal s=200", (1, 200, 200, 4, 1, 128), False, 0, 0),
    ]
    errs, stated = {}, {}
    for name, (b, sq, skv, h, kv, hd), causal, window, q_off in cases:
        base = [torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                             device=dev)
                for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                              (b, skv, kv, hd))]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dt) for x in base)
            kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                      q_offset=q_off)
            got = f_ops.flash_attention_fwd(q, k, v, **kw)
            want = f_ref.ref_attention(q, f_ref.expand_kv(k, h // kv),
                                       f_ref.expand_kv(v, h // kv), **kw)
            torch.cuda.synchronize()
            tol = FLASH_TOL[str(dt).split(".")[1]]
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            key = f"flash {name} {str(dt).split('.')[1]}"
            log(f"[kernels] {key}: vs the einsum oracle max abs err "
                f"{err:.3e}, mean {diff.mean().item():.3e} (rtol = atol = "
                f"{tol:g})")
            if got.dtype != dt or not torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"{key} disagrees with the einsum oracle")
            errs[key] = err
            if dt != torch.bfloat16:
                continue
            plain = f_ref.attention_blocked(
                q, f_ref.expand_kv(k, h // kv), f_ref.expand_kv(v, h // kv),
                kw["scale"], causal=causal, window=window, q_offset=q_off,
                q_block=64, kv_block=64, round_p=True)
            torch.cuda.synchronize()
            tol = FLASH_BF16_PLAIN_TOL
            diff = (got.float() - plain.float()).abs()
            log(f"[kernels] {key}: vs its plain version max abs err "
                f"{diff.max().item():.3e}, mean {diff.mean().item():.3e} "
                f"(rtol = atol = {tol:g})")
            if not torch.allclose(got.float(), plain.float(), rtol=tol,
                                  atol=tol):
                fail(f"{key} disagrees with its plain version")
            errs[f"{key} vs plain"] = diff.max().item()
            # stated, not a gate: the Pallas kernel's and the JAX blocked
            # path's rounding, P kept in f32 for P V
            exact_p = f_ref.attention_blocked(
                q, f_ref.expand_kv(k, h // kv), f_ref.expand_kv(v, h // kv),
                kw["scale"], causal=causal, window=window, q_offset=q_off,
                q_block=64, kv_block=64, round_p=False)
            torch.cuda.synchronize()
            diff = (got.float() - exact_p.float()).abs()
            log(f"[kernels] {key}: vs round_p=False (P in f32 for P V, as "
                f"flash.py) max abs err {diff.max().item():.3e}, mean "
                f"{diff.mean().item():.3e} (logged, not a gate)")
            stated[key] = diff.max().item()
    return errs, stated


def wkv6_inputs(rng, b, nc, q, h, k, extreme=False):
    """tests/test_kernels.py's WKV6 inputs, chunked: r, k, v at scale
    0.5, lw = -exp(2N - 1) (or -200), u at 0.3, cum the within-chunk
    cumsum of lw; numpy float32."""
    import numpy as np
    r, kk, v = ((0.5 * rng.normal(size=(b, nc, q, h, k))).astype(np.float32)
                for _ in range(3))
    lw = (np.full((b, nc, q, h, k), -200.0, np.float32) if extreme else
          -np.exp(2.0 * rng.normal(size=(b, nc, q, h, k)) - 1.0).astype(
              np.float32))
    u = (0.3 * rng.normal(size=(h, k))).astype(np.float32)
    return r, kk, v, np.cumsum(lw, axis=2, dtype=np.float32), lw, u


def wkv6_checks(dev, rng) -> dict:
    """The WKV6 kernel against its plain version (the sub-chunk form) on
    the card, all four outputs, also against the pairwise form (one exp
    per term, the Pallas kernel's) at the path's shape, and ops.wkv6
    against the sequential recurrence."""
    import torch
    from repro_torch.kernels.wkv6 import ops as w_ops
    from repro_torch.kernels.wkv6 import ref as w_ref
    cases = [  # name, (b, nc, Q, H, K), lw = -200
        ("path shape", WKV6_SHAPE, False),
        ("ragged chunk Q=100", (2, 2, 100, 4, 64), False),
        ("K=16", (2, 4, 64, 8, 16), False),
        ("Q=1", (1, 37, 1, 4, 64), False),
        ("lw=-200 Q=16", (1, 2, 16, 1, 16), True),
        ("lw=-200 Q=128", (1, 2, 128, 2, 64), True),
    ]
    errs = {}
    for name, shape, extreme in cases:
        args = [torch.tensor(x, device=dev)
                for x in wkv6_inputs(rng, *shape, extreme=extreme)]
        got = w_ops.wkv6_intra_chunk(*args)
        plains = [("", w_ref.SUB)]
        if shape == WKV6_SHAPE:
            plains.append((" vs the pairwise form", None))
        for suffix, sub in plains:
            want = w_ref.wkv6_intra_chunk(*args, sub=sub)
            torch.cuda.synchronize()
            for out, g, w in zip(("y_intra", "s_inj", "a_end", "r_dec"),
                                 got, want):
                # a_end under lw = -200 underflows to 0 everywhere
                scale = w.abs().max().item() or 1e-30
                err = (g - w).abs().max().item()
                key = f"wkv6 {name} {out}{suffix}"
                log(f"[kernels] {key}: max abs err {err:.3e}, "
                    f"{err / scale:.3e} of max |plain| {scale:.3e} (tol "
                    f"{WKV6_TOL:g})")
                if g.shape != w.shape or not torch.isfinite(g).all() or \
                        not err <= WKV6_TOL * scale:
                    fail(f"{key} disagrees with its plain version")
                errs[key] = err
            del want
    # tests/test_kernels.py's shape: chunks short enough that one ulp of
    # |cum| stays well below the tolerance (the chunked form and the
    # sequential product round the decay differently)
    b, s, h, k, chunk = 1, 96, 4, 32, 32
    r, kk, v, _, lw, u = (torch.tensor(x, device=dev) for x in
                          wkv6_inputs(rng, b, 1, s, h, k))
    r, kk, v, lw = (x.reshape(b, s, h, k) for x in (r, kk, v, lw))
    got = w_ops.wkv6(r, kk, v, lw, u, chunk=chunk)
    want = w_ref.ref_wkv6(r, kk, v, lw, u)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    log(f"[kernels] ops.wkv6 (b={b}, s={s}: {s // chunk} chunks of "
        f"{chunk}) vs the sequential recurrence: {err / scale:.3e} of max "
        f"|ref| (tol {WKV6_TOL:g})")
    if not err <= WKV6_TOL * scale:
        fail("ops.wkv6 disagrees with the sequential recurrence")
    errs["ops.wkv6 vs sequential"] = err
    return errs


def ptxas_entries(log: str) -> dict:
    """ptxas -v's report of each entry function in a build log: its
    registers, spill stores and loads, and static shared memory."""
    import re
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        name = re.match(r"\s*'([^']+)'", chunk)
        nums = {key: re.search(pat, chunk) for key, pat in (
            ("registers", r"Used (\d+) registers"),
            ("spill_stores", r"(\d+) bytes spill stores"),
            ("spill_loads", r"(\d+) bytes spill loads"),
            ("static_smem", r"(\d+) bytes smem"))}
        if name:
            out[name.group(1)] = {k: int(m.group(1)) if m else 0
                                  for k, m in nums.items()}
    return out


def fused_checks(dev, t, w, docs, rng) -> dict:
    """The fused kernel against its plain version at the path's widths:
    n cutting its 64-row tile, D=99 and a misaligned docs view (its
    4-byte-copy instantiation), and a bitwise repeat on the path's
    inputs."""
    import numpy as np
    import torch
    from repro_torch.kernels.fused_scoring import ops as s_ops
    from repro_torch.kernels.fused_scoring import ref as s_ref
    zq = torch.nn.functional.normalize(t(rng.normal(size=(2, 128))), dim=1)
    cases = {f"n={n}": docs[:n] for n in (1, 63, 64, 65, TILE - 1)}
    w1_99 = t(rng.normal(size=(99, 512)) / np.sqrt(99))
    cases["D=99"] = (t(rng.normal(size=(TILE, 99)) / np.sqrt(99)), w1_99)
    flat = torch.empty(TILE * DIM + 1, device=dev)
    off = flat[1:].view(TILE, DIM)
    off.copy_(docs)
    cases["docs 4 bytes off alignment"] = off
    errs = {}
    for name, x in cases.items():
        x, w1 = x if isinstance(x, tuple) else (x, w[0])
        args = (x, w1, *w[1:], zq)
        err = (s_ops.fused_scores_multi(*args)
               - s_ref.ref_scores_multi(*args)).abs().max().item()
        errs[f"fused_scoring {name} Q=2"] = err
    first = s_ops.fused_scores_multi(docs, *w, zq[:1])
    second = s_ops.fused_scores_multi(docs, *w, zq[:1])
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        fail("fused_scoring: two calls on the same inputs differ")
    return errs


def all_kernels():
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.fused_scoring import ops as s_ops
    from repro_torch.kernels.wkv6 import ops as w_ops
    return {"fused_scoring": s_ops.KERNEL, "contrastive": c_ops.KERNEL,
            "flash_attention": f_ops.KERNEL, "wkv6": w_ops.KERNEL}


def rwkv_checks(cfg, params, tokens, pooled) -> dict:
    """The rwkv6 blocks run by hand on one batch of ``tokens``, so that
    the recurrence can be swapped; ``pooled`` is the service's embedding
    of the batch, which the kernel path must reproduce. Per layer, on the
    kernel path's inputs: the recurrence through the kernel and through
    the direct scan (error over max |y|, f32 ulp distance) and the
    time-mix output of each (per-row cosine). With depth: the per-row
    cosine of the pooled hidden state of three other exact evaluations
    against the kernel path's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.wkv6 import ops as w_ops
    from repro_torch.models import rwkv
    from repro_torch.models.common import rmsnorm_apply
    from repro_torch.models.transformer import group_params

    def ulp_up(*args, chunk):
        y = w_ops.wkv6(*args, chunk=chunk)
        return torch.nextafter(y, torch.full_like(y, float("inf")))

    others = {"direct": rwkv.WKV6["direct"],
              "one ulp up": ulp_up,
              f"chunk {SPREAD_CHUNK}":
                  lambda *args, chunk: w_ops.wkv6(*args, chunk=SPREAD_CHUNK)}

    def block(p, x, wkv):
        h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        *args, g = rwkv.timemix_inputs(p["time"], h, cfg)
        y = wkv(*args, p["time"]["u"], chunk=rwkv.CHUNK)
        x = x + rwkv.timemix_output(p["time"], y, g, cfg)
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        return x + rwkv.channelmix_apply(p["channel"], h, cfg), (args, g, y)

    mask = (tokens > 0)[..., None]

    def pool(x):                     # as EmbeddingService.embed_batch
        m = mask.to(x.dtype)
        return (torch.sum(x * m, dim=1)
                / torch.clamp(torch.sum(m, dim=1), min=1.0)).float()

    def row_cos(a, b):               # in float64: 1 - cos reaches 1e-7
        return F.cosine_similarity(a.double().flatten(1),
                                   b.double().flatten(1), dim=1).min().item()

    def ordered(y):                  # f32 bits as integers in value order
        i = y.view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    layer = {"min_cosine": 1.0, "max_rel_err": 0.0, "max_ulps": 0,
             "min_share_0_ulps": 1.0, "min_share_within_1_ulp": 1.0,
             "min_share_within_16_ulps": 1.0}
    drift = {name: {} for name in others}
    with torch.inference_mode():
        x = F.embedding(tokens, params["embed"]["table"])
        xs = dict.fromkeys(others, x)
        for depth in range(1, cfg.num_layers + 1):
            p = group_params(params, depth - 1)["p0"]
            x_next, (args, g, y) = block(p, x, w_ops.wkv6)
            y_d = others["direct"](*args, p["time"]["u"], chunk=rwkv.CHUNK)
            ulps = (ordered(y) - ordered(y_d)).abs()
            layer["max_rel_err"] = max(layer["max_rel_err"], (
                (y - y_d).abs().max() / y_d.abs().max()).item())
            layer["max_ulps"] = max(layer["max_ulps"], ulps.max().item())
            for key, n in (("min_share_0_ulps", 0),
                           ("min_share_within_1_ulp", 1),
                           ("min_share_within_16_ulps", 16)):
                layer[key] = min(layer[key],
                                 (ulps <= n).float().mean().item())
            layer["min_cosine"] = min(layer["min_cosine"], row_cos(
                rwkv.timemix_output(p["time"], y, g, cfg),
                rwkv.timemix_output(p["time"], y_d, g, cfg)))
            del args, g, y, y_d, ulps
            x = x_next
            for name, wkv in others.items():
                xs[name] = block(p, xs[name], wkv)[0]
            if depth & (depth - 1) == 0 or depth == cfg.num_layers:
                for name in others:
                    drift[name][depth] = row_cos(pool(x), pool(xs[name]))
        hand_err = (pool(x) - pooled).abs().max().item()
    return {"layer": layer, "drift_min_cosine": drift,
            "hand_run_vs_service_max_abs_err": hand_err}


def offline_phase(dev, arch: str, kernel: str, plain_opts: dict,
                  tag: str, cos_min: float) -> tuple:
    """ScaleDocEngine.from_corpus over ``arch``, then its checks:
    ``kernel`` is the kernel each of its layers launches once per batch,
    ``plain_opts`` the service options of its plain path, whose pooled
    embeddings must reach a per-row cosine of ``cos_min``. Returns the
    report, the service and its first batch of tokens."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.config import CascadeConfig, ProxyConfig, get_arch
    from repro_torch.core.encoder import tree_leaves
    from repro_torch.core.oracle import SimulatedOracle
    from repro_torch.data import make_corpus, make_query
    from repro_torch.engine import ScaleDocEngine, build_index
    from repro_torch.engine.store import DATA_NAME
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import EmbeddingService

    cfg = get_arch(arch)
    kernels = all_kernels()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers of "
        f"{'/'.join(cfg.block_pattern)}, d={cfg.d_model}, {cfg.num_heads} "
        f"heads over {cfg.num_kv_heads} KV heads, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params drawn on the card in {init_s:.1f} s"
        f", {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    t0 = time.perf_counter()
    corpus = make_corpus(0, n_docs=OFF_DOCS, dim=128, with_tokens=True,
                         vocab=OFF_VOCAB, doc_len=OFF_DOC_LEN)
    docs = [corpus.tokens[i] for i in range(OFF_DOCS)]
    n_tokens = OFF_DOCS * OFF_DOC_LEN
    log(f"[{tag}] corpus: {OFF_DOCS} docs x {OFF_DOC_LEN} tokens "
        f"(vocab {OFF_VOCAB}) = {n_tokens} tokens, made in "
        f"{time.perf_counter() - t0:.1f} s")
    service = EmbeddingService(cfg, params, batch_size=OFF_BATCH, device=dev)
    t0 = time.perf_counter()
    digest = service.params_digest()
    digest_s = time.perf_counter() - t0
    log(f"[{tag}] params digest {digest} in {digest_s:.1f} s")

    work = ROOT / "build" / "chip_smoke_stores"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        # -- the path: every count 0 just before, read just after ---------
        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = ScaleDocEngine.from_corpus(
            service, docs, work / "store", proxy_cfg=ProxyConfig(),
            cascade_cfg=CascadeConfig(accuracy_target=0.9), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: kern.launches for name, kern in kernels.items()}
        launches = counts[kernel]
        st = engine.ingest_result.stats
        store = engine.store
        emb = store.get(np.arange(len(store)))
        log(f"[{tag}] from_corpus: {len(store)} x {store.dim} rows in "
            f"{wall:.1f} s: {st.docs / wall:.1f} docs/s, "
            f"{n_tokens / wall:.0f} tokens/s; {st.batches} batches, "
            f"{st.commits} commits; launches {json.dumps(counts)}")
        split = {f: getattr(st, f) for f in (
            "host_io_seconds", "compute_seconds", "stall_seconds",
            "write_seconds", "wall_seconds")}
        split["overlap_fraction"] = st.overlap_fraction
        split["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"[{tag}] IngestStats: {json.dumps(split)}")
        if emb.shape != (OFF_DOCS, cfg.d_model) or not np.isfinite(
                emb).all():
            fail(f"the store is not {OFF_DOCS} finite rows of width "
                 f"{cfg.d_model}: {emb.shape}")
        if st.batches != OFF_DOCS // OFF_BATCH or \
                launches != cfg.num_layers * st.batches:
            fail(f"{kernel} launched {launches} times over {st.batches} "
                 f"batches; expected {cfg.num_layers} per batch")

        # -- the kernel path against the plain path, one batch -----------
        batch = np.stack(docs[:OFF_BATCH]).astype(np.int32)
        got = service.embed_batch(batch)
        plain = EmbeddingService(cfg, params, batch_size=OFF_BATCH,
                                 device=dev, **plain_opts)
        want = plain.embed_batch(batch)
        cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
        p_err = (got - want).abs().max().item()
        same_as_store = bool(np.array_equal(got.cpu().numpy(),
                                            emb[:OFF_BATCH]))
        log(f"[{tag}] kernel path vs {plain_opts}, batch 0: min per-row "
            f"cosine {cos.min().item():.6f} (>= {cos_min}), max abs err "
            f"{p_err:.3e} (|x| max {want.abs().max().item():.3e}); "
            f"bitwise equal to the store's rows: {same_as_store}")
        if not cos.min().item() >= cos_min:
            fail(f"the kernel path's embeddings disagree with {plain_opts}")
        # -- kill / resume drill -----------------------------------------
        part_docs = docs[:RESUME_DOCS]
        full = build_index(service, part_docs, work / "full")
        killed = build_index(service, part_docs, work / "killed",
                             max_docs=RESUME_CUT)
        if not killed.interrupted or len(killed.store) != RESUME_CUT:
            fail(f"max_docs={RESUME_CUT} left {len(killed.store)} rows")
        resumed = build_index(service, part_docs, work / "killed")
        a = (work / "full" / DATA_NAME).read_bytes()
        b = (work / "killed" / DATA_NAME).read_bytes()
        prefix = emb[:RESUME_DOCS].tobytes() == a
        log(f"[{tag}] kill at {RESUME_CUT} of {RESUME_DOCS} docs, resume "
            f"from row {resumed.stats.resumed_rows}: embeddings.bin "
            f"bit-identical to an uninterrupted run: {a == b} ({len(a)} "
            f"bytes); equal to the full store's first rows: {prefix}")
        if a != b or resumed.stats.resumed_rows != RESUME_CUT \
                or full.interrupted:
            fail("the resumed store differs from the uninterrupted one")

        # -- one query over the store -------------------------------------
        q = make_query(corpus, 100, selectivity=0.2)
        pos = np.nonzero(q.truth)[0][:4]
        e_q = emb[pos].mean(axis=0)
        e_q = (e_q / (np.linalg.norm(e_q) + 1e-9)).astype(np.float32)
        tq = time.perf_counter()
        qs = engine.query(e_q, SimulatedOracle(q.truth), ground_truth=q.truth,
                          seed=0)
        q_wall = time.perf_counter() - tq
        log(f"[{tag}] query (sel {q.selectivity:.2f}) over the store: F1 "
            f"{qs.cascade.achieved_f1:.4f} (no bar: random weights), oracle "
            f"calls {qs.oracle_calls_total} of {OFF_DOCS}, {q_wall:.2f} s")
        if not np.isfinite(qs.scores).all() or \
                qs.oracle_calls_total > OFF_DOCS:
            fail("the query over the offline store failed")

        # one embedding batch on the card, and the flash share of it
        batch_dev = torch.as_tensor(batch, device=dev)
        batch_ms = cuda_ms(lambda: service.embed_batch(batch_dev), 5,
                           warmup=1)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"arch": cfg.name, "kernel": kernel, "params": n_params,
            "init_seconds": init_s,
            "digest_seconds": digest_s, "n_docs": OFF_DOCS,
            "tokens": n_tokens, "wall_seconds": wall,
            "docs_per_second": OFF_DOCS / wall,
            "tokens_per_second": n_tokens / wall, "batches": st.batches,
            "launches": launches, "launch_counts": counts,
            "ingest_stats": split,
            "pooled_min_cosine": cos.min().item(),
            "pooled_max_abs_err": p_err, "resume_bit_identical": a == b,
            "query": {"f1": qs.cascade.achieved_f1,
                      "oracle_calls": qs.oracle_calls_total,
                      "wall_seconds": q_wall},
            "embed_batch_ms": batch_ms}, service, batch


def flash_times(dev) -> dict:
    """The bf16 flash kernel, the FP32 kernel on the same inputs in f32,
    the plain version and SDPA under each backend, at the path's shape."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention import ref as f_ref
    b, s, h, kv, hd = FLASH_SHAPE
    gen = torch.Generator(dev).manual_seed(1)
    q = torch.randn((b, s, h, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, kv, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    scale = hd ** -0.5
    g = h // kv
    ms = cuda_ms(lambda: f_ops.flash_attention_fwd(q, k, v, scale=scale),
                 50)
    # the same call without the causal mask: every Q tile runs all 8 K/V
    # tiles (16,384 tile steps against the causal call's 9,216), which
    # shows whether the causal loops' short length or the steady state
    # sets the time
    noncausal_ms = cuda_ms(lambda: f_ops.flash_attention_fwd(
        q, k, v, scale=scale, causal=False), 50)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    fp32_ms = cuda_ms(lambda: f_ops.flash_attention_fwd(
        q32, k32, v32, scale=scale), 10)
    del q32, k32, v32
    plain_ms = cuda_ms(lambda: f_ref.attention_blocked(
        q, f_ref.expand_kv(k, g), f_ref.expand_kv(v, g), scale,
        causal=True, round_p=True), 10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "CUDNN_ATTENTION"):
        # a backend that refuses the call says why in a warning
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            try:
                with sdpa_kernel(getattr(SDPBackend, name)):
                    sdpa[name] = cuda_ms(
                        lambda: torch.nn.functional.
                        scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, scale=scale,
                            enable_gqa=True), 50)
            except (RuntimeError, AttributeError) as e:
                why = [str(w.message).split(" (Triggered")[0] for w in said]
                why = [w for w in why if not w.endswith("because:")]
                sdpa[name] = "refused: " + (why[0] if why else str(e))
    timed = {n: t for n, t in sdpa.items() if isinstance(t, float)}
    library = min(timed, key=timed.get) if timed else None
    flops = 4 * b * h * hd * s * (s + 1) // 2
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"ms": ms, "noncausal_ms": noncausal_ms,
            "noncausal_tflops": 4 * b * h * hd * s * s / noncausal_ms / 1e9,
            "fp32_kernel_ms": fp32_ms, "plain_ms": plain_ms,
            "library_ms": timed[library] if library else None,
            "library_backend": library, "sdpa": sdpa,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "fp32_fma_bound_ms": flops / PEAK_FP32_FLOPS * 1e3}


def wkv6_times(dev) -> dict:
    """The WKV6 kernel, its plain version and the whole ops.wkv6 at the
    rwkv6-7b path's shape, and the kernel's bound: the largest of the
    function's exponentials over the MUFU rate and its FP32 operations
    over the FP32 peak, both as the sub-chunk form needs them, and its
    bytes over the memory rate."""
    import numpy as np
    import torch
    from repro_torch.kernels.wkv6 import ops as w_ops
    from repro_torch.kernels.wkv6 import ref as w_ref
    b, nc, q, h, k = WKV6_SHAPE
    args = [torch.tensor(x, device=dev) for x in
            wkv6_inputs(np.random.default_rng(1), b, nc, q, h, k)]
    ms = cuda_ms(lambda: w_ops.wkv6_intra_chunk(*args), 20)
    sub = w_ref.SUB
    plain_ms = cuda_ms(lambda: w_ref.wkv6_intra_chunk(*args, sub=sub), 5,
                       warmup=1)
    pairwise_ms = cuda_ms(lambda: w_ref.wkv6_intra_chunk(*args), 5,
                          warmup=1)
    seq = [x.reshape(b, nc * q, h, k) for x in (args[0], args[1], args[2],
                                                  args[4])]
    op_ms = cuda_ms(lambda: w_ops.wkv6(*seq, args[5]), 20)
    blocks = b * nc * h
    pairs = q * (q - 1) // 2
    # The least exponentials that keep every exponent <= 0 (the sub-chunk
    # form of chunked GLA/RWKV6 kernels): the rows cut into sub-chunks of
    # sub; a pair inside one sub-chunk takes one exp per channel; a pair
    # (t, j) across sub-chunks factors through the last row e of j's
    # sub-chunk, exp(cum_{t-1}[t] - cum[e]) * exp(cum[e] - cum[j]), one exp
    # per (t, earlier sub-chunk, channel) and one per (j, channel); then
    # r_dec and dec_end, one per element, and a_end, one per channel.
    # The kernel takes that form, so exps_kernel counts the same; its warps
    # also evaluate the terms of their own sub-chunk that lie on or above
    # the diagonal (up to the warp's last row), which a select drops:
    # exps_evaluated counts those too.
    sizes = [min(sub, q - i) for i in range(0, q, sub)]
    inner = sum(m * (m - 1) // 2 for m in sizes)
    t_side = sum(i * m for i, m in enumerate(sizes))
    exps = blocks * k * (inner + t_side + q + 2 * q + 1)
    exps_kernel = exps
    walked = sum(min(8, q - w) * (min(w + 8, q) - 1 - w // sub * sub)
                 for w in range(0, q, 8))
    exps_evaluated = blocks * k * (walked + t_side + q + 2 * q + 1)
    # FLOP of that form: per channel, 4 per inner pair (the difference,
    # r * exp, * k, the sum), 2 per crossing pair (a dot product) and 2
    # per factor (its difference and scale); A v, 2 per pair and channel;
    # r.u.k and its v term, cum - lw, r_dec, dec_end and k * dec_end, 9
    # per element; the (K, Q) x (Q, K) s_inj product
    flops = blocks * (4 * inner * k + 2 * (pairs - inner) * k
                      + 2 * (t_side + q) * k + 2 * pairs * k + 9 * q * k
                      + 2 * q * k * k)
    nbytes = 4 * (blocks * (7 * q * k + k * k + k) + h * k)
    terms = {"operations": max(exps / PEAK_EXP, flops / PEAK_FP32_FLOPS),
             "bytes": nbytes / PEAK_BYTES}
    bound_by = max(terms, key=terms.get)
    return {"ms": ms, "plain_ms": plain_ms, "pairwise_plain_ms": pairwise_ms,
            "op_ms": op_ms, "exps_evaluated": exps_evaluated,
            "bound_ms": terms[bound_by] * 1e3, "bound_by": bound_by,
            "exps": exps, "flops": flops, "bytes": nbytes,
            "exps_kernel": exps_kernel,
            "exp_bound_ms": exps / PEAK_EXP * 1e3,
            "flop_bound_ms": flops / PEAK_FP32_FLOPS * 1e3,
            "byte_bound_ms": nbytes / PEAK_BYTES * 1e3}


def graph_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` back-to-back calls
    captured in one CUDA graph, replayed ``replays`` times between CUDA
    events, so no host launch overhead sits between the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def profiler_ms(fn, names, calls: int = 20) -> dict:
    """Each named kernel's device time per call of ``fn`` from
    torch.profiler's CUDA activity; "not measured" where the trace holds
    no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        total = sum(getattr(e, "device_time_total", 0.0)
                    for e in prof.key_averages() if name in e.key)
        out[name] = total / calls / 1e3 if total > 0 else "not measured"
    return out


def contrastive_times(args) -> dict:
    """The contrastive kernel on ``args`` (z_q, z_d, y): its device time
    per call from a replayed graph and per kernel from the profiler, the
    time of one ops.contrastive_losses call with the host's work in it,
    its plain version's, and its bound."""
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.contrastive import ref as c_ref
    q, n, p = args[1].shape
    call = lambda: c_ops.contrastive_losses(*args, 0.07, 0.2)
    prof = profiler_ms(call, ("contrastive_rows_kernel",
                              "contrastive_finish_kernel"))
    # pairwise and query dots, row norms and divides, and the online LSEs
    flops = q * (2 * n * n * p + 2 * n * p + 3 * n * p + 4 * n * n)
    nbytes = 4 * (q * n * p + q * p + q * n + q * 4)
    terms = {"operations": flops / PEAK_FP32_FLOPS,
             "bytes": nbytes / PEAK_BYTES}
    bound_by = max(terms, key=terms.get)
    calls = 50
    return {"device_ms": graph_ms(call, calls), "graph_calls": calls,
            "profiler_rows_ms": prof["contrastive_rows_kernel"],
            "profiler_finish_ms": prof["contrastive_finish_kernel"],
            "call_ms": cuda_ms(call, 200),
            "plain_ms": cuda_ms(lambda: c_ref.ref_losses(*args, 0.07, 0.2),
                                50),
            "bound_ms": terms[bound_by] * 1e3, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes}


def train_step_split(engine, args) -> dict:
    """One engine._train_padded run on ``args``, with a synchronize at
    the start of every step's loss: the mean and median ms of a phase-1
    and of a phase-2 step (each step from its loss to the next one's, so
    the last step, which ends in the run's own epilogue, is left out),
    the run's set-up before the first step, and the whole run."""
    import numpy as np
    import torch
    from repro_torch.core import trainer
    marks = []

    def timed(fn, phase):
        def step(*a, **k):
            torch.cuda.synchronize()
            marks.append((phase, time.perf_counter()))
            return fn(*a, **k)
        return step

    plain = trainer._KINDS["two_phase"]
    trainer._KINDS["two_phase"] = (timed(plain[0], 1), timed(plain[1], 2),
                                   plain[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        engine._train_padded(*args)
        torch.cuda.synchronize()
    finally:
        trainer._KINDS["two_phase"] = plain
    out = {"run_ms": 1e3 * (time.perf_counter() - t0),
           "setup_ms": 1e3 * (marks[0][1] - t0),
           "steps_ms": 1e3 * (marks[-1][1] - marks[0][1])}
    for phase in (1, 2):
        ms = [1e3 * (b[1] - a[1]) for a, b in zip(marks, marks[1:])
              if a[0] == phase]
        out[f"phase{phase}_steps"] = len(ms)
        out[f"phase{phase}_mean_ms"] = float(np.mean(ms))
        out[f"phase{phase}_median_ms"] = float(np.median(ms))
    return out


class StageClock:
    """A filter() observer that reads the host clock, after a
    synchronize, at each phase the engine announces (planning, training,
    scoring, done) and after each leaf of the plan (on_partial)."""

    def __init__(self):
        self.marks = []

    def _mark(self, name):
        import torch
        torch.cuda.synchronize()
        self.marks.append((name, time.perf_counter()))

    def on_phase(self, name):
        self._mark(name)

    def on_partial(self, accepted, rejected):
        self._mark("leaf")

    def split(self) -> dict:
        """Seconds of the plan, the training and each leaf's stage."""
        t = dict((n, s) for n, s in self.marks if n != "leaf")
        leaves = [s for n, s in self.marks if n == "leaf"]
        ends = [t["scoring"]] + leaves
        return {"plan_seconds": t["training"] - t["planning"],
                "train_seconds": t["scoring"] - t["training"],
                "leaf_seconds": [b - a for a, b in zip(ends, ends[1:])]}


def leaf_rows(res) -> list:
    return [{"leaf": r.name, "pending": r.n_pending,
             "train_calls": r.oracle_calls_train,
             "calib_calls": r.oracle_calls_calib,
             "online_calls": r.oracle_calls_online} for r in res.leaf_reports]


def compound_phase(dev, embeds, queries, n_tiles) -> dict:
    """Phase 6: compound predicates, the cost-ordered planner and
    cross-session CSE over the main path's corpus (see the docstring).
    Every gate is checked and logged; the phase fails after the last."""
    import numpy as np
    import torch
    from repro_torch.config import CascadeConfig, ProxyConfig
    from repro_torch.core.oracle import SimulatedOracle
    from repro_torch.core.pipeline import ScaleDocPipeline
    from repro_torch.engine import (InMemoryStore, QueryOptimizer,
                                    ScaleDocEngine, SemanticPredicate)
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.fused_scoring import ops as s_ops
    pcfg, ccfg = ProxyConfig(), CascadeConfig(accuracy_target=0.9)
    store = InMemoryStore(embeds)
    n = len(store)
    bad = []
    out = {}
    t_phase = time.perf_counter()

    def leaves(truths):
        return [SemanticPredicate(q.embed, SimulatedOracle(t),
                                  name=f"p{i + 1}")
                for i, (q, t) in enumerate(zip(queries, truths))]

    def engine(st):
        return ScaleDocEngine(st, pcfg, ccfg, device=dev)

    def same_params(a, b) -> bool:
        return a.keys() == b.keys() and all(
            same_params(a[k], b[k]) if isinstance(a[k], dict)
            else torch.equal(a[k], b[k]) for k in a)

    # 1. the AND-NOT and OR forms, each on a fresh engine. Each leaf's
    # oracle is held under N; the AND-NOT form's calls too. The OR form's
    # sum is held under its leaves filtered independently (one
    # ScaleDocPipeline per leaf, the same seed) instead: with
    # ProxyConfig() at D=4096 one leaf alone sends 59-99% of the
    # collection to its oracle, in the JAX package as in the port, and
    # the OR form's second leaf resolves most of what the first rejects,
    # so two oracles together cannot stay under N (PERF.md, section 6)
    truth = [q.truth for q in queries]
    forms = {"and_not": (lambda p: p[0] & ~p[1], truth[0] & ~truth[1], 0),
             "or": (lambda p: p[1] | p[2], truth[1] | truth[2], 1)}
    runs = {}
    for form, (build, root_truth, seed) in forms.items():
        p = leaves(truth)
        clock = StageClock()
        view = engine(store).session_view(observer=clock)
        s_ops.KERNEL.launches = 0
        c_ops.KERNEL.launches = 0
        tw = time.perf_counter()
        res = view.filter(build(p), ground_truth=root_truth, seed=seed)
        wall = time.perf_counter() - tw
        launches = {"fused_scoring": s_ops.KERNEL.launches,
                    "contrastive": c_ops.KERNEL.launches}
        built = len(res.leaf_reports)
        row = {"plan": res.plan, "f1": res.achieved_f1,
               "oracle_calls": res.oracle_calls_total,
               "train_calls": res.oracle_calls_train,
               "leaves": leaf_rows(res),
               "provenance": res.provenance.counts(),
               "provenance_complete": res.provenance.complete(),
               "launches": launches, "artifacts_built": built,
               "wall_seconds": wall, **clock.split()}
        runs[form] = (p, view, res)
        out[form] = row
        log(f"[compound] {form} (seed {seed}): plan {res.plan}; F1 "
            f"{res.achieved_f1:.4f}; oracle calls {res.oracle_calls_total} "
            f"of {n} ({res.oracle_calls_train} train); per leaf "
            f"{json.dumps(row['leaves'])}; provenance "
            f"{json.dumps(row['provenance'])}; launches {launches} "
            f"({built} leaf artifacts built); wall {wall:.3f} s: plan "
            f"{row['plan_seconds']:.3f} s, train {row['train_seconds']:.3f}"
            f" s, leaves " + ", ".join(f"{s:.3f}" for s in
                                       row["leaf_seconds"]) + " s")
        if not res.achieved_f1 >= F1_MIN:
            bad.append(f"{form}: root F1 {res.achieved_f1:.4f} < {F1_MIN}")
        over = [r.name for r in res.leaf_reports if not r.oracle_calls < n]
        if over:
            bad.append(f"{form}: leaves {over} asked their oracle about "
                       f"every document")
        if form == "and_not" and not res.oracle_calls_total < n:
            bad.append(f"{form}: {res.oracle_calls_total} oracle calls >= N")
        if form == "or":
            # the independent baseline: each leaf alone, one pipeline each
            indep = []
            for lf, t in ((p[1], truth[1]), (p[2], truth[2])):
                o = SimulatedOracle(t)
                ScaleDocPipeline(embeds, pcfg, ccfg, device=dev).query(
                    lf.e_q, o, seed=seed)
                indep.append(o.calls)
            row["independent_calls"] = indep
            log(f"[compound] or: the leaves alone (one ScaleDocPipeline "
                f"each, seed {seed}): {indep[0]} + {indep[1]} = "
                f"{sum(indep)} calls; the compound saves "
                f"{sum(indep) - res.oracle_calls_total} "
                f"({100 * (1 - res.oracle_calls_total / sum(indep)):.1f}%)"
                f"; its {res.oracle_calls_total} calls are "
                f"{res.oracle_calls_total / n:.3f} N")
            if not res.oracle_calls_total < sum(indep):
                bad.append(f"or: {res.oracle_calls_total} calls, no fewer "
                           f"than the leaves alone ({sum(indep)})")
        if not res.provenance.complete():
            bad.append(f"{form}: the provenance map is incomplete")
        if launches["contrastive"] != pcfg.phase2_steps:
            bad.append(f"{form}: {launches['contrastive']} contrastive "
                       f"launches for one plan, not {pcfg.phase2_steps}")
        if launches["fused_scoring"] != n_tiles * built:
            bad.append(f"{form}: {launches['fused_scoring']} fused launches"
                       f" for {built} leaf artifacts, not {n_tiles} each")

    # 2. canonical evaluation: the AND-NOT form's leaves alone on a third
    # fresh engine, each trained beside three dummy lanes
    p, view, res = runs["and_not"]
    solo = leaves(truth)[:2]
    eng = engine(store)
    singles = [eng.filter(lf, seed=0) for lf in solo]
    kleene = singles[0].mask & ~singles[1].mask
    same_mask = bool(np.array_equal(kleene, res.mask))
    same = {lf.name: same_params(view._proxies[lf.key], eng._proxies[s.key])
            for lf, s in zip(p, solo)}
    single_calls = sum(r.oracle_calls_total for r in singles)
    out["canonical"] = {
        "mask_equal": same_mask, "params_equal": same,
        "single_calls": [r.oracle_calls_total for r in singles],
        "compound_calls": res.oracle_calls_total,
        "saving": single_calls - res.oracle_calls_total}
    log(f"[compound] canonical evaluation: p1 alone "
        f"{singles[0].oracle_calls_total} calls, p2 alone "
        f"{singles[1].oracle_calls_total}; Kleene p1 & ~p2 of the two masks "
        f"bitwise equal to the compound's: {same_mask}; co-trained params "
        f"bitwise equal to those trained alone: {json.dumps(same)}; the "
        f"compound saves {single_calls - res.oracle_calls_total} of "
        f"{single_calls} calls "
        f"({100 * (1 - res.oracle_calls_total / single_calls):.1f}%)")
    if not same_mask:
        bad.append("the compound mask differs from the Kleene combination "
                   "of the single-leaf masks")
    if not all(same.values()):
        bad.append(f"co-trained params differ from those trained alone: "
                   f"{same}")
    if not res.oracle_calls_total <= single_calls:
        bad.append(f"the compound's {res.oracle_calls_total} calls exceed "
                   f"the single runs' {single_calls}")

    # 3. cross-session CSE on the first CSE_DOCS documents (bounds the
    # phase's time): two sessions of one engine in each arm
    sub = InMemoryStore(store.get(np.arange(CSE_DOCS)))
    sub_truth = [t[:CSE_DOCS] for t in truth]
    arms = {}
    for cse in (True, False):
        p = leaves(sub_truth)
        eng = engine(sub)
        opt = QueryOptimizer(cse=cse)
        tw = time.perf_counter()
        masks = [eng.session_view(optimizer=opt).filter(pred, seed=0).mask
                 for pred in (p[0] & ~p[1], p[1] | p[2])]
        snap = opt.snapshot()
        arms[cse] = {"masks": masks,
                     "calls": sum(lf.oracle.calls for lf in p),
                     "wall_seconds": time.perf_counter() - tw,
                     **{k: snap[k] for k in (
                         "proxies_trained", "proxy_hits", "artifacts_built",
                         "artifact_hits")}}
    on, off = arms[True], arms[False]
    cse_equal = all(np.array_equal(a, b)
                    for a, b in zip(on["masks"], off["masks"]))
    summary = {arm: {k: v for k, v in a.items() if k != "masks"}
               for arm, a in (("cse", on), ("no_cse", off))}
    out["cse"] = {"docs": CSE_DOCS, "masks_equal": cse_equal, **summary}
    log(f"[compound] cross-session CSE on the first {CSE_DOCS} documents "
        f"(cut to bound the phase's time), sessions p1 & ~p2 then p2 | p3, "
        f"seed 0: masks bitwise equal across the arms: {cse_equal}; "
        f"QueryOptimizer(): {json.dumps(summary['cse'])}; "
        f"QueryOptimizer(cse=False): {json.dumps(summary['no_cse'])}")
    if not cse_equal:
        bad.append("the CSE arm's masks differ from the cse=False arm's")
    if on["proxies_trained"] != 3:
        bad.append(f"the CSE arm trained {on['proxies_trained']} proxies, "
                   f"not 3")
    if not on["proxy_hits"] + on["artifact_hits"] > 0:
        bad.append("the CSE arm shared nothing")
    if not on["calls"] <= off["calls"]:
        bad.append(f"the CSE arm bought {on['calls']} labels, more than "
                   f"the cse=False arm's {off['calls']}")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[compound] phase time {out['phase_seconds']:.1f} s")
    if bad:
        fail("compound: " + "; ".join(bad))
    return out, {form: run[2] for form, run in runs.items()}


def topk_phase(dev, embeds, queries, full) -> dict:
    """Phase 7: SemanticTopK over one leaf and over a compound child, each
    on a fresh engine at seed 0, against the same predicate's full
    filter() at seed 0 from the earlier phases (``full``: predicate ->
    (mask, oracle calls)). Every gate is checked and logged; the phase
    fails after the last."""
    import numpy as np
    from repro_torch.config import CascadeConfig, ProxyConfig
    from repro_torch.core.oracle import SimulatedOracle
    from repro_torch.engine import (InMemoryStore, QueryOptimizer,
                                    ScaleDocEngine, SemanticPredicate,
                                    SemanticTopK)
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.fused_scoring import ops as s_ops
    store = InMemoryStore(embeds)
    n = len(store)
    bad = []
    out = {}
    t_phase = time.perf_counter()
    for form in ("p1", "p1 & ~p2"):
        p = [SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                               name=f"p{i + 1}")
             for i, q in enumerate(queries[:2])]
        child = p[0] if form == "p1" else p[0] & ~p[1]
        engine = ScaleDocEngine(store, ProxyConfig(),
                                CascadeConfig(accuracy_target=0.9),
                                device=dev)
        opt = None
        if form != "p1":
            opt = QueryOptimizer()
            engine = engine.session_view(optimizer=opt)
        s_ops.KERNEL.launches = 0
        c_ops.KERNEL.launches = 0
        tw = time.perf_counter()
        res = engine.filter(SemanticTopK(child, k=TOPK_K), seed=0)
        wall = time.perf_counter() - tw
        launches = {"fused_scoring": s_ops.KERNEL.launches,
                    "contrastive": c_ops.KERNEL.launches}
        members = np.flatnonzero(res.mask)
        full_mask, full_calls = full[form]
        walked = res.leaf_reports[0].n_pending
        row = {"plan": res.plan, "k": TOPK_K, "members": len(members),
               "docs_walked": walked,
               "oracle_calls": res.oracle_calls_total,
               "train_calls": res.oracle_calls_train,
               "calib_calls": sum(r.oracle_calls_calib
                                  for r in res.leaf_reports),
               "walk_calls": sum(r.oracle_calls_online
                                 for r in res.leaf_reports),
               "full_filter_calls": full_calls,
               "leaves": leaf_rows(res),
               "provenance": res.provenance.counts(),
               "provenance_complete": res.provenance.complete(),
               "launches": launches, "wall_seconds": wall}
        if opt is not None:
            row["topk_queries"] = opt.snapshot()["topk_queries"]
        out[form] = row
        log(f"[topk] SemanticTopK({form}, k={TOPK_K}) (seed 0"
            f"{', through a QueryOptimizer' if opt else ''}): plan "
            f"{res.plan}; {len(members)} members, {walked} of {n} documents "
            f"walked; oracle calls {res.oracle_calls_total} (train "
            f"{row['train_calls']}, calib {row['calib_calls']}, walk "
            f"{row['walk_calls']}) against {full_calls} for the full "
            f"filter(); per leaf {json.dumps(row['leaves'])}; provenance "
            f"{json.dumps(row['provenance'])}; launches {launches}; wall "
            f"{wall:.3f} s")
        if len(members) != TOPK_K:
            bad.append(f"{form}: {len(members)} members, not {TOPK_K}")
        if not full_mask[members].all():
            bad.append(f"{form}: {int((~full_mask[members]).sum())} members "
                       f"outside the full filter()'s mask at seed 0")
        if not res.oracle_calls_total < full_calls:
            bad.append(f"{form}: {res.oracle_calls_total} calls, no fewer "
                       f"than the full filter()'s {full_calls}")
        if opt is not None and row["topk_queries"] != 1:
            bad.append(f"{form}: topk_queries {row['topk_queries']}, not 1")
        if not res.provenance.complete():
            bad.append(f"{form}: the provenance map is incomplete")
        for name, count in launches.items():
            if count <= 0:
                bad.append(f"{form}: {name} was never launched")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[topk] phase time {out['phase_seconds']:.1f} s")
    if bad:
        fail("topk: " + "; ".join(bad))
    return out


class CountingOracle:
    """Per-doc purchase ledger around a raw oracle: the witness that no
    document is bought twice."""

    def __init__(self, inner):
        self.inner = inner
        self.per_doc = {}

    @property
    def calls(self):
        return self.inner.calls

    def label(self, indices):
        import numpy as np
        indices = np.asarray(indices, np.int64)
        for i in indices:
            self.per_doc[int(i)] = self.per_doc.get(int(i), 0) + 1
        return self.inner.label(indices)


def degrade_phase(dev, embeds, query, fault_free_mask) -> dict:
    """Phase 8: p1 at seed 0 on fresh engines over the oracle stack
    ResilientOracle(CachedOracle(ChaosOracle(counting(SimulatedOracle)))),
    blacked out from invocation DEGRADE_BLACKOUT on: degrade="defer",
    heal, repair_pending() (against the fault-free p1 run's mask), then
    degrade="proxy_fallback". Every gate is checked and logged; the phase
    fails after the last."""
    import numpy as np
    from repro_torch.config import CascadeConfig, ProxyConfig
    from repro_torch.core.oracle import CachedOracle, SimulatedOracle
    from repro_torch.engine import (InMemoryStore, ScaleDocEngine,
                                    SemanticPredicate)
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.fused_scoring import ops as s_ops
    from repro_torch.serve import ChaosConfig, ChaosOracle, ResilientOracle
    store = InMemoryStore(embeds)
    n = len(store)
    bad = []
    out = {}
    t_phase = time.perf_counter()

    def stack():
        counting = CountingOracle(SimulatedOracle(query.truth))
        chaos = ChaosOracle(counting, ChaosConfig(
            blackouts=((DEGRADE_BLACKOUT, 1 << 30),)))
        return ResilientOracle(CachedOracle(chaos)), chaos, counting

    def run(label, fn):
        s_ops.KERNEL.launches = 0
        c_ops.KERNEL.launches = 0
        tw = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - tw
        launches = {"fused_scoring": s_ops.KERNEL.launches,
                    "contrastive": c_ops.KERNEL.launches}
        for name, count in launches.items():
            if count <= 0:
                bad.append(f"{label}: {name} was never launched")
        return res, launches, wall

    def engine(mode):
        return ScaleDocEngine(store, ProxyConfig(),
                              CascadeConfig(accuracy_target=0.9),
                              degrade=mode, device=dev)

    # defer, then heal and repair
    res_o, chaos, counting = stack()
    eng = engine("defer")
    pred = SemanticPredicate(query.embed, res_o, name="p1")
    res, launches, wall = run("defer", lambda: eng.filter(pred, seed=0))
    unresolved = res.unresolved
    tickets = eng.repair_count
    out["defer"] = {"degraded": res.degraded, "unresolved": len(unresolved),
                    "partial_accepted": int(res.mask.sum()),
                    "oracle_calls": res.oracle_calls_total,
                    "tickets": tickets, "error": res.error,
                    "resilience": res_o.resilience_stats(),
                    "chaos_invocations": chaos.invocations,
                    "provenance": res.provenance.counts(),
                    "launches": launches, "wall_seconds": wall}
    log(f"[degrade] defer (blackout from invocation {DEGRADE_BLACKOUT}): "
        f"degraded {res.degraded}, {len(unresolved)} of {n} documents "
        f"unresolved, {int(res.mask.sum())} accepted in the partial mask, "
        f"{tickets} ticket(s) parked; oracle calls {res.oracle_calls_total};"
        f" error {res.error!r}; resilience "
        f"{json.dumps(res_o.resilience_stats())}; provenance "
        f"{json.dumps(res.provenance.counts())}; launches {launches}; wall "
        f"{wall:.3f} s")
    if not (res.degraded and res.degrade_mode == "defer" and tickets == 1):
        bad.append(f"defer: degraded {res.degraded}, {tickets} tickets "
                   f"parked, not 1")
    if res.mask[unresolved].any():
        bad.append("defer: the partial mask accepts unresolved documents")
    chaos.heal()
    (healed,), launches, wall = run("repair", eng.repair_pending)
    same = bool(np.array_equal(healed.mask, fault_free_mask))
    twice = sum(1 for v in counting.per_doc.values() if v > 1)
    out["repair"] = {"degraded": healed.degraded,
                     "mask_equal_fault_free": same,
                     "oracle_calls": healed.oracle_calls_total,
                     "docs_bought": len(counting.per_doc),
                     "docs_bought_twice": twice,
                     "tickets_left": eng.repair_count,
                     "launches": launches, "wall_seconds": wall}
    log(f"[degrade] repair after heal: degraded {healed.degraded}, mask "
        f"bitwise equal to the fault-free p1 run at seed 0: {same}; oracle "
        f"calls {healed.oracle_calls_total}; {len(counting.per_doc)} "
        f"documents bought, {twice} of them twice; {eng.repair_count} "
        f"ticket(s) left; launches {launches}; wall {wall:.3f} s")
    if healed.degraded or not same:
        bad.append("repair: the replay is not the fault-free run")
    if twice:
        bad.append(f"repair: {twice} documents bought twice")

    # proxy fallback on a fresh stack
    res_o, chaos, counting = stack()
    eng = engine("fail")
    pred = SemanticPredicate(query.embed, res_o, name="p1")
    res, launches, wall = run("proxy_fallback", lambda: eng.filter(
        pred, seed=0, degrade="proxy_fallback", ground_truth=query.truth))
    agree = float(np.mean(res.mask == query.truth))
    out["proxy_fallback"] = {
        "degraded": res.degraded, "unresolved": len(res.unresolved),
        "fallback_docs": res.fallback_docs,
        "est_accuracy_debit": res.est_accuracy_debit,
        "oracle_calls": res.oracle_calls_total, "f1": res.achieved_f1,
        "agreement": agree, "provenance": res.provenance.counts(),
        "launches": launches, "wall_seconds": wall}
    log(f"[degrade] proxy_fallback: degraded {res.degraded}, "
        f"{len(res.unresolved)} unresolved, {res.fallback_docs} documents "
        f"decided by the proxy alone, est_accuracy_debit "
        f"{res.est_accuracy_debit:.6f}; oracle calls "
        f"{res.oracle_calls_total}; agreement with the truth {agree:.4f} "
        f"(F1 {res.achieved_f1:.4f}); provenance "
        f"{json.dumps(res.provenance.counts())}; launches {launches}; wall "
        f"{wall:.3f} s")
    if not (res.degraded and res.degrade_mode == "proxy_fallback"):
        bad.append("proxy_fallback: the filter did not degrade")
    if len(res.unresolved):
        bad.append(f"proxy_fallback: {len(res.unresolved)} unresolved")
    if not 0.0 < res.est_accuracy_debit <= 1.0:
        bad.append(f"proxy_fallback: debit {res.est_accuracy_debit}")
    if not agree > DEGRADE_AGREE_MIN:
        bad.append(f"proxy_fallback: agreement {agree:.4f} <= "
                   f"{DEGRADE_AGREE_MIN}")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[degrade] phase time {out['phase_seconds']:.1f} s")
    if bad:
        fail("degrade: " + "; ".join(bad))
    return out


def trace_faults(spans) -> list:
    """What is wrong with one session's trace: it must hold one root, a
    ``session`` span, with one ``engine.filter`` under it, every span
    closed and parented inside the trace."""
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans if s["parent_id"] is None]
    bad = []
    if [s["name"] for s in roots] != ["session"]:
        bad.append(f"roots {[s['name'] for s in roots]}")
    under = [s for s in spans if s["name"] == "engine.filter"
             and roots and s["parent_id"] == roots[0]["span_id"]]
    if len(under) != 1:
        bad.append(f"{len(under)} engine.filter spans under the root")
    for s in spans:
        if s["end"] < s["start"]:
            bad.append(f"{s['name']} ends before it starts")
        if s["parent_id"] is not None and s["parent_id"] not in ids:
            bad.append(f"{s['name']} has a parent outside the trace")
    return bad


def serve_phase(dev, embeds, queries, refs, n_tiles) -> dict:
    """Phase 9: the serving plane. One resident engine behind a
    PredicateServer of four workers answers four sessions submitted at
    once (the mixed leaf/compound shape of tests/test_serve.py), then a
    fresh engine behind PredicateServer(optimize=True) answers them again
    (``refs``: form -> (mask, oracle calls, wall seconds) of the serial
    runs in phases 4 and 6). Every gate is checked and logged; the phase
    fails after the last."""
    import numpy as np
    from repro_torch.config import CascadeConfig, ProxyConfig
    from repro_torch.core.oracle import CachedOracle, SimulatedOracle
    from repro_torch.engine import (InMemoryStore, ScaleDocEngine,
                                    SemanticPredicate)
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.fused_scoring import ops as s_ops
    from repro_torch.runtime.trace import format_span_tree
    from repro_torch.serve import PredicateServer, SessionState
    store = InMemoryStore(embeds)
    pcfg = ProxyConfig()
    bad = []
    out = {}
    t_phase = time.perf_counter()
    serial_wall = sum(r[2] for r in refs.values())
    serial_calls = sum(r[1] for r in refs.values())

    def workload():
        sims = [CountingOracle(SimulatedOracle(q.truth)) for q in queries]
        p = [SemanticPredicate(q.embed, CachedOracle(o), name=f"p{i + 1}")
             for i, (q, o) in enumerate(zip(queries, sims))]
        return sims, [("p1", p[0], 0), ("p1 & ~p2", p[0] & ~p[1], 0),
                      ("p2 | p3", p[1] | p[2], 1), ("p3", p[2], 0)]

    masks = {}
    for arm, optimize in (("concurrent", False), ("optimize", True)):
        sims, forms = workload()
        engine = ScaleDocEngine(store, pcfg,
                                CascadeConfig(accuracy_target=0.9),
                                device=dev)
        with PredicateServer(engine, workers=4,
                             optimize=optimize) as server:
            s_ops.KERNEL.launches = 0
            c_ops.KERNEL.launches = 0
            tw = time.perf_counter()
            sessions = [server.submit(pred, seed=seed, name=name)
                        for name, pred, seed in forms]
            results = [s.result(timeout=900) for s in sessions]
            makespan = time.perf_counter() - tw
            launches = {"fused_scoring": s_ops.KERNEL.launches,
                        "contrastive": c_ops.KERNEL.launches}
            snap = json.loads(server.metrics_json())
            traces = {s.name: server.tracer.spans(s.trace_id)
                      for s in sessions}
        bought = sum(o.calls for o in sims)
        twice = sum(1 for o in sims for v in o.per_doc.values() if v > 1)
        built = sum(len(r.leaf_reports) for r in results)
        counters = snap["counters"]
        latency = snap["observations"]["session_latency_seconds"]
        flushes = counters.get("oracle_flushes", 0)
        flushed = counters.get("oracle_docs_flushed", 0)
        ledger_docs = sum(t["oracle_docs"]
                          for t in snap["cost_ledger"]["tenants"].values())
        masks[arm] = {s.name: r.mask for s, r in zip(sessions, results)}
        row = {
            "makespan_seconds": makespan,
            "serial_wall_seconds": serial_wall,
            "sessions": {s.name: {
                "state": s.state.value, "plan": r.plan,
                "oracle_calls": r.oracle_calls_total,
                "mask_equal_serial": bool(np.array_equal(
                    r.mask, refs[s.name][0])),
                "provenance_complete": r.provenance.complete(),
                "trace_faults": trace_faults(traces[s.name]),
                **{k: v for k, v in s.stats().items() if k in (
                    "oracle_wait_seconds", "queue_wait_seconds",
                    "run_seconds", "wall_seconds")}}
                for s, r in zip(sessions, results)},
            "latency_p50_seconds": latency["p50"],
            "latency_p95_seconds": latency["p95"],
            "docs_bought": bought, "docs_bought_twice": twice,
            "serial_calls": serial_calls,
            "oracle_invocations": flushes,
            "docs_per_invocation": flushed / max(flushes, 1),
            "ledger_oracle_docs": ledger_docs,
            "broker_docs_flushed": flushed,
            "cache_docs_purchased": snap["oracle_cache"]["docs_purchased"],
            "ledger_tenants": snap["cost_ledger"]["tenants"],
            "launches": launches, "artifacts_built": built,
            "optimizer": snap["optimizer"], "metrics_snapshot": snap}
        if arm == "concurrent":
            row["span_tree_p1_and_not_p2"] = format_span_tree(
                traces["p1 & ~p2"])
        out[arm] = row
        log(f"[serve] {arm} (PredicateServer(workers=4"
            f"{', optimize=True' if optimize else ''}), sessions "
            f"{', '.join(f'{n} (seed {sd})' for n, _, sd in forms)}): "
            f"makespan {makespan:.3f} s against {serial_wall:.3f} s for "
            f"the serial runs; session latency p50 {latency['p50']:.3f} s, "
            f"p95 {latency['p95']:.3f} s; {bought} documents bought "
            f"(serial {serial_calls}; {twice} twice) in {int(flushes)} "
            f"oracle invocations ({flushed / max(flushes, 1):.1f} documents"
            f" each); ledger {ledger_docs}, broker {int(flushed)}, cache "
            f"{snap['oracle_cache']['docs_purchased']}; launches "
            f"{launches} for {built} leaf artifacts; per session "
            + json.dumps({n: {k: v for k, v in r.items()
                              if k != "trace_faults"}
                          for n, r in row["sessions"].items()}))
        if optimize:
            opt = snap["optimizer"]
            # a proxy is shared per (leaf, seed): p2 | p3 runs at seed 1
            pairs = {(lf.key, sd) for _, pred, sd in forms
                     for lf in pred.leaves()}
            log(f"[serve] optimize: proxies_trained "
                f"{opt['proxies_trained']}, proxy_hits {opt['proxy_hits']},"
                f" artifacts_built {opt['artifacts_built']}, artifact_hits "
                f"{opt['artifact_hits']}, flights_joined "
                f"{opt['flights_joined']} ({len(pairs)} distinct (leaf, "
                f"seed) pairs)")
            if opt["proxies_trained"] != len(pairs):
                bad.append(f"optimize: {opt['proxies_trained']} proxies "
                           f"trained, not {len(pairs)} (one a distinct "
                           f"leaf and seed)")
            diff = [n for n in masks[arm] if not np.array_equal(
                masks[arm][n], masks["concurrent"][n])]
            if diff:
                bad.append(f"optimize: masks of {diff} differ from the "
                           f"concurrent arm's")
        else:
            log("[serve] the p1 & ~p2 session's span tree:\n"
                + row["span_tree_p1_and_not_p2"])
            for name, r in row["sessions"].items():
                if r["state"] != SessionState.DONE.value:
                    bad.append(f"{name}: state {r['state']}")
                if not r["mask_equal_serial"]:
                    bad.append(f"{name}: mask differs from its serial run")
                if not r["provenance_complete"]:
                    bad.append(f"{name}: the provenance map is incomplete")
                if r["trace_faults"]:
                    bad.append(f"{name}: trace {r['trace_faults']}")
            if not bought <= serial_calls:
                bad.append(f"{bought} documents bought, more than the "
                           f"serial runs' {serial_calls}")
            if not (ledger_docs == bought == flushed
                    == snap["oracle_cache"]["docs_purchased"]):
                bad.append(f"the ledger's {ledger_docs} oracle documents, "
                           f"the oracles' {bought}, the broker's "
                           f"{flushed} and the caches' "
                           f"{snap['oracle_cache']['docs_purchased']} "
                           f"disagree")
            if twice:
                bad.append(f"{twice} documents bought twice")
            if built != 6 or launches["fused_scoring"] != n_tiles * built:
                bad.append(f"{launches['fused_scoring']} fused launches for "
                           f"{built} leaf artifacts, not {n_tiles} each "
                           f"of 6")
            if launches["contrastive"] != 4 * pcfg.phase2_steps:
                bad.append(f"{launches['contrastive']} contrastive "
                           f"launches, not {pcfg.phase2_steps} for each of "
                           f"4 training runs")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[serve] phase time {out['phase_seconds']:.1f} s")
    if bad:
        fail("serve: " + "; ".join(bad))
    return out


def ablation_phase(dev, embeds, query, n_tiles) -> dict:
    """Phase 10: the five training variants of the paper's Fig. 9 on p1
    (train_proxy_variant at seed 0 on a 10% sample drawn as
    benchmarks/bench_ablation.py draws it), each scored over the corpus
    (the contrastive variants through the executor's fused kernel, the
    classifier by mlp_classifier_scores on the card), and the unfiltered
    fraction of the brute-force optimal cascade on the true labels at
    F1 0.9. Every gate is checked and logged; the phase fails after the
    last."""
    import numpy as np
    import torch
    from repro_torch.config import ProxyConfig, replace
    from repro_torch.core.calibration import discretize
    from repro_torch.core.thresholds import oracle_optimal_thresholds
    from repro_torch.core.trainer import (mlp_classifier_scores,
                                          train_proxy_variant)
    from repro_torch.engine import InMemoryStore, ScoringExecutor
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.fused_scoring import ops as s_ops
    store = InMemoryStore(embeds)
    n = len(store)
    cfg = replace(ProxyConfig(), embed_dim=embeds.shape[1])
    idx = np.random.default_rng(0).choice(n, size=int(0.1 * n),
                                          replace=False)
    sample, labels = store.get(idx), query.truth[idx]
    executor = ScoringExecutor(device=dev)
    edges = discretize(64)
    bad = []
    out = {}
    t_phase = time.perf_counter()
    for variant in ("mlp", "qsim", "qsim+supcon", "qsim+polar", "full"):
        s_ops.KERNEL.launches = 0
        c_ops.KERNEL.launches = 0
        torch.cuda.synchronize()
        tt = time.perf_counter()
        params = train_proxy_variant(0, query.embed, sample, labels, cfg,
                                     variant, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - tt
        if variant == "mlp":
            scores = torch.cat([
                mlp_classifier_scores(params, torch.as_tensor(
                    embeds[i:i + TILE], device=dev))
                for i in range(0, n, TILE)]).cpu().numpy()
        else:
            scores = executor.score(params, query.embed, store)[0]
        score_s = time.perf_counter() - tt - train_s
        launches = {"fused_scoring": s_ops.KERNEL.launches,
                    "contrastive": c_ops.KERNEL.launches}
        sel = oracle_optimal_thresholds(scores, query.truth, edges, 0.9)
        finite = bool(np.isfinite(scores).all()) and scores.shape == (n,)
        pos, neg = scores[query.truth], scores[~query.truth]
        row = {"train_seconds": train_s, "score_seconds": score_s,
               "feasible": sel.feasible, "l": sel.l, "r": sel.r,
               "unfiltered": sel.unfiltered, "f1": sel.est_accuracy,
               "pos5_minus_neg95": float(np.percentile(pos, 5)
                                         - np.percentile(neg, 95)),
               "finite": finite, "launches": launches}
        out[variant] = row
        log(f"[ablation] {variant}: trained in {train_s:.3f} s on "
            f"{len(idx)} documents, scored in {score_s:.3f} s; optimal "
            f"cascade at F1 0.9: unfiltered {sel.unfiltered:.4f} (l "
            f"{sel.l:.4f}, r {sel.r:.4f}, F1 {sel.est_accuracy:.4f}); "
            f"pos p5 - neg p95 {row['pos5_minus_neg95']:.4f}; launches "
            f"{launches}")
        if not finite:
            bad.append(f"{variant}: scores not finite or not ({n},)")
        want_c = 0 if variant in ("mlp", "qsim") else cfg.phase2_steps
        if launches["contrastive"] != want_c:
            bad.append(f"{variant}: {launches['contrastive']} contrastive "
                       f"launches, not {want_c}")
        want_f = 0 if variant == "mlp" else n_tiles
        if launches["fused_scoring"] != want_f:
            bad.append(f"{variant}: {launches['fused_scoring']} fused "
                       f"launches, not {want_f}")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[ablation] phase time {out['phase_seconds']:.1f} s")
    if bad:
        fail("ablation: " + "; ".join(bad))
    return out


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
    names = ("fused_scoring", "contrastive", "flash_attention", "wkv6")
    build_s = _build.build_all(names)
    log(f"[build] {', '.join(n + '.cu' for n in names)} in {build_s:.1f} s")
    ptx = {name: ptxas_entries(_build.build_log(name)) for name in names}
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "warning" in line.lower():
                log(f"[build] {name}: {line.strip()[:200]}")
    for name in names:
        if name == "fused_scoring":
            continue
        for entry, r in ptx[name].items():
            short = entry.split("_cu_", 1)[-1][8:]   # past the file's hash
            log(f"[build] {name}: {short[:72]}: {json.dumps(r)}")
    fused_ptx = ptx["fused_scoring"]
    path_entry = [e for e in fused_ptx if "ILi512ELi128ELb1E" in e]
    smem_fn = _build.load("fused_scoring").fused_scores_smem_bytes
    smem_fn.argtypes, smem_fn.restype = [ctypes.c_int], ctypes.c_int
    fused_smem = smem_fn(512)
    log(f"[build] fused_scoring: {len(fused_ptx)} instantiations; the "
        f"path's (H=512, L=128, 16-byte copies): "
        f"{json.dumps(fused_ptx[path_entry[0]] if path_entry else None)}, "
        f"{fused_smem} B of dynamic shared memory a block; registers "
        f"{min(r['registers'] for r in fused_ptx.values())}-"
        f"{max(r['registers'] for r in fused_ptx.values())}, spill stores "
        f"{sum(r['spill_stores'] for r in fused_ptx.values())} B, spill "
        f"loads {sum(r['spill_loads'] for r in fused_ptx.values())} B over "
        f"all")
    if not path_entry or any(r["spill_stores"] or r["spill_loads"]
                             for r in fused_ptx.values()):
        fail("fused_scoring: ptxas reports spills (or no path "
             "instantiation)")
    report["build_seconds"] = build_s
    report["ptxas"] = ptx
    report["fused_smem_bytes"] = fused_smem

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
    checks.update(fused_checks(dev, t, w, docs, rng))
    log("[kernels] fused_scoring: a second call on the path's inputs gave "
        "the same bits")
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
        elif case == "tie_far":
            # tied bellwether candidates in different 8-row anchor blocks
            y[:, [0, 9]] = 1
            y[:, [1, 17]] = 0
            zd[:, 9] = zd[:, 0]
            zd[:, 17] = zd[:, 1]
            zq[:] = zd[:, 1] - zd[:, 0]
        elif case == "empty_u":          # n = 2, one positive
            y[:] = 0
            y[:, 0] = 1
        return t(zq), t(zd), t(y)

    # the path's shape and the kernel's limits with every degenerate case;
    # n and p that cut the 8-row anchor blocks, the 256-row tiles and the
    # 32-column tiles raggedly; the n = 2 batch whose every U(i) is empty
    main_cases = ("mixed", "all_pos", "all_neg", "tie", "tie_far")
    c_cases = [(q, n, p, c) for q, n, p in ((4, 128, 64), (1, 512, 256))
               for c in main_cases]
    c_cases += [(q, n, p, c) for q, n, p in ((2, 1, 5), (2, 7, 1),
                                             (3, 100, 5), (2, 129, 256),
                                             (1, 511, 1))
                for c in ("mixed", "tie_far") if n >= 18 or c == "mixed"]
    c_cases.append((3, 2, 5, "empty_u"))
    c_errs = {}
    for q, n, p, case in c_cases:
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
        if case == "empty_u" and got[:, 1].any():
            fail("contrastive: a batch with no valid anchor has supcon != 0")
        if case == "mixed" and not torch.equal(
                got, c_ops.contrastive_losses(*args, 0.07, 0.2)):
            fail(f"contrastive Q={q} n={n} p={p}: two calls on the same "
                 f"inputs differ")
    log(f"[kernels] contrastive: {len(c_cases)} cases; a second call on "
        f"each mixed case's inputs gave the same bits")
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
    f_errs, f_stated = flash_checks(dev, rng)
    w_errs = wkv6_checks(dev, rng)
    report["checks"] = {**checks, **c_errs, "phase2 grad": g_err, **f_errs,
                        **w_errs}
    report["flash_bf16_vs_round_p_false"] = f_stated

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
    results, full = [], []
    for i, q in enumerate(queries):
        oracle = SimulatedOracle(q.truth)
        tq = time.perf_counter()
        st = engine.query(q.embed, oracle, ground_truth=q.truth, seed=0)
        wall = time.perf_counter() - tq
        # each query's fault-free decisions at seed 0
        full.append((st.cascade.labels.copy(), st.oracle_calls_total,
                     wall))
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
    fused_call = lambda: s_ops.fused_scores_multi(docs, *w, zq1)
    fused_ms = cuda_ms(fused_call, 20)
    fused_plain_ms = cuda_ms(lambda: s_ref.ref_scores_multi(docs, *w, zq1),
                             20)
    fused_graph_ms = graph_ms(fused_call, 10, 5)
    h, lat = 512, 128
    fused_flops = 2 * TILE * (DIM * h + h * h + h * lat + lat)
    fused_bytes = 4 * (TILE * DIM + DIM * h + h * h + h * lat + 2 * h + lat
                       + lat + TILE)
    fused_bound = max(fused_flops / PEAK_FP32_FLOPS,
                      fused_bytes / PEAK_BYTES) * 1e3
    ct = {f"Q={q} n={n} p={p}": contrastive_times(
        contrastive_case(q, n, p, "mixed"))
        for q, n, p in ((4, 128, 64), (1, 512, 256))}
    for shape, c in ct.items():
        log(f"[times] contrastive {shape}: device time per call "
            f"{c['device_ms']:.5f} ms (a replayed CUDA graph of "
            f"{c['graph_calls']} back-to-back calls); torch.profiler, per "
            f"call: rows kernel {c['profiler_rows_ms']} ms, finish kernel "
            f"{c['profiler_finish_ms']} ms; one ops.contrastive_losses call "
            f"(host included, CUDA events over 200) {c['call_ms']:.5f} ms; "
            f"plain {c['plain_ms']:.4f} ms; bound {c['bound_ms']:.6f} ms "
            f"({c['bound_by']})")
    con = ct["Q=4 n=128 p=64"]
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
         "ms": con["device_ms"], "plain_ms": con["plain_ms"],
         "bound_ms": con["bound_ms"], "bound_by": con["bound_by"],
         "library_ms": None},
    ]
    for k in kernels:
        log(f"[times] {k['name']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f}"
            f" ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']}), "
            f"{k['launches'] / n_q:.1f} launches per query()")
    log(f"[times] fused_scoring at (n={TILE}, D={DIM}, H={h}, L={lat}, Q=1):"
        f" {fused_ms:.4f} ms by CUDA events around 20 calls, "
        f"{fused_graph_ms:.4f} ms a call from a replayed CUDA graph of 10 "
        f"calls; {fused_flops / fused_ms / 1e9:.1f} TFLOP/s, "
        f"{fused_ms / fused_bound:.2f}x its bound")
    torch.cuda.synchronize()
    scores, stats = engine.executor.score(leaf_params, queries[0].embed,
                                          store)
    split = {f: getattr(stats, f) for f in (
        "tiles_scored", "bytes_streamed", "host_io_seconds",
        "compute_seconds", "stall_seconds", "wall_seconds")}
    split["overlap_fraction"] = stats.overlap_fraction
    log(f"[times] one scoring pass: {json.dumps(split)}")
    log(f"[times] one scoring pass over {n} documents: compute_seconds "
        f"{stats.compute_seconds:.4f} ({stats.tiles_scored} tiles; "
        f"{stats.tiles_scored} x the kernel's {fused_ms:.4f} ms = "
        f"{stats.tiles_scored * fused_ms / 1e3:.4f} s) beside "
        f"host_io_seconds {stats.host_io_seconds:.4f}, wall "
        f"{stats.wall_seconds:.4f}")
    # the other stages of one query(): a training run (4 padded lanes, as
    # the engine dispatches it) and the calibration, on query 0's inputs
    q0 = queries[0]
    idx = np.random.default_rng(0).choice(n, size=n // 10, replace=False)
    torch.cuda.synchronize()
    tt = time.perf_counter()
    engine._train_padded([1], [q0.embed], [store.get(idx)], [q0.truth[idx]])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - tt
    steps = train_step_split(engine, ([1], [q0.embed], [store.get(idx)],
                                      [q0.truth[idx]]))
    log(f"[times] one _train_padded run, synchronized at every step: "
        f"{json.dumps(steps)}")
    tc = time.perf_counter()
    calibrate_thresholds(scores, CachedOracle(SimulatedOracle(q0.truth)),
                         engine.cascade_cfg, np.random.default_rng(1))
    calib_s = time.perf_counter() - tc
    stages = {"train_seconds": train_s, "score_seconds": stats.wall_seconds,
              "calibrate_seconds": calib_s,
              "query_wall_seconds": results[0]["wall_seconds"]}
    log(f"[times] one query's stages: {json.dumps(stages)}")
    report["times"] = {"kernels": kernels, "scoring_pass": split,
                       "fused_graph_ms": fused_graph_ms,
                       "query_stages": stages, "train_steps": steps,
                       "fused_flops": fused_flops, "fused_bytes": fused_bytes,
                       "contrastive": ct}

    # -- 6. compound predicates, the planner and cross-session CSE -------
    n_tiles = -(-n // engine.executor.chunk)
    report["compound"], forms = compound_phase(dev, corpus.embeds, queries,
                                               n_tiles)

    # -- 7. SemanticTopK --------------------------------------------------
    report["topk"] = topk_phase(dev, corpus.embeds, queries, {
        "p1": full[0][:2],
        "p1 & ~p2": (forms["and_not"].mask,
                     forms["and_not"].oracle_calls_total)})

    # -- 8. the degraded modes over an oracle outage ---------------------
    report["degrade"] = degrade_phase(dev, corpus.embeds, queries[0],
                                      full[0][0])

    # -- 9. the serving plane: concurrent sessions -------------------------
    refs = {"p1": full[0], "p3": full[2]}
    for name, form in (("p1 & ~p2", "and_not"), ("p2 | p3", "or")):
        refs[name] = (forms[form].mask, forms[form].oracle_calls_total,
                      report["compound"][form]["wall_seconds"])
    report["serve"] = serve_phase(dev, corpus.embeds, queries, refs,
                                  n_tiles)

    # -- 10. the ablation surface ------------------------------------------
    report["ablation"] = ablation_phase(dev, corpus.embeds, queries[0],
                                        n_tiles)

    # -- 11. offline path: from_corpus over llama3-8b ---------------------
    del engine, store, corpus, docs
    torch.cuda.empty_cache()
    offline, service, _ = offline_phase(dev, OFF_ARCH, "flash_attention",
                                        dict(attn_impl="einsum"), "offline",
                                        COS_MIN)
    del service
    report["offline"] = offline

    # -- 12. flash times ------------------------------------------------------
    ft = flash_times(dev)
    kernels.append(
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash.py:101",
         "launches": offline["launches"],
         "max_abs_err": max(f_errs.values()),
         "ms": ft["ms"], "plain_ms": ft["plain_ms"],
         "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
         "library_ms": ft["library_ms"]})
    share = offline["launches"] // offline["batches"] * ft["ms"] \
        / offline["embed_batch_ms"]
    sdpa = ", ".join(f"{n} {t:.4f} ms" if isinstance(t, float) else
                     f"{n} {t}" for n, t in ft["sdpa"].items())
    log(f"[times] flash_attention: bf16 tensor-core kernel {ft['ms']:.4f} "
        f"ms ({ft['ms'] / ft['bound_ms']:.2f}x its bound; "
        f"{ft['flops'] / ft['ms'] / 1e9:.1f} TFLOP/s), the same call "
        f"non-causal {ft['noncausal_ms']:.4f} ms "
        f"({ft['noncausal_tflops']:.1f} TFLOP/s), FP32 kernel on "
        f"the same inputs in f32 {ft['fp32_kernel_ms']:.4f} ms, plain "
        f"{ft['plain_ms']:.4f} ms, bound {ft['bound_ms']:.5f} ms "
        f"({ft['bound_by']}; {ft['fp32_fma_bound_ms']:.4f} ms at the FP32 "
        f"peak), {offline['launches']} launches per from_corpus; SDPA: "
        f"{sdpa}; one embedding batch {offline['embed_batch_ms']:.2f} ms, "
        f"of which flash {100 * share:.1f}%")
    ft["share_of_embed_batch"] = share
    report["times"]["flash"] = ft

    # -- 13. the rwkv6-7b offline path ----------------------------------------
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 1e9
    log(f"[rwkv] after freeing the llama3-8b weights: {held:.3f} GB "
        f"allocated")
    if held > 1.0:
        fail(f"{held:.2f} GB still allocated after the llama3-8b phase")
    rwkv, service, batch = offline_phase(dev, RWKV_ARCH, "wkv6",
                                         dict(rwkv_mode="direct"), "rwkv",
                                         RWKV_COS_MIN)
    tokens = torch.as_tensor(batch, device=dev)
    rc = rwkv_checks(service.cfg, service.params, tokens,
                     service.embed_batch(tokens))
    n_layers = service.cfg.num_layers
    del service
    lay, drift = rc["layer"], rc["drift_min_cosine"]
    log(f"[rwkv] the {n_layers} blocks by hand on batch 0 (pooled: max abs "
        f"err {rc['hand_run_vs_service_max_abs_err']:.3e} against the "
        f"service's); each layer's recurrence, kernel vs direct scan on the "
        f"kernel path's inputs: max abs err {lay['max_rel_err']:.3e} of max "
        f"|y|, f32 ulp distance max {lay['max_ulps']}, least share of "
        f"elements at 0 ulps {lay['min_share_0_ulps']:.4f}, within 1 ulp "
        f"{lay['min_share_within_1_ulp']:.4f}, within 16 ulps "
        f"{lay['min_share_within_16_ulps']:.4f}; time-mix outputs: min "
        f"per-row cosine 1 - {1 - lay['min_cosine']:.3e} (>= "
        f"{LAYER_COS_MIN})")
    for name, by_depth in drift.items():
        log(f"[rwkv] drift of the pooled hidden state, kernel path vs "
            f"{name}: min per-row cosine after " + ", ".join(
                f"{d} layers {c:.6f}" for d, c in by_depth.items()))
    if not lay["min_cosine"] >= LAYER_COS_MIN:
        fail("a time-mix layer's kernel path disagrees with its direct path")
    if not drift["direct"][RWKV_DEPTH] >= RWKV_DEPTH_COS_MIN:
        fail(f"after {RWKV_DEPTH} layers the kernel path has drifted from "
             f"the direct scan")
    if not rc["hand_run_vs_service_max_abs_err"] <= F32_TOL:
        fail("the hand-run blocks do not reproduce the service's embeddings")
    rwkv["checks"] = rc
    report["rwkv"] = rwkv

    # -- 14. wkv6 times ------------------------------------------------------
    wt = wkv6_times(dev)
    kernels.append(
        {"name": "wkv6_intra_chunk", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/wkv6/wkv6.py:93",
         "launches": rwkv["launches"],
         "max_abs_err": max(w_errs.values()),
         "ms": wt["ms"], "plain_ms": wt["plain_ms"],
         "bound_ms": wt["bound_ms"], "bound_by": wt["bound_by"],
         "library_ms": None})
    per_batch = rwkv["launches"] // rwkv["batches"]
    wt["share_of_embed_batch"] = per_batch * wt["ms"] / rwkv["embed_batch_ms"]
    wt["wkv6_op_share_of_embed_batch"] = \
        per_batch * wt["op_ms"] / rwkv["embed_batch_ms"]
    log(f"[times] wkv6_intra_chunk: {wt['ms']:.4f} ms, plain "
        f"{wt['plain_ms']:.4f} ms, bound {wt['bound_ms']:.4f} ms "
        f"({wt['bound_by']}: exp {wt['exp_bound_ms']:.4f} ms for "
        f"{wt['exps']:.4g} exps in the sub-chunk form, which this kernel "
        f"takes, evaluating {wt['exps_evaluated']:.4g}; plain pairwise form "
        f"{wt['pairwise_plain_ms']:.4f} ms; FP32 "
        f"{wt['flop_bound_ms']:.4f} ms "
        f"for {wt['flops']:.4g} FLOP, bytes {wt['byte_bound_ms']:.4f} ms for "
        f"{wt['bytes']:.4g} B), {rwkv['launches']} launches per from_corpus;"
        f" ops.wkv6 (cumsum, kernel, combine) {wt['op_ms']:.4f} ms; one "
        f"embedding batch {rwkv['embed_batch_ms']:.2f} ms, of which the "
        f"kernel {100 * wt['share_of_embed_batch']:.1f}% and ops.wkv6 "
        f"{100 * wt['wkv6_op_share_of_embed_batch']:.1f}%")
    report["times"]["wkv6"] = wt

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
