#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ScaleDoc on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which exits non-zero when it fails:
  1. device  — the card's name and power limit (no card: exit 1);
  2. build   — the four CUDA kernels from src/repro_torch/csrc, one nvcc
               each, all started together; ptxas's registers and spills
               of every entry, logged (fused scoring: per instantiation,
               none may spill) and the fused kernel's shared memory a
               block;
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
               head_dim 128, causal), at qwen3-moe-30b-a3b's (32 heads
               over 4), at zamba2-2.7b's (b=4, s=2048, 32 heads over 32,
               head_dim 80 on the hd-128 instantiations, causal) and at
               small window / q_offset /
               ragged / non-causal shapes, in f32 (the FP32 kernel) and
               bf16 (the tensor-core kernel, also against its plain
               version, which rounds where it rounds, and, logged but not
               a gate, against the rounding of flash.py, P in f32); the
               same at gemma3-12b's head_dim 240 (the wide kernels), at
               its path's shape (b=4, s=2048, 16 heads over 8 KV heads,
               causal, with window 1024 and without) and a ragged
               continuation inside a window;
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
 10. live    — standing predicates over a growing store: the corpus
               through the port's StoreWriter into a MemmapStore
               directory, the first 65,536 rows committed, p1 & ~p2
               registered there (seed 0, DriftConfig(auto=False)); a
               probe scores every delta range through _score_rows
               without the pad and with it against one pass over all N
               rows (bitwise, the card's rule a gate) and logs the
               fused kernel's instantiation (16-byte or 4-byte copies,
               and whether both give the same bits on the same rows);
               then commit groups of 1, 3, 37, 8,191 and 8,193 rows, one
               pump each (the fused launches equal to the tiles scored);
               after [gateway] has landed the rest: the subscriber's
               stream contiguous from 65,536 to N, rows_scored (hi - lo)
               x the scorable leaves per batch, decisions bitwise
               standing_filter(calib_rows=65536) over the final store,
               and after revalidate() bitwise phase 6's p1 & ~p2;
               registration and pump times, rows per second, delta
               oracle calls and the live.* spans logged;
 11. gateway — [serve]'s four sessions over HTTP: a PredicateGateway on
               127.0.0.1 (two tenants) over PredicateServer(workers=4)
               with [live]'s LiveEngine as its live plane, four
               GatewayClients in four threads, while a standing p1
               subscribed over HTTP follows the store through the last
               three commit groups, pumped from another thread: each
               mask over the wire bitwise its serial run's, each
               session's trace one tree rooted at the gateway's request
               span over server, engine and broker spans, /explain
               classifying every document, the per-tenant ledger equal
               to the oracles' purchases, the SSE stream's replay
               bitwise the standing decisions and its done event on
               cancel; makespan and p50/p95 beside [serve]'s;
 12. ablation — the five train_proxy_variant variants on p1 (10% sample
               drawn as benchmarks/bench_ablation.py draws it, seed 0,
               ProxyConfig()), the contrastive ones scored through the
               fused kernel, the classifier by mlp_classifier_scores:
               finite scores, the contrastive kernel launched 0 times for
               qsim and mlp and 60 times for the others; each variant's
               unfiltered fraction under the brute-force optimal cascade
               on the true labels at F1 0.9 (the paper's Fig. 9) logged;
 12b. mesh  — the data axis on a ("data",) mesh of two entries: two
               distinct cards when the process has them, else cuda:0
               twice (the line says which): (a) one scoring pass of
               query 0's trained proxy over the main corpus on the
               executor's shard path (use_kernel=False) against the
               single-device plain pass (rtol = atol = 1e-6; devices,
               paths, the max abs difference and whether bitwise
               logged), then use_kernel=True on the same mesh (paths
               ("fused",), devices 1, a fused launch a tile); (b) one
               query() of ScaleDocEngine(mesh=, use_kernel=False)
               against the single-device engine: equal oracle calls,
               every differing decision's score within 1e-6 of l or r
               (their count logged); (c), inside phases 13 and 15, the
               first 256 documents of the offline corpus through
               build_index on the mesh by EmbeddingService(mesh=) over
               the llama3-8b and then the rwkv6-7b weights (nothing
               drawn, the digest already taken): per-row cosine >=
               COS_MIN against the single-device store's rows (bitwise
               logged), IngestStats.devices 2, flash (WKV6) launched
               once a layer a shard a batch; after phase 16 both
               kernels' times at a shard's batch of 4 (the
               flash_attention_mesh and wkv6_intra_chunk_mesh entries);
 13. offline — the offline path: ScaleDocEngine.from_corpus with an
               EmbeddingService over llama3-8b at full width (32 layers,
               bf16, weights drawn on the card from a seed) into a store of
               2,048 documents of 512 tokens: 2048 finite rows of width
               4096, flash launched 32 times per batch, the kernel path's
               pooled embeddings against the plain einsum path's (per-row
               cosine >= COS_MIN), a killed-and-resumed ingest bit-identical
               to an uninterrupted one, and one query() over the store;
               then, on the same weights, engine and corpus:
               [judge] llama3-8b as the cascade's oracle (LMOracle, a
               16-token query from a seeded generator, the seed stepped
               through JUDGE_SEEDS until the judge's selectivity is not
               degenerate): the judge over every document (the paper's
               baseline: wall time, prompts and tokens a second), then
               query() with the judge as its oracle (calls split into
               train, calibration and online, data reduction, wall time
               and the judge's share, F1 against the baseline's labels,
               not gated: random weights); gates: calls <= N, every label
               the cascade bought and the mask over the band bitwise the
               baseline's, flash, fused and contrastive launched, and the
               kernel path's last-position logits against the einsum
               path's on 256 prompts (per-row cosine >= COS_MIN,
               decisions agreeing >= JUDGE_AGREE_MIN);
               [decode] generate() of 32 tokens for 8 of the corpus's
               prompts, greedy, with prefill_last_only, bitwise a
               hand-rolled prefill + decode_step loop (prefill ms, decode
               ms a step, tokens a second, peak memory, flash launched
               once a layer in the prefill), and at 2 layers in f32,
               full width, decode against the teacher-forced forward
               within DECODE_REL;
 14. flash   — the bf16 flash kernel (and the same call non-causal), the
               FP32 kernel on the same inputs in f32, the plain version
               and PyTorch's scaled_dot_product_attention under each
               backend that takes the call (a yardstick the port never
               calls) at the offline path's shape, and the kernel's share
               of one embedding batch;
 15. rwkv    — the llama3-8b weights freed, the same offline path over
               rwkv6-7b at full width (32 layers, bf16, weights drawn on
               the card) and the same corpus: 2048 finite rows of width
               4096, the WKV6 kernel launched 32 times per batch, the
               kernel path's pooled embeddings against the plain direct
               scan's (per-row cosine >= RWKV_COS_MIN), the kill/resume
               drill, one query() over the store and [decode] as for
               llama3-8b (the WKV6 kernel in the prefill, the recurrent
               state in the steps); then the 32 blocks
               run by hand on one batch: each layer's recurrence through
               the kernel and the direct scan on the kernel path's inputs
               (relative error and f32 ulp distance; time-mix outputs at
               a per-row cosine >= LAYER_COS_MIN), and how three other
               exact evaluations (the direct scan, the kernel with each
               output one f32 ulp up, the kernel at chunk 64) drift from
               the kernel path with depth (the direct scan's after
               RWKV_DEPTH layers >= RWKV_DEPTH_COS_MIN);
 16. wkv6    — the WKV6 kernel, its plain version and the plain
               pairwise form at the rwkv6-7b path's shape, its bound
               (exponentials in the sub-chunk form, FP32 operations and
               bytes), and its share of one embedding batch;
 17. gemma3  — the rwkv6-7b weights freed, the offline path over
               gemma3-12b at full width and a quarter of its depth
               (GEMMA_DEPTH: 12 of its 48 layers, five of window 1024 a
               global one, head_dim 240, bf16, ~6.2 GB of weights drawn
               on the card) into a store of 512 documents of 2048 tokens
               (longer than the window), batch 4: 512 finite rows of
               width 3840, flash launched 12 times a batch, 10 of those
               calls with the window, the kernel path's pooled embeddings
               against attn_impl="blocked" (per-row cosine >= COS_MIN),
               the kill/resume drill, one query() over the store (the
               fused kernel at D=3840); then [decode] as above on 4
               prompts of 2048 tokens (local caches of 1024 slots, global
               ones of 2080) and one pattern period (6 layers) in f32 at
               full width over 1,100 tokens of context;
 18. flash   — the bf16 flash kernel at gemma3-12b's shape, global and
               with its window, as in 14, beside its bound, the FP32
               kernel, the plain version and SDPA;
 19. configs — codeqwen1.5-7b (MHA, an untied head) and internvl2-1b (14
               heads over 2, a vocab that is not a multiple of the
               padding, float patch embeddings) at full width with random
               bf16 weights: one batch of 8 x 512 tokens against the
               blocked path (per-row cosine >= COS_MIN, flash once a
               layer), internvl2-1b's hidden over (8, 256, 896) patch
               embeddings, generate() of 8 tokens bitwise a hand-rolled
               loop, ms a batch and peak memory;
 20. moe     — every earlier model's weights freed (the memory still
               held logged), the offline path over qwen3-moe-30b-a3b at
               full width and a quarter of its depth (MOE_DEPTH: 12 of
               its 48 layers, 128 experts top 8, d_ff 768, ~15.3 GB of
               bf16 weights drawn on the card, the router in f32)
               into a store of 256 documents of 512 tokens, batch 8: 4,096
               tokens a batch in four dispatch chunks of 1,024 with 80
               slots an expert, so pairs are dropped (gate: > 0 in batch
               0); 256 finite rows of width 2048, flash 12 times a batch,
               the per-row cosine against attn_impl="blocked" (>= COS_MIN;
               the (token, layer, k) pairs routed to another expert than
               on the blocked path logged first), the kill/resume drill,
               one query() over the store (the fused kernel at D=2048);
               [decode] as above (the f32 check at capacity factor E / K,
               its forward dropping nothing); then layer
               1's real MoE input on batch 0 through moe_apply with the
               onehot and the sort dispatch (the same drop sets, read off
               each one's own tables; max abs difference);
 21. flash   — the bf16 flash kernel at qwen3-moe-30b-a3b's shape (b=8,
               s=512, 32 heads over 4 KV heads, hd 128), as in 14; the
               fused scoring kernel on the [moe] query's tile (256 x 2048)
               against its plain version, with its bound;
 22. zamba2  — the qwen3-moe-30b-a3b weights freed (the memory still
               held logged), the offline path over zamba2-2.7b at full
               width (54 layers: 45 Mamba2 SSD layers and 9 applications
               of one shared attention block, head_dim 80; 3.96 GB of
               bf16 weights drawn on the card, the SSD's decay, skip and
               dt bias in f32; the drawn count, bytes and param_count()
               logged) into a store of 256 documents of 2048 tokens,
               batch 4 (16 SSD chunks of 128 a document): 256 finite rows
               of width 2560, flash 9 times a batch (the shared layers),
               the per-row cosine against attn_impl="blocked" (>=
               COS_MIN), the kill/resume drill (64, 32), one query() over
               the store (the fused kernel at D=2560); [decode] as above,
               its f32 check over one pattern period (5 mamba2 layers, 1
               shared) after 300 tokens to 316 (SSD chunks of 100 and
               79); then the bf16 flash kernel at its shape (b=4,
               s=2048, 32 heads over 32, hd 80) as in 14, beside the same
               call at hd 128 (what the hd-128 instantiation's padding
               costs), and fused scoring on the query's tile (256 x
               2560), with their bounds;
 23. whisper — the zamba2-2.7b weights freed (the memory still held
               logged), whisper-base at full width (6 encoder and 6
               decoder layers, d 512, 8 heads of 64, vocab 51,865; bf16
               weights drawn on the card; the drawn count, bytes and
               param_count() logged) over 32 clips of 1500 frames (the
               stubbed conv stem's output, N(0, 1)) and 448 decoder
               tokens each: the teacher-forced forward through the
               kernel (flash 18 times: 6 encoder, 6 self, 6 cross) and
               on attn_impl="blocked" (6: the cross-attention, as the
               JAX package routes it), the per-(clip, position) cosine
               of the logits over the real vocabulary (>= COS_MIN),
               finite, padded ids at -1e30, each encoder layer's
               attention on the kernel path's input and the drift of the
               encoder's state with depth, logged; encode, forward,
               prefill of a 4-token prompt and 32 greedy decode steps
               after the self cache is padded by hand to 448 (ms, peak
               memory, tokens/s); f32 decode against the forward at full
               depth (2 clips, 8 steps after a 4-token prompt, <=
               DECODE_REL); then the bf16 flash kernel at its three
               shapes (encoder 1500 x 1500 and cross-attention 448 x
               1500, non-causal; self-attention 448, causal) as in 14,
               with their bounds and their shares of a forward;
 24. train   — the whisper-base weights freed, the port's Trainer on
               smollm-360m at full width (32 layers, d 960, 15 heads
               over 5 of 64, vocab 49,152; bf16, remat "full") at 8
               sequences of 4,096 tokens (TRAIN_4K's batch of 256 cut
               to 8) for 8 steps, async checkpoints every 4 under
               build/, a WorkerFailure injected at step 6: one restart,
               the latest checkpoint at step 8, the replayed steps 4
               and 5 bitwise the first pass's losses, step 7's loss
               below step 0's, flash 64 times a step (32 forward, 32 by
               the remat) and no other kernel, the plain attention
               never called; ms a step (steps 1-7), tokens/s, peak
               memory, the checkpoint's host copy and write, the params
               digest of the step-8 checkpoint; one loss_fn gradient of
               a 2-layer model of its widths over (2, 2048) on the
               kernel path against attn_impl="blocked" (f32: each leaf
               within TRAIN_GRAD_REL of its max |g|; bf16: cosine >=
               TRAIN_GRAD_COS); the kernel's LSE form at the training
               shape (b=8, s=4096, 15 heads over 5, hd 64, causal) in
               bf16 and f32: out bitwise the form without it, lse
               against the plain version's (LSE_TOL); then its time,
               the form without it, the plain forward and backward and
               SDPA at that shape as in 14, with the bound and the
               shares of a step;
 24b. model_axis — two SPMD ranks (launch.dist.init_spmd; each a
               subprocess, `chip_smoke.py --model-axis-rank R JOB`) on a
               (1, 2) mesh (launch.mesh.make_test_mesh): cuda:0 twice
               over the port's repro_gloo backend, or cuda:0 and cuda:1
               over NCCL where there are two cards. (a) smollm-360m FULL
               (attention replicated: 15 and 5 heads do not split 2; the
               MLP and the vocabulary sharded; the ruleset's fallbacks
               logged), 3 Trainer steps at 2 x 4,096 (the batch cut from
               [train]'s 8: two ranks share one card), against the same
               steps of the single-device Trainer: each loss within
               AXIS_LOSS_REL, the ranks' losses equal, the step-3 params
               per leaf cosine >= AXIS_PARAM_COS; ms a step, the
               collectives' share (repro_gloo's host seconds; over NCCL,
               one more step under torch.profiler: NCCL's kernels'
               device time), peak memory a rank;
               (b) llama3-8b at full width on 2 layers, one step at
               1 x 2,048 against one device, flash's LSE form launched
               on 16 query heads and 4 KV heads a rank; (c) (a)'s step-3
               checkpoint (rank 0's async write of the gathered state,
               signature "data=1xmodel=2") restored onto a one-device
               mesh, each leaf bitwise the ranks' gathered live state;
               then the LSE form at a rank's share of (b)'s call
               (1, 2048, 16, 4, 128) against its plain version with
               [train]'s bars, its time, bound and SDPA's (a
               flash_attention_model_axis kernels entry);
 24c. decode_axis — [model_axis]'s two ranks through the prefill and
               decode plans and generate (launch.steps, the dense
               family), each against one device: (a) llama3-8b at full
               width on DAX_LLAMA_LAYERS layers, PREFILL_32K at batch 1
               (last_logit; flash on 16 query heads over 4 KV heads a
               rank), then the model's prefill of 32,767 tokens into
               32,768 slots and DECODE_32K's step (a head-sharded
               cache); (b) smollm-360m FULL, a 20,480-token prompt in
               32,768 slots, 16 decode plan steps (the cache's sequence
               over "model", the softmax combined across the ranks;
               every step's cache Shard(1) a layer, each rank half the
               one device's bytes) and generate on the mesh; logits
               cosine >= LAUNCH_DECODE_COS, top-1 among one device's
               ties; then flash at a rank's share of (a)'s call
               (1, 32768, 16, 4, 128) against its plain version, its
               time, bound and SDPA's (a flash_attention_decode_axis
               kernels entry);
 24d. moe_axis — [model_axis]'s two ranks on qwen3-moe-30b-a3b at full
               width (its experts over "model": 64 of 128 a rank,
               models.moe.moe_apply_mesh), each against one device: (a)
               MOE_AXIS_TRAIN_LAYERS layers, the Trainer for
               MOE_AXIS_TRAIN_STEPS steps at 1 x 4,096 (four dispatch
               chunks a layer): losses within MOE_AXIS_LOSS_REL, ms a
               step, the collectives' calls and seconds, peak memory a
               rank; (b) MOE_AXIS_SERVE_LAYERS layers: the prefill plan
               at PREFILL_32K, batch 1 (32 chunks a layer), the model's
               prefill into 32,768 slots and MOE_AXIS_DECODE_STEPS
               DECODE_32K plan steps, and a MOE_AXIS_GEN_TOKENS-token
               generate: logits cosine >= LAUNCH_DECODE_COS, top-1 among
               one device's ties, generate equal up to a near-tie; the
               routing of step 0 of (a) and of (b)'s prefill and steps
               against one device's, pair by pair: at the first MoE layer
               a pair differs only where one device's K-th and (K+1)-th
               log-probabilities lie within MOE_AXIS_TIE, or its
               expert's buffer was displaced by such a tie, and every
               chunk's kept flags are the capacity rule on the mesh's own
               experts; (c) layer 1's real MoE input (a batch of 8
               x 512 through the one-device model) through the mesh form
               with each dispatch: kept pairs bitwise one device's, y's
               cosine >= MOE_AXIS_LAYER_COS; then flash at a rank's share
               of (b)'s prefill (1, 32768, 16, 2, 128) against its plain
               version, its time, bound and SDPA's (a
               flash_attention_moe_axis kernels entry);
 24e. rwkv_axis — [model_axis]'s two ranks on rwkv6-7b at full width
               (its 64 heads split over "model": 32 a rank, the
               recurrence on a rank's heads, kernels.wkv6.ops.RankHeads),
               each against one device: (a) RWKV_AXIS_TRAIN_LAYERS
               layers, the Trainer ("direct" mode) for
               RWKV_AXIS_TRAIN_STEPS steps at 1 x 4,096: losses within
               RWKV_AXIS_LOSS_REL, the last step's params per-leaf cosine
               >= AXIS_PARAM_COS, ms a step, the collectives' calls and
               seconds, peak memory a rank; (b) RWKV_AXIS_SERVE_LAYERS
               layers through the factored plans: the prefill plan at
               PREFILL_32K, batch 1, RWKV_AXIS_DECODE_STEPS DECODE_32K
               plan steps from its state (each step's state in the plan's
               layout: the WKV state's heads replicated over "model"),
               and a RWKV_AXIS_GEN_TOKENS-token generate: logits cosine
               >= LAUNCH_DECODE_COS, top-1 among one device's ties,
               generate equal up to a near-tie; (c) the same layers in
               the kernel mode (build_model(cfg)): the prefill at
               PREFILL_32K (RWKV_AXIS_SERVE_LAYERS WKV6 launches a rank)
               and a generate, layer 1's time-mix in float32 on its real
               input (cosine >= LAYER_COS_MIN against one device) and
               the kernel's output on a rank's 32 heads bitwise one
               device's rows; then the kernel at a rank's share of (c)'s
               prefill (1, 256, 128, 32, 64) against its plain version,
               its time and bound (a wkv6_intra_chunk_rwkv_axis kernels
               entry);
 25. launch  — the launch layer's cell plans (launch.steps.make_plan on
               launch.mesh.make_test_mesh(1, 1)) on the card: the flash
               kernel at (1, 32768, 32, 8, 128) causal, three 64-row
               query blocks against its plain version on its tiles and
               every row against the timed plain pass (512-row blocks),
               at LONG_FLASH_TOL, its time, the plain version's and cuDNN
               SDPA's (a flash_attention_hd128_32k kernels entry);
               llama3-8b FULL
               through its PREFILL_32K plan at batch 1 (last_logit; 32
               flash launches) and its DECODE_32K plan at batch 1 after a
               prefill of 32,767 tokens into a 32,768-slot cache (the
               cache as the plan's spec; the step's logits against the
               prefill's last ones: cosine, its top-1 token one of the
               prefill's; no kernel launched; timed 5 times); rwkv6-7b
               FULL through its PREFILL_32K plan at batch 1 (factored
               WKV6: no kernel launched, the clamped log-decays counted
               on the card) against rwkv_mode="kernel" (32 WKV6
               launches), last logits' cosine; the first RWKV_DEPTH
               blocks by hand on the same tokens, each layer's time-mix
               in f32 through the factored recurrence against the
               kernel's (per-row cosine >= LAYER_COS_MIN) and the
               factored path's pooled drift after RWKV_DEPTH layers (>=
               RWKV_DEPTH_COS_MIN); smollm-360m FULL train-plan steps at 8 x
               4,096 with default_microbatches (2) and with 1 from one
               state and batch (loss, per-leaf update cosine, flash 128
               and 64 launches, ms and peak memory); launch.serve.main
               at smollm-360m's full width over 64 documents; then (g),
               the dry run held against the card: the llama3-8b prefill
               step and both smollm-360m train steps counted by
               launch.hlo_analysis on the plans' meta arguments and on
               the card (operators, FLOPs, bytes, transcendentals equal),
               their roofline time (launch.roofline's H100 constants) at
               or below the measured step, and arguments plus the meta
               peak within DRYRUN_MEM_REL of max_memory_allocated.

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
# [judge]: llama3-8b as the cascade's oracle over the offline corpus and
# store. A query of JUDGE_QUERY_LEN tokens drawn from a seeded generator
# (ids from 3, clear of the pad 0 and the yes/no ids 1 and 2); the seeds
# are tried in turn until the judge's selectivity over all documents is
# not degenerate (at least JUDGE_MIN_CLASS in each class)
JUDGE_QUERY_LEN = 16
JUDGE_SEEDS = (0, 1, 2, 3)
JUDGE_MIN_CLASS = 0.01
JUDGE_PLAIN_DOCS = 256     # prompts of the kernel-vs-plain comparison
JUDGE_AGREE_MIN = 0.98     # decisions of the kernel path = the plain path's
# [decode]: generate on one batch of offline documents (the embedding
# service's batch size) for DECODE_STEPS tokens, greedy; then decode
# against forward at
# 2 layers in f32 (4 steps after a 12-token prefill) to the JAX
# package's own bar (tests/test_models_consistency.py), of max |logit|
DECODE_STEPS = 32
DECODE_PRE, DECODE_TOTAL = 12, 16
DECODE_REL = 5e-4
# [gemma3]: gemma3-12b at full width (48 layers cut to GEMMA_DEPTH, 5 of
# window 1024 a global one, head_dim 240) over documents longer than its
# window, or its local
# layers would see every key as global ones do: 512 documents of 2048
# tokens (the llama3-8b phase's 1,048,576 tokens), batch 4; a shorter
# kill/resume drill (64 documents, killed after 32: one commit group of 8
# batches); [decode] then generates on one batch. Decode against forward
# runs one whole pattern period (5 local layers, 1 global) in f32 over a
# context past the window
GEMMA_ARCH = "gemma3-12b"
GEMMA_DOCS, GEMMA_DOC_LEN, GEMMA_BATCH = 512, 2048, 4
# depth cut from 48 to 12 layers (two whole pattern periods; width,
# window and heads kept): the weight draw, the params digest (71.5 s at
# full depth) and the corpus pass shrink with it, so the run keeps a
# margin inside its time limit beside [decode_axis]
GEMMA_DEPTH = 12
GEMMA_RESUME = (64, 32)
GEMMA_PERIOD_PRE, GEMMA_PERIOD_TOTAL = 1100, 1104
GEMMA_FLASH_SHAPE = (4, 2048, 16, 8, 240)   # b, s, heads, KV heads, hd
# [configs]: the other two configs at FULL with random bf16 weights, one
# embedding batch of CONFIGS_BATCH documents of OFF_DOC_LEN tokens each
# (internvl2-1b also over float patch embeddings of CONFIGS_PATCHES
# positions: its stubbed vision frontend), and generate of
# CONFIGS_STEPS tokens
CONFIGS_ARCHS = ("codeqwen1.5-7b", "internvl2-1b")
CONFIGS_BATCH, CONFIGS_PATCHES, CONFIGS_STEPS = 8, 256, 8
# [moe]: qwen3-moe-30b-a3b at full width (48 layers cut to MOE_DEPTH, d
# 2048, 32 heads over 4, 128 experts top 8 of d_ff 768; 61.06 GB bf16 at
# full depth) over MOE_DOCS documents of
# OFF_DOC_LEN tokens, batch 8: 4,096 tokens a batch, four dispatch chunks
# of 1,024 with 80 slots an expert each, so capacity drops happen. The
# kill/resume drill is llama3-8b's (128 documents, killed after 64, one
# commit group of 8 batches). Decode against forward needs a forward
# that drops nothing (a forward chunk and a decode chunk drop
# differently): the JAX test sets capacity factor 8.0 for that, which at
# full width left the random router's crowded experts dropping pairs, so
# the check runs at capacity factor E / K, where an expert's capacity is
# the chunk's token count and no pair can be dropped; the gate that the
# forward dropped nothing stays
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_DOCS, MOE_BATCH = 256, 8
# depth cut from 48 to 12 layers (width, experts and routing kept): the
# weight draw and the params digest, 157.5 s of the phase at full depth,
# shrink with it, so the run stays inside its time limit beside
# [launch]'s (g) and [decode_axis]
MOE_DEPTH = 12
MOE_FLASH_SHAPE = (8, 512, 32, 4, 128)   # b, s, heads, KV heads, hd
# onehot against sort on one layer's input in bf16: the same drops, sums
# rounded at other places (of max |y|; flash's bf16 bar)
MOE_DISPATCH_REL = 3e-2
# [zamba2]: zamba2-2.7b FULL (54 layers: 45 Mamba2 SSD layers and 9
# applications of one shared attention block, head_dim 80; 3.96 GB
# bf16) over ZAMBA_DOCS documents of GEMMA_DOC_LEN tokens, batch 4: 16
# SSD chunks of 128 a document, so the state is carried between chunks.
# The kill/resume drill is gemma3-12b's (64 documents, killed after 32:
# one commit group of 8 batches). Decode against forward runs one whole
# pattern period (5 mamba2 layers, 1 shared) in f32 after
# ZAMBA_PERIOD_PRE tokens, to ZAMBA_PERIOD_TOTAL: neither a multiple of
# the chunk of 128, so the adaptive chunk runs (100 in the prefill, 79
# in the forward)
ZAMBA_ARCH = "zamba2-2.7b"
ZAMBA_DOCS, ZAMBA_BATCH = 256, 4
ZAMBA_PERIOD_PRE, ZAMBA_PERIOD_TOTAL = 300, 316
ZAMBA_FLASH_SHAPE = (4, 2048, 32, 32, 80)   # b, s, heads, KV heads, hd
# [whisper]: whisper-base FULL (6 encoder and 6 decoder layers, d 512, 8
# heads of 64, vocab 51,865 padded to 51,968; 0.166 GB bf16) over one
# batch of WHISPER_CLIPS clips: WHISPER_FRAMES frames each (a 30-s window
# after Whisper's stride-2 conv stem, which is stubbed) and
# WHISPER_TOKENS decoder tokens (Whisper's decoder context); a prompt of
# WHISPER_PROMPT tokens (the start-of-transcript prefix) for prefill and
# decode. The f32 decode check runs at full depth on WHISPER_F32_CLIPS
# clips for WHISPER_F32_STEPS steps
WHISPER_ARCH = "whisper-base"
WHISPER_CLIPS, WHISPER_FRAMES, WHISPER_TOKENS = 32, 1500, 448
WHISPER_PROMPT = 4
WHISPER_F32_CLIPS, WHISPER_F32_STEPS = 2, 8
_wb, _wf, _wt = WHISPER_CLIPS, WHISPER_FRAMES, WHISPER_TOKENS
# [train]: smollm-360m FULL (32 layers, d 960, 15 heads over 5 of 64,
# vocab 49,152, tied; bf16, remat "full") trained by the port's Trainer
# at TRAIN_4K's sequence of 4,096 with its global batch of 256 cut to
# TRAIN_BATCH (the f32 logits alone would be 206 GB at 256), for
# TRAIN_STEPS steps, checkpoints every TRAIN_CKPT_EVERY (async, under
# build/), one WorkerFailure injected at TRAIN_FAIL_AT; then one loss_fn
# gradient of a TRAIN_GRAD_LAYERS-layer model of FULL's widths over
# TRAIN_GRAD_SHAPE (b, s), kernel path against attn_impl="blocked": f32
# (the FP32 kernel) each leaf within TRAIN_GRAD_REL of its max |g|, bf16
# (the tensor-core kernel) each leaf's cosine >= TRAIN_GRAD_COS
TRAIN_ARCH = "smollm-360m"
TRAIN_SEQ, TRAIN_BATCH = 4096, 8
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8, 4, 6
TRAIN_GRAD_LAYERS, TRAIN_GRAD_SHAPE = 2, (2, 2048)
TRAIN_GRAD_REL, TRAIN_GRAD_COS = 1e-4, 0.999
# after the run, the step-0 batch's loss under the final params must lie
# at least this far below its loss under init_state()'s (both taken
# without a gradient, so no batch-to-batch noise enters): a quarter of
# the 0.016 fall from step 0 to step 7 of the first chip runs; params
# that the optimizer left unchanged give a fall of exactly 0
TRAIN_FALL_MIN = 0.004
TRAIN_FLASH_SHAPE = (8, 4096, 15, 5, 64)   # b, s, heads, KV heads, hd
# the kernel's LSE against the plain version's (tests/test_torch_cuda.py)
LSE_TOL = dict(rtol=1e-5, atol=1e-4)
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
# the [model_axis] phase: two SPMD ranks (launch.dist.init_spmd) on a
# (1, 2) mesh (launch.mesh.make_test_mesh): cuda:0 twice over the port's
# repro_gloo backend (NCCL refuses two ranks on one card), or two cards
# over NCCL. (a) smollm-360m FULL, AXIS_STEPS Trainer steps at
# AXIS_BATCH x TRAIN_SEQ (the batch cut from [train]'s 8 to 2: the two
# ranks share one card's 80 GB), against the same steps of the
# single-device Trainer: each loss within AXIS_LOSS_REL["a"], the step-3
# params per leaf cosine >= AXIS_PARAM_COS; the ruleset's fallbacks
# logged (15 and 5 heads do not split 2: attention replicated; the MLP
# and the vocabulary sharded). (b) llama3-8b at full width cut to
# AXIS_LLAMA_LAYERS layers, one step at AXIS_LLAMA_SHAPE (b, s) against
# one device (AXIS_LOSS_REL["b"]): flash's LSE form on 16 query heads and 4
# KV heads a rank. (c) (a)'s last checkpoint (written by rank 0 from the
# async thread) restored onto a one-device mesh: each leaf bitwise the
# ranks' gathered live state.
AXIS_MESH = (1, 2)
AXIS_STEPS, AXIS_BATCH = 3, 2
AXIS_LLAMA_LAYERS, AXIS_LLAMA_SHAPE = 2, (1, 2048)
# each step's loss against one device: 4x the |rel| first measured on
# one H100 ((a) 1.033e-05, (b) 3.164e-05), inside the 1e-3 asked for
AXIS_LOSS_REL = {"a": 4e-5, "b": 1.2e-4}
AXIS_PARAM_COS = 0.999
AXIS_FLASH_SHAPE = (1, 2048, 16, 4, 128)   # (b)'s flash call on a rank
AXIS_DIR = ROOT / "build" / "chip_smoke_model_axis"
AXIS_RANK_TIMEOUT = 900
# the [decode_axis] phase: the prefill and decode plans and generate on a
# (1, 2) mesh of two SPMD ranks ([model_axis]'s launcher: cuda:0 twice
# over repro_gloo, or two cards over NCCL), each against the same plans
# on one device with the same params (placed by each plan once, before
# its timed calls). (a) llama3-8b at full width cut to
# DAX_LLAMA_LAYERS of its 32 layers: the prefill plan at PREFILL_32K cut
# to batch 1 with last_logit (flash on 16 query heads over 4 KV heads a
# rank, at LAUNCH_SEQ keys), then the model's prefill of LAUNCH_SEQ - 1
# tokens into a LAUNCH_SEQ-slot cache (as generate fills its cache) and
# DECODE_32K's step at batch 1 (8 KV
# heads split the model axis: a head-sharded cache), each logits'
# cosine >= LAUNCH_DECODE_COS against one device and its top-1 one of
# the one device's tied top tokens. (b) smollm-360m FULL (15 heads over
# 5, which do not split 2: the decode cache's sequence over "model"): a
# prompt of DAX_PROMPT tokens into a LAUNCH_SEQ-slot cache (the model's
# prefill, as generate's), then
# DAX_STEPS decode plan steps fed the one-device generate's tokens
# (logits as in (a); every step's cache Shard(1) a layer on both ranks,
# each rank's local cache half the one device's bytes; each layer's
# gathered cache against one device's, cosine >= DAX_CACHE_COS), then
# generate on the mesh, its tokens beside one device's: equal up to the
# first step whose one-device top-2 gap is under DAX_TIE_REL of its
# top logit. The flash call of (a) is timed alone (DAX_FLASH_SHAPE)
DAX_LLAMA_LAYERS = 4
DAX_PROMPT, DAX_STEPS = 20480, 16
DAX_DECODE_REPS = 5
# each layer's gathered cache against one device: 4x the drift first
# measured on one H100 (1 - 0.9998848: bf16 partial sums of the prefill
# taken in another order)
DAX_CACHE_COS = 1 - 4 * 1.152e-4
DAX_TIE_REL = 2.0 ** -6      # two bf16 ulps of the top logit
DAX_FLASH_SHAPE = (1, 32768, 16, 4, 128)   # (a)'s flash call on a rank
DAX_DIR = ROOT / "build" / "chip_smoke_decode_axis"
# the [moe_axis] phase: qwen3-moe-30b-a3b at full width on [model_axis]'s
# (1, 2) mesh of two SPMD ranks (its 128 experts over "model", 64 a
# rank; 32 heads over 4 KV heads: 16 over 2 a rank), each part against
# one device with the same params. (a) MOE_AXIS_TRAIN_LAYERS of its 48
# layers, the Trainer for MOE_AXIS_TRAIN_STEPS steps at
# MOE_AXIS_TRAIN_SHAPE (b, s): 4,096 tokens, four dispatch chunks of
# 1,024 a layer; each loss within MOE_AXIS_LOSS_REL of one device's.
# (b) MOE_AXIS_SERVE_LAYERS layers: the prefill plan at PREFILL_32K cut to
# batch 1 (32 chunks a layer), then the model's prefill of LAUNCH_SEQ -
# 1,024 tokens (whole dispatch chunks) into LAUNCH_SEQ slots and
# MOE_AXIS_DECODE_STEPS DECODE_32K plan steps teacher-forced on the same
# draw, then generate of
# MOE_AXIS_GEN_TOKENS tokens from its first MOE_AXIS_GEN_PROMPT; logits
# as [decode_axis]'s (cosine >= LAUNCH_DECODE_COS, top-1 among one
# device's ties), generate equal up to the first one-device top-2 gap
# under DAX_TIE_REL. The routing of (a)'s step 0 (the same params) and of
# (b)'s prefill and decode steps against one device's, chunk by chunk
# (MoERoutes, route_faults): at the first MoE layer, whose input differs
# from one device's only by the bf16 partial sums of the attention's
# output, a token's expert set may differ only where one device's K-th
# and (K+1)-th log-probabilities are within MOE_AXIS_TIE, and a kept
# flag only where the pair's expert is one such a tie moved in that
# chunk; in every chunk of every layer the mesh's kept flags must be the
# capacity rule on its own experts. A deeper layer's input moves with
# the pairs a tie displaced upstream (a dropped pair takes its expert's
# share out of a token's output), so its differences are logged, not
# gated. (c) layer 1's MoE input on a batch of MOE_AXIS_LAYER_BATCH
# (captured from the one-device model, as [moe]'s moe_layer does) through
# the mesh form with each dispatch: kept pairs bitwise one device's (x is
# the same bits on every rank, so the router is), y's cosine >=
# MOE_AXIS_LAYER_COS.
MOE_AXIS_TRAIN_LAYERS, MOE_AXIS_TRAIN_STEPS = 2, 3
MOE_AXIS_TRAIN_SHAPE = (1, 4096)
MOE_AXIS_SERVE_LAYERS = 4
MOE_AXIS_DECODE_STEPS = 8
MOE_AXIS_GEN_PROMPT, MOE_AXIS_GEN_TOKENS = 2048, 9
MOE_AXIS_LAYER_BATCH = (8, 512)
MOE_AXIS_DISPATCH = "onehot"       # (a) and (b); (c) runs both
# each loss against one device: 4x the |rel| first measured on one H100
# (1.558e-04: the routing's near-ties drop other pairs on the mesh)
MOE_AXIS_LOSS_REL = 4 * 1.558e-4
# a near-tie of the first MoE layer: one device's K-th and (K+1)-th
# log-probabilities closer than 4x the largest shift of a top log-
# probability first measured there on one H100 (0.01126: the router's f32
# logits move with the attention's bf16 partial sums)
MOE_AXIS_TIE = 4 * 0.01126
MOE_AXIS_LAYER_COS = 0.9999
MOE_AXIS_FLASH_SHAPE = (1, 32768, 16, 2, 128)   # (b)'s flash call a rank
MOE_AXIS_DIR = ROOT / "build" / "chip_smoke_moe_axis"
# the [rwkv_axis] phase: rwkv6-7b at full width on [model_axis]'s two
# ranks (32 of its 64 heads a rank), each part against one device with
# the same params. (a) RWKV_AXIS_TRAIN_LAYERS of its 32 layers, the
# Trainer ("direct" mode: the kernel has no backward) for
# RWKV_AXIS_TRAIN_STEPS steps at RWKV_AXIS_TRAIN_SHAPE (b, s); each loss
# within RWKV_AXIS_LOSS_REL of one device's, the last step's params
# per-leaf cosine >= AXIS_PARAM_COS. (b) RWKV_AXIS_SERVE_LAYERS layers
# through the factored plans: PREFILL_32K cut to batch 1,
# RWKV_AXIS_DECODE_STEPS DECODE_32K steps from its state, and
# RWKV_AXIS_GEN_TOKENS tokens of generate from the first
# RWKV_AXIS_GEN_PROMPT prompt tokens. (c) the same layers and tokens in
# the kernel mode: the prefill, a generate, and layer 1's time-mix in
# float32 on its real input against one device (LAYER_COS_MIN, the
# [rwkv] bar a layer: depth amplifies last bits).
RWKV_AXIS_TRAIN_LAYERS, RWKV_AXIS_TRAIN_STEPS = 2, 3
RWKV_AXIS_TRAIN_SHAPE = (1, 4096)
RWKV_AXIS_SERVE_LAYERS = 4
RWKV_AXIS_DECODE_STEPS = 8
RWKV_AXIS_GEN_PROMPT, RWKV_AXIS_GEN_TOKENS = 2048, 9
# 4x the first measured drift of (a)'s losses, as MOE_AXIS_LOSS_REL
RWKV_AXIS_LOSS_REL = 4 * 8.320e-05
RWKV_AXIS_DIR = ROOT / "build" / "chip_smoke_rwkv_axis"
# the [launch] phase: the launch layer's cell plans (launch.steps.make_plan
# over launch.mesh.make_test_mesh(1, 1)) at their cells' widths on one
# card. llama3-8b FULL at PREFILL_32K (a) and DECODE_32K (b), each global
# batch cut to 1 (at 32 the prefill's KV cache alone is 137 GB); the
# decode step's logits against the prefill's last ones, cosine >=
# LAUNCH_DECODE_COS and its top-1 token one of the prefill's (the
# logits are bf16 products, so tokens may tie at the max; argmax takes
# the first of them); the decode step timed
# LAUNCH_DECODE_REPS times from the same inputs. (c) the flash kernel at
# the prefill's call, LONG_FLASH_SHAPE. (d) smollm-360m FULL at TRAIN_4K
# cut to TRAIN_BATCH, default_microbatches (2) against 1 from one state
# and batch: loss within LAUNCH_LOSS_REL, each leaf's update (new - old
# params) cosine >= LAUNCH_UPDATE_COS. (e) rwkv6-7b FULL at PREFILL_32K
# cut to batch 1 through the prefill plan (factored WKV6, no kernel)
# against rwkv_mode="kernel" (the WKV6 kernel): last logits' cosine >=
# RWKV_COS_MIN, as the pooled rwkv6-7b gate, and the first RWKV_DEPTH
# layers held as [rwkv] holds the kernel against the direct scan: each
# time-mix (in f32 here) at LAYER_COS_MIN, the pooled drift at
# RWKV_DEPTH_COS_MIN. (f) the serving CLI at smollm-360m's full width
LAUNCH_ARCH, LAUNCH_RWKV_ARCH, LAUNCH_SEQ = "llama3-8b", "rwkv6-7b", 32768
LAUNCH_DECODE_REPS = 5
LAUNCH_DECODE_COS = 0.999
LAUNCH_LOSS_REL = 1e-4
LAUNCH_UPDATE_COS = 0.99
LAUNCH_OPT = dict(lr=1e-3, warmup_steps=0, schedule="constant")
LONG_FLASH_SHAPE = (1, 32768, 32, 8, 128)   # b, s, heads, KV heads, hd
# At 32,768 keys an output element is ~N(0, e / keys), ~0.01 at the far
# rows, so FLASH_BF16_PLAIN_TOL's atol would be one typical value. The
# long row keeps its rtol (one bf16 ulp) and takes as atol this share of
# each query position's max |want| over its heads and dims: ~0.03 of a
# typical value there, several bf16 ulps, while a dropped or misweighted
# K/V tile moves an output by a sizeable share of it
LONG_FLASH_TOL = dict(rtol=FLASH_BF16_PLAIN_TOL, row_atol=8e-3)
LAUNCH_SERVE_ARGS = ["--arch", "smollm-360m", "--docs", "64"]
# (g), the dry run on the card: the already-timed steps of (a) and (d)
# counted by the cost counter on the plans' meta arguments and on the
# card. The gates: the two counts equal; the step's roofline time
# max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s) at or below its measured
# time; the arguments plus the meta peak of live bytes within this share
# of torch.cuda.max_memory_allocated over the timed run
DRYRUN_MEM_REL = 0.15
# the compound phase's cross-session CSE arms run on this many of the
# main path's documents, to bound the phase's time
CSE_DOCS = 32_768
TOPK_K = 100
# the degrade phase's outage: the oracle answers the training sample
# (invocation 0) and the calibration sample (1), then fails until healed
DEGRADE_BLACKOUT = 2
DEGRADE_AGREE_MIN = 0.6     # proxy-only decisions against the truth
# [live]: the calibration prefix, the ragged commit groups pumped one by
# one, then [gateway]'s groups of LIVE_TAIL_GROUP rows to the end. The
# store (2.15 GB) goes under build/ beside the offline phase's stores,
# out of git and of chiprun_out/ (whose contents are kept after a run),
# and is deleted at the end of [live]
LIVE_CALIB = 65_536
LIVE_GROUPS = (1, 3, 37, 8191, 8193)
LIVE_TAIL_GROUP = 16_384
LIVE_DIR = ROOT / "build" / "chip_smoke_stores" / "live"
# the [mesh] phase: a 2-entry ("data",) mesh (two cards, or cuda:0 twice)
MESH_ENTRIES = 2
MESH_DOCS = 256            # the sharded ingest's share of the offline corpus
# a sharded pass against the single-device one: the JAX tests' bar
MESH_TOL = dict(rtol=1e-6, atol=1e-6)


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


_b, _s, _h, _kv, _hd = FLASH_SHAPE
_gb, _gs, _gh, _gkv, _ghd = GEMMA_FLASH_SHAPE
# name, (b, sq, skv, h, kv, hd), causal, window, q_offset
_mb, _ms, _mh, _mkv, _mhd = MOE_FLASH_SHAPE
_zb, _zs, _zh, _zkv, _zhd = ZAMBA_FLASH_SHAPE
# the sharded ingest's shape: a shard's rows of one batch
MESH_SHARD_B = OFF_BATCH // MESH_ENTRIES
FLASH_CASES = [
    ("path shape causal", (_b, _s, _s, _h, _kv, _hd), True, 0, 0),
    ("mesh shard causal", (MESH_SHARD_B, _s, _s, _h, _kv, _hd), True, 0, 0),
    ("qwen3 path shape causal GQA 8:1", (_mb, _ms, _ms, _mh, _mkv, _mhd),
     True, 0, 0),
    ("zamba2 path shape causal hd80", (_zb, _zs, _zs, _zh, _zkv, _zhd),
     True, 0, 0),
    ("window=24", (2, 128, 128, 4, 4, 32), True, 24, 0),
    ("q_offset=skv-sq", (1, 32, 96, 2, 2, 16), True, 0, 64),
    ("ragged s=200 GQA 4:1", (2, 200, 200, 8, 2, 128), True, 0, 0),
    ("non-causal s=200", (1, 200, 200, 4, 1, 128), False, 0, 0),
    ("whisper encoder s=1500 non-causal hd64", (_wb, _wf, _wf, 8, 8, 64),
     False, 0, 0),
    ("whisper cross 448x1500 non-causal hd64", (_wb, _wt, _wf, 8, 8, 64),
     False, 0, 0),
    ("whisper self s=448 causal hd64", (_wb, _wt, _wt, 8, 8, 64), True, 0,
     0),
]
# gemma3-12b's head (the wide kernels): its path's shape with and without
# its window, and a ragged continuation inside a window
FLASH_HD240_CASES = [
    ("hd240 gemma3 path shape causal", (_gb, _gs, _gs, _gh, _gkv, _ghd),
     True, 0, 0),
    ("hd240 gemma3 path shape window=1024",
     (_gb, _gs, _gs, _gh, _gkv, _ghd), True, 1024, 0),
    ("hd240 q_offset=123 window=24", (1, 77, 200, 4, 2, 240), True, 24, 123),
]


def flash_checks(dev, rng, cases=FLASH_CASES) -> tuple:
    """The flash kernels against the masked-einsum oracle on the card,
    and the bf16 kernel against its plain version on its own tiles
    (gates); and the bf16 kernel against attention_blocked(...,
    round_p=False), stated."""
    import torch
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention import ref as f_ref
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
                q_block=64, kv_block=f_ops.bf16_tile_keys(hd),
                round_p=True)
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
                q_block=64, kv_block=f_ops.bf16_tile_keys(hd),
                round_p=False)
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
        ("mesh shard", (MESH_SHARD_B,) + WKV6_SHAPE[1:], False),
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
                  tag: str, cos_min: float, after=(), n_docs: int = OFF_DOCS,
                  doc_len: int = OFF_DOC_LEN, batch_size: int = OFF_BATCH,
                  resume=(RESUME_DOCS, RESUME_CUT), depth: int = 0) -> tuple:
    """ScaleDocEngine.from_corpus over ``arch`` into a store of
    ``n_docs`` documents of ``doc_len`` tokens, ``batch_size`` a batch,
    then its checks: ``kernel`` is the kernel each of its attention (or
    RWKV6) layers launches once per batch, ``plain_opts`` the service options of its plain path,
    whose pooled embeddings must reach a per-row cosine of ``cos_min``,
    ``resume`` the kill/resume drill's documents and the row it is killed
    at. Each phase ``fn(dev, service, engine, docs)`` of ``after`` runs in
    turn over the same weights, engine and corpus before the store is
    deleted; its report goes under the key ``fn.__name__``. ``depth``
    cuts the model to that many layers (0: all). Returns the report, the
    service and its first batch of tokens."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch.config import (BLOCK_LOCAL_ATTN, CascadeConfig,
                                    ProxyConfig, get_arch)
    from repro_torch.core.encoder import tree_leaves
    from repro_torch.core.oracle import SimulatedOracle
    from repro_torch.data import make_corpus, make_query
    from repro_torch.engine import ScaleDocEngine, build_index
    from repro_torch.engine.store import DATA_NAME
    from repro_torch.models import build_model
    from repro_torch.models.transformer import kernel_layers
    from repro_torch.runtime.serve_loop import EmbeddingService

    cfg = get_arch(arch)
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers of "
        f"{'/'.join(cfg.block_pattern)}, d={cfg.d_model}, {cfg.num_heads} "
        f"heads over {cfg.num_kv_heads} KV heads, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params ({n_params}; {n_bytes / 1e9:.3f} "
        f"GB; param_count() {cfg.param_count()}) drawn on the card in "
        f"{init_s:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
        f"allocated")
    t0 = time.perf_counter()
    # OFF_VOCAB ids, or all of a smaller vocabulary (zamba2-2.7b's 32,000)
    vocab = min(OFF_VOCAB, cfg.vocab_size)
    corpus = make_corpus(0, n_docs=n_docs, dim=128, with_tokens=True,
                         vocab=vocab, doc_len=doc_len)
    docs = [corpus.tokens[i] for i in range(n_docs)]
    n_tokens = n_docs * doc_len
    log(f"[{tag}] corpus: {n_docs} docs x {doc_len} tokens "
        f"(vocab {vocab}) = {n_tokens} tokens, made in "
        f"{time.perf_counter() - t0:.1f} s")
    service = EmbeddingService(cfg, params, batch_size=batch_size,
                               device=dev)
    t0 = time.perf_counter()
    digest = service.params_digest()
    digest_s = time.perf_counter() - t0
    log(f"[{tag}] params digest {digest} in {digest_s:.1f} s")

    work = ROOT / "build" / "chip_smoke_stores"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        # -- the path: every count 0 just before, read just after ---------
        kernels = zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with AttentionCalls() as calls:
            engine = ScaleDocEngine.from_corpus(
                service, docs, work / "store", proxy_cfg=ProxyConfig(),
                cascade_cfg=CascadeConfig(accuracy_target=0.9), device=dev)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(kernels)
        launches = counts[kernel]
        st = engine.ingest_result.stats
        store = engine.store
        emb = store.get(np.arange(len(store)))
        log(f"[{tag}] from_corpus: {len(store)} x {store.dim} rows in "
            f"{wall:.1f} s: {st.docs / wall:.1f} docs/s, "
            f"{n_tokens / wall:.0f} tokens/s; {st.batches} batches, "
            f"{st.commits} commits; launches {json.dumps(counts)}; "
            f"attention calls by window {json.dumps(calls.by_window)}")
        split = {f: getattr(st, f) for f in (
            "host_io_seconds", "compute_seconds", "stall_seconds",
            "write_seconds", "wall_seconds")}
        split["overlap_fraction"] = st.overlap_fraction
        split["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"[{tag}] IngestStats: {json.dumps(split)}")
        if emb.shape != (n_docs, cfg.d_model) or not np.isfinite(
                emb).all():
            fail(f"the store is not {n_docs} finite rows of width "
                 f"{cfg.d_model}: {emb.shape}")
        per_batch = kernel_layers(cfg)
        if st.batches != n_docs // batch_size or \
                launches != per_batch * st.batches:
            fail(f"{kernel} launched {launches} times over {st.batches} "
                 f"batches; expected {per_batch} per batch")
        # each local layer's call carries the config's window, each
        # global (or shared) layer's none
        local = cfg.layer_kinds().count(BLOCK_LOCAL_ATTN)
        want_calls = {}
        if kernel == "flash_attention":
            want_calls = {str(w): n * st.batches for w, n in (
                (cfg.sliding_window, local), (0, per_batch - local))
                if n}
        if calls.by_window != want_calls:
            fail(f"attention calls by window {calls.by_window}; expected "
                 f"{want_calls}")

        # -- the kernel path against the plain path, one batch -----------
        batch = np.stack(docs[:batch_size]).astype(np.int32)
        with MoERoutes() as got_routes:
            got = service.embed_batch(batch)
        plain = EmbeddingService(cfg, params, batch_size=batch_size,
                                 device=dev, **plain_opts)
        with MoERoutes() as want_routes:
            want = plain.embed_batch(batch)
        cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
        routing = {}
        if cfg.moe.enabled:
            # logged before the cosine's gate: a routing flip is the
            # likeliest reason for a miss
            dropped, routed = got_routes.dropped()
            flips = got_routes.flips(want_routes, cfg.moe.num_experts)
            routing = {"dropped_pairs": dropped, "routed_pairs": routed,
                       "dropped_share": dropped / routed,
                       "plain_dropped_pairs": want_routes.dropped()[0],
                       "flips_vs_plain": flips}
            log(f"[{tag}] batch 0 routing: {dropped} of {routed} (token, "
                f"layer, k) pairs dropped by capacity "
                f"({100 * dropped / routed:.4f}%; the plain path "
                f"{routing['plain_dropped_pairs']}); {flips} (token, layer, "
                f"k) pairs routed to an expert the plain path did not pick")
            if not dropped > 0:
                fail(f"[{tag}] no capacity drop in a batch of "
                     f"{batch.size} tokens")
        del got_routes, want_routes
        p_err = (got - want).abs().max().item()
        same_as_store = bool(np.array_equal(got.cpu().numpy(),
                                            emb[:batch_size]))
        log(f"[{tag}] kernel path vs {plain_opts}, batch 0: min per-row "
            f"cosine {cos.min().item():.6f} (>= {cos_min}), max abs err "
            f"{p_err:.3e} (|x| max {want.abs().max().item():.3e}); "
            f"bitwise equal to the store's rows: {same_as_store}")
        if not cos.min().item() >= cos_min:
            fail(f"the kernel path's embeddings disagree with {plain_opts}")
        # -- kill / resume drill -----------------------------------------
        resume_docs, resume_cut = resume
        part_docs = docs[:resume_docs]
        full = build_index(service, part_docs, work / "full")
        killed = build_index(service, part_docs, work / "killed",
                             max_docs=resume_cut)
        if not killed.interrupted or len(killed.store) != resume_cut:
            fail(f"max_docs={resume_cut} left {len(killed.store)} rows")
        resumed = build_index(service, part_docs, work / "killed")
        a = (work / "full" / DATA_NAME).read_bytes()
        b = (work / "killed" / DATA_NAME).read_bytes()
        prefix = emb[:resume_docs].tobytes() == a
        log(f"[{tag}] kill at {resume_cut} of {resume_docs} docs, resume "
            f"from row {resumed.stats.resumed_rows}: embeddings.bin "
            f"bit-identical to an uninterrupted run: {a == b} ({len(a)} "
            f"bytes); equal to the full store's first rows: {prefix}")
        if a != b or resumed.stats.resumed_rows != resume_cut \
                or full.interrupted:
            fail("the resumed store differs from the uninterrupted one")

        # -- one query over the store -------------------------------------
        q = make_query(corpus, 100, selectivity=0.2)
        pos = np.nonzero(q.truth)[0][:4]
        e_q = emb[pos].mean(axis=0)
        e_q = (e_q / (np.linalg.norm(e_q) + 1e-9)).astype(np.float32)
        kernels = zero_counts()
        tq = time.perf_counter()
        qs = engine.query(e_q, SimulatedOracle(q.truth), ground_truth=q.truth,
                          seed=0)
        q_wall = time.perf_counter() - tq
        q_counts = read_counts(kernels)
        log(f"[{tag}] query (sel {q.selectivity:.2f}) over the store of "
            f"width {store.dim}: F1 {qs.cascade.achieved_f1:.4f} (no bar: "
            f"random weights), oracle calls {qs.oracle_calls_total} of "
            f"{n_docs}, {q_wall:.2f} s; launches {json.dumps(q_counts)}")
        if not np.isfinite(qs.scores).all() or \
                qs.oracle_calls_total > n_docs or \
                q_counts["fused_scoring"] <= 0:
            fail("the query over the offline store failed")

        # one embedding batch on the card, and the flash share of it
        batch_dev = torch.as_tensor(batch, device=dev)
        batch_ms = cuda_ms(lambda: service.embed_batch(batch_dev), 5,
                           warmup=1)
        after_report = {fn.__name__: fn(dev, service, engine, docs)
                        for fn in after}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"[{tag}] phase took {phase_s:.1f} s")
    return {**after_report, "phase_seconds": phase_s, "arch": cfg.name,
            "kernel": kernel, "params": n_params, "param_bytes": n_bytes,
            "param_count": cfg.param_count(), "init_seconds": init_s,
            "digest_seconds": digest_s, "n_docs": n_docs,
            "doc_len": doc_len, "batch_size": batch_size,
            "tokens": n_tokens, "wall_seconds": wall,
            "docs_per_second": n_docs / wall,
            "tokens_per_second": n_tokens / wall, "batches": st.batches,
            "launches": launches, "launch_counts": counts,
            "attention_calls_by_window": calls.by_window,
            "ingest_stats": split,
            "pooled_min_cosine": cos.min().item(), "routing": routing,
            "pooled_max_abs_err": p_err, "resume_bit_identical": a == b,
            "query": {"f1": qs.cascade.achieved_f1,
                      "oracle_calls": qs.oracle_calls_total,
                      "wall_seconds": q_wall, "launches": q_counts},
            "embed_batch_ms": batch_ms}, service, batch


def scoring_mesh(dev) -> tuple:
    """The [mesh] phase's ("data",) mesh of MESH_ENTRIES entries: that
    many distinct cards when the process has them, else ``dev`` repeated
    (its row shards share the card); and which of the two it is."""
    import torch
    from collections import OrderedDict
    from repro_torch.launch.mesh import Mesh, make_scoring_mesh
    if torch.cuda.device_count() >= MESH_ENTRIES:
        mesh = make_scoring_mesh(MESH_ENTRIES)
        return mesh, "distinct cards " + ", ".join(map(str, mesh.devices))
    return (Mesh(OrderedDict(data=MESH_ENTRIES), (dev,) * MESH_ENTRIES),
            f"{dev} x{MESH_ENTRIES} (one card: the shards share it)")


def mesh_phase(dev, embeds, query, params) -> dict:
    """[mesh] (a) and (b) over the main path's corpus on the 2-entry
    mesh: (a) one scoring pass of ``params`` (a trained leaf's proxy) on
    the shard path (use_kernel=False) against the single-device plain
    pass (MESH_TOL), then use_kernel=True on the same mesh (the fused
    kernel on one device, as the JAX executor routes it); (b) one
    query() of ScaleDocEngine(mesh=, use_kernel=False) against the
    single-device engine: equal oracle calls, and every decision that
    differs from a score within 1e-6 of l or r."""
    import numpy as np
    import torch
    from repro_torch.config import CascadeConfig, ProxyConfig
    from repro_torch.core.oracle import SimulatedOracle
    from repro_torch.engine import (InMemoryStore, ScaleDocEngine,
                                    ScoringExecutor)
    t_phase = time.perf_counter()
    mesh, kind = scoring_mesh(dev)
    store = InMemoryStore(embeds)
    n = len(store)
    runs = {}
    # the shard path twice: its first pass is a second card's first use
    # (context, cuBLAS handle), the second the steady state
    for name, kw in (("single", dict(use_kernel=False)),
                     ("shard_first", dict(use_kernel=False, mesh=mesh)),
                     ("shard", dict(use_kernel=False, mesh=mesh)),
                     ("fused", dict(use_kernel=True, mesh=mesh))):
        ex = ScoringExecutor(device=dev, **kw)
        kernels = zero_counts()
        torch.cuda.synchronize()
        scores, stats = ex.score(params, query.embed, store)
        runs[name] = (scores, stats, read_counts(kernels))
    (single, st1, _), (shard, sts, c_shard), (fused, stf, c_fused) = (
        runs["single"], runs["shard"], runs["fused"])
    first, st_first, c_first = runs["shard_first"]
    diff = float(np.abs(shard - single).max())
    bitwise = bool(np.array_equal(shard, single))
    f_diff = float(np.abs(fused - single).max())
    log(f"[mesh] (a) scoring pass over {n} documents on {kind}: shard path "
        f"devices {sts.devices}, paths {sts.paths}, {sts.tiles_scored} "
        f"tiles, wall {sts.wall_seconds:.4f} s (the first pass "
        f"{st_first.wall_seconds:.4f} s; single device "
        f"{st1.wall_seconds:.4f} s); max abs diff against the single-device "
        f"plain pass {diff:.3e} (rtol = atol = 1e-6), bitwise {bitwise}; "
        f"use_kernel=True on the mesh: devices {stf.devices}, paths "
        f"{stf.paths}, fused launches {c_fused['fused_scoring']}, max abs "
        f"diff {f_diff:.3e} (tol {F32_TOL:g}), wall {stf.wall_seconds:.4f} s")
    for st, got, counts in ((sts, shard, c_shard),
                            (st_first, first, c_first)):
        if st.devices != MESH_ENTRIES or st.paths != ("shard",) or \
                sum(counts.values()):
            fail(f"the shard path reported devices {st.devices}, paths "
                 f"{st.paths}, launches {counts}")
        if not np.allclose(got, single, **MESH_TOL):
            fail(f"the shard path's scores differ from the single-device "
                 f"pass by {float(np.abs(got - single).max())}")
    if stf.devices != 1 or stf.paths != ("fused",) or \
            c_fused["fused_scoring"] != stf.tiles_scored or \
            not f_diff <= F32_TOL:
        fail(f"use_kernel=True on the mesh: devices {stf.devices}, paths "
             f"{stf.paths}, launches {c_fused}, diff {f_diff}")

    # (b) one query() on the mesh engine against the single-device one
    q = query
    out = {}
    for name, m in (("single", None), ("mesh", mesh)):
        eng = ScaleDocEngine(store, ProxyConfig(),
                             CascadeConfig(accuracy_target=0.9), mesh=m,
                             use_kernel=False, device=dev)
        oracle = SimulatedOracle(q.truth)
        tq = time.perf_counter()
        st = eng.query(q.embed, oracle, ground_truth=q.truth, seed=0)
        out[name] = (st, oracle.calls, time.perf_counter() - tq)
    (one, one_calls, one_s), (sh, sh_calls, sh_s) = out["single"], \
        out["mesh"]
    differ = np.nonzero(sh.cascade.labels != one.cascade.labels)[0]
    near = np.minimum(np.abs(one.scores[differ] - one.cascade.l),
                      np.abs(one.scores[differ] - one.cascade.r))
    q_diff = float(np.abs(sh.scores - one.scores).max())
    log(f"[mesh] (b) query() (sel {q.selectivity:.2f}) on the mesh engine "
        f"(use_kernel=False): F1 {sh.cascade.achieved_f1:.4f} against "
        f"{one.cascade.achieved_f1:.4f} single-device; oracle calls "
        f"{sh.oracle_calls_total} against {one.oracle_calls_total} (oracle "
        f"{sh_calls} against {one_calls}); {len(differ)} decisions differ "
        f"(all within 1e-6 of l or r: {bool((near <= 1e-6).all())}); "
        f"scores max abs diff {q_diff:.3e}; l {sh.cascade.l:.6f} r "
        f"{sh.cascade.r:.6f}; {sh_s:.2f} s against {one_s:.2f} s")
    if not (near <= 1e-6).all() or sh_calls != one_calls or \
            sh.oracle_calls_total != one.oracle_calls_total:
        fail("the mesh engine's query() differs from the single-device one")
    phase_s = time.perf_counter() - t_phase
    log(f"[mesh] (a) and (b) took {phase_s:.1f} s")
    return {"mesh": kind, "n_docs": n,
            "scoring": {"devices": sts.devices, "paths": list(sts.paths),
                        "max_abs_diff": diff, "bitwise": bitwise,
                        "shard_wall_seconds": sts.wall_seconds,
                        "shard_first_wall_seconds": st_first.wall_seconds,
                        "single_wall_seconds": st1.wall_seconds,
                        "fused_devices": stf.devices,
                        "fused_paths": list(stf.paths),
                        "fused_launches": c_fused["fused_scoring"],
                        "fused_max_abs_diff": f_diff,
                        "fused_wall_seconds": stf.wall_seconds},
            "query": {"decisions_differ": int(len(differ)),
                      "oracle_calls": sh.oracle_calls_total,
                      "single_oracle_calls": one.oracle_calls_total,
                      "scores_max_abs_diff": q_diff,
                      "f1": sh.cascade.achieved_f1,
                      "wall_seconds": sh_s, "single_wall_seconds": one_s},
            "phase_seconds": phase_s}


def mesh_ingest(dev, service, engine, docs) -> dict:
    """[mesh] (c): the first MESH_DOCS documents of the offline corpus
    through build_index on the 2-entry mesh, by a service over the same
    weights (``EmbeddingService(mesh=)``; nothing drawn, and its digest
    the one the offline service already computed), against the rows the
    single-device from_corpus stored for them: per-row cosine >= COS_MIN,
    whether bitwise, and the path's kernel launched once a layer a
    shard a batch."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.config import BLOCK_RWKV6
    from repro_torch.engine import build_index
    from repro_torch.models.transformer import kernel_layers
    from repro_torch.runtime.serve_loop import EmbeddingService
    from repro_torch.sharding.rules import shard_rows
    mesh, kind = scoring_mesh(dev)
    cfg = service.cfg
    kernel = ("wkv6" if BLOCK_RWKV6 in cfg.layer_kinds()
              else "flash_attention")
    t0 = time.perf_counter()
    svc = EmbeddingService(cfg, service.params, service.batch_size,
                           mesh=mesh, device=dev)
    # the weights' digest was taken once, by the offline service
    svc._digest = service.params_digest()
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    work = ROOT / "build" / "chip_smoke_stores" / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    try:
        kernels = zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = build_index(svc, docs[:MESH_DOCS], work, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(kernels)
        rows = np.arange(MESH_DOCS)
        got = res.store.get(rows)
        want = engine.store.get(rows)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # one launch a layer for each entry's shard, a repeated card's too
    expect = kernel_layers(cfg) * res.stats.batches * MESH_ENTRIES
    # one shard's forward: the host's time to issue it (no sync) against
    # the card's time to run it, which bounds what one controller thread
    # can keep busy
    shard = torch.as_tensor(shard_rows(mesh, np.stack(
        docs[:service.batch_size]).astype(np.int32))[0],
        device=mesh.devices[0])
    svc.embed_batch([shard])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.embed_batch([shard])
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    shard_ms = cuda_ms(lambda: svc.embed_batch([shard]), 3, warmup=1)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    bitwise = bool(np.array_equal(got, want))
    err = float(np.abs(got - want).max())
    log(f"[mesh] (c) {cfg.name}: {MESH_DOCS} docs through build_index on "
        f"{kind} in {wall:.2f} s ({res.stats.batches} batches of "
        f"{service.batch_size}, {service.batch_size // MESH_ENTRIES} rows a "
        f"shard; {MESH_DOCS / wall:.1f} docs/s; params placed in "
        f"{place_s:.2f} s), IngestStats.devices {res.stats.devices}; "
        f"launches {json.dumps(counts)} ({kernel}: {expect} expected); "
        f"min per-row cosine against the single-device rows "
        f"{cos.min():.7f} (>= {COS_MIN}), max abs err {err:.3e}, bitwise "
        f"{bitwise}; one shard's forward: issued in {issue_ms:.2f} ms of "
        f"host time, {shard_ms:.2f} ms on the card (CUDA events)")
    if got.shape != want.shape or not np.isfinite(got).all() or \
            res.stats.devices != MESH_ENTRIES:
        fail(f"the sharded ingest of {cfg.name} gave {got.shape} rows on "
             f"{res.stats.devices} devices")
    if counts[kernel] != expect or counts[kernel] <= 0:
        fail(f"{kernel} launched {counts[kernel]} times on the mesh; "
             f"expected {expect}")
    if not cos.min() >= COS_MIN:
        fail(f"the sharded ingest of {cfg.name} disagrees with the "
             f"single-device rows: cosine {cos.min()}")
    return {"mesh": kind, "docs": MESH_DOCS, "batches": res.stats.batches,
            "wall_seconds": wall, "place_seconds": place_s,
            "kernel": kernel, "launches": counts[kernel],
            "launch_counts": counts, "min_cosine": float(cos.min()),
            "max_abs_err": err, "bitwise": bitwise,
            "shard_issue_ms": issue_ms, "shard_ms": shard_ms}


class AttentionCalls:
    """Within the block, the attention layer's calls of the flash entry
    (``ops.attention``), counted by their window and by their form
    ("causal" or "non-causal", sq x skv) (the launches are counted by
    the kernel's wrapper, as everywhere)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as f_ops
        self.by_window, self.by_form = {}, {}
        self._ops, self._inner = f_ops, f_ops.attention

        def counted(q, k, v, *, window=0, causal=True, **kw):
            key = str(window)
            self.by_window[key] = self.by_window.get(key, 0) + 1
            form = (f"{'causal' if causal else 'non-causal'} "
                    f"{q.shape[1]}x{k.shape[1]}")
            self.by_form[form] = self.by_form.get(form, 0) + 1
            return self._inner(q, k, v, window=window, causal=causal, **kw)
        f_ops.attention = counted
        return self

    def __exit__(self, *exc):
        self._ops.attention = self._inner
        return False


class MoERoutes:
    """Within the block, every MoE chunk routed alone
    (``models.moe._route``), in call order (layer by layer, chunk by
    chunk): its experts (T, K), which pairs fit the capacity, the
    log-probabilities of each token's top K + 1 experts (from the
    router's ``_gate``) and its layer (the group of the router leaf
    ``moe_apply`` was given: its offset in the stacked leaf), kept on
    the device."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.experts, self.keep, self.top, self.layers = [], [], [], []
        self._mod = moe
        self._inner = (moe._route, moe._gate, moe.moe_apply)
        route_inner, gate_inner, apply_inner = self._inner
        layer = [-1]

        def apply(params, x, *args, **kw):
            r = params["router"]
            r = r.to_local() if hasattr(r, "to_local") else r
            layer[0] = r.storage_offset() // r.numel()
            return apply_inner(params, x, *args, **kw)

        def gate(router, x, cfg):
            probs, gates, experts = gate_inner(router, x, cfg)
            self.top.append(torch.topk(probs, cfg.moe.top_k + 1,
                                       dim=-1).values.log())
            return probs, gates, experts

        def route(*args, **kw):
            out = route_inner(*args, **kw)
            self.experts.append(out[1])
            self.keep.append(out[3])
            self.layers.append(layer[0])
            return out
        moe._route, moe._gate, moe.moe_apply = route, gate, apply
        return self

    def __exit__(self, *exc):
        self._mod._route, self._mod._gate, self._mod.moe_apply = self._inner
        return False

    def mark(self) -> int:
        return len(self.experts)

    def records(self, start: int = 0, stop=None) -> list:
        """(experts, keep (T, K), top log-probabilities, layer) of the
        calls [start, stop), on the host."""
        return [(e.cpu(), k.reshape(e.shape).cpu(), t.cpu(), n)
                for e, k, t, n in list(zip(self.experts, self.keep, self.top,
                                           self.layers))[start:stop]]

    def dropped(self) -> tuple:
        """(pairs dropped by capacity, pairs routed)."""
        import torch
        if not self.keep:
            return 0, 0
        keep = torch.cat(self.keep)
        return int((~keep).sum().item()), keep.numel()

    def flips(self, other, n_experts: int) -> int:
        """(token, layer, k) pairs routed to an expert that ``other``'s
        same token in the same call did not pick."""
        import torch.nn.functional as F
        n = 0
        for mine, theirs in zip(self.experts, other.experts):
            picked = F.one_hot(theirs, n_experts).sum(1) > 0   # (T, E)
            n += int((~picked.gather(1, mine)).sum().item())
        return n


def zero_counts() -> dict:
    """Every kernel's launch count set to 0; returns the kernels."""
    kernels = all_kernels()
    for kern in kernels.values():
        kern.launches = 0
    return kernels


def read_counts(kernels) -> dict:
    return {name: kern.launches for name, kern in kernels.items()}


class RecordingJudge:
    """The judge behind the cascade, recording each document it is asked
    about with the label it gave, and the host time spent judging."""

    def __init__(self, inner):
        self.inner = inner
        self.given = {}
        self.seconds = 0.0

    @property
    def calls(self):
        return self.inner.calls

    def label(self, indices):
        import numpy as np
        t0 = time.perf_counter()
        out = self.inner.label(indices)      # a numpy copy: synchronized
        self.seconds += time.perf_counter() - t0
        for i, lab in zip(np.asarray(indices, np.int64), out):
            if int(i) in self.given:
                fail(f"[judge] document {int(i)} was judged twice")
            self.given[int(i)] = bool(lab)
        return out


def judge(dev, service, engine, docs) -> dict:
    """[judge]: the service's llama3-8b as the cascade's oracle over the
    offline corpus and store. The baseline judges every document (the
    paper's "LLM on every document"); its labels are the reference for
    F1 and for every label the cascade buys. Then query() with the judge
    as its oracle, and the kernel path's last-position logits against the
    plain einsum path's on JUDGE_PLAIN_DOCS prompts."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core import LMOracle, LMOracleConfig
    from repro_torch.core.oracle import JUDGE_BATCH
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg, model, params = service.cfg, service.model, service.params
    tokens = np.stack(docs).astype(np.int32)
    n = len(tokens)
    ocfg = LMOracleConfig()
    prompt_len = JUDGE_QUERY_LEN + ocfg.max_doc_tokens
    seeds = {}
    for seed in JUDGE_SEEDS:
        query = np.random.default_rng(seed).integers(
            3, OFF_VOCAB, size=JUDGE_QUERY_LEN).astype(np.int32)
        baseline = LMOracle(model, params, query, tokens, ocfg)
        kernels = zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        truth = baseline.label(np.arange(n))
        base_s = time.perf_counter() - t0
        counts = read_counts(kernels)
        sel = float(truth.mean())
        seeds[seed] = {"selectivity": sel, "wall_seconds": base_s,
                       "launches": counts}
        log(f"[judge] query seed {seed}: the judge over all {n} documents "
            f"(prompts of {prompt_len} tokens, micro-batches of "
            f"{JUDGE_BATCH}) in {base_s:.3f} s: {n / base_s:.1f} prompts/s, "
            f"{n * prompt_len / base_s:.0f} tokens/s; selectivity "
            f"{sel:.4f}; launches {json.dumps(counts)}")
        if counts["flash_attention"] != cfg.num_layers * -(-n // JUDGE_BATCH):
            fail(f"[judge] flash launched {counts['flash_attention']} times "
                 f"for {n} prompts")
        if min(sel, 1 - sel) >= JUDGE_MIN_CLASS:
            break
    else:
        log(f"[judge] every seed of {JUDGE_SEEDS} gave a degenerate "
            f"selectivity; seed {seed} is used")

    emb = service.embed_batch(query[None]).cpu().numpy()[0]
    e_q = (emb / (np.linalg.norm(emb) + 1e-9)).astype(np.float32)
    recorder = RecordingJudge(LMOracle(model, params, query, tokens, ocfg))
    kernels = zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = engine.query(e_q, recorder, ground_truth=truth, seed=0)
    torch.cuda.synchronize()
    q_wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    calls = st.oracle_calls_total
    split = {"train": st.oracle_calls_train,
             "calib": st.cascade.oracle_calls_calib,
             "online": st.cascade.oracle_calls_online}
    band = (st.scores >= st.cascade.l) & (st.scores <= st.cascade.r)
    asked = np.fromiter(recorder.given, np.int64, len(recorder.given))
    given = np.fromiter(recorder.given.values(), bool, len(asked))
    same_given = bool(np.array_equal(given, truth[asked]))
    same_band = bool(np.array_equal(st.cascade.labels[band], truth[band]))
    log(f"[judge] query() with the judge as oracle: calls {calls} of {n} "
        f"({json.dumps(split)}; the judge asked about {len(asked)} "
        f"documents), data reduction {1 - calls / n:.4f}, wall "
        f"{q_wall:.3f} s of which the judge {recorder.seconds:.3f} s "
        f"({100 * recorder.seconds / q_wall:.1f}%), F1 against the "
        f"all-documents judge {st.cascade.achieved_f1:.4f} (no bar: random "
        f"weights), l={st.cascade.l:.4f} r={st.cascade.r:.4f}, band "
        f"{int(band.sum())} documents; the all-documents judge took "
        f"{base_s / q_wall:.2f}x query()'s wall; launches "
        f"{json.dumps(counts)}")
    log(f"[judge] every label the cascade bought equals the all-documents "
        f"judge's: {same_given}; the mask over the band equals it: "
        f"{same_band}")
    if calls > n or recorder.calls > n:
        fail(f"[judge] {calls} oracle calls > N = {n}")
    if not (same_given and same_band):
        fail("[judge] a label the cascade bought differs from the "
             "all-documents judge's")
    for name in ("flash_attention", "fused_scoring", "contrastive"):
        if counts[name] <= 0:
            fail(f"[judge] {name} was never launched in query()")

    # the kernel path against the plain einsum path, same prompts
    idx = np.arange(JUDGE_PLAIN_DOCS)
    plain = LMOracle(build_model(cfg, attn_impl="einsum"), params, query,
                     tokens, ocfg)
    got = recorder.inner.last_logits(idx)
    want = plain.last_logits(idx)
    cos = F.cosine_similarity(got, want, dim=1).min().item()
    y, no = ocfg.yes_token, ocfg.no_token
    m_got, m_want = got[:, y] - got[:, no], want[:, y] - want[:, no]
    agree = ((m_got > 0) == (m_want > 0)).float().mean().item()
    d_margin = (m_got - m_want).abs().max().item()
    del got, want
    log(f"[judge] kernel path vs attn_impl='einsum' on {JUDGE_PLAIN_DOCS} "
        f"prompts: min per-row cosine of the last-position logits {cos:.6f}"
        f" (>= {COS_MIN}), decisions agree {agree:.4f} (>= "
        f"{JUDGE_AGREE_MIN}), max |d(logit_yes - logit_no)| {d_margin:.4e} "
        f"(|margin| max {m_want.abs().max().item():.4e})")
    if not cos >= COS_MIN:
        fail("[judge] the kernel path's logits disagree with the plain path")
    if not agree >= JUDGE_AGREE_MIN:
        fail(f"[judge] decisions agree on {agree:.4f} < {JUDGE_AGREE_MIN}")
    phase_s = time.perf_counter() - t_phase
    log(f"[judge] phase took {phase_s:.1f} s")
    return {"phase_seconds": phase_s, "query_seed": seed, "seeds": seeds, "selectivity": sel,
            "prompt_tokens": prompt_len, "judge_batch": JUDGE_BATCH,
            "baseline_seconds": base_s, "baseline_prompts_per_second":
                n / base_s,
            "baseline_tokens_per_second": n * prompt_len / base_s,
            "query_wall_seconds": q_wall, "judge_seconds": recorder.seconds,
            "oracle_calls": calls, "calls_split": split,
            "data_reduction": 1 - calls / n,
            "f1_vs_all_documents_judge": st.cascade.achieved_f1,
            "baseline_over_query_wall": base_s / q_wall,
            "band_docs": int(band.sum()), "launches": counts,
            "plain_min_cosine": cos, "plain_agreement": agree,
            "plain_max_margin_diff": d_margin}


def decode(dev, service, engine, docs) -> dict:
    """[decode]: generate on one embedding batch of the offline documents
    (the service's batch size) for DECODE_STEPS tokens (greedy) with the
    service's model, against a hand-rolled
    prefill + decode_step loop (bitwise), both with prefill_last_only
    (the serving option: logits at the last position only); then, at the
    same width in f32 through the kernels, decode steps against the
    teacher-forced forward: at 2 layers after DECODE_PRE tokens, or for a
    model with sliding-window layers one whole pattern period after
    GEMMA_PERIOD_PRE tokens (past the window), or for a model with
    mamba2 layers one whole pattern period after ZAMBA_PERIOD_PRE tokens
    (neither length a multiple of the chunk). The prefill's kernel:
    flash for attention layers (a shared block's every application),
    WKV6 for rwkv6 blocks; a mamba2 block launches none. A model with
    sliding-window layers must keep ring caches of its window and full
    caches of the prompt plus the new tokens. An MoE model's f32 check
    runs at capacity factor E / K, and its forward must drop no (token,
    k) pair."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import BLOCK_LOCAL_ATTN, BLOCK_MAMBA2, BLOCK_RWKV6
    from repro_torch.models import build_model
    from repro_torch.models.ssm import chunk_length
    from repro_torch.models.transformer import kernel_layers
    from repro_torch.runtime.serve_loop import generate

    t_phase = time.perf_counter()
    cfg, model, params = service.cfg, service.model, service.params
    kernel = ("wkv6" if BLOCK_RWKV6 in cfg.block_pattern
              else "flash_attention")
    tag = "decode"
    batch = service.batch_size
    prompt = torch.as_tensor(np.stack(docs[:batch]).astype(np.int32),
                             device=dev)
    b, s = prompt.shape
    model.prefill_last_only = True
    try:
        kernels = zero_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, params, prompt, DECODE_STEPS)
        gen_s = time.perf_counter() - t0      # generate ends in a copy
        counts = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        if counts[kernel] != kernel_layers(cfg):
            fail(f"[{tag}] {kernel} launched {counts[kernel]} times in "
                 f"generate(); expected {kernel_layers(cfg)} (the "
                 f"prefill)")

        # the hand-rolled loop, synchronized around the prefill and each
        # step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt,
                                      cache_len=s + DECODE_STEPS)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        del logits
        cache_lens = {}
        for i, kind in enumerate(cfg.block_pattern):
            if "k" in cache[f"p{i}"]:
                cache_lens.setdefault(kind, cache[f"p{i}"]["k"].shape[2])
        manual = [tok]
        t0 = time.perf_counter()
        for t in range(1, DECODE_STEPS):
            logits, cache = model.decode_step(params, tok, s + t - 1, cache)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            manual.append(tok)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (DECODE_STEPS - 1)
        del cache, logits
    finally:
        model.prefill_last_only = False
    manual = torch.cat(manual, dim=1).cpu().numpy()
    same = bool(np.array_equal(out, manual))
    log(f"[{tag}] {cfg.name} generate: {b} prompts of {s} tokens, "
        f"{DECODE_STEPS} new tokens, greedy, in {gen_s:.3f} s: "
        f"{b * DECODE_STEPS / gen_s:.1f} tokens/s; by hand, prefill "
        f"{1e3 * prefill_s:.2f} ms, decode {1e3 * step_s:.2f} ms a step "
        f"({b / step_s:.1f} tokens/s); peak {peak:.2f} GB; {kernel} "
        f"launches in the prefill {counts[kernel]}; launches "
        f"{json.dumps(counts)}; KV cache lengths by block kind "
        f"{json.dumps(cache_lens)}; tokens bitwise the hand-rolled loop's: "
        f"{same}")
    if not same:
        fail(f"[{tag}] generate() differs from prefill + decode_step")
    if BLOCK_LOCAL_ATTN in cache_lens and cache_lens[BLOCK_LOCAL_ATTN] != \
            min(cfg.sliding_window, s + DECODE_STEPS):
        fail(f"[{tag}] local layers' caches are "
             f"{cache_lens[BLOCK_LOCAL_ATTN]} long, not the window")
    if any(kind != BLOCK_LOCAL_ATTN and n != s + DECODE_STEPS
           for kind, n in cache_lens.items()):
        fail(f"[{tag}] global caches are not {s + DECODE_STEPS} long: "
             f"{cache_lens}")

    # decode against forward in f32, kernel path only
    windowed = BLOCK_LOCAL_ATTN in cfg.block_pattern
    hybrid = BLOCK_MAMBA2 in cfg.block_pattern
    layers = len(cfg.block_pattern) if windowed or hybrid else 2
    pre, total = ((GEMMA_PERIOD_PRE, GEMMA_PERIOD_TOTAL) if windowed
                  else (ZAMBA_PERIOD_PRE, ZAMBA_PERIOD_TOTAL) if hybrid
                  else (DECODE_PRE, DECODE_TOTAL))
    small = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    if cfg.moe.enabled:
        small = dataclasses.replace(small, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    m2 = build_model(small)
    p2 = m2.init(torch.Generator(dev).manual_seed(0))
    toks = torch.as_tensor(np.stack(docs[batch:batch + 2])
                           [:, :total].astype(np.int32), device=dev)
    kernels = zero_counts()
    with MoERoutes() as routes:
        full, _ = m2.forward(p2, toks)
    f32_dropped = routes.dropped()
    del routes
    if f32_dropped[0]:
        fail(f"[{tag}] the f32 forward dropped {f32_dropped[0]} of "
             f"{f32_dropped[1]} (token, k) pairs at capacity factor "
             f"{small.moe.capacity_factor}")
    _, cache = m2.prefill(p2, toks[:, :pre], cache_len=total)
    errs = []
    # over the real vocabulary: padded ids hold -1e30 in both, which
    # would make max |logit| 1e30 and any error vanish beside it
    v = cfg.vocab_size
    for t in range(pre, total):
        step, cache = m2.decode_step(p2, toks[:, t:t + 1], t, cache)
        errs.append(((step[:, 0, :v] - full[:, t, :v]).abs().max()
                     / full[:, t, :v].abs().max()).item())
    f32_counts = read_counts(kernels)
    del m2, p2, full, cache, step
    log(f"[{tag}] {cfg.name} decode vs forward at {layers} layers "
        f"({'/'.join(cfg.block_pattern)}) in f32 (full width, the kernel "
        f"path), steps {pre}..{total - 1}: max error of max |logit| "
        f"{', '.join(f'{e:.3e}' for e in errs)} (<= {DECODE_REL:g}); "
        f"launches {json.dumps(f32_counts)}"
        + (f"; MoE at capacity factor {small.moe.capacity_factor}: the "
           f"forward dropped {f32_dropped[0]} of {f32_dropped[1]} (token, "
           f"k) pairs" if cfg.moe.enabled else "")
        + (f"; SSD chunks {chunk_length(pre, cfg.ssm.chunk)} (prefill) and "
           f"{chunk_length(total, cfg.ssm.chunk)} (forward)" if hybrid
           else ""))
    if not max(errs) <= DECODE_REL:
        fail(f"[{tag}] decode disagrees with forward: {max(errs):.3e}")
    if f32_counts[kernel] != 2 * kernel_layers(small):
        fail(f"[{tag}] {kernel} launched {f32_counts[kernel]} times in the "
             f"f32 forward and prefill; expected "
             f"{2 * kernel_layers(small)}")
    phase_s = time.perf_counter() - t_phase
    log(f"[{tag}] {cfg.name} phase took {phase_s:.1f} s")
    return {"phase_seconds": phase_s, "arch": cfg.name, "batch": b,
            "prompt_tokens": s,
            "new_tokens": DECODE_STEPS, "generate_seconds": gen_s,
            "tokens_per_second": b * DECODE_STEPS / gen_s,
            "prefill_ms": 1e3 * prefill_s, "decode_ms_per_step": 1e3 * step_s,
            "decode_tokens_per_second": b / step_s, "peak_memory_gb": peak,
            "launches": counts, "generate_equals_loop": same,
            "cache_lengths": cache_lens, "f32_layers": layers,
            "f32_context": [pre, total], "f32_launches": f32_counts,
            "f32_forward_dropped_pairs": f32_dropped[0],
            "decode_vs_forward_rel_err": errs}


def moe_layer(dev, service, engine, docs) -> dict:
    """[moe] one MoE layer on its real input: layer 1's MoE input on the
    first batch of the corpus (the hidden state after layer 0 through
    layer 1's attention and norm), captured from the embedding path,
    through moe_apply with each dispatch: the max abs difference of the
    two (<= MOE_DISPATCH_REL of max |y|), the (token, k) pairs each kept,
    read off its own tables (dropped ones > 0, the two sets equal)."""
    import numpy as np
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import group_params

    cfg, params = service.cfg, service.params
    batch = torch.as_tensor(np.stack(docs[:service.batch_size])
                            .astype(np.int32), device=dev)
    inputs = []
    inner = moe_mod.moe_apply

    def recorded(p, x, *args, **kw):
        inputs.append(x)
        return inner(p, x, *args, **kw)
    moe_mod.moe_apply = recorded
    try:
        service.embed_batch(batch)
    finally:
        moe_mod.moe_apply = inner
    x = inputs[1]
    del inputs
    p = group_params(params, 1)["p0"]["moe"]
    with torch.inference_mode():
        y = {d: moe_mod.moe_apply(p, x, cfg, d) for d in ("onehot", "sort")}
    kept = {d: moe_mod.kept_pairs(p, x, cfg, d) for d in ("onehot", "sort")}
    torch.cuda.synchronize()
    err = (y["onehot"][0].float() - y["sort"][0].float()).abs().max().item()
    scale = y["onehot"][0].float().abs().max().item()
    same = bool(torch.equal(kept["onehot"], kept["sort"]))
    dropped = int((~kept["onehot"]).sum().item())
    pairs = kept["onehot"].numel()
    aux = {d: y[d][1].item() for d in y}
    finite = all(bool(torch.isfinite(y[d][0]).all()) for d in y)
    log(f"[moe] layer 1's MoE input on batch 0 ({tuple(x.shape)}, "
        f"{x.dtype}; {len(moe_mod._chunks(x.shape[0] * x.shape[1]))} "
        f"dispatch chunks of capacity "
        f"{moe_mod._capacity(moe_mod.DISPATCH_CHUNK, cfg)}): onehot vs "
        f"sort max abs err {err:.3e} of max |y| {scale:.3e} (<= "
        f"{MOE_DISPATCH_REL:g} of it); (token, k) pairs dropped {dropped} "
        f"of {pairs} ({100 * dropped / pairs:.4f}%), drop sets equal: "
        f"{same}; aux {aux['onehot']:.6f} / {aux['sort']:.6f}")
    if not (finite and same and dropped > 0
            and err <= MOE_DISPATCH_REL * scale):
        fail("[moe] the onehot and sort dispatches disagree on one layer")
    return {"input_shape": list(x.shape), "max_abs_err": err,
            "max_abs_y": scale, "dropped_pairs": dropped, "pairs": pairs,
            "drop_sets_equal": same, "aux": aux}


def fused_times(dev, n: int, d: int) -> dict:
    """The fused scoring kernel against its plain version on one tile of
    ``n`` documents of width ``d`` (``ProxyConfig()``'s hidden 512 and
    latent 128, Q = 1): max abs difference, CUDA-event times and the
    bound (FP32 operations or bytes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.config import ProxyConfig
    from repro_torch.core.encoder import encoder_init, tree_map
    from repro_torch.kernels.fused_scoring import ops as s_ops
    from repro_torch.kernels.fused_scoring import ref as s_ref
    params = tree_map(lambda p: p.to(dev), encoder_init(
        torch.Generator().manual_seed(0), ProxyConfig(embed_dim=d)))
    w = s_ops._unpack(params)
    gen = torch.Generator(dev).manual_seed(3)
    docs = torch.randn((n, d), generator=gen, device=dev) / d ** 0.5
    zq = F.normalize(torch.randn((1, 128), generator=gen, device=dev), dim=1)
    err = (s_ops.fused_scores_multi(docs, *w, zq)
           - s_ref.ref_scores_multi(docs, *w, zq)).abs().max().item()
    ms = cuda_ms(lambda: s_ops.fused_scores_multi(docs, *w, zq), 20)
    plain_ms = cuda_ms(lambda: s_ref.ref_scores_multi(docs, *w, zq), 20)
    work = s_ops.fused_work(docs, *w, zq)
    flops, nbytes = work.flops, work.bytes
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return {"n": n, "d": d, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def attention_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal attention over ``s`` positions visits,
    each query seeing at most ``window`` keys (0: all before it)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_times(dev, shape=FLASH_SHAPE, window: int = 0, *,
                causal: bool = True, skv: int = 0) -> dict:
    """The bf16 flash kernel, the FP32 kernel on the same inputs in f32,
    the plain version and SDPA under each backend, at ``shape`` (b, s,
    heads, KV heads, head_dim): s queries over ``skv`` keys (0: s),
    causal or not, with ``window`` (0: none; SDPA then takes the mask as
    a boolean attn_mask)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention import ref as f_ref
    b, s, h, kv, hd = shape
    skv = skv or s
    gen = torch.Generator(dev).manual_seed(1)
    q = torch.randn((b, s, h, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, skv, kv, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    scale = hd ** -0.5
    g = h // kv
    ms = cuda_ms(lambda: f_ops.flash_attention_fwd(
        q, k, v, scale=scale, causal=causal, window=window), 50)
    # a causal call again without the causal mask: every Q tile runs all
    # K/V tiles (at FLASH_SHAPE 16,384 tile steps against the causal
    # call's 9,216), which shows whether the causal loops' short length
    # or the steady state sets the time
    noncausal_ms = cuda_ms(lambda: f_ops.flash_attention_fwd(
        q, k, v, scale=scale, causal=False), 50) if causal else ms
    q32, k32, v32 = (x.float() for x in (q, k, v))
    fp32_ms = cuda_ms(lambda: f_ops.flash_attention_fwd(
        q32, k32, v32, scale=scale, causal=causal, window=window), 10)
    del q32, k32, v32
    plain_ms = cuda_ms(lambda: f_ref.attention_blocked(
        q, f_ref.expand_kv(k, g), f_ref.expand_kv(v, g), scale,
        causal=causal, window=window, round_p=True), 10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = (f_ref.attention_mask(s, skv, causal=causal, window=window,
                                 device=dev) if window else None)
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
                            qt, kt, vt, attn_mask=mask,
                            is_causal=causal and mask is None, scale=scale,
                            enable_gqa=True), 50)
            except (RuntimeError, AttributeError) as e:
                why = [str(w.message).split(" (Triggered")[0] for w in said]
                why = [w for w in why if not w.endswith("because:")]
                sdpa[name] = "refused: " + (why[0] if why else str(e))
    timed = {n: t for n, t in sdpa.items() if isinstance(t, float)}
    library = min(timed, key=timed.get) if timed else None
    pairs = attention_pairs(s, window) if causal else s * skv
    flops = 4 * b * h * hd * pairs
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * skv * kv * hd)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"shape": list(shape), "skv": skv, "causal": causal,
            "window": window, "ms": ms, "noncausal_ms": noncausal_ms,
            "noncausal_tflops": 4 * b * h * hd * s * skv / noncausal_ms
            / 1e9,
            "fp32_kernel_ms": fp32_ms, "plain_ms": plain_ms,
            "library_ms": timed[library] if library else None,
            "library_backend": library, "sdpa": sdpa,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "fp32_fma_bound_ms": flops / PEAK_FP32_FLOPS * 1e3}


def wkv6_times(dev, shape=WKV6_SHAPE) -> dict:
    """The WKV6 kernel, its plain version and the whole ops.wkv6 at
    ``shape`` (b, chunks, Q, heads, head_dim; the rwkv6-7b path's by
    default), and the kernel's bound: the largest of the
    function's exponentials over the MUFU rate and its FP32 operations
    over the FP32 peak, both as the sub-chunk form needs them, and its
    bytes over the memory rate."""
    import numpy as np
    import torch
    from repro_torch.kernels.wkv6 import ops as w_ops
    from repro_torch.kernels.wkv6 import ref as w_ref
    b, nc, q, h, k = shape
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
    # the sub-chunk form's least exponentials, FLOPs and bytes
    # (ops.wkv6_work); the kernel takes that form, so exps_kernel counts
    # the same. Its warps also evaluate the terms of their own sub-chunk
    # that lie on or above the diagonal (up to the warp's last row), which
    # a select drops: exps_evaluated counts those too
    work = w_ops.wkv6_work(*args)
    exps, flops, nbytes = work.transcendental, work.flops, work.bytes
    exps_kernel = exps
    sizes = [min(sub, q - i) for i in range(0, q, sub)]
    t_side = sum(i * m for i, m in enumerate(sizes))
    walked = sum(min(8, q - w) * (min(w + 8, q) - 1 - w // sub * sub)
                 for w in range(0, q, 8))
    exps_evaluated = b * nc * h * k * (walked + t_side + q + 2 * q + 1)
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
    the same call through the wrapper's torch.library operator (the cost
    counter's route, host included), its plain version's, and its
    bound."""
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.contrastive import ref as c_ref
    call = lambda: c_ops.contrastive_losses(*args, 0.07, 0.2)
    prof = profiler_ms(call, ("contrastive_rows_kernel",
                              "contrastive_finish_kernel"))
    work = c_ops.contrastive_work(*args, 0.07, 0.2)
    flops, nbytes = work.flops, work.bytes
    terms = {"operations": flops / PEAK_FP32_FLOPS,
             "bytes": nbytes / PEAK_BYTES}
    bound_by = max(terms, key=terms.get)
    calls = 50
    return {"device_ms": graph_ms(call, calls), "graph_calls": calls,
            "profiler_rows_ms": prof["contrastive_rows_kernel"],
            "profiler_finish_ms": prof["contrastive_finish_kernel"],
            "call_ms": cuda_ms(call, 200),
            "op_call_ms": cuda_ms(
                lambda: c_ops._contrastive_op(*args, 0.07, 0.2), 200),
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


def fused_instantiation(docs, w1, w2, w3) -> str:
    """The instantiation fused_scores_launch picks for these tensors
    (csrc/fused_scoring.cu: 16-byte copies when D % 4 == 0 and docs, w1,
    w2 and w3 are 16-byte aligned, 4-byte copies otherwise)."""
    vec = docs.shape[1] % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (docs, w1, w2, w3))
    return "16-byte" if vec else "4-byte"


def live_phase(dev, embeds, queries) -> tuple:
    """Phase 10, first part: a standing ``p1 & ~p2`` over a store an
    ingest job keeps appending to. The corpus goes through the port's
    StoreWriter into a MemmapStore directory; the first LIVE_CALIB rows
    are committed, the predicate registered there, and the delta ranges'
    row locality probed on the card; then the LIVE_GROUPS commit groups
    land, one pump each. The rest of the phase's gates run after
    [gateway], which lands the last groups (``live_finish``). Every gate
    is checked and logged; the phase fails after the last."""
    import shutil
    from types import SimpleNamespace

    import numpy as np
    import torch
    from repro_torch.config import CascadeConfig, ProxyConfig
    from repro_torch.core.oracle import SimulatedOracle
    from repro_torch.engine import (DriftConfig, InMemoryStore, LiveEngine,
                                    MemmapStore, ScaleDocEngine,
                                    SemanticPredicate, StoreWriter)
    from repro_torch.engine.live import PAD_DEVICE_TYPES, _score_rows
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.fused_scoring import ops as s_ops
    from repro_torch.runtime.trace import Tracer
    n, d = embeds.shape
    bad = []
    out = {}
    t_phase = time.perf_counter()
    shutil.rmtree(LIVE_DIR, ignore_errors=True)
    tw = time.perf_counter()
    writer = StoreWriter.open(LIVE_DIR, dim=d,
                              fingerprint={"model": "chip_smoke live"})
    writer.append(embeds[:LIVE_CALIB])
    writer.commit()
    out["first_commit_seconds"] = time.perf_counter() - tw

    pcfg, ccfg = ProxyConfig(), CascadeConfig(accuracy_target=0.9)
    live = LiveEngine(ScaleDocEngine(MemmapStore.open(LIVE_DIR), pcfg,
                                     ccfg, device=dev),
                      drift=DriftConfig(auto=False))
    live.tracer = Tracer()
    executor = live.engine.executor
    p = [SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                           name=f"p{i + 1}")
         for i, q in enumerate(queries[:2])]
    pred = p[0] & ~p[1]
    s_ops.KERNEL.launches = 0
    c_ops.KERNEL.launches = 0
    tr = time.perf_counter()
    sp = live.register(pred, seed=0, name="p1 & ~p2")
    out["register_seconds"] = time.perf_counter() - tr
    out["register_launches"] = {"fused_scoring": s_ops.KERNEL.launches,
                                "contrastive": c_ops.KERNEL.launches}
    out["register_oracle_calls"] = sp.calibration_oracle_calls
    sub = sp.subscribe()
    scorable = [ls for ls in sp._leaves if ls.scorable]
    out["leaves"] = [{"leaf": ls.name, "scorable": ls.scorable,
                      "l": ls.l, "r": ls.r} for ls in sp._leaves]
    log(f"[live] store: {LIVE_CALIB} of {n} rows committed through "
        f"StoreWriter in {out['first_commit_seconds']:.2f} s "
        f"({LIVE_CALIB * d * 4 / 1e9:.2f} GB); p1 & ~p2 registered at "
        f"watermark {sp.calib_rows} in {out['register_seconds']:.3f} s "
        f"({sp.calibration_oracle_calls} oracle calls; launches "
        f"{out['register_launches']}); leaves {json.dumps(out['leaves'])}")
    if not scorable:
        fail("live: no leaf of p1 & ~p2 is scorable after registration")
    if min(out["register_launches"].values()) <= 0:
        bad.append(f"registration launches {out['register_launches']}")

    # 1. the row-locality probe: every delta range of this run (the
    # ragged groups and the tail groups [gateway] lands), scored through
    # _score_rows without the pad and with it, against one pass over all
    # N rows (16 full tiles), on an in-memory view of the same corpus
    mem = InMemoryStore(embeds)
    ranges, lo = [], LIVE_CALIB
    for size in LIVE_GROUPS + live_tail_groups(n):
        ranges.append((lo, lo + size))
        lo += size
    seen = {}
    plain_call = s_ops.fused_scores_multi

    def spy(docs, w1, b1, w2, b2, w3, b3, zq):
        kind = fused_instantiation(docs, w1, w2, w3)
        seen[kind] = seen.get(kind, 0) + 1
        return plain_call(docs, w1, b1, w2, b2, w3, b3, zq)

    equal = {False: True, True: True}
    tp = time.perf_counter()
    s_ops.fused_scores_multi = spy
    try:
        for ls in scorable:
            full, _ = _score_rows(executor, ls.params, ls.e_q, mem, 0, n,
                                  pad=False)
            for lo, hi in ranges:
                for pad in (False, True):
                    got, _ = _score_rows(executor, ls.params, ls.e_q, mem,
                                         lo, hi, pad=pad)
                    equal[pad] &= bool(np.array_equal(got, full[lo:hi]))
    finally:
        s_ops.fused_scores_multi = plain_call
    # the two instantiations on the same rows: the last ragged group's
    # 8193 rows, aligned and 4 bytes off 16-byte alignment
    ls = scorable[0]
    w = s_ops._unpack(ls.params)
    zq = s_ops.normalized_query_latents(ls.params, torch.as_tensor(
        np.asarray(ls.e_q, np.float32), device=dev))
    lo, hi = ranges[len(LIVE_GROUPS) - 1]
    rows = torch.as_tensor(embeds[lo:hi], device=dev)
    buf = torch.empty(rows.numel() + 1, device=dev)
    off = buf[1:].view(rows.shape)
    off.copy_(rows)
    kinds = (fused_instantiation(rows, w[0], w[2], w[4]),
             fused_instantiation(off, w[0], w[2], w[4]))
    split_equal = bool(torch.equal(s_ops.fused_scores_multi(rows, *w, zq),
                                   s_ops.fused_scores_multi(off, *w, zq)))
    probe_s = time.perf_counter() - tp
    card_pad = dev.type in PAD_DEVICE_TYPES
    out["probe"] = {"ranges": ranges, "unpadded_equal": equal[False],
                    "padded_equal": equal[True], "instantiations": seen,
                    "split": {"kinds": kinds, "equal": split_equal},
                    "card_rule_pads": card_pad, "seconds": probe_s}
    log(f"[live] row-locality probe ({len(scorable)} scorable leaves, "
        f"{len(ranges)} delta ranges {ranges}, each against one pass over "
        f"all {n} rows): unpadded bitwise equal {equal[False]}, padded to "
        f"the chunk ({executor.chunk}) bitwise equal {equal[True]}; "
        f"instantiations launched by the executor {json.dumps(seen)}; "
        f"rows {lo}..{hi} through the {kinds[0]} and the {kinds[1]} "
        f"instantiation: bitwise equal {split_equal}; the port pads on "
        f"{PAD_DEVICE_TYPES}, so on the card it scores delta tiles "
        f"{'padded' if card_pad else 'unpadded'}; {probe_s:.2f} s")
    if not equal[card_pad]:
        bad.append(f"delta scores through the card's rule (pad={card_pad})"
                   f" differ from one full pass")
    if set(seen) != {"16-byte"}:
        bad.append(f"the executor launched instantiations {seen}")

    # 2. the ragged commit groups, one pump each
    tracer = live.tracer
    pumps = []
    hi = LIVE_CALIB
    for size in LIVE_GROUPS:
        writer.append(embeds[hi:hi + size])
        writer.commit()
        hi += size
        l0 = s_ops.KERNEL.launches
        t0 = sp.scoring_stats.tiles_scored
        calls0 = sp.oracle_calls_delta
        tq = time.perf_counter()
        watermark = live.pump()
        secs = time.perf_counter() - tq
        row = {"rows": size, "watermark": watermark, "seconds": secs,
               "rows_per_second": size / secs,
               "launches": s_ops.KERNEL.launches - l0,
               "tiles_scored": sp.scoring_stats.tiles_scored - t0,
               "expected_tiles": len(scorable) * -(-size
                                                   // executor.chunk),
               "oracle_calls": sp.oracle_calls_delta - calls0}
        pumps.append(row)
        if watermark != hi:
            bad.append(f"pump after {size} rows: watermark {watermark}, "
                       f"not {hi}")
        if not row["launches"] == row["tiles_scored"] \
                == row["expected_tiles"]:
            bad.append(f"pump of {size} rows: {row['launches']} fused "
                       f"launches, {row['tiles_scored']} tiles scored, "
                       f"{row['expected_tiles']} expected")
    log("[live] pumps: " + "; ".join(
        f"{r['rows']} rows in {r['seconds']:.4f} s ({r['rows_per_second']:.0f}"
        f" rows/s, {r['launches']} fused launches for {r['tiles_scored']} "
        f"tiles, {r['oracle_calls']} oracle calls)" for r in pumps))
    if sp.scoring_stats.paths != ("fused",):
        bad.append(f"delta scoring ran paths {sp.scoring_stats.paths}")
    out["pumps"] = pumps
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[live] first part {out['phase_seconds']:.1f} s")
    if bad:
        fail("live: " + "; ".join(bad))
    # what [gateway] and the phase's last gates take over
    return out, SimpleNamespace(writer=writer, live=live, sp=sp, sub=sub,
                                tracer=tracer, pcfg=pcfg, ccfg=ccfg,
                                n_scorable=len(scorable))


def live_tail_groups(n: int) -> tuple:
    """[gateway]'s commit groups: LIVE_TAIL_GROUP rows each, the last
    one ragged, from the end of the ragged groups to n."""
    lo = LIVE_CALIB + sum(LIVE_GROUPS)
    return tuple(min(LIVE_TAIL_GROUP, n - s)
                 for s in range(lo, n, LIVE_TAIL_GROUP))


def gateway_trace_faults(spans) -> list:
    """What is wrong with one session's trace over the gateway: one root
    (the gateway's request span) over gateway, server, engine and broker
    spans, every span closed and parented inside the trace."""
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans if s["parent_id"] not in ids]
    kinds = {s["attrs"].get("kind") for s in spans}
    bad = []
    if [s["name"] for s in roots] != ["gateway.request"]:
        bad.append(f"roots {[s['name'] for s in roots]}")
    if not {"gateway", "server", "engine"} <= kinds:
        bad.append(f"span kinds {sorted(k for k in kinds if k)}")
    if not any(s["name"] == "broker.request" for s in spans):
        bad.append("no broker.request span")
    for s in spans:
        if s["end"] < s["start"]:
            bad.append(f"{s['name']} ends before it starts")
    return bad


def gateway_phase(dev, embeds, queries, refs, run, serve_arm) -> dict:
    """Phase 11: the [serve] workload over HTTP. A PredicateGateway on
    127.0.0.1 (port 0, two tenants) over PredicateServer(workers=4) with
    [live]'s LiveEngine as its live plane; four GatewayClients in four
    threads submit the [serve] sessions as wire predicates over fresh
    CachedOracles, while a standing p1 subscribed over HTTP follows the
    store through the last commit groups, pumped from another thread
    (``refs``: session name -> (mask, calls, wall) of the serial runs of
    phases 4 and 6; ``serve_arm``: [serve]'s in-process arm). Every gate
    is checked and logged; the phase fails after the last."""
    import threading

    import numpy as np
    from repro_torch.core.oracle import CachedOracle, SimulatedOracle
    from repro_torch.engine import (InMemoryStore, ScaleDocEngine,
                                    SemanticPredicate)
    from repro_torch.gateway import GatewayClient, PredicateGateway, Tenant
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.fused_scoring import ops as s_ops
    from repro_torch.serve import PredicateServer
    n = embeds.shape[0]
    bad = []
    out = {}
    t_phase = time.perf_counter()
    live = run.live
    sims = [CountingOracle(SimulatedOracle(q.truth)) for q in queries]
    cached = [CachedOracle(o) for o in sims]
    p = [SemanticPredicate(q.embed, c, name=f"p{i + 1}")
         for i, (q, c) in enumerate(zip(queries, cached))]
    oracles = {f"o{i + 1}": c for i, c in enumerate(cached)}
    standing_oracle = CachedOracle(SimulatedOracle(queries[0].truth))
    oracles["s1"] = standing_oracle
    standing_pred = SemanticPredicate(queries[0].embed, standing_oracle,
                                      name="p1")
    forms = [("p1", p[0], 0), ("p1 & ~p2", p[0] & ~p[1], 0),
             ("p2 | p3", p[1] | p[2], 1), ("p3", p[2], 0)]
    wires = [(name, pred.to_wire(oracles), seed)
             for name, pred, seed in forms]
    # the sessions' engine holds the N rows of phases 4 and 6; the live
    # plane's store grows under it. One executor: every thread launches
    # through the same staging pool onto the same stream
    engine = ScaleDocEngine(InMemoryStore(embeds), run.pcfg, run.ccfg,
                            executor=live.engine.executor, device=dev)
    tenants = [Tenant("t0", "k-0"), Tenant("t1", "k-1")]
    tail = live_tail_groups(n)
    results, errors, events, pumps = {}, [], [], []
    subscribed = threading.Event()
    standing = {}
    s_ops.KERNEL.launches = 0
    c_ops.KERNEL.launches = 0
    with PredicateServer(engine, workers=4, live=live,
                         trace_capacity=1 << 16) as server:
        with PredicateGateway(server, oracles, tenants=tenants) as gw:
            clients = [GatewayClient(gw.url, api_key=f"k-{i % 2}",
                                     timeout=120) for i in range(4)]

            def session(i):
                name, wire, seed = wires[i]
                try:
                    sub = clients[i].submit(wire, seed=seed, name=name)
                    res = clients[i].wait(sub["id"], timeout=900,
                                          interval=1.0)
                    results[name] = (sub, res, time.perf_counter())
                except Exception as exc:    # surfaced after the joins
                    errors.append((name, exc))

            def follow():
                try:
                    tr = time.perf_counter()
                    sub = clients[0].subscribe_standing(
                        standing_pred, oracles=oracles, seed=0,
                        name="standing p1")
                    standing["register_seconds"] = time.perf_counter() - tr
                    standing["sub"] = sub
                    standing["sp"] = live.get(sub["id"])
                    subscribed.set()
                    events.extend(clients[0].iter_standing(sub["id"],
                                                           timeout=900))
                except Exception as exc:
                    errors.append(("standing", exc))
                    subscribed.set()

            def pump():
                subscribed.wait(timeout=900)
                hi = LIVE_CALIB + sum(LIVE_GROUPS)
                try:
                    for size in tail:
                        run.writer.append(embeds[hi:hi + size])
                        run.writer.commit()
                        hi += size
                        tq = time.perf_counter()
                        live.pump()
                        pumps.append({"rows": size, "watermark": hi,
                                      "seconds": time.perf_counter() - tq})
                except Exception as exc:
                    errors.append(("pump", exc))

            t0 = time.perf_counter()
            threads = [threading.Thread(target=session, args=(i,))
                       for i in range(4)]
            threads += [threading.Thread(target=pump)]
            follower = threading.Thread(target=follow)
            for t in threads + [follower]:
                t.start()
            for t in threads:
                t.join(timeout=900)
            makespan = max((r[2] for r in results.values()),
                           default=time.perf_counter()) - t0
            sid = standing.get("sub", {}).get("id")
            decisions = (standing["sp"].decisions
                         if standing.get("sp") is not None else None)
            if sid is not None:
                clients[0].cancel_standing(sid)
            follower.join(timeout=120)
            launches = {"fused_scoring": s_ops.KERNEL.launches,
                        "contrastive": c_ops.KERNEL.launches}
            explains = {name: clients[i].explain(results[name][0]["id"],
                                                 include_docs=False)
                        for i, (name, _, _) in enumerate(wires)
                        if name in results}
            traces = {name: server.tracer.spans(results[name][0]["trace_id"])
                      for name, _, _ in wires if name in results}
            metrics = clients[0].metrics()
    if errors:
        fail("gateway: " + "; ".join(f"{k}: {type(e).__name__}: {e}"
                                     for k, e in errors))
    latency = metrics["observations"]["session_latency_seconds"]
    bought = sum(o.calls for o in sims)
    twice = sum(1 for o in sims for v in o.per_doc.values() if v > 1)
    ledger = metrics["cost_ledger"]["tenants"]
    ledger_docs = sum(t["oracle_docs"] for t in ledger.values())
    rows = {}
    for name, _, _ in wires:
        sub, res, _ = results[name]
        mask = np.zeros(n, bool)
        mask[np.asarray(res["accepted"], np.int64)] = True
        ex = explains[name]
        rows[name] = {
            "tenant": sub["tenant"], "state": res["state"],
            "plan": res["plan"], "oracle_calls": res["oracle_calls_total"],
            "mask_equal_serial": bool(np.array_equal(mask, refs[name][0])),
            "explain_complete": ex["complete"],
            "explain_docs": sum(ex["counts"].values()),
            "trace_faults": gateway_trace_faults(traces[name])}
    # the standing stream, replayed as a subscriber must
    sub = standing["sub"]
    calib = sub["calib_rows"]
    deltas = [e for e in events if not e["final"]]
    replay = np.zeros(n, bool)
    for e in deltas:
        replay[np.asarray(e["accepted"], np.int64)] = True
    spans = [s for s in server.tracer.spans() if s["name"] in (
        "live.pump", "live.delta")]
    out.update({
        "makespan_seconds": makespan,
        "serve_makespan_seconds": serve_arm["makespan_seconds"],
        "latency_p50_seconds": latency["p50"],
        "latency_p95_seconds": latency["p95"],
        "serve_latency_p50_seconds": serve_arm["latency_p50_seconds"],
        "serve_latency_p95_seconds": serve_arm["latency_p95_seconds"],
        "sessions": rows, "docs_bought": bought, "docs_bought_twice": twice,
        "ledger_tenants": ledger, "ledger_oracle_docs": ledger_docs,
        "cache_docs_purchased": metrics["oracle_cache"]["docs_purchased"],
        "launches": launches, "pumps": pumps,
        "standing": {"calib_rows": calib,
                     "register_seconds": standing["register_seconds"],
                     "batches": [(e["lo"], e["hi"]) for e in deltas],
                     "done_event": bool(events and events[-1]["final"])},
        "live_spans": [{k: s[k] for k in ("name", "start", "end")}
                       | {"attrs": s["attrs"]} for s in spans],
        "gateway_counters": {k: v for k, v in metrics["counters"].items()
                             if k.startswith(("gateway", "tenant"))}})
    log(f"[gateway] four GatewayClients (tenants t0, t1) through "
        f"PredicateGateway on {gw.url} over PredicateServer(workers=4, "
        f"live=[live]'s LiveEngine): makespan {makespan:.3f} s against "
        f"[serve]'s in-process {serve_arm['makespan_seconds']:.3f} s; "
        f"session latency p50 {latency['p50']:.3f} s, p95 "
        f"{latency['p95']:.3f} s (in-process "
        f"{serve_arm['latency_p50_seconds']:.3f}, "
        f"{serve_arm['latency_p95_seconds']:.3f}); {bought} documents "
        f"bought ({twice} twice); ledger {json.dumps(ledger)}; cache "
        f"{metrics['oracle_cache']['docs_purchased']}; launches "
        f"{launches}; per session " + json.dumps(
            {k: {kk: vv for kk, vv in v.items() if kk != "trace_faults"}
             for k, v in rows.items()}))
    log(f"[gateway] standing p1 subscribed over HTTP at watermark {calib} "
        f"in {standing['register_seconds']:.3f} s; the pumping thread "
        f"landed " + ", ".join(f"{r['rows']} rows ({r['seconds']:.4f} s)"
                               for r in pumps)
        + f"; SSE batches {out['standing']['batches']}, done event "
        f"{out['standing']['done_event']}")
    for name, r in rows.items():
        if r["state"] != "done":
            bad.append(f"{name}: state {r['state']}")
        if not r["mask_equal_serial"]:
            bad.append(f"{name}: the mask over the wire differs from its "
                       f"serial run's")
        if not (r["explain_complete"] and r["explain_docs"] == n):
            bad.append(f"{name}: /explain classified {r['explain_docs']} "
                       f"of {n} documents (complete "
                       f"{r['explain_complete']})")
        if r["trace_faults"]:
            bad.append(f"{name}: trace {r['trace_faults']}")
    if set(ledger) != {"t0", "t1"} or ledger_docs != bought \
            or metrics["oracle_cache"]["docs_purchased"] != bought:
        bad.append(f"the ledger's tenants {sorted(ledger)} and "
                   f"{ledger_docs} documents, the caches' "
                   f"{metrics['oracle_cache']['docs_purchased']} and the "
                   f"oracles' {bought} disagree")
    if twice:
        bad.append(f"{twice} documents bought twice")
    want = [(lo, lo + size) for lo, size in zip(
        np.cumsum((calib,) + tail[:-1]), tail)]
    if out["standing"]["batches"] != [(int(a), int(b)) for a, b in want]:
        bad.append(f"standing batches {out['standing']['batches']}, not "
                   f"{want}")
    if decisions is None or not np.array_equal(replay[calib:],
                                               decisions[calib:]):
        bad.append("the SSE stream's replayed decisions differ from the "
                   "standing predicate's")
    if not out["standing"]["done_event"]:
        bad.append("the standing stream did not end with a done event")
    if calib != LIVE_CALIB + sum(LIVE_GROUPS):
        bad.append(f"standing p1 calibrated at {calib}")
    if min(launches.values()) <= 0:
        bad.append(f"launches {launches}")
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[gateway] phase time {out['phase_seconds']:.1f} s")
    if bad:
        fail("gateway: " + "; ".join(bad))
    return out


def live_finish(dev, embeds, queries, run, and_not_mask, and_not_calls,
                out) -> dict:
    """Phase 10, last part, after [gateway] landed the tail groups: the
    subscriber's stream, the scored-row counters, the decisions against
    standing_filter(calib_rows=LIVE_CALIB) over the final store, and
    after revalidate() against phase 6's fresh filter() of p1 & ~p2
    (``and_not_mask``, ``and_not_calls``). The store is deleted."""
    import shutil

    import numpy as np
    from repro_torch.core.oracle import SimulatedOracle
    from repro_torch.engine import (MemmapStore, SemanticPredicate,
                                    standing_filter)
    from repro_torch.kernels.contrastive import ops as c_ops
    from repro_torch.kernels.fused_scoring import ops as s_ops
    n = embeds.shape[0]
    bad = []
    t_phase = time.perf_counter()
    run.writer.close()
    live, sp = run.live, run.sp
    batches = []
    while True:
        try:
            batches.append(run.sub.get(timeout=0))
        except TimeoutError:
            break
    spans = {}
    for s in run.tracer.spans():
        spans.setdefault(s["name"], []).append(s["end"] - s["start"])
    lo, gaps = LIVE_CALIB, []
    for b in batches:
        if b.lo != lo:
            gaps.append((lo, b.lo))
        lo = b.hi
        if b.rows_scored != (b.hi - b.lo) * run.n_scorable:
            bad.append(f"batch [{b.lo}, {b.hi}): rows_scored "
                       f"{b.rows_scored}, not {(b.hi - b.lo)} x "
                       f"{run.n_scorable}")
    if gaps or lo != n:
        bad.append(f"the subscriber's stream has gaps {gaps} and ends at "
                   f"{lo}, not {n}")
    out["batches"] = [(b.lo, b.hi, b.rows_scored, b.oracle_calls)
                      for b in batches]
    out["delta_oracle_calls"] = sp.oracle_calls_delta
    out["span_seconds"] = spans

    s_ops.KERNEL.launches = 0
    c_ops.KERNEL.launches = 0
    tr = time.perf_counter()
    fresh = [SemanticPredicate(q.embed, SimulatedOracle(q.truth),
                               name=f"p{i + 1}")
             for i, q in enumerate(queries[:2])]
    ref = standing_filter(MemmapStore.open(LIVE_DIR), fresh[0] & ~fresh[1],
                          seed=0, calib_rows=LIVE_CALIB,
                          proxy_cfg=run.pcfg, cascade_cfg=run.ccfg,
                          executor=live.engine.executor, device=dev)
    ref_s = time.perf_counter() - tr
    one_shot = bool(np.array_equal(sp.decisions, ref.decisions))
    tv = time.perf_counter()
    calls0 = sp.calibration_oracle_calls
    batch = sp.revalidate()
    reval_s = time.perf_counter() - tv
    reval_calls = sp.calibration_oracle_calls - calls0
    fresh_equal = bool(np.array_equal(sp.decisions, and_not_mask))
    launches = {"fused_scoring": s_ops.KERNEL.launches,
                "contrastive": c_ops.KERNEL.launches}
    out.update({"standing_filter_seconds": ref_s,
                "standing_filter_equal": one_shot,
                "revalidate_seconds": reval_s,
                "revalidate_oracle_calls": reval_calls,
                "revalidated_equal_fresh_filter": fresh_equal,
                "finish_launches": launches})
    log(f"[live] the subscriber's {len(batches)} batches "
        f"{[(b.lo, b.hi) for b in batches]}: contiguous from {LIVE_CALIB} "
        f"to {lo}; rows_scored per batch (hi - lo) x {run.n_scorable}; "
        f"delta oracle calls {sp.oracle_calls_delta} over "
        f"{n - LIVE_CALIB} rows (registration {out['register_oracle_calls']}"
        f"; a full filter() of the final store, phase 6: {and_not_calls}); "
        f"live.* spans (s): " + json.dumps(
            {k: [round(v, 6) for v in vs] for k, vs in spans.items()}))
    log(f"[live] decisions bitwise standing_filter(calib_rows={LIVE_CALIB})"
        f" over the final store: {one_shot} ({ref_s:.3f} s); after "
        f"revalidate() ({reval_s:.3f} s, {reval_calls} oracle calls, "
        f"{batch.rows_scored} rows scored) bitwise phase 6's p1 & ~p2: "
        f"{fresh_equal}; launches {launches}")
    if not one_shot:
        bad.append("decisions differ from standing_filter over the final "
                   "store")
    if not fresh_equal:
        bad.append("revalidated decisions differ from phase 6's filter()")
    if min(launches.values()) <= 0:
        bad.append(f"launches {launches}")
    shutil.rmtree(LIVE_DIR, ignore_errors=True)
    out["finish_seconds"] = time.perf_counter() - t_phase
    out["phase_seconds"] += out["finish_seconds"]
    log(f"[live] last part {out['finish_seconds']:.1f} s; phase time "
        f"{out['phase_seconds']:.1f} s")
    if bad:
        fail("live: " + "; ".join(bad))
    return out


def ablation_phase(dev, embeds, query, n_tiles) -> dict:
    """Phase 12: the five training variants of the paper's Fig. 9 on p1
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


def configs_phase(dev) -> dict:
    """[configs]: CONFIGS_ARCHS at FULL width with random bf16 weights
    drawn on the card, one after the other: one embedding batch through
    the kernel path against attn_impl="blocked" (per-row cosine >=
    COS_MIN, flash launched once a layer), for a model with a vision
    frontend also ``hidden`` over float patch embeddings (mean-pooled
    rows, the same bar), and generate of CONFIGS_STEPS tokens bitwise a
    hand-rolled prefill + decode_step loop; init seconds, ms a batch and
    peak memory. Each gate is checked as it comes."""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.config import get_arch
    from repro_torch.core.encoder import tree_leaves
    from repro_torch.data import make_corpus
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_loop import EmbeddingService, generate

    t_phase = time.perf_counter()
    corpus = make_corpus(0, n_docs=CONFIGS_BATCH, dim=128, with_tokens=True,
                         vocab=OFF_VOCAB, doc_len=OFF_DOC_LEN)
    tokens = torch.as_tensor(np.stack([corpus.tokens[i] for i in range(
        CONFIGS_BATCH)]).astype(np.int32), device=dev)
    out = {}
    for arch in CONFIGS_ARCHS:
        cfg = get_arch(arch)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params))
        service = EmbeddingService(cfg, params, batch_size=CONFIGS_BATCH,
                                   device=dev)
        plain = EmbeddingService(cfg, params, batch_size=CONFIGS_BATCH,
                                 device=dev, attn_impl="blocked")
        kernels = zero_counts()
        got = service.embed_batch(tokens)
        torch.cuda.synchronize()
        counts = read_counts(kernels)
        want = plain.embed_batch(tokens)
        cos = F.cosine_similarity(got, want, dim=1).min().item()
        batch_ms = cuda_ms(lambda: service.embed_batch(tokens), 5, warmup=1)
        row = {"params": n_params, "init_seconds": init_s,
               "embed_launches": counts, "pooled_min_cosine": cos,
               "embed_batch_ms": batch_ms}
        log(f"[configs] {cfg.name}: {cfg.num_layers} layers, d="
            f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} "
            f"KV heads (head_dim {cfg.head_dim}), vocab {cfg.vocab_size} "
            f"(padded {cfg.padded_vocab_size}), tied head "
            f"{cfg.tie_embeddings}, {n_params / 1e9:.3f} B params drawn on "
            f"the card in {init_s:.1f} s; a batch of {CONFIGS_BATCH} x "
            f"{OFF_DOC_LEN} tokens {batch_ms:.2f} ms; kernel path vs "
            f"attn_impl='blocked': min per-row cosine {cos:.6f} (>= "
            f"{COS_MIN}); launches {json.dumps(counts)}")
        if counts["flash_attention"] != cfg.num_layers or \
                not torch.isfinite(got).all():
            fail(f"[configs] {cfg.name}: flash launched "
                 f"{counts['flash_attention']} times for one batch")
        if not cos >= COS_MIN:
            fail(f"[configs] {cfg.name}: the kernel path's embeddings "
                 f"disagree with the blocked path")
        if cfg.frontend == "vision":
            patches = torch.randn(
                (CONFIGS_BATCH, CONFIGS_PATCHES, cfg.d_model),
                generator=torch.Generator(dev).manual_seed(2), device=dev)
            kernels = zero_counts()
            h_got = service.model.hidden(params, patches)
            torch.cuda.synchronize()
            p_counts = read_counts(kernels)
            h_want = plain.model.hidden(params, patches)
            p_cos = F.cosine_similarity(h_got.float().mean(1),
                                        h_want.float().mean(1),
                                        dim=1).min().item()
            row.update(patch_launches=p_counts, patch_min_cosine=p_cos)
            log(f"[configs] {cfg.name}: hidden over float patch embeddings "
                f"({CONFIGS_BATCH}, {CONFIGS_PATCHES}, {cfg.d_model}), "
                f"the stubbed vision frontend: finite "
                f"{bool(torch.isfinite(h_got).all())}, mean-pooled rows vs "
                f"the blocked path min cosine {p_cos:.6f} (>= {COS_MIN}); "
                f"launches {json.dumps(p_counts)}")
            if p_counts["flash_attention"] != cfg.num_layers or \
                    not torch.isfinite(h_got).all() or not p_cos >= COS_MIN:
                fail(f"[configs] {cfg.name}: the patch-embedding path "
                     f"failed")
            del patches, h_got, h_want
        model = service.model
        s = tokens.shape[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = generate(model, params, tokens, CONFIGS_STEPS)
        gen_s = time.perf_counter() - t0
        logits, cache = model.prefill(params, tokens,
                                      cache_len=s + CONFIGS_STEPS)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        manual = [tok]
        for t in range(1, CONFIGS_STEPS):
            logits, cache = model.decode_step(params, tok, s + t - 1, cache)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            manual.append(tok)
        same = bool(np.array_equal(gen, torch.cat(manual, 1).cpu().numpy()))
        del logits, cache, manual
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        row.update(generate_seconds=gen_s, generate_equals_loop=same,
                   peak_memory_gb=peak)
        log(f"[configs] {cfg.name}: generate of {CONFIGS_STEPS} tokens for "
            f"{CONFIGS_BATCH} prompts in {gen_s:.3f} s, tokens bitwise the "
            f"hand-rolled loop's: {same}; peak {peak:.2f} GB")
        if not same:
            fail(f"[configs] {cfg.name}: generate() differs from prefill + "
                 f"decode_step")
        out[cfg.name] = row
        del params, service, plain, model, got, want
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[configs] phase took {out['phase_seconds']:.1f} s")
    return out


def zamba2_phase(dev, kernels: list, f_errs: dict) -> dict:
    """[zamba2] with every earlier model's weights freed: the offline
    path over zamba2-2.7b FULL (offline_phase, then [decode]); then the
    bf16 flash kernel at its shape (head_dim 80 on the hd-128
    instantiation: its time beside the same call at hd 128, the bound at
    hd 80, SDPA and its share of a batch) and fused scoring on the
    query's (256, 2560) tile, appended to ``kernels``."""
    import gc

    import torch
    from repro_torch.kernels.flash_attention import ops as f_ops
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 1e9
    log(f"[zamba2] after freeing the qwen3-moe-30b-a3b weights: {held:.3f} "
        f"GB allocated")
    if held > 1.0:
        fail(f"{held:.2f} GB still allocated before the zamba2 phase")
    zamba, service, _ = offline_phase(
        dev, ZAMBA_ARCH, "flash_attention", dict(attn_impl="blocked"),
        "zamba2", COS_MIN, after=(decode,), n_docs=ZAMBA_DOCS,
        doc_len=GEMMA_DOC_LEN, batch_size=ZAMBA_BATCH, resume=GEMMA_RESUME)
    cfg = service.cfg
    del service
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[zamba2] {cfg.name}: {zamba['params']} params drawn "
        f"({zamba['param_bytes'] / 1e9:.3f} GB; param_count() "
        f"{cfg.param_count()}, which counts B and C once a head); "
        f"from_corpus {zamba['wall_seconds']:.2f} s, "
        f"{zamba['tokens_per_second']:.0f} tokens/s, a batch "
        f"{zamba['embed_batch_ms']:.2f} ms, digest "
        f"{zamba['digest_seconds']:.1f} s, peak "
        f"{zamba['ingest_stats']['peak_memory_gb']:.2f} GB; cosine against "
        f"the blocked path {zamba['pooled_min_cosine']:.6f}; decode "
        f"{zamba['decode']['decode_ms_per_step']:.2f} ms a step; phase "
        f"{zamba['phase_seconds']:.1f} s")

    # flash at zamba2's shape: hd 80 on the hd-128 instantiation
    ft = flash_times(dev, ZAMBA_FLASH_SHAPE)
    b, s, h, kv, hd = ZAMBA_FLASH_SHAPE
    gen = torch.Generator(dev).manual_seed(1)
    q, k, v = (torch.randn((b, s, n, 128), generator=gen, device=dev,
                           dtype=torch.bfloat16) for n in (h, kv, kv))
    ft["hd128_ms"] = cuda_ms(lambda: f_ops.flash_attention_fwd(
        q, k, v, scale=hd ** -0.5), 50)
    del q, k, v
    ft["share_of_embed_batch"] = share = zamba["launches"] \
        / zamba["batches"] * ft["ms"] / zamba["embed_batch_ms"]
    hd80 = [e for name, e in f_errs.items() if "hd80" in name]
    kernels.append(
        {"name": "flash_attention_hd80", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash.py:101",
         "launches": zamba["launches"], "max_abs_err": max(hd80),
         "ms": ft["ms"], "plain_ms": ft["plain_ms"],
         "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
         "library_ms": ft["library_ms"]})
    sdpa = ", ".join(f"{n} {t:.4f} ms" if isinstance(t, float) else
                     f"{n} {t}" for n, t in ft["sdpa"].items())
    log(f"[times] flash_attention_hd80 at {tuple(ZAMBA_FLASH_SHAPE)} (the "
        f"hd-128 instantiation): bf16 tensor-core kernel {ft['ms']:.4f} ms "
        f"({ft['ms'] / ft['bound_ms']:.2f}x its bound at hd 80; "
        f"{ft['flops'] / ft['ms'] / 1e9:.1f} TFLOP/s counted at hd 80), "
        f"the same call at hd 128 {ft['hd128_ms']:.4f} ms (hd 80 takes "
        f"{ft['ms'] / ft['hd128_ms']:.3f} of it; 80/128 = 0.625), "
        f"non-causal {ft['noncausal_ms']:.4f} ms, FP32 kernel on the same "
        f"inputs in f32 {ft['fp32_kernel_ms']:.4f} ms, plain "
        f"{ft['plain_ms']:.4f} ms, bound {ft['bound_ms']:.5f} ms "
        f"({ft['bound_by']}; {ft['flops']:.4g} FLOP, {ft['bytes']:.4g} B), "
        f"{zamba['launches']} launches per from_corpus; SDPA: {sdpa}; one "
        f"zamba2-2.7b batch {zamba['embed_batch_ms']:.2f} ms, of which "
        f"flash {100 * share:.1f}%")
    fs = fused_times(dev, ZAMBA_DOCS, cfg.d_model)
    if not fs["max_abs_err"] <= F32_TOL:
        fail(f"fused_scoring at D={cfg.d_model} disagrees with its plain "
             f"version: {fs['max_abs_err']}")
    kernels.append(
        {"name": "fused_scoring_d2560", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_scoring.cu",
         "replaces": "src/repro/kernels/fused_scoring/scoring.py:138",
         "launches": zamba["query"]["launches"]["fused_scoring"],
         "max_abs_err": fs["max_abs_err"], "ms": fs["ms"],
         "plain_ms": fs["plain_ms"], "bound_ms": fs["bound_ms"],
         "bound_by": fs["bound_by"], "library_ms": None})
    log(f"[times] fused_scoring_d2560 at (n={fs['n']}, D={fs['d']}, H=512, "
        f"L=128, Q=1), the [zamba2] query's tile: {fs['ms']:.4f} ms, plain "
        f"{fs['plain_ms']:.4f} ms, bound {fs['bound_ms']:.5f} ms "
        f"({fs['bound_by']}), max abs err {fs['max_abs_err']:.3e}; "
        f"{zamba['query']['launches']['fused_scoring']} launches in the "
        f"query")
    zamba["times"] = {"flash_hd80": ft, "fused_d2560": fs}
    return zamba


def encoder_drift(kernel_model, plain_model, params, frames) -> dict:
    """The encoder's layers run by hand on both attention paths: each
    layer's attention on the kernel path's own input through the flash
    kernel and through the blocked path (min per-row cosine, max abs
    difference), and the per-row cosine of the two paths' states after
    each layer, each path fed its own (the drift with depth)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import attention as attn
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models.common import rmsnorm_apply, tree_map
    cfg = kernel_model.cfg
    x = kernel_model._with_positions(frames.to(torch.bfloat16))
    y = x.clone()
    positions = torch.arange(x.shape[1], device=x.device)

    def attend(p, h, impl):
        return attn.attn_apply(p["attn"], h, cfg, positions=positions,
                               causal=False, impl=impl, use_rope=False)[0]

    def rows_cos(a, b):
        return F.cosine_similarity(a.float().reshape(-1, a.shape[-1]),
                                   b.float().reshape(-1, b.shape[-1]),
                                   dim=1).min().item()
    layers, drift = [], []
    with torch.inference_mode():
        for i in range(cfg.encoder_layers):
            p = tree_map(lambda t: t[i], params["encoder"])
            h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
            got = attend(p, h, kernel_model.attn_impl)
            want = attend(p, h, plain_model.attn_impl)
            layers.append({"min_cosine": rows_cos(got, want),
                           "max_abs_err": (got.float() - want.float())
                           .abs().max().item()})
            x = x + got
            x = x + mlp_mod.mlp_apply(
                p["mlp"], rmsnorm_apply(p["norm2"], x, cfg.norm_eps), cfg)
            h = rmsnorm_apply(p["norm1"], y, cfg.norm_eps)
            y = y + attend(p, h, plain_model.attn_impl)
            y = y + mlp_mod.mlp_apply(
                p["mlp"], rmsnorm_apply(p["norm2"], y, cfg.norm_eps), cfg)
            drift.append(rows_cos(x, y))
    return {"layer": layers, "drift_min_cosine": drift}


def whisper_phase(dev, kernels: list, f_errs: dict) -> dict:
    """[whisper] with every earlier model's weights freed: whisper-base
    FULL on one batch of WHISPER_CLIPS clips (forward on both attention
    paths, the encoder's per-layer check, encode / forward / prefill /
    decode times, f32 decode against the forward at full depth); then
    the bf16 flash kernel at its encoder, cross- and self-attention
    shapes, appended to ``kernels``."""
    import dataclasses
    import gc

    import torch
    import torch.nn.functional as F
    from repro_torch.config import get_arch
    from repro_torch.core.encoder import tree_leaves
    from repro_torch.models import EncDecLM
    from repro_torch.models.common import tree_map

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 1e9
    log(f"[whisper] after freeing the zamba2-2.7b weights: {held:.3f} GB "
        f"allocated")
    if held > 1.0:
        fail(f"{held:.2f} GB still allocated before the whisper phase")
    cfg = get_arch(WHISPER_ARCH)
    v, d, L = cfg.vocab_size, cfg.d_model, cfg.num_layers
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = EncDecLM(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"[whisper] {cfg.name}: {cfg.encoder_layers} encoder and {L} "
        f"decoder layers, d={d}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads} (head_dim {cfg.head_dim}), d_ff {cfg.d_ff}, "
        f"vocab {v} (padded {cfg.padded_vocab_size}); {n_params} params "
        f"drawn on the card ({n_bytes / 1e9:.3f} GB {cfg.dtype}) in "
        f"{init_s:.2f} s; param_count() {cfg.param_count()}")
    plain = EncDecLM(cfg, attn_impl="blocked")
    gen = torch.Generator(dev).manual_seed(1)
    b, nf, nt = WHISPER_CLIPS, WHISPER_FRAMES, WHISPER_TOKENS
    frames = torch.randn((b, nf, d), generator=gen, device=dev)
    tokens = torch.randint(1, v, (b, nt), generator=gen, device=dev)

    # -- teacher-forced forward, kernel path against the blocked path
    counts = {}
    forms = {}
    outs = {}
    for name, m in (("flash", model), ("blocked", plain)):
        kern = zero_counts()
        with AttentionCalls() as calls:
            outs[name], aux = m.forward(params, frames, tokens)
        torch.cuda.synchronize()
        counts[name], forms[name] = read_counts(kern), calls.by_form
        if aux.item() != 0.0:
            fail(f"[whisper] the {name} forward's aux is {aux.item()}")
    got, want = outs["flash"], outs["blocked"]
    del outs
    finite = bool(torch.isfinite(got[..., :v]).all())
    padded_ok = bool((got[..., v:] == -1e30).all())
    cos = F.cosine_similarity(got[..., :v], want[..., :v],
                              dim=-1).min().item()
    diff = (got[..., :v] - want[..., :v]).abs().max().item()
    scale = want[..., :v].abs().max().item()
    del got, want
    log(f"[whisper] forward over {b} clips of {nf} frames and {nt} tokens: "
        f"flash launches {counts['flash']['flash_attention']} on the "
        f"kernel path (by form {json.dumps(forms['flash'])}), "
        f"{counts['blocked']['flash_attention']} on attn_impl='blocked' "
        f"(by form {json.dumps(forms['blocked'])}); logits finite "
        f"{finite}, padded ids at -1e30 {padded_ok}; kernel vs blocked "
        f"path: min per-(clip, position) cosine {cos:.6f} (>= {COS_MIN}), "
        f"max |diff| {diff:.4e} of max |logit| {scale:.4e}")
    if counts["flash"]["flash_attention"] != 3 * L or \
            sum(forms["flash"].values()) != 3 * L:
        fail(f"[whisper] flash launched "
             f"{counts['flash']['flash_attention']} times in the kernel "
             f"path's forward; expected {3 * L}")
    if counts["blocked"]["flash_attention"] != L or \
            list(forms["blocked"]) != [f"non-causal {nt}x{nf}"]:
        fail(f"[whisper] the blocked path's forward launched flash "
             f"{counts['blocked']['flash_attention']} times ("
             f"{forms['blocked']}); expected {L}, the cross-attention")
    if not finite or not padded_ok:
        fail("[whisper] the forward's logits are not finite, or padded ids "
             "are not -1e30")
    drift = encoder_drift(model, plain, params, frames)
    log("[whisper] each encoder layer's attention on the kernel path's "
        "input, kernel vs blocked: min per-row cosine " + ", ".join(
            f"{r['min_cosine']:.6f}" for r in drift["layer"])
        + "; max abs err " + ", ".join(
            f"{r['max_abs_err']:.3e}" for r in drift["layer"])
        + "; the two paths' encoder states after each layer, min per-row "
        "cosine " + ", ".join(f"{c:.6f}" for c in drift["drift_min_cosine"]))
    if not cos >= COS_MIN:
        fail("[whisper] the kernel path's logits disagree with the blocked "
             "path")

    # -- times
    torch.cuda.reset_peak_memory_stats(dev)
    encode_ms = cuda_ms(lambda: model.encode(params, frames), 5, warmup=1)
    encode_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    forward_ms = cuda_ms(lambda: model.forward(params, frames, tokens), 5,
                         warmup=1)
    forward_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    prompt = tokens[:, :WHISPER_PROMPT]
    torch.cuda.reset_peak_memory_stats(dev)
    kern = zero_counts()
    with AttentionCalls() as calls:
        logits, cache = model.prefill(params, frames, prompt)
    torch.cuda.synchronize()
    prefill_counts, prefill_forms = read_counts(kern), calls.by_form
    prefill_ms = cuda_ms(lambda: model.prefill(params, frames, prompt), 5,
                         warmup=1)
    prefill_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    if prefill_counts["flash_attention"] != 3 * L:
        fail(f"[whisper] the prefill launched flash "
             f"{prefill_counts['flash_attention']} times; expected {3 * L}")
    # the self cache padded by hand to the decoder's context, as the JAX
    # test pads it
    grow = lambda c: torch.cat([c, c.new_zeros(
        c.shape[:2] + (nt - c.shape[2],) + c.shape[3:])], dim=2)
    cache = {"self": tree_map(grow, cache["self"]), "cross": cache["cross"]}
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    del logits
    drawn = [tok]
    torch.cuda.reset_peak_memory_stats(dev)
    kern = zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(DECODE_STEPS):
        logits, cache = model.decode_step(params, tok, WHISPER_PROMPT + t,
                                          cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        drawn.append(tok)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / DECODE_STEPS
    decode_counts = read_counts(kern)
    decode_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    drawn = torch.cat(drawn, dim=1)
    in_vocab = bool(((drawn >= 0) & (drawn < v)).all())
    cache_len = cache["self"]["k"].shape[2]
    del cache, logits
    log(f"[whisper] encode {encode_ms:.3f} ms (peak {encode_peak:.2f} GB); "
        f"forward {forward_ms:.3f} ms (peak {forward_peak:.2f} GB); "
        f"prefill of a {WHISPER_PROMPT}-token prompt {prefill_ms:.3f} ms "
        f"(peak {prefill_peak:.2f} GB; flash by form "
        f"{json.dumps(prefill_forms)}); {DECODE_STEPS} greedy decode steps "
        f"from the self cache padded to {cache_len}: "
        f"{1e3 * step_s:.3f} ms a step, {b / step_s:.1f} tokens/s (peak "
        f"{decode_peak:.2f} GB; launches {json.dumps(decode_counts)}); "
        f"every token drawn below vocab_size: {in_vocab}")
    if not in_vocab or decode_counts["flash_attention"] != 0:
        fail("[whisper] decode drew a token outside the vocabulary or "
             "launched flash")

    # -- f32 decode against the forward, at full depth
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = EncDecLM(cfg32)
    p32 = tree_map(lambda t: t.float(), params)
    n32, pre, total = (WHISPER_F32_CLIPS, WHISPER_PROMPT,
                       WHISPER_PROMPT + WHISPER_F32_STEPS)
    f32_frames, f32_toks = frames[:n32], tokens[:n32, :total]
    kern = zero_counts()
    full, _ = m32.forward(p32, f32_frames, f32_toks)
    _, cache = m32.prefill(p32, f32_frames, f32_toks[:, :pre])
    f32_counts = read_counts(kern)
    grow = lambda c: torch.cat([c, c.new_zeros(
        c.shape[:2] + (total - c.shape[2],) + c.shape[3:])], dim=2)
    cache = {"self": tree_map(grow, cache["self"]), "cross": cache["cross"]}
    errs = []
    for t in range(pre, total):
        step, cache = m32.decode_step(p32, f32_toks[:, t:t + 1], t, cache)
        errs.append(((step[:, 0, :v] - full[:, t, :v]).abs().max()
                     / full[:, t, :v].abs().max()).item())
    del m32, p32, full, cache, step
    log(f"[whisper] f32 decode vs forward at full depth ({cfg.encoder_layers}"
        f" + {L} layers, {n32} clips of {nf} frames), steps {pre}..{total - 1}"
        f" from the self cache padded to {total}: max error of max |logit| "
        f"{', '.join(f'{e:.3e}' for e in errs)} (<= {DECODE_REL:g}); "
        f"launches {json.dumps(f32_counts)}")
    if not max(errs) <= DECODE_REL:
        fail(f"[whisper] f32 decode disagrees with forward: {max(errs):.3e}")
    if f32_counts["flash_attention"] != 6 * L:
        fail(f"[whisper] the f32 forward and prefill launched flash "
             f"{f32_counts['flash_attention']} times; expected {6 * L}")
    del params, model, plain, frames, tokens, drawn
    gc.collect()
    torch.cuda.empty_cache()

    # -- the flash kernel at whisper's three shapes
    # name: (FLASH_CASES row, flash_times arguments, the call's form in
    # the forward, in the prefill)
    p = WHISPER_PROMPT
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    shapes = {
        "enc": ("whisper encoder", dict(shape=(b, nf, *heads), causal=False),
                f"non-causal {nf}x{nf}", f"non-causal {nf}x{nf}"),
        "cross": ("whisper cross", dict(shape=(b, nt, *heads), causal=False,
                                        skv=nf),
                  f"non-causal {nt}x{nf}", f"non-causal {p}x{nf}"),
        "self": ("whisper self", dict(shape=(b, nt, *heads)),
                 f"causal {nt}x{nt}", f"causal {p}x{p}"),
    }
    times = {}
    for key, (case, kw, form, prefill_form) in shapes.items():
        ft = flash_times(dev, **kw)
        ft["share_of_forward"] = forms["flash"][form] * ft["ms"] / forward_ms
        errs_case = [e for name, e in f_errs.items() if case in name]
        kernels.append(
            {"name": f"flash_attention_whisper_{key}", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/flash.py:101",
             "launches": forms["flash"][form],
             "max_abs_err": max(errs_case),
             "ms": ft["ms"], "plain_ms": ft["plain_ms"],
             "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
             "library_ms": ft["library_ms"]})
        sdpa = ", ".join(f"{n} {t:.4f} ms" if isinstance(t, float) else
                         f"{n} {t}" for n, t in ft["sdpa"].items())
        log(f"[times] flash_attention_whisper_{key} at (b={b}, sq="
            f"{kw['shape'][1]}, skv={ft['skv']}, {heads[0]} heads over "
            f"{heads[1]}, hd {heads[2]}, "
            f"{'causal' if ft['causal'] else 'non-causal'}): bf16 "
            f"tensor-core kernel {ft['ms']:.4f} ms "
            f"({ft['ms'] / ft['bound_ms']:.2f}x its bound; "
            f"{ft['flops'] / ft['ms'] / 1e9:.1f} TFLOP/s), FP32 "
            f"kernel on the same inputs in f32 {ft['fp32_kernel_ms']:.4f} ms,"
            f" plain {ft['plain_ms']:.4f} ms, bound {ft['bound_ms']:.5f} ms "
            f"({ft['bound_by']}; {ft['flops']:.4g} FLOP, {ft['bytes']:.4g} "
            f"B); SDPA: {sdpa}; {forms['flash'][form]} launches a forward, "
            f"{prefill_forms.get(prefill_form, 0)} a prefill; "
            f"{100 * ft['share_of_forward']:.1f}% of a {forward_ms:.2f}-ms "
            f"forward")
        ft["prefill_launches"] = prefill_forms.get(prefill_form, 0)
        times[key] = ft
    phase_s = time.perf_counter() - t_phase
    log(f"[whisper] phase took {phase_s:.1f} s")
    return {"phase_seconds": phase_s, "params": n_params,
            "param_bytes": n_bytes, "param_count": cfg.param_count(),
            "init_seconds": init_s, "clips": b, "frames": nf, "tokens": nt,
            "launches": counts, "forms": forms,
            "logits_min_cosine": cos, "logits_max_abs_diff": diff,
            "logits_max_abs": scale, "encoder": drift,
            "encode_ms": encode_ms, "forward_ms": forward_ms,
            "prefill_ms": prefill_ms, "prefill_forms": prefill_forms,
            "decode_ms_per_step": 1e3 * step_s,
            "decode_tokens_per_second": b / step_s,
            "peak_memory_gb": {"encode": encode_peak,
                               "forward": forward_peak,
                               "prefill": prefill_peak,
                               "decode": decode_peak},
            "f32_decode_vs_forward_rel_err": errs, "f32_launches": f32_counts,
            "times": times}


class PlainAttentionCalls:
    """Within the block, calls of the plain attention versions
    (``attention_blocked`` and ``attention_einsum`` as the attention
    layer and the flash wrapper reach them): on the card's kernel path
    there must be none."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ref
        from repro_torch.models import attention
        self.calls = 0
        self._saved = [(mod, name, getattr(mod, name))
                       for mod in (ref, attention)
                       for name in ("attention_blocked", "attention_einsum")]

        def counting(inner):
            def call(*args, **kw):
                self.calls += 1
                return inner(*args, **kw)
            return call
        for mod, name, fn in self._saved:
            setattr(mod, name, counting(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def train_grad_check(dev, cfg, dtype: str) -> dict:
    """One loss_fn gradient of a TRAIN_GRAD_LAYERS-layer model of
    ``cfg``'s widths in ``dtype``, on the kernel path (flash launches:
    a forward and the remat's recompute a layer) and on
    attn_impl="blocked", compared leaf by leaf: max |diff| over max |g|
    and the cosine."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.data.loader import BatchSpec, SyntheticLMLoader
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.runtime.train_loop import grad_tree
    small = dataclasses.replace(cfg, num_layers=TRAIN_GRAD_LAYERS,
                                dtype=dtype)
    b, s = TRAIN_GRAD_SHAPE
    batch = SyntheticLMLoader(BatchSpec(b, s + 1, cfg.vocab_size),
                              seed=1).batch(0)
    params = build_model(small).init(torch.Generator(dev).manual_seed(2))
    grads, losses, launches = {}, {}, {}
    for impl in ("flash", "blocked"):
        model = build_model(small, attn_impl=impl)
        kern = zero_counts()
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = model.loss_fn(live, {k: torch.as_tensor(v, device=dev)
                                    for k, v in batch.items()})
        g = grad_tree(loss, live)
        torch.cuda.synchronize()
        launches[impl] = read_counts(kern)["flash_attention"]
        losses[impl] = loss.item()
        grads[impl] = dict(flatten_with_paths(g))
        del live, loss, g
    leaves = {}
    for path, want in grads["blocked"].items():
        got = grads["flash"][path].float()
        want = want.float()
        leaves[path] = {
            "rel": ((got - want).abs().max()
                    / want.abs().max().clamp(min=1e-30)).item(),
            "cos": F.cosine_similarity(got.flatten(), want.flatten(),
                                       dim=0).item()}
    del grads
    return {"dtype": dtype, "layers": TRAIN_GRAD_LAYERS,
            "shape": list(TRAIN_GRAD_SHAPE), "losses": losses,
            "launches": launches, "leaves": leaves,
            "max_rel": max(v["rel"] for v in leaves.values()),
            "min_cos": min(v["cos"] for v in leaves.values())}


def train_flash_checks(dev, shape=TRAIN_FLASH_SHAPE) -> dict:
    """The flash kernel's LSE form at the training shape (or ``shape``:
    b, s, heads, KV heads, head_dim), for the bf16
    kernel (the path's) and the FP32 one: out bitwise the form without
    LSE, and out and lse against the plain version's (the bf16 kernel's
    on its own tiles with P rounded, gated at FLASH_BF16_PLAIN_TOL; the
    FP32 one's at FLASH_TOL; lse at LSE_TOL)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention import ref as f_ref
    b, s, h, kv, hd = shape
    gen = torch.Generator(dev).manual_seed(5)
    base = [torch.randn((b, s, n, hd), generator=gen, device=dev)
            for n in (h, kv, kv)]
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (x.to(dt) for x in base)
        kw = dict(scale=hd ** -0.5, causal=True)
        plain_out = f_ops.flash_attention_fwd(q, k, v, **kw)
        with_lse, lse = f_ops.flash_attention_fwd(q, k, v, return_lse=True,
                                                  **kw)
        bf16 = dt == torch.bfloat16
        tiles = (dict(q_block=64, kv_block=f_ops.bf16_tile_keys(hd))
                 if bf16 else {})
        want_out, want = f_ref.attention_blocked(
            q, f_ref.expand_kv(k, h // kv), f_ref.expand_kv(v, h // kv),
            kw["scale"], causal=True, round_p=bf16, return_lse=True,
            **tiles)
        torch.cuda.synchronize()
        name = str(dt).split(".")[1]
        tol = FLASH_BF16_PLAIN_TOL if bf16 else FLASH_TOL[name]
        out[name] = {
            "out_bitwise": bool(torch.equal(plain_out, with_lse)),
            "out_max_abs_err": (with_lse.float() - want_out.float()
                                ).abs().max().item(),
            "out_tol": tol,
            "out_ok": with_lse.dtype == dt and bool(torch.allclose(
                with_lse.float(), want_out.float(), rtol=tol, atol=tol)),
            "lse_max_abs_err": (lse - want).abs().max().item(),
            "lse_ok": bool(torch.allclose(lse, want, **LSE_TOL)),
            "lse_finite": bool(torch.isfinite(lse).all())}
        del q, k, v, plain_out, with_lse, lse, want_out, want
    return out


def train_flash_times(dev, shape=TRAIN_FLASH_SHAPE) -> dict:
    """At the training shape (or ``shape``): the kernel's LSE form (what
    the train step launches), the plain forward with its LSE, the plain
    backward (``models.attention.flash_backward``) and, through
    ``flash_times``, the form without LSE and SDPA's backends."""
    import torch
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention import ref as f_ref
    from repro_torch.models.attention import flash_backward
    ft = flash_times(dev, shape)
    b, s, h, kv, hd = shape
    gen = torch.Generator(dev).manual_seed(6)
    q = torch.randn((b, s, h, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, kv, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    scale = hd ** -0.5
    ft["lse_ms"] = cuda_ms(lambda: f_ops.flash_attention_fwd(
        q, k, v, scale=scale, causal=True, return_lse=True), 50)
    ft["plain_lse_ms"] = cuda_ms(lambda: f_ref.attention_blocked(
        q, f_ref.expand_kv(k, h // kv), f_ref.expand_kv(v, h // kv), scale,
        causal=True, round_p=True, return_lse=True), 3, warmup=1)
    out, lse = f_ops.flash_attention_fwd(q, k, v, scale=scale, causal=True,
                                         return_lse=True)
    dout = torch.randn_like(q)
    ft["plain_backward_ms"] = cuda_ms(lambda: flash_backward(
        q, k, v, out, lse, dout, scale, causal=True), 3, warmup=1)
    ft["exp_bound_ms"] = b * h * attention_pairs(s, 0) / PEAK_EXP * 1e3
    return ft


def train_phase(dev, kernels: list) -> dict:
    """[train] with every earlier model's weights freed: the port's
    Trainer on smollm-360m FULL (TRAIN_* above): restart and learning,
    speed and memory, launch counts, the plain attention never called;
    the full-width gradient check, the LSE checks, and the flash times
    at the training shape, appended to ``kernels``."""
    import gc
    import shutil

    import torch
    from repro_torch import checkpoint as t_ckpt
    from repro_torch.config import (InputShape, OptimizerConfig,
                                    TrainConfig, get_arch)
    from repro_torch.data.loader import device_batch
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.runtime.fault import WorkerFailure
    from repro_torch.runtime.serve_loop import params_digest
    from repro_torch.runtime.train_loop import Trainer

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 1e9
    log(f"[train] after freeing the earlier models' weights: {held:.3f} GB "
        f"allocated")
    if held > 1.0:
        fail(f"{held:.2f} GB still allocated before the train phase")
    cfg = get_arch(TRAIN_ARCH)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    shape = InputShape(f"train_4k_b{TRAIN_BATCH}", TRAIN_SEQ, TRAIN_BATCH,
                       "train")
    tc = TrainConfig(shape=shape,
                     optimizer=OptimizerConfig(lr=3e-4, warmup_steps=2,
                                               total_steps=TRAIN_STEPS),
                     checkpoint_every=TRAIN_CKPT_EVERY,
                     checkpoint_dir=str(TRAIN_DIR), keep_checkpoints=2)
    fails = {TRAIN_FAIL_AT}
    entries = []            # (step, flash launches so far) at each start

    def injector(step):
        entries.append((step, f_ops.KERNEL.launches))
        if step in fails:
            fails.discard(step)
            raise WorkerFailure(f"injected at step {step}")

    kern = zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with PlainAttentionCalls() as plain_calls, \
            Trainer(cfg, tc, fail_injector=injector, device=dev) as tr:
        rep = tr.run(TRAIN_STEPS, resume=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    counts = read_counts(kern)
    # launches of each step run: from its start to the next one's (the
    # failed step 6 launched nothing before it raised)
    marks = entries + [(None, counts["flash_attention"])]
    per_step = [(st, nxt - at) for (st, at), (_, nxt)
                in zip(marks, marks[1:])]
    ran = [n for st, n in per_step]
    records = [r for r in tr.metrics.ring if "step_time_s" in r]
    last = {r["step"]: r for r in records}          # the final pass's
    step_s = [last[i]["step_time_s"] for i in range(1, TRAIN_STEPS)]
    ms_step = 1e3 * sum(step_s) / len(step_s)
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (ms_step / 1e3)
    losses = rep.losses
    n_first = TRAIN_FAIL_AT
    replay = losses[n_first:]
    latest = t_ckpt.latest_step(str(TRAIN_DIR))
    ckpt_s = {"host_copy": tr.checkpointer.host_seconds,
              "write": tr.checkpointer.write_seconds}
    log(f"[train] {cfg.name} FULL ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, remat "
        f"{cfg.remat}) at {TRAIN_BATCH} x {TRAIN_SEQ}: {TRAIN_STEPS} steps, "
        f"{len(losses)} run, restarts {rep.restarts}, latest checkpoint "
        f"{latest}, in {run_s:.2f} s")
    log(f"[train] losses (first pass, then from the step-"
        f"{TRAIN_CKPT_EVERY} checkpoint): "
        + ", ".join(f"{x!r}" for x in losses))
    log(f"[train] ms a step (host clock after a synchronize, steps 1-"
        f"{TRAIN_STEPS - 1} of the final pass): "
        + ", ".join(f"{1e3 * t:.1f}" for t in step_s)
        + f"; mean {ms_step:.2f} ms, {tokens_s:.1f} tokens/s; peak memory "
        f"{peak_gb:.2f} GB; checkpoint host copy "
        f"{ckpt_s['host_copy']:.2f} s, write {ckpt_s['write']:.2f} s (the "
        f"last one, {TRAIN_STEPS})")
    log(f"[train] launches a step run (flash): {json.dumps(per_step)}; all "
        f"kernels over the run {json.dumps(counts)}; plain attention calls "
        f"{plain_calls.calls}")
    want_replay = losses[TRAIN_CKPT_EVERY:n_first]
    if rep.restarts != 1 or latest != TRAIN_STEPS:
        fail(f"[train] restarts {rep.restarts}, latest checkpoint {latest}")
    if len(losses) != n_first + TRAIN_STEPS - TRAIN_CKPT_EVERY:
        fail(f"[train] {len(losses)} steps ran")
    if replay[:len(want_replay)] != want_replay:
        fail(f"[train] the replayed losses {replay[:len(want_replay)]} are "
             f"not the first pass's {want_replay}")
    if not all(map(lambda x: x == x and abs(x) < 1e4, losses)) or \
            not losses[-1] < losses[0]:
        fail(f"[train] the loss did not fall: step 0 {losses[0]}, step "
             f"{TRAIN_STEPS - 1} {losses[-1]}")
    want = 2 * cfg.num_layers
    if [n for st, n in per_step if st != TRAIN_FAIL_AT or n] != \
            [want] * len(losses) or counts["flash_attention"] != \
            want * len(losses):
        fail(f"[train] flash launched {ran}, not {want} a step")
    if any(n for name, n in counts.items() if name != "flash_attention"):
        fail(f"[train] other kernels launched: {counts}")
    if plain_calls.calls:
        fail(f"[train] the plain attention ran {plain_calls.calls} times "
             f"on the card")
    t0 = time.perf_counter()
    state, step = tr.restore_latest()
    digest = params_digest(state[0])
    digest_s = time.perf_counter() - t0
    init_params = tr.init_state()[0]
    init_digest = params_digest(init_params)
    batch0 = device_batch(tr.loader.batch(0), device=dev)
    with torch.no_grad():
        fall = {"init": tr.model.loss_fn(init_params, batch0).item(),
                "final": tr.model.loss_fn(state[0], batch0).item()}
    fall["fall"] = fall["init"] - fall["final"]
    log(f"[train] the step-{step} checkpoint restored, params digest "
        f"{digest} ({digest_s:.2f} s with the restore), init_state()'s "
        f"{init_digest}; the step-0 batch's loss under init_state()'s "
        f"params {fall['init']!r}, under the step-{step} ones "
        f"{fall['final']!r}: a fall of {fall['fall']!r} (gate >= "
        f"{TRAIN_FALL_MIN:g})")
    if digest == init_digest:
        fail(f"[train] the step-{step} params are init_state()'s")
    if not fall["fall"] >= TRAIN_FALL_MIN:
        fail(f"[train] the step-0 batch's loss fell {fall['fall']} < "
             f"{TRAIN_FALL_MIN}")
    del state, tr, init_params, batch0
    gc.collect()
    torch.cuda.empty_cache()

    grad = {}
    for dtype in ("float32", "bfloat16"):
        g = train_grad_check(dev, cfg, dtype)
        grad[dtype] = g
        worst = sorted(g["leaves"].items(), key=lambda kv: kv[1]["cos"])[0]
        log(f"[train] gradient check, {g['layers']} layers of "
            f"{cfg.name}'s widths in {dtype} over {tuple(g['shape'])}: "
            f"loss kernel path {g['losses']['flash']!r}, blocked "
            f"{g['losses']['blocked']!r}; flash launches "
            f"{json.dumps(g['launches'])}; every leaf: max |diff| / max "
            f"|g| <= {g['max_rel']:.3e}, cosine >= {g['min_cos']:.7f} "
            f"(least: {worst[0]})")
        if g["launches"]["flash"] != 2 * TRAIN_GRAD_LAYERS or \
                g["launches"]["blocked"]:
            fail(f"[train] {dtype} gradient check launches {g['launches']}")
        if dtype == "float32" and not g["max_rel"] <= TRAIN_GRAD_REL:
            fail(f"[train] f32 gradients differ by {g['max_rel']}")
        if dtype == "bfloat16" and not g["min_cos"] >= TRAIN_GRAD_COS:
            fail(f"[train] bf16 gradients' cosine {g['min_cos']}")
    gc.collect()
    torch.cuda.empty_cache()

    lse = train_flash_checks(dev)
    for name, c in lse.items():
        log(f"[train] flash LSE form at {tuple(TRAIN_FLASH_SHAPE)} causal, "
            f"{name}: out bitwise the form without it {c['out_bitwise']}; "
            f"out vs the plain version's max abs err "
            f"{c['out_max_abs_err']:.3e} (rtol = atol = {c['out_tol']:g}); "
            f"lse vs the plain version's max abs err "
            f"{c['lse_max_abs_err']:.3e} (rtol {LSE_TOL['rtol']:g}, atol "
            f"{LSE_TOL['atol']:g})")
        if not (c["out_bitwise"] and c["out_ok"] and c["lse_ok"]
                and c["lse_finite"]):
            fail(f"[train] flash LSE form ({name}) fails: {c}")
    ft = train_flash_times(dev)
    total = counts["flash_attention"]
    kernels.append(
        {"name": "flash_attention_train_lse", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash.py:101",
         "launches": total,
         "max_abs_err": max(max(c["out_max_abs_err"], c["lse_max_abs_err"])
                            for c in lse.values()),
         "ms": ft["lse_ms"], "plain_ms": ft["plain_lse_ms"],
         "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
         "library_ms": ft["library_ms"]})
    sdpa = ", ".join(f"{n} {t:.4f} ms" if isinstance(t, float) else
                     f"{n} {t}" for n, t in ft["sdpa"].items())
    bwd_share = cfg.num_layers * ft["plain_backward_ms"] / ms_step
    fwd_share = want * ft["lse_ms"] / ms_step
    log(f"[times] flash_attention_train_lse at {tuple(TRAIN_FLASH_SHAPE)} "
        f"causal: the LSE form {ft['lse_ms']:.4f} ms "
        f"({ft['lse_ms'] / ft['bound_ms']:.2f}x its bound; "
        f"{ft['flops'] / ft['lse_ms'] / 1e9:.1f} TFLOP/s), the form "
        f"without it {ft['ms']:.4f} ms, non-causal {ft['noncausal_ms']:.4f} "
        f"ms, FP32 kernel on f32 {ft['fp32_kernel_ms']:.4f} ms; plain "
        f"forward with LSE {ft['plain_lse_ms']:.4f} ms, plain backward "
        f"{ft['plain_backward_ms']:.4f} ms; bound {ft['bound_ms']:.5f} ms "
        f"({ft['bound_by']}; {ft['flops']:.4g} FLOP, exponentials "
        f"{ft['exp_bound_ms']:.4f} ms); {total} launches in the run "
        f"({want} a step); SDPA: {sdpa}; of a {ms_step:.1f}-ms step the "
        f"flash launches {100 * fwd_share:.1f}%, the plain backward "
        f"(one a layer) {100 * bwd_share:.1f}%")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"[train] phase {phase_s:.1f} s")
    return {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "losses": losses,
            "restarts": rep.restarts, "latest_checkpoint": latest,
            "step_seconds": step_s, "ms_per_step": ms_step,
            "tokens_per_second": tokens_s, "peak_memory_gb": peak_gb,
            "run_seconds": run_s, "launches_per_step_run": per_step,
            "launches": counts, "plain_attention_calls": plain_calls.calls,
            "checkpoint_seconds": ckpt_s,
            "params_digest": digest, "digest_seconds": digest_s,
            "init_params_digest": init_digest, "step0_batch_loss": fall,
            "grad_check": grad, "lse": lse, "flash": ft,
            "flash_share_of_step": fwd_share,
            "plain_backward_share_of_step": bwd_share,
            "phase_seconds": phase_s}


def _cosine(a, b) -> float:
    import torch
    a, b = a.double().flatten(), b.double().flatten()
    return (torch.dot(a, b) / (a.norm() * b.norm())).item()


def long_close(got, want) -> dict:
    """``got`` against ``want`` (b, s, heads, hd) at LONG_FLASH_TOL: the
    largest error, the largest error over its position's max |want|, the
    largest error over its bar rtol |want| + row_atol max_row |want|, and
    whether every element is within its bar."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    row_max = want.abs().amax(dim=(2, 3), keepdim=True)
    bar = (LONG_FLASH_TOL["rtol"] * want.abs()
           + LONG_FLASH_TOL["row_atol"] * row_max)
    return {"max_abs_err": diff.max().item(),
            "max_err_over_row_max": (diff / row_max.clamp(min=1e-30))
            .max().item(),
            "max_share_of_bar": (diff / bar.clamp(min=1e-30)).max().item(),
            "ok": bool((diff <= bar).all())}


def long_flash(dev, shape=LONG_FLASH_SHAPE) -> dict:
    """The bf16 flash kernel at ``shape`` (causal): its time (CUDA
    events over 10 calls); three 64-row query blocks (first, middle,
    last) against its plain version on its own tiles (P rounded; each
    block over the keys it sees) and every row against the plain
    version's timed pass over the whole call (P rounded, 512-row blocks,
    one call, as the other rows' plain ms), both at LONG_FLASH_TOL;
    cuDNN's SDPA (timed only) and the bound."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention import ref as f_ref
    b, s, h, kv, hd = shape
    gen = torch.Generator(dev).manual_seed(32)
    q = torch.randn((b, s, h, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, kv, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    scale, g = hd ** -0.5, h // kv
    got = f_ops.flash_attention_fwd(q, k, v, scale=scale, causal=True)
    errs = {}
    for start in (0, s // 2, s - 64):
        end = start + 64
        want = f_ref.attention_blocked(
            q[:, start:end], f_ref.expand_kv(k[:, :end], g),
            f_ref.expand_kv(v[:, :end], g), scale, causal=True,
            q_offset=start, q_block=64, kv_block=f_ops.bf16_tile_keys(hd),
            round_p=True)
        errs[str(start)] = long_close(got[:, start:end], want)
    finite = bool(torch.isfinite(got).all())
    ms = cuda_ms(lambda: f_ops.flash_attention_fwd(
        q, k, v, scale=scale, causal=True), 10)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    plain = f_ref.attention_blocked(
        q, f_ref.expand_kv(k, g), f_ref.expand_kv(v, g), scale,
        causal=True, round_p=True)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    whole = long_close(got, plain)
    del got, plain
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
            library_ms = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=scale,
                    enable_gqa=True), 10)
    except RuntimeError as e:
        library_ms, why = None, str(e).splitlines()[0][:160]
    else:
        why = None
    pairs = attention_pairs(s, 0)
    flops = 4 * b * h * hd * pairs
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_refused": why,
            "blocks_vs_plain": errs, "all_rows_vs_plain": whole,
            "finite": finite, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "exp_bound_ms": b * h * pairs / PEAK_EXP * 1e3}


def _synced_s(fn):
    """(fn()'s result, seconds on the host clock between two
    synchronizes)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dryrun_check(dev, plan, args, step_s: float, peak_gb: float) -> dict:
    """(g) on one timed step: the plan's step counted by the cost counter
    on the plan's meta arguments and again, run on the card, on ``args``
    (the timed run's own); its roofline time from the meta count against
    ``step_s``; the arguments plus the meta peak of live bytes against
    ``peak_gb``, the timed run's torch.cuda.max_memory_allocated."""
    import torch
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    t0 = time.perf_counter()
    meta = hlo_analysis.analyze_step(plan.step_fn, *plan.arg_sds)
    meta_s = time.perf_counter() - t0
    with hlo_analysis.CostCounter(args) as counter:
        plan.step_fn(*args)
    torch.cuda.synchronize(dev)
    card = counter.report()
    fields = ("ops", "flops", "product_flops", "bytes", "transcendental")
    t_compute, t_memory = meta.flops / PEAK_FLOPS, meta.bytes / HBM_BW
    est_gb = (meta.argument_bytes + meta.peak_bytes) / 1e9
    return {"meta": meta.to_dict(), "card": card.to_dict(),
            "counts_equal": all(getattr(meta, f) == getattr(card, f)
                                for f in fields),
            "trace_seconds": meta_s, "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "dominant": "compute" if t_compute >= t_memory else "memory",
            "step_s": step_s,
            "roofline_fraction": max(t_compute, t_memory) / step_s,
            "estimate_gb": est_gb, "peak_gb": peak_gb,
            "memory_rel_err": abs(est_gb - peak_gb) / peak_gb}


def dryrun_log(tag: str, g: dict) -> str:
    m, c = g["meta"], g["card"]
    return (f"[launch] (g) {tag}: meta {m['ops']} ops, {m['flops']:.6g} "
            f"FLOP ({m['product_flops']:.6g} in products), "
            f"{m['bytes']:.6g} B, {m['transcendental']:.6g} "
            f"transcendentals (traced in {g['trace_seconds']:.1f} s); card "
            f"{c['ops']} ops, {c['flops']:.6g} FLOP, {c['bytes']:.6g} B, "
            f"{c['transcendental']:.6g} transcendentals: equal "
            f"{g['counts_equal']}; roofline t_compute "
            f"{g['t_compute_s']:.4f} s, t_memory {g['t_memory_s']:.4f} s "
            f"({g['dominant']}) against the measured {g['step_s']:.4f} s: "
            f"fraction {g['roofline_fraction']:.4f}; arguments "
            f"{m['argument_bytes'] / 1e9:.3f} GB + meta peak "
            f"{m['peak_bytes'] / 1e9:.3f} GB = {g['estimate_gb']:.3f} GB "
            f"against max_memory_allocated {g['peak_gb']:.3f} GB "
            f"({100 * g['memory_rel_err']:.2f}% off; gate "
            f"{100 * DRYRUN_MEM_REL:.0f}%)")


def launch_llama(dev, mesh) -> dict:
    """(a) the prefill plan over LAUNCH_SEQ random tokens, last_logit;
    (b) the prefill of the first LAUNCH_SEQ - 1 with cache_len LAUNCH_SEQ,
    then the decode plan's step with the last token at its position,
    against (a)'s last logits, and timed LAUNCH_DECODE_REPS times."""
    import torch
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.config import InputShape, get_arch
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = get_arch(LAUNCH_ARCH)
    (params, draw_s) = _synced_s(lambda: build_model(cfg).init(
        torch.Generator(dev).manual_seed(0)))
    gen = torch.Generator(dev).manual_seed(30)
    tokens = torch.randint(1, cfg.vocab_size, (1, LAUNCH_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    pshape = InputShape("prefill_32k_b1", LAUNCH_SEQ, 1, "prefill")
    plan = steps.make_plan(cfg, pshape, mesh, last_logit=True)
    kern = zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    (last, cache), prefill_s = _synced_s(
        lambda: plan.step_fn(params, {"tokens": tokens}))
    counts = read_counts(kern)
    prefill_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    v = cfg.vocab_size
    out = {"description": plan.description, "draw_seconds": draw_s,
           "layers": cfg.num_layers,
           "prefill_ms": 1e3 * prefill_s, "prefill_peak_gb": prefill_peak,
           "prefill_launches": counts,
           "prefill_fallbacks": plan.ruleset.fallback_report(),
           "last_logits_shape": list(last.shape),
           "last_logits_finite": bool(torch.isfinite(last[:, :v]).all())}
    del cache
    out["dryrun"] = dryrun_check(dev, plan, (params, {"tokens": tokens}),
                                 prefill_s, prefill_peak)
    dshape = InputShape("decode_32k_b1", LAUNCH_SEQ, 1, "decode")
    dplan = steps.make_plan(cfg, dshape, mesh)
    model = steps.build_model_for_scale(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    kern = zero_counts()
    (_, cache), cache_s = _synced_s(lambda: model.prefill(
        params, tokens[:, :-1], cache_len=LAUNCH_SEQ))
    out["cache_prefill_launches"] = read_counts(kern)
    out["cache_prefill_ms"] = 1e3 * cache_s
    want = [(k, tuple(t.shape))
            for k, t in flatten_with_paths(dplan.arg_sds[1]["cache"])]
    got = [(k, tuple(t.shape)) for k, t in flatten_with_paths(cache)]
    out["cache_shapes_match_spec"] = want == got
    batch = {"tokens": tokens[:, -1:], "pos": LAUNCH_SEQ - 1,
             "cache": cache}
    kern = zero_counts()
    times = []
    for _ in range(LAUNCH_DECODE_REPS + 1):
        (dec, new_cache), step_s = _synced_s(
            lambda: dplan.step_fn(params, batch))
        times.append(1e3 * step_s)
        del new_cache
    out["decode_launches"] = read_counts(kern)
    out["decode_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["decode_ms"] = times[1:]
    out["decode_first_ms"] = times[0]
    a, d = last[0, :v].float(), dec[0, :v].float()
    top2 = torch.topk(a, 2).values
    # the logits are bf16 products cast to f32, so several tokens may tie
    # at the max: each path's top-1 tokens are every index at its max
    tops = [torch.nonzero(x == x.max()).flatten()[:8].tolist()
            for x in (a, d)]
    t_d = int(d.argmax())
    out.update({"cosine": _cosine(a, d),
                "max_abs_diff": (a - d).abs().max().item(),
                "top1_prefill": tops[0], "top1_decode": tops[1],
                "decode_top1_is_a_prefill_top1": bool(a[t_d] == a.max()),
                "decode_top1_rank_in_prefill": int((a > a[t_d]).sum()),
                "top1_gap_prefill": (top2[0] - top2[1]).item()})
    del params, cache, batch, last, dec
    return out


def launch_train(dev, mesh) -> dict:
    """(d) smollm-360m FULL at TRAIN_4K cut to TRAIN_BATCH: one train-plan
    step with default_microbatches and one with 1, from the same state and
    batch; losses, per-leaf update cosines, times, peaks, launches."""
    import torch
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.config import (InputShape, OptimizerConfig,
                                    get_arch)
    from repro_torch.data.loader import (BatchSpec, SyntheticLMLoader,
                                         device_batch)
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optimizer import adamw
    cfg = get_arch(TRAIN_ARCH)
    shape = InputShape(f"train_4k_b{TRAIN_BATCH}", TRAIN_SEQ, TRAIN_BATCH,
                       "train")
    nmicro = steps.default_microbatches(shape, mesh, cfg)
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
    # sequences of TRAIN_SEQ + 1 tokens: inputs and labels TRAIN_SEQ each
    loader = SyntheticLMLoader(BatchSpec(TRAIN_BATCH, TRAIN_SEQ + 1,
                                         cfg.vocab_size))
    batch = device_batch(loader.batch(0), device=dev)
    opt = OptimizerConfig(**LAUNCH_OPT)
    before = {p: t.float() for p, t in flatten_with_paths(params)}
    runs, updates = {}, {}
    for k in (nmicro, 1):
        plan = steps.make_train_plan(cfg, shape, mesh, opt_cfg=opt,
                                     microbatches=k)
        torch.cuda.reset_peak_memory_stats(dev)
        kern = zero_counts()
        ((new, state), metrics), step_s = _synced_s(
            lambda: plan.step_fn((params, adamw.init(opt, params)), batch))
        runs[k] = {"description": plan.description,
                   "loss": metrics["loss"].item(),
                   "grad_norm": metrics["grad_norm"].item(),
                   "ms": 1e3 * step_s,
                   "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                   "launches": read_counts(kern)}
        updates[k] = {p: t.float() - before[p]
                      for p, t in flatten_with_paths(new)}
        del new, state, metrics
        # (g) on this step; the optimizer state is an argument there
        runs[k]["dryrun"] = dryrun_check(
            dev, plan, ((params, adamw.init(opt, params)), batch), step_s,
            runs[k]["peak_gb"])
    cos = {p: _cosine(updates[nmicro][p], updates[1][p])
           for p in updates[1]}
    worst = min(cos, key=cos.get)
    del updates, before, params, batch
    return {"microbatches": nmicro, "layers": cfg.num_layers,
            # a loss_fn launches flash once a layer, and once more a layer
            # in the backward under remat "full"
            "flash_per_loss": cfg.num_layers * (2 if cfg.remat == "full"
                                                else 1),
            "runs": {str(k): r for k, r in runs.items()},
            "loss_rel_diff": abs(runs[nmicro]["loss"] - runs[1]["loss"])
            / abs(runs[1]["loss"]),
            "update_min_cosine": cos[worst], "update_least_leaf": worst}


def factored_layers(cfg, params, tokens) -> dict:
    """The first RWKV_DEPTH rwkv6 blocks by hand over ``tokens``, as
    rwkv_checks runs them against the direct scan: per layer, on the
    kernel path's inputs, the time-mix output in float32 from the factored
    recurrence against the kernel's (per-row cosine, relative error of
    y); after RWKV_DEPTH layers, the factored path's hidden state against
    the kernel path's (pooled over the sequence, and per row)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.wkv6 import ops as w_ops
    from repro_torch.models import rwkv
    from repro_torch.models.common import rmsnorm_apply
    from repro_torch.models.transformer import group_params

    def block(p, x, wkv):
        h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        *args, g = rwkv.timemix_inputs(p["time"], h, cfg)
        y = wkv(*args, p["time"]["u"], chunk=rwkv.CHUNK)
        x = x + rwkv.timemix_output(p["time"], y, g, cfg)
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        return x + rwkv.channelmix_apply(p["channel"], h, cfg), (args, g, y)

    def row_cos(a, b):               # in float64: 1 - cos reaches 1e-7
        return F.cosine_similarity(a.double().flatten(1),
                                   b.double().flatten(1), dim=1).min().item()

    layers = []
    with torch.inference_mode():
        x = F.embedding(tokens, params["embed"]["table"])
        xf = x
        for depth in range(RWKV_DEPTH):
            p = group_params(params, depth)["p0"]
            x_next, (args, g, y) = block(p, x, w_ops.wkv6)
            y_f = rwkv.WKV6["factored"](*args, p["time"]["u"],
                                        chunk=rwkv.CHUNK)
            p32 = {n: p["time"][n].float() for n in ("ln_x", "wo")}
            layers.append({
                "y_rel_err": ((y_f - y).abs().max() / y.abs().max()).item(),
                "time_mix_f32_min_cosine": row_cos(
                    rwkv.timemix_output(p32, y_f, g.float(), cfg)[0],
                    rwkv.timemix_output(p32, y, g.float(), cfg)[0])})
            del args, g, y, y_f
            x = x_next
            xf = block(p, xf, rwkv.WKV6["factored"])[0]
        return {"layers": layers,
                "pooled_cosine": row_cos(x.float().mean(dim=1),
                                         xf.float().mean(dim=1)),
                "row_min_cosine": row_cos(x[0], xf[0])}


def launch_rwkv(dev, mesh) -> dict:
    """(e) rwkv6-7b FULL at PREFILL_32K cut to batch 1: the prefill plan
    (factored WKV6; the clamped log-decays counted on the card, read
    after the step) against the same params in rwkv_mode="kernel" (the
    WKV6 kernel), last logits; then factored_layers on the same tokens."""
    import torch
    from repro_torch.config import InputShape, get_arch
    from repro_torch.kernels.wkv6 import ref as w_ref
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models import rwkv as t_rwkv
    cfg = get_arch(LAUNCH_RWKV_ARCH)
    (params, draw_s) = _synced_s(lambda: build_model(cfg).init(
        torch.Generator(dev).manual_seed(0)))
    gen = torch.Generator(dev).manual_seed(31)
    tokens = torch.randint(1, cfg.vocab_size, (1, LAUNCH_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    plan = steps.make_plan(cfg, InputShape("prefill_32k_b1", LAUNCH_SEQ, 1,
                                           "prefill"), mesh, last_logit=True)
    clamped = []
    inner = t_rwkv.WKV6["factored"]

    def counting(r, k, v, lw, u, *, chunk, **kw):
        # a count on the card, read after the timed window: no sync in it
        q = w_ref.chunk_len(lw.shape[1], chunk)
        clamped.append((lw < -t_rwkv.FACTORED_CLAMP / q).sum())
        return inner(r, k, v, lw, u, chunk=chunk, **kw)
    t_rwkv.WKV6["factored"] = counting
    torch.cuda.reset_peak_memory_stats(dev)
    kern = zero_counts()
    try:
        (fac, cache), fac_s = _synced_s(
            lambda: plan.step_fn(params, {"tokens": tokens}))
    finally:
        t_rwkv.WKV6["factored"] = inner
    fac_counts = read_counts(kern)
    fac_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    clamped = [int(n) for n in clamped]
    del cache
    kernel_model = build_model(cfg, rwkv_mode="kernel")
    kernel_model.prefill_last_only = True
    kern = zero_counts()
    (ker, cache), ker_s = _synced_s(lambda: kernel_model.prefill(params,
                                                                 tokens))
    ker_counts = read_counts(kern)
    v = cfg.vocab_size
    a, b = fac[:, :v], ker[:, -1, :v]
    out = {"description": plan.description, "draw_seconds": draw_s,
           "layers": cfg.num_layers,
           "factored_ms": 1e3 * fac_s, "kernel_ms": 1e3 * ker_s,
           "factored_peak_gb": fac_peak, "factored_launches": fac_counts,
           "kernel_launches": ker_counts, "clamped_per_layer": clamped,
           "clamped_total": sum(clamped),
           "log_decays": cfg.num_layers * LAUNCH_SEQ * cfg.d_model,
           "finite": bool(torch.isfinite(a).all()),
           "cosine": _cosine(a[0], b[0]),
           "top1": [int(a[0].argmax()), int(b[0].argmax())]}
    del cache, fac, ker
    torch.cuda.empty_cache()
    (out["by_hand"], out["by_hand_s"]) = _synced_s(
        lambda: factored_layers(cfg, params, tokens))
    del params
    return out


def launch_phase(dev, kernels: list) -> dict:
    """[launch]: the launch layer's cell plans on one card, (a) to (g)
    above; the flash kernel's entry at the prefill's call appended to
    ``kernels``. Every gate is checked and logged; the phase fails after
    the last."""
    import gc

    import numpy as np
    import torch
    from repro_torch.config import get_arch
    from repro_torch.launch import mesh as t_mesh
    from repro_torch.launch.serve import main as serve_main
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 1e9
    log(f"[launch] after freeing the earlier models' weights: {held:.3f} GB "
        f"allocated")
    if held > 1.0:
        fail(f"{held:.2f} GB still allocated before the launch phase")
    mesh = t_mesh.make_test_mesh(1, 1, device=dev)
    errors = []

    def gate(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)
            log(f"[launch] GATE FAILED: {msg}")

    # (c) first: the kernel alone, nothing else on the card
    lf = long_flash(dev)
    tol = (f"rtol {LONG_FLASH_TOL['rtol']:g}, atol "
           f"{LONG_FLASH_TOL['row_atol']:g} x the position's max |want|")
    for start, e in lf["blocks_vs_plain"].items():
        log(f"[launch] flash at {tuple(LONG_FLASH_SHAPE)} causal, query rows "
            f"{start}..+64 vs its plain version on its tiles: max abs err "
            f"{e['max_abs_err']:.3e}, {e['max_err_over_row_max']:.3e} of its "
            f"position's max |want|, {e['max_share_of_bar']:.3f} of the bar "
            f"({tol})")
        gate(e["ok"], f"flash at 32k, rows {start}: disagrees with its plain "
             f"version")
    e = lf["all_rows_vs_plain"]
    log(f"[launch] flash at {tuple(LONG_FLASH_SHAPE)} causal, all rows vs the "
        f"plain version's timed pass (512-row blocks): max abs err "
        f"{e['max_abs_err']:.3e}, {e['max_err_over_row_max']:.3e} of its "
        f"position's max |want|, {e['max_share_of_bar']:.3f} of the bar "
        f"({tol})")
    gate(e["ok"], "flash at 32k: disagrees with its plain version's pass")
    gate(lf["finite"], "flash at 32k: non-finite output")
    gc.collect()
    torch.cuda.empty_cache()

    # (a), (b) llama3-8b
    ll = launch_llama(dev, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    want = ll["layers"]                  # one flash call a layer
    log(f"[launch] (a) {ll['description']} (batch cut to 1, last_logit): "
        f"params drawn in {ll['draw_seconds']:.2f} s; the step "
        f"{ll['prefill_ms']:.1f} ms ({LAUNCH_SEQ / ll['prefill_ms'] * 1e3:.0f}"
        f" tokens/s), peak {ll['prefill_peak_gb']:.2f} GB, launches "
        f"{json.dumps(ll['prefill_launches'])}, logits "
        f"{ll['last_logits_shape']}; rule fallbacks on the 1 x 1 mesh: "
        f"{ll['prefill_fallbacks']}")
    gate(ll["prefill_launches"]["flash_attention"] == want and not any(
        n for name, n in ll["prefill_launches"].items()
        if name != "flash_attention"),
        f"(a) launches {ll['prefill_launches']}, not {want} flash")
    gate(ll["last_logits_finite"] and ll["last_logits_shape"][0] == 1,
         "(a) last logits not finite")
    log(f"[launch] (b) prefill of {LAUNCH_SEQ - 1} tokens into a "
        f"{LAUNCH_SEQ}-slot cache {ll['cache_prefill_ms']:.1f} ms (cache "
        f"shapes = the decode plan's spec: {ll['cache_shapes_match_spec']}); "
        f"the decode plan's step at position {LAUNCH_SEQ - 1}: "
        + ", ".join(f"{t:.2f}" for t in ll["decode_ms"])
        + f" ms (first {ll['decode_first_ms']:.2f}), peak "
        f"{ll['decode_peak_gb']:.2f} GB, launches "
        f"{json.dumps(ll['decode_launches'])}; against (a)'s last logits: "
        f"cosine {ll['cosine']:.7f} (gate >= {LAUNCH_DECODE_COS}), max abs "
        f"diff {ll['max_abs_diff']:.4f}; top-1 tokens (every index at the "
        f"max of the bf16-rounded logits) decode {ll['top1_decode']}, "
        f"prefill {ll['top1_prefill']} (the prefill's top-2 gap "
        f"{ll['top1_gap_prefill']:.4f}); the decode's first is a top-1 "
        f"token of the prefill: {ll['decode_top1_is_a_prefill_top1']} "
        f"(tokens above it there: {ll['decode_top1_rank_in_prefill']})")
    gate(ll["cache_shapes_match_spec"], "(b) cache shapes differ from the "
         "decode plan's spec")
    gate(ll["cosine"] >= LAUNCH_DECODE_COS, f"(b) cosine {ll['cosine']}")
    gate(ll["decode_top1_is_a_prefill_top1"],
         "(b) the decode's top-1 token is not a top-1 token of the prefill")
    gate(not any(ll["decode_launches"].values()),
         f"(b) the decode step launched {ll['decode_launches']}")

    # (e) rwkv6-7b
    rw = launch_rwkv(dev, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[launch] (e) {rw['description']} (batch cut to 1; factored WKV6): "
        f"params drawn in {rw['draw_seconds']:.2f} s; the step "
        f"{rw['factored_ms']:.1f} ms, peak {rw['factored_peak_gb']:.2f} GB, "
        f"launches {json.dumps(rw['factored_launches'])}; log-decays the "
        f"clamp changed {rw['clamped_total']} of {rw['log_decays']} "
        f"(per layer {rw['clamped_per_layer'][:4]}...); the same params in "
        f"rwkv_mode='kernel' {rw['kernel_ms']:.1f} ms, launches "
        f"{json.dumps(rw['kernel_launches'])}; last logits cosine "
        f"{rw['cosine']:.7f} (gate >= {RWKV_COS_MIN}), top-1 {rw['top1']}")
    gate(not any(rw["factored_launches"].values()),
         f"(e) factored mode launched {rw['factored_launches']}")
    gate(rw["kernel_launches"]["wkv6"] == rw["layers"],
         f"(e) kernel mode launched {rw['kernel_launches']}")
    gate(rw["finite"] and rw["cosine"] >= RWKV_COS_MIN,
         f"(e) cosine {rw['cosine']}")
    bh = rw["by_hand"]
    log(f"[launch] (e) the first {RWKV_DEPTH} blocks by hand over the same "
        f"{LAUNCH_SEQ} tokens ({rw['by_hand_s']:.1f} s): factored vs the "
        f"kernel's recurrence on the kernel path's inputs, y's relative "
        f"error " + ", ".join(f"{x['y_rel_err']:.2e}" for x in bh["layers"])
        + "; the time-mix in f32, least per-row cosine "
        + ", ".join(f"{x['time_mix_f32_min_cosine']:.9f}"
                    for x in bh["layers"])
        + f" (gate >= {LAYER_COS_MIN}); after {RWKV_DEPTH} layers the "
        f"factored path vs the kernel path, pooled over the sequence "
        f"{bh['pooled_cosine']:.9f} (gate >= {RWKV_DEPTH_COS_MIN}), least "
        f"per-row {bh['row_min_cosine']:.9f}")
    gate(all(x["time_mix_f32_min_cosine"] >= LAYER_COS_MIN
             for x in bh["layers"]), "(e) a factored time-mix layer differs "
         "from the kernel's")
    gate(bh["pooled_cosine"] >= RWKV_DEPTH_COS_MIN,
         f"(e) after {RWKV_DEPTH} layers the factored path has drifted: "
         f"{bh['pooled_cosine']}")

    # (d) smollm-360m training with microbatches
    tr = launch_train(dev, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    for k, r in tr["runs"].items():
        log(f"[launch] (d) {r['description']} at {TRAIN_BATCH} x {TRAIN_SEQ}:"
            f" loss {r['loss']!r}, grad norm {r['grad_norm']:.6f}, step "
            f"{r['ms']:.1f} ms, peak {r['peak_gb']:.2f} GB, launches "
            f"{json.dumps(r['launches'])}")
    log(f"[launch] (d) microbatches {tr['microbatches']} vs 1: loss rel diff "
        f"{tr['loss_rel_diff']:.3e} (gate <= {LAUNCH_LOSS_REL:g}), least "
        f"per-leaf update cosine {tr['update_min_cosine']:.6f} "
        f"({tr['update_least_leaf']}; gate >= {LAUNCH_UPDATE_COS})")
    gate(tr["microbatches"] == 2, f"(d) default_microbatches "
         f"{tr['microbatches']}")
    per = tr["flash_per_loss"]
    gate(tr["runs"]["2"]["launches"]["flash_attention"] == 2 * per and
         tr["runs"]["1"]["launches"]["flash_attention"] == per,
         "(d) flash launches")
    gate(tr["loss_rel_diff"] <= LAUNCH_LOSS_REL, "(d) losses differ")
    gate(tr["update_min_cosine"] >= LAUNCH_UPDATE_COS, "(d) updates differ")

    # (g) the dry run's count held against the card on (a) and (d)
    checks = {"(a) prefill": ll["dryrun"]}
    checks.update({f"(d) {k} microbatch{'es' if k != '1' else ''}":
                   r["dryrun"] for k, r in tr["runs"].items()})
    for tag, g in checks.items():
        log(dryrun_log(tag, g))
        gate(g["counts_equal"], f"(g) {tag}: the meta count differs from "
             f"the card's")
        gate(g["roofline_fraction"] <= 1.0, f"(g) {tag}: the roofline time "
             f"exceeds the measured step")
        gate(g["memory_rel_err"] <= DRYRUN_MEM_REL, f"(g) {tag}: the memory "
             f"estimate is {100 * g['memory_rel_err']:.1f}% off")

    # (f) the serving CLI
    kern = zero_counts()
    embeds, serve_s = _synced_s(lambda: serve_main(LAUNCH_SERVE_ARGS))
    serve_counts = read_counts(kern)
    serve_cfg = get_arch(LAUNCH_SERVE_ARGS[1])
    log(f"[launch] (f) launch.serve.main({LAUNCH_SERVE_ARGS}): "
        f"{embeds.shape} embeddings in {serve_s:.2f} s, launches "
        f"{json.dumps(serve_counts)}")
    gate(embeds.shape == (64, serve_cfg.d_model)
         and bool(np.isfinite(embeds).all()), "(f) embeddings")
    # 64 documents in batches of 8: 8 batches, one flash call a layer
    gate(serve_counts["flash_attention"] == 8 * serve_cfg.num_layers,
         f"(f) launches {serve_counts}")

    kernels.append(
        {"name": "flash_attention_hd128_32k", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash.py:101",
         "launches": ll["prefill_launches"]["flash_attention"],
         "max_abs_err": max(e["max_abs_err"] for e in (
             lf["all_rows_vs_plain"], *lf["blocks_vs_plain"].values())),
         "ms": lf["ms"], "plain_ms": lf["plain_ms"],
         "bound_ms": lf["bound_ms"], "bound_by": lf["bound_by"],
         "library_ms": lf["library_ms"]})
    share = want * lf["ms"] / ll["prefill_ms"]
    cudnn = (f"{lf['library_ms']:.4f} ms" if lf["library_ms"] is not None
             else f"refused ({lf['library_refused']})")
    log(f"[times] flash_attention_hd128_32k at {tuple(LONG_FLASH_SHAPE)} "
        f"causal: {lf['ms']:.4f} ms ({lf['ms'] / lf['bound_ms']:.2f}x its "
        f"bound; {lf['flops'] / lf['ms'] / 1e9:.1f} TFLOP/s), plain "
        f"{lf['plain_ms']:.2f} ms, bound {lf['bound_ms']:.4f} ms "
        f"({lf['bound_by']}; {lf['flops']:.4g} FLOP, exponentials "
        f"{lf['exp_bound_ms']:.4f} ms), cuDNN SDPA {cudnn}; {want} "
        f"launches a prefill step, {100 * share:.1f}% of it")
    phase_s = time.perf_counter() - t_phase
    log(f"[launch] phase {phase_s:.1f} s")
    if errors:
        fail(f"[launch] {len(errors)} gates failed: {errors}")
    return {"flash_32k": lf, "llama": ll, "rwkv": rw, "train": tr,
            "serve": {"seconds": serve_s, "launches": serve_counts,
                      "shape": list(embeds.shape)},
            "flash_share_of_prefill": share, "phase_seconds": phase_s}


def _leaf_digest(t) -> str:
    """Two position-weighted sums of a leaf's bits widened to float32
    (exact for bf16), on its device: any changed bit changes them."""
    import torch
    x = t.detach().float().contiguous().view(torch.int32).flatten().long()
    w = torch.arange(x.numel(), device=x.device) % 65521 + 1
    return f"{int(x.sum())}:{int((x * w).sum())}:{x.numel()}"


def _keep_states(trainer) -> list:
    """The state after the last of ``trainer``'s steps, kept as its step
    returns it (the live state: DTensors on a mesh)."""
    kept = []
    inner = trainer._step

    def step(state, batch):
        state, metrics = inner(state, batch)
        kept[:] = [state]
        return state, metrics
    trainer._step = step
    return kept


def _axis_configs(job: dict):
    """(a)'s and (b)'s configs and train configs for a [model_axis] job."""
    import dataclasses
    from repro_torch.config import (InputShape, OptimizerConfig,
                                    TrainConfig, get_arch, get_smoke_arch)
    get = get_smoke_arch if job["smoke"] else get_arch
    work = Path(job["dir"])
    opt = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=job["steps"])
    a = get(TRAIN_ARCH)
    # the mesh checkpoints at its last step, for (c); one device does not
    tc_a = TrainConfig(
        shape=InputShape("axis_a", job["seq"], job["batch"], "train"),
        optimizer=opt, keep_checkpoints=1,
        checkpoint_every=(job["steps"] if job["tag"] == "mesh"
                          else 1_000_000),
        checkpoint_dir=str(work / job["tag"] / "a"))
    b = dataclasses.replace(get(OFF_ARCH), num_layers=job["llama_layers"])
    bb, bs = job["llama_shape"]
    tc_b = TrainConfig(shape=InputShape("axis_b", bs, bb, "train"),
                       optimizer=opt, checkpoint_every=1_000_000,
                       checkpoint_dir=str(work / job["tag"] / "b"))
    return a, tc_a, b, tc_b


def axis_run(job: dict, mesh, device) -> dict:
    """(a) and (b) of [model_axis] on ``mesh`` (None: one device) in this
    process: losses, step times and their communication, peak memory,
    flash launches and the heads each launch saw; (a)'s live state at its
    last step, digested (gathered first on a mesh)."""
    import torch
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.launch.dist import COMM
    from repro_torch.runtime.train_loop import Trainer
    cfg_a, tc_a, cfg_b, tc_b = _axis_configs(job)
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)
    out = {}
    heads = set()
    inner_run = f_ops._flash_run

    def seeing(q, k, *rest):
        heads.add((int(q.shape[2]), int(k.shape[2])))
        return inner_run(q, k, *rest)
    f_ops._flash_run = seeing
    try:
        for tag, cfg, tc, steps in (("a", cfg_a, tc_a, job["steps"]),
                                    ("b", cfg_b, tc_b, 1)):
            heads.clear()
            marks = []
            prof = {}

            def mark(step):
                sync()
                marks.append((step, time.perf_counter(), COMM.seconds,
                              COMM.calls, COMM.bytes))
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            kern = zero_counts()
            with Trainer(cfg, tc, mesh, fail_injector=mark,
                         device=device) as tr:
                kept = _keep_states(tr)
                t0 = time.perf_counter()
                rep = tr.run(steps, resume=False)
                mark(steps)          # the last step's end (after its save)
                wall = time.perf_counter() - t0
                counts = read_counts(kern)
                fallbacks = (tr.ruleset.fallback_report()
                             if tr.ruleset is not None else [])
                digests = {}
                if tag == "a" and mesh is not None:
                    # every rank gathers (a collective), rank 0 digests
                    first = mesh.device_mesh.get_rank() == 0
                    for key, t in flatten_with_paths(
                            tr._checkpoint_tree(kept[-1])):
                        if hasattr(t, "full_tensor"):
                            t = t.full_tensor()
                        if isinstance(t, torch.Tensor) and first:
                            digests[key] = _leaf_digest(t)
                        del t
                elif tag == "a":
                    out["a_params"] = dict(flatten_with_paths(kept[-1][0]))
                if tag == "a" and mesh is not None and job.get("profile"):
                    prof = _profiled_step(tr, kept[-1], steps, device)
                del kept
            steps_s = [b[1] - a[1] for a, b in zip(marks, marks[1:])]
            comm_s = [b[2] - a[2] for a, b in zip(marks, marks[1:])]
            out[tag] = {
                "arch": cfg.name, "layers": cfg.num_layers,
                "shape": [tc.shape.global_batch, tc.shape.seq_len],
                "losses": rep.losses, "wall_seconds": wall,
                "step_seconds": steps_s, "comm_seconds": comm_s,
                "comm_calls": [b[3] - a[3] for a, b in zip(marks, marks[1:])],
                "comm_bytes": [b[4] - a[4] for a, b in zip(marks, marks[1:])],
                "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                                   if cuda else None),
                "launches": counts, "flash_heads": sorted(heads),
                "fallbacks": fallbacks, "digests": digests,
                "profile": prof}
    finally:
        f_ops._flash_run = inner_run
    return out


def _profiled_step(tr, state, step: int, device) -> dict:
    """One more step of ``tr`` from ``state`` on step ``step``'s batch
    under torch.profiler, after the timed ones (``_profiled``). An NCCL
    kernel runs from its launch until its peers join, so a rank that
    waits shows the wait too."""
    from repro_torch.data.loader import device_batch
    batch = device_batch(tr.loader.batch(step), tr.batch_shardings,
                         device=device)
    return _profiled(lambda: tr._step(state, batch))


def model_axis_rank(job_path: str, rank: int) -> None:
    """One rank of [model_axis], [decode_axis], [moe_axis] or
    [rwkv_axis] (``python3 chip_smoke.py --model-axis-rank R JOB``): its
    process group, the (1, 2) mesh, ``axis_run``, ``dax_run``,
    ``moe_axis_run`` or ``rwkv_axis_run`` (by the job's "phase"); writes
    ``rank{R}.json`` (and the last three's tensors, ``tensors{R}.pt``)
    beside the job."""
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist
    from repro_torch.launch.dist import init_spmd
    from repro_torch.launch.mesh import make_test_mesh
    job = json.loads(Path(job_path).read_text())
    device = init_spmd(job["device"], rank=rank, world_size=job["world"],
                       init_method=f"tcp://localhost:{job['port']}")
    mesh = make_test_mesh(*job["mesh"], device=job["device"])
    out = {"rank": rank, "device": str(device),
           "backend": dist.get_backend(),
           "coordinate": list(mesh.device_mesh.get_coordinate())}
    if job.get("phase") in ("decode_axis", "moe_axis", "rwkv_axis"):
        import torch
        run = {"decode_axis": dax_run, "moe_axis": moe_axis_run,
               "rwkv_axis": rwkv_axis_run}[job["phase"]]
        res, tensors = run(job, mesh, device)
        torch.save(tensors, Path(job_path).parent / f"tensors{rank}.pt")
        out.update(res)
    else:
        out.update(axis_run(job, mesh, device))
    dist.barrier()
    dist.destroy_process_group()
    (Path(job_path).parent / f"rank{rank}.json").write_text(
        json.dumps(out, default=str))


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(job: dict) -> list:
    """Start ``job["world"]`` ranks of this script on ``job`` and wait for
    them; any rank that fails or outlives AXIS_RANK_TIMEOUT fails the
    phase (all are stopped). Their results, in rank order."""
    import os
    phase = job.get("phase", "model_axis")
    work = Path(job["dir"]) / job["tag"]
    work.mkdir(parents=True, exist_ok=True)
    job = dict(job, port=_free_port())
    path = work / "job.json"
    path.write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--model-axis-rank",
         str(r), str(path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(job["world"])]
    logs, deadline = [], time.monotonic() + AXIS_RANK_TIMEOUT
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        fail(f"[{phase}] a rank outlived {AXIS_RANK_TIMEOUT} s")
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode:
            fail(f"[{phase}] rank {r} exited {p.returncode}:\n"
                 + text[-4000:])
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(job["world"])]


def _leaf_cosine(a, b) -> float:
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    den = (a.norm() * b.norm()).item()
    return (a @ b).item() / den if den else float(a.equal(b))


def model_axis_phase(dev, kernels: list, smoke: bool = False) -> dict:
    """[model_axis]: (a), (b) and (c) above, on two SPMD ranks against
    one device, and the ``flash_attention_model_axis`` entry of
    ``kernels`` (the LSE form at a rank's shard of (b)'s call)."""
    import gc
    import shutil

    import torch
    from repro_torch import checkpoint as t_ckpt
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.launch import mesh as t_mesh
    from repro_torch.runtime.train_loop import Trainer

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(AXIS_DIR, ignore_errors=True)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    world = AXIS_MESH[0] * AXIS_MESH[1]
    job = {"world": world, "mesh": list(AXIS_MESH), "device": dev.type,
           "smoke": smoke, "steps": AXIS_STEPS, "batch": AXIS_BATCH,
           "seq": TRAIN_SEQ, "llama_layers": AXIS_LLAMA_LAYERS,
           "llama_shape": list(AXIS_LLAMA_SHAPE), "dir": str(AXIS_DIR),
           "profile": cards >= world}
    where = (f"{world} cards" if cards >= world else
             f"{dev.type}:0 x{world}" if dev.type == "cuda" else
             f"the CPU x{world}")
    single = axis_run(dict(job, tag="single"), None, dev)
    a_params = single.pop("a_params")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(dict(job, tag="mesh"))
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    log(f"[model_axis] mesh {tuple(AXIS_MESH)} over {where}: backend "
        f"{r0['backend']}, ranks on "
        + ", ".join(r["device"] for r in ranks)
        + f"; {ranks_s:.1f} s for the ranks (start-up included)")
    log(f"[model_axis] (a) {r0['a']['arch']} fallbacks: "
        + "; ".join(r0["a"]["fallbacks"]))
    report = {"mesh": list(AXIS_MESH), "where": where,
              "backend": r0["backend"], "single": single, "ranks": ranks,
              "ranks_seconds": ranks_s}
    for tag in ("a", "b"):
        one = single[tag]
        rel = [abs(x - y) / abs(y) for x, y in zip(r0[tag]["losses"],
                                                   one["losses"])]
        agree = all(r[tag]["losses"] == r0[tag]["losses"] for r in ranks)
        report[tag] = {"loss_rel": rel, "ranks_agree": agree}
        per_rank = "; ".join(
            f"rank {r['rank']}: steps "
            + ", ".join(f"{1e3 * t:.1f}" for t in r[tag]["step_seconds"])
            + " ms, comm " + ", ".join(f"{1e3 * t:.1f}"
                                       for t in r[tag]["comm_seconds"])
            + f" ms ({', '.join(str(n) for n in r[tag]['comm_calls'])} "
            f"calls), peak {r[tag]['peak_memory_gb']} GB, flash "
            f"{r[tag]['launches']['flash_attention']} launches on "
            f"(heads, KV heads) {r[tag]['flash_heads']}"
            + (f"; one more step under torch.profiler "
               f"{r[tag]['profile']['step_ms']:.1f} ms, NCCL kernels "
               f"{r[tag]['profile']['nccl_device_ms']:.1f} of "
               f"{r[tag]['profile']['device_ms']:.1f} device ms"
               if r[tag]["profile"] else "")
            for r in ranks)
        log(f"[model_axis] ({tag}) {one['arch']} ({one['layers']} layers) "
            f"at {one['shape'][0]} x {one['shape'][1]}: losses mesh "
            + ", ".join(repr(x) for x in r0[tag]["losses"]) + "; one device "
            + ", ".join(repr(x) for x in one["losses"])
            + f"; |rel| max {max(rel):.3e} (bar {AXIS_LOSS_REL[tag]:g}); "
            f"ranks "
            f"agree {agree}. One device: steps "
            + ", ".join(f"{1e3 * t:.1f}" for t in one["step_seconds"])
            + f" ms, peak {one['peak_memory_gb']} GB, flash "
            f"{one['launches']['flash_attention']} launches on "
            f"{one['flash_heads']}. Mesh: {per_rank}")
        if not agree or not max(rel) <= AXIS_LOSS_REL[tag]:
            fail(f"[model_axis] ({tag}) losses {r0[tag]['losses']} against "
                 f"{one['losses']}")
        for r in ranks if dev.type == "cuda" else ():
            other = {n: c for n, c in r[tag]["launches"].items()
                     if n != "flash_attention" and c}
            if not r[tag]["launches"]["flash_attention"] or other:
                fail(f"[model_axis] ({tag}) rank {r['rank']} launched "
                     f"{r[tag]['launches']}")
    # a rank's heads of (b): its query heads with its KV heads when those
    # split the model axis, else the KV heads of its own query groups
    # (kernels.flash_attention.ops.HeadShards)
    cfg_b = _axis_configs(dict(job, tag="x"))[2]
    hl = cfg_b.num_heads // AXIS_MESH[1]
    groups = cfg_b.num_heads // cfg_b.num_kv_heads
    want_heads = [[hl, cfg_b.num_kv_heads // AXIS_MESH[1]
                   if cfg_b.num_kv_heads % AXIS_MESH[1] == 0
                   else 1 if groups % hl == 0 else hl]]
    if any(r["b"]["flash_heads"] != want_heads for r in ranks):
        fail(f"[model_axis] (b) flash ran on "
             f"{[r['b']['flash_heads'] for r in ranks]}, not {want_heads}")

    # (c) the mesh's last checkpoint onto a one-device mesh, bitwise
    cfg_a, tc_a = _axis_configs(dict(job, tag="mesh"))[:2]
    one_mesh = t_mesh.make_test_mesh(1, 1, device=dev)
    t0 = time.perf_counter()
    with Trainer(cfg_a, tc_a, one_mesh, device=dev) as tr:
        state, step = tr.restore_latest()
        tree = tr._checkpoint_tree(state)
    restore_s = time.perf_counter() - t0
    manifest = json.loads((Path(tc_a.checkpoint_dir) / f"step_{step:09d}"
                           / "manifest.json").read_text())
    got = {k: _leaf_digest(t) for k, t in flatten_with_paths(tree)
           if isinstance(t, torch.Tensor)}
    want = r0["a"]["digests"]
    differ = sorted(k for k in want if got.get(k) != want[k])
    log(f"[model_axis] (c) the step-{step} checkpoint of the mesh "
        f"(signature {manifest['mesh_signature']!r}) restored on a "
        f"one-device mesh in {restore_s:.2f} s: {len(want)} leaves, "
        f"{len(differ)} differ from the ranks' gathered state")
    signature = "data={}xmodel={}".format(*AXIS_MESH)
    if step != AXIS_STEPS or differ or set(got) != set(want) or \
            manifest["mesh_signature"] != signature:
        fail(f"[model_axis] (c) step {step}, signature "
             f"{manifest['mesh_signature']!r}, differing leaves {differ}")
    cos = {k: _leaf_cosine(t, a_params[k])
           for k, t in flatten_with_paths(state[0])}
    worst = min(cos, key=cos.get)
    log(f"[model_axis] (a) step-{step} params, mesh against one device: "
        f"per-leaf cosine >= {cos[worst]:.7f} ({worst}; bar "
        f"{AXIS_PARAM_COS})")
    if not cos[worst] >= AXIS_PARAM_COS:
        fail(f"[model_axis] (a) params cosine {cos[worst]} at {worst}")
    report["c"] = {"step": step, "leaves": len(want), "differ": differ,
                   "restore_seconds": restore_s,
                   "signature": manifest["mesh_signature"]}
    report["a"]["param_cosine_min"] = cos[worst]
    del state, tree, a_params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the flash entry at a rank's share of (b)'s call
    checks = train_flash_checks(dev, AXIS_FLASH_SHAPE)
    for name, c in checks.items():
        if not (c["out_bitwise"] and c["out_ok"] and c["lse_ok"]
                and c["lse_finite"]):
            fail(f"[model_axis] flash LSE form ({name}) at "
                 f"{AXIS_FLASH_SHAPE} fails: {c}")
    ft = train_flash_times(dev, AXIS_FLASH_SHAPE)
    launches = sum(r["b"]["launches"]["flash_attention"] for r in ranks)
    kernels.append(
        {"name": "flash_attention_model_axis", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash.py:101",
         "launches": launches,
         "max_abs_err": max(max(c["out_max_abs_err"], c["lse_max_abs_err"])
                            for c in checks.values()),
         "ms": ft["lse_ms"], "plain_ms": ft["plain_lse_ms"],
         "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
         "library_ms": ft["library_ms"]})
    log(f"[times] flash_attention_model_axis at {tuple(AXIS_FLASH_SHAPE)} "
        f"causal (a rank's heads of (b)): the LSE form {ft['lse_ms']:.4f} "
        f"ms, plain {ft['plain_lse_ms']:.4f} ms, bound "
        f"{ft['bound_ms']:.5f} ms ({ft['bound_by']}), library "
        f"{ft['library_ms']} ({ft['library_backend']}); max abs err "
        + ", ".join(f"{n} out {c['out_max_abs_err']:.3e} lse "
                    f"{c['lse_max_abs_err']:.3e}" for n, c in checks.items())
        + f"; {launches} launches over the ranks in (b)")
    report["flash"] = {"checks": checks, "times": ft}
    shutil.rmtree(AXIS_DIR, ignore_errors=True)
    report["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[model_axis] phase {report['phase_seconds']:.1f} s")
    return report


def _dax_configs(job: dict):
    """(a)'s and (b)'s configs for a [decode_axis] job."""
    import dataclasses
    from repro_torch.config import get_arch, get_smoke_arch
    get = get_smoke_arch if job["smoke"] else get_arch
    return (dataclasses.replace(get(job["archs"][0]),
                                num_layers=job["llama_layers"]),
            get(job["archs"][1]))


def _cache_layout(cache, shardings=None) -> dict:
    """Every cache leaf's placements (one device: "one device"), the
    plan's placements for it, and its local shape and bytes."""
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.sharding.rules import placements
    want = dict(flatten_with_paths(shardings)) if shardings else {}
    out = {}
    for key, t in flatten_with_paths(cache):
        loc = t.to_local() if hasattr(t, "to_local") else t
        out[key] = {
            "placements": (str(list(t.placements)) if hasattr(t, "placements")
                           else "one device"),
            "plan": (str(placements(want[key], t.shape)) if key in want
                     else None),
            "local_shape": list(loc.shape),
            "local_bytes": loc.numel() * loc.element_size()}
    return out


def dax_run(job: dict, mesh, device) -> tuple:
    """(a) and (b) of [decode_axis] on ``mesh`` (a (1, 2) mesh of SPMD
    ranks, or a 1 x 1 mesh: one device) in this process: (the scalars,
    the tensors: (a)'s two logits, (b)'s prefill and per-step logits, the
    one device's (b) cache or a rank's own shard of it). On one device
    (b) first runs ``generate``, whose tokens the decode steps take; on
    the mesh they come from ``job["tokens"]`` and ``generate`` runs
    after the steps."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.config import InputShape
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.common import full_value
    from repro_torch.optimizer.adamw import zip_map
    from repro_torch.runtime.serve_loop import generate
    from repro_torch.sharding.rules import place
    cfg_a, cfg_b = _dax_configs(job)
    cuda = torch.device(device).type == "cuda"
    spmd = getattr(mesh, "device_mesh", None) is not None
    seq = job["seq"]

    def timed(fn):
        return _timed(fn, cuda)

    def fresh():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    def draw(cfg, seed, n):
        gen = torch.Generator(device).manual_seed(seed)
        return torch.randint(1, cfg.vocab_size, (1, n), generator=gen,
                             device=device, dtype=torch.int32)

    def flat(x):
        return full_value(x)[0].float().cpu()

    def placed_by(plan):
        """The params placed by ``plan``'s shardings, once, before its
        timed calls (its step's own placement is then a no-op)."""
        return (zip_map(place, params, plan.arg_shardings[0]) if spmd
                else params)

    heads = set()
    inner = f_ops._flash_run

    def seeing(q, k, *rest):
        heads.add((int(q.shape[2]), int(k.shape[2])))
        return inner(q, k, *rest)
    f_ops._flash_run = seeing
    out, tensors = {}, {}
    try:
        # (a) llama3-8b cut to DAX_LLAMA_LAYERS: PREFILL_32K, then a
        # LAUNCH_SEQ-slot cache and DECODE_32K's step
        fresh()
        params = build_model(cfg_a).init(
            torch.Generator(device).manual_seed(0))
        tokens = draw(cfg_a, 30, seq)
        plan = steps.make_prefill_plan(
            cfg_a, InputShape("prefill_32k_b1", seq, 1, "prefill"), mesh,
            last_logit=True)
        placed, place_s, _, _ = timed(lambda: placed_by(plan))
        kern = zero_counts()
        (last, cache), t, calls, comm = timed(
            lambda: plan.step_fn(placed, {"tokens": tokens}))
        a = {"layers": cfg_a.num_layers, "place_ms": [1e3 * place_s],
             "prefill_ms": 1e3 * t,
             "prefill_comm_calls": calls, "prefill_comm_s": comm,
             "launches": read_counts(kern), "flash_heads": sorted(heads),
             "fallbacks": plan.ruleset.fallback_report()}
        tensors["a_last"] = flat(last)
        del last, cache, placed
        # as [launch] (b) and generate: the model's prefill of seq - 1
        # tokens into seq slots, on the params placed by the decode plan
        dplan = steps.make_plan(
            cfg_a, InputShape("decode_32k_b1", seq, 1, "decode"), mesh)
        model = steps.build_model_for_scale(cfg_a, ruleset=dplan.ruleset)
        model.prefill_last_only = True
        placed, place_s, _, _ = timed(lambda: placed_by(dplan))
        a["place_ms"].append(1e3 * place_s)
        kern = zero_counts()
        (_, cache), t, calls, comm = timed(
            lambda: model.prefill(placed, tokens[:, :-1], cache_len=seq))
        a.update(cache_prefill_ms=1e3 * t, cache_prefill_comm_calls=calls,
                 cache_prefill_comm_s=comm,
                 cache_prefill_launches=read_counts(kern))
        batch = {"tokens": tokens[:, -1:], "pos": seq - 1, "cache": cache}
        kern = zero_counts()
        reps = []
        for _ in range(job["decode_reps"] + 1):
            (dec, new), t, calls, comm = timed(
                lambda: dplan.step_fn(placed, batch))
            reps.append((1e3 * t, calls, comm))
            a["decode_cache"] = _cache_layout(new, dplan.out_shardings[1])
            del new
        a.update(decode_launches=read_counts(kern),
                 decode_first_ms=reps[0][0],
                 decode_ms=[r[0] for r in reps[1:]],
                 decode_comm_calls=reps[-1][1],
                 decode_comm_s=[r[2] for r in reps[1:]], peak_gb=peak())
        tensors["a_decode"] = flat(dec)
        out["a"] = a
        del params, placed, cache, batch, dec, tokens, plan, dplan, model

        # (b) smollm-360m FULL: a DAX_PROMPT-token prompt into a
        # LAUNCH_SEQ-slot cache, DAX_STEPS decode plan steps, generate
        fresh()
        params = build_model(cfg_b).init(
            torch.Generator(device).manual_seed(0))
        prompt = draw(cfg_b, 31, job["prompt"])
        dshape = InputShape("decode_32k_b1", seq, 1, "decode")
        b = {}
        n_tok = job["steps"] + 1

        dplan = steps.make_plan(cfg_b, dshape, mesh)
        b["fallbacks"] = dplan.ruleset.fallback_report()
        # the model generate drives, on the params placed by the plan
        model = steps.build_model_for_scale(cfg_b, ruleset=dplan.ruleset)
        placed, place_s, _, _ = timed(lambda: placed_by(dplan))
        b["place_ms"] = 1e3 * place_s

        def run_generate():
            toks, t, calls, comm = timed(lambda: generate(
                model, placed, prompt, n_tok, cache_len=seq))
            b.update(generate_tokens=toks[0].tolist(),
                     generate_ms=1e3 * t, generate_comm_calls=calls,
                     generate_comm_s=comm)
            return toks
        toks = (np.asarray([job["tokens"]], np.int32) if spmd
                else run_generate())
        # the prompt into seq slots, as generate fills its cache (only the
        # last position's logits)
        pmodel = steps.build_model_for_scale(cfg_b, ruleset=dplan.ruleset)
        pmodel.prefill_last_only = True
        heads.clear()
        kern = zero_counts()
        (last, cache), t, calls, comm = timed(
            lambda: pmodel.prefill(placed, prompt, cache_len=seq))
        b.update(prefill_ms=1e3 * t, prefill_comm_calls=calls,
                 prefill_comm_s=comm, prefill_launches=read_counts(kern),
                 prefill_heads=sorted(heads),
                 prefill_cache=_cache_layout(cache))
        tensors["b_last"] = flat(last[:, -1])
        tok = torch.as_tensor(toks, device=device)
        logits, b["steps"] = [], []
        kern = zero_counts()
        for i in range(job["steps"]):
            (lg, cache), t, calls, comm = timed(lambda: dplan.step_fn(
                placed, {"tokens": tok[:, i:i + 1], "pos": job["prompt"] + i,
                         "cache": cache}))
            layout = _cache_layout(cache, dplan.out_shardings[1])
            b["steps"].append({
                "ms": 1e3 * t, "comm_calls": calls, "comm_s": comm,
                "placements": sorted({v["placements"]
                                      for v in layout.values()}),
                "plan_placements": sorted({v["plan"]
                                           for v in layout.values()}),
                "local_bytes": sum(v["local_bytes"]
                                   for v in layout.values())})
            logits.append(flat(lg))
        b["decode_launches"] = read_counts(kern)
        b["layer_shape"] = layout["p0/k"]["local_shape"]
        tensors["b_steps"] = torch.stack(logits)
        tensors["b_cache"] = {k: (t.to_local() if spmd else t)
                              for k, t in flatten_with_paths(cache)}
        # the dimension the model axis splits (None: replicated)
        tensors["b_cache_dim"] = next(
            (p.dim for p in getattr(cache["p0"]["k"], "placements", ())
             if p.is_shard()), None)
        if spmd and job.get("profile"):
            b["profile"] = _profiled(lambda: dplan.step_fn(placed, {
                "tokens": tok[:, -1:], "pos": job["prompt"] + job["steps"],
                "cache": cache}))
        del cache, lg, last
        b["peak_gb"] = peak()
        if spmd:
            run_generate()
        out["b"] = b
    finally:
        f_ops._flash_run = inner
    return out, tensors


def _profiled(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its ms (the profiler's
    cost included) and the device time of NCCL's kernels against all
    kernels'."""
    import torch
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    with prof:
        fn()
        torch.cuda.synchronize()
    out = {"step_ms": 1e3 * (time.perf_counter() - t0)}
    total = comm = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "device_time_total", None)
        t = getattr(e, "cuda_time_total", 0.0) if t is None else t
        total += t
        if "nccl" in e.key.lower():
            comm += t
    out.update(nccl_device_ms=comm / 1e3, device_ms=total / 1e3)
    return out


def _gb(x) -> str:
    return "not measured" if x is None else f"{x:.2f}"


def _top1_in_ties(got, want) -> bool:
    """Whether ``got``'s top-1 token is one of ``want``'s tied top ones
    (bf16 products cast to f32 tie often; argmax takes the first)."""
    return bool(want[int(got.argmax())] == want.max())


def _gap(x) -> float:
    """The top-2 gap of a logits vector over its top logit's size."""
    import torch
    top = torch.topk(x, 2).values
    return ((top[0] - top[1]) / top[0].abs().clamp(min=1e-30)).item()


def decode_axis_phase(dev, kernels: list, smoke: bool = False) -> dict:
    """[decode_axis]: (a) and (b) above, on two SPMD ranks against one
    device, and the ``flash_attention_decode_axis`` entry of ``kernels``
    (the kernel at a rank's share of (a)'s prefill)."""
    import gc
    import shutil

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(DAX_DIR, ignore_errors=True)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    world = AXIS_MESH[0] * AXIS_MESH[1]
    job = {"phase": "decode_axis", "world": world, "mesh": list(AXIS_MESH),
           "device": dev.type, "smoke": smoke, "seq": LAUNCH_SEQ,
           "archs": [LAUNCH_ARCH, TRAIN_ARCH],
           "llama_layers": DAX_LLAMA_LAYERS, "prompt": DAX_PROMPT,
           "steps": DAX_STEPS, "decode_reps": DAX_DECODE_REPS,
           "dir": str(DAX_DIR), "profile": cards >= world}
    where = (f"{world} cards" if cards >= world else
             f"{dev.type}:0 x{world}" if dev.type == "cuda" else
             f"the CPU x{world}")
    errors = []

    def gate(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)
            log(f"[decode_axis] GATE FAILED: {msg}")

    from repro_torch.launch import mesh as t_mesh
    one, one_t = dax_run(dict(job, tag="single"),
                         t_mesh.make_test_mesh(1, 1, device=dev), dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(dict(job, tag="mesh",
                             tokens=one["b"]["generate_tokens"]))
    ranks_s = time.perf_counter() - t0
    rt = [torch.load(DAX_DIR / "mesh" / f"tensors{r['rank']}.pt",
                     map_location="cpu", weights_only=False) for r in ranks]
    r0 = ranks[0]
    log(f"[decode_axis] mesh {tuple(AXIS_MESH)} over {where}: backend "
        f"{r0['backend']}, ranks on " + ", ".join(r["device"] for r in ranks)
        + f"; {ranks_s:.1f} s for the ranks (start-up included)")
    report = {"mesh": list(AXIS_MESH), "where": where,
              "backend": r0["backend"], "single": one, "ranks": ranks,
              "ranks_seconds": ranks_s}

    # (a)
    a1 = one["a"]
    cos = {n: _cosine(rt[0][n], one_t[n]) for n in ("a_last", "a_decode")}
    top = {n: _top1_in_ties(rt[0][n], one_t[n]) for n in cos}
    per_rank = "; ".join(
        f"rank {r['rank']}: prefill {r['a']['prefill_ms']:.1f} ms "
        f"({r['a']['prefill_comm_calls']} collectives, "
        f"{1e3 * r['a']['prefill_comm_s']:.1f} ms), flash "
        f"{r['a']['launches']['flash_attention']} launches on (heads, KV "
        f"heads) {r['a']['flash_heads']}; the params placed by each plan "
        "once, outside the timed calls, in "
        + ", ".join(f"{t:.1f}" for t in r["a"]["place_ms"])
        + f" ms; cache prefill "
        f"{r['a']['cache_prefill_ms']:.1f} ms; decode step "
        + ", ".join(f"{t:.1f}" for t in r["a"]["decode_ms"])
        + f" ms (first {r['a']['decode_first_ms']:.1f}; "
        f"{r['a']['decode_comm_calls']} collectives, "
        + ", ".join(f"{1e3 * t:.1f}" for t in r["a"]["decode_comm_s"])
        + f" ms of them), cache {r['a']['decode_cache']['p0/k']}; peak "
        f"{_gb(r['a']['peak_gb'])} GB" for r in ranks)
    log(f"[decode_axis] (a) {job['archs'][0]} ({a1['layers']} layers) at "
        f"{LAUNCH_SEQ} tokens, batch 1: one device prefill "
        f"{a1['prefill_ms']:.1f} ms, flash "
        f"{a1['launches']['flash_attention']} launches on "
        f"{a1['flash_heads']}, cache prefill {a1['cache_prefill_ms']:.1f} "
        f"ms, decode step " + ", ".join(f"{t:.1f}" for t in a1["decode_ms"])
        + f" ms, peak {_gb(a1['peak_gb'])} GB. Mesh: {per_rank}. Against one "
        f"device: last logits cosine {cos['a_last']:.7f}, the decode step's "
        f"{cos['a_decode']:.7f} (gate >= {LAUNCH_DECODE_COS}); top-1 among "
        f"one device's ties: {top['a_last']}, {top['a_decode']}; rule "
        f"fallbacks " + "; ".join(r0["a"]["fallbacks"]))
    cfg_a = _dax_configs(job)[0]
    hl = cfg_a.num_heads // AXIS_MESH[1]
    groups = cfg_a.num_heads // cfg_a.num_kv_heads
    want_heads = [[hl, cfg_a.num_kv_heads // AXIS_MESH[1]
                   if cfg_a.num_kv_heads % AXIS_MESH[1] == 0
                   else 1 if groups % hl == 0 else hl]]
    for n in cos:
        gate(cos[n] >= LAUNCH_DECODE_COS and top[n],
             f"(a) {n}: cosine {cos[n]}, top-1 among ties {top[n]}")
    for r in ranks:
        launches = r["a"]["launches"]
        gate(launches["flash_attention"] == cfg_a.num_layers and not any(
            c for k, c in launches.items() if k != "flash_attention"),
            f"(a) rank {r['rank']} launched {launches}")
        gate(r["a"]["flash_heads"] == want_heads,
             f"(a) rank {r['rank']} flash on {r['a']['flash_heads']}, not "
             f"{want_heads}")
        layout = r["a"]["decode_cache"]
        gate(all(v["placements"] == v["plan"] for v in layout.values()),
             f"(a) rank {r['rank']} decode cache {layout['p0/k']}")

    # (b)
    b1 = one["b"]
    steps_cos = [_cosine(g, w) for g, w in zip(rt[0]["b_steps"],
                                               one_t["b_steps"])]
    steps_top = [_top1_in_ties(g, w) for g, w in zip(rt[0]["b_steps"],
                                                     one_t["b_steps"])]
    last_cos = _cosine(rt[0]["b_last"], one_t["b_last"])
    one_bytes = sum(t.numel() * t.element_size()
                    for t in one_t["b_cache"].values())
    # each layer's cache gathered from the ranks' shards, in rank order
    # along the sequence (the (1, 2) mesh's model coordinate)
    order = sorted(range(len(ranks)), key=lambda i: ranks[i]["coordinate"])
    dim = rt[0]["b_cache_dim"]
    layer_cos = {}
    for key, want in one_t["b_cache"].items():
        got = (rt[0]["b_cache"][key] if dim is None else torch.cat(
            [rt[i]["b_cache"][key] for i in order], dim=dim)).to(want.device)
        layer_cos[key] = [_cosine(got[g], want[g])
                          for g in range(want.shape[0])]
    worst = min(min(v) for v in layer_cos.values())
    cfg_b = _dax_configs(job)[1]
    for r in ranks:
        for i, st in enumerate(r["b"]["steps"]):
            gate(st["placements"] == st["plan_placements"] == [
                "[Replicate(), Shard(dim=2)]"],
                f"(b) rank {r['rank']} step {i} cache placed "
                f"{st['placements']}, the plan {st['plan_placements']}")
            gate(2 * st["local_bytes"] == one_bytes,
                 f"(b) rank {r['rank']} step {i}: {st['local_bytes']} local "
                 f"bytes against {one_bytes} on one device")
    gate(last_cos >= LAUNCH_DECODE_COS and _top1_in_ties(rt[0]["b_last"],
                                                         one_t["b_last"]),
         f"(b) prefill last logits cosine {last_cos}")
    gate(all(c >= LAUNCH_DECODE_COS for c in steps_cos) and all(steps_top),
         f"(b) step logits cosine {steps_cos}, top-1 among ties {steps_top}")
    gate(worst >= DAX_CACHE_COS,
         f"(b) a layer's cache cosine {worst} < {DAX_CACHE_COS}")
    # generate: equal up to the first one-device near-tie
    gaps = [_gap(one_t["b_last"])] + [_gap(x) for x in one_t["b_steps"]]
    mesh_tok = [r["b"]["generate_tokens"] for r in ranks]
    want_tok = b1["generate_tokens"]
    first = next((i for i, (x, y) in enumerate(zip(mesh_tok[0], want_tok))
                  if x != y), None)
    gate(all(t == mesh_tok[0] for t in mesh_tok),
         f"(b) the ranks' generate tokens differ: {mesh_tok}")
    gate(first is None or gaps[first] < DAX_TIE_REL,
         f"(b) generate differs at token {first} where the one-device top-2 "
         f"gap is {gaps[first] if first is not None else None}")
    comm_b = [st["comm_calls"] for st in r0["b"]["steps"]]
    log(f"[decode_axis] (b) {cfg_b.name} ({cfg_b.num_layers} layers, "
        f"{cfg_b.num_heads} heads over {cfg_b.num_kv_heads}): prompt "
        f"{DAX_PROMPT} into {LAUNCH_SEQ} slots; one device: generate of "
        f"{DAX_STEPS + 1} tokens {b1['generate_ms']:.1f} ms, prefill "
        f"{b1['prefill_ms']:.1f} ms, steps "
        + ", ".join(f"{st['ms']:.1f}" for st in b1["steps"])
        + f" ms, peak {_gb(b1['peak_gb'])} GB, cache {one_bytes} bytes. "
        + "; ".join(
            f"rank {r['rank']}: params placed once in "
            f"{r['b']['place_ms']:.1f} ms; prefill "
            f"{r['b']['prefill_ms']:.1f} ms "
            f"({r['b']['prefill_comm_calls']} collectives, "
            f"{1e3 * r['b']['prefill_comm_s']:.1f} ms; flash "
            f"{r['b']['prefill_launches']['flash_attention']} launches on "
            f"{r['b']['prefill_heads']}), prefill cache "
            f"{r['b']['prefill_cache']['p0/k']['placements']}, steps "
            + ", ".join(f"{st['ms']:.1f}" for st in r["b"]["steps"])
            + f" ms ({r['b']['steps'][-1]['comm_calls']} collectives a step, "
            + ", ".join(f"{1e3 * st['comm_s']:.1f}" for st in r["b"]["steps"])
            + f" ms of them), cache {r['b']['steps'][-1]['placements']}, "
            f"{r['b']['steps'][-1]['local_bytes']} local bytes (a layer's "
            f"shard {r['b']['layer_shape']}), peak {_gb(r['b']['peak_gb'])} GB"
            + (f"; one more step under torch.profiler "
               f"{r['b']['profile']['step_ms']:.1f} ms, NCCL kernels "
               f"{r['b']['profile']['nccl_device_ms']:.2f} of "
               f"{r['b']['profile']['device_ms']:.2f} device ms"
               if r["b"].get("profile") else "")
            for r in ranks)
        + f". Against one device: prefill last logits cosine {last_cos:.7f};"
        f" steps " + ", ".join(f"{c:.7f}" for c in steps_cos)
        + f" (gate >= {LAUNCH_DECODE_COS}), top-1 among ties {all(steps_top)};"
        f" each layer's gathered cache cosine >= {worst:.7f} (gate >= "
        f"{DAX_CACHE_COS}); the decode fallbacks "
        + "; ".join(r0["b"]["fallbacks"]))
    log(f"[decode_axis] (b) generate on the mesh {r0['b']['generate_ms']:.1f}"
        f" ms ({r0['b']['generate_comm_calls']} collectives): "
        f"{mesh_tok[0]}; one device {b1['generate_ms']:.1f} ms: {want_tok}; "
        f"first difference at {first} (the one-device top-2 gaps over the "
        f"top logit: " + ", ".join(f"{g:.2e}" for g in gaps) + ")")
    report["a"] = {"cosine": cos, "top1": top}
    report["b"] = {"prefill_cosine": last_cos, "step_cosine": steps_cos,
                   "step_top1": steps_top, "layer_cosine": layer_cos,
                   "layer_cosine_min": worst, "one_device_bytes": one_bytes,
                   "generate_first_difference": first, "gaps": gaps,
                   "comm_calls_a_step": comm_b}
    del rt, one_t
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the flash kernel at a rank's share of (a)'s prefill
    lf = long_flash(dev, DAX_FLASH_SHAPE)
    for start, e in lf["blocks_vs_plain"].items():
        gate(e["ok"], f"flash at {DAX_FLASH_SHAPE}, rows {start}: disagrees "
             f"with its plain version ({e})")
    gate(lf["all_rows_vs_plain"]["ok"] and lf["finite"],
         f"flash at {DAX_FLASH_SHAPE}: {lf['all_rows_vs_plain']}")
    launches = sum(r["a"]["launches"]["flash_attention"] for r in ranks)
    err = max([e["max_abs_err"] for e in lf["blocks_vs_plain"].values()]
              + [lf["all_rows_vs_plain"]["max_abs_err"]])
    kernels.append(
        {"name": "flash_attention_decode_axis", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash.py:101",
         "launches": launches, "max_abs_err": err, "ms": lf["ms"],
         "plain_ms": lf["plain_ms"], "bound_ms": lf["bound_ms"],
         "bound_by": lf["bound_by"], "library_ms": lf["library_ms"]})
    log(f"[times] flash_attention_decode_axis at {tuple(DAX_FLASH_SHAPE)} "
        f"causal (a rank's heads of (a)'s prefill): {lf['ms']:.4f} ms, plain "
        f"{lf['plain_ms']:.4f} ms, bound {lf['bound_ms']:.4f} ms "
        f"({lf['bound_by']}, exact pairs; exponentials "
        f"{lf['exp_bound_ms']:.4f} ms), SDPA (cuDNN) {lf['library_ms']}; "
        f"max abs "
        f"err {err:.3e} (every row within LONG_FLASH_TOL: "
        f"{lf['all_rows_vs_plain']['ok']}, "
        f"{lf['all_rows_vs_plain']['max_share_of_bar']:.3f} of the bar); "
        f"{launches} launches over the ranks in (a)'s PREFILL_32K step")
    report["flash"] = lf
    shutil.rmtree(DAX_DIR, ignore_errors=True)
    report["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[decode_axis] phase {report['phase_seconds']:.1f} s")
    if errors:
        fail("[decode_axis] " + "; ".join(errors))
    return report


def capacity_keep(experts, capacity: int):
    """(T, K) bool: the pairs that fit ``capacity`` when counted in
    (t, k)-major order per expert, in numpy (the rule, apart from the
    port's code)."""
    import numpy as np
    flat = experts.reshape(-1).numpy()
    onehot = flat[:, None] == np.arange(int(flat.max()) + 1)
    before = np.cumsum(onehot, axis=0) - onehot
    pos = before[np.arange(flat.size), flat]
    return (pos < capacity).reshape(experts.shape)


def route_faults(one: list, mesh: list, tie: float, capacity) -> dict:
    """Two runs' ``MoERoutes.records()`` compared call by call, each token's
    pairs taken in expert order (the order within a token's K moves no
    position). At the first MoE layer, whose input differs from one
    device's only by the rounding of partial sums: the tokens whose
    expert sets differ must be one-device near-ties (the K-th and
    (K+1)-th log-probabilities within ``tie``), and a kept flag may
    differ, where the sets agree, only on an expert a differing token of
    the chunk moved (its buffer displaced); every other difference there
    is a fault. In every call the second run's kept flags must be the
    capacity rule on its own experts (``capacity_keep`` at
    ``capacity(T)``): any other flag is a fault. Deeper layers take
    inputs that a first layer's displaced pair moved, so their
    differences are counted and not gated; ``shift`` is the largest
    change of a top-(K+1) log-probability where the sets agree, at the
    first layer and at the others."""
    import numpy as np
    import torch
    keys = ("calls", "pairs", "tokens_differ", "at_ties", "kept_differ",
            "displaced", "faults", "shift")
    out = {"first": dict.fromkeys(keys, 0), "deeper": dict.fromkeys(keys, 0),
           "capacity_faults": 0, "call_mismatch": len(one) != len(mesh)}
    for (e1, k1, t1, l1), (e2, k2, t2, l2) in zip(one, mesh):
        K = e1.shape[1]
        s1, i1 = e1.sort(1)
        s2, i2 = e2.sort(1)
        kk1, kk2 = k1.gather(1, i1), k2.gather(1, i2)
        moved = (s1 != s2).any(1)
        tie_tok = (t1[:, K - 1] - t1[:, K]) < tie
        kdiff = (kk1 != kk2) & ~moved[:, None]
        touched = torch.zeros(int(max(s1.max(), s2.max())) + 1,
                              dtype=torch.bool)
        touched[s1[moved].flatten()] = True
        touched[s2[moved].flatten()] = True
        displaced = kdiff & touched[s1]
        same = ~moved
        part = out["first" if l1 == l2 == 0 else "deeper"]
        part["calls"] += 1
        part["pairs"] += e1.numel()
        part["tokens_differ"] += int(moved.sum())
        part["at_ties"] += int((moved & tie_tok).sum())
        part["kept_differ"] += int(kdiff.sum())
        part["displaced"] += int(displaced.sum())
        part["faults"] += int((moved & ~tie_tok).sum()) + int(
            (kdiff & ~displaced).sum())
        if same.any():
            part["shift"] = max(part["shift"], float(
                (t1[same] - t2[same]).abs().max()))
        out["capacity_faults"] += int(
            (capacity_keep(e2, capacity(e2.shape[0])) != k2.numpy()).sum())
        out["call_mismatch"] |= l1 != l2
    out["faults"] = (out["first"]["faults"] + out["capacity_faults"]
                     + int(out["call_mismatch"]) + int(
                         out["first"]["calls"] == 0))
    return out


def _moe_axis_configs(job: dict):
    """(a)'s config and train config and (b)'s config for a [moe_axis]
    job (the SMOKE config for a rehearsal on the CPU)."""
    import dataclasses
    from repro_torch.config import (InputShape, OptimizerConfig,
                                    TrainConfig, get_arch, get_smoke_arch)
    get = get_smoke_arch if job["smoke"] else get_arch
    base = get(job["arch"])
    a = dataclasses.replace(base, num_layers=job["train_layers"])
    bb, bs = job["train_shape"]
    tc = TrainConfig(
        shape=InputShape("moe_axis_a", bs, bb, "train"),
        optimizer=OptimizerConfig(lr=3e-4, warmup_steps=2,
                                  total_steps=job["train_steps"]),
        checkpoint_every=1_000_000,
        checkpoint_dir=str(Path(job["dir"]) / job["tag"] / "a"))
    return a, tc, dataclasses.replace(base, num_layers=job["serve_layers"])


def _timed(fn, cuda: bool):
    """(fn(), host seconds between two synchronizes, the collectives and
    their host seconds in between)."""
    import torch
    from repro_torch.launch.dist import COMM
    if cuda:
        torch.cuda.synchronize()
    t0, c0, s0 = time.perf_counter(), COMM.calls, COMM.seconds
    res = fn()
    if cuda:
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, COMM.calls - c0, COMM.seconds - s0


def moe_axis_run(job: dict, mesh, device) -> tuple:
    """(a), (b) and (c) of [moe_axis] on ``mesh`` (the (1, 2) mesh of SPMD
    ranks, or a 1 x 1 mesh: one device) in this process: (the scalars,
    the tensors: (a)'s step-0 routes, (b)'s last logits, step logits and
    routes, (c)'s outputs and kept pairs). On one device (c)'s input is
    captured first and saved beside the job for the ranks."""
    import torch
    from repro_torch.config import InputShape
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.launch import steps
    from repro_torch.launch.dist import COMM
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import full_value
    from repro_torch.models.transformer import group_params
    from repro_torch.optimizer.adamw import zip_map
    from repro_torch.runtime.serve_loop import generate
    from repro_torch.runtime.train_loop import Trainer
    from repro_torch.sharding.rules import place
    cfg_a, tc_a, cfg_b = _moe_axis_configs(job)
    cuda = torch.device(device).type == "cuda"
    spmd = getattr(mesh, "device_mesh", None) is not None
    seq, dispatch = job["seq"], job["dispatch"]
    work = Path(job["dir"])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fresh():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    def draw(cfg, seed, n):
        gen = torch.Generator(device).manual_seed(seed)
        return torch.randint(1, cfg.vocab_size, (1, n), generator=gen,
                             device=device, dtype=torch.int32)

    def flat(x):
        return full_value(x)[0].float().cpu()

    heads = set()
    inner = f_ops._flash_run

    def seeing(q, k, *rest):
        heads.add((int(q.shape[2]), int(k.shape[2])))
        return inner(q, k, *rest)
    f_ops._flash_run = seeing
    out, tensors = {}, {}
    try:
        # (a) the Trainer, MOE_AXIS_TRAIN_STEPS steps
        fresh()
        marks = []
        kern = zero_counts()
        with MoERoutes() as routes:
            def mark(step):
                sync()
                marks.append((time.perf_counter(), COMM.seconds,
                              COMM.calls, COMM.bytes, routes.mark()))
            with Trainer(cfg_a, tc_a, mesh, fail_injector=mark,
                         device=device, moe_dispatch=dispatch) as tr:
                rep = tr.run(job["train_steps"], resume=False)
                mark(job["train_steps"])
                fallbacks = (tr.ruleset.fallback_report()
                             if tr.ruleset is not None else [])
        pairs = list(zip(marks, marks[1:]))
        out["a"] = {
            "layers": cfg_a.num_layers, "shape": job["train_shape"],
            "losses": rep.losses,
            "step_ms": [1e3 * (b[0] - a[0]) for a, b in pairs],
            "comm_s": [b[1] - a[1] for a, b in pairs],
            "comm_calls": [b[2] - a[2] for a, b in pairs],
            "comm_bytes": [b[3] - a[3] for a, b in pairs],
            "routes_a_step": [b[4] - a[4] for a, b in pairs],
            "peak_gb": peak(), "launches": read_counts(kern),
            "flash_heads": sorted(heads), "fallbacks": fallbacks}
        tensors["a_routes"] = routes.records(marks[0][4], marks[1][4])
        del routes, tr, rep

        # (b) the prefill plan at PREFILL_32K, decode plan steps, generate
        fresh()
        params = build_model(cfg_b).init(
            torch.Generator(device).manual_seed(0))
        tokens = draw(cfg_b, 40, seq)
        plan = steps.make_prefill_plan(
            cfg_b, InputShape("prefill_32k_b1", seq, 1, "prefill"), mesh,
            last_logit=True, moe_dispatch=dispatch)
        placed = (zip_map(place, params, plan.arg_shardings[0]) if spmd
                  else params)
        heads.clear()
        kern = zero_counts()
        with MoERoutes() as routes:
            (last, cache), t, calls, comm = _timed(
                lambda: plan.step_fn(placed, {"tokens": tokens}), cuda)
        b = {"layers": cfg_b.num_layers, "prefill_ms": 1e3 * t,
             "prefill_comm_calls": calls, "prefill_comm_s": comm,
             "prefill_launches": read_counts(kern),
             "prefill_heads": sorted(heads), "prefill_routes": routes.mark(),
             "fallbacks": plan.ruleset.fallback_report()}
        tensors["b_last"] = flat(last)
        tensors["b_prefill_routes"] = routes.records()
        del last, cache, placed, routes
        # the prompt before the steps: a whole number of dispatch chunks
        # (a count that 1,024 does not divide routes as one chunk, whose
        # (T, E, C) tables at ~32k tokens take 40 GB)
        n, start = job["decode_steps"], seq - moe_mod.DISPATCH_CHUNK
        dplan = steps.make_plan(
            cfg_b, InputShape("decode_32k_b1", seq, 1, "decode"), mesh,
            moe_dispatch=dispatch)
        model = steps.build_model_for_scale(cfg_b, ruleset=dplan.ruleset,
                                            moe_dispatch=dispatch)
        model.prefill_last_only = True
        placed = (zip_map(place, params, dplan.arg_shardings[0]) if spmd
                  else params)
        kern = zero_counts()
        (_, cache), t, calls, comm = _timed(lambda: model.prefill(
            placed, tokens[:, :start], cache_len=seq), cuda)
        b.update(cache_prefill_ms=1e3 * t, cache_prefill_comm_calls=calls,
                 cache_prefill_comm_s=comm,
                 cache_prefill_launches=read_counts(kern))
        logits, b["steps"] = [], []
        kern = zero_counts()
        with MoERoutes() as routes:
            for i in range(n):
                pos = start + i
                (lg, cache), t, calls, comm = _timed(
                    lambda: dplan.step_fn(placed, {
                        "tokens": tokens[:, pos:pos + 1], "pos": pos,
                        "cache": cache}), cuda)
                b["steps"].append({"ms": 1e3 * t, "comm_calls": calls,
                                   "comm_s": comm})
                logits.append(flat(lg))
        b["decode_launches"] = read_counts(kern)
        tensors["b_steps"] = torch.stack(logits)
        tensors["b_step_routes"] = routes.records()
        del cache, lg, routes
        b["peak_gb"] = peak()
        prompt = tokens[:, :job["gen_prompt"]]
        kern = zero_counts()
        toks, t, calls, comm = _timed(lambda: generate(
            model, placed, prompt, job["gen_tokens"],
            cache_len=job["gen_prompt"] + job["gen_tokens"]), cuda)
        b.update(generate_tokens=toks[0].tolist(), generate_ms=1e3 * t,
                 generate_comm_calls=calls, generate_comm_s=comm,
                 generate_launches=read_counts(kern))
        if not spmd:
            # each generated token's one-device top-2 gap, the same steps
            # teacher-forced on the tokens
            gen, p0 = torch.as_tensor(toks, device=device), job["gen_prompt"]
            with torch.inference_mode():
                lg, c = model.prefill(placed, prompt,
                                      cache_len=p0 + job["gen_tokens"])
                b["generate_gaps"] = [_gap(lg[0, -1].float())]
                for i in range(job["gen_tokens"] - 1):
                    lg, c = model.decode_step(placed, gen[:, i:i + 1],
                                              p0 + i, c)
                    b["generate_gaps"].append(_gap(lg[0, -1].float()))
            del lg, c
        out["b"] = b

        # (c) layer 1's MoE input, captured on one device
        path = work / "layer_input.pt"
        if not spmd:
            bb, bs = job["layer_batch"]
            batch = draw(cfg_b, 41, bb * bs).reshape(bb, bs)
            inputs = []
            moe_inner = moe_mod.moe_apply

            def recorded(p, x, *args, **kw):
                inputs.append(x)
                return moe_inner(p, x, *args, **kw)
            moe_mod.moe_apply = recorded
            try:
                model.hidden(params, batch)
            finally:
                moe_mod.moe_apply = moe_inner
            torch.save(inputs[1].cpu(), path)
            del inputs
        x = torch.load(path).to(device)
        p = group_params(placed, 1)["p0"]["moe"]
        c = {}
        with torch.no_grad():
            if spmd:
                from torch.distributed.tensor.experimental import (
                    implicit_replication)
                ctx = implicit_replication()
                x = place(x, dplan.ruleset.sharding(("batch", "seq", None),
                                                    x.shape))
            else:
                import contextlib
                ctx = contextlib.nullcontext()
            with ctx:
                for d in ("onehot", "sort"):
                    (y, aux), t, calls, comm = _timed(
                        lambda: moe_mod.moe_apply(p, x, cfg_b, d), cuda)
                    kept = moe_mod.kept_pairs(p, x, cfg_b, d)
                    tensors[f"c_{d}_y"] = full_value(y).float().cpu()
                    tensors[f"c_{d}_kept"] = kept.cpu()
                    c[d] = {"ms": 1e3 * t, "comm_calls": calls,
                            "comm_s": comm, "aux": float(full_value(aux)),
                            "kept": int(kept.sum()), "pairs": kept.numel()}
        out["c"] = c
        del params, placed, x, p
    finally:
        f_ops._flash_run = inner
    return out, tensors


def moe_axis_phase(dev, kernels: list, smoke: bool = False) -> dict:
    """[moe_axis]: (a), (b) and (c) above, on two SPMD ranks against one
    device, and the ``flash_attention_moe_axis`` entry of ``kernels``
    (the kernel at a rank's share of (b)'s prefill)."""
    import gc
    import shutil

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(MOE_AXIS_DIR, ignore_errors=True)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    world = AXIS_MESH[0] * AXIS_MESH[1]
    job = {"phase": "moe_axis", "world": world, "mesh": list(AXIS_MESH),
           "device": dev.type, "smoke": smoke, "arch": MOE_ARCH,
           "dispatch": MOE_AXIS_DISPATCH, "seq": LAUNCH_SEQ,
           "train_layers": MOE_AXIS_TRAIN_LAYERS,
           "train_steps": MOE_AXIS_TRAIN_STEPS,
           "train_shape": list(MOE_AXIS_TRAIN_SHAPE),
           "serve_layers": MOE_AXIS_SERVE_LAYERS,
           "decode_steps": MOE_AXIS_DECODE_STEPS,
           "gen_prompt": MOE_AXIS_GEN_PROMPT,
           "gen_tokens": MOE_AXIS_GEN_TOKENS,
           "layer_batch": list(MOE_AXIS_LAYER_BATCH),
           "dir": str(MOE_AXIS_DIR)}
    where = (f"{world} cards" if cards >= world else
             f"{dev.type}:0 x{world}" if dev.type == "cuda" else
             f"the CPU x{world}")
    errors = []

    def gate(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)
            log(f"[moe_axis] GATE FAILED: {msg}")

    from repro_torch.launch import mesh as t_mesh
    MOE_AXIS_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    one, one_t = moe_axis_run(dict(job, tag="single"),
                              t_mesh.make_test_mesh(1, 1, device=dev), dev)
    one_s = time.perf_counter() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(dict(job, tag="mesh"))
    ranks_s = time.perf_counter() - t0
    rt = [torch.load(MOE_AXIS_DIR / "mesh" / f"tensors{r['rank']}.pt",
                     map_location="cpu", weights_only=False) for r in ranks]
    r0 = ranks[0]
    cfg_b = _moe_axis_configs(dict(job, tag="single"))[2]
    K, E = cfg_b.moe.top_k, cfg_b.moe.num_experts
    log(f"[moe_axis] {cfg_b.name}: mesh {tuple(AXIS_MESH)} over {where}: "
        f"backend {r0['backend']}, ranks on "
        + ", ".join(r["device"] for r in ranks)
        + f"; one device {one_s:.1f} s, the ranks {ranks_s:.1f} s (start-up "
        f"included); {E} experts top {K}, {E // AXIS_MESH[1]} a rank; "
        f"dispatch {MOE_AXIS_DISPATCH} in (a) and (b)")
    report = {"mesh": list(AXIS_MESH), "where": where,
              "backend": r0["backend"], "single": one, "ranks": ranks,
              "one_seconds": one_s, "ranks_seconds": ranks_s}

    def launches_ok(got: dict, want: int) -> bool:
        return got["flash_attention"] == want and not any(
            c for k, c in got.items() if k != "flash_attention")

    # a rank's heads: 32 over 4 KV heads split 2 ways
    hl = cfg_b.num_heads // AXIS_MESH[1]
    kvl = (cfg_b.num_kv_heads // AXIS_MESH[1]
           if cfg_b.num_kv_heads % AXIS_MESH[1] == 0 else 1)
    cuda = dev.type == "cuda"

    # (a)
    a1 = one["a"]
    rel = [abs(x - y) / abs(y) for x, y in zip(r0["a"]["losses"],
                                              a1["losses"])]
    agree = all(r["a"]["losses"] == r0["a"]["losses"] for r in ranks)
    from repro_torch.models import moe as moe_mod

    def capacity(tokens):
        return moe_mod._capacity(tokens, cfg_b)
    ra = route_faults(one_t["a_routes"], rt[0]["a_routes"], MOE_AXIS_TIE,
                      capacity)
    a_flash = a1["launches"]["flash_attention"]
    log(f"[moe_axis] (a) {a1['layers']} layers, Trainer at "
        f"{a1['shape'][0]} x {a1['shape'][1]}: losses mesh "
        + ", ".join(repr(x) for x in r0["a"]["losses"]) + "; one device "
        + ", ".join(repr(x) for x in a1["losses"])
        + f"; |rel| max {max(rel):.3e} (bar {MOE_AXIS_LOSS_REL:g}); ranks "
        f"agree {agree}. One device: steps "
        + ", ".join(f"{t:.1f}" for t in a1["step_ms"])
        + f" ms, peak {_gb(a1['peak_gb'])} GB, flash {a_flash} launches on "
        f"{a1['flash_heads']}. Mesh: " + "; ".join(
            f"rank {r['rank']}: steps "
            + ", ".join(f"{t:.1f}" for t in r["a"]["step_ms"])
            + " ms, collectives "
            + ", ".join(str(n) for n in r["a"]["comm_calls"]) + " calls, "
            + ", ".join(f"{1e3 * t:.1f}" for t in r["a"]["comm_s"])
            + " ms, " + ", ".join(f"{n / 1e6:.1f}"
                                  for n in r["a"]["comm_bytes"])
            + f" MB; peak {_gb(r['a']['peak_gb'])} GB; flash "
            f"{r['a']['launches']['flash_attention']} launches on "
            f"{r['a']['flash_heads']}; chunks routed a step "
            f"{r['a']['routes_a_step']}" for r in ranks)
        + f". Step 0's routing against one device: {ra}; rule fallbacks "
        + "; ".join(r0["a"]["fallbacks"]))
    gate(agree and max(rel) <= MOE_AXIS_LOSS_REL,
         f"(a) losses {r0['a']['losses']} against {a1['losses']}")
    gate(ra["faults"] == 0, f"(a) step 0's routing: {ra}")
    for r in ranks:
        gate(not cuda or (launches_ok(r["a"]["launches"], a_flash)
                          and a_flash > 0),
             f"(a) rank {r['rank']} launched {r['a']['launches']} against "
             f"{a_flash} flash on one device")
        gate(not cuda or r["a"]["flash_heads"] == [[hl, kvl]],
             f"(a) rank {r['rank']} flash on {r['a']['flash_heads']}")

    # (b)
    b1 = one["b"]
    cos = {n: _cosine(rt[0][n], one_t[n]) for n in ("b_last",)}
    top = {n: _top1_in_ties(rt[0][n], one_t[n]) for n in cos}
    steps_cos = [_cosine(g, w) for g, w in zip(rt[0]["b_steps"],
                                               one_t["b_steps"])]
    steps_top = [_top1_in_ties(g, w) for g, w in zip(rt[0]["b_steps"],
                                                     one_t["b_steps"])]
    rp = route_faults(one_t["b_prefill_routes"], rt[0]["b_prefill_routes"],
                      MOE_AXIS_TIE, capacity)
    rs = route_faults(one_t["b_step_routes"], rt[0]["b_step_routes"],
                      MOE_AXIS_TIE, capacity)
    mesh_tok = [r["b"]["generate_tokens"] for r in ranks]
    want_tok = b1["generate_tokens"]
    first = next((i for i, (x, y) in enumerate(zip(mesh_tok[0], want_tok))
                  if x != y), None)
    gaps = b1["generate_gaps"]
    log(f"[moe_axis] (b) {b1['layers']} layers: one device prefill plan "
        f"{b1['prefill_ms']:.1f} ms at {LAUNCH_SEQ} tokens (flash "
        f"{b1['prefill_launches']['flash_attention']} launches on "
        f"{b1['prefill_heads']}; {b1['prefill_routes']} chunks routed), "
        f"cache prefill {b1['cache_prefill_ms']:.1f} ms, decode steps "
        + ", ".join(f"{st['ms']:.1f}" for st in b1["steps"])
        + f" ms, generate {b1['generate_ms']:.1f} ms, peak "
        f"{_gb(b1['peak_gb'])} GB. Mesh: " + "; ".join(
            f"rank {r['rank']}: prefill plan {r['b']['prefill_ms']:.1f} ms "
            f"({r['b']['prefill_comm_calls']} collectives, "
            f"{1e3 * r['b']['prefill_comm_s']:.1f} ms; flash "
            f"{r['b']['prefill_launches']['flash_attention']} launches on "
            f"{r['b']['prefill_heads']}), cache prefill "
            f"{r['b']['cache_prefill_ms']:.1f} ms "
            f"({r['b']['cache_prefill_comm_calls']} collectives, "
            f"{1e3 * r['b']['cache_prefill_comm_s']:.1f} ms), decode steps "
            + ", ".join(f"{st['ms']:.1f}" for st in r["b"]["steps"])
            + f" ms ({r['b']['steps'][-1]['comm_calls']} collectives a step, "
            + ", ".join(f"{1e3 * st['comm_s']:.1f}"
                        for st in r["b"]["steps"])
            + f" ms of them), generate {r['b']['generate_ms']:.1f} ms "
            f"({r['b']['generate_comm_calls']} collectives, "
            f"{1e3 * r['b']['generate_comm_s']:.1f} ms), peak "
            f"{_gb(r['b']['peak_gb'])} GB" for r in ranks)
        + f". Against one device: last logits cosine {cos['b_last']:.7f}, "
        f"top-1 among ties {top['b_last']}; steps "
        + ", ".join(f"{c:.7f}" for c in steps_cos)
        + f" (gate >= {LAUNCH_DECODE_COS}), top-1 among ties "
        f"{all(steps_top)}; routing: prefill {rp}; decode steps {rs}; "
        f"generate mesh {mesh_tok[0]}, one device {want_tok}, first "
        f"difference at {first} (top-2 gaps "
        + ", ".join(f"{g:.2e}" for g in gaps) + ")")
    gate(cos["b_last"] >= LAUNCH_DECODE_COS and top["b_last"],
         f"(b) prefill last logits cosine {cos['b_last']}, top-1 "
         f"{top['b_last']}")
    gate(all(c >= LAUNCH_DECODE_COS for c in steps_cos) and all(steps_top),
         f"(b) step logits cosine {steps_cos}, top-1 among ties {steps_top}")
    gate(rp["faults"] == 0 and rs["faults"] == 0,
         f"(b) routing: prefill {rp}, steps {rs}")
    gate(all(t == mesh_tok[0] for t in mesh_tok),
         f"(b) the ranks' generate tokens differ: {mesh_tok}")
    gate(first is None or gaps[first] < DAX_TIE_REL,
         f"(b) generate differs at token {first}")
    for r in ranks:
        for what, want in (("prefill_launches", b1["prefill_launches"]),
                           ("cache_prefill_launches",
                            b1["cache_prefill_launches"]),
                           ("decode_launches", b1["decode_launches"]),
                           ("generate_launches", b1["generate_launches"])):
            gate(not cuda or (launches_ok(r["b"][what],
                                          want["flash_attention"])
                              and (what == "decode_launches"
                                   or want["flash_attention"] > 0)),
                 f"(b) rank {r['rank']} {what} {r['b'][what]} against "
                 f"{want}")
        gate(not cuda or r["b"]["prefill_heads"] == [[hl, kvl]],
             f"(b) rank {r['rank']} flash on {r['b']['prefill_heads']}")

    # (c)
    c_out = {}
    for d in ("onehot", "sort"):
        same = bool(torch.equal(rt[0][f"c_{d}_kept"], one_t[f"c_{d}_kept"]))
        ycos = _cosine(rt[0][f"c_{d}_y"], one_t[f"c_{d}_y"])
        c1 = one["c"][d]
        c_out[d] = {"kept_bitwise": same, "y_cosine": ycos}
        log(f"[moe_axis] (c) layer 1's MoE input "
            f"{tuple(MOE_AXIS_LAYER_BATCH)} x {cfg_b.d_model}, dispatch {d}: "
            f"one device {c1['ms']:.1f} ms, kept {c1['kept']} of "
            f"{c1['pairs']} pairs, aux {c1['aux']:.6f}; mesh "
            + "; ".join(f"rank {r['rank']} {r['c'][d]['ms']:.1f} ms "
                        f"({r['c'][d]['comm_calls']} collectives, "
                        f"{1e3 * r['c'][d]['comm_s']:.1f} ms), aux "
                        f"{r['c'][d]['aux']:.6f}" for r in ranks)
            + f"; kept pairs bitwise one device's: {same}; y cosine "
            f"{ycos:.7f} (gate >= {MOE_AXIS_LAYER_COS})")
        gate(same and c1["kept"] < c1["pairs"],
             f"(c) {d}: kept pairs bitwise {same}, kept {c1['kept']} of "
             f"{c1['pairs']}")
        gate(ycos >= MOE_AXIS_LAYER_COS, f"(c) {d}: y cosine {ycos}")
    report["a"] = {"loss_rel": rel, "ranks_agree": agree, "routing": ra}
    report["b"] = {"prefill_cosine": cos["b_last"], "step_cosine": steps_cos,
                   "step_top1": steps_top, "prefill_routing": rp,
                   "step_routing": rs, "generate_first_difference": first,
                   "gaps": gaps}
    report["c"] = c_out
    del rt, one_t
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # flash at a rank's share of (b)'s prefill
    if cuda:
        lf = long_flash(dev, MOE_AXIS_FLASH_SHAPE)
        for start, e in lf["blocks_vs_plain"].items():
            gate(e["ok"], f"flash at {MOE_AXIS_FLASH_SHAPE}, rows {start}: "
                 f"disagrees with its plain version ({e})")
        gate(lf["all_rows_vs_plain"]["ok"] and lf["finite"],
             f"flash at {MOE_AXIS_FLASH_SHAPE}: {lf['all_rows_vs_plain']}")
        launches = sum(r["b"]["prefill_launches"]["flash_attention"]
                       for r in ranks)
        err = max([e["max_abs_err"] for e in lf["blocks_vs_plain"].values()]
                  + [lf["all_rows_vs_plain"]["max_abs_err"]])
        kernels.append(
            {"name": "flash_attention_moe_axis", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/flash.py:101",
             "launches": launches, "max_abs_err": err, "ms": lf["ms"],
             "plain_ms": lf["plain_ms"], "bound_ms": lf["bound_ms"],
             "bound_by": lf["bound_by"], "library_ms": lf["library_ms"]})
        log(f"[times] flash_attention_moe_axis at "
            f"{tuple(MOE_AXIS_FLASH_SHAPE)} causal (a rank's heads of (b)'s "
            f"prefill): {lf['ms']:.4f} ms, plain {lf['plain_ms']:.4f} ms, "
            f"bound {lf['bound_ms']:.4f} ms ({lf['bound_by']}, exact pairs;"
            f" exponentials {lf['exp_bound_ms']:.4f} ms), SDPA (cuDNN) "
            f"{lf['library_ms']}; max abs err {err:.3e} (every row within "
            f"LONG_FLASH_TOL: {lf['all_rows_vs_plain']['ok']}, "
            f"{lf['all_rows_vs_plain']['max_share_of_bar']:.3f} of the "
            f"bar); {launches} launches over the ranks in (b)'s PREFILL_32K "
            f"step")
        report["flash"] = lf
    shutil.rmtree(MOE_AXIS_DIR, ignore_errors=True)
    report["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[moe_axis] phase {report['phase_seconds']:.1f} s")
    if errors:
        fail("[moe_axis] " + "; ".join(errors))
    return report


def _rwkv_axis_configs(job: dict):
    """(a)'s config and train config and (b)'s and (c)'s config for a
    [rwkv_axis] job (the SMOKE config for a rehearsal on the CPU)."""
    import dataclasses
    from repro_torch.config import (InputShape, OptimizerConfig,
                                    TrainConfig, get_arch, get_smoke_arch)
    get = get_smoke_arch if job["smoke"] else get_arch
    base = get(RWKV_ARCH)
    a = dataclasses.replace(base, num_layers=job["train_layers"])
    bb, bs = job["train_shape"]
    tc = TrainConfig(
        shape=InputShape("rwkv_axis_a", bs, bb, "train"),
        optimizer=OptimizerConfig(lr=3e-4, warmup_steps=2,
                                  total_steps=job["train_steps"]),
        checkpoint_every=1_000_000,
        checkpoint_dir=str(Path(job["dir"]) / job["tag"] / "a"))
    return a, tc, dataclasses.replace(base, num_layers=job["serve_layers"])


def rwkv_axis_run(job: dict, mesh, device) -> tuple:
    """(a), (b) and (c) of [rwkv_axis] on ``mesh`` (the (1, 2) mesh of
    SPMD ranks, or a 1 x 1 mesh: one device) in this process: (the
    scalars, the tensors: (b)'s last logits and step logits, (c)'s last
    logits, layer 1's f32 time-mix output and the kernel's rows). On one
    device (a)'s last params and (c)'s layer-1 input are saved beside the
    job for the ranks, which compare (a)'s params leaf by leaf."""
    import contextlib

    import torch
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.config import InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.dist import COMM
    from repro_torch.models import build_model
    from repro_torch.models import rwkv as rwkv_mod
    from repro_torch.models.common import full_value
    from repro_torch.models.transformer import group_params
    from repro_torch.optimizer.adamw import zip_map
    from repro_torch.runtime.serve_loop import generate
    from repro_torch.runtime.train_loop import Trainer
    from repro_torch.sharding.rules import place
    cfg_a, tc_a, cfg_b = _rwkv_axis_configs(job)
    cuda = torch.device(device).type == "cuda"
    spmd = getattr(mesh, "device_mesh", None) is not None
    first = not spmd or mesh.device_mesh.get_rank() == 0
    seq, work = job["seq"], Path(job["dir"])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fresh():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    def flat(x):
        return full_value(x)[0].float().cpu()

    out, tensors = {}, {}
    # (a) the Trainer, RWKV_AXIS_TRAIN_STEPS steps
    fresh()
    marks = []

    def mark(step):
        sync()
        marks.append((time.perf_counter(), COMM.seconds, COMM.calls,
                      COMM.bytes))
    kern = zero_counts()
    with Trainer(cfg_a, tc_a, mesh, fail_injector=mark,
                 device=device) as tr:
        kept = _keep_states(tr)
        rep = tr.run(job["train_steps"], resume=False)
        mark(job["train_steps"])
        mode = tr.model.rwkv_mode
        fallbacks = (tr.ruleset.fallback_report()
                     if tr.ruleset is not None else [])
        path = work / "a_params.pt"
        leaves = dict(flatten_with_paths(kept[-1][0]))
        del kept
        cosines = {}
        if not spmd:
            torch.save({k: t.cpu() for k, t in leaves.items()}, path)
        else:
            # every rank gathers (a collective), rank 0 compares
            want = torch.load(path, mmap=True, weights_only=True)
            for key, t in leaves.items():
                t = full_value(t)
                if first:
                    cosines[key] = _leaf_cosine(t, want[key].to(t.device))
                del t
            del want
        del leaves
    pairs = list(zip(marks, marks[1:]))
    out["a"] = {
        "layers": cfg_a.num_layers, "shape": job["train_shape"],
        "mode": mode, "losses": rep.losses,
        "step_ms": [1e3 * (b[0] - a[0]) for a, b in pairs],
        "comm_s": [b[1] - a[1] for a, b in pairs],
        "comm_calls": [b[2] - a[2] for a, b in pairs],
        "comm_bytes": [b[3] - a[3] for a, b in pairs],
        "peak_gb": peak(), "launches": read_counts(kern),
        "param_cosines": cosines, "fallbacks": fallbacks}
    del tr, rep

    # (b) the factored prefill plan at PREFILL_32K, decode plan steps,
    # generate
    fresh()
    params = build_model(cfg_b).init(torch.Generator(device).manual_seed(0))
    gen = torch.Generator(device).manual_seed(40)
    n = job["decode_steps"]
    tokens = torch.randint(1, cfg_b.vocab_size, (1, seq + n), generator=gen,
                           device=device, dtype=torch.int32)
    plan = steps.make_prefill_plan(
        cfg_b, InputShape("prefill_32k_b1", seq, 1, "prefill"), mesh,
        last_logit=True)
    placed = (zip_map(place, params, plan.arg_shardings[0]) if spmd
              else params)
    kern = zero_counts()
    (last, cache), t, calls, comm = _timed(
        lambda: plan.step_fn(placed, {"tokens": tokens[:, :seq]}), cuda)
    b = {"layers": cfg_b.num_layers, "prefill_ms": 1e3 * t,
         "prefill_comm_calls": calls, "prefill_comm_s": comm,
         "prefill_launches": read_counts(kern),
         "fallbacks": plan.ruleset.fallback_report()}
    tensors["b_last"] = flat(last)
    del last
    dplan = steps.make_plan(
        cfg_b, InputShape("decode_32k_b1", seq, 1, "decode"), mesh)
    logits, b["steps"], b["layouts"] = [], [], []
    kern = zero_counts()
    for i in range(n):
        pos = seq + i
        (lg, cache), t, calls, comm = _timed(
            lambda: dplan.step_fn(placed, {"tokens": tokens[:, pos:pos + 1],
                                           "pos": pos, "cache": cache}),
            cuda)
        b["steps"].append({"ms": 1e3 * t, "comm_calls": calls,
                           "comm_s": comm})
        if spmd:
            b["layouts"].append(_cache_layout(cache,
                                              dplan.out_shardings[1]))
        logits.append(flat(lg))
    b["decode_launches"] = read_counts(kern)
    tensors["b_steps"] = torch.stack(logits)
    del cache, lg
    b["peak_gb"] = peak()
    model = steps.build_model_for_scale(cfg_b, ruleset=dplan.ruleset)
    placed = (zip_map(place, params, dplan.arg_shardings[0]) if spmd
              else params)
    prompt = tokens[:, :job["gen_prompt"]]

    def generated(model):
        kern = zero_counts()
        toks, t, calls, comm = _timed(lambda: generate(
            model, placed, prompt, job["gen_tokens"]), cuda)
        res = {"tokens": toks[0].tolist(), "ms": 1e3 * t,
               "comm_calls": calls, "comm_s": comm,
               "launches": read_counts(kern)}
        if not spmd:
            # each generated token's one-device top-2 gap, the same steps
            # teacher-forced on the tokens
            g = torch.as_tensor(toks, device=device)
            with torch.inference_mode():
                lg, c = model.prefill(placed, prompt)
                res["gaps"] = [_gap(lg[0, -1].float())]
                for i in range(job["gen_tokens"] - 1):
                    lg, c = model.decode_step(placed, g[:, i:i + 1],
                                              prompt.shape[1] + i, c)
                    res["gaps"].append(_gap(lg[0, -1].float()))
        return res
    b["generate"] = generated(model)
    out["b"] = b

    # (c) the kernel mode: the prefill, generate, layer 1's time-mix in f32
    fresh()
    kmodel = build_model(cfg_b)
    kmodel.prefill_last_only = True
    kern = zero_counts()
    (last, cache), t, calls, comm = _timed(
        lambda: kmodel.prefill(placed, tokens[:, :seq]), cuda)
    c = {"prefill_ms": 1e3 * t, "prefill_comm_calls": calls,
         "prefill_comm_s": comm, "prefill_launches": read_counts(kern)}
    tensors["c_last"] = flat(last[:, -1])
    del last, cache
    kmodel.prefill_last_only = False
    c["generate"] = generated(kmodel)
    path = work / "layer_input.pt"
    if not spmd:
        inputs = []
        inner = rwkv_mod.timemix_apply

        def recorded(p, x, *args, **kw):
            inputs.append(x)
            return inner(p, x, *args, **kw)
        rwkv_mod.timemix_apply = recorded
        try:
            kmodel.hidden(params, tokens[:, :seq])
        finally:
            rwkv_mod.timemix_apply = inner
        torch.save(inputs[1].cpu(), path)
        del inputs
    x = torch.load(path).to(device).float()
    p = {k: v.float() for k, v in group_params(placed, 1)["p0"]["time"]
         .items()}
    ctx = contextlib.nullcontext()
    if spmd:
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        ctx = implicit_replication()
        x = place(x, dplan.ruleset.sharding(("batch", "seq", None),
                                            x.shape))
    kern = zero_counts()
    with torch.no_grad(), ctx:
        y, t, calls, comm = _timed(
            lambda: rwkv_mod.timemix_apply(p, x, cfg_b, mode="kernel"), cuda)
        c.update(layer_ms=1e3 * t, layer_comm_calls=calls,
                 layer_comm_s=comm, layer_launches=read_counts(kern))
        tensors["c_layer_y"] = full_value(y)[0].float().cpu()
        del x, p, y
        # the kernel alone on one set of inputs at (c)'s prefill shape
        # (drawn alike on every rank): a rank's rows, digested, against
        # the one device's rows of the same heads
        H = cfg_b.d_model // cfg_b.rwkv.head_dim
        shape = (1, seq, H, cfg_b.rwkv.head_dim)
        gen = torch.Generator(device).manual_seed(42)
        r, k, v = (0.5 * torch.randn(shape, generator=gen, device=device)
                   for _ in range(3))
        lw = -torch.exp(2.0 * torch.randn(shape, generator=gen,
                                          device=device) - 1.0)
        u = 0.3 * torch.randn(shape[2:], generator=gen, device=device)
        if spmd:
            body = dplan.ruleset.sharding(rwkv_mod._BODY_AXES, shape)
            r, k, v, lw = (place(t, body) for t in (r, k, v, lw))
            u = place(u, dplan.ruleset.sharding(("act_heads", "head_dim"),
                                                u.shape))
        kern = zero_counts()
        y = rwkv_mod.recurrence("kernel", r, k, v, lw, u)
        c["rows_launches"] = read_counts(kern)
        if spmd:
            y = y.to_local()
            c["rows_shape"] = list(y.shape)
            c["rows_digest"] = _leaf_digest(y)
        else:
            hl = H // job["mesh"][1]
            c["rows_digests"] = [_leaf_digest(y[:, :, j * hl:(j + 1) * hl])
                                 for j in range(job["mesh"][1])]
        del r, k, v, lw, u, y
    out["c"] = c
    del params, placed
    return out, tensors


def rwkv_axis_phase(dev, kernels: list, smoke: bool = False) -> dict:
    """[rwkv_axis]: (a), (b) and (c) above, on two SPMD ranks against one
    device, and the ``wkv6_intra_chunk_rwkv_axis`` entry of ``kernels``
    (the kernel at a rank's share of (c)'s prefill)."""
    import gc
    import shutil

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(RWKV_AXIS_DIR, ignore_errors=True)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    world = AXIS_MESH[0] * AXIS_MESH[1]
    job = {"phase": "rwkv_axis", "world": world, "mesh": list(AXIS_MESH),
           "device": dev.type, "smoke": smoke, "seq": LAUNCH_SEQ,
           "train_layers": RWKV_AXIS_TRAIN_LAYERS,
           "train_steps": RWKV_AXIS_TRAIN_STEPS,
           "train_shape": list(RWKV_AXIS_TRAIN_SHAPE),
           "serve_layers": RWKV_AXIS_SERVE_LAYERS,
           "decode_steps": RWKV_AXIS_DECODE_STEPS,
           "gen_prompt": RWKV_AXIS_GEN_PROMPT,
           "gen_tokens": RWKV_AXIS_GEN_TOKENS, "dir": str(RWKV_AXIS_DIR)}
    where = (f"{world} cards" if cards >= world else
             f"{dev.type}:0 x{world}" if dev.type == "cuda" else
             f"the CPU x{world}")
    errors = []

    def gate(ok: bool, msg: str) -> None:
        if not ok:
            errors.append(msg)
            log(f"[rwkv_axis] GATE FAILED: {msg}")

    from repro_torch.launch import mesh as t_mesh
    RWKV_AXIS_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    one, one_t = rwkv_axis_run(dict(job, tag="single"),
                               t_mesh.make_test_mesh(1, 1, device=dev), dev)
    one_s = time.perf_counter() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(dict(job, tag="mesh"))
    ranks_s = time.perf_counter() - t0
    rt = [torch.load(RWKV_AXIS_DIR / "mesh" / f"tensors{r['rank']}.pt",
                     map_location="cpu", weights_only=False) for r in ranks]
    r0 = ranks[0]
    cfg_b = _rwkv_axis_configs(dict(job, tag="single"))[2]
    H = cfg_b.d_model // cfg_b.rwkv.head_dim
    hl = H // AXIS_MESH[1]
    cuda = dev.type == "cuda"
    log(f"[rwkv_axis] {cfg_b.name}: mesh {tuple(AXIS_MESH)} over {where}: "
        f"backend {r0['backend']}, ranks on "
        + ", ".join(r["device"] for r in ranks)
        + f"; one device {one_s:.1f} s, the ranks {ranks_s:.1f} s (start-up "
        f"included); {H} heads of {cfg_b.rwkv.head_dim}, {hl} a rank")
    report = {"mesh": list(AXIS_MESH), "where": where,
              "backend": r0["backend"], "single": one, "ranks": ranks,
              "one_seconds": one_s, "ranks_seconds": ranks_s}

    def none_launched(got: dict) -> bool:
        return not any(got.values())

    def wkv6_only(got: dict, want: int) -> bool:
        return got["wkv6"] == want and not any(
            c for k, c in got.items() if k != "wkv6")

    # (a)
    a1 = one["a"]
    rel = [abs(x - y) / abs(y) for x, y in zip(r0["a"]["losses"],
                                              a1["losses"])]
    agree = all(r["a"]["losses"] == r0["a"]["losses"] for r in ranks)
    pc = r0["a"]["param_cosines"]
    worst = min(pc, key=pc.get) if pc else None
    log(f"[rwkv_axis] (a) {a1['layers']} layers, Trainer ({a1['mode']} "
        f"mode) at {a1['shape'][0]} x {a1['shape'][1]}: losses mesh "
        + ", ".join(repr(x) for x in r0["a"]["losses"]) + "; one device "
        + ", ".join(repr(x) for x in a1["losses"])
        + f"; |rel| max {max(rel):.3e} (bar {RWKV_AXIS_LOSS_REL:g}); ranks "
        f"agree {agree}; step {RWKV_AXIS_TRAIN_STEPS}'s params: "
        f"{len(pc)} leaves, min cosine {pc.get(worst, float('nan')):.7f} "
        f"({worst}; gate >= {AXIS_PARAM_COS}). One device: steps "
        + ", ".join(f"{t:.1f}" for t in a1["step_ms"])
        + f" ms, peak {_gb(a1['peak_gb'])} GB. Mesh: " + "; ".join(
            f"rank {r['rank']}: steps "
            + ", ".join(f"{t:.1f}" for t in r["a"]["step_ms"])
            + " ms, collectives "
            + ", ".join(str(n) for n in r["a"]["comm_calls"]) + " calls, "
            + ", ".join(f"{1e3 * t:.1f}" for t in r["a"]["comm_s"])
            + " ms, " + ", ".join(f"{n / 1e6:.1f}"
                                  for n in r["a"]["comm_bytes"])
            + f" MB; peak {_gb(r['a']['peak_gb'])} GB" for r in ranks)
        + "; rule fallbacks " + "; ".join(r0["a"]["fallbacks"]))
    gate(agree and max(rel) <= RWKV_AXIS_LOSS_REL,
         f"(a) losses {r0['a']['losses']} against {a1['losses']}")
    gate(bool(pc) and min(pc.values()) >= AXIS_PARAM_COS,
         f"(a) params cosine {pc.get(worst)} at {worst}")
    for r in [one] + ranks:
        gate(r["a"]["mode"] == "direct" and none_launched(
            r["a"]["launches"]),
             f"(a) {r['a']['mode']} mode, launches {r['a']['launches']}")

    # (b)
    b1 = one["b"]
    cos = _cosine(rt[0]["b_last"], one_t["b_last"])
    top = _top1_in_ties(rt[0]["b_last"], one_t["b_last"])
    steps_cos = [_cosine(g, w) for g, w in zip(rt[0]["b_steps"],
                                               one_t["b_steps"])]
    steps_top = [_top1_in_ties(g, w) for g, w in zip(rt[0]["b_steps"],
                                                     one_t["b_steps"])]
    bad_layout = [(r["rank"], i, k, v) for r in ranks
                  for i, lay in enumerate(r["b"]["layouts"])
                  for k, v in lay.items() if v["placements"] != v["plan"]]
    wkv_layout = r0["b"]["layouts"][-1]["p0/wkv"]["placements"]

    def gen_check(tag: str, what: dict, want: dict):
        toks = [r[tag]["generate"]["tokens"] for r in ranks]
        first = next((i for i, (x, y) in enumerate(zip(toks[0],
                                                      want["tokens"]))
                      if x != y), None)
        gate(all(t == toks[0] for t in toks),
             f"({tag}) the ranks' generate tokens differ: {toks}")
        gate(first is None or want["gaps"][first] < DAX_TIE_REL,
             f"({tag}) generate differs at token {first}")
        return toks[0], first
    b_tok, b_first = gen_check("b", r0["b"], b1["generate"])
    log(f"[rwkv_axis] (b) {b1['layers']} layers, factored: one device "
        f"prefill plan {b1['prefill_ms']:.1f} ms at {LAUNCH_SEQ} tokens, "
        f"decode steps " + ", ".join(f"{st['ms']:.1f}" for st in b1["steps"])
        + f" ms, generate {b1['generate']['ms']:.1f} ms, peak "
        f"{_gb(b1['peak_gb'])} GB. Mesh: " + "; ".join(
            f"rank {r['rank']}: prefill plan {r['b']['prefill_ms']:.1f} ms "
            f"({r['b']['prefill_comm_calls']} collectives, "
            f"{1e3 * r['b']['prefill_comm_s']:.1f} ms), decode steps "
            + ", ".join(f"{st['ms']:.1f}" for st in r["b"]["steps"])
            + f" ms ({r['b']['steps'][-1]['comm_calls']} collectives a step, "
            + ", ".join(f"{1e3 * st['comm_s']:.1f}"
                        for st in r["b"]["steps"])
            + f" ms of them), generate {r['b']['generate']['ms']:.1f} ms "
            f"({r['b']['generate']['comm_calls']} collectives, "
            f"{1e3 * r['b']['generate']['comm_s']:.1f} ms), peak "
            f"{_gb(r['b']['peak_gb'])} GB" for r in ranks)
        + f". Against one device: last logits cosine {cos:.7f}, top-1 "
        f"among ties {top}; steps " + ", ".join(f"{x:.7f}" for x in steps_cos)
        + f" (gate >= {LAUNCH_DECODE_COS}), top-1 among ties "
        f"{all(steps_top)}; the state in the plan's layout at every step: "
        f"{not bad_layout} (wkv {wkv_layout}); generate mesh {b_tok}, one "
        f"device {b1['generate']['tokens']}, first difference at {b_first} "
        "(top-2 gaps " + ", ".join(f"{g:.2e}" for g in b1["generate"]["gaps"])
        + ")")
    gate(cos >= LAUNCH_DECODE_COS and top,
         f"(b) prefill last logits cosine {cos}, top-1 {top}")
    gate(all(x >= LAUNCH_DECODE_COS for x in steps_cos) and all(steps_top),
         f"(b) step logits cosine {steps_cos}, top-1 among ties {steps_top}")
    gate(not bad_layout and "Shard(dim=1)" not in wkv_layout,
         f"(b) the state's layout: {bad_layout[:3]}, wkv {wkv_layout}")
    for r in [one] + ranks:
        for what in ("prefill_launches", "decode_launches"):
            gate(none_launched(r["b"][what]),
                 f"(b) {what} {r['b'][what]} (the factored mode)")

    # (c)
    c1 = one["c"]
    c_cos = _cosine(rt[0]["c_last"], one_t["c_last"])
    c_top = _top1_in_ties(rt[0]["c_last"], one_t["c_last"])
    layer_cos = torch.nn.functional.cosine_similarity(
        rt[0]["c_layer_y"].double(), one_t["c_layer_y"].double(),
        dim=1).min().item()
    bitwise = [r["c"]["rows_digest"]
               == c1["rows_digests"][r["coordinate"][1]] for r in ranks]
    c_tok, c_first = gen_check("c", r0["c"], c1["generate"])
    log(f"[rwkv_axis] (c) {b1['layers']} layers, kernel mode: one device "
        f"prefill {c1['prefill_ms']:.1f} ms ({c1['prefill_launches']['wkv6']}"
        f" WKV6 launches), generate {c1['generate']['ms']:.1f} ms. Mesh: "
        + "; ".join(
            f"rank {r['rank']}: prefill {r['c']['prefill_ms']:.1f} ms "
            f"({r['c']['prefill_comm_calls']} collectives, "
            f"{1e3 * r['c']['prefill_comm_s']:.1f} ms; WKV6 "
            f"{r['c']['prefill_launches']['wkv6']} launches; the kernel "
            f"alone on {r['c']['rows_shape']}), generate {r['c']['generate']['ms']:.1f}"
            f" ms, layer 1 f32 {r['c']['layer_ms']:.1f} ms "
            f"({r['c']['layer_comm_calls']} collectives)" for r in ranks)
        + f". Against one device: last logits cosine {c_cos:.7f}, top-1 "
        f"among ties {c_top}; layer 1's time-mix in f32, min row cosine "
        f"{layer_cos:.9f} (gate >= {LAYER_COS_MIN}); the kernel's rows on a "
        f"rank's {hl} heads bitwise one device's: {bitwise}; generate mesh "
        f"{c_tok}, one device {c1['generate']['tokens']}, first difference "
        f"at {c_first}")
    gate(c_cos >= LAUNCH_DECODE_COS and c_top,
         f"(c) prefill last logits cosine {c_cos}, top-1 {c_top}")
    gate(layer_cos >= LAYER_COS_MIN, f"(c) layer 1 cosine {layer_cos}")
    gate(all(bitwise), f"(c) the kernel's rows bitwise: {bitwise}")
    layers = cfg_b.num_layers
    for r in [one] + ranks:
        gate(not cuda or wkv6_only(r["c"]["prefill_launches"], layers),
             f"(c) prefill launches {r['c']['prefill_launches']}, "
             f"{layers} WKV6 wanted")
        for what in ("layer_launches", "rows_launches"):
            gate(not cuda or wkv6_only(r["c"][what], 1),
                 f"(c) {what} {r['c'][what]}")
    report["a"] = {"loss_rel": rel, "ranks_agree": agree,
                   "param_min_cosine": pc.get(worst)}
    report["b"] = {"prefill_cosine": cos, "step_cosine": steps_cos,
                   "step_top1": steps_top, "layout_ok": not bad_layout,
                   "generate_first_difference": b_first}
    report["c"] = {"prefill_cosine": c_cos, "layer_min_cosine": layer_cos,
                   "rows_bitwise": bitwise,
                   "generate_first_difference": c_first}
    del rt, one_t
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the kernel at a rank's share of (c)'s prefill
    if cuda:
        from repro_torch.kernels.wkv6 import ops as w_ops
        from repro_torch.kernels.wkv6 import ref as w_ref
        from repro_torch.models.rwkv import CHUNK
        shape = (1, LAUNCH_SEQ // CHUNK, CHUNK, hl, cfg_b.rwkv.head_dim)
        args = [torch.tensor(x, device=dev) for x in
                wkv6_inputs(np.random.default_rng(2), *shape)]
        got = w_ops.wkv6_intra_chunk(*args)
        want = w_ref.wkv6_intra_chunk(*args, sub=w_ref.SUB)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        rel_err = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
        gate(rel_err <= WKV6_TOL, f"WKV6 at {shape}: rel err {rel_err}")
        del got, want, args
        wt = wkv6_times(dev, shape)
        launches = sum(r["c"]["prefill_launches"]["wkv6"] for r in ranks)
        kernels.append(
            {"name": "wkv6_intra_chunk_rwkv_axis", "route": "cuda",
             "source": "src/repro_torch/csrc/wkv6.cu",
             "replaces": "src/repro/kernels/wkv6/wkv6.py:93",
             "launches": launches, "max_abs_err": err, "ms": wt["ms"],
             "plain_ms": wt["plain_ms"], "bound_ms": wt["bound_ms"],
             "bound_by": wt["bound_by"], "library_ms": None})
        log(f"[times] wkv6_intra_chunk_rwkv_axis at {shape} (a rank's heads "
            f"of (c)'s prefill): {wt['ms']:.4f} ms, plain (sub-chunk) "
            f"{wt['plain_ms']:.4f} ms, bound {wt['bound_ms']:.4f} ms "
            f"({wt['bound_by']}; bytes {wt['byte_bound_ms']:.4f} ms, "
            f"exponentials {wt['exp_bound_ms']:.4f} ms), max abs err "
            f"{err:.3e} (rel {rel_err:.2e}, bar {WKV6_TOL:g}); {launches} "
            f"launches over the ranks in (c)'s prefill")
        report["wkv6"] = dict(wt, max_abs_err=err, launches=launches)
    shutil.rmtree(RWKV_AXIS_DIR, ignore_errors=True)
    report["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[rwkv_axis] phase {report['phase_seconds']:.1f} s")
    if errors:
        fail("[rwkv_axis] " + "; ".join(errors))
    return report


def main() -> None:
    t_main = time.perf_counter()
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
    # the wide kernels (gemma3-12b's head), on inputs of their own
    wide_errs, wide_stated = flash_checks(dev, np.random.default_rng(25),
                                          FLASH_HD240_CASES)
    report["checks"] = {**checks, **c_errs, "phase2 grad": g_err, **f_errs,
                        **w_errs, **wide_errs}
    report["flash_bf16_vs_round_p_false"] = {**f_stated, **wide_stated}

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
            f"(host included, CUDA events over 200) {c['call_ms']:.5f} ms, "
            f"through its torch.library operator {c['op_call_ms']:.5f} ms; "
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

    # -- 10. standing predicates over a growing store (first part) -------
    report["live"], live_run = live_phase(dev, corpus.embeds, queries)

    # -- 11. the gateway: [serve]'s sessions over HTTP, a standing stream -
    report["gateway"] = gateway_phase(dev, corpus.embeds, queries, refs,
                                      live_run,
                                      report["serve"]["concurrent"])

    # -- 10 (last part). the live plane's gates over the final store ------
    report["live"] = live_finish(dev, corpus.embeds, queries, live_run,
                                 forms["and_not"].mask,
                                 forms["and_not"].oracle_calls_total,
                                 report["live"])
    del live_run

    # -- 12. the ablation surface ------------------------------------------
    report["ablation"] = ablation_phase(dev, corpus.embeds, queries[0],
                                        n_tiles)

    # -- 12b. the data axis: the scoring pass and query() on a mesh ------
    report["mesh"] = mesh_phase(dev, corpus.embeds, queries[0], leaf_params)

    # -- 13. offline path: from_corpus over llama3-8b ---------------------
    del engine, store, corpus, docs
    torch.cuda.empty_cache()
    offline, service, _ = offline_phase(dev, OFF_ARCH, "flash_attention",
                                        dict(attn_impl="einsum"), "offline",
                                        COS_MIN,
                                        after=(judge, decode, mesh_ingest))
    del service
    report["offline"] = offline

    # -- 14. flash times ------------------------------------------------------
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

    # -- 15. the rwkv6-7b offline path ----------------------------------------
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
                                         RWKV_COS_MIN,
                                         after=(decode, mesh_ingest))
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

    # -- 16. wkv6 times ------------------------------------------------------
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

    # -- 16b. [mesh]: the sharded ingests' kernels at a shard's shape -----
    report["mesh"]["ingest"] = {"llama3-8b": offline["mesh_ingest"],
                                "rwkv6-7b": rwkv["mesh_ingest"]}
    mesh_ft = flash_times(dev, (MESH_SHARD_B,) + FLASH_SHAPE[1:])
    mesh_wt = wkv6_times(dev, (MESH_SHARD_B,) + WKV6_SHAPE[1:])
    by_name = {k["name"]: k for k in kernels}
    # each entry's error is its own shape's check only (FLASH_CASES'
    # "mesh shard causal", wkv6_checks' "mesh shard")
    for name, base, t, part, errs in (
            ("flash_attention_mesh", by_name["flash_attention"], mesh_ft,
             offline["mesh_ingest"],
             [e for k, e in f_errs.items() if "mesh shard" in k]),
            ("wkv6_intra_chunk_mesh", by_name["wkv6_intra_chunk"], mesh_wt,
             rwkv["mesh_ingest"],
             [e for k, e in w_errs.items() if "mesh shard" in k])):
        if not errs:
            fail(f"{name}: no check at a shard's shape")
        kernels.append(
            {"name": name, "route": "cuda", "source": base["source"],
             "replaces": base["replaces"], "launches": part["launches"],
             "max_abs_err": max(errs), "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": t.get("library_ms")})
        log(f"[times] {name} at a shard's batch of {MESH_SHARD_B}: {t['ms']:.4f} "
            f"ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), library {t.get('library_ms')}; "
            f"{part['launches']} launches on the mesh")
    report["times"]["mesh"] = {"flash": mesh_ft, "wkv6": mesh_wt}
    mesh_s = report["mesh"]["phase_seconds"] + sum(
        part["wall_seconds"] + part["place_seconds"]
        for part in report["mesh"]["ingest"].values())
    mr = report["mesh"]
    log(f"[mesh] {mr['mesh']}: (a) {mr['scoring']['max_abs_diff']:.3e} max "
        f"abs diff, (b) {mr['query']['decisions_differ']} decisions "
        f"differ, (c) min cosine " + ", ".join(
            f"{a} {part['min_cosine']:.7f} (bitwise {part['bitwise']})"
            for a, part in mr["ingest"].items())
        + f"; {mesh_s:.1f} s in all")
    mr["seconds"] = mesh_s

    # -- 17. gemma3-12b: the offline path and decode past the window ------
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 1e9
    log(f"[gemma3] after freeing the rwkv6-7b weights: {held:.3f} GB "
        f"allocated")
    if held > 1.0:
        fail(f"{held:.2f} GB still allocated after the rwkv6-7b phase")
    gemma, service, _ = offline_phase(
        dev, GEMMA_ARCH, "flash_attention", dict(attn_impl="blocked"),
        "gemma3", COS_MIN, after=(decode,), n_docs=GEMMA_DOCS,
        doc_len=GEMMA_DOC_LEN, batch_size=GEMMA_BATCH, resume=GEMMA_RESUME,
        depth=GEMMA_DEPTH)
    window = service.cfg.sliding_window
    del service
    report["gemma3"] = gemma

    # -- 18. flash at gemma3-12b's shape, global and windowed -------------
    wide = {w: flash_times(dev, GEMMA_FLASH_SHAPE, w) for w in (0, window)}
    calls = gemma["attention_calls_by_window"]
    for w, name in ((0, "flash_attention_hd240"),
                    (window, f"flash_attention_hd240_window{window}")):
        ft = wide[w]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/flash.py:101",
             "launches": calls[str(w)],
             "max_abs_err": max(wide_errs.values()),
             "ms": ft["ms"], "plain_ms": ft["plain_ms"],
             "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
             "library_ms": ft["library_ms"]})
        sdpa = ", ".join(f"{n} {t:.4f} ms" if isinstance(t, float) else
                         f"{n} {t}" for n, t in ft["sdpa"].items())
        over = ft["ms"] / ft["bound_ms"]
        log(f"[times] {name} at {tuple(GEMMA_FLASH_SHAPE)}: bf16 "
            f"tensor-core kernel {ft['ms']:.4f} ms ({over:.2f}x its bound; "
            f"{ft['flops'] / ft['ms'] / 1e9:.1f} TFLOP/s), "
            f"non-causal {ft['noncausal_ms']:.4f} ms, FP32 kernel on the "
            f"same inputs in f32 {ft['fp32_kernel_ms']:.4f} ms, plain "
            f"{ft['plain_ms']:.4f} ms, bound {ft['bound_ms']:.5f} ms "
            f"({ft['bound_by']}; {ft['flops']:.4g} FLOP, {ft['bytes']:.4g} "
            f"B; {ft['fp32_fma_bound_ms']:.4f} ms at the FP32 peak), "
            f"{calls[str(w)]} launches per from_corpus; SDPA: {sdpa}")
    share = sum(calls[str(w)] * wide[w]["ms"] for w in wide) \
        / gemma["batches"] / gemma["embed_batch_ms"]
    log(f"[times] gemma3-12b: one embedding batch "
        f"{gemma['embed_batch_ms']:.2f} ms, of which flash "
        f"{100 * share:.1f}%")
    report["times"]["flash_hd240"] = {str(w): ft for w, ft in wide.items()}
    report["times"]["flash_hd240_share_of_embed_batch"] = share

    # -- 19. codeqwen1.5-7b and internvl2-1b at full width ----------------
    report["configs"] = configs_phase(dev)

    # -- 20. qwen3-moe-30b-a3b: the MoE family at full width ---------------
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 1e9
    log(f"[moe] after freeing the earlier models' weights: {held:.3f} GB "
        f"allocated")
    if held > 1.0:
        fail(f"{held:.2f} GB still allocated before the MoE phase")
    moe, service, _ = offline_phase(
        dev, MOE_ARCH, "flash_attention", dict(attn_impl="blocked"), "moe",
        COS_MIN, after=(decode, moe_layer), n_docs=MOE_DOCS,
        batch_size=MOE_BATCH, depth=MOE_DEPTH)
    moe_cfg = service.cfg
    del service
    gc.collect()
    torch.cuda.empty_cache()
    report["moe"] = moe
    routing = moe["routing"]
    log(f"[moe] {moe_cfg.name}: {moe['params'] / 1e9:.3f} B params "
        f"(param_count {moe_cfg.param_count()}, active "
        f"{moe_cfg.active_param_count()}); from_corpus "
        f"{moe['wall_seconds']:.2f} s, {moe['tokens_per_second']:.0f} "
        f"tokens/s, a batch {moe['embed_batch_ms']:.2f} ms, digest "
        f"{moe['digest_seconds']:.1f} s, peak "
        f"{moe['ingest_stats']['peak_memory_gb']:.2f} GB; cosine against "
        f"the blocked path {moe['pooled_min_cosine']:.6f} with "
        f"{routing['flips_vs_plain']} routing flips; decode "
        f"{moe['decode']['decode_ms_per_step']:.2f} ms a step; dropped "
        f"share of (token, k) pairs in batch 0 "
        f"{routing['dropped_share']:.6f} (all layers), "
        f"{moe['moe_layer']['dropped_pairs'] / moe['moe_layer']['pairs']:.6f}"
        f" (layer 1); phase {moe['phase_seconds']:.1f} s")

    # -- 21. flash at qwen3's shape (GQA 8:1), fused scoring at D = 2048 ---
    ft = flash_times(dev, MOE_FLASH_SHAPE)
    gqa8 = [e for k, e in f_errs.items() if "GQA 8:1" in k]
    kernels.append(
        {"name": "flash_attention_gqa8", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash.py:101",
         "launches": moe["launches"], "max_abs_err": max(gqa8),
         "ms": ft["ms"], "plain_ms": ft["plain_ms"],
         "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
         "library_ms": ft["library_ms"]})
    sdpa = ", ".join(f"{n} {t:.4f} ms" if isinstance(t, float) else
                     f"{n} {t}" for n, t in ft["sdpa"].items())
    share = moe["launches"] / moe["batches"] * ft["ms"] \
        / moe["embed_batch_ms"]
    log(f"[times] flash_attention_gqa8 at {tuple(MOE_FLASH_SHAPE)}: bf16 "
        f"tensor-core kernel {ft['ms']:.4f} ms ({ft['ms'] / ft['bound_ms']:.2f}"
        f"x its bound; {ft['flops'] / ft['ms'] / 1e9:.1f} TFLOP/s), "
        f"non-causal {ft['noncausal_ms']:.4f} ms, FP32 kernel on the same "
        f"inputs in f32 {ft['fp32_kernel_ms']:.4f} ms, plain "
        f"{ft['plain_ms']:.4f} ms, bound {ft['bound_ms']:.5f} ms "
        f"({ft['bound_by']}), {moe['launches']} launches per from_corpus; "
        f"SDPA: {sdpa}; one qwen3-moe-30b-a3b batch "
        f"{moe['embed_batch_ms']:.2f} ms, of which flash "
        f"{100 * share:.1f}%")
    ft["share_of_embed_batch"] = share
    report["times"]["flash_gqa8"] = ft
    fs = fused_times(dev, MOE_DOCS, moe_cfg.d_model)
    if not fs["max_abs_err"] <= F32_TOL:
        fail(f"fused_scoring at D={moe_cfg.d_model} disagrees with its "
             f"plain version: {fs['max_abs_err']}")
    kernels.append(
        {"name": "fused_scoring_d2048", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_scoring.cu",
         "replaces": "src/repro/kernels/fused_scoring/scoring.py:138",
         "launches": moe["query"]["launches"]["fused_scoring"],
         "max_abs_err": fs["max_abs_err"], "ms": fs["ms"],
         "plain_ms": fs["plain_ms"], "bound_ms": fs["bound_ms"],
         "bound_by": fs["bound_by"], "library_ms": None})
    log(f"[times] fused_scoring_d2048 at (n={fs['n']}, D={fs['d']}, H=512, "
        f"L=128, Q=1), the [moe] query's tile: {fs['ms']:.4f} ms, plain "
        f"{fs['plain_ms']:.4f} ms, bound {fs['bound_ms']:.5f} ms "
        f"({fs['bound_by']}), max abs err {fs['max_abs_err']:.3e}; "
        f"{moe['query']['launches']['fused_scoring']} launches in the "
        f"query")
    report["times"]["fused_d2048"] = fs

    # -- 22. zamba2-2.7b: Mamba2 SSD blocks and the shared attention block -
    report["zamba2"] = zamba2_phase(dev, kernels, f_errs)

    # -- 23. whisper-base: the encoder-decoder family ------------------------
    report["whisper"] = whisper_phase(dev, kernels, f_errs)

    # -- 24. smollm-360m: LM training --------------------------------------
    report["train"] = train_phase(dev, kernels)

    # -- 24b. the model axis: smollm-360m and llama3-8b over SPMD ranks ---
    report["model_axis"] = model_axis_phase(dev, kernels)

    # -- 24c. the prefill and decode plans and generate on a model axis ----
    report["decode_axis"] = decode_axis_phase(dev, kernels)

    # -- 24d. the MoE family on a model axis: experts over "model" -------
    report["moe_axis"] = moe_axis_phase(dev, kernels)

    # -- 24e. the RWKV6 family on a model axis: heads over "model" -------
    report["rwkv_axis"] = rwkv_axis_phase(dev, kernels)

    # -- 25. the launch layer's cell plans ---------------------------------
    report["launch"] = launch_phase(dev, kernels)

    report["total_seconds"] = time.perf_counter() - t_main
    log(f"[total] {report['total_seconds']:.1f} s from the start of main, "
        f"the kernels' build included")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=2))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--model-axis-rank"]:
        model_axis_rank(sys.argv[3], int(sys.argv[2]))
    else:
        main()
