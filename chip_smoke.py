#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it puts ``src`` on ``sys.path`` itself.
Phases, each printed as it runs; any failed check raises:

  1. device: the card's name and power limit (nvidia-smi), then the build
     of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
  2. kernels against their plain PyTorch versions on the card, each
     maximum error beside its tolerance: cox_coord at n = 1, a tile - 1, a
     tile, a tile + 1, 262,144 and 1,048,577, on tie-free data, small tie
     groups, groups wider than a tile and one group of a quarter of the
     rows, with eta ~ 0.8 N(0, 1) and ~ U(-80, 80); cox_coord over C =
     8, 30 and 40 candidates at n = 262,144, tie-free and tied, each row
     bit for bit a single call, and the fused step ``cox_coord_step`` over
     five (j, prev) steps: eta within 1 ulp of its plain version's, (g, h)
     a single call's on that eta bit for bit, step and beta within 1 ulp
     of ``quad_min``'s, the launch count up by C a call; lipschitz at n = 1,
     257, 65,537 and 262,144 and p = 1, 15 (the selection path's
     finetune), 37 and 1,000, tie-free, in small groups, with a quarter of the rows in one group, with groups that
     straddle segment edges and with every row in one group; both curve
     panels at b = 1, 37, 4,096 and 4,097 and g = 1, 3, 4, 5, 127, 128,
     129 and 257 (the launch plan's edges: 16-byte and scalar rows, tails)
     with eta = +/-50 in the batch, a baseline off 16-byte alignment, and
     stratified tables of 8 strata (staged in shared memory) and of
     s = 512, g = 257 and s = 65, g = 128 (read through the read-only
     path); revcumsum at (65,536, m) for m = 1, 8, 31, 32, 33, 1,000,
     1,001 and at ragged shapes; cox_batch at n = 1, 255, 256, 257, 2,050
     and 65,536 and p = 1, 31, 32, 33, 70 and 1,000, in float32 and
     bfloat16. Every kernel must give the same bits twice, and one call of
     each must launch its kernels (KERNELS_PER_CALL) and no other device
     operation;
  3. fit: Appendix-C data at n = 262,144, p = 1,000 (rho 0.9, k 15, seed 0),
     ``fit_cd`` with cd_quad for 10 sweeps and cd_cubic for 3; the
     objective must not rise; cox_coord must be called p x sweeps times and
     lipschitz once per fit;
  4. artifact: ``fit_survival_model``, then save / load with checksums;
  5. serving: ``ScoringEngine.score(with_curves=True)`` on 1, 64 and 4,096
     requests against the closed form;
  then, with the main path's launch counts read, the fit's kernel path
  against its plain path over the first 2 sweeps of each method: the same
  kernel fit again must give the same bits, and the plain fit the same
  objective and beta within tolerance;
  5b. stratified scoring: the artifact of phase 3's data and beta with 8
     strata, scored with stratum indices on 1, 64 and 4,096 requests
     against the closed form exp(-H0[strata] exp(clip(x beta)));
  6. timings of the first slice's kernels: each kernel's median time (CUDA
     events) and device time (torch.profiler) at the main path's shapes,
     beside its bound and its plain version's (survival_curves at 1, 64
     and 4,096 requests, each beside a device fill_ of the same panel, the
     bytes it writes); the host time of the
     cox_coord wrapper's checks and counters; the device's idle share over
     one sweep of each method;
  7. streaming fit: n = 4,194,304 rows, p = 1,000, in 64 chunks of 65,536
     made on the card from a seed; ``fit_stream`` for 3 epochs in global
     mode and 3 in chunk mode; the objective must not rise; cox_batch must
     launch 64 x epochs times in chunk mode and revcumsum at least
     64 x (1 + 3 x epochs) times in global mode; seconds per epoch and the
     device's idle share over one profiled epoch. Then, with the counts
     read, the kernel path against the plain path over 2 epochs of each
     mode (bits repeated, objective and beta within tolerance), and 4
     chunks held as numpy arrays on the host against the same chunks on
     the card;
  8. timings of the second slice's kernels at the streaming and scoring
     shapes (the stratified curves as survival_curves in phase 6), beside
     their bounds, their plain versions' and, for revcumsum,
     torch.cumsum's;
  9. sparse selection at full width on phase 3's data (made again from the
     same host arrays): ``beam_search`` at k = 15 with the reference's
     defaults (beam width 5, 8 expansions, 4 score steps, 60 finetune
     sweeps, lam2 1e-3), then ``omp_greedy`` at k = 15. Losses must not
     rise with the support's size, the beam's last loss must be at most
     OMP's (MONO_RTOL), every beta finite. Prints seconds per support size
     (the ``beam.size`` spans), the support F1 of both against beta*, and
     the launches. The counts are zeroed before each call and must be
     exactly what the design implies (losses are plain
     ``cox.loss_from_eta``, so they launch nothing):
       cox_coord = sum over finetuned candidates of |support| x 60
                   sweeps (a batched call counts one a candidate);
       lipschitz = 1 for beam_search (its L2 serves its finetunes), one a
                   finetune for omp_greedy;
       revcumsum = beams scored x (2 x 4 steps + 1) x column blocks
                   (``beam.column_blocks``: 4 of <= 256 columns here), and
                   0 for omp_greedy.
     The candidates and beams scored per size are read back from the
     ``beam.size`` / ``beam.score`` spans. Then B1's device time at one
     (262,144, block) panel beside its bound, and the device's idle share
     over one scored beam and one finetune of 15 columns. With the counts
     read, the kernel path against the plain path at a reduced depth
     (k = 3, beam width 2, 4 expansions, 10 finetune sweeps): the same
     support at every size, losses within SELECT_DTOL, and a second
     kernel run repeating the bits;
  10. regularization path and baselines at full width, same data:
     ``l1_path`` at 6 lambdas (ratio 0.05) of 3 sweeps each, cut from the
     reference's 30 x 80 (support_sizes[0] <= 1, the last >= the first,
     losses finite); ``fit_newton`` with line search, 3 iterations,
     lam2 = 1 (monotone); ``fit_working_newton`` quasi and prox, 2
     iterations of 1 inner sweep; ``fit_gd``, 5 iterations (decreases);
     ``fit_cd_penalized`` with SCAD and MCP, 2 sweeps at
     lam1 = 0.4 lambda_max (monotone). Their launches must be exactly
     cox_coord p x (6 x 3 + 2 x 2), lipschitz 6 + 1 + 2, nothing else. Each
     step prints seconds per iteration and the device's idle share over
     one iteration.
  11. the serving front end, run after phase 5b on the artifacts of
     phases 4 and 5b, with RiskService's defaults (max_batch 64, retries
     2, down_after 3) and curves returned: the phase-4 artifact saved and
     loaded by ``ModelRegistry.load(block=False)`` (sha256 verified, the
     bucket ladder 1..64 warmed on the registry's thread), swapped live;
     4,096 requests from 4 submitter threads (25 % HIGH), every one ``ok``
     and equal to direct ``engine.score`` calls of its row in batches of
     64 (SERVE_RISK_RTOL, CURVES_ATOL, medians exact), with
     survival_curves launched exactly the warmed buckets plus the batches
     before those calls (which the path's count leaves out); a closed loop
     (4 submitters, 64 requests in flight each, 3 s) for the capacity,
     then benchmarks/bench_overload.py's open loop at 0.5x and 2x of it
     (seeded Poisson arrivals, 25 % HIGH, LOW deadline 0.25 s, max_queue
     8 x 64, 3 s each) with no silent loss; a rollout of the artifact
     refit with beta x 0.95 halfway through 3 s at 0.4x (nothing dropped,
     one engine swap, generation 2, later requests on the new model); a
     ChaosEngine around the live engine (fail_next(2) recovered by 2
     retries, fail_next(3) one batch of error responses then SERVING
     again, a bit-flipped artifact FAILED while the live engine serves);
     1 s of closed-loop serving under ``obs.profile.maybe_profile``, its
     trace's device idle share, and 1 s with the service's spans on (both
     read by the benchmark's readers in ``perfbench/harness.py``). Then
     the 8-strata artifact's 4,096
     requests through survival_curves_stratified, counted the same way.
     Its launches are the kernels line's "serve" and "serve_stratified".
  12. the deep-survival serving path at full width, after phase 10:
     mamba2-130m as ``deep.model_config(DeepSurvivalConfig(full=True))``
     gives it (d_model 768, expand 2, ssm_state 128, ssm_head_dim 64,
     chunk 128, 12 layers, vocab 2,048, bfloat16) with its Cox head, drawn
     on the card from generators seeded 0, with nothing drawn twice;
     ``collect_features`` over 128 held-out batches of ``SurvivalTextStream(2048, seq=48, batch=256)``
     (32,768 sequences; seconds a batch, tokens a second, the device's
     idle share over one profiled batch); ``refit_and_export`` at the
     reference's defaults (k 8, beam width 4, grid 64) on the (32,768,
     768) float32 panel (seconds per support size from the ``beam.size``
     spans); the artifact saved, rolled out through ``ModelRegistry`` into
     ``RiskService`` (curves returned) and 4,096 requests of pooled
     features from 16 further batches served; the counts, zeroed before
     the featurize and read once the service has stopped, exactly
     cox_coord, lipschitz and revcumsum as phase 9's formulas give them
     for the refit's spans, survival_curves the engine's calls (the
     warmed buckets and the service's batches) and ssd_scan one a Mamba2
     layer of every featurized batch, nothing else; then, as
     checks whose launches are not counted, each served answer equal to
     direct ``engine.score`` calls and to exp(clip(f beta, -30, 30)) within
     DEEP_RISK_RTOL, the refit's kernel route against its plain route on
     the same panel at DEEP_COMPARE's depth (supports equal, losses within
     SELECT_DTOL), and the pooled features of 2 batches against a float32
     twin of the backbone within SSM_BF16_RTOL; the held-out
     c-indexes of the deep head and the sparse refit on the served
     sequences (reported, not gated: the backbone is untrained). Then
     qwen2.5-3b at full width (12 layers, vocab 2,048): 8 batches of 256 x
     48 in bfloat16 against a float32 forward of the same weights on the
     card, the pooled features within DENSE_BF16_RTOL. Its launches are
     the kernels line's "deep survival".
  13. training on the card, after phase 12: ``deep.run`` at the
     reference's defaults, uncut (``DeepSurvivalConfig(full=True)``:
     mamba2-130m at full width, 12 layers, bfloat16, 150 steps of
     ``SurvivalTextStream(2048, seq=48, batch=32)`` under the exact Cox
     loss, lr 2e-3, warmup 20, remat on; the refit on 4 held-out batches,
     k 8, beam width 4, grid 64): seconds a step (the median after step
     10), tokens a second, peak memory, the first-10 and last-10 mean
     loss (the last below the first), one profiled step's idle share and
     top kernels; the counts, zeroed before the run, nothing during
     training and exactly cox_coord, lipschitz and revcumsum as phase 9's
     formulas give them for the refit and ssd_scan one a Mamba2 layer of
     each held-out batch featurized; the artifact rolled out through
     ``ModelRegistry`` into ``RiskService`` and the held-out rows served
     (survival_curves the engine's calls, each answer equal to direct
     ``engine.score``); both held-out c-indexes above 0.5. Then, as checks:
     the loss and every gradient of a float32 twin (full widths, 2 layers)
     on the card against the port on the CPU (GRAD_CARD_RTOL, TF32 off),
     for both objectives; microbatch 4 against the full batch; 5 steps
     saved through ``AsyncCheckpointer`` and resumed into a fresh model
     (params and moments bit-equal, bfloat16 included; restored onto the
     CPU too; the next step's loss within RESUME_RTOL); the launcher
     ``launch.train.main`` at qwen2.5-3b's widths (12 layers, vocab 4,096,
     20 steps of 8 x 64); and a one-rank NCCL world: ``fit_cd_sharded``
     against ``fit_cd`` at n = 262,144, p = 1,000, ``sharded_grad_hess_all``,
     ``compressed_psum`` and ``ScoringEngine(shard="auto")``. Its launches
     are the kernels line's "train".
  14. batched decode, after phase 13: ``launch.serve.serve_batch`` (prefill,
     then a greedy decode loop) on 4 requests drawn from the seed, bfloat16
     weights drawn on the card from SEED, at the published widths of
     DECODE_CASES: mixtral-8x7b (8 of 32 layers) at prompts of 4,160 (past
     its window of 4,096) and 64 (under it), 32 new tokens; zamba2-2.7b
     (54 layers) 512 + 32; gemma3-12b (12 of 48 layers) 1,100 + 16 (past
     its local window of 1,024); seamless-m4t-large-v2 (24 + 24) 256 source
     frames and tokens + 32; qwen2-vl-7b (28) 512 + 32. Each model is freed
     before the next. Per architecture: prefill seconds, decode seconds a
     step and tokens a second, peak memory, and one decode step under
     torch.profiler (idle share, kernels). Checks: every cache leaf of
     ``Model.init_cache``'s shape (the sliding window's 4,096 and 97
     slots) and its length the prompt plus the steps; each call's logits
     against the same model's full forward over the prompt and the tokens
     emitted, in bfloat16 (DECODE_BF16_RTOL) and in its float32 twin
     teacher-forced to those tokens (DECODE_F32_RTOL), for mixtral's dense
     variant (n_experts=0) at both prompts and every other architecture;
     mixtral's MoE at 2 layers against its float32 twin teacher-forced to
     the tokens and the expert routes (MOE_TWIN_RTOL); qwen2-vl's prefill
     from embeddings with 3-D M-RoPE positions. Its counts, zeroed before
     it and read after it: ssd_scan (zamba2's bfloat16 full-sequence
     forwards, a multiple of its 54 Mamba2 layers) and flash_attn (the
     causal bfloat16 self-attention of seamless-m4t's decoder and
     qwen2-vl, at least qwen2-vl's 28 layers), every other kernel 0.
  15. the entry points and the tools, last: the five twins of the
     reference's examples (``examples_torch/``) on the card at the
     reference's sizes, through their ``main`` as a user runs them:
     quickstart, sparse_selection, serve_risk_api (its spans traced to
     ``build/chip_smoke/serve_risk_api_trace.jsonl``), serve_batched and
     train_survival_lm (cut to 20 steps). Each path's counts, zeroed before
     it and read after it: > 0 exactly for the kernels of EXAMPLE_KERNELS
     (cox_coord and lipschitz in quickstart; revcumsum too in
     sparse_selection; survival_curves too in serve_risk_api and
     train_survival_lm; none in serve_batched). quickstart's final
     objectives (QUICKSTART_RTOL) and sparse_selection's F1 table (equal)
     against the same twins run on the CPU in processes of their own
     beside the card's; every serve_risk_api request scored, and the
     latency table of its trace with its service.step rows; then, as
     checks, every kernel at the shapes the examples give it; the dry run
     of every (arch x shape) cell on the meta device (40: each ``ok`` or
     skipped with a reason, every train cell's useful/counted flops within
     USEFUL_RANGE), its dry-run and roofline tables; the autotuner's sweep
     (the reference's shapes and b = 1, 64 and 4,096 at g = 128, both
     curve kernels) into ``build/chip_smoke/tuned_blocks.json``, every
     candidate's panel against the plain version, the tuned-blocks table.
     Its launches are the kernels line's "example <name>".
  16. the (data, model) mesh, last: (a) a (1, 1) ``DeviceMesh`` over a
     one-rank NCCL world, the launcher's qwen2.5-3b at its published
     widths (12 layers, vocab 4,096, bfloat16, 8 x 64) with every
     parameter and AdamW moment a DTensor (``launch.sharding.shard_model``
     in train mode), one ``trainer.make_train_step`` step against the plain
     step from the same weights (the loss within MESH_LOSS_RTOL, every
     parameter within two steps' moves and a bfloat16 rounding), then
     seconds a step of both, in turns, so the DTensor dispatch cost is
     written down; (b) the mesh dry run
     (``python -m repro_torch.launch.dryrun --mesh single``: the 40 cells
     on the 16 x 16 mesh, fake worlds of 256 ranks on meta, in four
     processes started when the phase starts, the card hidden from them):
     every cell ``ok`` or skipped with the reference's reason, each one's
     per-device GB, fits, collective bytes and bottleneck printed; (c) the
     step of (a) microbatched (``TrainConfig(microbatch=4)``: each
     microbatch placed on the mesh by itself) against the plain
     microbatched step from the same weights, by (a)'s rules, then timed
     in turns with it; (d) qwen2.5-3b at its published widths and depth
     (bfloat16, 4 requests) sharded in serve mode on the same mesh, its
     cache on ``cache_spec``'s placements, served through
     ``launch.serve.serve_batch`` beside the plain model: the greedy
     tokens compared, the logits of the prefill and of every decode step
     whose inputs were equal and the last caches held by phase 14's
     bfloat16 rule (DECODE_BF16_RTOL), then seconds a decode step of both,
     in turns. Its counts, zeroed before (a) and read after (d): only
     flash_attn, once a layer of each served prefill (plain and on the
     mesh's local shards), every other kernel 0.

Phase 2 also holds revcumsum at the selection path's (262,144, 1,000) and
(262,144, block) panels and lipschitz at (262,144, 15) against their plain
versions, and every kernel at the shapes phases 12 and 13 give it:
revcumsum on the (32,768, 768) and (128, 768) refit panels and at (128,
256), cox_coord at n = 32,768 and 128, lipschitz at (32,768 or 128,
1..8) and (32,768 or 128, 768), survival_curves at g = 64 for every
served bucket b = 1..64, and ssd_scan against the eager SSD at both
featurize cells' shapes (mamba2-130m's 128 x 512 tokens of 24 heads, a
Nemotron-H M layer's 4 x 4,096 of 64 heads in 8 groups), a ragged S and
its other instantiated shapes; phase 8 times it at both cells' shapes
(the kernels line's "cells"). flash_attn is held against the plain
streaming softmax at Nemotron-H's attention shape (4 x 4,096 tokens, 32
query heads of 128 over 2 KV heads), ragged S, G = 1, 4 and 16 and both
head dims, and phase 8 times it there beside
``scaled_dot_product_attention`` (``library_ms``, a yardstick the port
never calls). Kernel launch counts are zeroed just before each
path (phases 3-5, 5b, 11's two services, 7, 9's two calls, 10, 12, 13,
14, each example of 15 and 16) and read just after it. The line before
the last but eight is one JSON object with phase 11's numbers, then one with
the selection path's and phase 10's launch counts, then one with phase
12's numbers, then one with phase 13's, then one with phase 14's
(``{"decode": ...}``), then one with phase 15's (``{"tools": ...}``),
then one with phase 16's (``{"mesh": ...}``), then one with every
kernel's numbers (its
``launches_by_path`` gives every path's count, in ``launches_unit``:
calls, or for cox_coord candidate coordinates, C a call over C
candidates), then the card's name and
power limit; the last is ``{"ok": true, "device": {...}}``. Without CUDA,
or without the repository beside it, the script exits nonzero and prints
no result.
"""
from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N, P, RHO, K, SEED = 262_144, 1_000, 0.9, 15, 0
QUAD_SWEEPS, CUBIC_SWEEPS, COMPARE_SWEEPS = 10, 3, 2
BATCHES = (1, 64, 4096)
STRATA = 8
# the streaming fit: 64 chunks of the reference's default chunk size
# (src/repro/launch/runtime.py), at the main path's width
STREAM_N, STREAM_CHUNK, STREAM_LAM2 = 4_194_304, 65_536, 0.01
STREAM_EPOCHS, STREAM_COMPARE_EPOCHS, HOST_CHUNKS = 3, 2, 4

# tolerances, with their reasons
COORD_TOL = 1e-6     # |kernel - plain| <= COORD_TOL * sum_i |term_i|: float32
                     # sums over n in two orders, scaled by the terms' size
LIPSCHITZ_RTOL = 1e-5  # same ranges; float32 (plain) vs float64 (kernel) sums
CURVES_ATOL = 1e-6   # probabilities in [0, 1]; expf vs exp, a few ulp
FIT_DTOL = 1e-3      # |objective, kernel path - plain path| over the first
                     # sweeps, in units of the plain path's second-sweep
                     # decrease; the objective is ~4e5 with a float32 ulp of
                     # 0.03, a sweep's decrease ~1e3
BETA_RTOL = 1e-4     # max |beta, kernel - plain| / max |beta| after those
                     # sweeps: (g, h) agree to ~2e-7 of sum|terms| (phase 2)
                     # and each step is (g, h)'s ratio, over 2 x p dependent
                     # steps
MONO_RTOL = 1e-6     # allowed objective rise per sweep, float32 round-off
ARTIFACT_RTOL = 1e-4  # float32 baseline, card vs CPU cumulative sums
REVCUMSUM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
                     # |kernel - plain| / suffix(|x|) per element: float32
                     # sums in two orders, the kernel's a run of up to 32
                     # rows, up to 31 runs and a chain of segment carries,
                     # the plain version's a tree scan, worst case ~3e-5;
                     # bfloat16 adds one output rounding each, 2^-7
COX_BATCH_TOL = 2e-5  # |kernel - plain| / sum_i |term_i| per column: the
                     # kernel sums in float64, the plain version in float32
                     # over up to 65,536 terms; bfloat16 x is read exactly
                     # by both, so the same tolerance holds
STREAM_DTOL = 1e-3   # |objective, kernel - plain| over the compared epochs,
                     # in units of the plain path's first-epoch decrease;
                     # the objective is ~3e7 with a float32 ulp of 2
STREAM_BETA_RTOL = 1e-3  # max |beta, kernel - plain| / max |beta|: the
                     # paths differ in the local scans' and the panel
                     # sums' order, and each step is (g, h)'s ratio

# phase 9: beam_search and omp_greedy with the reference's defaults
SELECT = dict(k=K, beam_width=5, n_expand=8, lam2=1e-3, score_steps=4,
              finetune_sweeps=60)
# the kernel path against the plain path, at a reduced depth
SELECT_COMPARE = dict(k=3, beam_width=2, n_expand=4, lam2=1e-3,
                      score_steps=4, finetune_sweeps=10)
SELECT_DTOL = FIT_DTOL  # |loss, kernel - plain| at each size, in units of
                     # the plain path's loss decrease at that size: both
                     # finetune the same support from beta = 0 through the
                     # same float32 steps, whose (g, L2) agree as in phase 3
# phase 10: the path, cut from the reference's 30 lambdas x 80 sweeps
PATH_LAMBDAS, PATH_RATIO, PATH_SWEEPS = 6, 0.05, 3
NEWTON_ITERS, WORKING_ITERS, GD_ITERS, PENALIZED_SWEEPS = 3, 2, 5, 2
# phase 11: the service with RiskService's defaults (max_batch 64, retries
# 2, down_after 3), and benchmarks/bench_overload.py's traffic
SERVE_REQUESTS, SERVE_THREADS, SERVE_HIGH = 4_096, 4, 0.25
SERVE_SECONDS = 3.0      # the closed loop, each open-loop load, the swap
SERVE_LOADS = (0.5, 2.0)  # open-loop multiples of the closed-loop rate
SERVE_SWAP_LOAD = 0.4
SERVE_LOW_DEADLINE = 0.25
SERVE_PROFILE_SECONDS = 1.0
CHAOS_BATCH = 16
SERVE_RISK_RTOL = 1e-5   # a served risk against a direct engine call: the
                         # same float32 exp(x beta), x @ beta at another
                         # bucket; curves within CURVES_ATOL, medians equal

# phase 12: the deep-survival serving path at the full widths of
# mamba2-130m (deep.model_config(full=True): 12 layers, vocab 2,048) with
# the reference's seq, refit defaults (k 8, beam width 4, grid 64) and
# held-out start (after DeepSurvivalConfig.steps); 128 batches of 256
# sequences featurized where the reference takes 4 x 32
DEEP_SEQ, DEEP_BATCH, DEEP_BATCHES, DEEP_SERVE_BATCHES = 48, 256, 128, 16
DEEP_RISK_RTOL = 1e-4    # served risk against exp(clip(f @ beta, -30, 30)),
                         # the reference's (tests/test_deep.py)
# the shapes phase 12 gives its kernels, which phase 2 checks (phase 12
# checks that its path has them): the refit's (DEEP_N, DEEP_D) panel of
# mamba2-130m's d_model, its k and grid, and the buckets the served batches
# take (the registry's prewarm ladder at RiskService's max_batch 64)
DEEP_N, DEEP_D, DEEP_K, DEEP_GRID = DEEP_BATCHES * DEEP_BATCH, 768, 8, 64
DEEP_CURVE_BS = (1, 2, 4, 8, 16, 32, 64)
# the refit's kernel route against its plain route on the featurized
# panel: the refit's own settings (beam_search's defaults, beam width 4)
# cut to 3 support sizes, held as phase 9 holds it (SELECT_DTOL)
DEEP_COMPARE = dict(k=3, beam_width=4)
DEEP_TWIN_BATCHES = 2
SSM_BF16_RTOL = 6e-2     # ||f_bf16 - f_f32|| / ||f_f32|| over the pooled
                         # features of mamba2-130m, bfloat16 forward against
                         # the float32 forward of the same weights: the
                         # rounding error grows with depth (9.8e-3 at 2
                         # layers, 2.8e-2 at 12 in the reference's own
                         # bfloat16 forward on the CPU; the port 9.5e-3 and
                         # 2.9e-2), twice the reference's at 12 layers
DENSE_ARCH, DENSE_BATCHES = "qwen2.5-3b", 8
DENSE_BF16_RTOL = 3e-2   # ||f_bf16 - f_f32|| / ||f_f32|| over the pooled
                         # features, bfloat16 forward against the float32
                         # forward of the same weights: 8 bits of mantissa,
                         # a half-ulp 2^-9 ~ 2e-3 a rounding, compounded over
                         # 12 layers (4.6e-3 at 2 layers, reduced width, on
                         # the CPU)

# phase 13: training on the card. deep.run at the reference's defaults
# (DeepSurvivalConfig(full=True): mamba2-130m at its published widths, 12
# layers, vocab 2,048, bfloat16; 150 steps of 32 x 48, lr 2e-3, warmup 20;
# the refit on 4 held-out batches, k 8, beam width 4, grid 64), uncut; the
# shapes it gives its kernels, which phase 2 checks: the (TRAIN_N, DEEP_D)
# refit panel, cox_coord at n = TRAIN_N, lipschitz at (TRAIN_N, 1..8) and
# (TRAIN_N, 768), the curves at g = 64 for every served bucket
TRAIN_N = 4 * 32
TRAIN_SCAN_BLOCK = 256   # revcumsum also at (TRAIN_N, 256) column blocks
TRAIN_TIMED_FROM = 10    # seconds a step: the median after step 10
TWIN_LAYERS = 2          # the float32 twin: full widths, 2 layers
GRAD_CARD_RTOL = 1e-3    # every gradient on the card against the port on
                         # the CPU, max |diff| <= GRAD_CARD_RTOL * max |cpu|
                         # per parameter, TF32 off: float32 sums over 32 x
                         # 48 tokens and 768-wide rows in other orders (the
                         # CPU against the reference: ~5e-6 at reduced
                         # widths); the Cox head's bias, whose gradient is
                         # zero in exact arithmetic, within GRAD_CARD_ATOL
GRAD_CARD_ATOL = 1e-6
MICRO_LOSS_RTOL = 1e-4   # microbatch 4 against the full batch, as
MICRO_P_RTOL, MICRO_P_ATOL = 2e-3, 2e-4  # tests/test_runtime.py holds it
RESUME_RTOL = 1e-6       # the resumed step's loss (tests/test_runtime.py)
CKPT_STEPS = 5
LAUNCH_ARCH, LAUNCH_LAYERS, LAUNCH_STEPS = "qwen2.5-3b", 12, 20
LAUNCH_BATCH, LAUNCH_SEQ = 8, 64
SHARDED_SWEEPS = 2
SHARDED_RTOL = 1e-2      # objective, fit_cd_sharded against fit_cd
                         # (tests/test_distributed.py)
SHARDED_GH_RTOL = 1e-3   # sharded_grad_hess_all against grad_hess_all,
                         # max |diff| / max |ref|: float32 sums over
                         # 262,144 rows in two orders

# phase 14: batched decode through launch.serve.serve_batch, bfloat16,
# weights drawn from SEED: (arch, layers kept (None: uncut), prompt, new
# tokens), DECODE_REQUESTS requests of one prompt length each; mixtral also
# at DECODE_C10_PROMPT (under its window of 4,096: C10), and its dense
# variant (n_experts=0) beside it
DECODE_REQUESTS = 4
DECODE_CASES = (("mixtral-8x7b", 8, 4_160, 32),
                ("zamba2-2.7b", None, 512, 32),
                ("gemma3-12b", 12, 1_100, 16),
                ("seamless-m4t-large-v2", None, 256, 32),
                ("qwen2-vl-7b", None, 512, 32))
DECODE_C10_PROMPT = 64
DECODE_BF16_RTOL = 1e-1  # ||decode - full forward|| / ||full forward|| of
                         # each step's logits, both bfloat16: the same
                         # model rounds in other places (one token's GEMMs,
                         # attention and SSM recurrence against the whole
                         # sequence's), and a 1-ulp flip (2^-8) compounds
                         # with depth: mamba2-130m at full width on the CPU
                         # reads 1.6e-3 at 2 layers, 1.2e-2 at 6, 3.0e-2 at
                         # 24; these models have 16-63 sublayers
DECODE_F32_RTOL = 1e-3   # the same in the model's float32 twin (TF32 off),
                         # teacher-forced to the bfloat16 run's tokens: a
                         # cache fault (C10: 0.28-0.52 of the logits; C11:
                         # 0.19) shows here above the rounding (3.2e-6 at 6
                         # mamba2 layers on the CPU)
MOE_TWIN_LAYERS = 2
MOE_TWIN_RTOL = 5e-2  # ||bfloat16 - float32|| / ||float32|| of each step's
                      # logits of mixtral's 2-layer twin, teacher-forced to
                      # the bfloat16 run's tokens and expert routes:
                      # bfloat16 rounding at 2 layers (the CPU tests:
                      # 0.8-2.5e-2 at 4-6 sublayers against float32)
DECODE_PROFILE_STEP = 8  # the decode call profiled (earlier calls warm up)
# phase 15: the five examples' twins (examples_torch/) on the card at the
# reference's sizes, train_survival_lm cut from 150 steps to 20 (phase 13
# runs deep.run at its defaults uncut)
EXAMPLE_ARGS = {"quickstart": (), "sparse_selection": (),
                "serve_risk_api": (), "serve_batched": (),
                "train_survival_lm": ("--steps", "20")}
# the kernels each example's path launches; every other kernel launches 0
# times there (quickstart runs no beam search, so no revcumsum; the
# batched decode of serve_batched reaches no kernel of the six)
EXAMPLE_KERNELS = {
    "quickstart": ("cox_coord", "lipschitz"),
    "sparse_selection": ("revcumsum", "cox_coord", "lipschitz"),
    "serve_risk_api": ("revcumsum", "cox_coord", "lipschitz",
                       "survival_curves"),
    "serve_batched": (),
    "train_survival_lm": ("revcumsum", "cox_coord", "lipschitz",
                          "survival_curves")}
# the examples also run on the CPU (their plain versions), beside the card
CPU_EXAMPLES = ("quickstart", "sparse_selection")
CPU_EXAMPLE_TIMEOUT = 600
QUICKSTART_RTOL = 1e-4   # final objectives, card against CPU: float32 fits
                         # of 60 iterations (the CPU tests see 7e-8 against
                         # the reference)
# the shapes the examples give the kernels: the (n, p) of quickstart,
# sparse_selection and serve_risk_api's data and of train_survival_lm's
# refit panel (4 held-out batches of 32, its CPU-sized backbone's 128
# features); finetunes of up to EXAMPLE_K columns; serve_risk_api's grid
# and buckets (max_batch 32); train_survival_lm's grid of 64 and buckets
# up to 16 are phase 2's DEEP_GRID and DEEP_CURVE_BS
EXAMPLE_FITS = ((1_000, 100), (600, 120), (400, 120), (128, 128))
EXAMPLE_K = 8
EXAMPLE_GRID = 128
EXAMPLE_CURVE_BS = (1, 2, 4, 8, 16, 32)
TOOLS_DIR = ROOT / "build" / "chip_smoke"
DRYRUN_CELLS = 40
USEFUL_RANGE = (0.3, 1.5)  # model flops over counted flops, a train cell
AUTOTUNE_BS = (1, 64, 4_096)   # beside the reference's sweep (256, 1,024)

# the SSD scan (ssd_scan, replaces no TPU kernel) at the featurize cells'
# shapes, (batch, S, heads, head_dim, groups, d_state, chunk), timed and
# checked; then a ragged S and the other instantiated shapes, checked
SSD_CELLS = {"mamba2-featurize-512": (128, 512, 24, 64, 1, 128, 128),
             "nemotron3-nano-featurize-4k": (4, 4_096, 64, 64, 8, 128, 128)}
SSD_CHECKS = ((3, 300, 24, 64, 1, 128, 128), (2, 200, 16, 64, 1, 64, 64),
              (2, 37, 6, 16, 2, 16, 16))
SSD_ATOL = 1e-4          # y against the eager float32 y (TF32 off) before
                         # its rounding, beyond the kernel's own rounding to
                         # bfloat16 (2^-8 |y|, the float32 values straddling
                         # a rounding edge): sums in another order and float32
                         # operands split into bfloat16 halves, of max |y|
SSD_STATE_TOL = 5e-4     # the final state against the eager state, of its
                         # max: L = cumsum(dt A) reaches |L| ~ 600, where a
                         # float32 ulp is 6e-5, and exp(L_Q - L_s) carries
                         # that error in either summation order
BF16_PEAK = 989e12       # dense bfloat16 tensor-core rate of an H100 SXM
# the causal GQA flash-attention kernel (flash_attn, replaces no TPU
# kernel) at Nemotron-H's attention layer, (batch, S, heads, KV heads,
# head_dim), timed and checked; then ragged S, G = 1 and 16 and head_dim
# 64, checked
FA_CELL = (4, 4_096, 32, 2, 128)
FA_CHECKS = ((2, 1_000, 16, 16, 128), (2, 127, 16, 1, 64),
             (1, 4_097, 16, 4, 64))
FA_ATOL = 2.0 ** -9 * 1.05  # o against the plain version's float32 o beyond
                            # its rounding to bfloat16 (2^-8 |o|), of max |v|:
                            # P rounded to bfloat16 moves o by at most 2^-9
                            # max |v|; float32 sums in another order, exp2

# the TPU kernel each CUDA kernel replaces (its pallas_call), and the path
# whose launch count the kernels line reports
# phase 16: the (data, model) mesh. (a) the sharded train step on a (1, 1)
# mesh over a one-rank NCCL world at the launcher's widths (qwen2.5-3b, 12
# layers, vocab 4,096, bfloat16, batch 8 x 64): every parameter and moment
# a DTensor, one step from the same state as the plain step, then timed
# steps of each, in turns; (b) beside it, the mesh dry run of every cell
# on the 16 x 16 mesh in four processes (each a fake world of 256 ranks on
# meta), started when the phase starts so that they slow no earlier phase
MESH_TIMED_STEPS = 5
MESH_LOSS_RTOL = 2e-5    # the sharded step's loss against the plain step's
                         # from the same state: float32 loss, the vocab-
                         # parallel logsumexp (max, sum of exponentials,
                         # masked label logit) against torch.logsumexp and
                         # gather, a few ulps
# the parameters after that step: within 2 lr (AdamW's first move is
# +-lr, whose sign a gradient at round-off level can flip) and one
# bfloat16 ulp, |p| 2^-7 (the two float32 updates can round to neighbours)
# (c): the microbatches of (a)'s batch of 8 (2 rows each)
MESH_MICROBATCH = 4
# (d): serving on the mesh, qwen2.5-3b uncut; the decode steps timed in
# turns (the first of each left out as a warm-up)
MESH_SERVE_ARCH, MESH_SERVE_PROMPT, MESH_SERVE_NEW = "qwen2.5-3b", 128, 16
MESH_TIMED_DECODE = 8
MESH_DRYRUN_CELLS = 40
MESH_DRYRUN_TIMEOUT = 400
MESH_DRYRUN_GROUPS = (("deepseek-67b", "qwen2.5-3b", "mamba2-130m"),
                      ("mixtral-8x22b", "gemma3-12b"),
                      ("mixtral-8x7b", "zamba2-2.7b", "qwen1.5-4b"),
                      ("seamless-m4t-large-v2", "qwen2-vl-7b"))
MESH_DIR = ROOT / "build" / "chip_smoke" / "dryrun_mesh"
REPLACES = {
    "cox_coord": "src/repro/kernels/cox_coord.py:101",
    "lipschitz": "src/repro/kernels/lipschitz.py:78",
    "survival_curves": "src/repro/kernels/survival_curves.py:47",
    "revcumsum": "src/repro/kernels/revcumsum.py:55",
    "cox_batch": "src/repro/kernels/cox_batch.py:79",
    "survival_curves_stratified": "src/repro/kernels/survival_curves.py:98",
    "ssd_scan": "none: the JAX package's SSD is plain jnp "
                "(src/repro/models/ssm.py::_ssd_chunked)",
    "flash_attn": "none: the JAX package's attention is plain jnp "
                  "(src/repro/models/layers.py::flash_attention)",
}
PATH_OF = {"cox_coord": "fit and serve", "lipschitz": "fit and serve",
           "survival_curves": "fit and serve",
           "survival_curves_stratified": "stratified scoring",
           "revcumsum": "streaming fit", "cox_batch": "streaming fit",
           "ssd_scan": "deep survival", "flash_attn": "decode"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def events_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up call. When the host issues the
    calls more slowly than the device runs them, this is the host's rate."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int):
    """(device ms, wall ms) per call of ``fn`` after a warm-up call.

    Device time is the sum of the CUDA activity (kernels, memsets, copies)
    that torch.profiler records over ``reps`` calls; wall time is the host
    clock around them, ended by a synchronise. A profiler window that
    records no device activity at all is profiled once more (a short window
    of a few ctypes launches has come back empty); a second empty one
    fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us = sum(e.device_time_total for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        if busy_us > 0:
            break
        log(f"  torch.profiler recorded no device activity over {reps} "
            f"calls; profiling again")
    check(busy_us > 0, "torch.profiler recorded no device activity")
    return busy_us / reps / 1e3, wall / reps * 1e3


def kernel_ms(fn, reps: int, rounds: int = 5):
    """(CUDA-events median ms, profiler device ms) per call."""
    return events_ms(fn, reps, rounds), device_ms(fn, reps)[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

TIES = ("none", "small", "quarter")
# cox_coord also takes groups of ~1.5 kernel tiles, each crossing tile edges
COORD_TIES = TIES + ("wide",)
# lipschitz also takes groups across its 256-row segments' edges, and one
# group of every row
LIP_TIES = TIES + ("edge", "all")


def _risk_start(n: int, ties: str, gen):
    """Sorted tie-group starts: each sample's own index ("none"), groups of
    ~64 ("small"), groups of ~1,536 ("wide"), groups of ~64 and the last
    quarter of the rows in one group, as administrative censoring at one
    date gives ("quarter"), every row in one group ("all"), or each sample
    its own group but rows 216-295 and 500-1,099 (as far as n reaches), one
    group across a 256-row edge and one across three ("edge")."""
    import torch

    if ties == "all":
        return torch.zeros(n, dtype=torch.int32, device="cuda")
    if ties in ("none", "edge"):
        rs = torch.arange(n, dtype=torch.int32, device="cuda")
        if ties == "edge":
            for lo, hi in ((216, 296), (500, 1_100)):
                rs[lo:hi] = lo
        return rs
    size = 1536 if ties == "wide" else 64
    t = torch.sort(torch.randint(0, max(n // size, 1), (n,), device="cuda",
                                 generator=gen)).values
    if ties == "quarter":
        t[n - max(n // 4, 1):] = t[-1] + 1
    return torch.searchsorted(t, t, side="left").to(torch.int32)


def _coord_scales(eta, x, d, rs, order):
    """sum_i delta_i |each part of term_i| for g, h, c3, in float64."""
    import torch

    from repro_torch.kernels import ref

    e, xx, dd = eta.double(), x.double(), d.double()
    w = torch.exp(e - e.max())
    s = [ref._at(ref._suffix(w * xx ** r), rs) for r in range(4)]
    m = [s[r] / s[0] for r in range(4)]
    sg = torch.sum(dd * (m[1].abs() + xx.abs()))
    sh = torch.sum(dd * (m[2].abs() + m[1] ** 2))
    sc = torch.sum(dd * (m[3].abs() + 2 * m[1].abs() ** 3
                         + 3 * (m[2] * m[1]).abs()))
    return [float(sg), float(sh), float(sc) if order == 3 else 1.0]


# profiler windows device_ops reads before it gives up on the profiler
OPS_WINDOWS = 3


def device_ops(fn) -> list:
    """Names of the device operations (kernels, copies, memsets) one call
    of ``fn`` issues, by torch.profiler, after a warm-up call.

    Each window brackets the call between two fills of a marker tensor,
    and the call's operations are those between the two fills. A window
    that lost either marker is profiled again, up to OPS_WINDOWS windows:
    short windows of a few ctypes launches have come back empty, or
    missing their first kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    # the warm-up call in a window of its own: the first profiler window of
    # a process has come back missing its first kernel
    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    for _ in range(OPS_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.fill_(1.0)
            fn()
            marker.fill_(2.0)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        if (len(names) >= 2 and "FillFunctor" in names[0]
                and "FillFunctor" in names[-1]):
            return names[1:-1]
        log(f"  torch.profiler lost a marker of the window ({names}); "
            f"profiling again")
    check(False, f"torch.profiler lost a marker in {OPS_WINDOWS} windows")


def check_launch_shape(name: str, fn, want: int, prefix: str) -> None:
    """One call of ``fn`` issues ``want`` kernels whose names hold
    ``prefix`` and no other device operation."""
    names = device_ops(fn)
    log(f"  {name}: one call issues {len(names)} device operations {names} "
        f"(expected {want}, all {prefix}*)")
    check(len(names) == want and all(prefix in n for n in names),
          f"{name}: a call issued {names}")


# the curve kernels' launch-plan edges: 16-byte and scalar rows, tails,
# one row and a batch one past a power of two
CURVE_BS = (1, 37, 4_096, 4_097)
CURVE_GS = (1, 3, 4, 5, 127, 128, 129, 257)
# (b, s, g) of stratified tables with more strata than a block stages in
# shared memory (survival_curves.STAGED_STRATA): read by __ldg
LARGE_TABLES = ((37, 512, 257), (4_096, 512, 257), (4_096, 65, 128))


def curve_eta(b: int, gen):
    """~3 N(0, 1) with +50 and -50 in the batch, past the +/-30 clip."""
    import torch

    eta = torch.randn(b, device="cuda", generator=gen) * 3.0
    eta[0] = 50.0
    if b > 1:
        eta[1] = -50.0
    return eta


def check_curve(name: str, fn, want) -> float:
    """``fn()`` against ``want`` within CURVES_ATOL, the same bits twice;
    returns the largest absolute error."""
    import torch

    got = fn()
    same = torch.equal(got, fn())
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"  {name}: max |err| {err:.3e} (tol {CURVES_ATOL:.0e}); same bits "
        f"twice: {same}")
    check(err <= CURVES_ATOL and bool(torch.isfinite(got).all()) and same,
          name)
    return err


def check_kernels(coord_ns=None, curve_bs=CURVE_BS,
                  curve_gs=CURVE_GS, deep_curve_bs=DEEP_CURVE_BS,
                  launch_shape=True) -> dict:
    """Every kernel against its plain version on the card, then, with
    ``launch_shape``, one call's launch shape of cox_coord and
    survival_curves; returns the largest absolute error of each."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import cox_coord as coord_mod
    from repro_torch.kernels import survival_curves as curves_mod
    from repro_torch.kernels.cox_coord import cox_coord
    from repro_torch.kernels.survival_curves import survival_curves

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {"cox_coord": 0.0, "survival_curves": 0.0}

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    tile = coord_mod.TILE
    if coord_ns is None:
        coord_ns = (1, tile - 1, tile, tile + 1, TRAIN_N, DEEP_N, N,
                    1_048_577)
    for n in coord_ns:
        for ties in COORD_TIES:
            x = randn(n)
            d = (torch.rand(n, device="cuda", generator=gen) < 0.7).float()
            rs = _risk_start(n, ties, gen)
            groups = ops.group_events(d, rs)
            for spread in ("0.8 N(0, 1)", "U(-80, 80)"):
                eta = (randn(n) * 0.8 if spread.startswith("0.8")
                       else (torch.rand(n, device="cuda", generator=gen)
                             * 160.0 - 80.0))
                for order in (2, 3):
                    got = cox_coord(eta, x, d, rs, order=order,
                                    group_events=groups).clone()
                    again = cox_coord(eta, x, d, rs, order=order,
                                      group_events=groups).clone()
                    want = torch.stack(ref.cox_coord_ref(eta, x, d, rs,
                                                         order))
                    torch.cuda.synchronize()
                    err = (got - want).abs().double().cpu().tolist()
                    scales = _coord_scales(eta, x, d, rs, order)
                    worst = max(e / s for e, s in zip(err, scales))
                    same = torch.equal(got, again)
                    log(f"  cox_coord n={n} ties={ties} eta~{spread} "
                        f"order={order}: max |err| {max(err):.3e}, max "
                        f"|err|/sum|terms| {worst:.3e} (tol {COORD_TOL:.0e})"
                        f"; same bits twice: {same}")
                    check(worst <= COORD_TOL and bool(torch.isfinite(got).all())
                          and same,
                          f"cox_coord n={n} ties={ties} eta~{spread} "
                          f"order={order}")
                    errs["cox_coord"] = max(errs["cox_coord"], max(err))
            # without group_events the wrapper makes them itself
            got = cox_coord(eta, x, d, rs, order=3).clone()
            check(torch.equal(got, cox_coord(eta, x, d, rs, order=3,
                                             group_events=groups)),
                  f"cox_coord n={n} ties={ties}: made group_events differ")
    if launch_shape:
        eta, x = randn(N) * 0.8, randn(N)
        d = (torch.rand(N, device="cuda", generator=gen) < 0.7).float()
        rs = _risk_start(N, "quarter", gen)
        groups = ops.group_events(d, rs)
        check_launch_shape(
            f"cox_coord n={N}",
            lambda: cox_coord(eta, x, d, rs, group_events=groups),
            coord_mod.KERNELS_PER_CALL, "coord_")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(b, g) for b in curve_bs for g in curve_gs]
    for b, g in shapes + [(b, DEEP_GRID) for b in deep_curve_bs]:
        eta = curve_eta(b, gen)
        h0 = torch.cumsum(torch.rand(g, device="cuda", generator=gen),
                          0) * 0.05
        pl = curves_mod.plan(b, g, sms)
        err = check_curve(
            f"survival_curves b={b} g={g} (vec {pl.vec}, {pl.blocks} "
            f"blocks, slab {pl.slab})",
            lambda: survival_curves(eta, h0),
            ref.survival_curves_ref(eta, h0))
        errs["survival_curves"] = max(errs["survival_curves"], err)
    # a baseline off 16-byte alignment takes the scalar path at g = 128
    h0 = (torch.cumsum(torch.rand(129, device="cuda", generator=gen), 0)
          * 0.05)[1:]
    eta = curve_eta(4_096, gen)
    check(h0.data_ptr() % 16 != 0, "the offset baseline is aligned")
    err = check_curve("survival_curves b=4096 g=128, baseline off 16 bytes",
                      lambda: survival_curves(eta, h0),
                      ref.survival_curves_ref(eta, h0))
    errs["survival_curves"] = max(errs["survival_curves"], err)
    if launch_shape:
        h0 = h0.clone()
        check_launch_shape("survival_curves b=4096 g=128",
                           lambda: survival_curves(eta, h0),
                           curves_mod.KERNELS_PER_CALL, "curves_panel")
    return errs


COORD_CANDIDATES = (8, 30, 40)   # the search's C: 8 at size 1, ~30 above
# (j, prev) of the fused steps checked over s = 5 columns: the first step
# with nothing pending, steps along a sweep, and a sweep's wrap-around
COORD_STEPS = ((0, None), (1, 0), (2, 1), (4, 2), (0, 4))


def _ulps(a, b) -> float:
    """Largest |a - b| in float32 ulps of b."""
    import torch

    a, b = a.double(), b.double()
    return float(((a - b).abs() / torch.finfo(torch.float32).eps
                  / b.abs().clamp(min=1e-30)).max())


def check_coord_candidates(n=N, cs=COORD_CANDIDATES, s=5,
                           lam2=1e-3) -> float:
    """``cox_coord`` over (C, n) and the fused ``cox_coord_step`` at the
    search's C and n, on tie-free and tied times. The batched call's rows
    equal C single calls bit for bit (orders 2 and 3). Over ``COORD_STEPS``
    the fused step is held against the eager step on the same inputs
    (``solvers.coord_step``'s plain route): its eta within 1 ulp of the
    eager ``addcmul``, its (g, h) rows single calls' on that eta bit for
    bit and within ``COORD_TOL`` of the plain version's, its step and beta
    ``surrogate.quad_min`` of its g within 1 ulp. Each call adds C to the
    ``cox_coord`` launch count. Returns the largest |g, h error| against
    the plain version."""
    import torch

    from repro_torch.core import surrogate
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.cox_coord import cox_coord

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst_err = 0.0
    for ties in ("none", "quarter"):
        d = (torch.rand(n, device="cuda", generator=gen) < 0.7).float()
        rs = _risk_start(n, ties, gen)
        groups = ops.group_events(d, rs)
        for c in cs:
            what = f"cox_coord C={c} n={n} ties={ties}"
            rows = torch.randn(c, s, n, device="cuda", generator=gen)
            eta = 0.8 * torch.randn(c, n, device="cuda", generator=gen)
            x0 = rows[:, 0].contiguous()
            for order in (2, 3):
                ops.reset_launch_counts()
                got = cox_coord(eta, x0, d, rs, order, groups).clone()
                check(ops.launch_counts()["cox_coord"] == c,
                      f"{what} order={order}: the launch count rose by "
                      f"{ops.launch_counts()['cox_coord']}, not {c}")
                same = all(torch.equal(got[r], cox_coord(
                    eta[r], x0[r], d, rs, order, groups)) for r in range(c))
                check(same, f"{what} order={order}: a row differs from its "
                            f"single call")
            beta = 0.1 * torch.randn(c, s, device="cuda", generator=gen)
            curv = torch.rand(c, s, device="cuda", generator=gen) + 0.5
            step = torch.zeros(c, device="cuda")
            worst = {"eta": 0.0, "step": 0.0, "beta": 0.0, "gh": 0.0}
            for j, prev in COORD_STEPS:
                e0, b0, s0 = eta.clone(), beta.clone(), step.clone()
                ops.reset_launch_counts()
                out = ops.cox_coord_step(eta, rows, j, prev, beta, curv,
                                         step, d, groups, lam2).clone()
                check(ops.launch_counts()["cox_coord"] == c,
                      f"{what} step ({j}, {prev}): the launch count rose "
                      f"by {ops.launch_counts()['cox_coord']}, not {c}")
                if prev is None:
                    check(torch.equal(eta, e0),
                          f"{what} step ({j}, None): eta moved")
                else:
                    worst["eta"] = max(worst["eta"], _ulps(
                        eta, e0.addcmul(rows[:, prev], s0[:, None])))
                xj = rows[:, j].contiguous()
                same = all(torch.equal(out[r], cox_coord(
                    eta[r], xj[r], d, rs, 2, groups)) for r in range(c))
                check(same, f"{what} step ({j}, {prev}): (g, h) differs from "
                            f"a single call on the step's eta")
                for r in range(c):
                    scales = _coord_scales(eta[r], xj[r], d, rs, 2)[:2]
                    want = ref.cox_coord_groups_ref(eta[r], xj[r], d, groups)
                    errs = [abs(float(out[r, q]) - float(want[q]))
                            for q in range(2)]
                    worst_err = max(worst_err, max(errs))
                    worst["gh"] = max(worst["gh"], *(e / sc for e, sc in
                                                     zip(errs, scales)))
                dq = surrogate.quad_min(out[:, 0] + 2.0 * lam2 * b0[:, j],
                                        curv[:, j])
                worst["step"] = max(worst["step"], _ulps(step, dq))
                worst["beta"] = max(worst["beta"],
                                    _ulps(beta[:, j], b0[:, j] + dq))
                others = [q for q in range(s) if q != j]
                check(torch.equal(beta[:, others], b0[:, others]),
                      f"{what} step ({j}, {prev}): another column's beta "
                      f"moved")
            log(f"  {what}: rows = single calls bit for bit; fused steps "
                f"{[jp for jp in COORD_STEPS]}: eta {worst['eta']:.2f} ulp "
                f"of the eager step's, step {worst['step']:.2f} and beta "
                f"{worst['beta']:.2f} ulp of quad_min's, (g, h) "
                f"{worst['gh']:.3e} of sum|terms| from the plain version "
                f"(tol {COORD_TOL:.0e})")
            check(worst["eta"] <= 1.0 and worst["step"] <= 1.0
                  and worst["beta"] <= 1.0 and worst["gh"] <= COORD_TOL,
                  f"{what}: the fused step is off the eager step")
    return worst_err


def _suffix_abs(x):
    """suffix(|x|) along rows in float64: the scale of a scan's error."""
    from repro_torch.kernels import ref

    return ref._suffix(x.double().abs())


def batch_vectors(eta, delta):
    """(w, r, wa, delta, inv_s0) as ops.cox_batch_grad_hess forms them."""
    import torch

    from repro_torch.kernels import ref

    w = torch.exp(eta - torch.max(eta))
    inv_s0 = 1.0 / ref._suffix(w)
    wa = w * torch.cumsum(delta * inv_s0, 0)
    return w, wa - delta, wa, delta, inv_s0


def _batch_scales(x, w, r, wa, delta, inv_s0):
    """Per column sum_i |term_i| of grad and hess_diag, in float64."""
    from repro_torch.kernels import ref

    x, w, r, wa = x.double(), w.double(), r.double(), wa.double()
    m = ref._suffix(w[:, None] * x) * inv_s0.double()[:, None]
    sg = r.abs() @ x.abs()
    sh = wa @ (x * x) + delta.double() @ (m * m)
    return sg, sh


SCAN_SHAPES = tuple((STREAM_CHUNK, m) for m in (1, 8, 31, 32, 33, 1_000,
                                               1_001)) + (
    (STREAM_CHUNK,), (1, 1), (777, 3), (4_097, 1_000), (4_097, 256),
    (4_097, 255), (4_097, 33), (70_001, 8))


def check_scan(x) -> float:
    """revcumsum of ``x`` against its plain version within REVCUMSUM_TOL,
    the same bits twice; returns the largest absolute error."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.revcumsum import revcumsum

    shape, dtype = tuple(x.shape), str(x.dtype).removeprefix("torch.")
    got = revcumsum(x)
    same = torch.equal(got, revcumsum(x))
    want = ref.revcumsum_ref(x)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs()
    rel = float((err / _suffix_abs(x).clamp_min(1e-30)).max())
    check(got.dtype == x.dtype and got.shape == x.shape
          and bool(torch.isfinite(got).all()),
          f"revcumsum {shape} {dtype}: output")
    log(f"  revcumsum {shape} {dtype}: max |err| {float(err.max()):.3e},"
        f" max |err|/suffix|x| {rel:.3e} (tol "
        f"{REVCUMSUM_TOL[dtype]:.0e}); same bits twice: {same}")
    check(rel <= REVCUMSUM_TOL[dtype] and same, f"revcumsum {shape} {dtype}")
    return float(err.max())


def selection_scan_shapes():
    """The (n, m) panels the selection path scans: the full width and
    every distinct column block of ``score_candidates``; then those of
    phase 12's refit panel."""
    from repro_torch.core import beam

    shapes = []
    for n, p in ((N, P), (DEEP_N, DEEP_D), (TRAIN_N, DEEP_D)):
        widths = {c.stop - c.start for c in beam.column_blocks(n, p, 4)}
        shapes += [(n, p)] + [(n, m) for m in sorted(widths, reverse=True)
                              if m != p]
    return tuple(shapes) + ((TRAIN_N, TRAIN_SCAN_BLOCK),)


def check_selection_scans(shapes) -> float:
    """revcumsum at the selection path's float32 panels; returns the
    largest absolute error."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = 0.0
    for shape in shapes:
        worst = max(worst, check_scan(torch.randn(*shape, device="cuda",
                                                  generator=gen)))
        torch.cuda.empty_cache()
    return worst


STRAT_SHAPES = ((1, 1, 16),) + tuple(
    (b, STRATA, g) for b in CURVE_BS for g in CURVE_GS) + LARGE_TABLES


def check_stream_kernels(scan_shapes=SCAN_SHAPES,
                         strat_shapes=STRAT_SHAPES) -> dict:
    """revcumsum and the stratified curves against their plain versions on
    the card; returns the largest absolute error of each, in float32 and,
    for revcumsum, bfloat16."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import revcumsum as revcumsum_mod
    from repro_torch.kernels import survival_curves as curves_mod
    from repro_torch.kernels.revcumsum import revcumsum
    from repro_torch.kernels.survival_curves import \
        survival_curves_stratified

    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {"revcumsum": 0.0, "survival_curves_stratified": 0.0}
    errs_bf16 = {"revcumsum": 0.0}

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    for shape in scan_shapes:
        x32 = randn(*shape)
        for dtype in ("float32", "bfloat16"):
            into = errs if dtype == "float32" else errs_bf16
            into["revcumsum"] = max(into["revcumsum"], check_scan(
                x32.to(getattr(torch, dtype))))
        del x32
        torch.cuda.empty_cache()
    panel = randn(STREAM_CHUNK, P)
    vector = randn(STREAM_CHUNK)
    per_call = revcumsum_mod.KERNELS_PER_CALL
    check_launch_shape(f"revcumsum {tuple(panel.shape)}",
                       lambda: revcumsum(panel), per_call["panel"],
                       "rcs_panel")
    check_launch_shape(f"revcumsum {tuple(vector.shape)}",
                       lambda: revcumsum(vector), per_call["vector"],
                       "rcs_vec")
    del panel, vector

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    routes = set()
    for b, s, g in strat_shapes:
        eta = curve_eta(b, gen)
        h0 = torch.cumsum(torch.rand(s, g, device="cuda", generator=gen),
                          1) * 0.05
        strata = torch.randint(0, s, (b,), device="cuda", generator=gen,
                               dtype=torch.int32)
        pl = curves_mod.plan(b, g, sms, s, stratified=True)
        route = "staged in shared memory" if pl.staged else "read by __ldg"
        check(pl.staged == ((b, s, g) not in LARGE_TABLES),
              f"survival_curves_stratified b={b} s={s} g={g}: {route}")
        routes.add(route)
        err = check_curve(
            f"survival_curves_stratified b={b} s={s} g={g} (vec {pl.vec}, "
            f"table {route})",
            lambda: survival_curves_stratified(eta, h0, strata),
            ref.survival_curves_stratified_ref(eta, h0, strata))
        errs["survival_curves_stratified"] = max(
            errs["survival_curves_stratified"], err)
    check(len(routes) == 2, f"the stratified checks took only {routes}")
    check_launch_shape(f"survival_curves_stratified b={b} s={s} g={g}",
                       lambda: survival_curves_stratified(eta, h0, strata),
                       curves_mod.KERNELS_PER_CALL, "curves_panel")
    b, s, g = 4_096, STRATA, 128
    eta = curve_eta(b, gen)
    h0 = torch.rand(s, g, device="cuda", generator=gen)
    strata = torch.randint(0, s, (b,), device="cuda", generator=gen,
                           dtype=torch.int32)
    check_launch_shape(f"survival_curves_stratified b={b} s={s} g={g}",
                       lambda: survival_curves_stratified(eta, h0, strata),
                       curves_mod.KERNELS_PER_CALL, "curves_panel")
    return {"float32": errs, "bfloat16": errs_bf16}


BATCH_NS = (1, 255, 256, 257, 2_050, STREAM_CHUNK)
BATCH_PS = (1, 31, 32, 33, 70, P)


def check_cox_batch(ns=BATCH_NS, ps=BATCH_PS) -> dict:
    """cox_batch against its plain version on the card at every (n, p) of
    ``ns`` x ``ps`` (segment and strip edges, odd p in bfloat16), the same
    bits twice; then one call's launch shape. Returns the largest absolute
    error in float32 and in bfloat16."""
    import torch

    from repro_torch.kernels import cox_batch as batch_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.cox_batch import cox_batch

    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for n in ns:
        for p in ps:
            x32 = torch.randn(n, p, device="cuda", generator=gen)
            eta = torch.randn(n, device="cuda", generator=gen) * 0.5
            d = (torch.rand(n, device="cuda", generator=gen) < 0.7).float()
            vecs = batch_vectors(eta, d)
            for dtype in errs:
                x = x32.to(getattr(torch, dtype))
                got = [t.clone() for t in cox_batch(x, *vecs)]
                again = cox_batch(x, *vecs)
                want = ref.cox_batch_ref(x, *vecs)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                scales = _batch_scales(x, *vecs)
                err = [(g.double() - w_.double()).abs()
                       for g, w_ in zip(got, want)]
                rel = max(float((e / sc.clamp_min(1e-30)).max())
                          for e, sc in zip(err, scales))
                abs_err = max(float(e.max()) for e in err)
                log(f"  cox_batch n={n} p={p} {dtype}: max |err| "
                    f"{abs_err:.3e}, max |err|/sum|terms| {rel:.3e} (tol "
                    f"{COX_BATCH_TOL:.0e}); same bits twice: {same}")
                check(rel <= COX_BATCH_TOL and same
                      and all(bool(torch.isfinite(g).all()) for g in got),
                      f"cox_batch n={n} p={p} {dtype}")
                errs[dtype] = max(errs[dtype], abs_err)
                del x, got, again, want, err, scales
            del x32
            torch.cuda.empty_cache()
    x = torch.randn(STREAM_CHUNK, P, device="cuda", generator=gen)
    vecs = batch_vectors(torch.randn(STREAM_CHUNK, device="cuda",
                                     generator=gen) * 0.5,
                         (torch.rand(STREAM_CHUNK, device="cuda",
                                     generator=gen) < 0.5).float())
    for dtype in ("float32", "bfloat16"):
        xd = x.to(getattr(torch, dtype))
        check_launch_shape(f"cox_batch {tuple(x.shape)} {dtype}",
                           lambda: cox_batch(xd, *vecs),
                           batch_mod.KERNELS_PER_CALL, "cb_panel")
    return errs


def check_lipschitz(ns=(1, 257, 65_537, N), ps=(1, 15, 37, P),
                    launch_shape=True) -> float:
    """lipschitz against its plain version on the card at every (n, p) of
    ``ns`` x ``ps`` and every tie layout of LIP_TIES: the same bits twice
    and with or without the fit's group counts; then, with
    ``launch_shape``, one call's launch shape. Returns the largest
    absolute error."""
    import torch

    from repro_torch.kernels import lipschitz as lip_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lipschitz import lipschitz

    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = 0.0
    for n in ns:
        for p in ps:
            for ties in LIP_TIES:
                x = torch.randn(n, p, device="cuda", generator=gen)
                d = (torch.rand(n, device="cuda", generator=gen)
                     < 0.7).float()
                rs = _risk_start(n, ties, gen)
                groups = ops.group_events(d, rs)
                got = [t.clone() for t in lipschitz(x, d, rs)]
                again = lipschitz(x, d, rs, group_events=groups)
                want = ref.lipschitz_ref(x, d, rs)
                del x
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                rel = max(float(((g - w).abs() / w.abs().clamp_min(1e-30))
                                .max()) for g, w in zip(got, want))
                log(f"  lipschitz n={n} p={p} ties={ties}: max |err| "
                    f"{err:.3e}, max rel err {rel:.3e} (tol "
                    f"{LIPSCHITZ_RTOL:.0e}); same bits twice, with and "
                    f"without group_events: {same}")
                check(rel <= LIPSCHITZ_RTOL and same
                      and all(bool(torch.isfinite(g).all()) for g in got),
                      f"lipschitz n={n} p={p} ties={ties}")
                worst = max(worst, err)
                del got, again, want
                torch.cuda.empty_cache()
    if not launch_shape:
        return worst
    x = torch.randn(N, P, device="cuda", generator=gen)
    d = (torch.rand(N, device="cuda", generator=gen) < 0.7).float()
    rs = _risk_start(N, "quarter", gen)
    groups = ops.group_events(d, rs)
    check_launch_shape(f"lipschitz {tuple(x.shape)}",
                       lambda: lipschitz(x, d, rs, group_events=groups),
                       lip_mod.KERNELS_PER_CALL, "lip_panel")
    return worst


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------

def run_fit(data, lam1, lam2, method, sweeps):
    import torch

    from repro_torch.core import solvers
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solvers.fit_cd(data, lam1=lam1, lam2=lam2, n_iters=sweeps,
                         method=method)
    obj = res.objective.cpu().double()
    seconds = time.perf_counter() - t0
    after = ops.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    log(f"  {method}: {sweeps} sweeps in {seconds:.3f} s "
        f"({seconds / sweeps:.4f} s per sweep); objective "
        f"{obj[0]:.6f} -> {obj[-1]:.6f}; launches {launched}")
    check(bool(torch.isfinite(obj).all()), f"{method}: objective finite")
    rises = obj[1:] - obj[:-1]
    check(bool((rises <= MONO_RTOL * obj[:-1].abs()).all()),
          f"{method}: objective rose: {obj.tolist()}")
    check(launched["cox_coord"] == data.p * sweeps,
          f"{method}: cox_coord launched {launched['cox_coord']} times, "
          f"expected p x sweeps = {data.p * sweeps}")
    check(launched["lipschitz"] == 1, f"{method}: lipschitz launched "
          f"{launched['lipschitz']} times, expected 1")
    return res, seconds / sweeps


def compare_fits(data, lam1, lam2, fits) -> None:
    """The fit's kernel path against its plain path over the first
    COMPARE_SWEEPS sweeps of each method. Run after the main path's launch
    counts are read: these launches only compare."""
    import torch

    from repro_torch.core import solvers

    log("fit: kernel path against the plain path")
    for method, main in fits.items():
        kern, plain = (solvers.fit_cd(data, lam1=lam1, lam2=lam2,
                                      n_iters=COMPARE_SWEEPS, method=method,
                                      use_kernel=use)
                       for use in (True, False))
        kobj = kern.objective.cpu().double()
        pobj = plain.objective.cpu().double()
        same = torch.equal(kobj,
                           main.objective[:COMPARE_SWEEPS].cpu().double())
        decrease = float(pobj[0] - pobj[1])
        dobj = float((kobj - pobj).abs().max())
        dbeta = float((kern.beta - plain.beta).abs().max())
        bmax = float(plain.beta.abs().max())
        log(f"  {method}, {COMPARE_SWEEPS} sweeps: plain objective "
            f"{pobj.tolist()}, second-sweep decrease {decrease:.6f}; "
            f"max |objective diff| {dobj:.6f} = {dobj / decrease:.3e} of it "
            f"(tol {FIT_DTOL:.0e}); max |beta diff| {dbeta:.3e} of max "
            f"|beta| {bmax:.4f} = {dbeta / bmax:.3e} (tol {BETA_RTOL:.0e}); "
            f"kernel fit repeats the main fit's objective bit for bit: {same}")
        check(same, f"{method}: the kernel fit did not repeat its bits")
        check(decrease > 0 and dobj <= FIT_DTOL * decrease,
              f"{method}: kernel path's objective left the plain path's")
        check(dbeta <= BETA_RTOL * bmax,
              f"{method}: kernel path's beta left the plain path's")


def main_path(x, t, delta) -> dict:
    """Fit, artifact, serving at full size; returns what timings need."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.core import cox
    from repro_torch.kernels import ops
    from repro_torch.serving import ScoringEngine, SurvivalModel
    from repro_torch.serving import fit_survival_model

    log("phase 3: fit")
    data = convert.cox_data_from_numpy(x, t, delta, device="cuda")
    n_ties = data.n - int(torch.unique(data.risk_start).numel())
    grad0 = cox.grad_all(data, torch.zeros(data.n, device="cuda"))
    lam1, lam2 = 0.1 * float(grad0.abs().max()), 1.0
    log(f"  n={data.n} p={data.p} events={int(data.delta.sum())} "
        f"tied samples={n_ties} lam1={lam1:.4f} lam2={lam2}")
    from repro_torch.kernels import cox_coord as coord_mod
    log(f"  a cox_coord call is {coord_mod.KERNELS_PER_CALL} kernel launches;"
        f" the launch counts below count calls")
    quad, quad_sweep_s = run_fit(data, lam1, lam2, "cd_quad", QUAD_SWEEPS)
    cubic, cubic_sweep_s = run_fit(data, lam1, lam2, "cd_cubic",
                                   CUBIC_SWEEPS)

    log("phase 4: artifact")
    beta = quad.beta.cpu().numpy()
    model = fit_survival_model(x, t, delta, beta)
    h0 = model.base_cumhaz[0]
    check(bool(np.all(np.isfinite(h0)) and np.all(np.diff(h0) >= 0)
               and h0[0] >= 0), "baseline hazard finite and nondecreasing")
    cpu_model = fit_survival_model(x, t, delta, beta, device="cpu")
    rel = float(np.max(np.abs(h0 - cpu_model.base_cumhaz[0])
                       / np.maximum(np.abs(cpu_model.base_cumhaz[0]), 1e-30)))
    log(f"  grid {model.n_grid}, support {model.k}, H0 {h0[0]:.4g}.."
        f"{h0[-1]:.4g}; card vs CPU max rel diff {rel:.3e} "
        f"(tol {ARTIFACT_RTOL:.0e})")
    check(rel <= ARTIFACT_RTOL, "artifact: card and CPU baselines differ")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        loaded = SurvivalModel.load(model.save(str(Path(tmp) / "model")),
                                    verify=True)
    for name in ("beta", "time_grid", "base_cumhaz", "support",
                 "beta_support"):
        a, b = getattr(model, name), getattr(loaded, name)
        check((a is None and b is None) or np.array_equal(a, b),
              f"artifact round trip: {name}")
    log("  save/load round trip with sha256 checks: arrays equal")

    log("phase 5: serving")
    engine = ScoringEngine(model)
    rng = np.random.default_rng(SEED + 1)
    batch_s = {}
    before = ops.launch_counts()["survival_curves"]
    for b in BATCHES:
        q = x[rng.integers(0, x.shape[0], b)]
        risk, med, curves = engine.score(q, with_curves=True)
        bt = torch.as_tensor(engine._beta)
        qt = torch.as_tensor(q, device="cuda")
        if engine.use_sparse:
            qt = qt[:, torch.as_tensor(model.support, device="cuda").long()]
        eta = torch.clamp(qt @ bt, -30.0, 30.0)
        s_ref = torch.exp(-engine._h0[0][None, :] * torch.exp(eta)[:, None])
        s_ref = s_ref.cpu().numpy()
        err_c = float(np.max(np.abs(curves - s_ref)))
        err_r = float(np.max(np.abs(risk - torch.exp(eta).cpu().numpy())
                             / torch.exp(eta).cpu().numpy()))
        below = s_ref <= 0.5
        med_ref = np.where(below.any(1), model.time_grid[below.argmax(1)],
                           np.inf)
        check(curves.shape == (b, model.n_grid) and np.isfinite(curves).all()
              and err_c <= CURVES_ATOL and err_r <= 1e-5
              and np.array_equal(med, med_ref), f"serving batch {b}")
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.score(q, with_curves=True)
        batch_s[b] = (time.perf_counter() - t0) / reps
        log(f"  batch {b}: curves max |err| {err_c:.3e} (tol "
            f"{CURVES_ATOL:.0e}), risk rel err {err_r:.3e}; "
            f"{batch_s[b] * 1e3:.3f} ms per scored batch "
            f"(sparse={engine.use_sparse})")
    curve_launches = ops.launch_counts()["survival_curves"] - before
    check(curve_launches >= 21 * len(BATCHES),
          f"survival_curves launched {curve_launches} times")
    return {"data": data, "model": model, "engine": engine,
            "lam1": lam1, "lam2": lam2,
            "fits": {"cd_quad": quad, "cd_cubic": cubic},
            "quad_sweep_s": quad_sweep_s, "cubic_sweep_s": cubic_sweep_s,
            "batch_s": batch_s}


# ---------------------------------------------------------------------------
# Phase 5b: stratified scoring
# ---------------------------------------------------------------------------

def stratified_scoring(x, t, delta, beta) -> dict:
    """The artifact of ``x, t, delta`` and ``beta`` with STRATA strata,
    scored with stratum indices against the closed form; returns seconds
    per scored batch."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import ScoringEngine, fit_survival_model

    log("phase 5b: stratified scoring")
    strata = np.random.default_rng(SEED + 2).integers(0, STRATA, len(t))
    model = fit_survival_model(x, t, delta, beta, strata=strata)
    h0 = model.base_cumhaz
    check(model.n_strata == STRATA and np.all(np.isfinite(h0))
          and np.all(np.diff(h0, axis=1) >= 0), "stratified baselines")
    engine = ScoringEngine(model)
    h0_dev = torch.as_tensor(h0, device="cuda")
    rng = np.random.default_rng(SEED + 3)
    batch_s = {}
    for b in BATCHES:
        q = x[rng.integers(0, x.shape[0], b)]
        sq = rng.integers(0, STRATA, b)
        risk, med, curves = engine.score(q, sq, with_curves=True)
        qt = torch.as_tensor(q, device="cuda")
        if engine.use_sparse:
            qt = qt[:, torch.as_tensor(model.support, device="cuda").long()]
        eta = torch.clamp(qt @ engine._beta, -30.0, 30.0)
        s_ref = torch.exp(-h0_dev[torch.as_tensor(sq, device="cuda")]
                          * torch.exp(eta)[:, None]).cpu().numpy()
        risk_ref = torch.exp(eta).cpu().numpy()
        err_c = float(np.max(np.abs(curves - s_ref)))
        err_r = float(np.max(np.abs(risk - risk_ref) / risk_ref))
        below = s_ref <= 0.5
        med_ref = np.where(below.any(1), model.time_grid[below.argmax(1)],
                           np.inf)
        check(curves.shape == (b, model.n_grid) and np.isfinite(curves).all()
              and err_c <= CURVES_ATOL and err_r <= 1e-5
              and np.array_equal(med, med_ref), f"stratified batch {b}")
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.score(q, sq, with_curves=True)
        batch_s[b] = (time.perf_counter() - t0) / reps
        log(f"  batch {b}: curves max |err| {err_c:.3e} (tol "
            f"{CURVES_ATOL:.0e}), risk rel err {err_r:.3e}; "
            f"{batch_s[b] * 1e3:.3f} ms per scored batch "
            f"(strata={STRATA}, sparse={engine.use_sparse})")
    check(ops.launch_counts()["survival_curves"] == 0,
          "a stratified model launched the single-baseline kernel")
    return {"batch_s": batch_s, "h0": engine._h0, "model": model}


# ---------------------------------------------------------------------------
# Phase 11: the serving front end on the card
# ---------------------------------------------------------------------------

def _percentile_ms(latencies, q: float) -> float:
    import numpy as np

    return float(np.percentile(latencies, q) * 1e3) if len(latencies) else 0.0


def _in_threads(fn, seconds: float) -> float:
    """``fn(slot)`` on SERVE_THREADS threads at once; raises if one raised
    or outlived ``seconds``. Returns the seconds from start to join."""
    import threading

    errors = []

    def run(slot):
        try:
            fn(slot)
        except Exception as e:   # raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,))
               for s in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(seconds)
    elapsed = time.perf_counter() - t0
    check(not errors and not any(th.is_alive() for th in threads),
          f"threads failed: {errors}")
    return elapsed


def _submit_rows(svc, x, n_total: int, seed: int, strata: int = 0) -> list:
    """SERVE_THREADS submitter threads push ``n_total`` rows of x drawn
    from seeded generators, SERVE_HIGH of them HIGH, no deadlines; returns
    (rid, row, stratum) per request. With ``strata`` each request carries a
    stratum drawn from the same generator."""
    import numpy as np

    from repro_torch.serving import Priority

    per = n_total // SERVE_THREADS
    out = [[] for _ in range(SERVE_THREADS)]

    def produce(slot):
        rng = np.random.default_rng(seed + slot)
        rows = rng.integers(0, x.shape[0], per)
        high = rng.random(per) < SERVE_HIGH
        sts = rng.integers(0, max(strata, 1), per)
        for i, h, s in zip(rows, high, sts):
            prio = Priority.HIGH if h else Priority.LOW
            out[slot].append((svc.submit(x[i], int(s), priority=prio),
                              int(i), int(s)))

    _in_threads(produce, 120.0)
    return [r for slot in out for r in slot]


def _await_served(what: str, svc, requests) -> list:
    """The responses to ``requests``, every one ``ok``."""
    resps = [svc.wait(rid, timeout=120.0) for rid, _, _ in requests]
    bad = [r.error for r in resps if not r.ok]
    check(not bad, f"{what}: {len(bad)} error responses, first {bad[:3]}")
    return resps


def _check_served(what: str, svc, engine, x, requests, resps,
                  beta=None) -> dict:
    """Each served risk, median and curve as direct ``engine.score`` calls
    of the same rows give them, made in the service's batch size (so in
    the bucket most batches took); with ``beta``, each risk also as
    exp(clip(x beta, -30, 30)) in float64 within DEEP_RISK_RTOL. Returns
    the errors and the number of those calls, which launch kernels of
    their own: read a path's counts before this check."""
    import numpy as np

    rows = np.asarray([i for _, i, _ in requests])
    strata = np.asarray([s for _, _, s in requests], np.int32)
    b = svc.max_batch
    direct = [engine.score(x[rows[i:i + b]], strata[i:i + b]
                           if engine.model.n_strata > 1 else None,
                           with_curves=True)
              for i in range(0, len(rows), b)]
    risk, med, curves = (np.concatenate(parts) for parts in zip(*direct))
    got_risk = np.asarray([r.risk for r in resps])
    got_med = np.asarray([r.median for r in resps])
    got_curves = np.stack([r.curve for r in resps])
    err_r = float(np.max(np.abs(got_risk - risk) / risk))
    err_c = float(np.max(np.abs(got_curves - curves)))
    same_med = bool(np.array_equal(got_med, med))
    log(f"  {what}: {len(resps)} requests ok; against {len(direct)} direct "
        f"engine.score calls of the same rows, {b} at a time: risk rel err "
        f"{err_r:.3e} (tol {SERVE_RISK_RTOL:.0e}), curves max |err| "
        f"{err_c:.3e} (tol {CURVES_ATOL:.0e}), medians equal: {same_med}")
    check(np.all(np.isfinite(got_curves)) and err_r <= SERVE_RISK_RTOL
          and err_c <= CURVES_ATOL and same_med,
          f"{what}: served scores differ from the engine's")
    out = {"risk_rel_err": err_r, "curves_max_abs_err": err_c,
           "direct_calls": len(direct)}
    if beta is not None:
        expect = np.exp(np.clip(x[rows].astype(np.float64) @ beta, -30.0,
                                30.0))
        out["closed_form_rel_err"] = float(np.max(np.abs(got_risk - expect)
                                                  / expect))
        log(f"  {what}: risk against exp(clip(x @ beta, -30, 30)) rel err "
            f"{out['closed_form_rel_err']:.3e} (tol {DEEP_RISK_RTOL:.0e})")
        check(out["closed_form_rel_err"] <= DEEP_RISK_RTOL,
              f"{what}: served risks differ from exp(clip(x @ beta))")
    return out


def _closed_loop(svc, feats, seconds: float) -> dict:
    """SERVE_THREADS submitters, each keeping ``max_batch`` requests in
    flight (a new one as its oldest is answered) for ``seconds``: the
    service saturated by a fixed population. Returns its rate, its
    batches and latencies, all responses ``ok``."""
    import collections

    import numpy as np

    lats = [[] for _ in range(SERVE_THREADS)]

    def run(slot):
        rng = np.random.default_rng(SEED + 40 + slot)
        window = collections.deque()
        end = time.perf_counter() + seconds
        while time.perf_counter() < end or window:
            if len(window) < svc.max_batch and time.perf_counter() < end:
                window.append(svc.submit(feats[rng.integers(0, len(feats))]))
                continue
            resp = svc.wait(window.popleft(), timeout=120.0)
            check(resp.ok, f"closed loop: error response {resp.error}")
            lats[slot].append(resp.latency_s)

    batches = svc.stats()["n_batches"]
    elapsed = _in_threads(run, seconds + 120.0)
    batches = svc.stats()["n_batches"] - batches
    lat = [v for slot in lats for v in slot]
    return {"served": len(lat), "seconds": elapsed,
            "reqs_per_s": len(lat) / elapsed, "batches": batches,
            "mean_batch": len(lat) / max(batches, 1),
            "ms_per_batch": elapsed / max(batches, 1) * 1e3,
            "p50_ms": _percentile_ms(lat, 50),
            "p99_ms": _percentile_ms(lat, 99)}


def _open_loop(svc, feats, rps: float, seconds: float, seed: int,
               deadline_low, mid_run=None) -> dict:
    """``benchmarks/bench_overload.py``'s open loop: seeded Poisson arrivals
    at ``rps`` on their own clock (a backlogged schedule submits at once),
    SERVE_HIGH of them HIGH, LOW ones with ``deadline_low``; ``mid_run``
    fires once past half the run on a thread of its own. Returns every
    outcome (``ok`` as (priority, arrival offset, row, submit time,
    response)); a submitted rid with no response is silent loss."""
    import threading

    import numpy as np

    from repro_torch.serving import Priority, QueueFull

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rps,
                                         size=max(int(rps * seconds * 2), 16)))
    arrivals = arrivals[arrivals < seconds]
    rng = np.random.default_rng(seed + 1)
    prios = rng.random(len(arrivals)) < SERVE_HIGH
    rows = rng.integers(0, len(feats), len(arrivals))
    submitted, rejected = [], 0
    t_mid = mid_thread = None
    svc.start()
    t0 = time.perf_counter()
    for t_arr, high, i in zip(arrivals, prios, rows):
        if mid_run is not None and t_mid is None and t_arr >= seconds / 2:
            t_mid = time.perf_counter() - t0
            mid_thread = threading.Thread(target=mid_run, daemon=True)
            mid_thread.start()
        delay = t_arr - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        prio = Priority.HIGH if high else Priority.LOW
        try:
            t_abs = time.perf_counter()
            rid = svc.submit(feats[i], priority=prio, deadline_s=(
                None if high else deadline_low))
            submitted.append((rid, prio, float(t_arr), int(i), t_abs))
        except QueueFull:
            rejected += 1
    t_offered = time.perf_counter() - t0
    if mid_thread is not None:
        mid_thread.join(120.0)
        check(not mid_thread.is_alive(), "the mid-run call did not end")
    end = time.perf_counter() + 60.0
    while svc.stats()["queue_depth"] and time.perf_counter() < end:
        time.sleep(0.005)
    svc.stop()
    svc.drain()
    out = {"offered": len(arrivals), "offered_rps": len(arrivals) / t_offered,
           "rejected": rejected, "shed": 0, "expired": 0, "errors": [],
           "lost": 0, "t_mid": t_mid, "ok": []}
    for rid, prio, t_arr, i, t_abs in submitted:
        resp = svc.result(rid)
        if resp is None:
            out["lost"] += 1
        elif resp.ok:
            out["ok"].append((prio, t_arr, i, t_abs, resp))
        elif resp.error == "shed":
            out["shed"] += 1
        elif resp.error == "deadline_exceeded":
            out["expired"] += 1
        else:
            out["errors"].append(resp.error)
    out["shed_frac"] = ((out["rejected"] + out["shed"] + out["expired"])
                        / max(out["offered"], 1))
    out["p99_high_ms"] = _percentile_ms(
        [r.latency_s for p, _, _, _, r in out["ok"] if p == Priority.HIGH],
        99)
    return out


SERVICE_SPANS = ("service.step", "service.batch_form", "service.dispatch",
                 "engine.score", "service.respond")


def serving_phase(model, strat_model, x, t, delta) -> dict:
    """Phase 11: the service front end at full width on the phase-4 and
    phase-5b artifacts; returns its numbers and its two paths' launches."""
    import os

    import numpy as np

    from perfbench import harness
    from repro_torch.kernels import ops
    from repro_torch.obs import profile, trace
    from repro_torch.serving import (ArtifactCorrupt, ChaosEngine,
                                     ModelRegistry, RiskService,
                                     corrupt_artifact, fit_survival_model)
    from repro_torch.serving.registry import FAILED, READY

    log("phase 11: the serving front end")
    work = ROOT / "build" / "chip_smoke" / "serve"
    work.mkdir(parents=True, exist_ok=True)
    feats = x[np.random.default_rng(SEED + 30).integers(0, x.shape[0],
                                                        SERVE_REQUESTS)]
    model2 = fit_survival_model(x, t, delta, (model.beta * 0.95).astype(
        np.float32), time_grid=model.time_grid)
    out = {}

    ops.reset_launch_counts()
    # 1. registry from disk: sha256-verified load, the ladder warmed on the
    # registry's thread, then swapped live
    svc = RiskService(None, return_curves=True)
    reg = ModelRegistry(svc)
    path = model.save(str(work / "champ"))
    reg.load("champ", path, block=False)
    entry = reg.wait_ready("champ", timeout=300.0)
    engine = entry.engine
    ladder = len(reg.prewarm_batches)
    check(entry.state == READY and entry.compiles == ladder
          and engine.calls == ladder,
          f"registry load: state {entry.state}, {entry.compiles} builds "
          f"and {engine.calls} calls for a ladder of {ladder}")
    check(reg.swap("champ") == 1, "the first swap is generation 1")
    log(f"  registry: 'champ' loaded from disk (sha256 verified), warmed "
        f"buckets {reg.prewarm_batches} with the curve kind, swapped live; "
        f"max_batch {svc.max_batch}, retries {svc.retries}, down_after "
        f"{svc.down_after}")

    # 2-3. correctness under load, with exact launch counts
    svc.start()
    reqs = _submit_rows(svc, x, SERVE_REQUESTS, SEED + 20)
    resps = _await_served("1 stratum", svc, reqs)
    st = svc.stats()
    launched = ops.launch_counts()
    # the warmed buckets and the service's batches
    calls = ladder + st["n_batches"]
    _check_counts("correctness run", launched, {"survival_curves": calls})
    check(engine.calls == calls, f"engine calls {engine.calls}")
    # the direct calls that check the answers launch kernels too: taken
    # out of the path's count below
    resps_ok = _check_served("1 stratum", svc, engine, x, reqs, resps)
    check_calls = resps_ok["direct_calls"]
    log(f"  {st['n_requests']} requests in {st['n_batches']} batches "
        f"(mean {st['mean_batch']:.2f}), p50 {st['latency_p50_ms']:.3f} ms, "
        f"p99 {st['latency_p99_ms']:.3f} ms")
    svc.stop()

    # 4. capacity and overload, each on a service of its own
    cap_svc = RiskService(engine, return_curves=True)
    cap_svc.start()
    cap = _closed_loop(cap_svc, feats, SERVE_SECONDS)
    cap_svc.stop()
    rps = cap["reqs_per_s"]
    log(f"  closed loop, {SERVE_THREADS} submitters x {cap_svc.max_batch} in "
        f"flight: {rps:.1f} req/s, mean batch {cap['mean_batch']:.2f}, "
        f"{cap['ms_per_batch']:.4f} ms a scored batch through the service, "
        f"p50 {cap['p50_ms']:.3f} ms, p99 {cap['p99_ms']:.3f} ms")
    out["capacity"] = cap
    out["load"] = {}
    for mult in SERVE_LOADS:
        load_svc = RiskService(engine, return_curves=True,
                               max_queue=8 * cap_svc.max_batch)
        res = _open_loop(load_svc, feats, mult * rps, SERVE_SECONDS,
                         SEED + int(mult * 10), SERVE_LOW_DEADLINE)
        silent = res["lost"]
        log(f"  open loop at {mult:g}x: offered {res['offered']} "
            f"({res['offered_rps']:.1f} req/s), ok {len(res['ok'])}, "
            f"rejected {res['rejected']}, evicted {res['shed']}, expired "
            f"{res['expired']}; shed fraction {res['shed_frac']:.4f}, p99 "
            f"HIGH {res['p99_high_ms']:.3f} ms, silent loss {silent}")
        check(silent == 0, f"{mult:g}x: {silent} requests silently lost")
        check(not res["errors"], f"{mult:g}x: error responses "
              f"{res['errors'][:3]}")
        out["load"][f"{mult:g}x"] = {
            k: res[k] for k in ("offered", "offered_rps", "rejected", "shed",
                                "expired", "shed_frac", "p99_high_ms")}
        out["load"][f"{mult:g}x"]["silent_loss"] = silent

    # 5. hot swap under load: a refit model rolled out halfway through
    swaps0 = svc.stats()["engine_swaps"]
    swapped = {}

    def rollout():
        swapped["gen"] = reg.rollout("retrain", model2)
        swapped["t"] = time.perf_counter()

    res = _open_loop(svc, feats, SERVE_SWAP_LOAD * rps, SERVE_SECONDS,
                     SEED + 5, None, mid_run=rollout)
    dropped = (res["lost"] + len(res["errors"]) + res["shed"]
               + res["expired"] + res["rejected"])
    swaps = svc.stats()["engine_swaps"] - swaps0
    engine2 = reg.engine()
    t_sub = np.asarray([t_arr for _, t_arr, _, _, _ in res["ok"]])
    lat = np.asarray([r.latency_s for _, _, _, _, r in res["ok"]])
    win = (t_sub >= res["t_mid"] - 0.1) & (t_sub <= res["t_mid"] + 0.4)
    swap = {"dropped": dropped, "generation": swapped.get("gen"),
            "engine_swaps": swaps, "served": len(res["ok"]),
            "window_requests": int(win.sum()),
            "p99_window_ms": _percentile_ms(lat[win], 99),
            "p99_steady_ms": _percentile_ms(lat[~win], 99)}
    check(dropped == 0, f"hot swap dropped {dropped} requests")
    check(swapped.get("gen") == 2 and reg.generation == 2 and swaps == 1
          and svc.engine is engine2,
          f"hot swap: generation {swapped.get('gen')}, swaps {swaps}")
    # requests submitted after the rollout returned score on the new model
    late = [(i, r) for _, _, i, t_abs, r in res["ok"]
            if t_abs > swapped["t"]][-64:]
    check(len(late) > 0, "no request was submitted after the swap")
    rows = np.asarray([i for i, _ in late])
    got = np.asarray([r.risk for _, r in late])
    want2 = engine2.score(feats[rows], with_curves=True)[0]
    want1 = engine.score(feats[rows], with_curves=True)[0]
    swap["new_model_risk_rel_err"] = float(np.max(np.abs(got - want2)
                                                  / want2))
    swap["old_model_risk_rel_diff"] = float(np.max(np.abs(got - want1)
                                                   / want1))
    log(f"  hot swap at {SERVE_SWAP_LOAD:g}x: generation {swap['generation']},"
        f" {swap['served']} served, dropped {dropped}, engine swaps +{swaps};"
        f" p99 of the {swap['window_requests']} requests submitted in the "
        f"swap window {swap['p99_window_ms']:.3f} ms against "
        f"{swap['p99_steady_ms']:.3f} ms steady; {len(late)} requests after "
        f"the swap against the new model: risk rel err "
        f"{swap['new_model_risk_rel_err']:.3e} (the old model's differ by "
        f"{swap['old_model_risk_rel_diff']:.3e})")
    check(swap["new_model_risk_rel_err"] <= SERVE_RISK_RTOL
          and swap["old_model_risk_rel_diff"] > 1e3 * SERVE_RISK_RTOL,
          "requests after the swap did not score on the new model")
    out["swap"] = swap
    check(svc.stats()["error_count"] == 0 and svc.health() == "SERVING",
          "error responses or health off SERVING before the chaos step")

    # 6. chaos: the live engine behind a fault injector, the service stepped
    # by hand so that each batch is exactly the requests just submitted
    chaos = ChaosEngine(engine2, seed=SEED)
    svc.set_engine(chaos)
    base = svc.stats()
    rng = np.random.default_rng(SEED + 50)

    def one_batch():
        rids = [svc.submit(feats[i])
                for i in rng.integers(0, len(feats), CHAOS_BATCH)]
        served = svc.step()
        return served, [svc.result(rid) for rid in rids]

    def moved(key):
        return svc.stats()[key] - base[key]

    chaos.fail_next(2)
    served, resps = one_batch()
    check(served == CHAOS_BATCH and all(r.ok for r in resps)
          and moved("retry_count") == 2 and moved("engine_failures") == 0
          and svc.health() == "SERVING" and chaos.faults_injected == 2,
          f"fail_next(2): served {served}, retries {moved('retry_count')}, "
          f"health {svc.health()}")
    chaos.fail_next(svc.retries + 1)
    served, resps = one_batch()
    check(served == 0 and all(r is not None and not r.ok
                              and "EngineFault" in r.error for r in resps)
          and moved("error_count") == CHAOS_BATCH
          and moved("engine_failures") == 1 and svc.health() == "DEGRADED",
          f"fail_next({svc.retries + 1}): served {served}, errors "
          f"{moved('error_count')}, health {svc.health()}")
    served, resps = one_batch()
    check(served == CHAOS_BATCH and all(r.ok for r in resps)
          and svc.health() == "SERVING",
          f"after the failed batch: served {served}, health {svc.health()}")
    bad = model2.save(str(work / "corrupt"))
    corrupt_artifact(bad, "beta", mode="flip", seed=SEED)
    try:
        reg.load("corrupt", bad)
        corrupt_error = None
    except ArtifactCorrupt as e:
        corrupt_error = str(e)
    entry = reg.get("corrupt")
    check(corrupt_error is not None and entry.state == FAILED
          and "ArtifactCorrupt" in entry.error
          and reg.status()["live"] == "retrain" and svc.engine is chaos,
          f"corrupt artifact: state {entry.state}, error {entry.error}")
    served, resps = one_batch()
    check(served == CHAOS_BATCH and all(r.ok for r in resps),
          "the live engine stopped serving after a corrupt load")
    reg.unload("corrupt")
    out["chaos"] = {"retries": moved("retry_count"),
                    "error_responses": moved("error_count"),
                    "engine_failures": moved("engine_failures"),
                    "faults_injected": chaos.faults_injected,
                    "corrupt_load": corrupt_error}
    log(f"  chaos: fail_next(2) recovered by 2 retries; fail_next("
        f"{svc.retries + 1}) gave the batch's {CHAOS_BATCH} requests error "
        f"responses, DEGRADED, then SERVING after the next batch; a flipped "
        f"byte of beta.npy: {corrupt_error}; the live engine kept serving")

    # 7. the device's idle share over a profiled window of closed-loop
    # serving
    prof_dir = ROOT / "build" / "chip_smoke" / "profile"
    before = os.environ.get(profile.ENV_VAR)
    os.environ[profile.ENV_VAR] = str(prof_dir)
    try:
        svc.start()
        with profile.maybe_profile("serve"):
            loop = _closed_loop(svc, feats, SERVE_PROFILE_SECONDS)
        svc.stop()
    finally:
        if before is None:
            del os.environ[profile.ENV_VAR]
        else:
            os.environ[profile.ENV_VAR] = before
    chrome = prof_dir / "serve" / profile.TRACE_FILE
    check(chrome.is_file(), f"no profiler trace at {chrome}")
    dev, _ = harness.read_chrome_trace(str(chrome))
    check(bool(dev), f"{chrome}: no device activity in the trace")
    out["idle_share"] = 1.0 - harness.busy_us(dev) / 1e6 / loop["seconds"]
    out["profiled"] = loop
    log(f"  profiled {loop['seconds']:.3f} s of closed-loop serving "
        f"({loop['reqs_per_s']:.1f} req/s) into {chrome.relative_to(ROOT)}: "
        f"device idle {out['idle_share']:.1%}")

    # where the drain thread's time goes: the service's spans over a
    # window of closed-loop serving with tracing on
    spans_path = work / "spans.jsonl"
    trace.configure(str(spans_path))
    try:
        svc.start()
        loop = _closed_loop(svc, feats, SERVE_PROFILE_SECONDS)
        svc.stop()
    finally:
        trace.configure(None)
    spans = harness.read_spans(str(spans_path))
    steps = sum(r["name"] == "service.step" for r in spans)
    check(steps > 0, f"{spans_path}: no service.step span")
    total = {name: sum(r["dur_s"] for r in spans if r["name"] == name)
             for name in SERVICE_SPANS}
    out["spans"] = {"batches": steps,
                    "ms_per_batch": {k: v / steps * 1e3
                                     for k, v in total.items()},
                    "step_share": total["service.step"] / loop["seconds"]}
    log(f"  traced {loop['seconds']:.3f} s of closed-loop serving "
        f"({loop['reqs_per_s']:.1f} req/s, {loop['batches']} batches): ms a "
        f"batch " + ", ".join(f"{k} {v:.4f}" for k, v in
                              out["spans"]["ms_per_batch"].items())
        + f"; the drain thread inside service.step "
        f"{out['spans']['step_share']:.1%} of the window")

    st = svc.stats()
    statuses = {m: e["state"] for m, e in reg.status()["models"].items()}
    check(st["health"] == "SERVING" and st["error_count"]
          - base["error_count"] == CHAOS_BATCH and FAILED not in
          statuses.values(), f"after the phase: health {st['health']}, "
          f"models {statuses}")
    serve = ops.launch_counts()
    _check_counts("serve path and its check", serve, {
        "survival_curves": engine.calls + engine2.calls})
    serve["survival_curves"] -= check_calls

    # 2-3 again on the 8-strata artifact, through survival_curves_stratified
    ops.reset_launch_counts()
    ssvc = RiskService(None, return_curves=True)
    sreg = ModelRegistry(ssvc)
    sreg.load("strata", strat_model.save(str(work / "strata")), block=False)
    sentry = sreg.wait_ready("strata", timeout=300.0)
    check(sentry.state == READY and sentry.compiles == ladder,
          f"stratified registry load: {sentry.state}, {sentry.compiles}")
    sreg.swap("strata")
    ssvc.start()
    sreqs = _submit_rows(ssvc, x, SERVE_REQUESTS, SEED + 60,
                         strata=strat_model.n_strata)
    sresps = _await_served(f"{strat_model.n_strata} strata", ssvc, sreqs)
    ssvc.stop()
    sst = ssvc.stats()
    check(sst["health"] == "SERVING" and sst["error_count"] == 0,
          "stratified service health")
    serve_strat = ops.launch_counts()
    _check_counts("stratified serve path", serve_strat, {
        "survival_curves_stratified": ladder + sst["n_batches"]})
    strat_ok = _check_served(f"{strat_model.n_strata} strata", ssvc,
                             sentry.engine, x, sreqs, sresps)
    out["correct"] = {"1 stratum": resps_ok,
                      f"{strat_model.n_strata} strata": strat_ok}
    out["launches"] = {"serve": serve, "serve_stratified": serve_strat}
    return out


# ---------------------------------------------------------------------------
# Phase 12: the deep-survival serving path
# ---------------------------------------------------------------------------

def _profile_once(fn) -> tuple:
    """(fn(), its reading) for one call of ``fn`` under torch.profiler: wall
    and device-busy ms, the idle share, the device kernels launched, the
    matmul kernels' ms and the five kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda kv: -kv[1])[:5]
    return out, {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
                 "kernels": sum(c for _, _, c in kernels),
                 "gemm_ms": sum(ms for k, ms, _ in kernels
                                if any(w in k.lower() for w in GEMM_KERNELS)),
                 "top_kernels_ms": [[k[:60], ms] for k, ms, _ in top]}


def _profiled_batch(fn, host: bool = False) -> dict:
    """``_profile_once``'s reading of one call of ``fn`` after a warm-up
    call; with ``host``, also the host's operators with the most self time
    over a further call profiled on the host alone (the profiler's own
    cost included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a window with no device activity at all is profiled once more, as in
    # device_ms; a second empty one fails
    for _ in range(2):
        _, out = _profile_once(fn)
        if out["busy_ms"] > 0:
            break
        log("  torch.profiler recorded no device activity; profiling again")
    check(out["busy_ms"] > 0, "torch.profiler recorded no device activity")
    if host:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                      for e in prof.key_averages()),
                     key=lambda kv: -kv[1])[:8]
        out["host_top_ms"] = [[k[:50], ms, c] for k, ms, c in ops]
    return out


GEMM_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
                "w_out")
# name fragments of cuBLAS's matmul kernels on Hopper (a profiled window's
# "gemm_ms" sums their device time)
GEMM_KERNELS = ("gemm", "nvjet", "cutlass")


def _gemm_flops(model, batches: int) -> float:
    """2 x tokens x the layers' matmul weights (attention's q/k/v/o, the
    MLP's, mamba's in and out projections) over ``batches`` batches: the
    weight GEMMs of the forward, without attention's scores, the SSD's
    einsums and the embedding gather."""
    weights = sum(p.numel() for name, p in model.layers.named_parameters()
                  if name.rsplit(".", 1)[-1] in GEMM_WEIGHTS)
    return 2.0 * batches * DEEP_BATCH * DEEP_SEQ * weights


def _backbone(dcfg):
    """The deep-survival backbone of ``dcfg`` at full width with its Cox
    head, drawn on the card from generators seeded SEED."""
    from repro_torch.models import build_model
    from repro_torch.survival import deep

    return deep.init_state(build_model(deep.model_config(dcfg),
                                       device="cuda"), SEED).model


def _float32_twin(model):
    """``model``'s weights and Cox head in float32, in a model built on
    the card without drawing any."""
    import copy

    from repro_torch.models import build_model

    twin = build_model(model.cfg.scaled(dtype="float32"), device="cuda")
    twin.cox_head = copy.deepcopy(model.cox_head)
    twin.load_state_dict({k: v.float() for k, v in
                          model.state_dict().items()})
    return twin


def _against_float32(model, stream, start: int, n_batches: int) -> dict:
    """Pooled features and risks of ``model`` (bfloat16) against its
    float32 twin over ``n_batches`` batches from ``start``: the relative
    errors and both forwards' seconds."""
    import numpy as np
    import torch

    from repro_torch.survival import deep

    twin = _float32_twin(model)
    runs = []
    for m in (model, twin):
        _timed(lambda: deep.collect_features(m, stream, start, 1))
        runs.append(_timed(lambda: deep.collect_features(
            m, stream, start, n_batches)))
    (got, seconds), (want, seconds32) = runs
    del twin
    torch.cuda.empty_cache()
    f, f32 = got["features"], want["features"]
    check(f.shape == (n_batches * stream.batch, model.cfg.d_model)
          and bool(np.all(np.isfinite(f))), f"{model.cfg.name}: features")
    return {"seconds": seconds, "seconds_float32": seconds32,
            "features_rel_err": float(np.linalg.norm(f - f32)
                                      / np.linalg.norm(f32)),
            "features_max_rel_err": float(np.max(np.abs(f - f32))
                                          / np.max(np.abs(f32))),
            "risk_max_rel_err": float(
                np.max(np.abs(got["risk_deep"] - want["risk_deep"]))
                / np.max(np.abs(want["risk_deep"])))}


def dense_backbone() -> dict:
    """qwen2.5-3b at full width (12 layers, vocab 2,048): the bfloat16
    forward against a float32 forward of the same weights, on the card."""
    import torch

    from repro_torch.analysis import roofline as rl
    from repro_torch.data.pipeline import SurvivalTextStream
    from repro_torch.survival import deep

    dcfg = deep.DeepSurvivalConfig(arch=DENSE_ARCH, full=True,
                                   seq=DEEP_SEQ, batch=DEEP_BATCH)
    model = _backbone(dcfg)
    cfg = model.cfg
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.qkv_bias, cfg.rope_theta, cfg.tie_embeddings,
           cfg.n_layers, cfg.vocab_size, cfg.dtype)
          == (2048, 16, 2, 128, 11008, True, 1e6, True, 12, 2048,
              "bfloat16"), f"{DENSE_ARCH} config: {cfg}")
    n_params = sum(p.numel() for p in model.parameters())
    stream = SurvivalTextStream(cfg.vocab_size, dcfg.seq, dcfg.batch,
                                seed=dcfg.seed)
    cmp = _against_float32(model, stream, dcfg.steps, DENSE_BATCHES)
    seconds, seconds32 = cmp["seconds"], cmp["seconds_float32"]
    err = cmp["features_rel_err"]
    tokens = DEEP_BATCH * DEEP_SEQ
    flops = _gemm_flops(model, DENSE_BATCHES)
    out = {"arch": cfg.name, "params": n_params,
           "s_per_batch": seconds / DENSE_BATCHES,
           "s_per_batch_float32": seconds32 / DENSE_BATCHES,
           "tokens_per_s": tokens * DENSE_BATCHES / seconds,
           "gemm_tflop_per_batch": flops / DENSE_BATCHES / 1e12,
           "gemm_tflops": flops / seconds / 1e12,
           "gemm_tflops_float32": flops / seconds32 / 1e12,
           **{k: cmp[k] for k in ("features_rel_err", "features_max_rel_err",
                                  "risk_max_rel_err")}}
    log(f"  {cfg.name} at full width ({n_params / 1e6:.1f}M parameters, "
        f"{cfg.n_layers} layers, bfloat16): {out['s_per_batch']:.4f} s a "
        f"featurized batch of {DEEP_BATCH} x {DEEP_SEQ} "
        f"({out['tokens_per_s']:.0f} "
        f"tokens/s; weight GEMMs {out['gemm_tflop_per_batch']:.2f} TFLOP a "
        f"batch, {out['gemm_tflops']:.1f} TFLOP/s = "
        f"{out['gemm_tflops'] * 1e12 / rl.BF16_OPS_PER_S:.1%} of the bfloat16 "
        f"peak), float32 {out['s_per_batch_float32']:.4f} s "
        f"({out['gemm_tflops_float32']:.1f} TFLOP/s = "
        f"{out['gemm_tflops_float32'] * 1e12 / rl.FP32_OPS_PER_S:.1%} of the "
        f"float32 peak); pooled "
        f"features against the float32 forward: ||diff|| / ||f32|| "
        f"{err:.3e} (tol {DENSE_BF16_RTOL:.0e}), max |diff| / max |f32| "
        f"{out['features_max_rel_err']:.3e}, risk "
        f"{out['risk_max_rel_err']:.3e}")
    check(err <= DENSE_BF16_RTOL, f"{DENSE_ARCH}: bfloat16 features differ "
          f"from float32 by {err:.3e}")
    del model
    torch.cuda.empty_cache()
    return out


def deep_phase() -> dict:
    """Phase 12: featurize on mamba2-130m at full width (held against its
    float32 twin), refit k-sparse (held against the plain route), export,
    serve through ModelRegistry/RiskService with exact launch counts; then
    the dense backbone. Returns its numbers and launches."""
    import numpy as np
    import torch

    from repro_torch.core import beam, cox
    from repro_torch.data.pipeline import SurvivalTextStream
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    from repro_torch.serving import ModelRegistry, RiskService
    from repro_torch.survival import deep, metrics

    log("phase 12: the deep-survival serving path")
    dcfg = deep.DeepSurvivalConfig(full=True, seq=DEEP_SEQ,
                                   batch=DEEP_BATCH)
    model = _backbone(dcfg)
    cfg = model.cfg
    check((cfg.name, cfg.d_model, cfg.ssm_expand, cfg.ssm_state,
           cfg.ssm_head_dim, cfg.ssm_chunk, cfg.n_layers, cfg.vocab_size,
           cfg.dtype) == ("mamba2-130m", 768, 2, 128, 64, 128, 12, 2048,
                          "bfloat16"), f"backbone config: {cfg}")
    stream = SurvivalTextStream(cfg.vocab_size, dcfg.seq, dcfg.batch,
                                seed=dcfg.seed)
    start, n_feat = dcfg.steps, DEEP_BATCHES * dcfg.batch
    # the shapes this path gives its kernels are those phase 2 checked
    check((n_feat, cfg.d_model, dcfg.k, dcfg.grid_size)
          == (DEEP_N, DEEP_D, DEEP_K, DEEP_GRID),
          "phase 12's shapes are not those phase 2 checked")
    work = ROOT / "build" / "chip_smoke" / "deep"
    work.mkdir(parents=True, exist_ok=True)
    out = {"arch": cfg.name,
           "params": sum(p.numel() for p in model.parameters())}
    _timed(lambda: deep.collect_features(model, stream, start, 1))
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    held, seconds = _timed(lambda: deep.collect_features(
        model, stream, start, DEEP_BATCHES))
    out["featurize"] = {
        "sequences": n_feat, "s_per_batch": seconds / DEEP_BATCHES,
        "tokens_per_s": n_feat * DEEP_SEQ / seconds,
        "gemm_tflops": _gemm_flops(model, DEEP_BATCHES) / seconds / 1e12,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    feats = held["features"]
    check(feats.shape == (n_feat, cfg.d_model) and feats.dtype == np.float32
          and bool(np.all(np.isfinite(feats)))
          and bool(np.all(np.isfinite(held["risk_deep"]))),
          "featurized features")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        spans = Path(tmp) / "trace.jsonl"
        trace.configure(str(spans))
        try:
            refit, refit_s = _timed(lambda: deep.refit_and_export(
                feats, held["time"], held["event"], k=dcfg.k,
                beam_width=dcfg.beam_width, grid_size=dcfg.grid_size))
            res, beta, art = refit
        finally:
            trace.configure(None)
        size_s, candidates, scored = _beam_spans(spans)
    serve_step = start + DEEP_BATCHES
    fresh = deep.collect_features(model, stream, serve_step,
                                  DEEP_SERVE_BATCHES)
    f_new = fresh["features"]
    path = art.save(str(work / "deep_v1"))
    svc = RiskService(None, return_curves=True)
    reg = ModelRegistry(svc)
    check(reg.rollout("deep_v1", path) == 1, "the rollout is generation 1")
    check(tuple(reg.prewarm_batches) == DEEP_CURVE_BS,
          f"the served buckets {reg.prewarm_batches} are not those phase 2 "
          f"checked")
    engine = reg.engine()
    svc.start()
    reqs = _submit_rows(svc, f_new, len(f_new), SEED + 70)
    resps = _await_served("deep artifact", svc, reqs)
    svc.stop()
    launched = ops.launch_counts()
    path_calls = engine.calls

    nnz = int((np.abs(beta) > 1e-8).sum())
    blocks = beam.column_blocks(n_feat, cfg.d_model, feats.itemsize)
    out["refit"] = {"k": dcfg.k, "beam_width": dcfg.beam_width,
                    "seconds": refit_s, "size_s": size_s,
                    "candidates": candidates, "beams_scored": scored,
                    "column_blocks": [b.stop - b.start for b in blocks],
                    "nnz": nnz, "support": res.supports[-1].tolist(),
                    "losses": res.losses}
    log(f"  featurized {n_feat} sequences ({n_feat * DEEP_SEQ} tokens) on "
        f"{cfg.name} at full width ({out['params'] / 1e6:.1f}M parameters,"
        f" {cfg.n_layers} layers, bfloat16): "
        f"{out['featurize']['s_per_batch']:.4f} s a "
        f"batch of {DEEP_BATCH} x {DEEP_SEQ}, "
        f"{out['featurize']['tokens_per_s']:.0f} tokens/s (weight GEMMs at "
        f"{out['featurize']['gemm_tflops']:.1f} TFLOP/s), peak "
        f"{out['featurize']['peak_gb']:.2f} GB")
    log(f"  refit on the ({n_feat}, {cfg.d_model}) panel, k {dcfg.k}, beam "
        f"width {dcfg.beam_width} ({len(blocks)} column block(s) of "
        f"{out['refit']['column_blocks']}): {refit_s:.2f} s with the "
        f"artifact; seconds per support size "
        + ", ".join(f"{v:.3f}" for v in size_s)
        + f"; candidates {candidates}; support {res.supports[-1].tolist()},"
        f" {nnz} nonzeros, losses {res.losses[0]:.4f} -> "
        f"{res.losses[-1]:.4f}")
    check(len(size_s) == dcfg.k and nnz <= dcfg.k and art.is_sparse
          and art.k == nnz and art.p == cfg.d_model
          and art.n_grid == dcfg.grid_size
          and bool(np.all(np.isfinite(res.losses)))
          and bool(np.all(np.diff(res.losses)
                          <= MONO_RTOL * np.abs(res.losses[:-1])))
          and bool(np.all(np.diff(art.base_cumhaz, axis=1) >= -1e-6)),
          "the refit or its artifact")

    st = svc.stats()
    log(f"  served {len(reqs)} requests of pooled features from "
        f"{DEEP_SERVE_BATCHES} further batches through ModelRegistry and "
        f"RiskService in {st['n_batches']} batches (p50 "
        f"{st['latency_p50_ms']:.3f} ms, p99 {st['latency_p99_ms']:.3f} "
        f"ms)")
    # sparse_refit runs beam_search with its defaults, as the reference's
    defaults = inspect.signature(beam.beam_search).parameters
    sweeps = defaults["finetune_sweeps"].default
    steps = defaults["score_steps"].default
    _check_counts("deep-survival path", launched, {
        "cox_coord": sweeps * sum(size * c for size, c in
                                  enumerate(candidates, 1)),
        "lipschitz": 1,
        "revcumsum": sum(scored) * (2 * steps + 1) * len(blocks),
        "survival_curves": path_calls,
        # one a Mamba2 layer of every featurized batch
        "ssd_scan": (DEEP_BATCHES + DEEP_SERVE_BATCHES) * cfg.n_layers})
    check(path_calls == len(reg.prewarm_batches) + st["n_batches"],
          f"engine calls {path_calls}: not the warmed buckets and the "
          f"service's batches")
    out["launches"] = launched

    # the checks below launch kernels of their own, after the path's
    # counts were read
    served = _check_served("deep artifact", svc, engine, f_new, reqs,
                           resps, beta=beta)
    out["serve"] = {"requests": len(reqs), "batches": st["n_batches"],
                    "p50_ms": st["latency_p50_ms"],
                    "p99_ms": st["latency_p99_ms"], **served}
    compare_selection(cox.prepare(feats, held["time"], held["event"]),
                      "deep refit", DEEP_COMPARE)
    twin = _against_float32(model, stream, serve_step, DEEP_TWIN_BATCHES)
    out["float32_twin"] = twin
    log(f"  {cfg.name}'s pooled features on {DEEP_TWIN_BATCHES} batches "
        f"against its float32 twin (the same weights): ||diff|| / ||f32|| "
        f"{twin['features_rel_err']:.3e} (tol {SSM_BF16_RTOL:.0e}), max "
        f"|diff| / max |f32| {twin['features_max_rel_err']:.3e}, risk "
        f"{twin['risk_max_rel_err']:.3e}; float32 "
        f"{twin['seconds_float32'] / DEEP_TWIN_BATCHES:.4f} s a batch")
    check(twin["features_rel_err"] <= SSM_BF16_RTOL,
          f"{cfg.name}: bfloat16 features differ from float32 by "
          f"{twin['features_rel_err']:.3e}")

    out["cindex_deep"] = metrics.cindex(fresh["time"], fresh["event"],
                                        fresh["risk_deep"])
    out["cindex_sparse"] = metrics.cindex(fresh["time"], fresh["event"],
                                          f_new @ beta)
    log(f"  held-out c-index on the {len(f_new)} served sequences (an "
        f"untrained backbone, reported, not gated): deep head "
        f"{out['cindex_deep']:.4f}, sparse refit "
        f"{out['cindex_sparse']:.4f}")
    out["profiled_batch"] = _profiled_batch(lambda: deep.collect_features(
        model, stream, serve_step, 1))
    log(f"  one featurized batch profiled: wall "
        f"{out['profiled_batch']['wall_ms']:.2f} ms, device busy "
        f"{out['profiled_batch']['busy_ms']:.2f} ms -> idle "
        f"{out['profiled_batch']['idle']:.1%}; top kernels "
        f"{out['profiled_batch']['top_kernels_ms']}")
    del model
    torch.cuda.empty_cache()
    out["dense"] = dense_backbone()
    return out


# ---------------------------------------------------------------------------
# Phase 13: training on the card
# ---------------------------------------------------------------------------

def _max_rel(got: dict, want: dict, atol: dict) -> tuple:
    """(worst max |got - want| / max |want| over the keys, its key); a key
    of ``atol`` within its absolute tolerance counts as 0."""
    worst, at = -1.0, None
    for k, w in want.items():
        g = got[k].detach().double().cpu()
        w = w.detach().double().cpu()
        err = float((g - w).abs().max())
        rel = 0.0 if err <= atol.get(k, -1.0) \
            else err / max(float(w.abs().max()), 1e-30)
        if rel > worst:
            worst, at = rel, k
    return worst, at


def _step_timer(times: list):
    """An ``on_step`` callback that appends each step's seconds (the loss
    is read on the host before it fires, so the card has finished)."""
    last = [time.perf_counter()]

    def on_step(step, metrics):
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    return on_step


def _twin(cfg, objective: str, seed: int, device: str):
    """The float32 twin: ``cfg`` at TWIN_LAYERS layers in float32, its
    weights (and Cox head for ``cox``) drawn on the CPU from ``seed`` and
    copied to ``device``."""
    from repro_torch.models.model import Model
    from repro_torch.survival import deep

    tcfg = cfg.scaled(n_layers=TWIN_LAYERS, dtype="float32")
    cpu = deep.init_state(Model(tcfg, device="cpu"), seed)
    if device == "cpu":
        return cpu
    st = deep.init_state(Model(tcfg, device=device), seed)
    st.model.load_state_dict({k: v.to(device) for k, v in
                              cpu.model.state_dict().items()})
    return st


def _grads_on(state, objective: str, batch):
    """(loss, {name: grad}) of ``objective`` at ``state``'s model."""
    from repro_torch.data.pipeline import put_batch
    from repro_torch.train import trainer

    model = state.model
    loss, _ = trainer.make_loss_fn(model, objective)(
        put_batch(batch, model.device))
    return loss.detach(), trainer._grads(loss, dict(model.named_parameters()))


def _train_checks(cfg) -> dict:
    """Gradients on the card against the CPU and microbatch 4 against the
    full batch, on the float32 twin of ``cfg`` (TF32 is off)."""
    import copy

    import torch

    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import SurvivalTextStream, TokenTaskStream
    from repro_torch.train import trainer

    out = {}
    streams = {"cox": SurvivalTextStream(cfg.vocab_size, 48, 32, seed=3),
               "lm": TokenTaskStream(cfg.vocab_size, 48, 32, seed=3)}
    for objective, stream in streams.items():
        b = stream.batch_for_step(0)
        card = _twin(cfg, objective, SEED, "cuda")
        cpu = _twin(cfg, objective, SEED, "cpu")
        loss, g = _grads_on(card, objective, b)
        loss_c, g_c = _grads_on(cpu, objective, b)
        worst, at = _max_rel(g, g_c, {"cox_head.b": GRAD_CARD_ATOL})
        loss_err = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
        out[f"grads_{objective}"] = {"loss": float(loss),
                                     "loss_rel_err": loss_err,
                                     "worst_grad_rel_err": worst,
                                     "worst_at": at}
        log(f"  gradients on the card against the CPU ({objective}, "
            f"{cfg.name} at full width, {TWIN_LAYERS} layers, float32, one "
            f"batch of 32 x 48): loss {float(loss):.6f} rel err "
            f"{loss_err:.3e}; worst gradient max |diff| / max |cpu| "
            f"{worst:.3e} at {at} (tol {GRAD_CARD_RTOL:.0e})")
        check(loss_err <= GRAD_CARD_RTOL and worst <= GRAD_CARD_RTOL,
              f"{objective}: gradients on the card differ from the CPU's")
        del cpu, g_c
    # microbatch 4 against the full batch, the lm objective
    b = streams["lm"].batch_for_step(1)
    s1 = card
    s2 = copy.deepcopy(card)
    tc = dict(learning_rate=1e-3, warmup_steps=5)
    s1, m1 = trainer.make_train_step(s1.model, TrainConfig(
        microbatch=4, **tc), "lm")(s1, b)
    s2, m2 = trainer.make_train_step(s2.model, TrainConfig(**tc), "lm")(
        s2, b)
    loss_err = abs(float(m1["loss"]) - float(m2["loss"])) \
        / abs(float(m2["loss"]))
    p1, p2 = (dict(s.model.named_parameters()) for s in (s1, s2))
    with torch.no_grad():
        excess = max(float(((p1[k] - p2[k]).abs()
                            - MICRO_P_RTOL * p2[k].abs()).max()) for k in p2)
    out["microbatch"] = {"loss_rel_err": loss_err,
                         "worst_param_excess": excess}
    log(f"  microbatch 4 against the full batch on the card: loss rel err "
        f"{loss_err:.3e} (tol {MICRO_LOSS_RTOL:.0e}); params: max(|diff| - "
        f"{MICRO_P_RTOL:.0e} |p|) {excess:.3e} (tol {MICRO_P_ATOL:.0e})")
    check(loss_err <= MICRO_LOSS_RTOL and excess <= MICRO_P_ATOL,
          "microbatch 4 differs from the full batch")
    del s1, s2, card
    torch.cuda.empty_cache()
    return out


def _resume_check(cfg) -> dict:
    """CKPT_STEPS steps of the deep-survival backbone (bfloat16, 12 layers),
    saved through AsyncCheckpointer, resumed into a freshly built model:
    params and moments bit-equal, the next step's loss within RESUME_RTOL;
    the checkpoint restored onto the CPU as well."""
    import shutil

    import torch

    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import SurvivalTextStream
    from repro_torch.models import build_model
    from repro_torch.survival import deep
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault_tolerance as ft
    from repro_torch.train import trainer

    dcfg = deep.DeepSurvivalConfig(full=True)
    tc = TrainConfig(learning_rate=dcfg.learning_rate,
                     warmup_steps=dcfg.warmup_steps, total_steps=dcfg.steps)
    stream = SurvivalTextStream(cfg.vocab_size, dcfg.seq, dcfg.batch,
                                seed=SEED + 13)
    state = deep.init_state(build_model(cfg, device="cuda"), SEED + 13)
    step_fn = trainer.make_train_step(state.model, tc, "cox")
    for i in range(CKPT_STEPS):
        state, _ = step_fn(state, stream.batch_for_step(i))
    work = ROOT / "build" / "chip_smoke" / "ckpt"
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saver = ckpt.AsyncCheckpointer(str(work))
    saver.save(CKPT_STEPS, state)
    handed = time.perf_counter() - t0
    saver.wait()
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in work.rglob("*") if f.is_file())
    t0 = time.perf_counter()
    restored, start = ft.resume_or_init(
        str(work), lambda: deep.init_state(build_model(cfg, device="cuda"),
                                           SEED + 14))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(start == CKPT_STEPS and restored.opt.step == CKPT_STEPS,
          f"resumed at {start}")
    pa, pb = (dict(s.model.named_parameters()) for s in (state, restored))
    same = all(pa[k].dtype == pb[k].dtype and torch.equal(pa[k], pb[k])
               and torch.equal(state.opt.m[k], restored.opt.m[k])
               and torch.equal(state.opt.v[k], restored.opt.v[k])
               for k in pa)
    dtypes = sorted({str(p.dtype) for p in pb.values()})
    check(same, "the restored params or moments are not bit-equal")
    # the card's checkpoint onto the CPU (the port's elastic restore), into
    # a tree of shapes on the meta device
    meta = {"params": {k: torch.empty_like(p, device="meta")
                       for k, p in pa.items()}}
    on_cpu = ckpt.restore(str(work), meta, device="cpu")["params"]
    same_cpu = all(on_cpu[k].device.type == "cpu"
                   and torch.equal(p.cpu(), on_cpu[k]) for k, p in pa.items())
    check(same_cpu, "the checkpoint restored onto the CPU differs")
    del on_cpu, meta
    b = stream.batch_for_step(CKPT_STEPS)
    restored, m_res = trainer.make_train_step(restored.model, tc, "cox")(
        restored, b)
    state, m_direct = step_fn(state, b)
    loss_err = abs(float(m_res["loss"]) - float(m_direct["loss"])) \
        / abs(float(m_direct["loss"]))
    lr = float(m_direct["lr"])
    pa, pb = ({k: p.detach() for k, p in s.model.named_parameters()}
              for s in (state, restored))
    after_equal = all(torch.equal(pa[k], pb[k]) for k in pa)
    # two steps from the same state may differ where the embedding's
    # backward adds with atomics: each parameter within two of the step's
    # moves (2 lr) plus one bfloat16 rounding of its value
    excess = max(float(((pa[k].float() - pb[k].float()).abs()
                        - 2 * lr - pa[k].float().abs() * 2.0 ** -8).max())
                 for k in pa)
    out = {"bytes": nbytes, "save_s": save_s, "save_handed_back_s": handed,
           "restore_s": restore_s, "restored_dtypes": dtypes,
           "bit_equal": same, "next_loss_rel_err": loss_err,
           "params_after_step_bit_equal": after_equal,
           "params_after_step_excess": excess}
    log(f"  checkpoint of {CKPT_STEPS} steps ({nbytes / 1e6:.1f} MB; save "
        f"{save_s:.3f} s, {handed:.3f} s before the caller steps on; "
        f"restore into a fresh model {restore_s:.3f} s): params and "
        f"moments bit-equal ({', '.join(dtypes)}): {same}; restored onto "
        f"the CPU bit-equal: {same_cpu}; next step's loss rel err "
        f"{loss_err:.3e} (tol {RESUME_RTOL:.0e}); params after that step "
        f"bit-equal: {after_equal} (max |diff| - 2 lr - |p| 2^-8 = "
        f"{excess:.3e}, tol 0)")
    check(loss_err <= RESUME_RTOL, "the resumed step's loss differs")
    check(excess <= 0.0, "params after the resumed step differ by more "
          "than two steps' moves")
    shutil.rmtree(work, ignore_errors=True)
    del state, restored
    torch.cuda.empty_cache()
    return out


def _launcher_check() -> dict:
    """launch.train.main at qwen2.5-3b's published widths, 12 layers."""
    import numpy as np
    import torch

    from repro_torch.analysis import roofline as rl
    from repro_torch.data.pipeline import TokenTaskStream
    from repro_torch.launch import train as train_cli
    from repro_torch.configs import TrainConfig
    from repro_torch.train import trainer

    times: list = []
    torch.cuda.reset_peak_memory_stats()
    state, losses = train_cli.main([
        "--arch", LAUNCH_ARCH, "--objective", "lm", "--scale",
        f"n_layers={LAUNCH_LAYERS}", "--steps", str(LAUNCH_STEPS),
        "--batch", str(LAUNCH_BATCH), "--seq", str(LAUNCH_SEQ),
        "--log-every", "5", "--device", "cuda"],
        on_step=_step_timer(times))
    peak = torch.cuda.max_memory_allocated() / 1e9
    cfg = state.model.cfg
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.n_layers, cfg.vocab_size, cfg.dtype)
          == (2048, 16, 2, 11008, LAUNCH_LAYERS, 4096, "bfloat16"),
          f"launcher config: {cfg}")
    check(len(losses) == LAUNCH_STEPS
          and bool(np.all(np.isfinite(losses))), "launcher losses")
    step_s = statistics.median(times[5:])
    tokens = LAUNCH_BATCH * LAUNCH_SEQ
    # forward, backward (2x) and the per-layer recompute of remat
    flops = 8.0 * tokens * sum(
        p.numel() for name, p in state.model.layers.named_parameters()
        if name.rsplit(".", 1)[-1] in GEMM_WEIGHTS)
    n_params = sum(p.numel() for p in state.model.parameters())
    stream = TokenTaskStream(cfg.vocab_size, LAUNCH_SEQ, LAUNCH_BATCH)
    step_fn = trainer.make_train_step(state.model, TrainConfig(
        learning_rate=1e-3, warmup_steps=20, total_steps=LAUNCH_STEPS), "lm")
    prof = _profiled_batch(lambda: step_fn(state, stream.batch_for_step(0)),
                           host=True)
    out = {"arch": cfg.name, "params": n_params, "s_per_step": step_s,
           "tokens_per_s": tokens / step_s, "peak_gb": peak,
           "gemm_tflop_per_step": flops / 1e12,
           "gemm_tflops": flops / step_s / 1e12,
           "gemm_tflops_device": flops / prof["gemm_ms"] / 1e9,
           "first_loss": losses[0], "last_loss": losses[-1],
           "profiled_step": prof}
    log(f"  launch.train at {cfg.name}'s widths ({n_params / 1e6:.1f}M "
        f"parameters, {cfg.n_layers} layers, bfloat16, batch "
        f"{LAUNCH_BATCH} x {LAUNCH_SEQ}): {step_s:.4f} s a step (median "
        f"after step 5), {out['tokens_per_s']:.0f} tokens/s, peak "
        f"{peak:.2f} GB; weight GEMMs {out['gemm_tflop_per_step']:.2f} "
        f"TFLOP a step, {out['gemm_tflops']:.1f} TFLOP/s over the step, "
        f"{out['gemm_tflops_device']:.1f} TFLOP/s over the matmul kernels' "
        f"device time ({prof['gemm_ms']:.2f} ms of the profiled step, "
        f"all matmuls; "
        f"{out['gemm_tflops_device'] * 1e12 / rl.BF16_OPS_PER_S:.1%} of the "
        f"bfloat16 peak); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; one profiled step: wall "
        f"{prof['wall_ms']:.2f} ms, idle {prof['idle']:.1%}, "
        f"{prof['kernels']} kernels, top {prof['top_kernels_ms']}; host "
        f"operators by self time {prof['host_top_ms']}")
    del state, step_fn
    torch.cuda.empty_cache()
    return out


def _sharded_checks(x, t, delta, lam2: float, model) -> dict:
    """A one-rank NCCL world (``launch.mesh.data_group``): fit_cd_sharded
    against fit_cd, sharded_grad_hess_all against grad_hess_all on the
    main path's rows with ties broken by their order (the sharded
    functions' tie-free contract), compressed_psum against the int8 round
    trip, and ScoringEngine(shard="auto") against the unsharded engine."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.core import cox, distributed, solvers
    from repro_torch.launch import mesh
    from repro_torch.serving import ScoringEngine
    from repro_torch.train import compression

    group = mesh.data_group("cuda")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "the data group is not a one-rank NCCL world")
    data = convert.cox_data_from_numpy(x, t, delta, device="cuda")
    order = torch.arange(data.n, dtype=torch.int32, device="cuda")
    data = dataclasses.replace(data, risk_start=order, tie_end=order)
    l2c, _, _ = solvers.constants(data, True)
    _, sh_s = _timed(lambda: distributed.fit_cd_sharded(
        data, l2c, group, lam2=lam2, n_sweeps=1))
    (beta_sh, eta_sh), sh_s = _timed(lambda: distributed.fit_cd_sharded(
        data, l2c, group, lam2=lam2, n_sweeps=SHARDED_SWEEPS))
    f_sh = float(cox.loss_from_eta(data, eta_sh)
                 + lam2 * torch.sum(beta_sh * beta_sh))
    res, cd_s = _timed(lambda: solvers.fit_cd(data, lam2=lam2,
                                              n_iters=SHARDED_SWEEPS))
    f_ref = float(res.objective[-1])
    f_err = abs(f_sh - f_ref) / max(1.0, abs(f_ref))
    eta = data.x @ beta_sh
    g_sh, h_sh = distributed.sharded_grad_hess_all(data, eta, group)
    g_ref, h_ref = cox.grad_hess_all(data, eta)
    gh_err = max(float((a - b).abs().max() / b.abs().max())
                 for a, b in ((g_sh, g_ref), (h_sh, h_ref)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    y = torch.randn(1 << 20, device="cuda", generator=gen)
    cps = compression.compressed_psum(y, group)
    want, _ = compression.compress_decompress({"y": y},
                                              {"y": torch.zeros_like(y)})
    cps_same = torch.equal(cps, want["y"])
    one = ScoringEngine(model, device="cuda")
    auto = ScoringEngine(model, shard="auto", device="cuda")
    feats = np.random.default_rng(SEED + 131).standard_normal(
        (300, model.p)).astype(np.float32)
    engine_same = all(np.array_equal(a, b) for a, b in zip(
        one.score(feats, with_curves=True),
        auto.score(feats, with_curves=True)))
    dist.destroy_process_group()
    out = {"fit_cd_sharded_s_per_sweep": sh_s / SHARDED_SWEEPS,
           "fit_cd_s_per_sweep": cd_s / SHARDED_SWEEPS,
           "objective_sharded": f_sh, "objective_fit_cd": f_ref,
           "objective_rel_err": f_err, "grad_hess_rel_err": gh_err,
           "compressed_psum_bit_equal": cps_same,
           "engine_auto_shard": auto.shard,
           "engine_bit_equal": engine_same}
    log(f"  one-rank NCCL world: fit_cd_sharded {SHARDED_SWEEPS} sweeps at "
        f"n={data.n}, p={data.p} ({out['fit_cd_sharded_s_per_sweep']:.3f} s "
        f"a sweep; fit_cd {out['fit_cd_s_per_sweep']:.3f}): objective "
        f"{f_sh:.4f} against {f_ref:.4f}, rel err {f_err:.3e} (tol "
        f"{SHARDED_RTOL:.0e}); sharded_grad_hess_all against grad_hess_all "
        f"{gh_err:.3e} (tol {SHARDED_GH_RTOL:.0e}); compressed_psum equal "
        f"to the int8 round trip: {cps_same}; ScoringEngine(shard='auto') "
        f"shard {auto.shard}, its scores of 300 rows of the trained "
        f"artifact equal to the unsharded engine's bit for bit: "
        f"{engine_same}")
    check(f_err <= SHARDED_RTOL, "fit_cd_sharded's objective differs")
    check(gh_err <= SHARDED_GH_RTOL, "sharded_grad_hess_all differs")
    check(cps_same, "compressed_psum differs from the int8 round trip")
    check(auto.shard == torch.cuda.device_count() == 1 and engine_same,
          f"ScoringEngine(shard='auto'): shard {auto.shard}, scores equal "
          f"{engine_same}")
    return out


def train_phase(x, t, delta, lam2: float) -> dict:
    """Phase 13: deep.run at full width (train, featurize, refit, export)
    with exact launch counts, the trained artifact served; then gradients
    against the CPU, microbatching, checkpoint and resume, the launcher at
    qwen2.5-3b's widths and the one-rank sharded checks. Returns its
    numbers and launches."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig
    from repro_torch.core import beam
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    from repro_torch.serving import ModelRegistry, RiskService
    from repro_torch.survival import deep
    from repro_torch.train import trainer

    log("phase 13: training on the card")
    dcfg = deep.DeepSurvivalConfig(full=True)
    cfg = deep.model_config(dcfg)
    check((cfg.name, cfg.d_model, cfg.ssm_expand, cfg.ssm_state,
           cfg.ssm_head_dim, cfg.ssm_chunk, cfg.n_layers, cfg.vocab_size,
           cfg.dtype) == ("mamba2-130m", 768, 2, 128, 64, 128, 12, 2048,
                          "bfloat16"), f"backbone config: {cfg}")
    n_held = dcfg.refit_batches * dcfg.batch
    # the shapes this path gives its kernels are those phase 2 checked
    check((n_held, cfg.d_model, dcfg.k, dcfg.grid_size)
          == (TRAIN_N, DEEP_D, DEEP_K, DEEP_GRID),
          "phase 13's shapes are not those phase 2 checked")
    work = ROOT / "build" / "chip_smoke" / "train"
    work.mkdir(parents=True, exist_ok=True)
    times: list = []
    during_training: list = []
    timer = _step_timer(times)

    def on_step(step, metrics):
        timer(step, metrics)
        if step == dcfg.steps - 1:
            during_training.append(ops.launch_counts())

    out = {"arch": cfg.name}
    torch.cuda.reset_peak_memory_stats()
    spans = work / "trace.jsonl"
    spans.unlink(missing_ok=True)
    trace.configure(str(spans))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = deep.run(dcfg, device="cuda", on_step=on_step)
    finally:
        trace.configure(None)
    run_s = time.perf_counter() - t0
    launched = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    size_s, candidates, scored = _beam_spans(spans)
    losses = np.asarray(res.losses)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    step_s = statistics.median(times[TRAIN_TIMED_FROM:])
    tokens = dcfg.batch * dcfg.seq
    out["run"] = {"seconds": run_s, "steps": len(losses),
                  "s_per_step": step_s, "tokens_per_s": tokens / step_s,
                  "peak_gb": peak, "first10_loss": first,
                  "last10_loss": last, "margin": first - last,
                  "cindex_deep": res.cindex_deep,
                  "cindex_sparse": res.cindex_sparse, "nnz": res.nnz,
                  "support": res.beam.supports[-1].tolist(),
                  "refit_size_s": size_s, "candidates": candidates,
                  "params": sum(p.numel() for p in
                                res.state.model.parameters())}
    log(f"  deep.run at full width ({out['run']['params'] / 1e6:.1f}M "
        f"parameters, {cfg.n_layers} layers, bfloat16): {len(losses)} "
        f"steps of {dcfg.batch} x {dcfg.seq} in {run_s:.1f} s with the "
        f"refit; {step_s:.4f} s a step (median after step "
        f"{TRAIN_TIMED_FROM}), {tokens / step_s:.0f} tokens/s, peak "
        f"{peak:.2f} GB; first-10 mean loss {first:.4f}, last-10 "
        f"{last:.4f} (margin {first - last:.4f}); refit seconds per size "
        + ", ".join(f"{v:.3f}" for v in size_s)
        + f"; support {res.beam.supports[-1].tolist()}; held-out c-index "
        f"deep head {res.cindex_deep:.4f}, sparse refit "
        f"{res.cindex_sparse:.4f}")
    check(bool(np.all(np.isfinite(losses))) and len(losses) == dcfg.steps,
          "training losses")
    check(last < first, f"the loss did not fall: first-10 {first:.4f}, "
          f"last-10 {last:.4f}")
    check(during_training and not any(during_training[0].values()),
          f"kernels launched during training: {during_training}")
    defaults = inspect.signature(beam.beam_search).parameters
    sweeps = defaults["finetune_sweeps"].default
    steps = defaults["score_steps"].default
    blocks = beam.column_blocks(n_held, cfg.d_model, 4)
    _check_counts("training path (deep.run)", launched, {
        "cox_coord": sweeps * sum(size * c for size, c in
                                  enumerate(candidates, 1)),
        "lipschitz": 1,
        "revcumsum": sum(scored) * (2 * steps + 1) * len(blocks),
        # the held-out batches featurized for the refit (training, with
        # gradients, keeps the eager scan)
        "ssd_scan": dcfg.refit_batches * cfg.n_layers})
    check(len(size_s) == dcfg.k and res.nnz <= dcfg.k
          and res.artifact.is_sparse and res.artifact.k == res.nnz
          and res.artifact.n_grid == dcfg.grid_size
          and res.features.shape == (TRAIN_N, DEEP_D), "the refit")
    check(res.cindex_deep > 0.5 and res.cindex_sparse > 0.5,
          f"held-out c-indexes {res.cindex_deep:.4f}, "
          f"{res.cindex_sparse:.4f} not above 0.5")

    # one profiled step, on a copy of the trained state
    twin_state = copy.deepcopy(res.state)
    step_fn = trainer.make_train_step(twin_state.model, TrainConfig(
        learning_rate=dcfg.learning_rate, warmup_steps=dcfg.warmup_steps,
        total_steps=dcfg.steps), "cox")
    from repro_torch.data.pipeline import SurvivalTextStream
    stream = SurvivalTextStream(cfg.vocab_size, dcfg.seq, dcfg.batch,
                                seed=dcfg.seed)
    out["profiled_step"] = prof = _profiled_batch(
        lambda: step_fn(twin_state, stream.batch_for_step(0)), host=True)
    log(f"  one training step profiled: wall {prof['wall_ms']:.2f} ms, "
        f"device busy {prof['busy_ms']:.2f} ms -> idle {prof['idle']:.1%}, "
        f"{prof['kernels']} kernels; top kernels {prof['top_kernels_ms']}; "
        f"host operators by self time {prof['host_top_ms']}")
    del twin_state, step_fn

    # the trained artifact served
    path = res.artifact.save(str(work / "trained_v1"))
    ops.reset_launch_counts()
    svc = RiskService(None, return_curves=True)
    reg = ModelRegistry(svc)
    check(reg.rollout("trained_v1", path) == 1, "the rollout")
    check(tuple(reg.prewarm_batches) == DEEP_CURVE_BS,
          f"the served buckets {reg.prewarm_batches} are not those phase 2 "
          f"checked")
    engine = reg.engine()
    svc.start()
    reqs = _submit_rows(svc, res.features, len(res.features), SEED + 130)
    resps = _await_served("trained artifact", svc, reqs)
    svc.stop()
    served = ops.launch_counts()
    _check_counts("trained artifact served", served,
                  {"survival_curves": engine.calls})
    launched = {k: launched[k] + served[k] for k in launched}
    out["launches"] = launched
    out["serve"] = {"requests": len(reqs), **_check_served(
        "trained artifact", svc, engine, res.features, reqs, resps,
        beta=res.beta)}
    trained_model = res.artifact
    del res, engine, reg, svc
    torch.cuda.empty_cache()

    out.update(_train_checks(cfg))
    out["resume"] = _resume_check(cfg)
    out["launcher"] = _launcher_check()
    out["sharded"] = _sharded_checks(x, t, delta, lam2, trained_model)
    return out


# ---------------------------------------------------------------------------
# Phase 14: batched decode through launch.serve
# ---------------------------------------------------------------------------

def _decode_model(cfg):
    """``cfg``'s model on the card, weights drawn from a generator seeded
    SEED."""
    import torch

    from repro_torch.models import build_model

    return build_model(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(SEED))


def _record(model, profile_at=None) -> dict:
    """Wrap ``model``'s prefill and decode_step (instance attributes, which
    ``serve_batch`` calls) until ``_unrecord``: every call's logits as a
    float32 copy, the cache the last call returned, the prefill's seconds
    (synchronised), the host time at which each decode call starts, and
    torch.profiler's reading of decode call ``profile_at`` (the next one
    when that window recorded no device time). A sharded model's logits
    are gathered whole."""
    import torch

    from repro_torch.models.pspec import whole

    rec = {"logits": [], "starts": [], "cache": None, "profile": None,
           "profile_at": profile_at}
    prefill, decode = model.prefill, model.decode_step

    def recorded_prefill(batch, max_len=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(batch, max_len=max_len)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t0
        rec["logits"].append(whole(logits).float().clone())
        rec["cache"] = cache
        return logits, cache

    def recorded_decode(cache, tokens):
        rec["starts"].append(time.perf_counter())
        if len(rec["starts"]) - 1 == rec["profile_at"]:
            (logits, cache), reading = _profile_once(
                lambda: decode(cache, tokens))
            if reading["busy_ms"] > 0:
                rec["profile"] = reading
            else:
                log("  torch.profiler recorded no device activity; "
                    "profiling the next step")
                rec["profile_at"] += 1
        else:
            logits, cache = decode(cache, tokens)
        rec["logits"].append(whole(logits).float().clone())
        rec["cache"] = cache
        return logits, cache

    model.prefill, model.decode_step = recorded_prefill, recorded_decode
    return rec


def _unrecord(model) -> None:
    del model.prefill, model.decode_step


def _serve_case(model, prompt: int, new: int, seed: int,
                profile: bool = True) -> dict:
    """DECODE_REQUESTS requests of ``prompt`` tokens and ``new`` new tokens
    drawn from ``seed`` (an encoder-decoder's source frames too, one a
    prompt token) served through ``launch.serve.serve_batch``: the tokens,
    the recorded logits and last cache, prefill seconds, decode seconds a
    step (the median interval between decode calls, each ending in the
    host's read of the tokens) and tokens a second, peak memory and, with
    ``profile``, one profiled decode step."""
    import numpy as np
    import torch

    from repro_torch.launch import serve

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    reqs = [serve.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                     prompt), max_new=new)
            for i in range(DECODE_REQUESTS)]
    src = None
    if cfg.family == "encdec":
        src = rng.standard_normal((DECODE_REQUESTS, prompt, cfg.d_model)
                                  ).astype(np.float32)
    prompts = np.stack([r.prompt for r in reqs])
    rec = _record(model, DECODE_PROFILE_STEP if profile else None)
    torch.cuda.reset_peak_memory_stats()
    try:
        _, seconds = _timed(lambda: serve.serve_batch(model, reqs,
                                                      src_embeds=src))
    finally:
        _unrecord(model)
    tokens = np.array([r.out for r in reqs])
    check(tokens.shape == (DECODE_REQUESTS, new)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"{cfg.name}: served tokens {tokens.shape}")
    check(len(rec["logits"]) == new + 1
          and all(bool(torch.isfinite(lg[:, :cfg.vocab_size]).all())
                  for lg in rec["logits"]),
          f"{cfg.name}: logits of {len(rec['logits'])} calls, or not finite")
    check(not profile or rec["profile"] is not None,
          f"{cfg.name}: no profiled decode step")
    step_s = statistics.median(np.diff(rec["starts"]))
    out = {"prompt": prompt, "new": new, "requests": DECODE_REQUESTS,
           "seconds": seconds, "prefill_s": rec["prefill_s"],
           "decode_s_per_step": step_s,
           "tokens_per_s": DECODE_REQUESTS / step_s,
           "prefill_tokens_per_s": DECODE_REQUESTS * prompt
           / rec["prefill_s"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if profile:
        out["profiled_step"] = rec["profile"]
    return {"out": out, "rec": rec, "prompts": prompts, "tokens": tokens,
            "src": src}


def _check_cache(model, served: dict) -> dict:
    """The last cache: every leaf of ``Model.init_cache``'s shape and dtype
    for the longest prompt plus the new tokens plus one (a sliding window
    capped at the window), and its length the prompt plus the steps."""
    from repro_torch.models.model import Model

    cache = served["rec"]["cache"]
    prompt, new = served["out"]["prompt"], served["out"]["new"]
    want = Model(model.cfg, device="meta").init_cache(
        DECODE_REQUESTS, prompt + new + 1, src_len=prompt)
    shapes = {f: list(getattr(cache, f).shape) for f in cache._fields}
    for f in cache._fields:
        got, spec = getattr(cache, f), getattr(want, f)
        check(got.shape == spec.shape and got.dtype == spec.dtype,
              f"{model.cfg.name}: cache {f} {tuple(got.shape)} {got.dtype}, "
              f"expected {tuple(spec.shape)} {spec.dtype}")
    check(bool((cache.length == prompt + new).all()),
          f"{model.cfg.name}: cache length {cache.length.tolist()}, "
          f"expected {prompt + new}")
    return shapes


def _twin32(model):
    """``model``'s float32 twin on the card: the same weights, copied
    parameter by parameter (no float32 copy of the whole state beside
    it)."""
    import torch

    from repro_torch.models import build_model

    twin = build_model(model.cfg.scaled(dtype="float32"), device="cuda")
    src = model.state_dict()
    with torch.no_grad():
        for name, t in twin.state_dict().items():
            t.copy_(src[name])
    return twin


def _batch_of(served: dict, tokens) -> dict:
    import torch

    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    if served["src"] is not None:
        batch["src_embeds"] = torch.as_tensor(served["src"], device="cuda")
    return batch


def _teacher_forced(model, served: dict) -> list:
    """``model``'s logits (float32) for the served prompts, then for one
    decode step on each token the served run emitted."""
    import torch

    tokens = torch.as_tensor(served["tokens"], device="cuda")
    prompt, new = served["out"]["prompt"], served["out"]["new"]
    logits, cache = model.prefill(_batch_of(served, served["prompts"]),
                                  max_len=prompt + new + 1)
    out = [logits.float()]
    for s in range(new):
        logits, cache = model.decode_step(cache, tokens[:, s:s + 1])
        out.append(logits.float())
    return out


def _full_logits(model, served: dict):
    """``model``'s full forward over the prompts and the emitted tokens:
    causal, so position p of one forward over all of them is the forward
    over the first p + 1; the logits (B, new + 1, V) at the positions of
    the prefill's and every decode step's."""
    import numpy as np
    import torch

    toks = np.concatenate([served["prompts"], served["tokens"]], axis=1)
    with torch.no_grad():
        hidden, _ = model.hidden_states(_batch_of(served, toks),
                                        remat=False)
        return model._logits(hidden[:, served["out"]["prompt"] - 1:]).float()


def _step_errors(got: list, want, v: int) -> tuple:
    """(worst ||diff|| / ||ref||, worst max |diff| / max |ref|) over the
    calls, the real vocabulary's logits."""
    errs, max_errs = [], []
    for s, g in enumerate(got):
        ref = want[:, s, :v]
        diff = g[:, :v] - ref
        errs.append(float(diff.norm() / ref.norm()))
        max_errs.append(float(diff.abs().max() / ref.abs().max()))
    return max(errs), max(max_errs)


def _against_forward(model, served: dict) -> dict:
    """Each recorded call's logits (the prefill's, then every decode
    step's) against the same model's full forward over the prompt and the
    tokens emitted, in bfloat16 (DECODE_BF16_RTOL); then the same in the
    model's float32 twin, teacher-forced to those tokens
    (DECODE_F32_RTOL)."""
    import torch

    cfg = model.cfg
    v = cfg.vocab_size
    out = dict(zip(("rel_err", "max_rel_err"), _step_errors(
        served["rec"]["logits"], _full_logits(model, served), v)))
    twin = _twin32(model)
    out.update(zip(("f32_rel_err", "f32_max_rel_err"), _step_errors(
        _teacher_forced(twin, served), _full_logits(twin, served), v)))
    del twin
    torch.cuda.empty_cache()
    out["steps_checked"] = served["out"]["new"] + 1
    log(f"    decode against the full forward, {out['steps_checked']} "
        f"calls: bfloat16 worst ||diff|| / ||ref|| {out['rel_err']:.3e} "
        f"(tol {DECODE_BF16_RTOL:.0e}), max |diff| / max |ref| "
        f"{out['max_rel_err']:.3e}; float32 twin {out['f32_rel_err']:.3e} "
        f"(tol {DECODE_F32_RTOL:.0e}), {out['f32_max_rel_err']:.3e}")
    check(out["rel_err"] <= DECODE_BF16_RTOL,
          f"{cfg.name}: bfloat16 decode differs from the full forward by "
          f"{out['rel_err']:.3e}")
    check(out["f32_rel_err"] <= DECODE_F32_RTOL,
          f"{cfg.name}: float32 decode differs from the full forward by "
          f"{out['f32_rel_err']:.3e}")
    return out


def _log_served(name: str, out: dict) -> None:
    prof = out.get("profiled_step")
    log(f"    {name}: {out['requests']} x {out['prompt']} + {out['new']}: "
        f"prefill {out['prefill_s']:.3f} s "
        f"({out['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{out['decode_s_per_step'] * 1e3:.2f} ms a step "
        f"({out['tokens_per_s']:.1f} tokens/s), peak {out['peak_gb']:.2f} GB"
        + (f"; one profiled step {prof['wall_ms']:.2f} ms, device busy "
           f"{prof['busy_ms']:.2f} ms (idle {prof['idle']:.1%}), "
           f"{prof['kernels']} kernels" if prof else ""))


def _routes(record: list, replay=None):
    """A stand-in for ``moe.moe_ffn`` that appends each call's top-k
    experts to ``record`` or, given ``replay`` (an iterator over such a
    record), routes each call to the recorded experts: their weights from
    this call's own router probabilities, renormalized."""
    import torch

    from repro_torch.models import moe

    def moe_ffn(params, x, n_experts_per_tok=2, capacity_factor=1.25):
        probs, topv, topi = moe.route(params, x, n_experts_per_tok)
        record.append(topi)
        if replay is not None:
            topi = next(replay)
            topv = probs.gather(1, topi)
            topv = (topv / topv.sum(dim=-1, keepdim=True)).to(x.dtype)
        return moe.dispatch(params, x, probs, topv, topi, capacity_factor)

    return moe_ffn


def _moe_twin(cfg) -> dict:
    """mixtral at MOE_TWIN_LAYERS layers served in bfloat16, against its
    float32 twin (the same weights) prefilled on the same prompts and
    decoding the bfloat16 run's tokens through the bfloat16 run's
    experts: a router near-tie (a top-2 that bfloat16 rounding reorders)
    would send a token through other experts, an O(1) change, so the twin
    replays the routes and counts the calls where its own would differ."""
    import torch

    from repro_torch.models import moe

    model = _decode_model(cfg.scaled(n_layers=MOE_TWIN_LAYERS))
    real = moe.moe_ffn
    routes, own = [], []
    moe.moe_ffn = _routes(routes)
    try:
        served = _serve_case(model, DECODE_C10_PROMPT, DECODE_CASES[0][3],
                             SEED + 140, profile=False)
        twin = _twin32(model)
        del model
        moe.moe_ffn = _routes(own, replay=iter(routes))
        want = _teacher_forced(twin, served)
    finally:
        moe.moe_ffn = real
    check(len(own) == len(routes), "the twin's MoE calls")
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(routes, own))
    v = cfg.vocab_size
    got = torch.stack([lg[:, :v] for lg in served["rec"]["logits"]])
    want = torch.stack([lg[:, :v] for lg in want])
    steps = ((got - want).flatten(1).norm(dim=1)
             / want.flatten(1).norm(dim=1))
    out = {"layers": MOE_TWIN_LAYERS, "prompt": DECODE_C10_PROMPT,
           "new": served["out"]["new"],
           "rel_err": float((got - want).norm() / want.norm()),
           "worst_step_rel_err": float(steps.max()),
           "max_rel_err": float((got - want).abs().max()
                                / want.abs().max()),
           "routes": sum(int(r.shape[0]) for r in routes),
           "routes_float32_would_change": flips}
    log(f"    MoE, {MOE_TWIN_LAYERS} layers, bfloat16 against float32 "
        f"(teacher-forced to the tokens and the {out['routes']} routes, "
        f"{flips} of which float32 would send elsewhere; {len(steps)} "
        f"calls): worst step ||diff|| / ||f32|| "
        f"{out['worst_step_rel_err']:.3e} (tol {MOE_TWIN_RTOL:.0e}), all "
        f"steps {out['rel_err']:.3e}, max |diff| / max |f32| "
        f"{out['max_rel_err']:.3e}")
    check(out["worst_step_rel_err"] <= MOE_TWIN_RTOL,
          f"mixtral: bfloat16 decode differs from float32 by "
          f"{out['worst_step_rel_err']:.3e}")
    del twin
    torch.cuda.empty_cache()
    return out


def _vlm_prefills(model, served: dict) -> dict:
    """qwen2-vl's prefill fed the stub frontend's patch embeddings (here
    the prompts' own embeddings) with (3, B, S) M-RoPE positions: with
    equal t, h and w rows it is the token prefill (held at DECODE_BF16_RTOL;
    the same ops on the same values, so expected equal); with rows that
    differ, finite and another result."""
    import torch

    toks = torch.as_tensor(served["prompts"], device="cuda")
    b, s = toks.shape
    pos = torch.arange(s, device="cuda")[None, :].expand(b, s)
    emb = model.embed[toks.long()]
    a, _ = model.prefill({"tokens": toks})
    same, _ = model.prefill({"embeds": emb,
                             "positions": torch.stack([pos, pos, pos])})
    other, _ = model.prefill({"embeds": emb, "positions": torch.stack(
        [pos, pos // 16, pos % 16])})
    v = model.cfg.vocab_size
    a, same, other = (t[:, :v].float() for t in (a, same, other))
    out = {"same_rows_rel_err": float((same - a).norm() / a.norm()),
           "other_rows_rel_diff": float((other - a).norm() / a.norm())}
    log(f"    M-RoPE prefill from embeddings: equal rows against the "
        f"token prefill {out['same_rows_rel_err']:.3e} (tol "
        f"{DECODE_BF16_RTOL:.0e}); rows (t, t // 16, t % 16) move the logits by "
        f"{out['other_rows_rel_diff']:.3e}")
    check(out["same_rows_rel_err"] <= DECODE_BF16_RTOL
          and bool(torch.isfinite(other).all())
          and out["other_rows_rel_diff"] > 0,
          f"qwen2-vl M-RoPE prefill: {out}")
    return out


def _decode_case(arch: str, layers, prompt: int, new: int, k: int) -> dict:
    """One architecture of DECODE_CASES: built at its published widths
    (cut to ``layers``), served, its cache and its decode against the full
    forward checked (mixtral's MoE against its float32 twin instead, and
    its dense variant against the forward, also under the window)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if layers:
        cfg = cfg.scaled(n_layers=layers)
    check(cfg.dtype == "bfloat16", f"{arch}: {cfg.dtype}")
    model = _decode_model(cfg)
    res = {"layers": cfg.n_layers, "published_layers": get_config(
        arch).n_layers, "weights_gb": sum(
            p.numel() * p.element_size() for p in model.parameters()) / 1e9}
    log(f"  {arch}: {cfg.n_layers} of {res['published_layers']} layers, "
        f"{res['weights_gb']:.2f} GB of bfloat16 weights")
    served = _serve_case(model, prompt, new, SEED + 140 + k)
    _log_served(arch, served["out"])
    res.update(served["out"])
    res["cache"] = _check_cache(model, served)
    if cfg.family == "moe":
        short = _serve_case(model, DECODE_C10_PROMPT, new, SEED + 150,
                            profile=False)
        _log_served(f"{arch} under the window", short["out"])
        res["under_window"] = dict(short["out"],
                                   cache=_check_cache(model, short))
        slots = [res["cache"]["k"][2], res["under_window"]["cache"]["k"][2]]
        check(slots == [tf.cache_slots(cfg, p + new + 1)
                        for p in (prompt, DECODE_C10_PROMPT)]
              and slots[0] == cfg.sliding_window,
              f"{arch}: sliding-window slots {slots}")
        log(f"    sliding-window cache slots {slots} for prompts "
            f"{prompt} and {DECODE_C10_PROMPT} (window "
            f"{cfg.sliding_window})")
        del model, served, short
        torch.cuda.empty_cache()
        res["moe_twin"] = _moe_twin(cfg)
        dense = _decode_model(cfg.scaled(n_experts=0, n_experts_per_tok=0,
                                         family="dense"))
        log(f"  {arch}'s dense variant (n_experts=0)")
        res["dense_variant"] = {}
        for p in (prompt, DECODE_C10_PROMPT):
            served = _serve_case(dense, p, new, SEED + 160 + p,
                                 profile=False)
            _log_served(f"dense variant, prompt {p}", served["out"])
            res["dense_variant"][str(p)] = dict(
                served["out"], cache=_check_cache(dense, served),
                **_against_forward(dense, served))
        del dense, served
    else:
        res.update(_against_forward(model, served))
        if cfg.mrope_sections:
            res["mrope_prefill"] = _vlm_prefills(model, served)
        del model, served
    torch.cuda.empty_cache()
    res["case_seconds"] = time.perf_counter() - t0
    return res


def decode_phase() -> dict:
    """Phase 14: batched decode through ``launch.serve.serve_batch`` for
    DECODE_CASES at their published widths, each architecture freed
    before the next. The kernel counts are zeroed before and read after:
    zamba2's bfloat16 full-sequence forwards reach ssd_scan, and the
    causal self-attention of seamless-m4t's decoder and qwen2-vl
    flash_attn."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    log("phase 14: batched decode")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    out = {arch: _decode_case(arch, layers, prompt, new, k)
           for k, (arch, layers, prompt, new) in enumerate(DECODE_CASES)}
    launches = ops.launch_counts()
    # zamba2's full-sequence forwards in bfloat16 (prefill, the check's full
    # forward) scan each of its Mamba2 layers once; its float32 twin and
    # the decode steps keep the eager form
    zamba = get_config("zamba2-2.7b").n_layers
    scans = launches["ssd_scan"]
    check(scans >= 2 * zamba and scans % zamba == 0,
          f"decode path: {scans} ssd_scan launches, not a multiple of "
          f"zamba2's {zamba} Mamba2 layers")
    # the bfloat16 full-sequence forwards of causal self-attention with no
    # window and head_dim 64 or 128 (seamless-m4t's decoder, qwen2-vl) take
    # the flash-attention kernel, once a layer a forward; mixtral's (a
    # window), gemma3's (head_dim 256), zamba2's (80), the encoder's and
    # the float32 twins' run the plain version
    attn = launches["flash_attn"]
    vl = get_config("qwen2-vl-7b").n_layers
    check(attn >= vl, f"decode path: {attn} flash_attn launches, fewer than "
          f"qwen2-vl's {vl} attention layers")
    _check_counts("decode path", launches, {"ssd_scan": scans,
                                            "flash_attn": attn})
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 15: the entry points and the tools
# ---------------------------------------------------------------------------

def _example(name: str):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cpu_examples() -> dict:
    """The CPU twins of CPU_EXAMPLES, each started in a process of its own
    with one intra-op thread, to run beside the card's."""
    import os

    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    return {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
         "--device", "cpu"], cwd=str(TOOLS_DIR), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in CPU_EXAMPLES}


def _cpu_output(proc) -> str:
    out, err = proc.communicate(timeout=CPU_EXAMPLE_TIMEOUT)
    check(proc.returncode == 0, f"a CPU example exited {proc.returncode}: "
          f"{err[-2000:]}")
    return out


def _against_cpu(card: dict, procs: dict) -> dict:
    """quickstart's final objectives and sparse_selection's F1 table on the
    card against the same examples on the CPU."""
    import re

    cpu = {name: _cpu_output(proc) for name, proc in procs.items()}
    objs = {m: float(v) for m, v in re.findall(
        r"^\s*(\w+): final objective ([-\d.]+)", cpu["quickstart"],
        re.M)}
    check(sorted(objs) == sorted(_example("quickstart").METHODS),
          f"the CPU quickstart printed {sorted(objs)}")
    rel = {m: abs(card["quickstart"][m] - o) / abs(o)
           for m, o in objs.items()}
    log("  quickstart, card against CPU, final objectives: "
        + ", ".join(f"{m} {card['quickstart'][m]:.6f} / {objs[m]:.6f} "
                    f"(rel {rel[m]:.2e})" for m in objs)
        + f"; tol {QUICKSTART_RTOL:.0e}")
    check(max(rel.values()) <= QUICKSTART_RTOL,
          f"quickstart: card and CPU objectives differ by {rel}")
    rows = re.findall(r"^\s*(\d+) \| +([\d.]+) \| +([\d.]+) \| +([\d.]+)$",
                      cpu["sparse_selection"], re.M)
    mine = [(str(k), f"{b:.3f}", f"{o:.3f}", f"{f:.3f}")
            for k, b, o, f in card["sparse_selection"]]
    log(f"  sparse_selection F1 table, card {mine}, CPU {rows}")
    check(len(rows) == 8 and mine == rows,
          "sparse_selection: the card's F1 table is not the CPU's")
    return {"quickstart_rel": rel, "f1_rows": [list(r) for r in mine]}


def _latency_rows(table: str) -> dict:
    """{stage: count} of a latency-breakdown table."""
    rows = [r.split("|")[1:3] for r in table.splitlines()[2:]]
    return {name.strip(): int(n) for name, n in rows if n.strip().isdigit()}


def check_example_kernels() -> dict:
    """Every kernel of the examples' paths against its plain version at the
    shapes they give it: cox_coord and lipschitz on each example's data
    and on train_survival_lm's refit panel, revcumsum on their scored
    column blocks, survival_curves on serve_risk_api's buckets (phase 2
    has checked the launch shapes and train_survival_lm's buckets).
    Returns the largest absolute error of each."""
    import torch

    from repro_torch.core import beam

    errs = check_kernels(coord_ns=tuple(n for n, _ in EXAMPLE_FITS),
                         curve_bs=EXAMPLE_CURVE_BS,
                         curve_gs=(EXAMPLE_GRID,),
                         deep_curve_bs=(), launch_shape=False)
    errs["lipschitz"] = max(check_lipschitz(
        ns=(n,), ps=tuple(range(1, EXAMPLE_K + 1)) + (p,),
        launch_shape=False) for n, p in EXAMPLE_FITS)
    shapes = []
    for n, p in EXAMPLE_FITS:
        shapes += [(n, c.stop - c.start) for c in beam.column_blocks(n, p, 4)]
    errs["revcumsum"] = check_selection_scans(tuple(sorted(set(shapes))))
    torch.cuda.empty_cache()
    return errs


def _dryrun(out_dir: Path) -> dict:
    """Every (arch x shape) cell on the meta device; the tables printed."""
    import shutil

    from repro_torch.analysis import report
    from repro_torch.configs import REGISTRY, SHAPES
    from repro_torch.launch import dryrun

    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    recs = dryrun.main(["--out", str(out_dir)])
    seconds = time.perf_counter() - t0
    check(len(recs) == len(REGISTRY) * len(SHAPES) == DRYRUN_CELLS,
          f"the dry run gave {len(recs)} cells")
    for r in recs:
        check(r["status"] == "ok" or (r["status"] == "skipped"
                                      and r.get("reason")),
              f"dry run {r['arch']} {r['shape']}: {r['status']} "
              f"{r.get('traceback', '')}")
    useful = {r["arch"]: r["roofline"]["useful_flops_ratio"] for r in recs
              if r["status"] == "ok" and SHAPES[r["shape"]].kind == "train"}
    log("  train cells' useful/counted flops: "
        + ", ".join(f"{a} {u:.3f}" for a, u in useful.items())
        + f" (within {USEFUL_RANGE})")
    check(len(useful) == len(REGISTRY) and all(
        USEFUL_RANGE[0] <= u <= USEFUL_RANGE[1] for u in useful.values()),
        f"useful flops ratios {useful} outside {USEFUL_RANGE}")
    recs = report.load(str(out_dir))
    log(report.dryrun_table(recs))
    log(report.roofline_table(recs))
    log(f"  dry run: {len(recs)} cells in {seconds:.1f} s")
    cells = {f"{r['arch']} {r['shape']}": (
        {"fits": r["fits"], "state_gb": r["bytes"]["state"] / 1e9,
         "flops": r["flops"], "bottleneck": r["roofline"]["bottleneck"],
         "compute_s": r["roofline"]["compute_s"],
         "memory_floor_s": r["roofline"]["memory_s"],
         "useful": r["roofline"]["useful_flops_ratio"]}
        if r["status"] == "ok" else {"skipped": r["reason"]})
        for r in recs}
    return {"seconds": seconds, "train_useful": useful, "cells": cells,
            "card_bytes": recs[0].get("card_bytes") if recs else None}


def _autotune(cache: Path) -> dict:
    """The autotuner's sweep into ``cache``, every candidate's panel
    checked against the plain version at each swept shape."""
    from repro_torch.analysis import report
    from repro_torch.kernels import autotune, ref

    cache.unlink(missing_ok=True)
    shapes = list(autotune.DEFAULT_SWEEP) + [
        (kernel, {"b": b, "g": EXAMPLE_GRID})
        for kernel in sorted(autotune.DEFAULT_CONFIGS)
        for b in AUTOTUNE_BS]
    t0 = time.perf_counter()
    autotune.sweep(shapes, cache_file=str(cache), force=True, verbose=True)
    seconds = time.perf_counter() - t0
    worst = 0.0
    for kernel, shape in shapes:
        inputs = autotune._build_inputs(kernel, shape, seed=5,
                                        device="cuda")
        want = (ref.survival_curves_ref(*inputs)
                if kernel == "survival_curves"
                else ref.survival_curves_stratified_ref(*inputs))
        for cfg in autotune.CANDIDATES[kernel]:
            worst = max(worst, check_curve(
                f"{kernel} b={shape['b']} g={shape['g']} {cfg}",
                lambda cfg=cfg: autotune.run_config(kernel, inputs, cfg),
                want))
    log(report.tuned_blocks_table(str(cache)))
    entries = autotune.load_cache(str(cache), refresh=True)
    return {"seconds": seconds, "max_abs_err": worst, "entries": {
        key: {k: e[k] for k in ("config", "us", "spread_us", "default_us",
                                "default_spread_us", "candidates",
                                "candidate_spread_us", "device")}
        for key, e in entries.items()}}


def tools_phase() -> dict:
    """Phase 15: the five examples on the card as a user runs them, each
    path's launch counts read, quickstart and sparse_selection held
    against their CPU runs, the latency table of serve_risk_api's trace,
    the kernels at the examples' shapes, the whole dry run and the
    autotuner's sweep."""
    import os

    import numpy as np
    import torch

    from repro_torch.analysis import report
    from repro_torch.kernels import ops

    log("phase 15: the entry points and the tools")
    t0 = time.perf_counter()
    TOOLS_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = TOOLS_DIR / "serve_risk_api_trace.jsonl"
    trace_path.unlink(missing_ok=True)
    procs = _cpu_examples()
    try:
        results, examples, launches = {}, {}, {}
        for name, args in EXAMPLE_ARGS.items():
            if name == "serve_risk_api":
                os.environ["REPRO_TRACE_FILE"] = str(trace_path)
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            try:
                results[name] = _example(name).main(["--device", "cuda",
                                                     *args])
            finally:
                os.environ.pop("REPRO_TRACE_FILE", None)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
            counts = ops.launch_counts()
            log(f"  example {name}: {seconds:.2f} s, launches {counts}")
            want = EXAMPLE_KERNELS[name]
            check(all((counts[k] > 0) == (k in want) for k in counts),
                  f"example {name}: launches {counts}, expected > 0 exactly "
                  f"for {want}")
            examples[name] = {"seconds": seconds, "launches": counts}
            launches[f"example {name}"] = counts
        versus = _against_cpu(results, procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    resps = results["serve_risk_api"]
    check(len(resps) == 120 and all(r.ok for r in resps),
          "serve_risk_api: not every request scored")
    table = report.latency_breakdown_table(str(trace_path))
    log(table)
    stages = _latency_rows(table)
    check(stages.get("service.step", 0) >= 1
          and stages.get("service.request") == 120,
          f"serve_risk_api's latency table: {stages}")
    reqs = results["serve_batched"]
    check(len(reqs) == 8 and all(len(r.out) == 12 for r in reqs),
          "serve_batched: not 8 requests of 12 tokens")
    res = results["train_survival_lm"]
    check(len(res.losses) == 20 and bool(np.all(np.isfinite(res.losses))),
          "train_survival_lm: the losses")

    errs = check_example_kernels()
    dry = _dryrun(TOOLS_DIR / "dryrun")
    tuned = _autotune(TOOLS_DIR / "tuned_blocks.json")
    torch.cuda.empty_cache()
    return {"examples": examples, "launches": launches,
            "against_cpu": versus, "latency_stages": stages,
            "errs": errs, "dryrun": dry, "autotune": tuned,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 16: the (data, model) mesh
# ---------------------------------------------------------------------------

def start_mesh_dryrun():
    """The mesh dry run of every cell on the 16 x 16 mesh, in one process
    for each group of MESH_DRYRUN_GROUPS (each makes a fake world of 256
    ranks), with the card hidden: ``fits`` then reads against the data
    sheet's 80 GB. Their output goes to ``MESH_DIR``."""
    import os
    import shutil

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for i, archs in enumerate(MESH_DRYRUN_GROUPS):
        with open(MESH_DIR / f"log{i}.txt", "w") as log_file:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
                 "single", "--arch", ",".join(archs), "--out",
                 str(MESH_DIR / "records")], cwd=str(ROOT), env=env,
                stdout=log_file, stderr=subprocess.STDOUT))
    return procs, time.time()


def _mesh_dryrun(procs, started: float) -> dict:
    """Phase 16 (b): wait for the mesh dry run, check every cell and print
    each one's per-device GB, fits, collective bytes and bottleneck."""
    from repro_torch.analysis import report
    from repro_torch.configs import REGISTRY, SHAPES

    for i, proc in enumerate(procs):
        rc = proc.wait(timeout=max(1.0, MESH_DRYRUN_TIMEOUT
                                   - (time.time() - started)))
        tail = (MESH_DIR / f"log{i}.txt").read_text()[-3000:]
        check(rc == 0, f"the mesh dry run exited {rc}: {tail}")
    # its own seconds: from its start to its last record
    seconds = max(p.stat().st_mtime for p in
                  (MESH_DIR / "records").glob("*.json")) - started
    recs = report.load(str(MESH_DIR / "records"))
    check(len(recs) == len(REGISTRY) * len(SHAPES) == MESH_DRYRUN_CELLS,
          f"the mesh dry run gave {len(recs)} cells")
    cells = {}
    for r in recs:
        check(r["status"] == "ok" or (r["status"] == "skipped"
                                      and r.get("reason")),
              f"mesh dry run {r['arch']} {r['shape']}: {r['status']} "
              f"{r.get('traceback', '')}")
        if r["status"] != "ok":
            cells[f"{r['arch']} {r['shape']}"] = {"skipped": r["reason"]}
            continue
        b, ro = r["bytes"], r["roofline"]
        check(r["mesh"] == "pod16x16" and r["target"] == "H100 x256"
              and b["state"] > 0 and ro["collective_bytes"] > 0,
              f"mesh dry run {r['arch']} {r['shape']}: {r}")
        cells[f"{r['arch']} {r['shape']}"] = {
            "state_gb": b["state"] / 1e9, "fits": r["fits"],
            "collective_gb": ro["collective_bytes"] / 1e9,
            "flops": ro["flops_per_device"], "compute_s": ro["compute_s"],
            "memory_floor_s": ro["memory_s"],
            "collective_s": ro["collective_s"],
            "bottleneck": ro["bottleneck"]}
    for name, c in cells.items():
        if "skipped" in c:
            log(f"  {name} on 16 x 16: {c['skipped']}")
        else:
            log(f"  {name} on 16 x 16: {c['state_gb']:.3f} GB a device, "
                f"fits {c['fits']}, {c['collective_gb']:.3f} GB of "
                f"collectives a device, bottleneck {c['bottleneck']} "
                f"(compute {c['compute_s']:.3e} s, memory floor "
                f"{c['memory_floor_s']:.3e} s, link "
                f"{c['collective_s']:.3e} s)")
    log(report.mesh_table(recs))
    log(f"  mesh dry run: {len(recs)} cells in {seconds:.1f} s in "
        f"{len(procs)} processes (a model of the mesh, not a measurement)")
    return {"seconds": seconds, "cells": cells}


def _sharded_step(mesh, microbatch: int = 0) -> dict:
    """Phase 16 (a), or (c) with ``microbatch``: the train step of
    ``trainer.make_train_step`` with every parameter and moment a DTensor
    on the (1, 1) ``mesh``, against the plain step (microbatched alike)
    from the same state, then seconds a step of each, in turns."""
    import copy

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import TokenTaskStream
    from repro_torch.launch import mesh as mesh_lib, sharding
    from repro_torch.launch.train import build_state
    from repro_torch.models import build_model
    from repro_torch.train import optimizer, trainer

    cfg = get_config(LAUNCH_ARCH).scaled(n_layers=LAUNCH_LAYERS,
                                         vocab_size=4096)
    plain = build_state(build_model(cfg, device="cuda"), "lm",
                        torch.Generator("cuda").manual_seed(SEED + 16))
    state = copy.deepcopy(plain)
    sharding.shard_model(state.model, mesh, "train")
    state.opt = optimizer.init_opt_state(state.model)
    params = dict(state.model.named_parameters())
    check(all(isinstance(p, DTensor) and isinstance(state.opt.m[n], DTensor)
              for n, p in params.items()),
          "a parameter or moment is not a DTensor")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=20,
                       total_steps=LAUNCH_STEPS, microbatch=microbatch)
    stream = TokenTaskStream(cfg.vocab_size, LAUNCH_SEQ, LAUNCH_BATCH,
                             seed=SEED)
    steps = {"plain": trainer.make_train_step(plain.model, tcfg, "lm"),
             "sharded": trainer.make_train_step(state.model, tcfg, "lm")}
    states = {"plain": plain, "sharded": state}

    def step(kind, i):
        with mesh_lib.mesh_context(mesh if kind == "sharded" else None):
            states[kind], metrics = steps[kind](states[kind],
                                                stream.batch_for_step(i))
        return float(metrics["loss"])

    loss = {kind: step(kind, 0) for kind in steps}
    loss_err = abs(loss["sharded"] - loss["plain"]) / abs(loss["plain"])
    lr = float(optimizer.lr_schedule(1, tcfg))
    excess, n_diff = 0.0, 0
    for n, p in states["plain"].model.named_parameters():
        got = states["sharded"].model.get_parameter(n).detach().full_tensor()
        diff = (got.float() - p.detach().float()).abs()
        n_diff += int((diff > 0).sum())
        excess = max(excess, float((diff - 2 * lr - p.detach().float().abs()
                                    * 2.0 ** -7).max()))
    times = {kind: [] for kind in steps}
    for i in range(1, 1 + MESH_TIMED_STEPS):
        for kind in (("plain", "sharded") if i % 2 else ("sharded",
                                                         "plain")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(kind, i)
            times[kind].append(time.perf_counter() - t0)
    s_per_step = {kind: statistics.median(t[1:]) for kind, t in times.items()}
    n_params = sum(p.numel() for p in params.values())
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "microbatch": microbatch,
           "loss_plain": loss["plain"], "loss_sharded": loss["sharded"],
           "loss_rel_err": loss_err, "params_differing": n_diff,
           "param_excess": excess, "s_per_step": s_per_step,
           "dtensor_cost": s_per_step["sharded"] / s_per_step["plain"]}
    what = (f"the sharded step, {microbatch} microbatches of "
            f"{LAUNCH_BATCH // microbatch}," if microbatch
            else "the sharded step")
    log(f"  {what} on a (1, 1) mesh at {cfg.name}'s widths "
        f"({n_params / 1e6:.1f}M parameters, {cfg.n_layers} layers, "
        f"bfloat16, batch {LAUNCH_BATCH} x {LAUNCH_SEQ}): loss "
        f"{loss['sharded']:.6f} against the plain step's "
        f"{loss['plain']:.6f}, rel err {loss_err:.3e} (tol "
        f"{MESH_LOSS_RTOL:.0e}); {n_diff} parameter elements differ after "
        f"the step, max |diff| - 2 lr - |p| 2^-7 = {excess:.3e} (tol 0); "
        f"seconds a step (median of {MESH_TIMED_STEPS - 1} after a warm-up, "
        f"in turns): plain {s_per_step['plain']:.4f}, DTensor "
        f"{s_per_step['sharded']:.4f} ({out['dtensor_cost']:.2f}x)")
    check(loss_err <= MESH_LOSS_RTOL, f"{what}: the loss differs")
    check(excess <= 0.0, f"{what}: the parameters differ by more than two "
          "steps' moves")
    del states, steps, plain, state, params
    torch.cuda.empty_cache()
    return out


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def _decode_turns(models: dict, mesh, prompts) -> dict:
    """Seconds a decode step of each model of ``models`` (plain,
    sharded), in turns: both prefilled again on ``prompts`` with
    room for MESH_TIMED_DECODE more tokens, then one step of each in turn
    on its own greedy token, synchronised; the median after the first."""
    import torch

    from repro_torch.data.pipeline import put_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.pspec import whole

    v = models["plain"].cfg.vocab_size
    run = {}
    for kind, m in models.items():
        where = mesh if kind == "sharded" else "cuda"
        with mesh_lib.mesh_context(mesh if kind == "sharded" else None):
            logits, cache = m.prefill(
                put_batch({"tokens": prompts}, where),
                max_len=MESH_SERVE_PROMPT + MESH_TIMED_DECODE + 1)
        run[kind] = [cache, torch.argmax(logits[:, :v], -1).to(
            torch.int32)]
    times = {kind: [] for kind in models}
    for i in range(MESH_TIMED_DECODE):
        for kind in (("plain", "sharded") if i % 2
                     else ("sharded", "plain")):
            cache, nxt = run[kind]
            with mesh_lib.mesh_context(mesh if kind == "sharded" else None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = models[kind].decode_step(cache, nxt[:, None])
                nxt = torch.argmax(logits[:, :v], -1).to(torch.int32)
                whole(nxt).tolist()
                times[kind].append(time.perf_counter() - t0)
            run[kind] = [cache, nxt]
    return {kind: statistics.median(t[1:]) for kind, t in times.items()}


def _sharded_serve(mesh) -> dict:
    """Phase 16 (d): MESH_SERVE_ARCH at its published widths and depth,
    sharded in serve mode on the (1, 1) ``mesh`` beside the plain model of
    the same weights, both serving the same DECODE_REQUESTS requests
    through ``launch.serve.serve_batch``; then seconds a decode step of
    each, in turns."""
    import copy

    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib, sharding

    cfg = get_config(MESH_SERVE_ARCH)
    check(cfg.dtype == "bfloat16", f"{cfg.name}: {cfg.dtype}")
    plain = _decode_model(cfg)
    model = sharding.shard_model(copy.deepcopy(plain), mesh, "serve")
    check(all(isinstance(p, DTensor) for p in model.parameters()),
          "a parameter of the served model is not a DTensor")
    served = {"plain": _serve_case(plain, MESH_SERVE_PROMPT, MESH_SERVE_NEW,
                                   SEED + 170, profile=False)}
    with mesh_lib.mesh_context(mesh):
        served["sharded"] = _serve_case(model, MESH_SERVE_PROMPT,
                                        MESH_SERVE_NEW, SEED + 170,
                                        profile=False)
    got, want = served["sharded"], served["plain"]
    cache = got["rec"]["cache"]
    check(all(isinstance(t, DTensor) and tuple(t.placements)
              == sharding.cache_spec(n, tuple(t.shape), mesh)
              for n, t in zip(cache._fields, cache)),
          "the served cache is not on cache_spec's placements")
    # call j (0: the prefill) emits token j from inputs that hold tokens
    # 0 .. j-1: the calls up to the first differing token had equal inputs
    differ = np.flatnonzero((got["tokens"] != want["tokens"]).any(0))
    same = int(differ[0]) if len(differ) else MESH_SERVE_NEW
    v = cfg.vocab_size
    errs = [_rel(g[:, :v], w[:, :v]) for g, w in
            zip(got["rec"]["logits"][:same + 1],
                want["rec"]["logits"][:same + 1])]
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "requests": DECODE_REQUESTS, "prompt": MESH_SERVE_PROMPT,
           "new": MESH_SERVE_NEW,
           "tokens_equal": bool(np.array_equal(got["tokens"],
                                               want["tokens"])),
           "calls_compared": len(errs), "worst_call_rel_err": max(errs),
           "prefill_rel_err": errs[0],
           "prefill_s": {"plain": want["out"]["prefill_s"],
                         "sharded": got["out"]["prefill_s"]},
           "served_decode_s_per_step": {
               "plain": want["out"]["decode_s_per_step"],
               "sharded": got["out"]["decode_s_per_step"]}}
    if out["tokens_equal"]:
        out["cache_rel_err"] = {
            n: _rel(a.full_tensor(), b) for n, a, b in zip(
                cache._fields, cache, want["rec"]["cache"])
            if n != "length"}
        check(all(bool((a.full_tensor() == b).all()) for n, a, b in zip(
            cache._fields, cache, want["rec"]["cache"]) if n == "length"),
            "the served caches' lengths differ")
    else:
        # why: the plain logits' top-2 margin where the first token differs
        top2 = want["rec"]["logits"][same][:, :v].topk(2, dim=-1).values
        out["first_differing_step"] = same
        out["plain_top2_margin"] = float((top2[:, 0] - top2[:, 1]).min())
    prompts = want["prompts"]
    del served, got, want, cache
    out["decode_s_per_step"] = _decode_turns(
        {"plain": plain, "sharded": model}, mesh, prompts)
    out["dtensor_cost"] = (out["decode_s_per_step"]["sharded"]
                           / out["decode_s_per_step"]["plain"])
    log(f"  serving on the (1, 1) mesh, {cfg.name} at its published widths "
        f"({cfg.n_layers} layers, bfloat16), {DECODE_REQUESTS} x "
        f"{MESH_SERVE_PROMPT} + {MESH_SERVE_NEW}, the model sharded in serve "
        f"mode against the plain model: greedy tokens "
        + ("equal" if out["tokens_equal"] else
           f"differ from step {same} (the plain logits' top-2 margin there "
           f"{out['plain_top2_margin']:.3e})")
        + f"; worst ||diff|| / ||plain|| of {len(errs)} calls' logits "
        f"{out['worst_call_rel_err']:.3e} (tol {DECODE_BF16_RTOL:.0e})"
        + (f", caches {max(out['cache_rel_err'].values()):.3e}"
           if out["tokens_equal"] else "")
        + f"; prefill s plain {out['prefill_s']['plain']:.4f}, sharded "
        f"{out['prefill_s']['sharded']:.4f}; seconds a decode step (median "
        f"of {MESH_TIMED_DECODE - 1} after a warm-up, in turns): plain "
        f"{out['decode_s_per_step']['plain']:.4f}, DTensor "
        f"{out['decode_s_per_step']['sharded']:.4f} "
        f"({out['dtensor_cost']:.2f}x)")
    check(out["worst_call_rel_err"] <= DECODE_BF16_RTOL,
          f"sharded serving: logits differ by {out['worst_call_rel_err']:.3e}")
    check(all(e <= DECODE_BF16_RTOL
              for e in out.get("cache_rel_err", {}).values()),
          f"sharded serving: caches differ: {out.get('cache_rel_err')}")
    del plain, model
    torch.cuda.empty_cache()
    return out


def mesh_phase() -> dict:
    """Phase 16: the mesh dry run's 40 cells in processes of their own,
    and beside them on a (1, 1) mesh over a one-rank NCCL world the
    sharded train step, the microbatched one and sharded serving, each
    against its plain twin. Only flash_attn runs, in the served prefills
    (qwen2.5-3b's causal bfloat16 attention, once a layer, on the mesh's
    local shards too): the other counts, zeroed before the first and read
    after the last, are 0."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib

    log("phase 16: the (data, model) mesh")
    t0 = time.perf_counter()
    procs, started = start_mesh_dryrun()
    try:
        mesh = mesh_lib.make_host_mesh("cuda")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
              and tuple(mesh.shape) == (1, 1), "not a (1, 1) mesh over a "
              "one-rank NCCL world")
        ops.reset_launch_counts()
        out = {"step": _sharded_step(mesh),
               "microbatched_step": _sharded_step(mesh, MESH_MICROBATCH),
               "serve": _sharded_serve(mesh)}
        out["launches"] = got = ops.launch_counts()
        layers = get_config(MESH_SERVE_ARCH).n_layers
        check(got["flash_attn"] >= 2 * layers
              and got["flash_attn"] % layers == 0
              and not any(n for k, n in got.items() if k != "flash_attn"),
              f"kernels launched on the mesh: {got}")
        dist.destroy_process_group()
        out["dryrun"] = _mesh_dryrun(procs, started)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 7: the streaming fit
# ---------------------------------------------------------------------------

def make_stream_chunks(n: int, p: int, chunk_rows: int, seed: int):
    """Tie-free chunks made on the card, in ascending time by row index:
    x ~ 0.5 N(0, 1), p/8 true coefficients of +/-1, and events with
    probability 0.3 + 0.4 sigmoid(x beta*), as the reference's
    benchmarks/bench_scale.py::SyntheticChunkSource makes them on the
    host (the generators differ, so the numbers do)."""
    import torch

    from repro_torch.core.streaming import Chunk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = max(p // 8, 1)
    beta_star = torch.zeros(p, device="cuda")
    idx = torch.randperm(p, device="cuda", generator=gen)[:k]
    beta_star[idx] = (torch.randint(0, 2, (k,), device="cuda", generator=gen)
                      * 2 - 1).float()
    chunks = []
    for _ in range(n // chunk_rows):
        x = torch.randn(chunk_rows, p, device="cuda", generator=gen) * 0.5
        pr = torch.sigmoid(x @ beta_star)
        u = torch.rand(chunk_rows, device="cuda", generator=gen)
        chunks.append(Chunk(x=x, delta=(u < 0.3 + 0.4 * pr).float()))
    return chunks


def run_stream_fit(chunks, mode: str, epochs: int):
    import torch

    from repro_torch.core import solvers
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solvers.fit_stream(chunks, lam2=STREAM_LAM2, n_epochs=epochs,
                             mode=mode)
    obj = res.objective.cpu().double()
    seconds = time.perf_counter() - t0
    after = ops.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    k, e = len(chunks), res.n_iters
    log(f"  {mode}: {e} epochs in {seconds:.3f} s ({seconds / e:.4f} s per "
        f"epoch, the start objective included); objective "
        f"{obj.tolist()}; launches {launched}")
    check(e == epochs and bool(torch.isfinite(obj).all()),
          f"{mode}: {e} epochs of {epochs}, objective {obj.tolist()}")
    check(bool((obj[1:] <= obj[:-1]).all()),
          f"{mode}: objective rose: {obj.tolist()}")
    if mode == "chunk":
        check(launched["cox_batch"] == k * e,
              f"chunk mode: cox_batch launched {launched['cox_batch']} "
              f"times, expected chunks x epochs = {k * e}")
    else:
        check(launched["revcumsum"] >= k * (1 + 3 * e),
              f"global mode: revcumsum launched {launched['revcumsum']} "
              f"times, expected at least {k * (1 + 3 * e)}")
    return res, seconds / e


def _start_objective(chunks, mode: str) -> float:
    """The plain path's objective at beta = 0."""
    import torch

    from repro_torch.core import streaming

    zero = torch.zeros(chunks[0].x.shape[1], device="cuda")
    return float(streaming.streaming_loss(chunks, zero, use_kernel=False)
                 if mode == "global" else
                 streaming.stratified_loss(chunks, zero))


def _fits_agree(what: str, got, want, f0: float) -> None:
    """``got``'s objective within STREAM_DTOL of ``want``'s first-epoch
    decrease from ``f0``, and its beta within STREAM_BETA_RTOL."""
    wobj = want.objective.cpu().double()
    decrease = f0 - float(wobj[0])
    dobj = float((got.objective.cpu().double() - wobj).abs().max())
    dbeta = float((got.beta - want.beta).abs().max())
    bmax = float(want.beta.abs().max())
    log(f"  {what}: objective {wobj.tolist()} from {f0:.1f}, first-epoch "
        f"decrease {decrease:.3f}; max |objective diff| {dobj:.3f} = "
        f"{dobj / decrease:.3e} of it (tol {STREAM_DTOL:.0e}); max |beta "
        f"diff| {dbeta:.3e} of max |beta| {bmax:.4f} = {dbeta / bmax:.3e} "
        f"(tol {STREAM_BETA_RTOL:.0e})")
    check(decrease > 0 and dobj <= STREAM_DTOL * decrease,
          f"{what}: objectives differ")
    check(dbeta <= STREAM_BETA_RTOL * bmax, f"{what}: betas differ")


def compare_stream_fits(chunks, fits) -> None:
    """The streaming fit's kernel path against its plain path over the
    first STREAM_COMPARE_EPOCHS epochs of each mode. Run after the path's
    launch counts are read: these launches only compare."""
    import torch

    from repro_torch.core import solvers

    log("streaming fit: kernel path against the plain path")
    for mode, main in fits.items():
        kern, plain = (solvers.fit_stream(
            chunks, lam2=STREAM_LAM2, n_epochs=STREAM_COMPARE_EPOCHS,
            mode=mode, use_kernel=use) for use in (True, False))
        same = torch.equal(kern.objective,
                           main.objective[:STREAM_COMPARE_EPOCHS])
        log(f"  {mode}, {STREAM_COMPARE_EPOCHS} epochs: kernel fit repeats "
            f"the main fit's objective bit for bit: {same}")
        check(same, f"{mode}: the kernel fit did not repeat its bits")
        _fits_agree(f"{mode}, kernel path against the plain path", kern,
                    plain, _start_objective(chunks, mode))


def check_host_chunks(chunks) -> None:
    """HOST_CHUNKS chunks held as numpy arrays on the host, moved to the
    card when touched, against the same chunks on the card."""
    import torch

    from repro_torch.core import solvers
    from repro_torch.core.streaming import Chunk

    dev = chunks[:HOST_CHUNKS]
    host = [Chunk(x=c.x.cpu().numpy(), delta=c.delta.cpu().numpy())
            for c in dev]
    for mode in ("global", "chunk"):
        a, b = (solvers.fit_stream(src, lam2=STREAM_LAM2,
                                   n_epochs=STREAM_COMPARE_EPOCHS, mode=mode)
                for src in (host, dev))
        check(a.beta.device.type == "cuda", f"{mode}: host chunks' fit ran "
              f"on {a.beta.device}")
        same = (torch.equal(a.objective, b.objective)
                and torch.equal(a.beta, b.beta))
        log(f"  {mode}, {HOST_CHUNKS} x {STREAM_CHUNK} rows as numpy chunks: "
            f"bit for bit equal to the card's chunks: {same}")
        _fits_agree(f"{mode}, numpy chunks against card chunks", a, b,
                    _start_objective(dev, mode))


def streaming_phase() -> dict:
    """Phase 7; returns seconds and idle shares per epoch by mode."""
    import torch

    from repro_torch.core import solvers
    from repro_torch.kernels import ops

    log("phase 7: streaming fit")
    t0 = time.perf_counter()
    chunks = make_stream_chunks(STREAM_N, P, STREAM_CHUNK, SEED)
    torch.cuda.synchronize()
    events = int(sum(float(c.delta.sum()) for c in chunks))
    log(f"  n={STREAM_N} p={P} in {len(chunks)} chunks of {STREAM_CHUNK} "
        f"rows, {events} events, made on the card in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    ops.reset_launch_counts()
    fits, epoch_s = {}, {}
    for mode in ("global", "chunk"):
        fits[mode], epoch_s[mode] = run_stream_fit(chunks, mode,
                                                   STREAM_EPOCHS)
    launches = ops.launch_counts()
    log(f"  streaming path launches: {launches}")
    for name in ("revcumsum", "cox_batch"):
        check(launches[name] > 0, f"{name} did not launch on the streaming "
              f"path")
    compare_stream_fits(chunks, fits)
    check_host_chunks(chunks)
    idle = {}
    for mode in ("global", "chunk"):
        busy, wall = device_ms(lambda i: solvers.fit_stream(
            chunks, lam2=STREAM_LAM2, n_epochs=1, mode=mode), reps=1)
        idle[mode] = 1 - busy / wall
        log(f"  one {mode} epoch (with its start objective): wall "
            f"{wall / 1e3:.4f} s, device busy {busy / 1e3:.4f} s -> device "
            f"idle {idle[mode]:.1%}")
    log(f"  peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    return {"launches": launches, "epoch_s": epoch_s, "idle": idle}


# ---------------------------------------------------------------------------
# Phase 6: timings at the main path's shapes
# ---------------------------------------------------------------------------

def _bound(nbytes: float, ops: float):
    """(ms, what bounds it): the bytes at the H100's memory rate or the
    float32 operations at its peak outside the tensor cores, the larger."""
    from repro_torch.analysis import roofline as rl

    t_bytes, t_ops = nbytes / rl.HBM_BYTES_PER_S, ops / rl.FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def curve_timings(name: str, kernel, plain, h0, stratified: bool) -> tuple:
    """A curve kernel at every scored batch size: its CUDA-events median and
    device time a call, beside a device fill_ of the same (b, g) panel (the
    bytes the kernel writes, once) and the bound. Returns the largest
    batch's (kernel, plain version, bound), as timings() keeps them."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(6)
    s, g = h0.shape if stratified else (1, h0.shape[0])
    for b in BATCHES:
        args = (torch.randn(b, device="cuda", generator=gen), h0)
        if stratified:
            args += (torch.randint(0, s, (b,), device="cuda", generator=gen,
                                   dtype=torch.int32),)
        ms, dev = kernel_ms(lambda i: kernel(*args), reps=200)
        panel = torch.empty(b, g, device="cuda")
        fill = device_ms(lambda i: panel.fill_(0.5), reps=200)[0]
        bound = _bound(4.0 * ((2 if stratified else 1) * b + s * g + b * g),
                       3.0 * b * g)
        log(f"  {name} b={b}: median {ms * 1e3:.2f} us a call by CUDA "
            f"events, device time {dev * 1e3:.3f} us; device fill_ of the "
            f"({b}, {g}) panel {fill * 1e3:.3f} us; bound "
            f"{bound[0] * 1e3:.3f} us by {bound[1]}")
    return (ms, dev), kernel_ms(lambda i: plain(*args), reps=200), bound


def wrapper_overhead_us(data, groups, reps: int = 2000) -> float:
    """Host microseconds a cox_coord call spends in its wrapper's argument
    checks, library lookup and dispatch counter, without launching."""
    from repro_torch.kernels import _build, ops

    args = {"eta": data.delta, "x": data.xT[0], "delta": data.delta,
            "risk_start": data.risk_start, "group_events": groups}
    shapes = dict.fromkeys(args, (data.n,))
    dtypes = {name: t.dtype for name, t in args.items()}
    t0 = time.perf_counter()
    for _ in range(reps):
        _build.require("cox_coord", args, shapes, dtypes)
        _build.library()
        ops._count("cox_coord", data.delta)
    return (time.perf_counter() - t0) / reps * 1e6


def timings(state) -> dict:
    import torch

    from repro_torch.core import solvers
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.cox_coord import cox_coord
    from repro_torch.kernels.lipschitz import lipschitz
    from repro_torch.kernels.survival_curves import survival_curves

    data, engine = state["data"], state["engine"]
    n, p = data.n, data.p
    eta = data.x @ torch.as_tensor(state["model"].beta, device="cuda")
    rows = data.xT
    groups = ops.group_events(data.delta, data.risk_start)
    out = {}

    # cox_coord, as CD calls it: a new feature row each call (cold in L2)
    out["cox_coord"] = (
        kernel_ms(lambda i: cox_coord(eta, rows[i % p], data.delta,
                                      data.risk_start, group_events=groups),
                  reps=200),
        kernel_ms(lambda i: ref.cox_coord_ref(eta, rows[i % p], data.delta,
                                              data.risk_start), reps=50),
        _bound(16.0 * n + 12, 20.0 * n))
    # lipschitz as the fit calls it, given the group counts made once per
    # fit: the kernel reads x and those counts
    out["lipschitz"] = (
        kernel_ms(lambda i: lipschitz(data.x, data.delta, data.risk_start,
                                      group_events=groups), reps=10),
        kernel_ms(lambda i: ref.lipschitz_ref(data.x, data.delta,
                                              data.risk_start),
                  reps=1, rounds=3),
        _bound(4.0 * n * p + 4.0 * n + 8.0 * p, 8.0 * n * p))
    quarter = _risk_start(n, "quarter",
                          torch.Generator(device="cuda").manual_seed(2))
    q_groups = ops.group_events(data.delta, quarter)
    q_ms = events_ms(lambda i: lipschitz(data.x, data.delta, quarter,
                                         q_groups), 3)
    d_ms = events_ms(lambda i: ops.group_events(data.delta, quarter), 20)
    log(f"  lipschitz with the last quarter of the rows in one tie group: "
        f"{q_ms:.4f} ms a call by CUDA events; making the fit's group "
        f"counts (ops.group_events), once per fit: {d_ms:.4f} ms")
    out["survival_curves"] = curve_timings(
        "survival_curves", survival_curves, ref.survival_curves_ref,
        engine._h0[0], stratified=False)
    log(f"  cox_coord wrapper checks and counters: "
        f"{wrapper_overhead_us(data, groups):.2f} us of host time a call")
    for method in ("cd_quad", "cd_cubic"):
        busy, wall = device_ms(lambda i: solvers.fit_cd(
            data, lam1=state["lam1"], lam2=state["lam2"], n_iters=1,
            method=method), reps=1)
        log(f"  one {method} sweep: wall {wall / 1e3:.4f} s, device busy "
            f"{busy / 1e3:.4f} s -> device idle {1 - busy / wall:.1%}")
    for name, ((ms, dev), (plain, plain_dev), (bound, by)) in out.items():
        log(f"  {name}: median {ms * 1e3:.2f} us a call by CUDA events, "
            f"device time {dev * 1e3:.2f} us; plain version "
            f"{plain * 1e3:.2f} us, device {plain_dev * 1e3:.2f} us; bound "
            f"{bound * 1e3:.2f} us by {by} (3.35 TB/s) -> device time at "
            f"{bound / dev:.1%} of bound")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the second slice's kernels at their paths' shapes
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, h, hd, g, n, seed=0):
    """x, B and C as strided views of one bfloat16 (B, S, channels) conv
    output, as the mixer hands them over; dt as softplus gives it, A as
    the mixer's a_log makes it, D near 1."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn(b, s, h * hd + 2 * g * n, device="cuda",
                      generator=gen).to(torch.bfloat16)
    xh = xbc[..., :h * hd].reshape(b, s, h, hd)
    bb, cc = xbc[..., h * hd:h * hd + g * n], xbc[..., h * hd + g * n:]
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, device="cuda", generator=gen) - 1.0)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    d_skip = 1.0 + 0.1 * torch.randn(h, device="cuda", generator=gen)
    return xh, dt, a, bb, cc, d_skip


def check_ssd_scan() -> float:
    """ssd_scan against its plain version (``ref.ssd_scan_ref``) on the
    card (TF32 off) at the featurize cells' shapes, a ragged S and the
    other instantiated shapes: y within SSD_ATOL beyond its bfloat16
    rounding, the final state within SSD_STATE_TOL, the same bits twice;
    then one call's launch shape. Returns the largest |y - plain y| (both
    bfloat16)."""
    import torch

    from repro_torch.kernels import ops, ref, ssd_scan

    worst = 0.0
    for b, s, h, hd, g, n, q in (*SSD_CELLS.values(), *SSD_CHECKS):
        args = _ssd_inputs(b, s, h, hd, g, n)
        y, st = ops.ssd_scan(*args, q, g, return_state=True)
        y2, st2 = ops.ssd_scan(*args, q, g, return_state=True)
        same = torch.equal(y, y2) and torch.equal(st, st2)
        xh, dt, a, bb, cc, d_skip = args
        # given float32 x, B and C the plain version keeps y unrounded
        y32, st32 = ref.ssd_scan_ref(xh.float(), dt, a, bb.float(),
                                     cc.float(), d_skip, q, g)
        scale = float(y32.abs().max())
        y_err = float(((y.float() - y32).abs() - 2.0 ** -8 * y32.abs()).max())
        st_err = float((st - st32).abs().max() / st32.abs().max())
        plain_err = float((y.float() - y32.to(y.dtype).float()).abs().max())
        flips = float((y != y32.to(y.dtype)).float().mean())
        worst = max(worst, plain_err)
        log(f"  ssd_scan at (B, S, H, hd, G, N, Q) = {(b, s, h, hd, g, n, q)}"
            f": |y - y32| beyond 2^-8 |y32| {y_err / scale:.3e} of max |y| "
            f"(tol {SSD_ATOL:.0e}); state {st_err:.3e} of its max (tol "
            f"{SSD_STATE_TOL:.0e}); |y - plain y| max {plain_err:.3e}, "
            f"{flips:.3%} of values another bfloat16; same bits twice: "
            f"{same}")
        check(y_err <= SSD_ATOL * scale and st_err <= SSD_STATE_TOL and same,
              f"ssd_scan at {(b, s, h, hd, g, n, q)}")
        del args, y, y2, st, st2, y32, st32
    args = _ssd_inputs(*SSD_CHECKS[0][:6])
    check_launch_shape("ssd_scan", lambda: ops.ssd_scan(
        *args, SSD_CHECKS[0][6], SSD_CHECKS[0][4]),
        ssd_scan.KERNELS_PER_CALL, "ssd_scan")
    torch.cuda.empty_cache()
    return worst


def ssd_timings() -> dict:
    """ssd_scan at both featurize cells' shapes: its CUDA-events median and
    device time a call, the plain version's, and its bound (x, B, C and dt
    read and y written once at 3.35 TB/s, or the chunked form's products,
    C B^T, the masked intra-chunk product, the chunk states and the
    read-out, at the bfloat16 tensor-core rate it uses, the larger).
    ``times`` is the mamba2 cell's, as timings() gives them."""
    import torch

    from repro_torch.analysis import roofline as rl
    from repro_torch.kernels import ops, ref

    cells = {}
    for cell, (b, s, h, hd, g, n, q) in SSD_CELLS.items():
        args = _ssd_inputs(b, s, h, hd, g, n)
        nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * g * n) + 4 * b * s * h
        flops = b * h * -(-s // q) * (2 * q * q * (n + hd) + 4 * q * hd * n)
        t_bytes, t_ops = nbytes / rl.HBM_BYTES_PER_S, flops / BF16_PEAK
        bound = (max(t_bytes, t_ops) * 1e3,
                 "bytes" if t_bytes >= t_ops else "operations")
        with torch.no_grad():
            kern = kernel_ms(lambda i: ops.ssd_scan(*args, q, g), reps=20)
            plain = kernel_ms(lambda i: ref.ssd_scan_ref(*args, q, g),
                              reps=2, rounds=3)
        cells[cell] = {"shape": [b, s, h, hd, g, n, q], "ms": kern[0],
                       "device_ms": kern[1], "plain_ms": plain[0],
                       "plain_device_ms": plain[1], "bound_ms": bound[0],
                       "bound_by": bound[1], "bytes": nbytes, "flops": flops}
        log(f"  ssd_scan at {cell}'s shape {(b, s, h, hd, g, n, q)}: median "
            f"{kern[0]:.4f} ms a call by CUDA events, device time "
            f"{kern[1]:.4f} ms; plain version {plain[0]:.3f} ms, device "
            f"{plain[1]:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
            f"({nbytes / 1e6:.0f} MB at 3.35 TB/s, {flops / 1e9:.0f} GFLOP at "
            f"989 TFLOP/s) -> device time at {bound[0] / kern[1]:.1%} of "
            f"bound")
        if cell == "mamba2-featurize-512":
            times = (kern, plain, bound)
        del args
        torch.cuda.empty_cache()
    return {"times": times, "cells": cells}


def _fa_inputs(b, s, h, kh, hd, seed=0):
    """q (B, S, H, hd) and k, v (B, S, KH, hd) bfloat16 on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(b, s, n, hd, device="cuda", generator=gen)
                 .to(torch.bfloat16) for n in (h, kh, kh))


def check_flash_attn() -> float:
    """flash_attn against its plain version (``ref.flash_attention_ref``)
    given the same values in float32 (TF32 off), at Nemotron-H's attention
    shape, ragged S, G = 1, 4, 16 and both head dims: o within FA_ATOL
    beyond its bfloat16 rounding, the same bits twice; then one call's
    launch shape. Returns the largest |o - plain o| (both bfloat16)."""
    import torch

    from repro_torch.kernels import flash_attn, ops, ref

    worst = 0.0
    for b, s, h, kh, hd in (FA_CELL, *FA_CHECKS):
        q, k, v = _fa_inputs(b, s, h, kh, hd)
        with torch.no_grad():
            o = ops.flash_attn(q, k, v)
            same = torch.equal(o, ops.flash_attn(q, k, v))
            o32 = ref.flash_attention_ref(q.float(), k.float(), v.float())
        vmax = float(v.float().abs().max())
        err = float(((o.float() - o32).abs() - 2.0 ** -8 * o32.abs()).max())
        plain_err = float((o.float() - o32.to(o.dtype).float()).abs().max())
        flips = float((o != o32.to(o.dtype)).float().mean())
        worst = max(worst, plain_err)
        log(f"  flash_attn at (B, S, H, KH, hd) = {(b, s, h, kh, hd)}: "
            f"|o - o32| beyond 2^-8 |o32| {err / vmax:.3e} of max |v| (tol "
            f"{FA_ATOL:.2e}); |o - plain o| max {plain_err:.3e}, "
            f"{flips:.3%} of values another bfloat16; same bits twice: "
            f"{same}")
        check(err <= FA_ATOL * vmax and same,
              f"flash_attn at {(b, s, h, kh, hd)}")
        del q, k, v, o, o32
    q, k, v = _fa_inputs(*FA_CHECKS[0])
    check_launch_shape("flash_attn", lambda: ops.flash_attn(q, k, v),
                       flash_attn.KERNELS_PER_CALL, "flash_attn")
    torch.cuda.empty_cache()
    return worst


def flash_attn_timings() -> dict:
    """flash_attn at Nemotron-H's attention shape: its CUDA-events median
    and device time a call, the plain version's, and its bound (the causal
    q k^T and P v, 2 H hd (S + 1) operations a token at the bfloat16
    tensor-core rate, or q, k, v and o moved once at 3.35 TB/s, the
    larger); ``library_ms`` is one call of ``scaled_dot_product_attention``
    on the same tensors, a yardstick the port never calls."""
    import torch
    import torch.nn.functional as F

    from repro_torch.analysis import roofline as rl
    from repro_torch.kernels import ops, ref

    b, s, h, kh, hd = FA_CELL
    q, k, v = _fa_inputs(b, s, h, kh, hd)
    nbytes = 2 * b * s * hd * (2 * h + 2 * kh)
    flops = 2 * h * hd * (s + 1) * b * s
    t_bytes, t_ops = nbytes / rl.HBM_BYTES_PER_S, flops / BF16_PEAK
    bound = (max(t_bytes, t_ops) * 1e3,
             "bytes" if t_bytes >= t_ops else "operations")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        kern = kernel_ms(lambda i: ops.flash_attn(q, k, v), reps=20)
        plain = kernel_ms(lambda i: ref.flash_attention_ref(q, k, v),
                          reps=2, rounds=3)
        library = events_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=20)
    log(f"  flash_attn at Nemotron-H's attention shape {FA_CELL}: median "
        f"{kern[0]:.4f} ms a call by CUDA events, device time "
        f"{kern[1]:.4f} ms; plain version {plain[0]:.3f} ms, device "
        f"{plain[1]:.3f} ms; scaled_dot_product_attention (yardstick) "
        f"{library:.4f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
        f"({nbytes / 1e6:.0f} MB at 3.35 TB/s, {flops / 1e9:.1f} GFLOP at 989 "
        f"TFLOP/s) -> the events median at {bound[0] / kern[0]:.1%} of "
        f"bound (the profiler's device time reads low, as for ssd_scan)")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"times": (kern, plain, bound), "library_ms": library,
            "shape": list(FA_CELL), "bytes": nbytes, "flops": flops}


def stream_timings(strat_h0) -> tuple:
    """(times as timings() gives them, library-call ms) of revcumsum and
    cox_batch at one streaming chunk's panel and of the stratified curves
    at every scored batch size (the largest kept)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.cox_batch import cox_batch
    from repro_torch.kernels.revcumsum import revcumsum
    from repro_torch.kernels.survival_curves import \
        survival_curves_stratified

    gen = torch.Generator(device="cuda").manual_seed(4)
    n, p = STREAM_CHUNK, P
    x = torch.randn(n, p, device="cuda", generator=gen) * 0.5
    eta = torch.randn(n, device="cuda", generator=gen) * 0.5
    d = (torch.rand(n, device="cuda", generator=gen) < 0.5).float()
    vecs = batch_vectors(eta, d)
    w = vecs[0]
    out, library = {}, {}
    # revcumsum as global mode calls it on the (chunk_rows, p) panel w x;
    # torch.cumsum along rows is the one library call that does the scan
    out["revcumsum"] = (
        kernel_ms(lambda i: revcumsum(x), reps=50),
        kernel_ms(lambda i: ref.revcumsum_ref(x), reps=20),
        _bound(8.0 * n * p, 1.0 * n * p))
    library["revcumsum"] = events_ms(lambda i: torch.cumsum(x, 0), reps=50)
    vec_ms = kernel_ms(lambda i: revcumsum(w), reps=200)
    vec_bound, _ = _bound(8.0 * n, 1.0 * n)
    log(f"  revcumsum on the (chunk_rows,) = ({n},) hazard vector: median "
        f"{vec_ms[0] * 1e3:.2f} us by CUDA events, device time "
        f"{vec_ms[1] * 1e3:.2f} us; bound {vec_bound * 1e3:.3f} us")
    x16 = x.to(torch.bfloat16)
    bf16_ms = kernel_ms(lambda i: revcumsum(x16), reps=50)
    copy_ms = kernel_ms(lambda i: x.clone(), reps=50)
    log(f"  revcumsum on the panel in bfloat16: median "
        f"{bf16_ms[0] * 1e3:.2f} us, device time {bf16_ms[1] * 1e3:.2f} us; "
        f"bound {_bound(4.0 * n * p, 1.0 * n * p)[0] * 1e3:.2f} us. A device "
        f"copy of the float32 panel (x.clone(), the bytes the scan must "
        f"move): device time {copy_ms[1] * 1e3:.2f} us")
    del x16
    out["cox_batch"] = (
        kernel_ms(lambda i: cox_batch(x, *vecs), reps=50),
        kernel_ms(lambda i: ref.cox_batch_ref(x, *vecs), reps=20),
        _bound(4.0 * n * p + 20.0 * n + 8.0 * p, 11.0 * n * p))
    library["cox_batch"] = None
    out["survival_curves_stratified"] = curve_timings(
        "survival_curves_stratified", survival_curves_stratified,
        ref.survival_curves_stratified_ref, strat_h0, stratified=True)
    library["survival_curves_stratified"] = None
    for name, ((ms, dev), (plain, plain_dev), (bound, by)) in out.items():
        lib_ms = library[name]
        log(f"  {name}: median {ms * 1e3:.2f} us a call by CUDA events, "
            f"device time {dev * 1e3:.2f} us; plain version "
            f"{plain * 1e3:.2f} us, device {plain_dev * 1e3:.2f} us; "
            + (f"torch.cumsum {lib_ms * 1e3:.2f} us; " if lib_ms else "")
            + f"bound {bound * 1e3:.2f} us by {by} (3.35 TB/s, 67 TFLOP/s) "
            f"-> device time at {bound / dev:.1%} of bound")
    return out, library


# ---------------------------------------------------------------------------
# Phases 9-10: sparse selection, the regularization path and the baselines
# ---------------------------------------------------------------------------

def _timed(fn):
    """(fn(), seconds), the device synchronised at both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _launched(fn):
    """(fn(), seconds, launches): the counts zeroed just before the call
    and read just after it."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out, seconds = _timed(fn)
    return out, seconds, ops.launch_counts()


def _check_counts(what: str, got: dict, want: dict) -> None:
    """Every kernel's launches exactly as ``want`` says (0 where it says
    nothing)."""
    want = {name: want.get(name, 0) for name in got}
    log(f"  {what} launches: {got} (expected {want})")
    check(got == want, f"{what}: launches {got}, expected {want}")


def _selection_result(what: str, res, k: int, beta_star,
                      seconds: str) -> float:
    """Checks a BeamResult (k sizes, losses not rising, betas finite) and
    logs it with ``seconds``; returns its support F1 against beta*."""
    import numpy as np

    from repro_torch.survival import metrics

    losses = np.asarray(res.losses)
    check(len(res.supports) == k and [len(s) for s in res.supports]
          == list(range(1, k + 1)), f"{what}: supports {res.supports}")
    check(bool(np.all(np.isfinite(losses)))
          and all(bool(np.all(np.isfinite(b))) for b in res.betas),
          f"{what}: a loss or beta is not finite")
    check(bool(np.all(np.diff(losses) <= MONO_RTOL * np.abs(losses[:-1]))),
          f"{what}: a loss rose with the support's size: {losses.tolist()}")
    _, _, f1 = metrics.support_f1(beta_star, res.betas[-1])
    log(f"  {what}: support {res.supports[-1].tolist()}, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, support F1 against beta* "
        f"{f1:.3f}; {seconds}")
    return f1


def _beam_spans(path: Path) -> tuple:
    """(seconds, candidates, beams scored) per support size, from the
    ``beam.size`` and ``beam.score`` spans that ``beam_search`` recorded."""
    from repro_torch.obs import events

    spans = [r for r in events.read_jsonl(str(path)) if r["kind"] == "span"]
    sizes = sorted((r for r in spans if r["name"] == "beam.size"),
                   key=lambda r: r["attrs"]["size"])
    scores = [r["attrs"]["n_beams"] for r in spans
              if r["name"] == "beam.score"]
    return ([r["dur_s"] for r in sizes],
            [r["attrs"]["n_candidates"] for r in sizes], scores)


def compare_selection(data, what: str = "selection",
                      params=SELECT_COMPARE) -> None:
    """The selection path's kernel route against its plain route with
    ``beam_search(**params)``. Run after the path's counts are read: these
    launches only compare."""
    import numpy as np
    import torch

    from repro_torch.core import beam, cox

    log(f"{what}: kernel path against the plain path ({params})")
    kern, again, plain = (beam.beam_search(data, use_kernel=use, **params)
                          for use in (True, True, False))
    same = (kern.losses == again.losses and all(
        np.array_equal(a, b) for a, b in zip(kern.betas, again.betas)))
    check(same, f"{what}: the kernel path did not repeat its bits")
    zero = torch.zeros(data.n, device=data.device)
    prev = float(cox.loss_from_eta(data, zero))
    for size, (ks, ps, kl, pl) in enumerate(zip(
            kern.supports, plain.supports, kern.losses, plain.losses), 1):
        decrease = prev - pl
        log(f"  size {size}: kernel support {ks.tolist()}, plain "
            f"{ps.tolist()}; loss {kl:.4f} against {pl:.4f}, |diff| "
            f"{abs(kl - pl):.4f} = {abs(kl - pl) / decrease:.3e} of the "
            f"size's decrease {decrease:.4f} (tol {SELECT_DTOL:.0e}); "
            f"a second kernel run repeats the bits: {same}")
        check(np.array_equal(ks, ps), f"{what} size {size}: supports "
              f"differ")
        check(decrease > 0 and abs(kl - pl) <= SELECT_DTOL * decrease,
              f"{what} size {size}: losses differ")
        prev = pl


def selection_phase(data, beta_star) -> dict:
    """Phase 9; returns the launches of both calls, the seconds per
    support size and the device's idle share over one scored beam and one
    finetune."""
    import numpy as np
    import torch

    from repro_torch.core import beam
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.revcumsum import revcumsum
    from repro_torch.obs import trace

    log("phase 9: sparse selection")
    blocks = beam.column_blocks(data.n, data.p, data.x.element_size())
    log(f"  beam_search {SELECT}; score_candidates walks "
        f"{len(blocks)} column blocks of "
        f"{[b.stop - b.start for b in blocks]} columns")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        spans = Path(tmp) / "trace.jsonl"
        trace.configure(str(spans))
        try:
            res, seconds, launches = _launched(
                lambda: beam.beam_search(data, **SELECT))
        finally:
            trace.configure(None)
        size_s, candidates, scored = _beam_spans(spans)
    k, sweeps = SELECT["k"], SELECT["finetune_sweeps"]
    check(len(size_s) == len(candidates) == len(scored) == k,
          f"beam spans: {len(size_s)} sizes, {len(scored)} scores")
    log(f"  beam_search: {seconds:.2f} s; candidates per size {candidates}, "
        f"beams scored per size {scored}")
    f1 = {"beam_search": _selection_result(
        "beam_search", res, k, beta_star, "seconds per support size "
        + ", ".join(f"{s:.2f}" for s in size_s))}
    _check_counts("beam_search", launches, {
        "cox_coord": sweeps * sum(size * c for size, c in
                                  enumerate(candidates, 1)),
        "lipschitz": 1,
        "revcumsum": sum(scored) * (2 * SELECT["score_steps"] + 1)
        * len(blocks)})
    out = {"launches": {"beam_search": launches}, "size_s": size_s}

    omp, omp_s, launches = _launched(lambda: beam.omp_greedy(
        data, k, lam2=SELECT["lam2"], finetune_sweeps=sweeps))
    f1["omp_greedy"] = _selection_result(
        "omp_greedy", omp, k, beta_star, f"{omp_s:.2f} s for {k} sizes, "
        f"{omp_s / k:.3f} s a size on average")
    _check_counts("omp_greedy", launches, {
        "cox_coord": sweeps * k * (k + 1) // 2, "lipschitz": k})
    out["launches"]["omp_greedy"] = launches
    check(res.losses[-1] <= omp.losses[-1]
          + MONO_RTOL * abs(omp.losses[-1]),
          f"beam's loss {res.losses[-1]} above OMP's {omp.losses[-1]}")
    log(f"  last loss: beam {res.losses[-1]:.4f}, OMP {omp.losses[-1]:.4f};"
        f" support F1 against beta*: {f1}")
    out["f1"] = f1

    # B1 at one column block of the selection path, beside its bound
    n, m = data.n, blocks[0].stop - blocks[0].start
    gen = torch.Generator(device="cuda").manual_seed(9)
    panel = torch.randn(n, m, device="cuda", generator=gen)
    ms, dev = kernel_ms(lambda i: revcumsum(panel), reps=50)
    plain = kernel_ms(lambda i: ref.revcumsum_ref(panel), reps=10)
    library = events_ms(lambda i: torch.cumsum(panel, 0), reps=10)
    bound, by = _bound(8.0 * n * m, 1.0 * n * m)
    log(f"  revcumsum at ({n}, {m}): median {ms * 1e3:.2f} us by CUDA "
        f"events, device time {dev * 1e3:.2f} us; plain version "
        f"{plain[0] * 1e3:.2f} us, torch.cumsum {library * 1e3:.2f} us; "
        f"bound {bound * 1e3:.2f} us by {by} -> device time at "
        f"{bound / dev:.1%} of bound")
    out["revcumsum_at_block"] = {"shape": [n, m], "ms": ms, "device_ms": dev,
                                 "plain_ms": plain[0], "library_ms": library,
                                 "bound_ms": bound, "bound_by": by}
    del panel

    # where a support size's time goes: one scored beam and one finetune
    # of a k-column support, each profiled for the device's idle share
    groups = ops.group_events(data.delta, data.risk_start)
    l2c, _ = ops.lipschitz_constants(data.x, data.delta, data.risk_start,
                                     groups)
    mask = np.zeros(data.p, dtype=bool)
    mask[res.supports[-2]] = True
    eta = torch.zeros(data.n, device="cuda")
    support = res.supports[-1].astype(np.int32)
    parts = {
        "score_candidates (one beam)": lambda i: beam.score_candidates(
            data, eta, l2c, SELECT["lam2"], mask,
            steps=SELECT["score_steps"]),
        f"finetune (one support of {k})": lambda i: beam.finetune(
            data, support, np.ones(k, np.float32), SELECT["lam2"], k,
            n_sweeps=sweeps, groups=groups)}
    out["idle"] = {}
    for what, fn in parts.items():
        busy, wall = device_ms(fn, reps=1)
        out["idle"][what] = 1 - busy / wall
        log(f"  {what}: wall {wall / 1e3:.4f} s, device busy "
            f"{busy / 1e3:.4f} s -> device idle {1 - busy / wall:.1%}")
    compare_selection(data)
    return out


def _per_iteration(name: str, fit, iters: int, seconds: float) -> dict:
    """Seconds per iteration of a run of ``iters``, and the device's idle
    share over one more iteration (``fit(1)``), profiled."""
    busy, wall = device_ms(lambda i: fit(1), reps=1)
    idle = 1 - busy / wall
    log(f"  {name}: {seconds / iters:.4f} s per iteration over {iters}; "
        f"one iteration: wall {wall / 1e3:.4f} s, device busy "
        f"{busy / 1e3:.4f} s -> device idle {idle:.1%}")
    return {"s_per_iter": seconds / iters, "idle": idle}


def _monotone(what: str, objective, strict_end: bool = False) -> None:
    import torch

    obj = objective.cpu().double()
    log(f"  {what}: objective {obj.tolist()}")
    check(bool(torch.isfinite(obj).all()), f"{what}: objective not finite")
    check(bool((obj[1:] - obj[:-1] <= MONO_RTOL * obj[:-1].abs()).all()),
          f"{what}: objective rose")
    if strict_end:
        check(bool(obj[-1] < obj[0]), f"{what}: objective did not decrease")


def baselines_phase(data, lam1: float, lam2: float) -> dict:
    """Phase 10; returns the launches and, per step, seconds per iteration
    and the device's idle share."""
    import numpy as np

    from repro_torch.core import path, solvers
    from repro_torch.kernels import ops

    log("phase 10: regularization path and baselines")
    lmax = path.lambda_max(data)
    pen_lam1 = 0.4 * lmax
    fits = {
        "l1_path": (PATH_LAMBDAS, lambda it: path.l1_path(
            data, n_lambdas=it, lambda_min_ratio=PATH_RATIO,
            n_iters=PATH_SWEEPS)),
        "fit_newton (line search)": (NEWTON_ITERS, lambda it:
                                     solvers.fit_newton(
                                         data, lam2=1.0, n_iters=it,
                                         line_search=True)),
        **{f"fit_working_newton ({v})": (WORKING_ITERS, lambda it, v=v:
                                         solvers.fit_working_newton(
                                             data, lam1, lam2, n_iters=it,
                                             variant=v, inner_sweeps=1))
           for v in ("quasi", "prox")},
        "fit_gd": (GD_ITERS, lambda it: solvers.fit_gd(
            data, lam1, lam2, n_iters=it)),
        **{f"fit_cd_penalized ({pen})": (PENALIZED_SWEEPS, lambda it,
                                         pen=pen: solvers.fit_cd_penalized(
                                             data, penalty=pen,
                                             lam1=pen_lam1, n_iters=it))
           for pen in ("scad", "mcp")},
    }
    log(f"  lambda_max {lmax:.4f}; lam1 {lam1:.4f}, lam2 {lam2} for the "
        f"working-Newton and GD fits, lam1 {pen_lam1:.4f} for SCAD / MCP")
    ops.reset_launch_counts()
    results, seconds = {}, {}
    for name, (iters, fit) in fits.items():
        results[name], seconds[name] = _timed(lambda: fit(iters))
    launches = ops.launch_counts()
    pr = results["l1_path"]
    log(f"  l1_path: lambdas {np.round(pr.lambdas, 4).tolist()}, support "
        f"sizes {pr.support_sizes.tolist()}, losses {pr.losses.tolist()}")
    check(pr.support_sizes[0] <= 1 and pr.support_sizes[-1]
          >= pr.support_sizes[0] and bool(np.all(np.isfinite(pr.losses))),
          "l1_path: supports or losses")
    _monotone("fit_newton (line search)",
              results["fit_newton (line search)"].objective)
    for v in ("quasi", "prox"):
        name = f"fit_working_newton ({v})"
        obj = results[name].objective.cpu().double()
        log(f"  {name}: objective {obj.tolist()}")
        check(bool(obj.isfinite().all()), f"{name}: objective not finite")
    _monotone("fit_gd", results["fit_gd"].objective, strict_end=True)
    for pen in ("scad", "mcp"):
        _monotone(f"fit_cd_penalized ({pen})",
                  results[f"fit_cd_penalized ({pen})"].objective)
    _check_counts("path and baselines", launches, {
        "cox_coord": data.p * (PATH_LAMBDAS * PATH_SWEEPS
                               + 2 * PENALIZED_SWEEPS),
        "lipschitz": PATH_LAMBDAS + 1 + 2})
    steps = {name: _per_iteration(name, fit, iters, seconds[name])
             for name, (iters, fit) in fits.items()}
    steps["l1_path"]["unit"] = f"lambda of {PATH_SWEEPS} sweeps"
    return {"launches": launches, "steps": steps}


# ---------------------------------------------------------------------------

def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: no src/repro_torch beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import convert
    from repro_torch.data.synthetic import (SyntheticSpec,
                                            make_correlated_survival)
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
    log("phase 1: device")
    smi = nvidia_smi()
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    _build.library()
    log(f"  built the kernels in {_build.build_seconds:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or line.startswith("=="):
            log("   " + line.strip())

    log("phase 2: kernels against their plain versions")
    errs = check_kernels()
    errs["cox_coord"] = max(errs["cox_coord"], check_coord_candidates())
    stream_errs = check_stream_kernels()
    errs.update(stream_errs["float32"])
    errs_bf16 = stream_errs["bfloat16"]
    batch_errs = check_cox_batch()
    errs["cox_batch"] = batch_errs["float32"]
    errs_bf16["cox_batch"] = batch_errs["bfloat16"]
    errs["lipschitz"] = max(check_lipschitz(), check_lipschitz(
        ns=(DEEP_N, TRAIN_N), ps=tuple(range(1, DEEP_K + 1)) + (DEEP_D,),
        launch_shape=False))
    errs["revcumsum"] = max(errs["revcumsum"], check_selection_scans(
        selection_scan_shapes()))
    errs["ssd_scan"] = check_ssd_scan()
    errs["flash_attn"] = check_flash_attn()

    t0 = time.perf_counter()
    x, t, delta, beta_star = make_correlated_survival(
        SyntheticSpec(n=N, p=P, k=K, rho=RHO, seed=SEED))
    log(f"  Appendix-C data made in {time.perf_counter() - t0:.1f} s")
    launches = {}
    ops.reset_launch_counts()
    state = main_path(x, t, delta)
    launches["fit and serve"] = ops.launch_counts()
    log(f"  main path launches: {launches['fit and serve']}")
    for name in ("cox_coord", "lipschitz", "survival_curves"):
        check(launches["fit and serve"][name] > 0,
              f"{name} did not launch on the main path")
    compare_fits(state["data"], state["lam1"], state["lam2"], state["fits"])

    ops.reset_launch_counts()
    strat = stratified_scoring(x, t, delta,
                               state["fits"]["cd_quad"].beta.cpu().numpy())
    launches["stratified scoring"] = ops.launch_counts()
    log(f"  stratified scoring launches: {launches['stratified scoring']}")
    check(launches["stratified scoring"]["survival_curves_stratified"] > 0,
          "survival_curves_stratified did not launch on the stratified path")

    serve = serving_phase(state["model"], strat["model"], x, t, delta)
    launches.update(serve["launches"])

    log("phase 6: timings of the first slice's kernels")
    times = timings(state)
    library = dict.fromkeys(times)
    log(f"  seconds per CD sweep: cd_quad {state['quad_sweep_s']:.4f}, "
        f"cd_cubic {state['cubic_sweep_s']:.4f}; seconds per scored batch: "
        + ", ".join(f"b={b} {s:.6f}" for b, s in state["batch_s"].items()))
    lam1, lam2 = state["lam1"], state["lam2"]
    del state
    torch.cuda.empty_cache()

    stream = streaming_phase()
    launches["streaming fit"] = stream["launches"]
    torch.cuda.empty_cache()

    log("phase 8: timings of the second slice's kernels")
    more, more_library = stream_timings(strat["h0"])
    times.update(more)
    library.update(more_library)
    ssd = ssd_timings()
    times["ssd_scan"] = ssd["times"]
    library["ssd_scan"] = None
    fa = flash_attn_timings()
    times["flash_attn"] = fa["times"]
    library["flash_attn"] = fa["library_ms"]
    log("  seconds per streaming epoch: "
        + ", ".join(f"{m} {s:.4f} (device idle {stream['idle'][m]:.1%})"
                    for m, s in stream["epoch_s"].items())
        + "; seconds per scored stratified batch: "
        + ", ".join(f"b={b} {s:.6f}" for b, s in strat["batch_s"].items()))
    torch.cuda.empty_cache()

    data = convert.cox_data_from_numpy(x, t, delta, device="cuda")
    select = selection_phase(data, beta_star)
    launches["beam search"] = select["launches"]["beam_search"]
    launches["omp"] = select["launches"]["omp_greedy"]
    base = baselines_phase(data, lam1, lam2)
    launches["path and baselines"] = base["launches"]
    del data
    torch.cuda.empty_cache()

    t12 = time.perf_counter()
    deep_out = deep_phase()
    deep_out["seconds"] = time.perf_counter() - t12
    log(f"  phase 12 took {deep_out['seconds']:.1f} s")
    launches["deep survival"] = deep_out["launches"]
    for name in ("revcumsum", "cox_coord", "lipschitz", "survival_curves"):
        check(deep_out["launches"][name] > 0,
              f"{name} did not launch on the deep-survival path")
    torch.cuda.empty_cache()

    t13 = time.perf_counter()
    train_out = train_phase(x, t, delta, lam2)
    train_out["seconds"] = time.perf_counter() - t13
    log(f"  phase 13 took {train_out['seconds']:.1f} s")
    launches["train"] = train_out["launches"]
    for name in ("revcumsum", "cox_coord", "lipschitz", "survival_curves"):
        check(train_out["launches"][name] > 0,
              f"{name} did not launch on the training path")
    torch.cuda.empty_cache()

    decode_out = decode_phase()
    log(f"  phase 14 took {decode_out['seconds']:.1f} s")
    launches["decode"] = decode_out["launches"]

    tools_out = tools_phase()
    log(f"  phase 15 took {tools_out['seconds']:.1f} s")
    launches.update(tools_out.pop("launches"))
    for name, err in tools_out.pop("errs").items():
        errs[name] = max(errs[name], err)

    mesh_out = mesh_phase()
    log(f"  phase 16 took {mesh_out['seconds']:.1f} s")
    launches["mesh"] = mesh_out["launches"]
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, ((ms, dev), (plain, _), (bound, by)) in times.items():
        source = f"src/repro_torch/kernels/csrc/{name}.cu"
        check((ROOT / source).is_file(), f"{name}: no source {source}")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name],
            "launches": launches[PATH_OF[name]][name],
            # a cox_coord call over C candidates counts C
            "launches_unit": ("candidate coordinates" if name == "cox_coord"
                              else "calls"),
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": library[name],
            "device_ms": dev, "path": PATH_OF[name],
            "launches_by_path": {path: counts[name] for path, counts
                                 in launches.items() if counts[name]},
            **({"cells": ssd["cells"]} if name == "ssd_scan" else {}),
            **({"max_abs_err_bf16": errs_bf16[name]}
               if name in errs_bf16 else {})})
    check(sorted(k["name"] for k in kernels) == sorted(REPLACES),
          "the kernels line lacks a kernel")
    print(json.dumps({"serve": serve}))
    print(json.dumps({
        "selection_launches": {"beam_search": launches["beam search"],
                               "omp_greedy": launches["omp"],
                               "path_and_baselines":
                                   launches["path and baselines"]},
        "beam_seconds_per_size": select["size_s"],
        "beam_idle": select["idle"],
        "support_f1": select["f1"],
        "revcumsum_at_block": select["revcumsum_at_block"],
        "baselines": base["steps"]}))
    print(json.dumps({"deep": deep_out}))
    print(json.dumps({"train": train_out}))
    print(json.dumps({"decode": decode_out}))
    print(json.dumps({"tools": tools_out}))
    print(json.dumps({"mesh": mesh_out}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
