#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(the substep physics, the two placement scans, flash attention, MoE
routing, the selective scan, the RG-LRU scan and the threefry draws) and
holds each against
its eager PyTorch twin: the simulator kernels on fuzzed slot states, at
the shapes of ``tests/test_torch_gpu.py`` (``edge_substep`` at K not a
multiple of its cluster, K below it, G=33, n=1 and 128, no substep,
K=20000 past its shared memory, out-of-range stages; the repair at
trip-0 cells beside long walks, every fragment infeasible, a mid-row
failure and chunk-boundary trips; BestFit at 1 to 128 workers with and
without ties, -0.0 before +0.0, steps no worker fits and trips at its
staging chunk's boundaries) and one real main-path interval, timed
there from CUDA graphs (float64 at rtol=1e-12, bools and ints exact,
bitwise identical over two runs; BestFit also at the run's longest walk);
flash attention (bfloat16 on the
tensor cores, float32 on the CUDA cores) at the reference's test shapes,
at the tile edges of the bfloat16 kernel, at every attention shape of the
serving paths, full forward and one semantic branch (qwen2-vl-7b's 28/4
heads, g = 7, among them), at a 4096-token shape where recurrentgemma's
2048-token window bites and at musicgen-medium's cross attention
(non-causal, 1024 queries or one over 64 keys) (atol 2e-5 in float32,
2e-2 in bfloat16, bitwise repeatable), and with explicit positions at
every decode shape of the served models (one query per row
over a ring of 1056 slots, 1 to all of them written, the unwritten ones
at 2**30) and at offset and packed prefills (timed at the decode shapes
beside scaled_dot_product_attention with a boolean mask);
``moe_route`` at the reference's test shapes, qwen2-moe's serving shape
(timed from CUDA graphs, CUDA events beside), several overflowing groups,
ragged groups, the widest E, more tiles than one wave, a multi-window
look-back, an underflowing row and a decode step's 4 tokens (expert ids
and slots exactly, gates within atol 1e-5); ``selective_scan`` at the
reference's test shapes and falcon-mamba's serving shape in float32 and
bfloat16, y and the final state (rtol and atol 1e-5, bitwise
repeatable); ``rglru_scan`` at the reference's test
shapes and recurrentgemma's serving shape in float32 and bfloat16 (atol
1e-5 and 3e-2, bitwise repeatable); ``threefry_rows`` (JAX's threefry
draws of the in-loop learners) at its three call sites over G up to 64, A
up to 512, keys near 2**32, t up to 10**4 and p in {0, 1, a float32 ε, a
float64 ε} (bitwise), then at the main path's shape (G=16, A=39, the
trace keys) for every interval of the main paths at each site's ε
(bitwise), timed there from CUDA graphs.
Then it drives the main paths, each with every kernel's launch count set
to 0 just before and read just after:

* the simulator — ``run_grid_batched`` for ``bestfit-rr``, for the
  ``"mab"`` deploy policy and for ``"splitplace"`` (MAB + the DASO stage
  at ``SurrogatePlacer``'s widths: C=64, hidden 128, depth 3, 50 steps,
  ``lr_place`` 0.1, θ from a seeded CUDA generator) over a 16-cell (8
  seeds × λ∈{6, 24}) grid on the 50-worker Table-3 fleet, 100 intervals
  of 30 substeps; for splitplace it prints the ascent steps per interval,
  the rows moved off the warm start, the DASO stage's launches and time
  at interval 30, and a profiled run's device busy time;
* the training loop on the same grid — ``splitplace`` and ``mab`` in
  ``mode="train"`` (ε-greedy decisions; for splitplace the online DASO
  finetune from interval 7 and the ascent of the finetuned θ from
  interval 32), ``gillis`` and ``random+daso`` — each launching
  ``threefry_rows`` once per interval, with the phases ``draw`` and
  ``daso_train`` beside the others; each draw these paths make is kept
  and held bitwise against the twin on the same operands after the run;
* the paper's experiment protocol (``table4``) — ``pretrain(200)`` at
  Table 4's settings (λ=6, seed 7, 10 substeps; the host ``EdgeSim`` with
  the MAB, DASO and Gillis learners on the card), with its wall, phase
  split, ascent steps, host reads, θ's drift and the rows the trained θ's
  ascent moves; then ``run_grid(backend="torch")`` over the 7 Table-4
  policies × seed 0 × T=100 with those products (each simulator
  kernel launched T times per policy, ``threefry_rows`` T times in
  ``gillis`` and ``random+daso``) and ``aggregate`` beside the paper's
  values; the ``splitplace`` main path with the trained θ; the host
  backend on the card (7 policies, seed 0, T=40; it launches none of the
  kernels); and ``pretrain(36)`` from one θ0 on the card against the CPU,
  whose card products then feed short grids on both devices (summaries
  at rtol 1e-9);
* interval telemetry (``telemetry``) — each simulator path above
  (``bestfit-rr``, ``mab``, ``splitplace``, ``splitplace`` and ``mab`` in
  train mode, ``gillis``, ``random+daso``) on the main grid cut to 50
  intervals (``TELEMETRY_GRID``) with ``telemetry="interval"`` beside its
  summary run, one call of each (``TELEMETRY_CALLS``): equal
  summaries, a
  finite (16, 50, 18 + engine columns) series whose ``n_fin`` and
  ``energy_j`` sum to the totals, no added host read, cell 0 against the
  port's host ``EdgeSim`` oracle (``torchsim.reference``) at
  ``tests/test_differential.py``'s rule, and the walls of both modes;
* the differential fuzz (``differential``) — 30 seeded cases of
  ``tests/test_differential.py``'s quantized space and its six regression
  cases with the interval program on the card against the host oracles;
* the streaming serve loop (``stream``) — ``run_stream`` at its own
  defaults (the Table-3 fleet, λ=6, 30 substeps, a ring of 512 slots,
  chunks of 64 intervals): ``mc`` until 5000 tasks are offered, then
  ``splitplace`` (θ at ``SurrogatePlacer``'s widths) until 1000 and
  ``gillis`` until 2000; the admission ledger balances with nothing dropped, device memory
  is flat from the second chunk on, each simulator kernel (and
  ``threefry_rows`` in ``gillis``) is launched once per interval and no
  kernel library is loaded after the first chunk; it prints the chunk
  walls, the steady tasks/s and the feeder thread's overlap with the
  chunks.  Then ``replay_stream`` of main-grid cell 0 cut to 50
  intervals in chunks of 32 equals the one-shot program to every digit
  (``bestfit-rr``, ``splitplace``, ``gillis``), and ``mc`` and ``gillis``
  at 750 tasks
  give the CPU's counters and its summaries within rtol 1e-9;
* the paper's splits (``splitnets``) — Fig. 2's protocol through
  ``core.splitnets`` on the card: per app (mnist, fashionmnist, cifar100)
  a trained MLP classifier, its 3-fragment layer split (bitwise equal to
  the monolithic output) and min(4, classes) semantic branches, each
  strategy's test accuracy and latency (the semantic one its slowest
  branch);
* serving — ``SplitPlaceEngine`` over TinyLlama-1.1B, qwen2-moe-a2.7b,
  falcon-mamba-7b, recurrentgemma-9b, qwen2-vl-7b (M-RoPE ids walking a
  16 × 16 patch block under random visual embeds) and musicgen-medium (a
  random conditioning sequence, 4 codebooks), one after another, each at
  full width and depth
  (bfloat16, random weights from seed 0), 2 stages / 2 branches, batch
  4 × 1024 tokens, 20 requests under the reference's tight/loose deadline
  rule;
* decode — for each served model, ``launch.steps.make_prefill_step`` on
  a 4 × 1024-token prompt (caches of 1056 positions), then 32 greedy
  ``make_serve_step`` calls: prefill and per-step times, tokens/s, cache
  bytes, peak memory, launches (flash and ``moe_route`` once per layer
  per call, the scans once per layer in the prefill) and a profiled
  step (musicgen: one token per codebook, its ``cond`` each step); each
  decode logit within 0.25 of the largest logit of the
  teacher-forced forward; TinyLlama-1.1B at full width in float32 within
  2e-3 of its forward over 8 teacher-forced steps;
* training — the four backward kernels (flash attention's dQ and dK/dV
  passes, both scans', ``moe_route``'s gates) against their twins at the
  reference's kernel-test shapes, the training shape (bf16, b=8, s=256,
  32/4 heads, hd=64), hd=128 at 16/16, hd=256 at 16/1 with window 2048
  at s=4096, the wide blocks' heads at hd 112 and 192, musicgen-medium's
  cross attention (1024 queries over 64 keys, non-causal, 24/24 heads)
  and qwen2-vl-7b's 28/4 heads (g = 7; these two in float32 too, at atol
  2e-5), (4, 1024, 8192, 16), (4, 1024, 4096) and G=1, gs=4096, E=60,
  k=4 (float32 atol 1e-4, bf16 2e-2 of each output's scale; flash also
  against autograd of ``attention_ref``; two runs bitwise equal; the
  flash forward with its logsumexp gives the serving forward's bits),
  timed from CUDA graphs beside ``scaled_dot_product_attention``'s
  backward; then ``launch.train.main`` at the reference's defaults on
  TinyLlama-1.1B at full width and depth (100 steps of 8 × 256 tokens,
  bf16, AdamW, remat): the loss must improve, every step launches flash
  44 times forward and 22 backward, the state after step 50 is
  checkpointed and restored bit-exactly, one step is profiled; three
  steps of each of the six reduced float32 models on the card against the
  CPU; ten steps each of qwen2-moe-a2.7b (2 layers), falcon-mamba-7b (2),
  recurrentgemma-9b (3), qwen2-vl-7b (2) and musicgen-medium (all 48, on
  (4, 1024, 4) codebook batches) at full width on 4 × 1024 tokens, each
  freed before the next, whose losses must fall and whose launches per
  step must equal the remat arithmetic; then qwen2-moe's slow fall
  probed (``train_moe_probe``): one step's float32 gradients through the
  kernels against autograd through the twins, per group of leaves
  (within 1e-4), the blocks' output rms at init, and the losses in
  float32, without the clip, with the experts drawn at 1/√d, and over 30
  steps;
* the GPipe pipeline (``pipeline``) — ``serving.pipeline_smap.
  pipeline_shard_map`` over two stages on two CUDA streams of the card,
  TinyLlama-1.1B at full width and depth in bf16, 4 × 1024 tokens in 1
  and in 4 microbatches, against ``forward`` and ``pipeline_forward``
  (within 2e-2 of the logits' scale; the argmax agreement; flash
  launched once per layer per microbatch), timed beside ``forward``;
* the grid's dispatch (``grid``) — ``run_grid_batched`` on the main
  paths' grid for ``bestfit-rr`` and ``splitplace`` with ``threads=2``
  and with ``devices=1`` against the main paths' one call (every summary
  metric within rtol 1e-4 / atol 1e-9, ``bestfit-rr`` bitwise); on one
  card ``devices=2`` must raise;
* counts (``count_phase``) — inside the TinyLlama training path, each of
  the four families' serving paths (one more forward of 4 × 1024) and
  each cut training family, one more call under ``launch.flopcount``: the
  FLOPs, products and bytes counted on the card must equal the same
  call's count on the meta device exactly, and each kernel's launch
  counter must rise by the calls of its operator the counter saw;
  counted FLOPs / (the phase's ms × 989e12) is printed as mfu;
* the dry-run (``dryrun_phase``) — ``python -m repro_torch.launch.dryrun``
  of TinyLlama-1.1B's ``train_4k`` on the fake (16, 16) mesh in a
  subprocess on the CPU, started after the build beside the card's
  phases and waited for at the end: 256 cards, its peak under the card's 80 GB, a compute
  term, collective traffic, a useful-FLOP ratio in (0.05, 1.5];

profiles one more ``bestfit-rr`` run for each simulator kernel's summed
device time, and cross-checks the GPU driver against the committed golden
fixture and
the CPU path (``mab``, and ``splitplace`` and ``layer+gobi`` at
``lr_place`` 20, where the ascent must move rows; this slice's five
policies at G=4, T=12 with the train gates lowered, where decisions must
be equal, summaries within rtol 1e-9, the finetuned θ within 1e-5, and a
placement that flips must be a near-tie), qwen2-moe's real router
logits between the routing kernel
and its twin, the six served models and both serving plans against the
CPU at a reduced size, and the six reduced models' prefill and decode
steps (their rings wrapping) against the CPU, logits and every cache leaf.

Prints the card (``nvidia-smi`` name and power limit), per-phase
numbers, a ``{"kernels": [...]}`` JSON line and, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero on any failure, on a
machine without CUDA, or when run outside a checkout of the repository.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

RTOL = 1e-12                       # kernel vs twin, float64 carries
GOLDEN = os.path.join(ROOT, "tests", "data",
                      "golden_static_bestfit_rr.json")
GOLDEN_RTOL, GOLDEN_ATOL = 1e-6, 1e-12
#: the literal MAB state of the reference's golden fixtures
MAB_LITERAL = {"R": np.array([700.0, 1800.0, 3500.0]),
               "Q": np.array([[0.8, 0.6], [0.3, 0.7]]),
               "N": np.array([[20.0, 10.0], [5.0, 25.0]]),
               "eps": 0.4, "rho": 0.06, "t": 40}
MAIN = dict(seeds=tuple(range(8)), lams=(6.0, 24.0), n_intervals=100,
            substeps=30)
#: the DASO stage of the splitplace main path at SurrogatePlacer's widths
#: (the config's defaults: hidden 128, depth 3, 50 steps, lr_place 0.1);
#: θ from init_surrogate with a CUDA generator seeded so (pretrain is not
#: ported)
DASO_MAIN = dict(num_workers=50, max_containers=64, state_features=4)
DASO_SEED = 0
#: the interval whose DASO stage is profiled and timed on its own
DASO_PROFILE_INTERVAL = 30
#: the cross-check's DASO configuration (tools/regen_golden.py's) at a
#: learning rate where the ascent moves placements off BestFit's
DASO_SMALL = dict(num_workers=50, max_containers=16, state_features=4,
                  hidden=32, depth=2, place_iters=12, lr_place=20.0)
H100_BYTES_S = 3.35e12             # HBM3, NVIDIA H100 SXM data sheet
H100_FP64_S = 34e12                # FP64 (non-tensor), same data sheet
H100_BF16_S = 989e12               # bf16 dense tensor cores, same sheet
#: flash attention: the reference's test shapes (b, sq, sk, h, kvh, hd,
#: causal, window) and tolerances (tests/test_kernels.py)
FLASH_CASES = [(2, 64, 64, 4, 2, 32, True, 0),
               (1, 128, 128, 8, 8, 64, True, 0),
               (2, 96, 96, 4, 1, 32, True, 0),
               (1, 33, 77, 2, 2, 16, True, 0),
               (2, 80, 80, 4, 2, 32, True, 8),
               (2, 80, 80, 4, 2, 32, True, 32),
               (1, 40, 56, 2, 2, 64, False, 0)]
#: tile edges of the bfloat16 tensor-core kernel (tiles of 64 or 128
#: (position, head) rows, of 64 or 128 keys), same layout
FLASH_EDGES = [(1, 200, 200, 16, 16, 128, True, 0),
               (2, 70, 70, 8, 1, 16, True, 0),
               (1, 130, 130, 4, 4, 32, True, 0),
               (1, 90, 40, 8, 1, 256, False, 0),
               (1, 200, 200, 8, 2, 64, True, 5),
               (1, 20, 20, 128, 1, 64, True, 0),
               (1, 24, 8, 2, 1, 16, True, 4),
               # kimi-k2's hd=112 (mma.sync, 7 k-steps) and nemotron-4's
               # hd=192 (wgmma, three 64-column swizzle blocks)
               (1, 150, 150, 8, 1, 112, True, 0),
               (1, 70, 70, 16, 2, 112, True, 5),
               (1, 130, 130, 12, 1, 192, True, 17),
               (1, 90, 40, 4, 2, 192, False, 0)]
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the serving paths: each model at full width, the engine's plans,
#: batch × seq tokens per request
SERVE_ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
               "recurrentgemma-9b")
#: the models whose attention head dims (112, 192) no serving path runs:
#: flash at their full heads, and one decoder block of each at full width
#: (``wide_block_phase``: kimi-k2's layer 0, which is dense, and one
#: nemotron-4 block), bf16, seeded weights, batch × seq tokens, held
#: against the same block through the twins within ``atol`` of each
#: output's scale (the bf16 flash tolerance); one decode_attention step
#: over a ring of ``ring`` slots, 1025 written
WIDE_ARCHS = ("kimi-k2-1t-a32b", "nemotron-4-340b")
#: the served families that read batch entries beside the tokens:
#: qwen2-vl-7b (M-RoPE ids walking a grid × grid patch block under random
#: visual embeds) and musicgen-medium (a random conditioning sequence for
#: its cross attention; 4 codebooks), with ``launch.serve.request_extras``'
#: seeded inputs; served, decoded and cross-checked as SERVE_ARCHS, not
#: trained (codebook labels are a later slice)
EXTRA_ARCHS = ("qwen2-vl-7b", "musicgen-medium")
EXTRA_GRID = 16
#: flash attention at musicgen's cross attention, non-causal over its
#: conditioning sequence: (b, sq, sk, h, kvh, hd) at a prefill and at a
#: decode step, and the record's keys
FLASH_CROSS = [("cross", (4, 1024, 64, 24, 24, 64)),
               ("cross_decode", (4, 1, 64, 24, 24, 64))]
WIDE_BLOCK = dict(batch=4, seq=1024, ring=1056, atol=2e-2, reps=3)
#: flash attention where recurrentgemma's local window bites: (b, s, h,
#: kvh, hd, window), bfloat16
FLASH_WINDOWED = (1, 4096, 16, 1, 256, 2048)
SERVE = dict(requests=20, batch=4, seq=1024, stages=2, branches=2)
#: decode (``launch.steps``): each serving model prefills SERVE's batch ×
#: seq prompt into caches of seq + headroom positions, then decodes
#: ``steps`` greedy tokens; the bfloat16 runs' largest |decode logit −
#: teacher-forced forward logit| over the largest |forward logit| must stay
#: within ``bf16_rel`` (PERF.md states the bound and why; for an MoE model
#: over the rows routed alike); the float32 gates (TinyLlama-1.1B, and
#: qwen2-moe-a2.7b cut to ``f32_moe_layers``) decode ``f32_steps``
#: teacher-forced tokens within ``f32_atol`` of the forward
#: (tests/test_arch_smoke.py's bound)
DECODE = dict(steps=32, headroom=32, bf16_rel=0.25, f32_steps=8,
              f32_atol=2e-3, f32_moe_layers=4)
#: the reduced float32 card-vs-CPU decode check: a (batch, prompt) prefill
#: into a ring of the prompt's length, ``steps`` decode steps past it (the
#: ring wraps), and TinyLlama from a zero cache over a ring of ``ring``
#: slots to position 2 × ring
DECODE_CROSS = dict(batch=2, prompt=12, steps=6, ring=8)
#: flash attention at decode's shapes (explicit positions, sq=1, a ring of
#: seq + headroom slots): (h, kvh, hd, the record's key) of TinyLlama-1.1B,
#: qwen2-moe-a2.7b, recurrentgemma-9b, kimi-k2, nemotron-4, qwen2-vl-7b
#: (g = 7) and musicgen-medium; the ring's written slots
FLASH_DECODE_HEADS = [(32, 4, 64, "hd64"), (16, 16, 128, "hd128"),
                      (16, 1, 256, "hd256"), (64, 8, 112, "hd112"),
                      (96, 8, 192, "hd192"), (28, 4, 128, "hd128_g7"),
                      (24, 24, 64, "hd64_g1")]
FLASH_DECODE_VALID = (1, 517, 1025, 1056)
#: flash attention at prefill shapes with explicit positions: (b, s, h,
#: kvh, hd, window, kind), offset rows or two packed sequences per row
FLASH_POS_CASES = [(2, 200, 32, 4, 64, 0, "offset"),
                   (2, 200, 16, 16, 128, 17, "offset"),
                   (1, 300, 16, 1, 256, 0, "packed"),
                   (2, 77, 8, 2, 64, 5, "packed"),
                   (1, 130, 4, 4, 32, 0, "offset"),
                   (2, 150, 16, 2, 112, 0, "packed"),
                   (1, 140, 24, 2, 192, 9, "offset")]
#: moe_route: the reference's test shapes (tests/test_kernels.py), the
#: serving shape of qwen2-moe (one group of 4 × 1024 tokens, 60 experts,
#: top-4), several groups with capacity factor 1.0 (overflowing), groups
#: whose tokens are not a multiple of the kernel's tile, the widest E, more
#: tiles than the card holds at once (tiles taken by ticket) and more
#: predecessors than a CTA has threads (a look-back of several windows);
#: (G, gs, E, k)
MOE_ROUTE_CASES = [(1, 64, 8, 2), (1, 100, 16, 4), (1, 33, 4, 1),
                   (1, 4096, 60, 4), (8, 512, 60, 4), (2, 150, 60, 4),
                   (3, 77, 1024, 7), (128, 512, 60, 4), (1, 20000, 4, 2),
                   (1, 4, 60, 4)]
MOE_SERVING = (1, 4096, 60, 4)
#: one decode step of qwen2-moe: one group of the batch's 4 tokens, a
#: partial 32-token tile
MOE_DECODE = (1, 4, 60, 4)
MOE_OVERFLOW = (8, 512, 60, 4)
GATE_ATOL = 1e-5
#: selective_scan: the reference's test shapes and falcon-mamba's serving
#: shape; (b, s, d_in, n)
SCAN_CASES = [(2, 37, 16, 4), (1, 128, 64, 16), (3, 15, 8, 2)]
SCAN_SERVING = (4, 1024, 8192, 16)
SCAN_TOL = 1e-5
H100_FP32_S = 67e12                # FP32 (non-tensor), same data sheet
#: rglru_scan: the reference's test shapes and recurrentgemma's serving
#: shape; (b, s, w), and the reference test's tolerances
RGLRU_CASES = [(2, 37, 24), (1, 64, 128)]
RGLRU_SERVING = (4, 1024, 4096)
RGLRU_ATOL = {"float32": 1e-5, "bfloat16": 3e-2}


#: threefry_rows: its three call sites, (split, width of the explore draw)
THREEFRY_SITES = {"mab-train": (True, 32), "gillis": (True, 64),
                  "random+daso": (False, 64)}
#: the fuzz's (G, A) shapes and intervals
THREEFRY_SHAPES = [(1, 1), (16, 64), (33, 7), (64, 512)]
THREEFRY_TS = (0, 1, 9999, 10000)
#: 32-bit operations per row of each site: ~80 per threefry hash (20
#: rounds of an add, a funnel shift and a xor; 5 key injections), 6 hashes
#: with the split, 3 without, and a few for the uniforms
THREEFRY_OPS = {True: 6 * 80 + 12, False: 3 * 80 + 6}
#: the train paths' gates lowered (alpha, beta, train_steps, place_min,
#: train_min) so that a short trace ascends the finetuned θ
TRAIN_HP_LOW = (0.5, 0.5, 4, 4, 2)
#: the card-against-CPU cross-check of this slice's policies (G=4)
TRAIN_CROSS = dict(seeds=(0, 1), lams=(5.0, 24.0), n_intervals=12,
                   substeps=4)

#: the paper's experiment protocol (benchmarks/table4.py): the shared §6.3
#: pretraining pass, then the 7 policies × 2 seeds (the protocol's 3, cut
#: to keep the script well inside its limit on a slow host) on the
#: interval program
TABLE4_POLICIES = ("mc", "gillis", "semantic+gobi", "layer+gobi",
                   "random+daso", "mab+gobi", "splitplace")
TABLE4_PRETRAIN = dict(n_intervals=200, lam=6.0, seed=7, substeps=10)
TABLE4 = dict(seeds=(0,), lams=(6.0,), n_intervals=100, substeps=10)
#: the host backend on the card, with the same pretraining products
TABLE4_HOST = dict(seeds=(0,), lams=(6.0,), n_intervals=40, substeps=10)
#: the card against the CPU at a reduced size: a 36-interval pretraining
#: pass (the ascent runs from interval 33) from one θ0, then a short grid
#: fed the card's products
TABLE4_CROSS_PRETRAIN = dict(n_intervals=36, lam=6.0, seed=7, substeps=4)
TABLE4_CROSS = dict(seeds=(0, 1), lams=(6.0,), n_intervals=12, substeps=4)
#: card against CPU: Q and R, and θ and the AdamW moments, relative to
#: each leaf's largest entry (float32 sums in other orders); summaries
TABLE4_MAB_TOL, TABLE4_THETA_TOL, TABLE4_RTOL = 1e-6, 5e-4, 1e-9
#: the paper's Table-4 values (benchmarks/table4.py), printed beside the
#: run's for information only
TABLE4_PAPER = {
    "mc": dict(reward=0.8398, viol=0.26, acc=0.8993, resp=6.85),
    "gillis": dict(reward=0.8417, viol=0.22, acc=0.9190, resp=8.39),
    "semantic+gobi": dict(reward=0.8391, viol=0.14, acc=0.8904, resp=3.70),
    "layer+gobi": dict(reward=0.6487, viol=0.62, acc=0.9317, resp=9.92),
    "random+daso": dict(reward=0.8162, viol=0.29, acc=0.9071, resp=5.55),
    "mab+gobi": dict(reward=0.9018, viol=0.10, acc=0.9145, resp=5.64),
    "splitplace": dict(reward=0.9418, viol=0.08, acc=0.9272, resp=4.50),
}
#: the Table-4 policies that draw with threefry_rows on the interval
#: program
TABLE4_DRAWS = ("gillis", "random+daso")


#: edge_substep shapes beside the fuzz and the main-path interval (as in
#: tests/test_torch_gpu.py): (K, F, n, G, substeps); K not a multiple of
#: the cluster, K below it, more clusters than the card runs at once, one
#: and 128 workers, no substep, and K=20000, whose carries do not fit a
#: cluster's shared memory
SUBSTEP_SHAPES = [(301, 8, 50, 3, 7), (5, 4, 6, 2, 7), (40, 8, 50, 33, 5),
                  (60, 4, 1, 2, 7), (300, 8, 128, 2, 7), (64, 8, 50, 2, 0),
                  (20000, 8, 50, 1, 5)]


def log(*a):
    print(*a, flush=True)


def fuzz_inputs(rng, K=12, F=4, N=6):
    """One consistent fuzzed slot state (the reference's fuzz of
    tests/test_edge_substep.py): padding columns born done with worker -1,
    stage in [0, F], positive physical quantities."""
    nfrag = rng.randint(1, F + 1, K).astype(np.int32)
    colpad = np.arange(F)[None, :] >= nfrag[:, None]
    done = rng.rand(K, F) < 0.35
    done |= colpad
    worker = rng.randint(0, N, (K, F)).astype(np.int32)
    worker[colpad] = -1
    placed = rng.rand(K) < 0.8
    worker[~placed] = -1
    task_done = done.all(axis=1) & (rng.rand(K) < 0.5)
    stage = np.minimum(done.argmin(axis=1).astype(np.int32), nfrag - 1)
    stage[done.all(axis=1)] = nfrag[done.all(axis=1)]
    return [np.where(done, 0.0, rng.uniform(1e3, 5e4, (K, F))), done,
            np.where(done, 0.0, rng.uniform(0.0, 30.0, (K, F))), stage,
            task_done, np.where(task_done, rng.uniform(1.0, 50.0, K), 0.0),
            np.asarray([rng.uniform(0.0, 900.0)]), rng.uniform(0.0, 10.0, 9),
            worker, rng.uniform(0.5, 8.0, K), rng.uniform(0.1, 40.0, (K, F)),
            nfrag, rng.rand(K) < 0.5, placed, rng.uniform(5.0, 60.0, K),
            rng.uniform(0.0, 600.0, K), rng.uniform(0.5, 1.0, K),
            rng.uniform(0.0, 10.0, K), rng.randint(0, 3, K).astype(np.int32),
            rng.uniform(0.3, 1.0, N), rng.uniform(2e3, 8e3, N),
            rng.uniform(4.0, 16.0, N), rng.uniform(100.0, 1000.0, N)]


def fuzz_grid(seed, K, F, N, G):
    """G fuzzed cells stacked on a grid axis, sharing cell 0's cluster rows
    (mips, cap, net_bw: the last three operands)."""
    rng = np.random.RandomState(seed)
    cells = [fuzz_inputs(rng, K, F, N) for _ in range(G)]
    return [np.stack([c[i] for c in cells]) if i < 20 else cells[0][i]
            for i in range(23)]


def repair_fuzz(rng, G, K, F, n, trip, cap_lo, cap_hi):
    """Operands of repair_scan for G cells (tests/_torch_ref.repair_fuzz):
    each row of ``order`` a permutation, requests in [-2, n + 2), chain
    stages in [0, F], fragment RAM of 0.1-4 against capacities in
    [cap_lo, cap_hi)."""
    order = np.stack([rng.permutation(K) for _ in range(G)]).astype(np.int64)
    return [order, np.asarray(trip, dtype=np.int64), rng.rand(G, K) < 0.8,
            rng.rand(G, K, F) < 0.3, rng.rand(G, K) < 0.4,
            rng.randint(0, F + 1, (G, K)).astype(np.int32),
            rng.randint(-2, n + 2, (G, K, F)).astype(np.int32),
            rng.uniform(0.1, 4.0, (G, K, F)), rng.uniform(cap_lo, cap_hi, n),
            rng.randint(-1, n, (G, K, F)).astype(np.int32),
            rng.rand(G, K) < 0.5]


def repair_cases(chunk):
    """The repair shapes of tests/test_torch_gpu.py: trip-0 cells beside
    long walks, every fragment infeasible, a task that fails mid-row and
    keeps the RAM it took, and trips one below, at and one above chunk
    boundaries."""
    rng = np.random.RandomState
    cases = {
        "trip-0 and long walks": repair_fuzz(
            rng(0), 6, 1000, 8, 50, [0, 900, 0, 1000, 5, 0], 40.0, 120.0),
        "every fragment infeasible": repair_fuzz(
            rng(1), 2, 300, 8, 50, [300, 300], 0.01, 0.05),
        "mid-row failure": [
            np.array([[0, 1]], dtype=np.int64), np.array([2], dtype=np.int64),
            np.ones((1, 2), dtype=bool),
            np.array([[[False, False, False], [False, True, True]]]),
            np.zeros((1, 2), dtype=bool), np.zeros((1, 2), dtype=np.int32),
            np.zeros((1, 2, 3), dtype=np.int32),
            np.array([[[6.0, 6.0, 20.0], [4.5, 1.0, 1.0]]]),
            np.array([10.0, 10.0]), np.zeros((1, 2, 3), dtype=np.int32),
            np.zeros((1, 2), dtype=bool)]}
    for d in (-1, 0, 1):
        cases[f"chunk boundary {d:+d}"] = repair_fuzz(
            rng(2 + d), 3, 4 * chunk, 8, 50,
            [2 * chunk + d, chunk + d, 3 * chunk + d], 30.0, 80.0)
    return cases


def bestfit_fuzz(rng, G, K, F, n, n_new=None, ties=False):
    """Operands of bestfit_scan for G cells of K slots, F fragments and n
    workers, as numpy arrays in operand order: each row of ``pos`` a
    permutation of the K·F fragments, ``n_new`` (G,) drawn in [0, K·F]
    unless given, fragment RAM of 0.1-4 against capacities of 4-16 with
    part of them in use, integer loads and scores from the placement's
    formula.  ``ties`` draws RAM, capacities, use and the static term from
    a few values, so equal scores and equal masks are common, and some
    fragments (20) fit no worker.  The port's tests draw from it too."""
    P = K * F
    pos = np.stack([rng.permutation(P) for _ in range(G)]).astype(np.int64)
    if n_new is None:
        n_new = rng.randint(0, P + 1, G)
    if ties:
        ram = rng.choice([0.5, 1.0, 2.0, 4.0, 20.0], (G, K, F))
        cap = rng.choice([8.0, 16.0], n)
        static = 0.3 * rng.choice([0.5, 1.0], n)
        used = cap * rng.choice([0.0, 0.5], (G, n))
    else:
        ram = rng.uniform(0.1, 4.0, (G, K, F))
        cap = rng.uniform(4.0, 16.0, n)
        static = 0.3 * rng.uniform(0.25, 1.0, n)
        used = cap * rng.uniform(0.0, 0.9, (G, n))
    load0 = rng.randint(0, 5, (G, n)).astype(np.float64)
    free0 = cap - used
    return [pos, np.asarray(n_new, dtype=np.int64), ram, free0, load0,
            -load0 + static + 0.1 * free0 / cap, static, cap,
            rng.randint(-1, n, (G, K, F)).astype(np.int32)]


def bestfit_cases():
    """The BestFit shapes, which tests/test_torch_gpu.py takes from here:
    n of 1, 31-33, 50 and 128 workers with and without ties, -0.0 against
    +0.0, steps where no worker fits, and trips of 0 and at the 32-step
    staging chunk's boundaries +-1 beside other trips in one grid."""
    rng = np.random.RandomState
    cases = {}
    for n in (1, 31, 32, 33, 50, 128):
        for ties in (False, True):
            cases[f"n={n} ties={ties}"] = bestfit_fuzz(
                rng(n + 1000 * ties), 3, 40, 4, n, [160, 97, 33], ties)
    zeros = bestfit_fuzz(rng(5), 1, 4, 2, 40, [1])
    zeros[5][:] = -1.0
    zeros[5][0, 3], zeros[5][0, 35] = -0.0, 0.0
    zeros[3][:] = 100.0
    cases["-0.0 before +0.0"] = zeros
    masked = bestfit_fuzz(rng(7), 2, 6, 3, 50, [18, 5])
    masked[2][:] = 1e6
    cases["no worker fits"] = masked
    for trips in (0, 31, 32, 33, 63, 64, 65):
        cases[f"trips {trips}"] = bestfit_fuzz(
            rng(100 + trips), 3, 20, 5, 50, [trips, 70 - trips // 2, 0])
    return cases


def compare(outs_k, outs_r, names, where):
    """Kernel vs twin: floats at RTOL (atol 0), bools and ints exact;
    returns the largest absolute float difference, or raises naming every
    output that disagrees."""
    import torch
    worst, bad = 0.0, []
    for name, a, b in zip(names, outs_k, outs_r):
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(f"{name} {tuple(a.shape)}/{a.dtype} vs "
                       f"{tuple(b.shape)}/{b.dtype}")
        elif a.dtype.is_floating_point:
            diff = float((a - b).abs().max()) if a.numel() else 0.0
            worst = max(worst, diff)
            if not torch.allclose(a, b, rtol=RTOL, atol=0.0):
                bad.append(f"{name} max abs diff {diff:.3e}")
        elif not torch.equal(a, b):
            bad.append(f"{name} differs at {int((a != b).sum())} entries")
    if bad:
        raise AssertionError(f"{where}: kernel vs twin: " + "; ".join(bad))
    return worst


def bitwise_equal(xs, ys):
    import torch
    return all(torch.equal(x, y) for x, y in zip(xs, ys))


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Device time of one ``fn()`` from a CUDA graph of ``reps`` calls
    replayed three times: no host time between launches, for kernels
    shorter than a Python call's overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def main_path_interval(n_warm=30, walks=None):
    """The kernels' operands at one real interval of the main-path grid
    (bestfit-rr, G=16, K=default_capacity): the program's stages run for
    ``n_warm`` intervals (by then the λ=24 cells are overloaded and their
    RAM repair walks hundreds of slots), then the next interval's BestFit
    scan, repair scan and physics operands are returned.  ``walks``, a
    list, receives the longest cell's BestFit walk at every interval up to
    and including that one."""
    import torch
    from repro_torch.env.cluster import NIC_CAP_MB, make_cluster
    from repro_torch.env.torchsim import driver, engines, kernels
    from repro_torch.env.torchsim.arrays import (ClusterArrays,
                                                 compile_trace,
                                                 default_capacity,
                                                 stack_traces, to_device)
    from repro_torch.env.torchsim.policies import make_static_decider
    dev = torch.device("cuda")
    dec = make_static_decider("bestfit-rr")
    traces = [compile_trace(dec, lam=lam, seed=seed,
                            n_intervals=MAIN["n_intervals"],
                            substeps=MAIN["substeps"])
              for lam in MAIN["lams"] for seed in MAIN["seeds"]]
    K = default_capacity(traces)
    trace = to_device(stack_traces(traces), dev)
    cl = to_device(ClusterArrays.from_cluster(make_cluster()).as_dict(), dev)
    G, F, n = len(traces), trace["instr"].shape[-1], cl["ram"].shape[0]
    t0 = traces[0]
    dt = t0.interval_s / t0.substeps
    eng = engines.StaticEngine()
    state = kernels.init_state(G, K, F, n, dev)
    acc = driver._init_acc(G, n, dev)
    for t in range(n_warm + 1):
        arr, _ = eng.decide({}, trace, t)
        state = kernels.admit(state, arr)
        if walks is not None:
            walks.append(int(kernels.bestfit_operands(state, cl)[1].max()))
        if t == n_warm:
            break
        state = kernels.place(state, cl)
        state, acc, _ = driver._interval_physics(
            state, acc, trace["bw_mult"][:, t], cl, t0.substeps, dt,
            t0.interval_s, 0.5)
        state["alive"] = state["alive"] & ~state["task_done"]
    bestfit = kernels.bestfit_operands(state, cl)
    req = kernels.bestfit_requests(state, cl)
    repair = kernels.repair_operands(state, cl, req)
    state = kernels.apply_requests(state, cl, req)
    state["wait_s"] = state["wait_s"] + \
        (state["alive"] & ~state["placed"]).to(torch.float64) * t0.interval_s
    physics = [state["instr"], state["done"], state["transfer"],
               state["stage"], state["task_done"], state["resp"],
               acc["now"][:, None], acc["metrics"], state["worker"],
               state["ram"][..., 0].contiguous(), state["out_bytes"],
               state["nfrag"], state["chain"], state["placed"],
               state["sla"], state["arrival_s"], state["acc"],
               state["wait_s"], state["decision"],
               trace["bw_mult"][:, n_warm].contiguous(), cl["mips"],
               cl["ram"], cl["net_bw"]]
    kw = dict(substeps=t0.substeps, dt=dt, swap_slowdown=0.5,
              nic_cap=NIC_CAP_MB)
    return bestfit, repair, physics, kw


def longest_walk_interval():
    """The interval of the main-path grid whose longest cell walks the most
    BestFit steps, and that walk."""
    walks = []
    main_path_interval(MAIN["n_intervals"] - 1, walks)
    t = int(np.argmax(walks))
    return t, walks[t]


def _record(name, source, replaces, err, ms, plain_ms, nbytes, flops,
            peak=H100_FP64_S, library_ms=None):
    """One entry of the kernels JSON line; the bound is the larger of the
    bytes over the HBM rate and the operations over ``peak`` (the FP64
    rate unless given)."""
    b_ms = nbytes / H100_BYTES_S * 1e3
    o_ms = flops / peak * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": library_ms}


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _sim_ms(fn, reps):
    """(CUDA-graph ms, CUDA-event ms) of one simulator kernel call: the
    graph time has no host time between launches; the event time around
    plain wrapper calls includes it."""
    return graph_ms(fn, reps), cuda_ms(fn, reps)


def kernel_phase():
    """Every kernel of the main path vs its twin on the card; returns the
    kernel records."""
    import torch
    from repro_torch.kernels import placement
    from repro_torch.kernels.edge_substep import (OUT_NAMES, edge_substep,
                                                  edge_substep_cuda,
                                                  edge_substep_plan)
    from repro_torch.kernels.ref import edge_substep_ref
    dev = torch.device("cuda")
    kw = dict(substeps=7, dt=1.5, swap_slowdown=0.5, nic_cap=50.0)
    for seed in range(8):
        args = [torch.from_numpy(np.asarray(a)).to(dev)
                for a in fuzz_inputs(np.random.RandomState(seed))]
        k1 = edge_substep(*args, **kw)
        k2 = edge_substep(*args, **kw)
        torch.cuda.synchronize()
        compare(k1, edge_substep_ref(*args, **kw), OUT_NAMES,
                f"fuzz seed {seed}")
        if not bitwise_equal(k1, k2):
            raise AssertionError(f"fuzz seed {seed}: two runs differ")
    log("edge_substep fuzz: 8 seeds K=12 F=4 N=6 substeps=7 match the twin "
        f"(rtol={RTOL}), bitwise repeatable")
    for K, F, N, G, steps in SUBSTEP_SHAPES:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in fuzz_grid(7, K, F, N, G)]
        kws = dict(kw, substeps=steps)
        k1 = edge_substep(*args, **kws)
        k2 = edge_substep(*args, **kws)
        torch.cuda.synchronize()
        compare(k1, edge_substep_ref(*args, **kws), OUT_NAMES,
                f"edge_substep K={K} F={F} n={N} G={G} substeps={steps}")
        if not bitwise_equal(k1, k2):
            raise AssertionError(f"edge_substep K={K}: two runs differ")
        log(f"edge_substep at K={K} F={F} n={N} G={G} substeps={steps} "
            f"({edge_substep_plan(G, K, F)}): matches the twin, bitwise "
            f"repeatable")
    # fill semantics of an out-of-range stage on live chains, on a grid
    for seed in range(4):
        a = fuzz_grid(40 + seed, 48, 4, 6, 3)
        rows = np.arange(0, 48, 3)
        a[13][:, rows] = True            # placed
        a[12][:, rows] = True            # chain
        a[4][:, rows] = False            # task_done
        a[3][:, rows] = 4                # stage == F
        a[1][:, rows, 0] = False         # done
        a[8][:, rows, 0] = 1             # worker
        a[0][:, rows, 0] = 5.0           # instr
        a[2][:, rows, :] = 3.0           # transfer
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in a]
        k1 = edge_substep(*args, **kw)
        k2 = edge_substep(*args, **kw)
        compare(k1, edge_substep_ref(*args, **kw), OUT_NAMES,
                f"out-of-range stage seed {seed}")
        if not bitwise_equal(k1, k2):
            raise AssertionError("out-of-range stage: two runs differ")
    log("edge_substep with stage == F on live chains (4 seeds, G=3): "
        "matches the twin, bitwise repeatable")

    rplan = placement.repair_scan_plan(8)
    for where, ops in repair_cases(rplan["chunk"]).items():
        ops = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in ops]
        r1 = placement.repair_scan(*ops)
        r2 = placement.repair_scan(*ops)
        compare(r1, placement.repair_scan_ref(*ops), ["worker", "placed"],
                f"repair_scan {where}")
        if not bitwise_equal(r1, r2):
            raise AssertionError(f"repair_scan {where}: two runs differ")
    log(f"repair_scan ({rplan}) at trip-0 cells beside long walks, every "
        "fragment infeasible, a mid-row failure and trips at chunk "
        "boundaries +-1: equals the twin exactly, bitwise repeatable")

    for where, ops in bestfit_cases().items():
        ops = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in ops]
        b1 = placement.bestfit_scan(*ops)
        b2 = placement.bestfit_scan(*ops)
        compare([b1], [placement.bestfit_scan_ref(*ops)], ["req"],
                f"bestfit_scan {where}")
        if not torch.equal(b1, b2):
            raise AssertionError(f"bestfit_scan {where}: two runs differ")
    log("bestfit_scan at n=1/31/32/33/50/128 with and without ties, -0.0 "
        "before +0.0, no worker fitting and trips at the staging chunk's "
        "boundaries +-1: equals the twin exactly, bitwise repeatable")

    bestfit, repair, args, kw = main_path_interval()
    G, K, F = args[8].shape
    n = args[20].shape[0]
    records = []

    # BestFit scan: each step reads a fragment's RAM and index and writes
    # its worker; the per-worker rows are read and written once
    def bestfit_timed(ops, where):
        b1 = placement.bestfit_scan(*ops)
        b2 = placement.bestfit_scan(*ops)
        bref = placement.bestfit_scan_ref(*ops)
        torch.cuda.synchronize()
        compare([b1], [bref], ["req"], f"bestfit_scan {where}")
        if not torch.equal(b1, b2):
            raise AssertionError(f"bestfit_scan {where}: two runs differ")
        ms, ev_ms = _sim_ms(lambda: placement.bestfit_scan(*ops), 10)
        longest = int(ops[1].max())
        log(f"bestfit_scan at {where}: G={G} K={K} F={F} n={n}, {longest} "
            f"fragments in the longest cell ({int(ops[1].sum())} over the "
            f"grid): matches the twin exactly, bitwise repeatable; "
            f"{ms:.4f} ms/call from CUDA graphs ({ev_ms:.4f} with CUDA "
            f"events around wrapper calls; {ms * 1e6 / max(longest, 1):.1f} "
            f"ns per step of the longest cell)")
        return ms, ev_ms, longest

    ms, ev_ms, longest = bestfit_timed(bestfit, "main-path interval 30")
    steps = int(bestfit[1].sum())
    plain_ms = cuda_ms(lambda: placement.bestfit_scan_ref(*bestfit), 1)
    late, _ = longest_walk_interval()
    late_ms, late_ev, late_walk = bestfit_timed(
        main_path_interval(late)[0], f"main-path interval {late} (the "
        f"longest walk of the run)")
    log(f"bestfit_scan twin at interval 30: {plain_ms:.4f} ms/call")
    rec = _record(
        "bestfit_scan", "src/repro_torch/kernels/csrc/placement.cu",
        "src/repro/env/jaxsim/kernels.py:202", 0.0, ms, plain_ms,
        _nbytes(list(bestfit[3:8])) + steps * (8 + 8 + 4), 0.0)
    rec["event_ms"] = ev_ms
    rec["ns_per_step"] = ms * 1e6 / max(longest, 1)
    rec["late"] = {"interval": late, "longest": late_walk, "ms": late_ms,
                   "event_ms": late_ev,
                   "ns_per_step": late_ms * 1e6 / max(late_walk, 1)}
    records.append(rec)

    # repair scan: each walked slot reads its task row and fragment rows
    # and writes its workers and placed flag
    r1 = placement.repair_scan(*repair)
    r2 = placement.repair_scan(*repair)
    rref = placement.repair_scan_ref(*repair)
    torch.cuda.synchronize()
    compare(r1, rref, ["worker", "placed"], "repair_scan")
    if not bitwise_equal(r1, r2):
        raise AssertionError("repair_scan: two runs differ")
    walked = int(repair[1].sum())
    longest = int(repair[1].max())
    ms, ev_ms = _sim_ms(lambda: placement.repair_scan(*repair), 10)
    plain_ms = cuda_ms(lambda: placement.repair_scan_ref(*repair), 1)
    log(f"repair_scan at a main-path interval ({rplan}): {longest} slots "
        f"in the longest cell ({walked} over the grid): matches the twin "
        f"exactly, bitwise repeatable; {ms:.4f} ms/call from CUDA graphs "
        f"({ev_ms:.4f} with CUDA events around wrapper calls), "
        f"{ms * 1e6 / max(longest, 1):.1f} ns per walked slot of the "
        f"longest cell; twin {plain_ms:.4f} ms/call")
    rec = _record(
        "repair_scan", "src/repro_torch/kernels/csrc/placement.cu",
        "src/repro/env/jaxsim/kernels.py:271", 0.0, ms, plain_ms,
        walked * (8 + 1 + 1 + 4 + 1 + F * (1 + 4 + 8 + 4)) + n * 8, 0.0)
    rec["event_ms"] = ev_ms
    records.append(rec)

    # substep physics
    plan = edge_substep_plan(G, K, F)
    if plan["cluster"] < 2 or not plan["on_chip"]:
        raise AssertionError(f"edge_substep at the main-path interval is "
                             f"not launched as clusters on chip: {plan}")
    k1 = edge_substep_cuda(*args, **kw)
    k2 = edge_substep_cuda(*args, **kw)
    ref = edge_substep_ref(*args, **kw)
    torch.cuda.synchronize()
    err = compare(k1, ref, OUT_NAMES, "main-path interval")
    if not bitwise_equal(k1, k2):
        raise AssertionError("main-path interval: two runs differ")
    live = int((~args[1]).sum())
    ms, ev_ms = _sim_ms(lambda: edge_substep_cuda(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: edge_substep_ref(*args, **kw), 3)
    # FP64 work this interval needs: ~8 operations per live fragment per
    # substep (census add, rate, burn-down, compare)
    rec = _record("edge_substep",
                  "src/repro_torch/kernels/csrc/edge_substep.cu",
                  "src/repro/kernels/edge_substep.py:192", err, ms,
                  plain_ms, _nbytes(list(args) + list(k1)),
                  8.0 * live * kw["substeps"])
    rec["event_ms"] = ev_ms
    rec["cluster"] = plan
    log(f"edge_substep at a main-path interval: G={G} K={K} F={F} n={n} "
        f"substeps={kw['substeps']}, {live} live fragments; clusters of "
        f"{plan['cluster']} CTAs x {plan['threads']} threads, "
        f"{plan['smem_bytes']} bytes of dynamic shared memory per CTA "
        f"(carries on chip: {plan['on_chip']}), "
        f"{plan['max_active_clusters']} clusters at once on the card: "
        f"matches the twin (max abs err {err:.3e}), bitwise repeatable; "
        f"{ms:.4f} ms/call from CUDA graphs ({ev_ms:.4f} with CUDA events "
        f"around wrapper calls), {ms * 1e3 / kw['substeps']:.3f} us per "
        f"substep; twin {plain_ms:.4f} ms/call; bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    records.append(rec)
    return records


def threefry_cases():
    """Operands of ``threefry_rows``, name -> (key (G, 2) int64, t, rows,
    p (G,) float64 or None, width): every site at every fuzz shape and
    interval, keys near 2**32 among them, p in {0, 1, a float32 ε, a
    float64 ε}."""
    rng = np.random.RandomState(19)
    eps = [0.0, 1.0, float(np.float32(0.4)), 0.5 * 0.995 ** 37]
    cases = {}
    for G, A in THREEFRY_SHAPES:
        key = rng.randint(0, 2 ** 32, (G, 2), dtype=np.int64)
        key[0] = (2 ** 32 - 1, 2 ** 32 - 1)
        if G > 1:
            key[1] = (0, 2 ** 32 - 2)
        p = np.array([eps[i % 4] for i in range(G)], np.float64)
        for t in THREEFRY_TS:
            for site, (split, width) in THREEFRY_SITES.items():
                cases[f"{site} G={G} A={A} t={t}"] = (
                    key, t, A, p if split else None, width)
    return cases


def main_grid_rows():
    """(G, A) of the main-path grid's dual traces: the draws' shape."""
    from repro_torch.env.torchsim import compile_trace_dual
    A = max(compile_trace_dual(lam=lam, seed=seed,
                               n_intervals=MAIN["n_intervals"],
                               substeps=MAIN["substeps"]).max_arrivals
            for lam in MAIN["lams"] for seed in MAIN["seeds"])
    return len(MAIN["lams"]) * len(MAIN["seeds"]), A


def draw_err(xs, ys, what):
    """The largest difference (0 or 1) between two runs' draws; raises
    unless they are bitwise equal."""
    err = max(float((x.int() - y.int()).abs().max()) if x.numel() else 0.0
              for x, y in zip(xs, ys))
    if err or not bitwise_equal(xs, ys):
        raise AssertionError(f"threefry_rows {what}: kernel vs twin differ")
    return err


def threefry_phase():
    """``threefry_rows`` bitwise against its twin on the fuzz and at the
    main path's shape for every interval and site, then timed there for
    each site; returns its record."""
    import torch
    from repro_torch.env.torchsim import GILLIS_HP, trace_train_key
    from repro_torch.kernels.ref import threefry_rows_ref
    from repro_torch.kernels.threefry import threefry_rows_cuda
    dev = torch.device("cuda")

    def run(fn, key, t, A, p, width):
        out = fn(key, t, A, p, width)
        return out if isinstance(out, tuple) else (out,)

    err = 0.0
    for name, (key, t, A, p, width) in threefry_cases().items():
        key = torch.from_numpy(key).to(dev)
        p = None if p is None else torch.from_numpy(p).to(dev)
        k1 = run(threefry_rows_cuda, key, t, A, p, width)
        k2 = run(threefry_rows_cuda, key, t, A, p, width)
        ref = run(threefry_rows_ref, key, t, A, p, width)
        torch.cuda.synchronize()
        err = max(err, draw_err(k1, ref, name))
        if not bitwise_equal(k1, k2):
            raise AssertionError(f"threefry_rows {name}: two runs differ")
    log(f"threefry_rows: {len(threefry_cases())} cases (the three sites at "
        f"(G, A) in {THREEFRY_SHAPES}, t in {THREEFRY_TS}, keys near 2**32, "
        "p in {0, 1, float32 eps, float64 eps}) equal the twin bitwise, "
        "bitwise repeatable")
    G, A = main_grid_rows()
    key = torch.stack([trace_train_key(s, dev) for _ in MAIN["lams"]
                       for s in MAIN["seeds"]])
    p = torch.full((G,), float(np.float32(MAB_LITERAL["eps"])),
                   dtype=torch.float64, device=dev)
    # each site's ε at interval t on the main paths: the MAB's float32 ε
    # (it starts from MAB_LITERAL's and decays only on an improvement, so
    # the tap in train_paths holds the values the run drew with), Gillis's
    # float64 ε0 · decay^t, multiplied out per interval as its engine does
    eps = {"mab-train": [p] * MAIN["n_intervals"], "gillis": [],
           "random+daso": [None] * MAIN["n_intervals"]}
    g = torch.full((G,), GILLIS_HP[0], dtype=torch.float64, device=dev)
    for _ in range(MAIN["n_intervals"]):
        eps["gillis"].append(g)
        g = g * GILLIS_HP[2]
    for site, (_, width) in THREEFRY_SITES.items():
        for t, pt in enumerate(eps[site]):
            err = max(err, draw_err(
                run(threefry_rows_cuda, key, t, A, pt, width),
                run(threefry_rows_ref, key, t, A, pt, width),
                f"{site} G={G} A={A} t={t}"))
    torch.cuda.synchronize()
    log(f"threefry_rows: the three sites at the main path's G={G} A={A} "
        f"with its trace keys and each site's ε, every t in "
        f"range({MAIN['n_intervals']}), equal the twin bitwise (largest "
        f"difference {err})")
    sites = {}
    for site, (split, width) in THREEFRY_SITES.items():
        pp = p if split else None
        ms = graph_ms(lambda: threefry_rows_cuda(key, 30, A, pp, width), 50)
        ev_ms = cuda_ms(lambda: threefry_rows_cuda(key, 30, A, pp, width),
                        50)
        plain_ms = cuda_ms(lambda: threefry_rows_ref(key, 30, A, pp, width),
                           3)
        nbytes = G * 16 + (G * 8 if split else 0) + (2 if split else 1) \
            * G * A
        sites[site] = {"ms": ms, "event_ms": ev_ms, "plain_ms": plain_ms,
                       "bytes": nbytes, "ops": THREEFRY_OPS[split] * G * A}
        log(f"threefry_rows {site} at the main path's G={G} A={A}: {ms:.5f} "
            f"ms/call from CUDA graphs ({ev_ms:.5f} with CUDA events around "
            f"wrapper calls); twin {plain_ms:.4f} ms/call")
    main = sites["mab-train"]
    rec = _record("threefry_rows", "src/repro_torch/kernels/csrc/threefry.cu",
                  "src/repro/core/mab.py:126 (jax.random threefry in "
                  "decide_train_rows; not a Pallas kernel)", err, main["ms"],
                  main["plain_ms"], main["bytes"], main["ops"],
                  peak=H100_FP32_S)
    rec["event_ms"] = main["event_ms"]
    rec["peak"] = "FP32 non-tensor rate (the data sheet gives no INT32 rate)"
    rec["sites"] = sites
    return rec


def _flash_inputs(rng, b, sq, sk, h, kvh, hd, dtype):
    import torch
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .to("cuda", getattr(torch, dtype))
            for shape in ((b, sq, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd))]


def _flash_check(q, k, v, causal, window, dtype, where, pos_q=None,
                 pos_k=None):
    """Kernel vs twin on the card at the reference's tolerance; returns
    the largest absolute difference."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import attention_ref
    kw = dict(causal=causal, window=window, pos_q=pos_q, pos_k=pos_k)
    got = flash_attention_cuda(q, k, v, **kw)
    again = flash_attention_cuda(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    if got.dtype != q.dtype or got.shape != q.shape:
        raise AssertionError(f"{where}: output {got.dtype} "
                             f"{tuple(got.shape)}")
    err = float((got.float() - want.float()).abs().max())
    if not err <= FLASH_ATOL[dtype]:
        raise AssertionError(f"{where}: kernel vs twin max abs err {err:.3e}"
                             f" > {FLASH_ATOL[dtype]}")
    if not torch.equal(got, again):
        raise AssertionError(f"{where}: two runs differ")
    return err


def serving_heads(cfg):
    """(label, query heads, kv heads) of every attention call the serving
    path makes: the full forward's (layer plan, monolithic reference) and
    one semantic branch's, read from the plan's own head slicing
    (``_slice_block_params`` on shape-only weights)."""
    import torch
    from repro_torch.serving.plans import _slice_block_params
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim

    def meta(*shape):
        return torch.empty(*shape, device="meta")

    block = {"attn": {"wq": meta(d, h, hd), "wk": meta(d, kvh, hd),
                      "wv": meta(d, kvh, hd), "wo": meta(h, hd, d)}}
    B = SERVE["branches"]
    sliced = _slice_block_params(block, cfg, 0, B)["attn"]
    return [("full forward", h, kvh),
            (f"one of {B} branches", sliced["wq"].shape[1],
             sliced["wk"].shape[1])]


def flash_sass_counts():
    """Tensor-core instructions in the built flash library's SASS
    (``cuobjdump`` beside ``nvcc``): HMMA for the ``mma.sync`` head dims,
    HGMMA for the ``wgmma`` ones; fails if either path has none."""
    from repro_torch.kernels.build import _lib_path, nvcc_path
    from repro_torch.kernels.flash_attention import HEAD_DIMS, kernel_step
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_lib_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    counts = {"HMMA": sass.count("HMMA"), "HGMMA": sass.count("HGMMA")}
    steps = {kernel_step(hd) for hd in HEAD_DIMS}
    for step, name in ((1, "HMMA"), (2, "HGMMA")):
        if step in steps and counts[name] == 0:
            raise AssertionError(f"flash_attention: no {name} in the SASS "
                                 f"of the step-{step} kernels")
    return counts


def _visible_pairs(s, window):
    """(query, key) pairs a causal s x s attention with ``window`` sees."""
    if window and window < s:
        return window * (window + 1) / 2 + (s - window) * window
    return s * (s + 1) / 2


def flash_phase():
    """Flash attention vs its twin on the card at the reference's test
    shapes and the bfloat16 kernel's tile edges, at every serving shape
    (the full forward's heads and one semantic branch's, with the model's
    window; WIDE_ARCHS' heads at the same b × s), in float32 and bfloat16,
    and at FLASH_WINDOWED in bfloat16;
    times the kernel at each serving shape, and the twin and the library's
    scaled_dot_product_attention (a yardstick only: the port never calls
    it) at each attention model's full forward's and at FLASH_WINDOWED, in
    bfloat16.  The kernel and the library call are timed from CUDA graphs
    (``graph_ms``): at ~0.07 ms a call is as short as the Python call that
    launches it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     flash_attention_cuda,
                                                     kernel_step)
    from repro_torch.models.model import block_window
    steps = {hd: kernel_step(hd) for hd in HEAD_DIMS}
    log(f"flash_attention library SASS: {flash_sass_counts()} tensor-core "
        f"instructions; bfloat16 step per head dim {steps}")
    rng = np.random.RandomState(0)
    for cases, what in ((FLASH_CASES, "the reference's test cases"),
                        (FLASH_EDGES, "the bfloat16 kernel's tile edges")):
        worst = {"float32": 0.0, "bfloat16": 0.0}
        for dtype in ("float32", "bfloat16"):
            for b, sq, sk, h, kvh, hd, causal, window in cases:
                q, k, v = _flash_inputs(rng, b, sq, sk, h, kvh, hd, dtype)
                err = _flash_check(q, k, v, causal, window, dtype,
                                   f"flash {dtype} {(b, sq, sk, h, kvh, hd)}"
                                   f" causal={causal} window={window}")
                worst[dtype] = max(worst[dtype], err)
        log(f"flash_attention at {what} ({len(cases)}) matches the twin: "
            f"max abs err float32 {worst['float32']:.3e} (atol "
            f"{FLASH_ATOL['float32']}), bfloat16 {worst['bfloat16']:.3e} "
            f"(atol {FLASH_ATOL['bfloat16']}), bitwise repeatable")

    b, s = SERVE["batch"], SERVE["seq"]
    at = {}
    for arch in SERVE_ARCHS + WIDE_ARCHS + EXTRA_ARCHS:
        cfg = get_config(arch)
        windows = {block_window(kind, cfg) for kind in cfg.layer_kinds
                   if kind in ATTN_KINDS}
        if not windows:
            continue
        (window,) = windows
        hd = cfg.resolved_head_dim
        for label, hb, kvb in serving_heads(cfg):
            errs = {}
            for dtype in ("float32", "bfloat16"):
                q, k, v = _flash_inputs(rng, b, s, s, hb, kvb, hd, dtype)
                errs[dtype] = _flash_check(
                    q, k, v, True, window, dtype,
                    f"flash {dtype} {arch} serving shape ({label}, h={hb} "
                    f"kvh={kvb} hd={hd} window={window})")
            ms = graph_ms(lambda: flash_attention_cuda(q, k, v,
                                                       window=window), 20)
            at[(arch, label)] = (q, k, v, window, errs, ms)
            tflops = 4.0 * b * hb * hd * _visible_pairs(s, window) / (
                ms * 1e-3) / 1e12
            log(f"flash_attention at {arch}'s serving shape of the {label}: "
                f"b={b} s={s} h={hb} kvh={kvb} hd={hd} causal window="
                f"{window}: matches the twin (max abs err float32 "
                f"{errs['float32']:.3e}, bfloat16 {errs['bfloat16']:.3e}); "
                f"bfloat16 {ms:.4f} ms/call, {tflops:.1f} TFLOP/s, "
                f"tensor-core step {kernel_step(hd)}")
    # the record holds TinyLlama's full forward's shape; its "hd128" entry
    # qwen2-moe's, "hd256" recurrentgemma's (whose branches run the same
    # 16/1 heads), "hd112" kimi-k2's, "hd192" nemotron-4's, "hd128_g7"
    # qwen2-vl's (28/4 heads), "hd64_g1" musicgen's self attention (24/24),
    # "hd256_windowed" a 4096-token shape where the 2048-token window
    # bites, "cross" and "cross_decode" musicgen's cross attention
    records = {}
    for arch, key in ((SERVE_ARCHS[0], None), ("qwen2-moe-a2.7b", "hd128"),
                      ("recurrentgemma-9b", "hd256"),
                      ("kimi-k2-1t-a32b", "hd112"),
                      ("nemotron-4-340b", "hd192"),
                      ("qwen2-vl-7b", "hd128_g7"),
                      ("musicgen-medium", "hd64_g1")):
        label = serving_heads(get_config(arch))[0][0]
        q, k, v, window, errs, ms = at[(arch, label)]
        records[key] = _flash_timed(f"{arch}'s full forward's shape", q, k,
                                    v, window, errs["bfloat16"], ms)
    b, s, h, kvh, hd, window = FLASH_WINDOWED
    q, k, v = _flash_inputs(rng, b, s, s, h, kvh, hd, "bfloat16")
    err = _flash_check(q, k, v, True, window, "bfloat16",
                       f"flash bfloat16 {FLASH_WINDOWED} windowed")
    ms = graph_ms(lambda: flash_attention_cuda(q, k, v, window=window), 10)
    records["hd256_windowed"] = _flash_timed(
        f"a windowed shape b={b} s={s} h={h} kvh={kvh} hd={hd} "
        f"window={window}", q, k, v, window, err, ms)
    for key, (b, sq, sk, h, kvh, hd) in FLASH_CROSS:
        errs = {}
        for dtype in ("float32", "bfloat16"):
            q, k, v = _flash_inputs(rng, b, sq, sk, h, kvh, hd, dtype)
            errs[dtype] = _flash_check(
                q, k, v, False, 0, dtype, f"flash {dtype} musicgen's cross "
                f"attention {(b, sq, sk, h, kvh, hd)} non-causal")
        ms = graph_ms(lambda: flash_attention_cuda(q, k, v, causal=False),
                      50)
        records[key] = _flash_timed(
            f"musicgen's cross attention b={b} sq={sq} sk={sk} h={h} "
            f"kvh={kvh} hd={hd} non-causal (float32 err "
            f"{errs['float32']:.3e})", q, k, v, 0, errs["bfloat16"], ms,
            causal=False)
    rec = records.pop(None)
    for key, sub in records.items():
        rec[key] = {name: sub[name] for name in (
            "shape", "step", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
    rec["decode"] = flash_positions_phase(rng)
    return rec


def ring_positions(b, W, valid):
    """Decode's positions over a ring of W slots of which ``valid`` are
    written: the query at 1, written slots at 0, the others at 2**30
    (``models.attention.decode_attention``)."""
    import torch
    from repro_torch.models.attention import UNWRITTEN
    pos_k = torch.full((b, W), UNWRITTEN, dtype=torch.int32, device="cuda")
    pos_k[:, :valid] = 0
    return torch.ones((b, 1), dtype=torch.int32, device="cuda"), pos_k


def prefill_positions(b, s, kind):
    """Explicit prefill positions: rows offset by 5 + 300·row, or two
    packed sequences per row, each counting from 0."""
    import torch
    ar = torch.arange(s, dtype=torch.int32, device="cuda")
    if kind == "offset":
        off = 5 + 300 * torch.arange(b, dtype=torch.int32, device="cuda")
        return (ar[None] + off[:, None]).contiguous()
    cut = s // 3
    row = torch.where(ar < cut, ar, ar - cut)
    return row[None].expand(b, s).contiguous()


def flash_positions_phase(rng):
    """Flash attention with explicit positions against its twin in float32
    and bfloat16: every decode shape of the serving models (sq=1 over the
    ring, with 1 to all slots written) and FLASH_POS_CASES; without
    positions the same inputs give the implicit kernel's bits.  Times the
    bfloat16 kernel at each decode shape from CUDA graphs (the ring a step
    after the 1024-token prompt: 1025 slots written), beside the twin and
    scaled_dot_product_attention with the equivalent boolean mask (a
    yardstick only).  Returns the per-shape records."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import attention_ref
    b, W = SERVE["batch"], SERVE["seq"] + DECODE["headroom"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    out = {}
    for dtype in ("float32", "bfloat16"):
        for h, kvh, hd, key in FLASH_DECODE_HEADS:
            q, k, v = _flash_inputs(rng, b, 1, W, h, kvh, hd, dtype)
            err = 0.0
            for valid in FLASH_DECODE_VALID:
                pq, pk = ring_positions(b, W, valid)
                err = max(err, _flash_check(
                    q, k, v, True, 0, dtype, f"flash {dtype} decode h={h} "
                    f"kvh={kvh} hd={hd} ring {valid}/{W}", pq, pk))
            worst[dtype] = max(worst[dtype], err)
            if dtype != "bfloat16":
                continue
            valid = SERVE["seq"] + 1
            pq, pk = ring_positions(b, W, valid)
            ms = graph_ms(lambda: flash_attention_cuda(
                q, k, v, pos_q=pq, pos_k=pk), 50)
            plain_ms = cuda_ms(lambda: attention_ref(q, k, v, pos_q=pq,
                                                     pos_k=pk), 5)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = (pk >= 0) & (pq >= pk)                  # (b, W)
            mask = mask[:, None, None, :]
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
            lib_err = float((lib.transpose(1, 2).float() - flash_attention_cuda(
                q, k, v, pos_q=pq, pos_k=pk).float()).abs().max())
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 50)
            # the visible keys' K and V, q and the output, the positions;
            # QK^T and PV over the visible keys on bf16 tensor cores
            kv_bytes = 2 * b * valid * kvh * hd * k.element_size()
            rec = _record("flash_attention",
                          "src/repro_torch/kernels/csrc/flash_attention.cu",
                          "src/repro/kernels/flash_attention.py:87", err, ms,
                          plain_ms, kv_bytes + _nbytes([q, q, pq, pk]),
                          4.0 * b * h * hd * valid, peak=H100_BF16_S,
                          library_ms=library_ms)
            rec["shape"] = {"b": b, "sq": 1, "sk": W, "valid": valid, "h": h,
                            "kvh": kvh, "hd": hd}
            out[key] = {name: rec[name] for name in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
            log(f"flash_attention decode shape b={b} h={h} kvh={kvh} hd={hd}"
                f" ring {valid}/{W}, bfloat16: {ms:.4f} ms/call (twin "
                f"{plain_ms:.4f}, scaled_dot_product_attention with a "
                f"boolean mask {library_ms:.4f} ms/call, which differs by "
                f"{lib_err:.3e} at most), bound {rec['bound_ms']:.5f} ms "
                f"({rec['bound_by']})")
    # what explicit positions cost a prefill: TinyLlama's serving shape
    # with positions 0..s-1 given (every key tile visited, every score
    # masked by position) against the implicit ones, in turns
    s = SERVE["seq"]
    q, k, v = _flash_inputs(rng, b, s, s, 32, 4, 64, "bfloat16")
    pos = torch.arange(s, dtype=torch.int32, device="cuda").expand(
        b, s).contiguous()
    runs = {"implicit": [], "explicit": []}
    for name in ("implicit", "explicit", "explicit", "implicit"):
        kw = dict(pos_q=pos, pos_k=pos) if name == "explicit" else {}
        runs[name].append(graph_ms(lambda: flash_attention_cuda(q, k, v,
                                                                **kw), 20))
    same = torch.equal(flash_attention_cuda(q, k, v),
                       flash_attention_cuda(q, k, v, pos_q=pos, pos_k=pos))
    out["prefill_positions_ms"] = runs
    log(f"flash_attention at TinyLlama's prefill shape b={b} s={s} h=32 "
        f"kvh=4 hd=64, bfloat16: implicit positions "
        f"{[round(t, 5) for t in runs['implicit']]} ms/call, explicit 0..s-1 "
        f"{[round(t, 5) for t in runs['explicit']]} ms/call (every key tile "
        f"visited, every score masked); the same bits: {same}")
    for b2, s2, h, kvh, hd, window, kind in FLASH_POS_CASES:
        for dtype in ("float32", "bfloat16"):
            q, k, v = _flash_inputs(rng, b2, s2, s2, h, kvh, hd, dtype)
            pos = prefill_positions(b2, s2, kind)
            err = _flash_check(q, k, v, True, window, dtype,
                               f"flash {dtype} {kind} positions "
                               f"{(b2, s2, h, kvh, hd)} window={window}",
                               pos, pos)
            worst[dtype] = max(worst[dtype], err)
    log(f"flash_attention with explicit positions ({len(FLASH_DECODE_HEADS)}"
        f" decode shapes x {len(FLASH_DECODE_VALID)} rings, "
        f"{len(FLASH_POS_CASES)} offset / packed prefills) matches the twin:"
        f" max abs err float32 {worst['float32']:.3e}, bfloat16 "
        f"{worst['bfloat16']:.3e}, bitwise repeatable")
    out["max_abs_err"] = max(worst.values())
    return out


def _flash_timed(where, q, k, v, window, err, ms, causal=True):
    """The flash record at one bfloat16 shape the kernel was held at: the
    twin's time and the library's scaled_dot_product_attention's beside the
    kernel's, and the bound from the visible (query, key) pairs (every
    pair when not ``causal``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     kernel_step)
    from repro_torch.kernels.ref import attention_ref
    b, s, h, hd = q.shape
    sk = k.shape[1]
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=causal,
                                             window=window), 2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if not causal:
        lib_kw = {}
    elif window and window < s:
        pos = torch.arange(s, device="cuda")
        lag = pos[:, None] - pos[None, :]
        lib_kw = dict(attn_mask=(lag >= 0) & (lag < window))
    else:
        lib_kw = dict(is_causal=True)
    # visible (query, key) pairs: every query sees min(i + 1, window)
    pairs = _visible_pairs(s, window) if causal else s * sk
    lib = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                         **lib_kw)
    lib_err = float((lib.transpose(1, 2).float() - flash_attention_cuda(
        q, k, v, causal=causal, window=window).float()).abs().max())
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **lib_kw), 10)
    # QK^T and PV over the visible pairs, on bf16 tensor cores; bytes: q,
    # k, v read once and an output of q's size written once
    flops = 4.0 * b * h * hd * pairs
    rec = _record("flash_attention",
                  "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:87", err, ms,
                  plain_ms, _nbytes([q, k, v, q]), flops, peak=H100_BF16_S,
                  library_ms=library_ms)
    rec["shape"] = {"b": b, "s": s, "h": h, "kvh": k.shape[2], "hd": hd,
                    "window": window}
    if not causal:
        rec["shape"].update(sk=sk, causal=False)
    rec["step"] = kernel_step(hd)
    log(f"flash_attention at {where}, bfloat16, tensor-core step "
        f"{rec['step']}: {ms:.4f} ms/call (twin "
        f"{plain_ms:.4f} ms/call, scaled_dot_product_attention "
        f"{library_ms:.4f} ms/call, which differs from the kernel by "
        f"{lib_err:.3e} at most), bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']}), {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    return rec


def _route_logits(rng, G, gs, E):
    """Logits on a grid of 2^-10: exact ties break by index on both sides,
    and every other gap is far above an ulp of the probabilities."""
    import torch
    return torch.from_numpy(np.round(rng.randn(G, gs, E) * 1024) / 1024) \
        .float().cuda()


def _route_check(logits, k, where):
    """moe_route's kernel vs its twin: ids and slots exactly, gates within
    GATE_ATOL, two runs bitwise equal; returns the largest gate error."""
    import torch
    from repro_torch.kernels.moe_route import moe_route_cuda
    from repro_torch.kernels.ref import moe_route_ref
    got = moe_route_cuda(logits, k)
    again = moe_route_cuda(logits, k)
    want = moe_route_ref(logits, k)
    torch.cuda.synchronize()
    for name, a, b in zip(("eid", "slot"), got[::2], want[::2]):
        if a.dtype != torch.int32 or not torch.equal(a, b):
            raise AssertionError(f"{where}: {name} differs from the twin at "
                                 f"{int((a != b).sum())} entries")
    err = float((got[1] - want[1]).abs().max())
    if not err <= GATE_ATOL:
        raise AssertionError(f"{where}: gate max abs err {err:.3e} > "
                             f"{GATE_ATOL}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{where}: two runs differ")
    return err


def moe_route_phase():
    """moe_route vs its twin on the card at the reference's test shapes,
    the serving shape, several overflowing groups and an underflowing row;
    times the kernel and the twin at the serving shape."""
    import torch
    from repro_torch.kernels.moe_route import moe_route_cuda, moe_route_plan
    from repro_torch.kernels.ref import moe_route_ref
    rng = np.random.RandomState(0)
    worst = 0.0
    for G, gs, E, k in MOE_ROUTE_CASES:
        logits = _route_logits(rng, G, gs, E)
        err = _route_check(logits, k, f"moe_route {(G, gs, E, k)}")
        worst = max(worst, err)
        if (G, gs, E, k) == MOE_OVERFLOW:
            # capacity factor 1.0 as the model computes it
            C = max(int(gs * k / E * 1.0), k)
            slot = moe_route_cuda(logits, k)[2]
            dropped = int((slot >= C).sum())
            if dropped == 0:
                raise AssertionError("moe_route: the multi-group case "
                                     "overflows no expert")
            log(f"moe_route {G} groups of {gs}: {dropped} entries past "
                f"capacity {C} (cf 1.0), slots as the twin's")
    under = torch.tensor([[0.0, -200.0, -200.0, -200.0]], device="cuda")
    _route_check(under, 2, "moe_route underflow")
    eid = moe_route_cuda(under, 2)[0]
    if eid.tolist() != [[0, 1]]:
        raise AssertionError(f"moe_route underflow: experts {eid.tolist()}")
    log(f"moe_route at {len(MOE_ROUTE_CASES)} shapes and an underflowing row "
        f"matches the twin: ids and slots exactly, gates max abs err "
        f"{worst:.3e} (atol {GATE_ATOL}), bitwise repeatable; underflow "
        f"picks distinct experts {eid.tolist()}")
    G, gs, E, k = MOE_SERVING
    logits = _route_logits(rng, G, gs, E)
    err = _route_check(logits, k, "moe_route serving shape")
    # a call is as short as the Python wrapper: the graph time is the
    # device's, the event time around plain calls includes the host's
    ms = graph_ms(lambda: moe_route_cuda(logits, k), 50)
    ev_ms = cuda_ms(lambda: moe_route_cuda(logits, k), 50)
    plain_ms = cuda_ms(lambda: moe_route_ref(logits, k), 5)
    out = moe_route_cuda(logits, k)
    # softmax: exp, sum, divide per logit; top-k: k compares per logit
    rec = _record("moe_route", "src/repro_torch/kernels/csrc/moe_route.cu",
                  "src/repro/kernels/moe_route.py:83", err, ms, plain_ms,
                  _nbytes([logits] + list(out)), (3.0 + k) * logits.numel(),
                  peak=H100_FP32_S)
    rec["event_ms"] = ev_ms
    rec["plan"] = moe_route_plan(gs, E, k)
    log(f"moe_route at qwen2-moe's serving shape G={G} gs={gs} E={E} k={k} "
        f"({rec['plan']}): {ms:.4f} ms/call from CUDA graphs ({ev_ms:.4f} "
        f"with CUDA events around wrapper calls; twin {plain_ms:.4f} "
        f"ms/call), bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}); no "
        f"single PyTorch call computes it")
    rec["decode"] = _moe_route_decode(rng)
    return rec


def _moe_route_decode(rng):
    """moe_route at a decode step's shape (MOE_DECODE) against its twin,
    timed from CUDA graphs; returns its record."""
    from repro_torch.kernels.moe_route import moe_route_cuda, moe_route_plan
    from repro_torch.kernels.ref import moe_route_ref
    G, gs, E, k = MOE_DECODE
    logits = _route_logits(rng, G, gs, E)
    err = _route_check(logits, k, "moe_route decode shape")
    out = moe_route_cuda(logits, k)
    dec = _record("moe_route", "", "", err,
                  graph_ms(lambda: moe_route_cuda(logits, k), 50),
                  cuda_ms(lambda: moe_route_ref(logits, k), 5),
                  _nbytes([logits] + list(out)), (3.0 + k) * logits.numel(),
                  peak=H100_FP32_S)
    rec = {name: dec[name] for name in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    rec["shape"] = {"G": G, "gs": gs, "E": E, "k": k}
    rec["plan"] = moe_route_plan(gs, E, k)
    log(f"moe_route at a decode step's shape G={G} gs={gs} E={E} k={k} "
        f"({rec['plan']}): matches the twin, {dec['ms']:.4f} ms/call from "
        f"CUDA graphs (twin {dec['plain_ms']:.4f}), bound "
        f"{dec['bound_ms']:.6f} ms")
    return rec


def _scan_inputs(gen, b, s, d, n, dtype):
    """The reference test's distributions (dA uniform in [0.5, 1), dBx
    0.1·normal, C normal), drawn on the card from ``gen``."""
    import torch
    kw = dict(generator=gen, device="cuda")
    return ((0.5 + 0.5 * torch.rand((b, s, d, n), **kw)).to(dtype),
            (0.1 * torch.randn((b, s, d, n), **kw)).to(dtype),
            torch.randn((b, s, n), **kw).to(dtype))


def _scan_check(dA, dBx, C, where):
    """selective_scan's kernel vs its twin at rtol/atol SCAN_TOL, two runs
    bitwise equal; returns the largest absolute difference."""
    import torch
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    got = selective_scan_cuda(dA, dBx, C)
    again, h = selective_scan_cuda(dA, dBx, C, final_state=True)
    want, h_want = selective_scan_ref(dA, dBx, C, final_state=True)
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or got.shape != want.shape:
        raise AssertionError(f"{where}: y {got.dtype} {tuple(got.shape)}")
    if h.dtype != torch.float32 or h.shape != h_want.shape:
        raise AssertionError(f"{where}: h_final {h.dtype} "
                             f"{tuple(h.shape)}")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=SCAN_TOL, atol=SCAN_TOL):
        raise AssertionError(f"{where}: kernel vs twin max abs err "
                             f"{err:.3e}")
    if not torch.allclose(h, h_want, rtol=SCAN_TOL, atol=SCAN_TOL):
        raise AssertionError(f"{where}: h_final vs twin max abs err "
                             f"{float((h - h_want).abs().max()):.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"{where}: two runs differ")
    return max(err, float((h - h_want).abs().max()))


def selective_scan_phase():
    """selective_scan vs its twin on the card at the reference's test
    shapes and falcon-mamba's serving shape, float32 and bfloat16 inputs;
    times the kernel and the twin at the serving shape in float32."""
    import torch
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in SCAN_CASES:
            err = _scan_check(*_scan_inputs(gen, *case, dtype),
                              f"selective_scan {case} {dtype}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    log(f"selective_scan at the reference's {len(SCAN_CASES)} test shapes "
        f"matches the twin, y and h_final (rtol/atol {SCAN_TOL}; y without "
        f"h_final the same bits): max abs err float32 "
        f"{worst[torch.float32]:.3e}, bfloat16 inputs "
        f"{worst[torch.bfloat16]:.3e}; bitwise repeatable")
    b, s, d, n = SCAN_SERVING
    args = _scan_inputs(gen, b, s, d, n, torch.bfloat16)
    err16 = _scan_check(*args, "selective_scan serving shape bfloat16")
    ms16 = cuda_ms(lambda: selective_scan_cuda(*args), 10)
    args = _scan_inputs(gen, b, s, d, n, torch.float32)
    err = _scan_check(*args, "selective_scan serving shape float32")
    ms = cuda_ms(lambda: selective_scan_cuda(*args), 10)
    plain_ms = cuda_ms(lambda: selective_scan_ref(*args), 1)
    y = selective_scan_cuda(*args)
    nbytes = _nbytes(list(args) + [y])
    # the recurrence's multiply-add and y's multiply-add per state
    rec = _record("selective_scan",
                  "src/repro_torch/kernels/csrc/selective_scan.cu",
                  "src/repro/kernels/selective_scan.py:61", err, ms,
                  plain_ms, nbytes, 4.0 * b * s * d * n,
                  peak=H100_FP32_S)
    log(f"selective_scan at falcon-mamba's serving shape b={b} s={s} "
        f"d_in={d} n={n}: matches the twin (max abs err float32 {err:.3e}, "
        f"bfloat16 inputs {err16:.3e}), bitwise repeatable; float32 "
        f"{ms:.4f} ms/call (twin {plain_ms:.4f} ms/call), bfloat16 inputs "
        f"{ms16:.4f} ms/call; bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']}), {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s; "
        f"no single PyTorch call computes it")
    return rec


def rglru_scan_phase():
    """rglru_scan vs its twin on the card at the reference's test shapes
    and recurrentgemma's serving shape, float32 and bfloat16 inputs (the
    reference test's distributions: a in [0.8, 1), bx 0.1·normal); times
    the kernel and the twin at the serving shape."""
    import torch
    from repro_torch.kernels.ref import rglru_scan_ref
    from repro_torch.kernels.rglru_scan import rglru_scan_cuda
    gen = torch.Generator(device="cuda").manual_seed(2)
    at = {}
    for dtype in ("float32", "bfloat16"):
        worst, exact = 0.0, True
        for shape in RGLRU_CASES + [RGLRU_SERVING]:
            a = (0.8 + 0.2 * torch.rand(shape, generator=gen, device="cuda")
                 ).to(getattr(torch, dtype))
            bx = (0.1 * torch.randn(shape, generator=gen, device="cuda")
                  ).to(getattr(torch, dtype))
            got = rglru_scan_cuda(a, bx)
            again = rglru_scan_cuda(a, bx)
            want = rglru_scan_ref(a, bx)
            torch.cuda.synchronize()
            where = f"rglru_scan {shape} {dtype}"
            if got.dtype != torch.float32 or got.shape != want.shape:
                raise AssertionError(f"{where}: h {got.dtype} "
                                     f"{tuple(got.shape)}")
            err = float((got - want).abs().max())
            if not err <= RGLRU_ATOL[dtype]:
                raise AssertionError(f"{where}: kernel vs twin max abs err "
                                     f"{err:.3e} > {RGLRU_ATOL[dtype]}")
            if not torch.equal(got, again):
                raise AssertionError(f"{where}: two runs differ")
            worst, exact = max(worst, err), exact and torch.equal(got, want)
        ms = cuda_ms(lambda: rglru_scan_cuda(a, bx), 20)
        at[dtype] = (a, bx, got, worst, exact, ms)
        log(f"rglru_scan {dtype} at the reference's {len(RGLRU_CASES)} test "
            f"shapes and recurrentgemma's serving shape b, s, w = "
            f"{RGLRU_SERVING}: matches the twin (max abs err {worst:.3e}, "
            f"atol {RGLRU_ATOL[dtype]}; equal bitwise: {exact}), bitwise "
            f"repeatable; {ms:.4f} ms/call at the serving shape, "
            f"{_nbytes([a, bx, got]) / (ms * 1e-3) / 1e12:.3f} TB/s")
    a, bx, h, worst, exact, ms = at["float32"]
    plain_ms = cuda_ms(lambda: rglru_scan_ref(a, bx), 1)
    b, s, w = RGLRU_SERVING
    # a product and a sum per element
    rec = _record("rglru_scan", "src/repro_torch/kernels/csrc/rglru_scan.cu",
                  "src/repro/kernels/rglru_scan.py:53", worst, ms, plain_ms,
                  _nbytes([a, bx, h]), 2.0 * b * s * w, peak=H100_FP32_S)
    rec["bitwise_equal_twin"] = exact
    rec["ms_bfloat16"] = at["bfloat16"][5]
    log(f"rglru_scan at recurrentgemma's serving shape, float32: {ms:.4f} "
        f"ms/call (twin {plain_ms:.4f} ms/call), bfloat16 inputs "
        f"{rec['ms_bfloat16']:.4f} ms/call; bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']}); no single PyTorch call computes it")
    return rec


# ------------------------------------------------------ training kernels

#: the backward kernels' tolerance against their twins, of each output's
#: largest entry
TRAIN_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: flash backward shapes (b, sq, sk, h, kvh, hd, causal, window, key):
#: the training shape of TinyLlama-1.1B (the main path's, the kernels
#: line's entry itself), qwen2-moe's heads at hd=128, recurrentgemma's at
#: hd=256 where its 2048-token window bites, the wide blocks'
#: (WIDE_ARCHS): kimi-k2's 64/8 at hd=112, nemotron-4's 96/8 at hd=192,
#: and the two shapes only the multimodal families train: musicgen's
#: cross attention (1024 queries over the 64 ``cond`` keys, non-causal,
#: 24/24 heads) and qwen2-vl's group of 7 (28/4 heads at hd=128)
TRAIN_FLASH = [(8, 256, 256, 32, 4, 64, True, 0, "hd64"),
               (4, 1024, 1024, 16, 16, 128, True, 0, "hd128"),
               (1, 4096, 4096, 16, 1, 256, True, 2048, "hd256"),
               (4, 1024, 1024, 64, 8, 112, True, 0, "hd112"),
               (4, 1024, 1024, 96, 8, 192, True, 0, "hd192"),
               (4, 1024, 64, 24, 24, 64, False, 0, "cross"),
               (4, 1024, 1024, 28, 4, 128, True, 0, "hd128_g7")]
#: TRAIN_FLASH's entries also held in float32, at FLASH_ATOL (the
#: forward's tolerance, tighter than TRAIN_ATOL's)
TRAIN_FLASH_F32 = ("cross", "hd128_g7")
TRAIN_SCAN = (4, 1024, 8192, 16)
#: the shape the falcon-mamba training path launches (b=1 per microbatch)
TRAIN_SCAN_STEP = (1, 1024, 8192, 16)
TRAIN_RGLRU = (4, 1024, 4096)
#: the shape the recurrentgemma training path launches (b=1 per
#: microbatch)
TRAIN_RGLRU_STEP = (1, 1024, 4096)
#: an rglru backward shape whose s the kernel's register buffers do not
#: divide
RGLRU_BWD_RAGGED = (1, 1001, 96)
TRAIN_ROUTE = (1, 4096, 60, 4)
#: the gate backward at kimi-k2's routing (384 experts, top-8) and the
#: widest E, beside MOE_ROUTE_CASES
ROUTE_BWD_WIDE = [(1, 512, 384, 8), (1, 256, 1024, 8)]


def _scaled_err(got, want, where, atol, floor=1e-30):
    """The largest |got - want|; raises past ``atol`` times want's largest
    entry (at least ``floor``)."""
    err = float((got.float() - want.float()).abs().max())
    scale = max(float(want.float().abs().max()), floor)
    if not err <= atol * scale:
        raise AssertionError(f"{where}: max abs err {err:.3e} > {atol} x "
                             f"scale {scale:.3e}")
    return err


def _flash_train_check(q, k, v, causal, window, dtype, where, pos_q=None,
                       pos_k=None, autograd=True, atol=None):
    """The forward with its logsumexp (output bitwise the serving
    forward's), the backward kernel against its twin (each fed its own
    forward) and against autograd of ``attention_ref``, two backward runs
    bitwise equal, within ``atol`` (TRAIN_ATOL's unless given) of each
    output's scale.  Returns (largest absolute error, do)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.ref import attention_bwd_ref, attention_ref
    kw = dict(causal=causal, window=window, pos_q=pos_q, pos_k=pos_k)
    atol = TRAIN_ATOL[dtype] if atol is None else atol
    out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    if not torch.equal(out, flash_attention_cuda(q, k, v, **kw)):
        raise AssertionError(f"{where}: the forward with lse differs from "
                             f"the forward without")
    want_o, want_lse = attention_ref(q, k, v, return_lse=True, **kw)
    fin = torch.isfinite(want_lse)
    if not torch.equal(fin, torch.isfinite(lse)):
        raise AssertionError(f"{where}: lse's +inf rows differ")
    worst = _scaled_err(lse[fin], want_lse[fin], f"{where} lse", 1e-5)
    gen = torch.Generator(device="cuda").manual_seed(q.numel() % 9973)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    want = attention_bwd_ref(q, k, v, want_o, want_lse, do, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if a.dtype != q.dtype or a.shape != b.shape:
            raise AssertionError(f"{where}: {name} {a.dtype} "
                                 f"{tuple(a.shape)}")
        worst = max(worst, _scaled_err(a, b, f"{where} {name} vs twin",
                                       atol))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{where}: two backward runs differ")
    if autograd:
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        ref = torch.autograd.grad(attention_ref(qs, ks, vs, **kw),
                                  (qs, ks, vs), do)
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            worst = max(worst, _scaled_err(
                a, b, f"{where} {name} vs autograd of attention_ref", atol))
    torch.cuda.synchronize()
    return worst, do


def _flash_bwd_bound(b, sq, sk, h, kvh, hd, causal, window, dtype_bytes):
    """(bytes, operations) of the backward: q, k, v, o, dO and lse read
    once, dq, dk, dv written once; the five products over the visible
    pairs (S, dV, dP, dQ, dK): a causal self attention's (sq = sk), or
    every pair without a mask."""
    pairs = _visible_pairs(sq, window) if causal else sq * sk
    q_elems, kv_elems = b * sq * h * hd, 2 * b * sk * kvh * hd
    reads = 3 * q_elems + kv_elems          # q, o, dO; k, v
    writes = q_elems + kv_elems             # dq; dk, dv
    nbytes = (reads + writes) * dtype_bytes + b * h * sq * 4
    return nbytes, 10.0 * b * h * hd * pairs


def sdpa_bwd_ms(q, k, v, do, lib_kw, reps=5):
    """Device ms of ``scaled_dot_product_attention``'s backward on (b, h,
    s, hd) inputs that require grad: a CUDA graph of its forward and
    backward (``autograd.grad``) less a graph of its forward alone, both
    as ``graph_ms`` times them."""
    import torch
    import torch.nn.functional as F

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                              **lib_kw)
    both = graph_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), do),
                    reps)
    return both - graph_ms(fwd, reps)


def train_flash_phase():
    """The flash backward on the card: the reference's test shapes and the
    bfloat16 kernel's tile edges (float32 and bfloat16), explicit
    positions, TRAIN_FLASH_F32's shapes in float32, then TRAIN_FLASH in
    bfloat16; timed (CUDA graphs) at the
    training shape beside the twin and the library's
    ``scaled_dot_product_attention`` backward (``sdpa_bwd_ms``; a
    yardstick only, the port never calls it)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.ref import attention_bwd_ref, attention_ref
    rng = np.random.RandomState(3)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype in ("float32", "bfloat16"):
        for b, sq, sk, h, kvh, hd, causal, window in FLASH_CASES + \
                FLASH_EDGES:
            q, k, v = _flash_inputs(rng, b, sq, sk, h, kvh, hd, dtype)
            err, _ = _flash_train_check(
                q, k, v, causal, window, dtype,
                f"flash bwd {dtype} {(b, sq, sk, h, kvh, hd)} "
                f"causal={causal} window={window}")
            worst[dtype] = max(worst[dtype], err)
            n += 1
        for b, s, h, kvh, hd, window, kind in FLASH_POS_CASES:
            q, k, v = _flash_inputs(rng, b, s, s, h, kvh, hd, dtype)
            pos = prefill_positions(b, s, kind)
            err, _ = _flash_train_check(
                q, k, v, True, window, dtype,
                f"flash bwd {dtype} {kind} positions {(b, s, h, kvh, hd)}",
                pos_q=pos, pos_k=pos)
            worst[dtype] = max(worst[dtype], err)
            n += 1
    log(f"flash_attention backward at {n} shapes (the reference's test "
        f"cases, the tile edges and explicit positions, float32 and "
        f"bfloat16) matches its twin and autograd of attention_ref "
        f"(atol {TRAIN_ATOL['float32']} / {TRAIN_ATOL['bfloat16']} of each "
        f"output's scale): max abs err float32 {worst['float32']:.3e}, "
        f"bfloat16 {worst['bfloat16']:.3e}; the "
        f"forward with lse gives the serving forward's bits; two backward "
        f"runs bitwise equal")
    f32 = {}
    for b, sq, sk, h, kvh, hd, causal, window, key in TRAIN_FLASH:
        if key not in TRAIN_FLASH_F32:
            continue
        q, k, v = _flash_inputs(rng, b, sq, sk, h, kvh, hd, "float32")
        f32[key], _ = _flash_train_check(
            q, k, v, causal, window, "float32",
            f"flash bwd float32 {key} {(b, sq, sk, h, kvh, hd)} "
            f"causal={causal}", atol=FLASH_ATOL["float32"])
        log(f"flash bwd float32 {key} b={b} sq={sq} sk={sk} h={h} "
            f"kvh={kvh} hd={hd} causal={causal}: matches the twin and "
            f"autograd of attention_ref within {FLASH_ATOL['float32']} of "
            f"each output's scale, two runs bitwise equal; max abs err "
            f"{f32[key]:.3e}")
        del q, k, v
    rec = None
    for b, sq, sk, h, kvh, hd, causal, window, key in TRAIN_FLASH:
        q, k, v = _flash_inputs(rng, b, sq, sk, h, kvh, hd, "bfloat16")
        where = f"flash bwd bfloat16 {key} b={b} sq={sq} sk={sk} h={h} " \
                f"kvh={kvh} hd={hd} causal={causal} window={window}"
        err, do = _flash_train_check(q, k, v, causal, window, "bfloat16",
                                     where, autograd=sq <= 1024)
        kw = dict(causal=causal, window=window)
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
        ms = graph_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse,
                                                       do, **kw), 5)
        fwd_ms = graph_ms(lambda: flash_attention_cuda(q, k, v, **kw), 10)
        fwd_lse_ms = graph_ms(lambda: flash_attention_cuda(
            q, k, v, with_lse=True, **kw), 10)
        want_o, want_lse = attention_ref(q, k, v, return_lse=True, **kw)
        plain_ms = cuda_ms(lambda: attention_bwd_ref(
            q, k, v, want_o, want_lse, do, **kw), 2)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        if not causal:
            lib_kw = {}
        elif window and window < sq:
            pos = torch.arange(sq, device="cuda")
            lag = pos[:, None] - pos[None, :]
            lib_kw = dict(attn_mask=(lag >= 0) & (lag < window))
        else:
            lib_kw = dict(is_causal=True)
        library_ms = sdpa_bwd_ms(qt, kt, vt, do.transpose(1, 2), lib_kw)
        nbytes, flops = _flash_bwd_bound(b, sq, sk, h, kvh, hd, causal,
                                         window, 2)
        sub = _record("flash_attention_bwd",
                      "src/repro_torch/kernels/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:87", err, ms,
                      plain_ms, nbytes, flops, peak=H100_BF16_S,
                      library_ms=library_ms)
        sub["shape"] = {"b": b, "sq": sq, "sk": sk, "h": h, "kvh": kvh,
                        "hd": hd, "causal": causal, "window": window}
        if key in f32:
            sub["max_abs_err_float32"] = f32[key]
        sub["forward_ms"] = fwd_ms
        sub["forward_lse_ms"] = fwd_lse_ms
        log(f"{where}: backward {ms:.4f} ms/call (CUDA graphs; twin "
            f"{plain_ms:.3f}, scaled_dot_product_attention's backward "
            f"{library_ms:.4f} ms/call from graphs), bound "
            f"{sub['bound_ms']:.5f} ms ({sub['bound_by']}), "
            f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s (five products); "
            f"forward without "
            f"lse {fwd_ms:.4f} ms, with lse {fwd_lse_ms:.4f} ms; max abs "
            f"err {err:.3e}")
        del qt, kt, vt, want_o, want_lse
        if rec is None:
            rec = sub
            rec["gradient_of"] = "flash_attention"
        else:
            rec[key] = {name: sub[name] for name in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "forward_ms",
                "forward_lse_ms", "max_abs_err_float32") if name in sub}
    return rec


def train_scan_phase():
    """selective_scan's and rglru_scan's backward kernels against their
    twins: the reference's test shapes and the model's (float32 and
    bfloat16 inputs), two runs bitwise equal; timed at TRAIN_SCAN and
    TRAIN_RGLRU in float32 (CUDA graphs)."""
    import torch
    from repro_torch.kernels.ref import (rglru_scan_bwd_ref,
                                         rglru_scan_ref,
                                         selective_scan_bwd_ref)
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda
    from repro_torch.kernels.selective_scan import selective_scan_bwd_cuda
    gen = torch.Generator(device="cuda").manual_seed(4)
    recs = []
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in SCAN_CASES + [TRAIN_SCAN_STEP, TRAIN_SCAN]:
            dA, dBx, C = _scan_inputs(gen, *case, dtype)
            gy = torch.randn(case[:3], generator=gen, device="cuda")
            where = f"selective_scan bwd {case} {dtype}"
            got = selective_scan_bwd_cuda(dA, dBx, C, gy)
            again = selective_scan_bwd_cuda(dA, dBx, C, gy)
            want = selective_scan_bwd_ref(dA, dBx, C, gy)
            atol = TRAIN_ATOL[str(dtype).split(".")[-1]]
            err = max(_scaled_err(a, b, f"{where} {name}", atol)
                      for name, a, b in zip(("g_dA", "g_dBx", "g_C"), got,
                                            want))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{where}: two runs differ")
            if got[0].dtype != dtype or got[1].dtype != dtype:
                raise AssertionError(f"{where}: dtypes {got[0].dtype}")
            worst[("scan", dtype)] = max(worst.get(("scan", dtype), 0.0),
                                         err)
    del got, again, want
    step_ms = None
    for shape in (TRAIN_SCAN_STEP, TRAIN_SCAN):
        del dA, dBx, C
        args = (dA, dBx, C, gy) = (
            *_scan_inputs(gen, *shape, torch.float32),
            torch.randn(shape[:3], generator=gen, device="cuda"))
        ms = graph_ms(lambda: selective_scan_bwd_cuda(*args), 2)
        if shape == TRAIN_SCAN_STEP:
            step_ms = ms
    plain_ms = cuda_ms(lambda: selective_scan_bwd_ref(*args), 1)
    outs = selective_scan_bwd_cuda(*args)
    b, s, d, n = TRAIN_SCAN
    rec = _record("selective_scan_bwd",
                  "src/repro_torch/kernels/csrc/selective_scan.cu",
                  "src/repro/kernels/selective_scan.py:61",
                  worst[("scan", torch.float32)], ms, plain_ms,
                  _nbytes(list(args) + list(outs)), 8.0 * b * s * d * n,
                  peak=H100_FP32_S)
    rec["gradient_of"] = "selective_scan"
    rec["max_abs_err_bfloat16"] = worst[("scan", torch.bfloat16)]
    sb, ss, sd, sn = TRAIN_SCAN_STEP
    step_bytes = 4 * (4 * sb * ss * sd * sn + 2 * sb * ss * sn + sb * ss * sd)
    rec["training_shape"] = {"shape": list(TRAIN_SCAN_STEP), "ms": step_ms,
                             "bound_ms": step_bytes / H100_BYTES_S * 1e3,
                             "bound_by": "bytes"}
    log(f"selective_scan backward at the reference's {len(SCAN_CASES)} "
        f"test shapes, {TRAIN_SCAN_STEP} and {TRAIN_SCAN}: matches its "
        f"twin (atol 1e-4 / 2e-2 of each output's scale; max abs err "
        f"float32 {rec['max_abs_err']:.3e}, bfloat16 inputs "
        f"{rec['max_abs_err_bfloat16']:.3e}), bitwise repeatable; float32 "
        f"at {TRAIN_SCAN}: {ms:.4f} ms/call (graphs; twin {plain_ms:.2f}), "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}); at the training "
        f"path's {TRAIN_SCAN_STEP}: {step_ms:.4f} ms/call, bound "
        f"{rec['training_shape']['bound_ms']:.5f} ms (bytes)")
    recs.append(rec)
    del args, outs, dA, dBx, C
    for dtype in (torch.float32, torch.bfloat16):
        for shape in RGLRU_CASES + [RGLRU_BWD_RAGGED, TRAIN_RGLRU]:
            a = (0.8 + 0.2 * torch.rand(shape, generator=gen,
                                        device="cuda")).to(dtype)
            bx = (0.1 * torch.randn(shape, generator=gen,
                                    device="cuda")).to(dtype)
            h = rglru_scan_ref(a, bx)
            gh = torch.randn(shape, generator=gen, device="cuda")
            where = f"rglru_scan bwd {shape} {dtype}"
            got = rglru_scan_bwd_cuda(a, h, gh)
            again = rglru_scan_bwd_cuda(a, h, gh)
            want = rglru_scan_bwd_ref(a, h, gh)
            atol = TRAIN_ATOL[str(dtype).split(".")[-1]]
            err = max(_scaled_err(x, y, f"{where} {name}", atol)
                      for name, x, y in zip(("g_a", "g_bx"), got, want))
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{where}: two runs differ")
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{where}: not bitwise the twin's")
            if got[0].dtype != dtype:
                raise AssertionError(f"{where}: dtype {got[0].dtype}")
            worst[("rglru", dtype)] = max(
                worst.get(("rglru", dtype), 0.0), err)
    step_ms = None
    for shape in (TRAIN_RGLRU_STEP, TRAIN_RGLRU):
        a = (0.8 + 0.2 * torch.rand(shape, generator=gen, device="cuda"))
        bx = 0.1 * torch.randn(shape, generator=gen, device="cuda")
        h = rglru_scan_ref(a, bx)
        gh = torch.randn(shape, generator=gen, device="cuda")
        ms = graph_ms(lambda: rglru_scan_bwd_cuda(a, h, gh), 10)
        if shape == TRAIN_RGLRU_STEP:
            step_ms = ms
    plain_ms = cuda_ms(lambda: rglru_scan_bwd_ref(a, h, gh), 1)
    outs = rglru_scan_bwd_cuda(a, h, gh)
    b, s, w = TRAIN_RGLRU
    rec = _record("rglru_scan_bwd",
                  "src/repro_torch/kernels/csrc/rglru_scan.cu",
                  "src/repro/kernels/rglru_scan.py:53",
                  worst[("rglru", torch.float32)], ms, plain_ms,
                  _nbytes([a, h, gh] + list(outs)), 4.0 * b * s * w,
                  peak=H100_FP32_S)
    rec["gradient_of"] = "rglru_scan"
    rec["max_abs_err_bfloat16"] = worst[("rglru", torch.bfloat16)]
    sb, ss, sw = TRAIN_RGLRU_STEP
    rec["training_shape"] = {"shape": list(TRAIN_RGLRU_STEP), "ms": step_ms,
                             "bound_ms": 20 * sb * ss * sw / H100_BYTES_S
                             * 1e3, "bound_by": "bytes"}
    log(f"rglru_scan backward at the reference's {len(RGLRU_CASES)} test "
        f"shapes, {RGLRU_BWD_RAGGED} and {TRAIN_RGLRU}: equals its twin "
        f"bitwise in float32 and bfloat16 (max abs err "
        f"{rec['max_abs_err']:.3e} / {rec['max_abs_err_bfloat16']:.3e}), "
        f"bitwise repeatable; float32 "
        f"{ms:.4f} ms/call (graphs; twin {plain_ms:.2f}), bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}); at the training "
        f"path's {TRAIN_RGLRU_STEP}: {step_ms:.4f} ms/call, bound "
        f"{rec['training_shape']['bound_ms']:.5f} ms (bytes)")
    recs.append(rec)
    return recs


def train_route_phase():
    """moe_route's gate backward against its twin and against autograd of
    ``moe_route_ref``'s gates, at the routing test shapes and the training
    shape; two runs bitwise equal; timed from CUDA graphs at
    TRAIN_ROUTE."""
    import torch
    from repro_torch.kernels.moe_route import (moe_route_bwd_cuda,
                                               moe_route_cuda)
    from repro_torch.kernels.ref import moe_route_bwd_ref, moe_route_ref
    rng = np.random.RandomState(5)
    worst = 0.0
    for G, gs, E, k in MOE_ROUTE_CASES + ROUTE_BWD_WIDE:
        logits = _route_logits(rng, G, gs, E)
        eid = moe_route_cuda(logits, k)[0]
        g_gate = torch.from_numpy(rng.randn(G, gs, k)).float().cuda()
        where = f"moe_route bwd {(G, gs, E, k)}"
        got = moe_route_bwd_cuda(logits, eid, g_gate)
        again = moe_route_bwd_cuda(logits, eid, g_gate)
        want = moe_route_bwd_ref(logits, eid, g_gate)
        err = _scaled_err(got, want, f"{where} vs twin",
                          TRAIN_ATOL["float32"])
        lg = logits.detach().requires_grad_()
        ref = torch.autograd.grad(moe_route_ref(lg, k)[1], lg, g_gate)[0]
        # at k=1 the gate is 1 and its gradient 0: autograd's is rounding,
        # so the scale is at least the incoming gradient's
        err = max(err, _scaled_err(got, ref, f"{where} vs autograd",
                                   TRAIN_ATOL["float32"],
                                   floor=float(g_gate.abs().max())))
        if not torch.equal(got, again):
            raise AssertionError(f"{where}: two runs differ")
        worst = max(worst, err)
    G, gs, E, k = TRAIN_ROUTE
    logits = _route_logits(rng, G, gs, E)
    eid = moe_route_cuda(logits, k)[0]
    g_gate = torch.from_numpy(rng.randn(G, gs, k)).float().cuda()
    ms = graph_ms(lambda: moe_route_bwd_cuda(logits, eid, g_gate), 20)
    plain_ms = cuda_ms(lambda: moe_route_bwd_ref(logits, eid, g_gate), 5)
    out = moe_route_bwd_cuda(logits, eid, g_gate)
    rec = _record("moe_route_bwd",
                  "src/repro_torch/kernels/csrc/moe_route.cu",
                  "src/repro/kernels/moe_route.py:83", worst, ms, plain_ms,
                  _nbytes([logits, eid, g_gate, out]),
                  6.0 * G * gs * E, peak=H100_FP32_S)
    rec["gradient_of"] = "moe_route"
    log(f"moe_route's gate backward at the routing test shapes, "
        f"{ROUTE_BWD_WIDE} and {TRAIN_ROUTE}: matches its twin and autograd of moe_route_ref "
        f"(atol 1e-4 of the scale; max abs err {worst:.3e}), bitwise "
        f"repeatable; "
        f"{ms:.5f} ms/call at {TRAIN_ROUTE} (graphs; twin {plain_ms:.3f}), "
        f"bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    return rec


def train_kernels_phase():
    """Every backward kernel of the training path against its twin on the
    card; returns their records."""
    t0 = time.perf_counter()
    recs = [train_flash_phase(), *train_scan_phase(), train_route_phase()]
    log(f"train_kernels phase: {time.perf_counter() - t0:.1f} s")
    return recs


# ------------------------------------------------------------- training

#: the training CLI at the reference's defaults (TinyLlama-1.1B at full
#: width and depth, 100 steps of 8 x 256 tokens, lr 3e-4, warmup 20) and
#: the step whose state is checkpointed and restored
TRAIN_ARGV = ["--arch", "tinyllama-1.1b", "--steps", "100", "--batch", "8",
              "--seq", "256", "--lr", "3e-4", "--log-every", "10"]
TRAIN_CKPT_STEP = 50
#: the other families at full width and cut depth: layers, batch x seq,
#: steps at a constant lr; a run is cut in batch only past TRAIN_MAX_BYTES.
#: qwen2-vl-7b's 28 layers reckon 103.4 GB (``_train_bytes``), past one
#: card; musicgen-medium trains whole (its 48 layers, 24.6 GB reckoned)
TRAIN_CUT = {"qwen2-moe-a2.7b": 2, "falcon-mamba-7b": 2,
             "recurrentgemma-9b": 3, "qwen2-vl-7b": 2,
             "musicgen-medium": 48}
TRAIN_CUT_RUN = dict(batch=4, seq=1024, steps=10, lr=3e-4)
TRAIN_MAX_BYTES = 70e9
#: the reduced card-vs-CPU train steps: batch x seq, steps, the CLI's
#: schedule
STEP_CROSS = dict(batch=2, seq=12, steps=3, peak=3e-4, warmup=20,
                  total=100)


def _train_counters():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.moe_route import moe_route, moe_route_bwd
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_bwd)
    return {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "moe_route": moe_route, "moe_route_bwd": moe_route_bwd,
            "selective_scan": selective_scan,
            "selective_scan_bwd": selective_scan_bwd,
            "rglru_scan": rglru_scan, "rglru_scan_bwd": rglru_scan_bwd}


def _expected_train_launches(cfg):
    """Launches of each training kernel per step: a forward kernel
    (``LAYER_KERNELS``) twice per layer of its kinds (remat recomputes
    it), its backward once, each times the microbatches."""
    out = {}
    for name in LAYER_KERNELS:
        layers = per_forward(name, cfg.layer_kinds)
        out[name] = (2 if cfg.remat else 1) * layers * cfg.grad_accum
        out[f"{name}_bwd"] = layers * cfg.grad_accum
    return out


def _train_family(name):
    if "flash_bwd" in name:
        return "attention backward (flash kernels)"
    if "flash_attention" in name:
        return "attention forward (flash kernel)"
    if "route_bwd" in name:
        return "moe routing backward (kernel)"
    if "scan_bwd" in name or "scan_ckpt" in name:
        return "selective scan backward (kernels)"
    if "rglru_bwd" in name:
        return "rg-lru scan backward (kernel)"
    return _family(name)


#: count_phase: the kernel operators' names by their dispatchers'
#: launch counters
COUNT_OPS = {"flash_attention": "flash_attn_fwd",
             "flash_attention_bwd": "flash_attn_bwd",
             "moe_route": "moe_route_fwd", "moe_route_bwd": "moe_route_bwd",
             "selective_scan": "selective_scan_fwd",
             "selective_scan_bwd": "selective_scan_bwd",
             "rglru_scan": "rglru_scan_fwd",
             "rglru_scan_bwd": "rglru_scan_bwd"}
#: every count_check's result, in the order the phases ran them
COUNTS = []


def _on_card(batch):
    import torch
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def _forward_no_grad(params, batch, cfg):
    import torch
    from repro_torch.models.model import forward
    with torch.no_grad():
        return forward(params, batch, cfg)


def _meta_like(tree):
    """``tree`` with its tensors (and NumPy arrays) as meta tensors of the
    same shapes and dtypes, its other values kept."""
    import torch
    from repro_torch.tree import tree_flatten, tree_unflatten
    out = []
    for _, t in tree_flatten(tree):
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        out.append(torch.empty(t.shape, dtype=t.dtype, device="meta")
                   if isinstance(t, torch.Tensor) else t)
    return tree_unflatten(tree, out)


def _count_diff(card, meta):
    """The operators whose calls differ between two counters."""
    names = set(card.ops) | set(meta.ops)
    return {n: (card.ops.get(n, 0), meta.ops.get(n, 0)) for n in sorted(names)
            if card.ops.get(n, 0) != meta.ops.get(n, 0)}


def count_check(label, step, args, meta_step, ms):
    """count_phase's check of one call the script already makes: the call
    once more on the card under the FLOP counter
    (``launch.flopcount.count_fn``), held exactly against the same call on
    the meta device (``meta_step`` on ``_meta_like(args)``), and each
    kernel's launch counter against the operator calls the counter saw.
    Logs the counted TFLOP, ``ms`` (the phase's measured ms per call) and
    the share of the bf16 peak, counted FLOPs / (ms x 989e12), as mfu."""
    import torch
    from repro_torch.launch.flopcount import count_fn
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    t0 = time.perf_counter()
    counters = _train_counters()
    before = {n: fn.launches for n, fn in counters.items()}
    torch.cuda.synchronize()
    card = count_fn(step, *args)
    torch.cuda.synchronize()
    rose = {n: fn.launches - before[n] for n, fn in counters.items()}
    del card.result
    meta = count_fn(meta_step, *_meta_like(args))
    got = (card.dot_flops, card.other_flops, card.hbm_bytes)
    want = (meta.dot_flops, meta.other_flops, meta.hbm_bytes)
    if got != want:
        raise AssertionError(f"count_phase {label}: card (dot, other, bytes) "
                             f"{got} != meta {want}; operators that differ "
                             f"{_count_diff(card, meta)}")
    seen = {n: card.ops.get(f"repro_torch.{op}.default", 0)
            for n, op in COUNT_OPS.items()}
    if rose != seen:
        raise AssertionError(f"count_phase {label}: launches {rose} != the "
                             f"operator calls counted {seen}")
    mfu = card.flops / (ms * 1e-3 * PEAK_FLOPS_BF16)
    rec = {"label": label, "tflop": card.flops / 1e12,
           "dot_tflop": card.dot_flops / 1e12, "hbm_gb": card.hbm_bytes / 1e9,
           "ms": ms, "mfu": mfu, "launches": {n: c for n, c in seen.items()
                                              if c},
           "check_s": time.perf_counter() - t0}
    COUNTS.append(rec)
    log(f"count_phase {label}: {rec['tflop']:.4f} TFLOP counted "
        f"({rec['dot_tflop']:.4f} in products), {rec['hbm_gb']:.2f} GB, card "
        f"= meta exactly; {ms:.2f} ms per call measured; mfu "
        f"{mfu:.4f} of 989e12; kernel calls {rec['launches']}")
    return rec


def count_phase():
    """The FLOP counter on the card: ``count_check`` ran inside
    ``train_path`` (TinyLlama-1.1B's step), each family's serving path (a
    forward of 4 x 1024) and ``train_cut`` (each cut family's step); here
    every check is accounted for and summarised."""
    want = 1 + len(SERVE_ARCHS) + len(TRAIN_CUT)
    if len(COUNTS) != want:
        raise AssertionError(f"count_phase: {len(COUNTS)} checks ran, "
                             f"{want} expected")
    log(f"count_phase: {len(COUNTS)} calls counted on the card = meta, "
        f"{sum(r['check_s'] for r in COUNTS):.1f} s of checks: "
        + json.dumps(COUNTS))
    return COUNTS


#: dryrun_phase's combination and its subprocess's time limit from when
#: dryrun_phase starts to wait, s
DRYRUN_ARGS = ["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--mesh",
               "single"]
DRYRUN_TIMEOUT = 300


def dryrun_start():
    """Start ``python -m repro_torch.launch.dryrun`` of TinyLlama-1.1B's
    ``train_4k`` on the (16, 16) mesh in a subprocess (on the CPU: fake
    tensors, nothing on the card), to run beside the card's phases;
    ``dryrun_phase`` waits for it.  Returns (the process, its output
    file, its error stream)."""
    import atexit
    import tempfile
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
         "--out", out], stdout=subprocess.DEVNULL, stderr=err, text=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                       "OMP_NUM_THREADS": "2"})
    # an earlier phase's failure must not leave it running
    atexit.register(_stop, proc)
    return proc, out, err


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def dryrun_phase(started):
    """The dry-run ``dryrun_start`` started, waited for within
    ``DRYRUN_TIMEOUT``: its JSON, and the reference test's assertions with
    the card's 80 GB (256 cards, peak under 80 GB, a compute term,
    collective traffic, a useful-FLOP ratio in (0.05, 1.5])."""
    proc, out, err = started
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT)
        if proc.returncode != 0:
            err.seek(0)
            raise AssertionError(f"dryrun_phase: the dry-run failed "
                                 f"({proc.returncode}):\n"
                                 f"{err.read()[-3000:]}")
        with open(out) as f:
            d = json.load(f)
    finally:
        _stop(proc)
        err.close()
        os.remove(out)
    log("dryrun_phase: " + json.dumps(d))
    ok = (d["chips"] == 256 and d["memory"]["peak_gb"] < 80.0
          and d["roofline"]["compute_s"] > 0
          and d["collective_bytes_per_device"] > 0
          and 0.05 < d["useful_flops_ratio"] <= 1.5)
    if not ok:
        raise AssertionError(f"dryrun_phase: the report fails the "
                             f"reference test's assertions: {d}")
    return d


def train_profile(label, step_fn, params, opt_state, batch, lr):
    """Device time of one train step by kernel family from torch.profiler,
    and the optimizer's share (the clip and the update, timed apart with
    CUDA events on the same state); the idle share is 1 - busy / wall
    under the profiler, an upper bound.  The step updates the state, as
    a step of the run does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, _ = step_fn(params, opt_state, batch, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, busy = {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        ms0, n0 = fams.get(_train_family(ev.key), (0.0, 0))
        fams[_train_family(ev.key)] = (ms0 + us / 1e3, n0 + ev.count)
        busy += us / 1e3
    out = {"wall_ms": wall_ms, "busy_ms": busy,
           "idle_share": None if busy == 0 else 1 - busy / wall_ms,
           "families_ms": {f: ms for f, (ms, _) in fams.items()}}
    if busy == 0.0:
        log(f"profile of {label}: the profiler recorded no device time "
            f"(not measured)")
    else:
        log(f"profile of one {label} step: wall {wall_ms:.2f} ms under the "
            f"profiler, device busy {busy:.2f} ms (idle share at most "
            f"{1 - busy / wall_ms:.3f}); "
            + "; ".join(f"{f} {ms:.2f} ms in {n} kernels "
                        f"({ms / busy:.3f} of busy)"
                        for f, (ms, n) in sorted(fams.items(),
                                                 key=lambda kv: -kv[1][0])))
    return out, params, opt_state


def optimizer_ms(cfg, params, opt_state, reps=3):
    """Device ms of the step's clip and optimizer update (in place) on the
    run's state, with gradients of the parameters' shapes (CUDA events;
    the state moves by reps steps of a zero gradient)."""
    import torch
    from repro_torch.models.model import stack_groups
    from repro_torch.optim.optimizers import (clip_by_global_norm_,
                                              make_optimizer)
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    grads = [torch.zeros_like(p) for p in leaves]
    _, update = make_optimizer(cfg.optimizer, stack_groups(params, cfg))

    def run():
        clip_by_global_norm_(grads, 1.0)
        with torch.no_grad():
            update(grads, opt_state, leaves, 1e-12)
    ms = cuda_ms(run, reps)
    del grads
    return ms


def _step_stats(times):
    ms = sorted(t * 1e3 for t in times)
    return {"median_ms": float(np.median(ms)), "min_ms": ms[0],
            "max_ms": ms[-1]}


def train_path():
    """``launch.train.main`` at the reference's defaults on TinyLlama-1.1B
    at full width and depth (bf16 parameters, AdamW in float32, remat):
    it must print ``improved``; per step the host clock (synchronized),
    the training kernels' launches against the remat arithmetic, peak
    memory; the state after step 50 checkpointed and restored bit-exactly;
    one more step profiled.  Returns the launches of the run and its
    numbers."""
    import io
    import shutil
    import tempfile

    import torch
    from repro_torch.ckpt.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.tree import tree_leaves
    cfg = get_config("tinyllama-1.1b")
    expect = _expected_train_launches(cfg)
    counters = _train_counters()
    times, per_step, bad = [], [], []
    last = [None]
    ck = {}
    keep = {}

    def on_step(step, params, opt_state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        counts = {n: fn.launches for n, fn in counters.items()}
        prev = per_step[-1][1] if per_step else {n: 0 for n in counts}
        delta = {n: counts[n] - prev[n] for n in counts}
        per_step.append((delta, counts))
        if delta != expect:
            bad.append((step, delta))
        if step + 1 == TRAIN_CKPT_STEP:
            tmp = tempfile.mkdtemp(prefix="train_ckpt_")
            try:
                t0 = time.perf_counter()
                save_checkpoint(tmp, (params, opt_state), step + 1)
                save_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                got, at = restore_checkpoint(tmp, (params, opt_state))
                restore_s = time.perf_counter() - t0
                want = tree_leaves((params, opt_state))
                same = at == step + 1 and all(
                    a.dtype == b.dtype and a.device == b.device
                    and torch.equal(a, b)
                    for a, b in zip(tree_leaves(got), want))
                nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                             for f in os.listdir(tmp))
                ck.update(same=same, bytes=nbytes, save_s=save_s,
                          restore_s=restore_s, leaves=len(want))
                del got
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        keep.update(params=params, opt_state=opt_state)
        last[0] = time.perf_counter()

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    last[0] = t0
    with contextlib.redirect_stdout(out):
        losses = train.main(TRAIN_ARGV, on_step=on_step)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for line in out.getvalue().splitlines():
        log(f"  [train] {line}")
    if "(improved)" not in out.getvalue():
        raise AssertionError("train_path: the loss did not improve")
    if not np.all(np.isfinite(losses)):
        raise AssertionError("train_path: a loss is not finite")
    if bad:
        raise AssertionError(f"train_path: launches per step differ from "
                             f"{expect}: {bad[:3]}")
    if not ck.get("same"):
        raise AssertionError(f"train_path: the step-{TRAIN_CKPT_STEP} "
                             f"checkpoint did not restore bit-exactly: {ck}")
    # the first step (kernel libraries loaded, allocator warm-up) and the
    # checkpoint step stand apart from the steady steps
    steady = [t for i, t in enumerate(times)
              if i not in (0, TRAIN_CKPT_STEP - 1)]
    stats = _step_stats(steady)
    b, s = 8, 256
    tokens_s = b * s / (stats["median_ms"] / 1e3)
    params, opt_state = keep["params"], keep["opt_state"]
    keep.clear()
    batch = TokenPipeline(cfg.vocab_size, s, b, seed=1).next_batch()
    step_fn = make_train_step(cfg, lr=3e-4)
    count_check(f"TinyLlama-1.1B train step ({b} x {s})", step_fn,
                (params, opt_state, _on_card(batch), 3e-5),
                make_train_step(cfg, lr=3e-4, device="meta"),
                stats["median_ms"])
    prof, params, opt_state = train_profile(
        "TinyLlama-1.1B training (8 x 256 tokens)", step_fn, params,
        opt_state, batch, 3e-5)
    opt_ms = optimizer_ms(cfg, params, opt_state)
    log(f"train_path: TinyLlama-1.1B, {len(losses)} steps of {b} x {s} "
        f"tokens at full width and depth ({cfg.num_layers} layers, "
        f"{cfg.param_count() / 1e9:.3f} B parameters, bf16, AdamW in "
        f"float32, remat): wall {wall:.1f} s; ms per step median "
        f"{stats['median_ms']:.2f}, min {stats['min_ms']:.2f}, max "
        f"{stats['max_ms']:.2f} (first step {times[0] * 1e3:.1f}, "
        f"checkpoint step left out); {tokens_s:.0f} tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB; loss {np.mean(losses[:10]):.4f} -> "
        f"{np.mean(losses[-10:]):.4f}; launches per step {expect} (every "
        f"step); optimizer (clip + AdamW update) {opt_ms:.2f} ms; "
        f"checkpoint at step {TRAIN_CKPT_STEP}: {ck['leaves']} leaves, "
        f"{ck['bytes'] / 1e9:.2f} GB, save {ck['save_s']:.1f} s, restore "
        f"{ck['restore_s']:.1f} s, bit-exact")
    del params, opt_state
    return launches, {"steps": len(losses), "wall_s": wall, **stats,
                      "tokens_s": tokens_s, "peak_gb": peak / 1e9,
                      "loss_first10": float(np.mean(losses[:10])),
                      "loss_last10": float(np.mean(losses[-10:])),
                      "launches_per_step": expect, "optimizer_ms": opt_ms,
                      "checkpoint": ck, "profile": prof}


def _train_bytes(cfg, tokens):
    """Bytes a training step holds, reckoned: per parameter its value,
    its gradient, a float32 accumulator when microbatches accumulate and
    the two AdamW moments (12 or 16 bytes); four float32 (tokens x vocab,
    times the codebooks) logit-sized buffers of a microbatch; 2 GB of an
    update slice's temporaries."""
    per_param = 2 + 2 + 8 + (4 if cfg.grad_accum > 1 else 0)
    return cfg.param_count() * per_param \
        + 4 * 4 * (tokens // cfg.grad_accum) * cfg.vocab_size \
        * max(1, cfg.num_codebooks) + 2e9


def train_cut(arch, layers):
    """10 steps of ``arch`` at full width cut to ``layers`` layers on
    TRAIN_CUT_RUN's tokens at a constant lr: finite losses that fall,
    launches per step against the remat arithmetic, ms per step, peak
    memory and a profiled step."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_params, stack_groups
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    b, s = TRAIN_CUT_RUN["batch"], TRAIN_CUT_RUN["seq"]
    reckoned = _train_bytes(cfg, b * s)
    while reckoned > TRAIN_MAX_BYTES and b > cfg.grad_accum:
        b //= 2
        reckoned = _train_bytes(cfg, b * s)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    init, _ = make_optimizer(cfg.optimizer, stack_groups(params, cfg))
    opt_state = init(tree_leaves(params))
    step_fn = make_train_step(cfg, lr=TRAIN_CUT_RUN["lr"])
    pipe = TokenPipeline(cfg.vocab_size, s, b, seed=0,
                         num_codebooks=cfg.num_codebooks)
    counters = _train_counters()
    expect = _expected_train_launches(cfg)
    losses, gnorms, times = [], [], []
    total = {n: 0 for n in counters}
    for step in range(TRAIN_CUT_RUN["steps"]):
        for fn in counters.values():
            fn.launches = 0
        batch = pipe.next_batch()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        gnorms.append(float(m["grad_norm"]))
        got = {n: fn.launches for n, fn in counters.items()}
        if got != expect:
            raise AssertionError(f"train_cut {arch}: launches at step "
                                 f"{step} {got} != {expect}")
        total = {n: total[n] + got[n] for n in total}
    peak = torch.cuda.max_memory_allocated()
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_cut {arch}: the loss does not fall: "
                             f"{losses}")
    rises = [i for i in range(1, len(losses)) if losses[i] > losses[i - 1]]
    stats = _step_stats(times[1:])
    count_check(f"{arch} train step ({layers} layers, {b} x {s})", step_fn,
                (params, opt_state, _on_card(pipe.next_batch())),
                make_train_step(cfg, lr=TRAIN_CUT_RUN["lr"], device="meta"),
                stats["median_ms"])
    prof, params, opt_state = train_profile(
        f"{arch} ({layers} layers, {b} x {s} tokens)", step_fn, params,
        opt_state, pipe.next_batch(), TRAIN_CUT_RUN["lr"])
    cut = "" if b == TRAIN_CUT_RUN["batch"] else \
        f" (batch cut from {TRAIN_CUT_RUN['batch']}: reckoned past " \
        f"{TRAIN_MAX_BYTES / 1e9:.0f} GB)"
    log(f"train_cut {arch}: full width, {layers} of "
        f"{get_config(arch).num_layers} layers "
        f"({cfg.param_count() / 1e9:.3f} B parameters), {b} x {s} tokens"
        f"{cut}, grad_accum {cfg.grad_accum}, reckoned "
        f"{reckoned / 1e9:.1f} GB, peak {peak / 1e9:.2f} GB; losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f" (rises at steps {rises}); grad norms before the clip "
        + " ".join(f"{x:.4g}" for x in gnorms)
        + f"; ms per step median {stats['median_ms']:.1f} (min "
        f"{stats['min_ms']:.1f}, max {stats['max_ms']:.1f}, first "
        f"{times[0] * 1e3:.0f}), {b * s / (stats['median_ms'] / 1e3):.0f} "
        f"tokens/s; launches per step {expect}")
    del params, opt_state
    return {"layers": layers, "batch": b, "seq": s,
            "reckoned_gb": reckoned / 1e9, "peak_gb": peak / 1e9,
            "losses": losses, "grad_norms": gnorms, **stats,
            "tokens_s": b * s / (stats["median_ms"] / 1e3),
            "launches_per_step": expect, "launches": total, "profile": prof}


def _leaf_group(path):
    """The part of the model a parameter path belongs to, for
    ``train_moe_probe``'s per-group gradients."""
    parts = path.split("/")
    if parts[0] != "blocks":
        return parts[0]
    if parts[2] == "moe":
        return {"router": "router", "shared": "shared expert",
                "shared_gate": "shared gate"}.get(parts[3], "experts")
    return parts[2] if parts[2] == "attn" else "norms"


@contextlib.contextmanager
def _through_twins():
    """The model's attention and routing through autograd of their plain
    twins (``attention_ref``, ``moe_route_ref``) on CUDA tensors, for
    ``train_moe_probe``'s comparison only."""
    from repro_torch.kernels.ref import attention_ref, moe_route_ref
    from repro_torch.models import attention, moe
    saved = attention.flash_attention, moe.moe_route
    attention.flash_attention, moe.moe_route = attention_ref, moe_route_ref
    try:
        yield
    finally:
        attention.flash_attention, moe.moe_route = saved


#: train_moe_probe's largest float32 gap, kernels against twins, of a
#: group of leaves' gradients (the norm of the difference over the
#: twins')
PROBE_F32_RTOL = 1e-4


def _grads_by_group(params, batch, cfg, through_twins=False):
    """(float32 gradients of ``loss_fn`` over the flat leaves, the cross
    entropy), through the kernels or through autograd of the twins."""
    import torch
    from repro_torch.models.model import loss_fn
    from repro_torch.tree import tree_leaves, tree_unflatten
    with _through_twins() if through_twins else contextlib.nullcontext():
        wrt = [p.detach().requires_grad_() for p in tree_leaves(params)]
        total, m = loss_fn(tree_unflatten(params, wrt), batch, cfg)
        grads = torch.autograd.grad(total, wrt)
    return [g.float() for g in grads], float(m["ce"].detach())


def _block_rms(params, batch, cfg):
    """Each block's output rms (its residual update) at ``params``, and
    the rms of the residual the head reads."""
    import torch
    from repro_torch.models import model as M
    ctx = M.make_ctx(batch, cfg)
    with torch.no_grad():
        x = M.embed_tokens(params, batch, cfg, ctx["positions"])
        out = []
        for kind, p in zip(cfg.layer_kinds, params["blocks"]):
            y, _ = M._block(kind, p, x, ctx, cfg)
            out.append(float((y - x).float().pow(2).mean().sqrt()))
            x = y
        return out, float(x.float().pow(2).mean().sqrt())


def train_moe_probe(arch="qwen2-moe-a2.7b"):
    """Why ``arch``'s loss falls slowly at full width and cut depth
    (``train_cut``), on TRAIN_CUT_RUN's tokens from the same seeded
    parameters.  (1) One step's gradients through the kernels against
    autograd through the twins (``_through_twins``), per group of leaves
    (``_leaf_group``): in float32 within PROBE_F32_RTOL, and in bf16 (not
    gated: a router near-tie that flips reorders the slots of every later
    token of that expert, so capacity drops other tokens).  (2) Each
    block's output rms at init, beside TinyLlama-1.1B's at the same depth
    and beside ``arch`` with the experts' ``w_gate`` and ``w_up`` scaled
    from 1/√E to 1/√d: the reference's ``moe_init`` draws them with
    ``dense_init``'s default fan-in, shape[0] = E.  (3) The losses of
    TRAIN_CUT_RUN's steps with float32 parameters, in bf16 without the
    clip, with the experts at 1/√d, and 30 steps at the reference's init.
    Returns the numbers."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_params, stack_groups
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.tree import tree_flatten, tree_leaves
    cfg = dataclasses.replace(get_config(arch), num_layers=TRAIN_CUT[arch])
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    b, s = TRAIN_CUT_RUN["batch"], TRAIN_CUT_RUN["seq"]

    def fresh(c, experts_at_d=False):
        params = init_params(
            c, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        if experts_at_d:
            with torch.no_grad():
                for p in params["blocks"]:
                    for key in ("w_gate", "w_up"):
                        p["moe"][key].mul_(
                            (c.moe.num_experts / c.d_model) ** 0.5)
        return params

    def first_batch(c):
        return {k: torch.as_tensor(v, device="cuda") for k, v in
                TokenPipeline(c.vocab_size, s, b, seed=0).next_batch()
                .items()}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"grads": {}, "block_rms": {}, "losses": {}}
    batch = first_batch(cfg)
    for label, c in (("float32", f32), ("bf16", cfg)):
        params = fresh(c)
        names = [path for path, _ in tree_flatten(params)]
        got, ce = _grads_by_group(params, batch, c)
        want, ce_twin = _grads_by_group(params, batch, c, through_twins=True)
        groups = {}
        for name, g, w in zip(names, got, want):
            acc = groups.setdefault(_leaf_group(name), [0.0] * 4)
            acc[0] += float(torch.sum(g * g))
            acc[1] += float(torch.sum(w * w))
            acc[2] += float(torch.sum((g - w) ** 2))
            acc[3] += float(torch.sum(g * w))
        rows = {grp: {"rel_diff": (dd / max(ww, 1e-30)) ** 0.5,
                      "cosine": gw / max((gg * ww) ** 0.5, 1e-30)}
                for grp, (gg, ww, dd, gw) in groups.items()}
        out["grads"][label] = {"ce": [ce, ce_twin], "groups": rows}
        log(f"train_moe_probe {arch} {label}: one step's gradients, kernels "
            f"against the twins (ce {ce:.5f} / {ce_twin:.5f}): "
            + "; ".join(f"{grp} {v['rel_diff']:.3e} (cosine "
                        f"{v['cosine']:.6f})" for grp, v in rows.items()))
        if label == "float32":
            worst = max(v["rel_diff"] for v in rows.values())
            if not worst <= PROBE_F32_RTOL:
                raise AssertionError(f"train_moe_probe {arch}: float32 "
                                     f"gradients through the kernels differ "
                                     f"from the twins' by {worst:.3e}")
        del params, got, want
        free()
    tiny = dataclasses.replace(get_config("tinyllama-1.1b"),
                               num_layers=cfg.num_layers)
    for label, c, at_d in ((arch, cfg, False),
                           (f"{arch}, experts at 1/sqrt(d)", cfg, True),
                           ("tinyllama-1.1b", tiny, False)):
        params = fresh(c, at_d)
        blocks, head_in = _block_rms(params, first_batch(c), c)
        out["block_rms"][label] = {"blocks": blocks, "head_input": head_in}
        log(f"train_moe_probe block output rms at init, {label}, "
            f"{c.num_layers} layers: "
            + " ".join(f"{x:.4f}" for x in blocks)
            + f"; the head reads rms {head_in:.4f}")
        del params
        free()
    steps = TRAIN_CUT_RUN["steps"]
    for label, c, clip, at_d, n in (
            ("float32", f32, 1.0, False, steps),
            ("bf16 without the clip", cfg, float("inf"), False, steps),
            ("bf16, experts at 1/sqrt(d)", cfg, 1.0, True, steps),
            ("bf16, the reference's init, 30 steps", cfg, 1.0, False, 30)):
        params = fresh(c, at_d)
        init, _ = make_optimizer(c.optimizer, stack_groups(params, c))
        state = init(tree_leaves(params))
        step_fn = make_train_step(c, lr=TRAIN_CUT_RUN["lr"], clip=clip,
                                  device="cuda")
        pipe = TokenPipeline(c.vocab_size, s, b, seed=0)
        losses = []
        for _ in range(n):
            params, state, m = step_fn(params, state, pipe.next_batch())
            losses.append(float(m["loss"]))
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"train_moe_probe {arch} {label}: "
                                 f"{losses}")
        out["losses"][label] = losses
        log(f"train_moe_probe {arch} {label}: losses "
            + " ".join(f"{x:.4f}" for x in losses))
        del params, state
        free()
    return out


def _offset_zero_leaves(params, seed=5):
    """``params`` with normal x 0.1 (seeded) added to every leaf that is
    all 0 (norms, biases): AdamW's first step on such a leaf is g / (|g| +
    eps), which magnifies two devices' float32 rounding of a near-zero
    gradient entry to the whole step (tests/test_torch_train_step.py)."""
    import torch
    from repro_torch.tree import tree_leaves, tree_unflatten
    gen = torch.Generator().manual_seed(seed)
    return tree_unflatten(params, [
        p if bool(p.any()) else
        (0.1 * torch.randn(p.shape, generator=gen)).to(p.dtype)
        for p in tree_leaves(params)])


def train_step_cross(arch):
    """STEP_CROSS's steps of reduced float32 ``arch`` on the card and on
    the CPU from one set of parameters (each device its own copy: the
    step updates in place): parameters, optimizer state, loss and
    gradient norm within rtol 1e-4 / atol 1e-5 of each leaf's largest
    entry; returns (the largest error over scale, the leaves compared)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_params, stack_groups
    from repro_torch.optim.optimizers import make_optimizer, warmup_cosine
    from repro_torch.tree import tree_leaves, tree_unflatten
    cfg = get_config(arch).reduced()
    c = STEP_CROSS
    base = _offset_zero_leaves(init_params(cfg, device="cpu"))
    runs = {}
    for dev in ("cpu", "cuda"):
        params = tree_unflatten(base, [p.clone().to(dev)
                                       for p in tree_leaves(base)])
        init, _ = make_optimizer(cfg.optimizer, stack_groups(params, cfg))
        state = init(tree_leaves(params))
        step_fn = make_train_step(cfg, lr=c["peak"], device=dev)
        pipe = TokenPipeline(cfg.vocab_size, c["seq"], c["batch"], seed=4,
                             num_codebooks=cfg.num_codebooks)
        metrics = []
        for i in range(c["steps"]):
            params, state, m = step_fn(
                params, state, pipe.next_batch(),
                warmup_cosine(i, c["peak"], c["warmup"], c["total"]))
            metrics += [m["loss"], m["grad_norm"]]
        runs[dev] = [t.cpu() for t in tree_leaves((params, state))
                     + metrics]
    worst = 0.0
    for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        where = f"train_step_cross {arch}: leaf {i}"
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{where} {a.dtype} {tuple(a.shape)} vs "
                                 f"{b.dtype} {tuple(b.shape)}")
        if not a.dtype.is_floating_point:
            if not torch.equal(a, b):
                raise AssertionError(f"{where} differs")
            continue
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-5 * scale):
            raise AssertionError(f"{where} max abs err {err:.3e} (scale "
                                 f"{scale:.3e})")
        worst = max(worst, err / scale)
    return worst, len(runs["cpu"])


def train_phase():
    """The training slice on the card: its backward kernels, the CLI's
    main path on TinyLlama-1.1B, the reduced models on the card against
    the CPU, and the three other families at full width and cut depth.
    Returns the kernel records and the launches of the main path."""
    import torch
    t0 = time.perf_counter()
    recs = train_kernels_phase()
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    launches, main = train_path()
    log(f"train_path: {time.perf_counter() - t1:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    worst = {arch: train_step_cross(arch)
             for arch in SERVE_ARCHS + EXTRA_ARCHS}
    log(f"train_step_cross: {STEP_CROSS['steps']} steps of each reduced "
        f"float32 model on the card match the CPU (parameters, optimizer "
        f"state, loss and grad norm within rtol 1e-4 / atol 1e-5 of each "
        f"leaf's scale; zero-initialised leaves offset): largest error over "
        f"scale, leaves: "
        + ", ".join(f"{a} {e:.3e} / {n}" for a, (e, n) in worst.items())
        + f" ({time.perf_counter() - t1:.1f} s)")
    cuts = {}
    for arch, layers in TRAIN_CUT.items():
        t1 = time.perf_counter()
        cuts[arch] = train_cut(arch, layers)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"train_cut {arch}: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    probe = train_moe_probe()
    log(f"train_moe_probe: {time.perf_counter() - t1:.1f} s")
    for rec in recs:
        # the main path's launches where it runs the kernel, else the cut
        # runs' (moe_route, the scans: each family's own 10 steps)
        name = rec["name"]
        rec["launches"] = launches[name] or sum(
            c["launches"][name] for c in cuts.values())
        rec["launches_per_step"] = main["launches_per_step"][name]
        rec["launches_per_step_cut"] = {
            a: c["launches_per_step"][name] for a, c in cuts.items()}
        if not rec["launches"]:
            raise AssertionError(f"{name} was launched no time in training")
        if name == "flash_attention_bwd":
            # the two shapes only the multimodal families launch take their
            # cut runs' launches (musicgen's self and cross attention alike)
            for key, arch in (("cross", "musicgen-medium"),
                              ("hd128_g7", "qwen2-vl-7b")):
                rec[key]["launches"] = cuts[arch]["launches"][name]
                if not rec[key]["launches"]:
                    raise AssertionError(f"{name} was launched no time in "
                                         f"{arch}'s training")
    log(f"train phase: {time.perf_counter() - t0:.1f} s")
    return recs, launches, {"tinyllama": main, "cut": cuts,
                            "cross": worst, "moe_probe": probe}


def wide_block(arch):
    """One decoder block of ``arch`` (its layer 0) at full width on the
    card, bf16, weights from a seeded CUDA generator: the forward and the
    gradients of every parameter and of the input at WIDE_BLOCK's tokens
    through the kernels (flash forward with its logsumexp, the backward
    kernels) against the same block through the twins (``_through_twins``:
    autograd of ``attention_ref`` on the card), each within ``atol`` of
    its scale; one ``decode_attention`` step over a ring of ``ring``
    slots (1025 written) against the twin.  The kernels' counts are set to
    0 just before the kernel run and the decode step, and read just after.
    Returns the report."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.model import apply_block, init_block
    from repro_torch.tree import tree_flatten, tree_unflatten
    cfg = get_config(arch)
    kind = cfg.layer_kinds[0]
    b, s, W, atol = (WIDE_BLOCK[key] for key in ("batch", "seq", "ring",
                                                  "atol"))
    dt = dtype_of(cfg.compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = init_block(gen, kind, cfg, device="cuda")
    named = tree_flatten(p)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(dt)
    gy = torch.randn(x.shape, generator=gen, device="cuda").to(dt)
    ctx = {"positions": torch.arange(s, dtype=torch.int32,
                                     device="cuda").expand(b, s).contiguous(),
           "explicit": False}

    def run(twins):
        with _through_twins() if twins else contextlib.nullcontext():
            leaves = [t.detach().requires_grad_() for _, t in named]
            xs = x.detach().requires_grad_()
            y = apply_block(kind, tree_unflatten(p, leaves), xs, ctx, cfg)
            grads = torch.autograd.grad(y, [xs] + leaves, gy)
        return y.detach(), grads

    fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0
    y, grads = run(False)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.flash_attention.launches,
                "flash_attention_bwd": fa.flash_attention_bwd.launches}
    want_y, want = run(True)
    torch.cuda.synchronize()
    if y.dtype != dt or y.shape != x.shape or not torch.isfinite(y).all():
        raise AssertionError(f"wide_block {arch}: output {y.dtype} "
                             f"{tuple(y.shape)} not finite or of x's shape")
    def rel(got, want, what):
        # the largest |got - want| over want's largest entry (raises past
        # atol)
        err = _scaled_err(got, want, f"wide_block {arch} {what}", atol)
        return err / max(float(want.float().abs().max()), 1e-30)

    errs = {"y": rel(y, want_y, "output")}
    for name, g, w in zip(["x"] + [n for n, _ in named], grads, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"wide_block {arch}: d{name} not finite")
        errs[f"d{name}"] = rel(g, w, f"d{name}")
    del grads, want, want_y
    walls = {}
    for label, twins in (("kernels", False), ("twins", True),
                         ("twins", True), ("kernels", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(twins)
        torch.cuda.synchronize()
        walls.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
        del out

    # one decode step at position s over the ring: slots 0..s written
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {key: torch.randn((b, W, kvh, hd), generator=gen,
                              device="cuda").to(dt) for key in ("k", "v")}
    x1 = torch.randn((b, 1, cfg.d_model), generator=gen, device="cuda").to(dt)
    with torch.no_grad():
        fa.flash_attention.launches = 0
        got, got_cache = decode_attention(
            p["attn"], x1, {k: t.clone() for k, t in cache.items()}, s, cfg)
        torch.cuda.synchronize()
        launches["decode"] = fa.flash_attention.launches
        with _through_twins():
            ref, ref_cache = decode_attention(
                p["attn"], x1, {k: t.clone() for k, t in cache.items()}, s,
                cfg)
    errs["decode"] = rel(got, ref, "decode")
    if not all(torch.equal(got_cache[k], ref_cache[k]) for k in cache):
        raise AssertionError(f"wide_block {arch}: the decode step's ring "
                             f"writes differ")
    if launches != {"flash_attention": 1, "flash_attention_bwd": 1,
                    "decode": 1}:
        raise AssertionError(f"wide_block {arch}: launches {launches}")
    n_params = sum(t.numel() for _, t in named)
    worst = max(errs, key=lambda k: errs[k])
    rep = {"kind": kind, "params": n_params, "hd": hd, "heads": (h, kvh),
           "err_over_scale": errs, "launches": launches,
           "fwd_bwd_ms": {k: float(np.median(v)) for k, v in walls.items()}}
    log(f"wide_block {arch}: layer 0 ({kind}, d={cfg.d_model}, {h}/{kvh} "
        f"heads, hd={hd}, d_ff={cfg.d_ff}, {cfg.activation}, "
        f"{n_params / 1e9:.3f} B parameters, {dt}) at {b} x {s} tokens: "
        f"forward and {len(named) + 1} gradients through the kernels match "
        f"the twins within {atol} of each scale (error over scale: "
        f"largest {errs[worst]:.3e} at {worst}, output {errs['y']:.3e}, dx "
        f"{errs['dx']:.3e}); decode step over a {W}-slot ring ({s + 1} "
        f"written) {errs['decode']:.3e}, ring writes equal; forward + "
        f"backward ms through the kernels "
        f"{[round(t, 2) for t in walls['kernels']]}, through the twins "
        f"{[round(t, 2) for t in walls['twins']]}; launches {launches}")
    return rep


def wide_block_phase():
    """``wide_block`` for each of WIDE_ARCHS, freeing each block before
    the next; returns the reports by arch."""
    import torch
    t0 = time.perf_counter()
    out = {}
    for arch in WIDE_ARCHS:
        out[arch] = wide_block(arch)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"wide_block phase: {time.perf_counter() - t0:.1f} s")
    return out


#: the GPipe pipeline (``serving.pipeline_smap``): TinyLlama-1.1B at full
#: width and depth in bf16 over ``stages`` streams of the one card, batch x
#: seq tokens in each of ``microbatches``, against ``forward`` and
#: ``pipeline_forward`` within ``atol`` of the logits' scale; ``reps``
#: synchronized calls timed
PIPELINE = dict(arch="tinyllama-1.1b", stages=2, batch=4, seq=1024,
                microbatches=(1, 4), atol=2e-2, reps=5)


def _synced_runs(fn, device, reps):
    """``reps`` host-clock ms of ``fn``, each synchronized on ``device``'s
    card, sorted."""
    import torch
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def _spread_ms(times):
    return (f"median {np.median(times):.2f} ms (min {times[0]:.2f}, max "
            f"{times[-1]:.2f})")


def pipeline_phase(device="cuda", cfg=None):
    """``pipeline_shard_map`` over PIPELINE's stages of one device (a
    CUDA stream each on the card) at each microbatch count, against
    ``forward`` and ``pipeline_forward`` of the same seeded weights: the
    largest error over the logits' scale within ``atol``, the share of
    rows whose argmax agrees, and flash launched once per layer per
    microbatch (counts set to 0 just before each run and read just after);
    the median of ``reps`` synchronized calls beside ``forward``'s.
    Returns the report."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import forward, init_params
    from repro_torch.serving.pipeline_smap import pipeline_shard_map
    from repro_torch.serving.plans import pipeline_forward
    t_phase = time.perf_counter()
    dev = torch.device(device)
    P = PIPELINE
    cfg = cfg or get_config(P["arch"])
    S = P["stages"]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (P["batch"], P["seq"]), generator=gen,
                                     device=dev, dtype=torch.int32)}
    out = {"arch": cfg.name, "layers": cfg.num_layers, "stages": S,
           "batch": P["batch"], "seq": P["seq"]}
    with torch.no_grad():
        want = forward(params, batch, cfg)
        plain = pipeline_forward(params, batch, cfg, S)
        scale = float(want.abs().max())
        out["forward_ms"] = _synced_runs(
            lambda: forward(params, batch, cfg), dev, P["reps"])
        for m in P["microbatches"]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            flash_attention.launches = 0
            got = pipeline_shard_map(params, batch, cfg, [dev] * S, m)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            launches = flash_attention.launches
            expect = cfg.num_layers * m if dev.type == "cuda" else 0
            if launches != expect:
                raise AssertionError(f"pipeline M={m}: flash launched "
                                     f"{launches} times, expected {expect}")
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"pipeline M={m}: logits "
                                     f"{tuple(got.shape)} or not finite")
            errs = {name: float((got - ref).abs().max()) / scale
                    for name, ref in (("forward", want),
                                      ("pipeline_forward", plain))}
            worst = max(errs.values())
            if not worst <= P["atol"]:
                raise AssertionError(f"pipeline M={m}: error over the "
                                     f"logits' scale {errs} > {P['atol']}")
            agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            times = _synced_runs(lambda: pipeline_shard_map(
                params, batch, cfg, [dev] * S, m), dev, P["reps"])
            out[f"M{m}"] = {"err_over_scale": errs, "argmax_agree": agree,
                            "flash_launches": launches, "ms": times}
            log(f"pipeline {cfg.name} ({cfg.num_layers} layers, "
                f"{cfg.compute_dtype}) S={S} streams M={m} microbatches of "
                f"{P['batch'] // m} x {P['seq']}: largest error over the "
                f"logits' scale {scale:.3f} vs forward {errs['forward']:.3e}, "
                f"vs pipeline_forward {errs['pipeline_forward']:.3e} (bound "
                f"{P['atol']}); argmax agrees on {agree:.4f} of rows; flash "
                f"launched {launches} times; {_spread_ms(times)} of "
                f"{P['reps']} synchronized calls, forward "
                f"{_spread_ms(out['forward_ms'])}")
    del params, want, plain
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"pipeline phase: {out['phase_s']:.1f} s")
    return out


#: the grid's dispatch: ``run_grid_batched`` on MAIN's grid with
#: ``threads`` chunks and on ``devices`` shards, each against the one call
#: at the reference's contract (tests/test_grid_sharded.py)
GRID_DISPATCH = dict(policies=("bestfit-rr", "splitplace"), threads=2,
                     devices=1, rtol=1e-4, atol=1e-9)


def _grid_diff(one, got, label):
    """The largest relative difference of every scalar summary metric;
    raises past GRID_DISPATCH's rtol / atol."""
    worst = 0.0
    if len(one) != len(got):
        raise AssertionError(f"{label}: {len(got)} records, {len(one)} "
                             f"expected")
    for a, b in zip(one, got):
        for k, v in a.items():
            if not isinstance(v, float):
                if v != b[k]:
                    raise AssertionError(f"{label}: {k} {b[k]!r} != {v!r}")
                continue
            if not np.isclose(b[k], v, rtol=GRID_DISPATCH["rtol"],
                              atol=GRID_DISPATCH["atol"]):
                raise AssertionError(f"{label}: {k} {b[k]!r} vs the one "
                                     f"call's {v!r}")
            worst = max(worst, abs(b[k] - v) / max(abs(v), 1e-300))
    return worst


def grid_phase(mab_state, device="cuda", grid=None, one=None):
    """``run_grid_batched`` on MAIN's grid (``grid`` overrides it) for
    GRID_DISPATCH's policies: the one call (``one[policy]``: the main
    path's (records, wall s), when it ran it), ``threads`` chunks and
    ``devices`` shards, each chunked run against the one call (every
    summary metric within rtol 1e-4 / atol 1e-9; ``bestfit-rr`` bitwise),
    the simulator kernels launched once per interval in the sharded run
    (counts set to 0 just before and read just after); then more shards
    than cards raises.  Returns the report."""
    import torch
    from repro_torch.core.daso import DASOConfig, init_surrogate
    from repro_torch.launch.experiments import run_grid_batched
    t_phase = time.perf_counter()
    G = dict(grid or MAIN)
    dev = torch.device(device)
    cfg = DASOConfig(**DASO_MAIN)
    theta = init_surrogate(cfg, torch.Generator(device=dev).manual_seed(
        DASO_SEED), device=dev)
    kw = {"bestfit-rr": {},
          "splitplace": dict(mab_state=mab_state, daso_theta=theta,
                             daso_cfg=cfg)}
    out = {}
    for policy in GRID_DISPATCH["policies"]:
        walls, recs = {}, {}
        runs = [("one call", {})]
        if one and policy in one:
            recs["one call"], walls["one call"] = one[policy]
            runs = []
        for label, dispatch in runs + [
                (f"threads={GRID_DISPATCH['threads']}",
                 dict(threads=GRID_DISPATCH["threads"])),
                (f"devices={GRID_DISPATCH['devices']}",
                 dict(devices=GRID_DISPATCH["devices"]
                      if dev.type == "cuda" else [dev]))]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            for fn in _counters().values():
                fn.launches = 0
            t0 = time.perf_counter()
            recs[label] = run_grid_batched(policy, **G, device=dev,
                                           **dispatch, **kw[policy])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            walls[label] = time.perf_counter() - t0
            if dispatch.get("devices") and dev.type == "cuda":
                for name in SIM_KERNELS:
                    n = _counters()[name].launches
                    if n != G["n_intervals"]:
                        raise AssertionError(
                            f"grid {policy} {label}: {name} launched {n} "
                            f"times, expected {G['n_intervals']}")
        one = recs.pop("one call")
        diffs = {label: _grid_diff(one, got, f"grid {policy} {label}")
                 for label, got in recs.items()}
        bitwise = {label: got == one for label, got in recs.items()}
        if policy == "bestfit-rr" and not all(bitwise.values()):
            raise AssertionError(f"grid {policy}: a chunked run is not "
                                 f"bitwise the one call: {bitwise}")
        out[policy] = {"walls_s": walls, "max_rel_diff": diffs,
                       "bitwise": bitwise}
        log(f"grid dispatch {policy}: G={len(one)} T={G['n_intervals']} "
            f"substeps={G['substeps']}; largest relative difference from "
            f"the one call "
            + ", ".join(f"{k} {v:.3e} (bitwise {bitwise[k]})"
                        for k, v in diffs.items())
            + f" (rtol {GRID_DISPATCH['rtol']}); walls "
            + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    if dev.type == "cuda" and torch.cuda.device_count() == 1:
        try:
            run_grid_batched("bestfit-rr", **G, device=dev, devices=2)
        except ValueError as e:
            log(f"grid dispatch devices=2 on one card raises: {e}")
        else:
            raise AssertionError("devices=2 ran on a one-card machine")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"grid phase: {out['phase_s']:.1f} s")
    return out


#: the paper's Fig. 2 protocol (``benchmarks/splitnets_fig2.py``): per
#: app a monolithic MLP classifier (depth 4 on 6000 rows for ``steps``
#: steps; depth 2 on 20000 rows for at least ``big_steps`` when it has
#: more than 10 classes) trained at ``batch``, the layer split into
#: ``fragments`` and min(max_branches, classes) semantic branches, held on
#: ``test_rows`` rows; each strategy's latency the median of ``reps``
#: CUDA-synchronized runs
SPLITNETS = dict(apps=("mnist", "fashionmnist", "cifar100"), hidden=256,
                 steps=500, big_steps=800, batch=512, fragments=3,
                 max_branches=4, test_rows=2000, reps=5)


def _synced_ms(fn, device, reps):
    """Median of ``reps`` host-clock runs of ``fn``, each synchronized on
    ``device``'s card."""
    return float(np.median(_synced_runs(fn, device, reps)))


def splitnets_phase(device="cuda"):
    """The paper's own splits, Fig. 2 from first principles, through the
    port's ``core.splitnets`` (SPLITNETS' protocol): per app the
    monolithic classifier's, the layer split's and the semantic split's
    test accuracy and latency, the layer split bitwise equal to the
    monolithic output, the semantic split's time that of its slowest
    branch (its branches stand for parallel placements).  Returns the
    rows by app."""
    import torch
    from repro_torch.core import splitnets as sn
    from repro_torch.data.pipeline import APPS, synthetic_classification
    from repro_torch.device import resolve
    dev = resolve(device)
    P = SPLITNETS
    rows = {}
    for app in P["apps"]:
        spec = APPS[app]
        big = spec.num_classes > 10
        depth, n_train = (2, 20000) if big else (4, 6000)
        steps = max(P["steps"], P["big_steps"]) if big else P["steps"]
        cfg = sn.ClassifierConfig(input_dim=spec.input_dim,
                                  num_classes=spec.num_classes,
                                  hidden=P["hidden"], depth=depth)
        x, y = synthetic_classification(app, n_train, seed=0)
        xt, yt = synthetic_classification(app, P["test_rows"], seed=1)
        t0 = time.perf_counter()
        params = sn.train_classifier(
            torch.Generator(device=dev).manual_seed(0), cfg, x, y,
            steps=steps, batch=P["batch"], device=dev)
        train_s = time.perf_counter() - t0
        xd = torch.as_tensor(xt, device=dev)
        frags = sn.layer_split(params, P["fragments"])
        with torch.no_grad():
            mono = sn.mlp_apply(params, xd)
            layer = sn.layer_split_apply(frags, xd)
            t_full = _synced_ms(lambda: sn.mlp_apply(params, xd), dev,
                                P["reps"])
            t_layer = _synced_ms(lambda: sn.layer_split_apply(frags, xd),
                                 dev, P["reps"])
        if not torch.equal(layer, mono):
            raise AssertionError(f"splitnets {app}: the layer split differs "
                                 f"from the monolithic output")
        acc_full = sn.accuracy(params, xt, yt)
        acc_layer = sn.accuracy(frags, xt, yt, apply=sn.layer_split_apply)
        nb = min(P["max_branches"], spec.num_classes)
        t0 = time.perf_counter()
        branches, groups = sn.train_semantic_split(
            [torch.Generator(device=dev).manual_seed(1 + i)
             for i in range(nb)], cfg, x, y, num_branches=nb, steps=steps,
            device=dev)
        train_sem_s = time.perf_counter() - t0
        with torch.no_grad():
            logits = sn.semantic_split_apply(branches, groups, xd)
            t_branch = [_synced_ms(lambda: sn.mlp_apply(b, xd[:, lo:hi]),
                                   dev, P["reps"])
                        for b, (lo, hi) in zip(branches, groups[1])]
        acc_sem = float((logits.argmax(-1).cpu() == torch.as_tensor(
            yt).long()).float().mean())
        n_full = sum(p["w"].numel() for p in params)
        n_branch = max(sum(p["w"].numel() for p in b) for b in branches)
        if not (acc_layer == acc_full and bool(torch.isfinite(logits).all())
                and acc_full > 2.0 / spec.num_classes
                and n_branch < n_full):
            raise AssertionError(f"splitnets {app}: accuracy full "
                                 f"{acc_full} layer {acc_layer} semantic "
                                 f"{acc_sem}; branch {n_branch} of "
                                 f"{n_full} weights")
        rows[app] = dict(acc_full=acc_full, acc_layer=acc_layer,
                         acc_semantic=acc_sem, latency_full_ms=t_full,
                         latency_layer_ms=t_layer,
                         latency_semantic_ms=max(t_branch),
                         branch_ms=t_branch, train_s=train_s,
                         train_semantic_s=train_sem_s)
        log(f"splitnets {app} ({spec.input_dim} inputs, {spec.num_classes} "
            f"classes; depth {depth}, hidden {P['hidden']}, {n_train} rows, "
            f"{steps} steps at batch {P['batch']}; {len(frags)} fragments, "
            f"{nb} branches of {n_branch} weights against {n_full}) on "
            f"{dev}: accuracy on {P['test_rows']} test rows full "
            f"{acc_full:.4f} layer {acc_layer:.4f} semantic {acc_sem:.4f}; "
            f"latency (median of {P['reps']}, synchronized) full "
            f"{t_full:.4f} ms, layer {t_layer:.4f} ms, semantic "
            f"{max(t_branch):.4f} ms (slowest of branches "
            f"{[round(t, 4) for t in t_branch]}); the layer split equals the "
            f"monolithic output bitwise; training {train_s:.2f} s, branches "
            f"{train_sem_s:.2f} s")
    return rows


def _counters():
    from repro_torch.kernels import placement
    from repro_torch.kernels.edge_substep import edge_substep
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_route import moe_route
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.kernels.threefry import threefry_rows
    return {"edge_substep": edge_substep,
            "bestfit_scan": placement.bestfit_scan,
            "repair_scan": placement.repair_scan,
            "flash_attention": flash_attention,
            "moe_route": moe_route,
            "selective_scan": selective_scan,
            "rglru_scan": rglru_scan,
            "threefry_rows": threefry_rows}


#: the kernels each main path runs (and, once per interval, the draws of
#: the learners that draw: ``DRAW_KERNELS``)
SIM_KERNELS = ("edge_substep", "bestfit_scan", "repair_scan")
DRAW_KERNELS = ("threefry_rows",)
#: the serving kernels each block kind launches per layer per forward
#: (an ``xattn`` block runs flash twice: self and cross attention)
LAYER_KERNELS = {"flash_attention": {"attn": 1, "attn_moe": 1,
                                     "local_attn": 1, "xattn": 2},
                 "moe_route": {"attn_moe": 1}, "selective_scan": {"mamba": 1},
                 "rglru_scan": {"rglru": 1}}
#: block kinds that run attention
ATTN_KINDS = set(LAYER_KERNELS["flash_attention"])


def per_forward(name, kinds):
    """Launches of serving kernel ``name`` in one forward over layers of
    ``kinds``."""
    return sum(LAYER_KERNELS[name].get(k, 0) for k in kinds)


class CompileClock:
    """While active, sums the wall seconds of the host trace compiles
    ``run_grid_batched`` makes (``seconds``)."""

    def __enter__(self):
        from repro_torch.env import torchsim
        self._mod, self.seconds = torchsim, 0.0
        self._fns = {name: getattr(torchsim, name)
                     for name in ("compile_trace", "compile_trace_dual")}
        for name, fn in self._fns.items():
            setattr(torchsim, name, self._timed(fn))
        return self

    def _timed(self, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
        return call

    def __exit__(self, *exc):
        for name, fn in self._fns.items():
            setattr(self._mod, name, fn)


def main_path(policy, label=None, draws=False, grid=None, **kw):
    """One main-path grid through run_grid_batched with every kernel's
    launch count set to 0 just before and read just after; ``draws``: the
    policy draws once per interval (``DRAW_KERNELS``); ``grid`` overrides
    MAIN.  Returns (records, wall s, launches per kernel, phase
    seconds)."""
    import torch
    from repro_torch.env.torchsim.driver import PHASES
    from repro_torch.launch.experiments import run_grid_batched
    label = label or policy
    grid = grid or MAIN
    phase_s = {}
    gc.collect()
    torch.cuda.synchronize()
    for fn in _counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    with CompileClock() as compile_s:
        recs = run_grid_batched(policy, **grid, device="cuda",
                                phase_s=phase_s, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in _counters().items()}
    for name in SIM_KERNELS + (DRAW_KERNELS if draws else ()):
        count = launches[name]
        if count != grid["n_intervals"]:
            raise AssertionError(f"{label}: {name} launched {count} times, "
                                 f"expected once per interval "
                                 f"({grid['n_intervals']})")
    for r in recs:
        if r["dropped_tasks"] != 0:
            raise AssertionError(f"{label}: dropped tasks in {r}")
        if not r["tasks_completed"] > 0:
            raise AssertionError(f"{label}: no task completed in {r}")
        if not 0.0 <= r["reward"] <= 1.0:
            raise AssertionError(f"{label}: reward out of [0, 1] in {r}")
    tasks = sum(r["tasks_completed"] for r in recs)
    shares = [f"the MAB's host reads {phase_s.get('mab_host_read', 0.0):.4f}"
              " s of feedback"]
    if "draw" in phase_s:
        shares.append(f"the draws {phase_s['draw']:.4f} s of decide")
    if "daso_train" in phase_s:
        shares.append(f"the DASO finetune {phase_s['daso_train']:.4f} s of "
                      "feedback")
    log(f"main path {label}: G={len(recs)} T={grid['n_intervals']} "
        f"substeps={grid['substeps']}: wall {wall:.3f} s, "
        f"{len(recs) / wall:.3f} traces/s, {tasks / wall:.1f} tasks/s "
        f"({int(tasks)} tasks); launches {launches}; phases "
        + ", ".join(f"{k} {phase_s[k]:.3f} s" for k in PHASES)
        + " (" + "; ".join(shares) + ")"
        + f", host {wall - sum(phase_s[k] for k in PHASES):.3f} s (of it "
        f"the trace compile {compile_s.seconds:.3f} s; the rest upload, "
        f"state and summaries)"
        + f"; mean reward {np.mean([r['reward'] for r in recs]):.4f}")
    return recs, wall, launches, phase_s


#: each simulator kernel's name in the profiler's records
SIM_SYMBOLS = {"edge_substep": "edge_substep_kernel",
               "bestfit_scan": "bestfit_kernel",
               "repair_scan": "repair_kernel"}


def _cuda_events(prof):
    """(kernel name, summed device ms, launches) of every device kernel a
    torch.profiler run recorded."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        out.append((ev.key, us / 1e3, ev.count))
    return out


def sim_profile(policy, **kw):
    """One more main-path run under torch.profiler (CUPTI): each simulator
    kernel's summed device time and launches in the run, and the device
    time and kernel count of the whole run; {} if the profiler recorded
    none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.experiments import run_grid_batched
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_grid_batched(policy, **MAIN, device="cuda", **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sums = {name: [0.0, 0] for name in SIM_SYMBOLS}
    events = _cuda_events(prof)
    busy = sum(ms for _, ms, _ in events)
    count = sum(n for _, _, n in events)
    for key, ms, n in events:
        for name, sym in SIM_SYMBOLS.items():
            if sym in key:
                sums[name][0] += ms
                sums[name][1] += n
    if busy == 0.0:
        log(f"profile of a {policy} main-path run: the profiler recorded no "
            "device time (not measured)")
        return {}
    log(f"profile of a {policy} main-path run (G=16 T=100 substeps=30): "
        f"wall {wall:.3f} s under the profiler, device busy {busy:.2f} ms "
        f"in {count} kernels (idle share at most "
        f"{1 - busy / (wall * 1e3):.3f}); "
        + "; ".join(f"{name} {ms:.3f} ms in {count} launches "
                    f"({ms / max(count, 1):.4f} ms each)"
                    for name, (ms, count) in sums.items())
        + f"; other kernels {busy - sum(v[0] for v in sums.values()):.2f} ms")
    return sums


class DasoTally:
    """While active, wraps the DASO stage of the interval program: every
    ascent (one per interval) leaves its per-cell steps, valid rows and
    rows whose argmax left the warm start on the device, read once at the
    end; the stage's operands at interval ``capture_at`` are kept for
    ``daso_stage_profile``."""

    def __init__(self, capture_at=None):
        self.capture_at = capture_at
        self.steps, self.rows, self.moved = [], [], []
        self.captured = None

    def __enter__(self):
        from repro_torch.core import daso
        from repro_torch.env.torchsim import engines
        self._daso, self._engines = daso, engines
        self._ascent = daso.optimize_placement_grid
        self._place = engines._daso_place

        def ascent(cfg, theta, state, p0, dec, mask):
            p, score, steps = self._ascent(cfg, theta, state, p0, dec, mask)
            valid = mask.bool()
            self.steps.append(steps)
            self.rows.append(valid.sum(dim=1))
            self.moved.append(((p.argmax(-1) != p0.argmax(-1))
                               & valid).sum(dim=1))
            return p, score, steps

        def place(cfg, es, state, cl, trace, t, interval_s):
            if t == self.capture_at:
                self.captured = (cfg, es["theta"],
                                 {k: v.clone() for k, v in state.items()},
                                 cl, trace["lat_prev"][:, t].clone(),
                                 interval_s)
            return self._place(cfg, es, state, cl, trace, t, interval_s)

        daso.optimize_placement_grid = ascent
        engines._daso_place = place
        return self

    def __exit__(self, *exc):
        self._daso.optimize_placement_grid = self._ascent
        self._engines._daso_place = self._place

    def read(self):
        """(steps, valid rows, rows moved), each (intervals, cells)."""
        import torch
        return tuple(torch.stack(x).cpu().numpy()
                     for x in (self.steps, self.rows, self.moved))


def daso_report(tally, cfg, label, intervals):
    """Ascent steps per interval and rows moved off the warm start in one
    run of ``intervals`` intervals; returns the rows moved."""
    steps, rows, moved = tally.read()
    if steps.shape[0] != intervals:
        raise AssertionError(f"{label}: {steps.shape[0]} ascents, expected "
                             f"one per interval ({intervals})")
    full = float(np.mean(steps == cfg.place_iters))
    log(f"{label}: DASO ascent steps per interval and cell mean "
        f"{steps.mean():.2f}, min {steps.min()}, max {steps.max()} of "
        f"{cfg.place_iters} (share at place_iters {full:.3f}); "
        f"{int(rows.sum())} container rows over the run (C="
        f"{cfg.max_containers}, {rows.mean():.2f} per interval and cell), "
        f"{int(moved.sum())} moved off the warm start "
        f"({moved.sum() / max(rows.sum(), 1):.4f} of rows)")
    return int(moved.sum())


def daso_stage_profile(captured):
    """The DASO stage (``state_features_k`` + ``daso_requests``) at one
    captured main-path interval: launches and device ms under
    torch.profiler, and ms per stage from CUDA events and from the host
    clock around a synchronized call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.env.torchsim import kernels
    cfg, theta, state, cl, lat, interval_s = captured
    req = kernels.bestfit_requests(state, cl)

    def stage():
        feat = kernels.state_features_k(state, cl, lat, interval_s)
        return kernels.daso_requests(cfg, theta, state, feat, req)

    first = stage()
    if not torch.equal(first, stage()):
        raise AssertionError("DASO stage: two runs on one interval differ")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stage()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev_ms = cuda_ms(stage, 5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stage()
        torch.cuda.synchronize()
    events = _cuda_events(prof)
    busy = sum(ms for _, ms, _ in events)
    count = sum(n for _, _, n in events)
    per_step = (count / cfg.place_iters) if cfg.place_iters else 0.0
    log(f"DASO stage at main-path interval {DASO_PROFILE_INTERVAL} (G="
        f"{state['worker'].shape[0]}, K={state['worker'].shape[1]}, C="
        f"{cfg.max_containers}, hidden {cfg.hidden}, depth {cfg.depth}, "
        f"{cfg.place_iters} steps): {count} launches ({per_step:.1f} per "
        f"ascent step), device busy {busy:.3f} ms, {ev_ms:.3f} ms per stage "
        f"(CUDA events), {host_ms:.3f} ms host clock; repeatable bitwise")
    return count, busy, ev_ms


def daso_path(mab_state):
    """The splitplace main path at SurrogatePlacer's widths, with its DASO
    tallies, the stage's launches at one interval and a profiled run;
    returns the main path's records and wall s."""
    import torch
    from repro_torch.core.daso import DASOConfig, init_surrogate
    cfg = DASOConfig(**DASO_MAIN)
    gen = torch.Generator(device="cuda").manual_seed(DASO_SEED)
    theta = init_surrogate(cfg, gen, device="cuda")
    kw = dict(mab_state=mab_state, daso_theta=theta, daso_cfg=cfg)
    with DasoTally(capture_at=DASO_PROFILE_INTERVAL) as tally:
        recs, wall, _, _ = main_path("splitplace", **kw)
    daso_report(tally, cfg, "main path splitplace", MAIN["n_intervals"])
    daso_stage_profile(tally.captured)
    sim_profile("splitplace", **kw)
    return recs, wall


class DrawTap:
    """While active, keeps the operands and outputs of every
    ``threefry_rows`` call the simulator's learners make (the wrapper
    still launches and counts once per call); ``check`` holds each output
    bitwise against the twin on the same operands."""
    MODULES = ("repro_torch.core.mab", "repro_torch.env.torchsim.engines")

    def __enter__(self):
        import importlib
        self.calls = []
        self._mods = [importlib.import_module(m) for m in self.MODULES]
        self._fn = self._mods[0].threefry_rows
        if any(m.threefry_rows is not self._fn for m in self._mods):
            raise AssertionError("the learners call different threefry_rows")
        for mod in self._mods:
            mod.threefry_rows = self._tapped
        return self

    def _tapped(self, key, t, rows, p=None, width=64):
        out = self._fn(key, t, rows, p, width)
        outs = out if isinstance(out, tuple) else (out,)
        self.calls.append((key.clone(), t, rows,
                           None if p is None else p.clone(), width,
                           tuple(o.clone() for o in outs)))
        return out

    def __exit__(self, *exc):
        for mod in self._mods:
            mod.threefry_rows = self._fn

    def check(self, label):
        """(draws checked, largest difference); raises on a mismatch."""
        from repro_torch.kernels.ref import threefry_rows_ref
        err = 0.0
        for key, t, rows, p, width, outs in self.calls:
            ref = threefry_rows_ref(key, t, rows, p, width)
            err = max(err, draw_err(
                outs, ref if isinstance(ref, tuple) else (ref,),
                f"{label} t={t} (G={key.shape[0]} A={rows})"))
        shapes = sorted({(c[0].shape[0], c[2]) for c in self.calls})
        log(f"{label}: its {len(self.calls)} draws (G, A) in {shapes} equal "
            f"the twin on the same operands bitwise (largest difference "
            f"{err})")
        return len(self.calls), err


def train_paths(mab_state):
    """This slice's main paths at the main grid: ``splitplace`` and ``mab``
    in train mode (default ``TRAIN_HP``: the ascent from interval 32, the
    finetune from interval 7), ``gillis`` and ``random+daso``, the DASO
    stages at ``SurrogatePlacer``'s widths with θ from a seeded CUDA
    generator; returns ``threefry_rows``' launches per path and the
    largest difference of its draws there from the twin's."""
    import torch
    from repro_torch.core.daso import DASOConfig, init_surrogate
    from repro_torch.env.torchsim import TRAIN_HP
    cfg = DASOConfig(**DASO_MAIN)
    gen = torch.Generator(device="cuda").manual_seed(DASO_SEED)
    theta = init_surrogate(cfg, gen, device="cuda")
    draws, err = {}, 0.0
    with DasoTally() as tally, DrawTap() as tap:
        _, _, launches, _ = main_path(
            "splitplace", label="splitplace train", draws=True, mode="train",
            mab_state=mab_state, daso_theta=theta, daso_cfg=cfg)
    daso_report(tally, cfg, "main path splitplace train",
                MAIN["n_intervals"] - TRAIN_HP[3])
    draws["splitplace train"] = launches["threefry_rows"]
    err = max(err, tap.check("main path splitplace train")[1])
    for label, policy, kw in (
            ("mab train", "mab", dict(mode="train", mab_state=mab_state)),
            ("gillis", "gillis", {}),
            ("random+daso", "random+daso",
             dict(daso_theta=theta, daso_cfg=cfg))):
        with DrawTap() as tap:
            _, _, launches, _ = main_path(policy, label=label, draws=True,
                                          **kw)
        draws[label] = launches["threefry_rows"]
        err = max(err, tap.check(f"main path {label}")[1])
    return draws, err


def _expected_params(cfg):
    """Parameters ``init_params`` makes: ``param_count()``, plus each MoE
    layer's (d, 1) shared-expert gate, which the reference's init makes
    and its analytic count leaves out."""
    gates = 0
    if cfg.moe is not None and cfg.moe.num_shared_experts:
        gates = cfg.layer_kinds.count("attn_moe") * cfg.d_model
    return cfg.param_count() + gates


def _extras_on_card(extras):
    import torch
    return {k: torch.as_tensor(v, device="cuda") for k, v in extras.items()}


def serving_path(arch):
    """One serving main path: ``arch`` at full width through
    ``SplitPlaceEngine`` (the port's ``launch.serve`` request loop), with
    ``request_extras``' seeded inputs for EXTRA_ARCHS and every kernel's
    launch count set to 0 just before and read just after; returns the
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import request_extras, serve_requests
    from repro_torch.models.model import forward, init_params
    from repro_torch.serving.plans import branch_forward
    cfg = get_config(arch)
    extras = request_extras(cfg, SERVE["batch"], SERVE["seq"],
                            grid=EXTRA_GRID)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    if n_params != _expected_params(cfg):
        raise AssertionError(f"{arch}: {n_params} parameters, the config "
                             f"counts {_expected_params(cfg)}")
    kinds = "/".join(sorted(set(cfg.layer_kinds)))
    log(f"serving: {arch} {cfg.num_layers} {kinds} layers d={cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} "
        f"hd={cfg.resolved_head_dim} d_ff={cfg.d_ff} moe={cfg.moe} "
        f"ssm={cfg.ssm} rglru={cfg.rglru} vocab {cfg.vocab_size} "
        f"pos_emb={cfg.pos_emb} codebooks={cfg.num_codebooks} inputs "
        f"{['tokens'] + sorted(extras)} {cfg.param_dtype}: "
        f"{n_params} parameters (param_count() {cfg.param_count()}, "
        f"{n_bytes / 1e9:.3f} GB) made in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    for fn in _counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = serve_requests(params, cfg, requests=SERVE["requests"],
                         batch=SERVE["batch"], seq=SERVE["seq"],
                         stages=SERVE["stages"], branches=SERVE["branches"],
                         device="cuda", log=log, extras=extras)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in _counters().items()}
    results, B = out["results"], SERVE["branches"]
    # warmup (pipe + branches + mono), the two timed plans, then per
    # request its plan and the monolithic reference
    forwards = (1 + B + 1) + (1 + B) + sum(
        (1 if r.plan == 0 else B) + 1 for r in results)
    for name in SIM_KERNELS:
        if launches[name]:
            raise AssertionError(f"{arch}: {name} launched while serving")
    for name in LAYER_KERNELS:
        want = per_forward(name, cfg.layer_kinds) * forwards
        if launches[name] != want:
            raise AssertionError(f"{arch}: {name} launched "
                                 f"{launches[name]} times, the path's "
                                 f"{forwards} forwards need {want}")
    for i, r in enumerate(results):
        if not (np.isfinite(r.latency_s) and np.isfinite(r.reward)
                and 0.0 <= r.fidelity <= 1.0):
            raise AssertionError(f"{arch}: request {i}: {r}")
        if r.plan == 0 and r.fidelity != 1.0:
            raise AssertionError(f"{arch}: layer-plan fidelity "
                                 f"{r.fidelity} != 1.0 at request {i}")
    eng = out["engine"]
    if len(eng._replay) < 16:
        raise AssertionError(f"{arch}: DASO never reached its replay gate")
    Q = eng.state.Q[0].cpu().numpy()
    if not np.isfinite(Q).all():
        raise AssertionError(f"{arch}: MAB Q not finite: {Q}")
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    tok = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (SERVE["batch"], SERVE["seq"]) + cb).astype(
            np.int32), device="cuda")
    batch = {"tokens": tok, **_extras_on_card(extras)}
    with torch.no_grad():
        logits = forward(params, batch, cfg)
    if logits.shape != (SERVE["batch"], SERVE["seq"]) + cb + (
            cfg.vocab_size,) or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: logits {tuple(logits.shape)} "
                             f"finite={bool(torch.isfinite(logits).all())}")
    del logits
    if arch in SERVE_ARCHS:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _forward_no_grad(params, batch, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        count_check(f"{arch} forward ({SERVE['batch']} x {SERVE['seq']})",
                    _forward_no_grad, (params, batch, cfg), _forward_no_grad,
                    float(np.median(times)) * 1e3)
    tokens = SERVE["batch"] * SERVE["seq"]
    by_plan = {p: [r for r in results if r.plan == p] for p in (0, 1)}
    fid = {p: float(np.mean([r.fidelity for r in rs])) if rs else None
           for p, rs in by_plan.items()}
    log(f"serving main path {arch}: {len(results)} requests of {tokens} "
        f"tokens in {wall:.3f} s wall ({len(results) / wall:.3f} requests/s, "
        f"{len(results) * tokens / wall:.1f} tokens/s served, warmup and "
        f"the two timed plan runs included); plan latency layer-pipeline "
        f"{out['t_layer'] * 1e3:.2f} ms ({tokens / out['t_layer']:.1f} "
        f"tokens/s), semantic-branch {out['t_sem'] * 1e3:.2f} ms per branch "
        f"({tokens / out['t_sem']:.1f} tokens/s); plans "
        f"{[r.plan for r in results]} (layer {len(by_plan[0])}, semantic "
        f"{len(by_plan[1])}); mean fidelity layer {fid[0]} semantic "
        f"{fid[1]}; deadlines met {sum(r.met_deadline for r in results)}/"
        f"{len(results)}; mean reward "
        f"{np.mean([r.reward for r in results]):.4f}; {forwards} forwards, "
        f"launches {launches}; final MAB Q "
        f"{np.round(Q.astype(float), 4).tolist()} N "
        f"{eng.state.N[0].cpu().numpy().tolist()}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    # the plans' spread within this run, outside the counted path
    runs = {p: [eng._run(p, batch)[1] * 1e3 for _ in range(5)]
            for p in (0, 1)}
    log(f"{arch} plan runs after serving, ms (semantic per branch): layer "
        f"{[round(t, 3) for t in runs[0]]}, semantic "
        f"{[round(t, 3) for t in runs[1]]}")
    if cfg.moe is not None:
        real_routing_check(params, batch, cfg)
    profile_run(f"{arch}: one monolithic forward",
                lambda: forward(params, batch, cfg))
    if arch in (SERVE_ARCHS[0],) + EXTRA_ARCHS:
        profile_run(f"{arch}: one semantic-plan run "
                    f"({SERVE['branches']} branches)",
                    lambda: branch_forward(params, batch, cfg,
                                           SERVE["branches"]))
    return launches, decode_path(arch, params, cfg, extras)


def real_routing_check(params, batch, cfg):
    """moe_route's kernel vs its twin on the router logits of every MoE
    layer of one forward of the served model.  Logits from real
    activations are not on a grid, so two probabilities may lie an ulp
    apart and the two softmaxes may order them differently: every choice
    that differs must be such a near-tie (twin probabilities within 1e-6
    relative); where the choices agree, slots must agree exactly and gates
    within GATE_ATOL."""
    import torch
    from repro_torch.kernels.moe_route import moe_route_cuda
    from repro_torch.kernels.ref import moe_route_ref
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import forward
    captured = []
    router_logits = moe_mod.router_logits

    def capture(p, x):
        out = router_logits(p, x)
        captured.append(out)
        return out

    moe_mod.router_logits = capture
    try:
        with torch.no_grad():
            forward(params, batch, cfg)
    finally:
        moe_mod.router_logits = router_logits
    k, differ, rows = cfg.moe.top_k, 0, 0
    for layer, logits in enumerate(captured):
        got = moe_route_cuda(logits, k)
        want = moe_route_ref(logits, k)
        probs = torch.softmax(logits, dim=-1)
        bad = got[0] != want[0]
        if bad.any():
            differ += int(bad.sum())
            rows += int(bad.any(-1).sum())
            pk = torch.gather(probs, -1, got[0].long())[bad]
            pt = torch.gather(probs, -1, want[0].long())[bad]
            gap = float(((pk - pt).abs() / pt.clamp(min=1e-30)).max())
            if not gap < 1e-6:
                raise AssertionError(f"real routing, layer {layer}: a choice "
                                     f"differs by {gap:.3e} relative")
        else:
            if not torch.equal(got[2], want[2]):
                raise AssertionError(f"real routing, layer {layer}: slots "
                                     f"differ")
            err = float((got[1] - want[1]).abs().max())
            if not err <= GATE_ATOL:
                raise AssertionError(f"real routing, layer {layer}: gate "
                                     f"err {err:.3e}")
    log(f"real routing: {len(captured)} MoE layers of one forward "
        f"({captured[0].shape[1]} tokens, {cfg.moe.num_experts} experts, "
        f"top-{k}): {differ} choices in {rows} tokens differ between the "
        f"kernel and its twin, all near-ties (< 1e-6 relative)")


def _family(name):
    """The family of a device kernel, by its name (moe_route's memset
    nodes are moved to routing by profile_run)."""
    if "flash_attention" in name:
        return "attention (flash kernel)"
    if "rglru_kernel" in name:
        return "rg-lru scan (kernel)"
    if "route_kernel" in name:
        return "moe routing (moe_route kernel)"
    if "scan_kernel" in name:
        return "selective scan (kernel)"
    if any(w in name for w in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matrix products (cuBLAS)"
    return "elementwise and other"


def profile_run(label, fn, shape=None):
    """Device time of one run of ``fn`` by kernel family, read from
    torch.profiler (CUPTI); the wall is the host clock around the same run
    under the profiler, so the idle share is an upper bound.  ``shape``
    names the tokens of the run (default SERVE's batch × seq)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels[ev.key] = (us / 1e3, ev.count)
    busy = sum(ms for ms, _ in kernels.values())
    if busy == 0.0:
        log(f"profile of {label}: the profiler recorded no device time "
            "(not measured)")
        return
    fams = {}
    for name, (ms, n) in kernels.items():
        ms0, n0 = fams.get(_family(name), (0.0, 0))
        fams[_family(name)] = (ms0 + ms, n0 + n)
    route = _family("route_kernel")
    if route in fams:
        # moe_route's memset node (its ticket and tile flags) carries no
        # kernel name: it is the node just before each route_kernel on the
        # same stream, and moves from elementwise to routing
        nodes = sorted((ev for ev in prof.events()
                        if ev.device_type == DeviceType.CUDA),
                       key=lambda ev: (ev.device_resource_id,
                                       ev.time_range.start))
        ms, n, before = 0.0, 0, set()
        for a, b in zip(nodes, nodes[1:]):
            if ("route_kernel" in b.name
                    and a.device_resource_id == b.device_resource_id):
                before.add(a.name[:40])
                if "memset" in a.name.lower():
                    ms += a.time_range.elapsed_us() / 1e3
                    n += 1
        log(f"profile of {label}: {n} memset nodes of moe_route, "
            f"{ms:.4f} ms, counted as routing (nodes just before "
            f"route_kernel: {sorted(before)})")
        other = _family("memset")
        ms0, n0 = fams.get(other, (0.0, 0))
        fams[other] = (ms0 - ms, n0 - n)
        fams[route] = (fams[route][0] + ms, fams[route][1] + n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    shape = shape or f"{SERVE['batch']} x {SERVE['seq']} tokens"
    log(f"profile of {label} ({shape}): "
        f"wall {wall_ms:.2f} ms under the profiler, device busy "
        f"{busy:.2f} ms (idle share at most {1 - busy / wall_ms:.3f}); "
        + "; ".join(f"{f} {ms:.2f} ms in {n} kernels "
                    f"({ms / busy:.3f} of busy)"
                    for f, (ms, n) in sorted(fams.items(),
                                             key=lambda kv: -kv[1][0]))
        + "; top kernels: "
        + "; ".join(f"{name[:60]} {ms:.2f} ms x{n}"
                    for name, (ms, n) in top))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def logit_atol(cfg, atol=1e-5):
    """The float32 cross-checks' atol for ``cfg``'s logits: ``atol``
    times the logits' scale at init, which is 1 where the head is drawn
    at fan-in d and √(d / cb) where the reference draws musicgen's (cb, d,
    V) head at fan-in cb (``dense_init``'s ``shape[0]``)."""
    if not cfg.num_codebooks or cfg.tie_embeddings:
        return atol
    return atol * (cfg.d_model / cfg.num_codebooks) ** 0.5


def model_cross_check():
    """Each serving model and both plans on the card against the CPU at the
    reference's CPU size in float32 (rtol 1e-4 / atol 1e-5, TF32 off on
    both; EXTRA_ARCHS with ``request_extras``' inputs on a 2 × 2 patch
    grid; musicgen's atol scaled with its logits, ``logit_atol``); the
    layer plan equals the forward bitwise on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import request_extras
    from repro_torch.models.model import forward, init_params
    from repro_torch.serving.plans import (branch_forward,
                                           optimal_stage_bounds,
                                           pipeline_forward)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the cross-check needs "
                             "float32 products")
    for arch in SERVE_ARCHS + EXTRA_ARCHS:
        cfg = get_config(arch).reduced(max_d_model=256, max_layers=4)
        cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
        tok = torch.from_numpy(np.random.RandomState(1).randint(
            0, cfg.vocab_size, (2, 64) + cb).astype(np.int32))
        params = {dev: init_params(cfg, torch.Generator().manual_seed(0),
                                   device=dev) for dev in ("cuda", "cpu")}
        ex = {k: torch.from_numpy(v) for k, v in
              request_extras(cfg, 2, 64, grid=2).items()}
        batch = {dev: {"tokens": tok.to(dev),
                       **{k: v.to(dev) for k, v in ex.items()}}
                 for dev in ("cuda", "cpu")}
        bounds = optimal_stage_bounds(cfg, seq=256, batch=1,
                                      num_stages=SERVE["stages"])
        runs = {
            "forward": lambda d: forward(params[d], batch[d], cfg),
            "pipeline_forward": lambda d: pipeline_forward(
                params[d], batch[d], cfg, SERVE["stages"], bounds=bounds),
            "branch_forward": lambda d: branch_forward(
                params[d], batch[d], cfg, SERVE["branches"]),
        }
        out = {}
        for name, run in runs.items():
            with torch.no_grad():
                out[name] = run("cuda")
                torch.testing.assert_close(
                    out[name].cpu(), run("cpu"), rtol=1e-4,
                    atol=logit_atol(cfg),
                    msg=lambda m: f"{arch} {name}: {m}")
        if not torch.equal(out["pipeline_forward"], out["forward"]):
            raise AssertionError(f"{arch}: pipeline_forward differs from "
                                 f"forward on cuda")
        log(f"cross-check: the reduced {arch} forward, layer plan and "
            f"{SERVE['branches']}-branch semantic plan on cuda match the cpu "
            f"path at rtol=1e-4 / atol={logit_atol(cfg):.3g}; the layer "
            "plan equals the forward bitwise")


def _cache_bytes(cache):
    return sum(t.numel() * t.element_size() for c in cache for t in c.values())


def _lossless(cfg):
    """``cfg`` with MoE capacity of a whole group (capacity factor E / k,
    with a margin for the float product): no token is dropped, as none is
    in decode's groups of b <= top_k tokens (capacity top_k, each token's
    experts distinct)."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k * 1.001))


class RouteTap:
    """Within its ``with``, keeps the expert ids of every ``moe_route``
    call the model makes (``models.moe``'s name is wrapped; the kernel
    and its launch count are untouched)."""

    def __init__(self):
        self.eids = []

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        self._mod, self._route = moe_mod, moe_mod.moe_route

        def route(logits, k):
            out = self._route(logits, k)
            self.eids.append(out[0])
            return out

        moe_mod.moe_route = route
        return self

    def __exit__(self, *exc):
        self._mod.moe_route = self._route

    def flips(self, stepped, b, s, n, layers):
        """(b, n) bool: decode rows whose expert set differs from the
        forward's (``self.eids``, one call per layer) in some layer;
        ``stepped`` holds the decode steps' calls, n × layers."""
        import torch
        flips = torch.zeros((b, n), dtype=torch.bool, device="cuda")
        for layer, fw in enumerate(self.eids[:layers]):
            fw = fw.reshape(-1, fw.shape[-1])[:b * (s + n)]
            fw = fw.reshape(b, s + n, -1)[:, s:].sort(-1).values
            for i in range(n):
                got = stepped[i * layers + layer].reshape(b, -1)
                flips[:, i] |= (got.sort(-1).values != fw[:, i]).any(-1)
        return flips


def _next_tokens(last):
    """Greedy next tokens of last-position logits (b, vocab) or (b, cb,
    vocab): (b, 1) or (b, 1, cb) int32."""
    import torch
    return last.argmax(-1).to(torch.int32)[:, None]


def _decode_batches(extras, s, n):
    """The prompt's batch entries (``extras``, on the card), each decode
    step's (musicgen's ``cond``) and the teacher-forced forward's over
    prompt + n generated tokens: qwen2-vl's visual block stays in the
    prompt, and the generated tokens sit at their decode position on all
    three M-RoPE streams, as decode rotates them."""
    import torch
    ex = _extras_on_card(extras)
    step = {k: v for k, v in ex.items() if k == "cond"}
    full = dict(step)
    if "visual_embeds" in ex:
        ve, vm = ex["visual_embeds"], ex["visual_mask"]
        full["visual_embeds"] = torch.cat(
            [ve, ve.new_zeros((ve.shape[0], n, ve.shape[2]))], 1)
        full["visual_mask"] = torch.cat(
            [vm, vm.new_zeros((vm.shape[0], n))], 1)
    if "positions3" in ex:
        p3 = ex["positions3"]
        gen = torch.arange(s, s + n, dtype=p3.dtype, device=p3.device)
        full["positions3"] = torch.cat(
            [p3, gen.expand(p3.shape[0], 3, n)], 2)
    return ex, step, full


def decode_path(arch, params, cfg, extras=None):
    """The decode main path of one served model at full width through
    ``launch.steps``: ``make_prefill_step`` on SERVE's batch × seq prompt
    (with ``extras``, the serving path's inputs; caches of seq + headroom
    positions), then ``make_serve_step`` for DECODE["steps"] greedy tokens
    (musicgen: one per codebook, with its ``cond``), every kernel's launch
    count set to 0 just before and read just after; each attention kernel
    must run once per attention layer per call (twice per ``xattn``
    layer), moe_route once per MoE layer per call, the scans once per
    layer in the prefill only.  Then the teacher-forced
    forward of prompt + the generated tokens against the decode logits,
    within DECODE["bf16_rel"] of the largest forward logit, and one decode
    step under the profiler.  In an MoE model a router near-tie that bf16
    rounding flips sends a row to other experts, and its logits then
    differ by O(1) (the card's float32 gate shows none flips there); the
    bound holds over the rows whose every layer picked the forward's
    experts, and the flipped rows are counted and reported.  An MoE model's prefill routes its 4096-token
    group at the model's capacity and drops tokens, which a forward over
    prompt + generated tokens, grouped otherwise, does not drop alike; so
    for it the check prefills and decodes the same tokens again with
    lossless routing (``_lossless``) beside a lossless forward.  Returns
    the launches."""
    import torch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import forward
    b, s, n = SERVE["batch"], SERVE["seq"], DECODE["steps"]
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    prompt = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (b, s) + cb).astype(np.int32), device="cuda")
    ex, step_ex, full_ex = _decode_batches(extras or {}, s, n)
    prefill_step = make_prefill_step(cfg, device="cuda",
                                     max_ctx=s + DECODE["headroom"])
    serve_step = make_serve_step(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in _counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        last, cache = prefill_step(params, {"tokens": prompt, **ex})
        tok = _next_tokens(last)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = {name: fn.launches for name, fn in _counters().items()}
    toks, rows, step_ms = [tok], [], []
    with torch.no_grad():
        for i in range(n):
            t0 = time.perf_counter()
            logits, cache = serve_step(params, toks[-1], cache, s + i,
                                       step_ex)
            toks.append(_next_tokens(logits))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(logits)
    launches = {name: fn.launches for name, fn in _counters().items()}
    peak = torch.cuda.max_memory_allocated()
    kinds = cfg.layer_kinds
    want = {name: per_forward(name, kinds) * (1 + n)
            for name in LAYER_KERNELS}
    want["selective_scan"] = kinds.count("mamba")
    want["rglru_scan"] = kinds.count("rglru")
    for name in SIM_KERNELS + DRAW_KERNELS:
        want[name] = 0
    if launches != want:
        raise AssertionError(f"{arch} decode: launches {launches}, the "
                             f"prefill and {n} steps need {want}")
    dec = torch.stack(rows, 1)                     # (b, n[, cb], V)
    if not torch.isfinite(dec).all() or \
            dec.shape != (b, n) + cb + (cfg.vocab_size,):
        raise AssertionError(f"{arch} decode: logits {tuple(dec.shape)} "
                             f"finite={bool(torch.isfinite(dec).all())}")
    gen = torch.cat(toks[:n], 1)                            # (b, n[, cb])
    check = _lossless(cfg)
    tap = RouteTap()
    with torch.no_grad(), tap:
        if cfg.moe is not None:
            # the check's own lossless prefill and teacher-forced decode
            _, again = make_prefill_step(check, device="cuda",
                                         max_ctx=s + DECODE["headroom"])(
                params, {"tokens": prompt})
            tap.eids.clear()
            step = make_serve_step(check, device="cuda")
            rows = []
            for i in range(n):
                logits, again = step(params, gen[:, i:i + 1], again, s + i)
                rows.append(logits)
            dec = torch.stack(rows, 1)
            del again
        stepped = list(tap.eids)
        tap.eids.clear()
        full = forward(params, {"tokens": torch.cat([prompt, gen], 1),
                                **full_ex}, check)[:, s:]
    # rows (batch row, step) whose experts differ from the forward's in
    # some layer: a near-tie of the router that bf16 rounding flips
    flips = tap.flips(stepped, b, s, n, kinds.count("attn_moe"))
    err = (dec - full).abs().flatten(2).amax(-1) / full.abs().max()  # (b, n)
    rel = float(err.max())
    held = float(err[~flips].max()) if (~flips).any() else float("nan")
    agree = float((full.argmax(-1) == dec.argmax(-1)).float().mean())
    del full
    if not held <= DECODE["bf16_rel"]:
        raise AssertionError(f"{arch} decode vs teacher-forced forward: "
                             f"max |diff| / max |logit| {held:.4e} > "
                             f"{DECODE['bf16_rel']} over the "
                             f"{int((~flips).sum())} rows routed alike")
    steady = sorted(step_ms[1:])
    med = steady[len(steady) // 2]
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    per_step = {k: (v - prefill_launches[k]) / n for k, v in launches.items()
                if v}
    log(f"decode main path {arch} (launch.steps, {cfg.param_dtype}): prefill "
        f"{b} x {s} tokens into caches of {s + DECODE['headroom']} positions "
        f"in {prefill_ms:.2f} ms, then {n} greedy steps: per step median "
        f"{med:.3f} ms, min {steady[0]:.3f}, max {steady[-1]:.3f} (first "
        f"{step_ms[0]:.3f} left out), {b * 1e3 / med:.1f} tokens/s; bound per "
        f"step {w_bytes / H100_BYTES_S * 1e3:.3f} ms (the {w_bytes / 1e9:.2f}"
        f" GB of weights read once at 3.35 TB/s; the cache adds "
        f"{_cache_bytes(cache) / H100_BYTES_S * 1e3:.3f} ms); cache "
        f"{_cache_bytes(cache) / 1e6:.1f} MB; peak memory {peak / 1e9:.2f} "
        f"GB; launches {launches} (per step {per_step}); decode vs the "
        f"teacher-forced forward{' (lossless routing)' if cfg.moe else ''}: "
        f"max |diff| / max |logit| {held:.4e} over the "
        f"{int((~flips).sum())} of {b * n} rows whose every layer picked the "
        f"forward's experts (bound {DECODE['bf16_rel']}), {rel:.4e} over all "
        f"rows; {int(flips.sum())} rows with a flipped router near-tie; "
        f"greedy tokens agree {agree:.4f}")
    profile_run(f"{arch}: one decode step", lambda: serve_step(
        params, toks[n - 1], cache, s + n - 1, step_ex),
        shape=f"{b} x 1 tokens")
    return launches


def decode_f32_gate():
    """Decode against the forward in float32 at full width (random weights
    from a seeded CUDA generator): TinyLlama-1.1B at full depth (4.4 GB)
    and qwen2-moe-a2.7b cut to DECODE["f32_moe_layers"] layers (its 24 in
    float32 would be 57 GB; routing lossless, as decode's is).  Each
    prefills SERVE's prompt, decodes DECODE["f32_steps"] teacher-forced
    tokens through ``launch.steps`` (the float32 flash kernel with
    explicit positions) and holds every decode logit row within
    DECODE["f32_atol"] of the forward over the same tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (make_eval_step, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models.model import init_params
    b, s, n = SERVE["batch"], SERVE["seq"], DECODE["f32_steps"]
    out = {}
    for arch, layers in ((SERVE_ARCHS[0], None),
                         ("qwen2-moe-a2.7b", DECODE["f32_moe_layers"])):
        cfg = dataclasses.replace(get_config(arch), param_dtype="float32",
                                  compute_dtype="float32")
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        cfg = _lossless(cfg)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), device="cuda")
        tok = torch.as_tensor(np.random.RandomState(3).randint(
            0, cfg.vocab_size, (b, s + n)).astype(np.int32), device="cuda")
        t0 = time.perf_counter()
        with torch.no_grad():
            full = make_eval_step(cfg, device="cuda")(params,
                                                      {"tokens": tok})[:, s:]
            _, cache = make_prefill_step(cfg, device="cuda",
                                         max_ctx=s + DECODE["headroom"])(
                params, {"tokens": tok[:, :s]})
            serve_step = make_serve_step(cfg, device="cuda")
            err = 0.0
            for i in range(n):
                logits, cache = serve_step(params, tok[:, s + i:s + i + 1],
                                           cache, s + i)
                err = max(err, float((logits - full[:, i]).abs().max()))
        torch.cuda.synchronize()
        gb = sum(t.numel() for t in _leaves(params)) * 4 / 1e9
        del params, cache, full
        gc.collect()
        torch.cuda.empty_cache()
        if not err <= DECODE["f32_atol"]:
            raise AssertionError(f"float32 {arch} decode vs forward: max "
                                 f"abs err {err:.3e} > {DECODE['f32_atol']}")
        log(f"float32 gate: {arch} at full width, {cfg.num_layers} layers "
            f"({gb:.2f} GB), prefill {b} x {s} and {n} teacher-forced decode "
            f"steps match the forward within {err:.3e} (atol "
            f"{DECODE['f32_atol']}) in {time.perf_counter() - t0:.2f} s")
        out[arch] = err
    return out


def decode_cross(arch, device):
    """One reduced float32 model's decode on ``device``: a prefill step
    into a ring of the prompt's length, then DECODE_CROSS["steps"] steps
    past it (the ring wraps); for TinyLlama also a zero cache of a
    DECODE_CROSS["ring"]-slot ring decoded to position 2 × ring; for
    EXTRA_ARCHS with ``request_extras``' inputs (a 2 × 2 patch grid; the
    steps with musicgen's ``cond``).  Returns the logits and caches of
    every step, on the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import request_extras
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import init_cache, init_params
    cfg = get_config(arch).reduced(max_d_model=256, max_layers=4)
    b, s, n = DECODE_CROSS["batch"], DECODE_CROSS["prompt"], \
        DECODE_CROSS["steps"]
    params = init_params(cfg, torch.Generator().manual_seed(0), device=device)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    tok = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (b, s + 2 * DECODE_CROSS["ring"]) + cb).astype(
            np.int32))
    ex = {k: torch.as_tensor(v, device=device)
          for k, v in request_extras(cfg, b, s, grid=2).items()}
    step_ex = {k: v for k, v in ex.items() if k == "cond"}
    serve_step = make_serve_step(cfg, device=device)

    def snap(logits, cache):
        # copies: the rings are written in place by the next step
        return [t.to("cpu", copy=True) for t in
                [logits] + [t for c in cache for t in c.values()]]

    out = []
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg, device=device)(
            params, {"tokens": tok[:, :s], **ex})
        out.append(snap(logits, cache))
        for i in range(n):
            logits, cache = serve_step(params, tok[:, s + i:s + i + 1], cache,
                                       s + i, step_ex)
            out.append(snap(logits, cache))
        if arch == SERVE_ARCHS[0]:
            W = DECODE_CROSS["ring"]
            cache = init_cache(cfg, 1, ctx_len=64, sliding=W, device=device)
            for pos in range(2 * W):
                logits, cache = serve_step(params, tok[:1, pos:pos + 1],
                                           cache, pos)
                out.append(snap(logits, cache))
    return out


def decode_cross_check():
    """The six reduced served models' decode on the card against the CPU
    port, every step's logits and caches at rtol 1e-4 / atol 1e-5 (TF32
    off; musicgen's logits at ``logit_atol``)."""
    import torch
    from repro_torch.configs import get_config
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the cross-check needs "
                             "float32 products")
    for arch in SERVE_ARCHS + EXTRA_ARCHS:
        atol = logit_atol(get_config(arch).reduced(max_d_model=256,
                                                   max_layers=4))
        card, host = decode_cross(arch, "cuda"), decode_cross(arch, "cpu")
        for i, (g, w) in enumerate(zip(card, host)):
            for j, (a, b) in enumerate(zip(g, w)):
                # leaf 0 is the logits
                torch.testing.assert_close(
                    a, b, rtol=1e-4, atol=atol if j == 0 else 1e-5,
                    msg=lambda m: f"{arch} decode call {i} leaf {j}: {m}")
        log(f"cross-check: the reduced {arch} prefill step and "
            f"{len(card) - 1} decode steps on cuda match the cpu path "
            f"(logits and every cache leaf) at rtol=1e-4 / atol=1e-5 (the "
            f"logits' atol {atol:.3g})")


def cross_checks():
    from repro_torch.env.torchsim import (compile_trace, compile_trace_dual,
                                          make_static_decider,
                                          run_grid_arrays_learned,
                                          run_trace_arrays)
    with open(GOLDEN) as f:
        golden = json.load(f)["summary"]
    tr = compile_trace(make_static_decider("bestfit-rr"), lam=5.0, seed=0,
                       n_intervals=8, substeps=4)
    got = run_trace_arrays(tr, device="cuda")
    for k, v in golden.items():
        if not np.isclose(got[k], v, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL):
            raise AssertionError(f"golden {k}: fixture {v!r} vs cuda "
                                 f"{got[k]!r}")
    log("cross-check: the cuda driver reproduces "
        "golden_static_bestfit_rr.json at rtol=1e-6")
    traces = [compile_trace_dual(lam=5.0, seed=s, n_intervals=8, substeps=4)
              for s in range(3)]
    on_gpu = run_grid_arrays_learned(traces, MAB_LITERAL, device="cuda")
    on_cpu = run_grid_arrays_learned(traces, MAB_LITERAL, device="cpu")
    for g, c in zip(on_gpu, on_cpu):
        for k in c:
            if not np.isclose(g[k], c[k], rtol=1e-9, atol=1e-12):
                raise AssertionError(f"mab grid {k}: cuda {g[k]!r} vs cpu "
                                     f"{c[k]!r}")
    log("cross-check: a G=3 'mab' grid on cuda matches the cpu path at "
        "rtol=1e-9")
    daso_cross_check()
    train_cross_check()


def daso_cross_check():
    """splitplace and layer+gobi on a small grid at lr_place 20: the card
    matches the port's CPU path at rtol 1e-9, and the ascent moved rows
    off the warm start."""
    import torch
    from repro_torch.core.daso import DASOConfig, init_surrogate
    from repro_torch.launch.experiments import run_grid_batched
    cfg = DASOConfig(**DASO_SMALL)
    theta = init_surrogate(cfg, torch.Generator().manual_seed(DASO_SEED),
                           device="cpu")
    grid = dict(seeds=(0, 1, 2), lams=(5.0, 24.0), n_intervals=8,
                substeps=4, mab_state=MAB_LITERAL, daso_theta=theta,
                daso_cfg=cfg)
    for policy in ("splitplace", "layer+gobi"):
        with DasoTally() as tally:
            on_gpu = run_grid_batched(policy, device="cuda", **grid)
        moved = daso_report(tally, cfg, f"cross-check {policy}",
                            grid["n_intervals"])
        if moved <= 0:
            raise AssertionError(f"{policy}: the ascent moved no row off "
                                 "the warm start at lr_place 20")
        on_cpu = run_grid_batched(policy, device="cpu", **grid)
        for g, c in zip(on_gpu, on_cpu):
            for k in c:
                if k == "policy":
                    continue
                if not np.isclose(g[k], c[k], rtol=1e-9, atol=1e-12):
                    raise AssertionError(f"{policy} grid {k}: cuda {g[k]!r}"
                                         f" vs cpu {c[k]!r}")
        log(f"cross-check: a G={len(on_gpu)} {policy!r} grid at lr_place "
            f"{cfg.lr_place} on cuda matches the cpu path at rtol=1e-9")


class StageTally:
    """While active, keeps every interval's split decisions (the codes
    ``select_variant`` records, with the valid rows) and the DASO stage's
    final logits (``_write_rows``' operands), as device tensors."""

    def __enter__(self):
        from repro_torch.env.torchsim import kernels
        self._kernels = kernels
        self._select, self._write = kernels.select_variant, kernels._write_rows
        self.decisions, self.logits = [], []

        def select(shared, var, decision, arm_decisions=(0, 1)):
            arr = self._select(shared, var, decision, arm_decisions)
            self.decisions.append((arr["decision"].clone(),
                                   shared["valid"].clone()))
            return arr

        def write(req, slot_i, f_i, rowvalid, logits):
            self.logits.append((logits.clone(), rowvalid.clone()))
            return self._write(req, slot_i, f_i, rowvalid, logits)

        kernels.select_variant, kernels._write_rows = select, write
        return self

    def __exit__(self, *exc):
        self._kernels.select_variant = self._select
        self._kernels._write_rows = self._write


def _first_flips(card, host, label):
    """Per cell, the first interval whose DASO placements differ between
    the card and the CPU, and the largest relative logit margin of the
    rows that differ there (on the CPU's logits); raises unless it is a
    near-tie (< 1e-6)."""
    flips = {}
    for i, ((lc, vc), (lh, vh)) in enumerate(zip(card.logits, host.logits)):
        lc, vc = lc.cpu(), vc.cpu()
        if not np.array_equal(vc.numpy(), vh.numpy()):
            bad = [g for g in range(len(vc)) if not np.array_equal(
                vc[g].numpy(), vh[g].numpy())]
            if all(g in flips for g in bad):
                continue
            raise AssertionError(f"{label}: interval {i}: container rows "
                                 f"differ in cells {bad} before any flip")
        ac, ah = lc.argmax(-1), lh.argmax(-1)
        for g in range(lc.shape[0]):
            rows = ((ac[g] != ah[g]) & vh[g]).nonzero()[:, 0]
            if g in flips or not len(rows):
                continue
            l = lh[g, rows]
            pick_c = l.gather(1, ac[g, rows][:, None])[:, 0]
            pick_h = l.gather(1, ah[g, rows][:, None])[:, 0]
            margin = float(((pick_h - pick_c).abs()
                            / pick_h.abs().clamp(min=1e-300)).max())
            if not margin < 1e-6:
                raise AssertionError(f"{label}: cell {g} interval {i}: a "
                                     f"placement differs by {margin:.3e} "
                                     "relative")
            flips[g] = (i, margin)
    return flips


def train_cross_check(labels=None):
    """This slice's policies on a G=4 grid (``TRAIN_CROSS``) with the gates
    lowered (``TRAIN_HP_LOW``) and ``DASO_SMALL``'s lr_place 20, so that
    the finetuned θ is ascended and placements move, on the card and on
    the port's CPU path: per cell, equal decisions, summaries at rtol 1e-9,
    Q-tables at rtol 1e-9 and the finetuned θ at rtol 1e-5 (with a floor of
    1e-5 of each leaf's largest entry); a DASO placement that differs must
    be a near-tie (< 1e-6 relative), and its cell is then compared only up
    to there and reported."""
    import torch
    from repro_torch.core.daso import DASOConfig, init_surrogate
    from repro_torch.env.torchsim import (compile_trace_dual,
                                          run_grid_arrays_gillis,
                                          run_grid_arrays_static_daso,
                                          run_grid_arrays_trained)
    from repro_torch.env.workload import COMPRESSED, LAYER
    cfg = DASOConfig(**DASO_SMALL)
    theta = init_surrogate(cfg, torch.Generator().manual_seed(DASO_SEED),
                           device="cpu")
    cells = [(lam, seed) for lam in TRAIN_CROSS["lams"]
             for seed in TRAIN_CROSS["seeds"]]

    def traces(**kw):
        return [compile_trace_dual(
            lam=lam, seed=seed, n_intervals=TRAIN_CROSS["n_intervals"],
            substeps=TRAIN_CROSS["substeps"], **kw) for lam, seed in cells]

    dual, gdual = traces(), traces(variants=(LAYER, COMPRESSED))
    trained = dict(daso_theta=theta, train_hp=TRAIN_HP_LOW)
    runs = {
        "mab train": lambda dev: run_grid_arrays_trained(
            dual, MAB_LITERAL, device=dev),
        "splitplace train": lambda dev: run_grid_arrays_trained(
            dual, MAB_LITERAL, daso_cfg=cfg, device=dev, **trained),
        "mab+gobi train": lambda dev: run_grid_arrays_trained(
            dual, MAB_LITERAL, daso_cfg=cfg._replace(decision_aware=False),
            device=dev, **trained),
        "gillis": lambda dev: run_grid_arrays_gillis(gdual, device=dev),
        "random+daso": lambda dev: run_grid_arrays_static_daso(
            dual, "random+daso", daso_theta=theta, daso_cfg=cfg,
            device=dev),
    }
    for label, run in runs.items():
        if labels is not None and label not in labels:
            continue
        with DasoTally() as tally, StageTally() as card:
            on_gpu = run("cuda")
        with StageTally() as host:
            on_cpu = run("cpu")
        flips = _first_flips(card, host, label)
        rows = 0
        for i, ((dc, vc), (dh, vh)) in enumerate(zip(card.decisions,
                                                     host.decisions)):
            dc, vc = dc.cpu(), vc.cpu()
            for g in range(len(dc)):
                if g in flips and i > flips[g][0]:
                    continue
                if not torch.equal(vc[g], vh[g]) or not torch.equal(
                        dc[g][vh[g]], dh[g][vh[g]]):
                    raise AssertionError(f"{label}: cell {g} interval {i}: "
                                         "decisions differ")
                rows += int(vh[g].sum())
        worst_theta = 0.0
        for g, (gs, cs) in enumerate(zip(on_gpu, on_cpu)):
            if g in flips:
                continue
            for k, v in cs.items():
                if k == "daso_theta":
                    for lg, lc in zip(gs[k], v):
                        for x in ("w", "b"):
                            scale = float(np.abs(lc[x]).max())
                            err = float(np.abs(lg[x] - lc[x]).max())
                            worst_theta = max(worst_theta,
                                              err / max(scale, 1e-30))
                            if not np.allclose(lg[x], lc[x], rtol=1e-5,
                                               atol=1e-5 * scale):
                                raise AssertionError(
                                    f"{label} cell {g}: finetuned θ {x} "
                                    f"differs by {err:.3e}")
                elif not np.allclose(gs[k], v, rtol=1e-9, atol=1e-12):
                    raise AssertionError(f"{label} cell {g} {k}: cuda "
                                         f"{gs[k]!r} vs cpu {v!r}")
        moved = ""
        if tally.steps:
            n_moved = daso_report(tally, cfg, f"cross-check {label}",
                                  len(tally.steps))
            if n_moved <= 0:
                raise AssertionError(f"{label}: the ascent moved no row")
            moved = f", {n_moved} rows moved by the ascent"
        log(f"cross-check {label}: a G={len(cells)} grid (T="
            f"{TRAIN_CROSS['n_intervals']}) on cuda matches the cpu path: "
            f"{rows} decisions equal, summaries at rtol 1e-9"
            + (f", finetuned θ within {worst_theta:.3e} of each leaf's "
               "largest entry" if "daso_theta" in on_cpu[0] else "")
            + moved + "; placements that flip on a near-tie: "
            + (", ".join(f"cell {g} at interval {i} (margin {m:.3e})"
                         for g, (i, m) in flips.items()) or "none"))


class HostTally:
    """While active, tallies the host loop's learners: every batch of MAB
    decisions (``MABDecider.decide``, one host read per task) and every
    DASO ascent (``daso.optimize_placement``: its steps, each a host read,
    its container rows, the rows whose argmax left the warm start, and the
    ascended logits, copied to the CPU)."""

    def __enter__(self):
        from repro_torch.core import daso, splitplace
        self._daso, self._cls = daso, splitplace.MABDecider
        self._ascent, self._decide = daso.optimize_placement, \
            splitplace.MABDecider.decide
        self.decisions, self.ascents = [], []
        tally = self

        def ascent(cfg, theta, state, p0, dec, mask):
            p, score, steps = tally._ascent(cfg, theta, state, p0, dec, mask)
            valid = mask.bool()
            tally.ascents.append({
                "steps": int(steps), "rows": int(valid.sum()),
                "moved": int(((p.argmax(-1) != p0.argmax(-1))
                              & valid).sum()),
                "logits": p.detach().cpu(), "valid": valid.cpu()})
            return p, score, steps

        def decide(decider, tasks):
            out = tally._decide(decider, tasks)
            tally.decisions.append(list(out))
            return out

        daso.optimize_placement = ascent
        splitplace.MABDecider.decide = decide
        return self

    def __exit__(self, *exc):
        self._daso.optimize_placement = self._ascent
        self._cls.decide = self._decide

    def ascent_report(self, label, last=20):
        """Logs steps and rows moved over all ascents and the last
        ``last``; returns the steps."""
        a = self.ascents
        steps = sum(x["steps"] for x in a)
        tail = a[-last:]
        moved_tail = sum(x["moved"] for x in tail)
        rows_tail = sum(x["rows"] for x in tail)
        log(f"{label}: {len(a)} ascents, {steps} steps (mean "
            f"{steps / max(len(a), 1):.2f} per ascent), "
            f"{sum(x['moved'] for x in a)} of {sum(x['rows'] for x in a)} "
            f"container rows moved off BestFit's warm start; in the last "
            f"{len(tail)} ascents {moved_tail} of {rows_tail} "
            f"({moved_tail / max(rows_tail, 1):.4f})")
        return steps


def _finite_records(recs, label):
    """The Table-4 gates on grid records: no dropped task (the host loop
    reports none: it never drops), tasks completed, rewards in [0, 1],
    every metric finite."""
    for r in recs:
        where = f"{label} {r['policy']} seed {r['seed']}"
        if r.get("dropped_tasks", 0) != 0:
            raise AssertionError(f"{where}: dropped tasks")
        if not r["tasks_completed"] > 0:
            raise AssertionError(f"{where}: no task completed")
        if not 0.0 <= r["reward"] <= 1.0:
            raise AssertionError(f"{where}: reward {r['reward']}")
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{where}: not finite: {bad}")


def _leaves_finite(pre, label):
    import torch
    leaves = list(pre.mab_state) + [v for layer in pre.daso_theta
                                    for v in layer.values()]
    if not all(bool(torch.isfinite(v.float()).all()) for v in leaves):
        raise AssertionError(f"{label}: a pretrained leaf is not finite")


def table4_pretrain():
    """``pretrain(200)`` on the card at Table 4's protocol: its wall and
    phase split, ascent steps and host reads, θ's drift from θ0 and the
    rows the trained θ's ascent moves in its last intervals."""
    import torch
    from repro_torch.core.splitplace import SurrogatePlacer
    from repro_torch.env.torchsim.driver import PHASES
    from repro_torch.launch.experiments import pretrain
    kw = TABLE4_PRETRAIN
    T = kw["n_intervals"]
    # the seeded θ0 pretrain's placer starts from
    theta0 = SurrogatePlacer(50, True, seed=kw["seed"], device="cuda").theta
    phase_s = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with HostTally() as tally:
        pre = pretrain(**kw, policies=TABLE4_POLICIES, device="cuda",
                       phase_s=phase_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _leaves_finite(pre, "pretrain")
    if int(pre.mab_state.t[0]) != T + 1 or pre.gillis_policy is None:
        raise AssertionError(f"pretrain: t={int(pre.mab_state.t[0])}, "
                             f"gillis {pre.gillis_policy}")
    trace = sum(phase_s[p] for p in PHASES)
    n_dec = sum(len(d) for d in tally.decisions)
    log(f"table4 pretrain({T}, lam={kw['lam']}, seed={kw['seed']}, "
        f"substeps={kw['substeps']}) on cuda: wall {wall:.3f} s; the "
        f"splitplace trace {trace:.3f} s: MAB decisions (decide) "
        f"{phase_s['decide']:.3f} s, place {phase_s['place']:.3f} s (the "
        f"ascent {phase_s.get('ascent', 0.0):.3f} s of it, the rest BestFit"
        f" and the surrogate input), host simulator (placement repair and "
        f"advance) {phase_s['physics']:.3f} s, feedback "
        f"{phase_s['feedback']:.3f} s (the finetune epochs "
        f"{phase_s.get('daso_train', 0.0):.3f} s, the MAB's host reads "
        f"{phase_s['mab_host_read']:.4f} s); the Gillis trace and set-up "
        f"{wall - trace:.3f} s")
    steps = tally.ascent_report("table4 pretrain")
    log(f"table4 pretrain host reads: {n_dec} MAB decisions (one each), "
        f"{steps} ascent steps (one each), {T} assignment reads, and the "
        f"MAB feedback's (two per interval with finished tasks)")
    if not steps or not n_dec:
        raise AssertionError("pretrain: no ascent or no MAB decision ran")
    for i, (l, l0) in enumerate(zip(pre.daso_theta, theta0)):
        for k in ("w", "b"):
            d = float((l[k] - l0[k]).norm())
            n0 = float(l0[k].norm())
            log(f"  θ[{i}].{k} {tuple(l[k].shape)}: ||θ - θ0|| {d:.6f}"
                + (f" ({d / n0:.6f} of ||θ0||)" if n0 else " (θ0 = 0)")
                + f", largest |θ - θ0| {float((l[k] - l0[k]).abs().max()):.6f}")
    return pre


def table4_grid(pre):
    """Table 4 on the interval program: ``run_grid(backend="torch")`` over
    the 7 policies × 2 seeds with the pretraining products, the counts of
    every kernel set to 0 just before and read just after (and per
    policy), then ``aggregate`` beside the paper's values.  Returns the
    launches per kernel."""
    import torch
    from repro_torch.core.daso import DASOConfig
    from repro_torch.launch import experiments
    T = TABLE4["n_intervals"]
    per_policy = {}
    batched = experiments.run_grid_batched

    def counted(policy, **kw):
        torch.cuda.synchronize()
        before = {n: fn.launches for n, fn in _counters().items()}
        t0 = time.perf_counter()
        recs = batched(policy, **kw)
        torch.cuda.synchronize()
        per_policy[policy] = (time.perf_counter() - t0, {
            n: fn.launches - before[n] for n, fn in _counters().items()})
        return recs

    gc.collect()
    torch.cuda.synchronize()
    for fn in _counters().values():
        fn.launches = 0
    experiments.run_grid_batched = counted
    t0 = time.perf_counter()
    try:
        with DasoTally() as tally:
            recs = experiments.run_grid(
                list(TABLE4_POLICIES), **TABLE4, backend="torch",
                device="cuda", mab_state=pre.mab_state,
                daso_theta=pre.daso_theta, daso_cfg=pre.daso_cfg,
                daso_opt_state=pre.daso_opt_state)
        torch.cuda.synchronize()
    finally:
        experiments.run_grid_batched = batched
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in _counters().items()}
    for pol in TABLE4_POLICIES:
        got = per_policy[pol][1]
        for name in SIM_KERNELS + DRAW_KERNELS:
            want = T if name in SIM_KERNELS or pol in TABLE4_DRAWS else 0
            if got[name] != want:
                raise AssertionError(f"table4 {pol}: {name} launched "
                                     f"{got[name]} times, expected {want}")
    for name in SIM_KERNELS + DRAW_KERNELS:
        if launches[name] != sum(c[name] for _, c in per_policy.values()):
            raise AssertionError(f"table4: {name} counts do not add up")
    _finite_records(recs, "table4")
    cfg = DASOConfig(**DASO_MAIN)
    steps, rows, moved = tally.read()
    daso_pols = [p for p in TABLE4_POLICIES
                 if p not in ("mc", "gillis")]
    for i, pol in enumerate(daso_pols):
        sl = slice(i * T, (i + 1) * T)
        log(f"table4 {pol}: DASO ascent steps mean "
            f"{steps[sl].mean():.2f} of {cfg.place_iters}; "
            f"{int(moved[sl].sum())} of {int(rows[sl].sum())} container "
            f"rows moved off the warm start by the trained θ")
    rows_t = experiments.aggregate(recs, by=("policy",))
    log(f"table4 run_grid(backend='torch'): {len(TABLE4_POLICIES)} "
        f"policies × seeds {TABLE4['seeds']} × T={T} at substeps "
        f"{TABLE4['substeps']}, lam {TABLE4['lams'][0]}: wall {wall:.3f} s; "
        f"launches {launches}")
    for pol in TABLE4_POLICIES:
        m, p = rows_t[pol], TABLE4_PAPER[pol]
        log(f"  {pol:14s} reward {m['reward']:.4f} (paper {p['reward']:.4f})"
            f" viol {m['sla_violations']:.3f} ({p['viol']:.2f}) acc "
            f"{m['accuracy']:.4f} ({p['acc']:.4f}) resp "
            f"{m['response_intervals']:.3f} ({p['resp']:.2f}) energy "
            f"{m['energy_mwhr']:.6f} MWh fair {m['fairness']:.3f} "
            f"reward_std {m['reward_std']:.4f}; wall "
            f"{per_policy[pol][0]:.3f} s")
    return launches


def table4_host(pre):
    """The host backend on the card: the 7 policies at seed 0, T=40, with
    the same pretraining products (the Gillis object continued); the
    interval program's kernels are launched no time."""
    import torch
    from repro_torch.launch import experiments
    walls = {}
    run_trace = experiments.run_trace

    def timed(name, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_trace(name, **kw)
        torch.cuda.synchronize()
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return out

    for fn in _counters().values():
        fn.launches = 0
    experiments.run_trace = timed
    try:
        with HostTally() as tally:
            recs = experiments.run_grid(
                list(TABLE4_POLICIES), **TABLE4_HOST, backend="soa",
                device="cuda", mab_state=pre.mab_state,
                gillis_policy=pre.gillis_policy)
    finally:
        experiments.run_trace = run_trace
    launched = {n: fn.launches for n, fn in _counters().items()
                if fn.launches}
    if launched:
        raise AssertionError(f"table4 host loop launched kernels {launched}")
    _finite_records(recs, "table4 host")
    tally.ascent_report("table4 host loop")
    log(f"table4 host backend (run_grid backend='soa', seeds "
        f"{TABLE4_HOST['seeds']}, T={TABLE4_HOST['n_intervals']}, substeps "
        f"{TABLE4_HOST['substeps']}) on cuda: "
        + ", ".join(f"{r['policy']} reward {r['reward']:.4f} viol "
                    f"{r['sla_violations']:.3f} wall {walls[r['policy']]:.3f}"
                    " s" for r in recs)
        + f"; {sum(len(d) for d in tally.decisions)} MAB decisions")


def _ascent_flip(card, host):
    """The first ascent whose assignments differ between two pretraining
    runs: (index, rows, largest relative margin of the CPU's logits), or
    None."""
    for i, (ac, ah) in enumerate(zip(card.ascents, host.ascents)):
        if not np.array_equal(ac["valid"].numpy(), ah["valid"].numpy()):
            return i, "container rows differ", float("inf")
        pc, ph = ac["logits"].argmax(-1), ah["logits"].argmax(-1)
        rows = ((pc != ph) & ah["valid"]).nonzero()[:, 0]
        if len(rows):
            lh = ah["logits"][rows]
            a = lh.gather(1, pc[rows][:, None])[:, 0]
            b = lh.gather(1, ph[rows][:, None])[:, 0]
            return i, rows.tolist(), float(((b - a).abs()
                                            / b.abs().clamp(min=1e-30))
                                           .max())
    return None


def table4_cross():
    """The card against the CPU at a reduced size: ``pretrain(36)`` from one
    θ0 on each device — N, t, ε, ρ equal, Q and R and θ within the stated
    tolerances of each leaf's largest entry, any differing decision or
    assignment reported with its margin — then the card's products fed to
    ``run_grid(backend="torch")`` on both devices, summaries at rtol
    1e-9 (a DASO placement that flips must be a near-tie; its cell is
    then left out and reported)."""
    from repro_torch.core.daso import PLACE_MIN
    from repro_torch.core.splitplace import SurrogatePlacer
    from repro_torch.launch.experiments import pretrain, run_grid
    kw = TABLE4_CROSS_PRETRAIN
    theta0 = [{k: v.numpy() for k, v in layer.items()} for layer in
              SurrogatePlacer(50, True, seed=kw["seed"], device="cpu").theta]
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with HostTally() as tally:
            pre = pretrain(**kw, device=dev, daso_theta0=theta0)
        runs[dev] = (pre, tally, time.perf_counter() - t0)
    (pc, tc, wc), (ph, th, wh) = runs["cuda"], runs["cpu"]
    dec = next((i for i, (a, b) in enumerate(zip(tc.decisions,
                                                  th.decisions)) if a != b),
               None)
    flip = _ascent_flip(tc, th)
    # ascent j places interval PLACE_MIN + j (the replay's 32nd record)
    if dec is not None and (flip is None or dec <= PLACE_MIN + flip[0]):
        raise AssertionError(f"table4 cross-check: MAB decisions differ at "
                             f"interval {dec} before any placement did")
    if flip is not None:
        if not flip[2] < 1e-4:
            raise AssertionError(f"table4 cross-check: ascent {flip[0]} "
                                 f"places rows {flip[1]} differently "
                                 f"(relative margin {flip[2]:.3e})")
        log(f"table4 cross-check pretrain: ascent {flip[0]} places rows "
            f"{flip[1]} differently on a near-tie (relative margin "
            f"{flip[2]:.3e}); the trajectories part there, so the states "
            "are reported, not held")
    worst = {}
    for f in ("N", "t", "eps", "rho", "Q", "R"):
        a = getattr(pc.mab_state, f).cpu().numpy()
        b = getattr(ph.mab_state, f).cpu().numpy()
        worst[f] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if flip is None and (worst[f] > TABLE4_MAB_TOL or (
                f in ("N", "t", "eps", "rho") and not np.array_equal(a, b))):
            raise AssertionError(f"table4 cross-check: MAB {f} cuda {a} "
                                 f"cpu {b}")
    for name, lc_, lh_ in (("θ", pc.daso_theta, ph.daso_theta),
                           ("m", pc.daso_opt_state.m, ph.daso_opt_state.m),
                           ("v", pc.daso_opt_state.v, ph.daso_opt_state.v)):
        for lc, lh in zip(lc_, lh_):
            for k in ("w", "b"):
                b = lh[k].numpy()
                err = float(np.abs(lc[k].cpu().numpy() - b).max()
                            / max(np.abs(b).max(), 1e-30))
                worst[name] = max(worst.get(name, 0.0), err)
    if flip is None and max(worst[n] for n in ("θ", "m", "v")) > \
            TABLE4_THETA_TOL:
        raise AssertionError(f"table4 cross-check: θ or moments differ "
                             f"{worst}")
    log(f"table4 cross-check pretrain({kw['n_intervals']}, substeps "
        f"{kw['substeps']}) from one θ0: cuda {wc:.3f} s, cpu {wh:.3f} s; "
        f"{sum(len(d) for d in tc.decisions)} MAB decisions "
        + ("equal" if dec is None else f"differ from interval {dec}")
        + f", {len(tc.ascents)} ascents ("
        + ("assignments equal" if flip is None else "a near-tie flip")
        + "); largest difference relative to each leaf's largest entry: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (tolerances: Q, R {TABLE4_MAB_TOL}, θ and moments "
        f"{TABLE4_THETA_TOL}; N, t, ε, ρ exact)")
    products = dict(mab_state=pc.mab_state, daso_theta=pc.daso_theta,
                    daso_cfg=pc.daso_cfg, daso_opt_state=pc.daso_opt_state)
    for pol in TABLE4_POLICIES:
        with StageTally() as card:
            on_gpu = run_grid([pol], **TABLE4_CROSS, backend="torch",
                              device="cuda", **products)
        with StageTally() as host:
            on_cpu = run_grid([pol], **TABLE4_CROSS, backend="torch",
                              device="cpu", **products)
        flips = _first_flips(card, host, f"table4 cross-check {pol}")
        for g, (a, b) in enumerate(zip(on_gpu, on_cpu)):
            if g in flips:
                continue
            for k, v in b.items():
                if isinstance(v, float) and not np.isclose(
                        a[k], v, rtol=TABLE4_RTOL, atol=1e-12):
                    raise AssertionError(f"table4 cross-check {pol} cell "
                                         f"{g} {k}: cuda {a[k]!r} cpu "
                                         f"{v!r}")
        log(f"table4 cross-check {pol}: run_grid(backend='torch') G="
            f"{len(on_cpu)} T={TABLE4_CROSS['n_intervals']} with the card's "
            f"pretraining products: cuda matches cpu at rtol {TABLE4_RTOL}"
            + ("; near-tie flips: " + ", ".join(
                f"cell {g} at interval {i} (margin {m:.3e})"
                for g, (i, m) in flips.items()) if flips else ""))


def table4_phase():
    """The paper's experiment protocol on the card; returns the Table-4
    grid's launches per kernel."""
    import torch
    from repro_torch.core.daso import DASOConfig
    pre = table4_pretrain()
    launches = table4_grid(pre)
    cfg = DASOConfig(**DASO_MAIN)
    with DasoTally() as tally:
        main_path("splitplace", label="splitplace trained θ",
                  mab_state=pre.mab_state, daso_theta=pre.daso_theta,
                  daso_cfg=pre.daso_cfg)
    daso_report(tally, cfg, "main path splitplace trained θ",
                MAIN["n_intervals"])
    table4_host(pre)
    gc.collect()
    torch.cuda.empty_cache()
    table4_cross()
    return launches


# ------------------------------------------------- interval telemetry


#: the telemetry phase: every simulator main path run with
#: telemetry="interval" beside its summary run, TELEMETRY_CALLS
#: interleaved calls of each; the overhead is printed beside the
#: reference's own ceiling (benchmarks/jaxsim_grid.py
#: MAX_TELEMETRY_OVERHEAD), not gated.  The paths with a DASO stage run
#: one call: the stage's ascent is ~95 % of their ~10 s wall and their
#: run-to-run spread (±10 %) is ~20 times the row's cost, so repeats
#: cannot resolve the overhead there, and three calls of them (~200 s)
#: took the script to 1162 s of its 1200 on an H100 80GB HBM3 machine
#: (700 W) whose host-bound phases ran 1.3-1.5x slower than another's.
#: The other paths ran two calls each until the count and dry-run phases
#: took the whole script to 1151 s of its 1200 on such a host; one each
#: since (three took the telemetry phase to 115-327 s of a 651-1162 s
#: script)
#: the telemetry phase's grid: the main grid cut to 50 intervals, to keep
#: the whole script under its time limit
TELEMETRY_GRID = dict(MAIN, n_intervals=50)
TELEMETRY_CALLS = 1
TELEMETRY_DASO_CALLS = 1
TELEMETRY_CEILING = 0.05
#: the train path's finetune is chaotic past ~50 intervals at the main
#: widths (θ0 perturbed by 1e-7 moves θ by 0.27 of a leaf's largest entry
#: at T=100 on one device): on the main grid θ and the window loss are
#: reported, not held, and held at the full rule on a cut run of cell 0
TELEMETRY_CHAOTIC = ("daso_theta", "telemetry/daso_last_loss")
TELEMETRY_TRAIN_CUT = 10


class SeriesTap:
    """While active, keeps the full per-cell summaries (the telemetry
    series among them) that ``run_grid_batched``'s interval program
    returns, before its records keep only the scalars."""

    def __enter__(self):
        from repro_torch.launch import experiments
        self._mod, self._fn, self.outs = experiments, \
            experiments._run_torch, []

        def tapped(*a, **k):
            out = self._fn(*a, **k)
            self.outs.extend(out)
            return out

        experiments._run_torch = tapped
        return self

    def __exit__(self, *exc):
        self._mod._run_torch = self._fn


def telemetry_paths(mab_state):
    """The simulator main paths the script drives, as (label, policy,
    run_grid_batched keywords, draws once per interval, the engine's
    telemetry columns); the DASO stages at ``SurrogatePlacer``'s widths
    with θ from a seeded CUDA generator."""
    import torch
    from repro_torch.core.daso import DASOConfig, init_surrogate
    from repro_torch.env.torchsim.engines import (
        GILLIS_TELEMETRY_COLS, MAB_TELEMETRY_COLS, TRAIN_DASO_TELEMETRY_COLS)
    cfg = DASOConfig(**DASO_MAIN)
    gen = torch.Generator(device="cuda").manual_seed(DASO_SEED)
    daso = dict(daso_theta=init_surrogate(cfg, gen, device="cuda"),
                daso_cfg=cfg)
    mab = dict(mab_state=mab_state)
    return [("bestfit-rr", "bestfit-rr", {}, False, ()),
            ("mab", "mab", mab, False, MAB_TELEMETRY_COLS),
            ("splitplace", "splitplace", dict(**mab, **daso), False,
             MAB_TELEMETRY_COLS),
            ("splitplace train", "splitplace",
             dict(mode="train", **mab, **daso), True,
             TRAIN_DASO_TELEMETRY_COLS),
            ("mab train", "mab", dict(mode="train", **mab), True,
             MAB_TELEMETRY_COLS),
            ("gillis", "gillis", {}, True, GILLIS_TELEMETRY_COLS),
            ("random+daso", "random+daso", daso, True, ())]


def telemetry_train_cut(kw, errs):
    """``splitplace train``'s cell 0 cut to ``TELEMETRY_TRAIN_CUT``
    intervals (three finetune intervals, 12 AdamW epochs), on the card
    against the host oracle at the full rule, θ and the window loss
    included."""
    from repro_torch.env import torchsim
    tr = torchsim.compile_trace_dual(
        lam=MAIN["lams"][0], seed=MAIN["seeds"][0],
        n_intervals=TELEMETRY_TRAIN_CUT, substeps=MAIN["substeps"])
    args = dict(daso_theta=kw["daso_theta"], daso_cfg=kw["daso_cfg"],
                telemetry="interval")
    got = torchsim.run_trace_arrays_trained(tr, kw["mab_state"],
                                            device="cuda", **args)
    ref = torchsim.replay_trace_edgesim_trained(tr, kw["mab_state"], **args)
    cut = {}
    worst = diff_compare(ref, got, "telemetry splitplace train cut", cut)
    for k in TELEMETRY_CHAOTIC:
        errs[f"{k} (T={TELEMETRY_TRAIN_CUT})"] = cut[k]
    log(f"telemetry splitplace train, cell 0 cut to T="
        f"{TELEMETRY_TRAIN_CUT}: the card matches the host oracle at the "
        f"full rule, θ and the window loss included (largest relative "
        f"difference {worst:.3e}, θ {cut['daso_theta']:.3e})")


def telemetry_oracle(label, kw):
    """The port's host oracle of cell 0 of TELEMETRY_GRID (λ=6, seed 0)
    for the path ``label``, with ``telemetry="interval"``."""
    from repro_torch.env import torchsim
    from repro_torch.env.workload import COMPRESSED, LAYER
    lam, seed = TELEMETRY_GRID["lams"][0], TELEMETRY_GRID["seeds"][0]
    shape = dict(lam=lam, seed=seed,
                 n_intervals=TELEMETRY_GRID["n_intervals"],
                 substeps=TELEMETRY_GRID["substeps"])
    tel = dict(telemetry="interval")
    if label == "bestfit-rr":
        tr = torchsim.compile_trace(
            torchsim.make_static_decider("bestfit-rr"), **shape)
        return torchsim.replay_trace_edgesim(tr, **tel)
    if label == "gillis":
        tr = torchsim.compile_trace_dual(variants=(LAYER, COMPRESSED),
                                         **shape)
        return torchsim.replay_trace_edgesim_gillis(tr, **tel)
    tr = torchsim.compile_trace_dual(**shape)
    if label == "random+daso":
        return torchsim.replay_trace_edgesim_static_daso(
            tr, "random+daso", daso_theta=kw["daso_theta"],
            daso_cfg=kw["daso_cfg"], **tel)
    daso = {k: kw[k] for k in ("daso_theta", "daso_cfg") if k in kw}
    if kw.get("mode") == "train":
        return torchsim.replay_trace_edgesim_trained(
            tr, kw["mab_state"], **daso, **tel)
    return torchsim.replay_trace_edgesim_learned(tr, kw["mab_state"],
                                                 **daso, **tel)


def _spread(xs):
    return (f"median {np.median(xs):.3f} s (min {min(xs):.3f}, max "
            f"{max(xs):.3f})")


def telemetry_phase(mab_state):
    """Every simulator main path with ``telemetry="interval"`` on
    TELEMETRY_GRID (the main grid cut to T=50; G=16, 30 substeps,
    K=default_capacity): per path, the
    summary keys equal the summary run's, the series is (G, T, 18 +
    engine columns) and finite with ``n_fin`` summing to
    ``tasks_completed`` and ``energy_j`` to the energy total (rtol 1e-12),
    no host read is added, and cell 0's summary and series match the
    port's host oracle at ``test_differential.py``'s rule; the walls of
    ``TELEMETRY_CALLS`` interleaved calls in each mode are printed
    (``TELEMETRY_DASO_CALLS`` on the paths with a DASO stage).
    Returns the interval runs' launches per kernel, summed."""
    from repro_torch.core.mab import host_reads
    from repro_torch.env.metrics import TELEMETRY_COLS
    totals, errs = {}, {}
    tg = TELEMETRY_GRID
    G, T = len(tg["seeds"]) * len(tg["lams"]), tg["n_intervals"]
    for label, policy, kw, draws, ecols in telemetry_paths(mab_state):
        walls = {"summary": [], "interval": []}
        first = {}
        calls = TELEMETRY_DASO_CALLS if "daso_theta" in kw \
            else TELEMETRY_CALLS
        for call in range(calls):
            for mode in ("summary", "interval"):
                r0 = host_reads()
                with SeriesTap() as tap:
                    recs, wall, launches, _ = main_path(
                        policy, label=f"{label} [{mode} {call + 1}]",
                        draws=draws, grid=tg, telemetry=mode, **kw)
                walls[mode].append(wall)
                if call == 0:
                    first[mode] = (recs, tap.outs, launches,
                                   host_reads() - r0)
        (srecs, _, _, sreads), (irecs, iouts, ilaunch, ireads) = \
            first["summary"], first["interval"]
        for name, count in ilaunch.items():
            totals[name] = totals.get(name, 0) + count
        if ireads != sreads:
            raise AssertionError(f"telemetry {label}: {ireads} host reads "
                                 f"against {sreads} in the summary run")
        bitwise = True
        for g, (s, i) in enumerate(zip(srecs, irecs)):
            for k, v in s.items():
                if i[k] != v and not (isinstance(v, float) and np.isclose(
                        i[k], v, rtol=1e-12, atol=1e-12)):
                    raise AssertionError(f"telemetry {label} cell {g} {k}: "
                                         f"summary {v!r} interval {i[k]!r}")
                bitwise &= i[k] == v
        series = np.stack([o["telemetry"]["series"] for o in iouts])
        cols = iouts[0]["telemetry"]["cols"]
        if cols != list(TELEMETRY_COLS) + list(ecols) or \
                series.shape != (G, T, len(TELEMETRY_COLS) + len(ecols)):
            raise AssertionError(f"telemetry {label}: series {series.shape} "
                                 f"cols {cols}")
        if not np.isfinite(series).all():
            raise AssertionError(f"telemetry {label}: a non-finite entry")
        for g, o in enumerate(iouts):
            sr = o["telemetry"]["series"]
            nfin = sr[:, cols.index("n_fin")].sum()
            energy = sr[:, cols.index("energy_j")].sum() / 3.6e9
            if nfin != o["tasks_completed"] or not np.isclose(
                    energy, o["energy_mwhr"], rtol=1e-12, atol=0.0):
                raise AssertionError(
                    f"telemetry {label} cell {g}: n_fin sums to {nfin} "
                    f"({o['tasks_completed']} completed), energy_j to "
                    f"{energy!r} MWh ({o['energy_mwhr']!r})")
        t0 = time.perf_counter()
        ref = telemetry_oracle(label, kw)
        oracle_s = time.perf_counter() - t0
        # the finetune is chaotic past ~50 intervals at these widths: θ
        # and its window loss are held on a cut run (telemetry_train_cut)
        skip = TELEMETRY_CHAOTIC if "daso_theta" in ref else ()
        worst = diff_compare(ref, iouts[0], f"telemetry {label} cell 0",
                             errs, skip=skip)
        if skip:
            telemetry_train_cut(kw, errs)
        med = {m: float(np.median(w)) for m, w in walls.items()}
        log(f"telemetry {label}: series {series.shape} (engine columns "
            f"{', '.join(ecols) or 'none'}), summaries equal the summary "
            f"run's ({'bitwise' if bitwise else 'within rtol 1e-12'}), "
            f"{ireads} host reads in either mode; cell 0 matches the host "
            f"oracle (largest relative difference {worst:.3e}, the oracle "
            f"{oracle_s:.1f} s on the host); wall summary "
            f"{_spread(walls['summary'])}, interval "
            f"{_spread(walls['interval'])}: overhead "
            f"{med['interval'] / med['summary'] - 1.0:+.2%} of the median "
            f"(the reference's ceiling {TELEMETRY_CEILING:.0%}, reported, "
            f"not gated)")
    log("telemetry: largest relative difference from the host oracle per "
        "key: " + ", ".join(f"{k} {v:.3e}" for k, v in sorted(errs.items())))
    return totals


# --------------------------------------------------- differential fuzz
#
# tests/test_differential.py's contract on the port: seeded cases from a
# quantized space (fleet, λ, capacity scales, workload seed, MAB state and
# hyperparameters, DASO surrogate), each run through the interval program
# on a device and the host oracle; summaries at rtol 1e-4 / atol 1e-9,
# percentiles within their binning bound.  tests/test_torch_differential.py
# runs it on the CPU, the differential phase on the card.

DIFF_RTOL, DIFF_ATOL = 1e-4, 1e-9
#: slot capacity big enough that no quantized case drops an arrival
DIFF_MAX_ACTIVE = 160
DIFF_N_INTERVALS = (4, 6)
DIFF_SUBSTEPS = (3, 4)
DIFF_CLUSTERS = ("table3", "ram_squeeze", "slow_small")
DIFF_MAB_HPS = ((0.5, 0.3, 0.3, 0.1),      # host MABDecider defaults
                (1.0, 0.3, 0.3, 0.1),      # exploratory UCB
                (0.05, 0.9, 0.5, 0.2),     # paper-φ, aggressive RBED
                (0.5, 0.3, 0.3, 0.0))      # k=0: RBED never decays ε
#: (alpha, beta, train_steps, place_min, train_min): the lowered gates
#: make the short horizons ascend the finetuned surrogate and train
DIFF_TRAIN_HPS = ((0.5, 0.5, 4, 32, 8), (0.5, 0.5, 2, 2, 1),
                  (0.3, 0.7, 4, 4, 2))
DIFF_DASO_CFGS = ("small", "wide")
#: (eps0, lr, decay) of the Gillis arm: defaults, explore-heavy, pure
#: greedy forever, pure coin with lr=1
DIFF_GILLIS_HPS = ((0.5, 0.3, 0.995), (1.0, 0.5, 0.9), (0.0, 0.3, 1.0),
                   (1.0, 1.0, 1.0))
DIFF_MODES = ("static", "deploy", "train", "gillis", "gobi")
DIFF_PCT_KEYS = tuple(f"p{q}_{m}_s" for q in (50, 95, 99)
                      for m in ("response", "wait"))
#: the shrunk regression cases of tests/test_differential.py
DIFF_REGRESSIONS = ("ram_pressure_repair_static",
                    "ram_pressure_repair_train", "eps_boundary_decisions",
                    "gillis_eps_boundaries", "gillis_ram_pressure",
                    "capacity_drop_counting")
#: the differential phase on the card: this many seeded cases
DIFF_CHIP_CASES = 30


def diff_cluster(name):
    from repro_torch.env.cluster import make_cluster
    if name == "table3":
        return make_cluster()
    if name == "ram_squeeze":
        return make_cluster(ram_scale=0.45)
    return make_cluster(fleet=[("B2ms", 8), ("E2asv4", 4), ("B4ms", 4)],
                        compute_scale=0.7)


def diff_daso(name, n_workers, rng):
    """(θ on the CPU, cfg) of a small or wide surrogate, θ from a CPU
    generator seeded by one draw of ``rng``."""
    import torch
    from repro_torch.core import daso
    hidden, C = (16, 8) if name == "small" else (32, 16)
    cfg = daso.DASOConfig(num_workers=n_workers, max_containers=C,
                          state_features=4, hidden=hidden, depth=2,
                          place_iters=8)
    gen = torch.Generator().manual_seed(int(rng.randint(2**31)))
    return daso.init_surrogate(cfg, gen, device="cpu"), cfg


def diff_mab_state(rng):
    """A random-but-plausible MAB state (the reference's fields as NumPy):
    both contexts and arms reachable."""
    return {"R": rng.uniform(300.0, 4000.0, 3).astype(np.float32),
            "Q": rng.uniform(0.0, 1.0, (2, 2)).astype(np.float32),
            "N": rng.uniform(1.0, 40.0, (2, 2)).astype(np.float32),
            "eps": np.float32(rng.uniform(0.0, 1.0)),
            "rho": np.float32(rng.uniform(0.02, 0.2)),
            "t": int(rng.randint(1, 80))}


def diff_gillis_state(rng):
    return {"Q": rng.uniform(0.0, 1.0, (3, 2, 2)).astype(np.float64),
            "eps": np.float64(rng.uniform(0.0, 1.0))}


def diff_draw_case(case_seed: int) -> dict:
    """One configuration, fully determined by ``case_seed`` (the draws of
    ``tests/test_differential.py``'s ``draw_case``)."""
    rng = np.random.RandomState(case_seed)
    mode = DIFF_MODES[rng.randint(5)]
    case = {
        "mode": mode,
        "lam": float(np.round(rng.uniform(2.0, 9.0), 2)),
        "seed": int(rng.randint(10_000)),
        "n_intervals": int(DIFF_N_INTERVALS[rng.randint(2)]),
        "substeps": int(DIFF_SUBSTEPS[rng.randint(2)]),
        "cluster": DIFF_CLUSTERS[rng.randint(3)],
        "mab_hp": DIFF_MAB_HPS[rng.randint(4)],
        "mab_rng": int(rng.randint(2**31)),
        # the gobi ablation is a surrogate config: its draw is never None
        "daso": (((None,) if mode != "gobi" else ()) + DIFF_DASO_CFGS)[
            rng.randint((1 if mode != "gobi" else 0) + 2)],
    }
    if mode == "train":
        case["train_hp"] = DIFF_TRAIN_HPS[rng.randint(3)]
    if mode == "static":
        case["policy"] = ("mc", "bestfit-rr", "bestfit-layer",
                          "bestfit-semantic",
                          "bestfit-threshold")[rng.randint(5)]
    if mode == "gillis":
        case["gillis_hp"] = DIFF_GILLIS_HPS[rng.randint(4)]
    case["telemetry"] = ("summary", "interval")[rng.randint(2)]
    return case


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-300),
                        initial=0.0))


def diff_compare(ref, got, ctx, errs=None, skip=()):
    """``tests/test_differential.py``'s ``assert_close``: equal key sets,
    every key at rtol 1e-4 / atol 1e-9 (θ and the Q-table leaf by leaf,
    the series column by column), the percentiles within the larger
    binning bound; raises on a mismatch.  Records the largest relative
    difference per key into ``errs`` and returns the largest of all.
    Keys and series columns (``"telemetry/<col>"``) named in ``skip`` are
    not held; their largest difference (relative to the leaf's largest
    entry for θ) goes into ``errs`` under ``"<name> (not held)"``."""
    if set(ref) != set(got):
        raise AssertionError(f"{ctx}: key sets differ: "
                             f"{sorted(set(ref) ^ set(got))}")
    errs = {} if errs is None else errs
    worst = 0.0

    def note(k, e):
        nonlocal worst
        if k in skip:
            k = f"{k} (not held)"
        else:
            worst = max(worst, e)
        errs[k] = max(errs.get(k, 0.0), e)

    for k in ref:
        if k in ("daso_theta", "gillis_q"):
            for a, b in zip(_leaves(ref[k]), _leaves(got[k])):
                a, b = np.asarray(a), np.asarray(b)
                if k in skip:
                    note(k, float(np.max(np.abs(np.asarray(a, np.float64)
                                                - b), initial=0.0)
                                  / max(np.abs(a).max(), 1e-300)))
                    continue
                if not np.allclose(b, a, rtol=DIFF_RTOL, atol=DIFF_ATOL):
                    raise AssertionError(f"{ctx}: {k} differs")
                note(k, _rel(a, b))
        elif k == "telemetry":
            if ref[k]["cols"] != got[k]["cols"]:
                raise AssertionError(f"{ctx}: telemetry cols "
                                     f"{ref[k]['cols']} vs {got[k]['cols']}")
            rs, gs = ref[k]["series"], got[k]["series"]
            if np.shape(rs) != np.shape(gs):
                raise AssertionError(f"{ctx}: series {np.shape(rs)} vs "
                                     f"{np.shape(gs)}")
            for i, col in enumerate(ref[k]["cols"]):
                if f"telemetry/{col}" not in skip and not np.allclose(
                        gs[:, i], rs[:, i], rtol=DIFF_RTOL, atol=DIFF_ATOL):
                    raise AssertionError(f"{ctx}: telemetry column {col}")
                note(f"telemetry/{col}", _rel(rs[:, i], gs[:, i]))
        elif k == "percentile_err_s":
            if not (ref[k] >= 0.0 and got[k] >= 0.0):
                raise AssertionError(f"{ctx}: {k}")
        elif k in DIFF_PCT_KEYS:
            bound = max(ref["percentile_err_s"], got["percentile_err_s"])
            if abs(ref[k] - got[k]) > bound + DIFF_ATOL \
                    + DIFF_RTOL * abs(ref[k]):
                raise AssertionError(f"{ctx}: {k}: host={ref[k]!r} "
                                     f"program={got[k]!r} bound={bound!r}")
        else:
            if not np.isclose(got[k], ref[k], rtol=DIFF_RTOL,
                              atol=DIFF_ATOL):
                raise AssertionError(f"{ctx}: {k}: host={ref[k]!r} "
                                     f"program={got[k]!r}")
            note(k, _rel(ref[k], got[k]))
    return worst


def diff_check_case(case: dict, device, errs=None):
    """Run one configuration through the interval program on ``device``
    and through the host oracle, and compare."""
    from repro_torch.env import torchsim
    from repro_torch.env.workload import COMPRESSED, LAYER
    cl = diff_cluster(case["cluster"])
    tel = case.get("telemetry", "summary")
    ctx = f"case={case!r}"
    shape = dict(lam=case["lam"], seed=case["seed"],
                 n_intervals=case["n_intervals"],
                 substeps=case["substeps"], cluster=cl, max_arrivals=48)
    run = dict(cluster=cl, max_active=DIFF_MAX_ACTIVE, device=device,
               telemetry=tel)
    if case["mode"] == "static":
        tr = torchsim.compile_trace(
            torchsim.make_static_decider(case["policy"]), **shape)
        ref = torchsim.replay_trace_edgesim(tr, cluster=cl, telemetry=tel)
        got = torchsim.run_trace_arrays(tr, **run)
    elif case["mode"] == "gillis":
        rng = np.random.RandomState(case["mab_rng"])
        st = diff_gillis_state(rng)
        tr = torchsim.compile_trace_dual(variants=(LAYER, COMPRESSED),
                                         **shape)
        ref = torchsim.replay_trace_edgesim_gillis(
            tr, gillis_state=st, cluster=cl, gillis_hp=case["gillis_hp"],
            telemetry=tel)
        got = torchsim.run_trace_arrays_gillis(
            tr, gillis_state=st, gillis_hp=case["gillis_hp"], **run)
    else:
        rng = np.random.RandomState(case["mab_rng"])
        st = diff_mab_state(rng)
        theta = cfg = None
        if case["daso"] is not None:
            theta, cfg = diff_daso(case["daso"], cl.n, rng)
        if case["mode"] == "gobi":
            cfg = cfg._replace(decision_aware=False)
        tr = torchsim.compile_trace_dual(**shape)
        daso = dict(daso_theta=theta, daso_cfg=cfg, mab_hp=case["mab_hp"])
        if case["mode"] in ("deploy", "gobi"):
            ref = torchsim.replay_trace_edgesim_learned(
                tr, st, cluster=cl, telemetry=tel, **daso)
            got = torchsim.run_trace_arrays_learned(tr, st, **daso, **run)
        else:
            ref = torchsim.replay_trace_edgesim_trained(
                tr, st, cluster=cl, train_hp=case["train_hp"],
                telemetry=tel, **daso)
            got = torchsim.run_trace_arrays_trained(
                tr, st, train_hp=case["train_hp"], **daso, **run)
    if got["dropped_tasks"] != 0:
        raise AssertionError(f"{ctx}: dropped tasks")
    return diff_compare(ref, got, ctx, errs)


def diff_regression(name: str, device, errs=None):
    """One shrunk regression case of ``tests/test_differential.py`` with
    the interval program on ``device``."""
    from repro_torch.env import torchsim
    from repro_torch.env.cluster import make_cluster
    from repro_torch.env.workload import COMPRESSED, LAYER
    gv = dict(variants=(LAYER, COMPRESSED))
    if name == "ram_pressure_repair_static":
        # squeezed RAM + high λ: the repair, failed placements (waiting
        # tasks) and the swap slowdown
        cl = make_cluster(ram_scale=0.3)
        tr = torchsim.compile_trace(torchsim.make_static_decider("mc"),
                                    lam=14.0, seed=5, n_intervals=12,
                                    substeps=4, cluster=cl)
        ref = torchsim.replay_trace_edgesim(tr, cluster=cl)
        got = torchsim.run_trace_arrays(tr, cluster=cl, device=device)
        if not ref["wait_intervals"] > 0:
            raise AssertionError(f"{name}: the repair failed no task")
        return diff_compare(ref, got, name, errs)
    if name == "ram_pressure_repair_train":
        # the repair rewrites the finetuned surrogate's requests while the
        # training carry advances through the repaired placements
        rng = np.random.RandomState(11)
        cl = make_cluster(ram_scale=0.45)
        st = diff_mab_state(rng)
        theta, cfg = diff_daso("small", cl.n, rng)
        tr = torchsim.compile_trace_dual(lam=11.0, seed=5, n_intervals=10,
                                         substeps=4, cluster=cl)
        kw = dict(daso_theta=theta, daso_cfg=cfg, cluster=cl,
                  train_hp=(0.5, 0.5, 2, 2, 1))
        ref = torchsim.replay_trace_edgesim_trained(tr, st, **kw)
        got = torchsim.run_trace_arrays_trained(tr, st, device=device, **kw)
        if not (ref["wait_intervals"] > 0 or ref["response_intervals"] > 1):
            raise AssertionError(f"{name}: no RAM pressure")
        return diff_compare(ref, got, name, errs)
    if name == "eps_boundary_decisions":
        # ε=0 (pure greedy) and ε=1 (pure coin) train decisions
        rng = np.random.RandomState(3)
        tr = torchsim.compile_trace_dual(lam=5.0, seed=2, n_intervals=6,
                                         substeps=3)
        worst = 0.0
        for eps in (0.0, 1.0):
            st = dict(diff_mab_state(rng), eps=np.float32(eps))
            ref = torchsim.replay_trace_edgesim_trained(tr, st)
            got = torchsim.run_trace_arrays_trained(tr, st, device=device)
            worst = max(worst, diff_compare(ref, got, f"{name} eps={eps}",
                                            errs))
        return worst
    if name == "gillis_eps_boundaries":
        # ε=0 over a tied all-zero Q, and ε=1 with decay 1 (a coin forever)
        tr = torchsim.compile_trace_dual(lam=5.0, seed=2, n_intervals=6,
                                         substeps=3, **gv)
        worst = 0.0
        for hp in ((0.0, 0.3, 0.995), (1.0, 1.0, 1.0)):
            ref = torchsim.replay_trace_edgesim_gillis(tr, gillis_hp=hp)
            got = torchsim.run_trace_arrays_gillis(tr, gillis_hp=hp,
                                                   device=device)
            worst = max(worst, diff_compare(ref, got, f"{name} hp={hp}",
                                            errs))
        return worst
    if name == "gillis_ram_pressure":
        # compressed tasks have the largest single-container footprints
        rng = np.random.RandomState(7)
        cl = make_cluster(ram_scale=0.4)
        st = diff_gillis_state(rng)
        tr = torchsim.compile_trace_dual(lam=11.0, seed=5, n_intervals=10,
                                         substeps=4, cluster=cl, **gv)
        ref = torchsim.replay_trace_edgesim_gillis(tr, gillis_state=st,
                                                   cluster=cl)
        got = torchsim.run_trace_arrays_gillis(tr, gillis_state=st,
                                               cluster=cl, device=device)
        if not (ref["wait_intervals"] > 0 or ref["response_intervals"] > 1):
            raise AssertionError(f"{name}: no RAM pressure")
        return diff_compare(ref, got, name, errs)
    if name == "capacity_drop_counting":
        # arrivals past max_active are dropped and counted, the same way
        # twice, and grid rows equal solo runs while dropping
        tr = torchsim.compile_trace(torchsim.make_static_decider("mc"),
                                    lam=10.0, seed=1, n_intervals=8,
                                    substeps=3)
        one = torchsim.run_trace_arrays(tr, max_active=8, device=device)
        two = torchsim.run_trace_arrays(tr, max_active=8, device=device)
        if not one["dropped_tasks"] > 0 or one != two:
            raise AssertionError(f"{name}: drops {one['dropped_tasks']}, "
                                 f"deterministic {one == two}")
        for row in torchsim.run_grid_arrays([tr, tr], max_active=8,
                                            device=device):
            for k in one:
                if not np.isclose(one[k], row[k], rtol=1e-12, atol=1e-12):
                    raise AssertionError(f"{name}: grid row {k}")
        return 0.0
    raise ValueError(f"unknown regression case {name!r}")


def differential_phase():
    """``DIFF_CHIP_CASES`` seeded cases and the six regression cases with
    the interval program on the card against the host oracles; returns
    the launches per kernel of the card runs."""
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    errs, modes = {}, {}
    t0 = time.perf_counter()
    for seed in range(DIFF_CHIP_CASES):
        case = diff_draw_case(seed)
        diff_check_case(case, "cuda", errs)
        key = f"{case['mode']}/{case['telemetry']}"
        modes[key] = modes.get(key, 0) + 1
    for name in DIFF_REGRESSIONS:
        diff_regression(name, "cuda", errs)
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"differential: {DIFF_CHIP_CASES} seeded cases (mode/telemetry: "
        + ", ".join(f"{k} {v}" for k, v in sorted(modes.items()))
        + f") and {len(DIFF_REGRESSIONS)} regression cases on cuda match "
        f"the host oracles at rtol {DIFF_RTOL} / atol {DIFF_ATOL} in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    log("differential: largest relative difference per key: "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(errs.items())))
    return launches


# ------------------------------------------------------- streaming serve
#
# run_stream's own defaults (the Table-3 fleet, λ=6, 300 s intervals of 30
# substeps, a ring of 512 slots, chunks of 64 intervals): the reference's
# 5000 tasks for mc (half the reference's --quick soak size),
# 1000 for splitplace (its DASO stage makes it the slowest, ~29 s for
# 2000), 2000 for gillis; replay
# of main-grid cell 0 cut to 50 intervals in chunks of 32 against the
# one-shot program; the card against the CPU at 750 tasks (both cut, from
# 100 intervals and 1500 tasks, for the script's time limit).

STREAM = dict(lam=6.0, seed=0, chunk_intervals=64, max_active=512,
              substeps=30)
STREAM_TASKS = {"mc": 5000, "splitplace": 1000, "gillis": 2000}
STREAM_REPLAY = dict(n_intervals=50, chunk=32, substeps=30)
STREAM_REPLAY_POLICIES = ("bestfit-rr", "splitplace", "gillis")
STREAM_CROSS = dict(target_tasks=750, **STREAM)
STREAM_CROSS_POLICIES = ("mc", "gillis")
STREAM_RTOL = 1e-9
#: the serving report's integer keys (the admission ledger and its shape)
STREAM_COUNTERS = ("n_chunks", "n_intervals", "offered", "fed",
                   "feeder_overflow", "dropped", "admitted", "finished",
                   "live")


def stream_policy_kw(policy, mab_state, device):
    """run_stream's learner keywords of ``policy``: splitplace with the
    golden literal's MAB state and θ at ``SurrogatePlacer``'s widths from
    a seeded generator on ``device``."""
    import torch
    from repro_torch.core.daso import DASOConfig, init_surrogate
    if policy != "splitplace":
        return {}
    cfg = DASOConfig(**DASO_MAIN)
    gen = torch.Generator(device=device).manual_seed(DASO_SEED)
    return dict(mab_state=mab_state, daso_cfg=cfg,
                daso_theta=init_surrogate(cfg, gen, device=device))


def _check_stream_ledger(rep, label):
    if not (rep["offered"] == rep["fed"] + rep["feeder_overflow"]
            and rep["admitted"] == rep["fed"] - rep["dropped"]
            and rep["admitted"] == rep["finished"] + rep["live"]):
        raise AssertionError(f"stream {label}: the admission ledger does "
                             f"not balance: "
                             + str({k: rep[k] for k in STREAM_COUNTERS}))


def _overlap_s(spans, others):
    """Seconds of the ``spans`` intervals that ``others`` cover (``others``
    do not overlap one another: they run on one thread)."""
    return sum(max(0.0, min(b, d) - max(a, c))
               for a, b in spans for c, d in others)


def stream_path(policy, target_tasks, mab_state=None, draws=False,
                unthreaded=False):
    """One ``run_stream`` soak on the card at ``STREAM``'s settings with
    every kernel's launch count set to 0 just before and read just after:
    the ledger balances, nothing is dropped, device memory is flat from
    the second chunk on (growth at most one chunk's tape and series),
    each simulator kernel (and with ``draws`` ``threefry_rows``) launched
    once per interval, no kernel library built or loaded after the first
    chunk.  Prints the report, the chunk walls, the steady tasks/s and the
    feeder's overlap with the chunks; with ``unthreaded`` the same chunks
    again with no feeder thread (``stream_unthreaded``).  Returns the
    launches."""
    import torch
    from repro_torch.env.metrics import TELEMETRY_COLS
    from repro_torch.env.torchsim import stream
    from repro_torch.kernels import build
    from repro_torch.launch.experiments import run_stream
    from repro_torch.obs import RunLedger, use_ledger
    kw = stream_policy_kw(policy, mab_state, "cuda")
    mem, fin, cache = [], [], []
    T = STREAM["chunk_intervals"]
    i_fin = TELEMETRY_COLS.index("n_fin")

    def on_chunk(i, runner, rolling):
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        fin.append(sum(row[i_fin] for row in list(rolling.window)[-T:]))
        if i == 1:
            cache.append(build.cache_stats())

    # one chunk's upload (its tape, packed) and its series on the card
    engine, _, fkw = stream.make_stream_policy(policy, **kw)
    tape = stream.StreamFeeder(lam=STREAM["lam"], seed=STREAM["seed"],
                               substeps=STREAM["substeps"],
                               **fkw).next_chunk(T)
    chunk_bytes = T * (len(TELEMETRY_COLS) + len(engine.telemetry_cols())) \
        * 8 + sum(-(-v.nbytes // 8) * 8 for v in tape.values())
    counters = _counters()
    gc.collect()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    led = RunLedger(f"stream {policy}")
    t0 = time.perf_counter()
    with use_ledger(led):
        rep = run_stream(policy, target_tasks=target_tasks,
                         on_chunk=on_chunk, device="cuda", **STREAM, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    label = f"stream {policy}"
    _check_stream_ledger(rep, label)
    if rep["feeder_overflow"] or rep["dropped"]:
        raise AssertionError(f"{label}: feeder_overflow "
                             f"{rep['feeder_overflow']}, dropped "
                             f"{rep['dropped']} (expected 0)")
    n = rep["n_intervals"]
    for name in SIM_KERNELS + (DRAW_KERNELS if draws else ()):
        if launches[name] != n:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times over {n} "
                                 "intervals")
    growth = max(mem[1:]) - mem[1] if len(mem) > 1 else 0
    if growth > chunk_bytes:
        raise AssertionError(f"{label}: device memory grew by {growth} B "
                             f"from chunk 2 on (one chunk's tape and "
                             f"series: {chunk_bytes} B): {mem}")
    end = build.cache_stats()
    if cache and (end["misses"] != cache[0]["misses"]
                  or end["keys"] != cache[0]["keys"]):
        raise AssertionError(f"{label}: kernel libraries loaded or built "
                             f"after the first chunk: {cache[0]} -> {end}")
    spans = [e for e in led.events if e["kind"] == "span"]
    chunk_iv = [(e["start_s"], e["start_s"] + e["dur_s"]) for e in spans
                if e["name"] == "stream_chunk"]
    feed_iv = [(e["start_s"], e["start_s"] + e["dur_s"]) for e in spans
               if e["name"] == "feed"]
    walls = [b - a for a, b in chunk_iv]
    steady = sum(fin[1:]) / sum(walls[1:]) if len(walls) > 1 else 0.0
    feed_s = sum(b - a for a, b in feed_iv)
    roll = rep["rolling"]
    log(f"{label}: {target_tasks} tasks at lam={STREAM['lam']}, "
        f"{rep['n_chunks']} chunks of {T} = {n} intervals of "
        f"{STREAM['substeps']} substeps, ring {STREAM['max_active']}: wall "
        f"{wall:.3f} s; offered {rep['offered']} = fed {rep['fed']} + "
        f"feeder_overflow {rep['feeder_overflow']}; admitted "
        f"{rep['admitted']} = fed - dropped {rep['dropped']} = finished "
        f"{rep['finished']} + live {rep['live']}; occupancy max "
        f"{rep['max_occupancy']:.0f}, halves "
        f"{rep['occupancy_mean_first_half']:.2f} / "
        f"{rep['occupancy_mean_second_half']:.2f}; rolling "
        f"({roll['window_intervals']} intervals) qps {roll['qps']:.5f}/s, "
        f"p50 {roll['p50_response_s']:.1f} s, p99 "
        f"{roll['p99_response_s']:.1f} s, violation rate "
        f"{roll['violation_rate']:.4f}; reward "
        f"{rep['summary']['reward']:.4f}")
    log(f"{label}: chunk wall median {np.median(walls):.4f} s (min "
        f"{min(walls):.4f}, max {max(walls):.4f}); steady "
        f"{steady:.1f} tasks/s (completions over chunk wall, chunk 1 left "
        f"out); feeder {feed_s:.3f} s in {len(feed_iv)} feed spans, "
        f"{_overlap_s(feed_iv, chunk_iv):.3f} s of it overlapping chunks; "
        f"memory_allocated {mem[0]} B after chunk 1, growth from chunk 2 "
        f"{growth} B (bound {chunk_bytes} B; every chunk: "
        f"{', '.join(str(m) for m in mem)}); launches {launches}")
    if unthreaded:
        stream_unthreaded(policy, kw, rep, walls)
    return launches


def stream_unthreaded(policy, kw, rep, walls):
    """The soak's tapes made first, then run through a ``StreamRunner``
    with no feeder thread: the summary equals the threaded soak's (the
    report does not depend on thread timing), and the chunk walls, without
    the feeder competing for the GIL, are printed beside the threaded
    ones."""
    from repro_torch.env.torchsim import stream
    engine, es0, fkw = stream.make_stream_policy(policy, seed=STREAM["seed"],
                                                 **kw)
    feeder = stream.StreamFeeder(lam=STREAM["lam"], seed=STREAM["seed"],
                                 substeps=STREAM["substeps"], **fkw)
    tapes = [feeder.next_chunk(STREAM["chunk_intervals"])
             for _ in range(rep["n_chunks"])]
    runner = stream.StreamRunner(engine, es0, interval_s=feeder.interval_s,
                                 substeps=feeder.substeps,
                                 max_active=STREAM["max_active"],
                                 device="cuda")
    alone = []
    for tape in tapes:
        t0 = time.perf_counter()
        runner.run_chunk(tape)
        alone.append(time.perf_counter() - t0)
    got = runner.summary()
    for k, v in rep["summary"].items():
        if not np.array_equal(got[k], v):
            raise AssertionError(f"stream {policy} without the feeder "
                                 f"thread: {k} {got[k]!r}, threaded {v!r}")
    log(f"stream {policy} without the feeder thread (tapes made first): "
        f"the same summary to every digit; chunk wall median "
        f"{np.median(alone):.4f} s (min {min(alone):.4f}, max "
        f"{max(alone):.4f}), chunks 2 on {sum(alone[1:]):.3f} s against "
        f"{sum(walls[1:]):.3f} s with the feeder thread running")


def stream_replay(policy, device, mab_state=None, **shape):
    """``replay_stream`` of main-grid cell 0 (λ=6, seed 0) in chunks
    against the one-shot program with ``telemetry="interval"`` on
    ``device``: the summaries and series equal to every digit."""
    from repro_torch.env import torchsim
    from repro_torch.env.torchsim import driver, stream
    shape = {**STREAM_REPLAY, **shape}
    kw = stream_policy_kw(policy, mab_state, device)
    engine, es0, fkw = stream.make_stream_policy(policy, seed=0, **kw)
    tkw = dict(lam=MAIN["lams"][0], seed=MAIN["seeds"][0],
               n_intervals=shape["n_intervals"], substeps=shape["substeps"])
    if "decider" in fkw:
        tr = torchsim.compile_trace(fkw["decider"], **tkw)
    else:
        tr = torchsim.compile_trace_dual(variants=fkw["variants"], **tkw)
    one = driver.run_trace_engine(engine, tr, es0, device=device,
                                  telemetry="interval")
    got = stream.replay_stream(engine, tr, es0,
                               chunk_intervals=shape["chunk"],
                               collect_series=True, device=device)
    if set(got) != set(one):
        raise AssertionError(f"stream replay {policy}: keys differ: "
                             f"{set(got) ^ set(one)}")
    for k, v in one.items():
        if k == "telemetry":
            same = got[k]["cols"] == v["cols"] and \
                got[k]["series"].tobytes() == v["series"].tobytes()
        elif isinstance(v, np.ndarray):
            same = got[k].tobytes() == v.tobytes()
        else:
            same = got[k] == v
        if not same:
            raise AssertionError(f"stream replay {policy} {k}: one-shot "
                                 f"{v!r} chunked {got[k]!r}")
    log(f"stream replay {policy} on {device}: T={shape['n_intervals']} in "
        f"chunks of {shape['chunk']} equals the one-shot run to every digit "
        f"(summary and {got['telemetry']['series'].shape} series; "
        f"{one['tasks_completed']} tasks)")


def stream_cross(policy, **settings):
    """``run_stream`` on the card and on the CPU: the serving report's
    counters equal, the summary and the rolling snapshot within
    ``STREAM_RTOL``."""
    from repro_torch.launch.experiments import run_stream
    settings = {**STREAM_CROSS, **settings}
    card, host = (run_stream(policy, device=d, **settings)
                  for d in ("cuda", "cpu"))
    for k in STREAM_COUNTERS:
        if card[k] != host[k]:
            raise AssertionError(f"stream {policy} {k}: cuda {card[k]} cpu "
                                 f"{host[k]}")
    worst = 0.0
    for part in ("summary", "rolling"):
        for k, v in host[part].items():
            g = card[part][k]
            if isinstance(v, (float, np.ndarray)):
                if not np.allclose(g, v, rtol=STREAM_RTOL, atol=1e-12):
                    raise AssertionError(f"stream {policy} {part} {k}: cuda "
                                         f"{g!r} cpu {v!r}")
                d = np.abs(np.asarray(g) - np.asarray(v)) / np.maximum(
                    np.abs(np.asarray(v)), 1e-300)
                worst = max(worst, float(np.max(d)))
            elif g != v:
                raise AssertionError(f"stream {policy} {part} {k}: cuda "
                                     f"{g!r} cpu {v!r}")
    log(f"stream {policy}: the card equals the CPU on every counter "
        f"({card['n_intervals']} intervals, {card['finished']} finished) "
        f"and within rtol {STREAM_RTOL} on the summary and the rolling "
        f"snapshot (largest relative difference {worst:.3e})")


def stream_phase(mab_state):
    """The streaming serve loop on the card: the ``mc`` soak and the
    ``splitplace`` and ``gillis`` runs (``stream_path``), chunked replay
    against the one-shot program, and the card against the CPU.  Returns
    the soaks' launches per kernel, summed."""
    totals = {}
    for policy, draws in (("mc", False), ("splitplace", False),
                          ("gillis", True)):
        t0 = time.perf_counter()
        launches = stream_path(policy, STREAM_TASKS[policy], mab_state,
                               draws=draws, unthreaded=policy == "mc")
        log(f"stream {policy}: {time.perf_counter() - t0:.1f} s")
        for name, count in launches.items():
            totals[name] = totals.get(name, 0) + count
    for policy in STREAM_REPLAY_POLICIES:
        stream_replay(policy, "cuda", mab_state)
    for policy in STREAM_CROSS_POLICIES:
        stream_cross(policy)
    return totals


def main() -> int:
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.mab import mab_state_from_numpy
    from repro_torch.kernels.build import LIBRARIES

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    build_logs = LIBRARIES.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, text in build_logs.items():
        for line in text.strip().splitlines():
            log(f"  [{name}] {line}")

    dryrun = dryrun_start()
    t0 = time.perf_counter()
    records = []
    for phase in (kernel_phase, flash_phase, moe_route_phase,
                  selective_scan_phase, rglru_scan_phase, threefry_phase):
        t1 = time.perf_counter()
        out = phase()
        records.extend(out if isinstance(out, list) else [out])
        log(f"{phase.__name__}: {time.perf_counter() - t1:.1f} s")
    log(f"forward kernel phases: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    one_call = {}
    recs, wall, launches, _ = main_path("bestfit-rr")
    one_call["bestfit-rr"] = (recs, wall)
    device = sim_profile("bestfit-rr")
    for rec in records:
        if rec["name"] in SIM_KERNELS:
            rec["launches"] = launches[rec["name"]]
            if device:
                rec["device_ms_per_run"] = device[rec["name"]][0]
    mab_state = mab_state_from_numpy(MAB_LITERAL, device="cuda")
    main_path("mab", mab_state=mab_state)
    one_call["splitplace"] = daso_path(mab_state)
    draws, draw_err_main = train_paths(mab_state)
    for rec in records:
        if rec["name"] == "threefry_rows":
            rec["launches"] = draws["splitplace train"]
            rec["max_abs_err"] = max(rec["max_abs_err"], draw_err_main)
            rec["launches_by_path"] = draws
    log(f"simulator main paths: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tel = telemetry_phase(mab_state)
    log(f"telemetry phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    diff = differential_phase()
    log(f"differential phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    streamed = stream_phase(mab_state)
    log(f"stream phase: {time.perf_counter() - t0:.1f} s")
    for rec in records:
        if rec["name"] in SIM_KERNELS + DRAW_KERNELS:
            rec["launches_telemetry"] = tel[rec["name"]]
            rec["launches_differential"] = diff[rec["name"]]
            rec["launches_stream"] = streamed[rec["name"]]
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    table4 = table4_phase()
    log(f"table4 phase: {time.perf_counter() - t0:.1f} s")
    for rec in records:
        if rec["name"] in SIM_KERNELS + DRAW_KERNELS:
            rec["launches_table4"] = table4[rec["name"]]
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    splitnets_phase()
    log(f"splitnets phase: {time.perf_counter() - t0:.1f} s")

    totals, decoded, flash_by_arch = {}, {}, {}
    t0 = time.perf_counter()
    for arch in SERVE_ARCHS + EXTRA_ARCHS:
        launches, dec = serving_path(arch)
        for name, count in launches.items():
            totals[name] = totals.get(name, 0) + count
        for name, count in dec.items():
            decoded.setdefault(name, {})[arch] = count
        flash_by_arch[arch] = launches["flash_attention"]
        gc.collect()
        torch.cuda.empty_cache()
    log(f"serving and decode paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    decode_f32_gate()
    gc.collect()
    torch.cuda.empty_cache()
    decode_cross_check()
    log(f"decode gates (float32 full width, reduced card vs cpu): "
        f"{time.perf_counter() - t0:.1f} s")
    for rec in records:
        if rec["name"] not in SIM_KERNELS + DRAW_KERNELS:
            rec["launches"] = totals[rec["name"]]
            rec["launches_decode"] = decoded[rec["name"]]
        if rec["name"] == "flash_attention":
            # an entry's launches are those of the serving path whose
            # shape it holds (musicgen's self and cross attention alike)
            for key, arch in (("hd128", "qwen2-moe-a2.7b"),
                              ("hd256", "recurrentgemma-9b"),
                              ("hd128_g7", "qwen2-vl-7b"),
                              ("hd64_g1", "musicgen-medium"),
                              ("cross", "musicgen-medium")):
                rec[key]["launches"] = flash_by_arch[arch]
            for key, arch in (("hd64", SERVE_ARCHS[0]),
                              ("hd128", "qwen2-moe-a2.7b"),
                              ("hd256", "recurrentgemma-9b"),
                              ("hd128_g7", "qwen2-vl-7b"),
                              ("hd64_g1", "musicgen-medium")):
                rec["decode"][key]["launches"] = decoded[rec["name"]][arch]
            rec["cross_decode"]["launches"] = \
                decoded[rec["name"]]["musicgen-medium"]
        if rec["name"] == "moe_route":
            rec["decode"]["launches"] = decoded[rec["name"]]["qwen2-moe-a2.7b"]

    t0 = time.perf_counter()
    train_recs, _, _ = train_phase()
    records.extend(train_recs)
    log(f"training phases: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # the head dims 112 and 192 run only in the wide blocks: their flash
    # entries take those runs' launches
    wide = wide_block_phase()
    for rec in records:
        for arch, key in zip(WIDE_ARCHS, ("hd112", "hd192")):
            n = wide[arch]["launches"]
            if rec["name"] == "flash_attention":
                rec[key]["launches"] = n["flash_attention"]
                rec["decode"][key]["launches"] = n["decode"]
                rec[key]["wide_block"] = wide[arch]
            elif rec["name"] == "flash_attention_bwd":
                rec[key]["launches"] = n["flash_attention_bwd"]
    gc.collect()
    torch.cuda.empty_cache()

    piped = pipeline_phase()
    for rec in records:
        if rec["name"] == "flash_attention":
            rec["launches_pipeline"] = {
                f"M{m}": piped[f"M{m}"]["flash_launches"]
                for m in PIPELINE["microbatches"]}
    gc.collect()
    torch.cuda.empty_cache()
    grid_phase(mab_state, one=one_call)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    count_phase()
    dryrun_phase(dryrun)
    log(f"count and dry-run phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cross_checks()
    model_cross_check()
    log(f"cross checks: {time.perf_counter() - t0:.1f} s")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if leaked:
        raise AssertionError(f"JAX or the JAX package was imported: {leaked}")

    log(f"whole script: {time.perf_counter() - t_main:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
