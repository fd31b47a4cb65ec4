#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA
                                   # card with sm_90a (H100) and nvcc

Phases, each of which ends the run non-zero if it fails:
  1. build      — nvcc the three kernel sources (tree-attention forward, dq,
                  dk/dv) in parallel, one process each; print every kernel
                  instance's registers and spills from ptxas's report and
                  its wgmma (HGMMA) and TMA-load (UTMALDG) instruction
                  counts; each Hopper instance (bf16: the three kernels
                  at hd 64, 128 and 192) must be there, show both and
                  spill nothing.
 1a. warm restart — ``python -m repro_torch.train.warmup --persist-probe``
                  over the build directory phase 1 filled, in a fresh
                  process: 0 new files there (nothing rebuilt), a tiny
                  plan stream prewarmed, one engine step with 0 retraces;
                  its first step's ms and its wall printed.
  2. kernel     — hold the forward kernel against its plain PyTorch version
                  on the card, computed in f32 from the same inputs (o and
                  lse at 1e-4; a bf16 o within its rounding: 2^-7 of it plus
                  2e-2 of its row's rms), and a bf16 kernel also against the
                  plain version run in bf16 (2e-2), on packed branching
                  trees, MHA/GQA/MQA, padding keys, gateway ancestors,
                  windows, prefill_attention, every head dim, a packed
                  agentic row and the serving path's two shapes; prints
                  block-skip fractions.
  3. bwd kernel — the dq and dk/dv kernels against the plain backward in f32
                  on the same (q, k, v, o, lse, do): f32 at 1e-4; bf16 at
                  relative L2 ≤ 1e-2 per output and every element within
                  5e-2 + 5e-2·|ref|.  The forward's cases plus the training
                  shape T; two launches must be bit-identical, invisible
                  keys get exactly zero dk/dv.  Where the dq kernel computes
                  Δ itself (bf16 hd 64/128/192) its Δ is held against the
                  plain ``delta`` at 1e-5 of Σ|do·o| per row, dq and Δ must be
                  bit-identical over two launches and dq exactly 0 on rows
                  that see no key.
 3a. mask soundness — the kernels' copies of the skip predicate against
                  ``block_live_mask``, on every path (bf16 at hd 64, 96,
                  128, 192; f32 at hd 64, 128): padding tails, a gateway
                  wave with padded ancestor slots, and a window x q_off
                  case.  Phases 2-3's checks on them, then NaN in K and V
                  of exactly the key tiles dead for every query tile (128
                  query rows for the Hopper forward and dq at hd 192, 64
                  elsewhere): o, lse, dq, dk, dv torch.equal to the clean
                  run and finite.
  4. serve      — Qwen2-1.5B at full width, random bf16 weights: 4 rollout
                  groups (prompt 1024, K=8, 64 new tokens) and one
                  multi-turn agentic session (prefill → fork(8) → 32 steps →
                  a 200-token tool-output prefill on all branches → 32
                  steps); each session replays a CUDA graph a decode
                  step.  Launch counts are reset just before and read just
                  after.  Then one decode step of 8 branches under
                  torch.profiler, reported as the train step's (phase 6).
  5. parity     — replay the multi-turn session with the plain attention,
                  teacher-forced: 4 layers in f32 (≤ 1e-4 max-rel) and all
                  28 layers in bf16 (relative L2 ≤ 3e-2).
  6. train      — Qwen2-1.5B at full width in bf16 through
                  ``TreeTrainEngine.step`` with the kernels: 4 SFT steps on
                  agentic trees and 2 RL steps on GRPO trees, 2 rows of
                  4096; each step launches each kernel once per layer and
                  syncs the host once.  Then one more step under
                  torch.profiler (not in the median): the 15 CUDA kernels
                  with the most device time, kernel time by family and by
                  the host op that launched it, and the device-busy share
                  of the step's window.  Then tree vs per-branch baseline
                  on the planner's 2-row step (rows of 2048) and the same
                  trees' paths, forward + backward timed apart from AdamW.
                  Counts are reset just before and read just after.
  7. determinism — two ``accumulate`` calls on the same parameters and
                  plan give bit-identical gradients on every leaf: a
                  packed plan and a partition-wave plan, all 28 layers;
                  a third under ``remat="full"`` (each layer recomputed in
                  the backward) gives the same bits.
  8. waves      — 4 generator batches of agentic trees of 6k-16k unique
                  tokens (nearly all larger than a row) through ``plans``:
                  auto partition, auto capacity, lookahead 2, grafting on,
                  plans built on a background thread.  Per step: waves,
                  rows per wave, A_max, step time, unique tokens/s, peak
                  memory, launches (forward 2 per layer and wave: sweep
                  and remat), one host sync (audited in 'warn' and in
                  'error' mode), trees packed, partitioned and dropped
                  (0); Σ unique tokens equals the generated trees'.
                  The last step's plan once more through an engine with
                  the executable cache, prewarmed as ``plans(...,
                  warmup=)`` prewarms it: grads and scalars torch.equal to
                  the uncached engine's, 0 retraces.
  9. train parity — (a) 4 layers f32, kernel vs plain attention: loss 1e-5
                  relative, grads max-rel 1e-4; (b) the same through the
                  kernels, tree vs per-branch baseline (Eq. 5), same limits;
                  (c) 28 layers bf16, kernel vs plain: loss 1e-2 relative,
                  gradient relative L2 5e-2.
 10. wave parity — one tree of 6k-8k tokens partitioned at 2048 (≥ 3
                  waves, ancestors ≥ 2048 tokens) vs the same tree whole in
                  one row of 8192, kernels both: (a) 4 layers f32, loss
                  1e-5, grads max-rel 1e-4; (b) 28 layers bf16, loss 1e-2,
                  gradient relative L2 5e-2.
 10a. data parallel — (a) a world of 1 over NCCL (``torch.distributed``,
                  a file store) at full width, 28 layers bf16: the packed
                  plan's and the wave plan's grads through the engine on
                  the data axis (``sharding.use_mesh``) ``torch.equal`` to
                  the engine's with no process group; 3 steps on the
                  axis, their launches counted from 0 just before them
                  (28 of each kernel a step), one host sync each (step 1
                  audited as in phase 6), their median beside phase 6's;
                  one profiled step's reduction over the axis (device ms
                  of the kernels in ``engine.REDUCE_SPAN``, and the bytes
                  summed; at one rank NCCL sums nothing across cards).
                  (b) a world of 2 spawned from the script (NCCL where
                  the machine shows two devices, else gloo on the one
                  card; printed; started with the phase, let go after
                  (a)), 4 layers f32, 2 steps: phase 6's first plan, then
                  the waves stream's first plan at num_replicas 2 that
                  has a parent row on the other rank (the captures'
                  all-gather and the cotangents' reduce-scatter cross
                  ranks): each step's grads on the axis within 1e-4
                  max-rel of world 1's at the same params (rank 0),
                  params torch.equal across ranks after the steps, each
                  kernel's launches a step on each rank as
                  ``step_launches`` says, the engine's one host sync a
                  step.  A rank that fails or outlives DP_TIMEOUT_S
                  fails the run.
 10b. model parallel — the same two ranks, after (b)'s steps, on a mesh
                  (data 1, model 2): Megatron tensor parallelism
                  (``sharding.py``), each rank's blocks drawn from the
                  seed as world 1 draws its leaves, the kernels at the
                  rank's heads (H 6 / Kh 1), on ``mp_plans``: a packed
                  plan and a 3-wave plan, 2 rows of MP_SEQ (1024; every
                  block boundary's collective goes through the host over
                  gloo).  (a) 4 layers f32, sequence
                  parallelism off and on: loss 1e-6 relative and each
                  rank's grad blocks 1e-4 max-rel of world 1's (each rank
                  runs the engine with no process group too, at the same
                  params, and holds its blocks against it), each
                  kernel launched ``plan_launches`` times by each rank
                  (4 a packed step).  (b) The same at MP_BF16_LAYERS
                  layers in bf16 (reduced: the depth at which two ranks'
                  world 1 runs and blocks fit the card beside the
                  script's own process, reckoned and printed),
                  gradient relative L2 5e-2 of world 1's, the kernels on
                  their Hopper path.  Phases 2-3 also hold the kernels at
                  the model axis's head layouts, H 6 / Kh 1 and H 8 / Kh
                  2 at hd 128 (Qwen2-1.5B at model 2, Qwen3-8B at model
                  4), on the T rows.
 11. timing     — each kernel, its plain version and one library call, at
                  the serving path's two shapes A and B (forward) and at
                  the training shape T (all three), and at W (a gateway
                  wave of phase 8, q_off = A_max, the largest it ran),
                  beside the H100's bound and as a percentage of it;
                  kernel and library call also as device time, replayed
                  from a CUDA graph (SDPA's backward: a graph of forward
                  and backward less one of the forward, since autograd
                  runs the backward on the forward's stream).
 11a. rl loop   — the async tree-RL loop, Qwen2-1.5B at full width and
                  depth, through ``repro_torch.launch.rl_loop.main``: prompt
                  1024, K 8, 2 rows of 4096, lookahead 1, --check-grads;
                  --groups and --max-new chosen so that a train step takes
                  at least 1.2x a step's generation, reckoned from phases 4
                  and 6 (both printed; a group's fixed cost is its prefill,
                  its decode graphs being captured before the loop).  At --max-ahead 1 for 6 steps (steps
                  3-4 profiled with both threads live: device-busy share,
                  kernel time by family and by stream, the longest idle
                  gaps), then on-policy at --max-ahead 0 for 3 steps; the
                  per-step wall of steps 1-2 of the two compared.  Per step:
                  ms, wall, loss, lag, peak GB, the trainer thread's
                  synchronizing calls (exactly 1: counted by thread under
                  set_sync_debug_mode('warn'); the generator's own syncs
                  are reported apart) and the trainer's launches (28 of each
                  kernel), the launches counted per thread; the generator
                  launches 28 forwards a group prefill and no backward.
                  0 dropped, lag within max_ahead + lookahead - 1, the
                  launcher's overlap check, and no step's peak more than
                  one weight snapshot above step 1's.  The launcher's
                  warm-up (its seconds printed) captures the decode graphs
                  of the loop's shape through the generator's GraphPool and
                  parameter buffer and prewarms the probe window's
                  executables: in the loop 0 decode-graph captures (every
                  group leases the graphs) and 0 engine retraces; the
                  captures before the loop and the generation seconds a
                  group are printed.  After each group the CUDA-graph pools
                  (the allocator's segments outside its default pool) hold
                  the bytes they held after the first.  The allocator never
                  flushed its cache in the loop (while a decode graph
                  captures it cannot, and would raise out of memory
                  instead); reserved and free device memory after the loop
                  are printed.
 11b. rl parity — (a) a frozen rollout group's online plan-path grads vs the
                  offline RL grads: full depth bf16 (11a's --check-grads) and
                  4 layers f32, each ≤ 1e-6 max-rel; (b) a sampled group
                  (temperature 1, fixed seed) from a just-published
                  snapshot, on a stream of its own, while the trainer runs
                  2 steps, then from the same weights alone: equal tokens
                  and every prefill and decode logit torch.equal; (b') a
                  greedy group whose stream first sleeps, so that its reads
                  of the snapshot are still queued when its thread drops
                  its last reference, the trainer then publishing twice
                  (the store drops the snapshot, the step allocates): its
                  logits torch.equal the greedy group's alone, and its work
                  was still queued after the two steps; the same with
                  ``record_stream`` disabled is printed as a control; (c)
                  after every publish the snapshot equals the trainer's
                  params.  The five groups share one GraphPool and
                  parameter buffer: (b)'s concurrent group captures the
                  decode graph (1 capture), the other four replay it (4
                  leases).
Then the MoE model, Qwen3-30B-A3B (H 32, Kh 4, 128 experts top-8), once
the dense model's tensors are freed:
 12. moe kernel — phases 2-3 at H 32/Kh 4: a gateway case (f32, bf16),
                  the serving path's prefill and tool prefill, and the MoE
                  train step's rows T_moe; and at the model axis's head
                  layouts of the MoE model, H 16/Kh 2 and H 8/Kh 1 (model
                  2 and 4), on the T_moe rows in f32 and bf16.
 13. moe serve  — all 48 layers (or the deepest cut whose bf16 weights fit
                  75 GB, printed as reduced), random weights: phase 4's
                  groups and session, decode tokens/s beside the bound of
                  reading every weight once a step, a profiled decode
                  step; teacher-forced replays of the session up to its
                  second prefill, through the kernels and the plain
                  attention, with the routing recorded: the dropped share of (token, slot)
                  pairs at prefill and decode, the routing balance, bf16
                  prefill-logits parity (relative L2 ≤ 5e-2) and routing
                  agreement.
 14. moe parity — 2 layers f32, kernel vs plain, teacher-forced: logits
                  max-rel ≤ 1e-4; routing flips counted, and the rows they
                  reach left out of the check and reported.
 15. moe train  — phase 6 at depth 2 (2 rows of 4096, bf16), then phase
                  7's check on a packed plan.
 16. moe train parity — 1 layer f32, one row of 2048: (a) kernel vs plain,
                  (b) tree vs baseline with the aux losses off and
                  capacity factor E/K (C = N): loss 1e-5 relative, gradient
                  relative L2 1e-4, routing flips counted; then, not
                  checked, tree vs baseline at the real capacity factor.
 16a. expert parallel — a world of 2 spawned from the script (NCCL where
                  the machine shows two devices, else gloo on the one
                  card), the memory reckoned and printed first, on a mesh
                  (data 1, model 2): each rank holds 64 of the 128 experts
                  (``models/moe.py``), its blocks drawn from the seed as
                  world 1 draws its leaves, and runs the kernels at H 16 /
                  Kh 2; 2 layers at full width, ``mp_plans``' packed and
                  3-wave plans (2 rows of MP_SEQ), sequence parallelism off
                  and on, the aux losses on, one ``accumulate`` each beside
                  world 1's on the rank.  (a) f32: loss 1e-6 relative and
                  each rank's grad blocks 1e-4 max-rel of world 1's, every
                  MoE call's routing torch.equal across the ranks and its
                  kept (token, slot) pairs world 1's; (b) bf16: gradient
                  relative L2 5e-2 of world 1's with the routing flips
                  against world 1 counted; a miss is rerun with world 1's
                  routing pinned, and passes, reported as a miss, only if
                  flips occurred and the pinned run is within the bar.
                  Each kernel is launched ``plan_launches`` times by each
                  rank.
 17. moe timing T — phase 11's training-shape timing at T_moe.
Then the rest of the dense and MoE archs (Qwen3-8B, Qwen3-32B, Llama-4
Scout, Kimi K2, Nemotron-4 340B), once the MoE model's tensors are freed:
 18. arch kernel, arch bwd kernel — phases 2-3 at each of their attention
                  layouts (H 32, 64 and 40 over Kh 8 at hd 128 on the
                  Hopper paths; H 96/Kh 8 at hd 192 in bf16 on the
                  Hopper paths, and in f32 on the simple kernels), at the
                  serving prefill shape (S 1024, B 1), the tool prefill
                  (B 8, S 200, q_off 1056) and the train rows (B 2, S
                  4096, real kv_last).  Each case names each kernel's bf16 path.  The
                  plain versions run by whole GQA groups where their dense
                  scores would pass 4 GB.
 19. <arch> serve — each arch at full width and the deepest cut whose bf16
                  weights fit 69 GB (the head and each layer reckoned by
                  kind), random weights: one rollout group, the multi-turn
                  session, decode tokens/s beside the bound of reading
                  every weight once a step, a profiled decode step; then
                  parity (b), the session replayed through the plain
                  attention in bf16 at that depth: every call's logits at
                  relative L2 ≤ 3e-2 (dense), or phase 13's checks (MoE).
 20. <arch> parity — phase 14's check (a) in f32 at the deepest cut that
                  fits, at most 4 layers (Kimi K2: its dense layer only).
 21. qwen3_32b train — phase 6 at the deepest cut whose weights, fp32
                  grads and AdamW state (14 bytes a parameter) and 1.9 GB
                  of activations a layer fit 60 GB: 2 SFT steps, 1 RL step;
                  then phase 7's check on a packed plan.
 22. timing <layout> — phase 11's training-shape timing at each layout, at
                  the serving prefill shape, the tool prefill and the train
                  rows; the kernels line names each row's bf16 path.

Then the SSM and hybrid archs (RWKV6-1.6B, the GDN stack, Zamba2-1.2B),
each at full width, once the other archs' tensors are freed:
 23. zamba2 kernel, zamba2 bwd kernel — phases 2-3 at Zamba2's shared
                  attention layout (H 32/Kh 32, hd 64): the serving-width
                  prefill (S 1024, B 1) and the first chunk-aligned train
                  rows (B 2, S 4096; the chunk pads invisible keys, their
                  dk/dv exactly 0), bf16 and f32.
 24. <arch> serve — at half depth (STEP_LOOP_SERVE_DEPTH: 12, 12 and 19
                  layers): one rollout group (prompt 1024, K 8, 64 new
                  tokens)
                  and the multi-turn session, prefilled through the step
                  loop: prefill and decode tokens/s, the decode bound, a
                  profiled decode step; no tree-attention kernel launches.
 25. <arch> serve parity — the step loop vs the packed forward on 256
                  tokens, teacher-forced, at phase 24's depth and at 4
                  layers:
                  f32 (atol = rtol = 5e-4); bf16, both paths against the
                  f32 forward (the step loop within 1.25x of the bf16
                  forward's distance; at 4 layers also within 3e-2 of the
                  bf16 forward); two broken step loops: bf16 states
                  (reported) and a 2% fault in every SSM mixer's step
                  (must fail).
 26. <arch> train — at a quarter of its depth (SSM_TRAIN_DEPTH: 6, 6
                  and 10 layers), 3 SFT and 2 RL steps on chunk-aligned
                  rows (2 of 4096): step time, unique tokens/s,
                  chunk-padding share, peak memory, one host sync
                  (audited), launches (2 of each kernel a Zamba2 step at
                  10 layers, none for the pure SSMs), a profiled step.
 27. <arch> determinism — phase 7's check on a packed plan and on the
                  first plan of phase 28's stream (partition waves), at
                  SSM_DETERMINISM_LAYERS layers (8: Zamba2's shared
                  block applied twice).
 28. <arch> waves — phase 8 at a quarter of its depth (SSM_WAVE_DEPTH:
                  6, 6 and 10 layers) on SSM_WAVE_BATCHES generator
                  batches: chunk-aligned partitions and waves (auto
                  capacity, a multiple of the chunk), the chunk-padding
                  share per step, no profiled step; launches 0 for RWKV6
                  and GDN, for Zamba2 each kernel per application of the
                  shared block: forward 2 a wave (sweep and remat), dq
                  and dk/dv 1; at least 2 steps, 2 waves in some step.
 29. <arch> wave parity — phase 10, chunk-aligned, (b) at phase 28's
                  depth on its trained weights (a quarter of the depth:
                  at half depth a run passed the 1200 s limit on a slow
                  host);
                  (b)'s gradient bar is 5e-2 for all three (Zamba2's
                  bar was 1e-1 at full depth, where its bf16 waves
                  drift 5.7e-2-6.6e-2; at 19 layers 2.750e-2); two
                  broken partitioned runs are reported.
 30. <arch> train parity — 4 layers f32: (a) kernel vs plain (Zamba2),
                  (b) tree vs per-branch baseline (tree state routing),
                  loss 1e-5, grads max-rel 1e-4.
 30a. zamba2 rl loop — phase 11a at Zamba2-1.2B's full width and depth
                  (prompt 512, K 8, 32 new tokens, 1 group, 3 steps,
                  --max-ahead 1): no kernel launch in generation (its
                  sessions step the prompt: the warm-up captures a batch-1
                  and a batch-K decode graph, the loop none), 7 of each
                  kernel a train step.
 31. timing H 32/Kh 32 hd 64 — phase 11's timing at the prefill and at
                  the chunk-padded train rows, with the attention share of
                  a Zamba2 step.
 32. zamba2 wave kernel, timing ZW — phase 11's W checks and timing at
                  ZW, the Zamba2 waves phase's gateway wave with the
                  largest A_max, H 32/Kh 32 hd 64, q_off = A_max.

Then the enc-dec and VLM archs (SeamlessM4T-large v2, Phi-3-vision 4.2B),
at full width, once the SSM archs' tensors are freed:
 33. mm kernel, mm bwd kernel — phases 2-3 at the two new layouts on their
                  first train step's real kv_last: V, Phi-3's rows (B 2,
                  576 patches + 4096 text tokens, H 32/Kh 32, hd 96: in
                  bf16 the three Hopper kernels, chained as training
                  chains them) and S2, Seamless's decoder rows (B
                  2, S 4096, H 16/Kh 16, hd 64: the Hopper paths in bf16),
                  bf16 and f32; and hd 96 bf16 beyond Phi-3's MHA: GQA
                  32/8, MQA 32/1, padding keys, gateway ancestors with a
                  window, and a ragged S behind a prefix (the dq kernel's
                  Δ, two launches bit-identical, invisible keys' dk/dv
                  exactly 0, the dk/dv schedule against its plain
                  version).
 34. <arch> serve — half depth (STEP_LOOP_SERVE_DEPTH: Seamless 12 + 12
                  layers, Phi-3 16), bf16: Seamless's encoder over its 1024
                  frames drawn from the seed and each decoder layer's
                  cross K/V; one rollout group (prompt 1024, K 8, 64 new
                  tokens; enc_len 0, as the reference's) and the
                  multi-turn session (Seamless: the cross K/V loaded and
                  tiled by the fork), prefilled through the step loop
                  (a CUDA graph a step); prefill and decode tokens/s, the
                  decode bound, a profiled decode step; no kernel launch.
 35. <arch> serve parity — 256 tokens teacher-forced, the step loop vs
                  the packed forward: Seamless at 4 + 4 layers f32 over
                  the same frames (atol = rtol = 5e-4), then a
                  ``load_cross`` after the graph was captured must move
                  the later logits (relative L2 > 1e-2) and match an
                  eager step loop making the same swap (5e-4); phase
                  34's depth in bf16 reported.  Phi-3 at 4 layers f32: its step loop vs
                  the forward of its text decoder (5e-4).
 36. <arch> train, <arch> determinism — phase 6 (no baseline timing) on
                  MM_TRAIN_GEN trees: 2 SFT + 1 RL steps, 2 rows of 4096,
                  frontend rows drawn by the planner; Seamless at full
                  depth, Phi-3 with ``remat="full"`` at the deepest cut
                  ``fit_depth`` gives under TRAIN_LIMIT, reckoning each
                  layer's saved input and one recomputed layer's
                  ``act_bytes`` (printed; all 32 layers), its peak within
                  PEAK_LIMIT; each kernel once a decoder layer a step (the
                  forward twice under remat), 0 trees dropped; then phase
                  7's check on a packed plan.
 37. <arch> train parity — 4 layers f32 (Seamless: 4 + 4) on one row of
                  2048 behind frontend rows: (a) kernel vs plain, loss and
                  grads max-rel 1e-4; (b) tree vs per-branch baseline,
                  loss 5e-6, grads 1e-4; (c) (a) again under
                  ``remat="full"``: loss and every gradient leaf
                  torch.equal.
 38. timing V, timing S2 — phase 11's training-shape timing at V and S2.

The line before the last names the card and its power limit; the one before
it lists the kernels (each with its MoE-shape numbers under ``moe``, its
W numbers under ``wave``, the rl loops' launches (per train step, in
generation; Zamba2's too) under ``rl``, the five archs' layouts under
``archs``,
Zamba2's layout, the SSM wave steps' launches and ZW under ``ssm``, the
enc-dec and VLM archs' launches and the V and S2 timings under ``mm``,
the data, model and expert parallel phases' launches under
``data_parallel``, ``model_parallel`` and ``expert_parallel``, and every
instance its source built, with
registers, spills, HGMMA and UTMALDG, under ``instances``); the
last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 2.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import faulthandler
import gzip
import json
import math
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.analysis import mask_check  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.gateway import (  # noqa: E402
    packed_partitioned_value_and_grad)
from repro_torch.core.packing import pack_linear_paths, pack_trees  # noqa: E402
from repro_torch.core.partition import partition_tree  # noqa: E402
from repro_torch.core.tree import (TrajectoryTree, TreeNode,  # noqa: E402
                                   serialize_tree)
from repro_torch.data.loader import LoaderConfig, tree_stream  # noqa: E402
from repro_torch.data.synthetic import agentic_tree, random_tree  # noqa: E402
from repro_torch.device import flatten_tree, map_tree, tree_leaves  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.kernels import tree_attention_bwd as tab  # noqa: E402
from repro_torch.kernels.ref import (tree_attention_bwd_ref,  # noqa: E402
                                     tree_attention_ref_ext)
from repro_torch.launch import rl_loop  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import moe as moe_layer  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import logits_from_hidden  # noqa: E402
from repro_torch.models.model import (batch_arrays,  # noqa: E402
                                      init_params, layer_groups,
                                      chunk_size_of, prepare_batch)
from repro_torch.serve import decode  # noqa: E402
from repro_torch.serve.rollout import (RolloutConfig, rollout_group,  # noqa: E402
                                       sample_tokens)
from repro_torch.serve import service  # noqa: E402
from repro_torch.serve.service import WeightStore  # noqa: E402
from repro_torch.serve.session import (CAPTURE_LOCK,  # noqa: E402
                                       DecodeSession, GraphPool)
from repro_torch.train import engine as train_engine  # noqa: E402
from repro_torch.train.engine import (ExecutionPlan, PackedExec,  # noqa: E402
                                      TreeTrainEngine)
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.planner import PlannerConfig, plans  # noqa: E402
from repro_torch.train.train_step import update, value_and_grad  # noqa: E402
from repro_torch.train.warmup import AOTWarmupService  # noqa: E402

BIG = 1 << 30
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL_F32 = 1e-4                # f32 sums in another order on the card
TOL_BF16_PLAIN = 2e-2         # against the plain version run in bf16
TOL_BWD_L2 = 1e-2             # bf16 backward: relative L2 per output
TOL_BWD_ELEM = 5e-2           # bf16 backward: 5e-2 + 5e-2·|ref| per element
SOURCES = (ta.SOURCE, *tab.SOURCES)
# each source's Hopper instances (kernel, head dim), by the head dims each
# kernel's bf16 path takes (kernel_path): all three at hd 64, 96, 128 and
# 192
HOPPER_INSTANCES = {src: [(kern, hd) for hd in ta.HOPPER_PATH_HEAD_DIMS[kern]]
                    for src, kern in zip(SOURCES, ("fwd", "dq", "dkv"))}
KERNELS = {"tree_attention_fwd": ta.tree_attention,
           "tree_attention_bwd_dq": tab.bwd_dq,
           "tree_attention_bwd_dkv": tab.bwd_dkv}
# the training phase: 2 rows of 4096, 4 agentic trees per generator batch
TRAIN_ROWS, TRAIN_SEQ, SFT_STEPS, RL_STEPS = 2, 4096, 4, 2
TRAIN_GEN = dict(num_turns=3, turn_len_range=(64, 256))
# Tree Packing over partitions: trees of 6k-16k unique tokens (agentic,
# longer turns), nearly all larger than a row of 4096, trained through the
# planner (auto partition, auto capacity, lookahead 2, grafting on), 2
# trees per generator batch, rows of TRAIN_SEQ, at most TRAIN_ROWS rows a
# wave; the wave parity tree is partitioned at 2048 and also run whole in
# one row of 8192
WAVE_GEN = dict(num_turns=3, turn_len_range=(256, 1536), max_parallel_tools=2)
WAVE_BATCHES, WAVE_TREES, WAVE_SEED, WAVE_LOOKAHEAD = 4, 2, 1, 2
WAVE_MIN_ANC = 2048           # some gateway wave must carry this many
# the data parallel phase: (a)'s steps on the axis; (b)'s world of 2:
# depth (f32), steps (a packed plan, then a wave plan), and how long a
# rank may take before the run fails
DP_WORLD1_STEPS = 3
DP_LAYERS, DP_STEPS, DP_TIMEOUT_S = 4, 2, 300
# the model parallel part of (b)'s ranks: a (data 1, model 2) mesh, the
# bf16 check's depth, its plans' rows of MP_SEQ (every block boundary's
# collective goes through the host over gloo on one card), the wave
# plan's trees and capacity, and the head layouts the model axis gives
# the kernels ((H, Kh) at hd 128: Qwen2-1.5B at model 2, Qwen3-8B at 4)
MP_SHAPE, MP_BF16_LAYERS, MP_SEQ = (1, 2), 8, 1024
MP_PACKED_GEN = dict(num_turns=3, turn_len_range=(16, 64))
MP_WAVE_GEN = dict(num_turns=3, turn_len_range=(64, 256),
                   max_parallel_tools=2)
MP_HEADS = ((6, 1), (8, 2))
PARITY_CAP, PARITY_ROW, PARITY_TOKENS = 2048, 8192, (6000, 8000)
# the async tree-RL loop (rl_loop.main), Qwen2-1.5B: RL_K branches on a
# prompt of RL_PROMPT, RL_LOOP_STEPS steps at --max-ahead 1 (steps
# RL_PROFILE profiled, both threads live; RL_GAPS longest idle gaps listed)
# and RL_LOOP_STEPS_A0 on-policy; --groups and --max-new are the most
# generation a step whose groups take at most 1/RL_TRAIN_OVER_GEN of a
# train step (by this run's serve and train phases), max_new from
# RL_MAX_NEW; rl parity's
# concurrent group decodes RL_PARITY_NEW tokens beside RL_PARITY_STEPS
# train steps.  The generator's thread name tells its launches and syncs
# from the trainer's.
RL_ARCH, RL_K, RL_PROMPT = "qwen2_1p5b", 8, 1024
RL_LOOP_STEPS, RL_LOOP_STEPS_A0 = 6, 3
RL_PROFILE, RL_GAPS, RL_TRAIN_OVER_GEN = (3, 4), 8, 1.2
RL_MAX_NEW = (64, 48, 32, 24, 16, 12, 8, 4)
RL_PARITY_NEW, RL_PARITY_STEPS = 64, 2
# rl parity (b'): the GPU clock cycles its stream sleeps (about 3 s at the
# H100's 1.98 GHz boost) before its decode steps read the snapshot
RL_HOLD_CYCLES = 6_000_000_000
RL_GEN_THREAD = "tree-rl-gen"
# the MoE model (Qwen3-30B-A3B): its attention heads and the depth it
# trains at; a serving run's weights and work may take PEAK_LIMIT of the
# card, 6 GB of it for the caches, activations and parity replays
MOE_ARCH, MOE_HEADS, MOE_TRAIN_LAYERS = "qwen3_30b_a3b", (32, 4), 2
# the expert parallel phase: the MoE model on a (data 1, model 2) mesh at
# MOE_TRAIN_LAYERS layers, 2 rows of MP_SEQ, spawned ranks that may take
# EP_TIMEOUT_S; the head layouts the model axis gives its kernels ((H, Kh)
# at hd 128: model 2 and model 4)
EP_SHAPE, EP_TIMEOUT_S = (1, 2), 240
# (b)'s bar: the bf16 gradient's relative L2 of world 1's
EP_BF16_L2 = 5e-2
EP_HEADS = ((16, 2), (8, 1))
PEAK_LIMIT, SERVE_WORK = 75e9, 6e9
# the rest of the dense and MoE archs: each serves at the deepest cut that
# fits and is held in f32 at up to PARITY_LAYERS layers; Qwen3-32B also
# trains at the deepest cut whose bf16 weights, fp32 grads and AdamW state
# (14 bytes a parameter) and saved activations (TRAIN_ACT_BYTES a layer at
# 2 rows of 4096) fit TRAIN_LIMIT, 2 SFT steps and 1 RL step
ARCHS = ("qwen3_8b", "qwen3_32b", "llama4_scout_17b_a16e", "kimi_k2_1t_a32b",
         "nemotron_4_340b")
TRAIN_ARCH, TRAIN_LIMIT, TRAIN_ACT_BYTES = "qwen3_32b", 60e9, 1.9e9
PARITY_LAYERS = 4
# the SSM and hybrid archs, each at full width: served (one rollout group
# and the session, prefilled through the step loop, at
# STEP_LOOP_SERVE_DEPTH of their depth), teacher-forced step loop vs
# packed forward (SSM_PARITY_TOKENS, f32 and bf16 at that depth and at
# PARITY_LAYERS layers), trained on chunk-aligned
# rows (SSM_SFT_STEPS + RL_STEPS), held tree vs baseline at PARITY_LAYERS
# layers in f32, and checked for deterministic grads; Zamba2's shared
# attention block runs the three kernels at H 32/Kh 32, hd 64
SSM_ARCHS = ("rwkv6_1p6b", "qwen3p5_gdn_2b", "zamba2_1p2b")
HYBRID_ARCH, SSM_SFT_STEPS, SSM_PARITY_TOKENS = "zamba2_1p2b", 3, 256
# each SSM arch also trains SSM_WAVE_BATCHES generator batches of the waves
# phase's trees (6k-16k tokens) through chunk-aligned partition waves, at
# a quarter of its depth (SSM_WAVE_DEPTH of it), and holds its wave parity
# there on the weights those steps trained; its train phase runs at the
# same cut (SSM_TRAIN_DEPTH).  The partitions and waves depend on the
# trees' sizes only, not on the depth.  At full depth the three waves
# phases took 129 s of a 1276 s run on a slow host and the three train
# phases 119.0 s of a 1138.8 s run; at half depth a run on a slow host
# still passed the 1200 s limit.  Full-depth SSM training stays in the
# Zamba2 RL loop.
SSM_WAVE_BATCHES, SSM_WAVE_DEPTH = 3, 0.25
SSM_TRAIN_DEPTH = 0.25
# the archs whose sessions prefill through the step loop (the SSM, hybrid,
# enc-dec and VLM archs) serve, and hold the step loop against the
# forward, at this share of their depth: at full depth their five serve
# phases took 89.6 s of a 928.5 s run
STEP_LOOP_SERVE_DEPTH = 0.5
# their determinism check (a packed and a wave plan) runs at this cut, as
# deep as Zamba2's first two applications of its shared block need, to
# keep the script inside its time limit
SSM_DETERMINISM_LAYERS = 8
# control d of the SSM serve parity: each SSM mixer's step output x this
SSM_CONTROL_SCALE = 1.02
# the archs' head dims whose f32 (simple) kernels the arch phases hold at
# the archs' shapes: hd 192 (Nemotron-4 340B), which no other phase runs
# at a real size; hd 128's f32 path is held at Qwen2-1.5B's shapes
ARCH_F32_HEAD_DIMS = (192,)
# the enc-dec and VLM archs, at full width: each serves at
# STEP_LOOP_SERVE_DEPTH of its depth in bf16 (one rollout group and the session, prefilled through the step loop
# as the reference does; SeamlessM4T's encoder first runs over its
# frontend_len (1024) frames drawn from the seed and its session holds each decoder layer's
# cross K/V), trains MM_SFT_STEPS + MM_RL_STEPS steps on planner rows of
# MM_TRAIN_GEN trees (MM_TRAIN_TREES a batch: none larger than a row, so
# none dropped; these families do not partition), Seamless at full depth
# and Phi-3 at the deepest cut whose weights, fp32 grads and AdamW state
# and ``act_bytes`` a layer fit TRAIN_LIMIT, and is held in f32 at
# PARITY_LAYERS layers (Seamless: as many encoder layers)
ENCDEC_ARCH, VLM_ARCH = "seamless_m4t_large_v2", "phi3_vision_4p2b"
MM_SFT_STEPS, MM_RL_STEPS, MM_TRAIN_TREES = 2, 1, 6
MM_TRAIN_GEN = dict(num_turns=2, turn_len_range=(64, 256))
# a plain version runs on whole GQA groups of at most this many score
# elements (4 GB in f32) a call
PLAIN_CHUNK = 1 << 30
DEV = "cuda"
# the run's own limit, inside the 1200 s a caller allows it with its start-up
WATCHDOG_S = 1150
CARD = ""
# {source: {kernel instance: its ptxas and SASS numbers}}, from phase_build
INSTANCES: dict = {}
# the profile's kernel families, by a substring of the kernel's name; the
# first family that matches takes the kernel
PROFILE_FAMILIES = (
    ("tree attention (this repo's kernels)",
     ("_hopper_kernel", "tree_attention_", "dkv_schedule", "sum_parts")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("indexing, sort, scan (gathers, index_put, the MoE queue)",
     ("index", "Index", "Radix", "radix", "sort", "Sort", "scan", "Scan",
      "gather", "scatter")),
    ("copy, cast, fill, cat", ("copy", "Fill", "CatArray")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel",)))


def log(msg: str) -> None:
    print(f"{msg}  [{CARD}]", flush=True)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def pack_row(sers, S: int, fill: float = 1.0):
    """Serialized trees laid end to end in one row of S slots (kv_last
    shifted by each tree's offset), padded with invisible keys."""
    kv = np.full(S, -1, np.int64)
    pos = np.zeros(S, np.int64)
    off = 0
    for s in sers:
        if off + s.n > int(S * fill):
            continue
        kv[off:off + s.n] = np.where(s.kv_last >= 0, s.kv_last + off, -1)
        pos[off:off + s.n] = s.pos_ids
        off += s.n
    return kv, pos


def tree_rows(seed: int, B: int, S: int, fill: float = 0.75):
    rng = np.random.default_rng(seed)
    rows = [pack_row([serialize_tree(random_tree(
        rng, seg_len_range=(4, 48), max_depth=4)) for _ in range(8 * S // 64)],
        S, fill) for _ in range(B)]
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def randn(rng, shape, dtype) -> torch.Tensor:
    """N(0, 1) values of ``shape`` in ``dtype``, drawn in f32 on the card by
    a generator seeded from ``rng`` (drawing them on the host took tens of
    seconds a run)."""
    g = torch.Generator(DEV).manual_seed(int(rng.integers(1 << 62)))
    return torch.randn(tuple(shape), generator=g, device=DEV).to(dtype)


def qkv(rng, B, S, Skv, H, Kh, hd, dtype):
    return (randn(rng, (B, S, H, hd), dtype),
            randn(rng, (B, Skv, Kh, hd), dtype),
            randn(rng, (B, Skv, Kh, hd), dtype))


def i32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=DEV)


def tool_kv_last() -> np.ndarray:
    """kv_last of the session's tool-output prefill: 8 branches of 200 new
    tokens, each after 1056 cached keys that every query sees (q_off
    1056)."""
    return np.concatenate([np.full((8, 1056), BIG), np.full((8, 200), 1255)],
                          1)


def gateway(kv_main, pos_main, A: int, pad_rows):
    """The gateway layout models/attention.py assembles: A ancestors in
    front (kv_last 2^30, or −1 on front-padded rows), DFS indices shifted."""
    B = kv_main.shape[0]
    anc = np.full((B, A), BIG, np.int64)
    for r, p in enumerate(pad_rows):
        anc[r, :p] = -1
    kl = np.concatenate([anc, np.where(kv_main >= 0, kv_main + A, -1)], 1)
    pos_q = pos_main + A
    pos_k = np.concatenate([np.tile(np.arange(A), (B, 1)), pos_q], 1)
    return kl, pos_q, pos_k


def case_adder(rng, cases: list):
    """``add(name, dtype, B, S, H, Kh, hd, kv_last, ...)`` appends a kernel
    case (name, dtype, q, k, v, kv_last, q_off, window, pos_q, pos_k) with
    q/k/v drawn from ``rng``."""
    def add(name, dt, B, S, H, Kh, hd, kl, q_off=0, window=None, pq=None,
            pk=None):
        q, k, v = qkv(rng, B, S, kl.shape[1], H, Kh, hd, dt)
        cases.append((name, dt, q, k, v, i32(kl), q_off, window,
                       None if pq is None else i32(pq),
                       None if pk is None else i32(pk)))
    return add


def kernel_cases(train_kv_last=None, tp_kv_last=None):
    """(name, dtype, q, k, v, kv_last, q_off, window, pos_q, pos_k).  With
    ``tp_kv_last`` the model axis's head layouts (MP_HEADS) on those rows,
    f32 and bf16; with ``train_kv_last`` the training shape T (its real
    kv_last) comes last."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    add = case_adder(np.random.default_rng(0), cases)

    kl, pos = tree_rows(1, 2, 2048)
    add("trees MHA f32", f32, 2, 2048, 8, 8, 64, kl)
    add("trees GQA 12/2 bf16", bf16, 2, 2048, 12, 2, 128, kl)
    add("trees MQA f32", f32, 2, 2048, 8, 1, 128, kl)
    pad = np.full((1, 1024), -1)
    pad[0, :300] = 299
    add("padding keys f32", f32, 1, 1024, 12, 2, 128, pad)
    kl2, pos2 = tree_rows(2, 2, 512)
    for A, rows in ((64, (0, 7)), (20, (5, 0))):
        g, pq, pk = gateway(kl2, pos2, A, rows)
        for dt in (f32, bf16):
            add(f"gateway A={A} {dt}", dt, 2, 512, 12, 2, 128, g, q_off=A)
    add("window 32 x branching f32", f32, 2, 2048, 12, 2, 128, kl,
        window=32, pq=pos, pk=pos)
    g, pq, pk = gateway(kl2, pos2, 20, (9, 0))
    add("gateway A=20 window 16 bf16", bf16, 2, 512, 12, 2, 128, g,
        q_off=20, window=16, pq=pq, pk=pk)
    for hd in ta.HEAD_DIMS:
        g, _, _ = gateway(kl2[:, :200], pos2[:, :200], 20, (3, 0))
        for dt in (f32, bf16):
            add(f"head dim {hd} {dt}", dt, 2, 200, 4, 2, hd, g, q_off=20)
    trng = np.random.default_rng(3)
    sers = [serialize_tree(agentic_tree(trng, turn_len_range=(32, 256)))
            for _ in range(40)]
    akl, _ = pack_row(sers, 4096)
    add("agentic row S=4096 bf16", bf16, 1, 4096, 12, 2, 128, akl[None])
    add("path: prefill S=1024 bf16", bf16, 1, 1024, 12, 2, 128,
        np.full((1, 1024), 1023))
    add("path: tool prefill S=200 q_off=1056 bf16", bf16, 8, 200, 12, 2, 128,
        tool_kv_last(), q_off=1056)
    if tp_kv_last is not None:
        B, S = tp_kv_last.shape
        for H, Kh in MP_HEADS:
            for dt in (f32, bf16):
                add(f"model axis H {H}/Kh {Kh} on T (B={B}, S={S}) {dt}", dt,
                    B, S, H, Kh, 128, tp_kv_last)
    if train_kv_last is not None:
        B, S = train_kv_last.shape
        add(f"train shape T (B={B}, S={S}) bf16", bf16, B, S, 12, 2, 128,
            train_kv_last)
    return cases


def moe_kernel_cases(train_kv_last):
    """The MoE model's attention (H 32, Kh 4: a GQA group of 8, hd 128): a
    gateway case in f32 and bf16, the serving path's prefill and tool
    prefill, the model axis's head layouts (EP_HEADS: a rank's heads at
    model 2 and 4) on the MoE training rows in f32 and bf16, and the MoE
    training shape T (its real kv_last) last."""
    f32, bf16 = torch.float32, torch.bfloat16
    H, Kh = MOE_HEADS
    cases = []
    add = case_adder(np.random.default_rng(20), cases)
    kl, _ = tree_rows(21, 2, 512)
    g, _, _ = gateway(kl, np.zeros_like(kl), 37, (5, 0))
    for dt in (f32, bf16):
        add(f"H {H}/Kh {Kh}: trees + gateway A=37 {dt}", dt, 2, 512, H, Kh,
            128, g, q_off=37)
    add(f"H {H}/Kh {Kh} path: prefill S=1024 bf16", bf16, 1, 1024, H, Kh,
        128, np.full((1, 1024), 1023))
    add(f"H {H}/Kh {Kh} path: tool prefill S=200 q_off=1056 bf16", bf16, 8,
        200, H, Kh, 128, tool_kv_last(), q_off=1056)
    B, S = train_kv_last.shape
    for h, kh in EP_HEADS:
        for dt in (f32, bf16):
            add(f"model axis H {h}/Kh {kh} on T_moe (B={B}, S={S}) {dt}", dt,
                B, S, h, kh, 128, train_kv_last)
    add(f"H {H}/Kh {Kh} MoE train shape T (B={B}, S={S}) bf16", bf16, B, S,
        H, Kh, 128, train_kv_last)
    return cases


def arch_layouts() -> list:
    """[(archs, H, Kh, hd)]: each attention layout of ARCHS once, with
    the archs that run it."""
    out: dict = {}
    for arch in ARCHS:
        a = get_config(arch).attn
        out.setdefault((a.n_heads, a.n_kv_heads, a.head_dim), []).append(arch)
    return [(names, *lay) for lay, names in out.items()]


def layout_tag(H: int, Kh: int, hd: int) -> str:
    return f"H {H}/Kh {Kh} hd {hd}"


def bf16_paths(hd: int) -> str:
    """Which path each kernel's bf16 instance takes at head dim ``hd``."""
    return ", ".join(f"{kern} {ta.kernel_path(kern, torch.bfloat16, hd)}"
                     for kern in ("fwd", "dq", "dkv"))


def arch_kernel_cases(train_kv_last):
    """Each layout of ``arch_layouts`` at the serving prefill shape (S
    1024, B 1), the session's tool prefill (B 8, S 200 after 1056 cached
    keys: the q_off path) and the train rows (``train_kv_last``: B 2, S
    4096, real kv_last), in bf16 (the Hopper paths) and, at the head dims
    of ARCH_F32_HEAD_DIMS, in f32 too: the simple kernels' accuracy
    path."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    add = case_adder(np.random.default_rng(40), cases)
    B, S = train_kv_last.shape
    tool = tool_kv_last()
    for names, H, Kh, hd in arch_layouts():
        lay = (f"{layout_tag(H, Kh, hd)} ({', '.join(names)}; bf16 paths: "
               f"{bf16_paths(hd)})")
        for dt in (bf16, f32) if hd in ARCH_F32_HEAD_DIMS else (bf16,):
            add(f"{lay} path: prefill S=1024 {dt}", dt, 1, 1024, H, Kh, hd,
                np.full((1, 1024), 1023))
            add(f"{lay} path: tool prefill S=200 q_off=1056 {dt}", dt, 8, 200,
                H, Kh, hd, tool, q_off=1056)
            add(f"{lay} train rows (B={B}, S={S}) {dt}", dt, B, S, H, Kh, hd,
                train_kv_last)
    return cases


def close(a: torch.Tensor, b: torch.Tensor, tol: float):
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool(torch.isfinite(a).all()) and bool(
        (err <= tol + tol * b.abs()).all())
    return ok, float(err.max())


def close_bf16(o: torch.Tensor, ref: torch.Tensor):
    """A bf16 kernel output against the plain version computed in f32 from
    the same bf16 inputs.  The kernel keeps fp32 logits and accumulators
    and rounds only P (to bf16, before P·V) and o, so each element must lie
    within 2^-7 of itself (o's rounding, with margin) plus 2e-2 of its
    row's rms over hd (P's rounding: ~2^-8/√3 of the rms per element, so
    2e-2 is about 5 standard deviations with margin).  A dropped live tile
    moves whole rows by tens of per cent of their rms.  Returns (ok, max
    abs error, max error over row rms)."""
    o, ref = o.float(), ref.float()
    err = (o - ref).abs()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    ok = bool(torch.isfinite(o).all()) and bool(
        (err <= 2 ** -7 * ref.abs() + 2e-2 * rms).all())
    rel = float(torch.where(err > 0, err / rms, 0.0).max())
    return ok, float(err.max()), rel


def kv_head_chunks(q, k) -> list:
    """(query-head slice, kv-head slice) pairs of whole GQA groups, each
    with at most PLAIN_CHUNK dense scores [B, Kh', G, S, Skv]: the plain
    versions materialise them, and a group's heads see no other group's
    keys, so the chunks' results are the whole call's."""
    B, S, H, _ = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    per = max(1, PLAIN_CHUNK // (B * G * S * Skv))
    return [(slice(j * G, min(j + per, Kh) * G), slice(j, min(j + per, Kh)))
            for j in range(0, Kh, per)]


def plain(q, k, v, *args, f32: bool = False, **kw):
    """The kernel's plain version, in the inputs' dtype or (``f32``) in f32
    from the same values; by whole GQA groups where the dense scores would
    pass PLAIN_CHUNK."""
    if f32:
        q, k, v = q.float(), k.float(), v.float()
    chunks = kv_head_chunks(q, k)
    if len(chunks) == 1:
        return tree_attention_ref_ext(q, k, v, *args, **kw)
    parts = [tree_attention_ref_ext(q[:, :, hs], k[:, :, ks], v[:, :, ks],
                                    *args, **kw) for hs, ks in chunks]
    if kw.get("return_lse"):
        return (torch.cat([p[0] for p in parts], 2),
                torch.cat([p[1] for p in parts], 1))
    return torch.cat(parts, 2)


def plain_bwd(q, k, v, kv_last, o, lse, do, scale, **kw):
    """The backward kernels' plain version (``tree_attention_bwd_ref``),
    by whole GQA groups where the dense scores would pass PLAIN_CHUNK."""
    chunks = kv_head_chunks(q, k)
    if len(chunks) == 1:
        return tree_attention_bwd_ref(q, k, v, kv_last, o, lse, do, scale,
                                      **kw)
    parts = [tree_attention_bwd_ref(q[:, :, hs], k[:, :, ks], v[:, :, ks],
                                    kv_last, o[:, :, hs], lse[:, hs],
                                    do[:, :, hs], scale, **kw)
             for hs, ks in chunks]
    return tuple(torch.cat([p[i] for p in parts], 2) for i in range(3))


def hold(tag: str, o, ref32, lse=None, lse32=None, o_bf16=None,
         lse_bf16=None) -> float:
    """Check the kernel's o (and lse) against the plain version computed in
    f32 (``ref32``/``lse32``), and a bf16 kernel also against the plain
    version run in bf16 (``o_bf16``/``lse_bf16``).  Logs the errors and
    returns o's max abs error against the f32 plain version."""
    if o.dtype == torch.float32:
        ok, e = close(o, ref32, TOL_F32)
        txt = f"o max_abs_err {e:.3e} (tol {TOL_F32:g})"
    else:
        ok, e, rel = close_bf16(o, ref32)
        txt = (f"o max_abs_err {e:.3e}, max err/row rms {rel:.3e} (tol "
               f"2^-7|ref| + 2e-2 rms)")
    if lse is not None:
        ok_l, el = close(lse, lse32, TOL_F32)
        ok = ok and ok_l
        txt += f", lse max_abs_err {el:.3e} (tol {TOL_F32:g})"
    if o.dtype == torch.bfloat16:
        ok_b, eb = close(o, o_bf16, TOL_BF16_PLAIN)
        txt += f"; vs plain in bf16: o {eb:.3e}"
        if lse is not None:
            ok_bl, ebl = close(lse, lse_bf16, TOL_BF16_PLAIN)
            ok_b = ok_b and ok_bl
            txt += f", lse {ebl:.3e}"
        ok = ok and ok_b
        txt += f" (tol {TOL_BF16_PLAIN:g})"
    log(f"kernel vs plain (f32): {tag}: {txt}")
    check(ok, f"kernel disagrees with plain on {tag}")
    return e


def hold_bwd(tag: str, got, want) -> dict:
    """Check dq/dk/dv of the backward kernels against the plain backward in
    f32: f32 outputs within 1e-4 (atol and rtol); bf16 outputs at relative
    L2 ≤ 1e-2 each and every element within 5e-2 + 5e-2·|ref| (the
    reference's bf16 bar, tests/test_kernels_bwd.py:235).  Logs the errors
    and returns each output's max abs error, by name."""
    ok, errs, parts = True, {}, []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if a.dtype == torch.float32:
            good, e = close(a, b, TOL_F32)
            parts.append(f"{name} {e:.3e}")
        else:
            a, b = a.float(), b.float()
            err = (a - b).abs()
            e = float(err.max())
            rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
            good = (bool(torch.isfinite(a).all()) and rel <= TOL_BWD_L2
                    and bool((err <= TOL_BWD_ELEM + TOL_BWD_ELEM
                              * b.abs()).all()))
            parts.append(f"{name} {e:.3e} (rel L2 {rel:.2e})")
        ok = ok and good
        errs[name] = e
    tol = (f"tol {TOL_F32:g}" if got[0].dtype == torch.float32 else
           f"tol rel L2 {TOL_BWD_L2:g}, {TOL_BWD_ELEM:g} + "
           f"{TOL_BWD_ELEM:g}|ref|")
    log(f"bwd kernels vs plain (f32): {tag}: max_abs_err "
        f"{', '.join(parts)} ({tol})")
    check(ok, f"backward kernels disagree with plain on {tag}")
    return errs


def hold_dq_delta(tag, q, k, v, kl, o, lse, do, sc, kw, dq_bwd) -> None:
    """The dq kernel's Hopper path alone, twice: its Δ against the plain
    ``delta`` at 1e-5 of Σ_d |do·o| per row (the same exact fp32 products
    of bf16 values summed in another order), dq and Δ bit-identical over
    the two launches and equal to the backward's dq, dq exactly 0 on rows
    that see no key (lse = −1e30)."""
    dq, dl = tab.bwd_dq(q, k, v, kl, o, lse, do, sc, **kw)
    dq2, dl2 = tab.bwd_dq(q, k, v, kl, o, lse, do, sc, **kw)
    torch.cuda.synchronize()
    want = tab.delta(o, do)
    mag = (do.float() * o.float()).abs().sum(-1).transpose(1, 2)
    err = float(((dl - want).abs() / mag.clamp_min(1e-30)).max())
    same = torch.equal(dq, dq2) and torch.equal(dl, dl2) and torch.equal(
        dq, dq_bwd)
    masked = (lse <= -1e29).transpose(1, 2)
    zero = not bool(dq[masked].any())
    log(f"dq kernel's Δ vs plain delta: {tag}: max |err| / Σ|do·o| "
        f"{err:.3e} (tol 1e-5); dq and Δ bit-identical over two launches "
        f"{same}; dq exactly 0 on the {int(masked.sum())} (row, head) pairs "
        f"that see no key {zero}")
    check(bool(torch.isfinite(dl).all()) and err <= 1e-5,
          f"{tag}: the dq kernel's Δ disagrees with delta()")
    check(same, f"{tag}: two dq launches differ")
    check(zero, f"{tag}: dq nonzero on a row that sees no key")


def skip_fraction(kl, S, q_off, window, pq, pk) -> float:
    B = kl.shape[0]
    kl, pq, pk = (None if t is None else t.cpu().numpy() for t in (kl, pq, pk))
    live = [ta.block_live_mask(kl[b], S, q_off=q_off, window=window,
                               pos_q=None if pq is None else pq[b],
                               pos_k=None if pk is None else pk[b])
            for b in range(B)]
    return 1.0 - float(np.mean([m.mean() for m in live]))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def ptxas_report(log_txt: str, sass: dict = None):
    """[(kernel instance, registers, spill store bytes, spill load bytes,
    wgmma and TMA-load instructions in its SASS or None)] from ``nvcc
    -Xptxas -v`` output, names demangled where c++filt exists."""
    rows, name, spills = [], None, (0, 0)
    for line in log_txt.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            w = line.replace(",", " ").split()
            spills = (int(w[w.index("spill") - 2]),
                      int(w[len(w) - 1 - w[::-1].index("spill") - 2]))
        elif "Used" in line and "registers" in line and name:
            rows.append((name, int(line.split("Used")[1].split()[0]),
                         *spills, (sass or {}).get(name)))
            name, spills = None, (0, 0)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        if len(names) == len(rows):
            rows = [(n.replace("(anonymous namespace)::", "").split("(")[0]
                     .removeprefix("void "), *r[1:])
                    for n, r in zip(names, rows)]
    except (OSError, subprocess.CalledProcessError):
        pass
    return rows


def sass_counts(lib: Path) -> dict:
    """{mangled kernel name: (wgmma, TMA load) instruction counts} in the
    library's SASS (HGMMA and UTMALDG), from cuobjdump beside nvcc; empty
    where cuobjdump is missing."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    try:
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            out[name] = [0, 0]
        elif name is not None:
            out[name][0] += "HGMMA" in line
            out[name][1] += "UTMALDG" in line
    return {k: tuple(v) for k, v in out.items()}


def phase_build() -> float:
    t0 = time.perf_counter()
    built = build.build_all(SOURCES)
    total = time.perf_counter() - t0
    for src, (lib, dt) in built.items():
        rows = ptxas_report(lib.with_suffix(".log").read_text(),
                            sass_counts(lib))
        log(f"build: {src} -> {lib.name} in {dt:.2f} s; {len(rows)} kernel "
            f"instances, max {max(r[1] for r in rows)} registers, "
            f"{sum(r[2] for r in rows)} bytes spill stores in all")
        for name, regs, st, ld, sass in rows:
            INSTANCES.setdefault(src, {})[name] = dict(
                registers=regs, spill_store_bytes=st, spill_load_bytes=ld,
                hgmma=None if sass is None else sass[0],
                utmaldg=None if sass is None else sass[1])
            ins = ("" if sass is None else
                   f"; SASS: {sass[0]} HGMMA (wgmma), {sass[1]} UTMALDG (TMA)")
            log(f"build:   {name}: {regs} registers, {st} bytes spill stores, "
                f"{ld} bytes spill loads{ins}")
            if "_hopper_kernel<" in name:
                check(st == ld == 0, f"{name} spills")
                check(sass is None or (sass[0] > 0 and sass[1] > 0),
                      f"{name}: no wgmma or no TMA load in its SASS")
        for kern, hd in HOPPER_INSTANCES[src]:
            # demangled, or mangled where c++filt is missing
            forms = (f"{kern}_hopper_kernel<{hd}>",
                     f"{kern}_hopper_kernelILi{hd}E")
            check(any(f in r[0] for r in rows for f in forms),
                  f"{src}: no {forms[0]} in ptxas's report")
    log(f"build: {len(SOURCES)} sources, one nvcc {' '.join(build.NVCC_FLAGS)}"
        f" each, all started together: {total:.2f} s in all")
    return total


def phase_warm_restart() -> dict:
    """A fresh process over the build directory ``phase_build`` filled
    (``python -m repro_torch.train.warmup --persist-probe``): it must build
    nothing (0 new files there), prewarm a tiny plan stream and run one
    engine step with 0 retraces.  Returns the probe's record."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.train.warmup",
                        "--persist-probe", str(build.BUILD_DIR)], env=env,
                       cwd=root, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"warm restart: the probe failed "
                             f"({r.returncode}): {r.stderr[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    log(f"warm restart: a fresh process over {out['cache_dir']}: "
        f"{out['new_cache_files']} new files, {out['aot_executables']} "
        f"executables made in {out['compile_s']} s (prewarm "
        f"{out['prewarm_s']} s), {out['retraces']} retraces, first engine "
        f"step {out['step1_ms']} ms, loss {out['loss']:.4f}; the probe "
        f"{out['wall_s']} s, the process {wall:.2f} s with its start and "
        f"imports")
    check(out["new_cache_files"] == 0,
          f"warm restart: {out['new_cache_files']} new files in the build "
          f"directory")
    check(out["retraces"] == 0, f"warm restart: {out['retraces']} retraces")
    check(math.isfinite(out["loss"]), "warm restart: non-finite loss")
    return out


def phase_kernel(cases, with_prefill_attention: bool = True) -> float:
    worst = 0.0
    with torch.inference_mode():
        for name, dt, q, k, v, kl, q_off, window, pq, pk in cases:
            kw = dict(q_off=q_off, window=window, pos_q=pq, pos_k=pk)
            sc = q.shape[-1] ** -0.5
            o, lse = ops.tree_attention(q, k, v, kl, sc, save_residuals=True,
                                        **kw)
            torch.cuda.synchronize()
            ro, rl = plain(q, k, v, kl, sc, f32=True, return_lse=True, **kw)
            bo = bl = None
            if dt == torch.bfloat16:
                bo, bl = plain(q, k, v, kl, sc, return_lse=True, **kw)
            skip = skip_fraction(kl, q.shape[1], q_off, window, pq, pk)
            worst = max(worst, hold(f"{name} (block-skip fraction "
                                    f"{skip:.3f})", o, ro, lse, rl, bo, bl))
        if not with_prefill_attention:
            return worst
        # prefill_attention: no context, context, an invalid context row
        rng = np.random.default_rng(5)
        B, A, S, H, Kh, hd = 2, 300, 500, 12, 2, 128
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(rng, B, A + S, A + S, H, Kh, hd, dt)
            sc = hd ** -0.5
            out0 = ops.prefill_attention(q, k, v, sc)
            # the kernel takes contiguous tensors: split into new ones
            qn, kn, vn, kc, vc = (t.contiguous() for t in (
                q[:, A:], k[:, A:], v[:, A:], k[:, :A], v[:, :A]))
            out1 = ops.prefill_attention(
                qn, kn, vn, sc, ctx_k=kc, ctx_v=vc,
                ctx_valid=torch.ones(B, A, dtype=torch.bool, device=DEV))
            valid = torch.ones(B, A, dtype=torch.bool, device=DEV)
            valid[:, 7] = False
            out2 = ops.prefill_attention(qn, kn, vn, sc, ctx_k=kc, ctx_v=vc,
                                         ctx_valid=valid)
            keep = [i for i in range(A + S) if i != 7]

            def refs(f32):
                full = plain(q, k, v, i32(np.full((B, A + S), A + S - 1)),
                             sc, f32=f32)
                drop = plain(q[:, A:], k[:, keep], v[:, keep],
                             i32(np.full((B, A + S - 1), A + S - 2)), sc,
                             q_off=A - 1, f32=f32)
                return full, full[:, A:], drop

            tags = ("no context", "context", "invalid context row")
            for tag, out, r32, rdt in zip(tags, (out0, out1, out2),
                                          refs(True), refs(False)):
                worst = max(worst, hold(f"prefill_attention {tag} {dt}",
                                        out, r32, o_bf16=rdt))
    return worst


def phase_bwd_kernel(cases) -> dict:
    """The dq and dk/dv kernels on the forward's cases and a training shape
    T, from the forward kernel's own o and lse.  Returns each kernel's
    largest max abs error over the cases: dq's for the dq kernel, dk's and
    dv's for the dk/dv kernel."""
    worst = {"dq": 0.0, "dkv": 0.0}
    rng = np.random.default_rng(4)
    with torch.inference_mode():
        for name, dt, q, k, v, kl, q_off, window, pq, pk in cases:
            kw = dict(q_off=q_off, window=window, pos_q=pq, pos_k=pk)
            sc = q.shape[-1] ** -0.5
            do = randn(rng, q.shape, dt)
            o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True,
                                       **kw)
            got = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc, **kw)
            again = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc, **kw)
            torch.cuda.synchronize()
            want = plain_bwd(q.float(), k.float(), v.float(), kl, o.float(),
                             lse, do.float(), sc, **kw)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            dead = kl < 0                   # keys no query sees
            zero = not bool(got[1][dead].any()) and not bool(got[2][dead].any())
            skip = skip_fraction(kl, q.shape[1], q_off, window, pq, pk)
            anc = ""
            if q_off:
                a_max = float(got[1][:, :q_off].float().abs().max())
                anc = f", ancestor dk max |.| {a_max:.3e}"
                check(a_max > 0, f"{name}: ancestor dk is all zero")
            errs = hold_bwd(
                f"{name} (block-skip fraction {skip:.3f}; two launches "
                f"bit-identical {same}; invisible keys' dk/dv exactly 0 "
                f"{zero}{anc})", got, want)
            if tab.fuses_delta(q):
                hold_dq_delta(name, q, k, v, kl, o, lse, do, sc, kw,
                              got[0])
            if ta.kernel_path("dkv", dt, q.shape[-1]) == "hopper":
                # the dk/dv launch's schedule pass against its plain version
                order = tab.dkv_order(kl, q.shape[1], q_off)
                check(torch.equal(order, tab.dkv_schedule(kl, q.shape[1],
                                                          q_off)[2]),
                      f"{name}: the dk/dv schedule differs from its plain "
                      f"version")
            worst["dq"] = max(worst["dq"], errs["dq"])
            worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"])
            check(same, f"{name}: two launches of the backward differ")
            check(zero, f"{name}: invisible keys got nonzero dk/dv")
            del got, again, want
    return worst


def mask_cases():
    """Cases with whole key tiles that no query tile of their row sees, at
    H 4/Kh 2, for each kernel path: bf16 at the Hopper head dims and f32
    (the simple kernels) at hd 64 and 128.  Padding tails (trees fill 55%
    of rows of 1024, the rest kv_last −1); a gateway wave whose first 192
    and 81 ancestor slots are padding (q_off 256); and 1024 ancestors
    under a window of 128 (q_off 1024: the old ancestor tiles lie out of
    every query's window)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    add = case_adder(np.random.default_rng(50), cases)
    pad, _ = tree_rows(51, 2, 1024, fill=0.55)
    g, _, _ = gateway(*tree_rows(52, 2, 512), 256, (192, 81))
    w, wq, wk = gateway(*tree_rows(53, 2, 512), 1024, ())
    paths = [(hd, bf16) for hd in ta.HOPPER_PATH_HEAD_DIMS["fwd"]] + [
        (64, f32), (128, f32)]
    for hd, dt in paths:
        tag = f"hd {hd} {dt} ({bf16_paths(hd) if dt == bf16 else 'simple'})"
        add(f"padding tails, {tag}", dt, 2, 1024, 4, 2, hd, pad)
        add(f"gateway A=256, ancestors 192/81 padded, {tag}", dt, 2, 512, 4,
            2, hd, g, q_off=256)
        add(f"window 128 x q_off 1024, {tag}", dt, 2, 512, 4, 2, hd, w,
            q_off=1024, window=128, pq=wq, pk=wk)
    return cases


def dead_keys(kl, S: int, q_off: int, window, pq, pk,
              block_q: int) -> torch.Tensor:
    """[B, Skv] bool: the keys of every key tile that ``block_live_mask``
    marks dead for every query tile of its row, at ``block_q`` query rows
    a tile (a key tile dead for every tile of 2·64 rows is dead for every
    tile of 64)."""
    kl, pq, pk = (None if t is None else t.cpu().numpy() for t in (kl, pq, pk))
    Skv = kl.shape[1]
    rows = []
    for b in range(kl.shape[0]):
        m = ta.block_live_mask(kl[b], S, block_q, ta.BLOCK_K, q_off=q_off,
                               window=window,
                               pos_q=None if pq is None else pq[b],
                               pos_k=None if pk is None else pk[b])
        rows.append(np.repeat(~m.any(0), ta.BLOCK_K)[:Skv])
    return torch.as_tensor(np.stack(rows), device=DEV)


def phase_mask_soundness() -> dict:
    """The kernels' copies of the skip predicate against
    ``block_live_mask``: on ``mask_cases`` the forward, dq and dk/dv are
    first held against their plain versions (phases 2-3's checks), then
    run again with NaN written into K and V of exactly the key tiles that
    ``block_live_mask`` marks dead for every query tile (at the query
    rows a block of that path covers: 128 for the Hopper forward and dq at
    hd 192, 64 elsewhere).  o, lse, dq, dk and dv must be ``torch.equal``
    to the clean run's and finite: a kernel that loads a dead tile spreads
    its NaN, one that skips a live tile misses the plain version.
    Returns the cases and the poisoned key tiles."""
    cases = mask_cases()
    phase_kernel(cases, False)
    phase_bwd_kernel(cases)
    rng = np.random.default_rng(56)
    tiles = mask_check.kernel_tiles()
    poisoned = 0
    with torch.inference_mode():
        for name, dt, q, k, v, kl, q_off, window, pq, pk in cases:
            B, S, _, hd = q.shape
            kw = dict(q_off=q_off, window=window, pos_q=pq, pos_k=pk)
            sc = hd ** -0.5
            wide = ta.kernel_path("fwd", dt, hd) == "hopper" and hd == 192
            bq = tiles["hopper fwd/dq hd 192" if wide else "simple fwd"][0]
            dead = dead_keys(kl, S, q_off, window, pq, pk, bq)
            n_dead = int(dead.sum()) // ta.BLOCK_K
            check(n_dead > 0, f"mask soundness {name}: no key tile is dead "
                              f"for every query tile")
            do = randn(rng, q.shape, dt)

            def run(k_, v_):
                o, lse = ta.tree_attention(q, k_, v_, kl, sc,
                                           save_residuals=True, **kw)
                return (o, lse, *tab.tree_attention_bwd(q, k_, v_, kl, o,
                                                        lse, do, sc, **kw))

            clean = run(k, v)
            kn, vn = k.clone(), v.clone()
            kn[dead] = float("nan")
            vn[dead] = float("nan")
            nan = run(kn, vn)
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(clean, nan)]
            finite = [bool(torch.isfinite(t).all()) for t in nan]
            outs = ("o", "lse", "dq", "dk", "dv")
            log(f"mask soundness {name}: {n_dead} key tiles of 64 dead for "
                f"every {bq}-row query tile, NaN in their K and V: "
                + ", ".join(f"{o} {'equal' if e else 'DIFFERS'}"
                            f"{'' if f else ' (NOT FINITE)'}"
                            for o, e, f in zip(outs, same, finite)))
            check(all(same) and all(finite), f"mask soundness {name}: a "
                  f"kernel read a key tile its predicate should skip")
            poisoned += n_dead
            del clean, nan, kn, vn
    return dict(cases=len(cases), poisoned_key_tiles=poisoned)


def multiturn(cfg, params, impl: str, gen=None, record=None,
              tail_steps: int = 32, cross=None):
    """prefill 1024 → fork(8) → 32 steps → prefill 200 "tool output"
    tokens on all 8 branches (the kernel's q_off path) → ``tail_steps``
    steps.  ``cross``: an enc-dec model's cross K/V [dec_layers, 1, T, Kh,
    hd], loaded into the session (``load_cross``) before its prefill and
    tiled by the fork.

    Samples with ``gen``, or, given ``record`` (the fed tokens of an
    earlier run), replays those tokens.  Returns (fed tokens, logits per
    call, host-clock seconds and tokens of prefill and of decode)."""
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, 1024).astype(np.int32)
    tool = rng.integers(0, cfg.vocab_size, 200).astype(np.int32)
    fed, logits = [], []
    timing = {"prefill_s": 0.0, "prefill_tok": 0, "decode_s": 0.0,
              "decode_tok": 0, "kinds": []}

    def run(kind, n_tok, fn, toks):
        if record is not None:
            toks = record[len(fed)]
        fed.append(toks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(toks)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not timing[f"{kind}_tok"]:
            # the 1024-token prefill; the decode step that captures
            timing[f"first_{kind}_s"] = dt
        timing[f"{kind}_s"] += dt
        timing[f"{kind}_tok"] += n_tok
        timing["kinds"].append(kind)
        check(bool(torch.isfinite(out).all()), f"non-finite logits ({impl})")
        logits.append(out)
        return out

    def sample(lg):
        if record is not None:
            return None
        return sample_tokens(lg, cfg.vocab_size, gen, 1.0)

    sess = DecodeSession.create(cfg, params, buf_len=1536, enc_len=(
        0 if cross is None else cross[0].shape[2]))
    if cross is not None:
        sess.load_cross(*cross)
    lg = run("prefill", len(prompt), lambda t: sess.prefill(t, impl=impl),
             prompt)
    br = sess.fork(8)
    tok = sample(lg.expand(8, -1))
    for turn in range(2):
        if turn:
            lg = run("prefill", 8 * len(tool),
                     lambda t: br.prefill(t, impl=impl), tool)
            tok = sample(lg)
        for _ in range(tail_steps if turn else 32):
            lg = run("decode", 8, br.step, tok)
            tok = sample(lg)
    return fed, logits, timing


def phase_serve(cfg, params, tag: str = "serve", groups: int = 4):
    """``groups`` rollout groups, the multi-turn session and a profiled
    decode step.  Returns (the session's fed tokens, its logits, its
    timing, the run's forward launches)."""
    rc = RolloutConfig(k=8, prompt_len=1024, max_new=64, temperature=1.0)
    gen = torch.Generator(DEV).manual_seed(1)
    rng = np.random.default_rng(7)
    reset_launches()
    n_prefill = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        group_s = []
        for g in range(groups):
            prompt = rng.integers(0, cfg.vocab_size, rc.prompt_len)
            tg = time.perf_counter()
            tree, st = rollout_group(cfg, params, prompt, rc, gen)
            group_s.append(time.perf_counter() - tg)   # it ends in a sync
            n_prefill += 1
            check(st.prefill_tokens == rc.prompt_len,
                  f"group {g}: prefill_tokens {st.prefill_tokens}")
            check(st.decode_tokens == rc.k * (rc.max_new - 1),
                  f"group {g}: decode_tokens {st.decode_tokens}")
            check(tree.num_unique_tokens() <= rc.prompt_len
                  + rc.k * rc.max_new, f"group {g}: tree too large")
            check(tree.root.size >= rc.prompt_len and tree.num_leaves()
                  == rc.k, f"group {g}: prompt not shared by {rc.k} leaves")
        torch.cuda.synchronize()
        t_groups = time.perf_counter() - t0
        calls, logits, tm = multiturn(cfg, params, "kernel", gen)
        tm["group_s"] = statistics.median(group_s)
        n_prefill += 2
    counts = launch_counts()
    launches = counts["tree_attention_fwd"]
    log(f"{tag}: {groups} rollout group{'s' * (groups > 1)} (prompt "
        f"{rc.prompt_len}, k {rc.k}, max_new {rc.max_new}) in {t_groups:.3f} "
        f"s ({t_groups / groups:.3f} s a group; prefill_tokens == prompt_len "
        f"in each); multi-turn session: "
        f"prefill {tm['prefill_tok'] / tm['prefill_s']:.1f} tokens/s "
        f"({tm['prefill_tok']} tokens in {tm['prefill_s']:.4f} s), decode "
        f"{tm['decode_tok'] / tm['decode_s']:.1f} tokens/s "
        f"({tm['decode_tok']} tokens in {tm['decode_s']:.4f} s)")
    log(f"{tag}: kernel launches {counts} (forward = {cfg.n_layers} layers "
        f"x {n_prefill} parallel prefills: {launches / cfg.n_layers:g} a "
        f"layer, 1 a layer per prefill; no backward)")
    check(launches == cfg.n_layers * n_prefill,
          f"kernel launches {launches} != {cfg.n_layers} x {n_prefill}")
    check(counts["tree_attention_bwd_dq"] == counts["tree_attention_bwd_dkv"]
          == 0, "serving launched a backward kernel")
    with torch.inference_mode():
        # one decode step of 8 branches off a 1024-token prompt, profiled
        br = DecodeSession.create(cfg, params, buf_len=rc.buf_len)
        br.prefill(rng.integers(0, cfg.vocab_size, rc.prompt_len))
        br = br.fork(rc.k)
        tok = torch.zeros(rc.k, dtype=torch.long, device=DEV)
        for _ in range(2):
            br.step(tok)
        profile_step(lambda: (br.step(tok), torch.cuda.synchronize()),
                     tag.replace(" ", "_") + "_decode_step_trace",
                     "decode step")
    return calls, logits, tm, launches


def replay_error(cfg, params, calls, logits, metric):
    with torch.inference_mode():
        _, ref, _ = multiturn(cfg, params, "ref", record=calls)
    return max(metric(a, b) for a, b in zip(logits, ref))


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def phase_parity(cfg_full, params_full, calls, logits):
    e = replay_error(cfg_full, params_full, calls, logits, rel_l2)
    log(f"parity: {cfg_full.n_layers} layers bf16, kernel vs plain "
        f"attention, teacher-forced multi-turn: max relative L2 of logits "
        f"{e:.3e} (limit 3e-2)")
    check(e <= 3e-2, "full-depth bf16 path parity")
    cfg4 = cfg_full.replace(n_layers=4, dtype="float32")
    p4 = init_params(cfg4, torch.Generator(DEV).manual_seed(0))
    with torch.inference_mode():
        calls4, logits4, _ = multiturn(cfg4, p4, "kernel",
                                       torch.Generator(DEV).manual_seed(2))
    e4 = replay_error(cfg4, p4, calls4, logits4, max_rel)
    log(f"parity: 4 layers f32, kernel vs plain attention, teacher-forced "
        f"multi-turn: max relative error of logits {e4:.3e} (limit 1e-4)")
    check(e4 <= 1e-4, "reduced-depth f32 path parity")
    del p4


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def train_plans(cfg, kind: str, loss_mode: str, n: int, gen=TRAIN_GEN,
                trees: int = 4):
    """The first ``n`` non-empty plans of the launcher's planner (host
    arrays; the engine copies them to the card), ``trees`` trees of the
    generator settings ``gen`` a batch."""
    lc = LoaderConfig(seq_len=TRAIN_SEQ, batch_rows=TRAIN_ROWS,
                      trees_per_batch=trees, kind=kind, loss_mode=loss_mode,
                      seed=0, gen_kwargs=gen)
    out, dropped = [], 0
    for ps in plans(cfg, lc, 8 * n):
        plan = ps.execution_plan()
        if plan.is_empty:
            dropped += plan.dropped
            continue
        plan.dropped += dropped
        dropped = 0
        out.append(plan)
        if len(out) == n:
            return out
    raise Failed(f"the planner gave fewer than {n} {kind} plans")


def multi_row_step(cfg, S: int):
    """The first step of the planner (tree mode, lookahead 2, 8 short
    agentic trees a batch, rows of S) whose TRAIN_ROWS rows each hold at
    least two trees."""
    lc = LoaderConfig(seq_len=S, batch_rows=TRAIN_ROWS, trees_per_batch=8,
                      seed=0, gen_kwargs=dict(num_turns=3,
                                              turn_len_range=(32, 160)))
    for ps in plans(cfg, lc, 32, PlannerConfig(lookahead=2)):
        if len(ps.rows) == TRAIN_ROWS and not ps.oversized and \
                all(len(r) >= 2 for r in ps.rows):
            return ps
    raise Failed(f"no planner step put two trees in each of {TRAIN_ROWS} "
                 f"rows of {S}")


def row_trees(cfg, S: int, scan: int = 64):
    """The first trees of the agentic stream (first fit, in stream order,
    over its first ``scan`` trees) whose unique tokens fit one row of S,
    and no path of which is longer than S (both chunk-padded for an SSM
    model)."""
    lc = LoaderConfig(seq_len=TRAIN_SEQ, trees_per_batch=4, seed=0,
                      gen_kwargs=TRAIN_GEN)
    cs = chunk_size_of(cfg)
    pad = (lambda n: n) if cs is None else (lambda n: n + (-n % cs))
    trees, used = [], 0
    for batch in tree_stream(cfg, lc, scan // 4):
        for t in batch:
            n = serialize_tree(t, chunk_size=cs).n
            if used + n <= S and max(pad(len(p["tokens"]))
                                     for p in t.linearize_paths()) <= S:
                trees.append(t)
                used += n
    return trees


def tree_and_baseline(cfg, trees, S: int):
    """The trees packed into one row of S (tree mode) and their linearized
    paths into as many rows of S as they need (baseline), chunk-aligned
    for an SSM model."""
    cs = chunk_size_of(cfg)
    tb = pack_trees([serialize_tree(t, chunk_size=cs) for t in trees], S,
                    batch_size=1, chunk_size=cs)
    bb = pack_linear_paths([t.linearize_paths() for t in trees], S,
                           chunk_size=cs)
    return (prepare_batch(cfg, tb, device=DEV),
            prepare_batch(cfg, bb, device=DEV))


def count_hidden_syncs(engine, fn):
    """Run ``fn`` with PyTorch's CUDA sync debugging on everywhere except
    inside ``engine._sync`` (the engine's one counted transfer).  Returns
    (fn's result, the messages of the synchronizing calls made elsewhere)."""
    sync = engine._sync

    def counted(vec):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return sync(vec)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    engine._sync = counted
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            engine._sync = sync
    return out, [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]


def phase_train(cfg, sft, rl, tag: str = "train", baseline: bool = True):
    """Full-width training through the kernels, then (``baseline``) tree vs
    baseline."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    opt_state = init_opt_state(params)
    n_steps = len(sft) + len(rl)
    # the engine's default attention (impl="kernel"), as a user gets it
    engine = TreeTrainEngine(cfg, OptimizerConfig(
        lr=3e-4, warmup_steps=2, total_steps=n_steps))
    torch.cuda.synchronize()
    log(f"{tag}: {cfg.name} {cfg.n_layers} layers d {cfg.d_model} heads "
        f"{cfg.attn.n_heads}/{cfg.attn.n_kv_heads} hd {cfg.attn.head_dim} "
        f"{cfg.dtype}, remat {cfg.remat}, {cfg.param_count() / 1e9:.3f} B "
        f"params + fp32 AdamW state: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.2f} s")
    # each kernel once a layer a step; under remat the forward twice (the
    # backward recomputes each layer)
    want = {name: cfg.n_layers for name in KERNELS}
    want["tree_attention_fwd"] *= 2 if cfg.remat == "full" else 1
    reset_launches()
    times, per_tok, dropped, unique = [], [], 0, 0
    for i, (mode, plan) in enumerate([("sep_avg", p) for p in sft]
                                     + [("rl", p) for p in rl]):
        before = launch_counts()
        t1 = time.perf_counter()
        if i == 1:      # audit one step for transfers besides _sync
            (params, opt_state, m), hidden = count_hidden_syncs(
                engine, lambda: engine.step(params, opt_state, plan))
        else:
            params, opt_state, m = engine.step(params, opt_state, plan)
        dt = time.perf_counter() - t1
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        dropped += plan.dropped
        unique += plan.unique_tokens
        if i:
            times.append(dt)
            per_tok.append(plan.unique_tokens / dt)
        log(f"{tag} step {i} ({mode}): loss {m['loss']:.4f} nll/tok "
            f"{m['nll']:.4f} grad_norm {m['grad_norm']:.3f} lr {m['lr']:.3e}"
            f"; {plan.num_trees} trees, {plan.unique_tokens} unique tokens "
            f"in {plan.packed.cells} cells, {plan.dropped} trees dropped; "
            f"{dt:.3f} s ({plan.unique_tokens / dt:.0f} unique tokens/s); "
            f"launches this step {delta}; host syncs {engine.host_syncs}")
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"train step {i}: non-finite loss or grad norm")
        check(delta == want, f"train step {i}: launches {delta}, want "
                             f"{want}")
        check(engine.host_syncs == i + 1,
              f"train step {i}: {engine.host_syncs} host syncs")
    counts = launch_counts()
    log(f"{tag}: step 1 under torch.cuda.set_sync_debug_mode('warn') (off "
        f"inside the engine's _sync): {len(hidden)} other synchronizing "
        f"calls{': ' + '; '.join(sorted(set(hidden))) if hidden else ''}")
    check(not hidden, "a train step synchronized outside _sync")
    step_s = statistics.median(times)
    log(f"{tag}: {n_steps} steps ({len(sft)} sep_avg on agentic trees, "
        f"{len(rl)} rl on GRPO trees), {TRAIN_ROWS} rows x {TRAIN_SEQ}: "
        f"step {step_s:.3f} s median after the first (all: "
        f"{', '.join(f'{t:.3f}' for t in times)}), "
        f"{statistics.median(per_tok):.0f} unique tokens/s median, "
        f"{unique} unique tokens, {dropped} trees dropped, "
        f"{engine.host_syncs} host syncs / {n_steps} steps, peak "
        f"{peak_gb():.2f} GB; launches {counts}")
    params, opt_state, _ = profile_step(
        lambda: engine.step(params, opt_state, sft[0]),
        tag.replace(" ", "_") + "_step_trace")
    if not baseline:
        del opt_state
        return params, counts, step_s

    # tree vs per-branch baseline on the planner's multi-row output: its
    # first step with two or more trees in each row of 2048, and the same
    # trees' paths in as many rows of 2048 as they need; the forward + backward
    # (``engine.accumulate``) timed apart from AdamW
    ps = multi_row_step(cfg, 2048)
    bb = pack_linear_paths([f.paths for f in ps.fits], 2048)
    plan_t = ps.execution_plan()
    plan_b = ExecutionPlan(packed=PackedExec(
        inputs=batch_arrays(cfg, bb), tokens=int(bb.valid.sum()),
        cells=bb.tokens.size), num_trees=plan_t.num_trees)
    del opt_state
    res = {}
    for name, plan in (("tree", plan_t), ("baseline", plan_b)):
        opt = init_opt_state(params)
        eng = TreeTrainEngine(cfg, OptimizerConfig(
            lr=3e-4, warmup_steps=2, total_steps=4))
        torch.cuda.reset_peak_memory_stats()
        fb, ad = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads, scal = eng.accumulate(params, plan)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            params, opt, _ = update(eng.opt_cfg, params, grads, opt)
            torch.cuda.synchronize()
            fb.append(t2 - t1)
            ad.append(time.perf_counter() - t2)
            check(bool(torch.isfinite(scal).all()), f"{name}: non-finite loss")
            del grads
        res[name] = (statistics.median(fb[1:]), statistics.median(ad[1:]),
                     plan.unique_tokens, plan.packed.inputs["tokens"].shape[0],
                     peak_gb())
        del opt
    (f_t, a_t, n_t, r_t, pk_t), (f_b, a_b, n_b, r_b, pk_b) = \
        res["tree"], res["baseline"]
    log(f"{tag}: tree vs per-branch baseline on the planner's multi-row "
        f"step ({plan_t.num_trees} trees in {[len(r) for r in ps.rows]} per "
        f"row, rows of 2048, full width, "
        f"{cfg.dtype}, kernels): tree {n_t} tokens in {r_t} rows, forward + "
        f"backward {f_t:.3f} s, AdamW {a_t:.3f} s, peak {pk_t:.2f} GB; "
        f"baseline {n_b} tokens in {r_b} rows, forward + backward "
        f"{f_b:.3f} s, AdamW {a_b:.3f} s, peak {pk_b:.2f} GB; "
        f"{n_b / n_t:.3f} flat tokens per unique token, forward + backward "
        f"ratio baseline/tree {f_b / f_t:.3f}, with AdamW "
        f"{(f_b + a_b) / (f_t + a_t):.3f} (median of 2 after one warm-up "
        f"each; host clock around synchronized calls)")
    return params, counts, step_s


def profile_step(step, name: str = "train_step_trace",
                 what: str = "train step", annotations: tuple = (),
                 stats: dict = None):
    """Run ``step`` (one train step, or ``what``) once under torch.profiler
    with CUDA activity and print, from its Chrome trace: the 15 CUDA
    kernels with the most device time (name, calls, ms, share of the step's
    window) and the device-busy share of that window — the union of
    kernel, memcpy and memset intervals over the host-clock span of the
    step, which must end in a host sync.  The trace is kept, gzipped, as
    build/<name>.json.gz (``build/`` is not committed).  Returns ``step``'s
    result; ``stats`` takes {annotation: (kernels, device ms)}."""
    from torch.profiler import ProfilerActivity, profile, record_function
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / f"{name}.json"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("train_step"):
            out = step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    raw = path.read_bytes()
    path.unlink()
    (out_dir / f"{name}.json.gz").write_bytes(gzip.compress(raw))
    ann = report_trace(json.loads(raw)["traceEvents"], what, annotations)
    if stats is not None:
        stats.update(ann)
    return out


def report_trace(trace_events, what: str = "train step",
                 annotations: tuple = (), gaps: int = 0,
                 by_stream: bool = False) -> None:
    """``profile_step``'s report from the events of a Chrome trace that
    holds one ``train_step`` annotation; ``annotations`` names
    ``record_function`` ranges whose kernels' device time is reported;
    ``gaps``: that many longest idle gaps of the device in the window;
    ``by_stream``: kernel time by CUDA stream.  Returns {annotation:
    (kernels, device ms)}."""
    events = [e for e in trace_events if e.get("ph") == "X"]
    marks = [e for e in events if e.get("name") == "train_step"
             and e.get("cat") == "user_annotation"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not marks or not dev:
        log(f"profile: the trace holds {len(marks)} step marks and "
            f"{len(dev)} device events: no device breakdown")
        return {}
    t0 = marks[0]["ts"]
    t1 = t0 + marks[0]["dur"]
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in dev if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    busy, end = 0.0, t0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    win = t1 - t0
    by_name = {}
    for e in dev:
        if e["cat"] == "kernel" and t0 <= e["ts"] < t1:
            n, d = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, d + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    k_all = sum(d for _, d in by_name.values())
    log(f"profile: one {what} under torch.profiler (CPU + CUDA, outside "
        f"the timed runs): window {win / 1e3:.3f} ms on the host clock, device "
        f"busy {busy / 1e3:.3f} ms ({100 * busy / win:.1f}% of the window); "
        f"{sum(n for n, _ in by_name.values())} kernels, "
        f"{len(by_name)} distinct, {k_all / 1e3:.3f} ms of kernel time")
    log("profile: the 15 CUDA kernels with the most device time (calls, ms, "
        "share of the window):")
    for name, (n, d) in top:
        short = name if len(name) <= 110 else name[:107] + "..."
        log(f"profile:   {n:5d}  {d / 1e3:9.3f} ms  {100 * d / win:5.1f}%  "
            f"{short}")
    rest = k_all - sum(d for _, (_, d) in top)
    log(f"profile:   the other {len(by_name) - len(top)} kernels: "
        f"{rest / 1e3:.3f} ms ({100 * rest / win:.1f}%)")
    fam = {}
    for name, (n, d) in by_name.items():
        f = next((f for f, keys in PROFILE_FAMILIES
                  if any(s in name for s in keys)), "other")
        c, s = fam.get(f, (0, 0.0))
        fam[f] = (c + n, s + d)
    log("profile: kernel time by family (calls, ms, share of the window): "
        + "; ".join(f"{f} {n} / {d / 1e3:.3f} ms / {100 * d / win:.1f}%"
                    for f, (n, d) in sorted(fam.items(),
                                            key=lambda kv: -kv[1][1]))
        + f"; device idle {(win - busy) / 1e3:.3f} ms / "
        f"{100 * (win - busy) / win:.1f}%")
    if by_stream:
        streams = {}
        for e in dev:
            if e["cat"] == "kernel" and t0 <= e["ts"] < t1:
                sid = e.get("args", {}).get("stream", "?")
                n, d = streams.get(sid, (0, 0.0))
                streams[sid] = (n + 1, d + e["dur"])
        log("profile: kernel time by CUDA stream (kernels, ms, share of the "
            "window): " + "; ".join(
                f"stream {sid} {n} / {d / 1e3:.3f} ms / {100 * d / win:.1f}%"
                for sid, (n, d) in sorted(streams.items(),
                                          key=lambda kv: -kv[1][1])))
    if gaps:
        idle, end = [], t0
        for a, b in spans:
            if a > end:
                idle.append((a - end, end))
            end = max(end, b)
        if t1 > end:
            idle.append((t1 - end, end))
        log(f"profile: the {gaps} longest idle gaps of the device (ms, at "
            f"ms into the window): " + ", ".join(
                f"{d / 1e3:.3f} at {(at - t0) / 1e3:.3f}"
                for d, at in sorted(idle, reverse=True)[:gaps]))
    # the host op that launched each kernel: the outermost op of its thread
    # around the launch call (on autograd's thread, the node it evaluates)
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    outer = {}
    for e in sorted((e for e in events if e.get("cat") == "cpu_op"),
                    key=lambda e: (e["ts"], -e["dur"])):
        ops = outer.setdefault(e["tid"], [])
        if not ops or e["ts"] >= ops[-1]["ts"] + ops[-1]["dur"]:
            ops.append(e)
    starts = {tid: [e["ts"] for e in ops] for tid, ops in outer.items()}
    by_op = {}
    for e in dev:
        if e["cat"] != "kernel" or not t0 <= e["ts"] < t1:
            continue
        r = launch.get(e.get("args", {}).get("correlation"))
        op = "(launch not in the trace)"
        if r is not None:
            ops = outer.get(r["tid"], [])
            i = bisect.bisect_right(starts.get(r["tid"], []), r["ts"]) - 1
            op = (ops[i]["name"].removeprefix(
                "autograd::engine::evaluate_function: ")
                if i >= 0 and ops[i]["ts"] + ops[i]["dur"] >= r["ts"]
                else "(no host op)")
        n, d = by_op.get(op, (0, 0.0))
        by_op[op] = (n + 1, d + e["dur"])
    log("profile: kernel time by the host op that launched it (the "
        "outermost op around the launch; autograd nodes on the backward "
        "thread), the 12 largest (kernels, ms, share of the window):")
    for op, (n, d) in sorted(by_op.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"profile:   {n:5d}  {d / 1e3:9.3f} ms  {100 * d / win:5.1f}%  "
            f"{op[:110]}")
    # device time of the kernels launched inside each named annotation
    # (e.g. the gateway's K/V concatenation, models/attention.py)
    ann = {}
    for label in annotations:
        spans = {}
        for e in events:
            if e.get("cat") == "user_annotation" and e.get("name") == label:
                spans.setdefault(e["tid"], []).append(
                    (e["ts"], e["ts"] + e["dur"]))
        n = d = 0
        for e in dev:
            r = launch.get(e.get("args", {}).get("correlation"))
            if e["cat"] == "kernel" and r is not None and any(
                    a <= r["ts"] <= b for a, b in spans.get(r["tid"], ())):
                n, d = n + 1, d + e["dur"]
        log(f"profile: kernels launched inside '{label}': "
            f"{sum(map(len, spans.values()))} calls, {n} kernels, "
            f"{d / 1e3:.3f} ms ({100 * d / win:.2f}% of the window)")
        ann[label] = (n, d / 1e3)
    # the layer stacks' gradients: one unbind per stack leaf and forward
    # (its backward stacks the layers' grads), or a select per layer
    log("profile: the layer stacks' gradient nodes (kernels, ms, share of "
        "the window): " + "; ".join(
            f"{op} {by_op.get(op, (0, 0.0))[0]} / "
            f"{by_op.get(op, (0, 0.0))[1] / 1e3:.3f} ms / "
            f"{100 * by_op.get(op, (0, 0.0))[1] / win:.1f}%"
            for op in ("UnbindBackward0", "SelectBackward0")))
    return ann


def grads_rel(ga, gb):
    """(max over leaves of max|a − b| / max|b|, that leaf, relative L2 of
    the whole flattened gradient, the leaf with the largest relative L2)."""
    worst, wleaf, num, den, l2w, l2leaf = 0.0, "", 0.0, 0.0, 0.0, ""
    for (path, a), (_, b) in zip(flatten_tree(ga), flatten_tree(gb)):
        a, b = a.float(), b.float()
        d = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        n2, d2 = float((a - b).pow(2).sum()), float(b.pow(2).sum())
        num, den = num + n2, den + d2
        name = "/".join(map(str, path))
        if d > worst:
            worst, wleaf = d, name
        if d2 > 0 and math.sqrt(n2 / d2) > l2w:
            l2w, l2leaf = math.sqrt(n2 / d2), name
    return worst, wleaf, math.sqrt(num / den), f"{l2leaf} {l2w:.3e}"


def phase_train_parity(cfg, params):
    """(a) 4 layers f32 kernel vs plain; (b) 4 layers f32 tree vs baseline
    through the kernels; (c) 28 layers bf16 kernel vs plain."""
    cfg4 = cfg.replace(n_layers=4, dtype="float32")
    p4 = init_params(cfg4, torch.Generator(DEV).manual_seed(0))
    trees = row_trees(cfg4, 2048)
    bt, bb = tree_and_baseline(cfg4, trees, 2048)
    lk, _, gk = value_and_grad(cfg4, p4, bt, "kernel")
    lr, _, gr = value_and_grad(cfg4, p4, bt, "ref")
    e_loss = abs(float(lk) - float(lr)) / abs(float(lr))
    e_g, leaf, l2, _ = grads_rel(gk, gr)
    log(f"train parity (a): 4 layers f32, one packed row of 2048 "
        f"({len(trees)} trees, {int(bt['valid'].sum())} tokens), kernel vs "
        f"plain attention: loss {float(lk):.6f} vs {float(lr):.6f}, relative "
        f"error {e_loss:.3e} (limit 1e-5); grads max-rel {e_g:.3e} at {leaf} "
        f"(limit 1e-4), relative L2 {l2:.3e}")
    del gr
    lb, _, gb = value_and_grad(cfg4, p4, bb, "kernel")
    e_loss_b = abs(float(lk) - float(lb)) / abs(float(lb))
    e_g_b, leaf_b, l2_b, _ = grads_rel(gk, gb)
    log(f"train parity (b): 4 layers f32 through the kernels, tree (1 row) "
        f"vs per-branch baseline ({bb['tokens'].shape[0]} rows of 2048, "
        f"{int(bb['valid'].sum())} tokens): loss {float(lk):.6f} vs "
        f"{float(lb):.6f}, relative error {e_loss_b:.3e} (limit 1e-5); "
        f"grads max-rel {e_g_b:.3e} at {leaf_b} (limit 1e-4), relative L2 "
        f"{l2_b:.3e}")
    del p4, gk, gb
    trees = row_trees(cfg, 1024)
    bt, _ = tree_and_baseline(cfg, trees, 1024)
    lk2, _, gk2 = value_and_grad(cfg, params, bt, "kernel")
    lr2, _, gr2 = value_and_grad(cfg, params, bt, "ref")
    e_loss_c = abs(float(lk2) - float(lr2)) / abs(float(lr2))
    e_g_c, leaf_c, l2_c, l2leaf_c = grads_rel(gk2, gr2)
    log(f"train parity (c): {cfg.n_layers} layers bf16, one packed row of "
        f"1024 ({len(trees)} trees, {int(bt['valid'].sum())} tokens), kernel "
        f"vs plain attention: loss {float(lk2):.6f} vs {float(lr2):.6f}, "
        f"relative error {e_loss_c:.3e} (limit 1e-2); relative L2 of the "
        f"flattened gradient {l2_c:.3e} (limit 5e-2); worst leaf by relative "
        f"L2 {l2leaf_c}; max-rel {e_g_c:.3e} at {leaf_c}")
    del gk2, gr2
    check(e_loss <= 1e-5 and e_g <= 1e-4, "train parity (a)")
    check(e_loss_b <= 1e-5 and e_g_b <= 1e-4, "train parity (b)")
    check(e_loss_c <= 1e-2 and l2_c <= 5e-2, "train parity (c)")


# --------------------------------------------------------------------------
# determinism and Tree Packing over partitions
# --------------------------------------------------------------------------

def differing(ga, gb) -> list:
    """(leaf, max |a − b|) of the leaves of two gradient trees that are not
    ``torch.equal``."""
    return [("/".join(map(str, pa)), float((a - b).abs().max()))
            for (pa, a), (_, b) in zip(flatten_tree(ga), flatten_tree(gb))
            if not torch.equal(a, b)]


def phase_determinism(cfg, params, cases, tag: str = "determinism",
                      remat: bool = False):
    """Each (name, plan): ``engine.accumulate`` twice on the same
    parameters and plan; every gradient leaf and the scalars must be
    bit-identical (``torch.equal``).  With ``remat`` (``cfg`` at
    ``remat="none"``) a third call under ``remat="full"`` must give the
    same bits too: the backward's recompute of each layer is exact."""
    engine = TreeTrainEngine(cfg)
    for name, plan in cases:
        g1, s1 = engine.accumulate(params, plan)
        g2, s2 = engine.accumulate(params, plan)
        n = len(flatten_tree(g1))
        differ = differing(g1, g2)
        same_scal = torch.equal(s1, s2)
        del g2
        waves = len(plan.partition.waves) if plan.has_waves else 0
        log(f"{tag} ({name}): {cfg.name} {cfg.n_layers} layers {cfg.dtype}, "
            f"remat {cfg.remat}, {plan.num_trees} trees, "
            f"{plan.unique_tokens} unique tokens, "
            f"{'packed rows' if plan.packed is not None else 'no packed rows'}"
            f" + {waves} waves; two accumulate calls: {n - len(differ)}"
            f" of {n} gradient leaves bit-identical, scalars "
            f"{'identical' if same_scal else 'differ'}"
            + (f"; differing: {differ[:6]}" if differ else ""))
        check(not differ and same_scal, f"{tag} ({name}): gradients differ "
              f"between two runs")
        if remat:
            rcfg = cfg.replace(remat="full")
            gr, sr = TreeTrainEngine(rcfg).accumulate(params, plan)
            differ = differing(g1, gr)
            same_scal = torch.equal(s1, sr)
            del gr
            log(f"{tag} ({name}, remat full vs none): {n - len(differ)} of "
                f"{n} gradient leaves bit-identical, scalars "
                f"{'identical' if same_scal else 'differ'}"
                + (f"; differing: {differ[:6]}" if differ else ""))
            check(not differ and same_scal, f"{tag} ({name}): remat full "
                  f"changes the gradients")
        del g1
    torch.cuda.empty_cache()


def error_mode_step(engine, fn):
    """Run ``fn`` (one engine step) under ``set_sync_debug_mode("error")``
    everywhere except inside ``engine._sync``: any other synchronizing call
    raises."""
    sync = engine._sync

    def allowed(vec):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return sync(vec)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    engine._sync = allowed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        engine._sync = sync


def wave_config(cfg):
    lc = LoaderConfig(seq_len=TRAIN_SEQ, batch_rows=TRAIN_ROWS,
                      trees_per_batch=WAVE_TREES, kind="agentic",
                      seed=WAVE_SEED, auto_partition=True, auto_capacity=True,
                      gen_kwargs=WAVE_GEN)
    pc = PlannerConfig(lookahead=WAVE_LOOKAHEAD, plan_workers=1, graft=True,
                       max_rows=TRAIN_ROWS)
    return lc, pc


def step_launches(L: int, P: int, W: int) -> dict:
    """Each kernel's launches in one engine step (on one rank) of a plan
    with P packed executions and W waves, L attention layers: a forward,
    dq and dk/dv a layer an execution, and a wave's forward twice (the
    sweep and the backward's recompute)."""
    return {"tree_attention_fwd": L * (P + 2 * W),
            "tree_attention_bwd_dq": L * (P + W),
            "tree_attention_bwd_dkv": L * (P + W)}


def first_wave_plan(cfg):
    """The first plan of the waves phase's stream (host arrays)."""
    lc, pc = wave_config(cfg)
    return next(iter(plans(cfg, lc, WAVE_LOOKAHEAD, pc))).execution_plan()


def wave_kv_last(wp) -> np.ndarray:
    """The kernels' kv_last for a gateway wave's rows, as
    models/attention.py assembles it: the front-padded ancestors (2^30
    where ``anc_valid``, −1 on the padding), then the rows' own kv_last
    shifted by A_max."""
    A = wp.anc_A_max
    kl = wp.batch["kv_last"].astype(np.int64)
    anc = np.where(wp.batch["anc_valid"], BIG, -1)
    return np.concatenate([anc, np.where(kl >= 0, kl + A, -1)], 1)


def phase_wave_kernel(waves, heads=(12, 2), hd: int = 128,
                      tag: str = "wave kernel", label: str = "W") -> dict:
    """The three kernels against their plain versions at the waves phase's
    gateway waves (the largest A_max, and the most padded ancestor slots):
    each wave's rows and real kv_last behind its front-padded ancestors,
    q_off = A_max, at ``heads`` = (H, Kh) and ``hd`` (H 12, Kh 2, hd 128:
    Qwen2-1.5B), in f32 (the simple kernels) and
    bf16 (the Hopper kernels), through ``phase_kernel`` and
    ``phase_bwd_kernel``: o/lse and dq/dk/dv at their tolerances, the
    backward bit-identical over two launches, dk/dv exactly 0 on every key
    no query sees (the padded ancestor slots among them), the dq kernel's
    Δ.  Returns each kernel's largest max abs error: o's for the forward,
    dq's, and dk's and dv's."""
    cases, n_pad = [], 0
    add = case_adder(np.random.default_rng(30), cases)
    seen = set()
    for wp in waves:
        if wp is None or id(wp) in seen:
            continue
        seen.add(id(wp))
        kl, A = wave_kv_last(wp), wp.anc_A_max
        B, Skv = kl.shape
        pad = ~wp.batch["anc_valid"]
        n_pad += int(pad.sum())
        tiles = [int(p.reshape(-1, 64).all(1).sum()) if A % 64 == 0 else 0
                 for p in pad]
        log(f"{tag}: a gateway wave of {B} rows of {Skv - A}, q_off = "
            f"A_max = {A}, Skv {Skv} ({Skv % 64} keys past the last whole "
            f"64-key tile); ancestors per row {list(wp.A_real[:B])}, "
            f"padded ancestor slots per row {pad.sum(1).tolist()}, whole "
            f"64-key tiles of kv_last -1 per row {tiles}")
        for dt in (torch.float32, torch.bfloat16):
            add(f"{label}: gateway wave q_off = A_max = {A}, B={B}, "
                f"Skv={Skv}, H {heads[0]}/Kh {heads[1]} hd {hd} {dt}", dt, B,
                Skv - A, *heads, hd, kl, q_off=A)
    check(n_pad > 0, f"{tag}: no gateway wave had padded ancestor slots")
    fwd = phase_kernel(cases, with_prefill_attention=False)
    bwd = phase_bwd_kernel(cases)
    return {"fwd": fwd, "dq": bwd["dq"], "dkv": bwd["dkv"]}


def wave_pads(plan) -> tuple[int, int]:
    """(chunk-padding tokens in a plan's rows, packed and wave rows alike:
    invalid tokens before each row's last real token; the rows' cells)."""
    rows = [] if plan.packed is None else \
        [np.asarray(plan.packed.inputs["valid"])]
    if plan.has_waves:
        rows += [w.batch["valid"] for w in plan.partition.waves]
    pads = cells = 0
    for v in rows:
        cells += v.size
        for row in v:
            real = np.nonzero(row)[0]
            if real.size:
                pads += int((~row[:real[-1] + 1]).sum())
    return pads, cells


def phase_waves(cfg, params, tag: str = "waves",
                batches: int = WAVE_BATCHES, profile: bool = True,
                cached: bool = False):
    """``cfg`` (Qwen2-1.5B; an SSM arch at SSM_WAVE_DEPTH of its depth)
    trained through
    ``plans`` on trees larger than a row:
    auto partition, auto capacity, lookahead 2, grafting on, the plans
    built on a background thread and copied to the card by the engine.
    Per step: waves, rows per wave, A_max, the chunk-padding share (an SSM
    arch), step time, unique tokens/s,
    peak memory, launches (per application of the attention in a forward,
    one a layer or one a use of the hybrid's shared block: forward 2 a
    wave, sweep and remat), host syncs (one; step 1 audited in 'warn' mode,
    step 2 in 'error' mode), trees packed, partitioned and dropped (0).
    Token conservation over the stream.  With ``cached``, the last step's
    plan once more through an engine with the executable cache, the plan
    prewarmed (``AOTWarmupService.prewarm``): its grads and scalars
    ``torch.equal`` to the uncached engine's, 0 retraces.  Returns (params, the gateway
    wave with the largest A_max (of those, the most padded ancestor
    slots), the kernel launches of its step, the step's wave count, the
    gateway wave with the most padded ancestor slots, the launches of
    every step, the median step s)."""
    lc, pc = wave_config(cfg)
    generated = [t for b in tree_stream(cfg, lc, batches) for t in b]
    g_tokens = sum(t.num_unique_tokens() for t in generated)
    big = sum(t.num_unique_tokens() > TRAIN_SEQ for t in generated)
    in_range = sum(6000 <= t.num_unique_tokens() <= 16000 for t in generated)
    log(f"{tag}: {len(generated)} agentic trees ({WAVE_GEN}), {g_tokens} "
        f"unique tokens; {big} larger than a row of {TRAIN_SEQ}, {in_range} "
        f"with 6k-16k unique tokens; sizes "
        f"{sorted(t.num_unique_tokens() for t in generated)}")
    check(2 * big >= len(generated), f"{tag}: fewer than half the trees "
          "exceed a row")
    opt_state = init_opt_state(params)
    engine = TreeTrainEngine(cfg, OptimizerConfig(
        lr=3e-4, warmup_steps=2, total_steps=batches))
    L = cfg.n_layers if cfg.ssm is None else shared_apps(cfg)
    chunked = chunk_size_of(cfg) is not None
    reset_launches()
    pipe = plans(cfg, lc, batches, pc)
    tokens = trees = oversized = dropped = grafted = max_w = 0
    times, per_tok, hidden, deltas = [], [], [], []
    pads_all = cells_all = 0
    best, padded = ((0, 0), None, None, 0), ((0, 0), None)
    for i, ps in enumerate(pipe):
        plan = ps.execution_plan()
        dropped += plan.dropped
        if plan.is_empty:
            continue
        grafted += sum(f.n_src > 1 for f in ps.fits) \
            + sum(o.n_src > 1 for o in ps.oversized)
        waves = plan.partition.waves if plan.has_waves else []
        W, P = len(waves), int(plan.packed is not None)
        max_w = max(max_w, W)
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        step = lambda: engine.step(params, opt_state, plan)
        t1 = time.perf_counter()
        if i == 1:
            (params, opt_state, m), hidden = count_hidden_syncs(engine, step)
        elif i == 2:
            params, opt_state, m = error_mode_step(engine, step)
        else:
            params, opt_state, m = step()
        dt = time.perf_counter() - t1
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        want = step_launches(L, P, W)
        deltas.append(delta)
        tokens += plan.unique_tokens
        trees += plan.num_trees
        oversized += plan.num_oversized
        if i:
            times.append(dt)
        per_tok.append(plan.unique_tokens / dt)
        pads, cells = wave_pads(plan)
        pads_all, cells_all = pads_all + pads, cells_all + cells
        pad_txt = f", chunk padding {share(pads, cells)} of the cells" \
            if chunked else ""
        log(f"{tag} step {i}: capacity {ps.capacity}, {plan.num_trees} trees "
            f"({plan.num_trees - plan.num_oversized} packed, "
            f"{plan.num_oversized} partitioned, {plan.dropped} dropped), "
            f"{plan.unique_tokens} unique tokens, {P} packed execution + {W} "
            f"waves, rows per wave {[w.num_rows for w in waves]}, A_max per "
            f"wave {[w.anc_A_max for w in waves]}{pad_txt}; loss "
            f"{m['loss']:.4f} "
            f"nll/tok {m['nll']:.4f} grad_norm {m['grad_norm']:.3f}; "
            f"{dt:.3f} s ({plan.unique_tokens / dt:.0f} unique tokens/s), "
            f"peak {peak_gb():.2f} GB; launches {delta}; host syncs "
            f"{engine.host_syncs}")
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"{tag} step {i}: non-finite loss or grad norm")
        check(delta == want, f"{tag} step {i}: launches {delta}, want {want}")
        check(engine.host_syncs == engine.steps_done, f"{tag} step {i}: "
              f"{engine.host_syncs} host syncs in {engine.steps_done} steps")
        for wp in waves:
            if not wp.has_gw:
                continue
            n_pad = int((~wp.batch["anc_valid"]).sum())
            if (wp.anc_A_max, n_pad) > best[0]:
                best = ((wp.anc_A_max, n_pad), wp, delta, W)
            if (n_pad, wp.anc_A_max) > padded[0]:
                padded = ((n_pad, wp.anc_A_max), wp)
    log(f"{tag}: step 1 under set_sync_debug_mode('warn'): {len(hidden)} "
        f"other synchronizing calls"
        f"{': ' + '; '.join(sorted(set(hidden))) if hidden else ''}; step 2 "
        f"under set_sync_debug_mode('error') outside _sync: passed")
    check(not hidden, "a wave step synchronized outside _sync")
    if cached:
        phase_cached_step(cfg, lc, pc, params, ps, engine, tag)
    pad_txt = f"chunk padding {share(pads_all, cells_all)} of the cells; " \
        if chunked else ""
    log(f"{tag}: {engine.steps_done} steps, {trees} trees ({oversized} "
        f"partitioned, {grafted} grafted entries), {dropped} dropped; "
        f"{tokens} unique tokens trained of {g_tokens} generated; step "
        f"{statistics.median(times):.3f} s median after the first (all: "
        f"{', '.join(f'{t:.3f}' for t in times)}), "
        f"{statistics.median(per_tok):.0f} unique tokens/s median; "
        f"{pad_txt}peak {peak_gb():.2f} GB over the phase; plan "
        f"build on 1 worker: {pipe.schedule_s * 1e3:.1f} ms scheduled + "
        f"{pipe.build_s * 1e3:.1f} ms built, {pipe.exposed_s * 1e3:.1f} ms "
        f"exposed to the engine; host syncs {engine.host_syncs}")
    if profile:
        # one more step (not in the median) under torch.profiler: where the
        # wave step's time goes, and what the gateways' K/V concatenation
        # costs
        params, opt_state, _ = profile_step(
            lambda: engine.step(params, opt_state, plan), "wave_step_trace",
            f"wave step ({W} waves)", ("gateway_kv_cat",))
    check(dropped == 0, f"{tag}: trees dropped")
    check(tokens == g_tokens, f"{tag}: {tokens} unique tokens trained, "
          f"{g_tokens} generated")
    check(engine.steps_done >= 2, f"{tag}: {engine.steps_done} steps")
    check(best[1] is not None and best[0][0] >= WAVE_MIN_ANC,
          f"{tag}: no gateway wave with A_max >= {WAVE_MIN_ANC} (largest "
          f"{best[0][0]})")
    check(max_w >= 3, f"{tag}: at most {max_w} waves a step")
    del opt_state
    torch.cuda.empty_cache()
    return (params, best[1], best[2], best[3], padded[1], deltas,
            statistics.median(times))


def phase_cached_step(cfg, lc, pc, params, ps, engine, tag: str) -> None:
    """``ps``'s plan through an engine with the executable cache, the plan
    prewarmed as ``plans(..., warmup=)`` prewarms it, and through the
    uncached ``engine``: grads and scalars ``torch.equal``, 0 retraces."""
    plan = ps.execution_plan()
    t0 = time.perf_counter()
    svc = AOTWarmupService(cfg, lc, pc, params=params,
                           opt_cfg=engine.opt_cfg)
    new = svc.prewarm(step=ps)
    prewarm_s = time.perf_counter() - t0
    eng = TreeTrainEngine(cfg, engine.opt_cfg, exec_cache=svc.cache,
                          universe=svc.universe)
    g_c, s_c = eng.accumulate(params, plan)
    g_u, s_u = engine.accumulate(params, plan)
    diff = differing(g_c, g_u)
    same_s = torch.equal(s_c, s_u)
    n = len(flatten_tree(g_u))
    del g_c, g_u
    log(f"{tag}: the last step's plan ({plan.num_executions} executions) "
        f"through an engine with the executable cache, prewarmed ({new} "
        f"executables in {prewarm_s:.3f} s): {eng.retraces} retraces, "
        f"{n - len(diff)} of {n} grad leaves and the scalars "
        f"{'' if same_s else 'not '}torch.equal to the uncached engine's")
    check(not diff and same_s, f"{tag}: the cached engine's grads differ: "
                               f"{diff[:4]}")
    check(eng.retraces == 0 and not svc.errors,
          f"{tag}: {eng.retraces} retraces after prewarm, {svc.errors[:2]}")


def parity_tree(cfg):
    """The first tree of the waves phase's generator with PARITY_TOKENS
    unique tokens that partitions at PARITY_CAP into ≥ 3 waves with
    ancestors of ≥ PARITY_CAP tokens, and fits one row of PARITY_ROW."""
    lc, _ = wave_config(cfg)
    lc = dataclasses.replace(lc, seed=WAVE_SEED + 1, trees_per_batch=4)
    cs = chunk_size_of(cfg)
    for batch in tree_stream(cfg, lc, 16):
        for t in batch:
            n = t.num_unique_tokens()
            if not PARITY_TOKENS[0] <= n <= PARITY_TOKENS[1] or \
                    serialize_tree(t, chunk_size=cs).n > PARITY_ROW:
                continue
            parts = partition_tree(t, PARITY_CAP, chunk_size=cs)
            depth = {}
            for p in parts:
                depth[p.pid] = 0 if p.parent_pid < 0 \
                    else depth[p.parent_pid] + 1
            if max(depth.values()) >= 2 and \
                    max(p.anc_len for p in parts) >= PARITY_CAP:
                return t, parts
    raise Failed("no wave parity tree in the stream")


class BrokenGateways:
    """While active, the wave executor relays every child gateway with each
    leaf ``name`` (``k``/``v``, ``state``, ``conv``, ``shift``) replaced by
    ``fix(name, value)``: a deliberately broken gateway, a control of
    ``phase_wave_parity``'s (b) for the SSM archs."""

    def __init__(self, fix):
        self.fix = fix

    def __enter__(self):
        real = self._real = train_engine.assemble_child_gw

        def broken(*args, **kw):
            return {g: {k: {n: self.fix(n, v) for n, v in leaves.items()}
                        for k, leaves in cg.items()}
                    for g, cg in real(*args, **kw).items()}

        train_engine.assemble_child_gw = broken
        return self

    def __exit__(self, *exc):
        train_engine.assemble_child_gw = self._real


# (b)'s controls: the relayed conv and shift tails zeroed (must miss a
# raised bar), the relayed SSM states rounded to bf16
GATEWAY_CONTROLS = {
    "zeroed tails": lambda n, v: torch.zeros_like(v)
    if n in ("conv", "shift") else v,
    "bf16 states": lambda n, v: map_tree(
        lambda t: t.bfloat16().to(t.dtype), v) if n == "state" else v}


def phase_wave_parity(cfg, params, tag: str = "wave parity",
                      controls: bool = False):
    """One tree partitioned at PARITY_CAP (≥ 3 waves, ancestors ≥
    PARITY_CAP tokens) against the same tree whole in one row of
    PARITY_ROW, through the kernels (chunk-aligned for an SSM arch):
    (a) 4 layers f32: loss 1e-5 relative, grads max-rel 1e-4; (b) all
    layers bf16: loss 1e-2 relative, gradient relative L2 5e-2.

    With ``controls`` (the SSM archs), the GATEWAY_CONTROLS' broken
    partitioned runs follow (b) at the same weights, each held against
    the bf16 whole tree and reported.  (At the trained RWKV6-1.6B's
    weights the zeroed-tails fault moves (b) by 5e-3 to 2e-2, so it
    cannot be required to miss 5e-2.)"""
    l2_bar = 5e-2
    tree, parts = parity_tree(cfg)
    cs = chunk_size_of(cfg)
    ser = serialize_tree(tree, chunk_size=cs)
    results = []
    for label, c, p in (("a", cfg.replace(n_layers=4, dtype="float32"),
                         None), ("b", cfg, params)):
        if p is None:
            p = init_params(c, torch.Generator(DEV).manual_seed(0))
        whole = prepare_batch(c, pack_trees([ser], PARITY_ROW, chunk_size=cs),
                              device=DEV)
        lw, _, gw = value_and_grad(c, p, whole, "kernel")
        lp, gp, info = packed_partitioned_value_and_grad(
            c, p, [tree], PARITY_CAP, seq_len=PARITY_CAP)
        e_loss = abs(lp - float(lw)) / abs(float(lw))
        e_g, leaf, l2, l2leaf = grads_rel(gp, gw)
        log(f"{tag} ({label}): {c.n_layers} layers {c.dtype}, one tree "
            f"of {tree.num_unique_tokens()} unique tokens ({ser.n} "
            f"serialized, {tree.num_leaves()} leaves): "
            f"{info['num_partitions']} partitions in {info['num_waves']} waves "
            f"of rows of {PARITY_CAP} (max ancestors "
            f"{max(q.anc_len for q in parts)}) vs whole in one row of "
            f"{PARITY_ROW}, kernels both: loss {lp:.6f} vs {float(lw):.6f}, "
            f"relative error {e_loss:.3e}; grads max-rel {e_g:.3e} at {leaf}, "
            f"relative L2 {l2:.3e} (worst leaf {l2leaf})")
        results.append((label, e_loss, e_g, l2, info["num_waves"]))
        del gp
        if label == "b" and controls:
            ctl = {}
            for name, fix in GATEWAY_CONTROLS.items():
                with BrokenGateways(fix):
                    lc, gc, _ = packed_partitioned_value_and_grad(
                        c, p, [tree], PARITY_CAP, seq_len=PARITY_CAP)
                ctl[name] = (abs(lc - float(lw)) / abs(float(lw)),
                             grads_rel(gc, gw)[2])
                del gc
            log(f"{tag} (b, controls): gradient bar {l2_bar:.3e} "
                f"({l2 / l2_bar:.3f} of it used); broken partitioned runs "
                f"against the bf16 whole tree: " + "; ".join(
                    f"{n}: loss {e:.3e}, gradient relative L2 {g:.3e} "
                    f"({g / l2_bar:.3f} of the bar)"
                    for n, (e, g) in ctl.items()))
        del gw
        if label == "a":
            del p
        torch.cuda.empty_cache()
    (_, la, ga, _, wa), (_, lb, _, l2b, _) = results
    check(wa >= 3, f"{tag}: fewer than 3 waves")
    check(la <= 1e-5 and ga <= 1e-4, f"{tag} (a)")
    check(lb <= 1e-2 and l2b <= l2_bar, f"{tag} (b)")


# --------------------------------------------------------------------------
# the async tree-RL loop: a generation thread beside the trainer
# --------------------------------------------------------------------------

class ThreadCount:
    """A kernel's launch count kept per thread name: the wrapper's
    ``fn.launches += 1`` calls ``__iadd__``, so the generator's launches
    (RL_GEN_THREAD) and the trainer's (its thread and autograd's device
    thread) are told apart."""

    def __init__(self):
        self.by: dict = {}
        self.lock = threading.Lock()

    def __iadd__(self, n: int):
        name = threading.current_thread().name
        with self.lock:
            self.by[name] = self.by.get(name, 0) + n
        return self

    def split(self) -> tuple[int, int]:
        """(the trainer's launches, the generator's)."""
        with self.lock:
            gen = self.by.get(RL_GEN_THREAD, 0)
            return sum(self.by.values()) - gen, gen


class SyncLog:
    """While active, ``torch.cuda.set_sync_debug_mode('warn')`` is on in
    the whole process and every synchronizing call's warning is counted by
    the thread that raised it: autograd replays its device thread's
    warnings on the thread that called the backward, so the trainer's
    thread sees its whole step's.  Other warnings pass through."""

    def __init__(self):
        self.by: dict = {}
        self.lock = threading.Lock()

    def count(self, name: str) -> int:
        with self.lock:
            return self.by.get(name, 0)

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        if "called a synchronizing" in str(message):
            name = threading.current_thread().name
            with self.lock:
                self.by[name] = self.by.get(name, 0) + 1
        else:
            self._show(message, category, filename, lineno, file, line)

    def __enter__(self):
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self._hook
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._cm.__exit__(*exc)


class StepAudit:
    """While active, wraps ``TreeTrainEngine.step`` (the launcher's steps
    only: the warm-up and the gradient check do not step) and records per
    step the trainer thread's synchronizing calls, the trainer's kernel
    launches, and the device memory allocated and reserved after it.  With
    ``profile=(a, b)`` steps a..b run under torch.profiler, both threads
    live, inside one ``train_step`` annotation; the trace is reported after
    the loop."""

    def __init__(self, syncs: SyncLog, counters: dict, profile=None):
        self.syncs, self.counters, self.profile = syncs, counters, profile
        self.rows: list = []
        self.prof = None

    def __enter__(self):
        self._orig = orig = TreeTrainEngine.step
        audit = self

        def step(engine, params, opt_state, plan):
            i = len(audit.rows)
            name = threading.current_thread().name
            if audit.profile and i == audit.profile[0]:
                from torch.profiler import (ProfilerActivity, profile,
                                            record_function)
                audit.prof = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
                with CAPTURE_LOCK:  # not while the generator captures
                    audit.prof.start()
                audit.mark = record_function("train_step")
                audit.mark.__enter__()
            s0 = audit.syncs.count(name)
            l0 = {k: c.split()[0] for k, c in audit.counters.items()}
            h0 = engine.host_syncs
            out = orig(engine, params, opt_state, plan)
            audit.rows.append(dict(
                syncs=audit.syncs.count(name) - s0,
                host_syncs=engine.host_syncs - h0,
                launches={k: c.split()[0] - l0[k]
                          for k, c in audit.counters.items()},
                alloc_gb=torch.cuda.memory_allocated() / 1e9,
                reserved_gb=torch.cuda.memory_reserved() / 1e9))
            if audit.profile and i == audit.profile[1]:
                audit.mark.__exit__(None, None, None)
                with CAPTURE_LOCK:  # its stop syncs the device
                    torch.cuda.synchronize()
                    audit.prof.stop()
            return out

        TreeTrainEngine.step = step
        return self

    def __exit__(self, *exc):
        TreeTrainEngine.step = self._orig


# --------------------------------------------------------------------------
# the data axis (torch.distributed)
# --------------------------------------------------------------------------

def dp_store() -> str:
    """A fresh file for a process group's file store (no port)."""
    return os.path.join(tempfile.mkdtemp(prefix="dp_"), "store")


def phase_data_parallel(cfg, params, sft, wave_plan, step_s: float) -> dict:
    """(a) ``dp_world1``; (b) a world of 2 (``dp_spawn``), whose ranks
    start with the phase and wait for (a) to end before they train, so
    their start-up overlaps (a) and their work does not."""
    ranks = dp_spawn(cfg, sft)
    try:
        res = dp_world1(cfg, params, sft, wave_plan, step_s)
        torch.cuda.empty_cache()
        res["world2"] = dp_collect(cfg, ranks)
    finally:
        for p in ranks["procs"]:
            if p.is_alive():
                p.kill()
                p.join()
    return res


def dp_world1(cfg, params, sft, wave_plan, step_s: float) -> dict:
    """(a) A world of 1 over NCCL at full width: the packed and the wave
    plan's grads through the engine on the data axis ``torch.equal`` to
    the engine's with no process group; then DP_WORLD1_STEPS steps on the
    axis, counted from 0 just before them and read just after (each kernel
    ``step_launches`` times a step), one host sync each (step 1 audited as
    ``phase_train`` audits it), their time beside the train phase's; one
    profiled step's reduction (device ms, bytes).  At one rank NCCL moves
    no data, so that device time is the collectives' own cost, not the
    cost of summing across cards."""
    from repro_torch import sharding as sh
    from repro_torch.launch.mesh import host_descriptor
    dist.init_process_group("nccl", init_method="file://" + dp_store(),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        t0 = time.perf_counter()
        mesh = host_descriptor().build("cuda")
        plain = TreeTrainEngine(cfg)
        for name, plan in (("packed", sft[0]), ("waves", wave_plan)):
            g0, s0 = plain.accumulate(params, plan)
            with sh.use_mesh(mesh):
                g1, s1 = TreeTrainEngine(cfg).accumulate(params, plan)
            differ = differing(g0, g1)
            n = len(flatten_tree(g0))
            same = torch.equal(s0, s1)
            del g0, g1
            log(f"data parallel (a, {name}): NCCL world 1, {cfg.name} "
                f"{cfg.n_layers} layers {cfg.dtype}, "
                f"{plan.num_executions} executions: {n - len(differ)} of {n} "
                f"gradient leaves and the scalars "
                f"{'torch.equal' if same else 'differ'} to the engine with "
                f"no process group"
                + (f"; differing: {differ[:6]}" if differ else ""))
            check(not differ and same, f"data parallel (a, {name}): the "
                  f"data axis changed the gradients")
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        opt_state = init_opt_state(params)
        engine = TreeTrainEngine(cfg, OptimizerConfig(
            lr=3e-4, warmup_steps=2, total_steps=len(sft)))
        steps = sft[:DP_WORLD1_STEPS]
        times, per_step = [], []
        with sh.use_mesh(mesh):
            reset_launches()
            for i, plan in enumerate(steps):
                want = plan_launches(cfg.n_layers, plan)
                before = launch_counts()
                t2 = time.perf_counter()
                if i == 1:
                    (params, opt_state, m), hidden = count_hidden_syncs(
                        engine, lambda: engine.step(params, opt_state, plan))
                else:
                    params, opt_state, m = engine.step(params, opt_state, plan)
                times.append(time.perf_counter() - t2)
                after = launch_counts()
                per_step.append({k: after[k] - before[k] for k in after})
                check(math.isfinite(m["loss"]), "data parallel: non-finite "
                                                "loss")
                check(engine.host_syncs == i + 1, f"data parallel step {i}: "
                      f"{engine.host_syncs} host syncs")
                check(per_step[-1] == want, f"data parallel (a) step {i}: "
                      f"launches {per_step[-1]}, want {want}")
            counts = launch_counts()
            stats = {}
            t3 = time.perf_counter()
            params, opt_state, _ = profile_step(
                lambda: engine.step(params, opt_state, sft[0]),
                "dp_step_trace", "data-axis train step",
                (train_engine.REDUCE_SPAN,), stats)
        n_red, red_ms = stats.get(train_engine.REDUCE_SPAN, (0, math.nan))
        nbytes = train_engine.reduced_bytes(params)
        dp_s = statistics.median(times[1:])
        log(f"data parallel (a): steps on the data axis "
            f"{', '.join(f'{t:.3f}' for t in times)} s, median after the "
            f"first {dp_s:.3f} s beside the train phase's {step_s:.3f} s; "
            f"{engine.host_syncs} host syncs / {len(times) + 1} steps; step "
            f"1 under set_sync_debug_mode('warn'): {len(hidden)} other "
            f"synchronizing calls"
            f"{': ' + '; '.join(sorted(set(hidden))) if hidden else ''}; "
            f"launches counted from 0 over the {len(steps)} steps {counts}, "
            f"a step {per_step}; the reduction in the profiled step: "
            f"{n_red} kernels, {red_ms:.3f} device ms for {nbytes / 1e9:.3f} "
            f"GB of fp32 slots and scalars (one rank: NCCL sums nothing "
            f"across cards, so this is the collectives' cost, not the "
            f"sum's); (a) took {time.perf_counter() - t0:.1f} s: the mesh "
            f"and the grads' checks {t1 - t0:.1f}, the steps {t3 - t1:.1f}, "
            f"the profiled step {time.perf_counter() - t3:.1f}")
        check(not hidden, "data parallel: a step synchronized outside _sync")
        check(counts == {k: sum(d[k] for d in per_step) for k in counts},
              f"data parallel (a): launches {counts} beside the steps' "
              f"{per_step}")
        return dict(step_s=dp_s, reduce_ms=red_ms, reduce_kernels=n_red,
                    reduce_bytes=nbytes, launches=per_step)
    finally:
        dist.destroy_process_group()


def plan_launches(L: int, plan) -> dict:
    """``step_launches`` of an execution plan."""
    return step_launches(L, int(plan.packed is not None),
                         len(plan.partition.waves) if plan.has_waves else 0)


def crossing_parents(plan) -> int:
    """Gateway slots of a plan's waves whose parent row sits on the other
    rank of a data axis of 2 (contiguous row blocks)."""
    waves, n = plan.partition.waves, 0
    for wp in waves:
        B = wp.batch["tokens"].shape[0]
        for si, ref in enumerate(wp.parents):
            pB = waves[ref.wave].batch["tokens"].shape[0]
            n += wp.slot_rows[si] // (B // 2) != ref.row // (pB // 2)
    return n


def dp_wave_plan(cfg):
    """The first plan of the waves phase's stream, planned for a data axis
    of 2 ranks (``num_replicas=2``), that has a gateway slot whose parent
    row sits on the other rank; returns (plan, such slots).  Every rank
    plans the same stream from the same seed, as the launcher's ranks do."""
    lc, pc = wave_config(cfg)
    pc = dataclasses.replace(pc, num_replicas=2)
    for ps in plans(cfg, lc, WAVE_BATCHES, pc):
        plan = ps.execution_plan()
        if plan.has_waves and crossing_parents(plan):
            return plan, crossing_parents(plan)
    raise RuntimeError(f"data parallel (b): none of the waves stream's "
                       f"first {WAVE_BATCHES} plans has a parent on another "
                       f"rank")


def dp_spawn(cfg, sft) -> dict:
    """Start (b)'s world of 2 (``dp_rank``): NCCL on two devices where the
    machine shows two, else gloo on the one card; DP_LAYERS layers in
    f32, the train phase's first plan and a wave plan.  The ranks wait for
    the ``go`` file before they train (their start-up, the group, their
    params and their planning come before it)."""
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    out = Path(tempfile.mkdtemp(prefix="dp_out_"))
    ctx = mp.get_context("spawn")
    cfg4 = cfg.replace(n_layers=DP_LAYERS, dtype="float32")
    store = dp_store()
    procs = [ctx.Process(target=dp_rank, args=(
        r, 2, backend, store, cfg4, sft[0], str(out))) for r in range(2)]
    for p in procs:
        p.start()
    return dict(procs=procs, out=out, backend=backend)


def dp_collect(cfg, ranks: dict) -> dict:
    """(b): let the ranks start (the ``go`` file), wait for them (at most
    DP_TIMEOUT_S), and check what they wrote: each step's grads on the
    axis (rank 0's share of the sum, which every rank holds) within 1e-4
    max-rel of world 1's at the params the step started from, params
    torch.equal across ranks after the steps, each kernel launched
    ``plan_launches`` times a step on each rank, and the engine's one
    host sync a step."""
    out, procs, backend = ranks["out"], ranks["procs"], ranks["backend"]
    t0 = time.perf_counter()
    (out / "go").touch()
    for p in procs:
        p.join(max(DP_TIMEOUT_S - (time.perf_counter() - t0), 1))
    alive = [p for p in procs if p.is_alive()]
    wall = time.perf_counter() - t0
    check(not alive, f"data parallel (b): {len(alive)} ranks still running "
                     f"after {DP_TIMEOUT_S} s")
    check(all(p.exitcode == 0 for p in procs), f"data parallel (b): rank "
          f"exit codes {[p.exitcode for p in procs]}")
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    r0 = res[0]
    log(f"data parallel (b): world 2 over {backend} on "
        f"{'two devices' if backend == 'nccl' else 'the one card'}, "
        f"{cfg.name} {DP_LAYERS} layers f32 ({TRAIN_ROWS} rows of "
        f"{TRAIN_SEQ}, one a rank): step 1 the train phase's first plan "
        f"(packed), step 2 the waves stream's first plan at num_replicas 2 "
        f"with a parent on the other rank ({r0['waves']} waves, "
        f"{r0['crossing']} gateway slots whose parent row is on the other "
        f"rank: the captures' all-gather and the cotangents' "
        f"reduce-scatter move data between the ranks); grads max-rel of "
        f"world 1 by step {[s['max_rel'] for s in r0['steps']]} (limit "
        f"1e-4) at {[s['leaf'] for s in r0['steps']]}; loss by step "
        f"{[s['loss'] for s in r0['steps']]} vs world 1's "
        f"{[s['loss1'] for s in r0['steps']]}; params after the steps "
        f"{'torch.equal' if res[1]['params_equal'] else 'differ'} across "
        f"ranks ({res[1]['leaves_equal']} of {res[1]['leaves']} leaves); "
        f"launches by rank and step {[r['launches'] for r in res]} (want "
        f"{r0['want']}); device memory a step's peak added, GB, by rank "
        f"and step {[r['peak_gb'] for r in res]} beside world 1's "
        f"accumulate on rank 0 {[s['peak_gb1'] for s in r0['steps']]}; "
        f"the engine's host syncs {[r['host_syncs'] for r in res]} "
        f"(its own counter: over gloo every collective on a card's tensor "
        f"also blocks the host until it ends, which the counter does not "
        f"see); step s {[r['step_s'] for r in res]}; wall {wall:.1f} s "
        f"after the ranks were let go")
    check(r0["crossing"] > 0, "data parallel (b): no parent on another rank")
    check(all(s["max_rel"] <= 1e-4 for s in r0["steps"]),
          "data parallel (b): grads")
    check(res[1]["params_equal"], "data parallel (b): params differ across "
                                  "ranks")
    check(all(r["launches"] == r0["want"] for r in res),
          "data parallel (b): launches")
    check(all(r["host_syncs"] == DP_STEPS for r in res),
          "data parallel (b): host syncs")
    return dict(backend=backend, max_rel=[s["max_rel"] for s in r0["steps"]],
                launches=[r["launches"] for r in res], wall_s=wall,
                mp=mp_report(res))


def dp_rank(rank: int, world: int, backend: str, store: str, cfg, packed,
            out: str) -> None:
    """One rank of (b) (a spawned process): joins the group, makes its
    params and plans the wave plan (``dp_wave_plan``); then, once
    ``out``/go exists, DP_STEPS steps on the data axis, ``packed`` then
    the wave plan, each step's launches counted around it; rank 0 first
    runs each step's plan through the engine with no process group at the
    params the step starts from (world 1) and holds the step's reduced
    grads against it.  Writes rank<r>.json to ``out``."""
    from repro_torch import sharding as sh
    from repro_torch.launch.mesh import host_descriptor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=DP_TIMEOUT_S),
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    try:
        params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
        wave, crossing = dp_wave_plan(cfg)
        plans_ = [packed, wave][:DP_STEPS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while not Path(out, "go").exists():
            if time.perf_counter() - t0 > DP_TIMEOUT_S:
                raise TimeoutError("data parallel (b): never let go")
            time.sleep(0.1)
        engine = TreeTrainEngine(cfg, OptimizerConfig(
            lr=3e-4, warmup_steps=1, total_steps=DP_STEPS))
        plain = TreeTrainEngine(cfg)
        kept, accumulate = [], engine.accumulate

        def keep(p, plan):
            kept.append(accumulate(p, plan))
            return kept[-1]

        engine.accumulate = keep
        opt = init_opt_state(params)
        res = dict(crossing=crossing, waves=len(wave.partition.waves),
                   want=[plan_launches(cfg.n_layers, p) for p in plans_],
                   launches=[], step_s=[], steps=[], peak_gb=[])

        def added_gb(fn):
            """(fn's result, the device memory its peak added, GB)."""
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out_ = fn()
            torch.cuda.synchronize(dev)
            return out_, round((torch.cuda.max_memory_allocated(dev)
                                - base) / 1e9, 3)

        with sh.use_mesh(host_descriptor().build("cuda")):
            for plan in plans_:
                ref = None
                if rank == 0:
                    with sh.use_mesh(None):
                        ref, ref_gb = added_gb(
                            lambda: plain.accumulate(params, plan))
                before = launch_counts()
                t1 = time.perf_counter()
                (params, opt, _), gb = added_gb(
                    lambda: engine.step(params, opt, plan))
                res["step_s"].append(round(time.perf_counter() - t1, 3))
                res["peak_gb"].append(gb)
                after = launch_counts()
                res["launches"].append({k: after[k] - before[k]
                                        for k in after})
                got = kept.pop()
                if ref is not None:
                    worst, leaf, _, _ = grads_rel(got[0], ref[0])
                    res["steps"].append(dict(
                        max_rel=worst, leaf=leaf, peak_gb1=ref_gb,
                        loss=round(float(got[1][0]), 6),
                        loss1=round(float(ref[1][0]), 6)))
                del got, ref
        res["host_syncs"] = engine.host_syncs
        same = []
        for leaf in tree_leaves(params):
            buf = leaf.clone()
            dist.broadcast(buf, src=0)
            same.append(torch.equal(buf, leaf))
        res.update(params_equal=all(same), leaves_equal=sum(same),
                   leaves=len(same))
        del params, opt, kept
        torch.cuda.empty_cache()
        res["mp"] = mp_rank(rank, dev, cfg)
        Path(out, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def mp_bf16_reckoning(cfg) -> str:
    """The device memory the bf16 check of the model parallel part needs
    at MP_BF16_LAYERS layers, reckoned from the config: each rank holds
    world 1's parameters, fp32 grads and activations, and its blocks,
    their fp32 grads and their activations."""
    L, D, F, V = MP_BF16_LAYERS, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    layer = cfg.param_count() - 2 * V * D
    layer //= cfg.n_layers
    n = 2 * V * D + L * layer
    tok = TRAIN_ROWS * MP_SEQ
    # a layer keeps about 8 [tokens, D] and 4 [tokens, F] bf16 tensors
    act = L * tok * (8 * D + 4 * F) * 2
    rank = n * (2 + 4) + act + (n * (2 + 4) + act) // 2
    return (f"{L} layers bf16: world 1 {n / 1e9:.3f} B params; a rank "
            f"~{rank / 1e9:.1f} GB (world 1's params, fp32 grads and "
            f"activations, and its blocks'), two ranks beside the script's "
            f"own process")


def mp_block_rel(got, ref, first: bool):
    """This rank's blocks of the model axis's grads ``got`` against world
    1's full grads ``ref``: (the largest max|a - b| / max|b| over a leaf,
    that leaf, Σ (a - b)², Σ b²), the sums over this rank's blocks of the
    model-sharded leaves and, on the ``first`` rank only, the replicated
    leaves (whole and equal on every rank)."""
    from repro_torch import sharding as sh
    worst, wleaf, num, den = 0.0, "", 0.0, 0.0
    mine = sh.local_params(ref)
    for (path, a), b, full in zip(flatten_tree(got), tree_leaves(mine),
                                  tree_leaves(ref)):
        a, b = a.float(), b.float()
        d = float((a - b).abs().max() / full.float().abs().max()
                  .clamp_min(1e-30))
        if d > worst:
            worst, wleaf = d, "/".join(map(str, path))
        if first or sh.model_dim(path, a.dim()) is not None:
            num += float((a - b).pow(2).sum())
            den += float(b.pow(2).sum())
    return worst, wleaf, num, den


def mp_plans(cfg) -> tuple:
    """The model parallel part's plans, 2 rows of MP_SEQ: the planner's
    first packed plan of short agentic trees (4 a batch), and its first
    plan of two agentic trees larger than a row, partitioned at MP_SEQ
    (3 waves).  Every rank plans them from the same seeds."""
    lc = LoaderConfig(seq_len=MP_SEQ, batch_rows=TRAIN_ROWS,
                      trees_per_batch=4, kind="agentic", seed=0,
                      gen_kwargs=MP_PACKED_GEN)
    packed = next(p for p in (ps.execution_plan() for ps in plans(cfg, lc, 8))
                  if p.packed is not None and not p.has_waves)
    lc = LoaderConfig(seq_len=MP_SEQ, batch_rows=TRAIN_ROWS,
                      trees_per_batch=2, kind="agentic", seed=1,
                      auto_partition=True, capacity=MP_SEQ,
                      gen_kwargs=MP_WAVE_GEN)
    wave = next(p for p in (ps.execution_plan() for ps in plans(
        cfg, lc, 8, PlannerConfig(max_rows=TRAIN_ROWS))) if p.has_waves)
    return packed, wave


def mp_rank(rank: int, dev, cfg) -> dict:
    """Phase 10b on one rank of (b)'s world: the (data 1, model 2) mesh
    (MP_SHAPE).  For (a) ``cfg`` (4 layers f32) and (b) the same at
    MP_BF16_LAYERS in bf16: this rank's blocks drawn from seed 0
    (``init_params`` under the mesh) and world 1's full params from the
    same seed; for ``mp_plans``' packed and wave plan, with sequence
    parallelism off and on, one ``accumulate`` on the mesh (its launches
    counted around it) beside world 1's, each rank holding its blocks of
    the grads against world 1's (``mp_block_rel``; the errors combined
    over the axis: no full gradient crosses the host).  Returns the
    rank's rows."""
    from repro_torch import sharding as sh
    from repro_torch.launch.mesh import MeshDescriptor
    mesh = MeshDescriptor("mp", MP_SHAPE, ("data", "model"),
                          ("data",)).build(dev.type)
    t0 = time.perf_counter()
    packed, wave = mp_plans(cfg)
    rows = []
    parts = (("a", cfg), ("b", cfg.replace(n_layers=MP_BF16_LAYERS,
                                            dtype="bfloat16")))
    for part, c in parts:
        with sh.use_mesh(None):
            full = init_params(c, torch.Generator(dev).manual_seed(0),
                               device=dev)
        with sh.use_mesh(mesh):
            local = init_params(c, torch.Generator(dev).manual_seed(0),
                                device=dev)
        for name, plan in (("packed", packed), ("waves", wave)):
            with sh.use_mesh(None):
                ref = TreeTrainEngine(c).accumulate(full, plan)
            for sp in (False, True):
                with sh.use_mesh(mesh, seq_parallel=sp):
                    reset_launches()
                    torch.cuda.synchronize(dev)
                    t1 = time.perf_counter()
                    grads, scal = TreeTrainEngine(c).accumulate(local, plan)
                    torch.cuda.synchronize(dev)
                    t2 = time.perf_counter()
                    counts = launch_counts()
                    worst, leaf, num, den = mp_block_rel(grads, ref[0],
                                                         rank == 0)
                    ax = sh.model_axis()
                    tot = torch.tensor([num, den], dtype=torch.float64,
                                       device=dev)
                    top = torch.tensor([worst], device=dev)
                    dist.all_reduce(tot, group=ax.group)
                    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=ax.group)
                rows.append(dict(
                    part=part, plan=name, sp=sp, launches=counts,
                    want=plan_launches(c.n_layers, plan),
                    s=round(t2 - t1, 3), max_rel=float(top), leaf=leaf,
                    rank_max_rel=worst, rel_l2=math.sqrt(float(tot[0])
                                                         / float(tot[1])),
                    loss=float(scal[0]), loss1=float(ref[1][0])))
                del grads
            del ref
        del full, local
        torch.cuda.empty_cache()
    return dict(rows=rows, wall_s=round(time.perf_counter() - t0, 3),
                reckoning=mp_bf16_reckoning(cfg))


def mp_report(res: list) -> dict:
    """Phase 10b's prints and checks, from the ranks' rows."""
    rows0 = res[0]["mp"]["rows"]
    for r0, r1 in zip(rows0, res[1]["mp"]["rows"]):
        tag = (f"model parallel ({r0['part']}, {r0['plan']}, sequence "
               f"parallelism {'on' if r0['sp'] else 'off'})")
        rel = abs(r0["loss"] - r0["loss1"]) / max(abs(r0["loss1"]), 1e-12)
        leaf = max((r0, r1), key=lambda r: r["rank_max_rel"])["leaf"]
        log(f"{tag}: mesh {MP_SHAPE}, loss {r0['loss']:.7f} vs world 1's "
            f"{r0['loss1']:.7f} (rel {rel:.2e}); the ranks' grad blocks "
            f"max-rel {r0['max_rel']:.3e} of world 1's (at {leaf}), "
            f"relative L2 {r0['rel_l2']:.3e}; launches by rank "
            f"{[r0['launches'], r1['launches']]} (want {r0['want']}); "
            f"accumulate s by rank {[r0['s'], r1['s']]}")
        check(r0["launches"] == r0["want"] and r1["launches"] == r0["want"],
              f"{tag}: launches")
        if r0["part"] == "a":
            check(rel <= 1e-6 and r0["max_rel"] <= 1e-4, f"{tag}: loss "
                  f"{rel:.2e} or grads {r0['max_rel']:.2e}")
        else:
            check(r0["rel_l2"] <= 5e-2, f"{tag}: gradient relative L2 "
                                        f"{r0['rel_l2']:.2e}")
    log(f"model parallel (b) depth, reduced: {res[0]['mp']['reckoning']}; "
        f"the part took {res[0]['mp']['wall_s']:.1f} s on rank 0")
    return dict(wall_s=res[0]["mp"]["wall_s"],
                launches=[[r["launches"] for r in x["mp"]["rows"]]
                          for x in res],
                rows=[(r["part"], r["plan"], r["sp"]) for r in rows0])


def ep_reckoning(cfg) -> tuple[str, float]:
    """The device memory the expert parallel phase needs, reckoned from the
    config at MOE_TRAIN_LAYERS layers in f32 (its larger part): each rank
    holds world 1's parameters and fp32 grads, its blocks, their grads and
    world 1's grads cut to its blocks, and a layer's activations at 2
    rows of MP_SEQ (about 8 [tokens, D] f32 tensors and the dispatch's
    [E, C + 1, D] and [E, C, F] ones, twice for the ranks' own)."""
    L, D, V = MOE_TRAIN_LAYERS, cfg.d_model, cfg.padded_vocab
    m, a = cfg.moe, cfg.attn
    ne = EP_SHAPE[1]
    expert = (3 if cfg.mlp_activation == "swiglu" else 2) * \
        m.num_experts * D * m.d_expert
    attn = D * (a.q_dim + 2 * a.kv_dim) + a.q_dim * D + D * m.num_experts
    n = 2 * V * D + L * (expert + attn)
    block = n // ne
    tok = TRAIN_ROWS * MP_SEQ
    C = moe_layer.capacity(tok, m)
    act = L * 4 * (8 * tok * D + m.num_experts * C * (D + 2 * m.d_expert))
    rank = 4 * (2 * n + 3 * block) + act * 3 // 2
    return (f"{L} layers f32: world 1 {n / 1e9:.3f} B params "
            f"({expert / 1e9:.3f} B in a layer's experts), a rank's blocks "
            f"{block / 1e9:.3f} B; a rank ~{rank / 1e9:.1f} GB (world 1's "
            f"params and fp32 grads, its blocks, their grads and world 1's "
            f"cut to them, activations), two ranks ~{2 * rank / 1e9:.1f} GB "
            f"beside the script's own process"), 2 * rank


class RouteRecord:
    """While active, every MoE call's routing as the layer's own ``route``
    and ``queue`` return it: ``top_e`` [N, K], the kept (token, slot)
    pairs and the valid tokens.  With ``pin`` (a record of the same calls
    in another run) call i routes each token to the experts that ``pin``'s
    call i chose, weighted by this call's router probabilities of them
    (renormalised), as ``PinnedRouting`` does: a run that differs from the
    pinned one by near-tie flips then makes its routing and drops."""

    def __init__(self, pin: "RouteRecord" = None):
        self.top_e, self.keep, self.valid, self.pin = [], [], [], pin

    def __enter__(self):
        self._route, self._queue = moe_layer.route, moe_layer.queue

        def route(params, mcfg, xf):
            logits, probs, top_p, top_e = self._route(params, mcfg, xf)
            if self.pin is not None:
                top_e = self.pin.top_e[len(self.top_e)]
                top_p = torch.gather(probs, 1, top_e)
                top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True),
                                            min=1e-9)
            self.top_e.append(top_e)
            return logits, probs, top_p, top_e

        def queue(top_e, vmask, *args):
            out = self._queue(top_e, vmask, *args)
            self.keep.append(out[2])
            self.valid.append(vmask)
            return out

        moe_layer.route, moe_layer.queue = route, queue
        return self

    def __exit__(self, *exc):
        moe_layer.route, moe_layer.queue = self._route, self._queue

    def flips(self, other: "RouteRecord") -> tuple[int, int]:
        """(valid tokens whose top-k expert set differs from ``other``'s,
        valid tokens), over the calls."""
        check(len(self.top_e) == len(other.top_e),
              "expert parallel: the two runs made different MoE calls")
        n = d = 0
        for a, b, v in zip(self.top_e, other.top_e, self.valid):
            diff = (a.sort(-1).values != b.sort(-1).values).any(-1)
            n += int((diff & v).sum())
            d += int(v.sum())
        return n, d


def ep_agree(rec: RouteRecord, ax) -> bool:
    """Every MoE call's ``top_e`` torch.equal on every rank of the model
    axis ``ax``: rank 0's broadcast over the axis and compared."""
    mine = torch.cat([t.reshape(-1) for t in rec.top_e])
    first = mine.clone()
    dist.broadcast(first, src=dist.get_global_rank(ax.group, 0),
                   group=ax.group)
    same = torch.tensor([int(torch.equal(first, mine))], device=mine.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=ax.group)
    return bool(same.item())


def phase_expert_parallel(cfg_full) -> dict:
    """16a. Qwen3-30B-A3B at full width on a (data 1, model 2) mesh in a
    world of 2 spawned from the script (``ep_rank``: NCCL where the
    machine shows two devices, else gloo on the one card): the memory
    reckoned and printed first, then each rank's rows (``ep_report``)."""
    note, need = ep_reckoning(cfg_full)
    free = torch.cuda.mem_get_info()[0]
    log(f"expert parallel: {note}; {free / 1e9:.1f} GB free on the card")
    check(need < free, "expert parallel: the reckoned memory does not fit")
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    out = Path(tempfile.mkdtemp(prefix="ep_out_"))
    cfg = cfg_full.replace(n_layers=MOE_TRAIN_LAYERS)
    store = dp_store()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ep_rank, args=(r, 2, backend, store, cfg,
                                               str(out))) for r in range(2)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(EP_TIMEOUT_S - (time.perf_counter() - t0), 1))
        alive = [p for p in procs if p.is_alive()]
        check(not alive, f"expert parallel: {len(alive)} ranks still "
                         f"running after {EP_TIMEOUT_S} s")
        check(all(p.exitcode == 0 for p in procs), f"expert parallel: rank "
              f"exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    return ep_report(res, backend, time.perf_counter() - t0)


def ep_rank(rank: int, world: int, backend: str, store: str, cfg,
            out: str) -> None:
    """One rank of the expert parallel phase (a spawned process): joins
    the group and runs ``ep_parts``; writes rank<r>.json to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=EP_TIMEOUT_S),
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    try:
        res = ep_parts(rank, dev, cfg)
        Path(out, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def ep_parts(rank: int, dev, cfg) -> dict:
    """The expert parallel phase on one rank: the EP_SHAPE mesh, 64 of the
    128 experts and H 16/Kh 2 a rank.  For (a) ``cfg`` in f32 and (b) in
    bf16: this rank's blocks drawn from seed 0 (``init_params`` under the
    mesh) and world 1's full params from the same seed; for ``mp_plans``'
    packed and wave plan, world 1's ``accumulate`` with its routing
    recorded, then with sequence parallelism off and on one ``accumulate``
    on the mesh (its launches counted around it, its routing recorded):
    each rank's grad blocks against world 1's (``mp_block_rel``, combined
    over the axis), the routing ``torch.equal`` across the axis
    (``ep_agree``), the kept (token, slot) pairs against world 1's and
    the near-tie flips counted.  Where (b) misses its bar, the mesh runs
    again with world 1's routing pinned, and both figures are reported."""
    from repro_torch import sharding as sh
    from repro_torch.launch.mesh import MeshDescriptor
    mesh = MeshDescriptor("ep", EP_SHAPE, ("data", "model"),
                          ("data",)).build(dev.type)
    t0 = time.perf_counter()
    packed, wave = mp_plans(cfg)
    rows = []
    for part, c in (("a", cfg.replace(dtype="float32")),
                    ("b", cfg.replace(dtype="bfloat16"))):
        with sh.use_mesh(None):
            full = init_params(c, torch.Generator(dev).manual_seed(0),
                               device=dev)
        with sh.use_mesh(mesh):
            local = init_params(c, torch.Generator(dev).manual_seed(0),
                                device=dev)
            experts = tuple(local["layer_stacks"][0]["moe"]["wi_up"].shape)
        for name, plan in (("packed", packed), ("waves", wave)):
            with sh.use_mesh(None), RouteRecord() as r1:
                ref = TreeTrainEngine(c).accumulate(full, plan)
            for sp in (False, True):
                def run(pin=None):
                    with sh.use_mesh(mesh, seq_parallel=sp), \
                            RouteRecord(pin) as r2:
                        reset_launches()
                        torch.cuda.synchronize(dev)
                        t1 = time.perf_counter()
                        grads, scal = TreeTrainEngine(c).accumulate(local,
                                                                    plan)
                        torch.cuda.synchronize(dev)
                        s = time.perf_counter() - t1
                        counts = launch_counts()
                        worst, leaf, num, den = mp_block_rel(
                            grads, ref[0], rank == 0)
                        ax = sh.model_axis()
                        tot = torch.tensor([num, den], dtype=torch.float64,
                                           device=dev)
                        top = torch.tensor([worst], device=dev)
                        dist.all_reduce(tot, group=ax.group)
                        dist.all_reduce(top, op=dist.ReduceOp.MAX,
                                        group=ax.group)
                        agree = ep_agree(r2, ax)
                    del grads
                    return dict(
                        launches=counts, s=round(s, 3), max_rel=float(top),
                        leaf=leaf, rank_max_rel=worst,
                        rel_l2=math.sqrt(float(tot[0]) / float(tot[1])),
                        loss=float(scal[0]), agree=agree,
                        kept_equal=all(torch.equal(a, b) for a, b in
                                       zip(r2.keep, r1.keep))
                        and len(r2.keep) == len(r1.keep),
                        flips=r2.flips(r1), calls=len(r2.top_e))
                row = dict(part=part, plan=name, sp=sp, experts=experts,
                           want=plan_launches(c.n_layers, plan),
                           loss1=float(ref[1][0]), **run())
                if part == "b" and row["rel_l2"] > EP_BF16_L2:
                    pinned = run(r1)
                    row["pinned"] = {k: pinned[k] for k in (
                        "rel_l2", "max_rel", "flips", "kept_equal")}
                rows.append(row)
            del ref
        del full, local
        torch.cuda.empty_cache()
    return dict(rows=rows, wall_s=round(time.perf_counter() - t0, 3),
                peak_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 3))


def ep_report(res: list, backend: str, wall: float) -> dict:
    """The expert parallel phase's prints and checks, from the ranks'
    rows: (a) loss 1e-6 relative and the grad blocks 1e-4 max-rel of world
    1's, the routing torch.equal across the ranks and the kept slots world
    1's; (b) gradient relative L2 5e-2, or a miss the flips alone explain
    (world 1's routing pinned: within the bar), reported as such; each
    kernel ``plan_launches`` times by each rank."""
    rows0, rows1 = res[0]["rows"], res[1]["rows"]
    misses = []
    for r0, r1 in zip(rows0, rows1):
        tag = (f"expert parallel ({r0['part']}, {r0['plan']}, sequence "
               f"parallelism {'on' if r0['sp'] else 'off'})")
        rel = abs(r0["loss"] - r0["loss1"]) / max(abs(r0["loss1"]), 1e-12)
        leaf = max((r0, r1), key=lambda r: r["rank_max_rel"])["leaf"]
        pin = r0.get("pinned")
        log(f"{tag}: mesh {EP_SHAPE} over {backend}, expert blocks "
            f"{r0['experts']} a rank; loss {r0['loss']:.7f} vs world 1's "
            f"{r0['loss1']:.7f} (rel {rel:.2e}); the ranks' grad blocks "
            f"max-rel {r0['max_rel']:.3e} of world 1's (at {leaf}), "
            f"relative L2 {r0['rel_l2']:.3e}; routing torch.equal across "
            f"the ranks {r0['agree'] and r1['agree']} over {r0['calls']} "
            f"MoE calls; kept (token, slot) pairs world 1's "
            f"{r0['kept_equal']}; routing flips against world 1 "
            f"{share(*r0['flips'])} valid tokens"
            + (f"; with world 1's routing pinned: relative L2 "
               f"{pin['rel_l2']:.3e}, max-rel {pin['max_rel']:.3e}"
               if pin else "")
            + f"; launches by rank {[r0['launches'], r1['launches']]} (want "
            f"{r0['want']}); accumulate s by rank {[r0['s'], r1['s']]}")
        check(r0["launches"] == r0["want"] and r1["launches"] == r0["want"],
              f"{tag}: launches")
        check(r0["agree"] and r1["agree"], f"{tag}: the ranks routed "
                                           f"differently")
        if r0["part"] == "a":
            check(rel <= 1e-6 and r0["max_rel"] <= 1e-4, f"{tag}: loss "
                  f"{rel:.2e} or grads {r0['max_rel']:.2e}")
            check(r0["kept_equal"], f"{tag}: kept slots differ from world "
                                    f"1's")
        elif pin is not None:
            check(r0["flips"][0] > 0 and pin["rel_l2"] <= EP_BF16_L2,
                  f"{tag}: gradient relative L2 {r0['rel_l2']:.2e}, "
                  f"{pin['rel_l2']:.2e} with the routing pinned")
            misses.append(tag)
            log(f"{tag}: MISS of the {EP_BF16_L2:g} bar that the routing "
                f"flips alone "
                f"explain (pinned {pin['rel_l2']:.3e}); see ROADMAP Queue C")
    log(f"expert parallel: ranks' parts {res[0]['wall_s']:.1f} and "
        f"{res[1]['wall_s']:.1f} s, peak device memory by rank "
        f"{[r['peak_gb'] for r in res]} GB, wall {wall:.1f} s with the "
        f"ranks' start-up")
    return dict(wall_s=wall, misses=misses, backend=backend,
                launches=[[r["launches"] for r in x["rows"]] for x in res],
                rows=[(r["part"], r["plan"], r["sp"]) for r in rows0])


def graph_pool_bytes() -> tuple[int, int]:
    """(bytes in use, bytes reserved) in the CUDA-graph pools: the caching
    allocator's segments outside its default pool."""
    used = held = 0
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg["segment_pool_id"]) != (0, 0):
            used += seg["allocated_size"]
            held += seg["total_size"]
    return used, held


def rl_shape(tm: dict, step_s: float) -> tuple:
    """(groups, max_new, predicted generation seconds a step, a group's
    fixed s, a new token's s, a capture's s): the most generation a step
    whose groups take at most 1/RL_TRAIN_OVER_GEN of a train step,
    reckoned from this run's serve phase and train phase (the median
    step).  In the loop a group costs its prefill (the session's
    1024-token prefill) and then a new token's time: its decode graphs
    were captured before the loop (``rl_loop._warm``), and its lease's one
    copy of the cache is left in the token time.  A new token's time is
    the median of the serve phase's groups of 64 new tokens less their
    prefill and their capture (a serve session captures its own graph:
    its first step less its mean replayed step).  Where no shape meets the
    rule (a slow host), the smallest runs and the reading is printed."""
    prefill_s = tm["first_prefill_s"] * RL_PROMPT / 1024
    n = tm["decode_tok"] // RL_K
    capture_s = tm["first_decode_s"] - (
        tm["decode_s"] - tm["first_decode_s"]) / (n - 1)
    fixed_s = prefill_s
    tok_s = max(tm["group_s"] - prefill_s - capture_s, 0.0) / 63
    for groups in (2, 1):
        for max_new in RL_MAX_NEW:
            gen_s = groups * (fixed_s + (max_new - 1) * tok_s)
            if (RL_TRAIN_OVER_GEN * gen_s <= step_s
                    and RL_PROMPT + RL_K * max_new <= TRAIN_SEQ):
                return groups, max_new, gen_s, fixed_s, tok_s, capture_s
    return 1, RL_MAX_NEW[-1], gen_s, fixed_s, tok_s, capture_s


def run_rl(cfg, argv: list, tag: str, profile=None) -> tuple:
    """``rl_loop.main(argv)`` with the kernels' launches counted per
    thread, the synchronizing calls counted per thread and each step
    audited (``StepAudit``), and the graph pools' bytes read after each
    rollout group in the generator's thread.  Prints a line a step, the
    generator's totals and the warm-up's (seconds, decode graphs captured
    before the loop, generation seconds a group); requires 0 decode-graph
    captures and 0 engine retraces in the loop and 0 cache flushes.
    Returns (main's record, the step rows, the generator's launches, the
    audit)."""
    counters = {name: ThreadCount() for name in KERNELS}
    for name, fn in KERNELS.items():
        fn.launches = counters[name]
    group, pools = service.rollout_group, []

    def pooled(*args, **kw):
        out = group(*args, **kw)        # its sessions are closed on return
        pools.append(graph_pool_bytes())
        return out

    service.rollout_group = pooled
    try:
        with SyncLog() as syncs, StepAudit(syncs, counters,
                                           profile) as audit:
            res = rl_loop.main(argv)
    finally:
        reset_launches()
        service.rollout_group = group
    gen = {k: c.split()[1] for k, c in counters.items()}
    # the attention layers a forward runs (Zamba2: its shared block's
    # applications)
    L = cfg.n_layers if cfg.hybrid is None else shared_apps(cfg)
    for m, row in zip(res["history"], audit.rows):
        log(f"{tag} step {m['step']}: {m['ms']:.1f} ms (wall "
            f"{m['wall_ms']:.1f} ms), loss {m['loss']:.4f}, lag "
            f"{m.get('max_lag')}, versions {m['versions']}, peak "
            f"{m['peak_gb']:.2f} GB, allocated after {row['alloc_gb']:.2f} "
            f"GB, reserved {row['reserved_gb']:.2f} GB; trainer syncs "
            f"{row['syncs']} (engine {row['host_syncs']}), trainer launches "
            f"{row['launches']}")
    st = res["stats"]
    log(f"{tag}: generator thread: launches {gen} over "
        f"{st.trees_generated} groups, synchronizing calls "
        f"{syncs.count(RL_GEN_THREAD)} (its own, left out of the "
        f"trainer's); {st.trees_generated} trees, {res['dropped']} "
        f"dropped, wall {res['wall_s']:.3f} s, max lag {res['max_lag_seen']} (bound "
        f"{res['lag_bound']}), generation busy {st.gen_busy_s * 1e3:.1f} ms, "
        f"exposed {res['exposed_s'] * 1e3:.1f} ms, overlap "
        f"{100 * res['overlap']:.1f}%, prefill {st.prefill_tokens} tokens "
        f"(+{st.saved_prefill_tokens} reused), decode {st.decode_tokens} "
        f"tokens, {res['plans_built']} plans built "
        f"({res['plan_build_s'] * 1e3:.1f} ms), warm-up "
        f"{res['warmup_s']:.2f} s")
    log(f"{tag}: warm-up {res['warmup_s']:.3f} s, {res['captures_before']} "
        f"decode graphs captured before the loop, {res['captures_in_loop']} "
        f"in it, {res['reuses']} leases; engine retraces "
        f"{res['retraces']}, exposed compile wait "
        f"{res['compile_wait_s'] * 1e3:.1f} ms, {res['prewarmed']} "
        f"executables prewarmed; generation {st.gen_busy_s * 1e3:.1f} ms "
        f"over {st.trees_generated} groups: "
        f"{st.gen_busy_s / max(st.trees_generated, 1):.4f} s a group")
    mem = res["memory"]
    log(f"{tag}: graph pools after each of {len(pools)} groups (MB in use, "
        f"reserved): {[(u / 1e6, h / 1e6) for u, h in pools]}; device "
        f"memory after the loop: {mem['reserved_gb']:.2f} GB reserved, "
        f"{mem['free_gb']:.2f} GB of {mem['total_gb']:.2f} GB free (the "
        f"headroom left for an allocation while a graph captures), "
        f"{mem['cache_flushes']} cache flushes in the loop")
    check(len(pools) == res["stats"].trees_generated
          and all(p == pools[0] for p in pools),
          f"{tag}: the graph pools grew from group to group: {pools}")
    check(mem["cache_flushes"] == 0,
          f"{tag}: the allocator flushed its cache {mem['cache_flushes']} "
          f"times in the loop")
    check(res["captures_in_loop"] == 0 and res["retraces"] == 0,
          f"{tag}: {res['captures_in_loop']} decode-graph captures and "
          f"{res['retraces']} retraces in the loop")
    for m, row in zip(res["history"], audit.rows):
        check(row["syncs"] == 1 and row["host_syncs"] == 1,
              f"{tag} step {m['step']}: {row['syncs']} synchronizing calls "
              f"on the trainer's thread, {row['host_syncs']} engine syncs")
        check(all(n == L for n in row["launches"].values()),
              f"{tag} step {m['step']}: trainer launches "
              f"{row['launches']}, want {L} each")
    check(len(audit.rows) == len(res["history"]), f"{tag}: unaudited steps")
    return res, audit.rows, gen, audit


def rl_argv(arch: str, **kw) -> list:
    argv = ["--arch", arch]
    for k, v in kw.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    return argv


def phase_rl_loop(cfg, tm: dict, step_s: float) -> dict:
    """The async tree-RL loop, Qwen2-1.5B at full width and depth, through
    ``rl_loop.main``: at --max-ahead 1 (RL_LOOP_STEPS steps, the gradient
    check, a profiled window of two steps in the middle) and on-policy at
    --max-ahead 0 (RL_LOOP_STEPS_A0 steps)."""
    groups, max_new, gen_s, fixed_s, tok_s, capture_s = rl_shape(tm, step_s)
    log(f"rl loop: this run's serve phase: a group (prompt {RL_PROMPT}, k "
        f"{RL_K}, 64 new tokens) {tm['group_s']:.3f} s, of which the "
        f"prefill {fixed_s:.4f} s (a group's fixed cost in the loop, whose "
        f"decode graphs are captured before it) and the graph capture "
        f"{capture_s:.4f} s, a new token {tok_s * 1e3:.2f} ms; train phase: "
        f"step {step_s:.3f} s; chosen {groups} groups x {max_new} new "
        f"tokens: generation {gen_s:.3f} s a step, train/generation "
        f"{step_s / gen_s:.2f} (want >= {RL_TRAIN_OVER_GEN}"
        + ("" if step_s >= RL_TRAIN_OVER_GEN * gen_s
           else "; not met: the smallest shape runs") + ")")
    shape = dict(prompt_len=RL_PROMPT, k=RL_K, seq_len=TRAIN_SEQ,
                 rows=TRAIN_ROWS, lookahead=1, groups=groups,
                 max_new=max_new)
    a = RL_PROFILE
    res, rows, gen, audit = run_rl(cfg, rl_argv(
        RL_ARCH, max_ahead=1, steps=RL_LOOP_STEPS, check_grads=True, **shape),
        "rl loop", profile=a)
    st = res["stats"]
    L = cfg.n_layers
    check(gen["tree_attention_fwd"] == L * st.trees_generated
          and gen["tree_attention_bwd_dq"] == gen["tree_attention_bwd_dkv"]
          == 0, f"rl loop: generator launches {gen}, want {L} forward a "
                f"group")
    peaks = [m["peak_gb"] for m in res["history"]]
    snap_gb = cfg.param_count() * 2 / 1e9        # bf16 weights
    log(f"rl loop: peak GB per step {[round(p, 2) for p in peaks]}; after "
        f"step 1 at most {max(peaks[2:]):.2f} GB against step 1's "
        f"{peaks[1]:.2f} GB + one snapshot ({snap_gb:.2f} GB, the one term "
        f"that depends on whether the generator still holds the last "
        f"snapshot)")
    check(max(peaks[2:]) <= peaks[1] + snap_gb,
          "rl loop: peak memory grew after step 1")
    log(f"rl loop: profiled window (steps {a[0]}-{a[1]}, both threads "
        f"live):")
    path = Path(__file__).resolve().parent / "build" / "rl_loop_trace.json"
    path.parent.mkdir(exist_ok=True)
    audit.prof.export_chrome_trace(str(path))
    raw = path.read_bytes()
    path.unlink()
    path.with_suffix(".json.gz").write_bytes(gzip.compress(raw))
    report_trace(json.loads(raw)["traceEvents"],
                 f"window of steps {a[0]}-{a[1]} of the rl loop",
                 gaps=RL_GAPS, by_stream=True)
    del raw
    res0, rows0, gen0, _ = run_rl(cfg, rl_argv(
        RL_ARCH, max_ahead=0, steps=RL_LOOP_STEPS_A0, **shape),
        "rl loop A=0")
    w1 = statistics.mean(m["wall_ms"] for m in res["history"][1:3])
    w0 = statistics.mean(m["wall_ms"] for m in res0["history"][1:3])
    log(f"rl loop: per-step wall of steps 1-2, --max-ahead 1 {w1:.1f} ms "
        f"vs --max-ahead 0 (on-policy: generation and training take turns) "
        f"{w0:.1f} ms: {w0 / w1:.3f}x; generation busy a step "
        f"{res['stats'].gen_busy_s / RL_LOOP_STEPS * 1e3:.1f} ms (A=1) and "
        f"{res0['stats'].gen_busy_s / RL_LOOP_STEPS_A0 * 1e3:.1f} ms (A=0)")
    check(res0["max_lag_seen"] == 0, "rl loop A=0: off-policy step")
    return dict(shape=shape, res=res, rows=rows, gen=gen, res0=res0,
                rows0=rows0, gen0=gen0, wall=(w1, w0))


def sampled_group(cfg, store, prompt, seed: int, out: dict, got, pool,
                  buf, greedy: bool = False, early=None) -> None:
    """One group of RL_K branches and RL_PARITY_NEW tokens (sampled at
    temperature 1 by a generator seeded ``seed``, or ``greedy``) from
    ``store``'s snapshot, read on a stream of its own as the service's
    generator reads it: the snapshot is copied into the parameter buffer
    ``buf``, and the sessions lease their decode graphs from ``pool``
    (``GraphPool``: the first group captures them, every later one
    replays them); sets ``got`` once it holds the snapshot.  The thread
    drops its references to the snapshot before it reads the results
    back.  With ``early`` (two events), the stream sleeps RL_HOLD_CYCLES
    before the copy, so that the snapshot's read (and every step after
    it) is still queued when the thread drops the snapshot; it then sets
    ``early[0]``, waits for ``early[1]`` and records in ``out["queued"]``
    whether its work is still queued.  Puts the snapshot's version, every
    prefill and decode logit and the tokens into ``out`` (or the error)."""
    try:
        stream = torch.cuda.Stream()
        temp = 0.0 if greedy else 1.0
        with torch.cuda.stream(stream), torch.inference_mode():
            params, out["version"] = store.get()
            got.set()
            if early is not None:
                torch.cuda._sleep(RL_HOLD_CYCLES)
            service.copy_into(buf, params)
            gen = torch.Generator(DEV).manual_seed(seed)
            sess = DecodeSession.create(cfg, buf,
                                        buf_len=RL_PROMPT + RL_PARITY_NEW,
                                        graph_pool=pool)
            lg = sess.prefill(prompt)
            logits = [lg]
            br = sess.fork(RL_K)
            tok = sample_tokens(lg.expand(RL_K, -1), cfg.vocab_size, gen,
                                temp)
            toks = [tok]
            for _ in range(RL_PARITY_NEW - 1):
                lg = br.step(tok)
                logits.append(lg)
                tok = sample_tokens(lg, cfg.vocab_size, gen, temp)
                toks.append(tok)
            tokens = torch.stack(toks, 1)
            sess.close()
            br.close()
            del params, sess, br
            if early is not None:
                early[0].set()
                early[1].wait(120)
                out["queued"] = not stream.query()
            out["tokens"] = tokens.cpu()
            out["logits"] = logits
            stream.synchronize()
    except BaseException as e:          # noqa: BLE001 — reported by caller
        out["error"] = e
        got.set()
        if early is not None:
            early[0].set()


def group_thread(cfg, store, prompt, seed: int, out: dict, pool, buf,
                 **kw):
    got = threading.Event()
    t = threading.Thread(target=sampled_group, name=RL_GEN_THREAD,
                         args=(cfg, store, prompt, seed, out, got, pool,
                               buf), kwargs=kw)
    t.start()
    got.wait(120)
    return t


class NoRecordStream:
    """A planted fault: ``Tensor.record_stream`` does nothing, so a
    dropped snapshot's memory is free for reuse while another stream's
    queued kernels still read it."""

    def __enter__(self):
        self._orig = torch.Tensor.record_stream
        torch.Tensor.record_stream = lambda t, stream: None
        return self

    def __exit__(self, *exc):
        torch.Tensor.record_stream = self._orig


def logit_diffs(a: dict, b: dict) -> list:
    """The logit calls of two groups that are not bit-identical."""
    return [i for i, (x, y) in enumerate(zip(a["logits"], b["logits"]))
            if not torch.equal(x, y)]


def phase_rl_parity(cfg, plan, grad_err: float) -> dict:
    """(a) frozen rollout group: online plan path vs offline RL gradients,
    full depth bf16 (the rl loop's --check-grads) and PARITY_LAYERS layers
    in f32, each ≤ 1e-6 max-rel; (b) a sampled group generated from a
    just-published snapshot while the trainer runs RL_PARITY_STEPS steps,
    then from the same weights alone: equal tokens, every logit
    ``torch.equal``; (b') a greedy group that drops the snapshot while its
    reads are queued and the trainer publishes twice, against the greedy
    group alone, and the same under ``NoRecordStream`` as a control; (c)
    after every publish the store's snapshot equals the trainer's
    parameters (``torch.equal`` on every leaf).  The groups run one after
    another through one ``GraphPool`` and parameter buffer, as the loop's
    generator does: (b)'s concurrent group captures the decode graph and
    the four later groups replay it."""
    log(f"rl parity (a): full depth bf16, frozen rollout group at the rl "
        f"loop's final weights: max-rel {grad_err:.3e} (bar 1e-6)")
    cfg4 = cfg.replace(n_layers=PARITY_LAYERS, dtype="float32")
    p4 = init_params(cfg4, torch.Generator(DEV).manual_seed(0))
    rc = RolloutConfig(k=RL_K, prompt_len=RL_PROMPT, max_new=RL_PARITY_NEW,
                       temperature=1.0)
    with torch.inference_mode():
        tree, _ = rollout_group(cfg4, p4, np.arange(RL_PROMPT)
                                % cfg.vocab_size, rc,
                                torch.Generator(DEV).manual_seed(1))
    lc = LoaderConfig(seq_len=TRAIN_SEQ, batch_rows=TRAIN_ROWS,
                      trees_per_batch=1, mode="tree", seed=0,
                      loss_mode="rl", auto_partition=True)
    err4 = rl_loop.check_frozen_grads(
        cfg4, lc, PlannerConfig(lookahead=1, max_rows=TRAIN_ROWS), p4,
        [tree], "kernel")
    log(f"rl parity (a): {PARITY_LAYERS} layers f32: max-rel {err4:.3e} "
        f"(bar 1e-6)")
    check(grad_err <= 1e-6 and err4 <= 1e-6, "rl parity (a)")
    del p4, tree
    torch.cuda.empty_cache()

    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    opt_state = init_opt_state(params)
    store = WeightStore(params)
    engine = TreeTrainEngine(cfg, OptimizerConfig(
        lr=3e-4, warmup_steps=2, total_steps=RL_PARITY_STEPS + 1),
        weight_store=store)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, RL_PROMPT)
    same = []
    with torch.inference_mode():
        pool, buf = GraphPool(), map_tree(torch.empty_like, params)

    def stepped():
        nonlocal params, opt_state
        params, opt_state, _ = engine.step(params, opt_state, plan)
        snap, ver = engine.weight_store.get()
        same.append(ver == engine.steps_done and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(snap),
                                              tree_leaves(params))))

    stepped()               # publishes v1; its copy may still be queued
    side = {}
    t0 = time.perf_counter()
    thread = group_thread(cfg, store, prompt, 7, side, pool, buf)
    keep = map_tree(torch.clone, store.get()[0])
    t1 = time.perf_counter()
    for _ in range(RL_PARITY_STEPS):
        stepped()
    t2 = time.perf_counter()
    thread.join(300)
    t3 = time.perf_counter()
    check(not thread.is_alive() and "error" not in side,
          f"rl parity (b): the concurrent group failed: {side.get('error')}")
    dropped = {}
    for name, fault in (("b'", None), ("control", NoRecordStream)):
        engine.weight_store = WeightStore(keep)    # the store holds v1
        out = dropped[name] = {}
        ev = (threading.Event(), threading.Event())
        with fault() if fault else contextlib.nullcontext():
            thread = group_thread(cfg, engine.weight_store, prompt, 7, out,
                                  pool, buf, greedy=True, early=ev)
            ev[0].wait(120)             # its last reference is gone
            for _ in range(2):          # the store drops v1; allocations
                stepped()
            ev[1].set()
            thread.join(300)
        check(not thread.is_alive() and "error" not in out,
              f"rl parity ({name}): the group failed: {out.get('error')}")
    del params, opt_state, engine, store
    torch.cuda.empty_cache()
    alone, greedy = {}, {}
    group_thread(cfg, WeightStore(keep), prompt, 7, alone, pool,
                 buf).join(300)
    check("error" not in alone, f"rl parity (b): {alone.get('error')}")
    group_thread(cfg, WeightStore(keep), prompt, 7, greedy, pool, buf,
                 greedy=True).join(300)
    check("error" not in greedy, f"rl parity (b'): {greedy.get('error')}")
    n = len(side["logits"])
    diff = logit_diffs(side, alone)
    log(f"rl parity (b): a group of {RL_K} x {RL_PARITY_NEW} sampled tokens "
        f"from snapshot v{side['version']}, generated in {t3 - t0:.3f} s "
        f"while the trainer ran {RL_PARITY_STEPS} steps ({t2 - t1:.3f} s), "
        f"then alone: tokens equal "
        f"{torch.equal(side['tokens'], alone['tokens'])}, {n - len(diff)} "
        f"of {n} logit calls bit-identical")
    late = {k: logit_diffs(v, greedy) for k, v in dropped.items()}
    for k, v in dropped.items():
        log(f"rl parity ({k}): a greedy group of {RL_K} x {RL_PARITY_NEW} "
            f"tokens whose thread dropped the snapshot with its reads "
            f"queued (the stream slept {RL_HOLD_CYCLES:.2e} cycles), the "
            f"trainer publishing twice meanwhile"
            + (", with record_stream disabled (a control)" if k != "b'"
               else "")
            + f": still queued after the steps {v['queued']}, tokens "
              f"equal to the group alone "
              f"{torch.equal(v['tokens'], greedy['tokens'])}, "
              f"{n - len(late[k])} of {n} logit calls bit-identical")
    log(f"rl parity (c): after each of {len(same)} publishes the snapshot "
        f"equals the trainer's parameters: {same}")
    check(side["version"] == 1, "rl parity (b): the group read another "
                                "snapshot than v1")
    check(torch.equal(side["tokens"], alone["tokens"]) and not diff,
          f"rl parity (b): calls {diff[:8]} differ")
    b2, bad = dropped["b'"], late["b'"]
    check(b2["queued"], "rl parity (b'): the group's work was done before "
                        "the trainer's steps; the sleep is too short")
    check(torch.equal(b2["tokens"], greedy["tokens"]) and not bad,
          f"rl parity (b'): calls {bad[:8]} differ")
    check(all(same), "rl parity (c)")
    log(f"rl parity: the five groups' decode graphs: {pool.captures} "
        f"captured (by (b)'s concurrent group), {pool.reuses} leases")
    check(pool.captures == 1 and pool.reuses == 4,
          f"rl parity: {pool.captures} captures, {pool.reuses} leases "
          f"(want 1 and 4)")
    return dict(err_bf16=grad_err, err_f32=err4, calls=n,
                control_diffs=len(late["control"]))


def phase_ssm_rl_loop(cfg) -> dict:
    """The rl loop at Zamba2-1.2B's full width and depth: its sessions step
    the prompt (no kernel launch in generation), and each train step
    launches each kernel once per application of the shared block."""
    res, rows, gen, _ = run_rl(cfg, rl_argv(
        HYBRID_ARCH, prompt_len=512, k=RL_K, max_new=32, groups=1,
        steps=RL_LOOP_STEPS_A0, seq_len=TRAIN_SEQ, rows=TRAIN_ROWS,
        max_ahead=1), "zamba2 rl loop")
    check(all(v == 0 for v in gen.values()),
          f"zamba2 rl loop: generation launched {gen}")
    return dict(res=res, rows=rows, gen=gen)


# --------------------------------------------------------------------------
# the MoE model: Qwen3-30B-A3B
# --------------------------------------------------------------------------

class RoutingLog:
    """While active, records every MoE layer call's routing: for each token
    its top-k experts (sorted), which of its (token, slot) pairs its expert
    kept, and whether it is valid.  They are recomputed from the layer's own
    input by ``moe.route`` and ``moe.queue``, the functions the layer calls,
    so the layer's output is the unwrapped layer's.  Sessions step eagerly
    meanwhile (``DecodeSession.graph_steps``): a replayed CUDA graph runs
    no Python, so the log would miss every replayed step."""

    def __init__(self):
        # (B, S, top_e sorted [N, K], keep [N, K], valid [N]) per call
        self.calls = []

    def __enter__(self):
        real = self._real = moe_layer.moe

        def recorded(params, mcfg, x, valid, activation, **kw):
            B, S, D = x.shape
            top_e = moe_layer.route(params, mcfg, x.reshape(-1, D))[3]
            _, _, keep = moe_layer.queue(top_e, valid.reshape(-1),
                                         mcfg.num_experts,
                                         moe_layer.capacity(B * S, mcfg))
            self.calls.append((B, S, top_e.sort(-1).values,
                               keep.view(B * S, -1), valid.reshape(-1)))
            return real(params, mcfg, x, valid, activation, **kw)

        transformer.moe = decode.moe = recorded
        DecodeSession.graph_steps = False
        return self

    def __exit__(self, *exc):
        transformer.moe = decode.moe = self._real
        DecodeSession.graph_steps = True

    def busiest(self, first: int, n: int) -> list:
        """For calls first .. first+n−1 (one call's layers): the share of
        the call's valid tokens that chose its busiest expert."""
        return [float(torch.bincount(top_e[valid].reshape(-1)).max())
                / int(valid.sum())
                for _, _, top_e, _, valid in self.calls[first:first + n]]

    def drop_share(self, decode_calls: bool) -> tuple[int, int]:
        """(dropped, total) valid (token, slot) pairs over the prefill
        calls (S > 1) or the decode calls (S = 1)."""
        dropped = total = 0
        for _, S, _, keep, valid in self.calls:
            if (S == 1) == decode_calls:
                dropped += int((~keep & valid[:, None]).sum())
                total += int(valid.sum()) * keep.shape[1]
        return dropped, total


class PinnedRouting:
    """While active, the i-th MoE layer call routes each token to the
    experts that the i-th call recorded in ``log`` chose for it, weighted
    by this call's own router probabilities of those experts
    (renormalised): a replay then makes the recorded run's routing and
    capacity drops, and differs from it only where the layers' inputs do,
    not by whole experts where a near-tie flipped."""

    def __init__(self, log: RoutingLog):
        self.log, self.i = log, 0

    def __enter__(self):
        real = self._real = moe_layer.route

        def pinned(params, mcfg, xf):
            logits, probs, _, _ = real(params, mcfg, xf)
            top_e = self.log.calls[self.i][2]
            self.i += 1
            top_p = torch.gather(probs, 1, top_e)
            return logits, probs, top_p / torch.clamp(
                top_p.sum(-1, keepdim=True), min=1e-9), top_e

        moe_layer.route = pinned
        DecodeSession.graph_steps = False      # see RoutingLog
        return self

    def __exit__(self, *exc):
        moe_layer.route = self._real
        DecodeSession.graph_steps = True


def flipped_tokens(a: RoutingLog, b: RoutingLog) -> list:
    """Per MoE call of two runs over the same inputs: the [N] bool of valid
    tokens whose top-k expert set differs."""
    check(len(a.calls) == len(b.calls), "the two runs made different MoE "
                                        "calls")
    return [(ea != eb).any(-1) & va
            for (_, _, ea, _, va), (_, _, eb, _, _) in zip(a.calls, b.calls)]


def share(n: int, d: int) -> str:
    return f"{n} of {d} ({100 * n / max(d, 1):.3f}%)"


def head_bytes(cfg) -> int:
    """Bytes of the weights outside the layers, as ``init_params`` makes
    them: the embedding and LM head over the padded vocabulary, and the
    final norm."""
    n = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return (n + cfg.d_model) * (2 if cfg.dtype == "bfloat16" else 4)


def layer_bytes(cfg, kind: str) -> int:
    """Bytes of one ``kind`` ('dense' or 'moe') layer's weights, as
    ``init_params`` makes them (an MoE layer's router is fp32)."""
    D, a = cfg.d_model, cfg.attn
    n = 2 * D + 2 * D * a.q_dim + 2 * D * a.kv_dim
    n += (a.q_dim + 2 * a.kv_dim) * a.qkv_bias + 2 * a.head_dim * a.qk_norm
    mult = 3 if cfg.mlp_activation == "swiglu" else 2
    router = 0
    if kind == "moe":
        m = cfg.moe
        n += (m.num_experts + m.num_shared_experts) * mult * D * m.d_expert
        router = 4 * D * m.num_experts
    else:
        n += mult * D * cfg.d_ff + (cfg.d_ff + D) * cfg.mlp_bias
    return n * (2 if cfg.dtype == "bfloat16" else 4) + router


def fit_depth(cfg, limit: float, scale: float = 1.0,
              per_layer: float = 0.0) -> int:
    """The deepest cut of ``cfg`` (its layers in order, the leading dense
    ones first) for which ``scale`` × the weights' bytes, plus
    ``per_layer`` bytes a layer, stay within ``limit``.  The head and each
    layer are reckoned directly (``head_bytes``, ``layer_bytes``), not as
    ``param_count`` differences, which go negative for a cut above
    ``first_dense_layers``."""
    used, depth = scale * head_bytes(cfg), 0
    for kind, n in layer_groups(cfg):
        for _ in range(n):
            used += scale * layer_bytes(cfg, kind) + per_layer
            if used > limit:
                return depth
            depth += 1
    return depth


def serve_depth(cfg) -> int:
    """The deepest cut whose weights, with SERVE_WORK for the caches,
    activations and parity replays, stay within PEAK_LIMIT."""
    return fit_depth(cfg, PEAK_LIMIT - SERVE_WORK)


def step_loop_cut(cfg):
    """``cfg`` at STEP_LOOP_SERVE_DEPTH of its depth (an enc-dec model's
    encoder and decoder both), and the words that say so."""
    L = round(cfg.n_layers * STEP_LOOP_SERVE_DEPTH)
    cut = cfg.replace(n_layers=L)
    if cfg.encdec is not None:
        cut = cut.replace(encdec=dataclasses.replace(
            cfg.encdec, dec_layers=L, enc_layers=round(
                cfg.encdec.enc_layers * STEP_LOOP_SERVE_DEPTH)))
    return cut, (f"reduced: {L} of {cfg.n_layers} layers, "
                 f"STEP_LOOP_SERVE_DEPTH")


def weights_match(cfg, params) -> bool:
    """Whether ``head_bytes`` and ``layer_bytes`` count the model's
    weights to the byte."""
    got = sum(t.numel() * t.element_size() for _, t in flatten_tree(params))
    return got == head_bytes(cfg) + sum(
        n * layer_bytes(cfg, kind) for kind, n in layer_groups(cfg))


def decode_bound(cfg, params, tm, tag: str) -> None:
    """Log the session's decode rate against its bound: a decode step of 8
    branches reads every weight but the embedding table once (an MoE
    layer multiplies every expert, at capacity 1)."""
    step_bytes = sum(t.numel() * t.element_size()
                     for p, t in flatten_tree(params) if p[0] != "embed")
    bound_s = step_bytes / PEAK_BYTES
    cap = ("" if cfg.moe is None else
           f" (every expert multiplies at capacity "
           f"{moe_layer.capacity(8, cfg.moe)})")
    log(f"{tag}: decode {tm['decode_tok'] / tm['decode_s']:.1f} tokens/s "
        f"(8 branches, {tm['decode_s'] / (tm['decode_tok'] / 8) * 1e3:.2f} ms "
        f"a step) against its bound: a step reads {step_bytes / 1e9:.2f} GB "
        f"of weights{cap}, >= {bound_s * 1e3:.2f} ms at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s, so at most {8 / bound_s:.1f} tokens/s")


def moe_serve_checks(cfg, params, calls, logits, tag: str) -> None:
    """Teacher-forced replays of the session up to its second prefill,
    through the kernels and the plain attention, with the routing
    recorded: the dropped share of (token, slot) pairs and the routing
    balance, then bf16 parity (b), four checks:

    - pinned: every call's logits at relative L2 ≤ 5e-2 against a third
      replay, through the plain attention with the kernel replay's routing
      pinned (``PinnedRouting``): the attention alone, at equal routing;
    - unpinned, where top-k > 1: the prefill calls' logits at relative L2
      ≤ 5e-2 against the plain replay that routes for itself.  With top-1 a
      near-tie that the two attentions' rounding flips replaces the
      token's whole routed FFN output, and each later layer compounds it,
      so a top-1 arch's unpinned logits are reported, not checked;
    - routing agreement at the prompt's first MoE layer, where no earlier
      flip has compounded: ≥ 95% of its tokens choose the same experts;
    - where top-k = 1: the prefill calls' routing agreement over every
      (token, MoE layer) ≥ 90%.

    A kernel fault that moves the routing fails the last three."""
    with torch.inference_mode():
        # the replays end at the second prefill: both prefills and the 32
        # decode steps between them
        with RoutingLog() as rk:
            _, lk, tmk = multiturn(cfg, params, "kernel", record=calls,
                                   tail_steps=0)
        with RoutingLog() as rr:
            _, lr, _ = multiturn(cfg, params, "ref", record=calls,
                                 tail_steps=0)
        with PinnedRouting(rk) as pin:
            _, lp, _ = multiturn(cfg, params, "ref", record=calls,
                                 tail_steps=0)
    check(pin.i == len(rk.calls), f"{tag}: the pinned replay made "
          f"{pin.i} MoE calls, the kernel replay {len(rk.calls)}")
    same = all(torch.equal(a, b) for a, b in zip(lk, logits))
    pre = [i for i, k in enumerate(tmk["kinds"]) if k == "prefill"]
    e_pin = max(rel_l2(a, b) for a, b in zip(lk, lp))
    e_pin_pre = max(rel_l2(lk[i], lp[i]) for i in pre)
    e_pre = max(rel_l2(lk[i], lr[i]) for i in pre)
    e_all = max(rel_l2(a, b) for a, b in zip(lk, lr))
    flips = flipped_tokens(rk, rr)
    n_pre = sum(int(f.sum()) for f, c in zip(flips, rk.calls) if c[1] > 1)
    n_dec = sum(int(f.sum()) for f, c in zip(flips, rk.calls) if c[1] == 1)
    d_pre = sum(int(c[4].sum()) for c in rk.calls if c[1] > 1)
    d_dec = sum(int(c[4].sum()) for c in rk.calls if c[1] == 1)
    log(f"{tag}: share of (token, slot) pairs dropped (capacity "
        f"{cfg.moe.capacity_factor} x N·K/E per call, N the call's tokens): "
        f"prefill {share(*rk.drop_share(False))}, decode "
        f"{share(*rk.drop_share(True))} (capacity "
        f"{moe_layer.capacity(8, cfg.moe)} at 8 branches)")
    n_moe = sum(n for kind, n in layer_groups(cfg) if kind == "moe")
    busy = rk.busiest(0, n_moe)     # the prompt's prefill, layer by layer
    by_layer = [int(f.sum()) for f in flips[:n_moe]]
    m = cfg.moe
    log(f"{tag}: routing balance of the prompt's prefill (1024 tokens, "
        f"top-{m.top_k} of {m.num_experts}: "
        f"{100 * m.top_k / m.num_experts:.2f}% each if uniform, capacity "
        f"{100 * moe_layer.capacity(1024, m) / 1024:.2f}%): "
        f"the busiest expert takes {100 * busy[0]:.1f}% of the tokens at "
        f"the first MoE layer, {100 * statistics.median(busy):.1f}% at the "
        f"median MoE layer, {100 * max(busy):.1f}% at most (MoE layer "
        f"{busy.index(max(busy))})")
    agree_pre = 1 - n_pre / max(d_pre, 1)
    agree_first = 1 - by_layer[0] / max(int(rk.calls[0][4].sum()), 1)
    held = m.top_k > 1
    log(f"{tag} parity (b): {cfg.n_layers} layers bf16, kernel vs plain "
        f"attention, teacher-forced multi-turn replay with the kernel "
        f"replay's routing pinned: max relative L2 of logits {e_pin:.3e} "
        f"over {len(lk)} calls (limit 5e-2; prefill calls {e_pin_pre:.3e}); "
        f"each routing for itself: prefill logits {e_pre:.3e} "
        f"({'limit 5e-2' if held else 'top-1, not checked'}), every call's "
        f"{e_all:.3e} (not checked); routing agreement over (token, MoE "
        f"layer): the prompt's first MoE layer {100 * agree_first:.3f}% "
        f"(limit 95%), prefill {100 * agree_pre:.3f}% "
        f"({'limit 90%' if not held else 'not checked'}; {n_pre} of {d_pre} "
        f"differ; the prompt's prefill by MoE layer: {by_layer}), decode "
        f"{100 - 100 * n_dec / max(d_dec, 1):.3f}% ({n_dec} of {d_dec}); the "
        f"kernel replay reproduces the timed run's logits bit for bit: "
        f"{same}")
    check(e_pin <= 5e-2, f"{tag} parity (b), pinned routing")
    check(not held or e_pre <= 5e-2, f"{tag} parity (b), own routing")
    check(agree_first >= 0.95, f"{tag} parity (b), routing agreement at the "
                               f"first MoE layer")
    check(held or agree_pre >= 0.90, f"{tag} parity (b), prefill routing "
                                     f"agreement")


def load_cut(cfg_full, L: int, tag: str, why: str):
    """``cfg_full`` cut to ``L`` layers with random bf16 weights from seed
    0 (the MoE router fp32), checked against ``head_bytes`` and
    ``layer_bytes``; logs the cut, the parameters and the memory."""
    cfg = cfg_full.replace(n_layers=L)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    check(weights_match(cfg, params), f"{tag}: head_bytes + layer_bytes do "
          f"not count the weights")
    a = cfg.attn
    cut = "" if L == cfg_full.n_layers else (
        f" (reduced: {L} of {cfg_full.n_layers} layers, {why})")
    kinds = ", ".join(f"{n} {kind}" for kind, n in layer_groups(cfg))
    moe = "" if cfg.moe is None else (
        f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} d_expert "
        f"{cfg.moe.d_expert} + {cfg.moe.num_shared_experts} shared, capacity "
        f"factor {cfg.moe.capacity_factor} (router fp32)")
    log(f"{tag}: {cfg.name} {L} layers{cut} [{kinds}] d {cfg.d_model} d_ff "
        f"{cfg.d_ff} {cfg.mlp_activation} vocab {cfg.vocab_size} heads "
        f"{a.n_heads}/{a.n_kv_heads} hd {a.head_dim}"
        f"{' qk_norm' if a.qk_norm else ''}{moe}, {cfg.dtype}: "
        f"{cfg.param_count() / 1e9:.3f} B params ({cfg_full.param_count() / 1e9:.3f} B "
        f"at full depth), {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, random weights in {time.perf_counter() - t0:.2f} s")
    return cfg, params


def phase_arch_serve(arch: str, tag: str = "", groups: int = 1):
    """One arch at full width and the deepest cut whose bf16 weights fit
    (``serve_depth``; all 48 layers of Qwen3-30B-A3B): ``groups`` rollout
    groups, the multi-turn session and a profiled decode step
    (``phase_serve``), the decode rate against its bound, then parity (b),
    the session replayed teacher-forced through the plain attention at the
    same depth in bf16: every call's logits at relative L2 ≤ 3e-2 for a
    dense arch, ``moe_serve_checks`` for an MoE arch.  Returns (the serve
    run's forward launches, the depth)."""
    cfg_full = get_config(arch)
    L = serve_depth(cfg_full)
    tag = tag or f"{arch} serve"
    cfg, params = load_cut(cfg_full, L, tag, f"the bf16 weights fit "
                           f"{(PEAK_LIMIT - SERVE_WORK) / 1e9:.0f} GB")
    calls, logits, tm, launches = phase_serve(cfg, params, tag, groups)
    decode_bound(cfg, params, tm, tag)
    if cfg.moe is not None:
        moe_serve_checks(cfg, params, calls, logits, tag)
    else:
        e = replay_error(cfg, params, calls, logits, rel_l2)
        log(f"{tag} parity (b): {L} layers bf16, kernel vs plain attention, "
            f"teacher-forced multi-turn: max relative L2 of logits {e:.3e} "
            f"(limit 3e-2)")
        check(e <= 3e-2, f"{tag} parity (b)")
    del params, logits
    torch.cuda.empty_cache()
    return launches, L


def phase_f32_parity(cfg_full, layers: int, tag: str):
    """(a) ``layers`` layers at full width in f32: the multi-turn session
    through the kernels, replayed teacher-forced through the plain
    attention, with routing recorded.  A (token, layer) whose expert set
    differs between the two (a near-tie in the top-k flipped by sub-1e-6
    differences) is reported, and the logits rows it can reach are left
    out of the check: its own branch from that call on, every branch if
    it lies in the shared prompt.  A dense cut has no routing to flip."""
    cfg = cfg_full.replace(n_layers=layers, dtype="float32")
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    with torch.inference_mode():
        with RoutingLog() as rk:
            calls, lk, _ = multiturn(cfg, params, "kernel",
                                     torch.Generator(DEV).manual_seed(2))
        with RoutingLog() as rr:
            _, lr, _ = multiturn(cfg, params, "ref", record=calls)
    flips = flipped_tokens(rk, rr)
    n_moe = sum(n for kind, n in layer_groups(cfg) if kind == "moe")
    all_rows, tainted = False, set()
    worst, compared, excluded = 0.0, 0, 0
    for c, (a, b) in enumerate(zip(lk, lr)):
        for f, (B, S, *_) in zip(flips[c * n_moe:(c + 1) * n_moe],
                                 rk.calls[c * n_moe:(c + 1) * n_moe]):
            rows = set(np.nonzero(f.view(B, S).any(-1).cpu().numpy())[0])
            all_rows |= bool(rows) and B == 1
            tainted |= rows
        keep = [r for r in range(a.shape[0]) if not all_rows
                and r not in tainted]
        if keep:
            worst = max(worst, max_rel(a[keep], b[keep]))
        compared += len(keep)
        excluded += a.shape[0] - len(keep)
    n_flip = sum(int(f.sum()) for f in flips)
    n_dec = sum(int(c[4].sum()) for c in rk.calls)
    log(f"{tag} (a): {layers} layers f32 at full width, kernel vs plain "
        f"attention, teacher-forced multi-turn: max relative error of logits "
        f"{worst:.3e} (limit 1e-4) over {compared} rows; routing flips "
        f"{n_flip} of {n_dec} (token, MoE layer) decisions, {excluded} "
        f"logits rows left out for them")
    check(compared > 0, f"{tag} (a): every row was left out")
    check(worst <= 1e-4, f"{tag} (a)")
    del params


def prefix_keys(batch) -> dict:
    """{key: flat index (b·S + s)} of a packed batch's valid tokens, keyed
    by the token sequence of the path that ends in them (followed through
    ``prev_idx``): a tree token and its copies in the per-branch baseline
    share a key, and equal keys mean equal inputs."""
    tok, prev, val = (batch[k].cpu().numpy() for k in ("tokens", "prev_idx",
                                                        "valid"))
    B, S = tok.shape
    keys = {}
    for b in range(B):
        h = [0] * S
        for s in range(S):
            if val[b, s]:
                p = prev[b, s]
                h[s] = hash((h[p] if p >= 0 else 0, int(tok[b, s])))
                keys[h[s]] = b * S + s
    return keys


def tree_baseline_flips(rt: RoutingLog, bt, rb: RoutingLog, bb) -> tuple:
    """(flipped, compared) (token, layer) routing decisions between a
    tree-packed batch and its per-branch baseline, matched by path."""
    kt, kb = prefix_keys(bt), prefix_keys(bb)
    check(set(kb) <= set(kt), "a baseline token has no tree token")
    it = torch.tensor([kt[k] for k in kb], device=DEV)
    ib = torch.tensor(list(kb.values()), device=DEV)
    flipped = sum(int((ct[2][it] != cb[2][ib]).any(-1).sum())
                  for ct, cb in zip(rt.calls, rb.calls))
    return flipped, len(kb) * len(rt.calls)


def phase_moe_train_parity(cfg_full):
    """1 layer at full width in f32, one packed row of 2048: (a) kernel vs
    plain attention; (b) tree vs per-branch baseline with the aux losses
    off and capacity factor E/K (capacity never binds); then, not checked,
    tree vs baseline at the real capacity factor with the aux losses on."""
    cfg = cfg_full.replace(n_layers=1, dtype="float32")
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    trees = row_trees(cfg, 2048)
    bt, bb = tree_and_baseline(cfg, trees, 2048)
    with RoutingLog() as rk:
        lk, _, gk = value_and_grad(cfg, params, bt, "kernel")
    with RoutingLog() as rr:
        lr, _, gr = value_and_grad(cfg, params, bt, "ref")
    e_loss = abs(float(lk) - float(lr)) / abs(float(lr))
    e_g, leaf, l2, l2leaf = grads_rel(gk, gr)
    n_flip = sum(int(f.sum()) for f in flipped_tokens(rk, rr))
    log(f"moe train parity (a): 1 layer f32 at full width, one packed row of "
        f"2048 ({len(trees)} trees, {int(bt['valid'].sum())} tokens), kernel "
        f"vs plain attention: loss {float(lk):.6f} vs {float(lr):.6f}, "
        f"relative error {e_loss:.3e} (limit 1e-5); relative L2 of the "
        f"flattened gradient {l2:.3e} (limit 1e-4), worst leaf {l2leaf}; "
        f"max-rel {e_g:.3e} at {leaf}; routing flips {n_flip} of "
        f"{int(bt['valid'].sum())} tokens")
    del gr
    m = cfg.moe
    strict = cfg.replace(moe=dataclasses.replace(
        m, router_aux_weight=0.0, router_z_weight=0.0,
        capacity_factor=m.num_experts / m.top_k))
    res = {}
    for name, c in (("strict", strict), ("real", cfg)):
        with RoutingLog() as rt:
            l_t, mt, g_t = value_and_grad(c, params, bt, "kernel")
        with RoutingLog() as rb:
            l_b, _, g_b = value_and_grad(c, params, bb, "kernel")
        res[name] = (float(l_t), float(l_b), float(mt["aux_loss"]),
                     *grads_rel(g_t, g_b),
                     *tree_baseline_flips(rt, bt, rb, bb))
        del g_t, g_b
    l_t, l_b, aux, e_gb, leaf_b, l2_b, l2leaf_b, fl, n = res["strict"]
    e_loss_b = abs(l_t - l_b) / abs(l_b)
    C_t = moe_layer.capacity(bt["tokens"].numel(), strict.moe)
    log(f"moe train parity (b): 1 layer f32 through the kernels, aux losses "
        f"off, capacity factor {strict.moe.capacity_factor:g} (C = N: "
        f"{C_t} for the tree's row), tree (1 row) vs per-branch baseline "
        f"({bb['tokens'].shape[0]} rows of 2048, {int(bb['valid'].sum())} "
        f"tokens): loss {l_t:.6f} vs {l_b:.6f}, relative error "
        f"{e_loss_b:.3e} (limit 1e-5); relative L2 of the flattened gradient "
        f"{l2_b:.3e} (limit 1e-4), worst leaf {l2leaf_b}; max-rel {e_gb:.3e} "
        f"at {leaf_b}; routing flips {fl} of {n} (baseline token, layer) "
        f"decisions matched to the tree by path")
    r = res["real"]
    log(f"moe train parity, not checked: at the real capacity factor "
        f"{m.capacity_factor} with the aux losses on, tree and baseline "
        f"differ by design (C comes from each batch's N, and the aux losses "
        f"are means over its valid tokens): loss {r[0]:.6f} vs {r[1]:.6f} "
        f"(relative {abs(r[0] - r[1]) / abs(r[1]):.3e}; tree aux {r[2]:.3e}), "
        f"gradient relative L2 {r[5]:.3e}, routing flips {r[7]} of {r[8]}")
    check(e_loss <= 1e-5 and l2 <= 1e-4, "moe train parity (a)")
    check(e_loss_b <= 1e-5 and l2_b <= 1e-4, "moe train parity (b)")
    check(aux == 0.0, "moe train parity (b): the aux losses are not off")
    del params, gk


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

# graph_ms: calls longer than this many ms go into its graph this many times
LONG_CALL_MS, LONG_CALL_REPS = 2.0, 4


def time_ms(fn, reps=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def graph_ms(fn, reps=20):
    """Device time of one call: CUDA events around the replay of a CUDA
    graph holding ``reps`` calls (median of 5 replays, divided by
    ``reps``), so the host's launch overhead, which ``time_ms`` includes
    whenever a call's device work is shorter than its host work, is not in
    it.  A call that takes more than LONG_CALL_MS (timed once after the
    warm-up) goes into the graph LONG_CALL_REPS times instead: its launch
    overhead is already negligible.  None where the call cannot be
    captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        if a.elapsed_time(b) > LONG_CALL_MS:
            reps = LONG_CALL_REPS
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        log(f"timing: CUDA graph capture failed ({e}); no device time")
        torch.cuda.synchronize()
        return None
    ts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    del g
    return statistics.median(ts)


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def dev_pct(bound_ms: float, dev_ms) -> str:
    """", at N% of its bound" for a measured device time."""
    return "" if dev_ms is None else f", at {100 * bound_ms / dev_ms:.1f}% " \
        "of its bound"


def dense_mask(kl, S: int, q_off: int) -> torch.Tensor:
    """[B, 1, S, Skv] bool: the tree mask, for the library yardstick and
    for counting visible pairs."""
    Skv = kl.shape[1]
    i = q_off + torch.arange(S, device=DEV)
    return ((torch.arange(Skv, device=DEV)[None, :] <= i[:, None])
            & (kl[:, None, :] >= i[None, :, None]))[:, None]


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_timing_serve() -> dict:
    """The forward kernel at the serving path's two shapes, A and B; returns
    {shape: its kernel, plain, library and bound times}."""
    rng = np.random.default_rng(9)
    shapes = [("A", "prefill S=1024 q_off=0", 1, 1024, 0),
              ("B", "tool prefill S=200 q_off=1056", 8, 200, 1056)]
    out = {}
    with torch.inference_mode():
        for tag, name, B, S, q_off in shapes:
            H, Kh, hd, dt = 12, 2, 128, torch.bfloat16
            Skv = q_off + S
            q, k, v = qkv(rng, B, S, Skv, H, Kh, hd, dt)
            kl = i32(np.concatenate([np.full((B, q_off), BIG),
                                     np.full((B, S), Skv - 1)], 1))
            sc = hd ** -0.5
            mask = dense_mask(kl, S, q_off)
            # the yardstick gets K/V expanded to every query head (outside
            # the timed call) so any of PyTorch's masked backends can run
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (t.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
                      .contiguous() for t in (k, v))
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=sc)
            kern = lambda: ta.tree_attention(q, k, v, kl, sc, q_off=q_off)
            plain_f = lambda: tree_attention_ref_ext(q, k, v, kl, sc,
                                                     q_off=q_off)
            e_lib = float((lib().transpose(1, 2).float()
                           - kern().float()).abs().max())
            ms_k, ms_p, ms_l = time_ms(kern), time_ms(plain_f), time_ms(lib)
            dev_k, dev_l = graph_ms(kern), graph_ms(lib)
            # the work the function needs: 2·hd for q·k and 2·hd for p·v on
            # each visible (query, key) pair of every head
            flops = 4 * hd * H * int(mask.sum())
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 \
                + kl.numel() * 4
            bnd, by = bound(flops, nbytes)
            out[tag] = dict(ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
                            bound_ms=bnd, bound_by=by,
                            pct_of_bound=100 * bnd / ms_k, device_ms=dev_k,
                            library_device_ms=dev_l)
            log(f"timing forward, {tag}: {name} (B={B}, H=12, Kh=2, hd=128, "
                f"bf16, CUDA events, median of 20 after 3 warm-up): kernel "
                f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, sdpa (dense bool mask) "
                f"{ms_l:.4f} ms (kernel / sdpa {ms_k / ms_l:.2f}x); device "
                f"time in a CUDA graph: kernel {fmt_ms(dev_k)}, sdpa "
                f"{fmt_ms(dev_l)}; bound "
                f"{bnd:.4f} ms by {by}, kernel at {100 * bnd / ms_k:.1f}% of "
                f"it ({flops / 1e9:.3f} GFLOP on visible pairs, "
                f"{nbytes / 1e6:.3f} MB); kernel at "
                f"{flops / ms_k / 1e9:.1f} TFLOP/s; sdpa vs kernel "
                f"max_abs_err {e_lib:.3e}")
    return out


def sdpa_bwd_device_ms(q, k, v, dout, **kw):
    """Device time of SDPA's backward: a CUDA graph of its forward and
    backward together (``torch.autograd.grad`` to q, k, v), less a graph of
    the forward alone, both on fresh leaves.  Autograd runs a node's
    backward on the stream its forward ran on, so the pair is captured on
    the capturing stream, where the backward of a forward run outside it is
    not (nor may an autograd node of such a forward still be alive: the
    engine would sync with the stream it was made on).  Depends on no
    profiler trace.  None where either capture fails."""
    leaves = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
    fwd = lambda: F.scaled_dot_product_attention(*leaves, **kw)
    both = graph_ms(lambda: torch.autograd.grad(fwd(), leaves, dout))
    alone = graph_ms(fwd)
    return None if both is None or alone is None else both - alone


def phase_timing_train(train_kv_last, step_s, n_layers: int,
                       heads=(12, 2), tag: str = "T", q_off: int = 0,
                       hd: int = 128):
    """All three kernels at a training shape (a train step's rows and
    their real kv_last over Skv keys, of which the first ``q_off`` are
    gateway ancestors; ``heads`` = (H, Kh)), with bounds on visible pairs.
    ``step_s`` (None: not reported) relates them to a step.  The plain
    versions run by whole GQA groups where their dense scores pass
    PLAIN_CHUNK, and are then timed over 5 calls after one warm-up."""
    rng = np.random.default_rng(10)
    B, Skv = train_kv_last.shape
    S = Skv - q_off
    (H, Kh), dt = heads, torch.bfloat16
    kl = i32(train_kv_last)
    q, k, v = qkv(rng, B, S, Skv, H, Kh, hd, dt)
    qo = dict(q_off=q_off)
    do = randn(rng, q.shape, dt)
    sc = hd ** -0.5
    out = {}
    fused = tab.fuses_delta(q)      # the dq kernel computes Δ itself
    with torch.inference_mode():
        o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True,
                                   **qo)
        _, dl = tab.bwd_dq(q, k, v, kl, o, lse, do, sc, **qo)
        pairs = int(dense_mask(kl, S, q_off).sum())
        fwd = lambda: ta.tree_attention(q, k, v, kl, sc, save_residuals=True,
                                        **qo)
        dq = lambda: tab.bwd_dq(q, k, v, kl, o, lse, do, sc, **qo)
        dkv = lambda: tab.bwd_dkv(q, k, v, kl, lse, dl, do, sc, **qo)
        ms = {"fwd": time_ms(fwd), "dq": time_ms(dq), "dkv": time_ms(dkv)}
        if not fused:     # the backward still runs the torch reduction
            ms["delta"] = time_ms(lambda: tab.delta(o, do))
        dev = {"fwd": graph_ms(fwd), "dq": graph_ms(dq), "dkv": graph_ms(dkv)}
        reps = dict(reps=5, warm=1) if len(kv_head_chunks(q, k)) > 1 \
            else {}
        ms["plain_fwd"] = time_ms(lambda: plain(
            q, k, v, kl, sc, return_lse=True, **qo), **reps)
        ms["plain_bwd"] = time_ms(lambda: plain_bwd(
            q, k, v, kl, o, lse, do, sc, **qo), **reps)
    mask = dense_mask(kl, S, q_off)
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (t.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
              .contiguous().requires_grad_(True) for t in (k, v))
    dot = do.transpose(1, 2).contiguous()
    ms["lib_fwd"] = time_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), attn_mask=mask, scale=sc))
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=sc)
    lib_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                          retain_graph=True)
    ms["lib_bwd"] = time_ms(lib_bwd)
    del ot
    dev["lib_fwd"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), attn_mask=mask, scale=sc))
    dev["lib_bwd"] = sdpa_bwd_device_ms(qt, kt, vt, dot, attn_mask=mask,
                                        scale=sc)
    del qt, kt, vt, mask
    io = 2 * (q.numel() + k.numel() + v.numel())      # bf16 q, k, v
    meta = kl.numel() * 4
    rows = 2 * B * H * S * 4                           # lse and Δ, f32
    # dq reads q, k, v, do (and o, where it computes Δ), lse (and Δ, where
    # it does not), and writes dq (and Δ)
    spec = {"fwd": (4, io + 2 * q.numel() + meta + B * H * S * 4),
            "dq": (6, io + (6 if fused else 4) * q.numel() + meta + rows),
            "dkv": (8, io + 2 * q.numel() + 4 * k.numel() + meta + rows)}
    bwd_sum = ms["dq"] + ms["dkv"]
    for key, (per_pair, nbytes) in spec.items():
        flops = per_pair * hd * H * pairs
        bnd, by = bound(flops, nbytes)
        plain_ms = ms["plain_fwd"] if key == "fwd" else ms["plain_bwd"]
        lib_ms = ms["lib_fwd"] if key == "fwd" else ms["lib_bwd"]
        lib_dev = dev["lib_fwd"] if key == "fwd" else dev["lib_bwd"]
        out[key] = dict(ms=ms[key], plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bnd, bound_by=by,
                        pct_of_bound=100 * bnd / ms[key], device_ms=dev[key],
                        library_device_ms=lib_dev)
        what = "forward" if key == "fwd" else "backward (dq, dk, dv)"
        log(f"timing {key} at {tag} (B={B}, S={S}, Skv={Skv}, q_off={q_off}, "
            f"H={H}, Kh={Kh}, hd={hd}, bf16, "
            f"real kv_last, {pairs} visible pairs; CUDA events, median of 20 "
            f"after 3 warm-up): kernel {ms[key]:.4f} ms, bound {bnd:.4f} ms "
            f"by {by} ({per_pair}·hd·H FLOPs per visible pair = "
            f"{flops / 1e12:.4f} TFLOP, {nbytes / 1e6:.3f} MB), kernel at "
            f"{100 * bnd / ms[key]:.1f}% of its bound, "
            f"{flops / ms[key] / 1e9:.1f} TFLOP/s; plain {what} "
            f"{plain_ms:.4f} ms; sdpa {what} (dense bool mask, K/V expanded) "
            f"{lib_ms:.4f} ms; device time: kernel {fmt_ms(dev[key])} (CUDA "
            f"graph{dev_pct(bnd, dev[key])}), sdpa {fmt_ms(lib_dev)} ("
            + ("CUDA graph" if key == "fwd" else
               "CUDA graph of forward + backward less the forward") + ")")
    d_txt = ("Δ computed inside the dq kernel, no torch reduction" if fused
             else f"plus the wrapper's Δ reduction {ms['delta']:.4f} ms")
    log(f"timing at {tag}: backward kernels dq + dk/dv {bwd_sum:.4f} ms "
        f"({d_txt}); plain backward "
        f"{ms['plain_bwd']:.4f} ms; sdpa backward {ms['lib_bwd']:.4f} ms "
        f"(kernels / sdpa {bwd_sum / ms['lib_bwd']:.2f}x); forward kernel / "
        f"sdpa forward {ms['fwd'] / ms['lib_fwd']:.2f}x")
    if None not in (dev["fwd"], dev["dq"], dev["dkv"]):
        log(f"timing at {tag}, device time: fwd {dev['fwd']:.4f} ms, dq + "
            f"dk/dv {dev['dq'] + dev['dkv']:.4f} ms (CUDA graphs); sdpa "
            f"backward {fmt_ms(dev['lib_bwd'])} (CUDA graph of forward + "
            f"backward less the forward)")
    if step_s is not None:
        att = n_layers * (ms["fwd"] + bwd_sum + ms.get("delta", 0.0)) / 1e3
        log(f"timing at {tag}: attention share of a train step: {n_layers} x "
            f"(fwd + dq + dk/dv{'' if fused else ' + Δ'}) = {att:.3f} s of "
            f"the {step_s:.3f} s median step ({100 * att / step_s:.1f}%)")
    out["dq"]["delta_in_kernel"] = fused
    return out


def run_archs(timed) -> dict:
    """The rest of the dense and MoE archs (ARCHS): the three kernels at
    their attention layouts against the plain versions, each arch served
    at the deepest cut that fits (``phase_arch_serve``) and held in f32 at
    up to PARITY_LAYERS layers, Qwen3-32B trained at its cut (2 SFT steps,
    1 RL step, tree vs baseline, the profiled step, determinism), each
    layout timed at the serving prefill and train-row shapes.  ``timed``
    runs and times one phase.  Returns the kernels' worst errors, each
    arch's (serve launches, depth), the train step's launches and config,
    and the layouts' timings."""
    tcfg = get_config(TRAIN_ARCH)
    tcfg = tcfg.replace(n_layers=fit_depth(tcfg, TRAIN_LIMIT, scale=7,
                                           per_layer=TRAIN_ACT_BYTES))
    asft = train_plans(tcfg, "agentic", "sep_avg", 2)
    arl = train_plans(tcfg, "grpo", "rl", 1)
    kl_a = np.asarray(asft[0].packed.inputs["kv_last"])
    arch_err = {"fwd": timed("arch kernel", phase_kernel,
                             arch_kernel_cases(kl_a), False)}
    arch_err.update(timed("arch bwd kernel", phase_bwd_kernel,
                          arch_kernel_cases(kl_a)))
    arch_runs = {}
    for arch in ARCHS:
        arch_runs[arch] = timed(f"{arch} serve", phase_arch_serve, arch)
        f32 = get_config(arch).replace(dtype="float32")
        timed(f"{arch} parity", phase_f32_parity, get_config(arch),
              min(PARITY_LAYERS, fit_depth(f32, PEAK_LIMIT - SERVE_WORK)),
              f"{arch} parity")
        torch.cuda.empty_cache()
    params, t_counts, t_step_s = timed(
        f"{TRAIN_ARCH} train", phase_train, tcfg, asft, arl,
        f"{TRAIN_ARCH} train")
    timed(f"{TRAIN_ARCH} determinism", phase_determinism, tcfg, params,
          [("packed", asft[0])], f"{TRAIN_ARCH} determinism")
    del params
    torch.cuda.empty_cache()
    timing_arch = {}
    tool = tool_kv_last()
    for names, H, Kh, hd in arch_layouts():
        lay = layout_tag(H, Kh, hd)
        trains = TRAIN_ARCH in names
        timing_arch[lay] = dict(archs=names, hd=hd, prefill=timed(
            f"timing {lay} prefill", phase_timing_train,
            np.full((1, 1024), 1023), None, 0, (H, Kh),
            f"{lay} serving prefill S=1024", 0, hd), tool=timed(
            f"timing {lay} tool prefill", phase_timing_train, tool, None, 0,
            (H, Kh), f"{lay} tool prefill S=200 q_off=1056", 1056, hd),
            train=timed(
            f"timing {lay} train", phase_timing_train, kl_a,
            t_step_s if trains else None, tcfg.n_layers, (H, Kh),
            f"{lay} train rows", 0, hd))
    return dict(err=arch_err, runs=arch_runs, train_counts=t_counts,
                train_cfg=tcfg, timing=timing_arch)


# --------------------------------------------------------------------------
# the SSM and hybrid archs (RWKV6-1.6B, the GDN stack, Zamba2-1.2B)
# --------------------------------------------------------------------------

def shared_apps(cfg) -> int:
    """Applications of the hybrid's shared attention block a forward (0
    for a pure SSM): each launches each kernel once."""
    return 0 if cfg.hybrid is None else -(-cfg.n_layers
                                         // cfg.hybrid.attn_every)


def ssm_desc(cfg) -> str:
    s = cfg.ssm
    att = "" if cfg.attn is None else (
        f", shared attention block every {cfg.hybrid.attn_every} layers "
        f"({shared_apps(cfg)} applications) heads {cfg.attn.n_heads}/"
        f"{cfg.attn.n_kv_heads} hd {cfg.attn.head_dim}")
    return (f"{cfg.name} {cfg.n_layers} {s.kind} layers d {cfg.d_model} "
            f"d_ff {cfg.d_ff} vocab {cfg.vocab_size} (padded "
            f"{cfg.padded_vocab}), SSM heads {s.n_heads(cfg.d_model)} hd "
            f"{s.head_dim} d_state {s.d_state} conv {s.conv_kernel} chunk "
            f"{s.chunk_size}{att}, {cfg.dtype}")


def zamba2_kernel_cases(train_kv_last):
    """The three kernels at Zamba2's attention layout (H 32/Kh 32, hd 64):
    the serving-width prefill (B 1, S 1024) in bf16 and the first
    chunk-aligned train rows (``train_kv_last``: B 2, S 4096, the
    chunk-padding tokens inside the rows invisible as keys) in bf16 and
    f32."""
    a = get_config(HYBRID_ARCH).attn
    H, Kh, hd = a.n_heads, a.n_kv_heads, a.head_dim
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    add = case_adder(np.random.default_rng(60), cases)
    lay = (f"{layout_tag(H, Kh, hd)} ({HYBRID_ARCH}; bf16 paths: "
           f"{bf16_paths(hd)})")
    add(f"{lay} path: prefill S=1024 bf16", bf16, 1, 1024, H, Kh, hd,
        np.full((1, 1024), 1023))
    B, S = train_kv_last.shape
    dead = int((train_kv_last < 0).sum())
    for dt in (bf16, f32):
        add(f"{lay} chunk-padded train rows (B={B}, S={S}, {dead} invisible "
            f"keys) {dt}", dt, B, S, H, Kh, hd, train_kv_last)
    return cases


def ssm_decode_bound(cfg, params, tm, tag: str) -> None:
    """The session's decode rate against its bound: a step of 8 branches
    reads every weight but the embedding table once, reads and writes
    every recurrent state and conv/shift tail, and reads the hybrid's KV
    rings once."""
    w = sum(t.numel() * t.element_size()
            for p, t in flatten_tree(params) if p[0] != "embed")
    cache = decode._init_cache(cfg, 8, 1536, DEV)
    st = sum(t.numel() * t.element_size()
             for g, grp in cache.items() for t in grp.values()
             if "pos" not in grp)
    ring = sum(t.numel() * t.element_size()
               for grp in cache.values() if "pos" in grp
               for t in grp.values())
    del cache
    step_bytes = w + 2 * st + ring
    bound_s = step_bytes / PEAK_BYTES
    log(f"{tag}: decode {tm['decode_tok'] / tm['decode_s']:.1f} tokens/s "
        f"(8 branches, {tm['decode_s'] / (tm['decode_tok'] / 8) * 1e3:.2f} ms "
        f"a step) against its bound: a step moves {step_bytes / 1e9:.3f} GB "
        f"({w / 1e9:.3f} GB of weights, {st / 1e6:.1f} MB of states read "
        f"and written, {ring / 1e6:.1f} MB of KV rings read), >= "
        f"{bound_s * 1e3:.3f} ms at {PEAK_BYTES / 1e12:.2f} TB/s, so at most "
        f"{8 / bound_s:.1f} tokens/s")


def phase_ssm_serve(arch: str):
    """One arch at full width and STEP_LOOP_SERVE_DEPTH of its depth,
    random bf16 weights: one rollout
    group (prompt 1024, K 8, 64 new tokens) and the multi-turn session,
    both prefilled through the step loop as the reference does; prefill
    and decode tokens/s, the decode bound, a profiled decode step.  No
    tree-attention kernel may launch (Zamba2's decode attention is the
    plain one).  Returns (cfg, params, the measured launch counts)."""
    tag = f"{arch} serve"
    cfg, cut = step_loop_cut(get_config(arch))
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in flatten_tree(params))
    log(f"{tag}: {ssm_desc(cfg)} ({cut}): {n / 1e9:.3f} B parameters "
        f"({cfg.param_count() / 1e9:.3f} B by the reference's formula), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, random weights in "
        f"{time.perf_counter() - t0:.2f} s")
    rc = RolloutConfig(k=8, prompt_len=1024, max_new=64, temperature=1.0)
    gen = torch.Generator(DEV).manual_seed(1)
    rng = np.random.default_rng(7)
    reset_launches()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, st = rollout_group(cfg, params, rng.integers(
            0, cfg.vocab_size, rc.prompt_len), rc, gen)
        torch.cuda.synchronize()
        t_group = time.perf_counter() - t0
        check(st.prefill_tokens == rc.prompt_len
              and st.decode_tokens == rc.k * (rc.max_new - 1),
              f"{tag}: group token counts {st}")
        check(tree.root.size >= rc.prompt_len and tree.num_leaves() == rc.k,
              f"{tag}: prompt not shared by {rc.k} leaves")
        calls, logits, tm = multiturn(cfg, params, "kernel", gen)
    counts = launch_counts()
    log(f"{tag}: one rollout group (prompt {rc.prompt_len}, k {rc.k}, "
        f"max_new {rc.max_new}) in {t_group:.3f} s; multi-turn session: "
        f"prefill {tm['prefill_tok'] / tm['prefill_s']:.1f} tokens/s "
        f"({tm['prefill_tok']} tokens through the step loop in "
        f"{tm['prefill_s']:.3f} s), decode "
        f"{tm['decode_tok'] / tm['decode_s']:.1f} tokens/s "
        f"({tm['decode_tok']} tokens in {tm['decode_s']:.3f} s); kernel "
        f"launches {counts} (the step loop runs no tree-attention kernel)")
    check(all(v == 0 for v in counts.values()),
          f"{tag}: serving launched a tree-attention kernel")
    ssm_decode_bound(cfg, params, tm, tag)
    with torch.inference_mode():
        sess = DecodeSession.create(cfg, params, buf_len=1536)
        sess.prefill(rng.integers(0, cfg.vocab_size, 16))
        br = sess.fork(8)
        tok = torch.zeros(8, dtype=torch.long, device=DEV)
        for _ in range(2):
            br.step(tok)
        profile_step(lambda: (br.step(tok), torch.cuda.synchronize()),
                     f"{arch}_decode_step_trace", "decode step")
    del calls, logits, br, sess
    return cfg, params, counts


def forward_logits(cfg, params, toks):
    """The packed forward's logits at the positions of ``toks`` (one chain,
    chunk-padded)."""
    T, cs = len(toks), cfg.ssm.chunk_size
    tb = pack_trees([serialize_tree(TrajectoryTree(TreeNode(tokens=toks)),
                                    chunk_size=cs)], T + (-T % cs),
                    chunk_size=cs)
    with torch.inference_mode():
        hidden, _ = transformer.forward(cfg, params,
                                        prepare_batch(cfg, tb, device=DEV))
        return logits_from_hidden(params["embed"], params.get("lm_head"),
                                  hidden[0, :T])


def step_logits(cfg, params, toks):
    """Teacher-forced: the logits of a session stepping ``toks`` one by
    one."""
    with torch.inference_mode():
        sess = DecodeSession.create(cfg, params,
                                    buf_len=len(toks) + cfg.ssm.chunk_size)
        return torch.stack([sess.step([int(t)])[0] for t in toks])


class BF16States:
    """While active, new SSM caches keep their fp32 recurrent states in
    bf16, so each step rounds the state: a deliberately broken step loop
    (control c of ``serve_parity_at``)."""

    def __enter__(self):
        real = self._real = decode._ssm_cache

        def broken(*args, **kw):
            return {k: t.bfloat16() if t.dtype == torch.float32 else t
                    for k, t in real(*args, **kw).items()}

        decode._ssm_cache = broken
        return self

    def __exit__(self, *exc):
        decode._ssm_cache = self._real


class ScaledSSMSteps:
    """While active, every SSM mixer's decode step returns its output
    times ``SSM_CONTROL_SCALE``: a step-loop fault of a set size (control
    d of ``serve_parity_at``), which the bf16 parity checks must fail."""
    NAMES = ("rwkv6_timemix_decode", "mamba2_decode", "gdn_decode")

    def __enter__(self):
        self._real = {n: getattr(decode, n) for n in self.NAMES}
        for n, fn in self._real.items():
            setattr(decode, n, lambda *a, fn=fn, **kw:
                    fn(*a, **kw) * SSM_CONTROL_SCALE)
        return self

    def __exit__(self, *exc):
        for n, fn in self._real.items():
            setattr(decode, n, fn)


def serve_parity_at(cfg, params, seed: int, tag: str) -> dict:
    """The step loop against the packed forward on SSM_PARITY_TOKENS
    teacher-forced tokens, bf16 ``params`` and the same weights in f32:
    relative L2 of logits, the bf16 step loop (s), the bf16 forward (f)
    and two broken bf16 step loops, c (``BF16States``) and d
    (``ScaledSSMSteps``), each against the f32 forward (F), and s, c, d
    against f; the f32 step loop against F element by element at atol =
    rtol = 5e-4.  Logs every number, checks nothing."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                SSM_PARITY_TOKENS)
    p32 = map_tree(lambda t: t.float(), params)
    cfg32 = cfg.replace(dtype="float32")
    F = forward_logits(cfg32, p32, toks)
    ok32, err32 = close(step_logits(cfg32, p32, toks), F, 5e-4)
    del p32
    f, s = forward_logits(cfg, params, toks), step_logits(cfg, params, toks)
    with BF16States():
        c = step_logits(cfg, params, toks)
    with ScaledSSMSteps():
        d = step_logits(cfg, params, toks)
    e = dict(sF=rel_l2(s, F), fF=rel_l2(f, F), cF=rel_l2(c, F),
             dF=rel_l2(d, F), sf=rel_l2(s, f), cf=rel_l2(c, f),
             df=rel_l2(d, f), ok32=ok32, finite=bool(torch.isfinite(s).all()))
    log(f"{tag}: {cfg.n_layers} layers, {SSM_PARITY_TOKENS} tokens "
        f"teacher-forced, relative L2 of logits: bf16 step loop vs f32 "
        f"forward {e['sF']:.3e}, bf16 forward vs f32 forward {e['fF']:.3e} "
        f"(ratio {e['sF'] / e['fF']:.3f}), bf16 step loop vs bf16 forward "
        f"{e['sf']:.3e}; control c (states stored in bf16): vs f32 forward "
        f"{e['cF']:.3e} (ratio {e['cF'] / e['fF']:.3f}), vs bf16 forward "
        f"{e['cf']:.3e}; control d (each SSM mixer's step output x "
        f"{SSM_CONTROL_SCALE}): vs f32 forward {e['dF']:.3e} (ratio "
        f"{e['dF'] / e['fF']:.3f}), vs bf16 forward {e['df']:.3e}; f32 step "
        f"loop vs f32 forward max abs error "
        f"{err32:.3e} (atol = rtol = 5e-4: {'ok' if ok32 else 'FAILED'})")
    return e


def phase_ssm_serve_parity(cfg, params):
    """The step loop (the serving path) against the packed forward (the
    training path), ``serve_parity_at`` at two depths:
    - every depth: the f32 step loop within atol = rtol = 5e-4 of the f32
      forward, the reference's decode bar (tests/test_serve.py:47-48);
    - the serve phase's depth (``cfg``: STEP_LOOP_SERVE_DEPTH of the
      arch's) and PARITY_LAYERS layers, bf16: the step loop within
      1.25x the bf16 forward's distance from the f32 forward (the
      reference's bf16 step loop drifts as far as the port's,
      tests/test_torch_ssm_model.py), and control d, a 2% fault in every
      SSM mixer's step, must fail that bar;
    - PARITY_LAYERS layers, bf16: also the step loop within relative L2
      3e-2 of the bf16 forward (deeper, the random model's own bf16
      drift exceeds 3e-2);
    - control c (states stored in bf16) is reported: it moves the logits
      by a few per cent of the bf16 drift, below any bar (PERF.md)."""
    tag = f"{cfg.name} serve parity"
    e = serve_parity_at(cfg, params, 12, tag)
    check(e["ok32"], f"{tag} (f32, {cfg.n_layers} layers)")
    check(e["finite"] and e["sF"] <= 1.25 * e["fF"],
          f"{tag} (bf16, {cfg.n_layers} layers)")
    check(e["dF"] > 1.25 * e["fF"], f"{tag}: control d passed the "
                                    f"{cfg.n_layers}-layer bf16 check")
    cfg4 = cfg.replace(n_layers=PARITY_LAYERS)
    p4 = init_params(cfg4, torch.Generator(DEV).manual_seed(0))
    e4 = serve_parity_at(cfg4, p4, 13, tag)
    del p4
    check(e4["ok32"], f"{tag} (f32, {PARITY_LAYERS} layers)")
    check(e4["finite"] and e4["sf"] <= 3e-2 and e4["sF"] <= 1.25 * e4["fF"],
          f"{tag} (bf16, {PARITY_LAYERS} layers)")
    check(e4["dF"] > 1.25 * e4["fF"], f"{tag}: control d passed the "
                                      f"{PARITY_LAYERS}-layer bf16 check")


def chunk_pads(plan) -> tuple[int, int]:
    """(chunk-padding tokens inside the packed rows: invalid tokens before
    each row's last real token, row cells)."""
    v = np.asarray(plan.packed.inputs["valid"])
    pads = 0
    for row in v:
        real = np.nonzero(row)[0]
        if real.size:
            pads += int((~row[:real[-1] + 1]).sum())
    return pads, v.size


def phase_ssm_train(cfg, sft, rl, tag: str):
    """``cfg``'s width and depth in bf16 through ``TreeTrainEngine.step`` on
    the planner's chunk-aligned rows (TRAIN_ROWS of TRAIN_SEQ): SFT steps on
    agentic trees, then RL steps on GRPO trees; each step's chunk-padding
    share, time, unique tokens/s, launches (each kernel once per
    application of the shared attention block, none for a pure SSM) and
    host syncs (exactly one; step 1 audited); then a profiled step.
    Returns (params, the run's launch counts, each step's launches, the
    median step s)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    opt_state = init_opt_state(params)
    n_steps = len(sft) + len(rl)
    engine = TreeTrainEngine(cfg, OptimizerConfig(
        lr=3e-4, warmup_steps=2, total_steps=n_steps))
    torch.cuda.synchronize()
    per_step = shared_apps(cfg)
    log(f"{tag}: {ssm_desc(cfg)} + fp32 AdamW state: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.2f} s; SSM layers recomputed in the "
        f"backward (checkpointed)")
    reset_launches()
    times, per_tok, pads_all, cells_all, hidden = [], [], 0, 0, []
    deltas = []
    for i, (mode, plan) in enumerate([("sep_avg", p) for p in sft]
                                     + [("rl", p) for p in rl]):
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        if i == 1:
            (params, opt_state, m), hidden = count_hidden_syncs(
                engine, lambda: engine.step(params, opt_state, plan))
        else:
            params, opt_state, m = engine.step(params, opt_state, plan)
        dt = time.perf_counter() - t1
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        deltas.append(delta)
        pads, cells = chunk_pads(plan)
        pads_all += pads
        cells_all += cells
        if i:
            times.append(dt)
            per_tok.append(plan.unique_tokens / dt)
        log(f"{tag} step {i} ({mode}): loss {m['loss']:.4f} nll/tok "
            f"{m['nll']:.4f} grad_norm {m['grad_norm']:.3f}; "
            f"{plan.num_trees} trees, {plan.unique_tokens} unique tokens in "
            f"{cells} cells, chunk padding {share(pads, cells)} of the cells; "
            f"{dt:.3f} s ({plan.unique_tokens / dt:.0f} unique tokens/s), "
            f"peak {peak_gb():.2f} GB; launches this step {delta}; host "
            f"syncs {engine.host_syncs}")
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"{tag} step {i}: non-finite loss or grad norm")
        check(all(d == per_step for d in delta.values()),
              f"{tag} step {i}: launches {delta}, want {per_step} each")
        check(engine.host_syncs == i + 1,
              f"{tag} step {i}: {engine.host_syncs} host syncs")
    counts = launch_counts()
    log(f"{tag}: step 1 under torch.cuda.set_sync_debug_mode('warn') (off "
        f"inside the engine's _sync): {len(hidden)} other synchronizing "
        f"calls{': ' + '; '.join(sorted(set(hidden))) if hidden else ''}")
    check(not hidden, f"{tag}: a train step synchronized outside _sync")
    step_s = statistics.median(times)
    log(f"{tag}: {n_steps} steps ({len(sft)} sep_avg, {len(rl)} rl), "
        f"{TRAIN_ROWS} rows x {TRAIN_SEQ}: step {step_s:.3f} s median after "
        f"the first (all: {', '.join(f'{t:.3f}' for t in times)}), "
        f"{statistics.median(per_tok):.0f} unique tokens/s median, chunk "
        f"padding {share(pads_all, cells_all)} of the cells, "
        f"{engine.host_syncs} host syncs / {n_steps} steps; launches {counts} "
        f"({per_step} of each kernel a step)")
    profile_step(lambda: engine.step(params, opt_state, sft[0]),
                 f"{cfg.name.replace('.', 'p')}_train_step_trace")
    del opt_state
    return params, counts, deltas, step_s


def phase_ssm_train_parity(cfg_full):
    """PARITY_LAYERS layers in f32 on one chunk-aligned row of 2048: (a)
    for the hybrid, the kernels against the plain attention; (b) tree vs
    per-branch baseline (Eq. 5 through tree state routing and the tree
    causal conv), through the kernels: loss 1e-5 relative, grads max-rel
    1e-4."""
    tag = f"{cfg_full.name} train parity"
    cfg = cfg_full.replace(n_layers=PARITY_LAYERS, dtype="float32")
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    trees = row_trees(cfg, 2048)
    bt, bb = tree_and_baseline(cfg, trees, 2048)
    lk, _, gk = value_and_grad(cfg, params, bt, "kernel")
    if cfg.attn is not None:
        lr, _, gr = value_and_grad(cfg, params, bt, "ref")
        e_loss = abs(float(lk) - float(lr)) / abs(float(lr))
        e_g, leaf, l2, _ = grads_rel(gk, gr)
        log(f"{tag} (a): {PARITY_LAYERS} layers f32, one packed row of 2048 "
            f"({len(trees)} trees, {int(bt['valid'].sum())} tokens), kernel "
            f"vs plain attention: loss {float(lk):.6f} vs {float(lr):.6f}, "
            f"relative error {e_loss:.3e} (limit 1e-5); grads max-rel "
            f"{e_g:.3e} at {leaf} (limit 1e-4), relative L2 {l2:.3e}")
        check(e_loss <= 1e-5 and e_g <= 1e-4, f"{tag} (a)")
        del gr
    lb, _, gb = value_and_grad(cfg, params, bb, "kernel")
    e_loss = abs(float(lk) - float(lb)) / abs(float(lb))
    e_g, leaf, l2, _ = grads_rel(gk, gb)
    log(f"{tag} (b): {PARITY_LAYERS} layers f32, tree (1 row, "
        f"{int(bt['valid'].sum())} tokens, {len(trees)} trees) vs per-branch "
        f"baseline ({bb['tokens'].shape[0]} rows of 2048, "
        f"{int(bb['valid'].sum())} tokens): loss {float(lk):.6f} vs "
        f"{float(lb):.6f}, relative error {e_loss:.3e} (limit 1e-5); grads "
        f"max-rel {e_g:.3e} at {leaf} (limit 1e-4), relative L2 {l2:.3e}")
    check(e_loss <= 1e-5 and e_g <= 1e-4, f"{tag} (b)")
    del params, gk, gb


def run_ssm(timed) -> dict:
    """The SSM and hybrid archs (SSM_ARCHS): the three kernels at Zamba2's
    layout against their plain versions; each arch served, held step loop
    vs forward, trained (one host sync a step), checked for deterministic
    grads (a packed and a wave plan), trained on trees larger than a row
    through partition waves, held partitioned vs whole and tree vs
    baseline; the kernels held and timed at Zamba2's prefill, train rows
    and largest gateway wave (ZW).  Returns the kernels' worst errors, each
    arch's measured launches (serving, the train run, each train and wave
    step) and step times, the ZW wave and the timings."""
    zcfg = get_config(HYBRID_ARCH)
    zw: dict = {}
    plans_of = {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        plans_of[arch] = (train_plans(cfg, "agentic", "sep_avg",
                                      SSM_SFT_STEPS),
                          train_plans(cfg, "grpo", "rl", RL_STEPS))
    kl_z = np.asarray(plans_of[HYBRID_ARCH][0][0].packed.inputs["kv_last"])
    err = {"fwd": timed("zamba2 kernel", phase_kernel,
                        zamba2_kernel_cases(kl_z), False)}
    err.update(timed("zamba2 bwd kernel", phase_bwd_kernel,
                     zamba2_kernel_cases(kl_z)))
    runs = {}
    for arch in SSM_ARCHS:
        sft, rl = plans_of[arch]
        cfg, params, serve_counts = timed(f"{arch} serve", phase_ssm_serve,
                                          arch)
        timed(f"{arch} serve parity", phase_ssm_serve_parity, cfg, params)
        del params
        torch.cuda.empty_cache()
        full = get_config(arch)
        tcfg = full.replace(n_layers=round(full.n_layers * SSM_TRAIN_DEPTH))
        params, counts, deltas, step_s = timed(
            f"{arch} train", phase_ssm_train, tcfg, sft, rl, f"{arch} train")
        del params
        torch.cuda.empty_cache()
        dcfg = full.replace(n_layers=SSM_DETERMINISM_LAYERS)
        timed(f"{arch} determinism", phase_determinism, dcfg,
              init_params(dcfg, torch.Generator(DEV).manual_seed(0)),
              [("packed", sft[0]), ("waves", first_wave_plan(dcfg))],
              f"{arch} determinism")
        wcfg = full.replace(n_layers=round(full.n_layers * SSM_WAVE_DEPTH))
        params, w_big, w_launches, w_n, w_pad, w_deltas, w_step = timed(
            f"{arch} waves", phase_waves, wcfg,
            init_params(wcfg, torch.Generator(DEV).manual_seed(0)),
            f"{arch} waves", SSM_WAVE_BATCHES, False)
        timed(f"{arch} wave parity", phase_wave_parity, wcfg, params,
              f"{arch} wave parity", True)
        del params
        torch.cuda.empty_cache()
        timed(f"{arch} train parity", phase_ssm_train_parity, full)
        torch.cuda.empty_cache()
        runs[arch] = dict(counts=counts, step_counts=deltas, step_s=step_s,
                          serve_counts=serve_counts, wave_counts=w_deltas,
                          wave_step_s=w_step)
        if arch == HYBRID_ARCH:
            zw = dict(wave=w_big, launches=w_launches, waves=w_n, pad=w_pad)
            zrl = timed("zamba2 rl loop", phase_ssm_rl_loop, full)
            torch.cuda.empty_cache()
    a = zcfg.attn
    heads, hd, apps = (a.n_heads, a.n_kv_heads), a.head_dim, shared_apps(zcfg)
    lay = layout_tag(*heads, hd)
    timing = dict(prefill=timed(
        f"timing {lay} prefill", phase_timing_train, np.full((1, 1024), 1023),
        None, 0, heads, f"{lay} serving prefill S=1024", 0, hd), train=timed(
        f"timing {lay} train", phase_timing_train, kl_z,
        runs[HYBRID_ARCH]["step_s"], shared_apps(zcfg.replace(
            n_layers=round(zcfg.n_layers * SSM_TRAIN_DEPTH))), heads,
        f"{lay} chunk-padded train rows", 0, hd))
    # ZW: the Zamba2 waves phase's gateway wave with the largest A_max
    zw["err"] = timed("zamba2 wave kernel", phase_wave_kernel,
                      (zw["wave"], zw["pad"]), heads, hd,
                      "zamba2 wave kernel", "ZW")
    timing["wave"] = timed(
        "timing ZW", phase_timing_train, wave_kv_last(zw["wave"]), None,
        apps, heads, "ZW", zw["wave"].anc_A_max, hd)
    return dict(err=err, runs=runs, timing=timing, layout=lay,
                apps=apps, train_shape=kl_z.shape, zw=zw, rl=zrl)

# --------------------------------------------------------------------------
# the enc-dec and VLM archs (SeamlessM4T-large v2, Phi-3-vision 4.2B)
# --------------------------------------------------------------------------

def act_bytes(cfg, tokens: int) -> float:
    """Saved activation bytes of one layer of ``cfg`` over ``tokens`` row
    tokens: TRAIN_ACT_BYTES (a Qwen3-32B layer at TRAIN_ROWS x TRAIN_SEQ)
    in proportion to tokens x (d_model + d_ff + q_dim)."""
    def width(c):
        return c.d_model + c.d_ff + c.attn.q_dim
    return TRAIN_ACT_BYTES * tokens * width(cfg) / (
        TRAIN_ROWS * TRAIN_SEQ * width(get_config(TRAIN_ARCH)))


def prefix_kv_last(kv_last: np.ndarray, F: int) -> np.ndarray:
    """The kv_last the kernels see on rows of text ``kv_last`` [B, S]
    behind a multimodal prefix of F rows (``transformer._mm_prefix_meta``):
    the prefix visible to the whole row, the text's indices shifted by F."""
    B, S = kv_last.shape
    return np.concatenate([np.full((B, F), F + S - 1),
                           np.where(kv_last >= 0, kv_last + F, -1)], 1)


def mm_kernel_cases(kl_v, kl_s2):
    """The three kernels at the two new layouts on their first train
    step's real kv_last: V, Phi-3-vision's rows (its 576-patch prefix and
    the text, H 32/Kh 32, hd 96: in bf16 the Hopper kernels, in f32 the
    simple kernels), and S2, SeamlessM4T's
    decoder rows (H 16/Kh 16, hd 64: the Hopper paths in bf16, the simple
    kernels in f32).  Then bf16 at hd 96 beyond Phi-3's MHA, on rows of
    Phi-3's 576-row prefix before packed trees: a GQA group of 4 (H 32/Kh
    8), MQA (H 32/Kh 1), padding keys (a row whose last 700 keys no query
    sees), gateway ancestors (A 37, two rows front-padded) with a window
    of 24, and a ragged S (1000 = 15·64 + 40)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    add = case_adder(np.random.default_rng(80), cases)
    for tag, arch, kl in (("V", VLM_ARCH, kl_v), ("S2", ENCDEC_ARCH, kl_s2)):
        a = get_config(arch).attn
        H, Kh, hd = a.n_heads, a.n_kv_heads, a.head_dim
        B, S = kl.shape
        for dt in (bf16, f32):
            add(f"{tag}: {layout_tag(H, Kh, hd)} ({arch}; bf16 paths: "
                f"{bf16_paths(hd)}) train rows (B={B}, S={S}) {dt}", dt, B,
                S, H, Kh, hd, kl)
    Fv = get_config(VLM_ARCH).frontend_len
    tag = f"hd 96 ({bf16_paths(96)})"
    kl, pos = tree_rows(81, 2, 1024)
    pre = prefix_kv_last(kl, Fv)
    S = pre.shape[1]
    add(f"{tag}: GQA 32/8, prefix {Fv} + 1024 bf16", bf16, 2, S, 32, 8, 96,
        pre)
    add(f"{tag}: MQA 32/1, prefix {Fv} + 1024 bf16", bf16, 2, S, 32, 1, 96,
        pre)
    pad = pre.copy()
    pad[0, S - 700:] = -1
    add(f"{tag}: padding keys, MHA 32/32 bf16", bf16, 2, S, 32, 32, 96, pad)
    g, pq, pk = gateway(kl, pos, 37, (5, 0))
    add(f"{tag}: gateway A=37 window 24, GQA 32/8 bf16", bf16, 2, 1024, 32,
        8, 96, g, q_off=37, window=24, pq=pq, pk=pk)
    rag = prefix_kv_last(tree_rows(82, 2, 1000 - Fv)[0], Fv)
    add(f"{tag}: ragged S=1000 behind the prefix, MHA 32/32 bf16", bf16, 2,
        1000, 32, 32, 96, rag)
    return cases


def mm_desc(cfg) -> str:
    a = cfg.attn
    enc = "" if cfg.encdec is None else (
        f"{cfg.encdec.enc_layers} encoder + ")
    layers = (f"{enc}{cfg.n_layers} decoder layers" if cfg.encdec is not None
              else f"{cfg.n_layers} layers")
    return (f"{cfg.name} ({cfg.family}) {layers} d {cfg.d_model} d_ff "
            f"{cfg.d_ff} vocab {cfg.vocab_size} (padded {cfg.padded_vocab}) "
            f"heads {a.n_heads}/{a.n_kv_heads} hd {a.head_dim}, "
            f"{cfg.frontend} frontend stub of {cfg.frontend_len} rows, "
            f"{cfg.dtype}")


def cross_kv(cfg, params, enc):
    """Each decoder layer's cross K/V over the encoder output ``enc`` [B,
    T, D], stacked [dec_layers, B, T, Kh, hd] for ``load_cross``."""
    n = cfg.encdec.dec_layers
    xattn = params["layer_stacks"][0]["xattn"]
    ks, vs = zip(*[attn_mod.project_cross_kv(
        {k: v[i] for k, v in xattn.items()}, cfg.attn, enc)
        for i in range(n)])
    return torch.stack(ks), torch.stack(vs)


def encode_frames(cfg, params, seed: int):
    """Frame embeddings [1, frontend_len, D] drawn from ``seed`` (the stub
    frontend),
    the encoder over them, and each decoder layer's cross K/V.  Returns
    (frames, (k, v), seconds on the host clock around synced calls)."""
    gen = torch.Generator(DEV).manual_seed(seed)
    frames = torch.randn((1, cfg.frontend_len, cfg.d_model), generator=gen,
                         device=DEV)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, _ = transformer.encode(cfg, params, frames)
        kv = cross_kv(cfg, params, enc)
        torch.cuda.synchronize()
    return frames, kv, time.perf_counter() - t0


def mm_decode_bound(cfg, params, tm, tag: str, enc_len: int) -> None:
    """The session's decode rate against its bound: a step of 8 branches
    reads every decoder weight it uses once (not the embedding table, the
    encoder, which ran once before, nor the cross blocks' K/V
    projections, applied to the encoder output there), every slot of its
    KV rings (1536 a branch, read whole and masked) and, enc-dec, every
    branch's cross K/V."""
    w = sum(t.numel() * t.element_size() for p, t in flatten_tree(params)
            if p[0] not in ("embed", "encoder", "enc_norm")
            and not (len(p) > 3 and p[2] == "xattn"
                     and p[3] in ("wk", "wv", "bk", "bv")))
    cache = decode._init_cache(cfg, 8, 1536, DEV, enc_len)
    ring = sum(t.numel() * t.element_size() for g, grp in cache.items()
               if g != "cross" for t in grp.values())
    xkv = sum(t.numel() * t.element_size()
              for t in cache.get("cross", {}).values())
    del cache
    step_bytes = w + ring + xkv
    bound_s = step_bytes / PEAK_BYTES
    log(f"{tag}: decode {tm['decode_tok'] / tm['decode_s']:.1f} tokens/s "
        f"(8 branches, {tm['decode_s'] / (tm['decode_tok'] / 8) * 1e3:.2f} ms "
        f"a step) against its bound: a step reads {step_bytes / 1e9:.3f} GB "
        f"({w / 1e9:.3f} GB of decoder weights, {ring / 1e9:.3f} GB of KV "
        f"rings, {xkv / 1e9:.3f} GB of cross K/V), >= {bound_s * 1e3:.3f} ms "
        f"at {PEAK_BYTES / 1e12:.2f} TB/s, so at most {8 / bound_s:.1f} "
        f"tokens/s")


def phase_mm_serve(arch: str):
    """One arch at full width and STEP_LOOP_SERVE_DEPTH of its depth
    (Seamless: of its encoder's and its decoder's), random bf16 weights.
    Seamless:
    its encoder over its 1024 frames drawn from the seed, each decoder
    layer's cross K/V projected.  Then one rollout group (prompt 1024, K 8,
    64 new tokens; its session holds no encoder output, enc_len 0, as the
    reference's ``rollout_group`` makes it) and the multi-turn session
    (Seamless: the cross K/V loaded, and tiled by the fork), both
    prefilled through the step loop as the reference's sessions are, every
    step a CUDA-graph replay; prefill and decode tokens/s against the
    decode bound; a profiled decode step.  No tree-attention kernel may
    launch.  Returns (cfg, params, launch counts, frames or None)."""
    tag = f"{arch} serve"
    cfg, cut = step_loop_cut(get_config(arch))
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in flatten_tree(params))
    log(f"{tag}: {mm_desc(cfg)} ({cut}): {n / 1e9:.3f} B parameters "
        f"({cfg.param_count() / 1e9:.3f} B by the reference's formula), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, random weights in "
        f"{time.perf_counter() - t0:.2f} s")
    reset_launches()
    frames, cross = None, None
    if cfg.encdec is not None:
        frames, cross, t_enc = encode_frames(cfg, params, 3)
        log(f"{tag}: encoder over {cfg.frontend_len} frames "
            f"({cfg.encdec.enc_layers}"
            f" bidirectional layers, plain attention) and {cfg.n_layers} "
            f"layers' cross K/V {tuple(cross[0].shape)} in {t_enc:.3f} s "
            f"({cfg.frontend_len / t_enc:.0f} frames/s, first call)")
    rc = RolloutConfig(k=8, prompt_len=1024, max_new=64, temperature=1.0)
    gen = torch.Generator(DEV).manual_seed(1)
    rng = np.random.default_rng(7)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, st = rollout_group(cfg, params, rng.integers(
            0, cfg.vocab_size, rc.prompt_len), rc, gen)
        torch.cuda.synchronize()
        t_group = time.perf_counter() - t0
        check(st.prefill_tokens == rc.prompt_len
              and st.decode_tokens == rc.k * (rc.max_new - 1),
              f"{tag}: group token counts {st}")
        check(tree.root.size >= rc.prompt_len and tree.num_leaves() == rc.k,
              f"{tag}: prompt not shared by {rc.k} leaves")
        calls, logits, tm = multiturn(cfg, params, "kernel", gen,
                                      cross=cross)
    counts = launch_counts()
    log(f"{tag}: one rollout group (prompt {rc.prompt_len}, k {rc.k}, "
        f"max_new {rc.max_new}, enc_len 0) in {t_group:.3f} s; multi-turn "
        f"session{' with the cross K/V loaded' if cross else ''}: prefill "
        f"{tm['prefill_tok'] / tm['prefill_s']:.1f} tokens/s "
        f"({tm['prefill_tok']} tokens through the step loop in "
        f"{tm['prefill_s']:.3f} s), decode "
        f"{tm['decode_tok'] / tm['decode_s']:.1f} tokens/s "
        f"({tm['decode_tok']} tokens in {tm['decode_s']:.3f} s); kernel "
        f"launches {counts} (the step loop runs no tree-attention kernel)")
    check(all(v == 0 for v in counts.values()),
          f"{tag}: serving launched a tree-attention kernel")
    enc_len = 0 if cross is None else cfg.frontend_len
    mm_decode_bound(cfg, params, tm, tag, enc_len)
    with torch.inference_mode():
        sess = DecodeSession.create(cfg, params, buf_len=1536,
                                    enc_len=enc_len)
        if cross is not None:
            sess.load_cross(*cross)
        sess.prefill(rng.integers(0, cfg.vocab_size, 16))
        br = sess.fork(8)
        tok = torch.zeros(8, dtype=torch.long, device=DEV)
        for _ in range(2):
            br.step(tok)
        profile_step(lambda: (br.step(tok), torch.cuda.synchronize()),
                     f"{arch}_decode_step_trace", "decode step")
    del calls, logits, br, sess, cross
    return cfg, params, counts, frames


def chain_logits(cfg, params, toks, frames=None):
    """The packed forward's logits at the positions of ``toks`` (one chain;
    ``frames`` the frontend rows, the stub's zeros if None)."""
    tb = pack_trees([serialize_tree(TrajectoryTree(TreeNode(tokens=toks)))],
                    len(toks))
    with torch.inference_mode():
        hidden, _ = transformer.forward(cfg, params, prepare_batch(
            cfg, tb, frames, device=DEV))
        return logits_from_hidden(params["embed"], params.get("lm_head"),
                                  hidden[0])


def stepped_logits(cfg, params, toks, cross=None, swap=None):
    """Teacher-forced: the logits of a session stepping ``toks`` one by one
    (a CUDA-graph replay a step, captured at the first), with the cross
    K/V ``cross`` loaded before the first step and, given ``swap`` = (i,
    K/V), the K/V replaced by ``load_cross`` before step i."""
    T = 0 if cross is None else cross[0].shape[2]
    with torch.inference_mode():
        sess = DecodeSession.create(cfg, params, buf_len=len(toks),
                                    enc_len=T)
        if cross is not None:
            sess.load_cross(*cross)
        out = []
        for i, t in enumerate(toks):
            if swap is not None and i == swap[0]:
                sess.load_cross(*swap[1])
            out.append(sess.step([int(t)])[0])
        return torch.stack(out)


def phase_mm_serve_parity(cfg, params, frames):
    """The step loop (the serving path) against the packed forward (the
    training path) on SSM_PARITY_TOKENS teacher-forced tokens:
    - Seamless, PARITY_LAYERS encoder and decoder layers in f32: the step
      loop with the cross K/V of ``frames`` loaded within atol = rtol =
      5e-4 of the forward over the same frames (tests/test_serve.py:72-114);
      then a ``load_cross`` after the graph was captured: K/V of other
      frames loaded before step SSM_PARITY_TOKENS / 2 must move the later
      logits (relative L2 > 1e-2 from the first run's) and match an eager
      step loop that makes the same swap (5e-4); full depth bf16: the step
      loop's relative L2 from the bf16 forward, reported;
    - Phi-3-vision, PARITY_LAYERS layers in f32: the VLM session is its
      text decoder (the reference's session feeds no image), so its step
      loop equals the forward of the same weights as a dense model with
      no frontend, within 5e-4."""
    tag = f"{cfg.name} serve parity"
    P = SSM_PARITY_TOKENS
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, P)
    c4 = cfg.replace(n_layers=PARITY_LAYERS, dtype="float32")
    if cfg.encdec is not None:
        c4 = c4.replace(encdec=dataclasses.replace(
            cfg.encdec, enc_layers=PARITY_LAYERS, dec_layers=PARITY_LAYERS))
    p4 = init_params(c4, torch.Generator(DEV).manual_seed(0))
    if cfg.encdec is None:
        text = c4.replace(family="dense", frontend=None, frontend_len=0)
        ok, err = close(stepped_logits(c4, p4, toks),
                        chain_logits(text, p4, toks), 5e-4)
        log(f"{tag}: {PARITY_LAYERS} layers f32, {P} tokens teacher-forced: "
            f"the VLM step loop vs the forward of its text decoder (dense, "
            f"no frontend): max abs error {err:.3e} (atol = rtol = 5e-4)")
        check(ok, f"{tag} (f32)")
        del p4
        return
    f4, kv4, _ = encode_frames(c4, p4, 3)
    _, other, _ = encode_frames(c4, p4, 4)
    want = chain_logits(c4, p4, toks, f4)
    got = stepped_logits(c4, p4, toks, kv4)
    ok, err = close(got, want, 5e-4)
    half = P // 2
    swapped = stepped_logits(c4, p4, toks, kv4, (half, other))
    DecodeSession.graph_steps = False
    try:
        eager = stepped_logits(c4, p4, toks, kv4, (half, other))
    finally:
        DecodeSession.graph_steps = True
    ok_swap, err_swap = close(swapped, eager, 5e-4)
    moved = rel_l2(swapped[half:], got[half:])
    ok_before, before = close(swapped[:half], got[:half], 5e-4)
    log(f"{tag}: {PARITY_LAYERS} + {PARITY_LAYERS} layers f32, {P} tokens "
        f"teacher-forced over {cfg.frontend_len} frames: step loop (cross K/V "
        f"loaded) vs packed forward max abs error {err:.3e} (atol = rtol = "
        f"5e-4); load_cross of other frames' K/V after the graph was "
        f"captured, before step {half}: the later logits move by relative "
        f"L2 {moved:.3e} (must exceed 1e-2; the earlier ones stay within "
        f"5e-4: max abs {before:.3e}), and match an eager step loop making "
        f"the same swap: max abs error {err_swap:.3e} (5e-4)")
    check(ok, f"{tag} (f32 step loop vs forward)")
    check(ok_swap and ok_before and moved > 1e-2,
          f"{tag}: load_cross after the capture")
    del p4, kv4, other
    kv = cross_kv(cfg, params, transformer.encode(cfg, params, frames)[0])
    fb = chain_logits(cfg, params, toks, frames)
    sb = stepped_logits(cfg, params, toks, kv)
    log(f"{tag}: {cfg.encdec.enc_layers} + {cfg.n_layers} layers bf16: step "
        f"loop vs packed forward relative L2 of logits {rel_l2(sb, fb):.3e} "
        f"(reported; finite: {bool(torch.isfinite(sb).all())})")
    check(bool(torch.isfinite(sb).all()), f"{tag}: non-finite bf16 logits")


def phase_mm_train_parity(cfg_full):
    """PARITY_LAYERS layers in f32 (Seamless: as many encoder layers) on
    one packed row of 2048 text tokens behind frontend rows drawn from the
    seed: (a) the kernels against the plain attention, loss and grads
    within 1e-4 max-rel (tests/test_equivalence.py:62); (b) tree vs the
    per-branch baseline, every path row behind the same frontend rows,
    through the kernels: loss rtol 5e-6 (tests/test_equivalence.py:65-80),
    grads max-rel 1e-4; (c) (a)'s kernel run again under ``remat="full"``:
    loss and every gradient leaf ``torch.equal``."""
    tag = f"{cfg_full.name} train parity"
    cfg = cfg_full.replace(n_layers=PARITY_LAYERS, dtype="float32")
    if cfg.encdec is not None:
        cfg = cfg.replace(encdec=dataclasses.replace(
            cfg.encdec, enc_layers=PARITY_LAYERS, dec_layers=PARITY_LAYERS))
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    trees = row_trees(cfg, 2048)
    tb = pack_trees([serialize_tree(t) for t in trees], 2048, batch_size=1)
    lb = pack_linear_paths([t.linearize_paths() for t in trees], 2048)
    ext = np.random.default_rng(15).normal(
        size=(1, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    bt = prepare_batch(cfg, tb, ext, device=DEV)
    bb = prepare_batch(cfg, lb, np.repeat(ext, lb.tokens.shape[0], 0),
                       device=DEV)
    lk, _, gk = value_and_grad(cfg, params, bt, "kernel")
    lr, _, gr = value_and_grad(cfg, params, bt, "ref")
    e_loss = abs(float(lk) - float(lr)) / abs(float(lr))
    e_g, leaf, l2, _ = grads_rel(gk, gr)
    log(f"{tag} (a): {PARITY_LAYERS} layers f32, one packed row of 2048 "
        f"({len(trees)} trees, {int(bt['valid'].sum())} tokens) behind "
        f"{cfg.frontend_len} frontend rows, kernel vs plain attention: loss "
        f"{float(lk):.6f} vs {float(lr):.6f}, relative error {e_loss:.3e} "
        f"(limit 1e-4); grads max-rel {e_g:.3e} at {leaf} (limit 1e-4), "
        f"relative L2 {l2:.3e}")
    del gr
    lbl, _, gb = value_and_grad(cfg, params, bb, "kernel")
    e_loss_b = abs(float(lk) - float(lbl)) / abs(float(lbl))
    e_g_b, leaf_b, l2_b, _ = grads_rel(gk, gb)
    log(f"{tag} (b): {PARITY_LAYERS} layers f32 through the kernels, tree "
        f"(1 row) vs per-branch baseline ({bb['tokens'].shape[0]} rows of "
        f"2048, {int(bb['valid'].sum())} tokens, each behind the same "
        f"frontend rows): loss {float(lk):.6f} vs {float(lbl):.6f}, "
        f"relative error {e_loss_b:.3e} (limit 5e-6); grads max-rel "
        f"{e_g_b:.3e} at {leaf_b} (limit 1e-4), relative L2 {l2_b:.3e}")
    del gb
    lkr, _, gkr = value_and_grad(cfg.replace(remat="full"), params, bt,
                                 "kernel")
    differ = differing(gk, gkr)
    same_loss = torch.equal(lk, lkr)
    log(f"{tag} (c): {PARITY_LAYERS} layers f32 through the kernels, the "
        f"tree row of (a) with remat full vs none: loss "
        f"{'identical' if same_loss else 'differs'}, "
        f"{len(flatten_tree(gk)) - len(differ)} of {len(flatten_tree(gk))} "
        f"gradient leaves bit-identical"
        + (f"; differing: {differ[:6]}" if differ else ""))
    check(e_loss <= 1e-4 and e_g <= 1e-4, f"{tag} (a)")
    check(e_loss_b <= 5e-6 and e_g_b <= 1e-4, f"{tag} (b)")
    check(same_loss and not differ, f"{tag} (c): remat full changes the "
                                    f"loss or the gradients")
    del params, gk, gkr


def vlm_train_cut():
    """Phi-3-vision's training cut, with ``remat="full"``: the deepest
    whose bf16 weights, fp32 grads and AdamW state, each layer's saved
    input (TRAIN_ROWS rows of its prefix + TRAIN_SEQ tokens, bf16) and one
    layer's ``act_bytes`` (the layer the backward recomputes) fit
    TRAIN_LIMIT.  (cfg, saved bytes a layer, the recomputed layer's
    bytes)."""
    full = get_config(VLM_ARCH)
    tokens = TRAIN_ROWS * (TRAIN_SEQ + full.frontend_len)
    per_layer = tokens * full.d_model * 2
    once = act_bytes(full, tokens)
    return full.replace(remat="full", n_layers=fit_depth(
        full, TRAIN_LIMIT - once, scale=7, per_layer=per_layer)), \
        per_layer, once


def mm_train_plans(cfg, sft_steps: int = MM_SFT_STEPS,
                   rl_steps: int = MM_RL_STEPS):
    """An enc-dec or VLM arch's train plans: ``sft_steps`` sep_avg steps on
    agentic trees, then ``rl_steps`` rl steps on GRPO trees, both of
    MM_TRAIN_GEN trees, MM_TRAIN_TREES a batch."""
    kw = dict(gen=MM_TRAIN_GEN, trees=MM_TRAIN_TREES)
    return (train_plans(cfg, "agentic", "sep_avg", sft_steps, **kw),
            train_plans(cfg, "grpo", "rl", rl_steps, **kw))


def run_mm(timed) -> dict:
    """The enc-dec and VLM archs: the three kernels at their layouts (V,
    S2) against the plain versions; each arch served at full depth
    (``phase_mm_serve``), held step loop vs forward, trained (Phi-3 at the
    deepest cut ``fit_depth`` gives), checked for deterministic grads and
    held in f32 kernel vs plain and tree vs baseline; the kernels timed at
    V and S2 on their first train step's real kv_last.  Returns the
    kernels' worst errors, each arch's launches, step times and depth, and
    the timings."""
    ecfg, vfull = get_config(ENCDEC_ARCH), get_config(VLM_ARCH)
    Fv = vfull.frontend_len
    vcfg, per_layer, once = vlm_train_cut()
    log(f"{VLM_ARCH} train: remat full, the deepest cut whose bf16 "
        f"weights, fp32 grads and AdamW state (14 bytes a parameter), "
        f"{per_layer / 1e9:.3f} GB of saved layer input a layer "
        f"({TRAIN_ROWS} rows of {Fv} + {TRAIN_SEQ} tokens) and one "
        f"recomputed layer's {once / 1e9:.2f} GB fit "
        f"{TRAIN_LIMIT / 1e9:.0f} GB: {vcfg.n_layers} of {vfull.n_layers} "
        f"layers" + (" (reduced)" if vcfg.n_layers < vfull.n_layers
                     else ""))
    plans_of = {ENCDEC_ARCH: mm_train_plans(ecfg),
                VLM_ARCH: mm_train_plans(vcfg)}
    kl_s2 = np.asarray(plans_of[ENCDEC_ARCH][0][0].packed.inputs["kv_last"])
    kl_v = prefix_kv_last(np.asarray(
        plans_of[VLM_ARCH][0][0].packed.inputs["kv_last"]), Fv)
    err = {"fwd": timed("mm kernel", phase_kernel,
                        mm_kernel_cases(kl_v, kl_s2), False)}
    err.update(timed("mm bwd kernel", phase_bwd_kernel,
                     mm_kernel_cases(kl_v, kl_s2)))
    runs = {}
    for arch, tcfg in ((ENCDEC_ARCH, ecfg), (VLM_ARCH, vcfg)):
        sft, rl = plans_of[arch]
        cfg, params, serve_counts, frames = timed(
            f"{arch} serve", phase_mm_serve, arch)
        timed(f"{arch} serve parity", phase_mm_serve_parity, cfg, params,
              frames)
        del params, frames
        torch.cuda.empty_cache()
        params, counts, step_s = timed(f"{arch} train", phase_train, tcfg,
                                       sft, rl, f"{arch} train", False)
        dropped = sum(p.dropped for p in (*sft, *rl))
        peak = peak_gb()
        check(dropped == 0, f"{arch} train: {dropped} trees dropped")
        check(peak <= PEAK_LIMIT / 1e9, f"{arch} train: peak {peak:.2f} GB "
              f"over {PEAK_LIMIT / 1e9:.0f} GB")
        timed(f"{arch} determinism", phase_determinism, tcfg, params,
              [("packed", sft[0])], f"{arch} determinism")
        del params
        torch.cuda.empty_cache()
        timed(f"{arch} train parity", phase_mm_train_parity,
              get_config(arch))
        torch.cuda.empty_cache()
        runs[arch] = dict(counts=counts, step_s=step_s, layers=tcfg.n_layers,
                          serve_counts=serve_counts, remat=tcfg.remat,
                          peak_gb=peak)
    timing = {}
    for key, arch, kl, n in (("V", VLM_ARCH, kl_v, vcfg.n_layers),
                             ("S2", ENCDEC_ARCH, kl_s2, ecfg.n_layers)):
        a = get_config(arch).attn
        timing[key] = timed(
            f"timing {key}", phase_timing_train, kl, runs[arch]["step_s"], n,
            (a.n_heads, a.n_kv_heads), key, 0, a.head_dim)
    return dict(err=err, runs=runs, timing=timing, shapes={
        "V": kl_v.shape, "S2": kl_s2.shape})


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t_start = time.perf_counter()
    # past WATCHDOG_S every thread's stack goes to stderr and the run ends
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    phase_s = {}
    last_end = [t_start]

    def timed(name, fn, *args):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*args)
        t1 = time.perf_counter()
        phase_s[name] = t1 - t0
        log(f"phase {name}: {phase_s[name]:.1f} s, peak memory "
            f"{peak_gb():.2f} GB; {t0 - last_end[0]:.1f} s since the last "
            f"phase, {t1 - t_start:.1f} s since the start")
        last_end[0] = t1
        return out

    cfg = get_config("qwen2_1p5b")
    sft = train_plans(cfg, "agentic", "sep_avg", SFT_STEPS)
    rl_plans = train_plans(cfg, "grpo", "rl", RL_STEPS)
    kl_t = np.asarray(sft[0].packed.inputs["kv_last"])
    timed("build", phase_build)
    timed("warm restart", phase_warm_restart)
    worst_fwd = timed("kernel", phase_kernel, kernel_cases(tp_kv_last=kl_t))
    worst_bwd = timed("bwd kernel", phase_bwd_kernel,
                      kernel_cases(kl_t, kl_t))
    mask = timed("mask soundness", phase_mask_soundness)

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.n_layers} layers d {cfg.d_model} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size} (padded {cfg.padded_vocab}) "
        f"heads {cfg.attn.n_heads}/{cfg.attn.n_kv_heads} hd "
        f"{cfg.attn.head_dim} {cfg.dtype}: {cfg.param_count() / 1e9:.3f} B "
        f"params, {torch.cuda.memory_allocated() / 1e9:.2f} GB, random "
        f"weights in {time.perf_counter() - t0:.2f} s")
    calls, logits, serve_tm, serve_launches = timed("serve", phase_serve,
                                                    cfg, params)
    timed("parity", phase_parity, cfg, params, calls, logits)
    del params, logits
    torch.cuda.empty_cache()

    params, counts, step_s = timed("train", phase_train, cfg, sft, rl_plans)
    wave_plan = first_wave_plan(cfg)
    timed("determinism", phase_determinism, cfg, params,
          [("packed", sft[0]), ("waves", wave_plan)], "determinism", True)
    params, wave_w, wave_launches, wave_n, wave_pad, _, _ = timed(
        "waves", phase_waves, cfg, params, "waves", WAVE_BATCHES, True, True)
    timed("train parity", phase_train_parity, cfg, params)
    timed("wave parity", phase_wave_parity, cfg, params)
    dp = timed("data parallel", phase_data_parallel, cfg, params, sft,
               wave_plan, step_s)
    mp_ = dp["world2"]["mp"]
    phase_s["model parallel"] = mp_["wall_s"]
    log(f"phase model parallel: {mp_['wall_s']:.1f} s (the data parallel "
        f"phase's ranks, after its steps; inside its time)")
    del params
    torch.cuda.empty_cache()
    timing_ab = timed("timing", phase_timing_serve)
    timing = timed("timing T", phase_timing_train, kl_t, step_s,
                   cfg.n_layers)
    wave_err = timed("wave kernel", phase_wave_kernel, (wave_w, wave_pad))
    timing_w = timed("timing W", phase_timing_train, wave_kv_last(wave_w),
                     None, cfg.n_layers, (12, 2), "W", wave_w.anc_A_max)
    # the async tree-RL loop: generation beside the trainer on one card
    rl = timed("rl loop", phase_rl_loop, cfg, serve_tm, step_s)
    rl["parity"] = timed("rl parity", phase_rl_parity, cfg, rl_plans[0],
                         rl["res"]["grad_err"])
    torch.cuda.empty_cache()

    # the MoE model, Qwen3-30B-A3B, once the dense model's tensors are gone
    mcfg = get_config(MOE_ARCH)
    mcfg_train = mcfg.replace(n_layers=MOE_TRAIN_LAYERS)
    msft = train_plans(mcfg_train, "agentic", "sep_avg", SFT_STEPS)
    mrl = train_plans(mcfg_train, "grpo", "rl", RL_STEPS)
    kl_m = np.asarray(msft[0].packed.inputs["kv_last"])
    worst_fwd = max(worst_fwd, timed("moe kernel", phase_kernel,
                                     moe_kernel_cases(kl_m), False))
    worst_m = timed("moe bwd kernel", phase_bwd_kernel, moe_kernel_cases(kl_m))
    worst_bwd = {k: max(worst_bwd[k], worst_m[k]) for k in worst_bwd}
    moe_serve_launches, moe_depth = timed("moe serve", phase_arch_serve,
                                            MOE_ARCH, "moe serve", 4)
    timed("moe parity", phase_f32_parity, mcfg, 2, "moe parity")
    params, moe_counts, moe_step_s = timed("moe train", phase_train,
                                           mcfg_train, msft, mrl, "moe train")
    timed("moe determinism", phase_determinism, mcfg_train, params,
          [("packed", msft[0])], "moe determinism")
    del params
    torch.cuda.empty_cache()
    timed("moe train parity", phase_moe_train_parity, mcfg)
    torch.cuda.empty_cache()
    ep = timed("expert parallel", phase_expert_parallel, mcfg)
    timing_moe = timed("moe timing T", phase_timing_train, kl_m, moe_step_s,
                       MOE_TRAIN_LAYERS, MOE_HEADS, "T_moe")

    # the rest of the dense and MoE archs, once the MoE model is gone
    archs = run_archs(timed)
    worst_fwd = max(worst_fwd, archs["err"]["fwd"])
    worst_bwd = {k: max(worst_bwd[k], archs["err"][k]) for k in worst_bwd}

    # the SSM and hybrid archs, once the other archs' tensors are gone
    ssm = run_ssm(timed)
    worst_fwd = max(worst_fwd, ssm["err"]["fwd"])
    worst_bwd = {k: max(worst_bwd[k], ssm["err"][k]) for k in worst_bwd}

    # the enc-dec and VLM archs, once the SSM archs' tensors are gone
    mm = run_mm(timed)
    worst_fwd = max(worst_fwd, mm["err"]["fwd"])
    worst_bwd = {k: max(worst_bwd[k], mm["err"][k]) for k in worst_bwd}
    total = time.perf_counter() - t_start
    inside = sum(phase_s.values()) - mp_["wall_s"]   # mp_: inside a phase
    log(f"total {total:.1f} s, of which {total - inside:.1f} s outside the "
        f"phases; phases "
        + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))

    src = "src/repro_torch/kernels/csrc/"
    rows = [("tree_attention_fwd", "fwd", "tree_attention_fwd.cu",
             "src/repro/kernels/tree_attention.py:112", worst_fwd),
            ("tree_attention_bwd_dq", "dq", "tree_attention_bwd_dq.cu",
             "src/repro/kernels/tree_attention_bwd.py:75", worst_bwd["dq"]),
            ("tree_attention_bwd_dkv", "dkv", "tree_attention_bwd_dkv.cu",
             "src/repro/kernels/tree_attention_bwd.py:177",
             worst_bwd["dkv"])]
    entries = []
    for name, key, file, replaces, err in rows:
        e = dict(name=name, route="cuda", source=src + file,
                 replaces=replaces, launches=counts[name], max_abs_err=err,
                 **timing[key], instances=INSTANCES.get(file, {}))
        e["shape"] = "T: the first train step's rows, bf16, hd 128"
        e["mask_soundness"] = mask
        e["wave"] = dict(
            shape=f"W: a gateway wave of the waves phase, "
                  f"{wave_w.batch['tokens'].shape[0]} rows of {TRAIN_SEQ}, "
                  f"q_off = A_max = {wave_w.anc_A_max}, H 12, Kh 2, bf16, "
                  f"hd 128",
            launches_wave_step=wave_launches[name], waves_in_step=wave_n,
            max_abs_err=wave_err[key], **timing_w[key])
        e["moe"] = dict(
            shape=f"T_moe: the {MOE_TRAIN_LAYERS}-layer Qwen3-30B-A3B train "
                  f"step's rows, H 32, Kh 4, bf16, hd 128",
            launches_train=moe_counts[name], **timing_moe[key])
        e["archs"] = {"max_abs_err": archs["err"][key], **{lay: dict(
            archs=t["archs"],
            launches_serve={a: archs["runs"][a][0] if key == "fwd" else 0
                            for a in t["archs"]},
            launches_train=({TRAIN_ARCH: archs["train_counts"][name]}
                            if TRAIN_ARCH in t["archs"] else {}),
            path=ta.kernel_path(key, torch.bfloat16, t["hd"]),
            prefill=dict(shape="serving prefill: B 1, S 1024, bf16",
                         **t["prefill"][key]),
            tool_prefill=dict(shape="tool prefill: B 8, S 200 after 1056 "
                                    "cached keys (q_off), bf16",
                              **t["tool"][key]),
            train=dict(shape=f"train rows of the "
                             f"{archs['train_cfg'].n_layers}-layer "
                             f"{TRAIN_ARCH} step: B 2, S {TRAIN_SEQ}, real "
                             f"kv_last, bf16", **t["train"][key]))
            for lay, t in archs["timing"].items()}}
        e["archs"]["serve_layers"] = {a: archs["runs"][a][1] for a in ARCHS}
        zB, zS = ssm["train_shape"]
        zw = ssm["zw"]
        e["ssm"] = dict(
            layout=f"{ssm['layout']} ({HYBRID_ARCH}: its shared attention "
                   f"block, {ssm['apps']} applications a forward)",
            path=ta.kernel_path(key, torch.bfloat16, 64),
            max_abs_err=ssm["err"][key],
            launches_train={a: ssm["runs"][a]["counts"][name]
                            for a in SSM_ARCHS},
            launches_per_train_step={
                a: [d[name] for d in ssm["runs"][a]["step_counts"]]
                for a in SSM_ARCHS},
            launches_serve={a: ssm["runs"][a]["serve_counts"][name]
                            for a in SSM_ARCHS},
            prefill=dict(shape="serving-width prefill: B 1, S 1024, bf16",
                         **ssm["timing"]["prefill"][key]),
            train=dict(shape=f"the {HYBRID_ARCH} step's chunk-aligned rows: "
                             f"B {zB}, S {zS}, real kv_last with the chunk "
                             f"pads invisible, bf16",
                       **ssm["timing"]["train"][key]),
            launches_per_wave_step={
                a: [d[name] for d in ssm["runs"][a]["wave_counts"]]
                for a in SSM_ARCHS},
            wave=dict(
                shape=f"ZW: the {HYBRID_ARCH} waves phase's gateway wave "
                      f"with the largest A_max, "
                      f"{zw['wave'].batch['tokens'].shape[0]} rows of "
                      f"{TRAIN_SEQ}, q_off = A_max = {zw['wave'].anc_A_max}, "
                      f"H 32, Kh 32, bf16, hd 64",
                launches_wave_step=zw["launches"][name],
                waves_in_step=zw["waves"], max_abs_err=zw["err"][key],
                **ssm["timing"]["wave"][key]))
        e["mm"] = dict(
            max_abs_err=mm["err"][key],
            launches_serve={a: mm["runs"][a]["serve_counts"][name]
                            for a in (ENCDEC_ARCH, VLM_ARCH)},
            launches_train={a: mm["runs"][a]["counts"][name]
                            for a in (ENCDEC_ARCH, VLM_ARCH)},
            train_layers={a: mm["runs"][a]["layers"]
                          for a in (ENCDEC_ARCH, VLM_ARCH)},
            train_remat={a: mm["runs"][a]["remat"]
                         for a in (ENCDEC_ARCH, VLM_ARCH)},
            train_peak_gb={a: mm["runs"][a]["peak_gb"]
                           for a in (ENCDEC_ARCH, VLM_ARCH)},
            V=dict(shape=f"V: the {mm['runs'][VLM_ARCH]['layers']}-layer "
                         f"{VLM_ARCH} step's rows, B {mm['shapes']['V'][0]}, "
                         f"S {mm['shapes']['V'][1]} (576 patches + "
                         f"{TRAIN_SEQ} text), real kv_last, H 32, Kh 32, "
                         f"bf16, hd 96",
                   path=ta.kernel_path(key, torch.bfloat16, 96),
                   **mm["timing"]["V"][key]),
            S2=dict(shape=f"S2: the {ENCDEC_ARCH} decoder step's rows, B "
                          f"{mm['shapes']['S2'][0]}, S "
                          f"{mm['shapes']['S2'][1]}, real kv_last, H 16, "
                          f"Kh 16, bf16, hd 64",
                    path=ta.kernel_path(key, torch.bfloat16, 64),
                    **mm["timing"]["S2"][key]))
        e["data_parallel"] = dict(
            shape=f"Qwen2-1.5B: (a) NCCL world 1, {cfg.n_layers} layers "
                  f"bf16, {DP_WORLD1_STEPS} steps on the train phase's "
                  f"plans; (b) world 2 over {dp['world2']['backend']}, "
                  f"{DP_LAYERS} layers f32, {DP_STEPS} steps (packed, "
                  f"waves)",
            launches_world1_per_step=[c[name] for c in dp["launches"]],
            launches_world2_per_rank_per_step=[
                [c[name] for c in r] for r in dp["world2"]["launches"]])
        e["model_parallel"] = dict(
            shape=f"Qwen2-1.5B on a (data 1, model 2) mesh over "
                  f"{dp['world2']['backend']}, {TRAIN_ROWS} rows of "
                  f"{MP_SEQ}: H 6 / Kh 1 a rank, hd 128; "
                  f"(a) {DP_LAYERS} layers f32, (b) {MP_BF16_LAYERS} layers "
                  f"bf16; one accumulate each of (part, plan, sequence "
                  f"parallelism) {mp_['rows']}",
            launches_per_rank_per_accumulate=[
                [c[name] for c in r] for r in mp_["launches"]])
        e["expert_parallel"] = dict(
            shape=f"{MOE_ARCH} on a (data 1, model 2) mesh over "
                  f"{ep['backend']}, {MOE_TRAIN_LAYERS} layers, "
                  f"{TRAIN_ROWS} rows of {MP_SEQ}: 64 of 128 experts and H "
                  f"16 / Kh 2 a rank, hd 128; (a) f32, (b) bf16; one "
                  f"accumulate each of (part, plan, sequence parallelism) "
                  f"{ep['rows']}",
            launches_per_rank_per_accumulate=[
                [c[name] for c in r] for r in ep["launches"]])
        e["rl"] = dict(
            shape=f"rl loop: {RL_ARCH}, prompt {RL_PROMPT}, k {RL_K}, "
                  f"{rl['shape']['groups']} groups x "
                  f"{rl['shape']['max_new']} new tokens a step, "
                  f"{TRAIN_ROWS} rows of {TRAIN_SEQ}, bf16",
            launches_per_train_step=[r["launches"][name]
                                     for r in rl["rows"]],
            launches_generation=rl["gen"][name],
            groups_generated=rl["res"]["stats"].trees_generated,
            launches_per_train_step_max_ahead_0=[
                r["launches"][name] for r in rl["rows0"]],
            zamba2=dict(launches_per_train_step=[
                r["launches"][name] for r in ssm["rl"]["rows"]],
                launches_generation=ssm["rl"]["gen"][name]))
        if key == "fwd":
            e["launches_serve"] = serve_launches
            e["moe"]["launches_serve"] = moe_serve_launches
            e["moe"]["serve_layers"] = moe_depth
            e.update(timing_ab)     # the serving shapes A and B
        else:
            e["plain_and_library_compute"] = "dq, dk and dv together"
        entries.append(e)
    print(json.dumps({"kernels": entries}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    rc = main()
    # end here: a process group's or an allocator's teardown at the
    # interpreter's exit must not outlive the result (every rank and
    # subprocess this script started has been joined)
    for child in mp.active_children():
        child.kill()
        child.join()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
