#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA
                                   # card with sm_90a (H100) and nvcc

Phases, each of which ends the run non-zero if it fails:
  1. build      — nvcc the three kernel sources (tree-attention forward, dq,
                  dk/dv) in parallel, one process each; print every kernel
                  instance's registers and spills from ptxas's report and
                  its wgmma (HGMMA) and TMA-load (UTMALDG) instruction
                  counts; each Hopper instance (bf16 hd 64/128) must show
                  both and spill nothing.
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
                  Δ itself (bf16 hd 64/128) its Δ is held against the plain
                  ``delta`` at 1e-5 of Σ|do·o| per row, dq and Δ must be
                  bit-identical over two launches and dq exactly 0 on rows
                  that see no key.
  4. serve      — Qwen2-1.5B at full width, random bf16 weights: 4 rollout
                  groups (prompt 1024, K=8, 64 new tokens) and one
                  multi-turn agentic session (prefill → fork(8) → 32 steps →
                  a 200-token tool-output prefill on all branches → 32
                  steps).  Launch counts are reset just before and read just
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
                  of the step's window.  Then one tree-vs-baseline step
                  comparison on the same trees.  Counts are reset just
                  before and read just after.
  7. train parity — (a) 4 layers f32, kernel vs plain attention: loss 1e-5
                  relative, grads max-rel 1e-4; (b) the same through the
                  kernels, tree vs per-branch baseline (Eq. 5), same limits;
                  (c) 28 layers bf16, kernel vs plain: loss 1e-2 relative,
                  gradient relative L2 5e-2.
  8. timing     — each kernel, its plain version and one library call, at
                  the serving path's two shapes A and B (forward) and at
                  the training shape T (all three), beside the H100's bound
                  and as a percentage of it; kernel and library call also
                  as device time, replayed from a CUDA graph (SDPA's
                  backward, which a graph cannot capture: the sum of its
                  kernels in torch.profiler).  The torch Δ reduction is
                  timed only where the backward still runs it.
Then the MoE model, Qwen3-30B-A3B (H 32, Kh 4, 128 experts top-8), once
the dense model's tensors are freed:
  9. moe kernel — phases 2-3 at H 32/Kh 4: a gateway case (f32, bf16),
                  the serving path's prefill and tool prefill, and the MoE
                  train step's rows T_moe.
 10. moe serve  — all 48 layers (or the deepest cut whose bf16 weights fit
                  75 GB, printed as reduced), random weights: phase 4's
                  groups and session, decode tokens/s beside the bound of
                  reading every weight once a step, a profiled decode
                  step; teacher-forced replays of the session up to its
                  second prefill, through the kernels and the plain
                  attention, with the routing recorded: the dropped share of (token, slot)
                  pairs at prefill and decode, the routing balance, bf16
                  prefill-logits parity (relative L2 ≤ 5e-2) and routing
                  agreement.
 11. moe parity — 2 layers f32, kernel vs plain, teacher-forced: logits
                  max-rel ≤ 1e-4; routing flips counted, and the rows they
                  reach left out of the check and reported.
 12. moe train  — phase 6 at depth 2 (2 rows of 4096, bf16).
 13. moe train parity — 1 layer f32, one row of 2048: (a) kernel vs plain,
                  (b) tree vs baseline with the aux losses off and
                  capacity factor E/K (C = N): loss 1e-5 relative, gradient
                  relative L2 1e-4, routing flips counted; then, not
                  checked, tree vs baseline at the real capacity factor.
 14. moe timing T — phase 8's training-shape timing at T_moe.

The line before the last names the card and its power limit; the one before
it lists the kernels (each with its MoE-shape numbers under ``moe``); the
last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 2.
"""
from __future__ import annotations

import bisect
import dataclasses
import gzip
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.packing import pack_linear_paths, pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.loader import LoaderConfig, tree_stream  # noqa: E402
from repro_torch.data.synthetic import agentic_tree, random_tree  # noqa: E402
from repro_torch.device import flatten_tree  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.kernels import tree_attention_bwd as tab  # noqa: E402
from repro_torch.kernels.ref import (tree_attention_bwd_ref,  # noqa: E402
                                     tree_attention_ref_ext)
from repro_torch.models import moe as moe_layer  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import (init_params, layer_groups,  # noqa: E402
                                      prepare_batch)
from repro_torch.serve import decode  # noqa: E402
from repro_torch.serve.rollout import (RolloutConfig, rollout_group,  # noqa: E402
                                       sample_tokens)
from repro_torch.serve.session import DecodeSession  # noqa: E402
from repro_torch.train.engine import (ExecutionPlan, PackedExec,  # noqa: E402
                                      TreeTrainEngine)
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.planner import plans  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

BIG = 1 << 30
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL_F32 = 1e-4                # f32 sums in another order on the card
TOL_BF16_PLAIN = 2e-2         # against the plain version run in bf16
TOL_BWD_L2 = 1e-2             # bf16 backward: relative L2 per output
TOL_BWD_ELEM = 5e-2           # bf16 backward: 5e-2 + 5e-2·|ref| per element
SOURCES = (ta.SOURCE, *tab.SOURCES)
KERNELS = {"tree_attention_fwd": ta.tree_attention,
           "tree_attention_bwd_dq": tab.bwd_dq,
           "tree_attention_bwd_dkv": tab.bwd_dkv}
# the training phase: 2 rows of 4096, 4 agentic trees per generator batch
TRAIN_ROWS, TRAIN_SEQ, SFT_STEPS, RL_STEPS = 2, 4096, 4, 2
TRAIN_GEN = dict(num_turns=3, turn_len_range=(64, 256))
# the MoE model (Qwen3-30B-A3B): its attention heads, the depth it trains
# at, and the memory its serving weights and work may take
MOE_ARCH, MOE_HEADS, MOE_TRAIN_LAYERS = "qwen3_30b_a3b", (32, 4), 2
MOE_PEAK_LIMIT = 75e9
DEV = "cuda"
CARD = ""
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


def qkv(rng, B, S, Skv, H, Kh, hd, dtype):
    mk = lambda *sh: torch.tensor(rng.normal(size=sh), dtype=dtype, device=DEV)
    return mk(B, S, H, hd), mk(B, Skv, Kh, hd), mk(B, Skv, Kh, hd)


def i32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=DEV)


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


def kernel_cases(train_kv_last=None):
    """(name, dtype, q, k, v, kv_last, q_off, window, pos_q, pos_k).  With
    ``train_kv_last`` the training shape T (its real kv_last) comes last."""
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
        np.concatenate([np.full((8, 1056), BIG), np.full((8, 200), 1255)],
                       1), q_off=1056)
    if train_kv_last is not None:
        B, S = train_kv_last.shape
        add(f"train shape T (B={B}, S={S}) bf16", bf16, B, S, 12, 2, 128,
            train_kv_last)
    return cases


def moe_kernel_cases(train_kv_last):
    """The MoE model's attention (H 32, Kh 4: a GQA group of 8, hd 128): a
    gateway case in f32 and bf16, the serving path's prefill and tool
    prefill, and the MoE training shape T (its real kv_last) last."""
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
        200, H, Kh, 128, np.concatenate(
            [np.full((8, 1056), BIG), np.full((8, 200), 1255)], 1),
        q_off=1056)
    B, S = train_kv_last.shape
    add(f"H {H}/Kh {Kh} MoE train shape T (B={B}, S={S}) bf16", bf16, B, S,
        H, Kh, 128, train_kv_last)
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


def plain(q, k, v, *args, f32: bool = False, **kw):
    """The kernel's plain version, in the inputs' dtype or (``f32``) in f32
    from the same values."""
    if f32:
        q, k, v = q.float(), k.float(), v.float()
    return tree_attention_ref_ext(q, k, v, *args, **kw)


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
            ins = ("" if sass is None else
                   f"; SASS: {sass[0]} HGMMA (wgmma), {sass[1]} UTMALDG (TMA)")
            log(f"build:   {name}: {regs} registers, {st} bytes spill stores, "
                f"{ld} bytes spill loads{ins}")
            if "_hopper_kernel<" in name:
                check(st == ld == 0, f"{name} spills")
                check(sass is None or (sass[0] > 0 and sass[1] > 0),
                      f"{name}: no wgmma or no TMA load in its SASS")
    log(f"build: {len(SOURCES)} sources, one nvcc {' '.join(build.NVCC_FLAGS)}"
        f" each, all started together: {total:.2f} s in all")
    return total


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
            do = torch.tensor(rng.normal(size=q.shape), dtype=dt, device=DEV)
            o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True,
                                       **kw)
            got = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc, **kw)
            again = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc, **kw)
            torch.cuda.synchronize()
            want = tree_attention_bwd_ref(q.float(), k.float(), v.float(), kl,
                                          o.float(), lse, do.float(), sc, **kw)
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
            if dt == torch.bfloat16 and q.shape[-1] in ta.HOPPER_HEAD_DIMS:
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


def multiturn(cfg, params, impl: str, gen=None, record=None,
              tail_steps: int = 32):
    """prefill 1024 → fork(8) → 32 steps → prefill 200 "tool output"
    tokens on all 8 branches (the kernel's q_off path) → ``tail_steps``
    steps.

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
        timing[f"{kind}_s"] += time.perf_counter() - t0
        timing[f"{kind}_tok"] += n_tok
        timing["kinds"].append(kind)
        check(bool(torch.isfinite(out).all()), f"non-finite logits ({impl})")
        logits.append(out)
        return out

    def sample(lg):
        if record is not None:
            return None
        return sample_tokens(lg, cfg.vocab_size, gen, 1.0)

    sess = DecodeSession.create(cfg, params, buf_len=1536)
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


def phase_serve(cfg, params, tag: str = "serve"):
    rc = RolloutConfig(k=8, prompt_len=1024, max_new=64, temperature=1.0)
    gen = torch.Generator(DEV).manual_seed(1)
    rng = np.random.default_rng(7)
    reset_launches()
    n_prefill = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for g in range(4):
            prompt = rng.integers(0, cfg.vocab_size, rc.prompt_len)
            tree, st = rollout_group(cfg, params, prompt, rc, gen)
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
        n_prefill += 2
    counts = launch_counts()
    launches = counts["tree_attention_fwd"]
    log(f"{tag}: 4 rollout groups (prompt {rc.prompt_len}, k {rc.k}, "
        f"max_new {rc.max_new}) in {t_groups:.3f} s ({t_groups / 4:.3f} s a "
        f"group; prefill_tokens == prompt_len in each); multi-turn session: "
        f"prefill {tm['prefill_tok'] / tm['prefill_s']:.1f} tokens/s "
        f"({tm['prefill_tok']} tokens in {tm['prefill_s']:.4f} s), decode "
        f"{tm['decode_tok'] / tm['decode_s']:.1f} tokens/s "
        f"({tm['decode_tok']} tokens in {tm['decode_s']:.4f} s)")
    log(f"{tag}: kernel launches {counts} (forward = {cfg.n_layers} layers "
        f"x {n_prefill} parallel prefills; no backward)")
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

def train_plans(cfg, kind: str, loss_mode: str, n: int):
    """The first ``n`` non-empty plans of the launcher's planner."""
    lc = LoaderConfig(seq_len=TRAIN_SEQ, batch_rows=TRAIN_ROWS,
                      trees_per_batch=4, kind=kind, loss_mode=loss_mode,
                      seed=0, gen_kwargs=TRAIN_GEN)
    out, dropped = [], 0
    for plan in plans(cfg, lc, 8 * n, device=DEV):
        if plan.is_empty:
            dropped += plan.dropped
            continue
        plan.dropped += dropped
        dropped = 0
        out.append(plan)
        if len(out) == n:
            return out
    raise Failed(f"the planner gave fewer than {n} {kind} plans")


def row_trees(cfg, S: int, scan: int = 64):
    """The first trees of the agentic stream (first fit, in stream order,
    over its first ``scan`` trees) whose unique tokens fit one row of S,
    and no path of which is longer than S."""
    lc = LoaderConfig(seq_len=TRAIN_SEQ, trees_per_batch=4, seed=0,
                      gen_kwargs=TRAIN_GEN)
    trees, used = [], 0
    for batch in tree_stream(cfg, lc, scan // 4):
        for t in batch:
            n = serialize_tree(t).n
            if used + n <= S and max(len(p["tokens"])
                                     for p in t.linearize_paths()) <= S:
                trees.append(t)
                used += n
    return trees


def tree_and_baseline(cfg, trees, S: int):
    """The trees packed into one row of S (tree mode) and their linearized
    paths into as many rows of S as they need (baseline)."""
    tb = pack_trees([serialize_tree(t) for t in trees], S, batch_size=1)
    bb = pack_linear_paths([t.linearize_paths() for t in trees], S)
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


def phase_train(cfg, sft, rl, tag: str = "train"):
    """Full-width training through the kernels, then tree vs baseline."""
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
        f"{cfg.dtype}, {cfg.param_count() / 1e9:.3f} B params + fp32 AdamW "
        f"state: {torch.cuda.memory_allocated() / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.2f} s")
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
        check(all(d == cfg.n_layers for d in delta.values()),
              f"train step {i}: launches {delta}, want {cfg.n_layers} each")
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

    # tree vs per-branch baseline on the same trees, rows of 2048
    trees = row_trees(cfg, 2048)
    bt, bb = tree_and_baseline(cfg, trees, 2048)
    del opt_state
    res = {}
    for name, batch in (("tree", bt), ("baseline", bb)):
        opt = init_opt_state(params)
        eng = TreeTrainEngine(cfg, OptimizerConfig(
            lr=3e-4, warmup_steps=2, total_steps=4))
        plan = ExecutionPlan(packed=PackedExec(
            inputs=batch, tokens=int(batch["valid"].sum()),
            cells=batch["tokens"].numel()), num_trees=len(trees))
        torch.cuda.reset_peak_memory_stats()
        ts = []
        for _ in range(3):
            t1 = time.perf_counter()
            params, opt, m = eng.step(params, opt, plan)
            ts.append(time.perf_counter() - t1)
            check(math.isfinite(m["loss"]), f"{name} step: non-finite loss")
        res[name] = (statistics.median(ts[1:]), plan.unique_tokens,
                     tuple(batch["tokens"].shape), peak_gb())
        del opt
    (t_t, n_t, sh_t, pk_t), (t_b, n_b, sh_b, pk_b) = res["tree"], \
        res["baseline"]
    log(f"{tag}: tree vs per-branch baseline on the same {len(trees)} trees "
        f"(rows of 2048, full width, {cfg.dtype}, kernels, AdamW included): "
        f"tree {n_t} tokens in {sh_t[0]} row(s), step {t_t:.3f} s, peak "
        f"{pk_t:.2f} GB; baseline {n_b} tokens in {sh_b[0]} row(s), step "
        f"{t_b:.3f} s, peak {pk_b:.2f} GB; {n_b / n_t:.3f} flat tokens per "
        f"unique token, step time ratio baseline/tree {t_b / t_t:.3f} "
        f"(median of 2 after one warm-up step each)")
    return params, counts, step_s


def profile_step(step, name: str = "train_step_trace",
                 what: str = "train step"):
    """Run ``step`` (one train step, or ``what``) once under torch.profiler
    with CUDA activity and print, from its Chrome trace: the 15 CUDA
    kernels with the most device time (name, calls, ms, share of the step's
    window) and the device-busy share of that window — the union of
    kernel, memcpy and memset intervals over the host-clock span of the
    step, which must end in a host sync.  The trace is kept, gzipped, as
    build/<name>.json.gz (``build/`` is not committed).  Returns ``step``'s
    result."""
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
    report_trace(json.loads(raw)["traceEvents"], what)
    return out


def report_trace(trace_events, what: str = "train step") -> None:
    """``profile_step``'s report from the events of a Chrome trace that
    holds one ``train_step`` annotation."""
    events = [e for e in trace_events if e.get("ph") == "X"]
    marks = [e for e in events if e.get("name") == "train_step"
             and e.get("cat") == "user_annotation"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not marks or not dev:
        log(f"profile: the trace holds {len(marks)} step marks and "
            f"{len(dev)} device events: no device breakdown")
        return
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
    # the layer stacks' gradients: one unbind per stack leaf and forward
    # (its backward stacks the layers' grads), or a select per layer
    log("profile: the layer stacks' gradient nodes (kernels, ms, share of "
        "the window): " + "; ".join(
            f"{op} {by_op.get(op, (0, 0.0))[0]} / "
            f"{by_op.get(op, (0, 0.0))[1] / 1e3:.3f} ms / "
            f"{100 * by_op.get(op, (0, 0.0))[1] / win:.1f}%"
            for op in ("UnbindBackward0", "SelectBackward0")))


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
# the MoE model: Qwen3-30B-A3B
# --------------------------------------------------------------------------

class RoutingLog:
    """While active, records every MoE layer call's routing: for each token
    its top-k experts (sorted), which of its (token, slot) pairs its expert
    kept, and whether it is valid.  They are recomputed from the layer's own
    input by ``moe.route`` and ``moe.queue``, the functions the layer calls,
    so the layer's output is the unwrapped layer's."""

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
        return self

    def __exit__(self, *exc):
        transformer.moe = decode.moe = self._real

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


def flipped_tokens(a: RoutingLog, b: RoutingLog) -> list:
    """Per MoE call of two runs over the same inputs: the [N] bool of valid
    tokens whose top-k expert set differs."""
    check(len(a.calls) == len(b.calls), "the two runs made different MoE "
                                        "calls")
    return [(ea != eb).any(-1) & va
            for (_, _, ea, _, va), (_, _, eb, _, _) in zip(a.calls, b.calls)]


def share(n: int, d: int) -> str:
    return f"{n} of {d} ({100 * n / max(d, 1):.3f}%)"


def moe_serve_depth(cfg) -> int:
    """The deepest cut of ``cfg`` whose bf16 weights, with 6 GB for the
    caches, activations and the parity replays, stay under
    ``MOE_PEAK_LIMIT``."""
    one = cfg.replace(n_layers=1)
    head = cfg.replace(n_layers=0).param_count() * 2
    per_layer = one.param_count() * 2 - head \
        + 2 * cfg.d_model * cfg.moe.num_experts        # the fp32 router
    return min(cfg.n_layers, int((MOE_PEAK_LIMIT - 6e9 - head) // per_layer))


def phase_moe_serve(cfg_full):
    """Qwen3-30B-A3B at full width and the deepest cut that fits (all 48
    layers on an 80 GB card): the serve phase's rollout groups and session,
    then teacher-forced replays of the session up to its second prefill
    with the kernels and with the plain attention, recording the routing: the dropped share of
    (token, slot) pairs, prefill logits parity in bf16 and the routing
    agreement.  Returns (the serve run's forward launches, the depth)."""
    L = moe_serve_depth(cfg_full)
    cfg = cfg_full.replace(n_layers=L)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    cut = "" if L == cfg_full.n_layers else (
        f" (reduced: {L} of {cfg_full.n_layers} layers fit "
        f"{MOE_PEAK_LIMIT / 1e9:.0f} GB)")
    log(f"moe serve: {cfg.name} {L} layers{cut} d {cfg.d_model} heads "
        f"{cfg.attn.n_heads}/{cfg.attn.n_kv_heads} hd {cfg.attn.head_dim} "
        f"qk_norm, {cfg.moe.num_experts} experts top-{cfg.moe.top_k} d_expert "
        f"{cfg.moe.d_expert} capacity factor {cfg.moe.capacity_factor}, "
        f"{cfg.dtype} (router fp32): {cfg.param_count() / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, random weights in "
        f"{time.perf_counter() - t0:.2f} s")
    calls, logits, tm, launches = phase_serve(cfg, params, "moe serve")
    # a decode step multiplies every expert at capacity 1: it reads every
    # weight but the embedding table
    step_bytes = sum(t.numel() * t.element_size()
                     for p, t in flatten_tree(params) if p[0] != "embed")
    bound_s = step_bytes / PEAK_BYTES
    log(f"moe serve: decode {tm['decode_tok'] / tm['decode_s']:.1f} tokens/s "
        f"(8 branches, {tm['decode_s'] / (tm['decode_tok'] / 8) * 1e3:.2f} ms "
        f"a step) against its bound: a step reads {step_bytes / 1e9:.2f} GB "
        f"of weights (every expert multiplies at capacity "
        f"{moe_layer.capacity(8, cfg.moe)}), >= {bound_s * 1e3:.2f} ms at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s, so at most {8 / bound_s:.1f} tokens/s")
    with torch.inference_mode():
        # the replays end at the second prefill: both prefills and the 32
        # decode steps between them
        with RoutingLog() as rk:
            _, lk, tmk = multiturn(cfg, params, "kernel", record=calls,
                                   tail_steps=0)
        with RoutingLog() as rr:
            _, lr, _ = multiturn(cfg, params, "ref", record=calls,
                                 tail_steps=0)
    same = all(torch.equal(a, b) for a, b in zip(lk, logits))
    pre = [i for i, k in enumerate(tmk["kinds"]) if k == "prefill"]
    e_pre = max(rel_l2(lk[i], lr[i]) for i in pre)
    e_all = max(rel_l2(a, b) for a, b in zip(lk, lr))
    flips = flipped_tokens(rk, rr)
    n_pre = sum(int(f.sum()) for f, c in zip(flips, rk.calls) if c[1] > 1)
    n_dec = sum(int(f.sum()) for f, c in zip(flips, rk.calls) if c[1] == 1)
    d_pre = sum(int(c[4].sum()) for c in rk.calls if c[1] > 1)
    d_dec = sum(int(c[4].sum()) for c in rk.calls if c[1] == 1)
    log(f"moe serve: share of (token, slot) pairs dropped (capacity "
        f"{cfg.moe.capacity_factor} x N·K/E per call, N the call's tokens): "
        f"prefill {share(*rk.drop_share(False))}, decode "
        f"{share(*rk.drop_share(True))} (capacity "
        f"{moe_layer.capacity(8, cfg.moe)} at 8 branches)")
    busy = rk.busiest(0, L)     # the prompt's prefill, layer by layer
    m = cfg.moe
    log(f"moe serve: routing balance of the prompt's prefill (1024 tokens, "
        f"top-{m.top_k} of {m.num_experts}: "
        f"{100 * m.top_k / m.num_experts:.2f}% each if uniform, capacity "
        f"{100 * moe_layer.capacity(1024, m) / 1024:.2f}%): "
        f"the busiest expert takes {100 * busy[0]:.1f}% of the tokens at "
        f"layer 0, {100 * statistics.median(busy):.1f}% at the median layer, "
        f"{100 * max(busy):.1f}% at most (layer {busy.index(max(busy))})")
    log(f"moe serve parity (b): {L} layers bf16, kernel vs plain attention, "
        f"teacher-forced multi-turn replay: relative L2 of the prefill logits "
        f"{e_pre:.3e} (limit 5e-2; {len(pre)} prefill calls), of every call's "
        f"{e_all:.3e} (not checked); routing agreement over (token, layer): "
        f"prefill {100 - 100 * n_pre / max(d_pre, 1):.3f}% ({n_pre} of "
        f"{d_pre} differ), decode {100 - 100 * n_dec / max(d_dec, 1):.3f}% "
        f"({n_dec} of {d_dec}); the kernel replay reproduces the timed run's "
        f"logits bit for bit: {same}")
    check(e_pre <= 5e-2, "moe serve parity (b)")
    del params, logits, lk, lr, rk, rr
    torch.cuda.empty_cache()
    return launches, L


def phase_moe_parity(cfg_full):
    """(a) 2 layers at full width in f32: the multi-turn session through
    the kernels, replayed teacher-forced through the plain attention, with
    routing recorded.  A (token, layer) whose expert set differs between the
    two (a near-tie in the top-8 of 128 flipped by sub-1e-6 differences) is
    reported, and the logits rows it can reach are left out of the check:
    its own branch from that call on, every branch if it lies in the shared
    prompt."""
    cfg = cfg_full.replace(n_layers=2, dtype="float32")
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
    log(f"moe parity (a): 2 layers f32 at full width, kernel vs plain "
        f"attention, teacher-forced multi-turn: max relative error of logits "
        f"{worst:.3e} (limit 1e-4) over {compared} rows; routing flips "
        f"{n_flip} of {n_dec} (token, layer) decisions, {excluded} logits "
        f"rows left out for them")
    check(compared > 0, "moe parity (a): every row was left out")
    check(worst <= 1e-4, "moe parity (a)")
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
    it.  None where the call cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
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


def profiler_kernel_ms(fn, reps: int = 5) -> float:
    """Device time of one call of ``fn`` as the sum of the durations of the
    CUDA kernels it launches, from a torch.profiler trace of ``reps`` calls
    after one warm-up (for calls a CUDA graph cannot capture)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "kernel_sum_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return sum(e["dur"] for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel") / 1e3 / reps


def phase_timing_train(train_kv_last, step_s: float, n_layers: int,
                       heads=(12, 2), tag: str = "T"):
    """All three kernels at a training shape (the first train step's
    packed rows and their real kv_last; ``heads`` = (H, Kh)), with bounds
    on visible pairs."""
    rng = np.random.default_rng(10)
    B, S = train_kv_last.shape
    (H, Kh), hd, dt = heads, 128, torch.bfloat16
    kl = i32(train_kv_last)
    q, k, v = qkv(rng, B, S, S, H, Kh, hd, dt)
    do = torch.tensor(rng.normal(size=q.shape), dtype=dt, device=DEV)
    sc = hd ** -0.5
    out = {}
    fused = tab.fuses_delta(q)      # the dq kernel computes Δ itself
    with torch.inference_mode():
        o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True)
        _, dl = tab.bwd_dq(q, k, v, kl, o, lse, do, sc)
        pairs = int(dense_mask(kl, S, 0).sum())
        fwd = lambda: ta.tree_attention(q, k, v, kl, sc, save_residuals=True)
        dq = lambda: tab.bwd_dq(q, k, v, kl, o, lse, do, sc)
        dkv = lambda: tab.bwd_dkv(q, k, v, kl, lse, dl, do, sc)
        ms = {"fwd": time_ms(fwd), "dq": time_ms(dq), "dkv": time_ms(dkv)}
        if not fused:     # the backward still runs the torch reduction
            ms["delta"] = time_ms(lambda: tab.delta(o, do))
        dev = {"fwd": graph_ms(fwd), "dq": graph_ms(dq), "dkv": graph_ms(dkv)}
        ms["plain_fwd"] = time_ms(lambda: tree_attention_ref_ext(
            q, k, v, kl, sc, return_lse=True))
        ms["plain_bwd"] = time_ms(lambda: tree_attention_bwd_ref(
            q, k, v, kl, o, lse, do, sc))
    mask = dense_mask(kl, S, 0)
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
    dev["lib_fwd"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), attn_mask=mask, scale=sc))
    # autograd runs the backward outside the capturing stream, so no graph:
    # its device time is the sum of its kernels in torch.profiler
    dev["lib_bwd"] = profiler_kernel_ms(lib_bwd)
    del ot, qt, kt, vt, mask
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
        log(f"timing {key} at {tag} (B={B}, S={S}, H={H}, Kh={Kh}, hd=128, "
            f"bf16, "
            f"real kv_last, {pairs} visible pairs; CUDA events, median of 20 "
            f"after 3 warm-up): kernel {ms[key]:.4f} ms, bound {bnd:.4f} ms "
            f"by {by} ({per_pair}·hd·H FLOPs per visible pair = "
            f"{flops / 1e12:.4f} TFLOP, {nbytes / 1e6:.3f} MB), kernel at "
            f"{100 * bnd / ms[key]:.1f}% of its bound, "
            f"{flops / ms[key] / 1e9:.1f} TFLOP/s; plain {what} "
            f"{plain_ms:.4f} ms; sdpa {what} (dense bool mask, K/V expanded) "
            f"{lib_ms:.4f} ms; device time: kernel {fmt_ms(dev[key])} (CUDA "
            f"graph), sdpa {fmt_ms(lib_dev)} ("
            + ("CUDA graph" if key == "fwd" else
               "sum of its kernels in torch.profiler") + ")")
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
            f"backward {dev['lib_bwd']:.4f} ms (the sum of its kernels in "
            f"torch.profiler: autograd runs it outside a capturing stream)")
    att = n_layers * (ms["fwd"] + bwd_sum + ms.get("delta", 0.0)) / 1e3
    log(f"timing at {tag}: attention share of a train step: {n_layers} x "
        f"(fwd + dq + dk/dv{'' if fused else ' + Δ'}) = {att:.3f} s of the "
        f"{step_s:.3f} s median step ({100 * att / step_s:.1f}%)")
    out["dq"]["delta_in_kernel"] = fused
    return out


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
    phase_s = {}

    def timed(name, fn, *args):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s, peak memory "
            f"{peak_gb():.2f} GB")
        return out

    cfg = get_config("qwen2_1p5b")
    sft = train_plans(cfg, "agentic", "sep_avg", SFT_STEPS)
    rl = train_plans(cfg, "grpo", "rl", RL_STEPS)
    kl_t = sft[0].packed.inputs["kv_last"].cpu().numpy()
    timed("build", phase_build)
    worst_fwd = timed("kernel", phase_kernel, kernel_cases())
    worst_bwd = timed("bwd kernel", phase_bwd_kernel, kernel_cases(kl_t))

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.n_layers} layers d {cfg.d_model} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size} (padded {cfg.padded_vocab}) "
        f"heads {cfg.attn.n_heads}/{cfg.attn.n_kv_heads} hd "
        f"{cfg.attn.head_dim} {cfg.dtype}: {cfg.param_count() / 1e9:.3f} B "
        f"params, {torch.cuda.memory_allocated() / 1e9:.2f} GB, random "
        f"weights in {time.perf_counter() - t0:.2f} s")
    calls, logits, _, serve_launches = timed("serve", phase_serve, cfg,
                                             params)
    timed("parity", phase_parity, cfg, params, calls, logits)
    del params, logits
    torch.cuda.empty_cache()

    params, counts, step_s = timed("train", phase_train, cfg, sft, rl)
    timed("train parity", phase_train_parity, cfg, params)
    del params
    torch.cuda.empty_cache()
    timing_ab = timed("timing", phase_timing_serve)
    timing = timed("timing T", phase_timing_train, kl_t, step_s,
                   cfg.n_layers)

    # the MoE model, Qwen3-30B-A3B, once the dense model's tensors are gone
    mcfg = get_config(MOE_ARCH)
    mcfg_train = mcfg.replace(n_layers=MOE_TRAIN_LAYERS)
    msft = train_plans(mcfg_train, "agentic", "sep_avg", SFT_STEPS)
    mrl = train_plans(mcfg_train, "grpo", "rl", RL_STEPS)
    kl_m = msft[0].packed.inputs["kv_last"].cpu().numpy()
    worst_fwd = max(worst_fwd, timed("moe kernel", phase_kernel,
                                     moe_kernel_cases(kl_m), False))
    worst_m = timed("moe bwd kernel", phase_bwd_kernel, moe_kernel_cases(kl_m))
    worst_bwd = {k: max(worst_bwd[k], worst_m[k]) for k in worst_bwd}
    moe_serve_launches, moe_depth = timed("moe serve", phase_moe_serve, mcfg)
    timed("moe parity", phase_moe_parity, mcfg)
    params, moe_counts, moe_step_s = timed("moe train", phase_train,
                                           mcfg_train, msft, mrl, "moe train")
    del params
    torch.cuda.empty_cache()
    timed("moe train parity", phase_moe_train_parity, mcfg)
    timing_moe = timed("moe timing T", phase_timing_train, kl_m, moe_step_s,
                       MOE_TRAIN_LAYERS, MOE_HEADS, "T_moe")
    log(f"total {time.perf_counter() - t_start:.1f} s; phases "
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
                 **timing[key])
        e["shape"] = "T: the first train step's rows, bf16, hd 128"
        e["moe"] = dict(
            shape=f"T_moe: the {MOE_TRAIN_LAYERS}-layer Qwen3-30B-A3B train "
                  f"step's rows, H 32, Kh 4, bf16, hd 128",
            launches_train=moe_counts[name], **timing_moe[key])
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
    sys.exit(main())
