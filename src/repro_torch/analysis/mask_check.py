"""Kernel mask-soundness checker: prove ``block_live`` never skips work.

The port's copy of ``repro/analysis/mask_check.py``.  The tree-attention
kernels (forward, dq, dk/dv) skip a (query tile, key tile) pair when the
predicate ``kernels/tree_attention.block_live`` says no visible (query,
key) pair can exist inside it.  An unsound predicate silently zeroes
attention — gradients stay finite and training "works", just wrong.  This
pass verifies soundness *statically*, with no kernel launch:

  boundary sweep    for every (tile shape, q_off, window) combination the
                    port's kernels and gateway waves reach, enumerate the
                    predicate's scalar inputs at their boundary values
                    (block_max at q_start±1/q_end±1, window gap at
                    window±1, …) and check the predicate against an
                    independent per-pair oracle — the plain version's
                    visibility ``j ≤ i ∧ kv_last[j] ≥ i ∧ pos_q−pos_k <
                    window`` evaluated on the *extremal* in-tile
                    assignment (every kv_last at the tile max, every
                    position at its extremum).  Visibility is monotone in
                    kv_last and anti-monotone in the position gap, so the
                    extremal assignment dominates every concrete tile and
                    the boundary values dominate the integer ranges
                    between them: the finite sweep is exhaustive over the
                    bucket universe.
  empirical sweep   pack real random trees into rows (ragged lengths
                    included) and require ``block_live_mask`` ⊇ the dense
                    per-pair visibility, reporting the proven skip rate.

The reference also pins its forward and backward kernels to the same
predicate object.  The port's CUDA kernels each carry a copy of the
predicate (``csrc/hopper.cuh``'s producer, the simple kernels, the dk/dv
kernels), which no Python object can pin; ``chip_smoke.py``'s ``mask
soundness`` phase holds them on the card instead.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from repro_torch.kernels.tree_attention import block_live, block_live_mask

BIG = 1 << 20
CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"


@dataclass
class Finding:
    """One proven contract violation."""
    target: str
    check: str
    message: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.target}: {self.message}"


@dataclass
class MaskPoint:
    """One predicate evaluation point (all *global* query indices)."""
    q_start: int
    q_end: int
    kv_start: int
    kv_end: int
    block_max: int
    window: Optional[int] = None
    gap: int = 0              # qp_min − kp_max (windowed only)


def oracle_any_visible(pt: MaskPoint) -> bool:
    """Independent per-pair oracle (the plain version's visibility,
    evaluated on the extremal in-tile assignment): does ANY (query i, key
    j) pair inside the tile admit visibility under the tile's summary
    scalars?"""
    i = np.arange(pt.q_start, pt.q_end + 1)[:, None]
    j = np.arange(pt.kv_start, pt.kv_end + 1)[None, :]
    vis = (j <= i) & (pt.block_max >= i)      # kv_last[j] ≡ block_max
    if pt.window is not None:                 # pos at extrema: gap const
        vis = vis & (pt.gap < pt.window)
    return bool(vis.any())


def predicate_live(pt: MaskPoint, live_fn: Callable = block_live) -> bool:
    if pt.window is None:
        return bool(live_fn(pt.q_start, pt.q_end, pt.kv_start,
                            pt.block_max))
    kp_max = BIG
    return bool(live_fn(pt.q_start, pt.q_end, pt.kv_start, pt.block_max,
                        qp_min=kp_max + pt.gap, kp_max=kp_max,
                        window=pt.window))


def boundary_points(block_q: int, block_k: int, q_off: int,
                    window: Optional[int], nq: int = 3):
    """Boundary-value enumeration for one bucket: all q tiles of a small
    grid, kv tiles straddling each causal/visibility boundary, block_max
    and window gap at ±1 around every decision threshold."""
    S_kv = q_off + nq * block_q
    nk = -(-S_kv // block_k)
    gaps = ([0] if window is None else
            sorted({-3, 0, window - 2, window - 1, window, window + 1,
                    BIG // 2}))
    for qi in range(nq):
        q_start = q_off + qi * block_q
        q_end = q_start + block_q - 1
        kis = sorted({0, q_start // block_k - 1, q_start // block_k,
                      q_end // block_k, q_end // block_k + 1, nk - 1})
        for ki in kis:
            if ki < 0 or ki >= nk:
                continue
            kv_start = ki * block_k
            kv_end = kv_start + block_k - 1
            for m in sorted({-1, q_start - 1, q_start, q_end, q_end + 1,
                             S_kv + 7}):
                for g in gaps:
                    yield MaskPoint(q_start, q_end, kv_start, kv_end, m,
                                    window, g)


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / source).read_text())
    if m is None:
        raise ValueError(f"csrc/{source} declares no constexpr int {name}")
    return int(m.group(1))


def kernel_tiles() -> dict:
    """Each kernel path's (query rows, keys) a predicate call covers, read
    from the CUDA sources: the simple kernels' BQ × BK; the Hopper
    forward's and dq's query tile of BQ rows (two warpgroups' 2·BQ = 128
    at hd 192, whose producer tests all of them) against ``hopper.cuh``'s
    KT keys; the Hopper dk/dv's BQ-row query tiles against its HBK-key
    block."""
    bq = _constant("tree_attention_fwd.cu", "BQ")
    bk = _constant("tree_attention_fwd.cu", "BK")
    kt = _constant("hopper.cuh", "KT")
    return {
        "simple fwd": (bq, bk),
        "simple dq": (_constant("tree_attention_bwd.cuh", "BQ"),
                      _constant("tree_attention_bwd_dq.cu", "BK")),
        "hopper fwd/dq": (bq, kt),
        "hopper fwd/dq hd 192": (2 * bq, kt),
        "hopper dkv": (_constant("tree_attention_bwd.cuh", "BQ"),
                       _constant("tree_attention_bwd_dkv.cu", "HBK")),
    }


def bucket_universe(fast: bool = False) -> list[tuple]:
    """(block_q, block_k, q_off, window) combinations the port reaches:
    the kernels' tile shapes (``kernel_tiles``); q_off 0, the gateway
    waves' ancestor pads (powers of two ≥ 8) and the session's tool
    prefill after 1056 cached keys; windows {None} plus the long-context
    8192 and adversarial small values (the reference's set)."""
    tiles = sorted(set(kernel_tiles().values()))
    off_cap = 64 if fast else 4096
    q_offs = [0] + [b for b in (8 << i for i in range(20)) if b <= off_cap]
    if not fast:
        q_offs.append(1056)
    windows = [None, 63, 8192] if fast else [None, 1, 7, 63, 257, 8192]
    return [(bq, bk, q_off, w)
            for bq, bk in tiles for q_off in q_offs for w in windows]


def check_predicate(live_fn: Callable = block_live, *,
                    buckets=None, fast: bool = False
                    ) -> tuple[list, dict]:
    """Sweep the bucket universe; a finding is a tile the predicate skips
    while the oracle proves a visible pair exists (unsoundness).  The
    report carries the proven-safe skip fraction and the count of
    live-but-empty tiles (completeness, informational only)."""
    buckets = bucket_universe(fast) if buckets is None else buckets
    findings: list = []
    total = skipped_safe = live_empty = 0
    for bq, bk, q_off, window in buckets:
        for pt in boundary_points(bq, bk, q_off, window):
            total += 1
            live = predicate_live(pt, live_fn)
            vis = oracle_any_visible(pt)
            if vis and not live:
                findings.append(Finding(
                    "kernels.block_live", "mask",
                    f"UNSOUND skip: block q[{pt.q_start},{pt.q_end}] × "
                    f"kv[{pt.kv_start},{pt.kv_end}] block_max="
                    f"{pt.block_max} window={pt.window} gap={pt.gap} "
                    f"holds a visible pair but the predicate skips it"))
                if len(findings) >= 20:
                    report = {"points": total, "buckets": len(buckets),
                              "truncated": True}
                    return findings, report
            elif not live:
                skipped_safe += 1
            elif not vis:
                live_empty += 1
    report = {
        "points": total,
        "buckets": len(buckets),
        "proven_skip_rate": skipped_safe / max(total, 1),
        "live_empty_blocks": live_empty,
        "unsound_skips": len(findings),
    }
    return findings, report


def _rows(seed: int, seq_len: int, n_trees: int = 6):
    """Random trees packed into rows of ``seq_len`` (kv_last, pos_ids)."""
    from repro_torch.core.packing import (materialize_tree_rows,
                                          plan_tree_rows)
    from repro_torch.core.tree import serialize_tree
    from repro_torch.data.synthetic import random_tree

    rng = np.random.default_rng(seed)
    sers = [serialize_tree(random_tree(rng, vocab_size=97))
            for _ in range(n_trees)]
    sers = [s for s in sers if s.n <= seq_len]
    rows = plan_tree_rows([s.n for s in sers], seq_len)
    tb = materialize_tree_rows(sers, rows, seq_len)
    return tb.kv_last, tb.pos_ids


def _soundness(kv_last, pos_q, pos_k, S: int, q_off: int, block_q: int,
               block_k: int, window: Optional[int]):
    """(mask, tiles holding a dense-visible pair) for one row of S queries
    at global indices q_off.. over kv_last's keys."""
    Skv = kv_last.shape[0]
    mask = np.asarray(block_live_mask(
        kv_last, S, block_q, block_k, q_off=q_off,
        pos_q=pos_q if window else None, pos_k=pos_k if window else None,
        window=window))
    i = q_off + np.arange(S)[:, None]
    j = np.arange(Skv)[None, :]
    vis = (j <= i) & (kv_last[None, :] >= i)
    if window is not None:
        vis &= (pos_q[:, None] - pos_k[None, :]) < window
    nq, nk = mask.shape
    vis = np.pad(vis, ((0, nq * block_q - S), (0, nk * block_k - Skv)))
    return mask, vis.reshape(nq, block_q, nk, block_k).any((1, 3))


def empirical_mask_check(*, seeds=(0, 1, 2), seq_len: int = 128,
                         block: int = 32, window: Optional[int] = None,
                         ragged: bool = True) -> tuple[list, dict]:
    """Pack real random trees and require the kernel's tile mask to cover
    every tile holding a dense-visible pair; report the proven skip rate.
    With ``ragged`` each row is also checked cut to a length the tiles do
    not divide (the kernels mask ragged tails, and ``block_live_mask``
    counts a tail tile's real rows and keys only), and at the serving
    shapes: the session's tool prefill (8 branches of S 200 after 1056
    cached keys, q_off 1056) and Phi-3-vision's rows (576 prefix rows
    every text token sees, then 4096 text tokens)."""
    findings: list = []
    total = live = 0

    def hold(tag, kv_last, pos_q, pos_k, S, q_off, bq, bk):
        nonlocal total, live
        mask, vis_tiles = _soundness(kv_last, pos_q, pos_k, S, q_off, bq,
                                     bk, window)
        bad = vis_tiles & ~mask
        if bad.any():
            qi, ki = map(int, np.argwhere(bad)[0])
            findings.append(Finding(
                "kernels.block_live_mask", "mask",
                f"{tag}: visible pair in tile ({qi},{ki}) skipped by the "
                f"packed-row mask"))
        total += mask.size
        live += int(mask.sum())

    for seed in seeds:
        kl, pos = _rows(seed, seq_len)
        for r in range(kl.shape[0]):
            hold(f"seed {seed} row {r}", kl[r], pos[r], pos[r], seq_len, 0,
                 block, block)
            if ragged:
                n = seq_len - block // 2 - 3
                hold(f"seed {seed} row {r} cut to {n}", kl[r, :n],
                     pos[r, :n], pos[r, :n], n, 0, block, block)
    if ragged:
        for bq, bk in sorted(set(kernel_tiles().values())):
            # the tool prefill: 1056 cached keys every query sees
            A, S = 1056, 200
            kl = np.concatenate([np.full(A, BIG), np.full(S, A + S - 1)])
            pos = np.arange(A + S)
            hold(f"tool prefill tiles {bq}x{bk}", kl, pos[A:], pos, S, A,
                 bq, bk)
            # Phi-3-vision: a 576-row prefix, then packed text rows
            F, S = 576, 4096
            tkl, tpos = _rows(seeds[0], S, n_trees=60)
            kl = np.concatenate([np.full(F, F + S - 1),
                                 np.where(tkl[0] >= 0, tkl[0] + F, -1)])
            pos = np.concatenate([np.arange(F), tpos[0] + F])
            hold(f"prefix {F} + {S} tiles {bq}x{bk}", kl, pos, pos, F + S,
                 0, bq, bk)
    report = {"blocks": total,
              "proven_skip_rate": 1.0 - live / max(total, 1)}
    return findings, report
