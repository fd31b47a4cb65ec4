"""Plan-ahead scheduler: global cost-model-driven Tree Packing.

Port of ``repro/train/planner.py`` (``tests/test_torch_planner.py`` holds
its plans identical to the reference's for the same seeds).  The paper's
Tree Packing preserves prefix reuse *within* a step; this module owns the
schedule level above it:

  lookahead packing   trees from a window of ``lookahead`` generator
                      batches are bin-packed globally into the window's
                      steps (FFD and BFD candidates scored by
                      ``core/plan_cost``), so one batch's holes are filled
                      by the next one's trees;
  forest grafting     with ``PlannerConfig.graft``, trees whose heads share
                      a ≥ ``min_graft`` token prefix across the window are
                      merged into grafted forests (``core/forest``), each
                      merge gated by ``plan_cost.graft_gain``; the loss
                      stays a mean over SOURCE trees (``n_src``);
  auto capacity       with ``LoaderConfig.auto_capacity`` the partition cap
                      is chosen per window by
                      ``core/partition.choose_capacity``;
  replica balance     row counts are multiples of ``num_replicas`` and
                      rows are permuted so contiguous per-replica shards
                      balance (identity at the default of 1);
  oversized routing   with ``LoaderConfig.auto_partition`` a tree that does
                      not fit a row trains through Redundancy-Free Tree
                      Partitioning (partition waves, ``core/gateway``),
                      each tree partitioned exactly once and the trees
                      spread across the window's steps by partitioned load;
                      without it the tree is counted in ``dropped``;
  async pipeline      ``PlanPipeline`` builds the host-side numpy plans on
                      background threads while the engine trains; the
                      engine copies them to the device on the consumer's
                      side.  It tracks built vs *exposed* build time.

Invariants: every generated tree is packed, partitioned or counted in
``dropped`` (Σ unique tokens is conserved); parents never schedule later
than children.

Each plan carries ``versions``, the (min, max) ``weight_version`` of its
trees (the async RL service tags them; ``train/engine`` audits the lag).
For a model with a frontend (VLM, enc-dec) each step's packed rows get
stub frontend embeddings drawn as the reference's planner draws them,
``np.random.default_rng([seed, 7919, step index])``.

``plans(..., warmup=svc)`` (``train/warmup.AOTWarmupService``) keys each
step's executables on the pipeline's build threads before the engine
consumes the step.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from itertools import islice
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.analysis.signatures import step_signatures
from repro_torch.configs.base import ModelConfig
from repro_torch.core.forest import graft_trees
from repro_torch.core.gateway import build_partition_plan
from repro_torch.core.packing import (DoesNotFitError, TreeBatch,
                                      materialize_tree_rows,
                                      pack_linear_paths)
from repro_torch.core.partition import (TreePartition, choose_capacity,
                                        partition_schedule_load,
                                        partition_tree)
from repro_torch.core.plan_cost import (DEFAULT_WEIGHTS, CompileCacheSim,
                                        CostWeights, PackingCost,
                                        _packing_live_blocks,
                                        balanced_row_order, graft_gain,
                                        packed_signature, pow2,
                                        round_to_multiple, score_packing)
from repro_torch.core.tree import TrajectoryTree, serialize_tree
from repro_torch.data.loader import LoaderConfig, StepBatch, tree_stream
from repro_torch.models.model import batch_arrays, chunk_size_of
from repro_torch.train.engine import ExecutionPlan, PackedExec


@dataclass(frozen=True)
class PlannerConfig:
    """Schedule-level knobs (the data-level ones live in LoaderConfig)."""
    lookahead: int = 1            # generator batches planned jointly
    plan_workers: int = 0         # background plan builders (0 = sync)
    num_replicas: int = 1         # mesh data-axis size (row multiples)
    heuristics: tuple = ("ffd", "bfd")   # candidate packings to score
    block: int = 64               # kernel block for the skip estimate
    weights: CostWeights = DEFAULT_WEIGHTS
    max_rows: Optional[int] = None  # wave row cap (None: batch_rows)
    pipeline_depth: int = 2       # plans buffered ahead (double buffer)
    graft: bool = False           # cross-tree forest grafting (core/forest)
    min_graft: int = 16           # min shared-prefix tokens worth a graft


@dataclass
class FitTree:
    """One row-sized tree with its serialization artifacts, computed ONCE
    for the whole schedule (fit filter, candidate packings, eviction
    retries and materialization all reuse it)."""
    tree: TrajectoryTree
    ser: Any                      # SerializedTree (loss_mode applied)
    paths: list[dict]             # linearize_paths() output
    n_unique: int
    src: int                      # source generator batch (step index)
    n_src: int = 1                # source trees this entry represents
    lam_map: Optional[dict] = None  # grafted forest: id(node) → λ


@dataclass
class OversizedTree:
    """A tree routed to the partitioned driver, with its partition forest
    computed lazily and exactly once (build_partition_plan reuses it)."""
    tree: TrajectoryTree
    src: int
    parts: Optional[list[TreePartition]] = None
    n_src: int = 1                # source trees (grafted forests > 1)
    lam_map: Optional[dict] = None  # grafted forest: id(node) → λ

    def forest(self, capacity: int, chunk: Optional[int],
               loss_mode: str) -> list[TreePartition]:
        if self.parts is None:
            self.parts = partition_tree(self.tree, capacity,
                                        chunk_size=chunk,
                                        loss_mode=loss_mode,
                                        lam_map=self.lam_map)
        return self.parts

    def load(self, capacity: int, chunk: Optional[int],
             loss_mode: str) -> int:
        return partition_schedule_load(
            self.forest(capacity, chunk, loss_mode))["tokens"]


# ---------------------------------------------------------------------------
# Window scheduling: global bin packing + cost-model candidate choice
# ---------------------------------------------------------------------------

def _fit_split(trees: Sequence[TrajectoryTree], seq_len: int,
               chunk: Optional[int], loss_mode: str, src: int
               ) -> tuple[list[FitTree], list[OversizedTree]]:
    """Split one generator batch into row-sized FitTrees and oversized
    trees.  The filter checks BOTH serializations so tree and baseline
    modes see the exact same dataset — step-wise loss comparisons stay
    pure.  Each tree is serialized exactly once."""
    keep: list[FitTree] = []
    over: list[OversizedTree] = []
    for t in trees:
        ser = serialize_tree(t, chunk_size=chunk, loss_mode=loss_mode)
        paths = t.linearize_paths()
        n_path = max(len(p["tokens"]) for p in paths)
        if chunk:
            n_path += -n_path % chunk
        if max(ser.n, n_path) <= seq_len:
            keep.append(FitTree(tree=t, ser=ser, paths=paths,
                                n_unique=t.num_unique_tokens(), src=src))
        else:
            over.append(OversizedTree(tree=t, src=src))
    return keep, over


def _graft_fits(fits: list[FitTree], lc: LoaderConfig, pc: PlannerConfig,
                chunk: Optional[int], cap: int
                ) -> tuple[list[FitTree], list[OversizedTree]]:
    """Cross-tree forest grafting over the window's row-sized trees
    (``core/forest``): merge shared heads so each cross-tree prefix is
    computed once per window.  Every candidate is gated by the cost
    model's dedup term (``plan_cost.graft_gain`` on serialized, i.e.
    chunk-padded, lengths) — a losing graft falls back to its sources
    untouched.  A winning graft that no longer fits a packed row routes
    to Redundancy-Free Tree Partitioning like any oversized tree, its
    λ map and source count riding along.

    Oversized candidates are refined by recursive bisection: any
    consecutive slice of a graft group still shares the ≥ ``min_graft``
    prefix (groups are maximal runs in member-sorted order), so a group
    whose merged forest overflows the row is split in half and re-grafted
    whenever the halves' summed gain beats the whole — trading a little
    prefix redundancy (the prefix is computed once per slice) for
    row-sized forests that pack without partition-wave padding."""

    def gain_of(srcs: list[int], ser_n: int,
                parts: Optional[int] = None) -> float:
        return graft_gain(sum(fits[i].ser.n for i in srcs), ser_n,
                          lc.seq_len, cap, pc.weights, parts=parts)

    def plan_slice(srcs: list[int]) -> tuple[float, list]:
        """Best placement of a consecutive member slice: (gain,
        placements), a placement being a passthrough fit index or a
        (graft, ser, window-indices) triple."""
        if len(srcs) == 1:
            return 0.0, [srcs[0]]
        gs, ps = graft_trees([fits[i].tree for i in srcs],
                             loss_mode=lc.loss_mode,
                             min_graft=pc.min_graft)
        gain_tot: float = 0.0
        placed: list = [srcs[j] for j in ps]
        for g2 in gs:
            gsrcs = [srcs[j] for j in g2.srcs]
            ser = serialize_tree(g2.tree, chunk_size=chunk,
                                 lam_map=g2.lam_map)
            parts = (len(partition_tree(g2.tree, cap, chunk_size=chunk,
                                        lam_map=g2.lam_map))
                     if ser.n > lc.seq_len else None)
            whole = gain_of(gsrcs, ser.n, parts)
            best: tuple[float, list] = ((whole, [(g2, ser, gsrcs)])
                                        if whole > 0 else (0.0, gsrcs))
            if ser.n > lc.seq_len and len(gsrcs) >= 2:
                mid = len(gsrcs) // 2
                gl, pl = plan_slice(gsrcs[:mid])
                gr, pr = plan_slice(gsrcs[mid:])
                if gl + gr > best[0]:
                    best = (gl + gr, pl + pr)
            gain_tot += best[0]
            placed += best[1]
        return gain_tot, placed

    grafts, passthrough = graft_trees(
        [f.tree for f in fits], loss_mode=lc.loss_mode,
        min_graft=pc.min_graft)
    out = [fits[i] for i in passthrough]
    over: list[OversizedTree] = []
    for g in grafts:
        _, placed = plan_slice(g.srcs)
        for p in placed:
            if isinstance(p, int):
                out.append(fits[p])
                continue
            g2, ser, gsrcs = p
            src = min(fits[i].src for i in gsrcs)
            n_src = sum(fits[i].n_src for i in gsrcs)
            if ser.n <= lc.seq_len:
                out.append(FitTree(tree=g2.tree, ser=ser, paths=[],
                                   n_unique=int(ser.valid.sum()), src=src,
                                   n_src=n_src, lam_map=g2.lam_map))
            else:
                over.append(OversizedTree(tree=g2.tree, src=src,
                                          n_src=n_src,
                                          lam_map=g2.lam_map))
    return out, over


def _assign_window(sizes: Sequence[int], num_steps: int, rows_per_step: int,
                   seq_len: int, heuristic: str
                   ) -> tuple[Optional[list[list[list[int]]]], Optional[int]]:
    """Global bin packing of the window's trees into ``num_steps`` steps of
    ``rows_per_step`` rows each (largest-first).  Returns (per-step rows
    of item indices, None) on success, or (None, i) where i is the first
    item that found no slot — since placement is largest-first, i is the
    largest *unplaceable* item, the right eviction victim (everything
    bigger provably fits and keeps training)."""
    rows: list[list[list[int]]] = [[] for _ in range(num_steps)]
    used: list[list[int]] = [[] for _ in range(num_steps)]
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    for i in order:
        n = sizes[i]
        if n > seq_len:
            return None, i
        best: Optional[tuple[int, int]] = None
        for s in range(num_steps):
            for r, u in enumerate(used[s]):
                if u + n > seq_len:
                    continue
                if heuristic == "ffd":
                    best = (s, r)
                    break
                if best is None or u > used[best[0]][best[1]]:
                    best = (s, r)       # bfd: tightest fitting row
            if heuristic == "ffd" and best is not None:
                break
        if best is None:
            for s in range(num_steps):
                if len(rows[s]) < rows_per_step:
                    best = (s, len(rows[s]))
                    rows[s].append([])
                    used[s].append(0)
                    break
            if best is None:
                return None, i
        s, r = best
        rows[s][r].append(i)
        used[s][r] += n
    return rows, None


def _score_window(steps_rows: list[list[list[int]]],
                  sizes: Sequence[int], rows_per_step: int, seq_len: int,
                  cache: CompileCacheSim, pc: PlannerConfig
                  ) -> tuple[PackingCost, list]:
    """Cost of one candidate window schedule: every non-empty step
    materializes ``rows_per_step`` rows (empty rows pad to the fixed
    batch), one packed signature per non-empty step."""
    row_sizes: list[list[int]] = []
    sigs = []
    for rows in steps_rows:
        if not any(rows):
            continue
        row_sizes.extend([sizes[i] for i in r] for r in rows)
        row_sizes.extend([] for _ in range(rows_per_step - len(rows)))
        sigs.append(packed_signature(rows_per_step, seq_len))
    cost = score_packing(row_sizes, seq_len, block=pc.block,
                         signatures=sigs, cache=cache,
                         weights=pc.weights)
    return cost, sigs


def _schedule_tree_window(
    fits: list[FitTree], num_steps: int, rows_per_step: int, seq_len: int,
    cache: CompileCacheSim, pc: PlannerConfig,
) -> tuple[list[list[list[int]]], list[int], Optional[PackingCost]]:
    """Choose the window's packed schedule: try every candidate heuristic
    on the current fit set, score the feasible ones with the cost model,
    and evict only when NO candidate can hold everything.  The victim is
    the largest item the candidates could not place — NOT the globally
    largest tree, which provably fits and keeps training (evicting it
    could pack *less* data than per-step greedy would).  Returns
    (per-step rows of fit indices, evicted fit indices, winning cost)."""
    active = list(range(len(fits)))
    evicted: list[int] = []
    while active:
        sizes = [fits[i].ser.n for i in range(len(fits))]
        cands = []
        blocked: list[int] = []
        for h in pc.heuristics:
            sub, stuck = _assign_window([sizes[i] for i in active],
                                        num_steps, rows_per_step, seq_len,
                                        h)
            if sub is not None:
                remap = [[[active[i] for i in r] for r in rows]
                         for rows in sub]
                cands.append(remap)
            else:
                blocked.append(active[stuck])
        if cands:
            best = None
            for steps_rows in cands:
                cost, sigs = _score_window(steps_rows, sizes,
                                           rows_per_step, seq_len, cache,
                                           pc)
                if best is None or cost.total < best[0].total:
                    best = (cost, sigs, steps_rows)
            cache.commit(best[1])
            return best[2], evicted, best[0]
        big = max(blocked, key=lambda i: (fits[i].n_unique, i))
        active.remove(big)
        evicted.append(big)
    return [[] for _ in range(num_steps)], evicted, None


def _permute_tb_rows(tb, order: Sequence[int]):
    """Reorder a TreeBatch's rows (replica load balancing is a pure row
    permutation — per-row metadata is row-local, so gradients are
    unchanged)."""
    if list(order) == list(range(len(order))):
        return tb
    idx = np.asarray(order)
    sl = lambda a: None if a is None else a[idx]
    return TreeBatch(tokens=tb.tokens[idx], pos_ids=tb.pos_ids[idx],
                     kv_last=tb.kv_last[idx], weight=tb.weight[idx],
                     prev_idx=tb.prev_idx[idx], valid=tb.valid[idx],
                     chunk_parent=sl(tb.chunk_parent),
                     num_trees=tb.num_trees,
                     extra_embeds=sl(tb.extra_embeds),
                     row_trees=sl(tb.row_trees))


# ---------------------------------------------------------------------------
# Planned steps (host-side schedule → materialized batches/plans)
# ---------------------------------------------------------------------------

@dataclass
class PlannedStep:
    """One optimizer step's schedule.  ``step_batch()`` materializes the
    packed rows (numpy + model inputs); ``execution_plan()`` additionally
    builds the partition waves — both are cached, so the two loader
    wrappers share one materialization."""
    cfg: ModelConfig
    lc: LoaderConfig
    pc: PlannerConfig
    index: int                        # source batch / step index
    fits: list[FitTree] = field(default_factory=list)
    rows: list[list[int]] = field(default_factory=list)  # idx into fits
    oversized: list[OversizedTree] = field(default_factory=list)
    dropped: int = 0
    cost: Optional[PackingCost] = None
    capacity: Optional[int] = None    # resolved partition cap (auto mode)
    baseline_tb: Any = None           # baseline mode pre-packs paths
    _sb: Optional[StepBatch] = None
    _plan: Any = None

    @property
    def num_trees(self) -> int:
        # SOURCE trees, not schedule entries: a grafted forest carries
        # n_src members and the loss stays a mean over source trees
        return (sum(f.n_src for f in self.fits)
                + sum(o.n_src for o in self.oversized))

    @property
    def is_empty(self) -> bool:
        return (not self.fits and not self.oversized
                and self.dropped == 0)

    # -- packed rows -------------------------------------------------------
    def step_batch(self) -> StepBatch:
        if self._sb is not None:
            return self._sb
        cfg, lc, pc = self.cfg, self.lc, self.pc
        chunk = chunk_size_of(cfg)
        tb = None
        if self.baseline_tb is not None:
            # baseline rows get the same replica balance as tree rows
            tb = _permute_tb_rows(
                self.baseline_tb,
                balanced_row_order(
                    [int(v) for v in self.baseline_tb.valid.sum(axis=1)],
                    pc.num_replicas))
        elif any(self.rows):
            B = round_to_multiple(lc.batch_rows, pc.num_replicas)
            rows = [list(r) for r in self.rows]
            rows.extend([] for _ in range(B - len(rows)))
            loads = [sum(self.fits[i].ser.n for i in r) for r in rows]
            order = balanced_row_order(loads, pc.num_replicas)
            rows = [rows[r] for r in order]
            tb = materialize_tree_rows(
                [f.ser for f in self.fits], rows, lc.seq_len,
                chunk_size=chunk,
                tree_counts=[f.n_src for f in self.fits])
        inputs = None
        if tb is not None:
            extra = None
            if cfg.frontend is not None:
                # the stub frontend's patch or frame embeddings, drawn as
                # the reference's planner draws them
                rng = np.random.default_rng([lc.seed, 7919, self.index])
                extra = rng.normal(
                    size=(tb.tokens.shape[0], cfg.frontend_len,
                          cfg.d_model)).astype(np.float32)
            # normalize by the step's FULL tree count: oversized trees on
            # the partition waves share this step's mean-over-trees loss
            inputs = batch_arrays(
                cfg, tb, extra,
                num_trees=self.num_trees if self.oversized else None)
        self._sb = StepBatch(inputs=inputs, tb=tb,
                             oversized=[o.tree for o in self.oversized],
                             dropped=self.dropped,
                             num_trees=self.num_trees)
        return self._sb

    # -- full execution plan ----------------------------------------------
    def execution_plan(self) -> ExecutionPlan:
        """The step's ExecutionPlan, host arrays only (the engine copies
        them to its device)."""
        if self._plan is not None:
            return self._plan
        cfg, lc, pc = self.cfg, self.lc, self.pc
        chunk = chunk_size_of(cfg)
        cap = self.capacity or lc.capacity or lc.seq_len
        sb = self.step_batch()
        packed = None
        if sb.inputs is not None:
            B, S = sb.tb.tokens.shape
            packed = PackedExec(inputs=sb.inputs,
                                tokens=int(sb.tb.valid.sum()),
                                cells=B * S)
        partition = None
        if self.oversized:
            partition = build_partition_plan(
                cfg, [o.tree for o in self.oversized], cap,
                seq_len=lc.seq_len, loss_mode=lc.loss_mode,
                max_rows=(pc.max_rows if pc.max_rows is not None
                          else lc.batch_rows),
                row_multiple=pc.num_replicas,
                forest=[o.forest(cap, chunk, lc.loss_mode)
                        for o in self.oversized])
        vers = [v for v in (getattr(e.tree, "weight_version", None)
                            for e in [*self.fits, *self.oversized])
                if v is not None]
        self._plan = ExecutionPlan(packed=packed, partition=partition,
                                   num_trees=self.num_trees,
                                   dropped=self.dropped,
                                   versions=((min(vers), max(vers))
                                             if vers else None))
        return self._plan


# ---------------------------------------------------------------------------
# The schedule stream
# ---------------------------------------------------------------------------

def plan_window(cfg: ModelConfig, lc: LoaderConfig, pc: PlannerConfig,
                window: Sequence[Sequence[TrajectoryTree]],
                cache: Optional[CompileCacheSim] = None,
                first_index: int = 0) -> list[PlannedStep]:
    """Schedule one lookahead window (``window[b]`` = generator batch b's
    trees) into ``len(window)`` PlannedSteps.  Pure host-side decisions —
    nothing is materialized yet."""
    chunk = chunk_size_of(cfg)
    route = lc.auto_partition and lc.mode == "tree"
    cap = lc.capacity or lc.seq_len
    cache = cache if cache is not None else CompileCacheSim()
    W = len(window)
    rows_per_step = round_to_multiple(lc.batch_rows, pc.num_replicas)

    fits: list[FitTree] = []
    over: list[OversizedTree] = []
    for s, trees in enumerate(window):
        f, o = _fit_split(trees, lc.seq_len, chunk, lc.loss_mode,
                          first_index + s)
        fits.extend(f)
        over.extend(o)

    if pc.graft and lc.mode == "tree" and len(fits) > 1:
        fits, grafted_over = _graft_fits(fits, lc, pc, chunk, cap)
        over = over + grafted_over

    if (lc.auto_capacity and lc.capacity is None and route and over):
        # planner-chosen partition capacity, resolved once per window so
        # load balancing and wave building agree (PlannedStep.capacity)
        cap = choose_capacity([o.tree for o in over], lc.seq_len,
                              chunk_size=chunk)

    steps = [PlannedStep(cfg=cfg, lc=lc, pc=pc, index=first_index + s,
                         capacity=cap)
             for s in range(W)]

    if lc.mode == "tree":
        steps_rows, evicted, cost = _schedule_tree_window(
            fits, W, rows_per_step, lc.seq_len, cache, pc)
        over = over + [OversizedTree(tree=fits[i].tree, src=fits[i].src,
                                     n_src=fits[i].n_src,
                                     lam_map=fits[i].lam_map)
                       for i in evicted]
        for s in range(W):
            placed = sorted({i for r in steps_rows[s] for i in r})
            local = {i: j for j, i in enumerate(placed)}
            steps[s].fits = [fits[i] for i in placed]
            steps[s].rows = [[local[i] for i in r]
                             for r in steps_rows[s]]
            steps[s].cost = cost
    else:
        # baseline mode: per-batch path packing (kept comparable with the
        # tree mode stream — no cross-batch shuffling of the baseline)
        by_src: dict[int, list[FitTree]] = {}
        for f in fits:
            by_src.setdefault(f.src, []).append(f)
        for s in range(W):
            kept = sorted(by_src.get(first_index + s, []),
                          key=lambda f: f.n_unique)
            while kept:
                try:
                    steps[s].baseline_tb = pack_linear_paths(
                        [f.paths for f in kept], lc.seq_len,
                        batch_size=rows_per_step, chunk_size=chunk,
                        loss_mode=lc.loss_mode)
                    break
                except DoesNotFitError:
                    over.append(OversizedTree(tree=kept[-1].tree,
                                              src=first_index + s))
                    kept = kept[:-1]
            steps[s].fits = kept

    # ---- oversized routing / drop accounting -----------------------------
    if route:
        if W == 1 or len(over) <= 1:
            for o in over:
                steps[o.src - first_index].oversized.append(o)
        else:
            # balance partitioned token load across the window's steps,
            # steering trees toward steps where their waves reuse an
            # already-live row bucket: a fresh bucket is a fresh wave
            # signature, charged at CostWeights.wave_compile just like
            # score_packing charges packed signatures
            R = max(pc.num_replicas, 1)
            mrows = pc.max_rows if pc.max_rows is not None else lc.batch_rows
            max_bucket = R * pow2(-(-mrows // R))
            seen_rows = {s[1] for s in cache.seen if s[0] == "wave"}

            def depth_widths(o: OversizedTree) -> dict[int, int]:
                """Fragments per wave depth of one partitioned tree (the
                forest is cached — build_partition_plan reuses it)."""
                w: dict[int, int] = {}
                dep: dict[int, int] = {}
                for p in o.forest(cap, chunk, lc.loss_mode):
                    d = 0 if p.parent_pid < 0 else dep[p.parent_pid] + 1
                    dep[p.pid] = d
                    w[d] = w.get(d, 0) + 1
                return w

            def row_bucket(n: int) -> int:
                return min(R * pow2(-(-n // R)), max_bucket)

            def fresh_buckets(sw: dict[int, int], w: dict[int, int]) -> int:
                """Row buckets this tree's waves would newly open in a
                step already holding ``sw`` fragments per depth."""
                fresh = 0
                for d, n in w.items():
                    cur = sw.get(d, 0)
                    b = row_bucket(cur + n)
                    if b != (row_bucket(cur) if cur else None) \
                            and b not in seen_rows:
                        fresh += 1
                return fresh

            loads = [0] * W
            step_w: list[dict[int, int]] = [{} for _ in range(W)]
            wave_w = pc.weights.wave_compile
            for o in sorted(over,
                            key=lambda o: -o.load(cap, chunk,
                                                  lc.loss_mode)):
                w = depth_widths(o)
                s = min(range(W),
                        key=lambda s_: (loads[s_]
                                        + wave_w * fresh_buckets(
                                            step_w[s_], w), s_))
                steps[s].oversized.append(o)
                loads[s] += o.load(cap, chunk, lc.loss_mode)
                for d, n in w.items():
                    step_w[s][d] = step_w[s].get(d, 0) + n
    else:
        for o in over:
            steps[o.src - first_index].dropped += o.n_src
    return steps


def plan_stream(cfg: ModelConfig, lc: LoaderConfig,
                source: "int | Iterable[Sequence[TrajectoryTree]]",
                pc: Optional[PlannerConfig] = None, *,
                cache: Optional[CompileCacheSim] = None
                ) -> Iterator[PlannedStep]:
    """The scheduler's main stream: ingest trees, plan each lookahead
    window globally, yield non-empty PlannedSteps in step order.

    ``source`` is either an int — that many synthetic generator batches
    (deterministic in (cfg, lc, seed), the offline path) — or any
    iterable of tree lists, one list per optimizer step: a live rollout
    queue, a dataset reader, etc.  A live source is pulled at most ``lookahead`` steps
    ahead of the consumed plan, so the planner adds no extra staleness
    beyond its window.

    ``cache``: an optional shared :class:`CompileCacheSim`."""
    pc = pc or PlannerConfig()
    cache = cache if cache is not None else CompileCacheSim()
    W = max(1, pc.lookahead)
    if isinstance(source, int):
        gen: Iterator = tree_stream(cfg, lc, source)
        remaining: Optional[int] = source
    else:
        gen = iter(source)
        remaining = None
    first = 0
    while remaining is None or first < remaining:
        n = W if remaining is None else min(W, remaining - first)
        window = [list(trees) for trees in islice(gen, n)]
        if not window:
            break
        for ps in plan_window(cfg, lc, pc, window, cache=cache,
                              first_index=first):
            if not ps.is_empty:
                yield ps
        first += len(window)


# ---------------------------------------------------------------------------
# Async double-buffered plan pipeline
# ---------------------------------------------------------------------------

class PlanPipeline:
    """Builds plans on background threads while the consumer (the train
    loop / engine) executes the previous one — the host-side numpy plan
    construction is double-buffered against device work.

    ``workers=0`` degrades to synchronous in-line building (every
    scheduling/build second is exposed).  With workers ≥ 1, the
    *scheduling* iterator is pulled under its own lock — never the
    result lock, so a long window-scheduling pull cannot block the
    consumer from popping an already-built plan — and the expensive
    materialization (``build``) runs outside both; results are
    re-ordered by sequence number, at most ``depth + workers`` plans
    in flight ahead of the consumer.

    Stats: ``schedule_s`` (source-pull seconds: fit + window packing),
    ``build_s`` (materialization seconds, possibly overlapped),
    ``exposed_s`` (seconds the consumer actually waited), ``built``."""

    def __init__(self, source: Iterable, build: Callable[[Any], Any],
                 workers: int = 1, depth: int = 2):
        self._source = iter(source)
        self._build = build
        self._workers = max(0, workers)
        self._depth = max(1, depth)
        self.schedule_s = 0.0
        self.build_s = 0.0
        self.exposed_s = 0.0
        self.built = 0
        if self._workers:
            self._cv = threading.Condition()
            self._pull_lock = threading.Lock()
            self._results: dict[int, tuple[str, Any]] = {}
            self._next_pull = 0
            self._next_out = 0
            self._exhausted = False
            self._stop = False
            self._threads = [
                threading.Thread(target=self._work, daemon=True,
                                 name=f"plan-builder-{i}")
                for i in range(self._workers)]
            for t in self._threads:
                t.start()

    # -- worker side -------------------------------------------------------
    def _work(self) -> None:
        while True:
            with self._cv:
                while (not self._stop and not self._exhausted
                       and self._next_pull - self._next_out
                       >= self._depth + self._workers):
                    self._cv.wait()
                if self._stop or self._exhausted:
                    return
            # the scheduling pull serializes on its own lock; _cv stays
            # free for consumer pops of already-built plans
            with self._pull_lock:
                with self._cv:
                    if self._stop or self._exhausted:
                        return
                t0 = time.perf_counter()
                try:
                    item = self._source.__next__()
                except StopIteration:
                    with self._cv:
                        self._exhausted = True
                        self._cv.notify_all()
                    return
                except BaseException as e:  # scheduling error: re-raise in order
                    with self._cv:
                        self._results[self._next_pull] = ("err", e)
                        self._next_pull += 1
                        self._exhausted = True
                        self._cv.notify_all()
                    return
                dt = time.perf_counter() - t0
                with self._cv:      # seq assignment in pull order
                    seq = self._next_pull
                    self._next_pull += 1
                    self.schedule_s += dt
            t0 = time.perf_counter()
            try:
                out = ("ok", self._build(item))
            except BaseException as e:
                out = ("err", e)
            dt = time.perf_counter() - t0
            with self._cv:
                self._results[seq] = out
                self.build_s += dt
                self.built += 1
                self._cv.notify_all()

    def close(self) -> None:
        if self._workers:
            with self._cv:
                self._stop = True
                self._cv.notify_all()

    # -- consumer side -----------------------------------------------------
    def __iter__(self) -> Iterator:
        if self._workers == 0:
            while True:
                t0 = time.perf_counter()
                try:
                    item = self._source.__next__()
                except StopIteration:
                    return
                t1 = time.perf_counter()
                plan = self._build(item)
                t2 = time.perf_counter()
                self.schedule_s += t1 - t0
                self.build_s += t2 - t1
                self.exposed_s += t2 - t0
                self.built += 1
                yield plan
        try:
            while True:
                t0 = time.perf_counter()
                with self._cv:
                    while (self._next_out not in self._results
                           and not (self._exhausted
                                    and self._next_pull <= self._next_out)):
                        self._cv.wait()
                    self.exposed_s += time.perf_counter() - t0
                    if self._next_out not in self._results:
                        return                      # stream exhausted
                    kind, val = self._results.pop(self._next_out)
                    self._next_out += 1
                    self._cv.notify_all()
                if kind == "err":
                    raise val
                yield val
        finally:
            self.close()


def plans(cfg: ModelConfig, lc: LoaderConfig,
          source: "int | Iterable[Sequence[TrajectoryTree]]",
          pc: Optional[PlannerConfig] = None, *,
          max_rows: Optional[int] = None, warmup=None) -> PlanPipeline:
    """THE planner entrypoint: a :class:`PlanPipeline` of
    :class:`PlannedStep`\\ s, scheduled over ``source`` and built on
    background threads.

    ``source``: an int (that many deterministic synthetic batches — the
    offline path) or any iterable of per-step tree lists (a live rollout
    queue, a dataset reader).  Each yielded step arrives with its
    materialization pre-built: call ``step.execution_plan()`` to train it
    (``TreeTrainEngine.step``) or ``step.step_batch()`` for the raw packed
    rows — both are cached, already-paid lookups.

    ``warmup``: a :class:`~repro_torch.train.warmup.AOTWarmupService` (or
    any object with ``prewarm(step=...)``) — each step's executables are
    made on the pipeline's build threads the moment its plans exist, so
    ``TreeTrainEngine`` never blocks on a cold bucket.  Its ``sim`` is the
    schedule's compile-cache model too."""
    pc = pc or PlannerConfig()
    if max_rows is not None and pc.max_rows is None:
        pc = replace(pc, max_rows=max_rows)

    def build(ps: PlannedStep) -> PlannedStep:
        ps.execution_plan()           # materialize on the worker thread
        if warmup is not None:
            warmup.prewarm(step=ps)   # before the engine consumes it
        return ps

    sim = getattr(warmup, "sim", None) if warmup is not None else None
    return PlanPipeline(plan_stream(cfg, lc, source, pc, cache=sim), build,
                        workers=pc.plan_workers, depth=pc.pipeline_depth)


def plan_pipeline(cfg: ModelConfig, lc: LoaderConfig, num_batches: int,
                  pc: Optional[PlannerConfig] = None, *,
                  max_rows: Optional[int] = None) -> PlanPipeline:
    """ExecutionPlan stream behind the async pipeline: schedule on the
    source iterator, build (materialize rows + partition waves) on
    ``plan_workers`` background threads."""
    pc = pc or PlannerConfig()
    if max_rows is not None and pc.max_rows is None:
        pc = replace(pc, max_rows=max_rows)
    return PlanPipeline(plan_stream(cfg, lc, num_batches, pc),
                        lambda ps: ps.execution_plan(),
                        workers=pc.plan_workers, depth=pc.pipeline_depth)


def planned_step_features(ps: PlannedStep,
                          block: Optional[int] = None) -> dict:
    """Host-side cost-model features of one built step, to pair with the
    measured step wall time when fitting :class:`CostWeights`."""
    plan = ps.execution_plan()
    block = block or ps.pc.block
    row_sizes = [[ps.fits[i].ser.n for i in r] for r in ps.rows]
    live, causal = (_packing_live_blocks(row_sizes, ps.lc.seq_len, block)
                    if row_sizes else (0, 0))
    return dict(index=ps.index,
                padded_tokens=plan.padded_tokens,
                live_blocks=live,
                causal_blocks=causal,
                num_waves=(0 if plan.partition is None
                           else len(plan.partition.waves)),
                signatures=[str(s) for s in step_signatures(ps)])
