"""Schedule-level cost model for Tree Packing plans.

A copy of ``repro/core/plan_cost.py`` (``tests/test_torch_planner.py``
holds the planner's plans built on it identical to the reference's).  Tree
Packing fixes *what* shares a row; the schedule level decides which trees
share a step, how many rows a step materializes and which shape signatures
the stream exercises.  ``score_packing`` scores candidate packings so the
planner (``train/planner.py``) can choose among placement heuristics and
lookahead windows.  All components are in **token-cell units** (one token
slot of one row):

  padded tokens      row cells that hold no valid token;
  signature misses   a shape the stream has not run before, charged
                     ``compile_miss`` per new packed signature and
                     ``wave_compile`` per new wave bucket.  Eager PyTorch
                     compiles nothing per shape, but the charge stays, as
                     does ``CompileCacheSim``: the planner's choices (and
                     so its plans) must stay identical to the reference's;
  live blocks        the tree-attention kernels skip key tiles wholly
                     invisible to a query tile, so attention work scales
                     with the *live* tiles;
  comm bytes         per-step collective wire bytes (weight 0 by default;
                     the one-card port has no collectives).

Pure numpy/host code, safe to call from the planner's background build
threads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Hashable, Iterable, Sequence


def pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two ≥ n (and ≥ lo) — THE shape-bucket rule, shared
    with the wave planner (core/gateway) so cost-model signature estimates
    match the buckets the engine actually compiles."""
    b = lo
    while b < n:
        b *= 2
    return b


def round_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m ≥ n (replica-balanced row counts)."""
    if m <= 1:
        return n
    return ((n + m - 1) // m) * m


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def row_live_blocks(sizes: Sequence[int], block: int) -> int:
    """Estimated live (non-skipped) attention blocks for ONE row packed
    with trees of the given serialized lengths.

    Each tree of n tokens spans ``c = ceil(n/block)`` query blocks and its
    visible KV is confined to its own span, giving ~tri(c) live blocks;
    straddling a block boundary can light up at most one extra diagonal
    per tree, which we fold in when the tree is not block-aligned."""
    live = 0
    for n in sizes:
        if n <= 0:
            continue
        c = -(-n // block)
        live += _tri(c)
        if n % block:
            live += c - 1       # boundary straddle with the next resident
    return live


def _packing_live_blocks(row_sizes: Sequence[Sequence[int]], seq_len: int,
                         block: int) -> tuple[int, int]:
    """(live, causal) block counts for a candidate packing — the single
    definition both ``est_block_skip`` and ``score_packing`` share."""
    nq = max(seq_len // block, 1)
    causal = _tri(nq) * len(row_sizes)
    live = sum(min(row_live_blocks(s, block), _tri(nq)) for s in row_sizes)
    return live, causal


def est_block_skip(row_sizes: Sequence[Sequence[int]], seq_len: int,
                   block: int) -> float:
    """Estimated fraction of causal-schedule blocks the kernel skips for a
    candidate packing (rows → serialized tree lengths).  Empty rows are
    fully skipped (kv_last = −1 everywhere)."""
    live, causal = _packing_live_blocks(row_sizes, seq_len, block)
    return 1.0 - live / causal if causal else 0.0


class CompileCacheSim:
    """Host-side record of the shape signatures the stream has run: the
    planner charges a candidate only for signatures not seen before (the
    reference's jit-cache model, kept so the plans match it).  ``freq``
    counts every commit per signature."""

    def __init__(self) -> None:
        self.seen: set[Hashable] = set()
        self.freq: dict[Hashable, int] = {}

    def misses(self, sigs: Iterable[Hashable]) -> int:
        return len({s for s in sigs if s not in self.seen})

    def commit(self, sigs: Iterable[Hashable]) -> None:
        for s in sigs:
            self.seen.add(s)
            self.freq[s] = self.freq.get(s, 0) + 1


def packed_signature(n_rows: int, seq_len: int) -> Hashable:
    return ("packed", n_rows, seq_len)


def wave_signature(n_rows: int, seq_len: int, anc: int, n_cuts: int,
                   path_len: int, n_extra: int) -> Hashable:
    """Shape signature of one partition wave: bucketed rows × ancestor
    length × cut count × capture-path length × boundary-extra count (the
    wave half of the signature model)."""
    return ("wave", n_rows, seq_len, anc, n_cuts, path_len, n_extra)


def wave_signature_of(wp, seq_len: int) -> Hashable:
    """The shape signature of one ``core/gateway.WavePlan``: bucketed rows,
    ancestor pad, capspec count/path pad and boundary-extra pad."""
    ncut = len(wp.capspecs)
    plen = (len(next(iter(wp.capspecs.values()))["path_idx"])
            if ncut else 0)
    n_extra = (wp.batch["extra_pos"].shape[1]
               if "extra_pos" in wp.batch else 0)
    return wave_signature(wp.batch["tokens"].shape[0], seq_len,
                          wp.anc_A_max, ncut, plen, n_extra)


@dataclass(frozen=True)
class CostWeights:
    """All weights are token-cells per unit of the component."""
    pad: float = 1.0             # per padded (invalid) token cell
    compile_miss: float = 4096.0  # per new packed signature
    wave_compile: float = 2048.0  # per new WAVE shape bucket (the wave
    #                               fwd+bwd pair is a shorter trace than
    #                               the fused packed step, but a miss
    #                               still stalls the step it lands in)
    live_block: float = 0.25      # per live block, scaled by block²
    comm_byte: float = 0.0        # per audited collective wire byte
    graft_saved: float = 1.0      # credit per cross-tree deduped cell
    graft_cut: float = 64.0       # per extra gateway boundary a graft adds


@dataclass
class PackingCost:
    """Score breakdown for one candidate packing (lower total = better)."""
    padded_tokens: int
    used_tokens: int
    est_skip: float              # estimated block-skip fraction
    live_blocks: int
    new_signatures: int
    total: float
    comm_bytes: int = 0          # audited wire bytes charged (0 = off)

    @property
    def pad_per_unique(self) -> float:
        return self.padded_tokens / max(self.used_tokens, 1)


DEFAULT_WEIGHTS = CostWeights()


def score_packing(
    row_sizes: Sequence[Sequence[int]],
    seq_len: int,
    *,
    block: int = 64,
    signatures: Iterable[Hashable] = (),
    cache: CompileCacheSim | None = None,
    weights: CostWeights = DEFAULT_WEIGHTS,
    comm_bytes: int = 0,
) -> PackingCost:
    """Score a candidate packing: ``row_sizes[r]`` lists the serialized
    token counts sharing materialized row r (include empty rows — their
    padding is real).  ``signatures`` are the shape signatures the candidate
    would execute; with a ``cache`` only unseen ones are charged.
    ``comm_bytes``: the candidate's audited per-step collective wire
    bytes (``wire_bytes_per_step`` over shardlint's byte table)."""
    used = sum(sum(s) for s in row_sizes)
    padded = len(row_sizes) * seq_len - used
    live, causal = _packing_live_blocks(row_sizes, seq_len, block)
    skip = 1.0 - live / causal if causal else 0.0
    new = ({s for s in signatures if s not in cache.seen}
           if cache is not None else set(signatures))
    miss = len(new)
    compile_cost = sum(
        weights.wave_compile if (isinstance(s, tuple) and s
                                 and s[0] == "wave")
        else weights.compile_miss
        for s in new)
    total = (weights.pad * padded
             + compile_cost
             + weights.live_block * live * block * block
             + weights.comm_byte * comm_bytes)
    return PackingCost(padded_tokens=padded, used_tokens=used,
                       est_skip=skip, live_blocks=live,
                       new_signatures=miss, total=total,
                       comm_bytes=comm_bytes)


def graft_gain(src_cells: int, merged_cells: int, seq_len: int,
               capacity: int,
               weights: CostWeights = DEFAULT_WEIGHTS, *,
               parts: int | None = None) -> float:
    """Net token-cell gain of one cross-tree graft (``core/forest``) —
    the schedule-level dedup term: graft iff the result is > 0.

    ``src_cells`` is the summed *serialized* length of the source trees
    (chunk padding included) and ``merged_cells`` the grafted tree's, so
    the credit already nets out the node fragmentation the merge adds
    under SSM chunk alignment.  When the merged forest no longer fits a
    packed row it partitions like any oversized tree — charge the wave
    rows' fragmentation (each partition materializes a full ``seq_len``
    row slot) plus ``graft_cut`` per extra gateway boundary the wider
    fan-out relays cotangents across.  Pass ``parts`` (the REAL
    partition count from ``core.partition.partition_tree``) when known:
    tree partitions cut at subtree boundaries, so the capacity quotient
    badly underestimates the wave rows a branchy forest materializes —
    the planner supplies the real count so losing grafts (padding out-
    weighing dedup) are rejected or bisected instead of shipped."""
    gain = weights.graft_saved * (src_cells - merged_cells)
    if merged_cells > seq_len:
        if parts is None:
            parts = -(-merged_cells // max(capacity, 1))
        frag = parts * seq_len - merged_cells
        gain -= weights.pad * max(frag, 0)
        gain -= weights.graft_cut * (parts - 1)
    return gain


def wire_bytes_per_step(comms_entry: dict) -> int:
    """One engine step's audited collective wire bytes, summed from a
    shardlint ``comms.json`` entrypoint entry (``engine.packed`` /
    ``session.step``): per-op ``wire_bytes_with_loops`` from the
    ``collectives`` summary.  Feed the result to ``score_packing``'s
    ``comm_bytes`` with a non-zero ``CostWeights.comm_byte``."""
    total = 0
    for s in comms_entry.get("collectives", {}).values():
        total += int(s.get("wire_bytes_with_loops",
                           s.get("wire_bytes", 0)))
    return total


def balanced_row_order(row_loads: Sequence[int], num_replicas: int
                       ) -> list[int]:
    """Permutation of rows such that splitting the reordered rows into
    ``num_replicas`` contiguous shards (how the data axis slices the
    leading dim) balances both the non-empty-row count (≤1 apart) and the
    token load: rows are dealt snake-wise, heaviest first.

    ``len(row_loads)`` must be a multiple of ``num_replicas`` (the planner
    rounds row counts up first)."""
    B = len(row_loads)
    if num_replicas <= 1 or B % num_replicas:
        return list(range(B))
    order = sorted(range(B), key=lambda r: (-row_loads[r], r))
    shards: list[list[int]] = [[] for _ in range(num_replicas)]
    for i, r in enumerate(order):
        rnd, j = divmod(i, num_replicas)
        if rnd % 2:
            j = num_replicas - 1 - j
        shards[j].append(r)
    out: list[int] = []
    for s in shards:
        out.extend(s)
    return out
