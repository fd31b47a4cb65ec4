"""Packing serialized trees into fixed-shape training rows.

A copy of ``repro/core/packing.py``: packed rows (held against the original
field by field in ``tests/test_torch_train.py``) and Tree Packing over
partitions, ``pack_partition_waves`` (``tests/test_torch_partition.py``).
A row holds one or more whole DFS-serialized trees back to back; because
``kv_last`` bounds visibility to a token's own subtree, packed trees are
mutually invisible with no extra mask.  The SSM ``chunk_size`` alignment is
not copied (SSM families are ROADMAP.md Queue A item 4): it raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.partition import TreePartition
from repro_torch.core.tree import SerializedTree


class DoesNotFitError(ValueError):
    """An item (tree / path / row set) exceeds the fixed packing budget."""


@dataclass
class TreeBatch:
    """Fixed-shape batch of packed DFS rows (+ per-token metadata)."""

    tokens: np.ndarray        # i32 [B, S]
    pos_ids: np.ndarray       # i32 [B, S]
    kv_last: np.ndarray       # i32 [B, S]   (−1 = invisible key)
    weight: np.ndarray        # f32 [B, S]   λ_t
    prev_idx: np.ndarray      # i32 [B, S]   (−1 = no loss for this token)
    valid: np.ndarray         # bool [B, S]
    num_trees: int = 1        # loss normalizer (mean over trees)
    row_trees: Optional[np.ndarray] = None     # i32 [B] trees per row

    @property
    def shape(self) -> tuple[int, int]:
        return self.tokens.shape  # type: ignore[return-value]


def _no_chunks(chunk_size: Optional[int]) -> None:
    if chunk_size is not None:
        raise NotImplementedError(
            "chunk-aligned (SSM) packing is not ported yet; see ROADMAP.md "
            "Queue A item 4")


def _empty_row(S: int) -> dict[str, np.ndarray]:
    return dict(
        tokens=np.zeros(S, np.int32),
        pos_ids=np.zeros(S, np.int32),
        kv_last=np.full(S, -1, np.int32),
        weight=np.zeros(S, np.float32),
        prev_idx=np.full(S, -1, np.int32),
        valid=np.zeros(S, bool),
    )


def plan_tree_rows(
    sizes: Sequence[int],
    seq_len: int,
    *,
    batch_size: Optional[int] = None,
    heuristic: str = "ffd",
) -> list[list[int]]:
    """Row *assignment* only: rows as lists of item indices (items placed
    largest-first).  'ffd': first-fit decreasing; 'bfd': best-fit
    decreasing (tightest row that still fits)."""
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    rows: list[list[int]] = []
    row_used: list[int] = []
    for i in order:
        n = sizes[i]
        if n > seq_len:
            raise DoesNotFitError(
                f"tree of {n} tokens does not fit row of {seq_len}")
        fit = [r for r, used in enumerate(row_used) if used + n <= seq_len]
        if fit:
            r = fit[0] if heuristic == "ffd" else \
                min(fit, key=lambda r_: seq_len - row_used[r_] - n)
            rows[r].append(i)
            row_used[r] += n
        else:
            rows.append([i])
            row_used.append(n)

    if batch_size is not None:
        if len(rows) > batch_size:
            raise DoesNotFitError(
                f"{len(rows)} rows > batch_size {batch_size}")
        while len(rows) < batch_size:
            rows.append([])
    return rows


def materialize_tree_rows(
    trees: Sequence[SerializedTree],
    rows: Sequence[Sequence[int]],
    seq_len: int,
    *,
    chunk_size: Optional[int] = None,
    tree_counts: Optional[Sequence[int]] = None,
) -> TreeBatch:
    """Materialize a planned row assignment (``rows[r]`` = tree indices
    sharing row r, in placement order) into a fixed-shape TreeBatch.
    ``tree_counts[i]`` is how many source trees serialization i represents
    (default 1 each)."""
    _no_chunks(chunk_size)
    for r in rows:
        if sum(trees[i].n for i in r) > seq_len:
            raise DoesNotFitError(
                f"planned row of {sum(trees[i].n for i in r)} tokens "
                f"exceeds seq_len {seq_len}")
    count = (lambda i: 1) if tree_counts is None \
        else (lambda i: int(tree_counts[i]))
    cols = {k: [] for k in
            ("tokens", "pos_ids", "kv_last", "weight", "prev_idx", "valid")}
    for r in rows:
        row = _empty_row(seq_len)
        off = 0
        for i in r:
            t = trees[i]
            sl = slice(off, off + t.n)
            row["tokens"][sl] = t.tokens
            row["pos_ids"][sl] = t.pos_ids
            row["kv_last"][sl] = np.where(t.kv_last < 0, -1, t.kv_last + off)
            row["weight"][sl] = t.weight
            row["prev_idx"][sl] = np.where(t.prev_idx < 0, -1,
                                           t.prev_idx + off)
            row["valid"][sl] = t.valid
            off += t.n
        for k in cols:
            cols[k].append(row[k])
    return TreeBatch(
        **{k: np.stack(v) for k, v in cols.items()},
        num_trees=sum(count(i) for r in rows for i in r),
        row_trees=np.asarray([sum(count(i) for i in r) for r in rows],
                             np.int32),
    )


def pack_trees(
    trees: Sequence[SerializedTree],
    seq_len: int,
    *,
    batch_size: Optional[int] = None,
    chunk_size: Optional[int] = None,
) -> TreeBatch:
    """First-fit-decreasing pack of whole serialized trees into rows (plan
    + materialize).  Every tree must fit in one row."""
    _no_chunks(chunk_size)
    rows = plan_tree_rows([t.n for t in trees], seq_len,
                          batch_size=batch_size)
    return materialize_tree_rows(trees, rows, seq_len)


def pack_linear_paths(
    trees_paths: Sequence[Sequence[dict[str, np.ndarray]]],
    seq_len: int,
    *,
    batch_size: Optional[int] = None,
    chunk_size: Optional[int] = None,
    loss_mode: str = "sep_avg",
) -> TreeBatch:
    """Baseline: pack *linearized per-branch sequences* (Eq. 7 + standard
    sequence packing).  ``trees_paths[k]`` is the list of path dicts of
    tree k (``TrajectoryTree.linearize_paths``).  Loss weights are 1/K_k
    per trained token ('sep_avg'), so the packed loss equals the
    mean-over-trees sep-avg loss; 'rl' also scales each path by its
    ``branch_adv``; 'uniform' drops the 1/K."""
    _no_chunks(chunk_size)
    flat: list[dict[str, np.ndarray]] = []
    for ti, paths in enumerate(trees_paths):
        K = len(paths)
        for p in paths:
            q = dict(p)
            if loss_mode == "sep_avg":
                w = p["advantage"] / K
            elif loss_mode == "uniform":
                w = p["advantage"]
            elif loss_mode == "rl":
                w = p["advantage"] * p.get("branch_adv", 1.0) / K
            else:
                raise ValueError(loss_mode)
            q["_w"] = np.where(p["trained"], w, 0.0).astype(np.float32)
            q["_tree"] = ti
            flat.append(q)

    order = sorted(range(len(flat)), key=lambda i: -len(flat[i]["tokens"]))
    rows: list[list[int]] = []
    row_used: list[int] = []
    for i in order:
        n = len(flat[i]["tokens"])
        if n > seq_len:
            raise DoesNotFitError("path longer than row")
        for r, used in enumerate(row_used):
            if used + n <= seq_len:
                rows[r].append(i)
                row_used[r] += n
                break
        else:
            rows.append([i])
            row_used.append(n)
    if batch_size is not None:
        if len(rows) > batch_size:
            raise DoesNotFitError(
                f"{len(rows)} rows > batch_size {batch_size}")
        while len(rows) < batch_size:
            rows.append([])

    out = {k: [] for k in
           ("tokens", "pos_ids", "kv_last", "weight", "prev_idx", "valid")}
    for r in rows:
        row = _empty_row(seq_len)
        off = 0
        for i in r:
            p = flat[i]
            n = len(p["tokens"])
            sl = slice(off, off + n)
            row["tokens"][sl] = p["tokens"]
            row["pos_ids"][sl] = p["pos_ids"]
            row["kv_last"][sl] = off + n - 1
            row["weight"][sl] = p["_w"]
            pv = np.arange(off - 1, off + n - 1, dtype=np.int32)
            pv[0] = -1
            row["prev_idx"][sl] = pv
            row["valid"][sl] = True
            off += n
        for k in out:
            out[k].append(row[k])

    return TreeBatch(
        **{k: np.stack(v) for k, v in out.items()},
        num_trees=len(trees_paths),
        row_trees=np.asarray(
            [len({flat[i]["_tree"] for i in r}) for r in rows], np.int32),
    )


# ---------------------------------------------------------------------------
# Tree Packing over partitions (paper §3.3–3.4): pack the partition
# serializations of MANY trees into fixed-shape [B, S] rows, grouped by
# topological wave so every partition's parent lands in a strictly earlier
# wave (its gateway captures exist before the child runs).  Waves follow
# depth order in the partition tree; a depth level wider than ``max_rows``
# splits into several consecutive waves, all still after their parents'.
#
# Row discipline: wave-0 fragments carry no gateway, so any number can
# share a row (kv_last separates them, as with whole trees).  Wave ≥1
# fragments each own a row — their ancestor KV (extra_kv) is row-global.
# ---------------------------------------------------------------------------

@dataclass
class PackedPartition:
    """Placement of one partition fragment inside a wave batch."""
    tree: int                  # index into the forest's tree list
    pid: int                   # partition id within that tree
    row: int
    offset: int                # token offset inside the row


@dataclass
class PackedCut:
    """One cut of a placed partition, with row-absolute indices."""
    tree: int
    pid: int                   # parent partition (lives in this wave)
    child_pid: int
    row: int                   # parent's row
    path_idx: np.ndarray       # i32, absolute positions in the parent row
    cut_chunk: int             # absolute chunk index in the parent row
    boundary_pos: int          # absolute position of the predicting token
    boundary_label: int
    boundary_weight: float


@dataclass
class PackedWave:
    """One topological wave: fixed-shape rows + placement metadata."""
    arrays: dict[str, np.ndarray]          # [B, S] serialization columns
    slots: list[PackedPartition] = field(default_factory=list)
    cuts: list[PackedCut] = field(default_factory=list)

    @property
    def num_rows(self) -> int:
        return self.arrays["tokens"].shape[0]


def pack_partition_waves(
    forest: Sequence[Sequence[TreePartition]],
    seq_len: int,
    *,
    chunk_size: Optional[int] = None,
    max_rows: Optional[int] = None,
) -> list[PackedWave]:
    """Pack every partition of every tree into per-wave [B, S] rows.

    forest[t] is ``partition_tree(trees[t], capacity, ...)`` with
    capacity ≤ seq_len.  Returns waves in topological order; root waves'
    rows may hold several fragments, gateway-bearing waves one fragment
    per row.  ``max_rows`` bounds every wave's row count (same-depth
    fragments are independent, so a too-wide wave splits into several
    consecutive waves) — the partitioned path then never exceeds the
    activation footprint of a ``max_rows × seq_len`` packed step."""
    _no_chunks(chunk_size)
    # wave index per partition (parent wave + 1; parents precede children)
    waves: list[list[tuple[int, int]]] = []
    for t, parts in enumerate(forest):
        wv: dict[int, int] = {}
        for p in parts:
            w = 0 if p.parent_pid < 0 else wv[p.parent_pid] + 1
            wv[p.pid] = w
            while len(waves) <= w:
                waves.append([])
            waves[w].append((t, p.pid))

    def materialize(placements: list[PackedPartition], B: int
                    ) -> PackedWave:
        S = seq_len
        cols = {k: np.stack([_empty_row(S)[k] for _ in range(B)])
                for k in ("tokens", "pos_ids", "kv_last", "weight",
                          "prev_idx", "valid")}
        cuts: list[PackedCut] = []
        for pl in placements:
            ser = forest[pl.tree][pl.pid].ser
            off = pl.offset
            sl = slice(off, off + ser.n)
            cols["tokens"][pl.row, sl] = ser.tokens
            cols["pos_ids"][pl.row, sl] = ser.pos_ids
            cols["kv_last"][pl.row, sl] = np.where(
                ser.kv_last < 0, -1, ser.kv_last + off)
            cols["weight"][pl.row, sl] = ser.weight
            # negative prev slots (−1 none, −2.. gateway) are offset-free
            cols["prev_idx"][pl.row, sl] = np.where(
                ser.prev_idx < 0, ser.prev_idx, ser.prev_idx + off)
            cols["valid"][pl.row, sl] = ser.valid
            for c in forest[pl.tree][pl.pid].cuts:
                cuts.append(PackedCut(
                    tree=pl.tree, pid=pl.pid, child_pid=c.child_pid,
                    row=pl.row,
                    path_idx=c.path_token_idx + off,
                    cut_chunk=c.cut_chunk,
                    boundary_pos=c.boundary_pos + off,
                    boundary_label=c.boundary_label,
                    boundary_weight=c.boundary_weight))
        return PackedWave(arrays=dict(cols), slots=placements, cuts=cuts)

    out: list[PackedWave] = []
    for w, members in enumerate(waves):
        # --- row assignment -------------------------------------------------
        placements: list[PackedPartition] = []
        if w == 0:
            order = sorted(members,
                           key=lambda m: -forest[m[0]][m[1]].ser.n)
            row_used: list[int] = []
            for t, pid in order:
                n = forest[t][pid].ser.n
                if n > seq_len:
                    raise DoesNotFitError(
                        f"partition of {n} tokens > row of {seq_len}; "
                        "lower the partition capacity")
                for r, used in enumerate(row_used):
                    if used + n <= seq_len:
                        placements.append(PackedPartition(t, pid, r, used))
                        row_used[r] += n
                        break
                else:
                    placements.append(PackedPartition(t, pid,
                                                      len(row_used), 0))
                    row_used.append(n)
            B = len(row_used)
        else:
            for r, (t, pid) in enumerate(members):
                if forest[t][pid].ser.n > seq_len:
                    raise DoesNotFitError(
                        f"partition of {forest[t][pid].ser.n} tokens > row "
                        f"of {seq_len}; lower the partition capacity")
                placements.append(PackedPartition(t, pid, r, 0))
            B = len(members)

        # --- materialize rows (splitting too-wide waves) --------------------
        if max_rows is not None and B > max_rows:
            for base in range(0, B, max_rows):
                chunk = [PackedPartition(p.tree, p.pid, p.row - base,
                                         p.offset)
                         for p in placements
                         if base <= p.row < base + max_rows]
                out.append(materialize(chunk, min(max_rows, B - base)))
        else:
            out.append(materialize(placements, B))
    return out
