"""Packing serialized trees into fixed-shape training rows.

A copy of the packed-row part of ``repro/core/packing.py`` (``:23-310``);
``tests/test_torch_train.py`` holds it against the original field by field.
A row holds one or more whole DFS-serialized trees back to back; because
``kv_last`` bounds visibility to a token's own subtree, packed trees are
mutually invisible with no extra mask.  The SSM ``chunk_size`` alignment is
not copied (SSM families are ROADMAP Queue A item 5), and neither is the
partition-wave packing (Queue A item 4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

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
            "Queue A item 5")


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
