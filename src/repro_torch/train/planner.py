"""A stand-in for the reference's plan-ahead scheduler, with its entry name.

``plans(cfg, lc, source)`` turns each generator batch into one
``ExecutionPlan`` (lookahead 1): every tree is serialized once; a tree
whose serialization or longest root-to-leaf path exceeds a row is dropped
(the reference's ``_fit_split`` filter, so tree and baseline modes train
the same trees); the rest are packed first-fit decreasing
(``plan_tree_rows``) into ``lc.batch_rows`` rows, dropping the largest
remaining tree while FFD needs more rows than that.  Baseline mode packs
the same trees' linearized paths (``pack_linear_paths``), dropping the
largest while they do not fit.  Dropped trees are counted in
``ExecutionPlan.dropped``.

The reference's ``plans`` (``repro/train/planner.py:810``) is more: a cost
model scoring FFD against BFD, lookahead windows packed globally,
cross-tree grafting, routing of oversized trees to partition waves, replica
row balancing and a background build pipeline.  Those are ROADMAP.md
Queue A item 3 (item 4 for the waves), so this launcher's plans may differ
from the reference launcher's; parity is held at the engine, on the same
batches.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Sequence, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import (DoesNotFitError, materialize_tree_rows,
                                      pack_linear_paths, plan_tree_rows)
from repro_torch.core.tree import TrajectoryTree, serialize_tree
from repro_torch.data.loader import LoaderConfig, tree_stream
from repro_torch.device import DeviceLike
from repro_torch.models.model import prepare_batch
from repro_torch.train.engine import ExecutionPlan, PackedExec


def _fit(order, pack):
    """``pack(kept)`` of the largest prefix of ``order`` (indices, smallest
    first) that fits, dropping the largest tree while ``pack`` raises
    ``DoesNotFitError``.  Returns (kept, packed), or ([], None)."""
    kept = list(order)
    while kept:
        try:
            return kept, pack(kept)
        except DoesNotFitError:
            kept = kept[:-1]
    return [], None


def plan_batch(cfg: ModelConfig, lc: LoaderConfig,
               trees: Sequence[TrajectoryTree], *,
               device: DeviceLike = None) -> ExecutionPlan:
    """One generator batch → one ExecutionPlan (model inputs on
    ``device``)."""
    sers, paths = [], []
    dropped = 0
    for t in trees:
        ser = serialize_tree(t, loss_mode=lc.loss_mode)
        ps = t.linearize_paths()
        if max(ser.n, max(len(p["tokens"]) for p in ps)) <= lc.seq_len:
            sers.append(ser)
            paths.append(ps)
        else:
            dropped += 1
    order = sorted(range(len(sers)), key=lambda i: (sers[i].n, i))
    if lc.mode == "tree":
        def pack(kept):
            rows = plan_tree_rows([sers[i].n for i in kept], lc.seq_len,
                                  batch_size=lc.batch_rows)
            return materialize_tree_rows(
                sers, [[kept[j] for j in r] for r in rows], lc.seq_len)
    else:
        def pack(kept):
            return pack_linear_paths([paths[i] for i in kept], lc.seq_len,
                                     batch_size=lc.batch_rows,
                                     loss_mode=lc.loss_mode)
    kept, tb = _fit(order, pack)
    dropped += len(sers) - len(kept)
    packed = None
    if tb is not None:
        B, S = tb.tokens.shape
        packed = PackedExec(inputs=prepare_batch(cfg, tb, device=device),
                            tokens=int(tb.valid.sum()), cells=B * S)
    return ExecutionPlan(packed=packed, num_trees=len(kept), dropped=dropped)


def plans(cfg: ModelConfig, lc: LoaderConfig,
          source: Union[int, Iterable[Sequence[TrajectoryTree]]], *,
          device: DeviceLike = None) -> Iterator[ExecutionPlan]:
    """THE planner entry point: one ExecutionPlan per generator batch.
    ``source`` is an int (that many deterministic synthetic batches) or any
    iterable of per-step tree lists.  A plan with nothing packed still
    carries its ``dropped`` count; the caller skips it (``is_empty``)."""
    stream = tree_stream(cfg, lc, source) if isinstance(source, int) \
        else source
    for trees in stream:
        yield plan_batch(cfg, lc, list(trees), device=device)
