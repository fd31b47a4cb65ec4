"""Tree ingestion: synthetic generator batches → the planner's stream.

A copy of ``repro/data/loader.py``: ``LoaderConfig`` (:29), ``StepBatch``
(:46), ``tree_stream`` (:57) and ``dataset_por`` (:114).  Each global batch
is a self-contained set of whole trees (paper §3.4): shuffling happens
between trees, never inside one, so tree partitioning stays within a step
and the gradient is unbiased.  Everything schedule-shaped lives in the
planner (``train/planner.py``).  The reference's deprecated
``step_batches``/``batches``/``execution_plans`` wrappers are not copied:
``train.planner.plans(cfg, lc, source)`` is the one entry point.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import TreeBatch
from repro_torch.core.tree import TrajectoryTree
from repro_torch.data.synthetic import trees_for_batch


@dataclass
class LoaderConfig:
    seq_len: int = 512
    batch_rows: int = 4
    trees_per_batch: int = 8
    mode: str = "tree"            # tree | baseline
    kind: str = "agentic"         # synthetic generator
    seed: int = 0
    loss_mode: str = "sep_avg"
    gen_kwargs: Optional[dict] = None
    auto_partition: bool = False  # route oversized trees via partitioning
    capacity: Optional[int] = None  # partition token cap (default seq_len)
    # planner-chosen capacity: with capacity=None the planner resolves the
    # cap per lookahead window via core/partition.choose_capacity instead
    # of defaulting to seq_len (an explicit ``capacity`` always wins)
    auto_capacity: bool = False


@dataclass
class StepBatch:
    """One training step's data: the packed batch plus any trees routed
    to the partitioned driver instead of being dropped.  ``inputs`` are
    host (numpy) model inputs; the engine moves them to its device."""
    inputs: Optional[dict]              # model inputs (None: nothing packed)
    tb: Optional[TreeBatch]
    oversized: list[TrajectoryTree] = field(default_factory=list)
    dropped: int = 0                    # trees lost this step
    num_trees: int = 0                  # packed + oversized (normalizer)


def tree_stream(cfg: ModelConfig, lc: LoaderConfig,
                num_batches: int) -> Iterator[list[TrajectoryTree]]:
    """One deterministic list of trees per generator batch (seeded per
    batch, so lookahead windows re-slice the same data)."""
    gk = dict(vocab_size=cfg.vocab_size)
    gk.update(lc.gen_kwargs or {})
    for b in range(num_batches):
        yield trees_for_batch(lc.seed * 100_003 + b,
                              n_trees=lc.trees_per_batch, kind=lc.kind,
                              **gk)


def dataset_por(trees: Sequence[TrajectoryTree]) -> float:
    """Aggregate POR (Eq. 12) of a list of trees."""
    uniq = sum(t.num_unique_tokens() for t in trees)
    flat = sum(t.flat_tokens() for t in trees)
    return 1.0 - uniq / flat if flat else 0.0
