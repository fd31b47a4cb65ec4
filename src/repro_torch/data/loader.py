"""Tree ingestion: synthetic generator batches → the planner's stream.

A copy of ``repro/data/loader.py``'s ``LoaderConfig`` (:29) and
``tree_stream`` (:57).  Each global batch is a self-contained set of whole
trees (paper §3.4).  The partition options of the reference's config
(``auto_partition``, ``capacity``, ``auto_capacity``) come with the
partition waves (ROADMAP.md Queue A item 4); the deprecated
``step_batches``/``execution_plans`` wrappers are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

from repro_torch.configs.base import ModelConfig
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


def tree_stream(cfg: ModelConfig, lc: LoaderConfig,
                num_batches: int) -> Iterator[list[TrajectoryTree]]:
    """One deterministic list of trees per generator batch (seeded per
    batch, as the reference)."""
    gk = dict(vocab_size=cfg.vocab_size)
    gk.update(lc.gen_kwargs or {})
    for b in range(num_batches):
        yield trees_for_batch(lc.seed * 100_003 + b,
                              n_trees=lc.trees_per_batch, kind=lc.kind,
                              **gk)
