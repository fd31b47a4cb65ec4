"""Synthetic trajectory trees and the GRPO group baseline.

A copy of the serving slice's part of ``repro/data/synthetic.py``; the
same ``np.random.Generator`` gives the same trees as the reference (held
against it in ``tests/test_torch_serve.py``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.tree import TrajectoryTree, TreeNode


def random_tree(
    rng: np.random.Generator,
    *,
    vocab_size: int = 256,
    max_depth: int = 4,
    branch_prob: float = 0.5,
    max_children: int = 3,
    seg_len_range: tuple[int, int] = (2, 8),
    trained_frac: float = 0.7,
) -> TrajectoryTree:
    """Random tree with geometric-ish branching."""

    def seg() -> tuple[np.ndarray, np.ndarray]:
        L = int(rng.integers(*seg_len_range))
        toks = rng.integers(0, vocab_size, L).astype(np.int32)
        trained = rng.random(L) < trained_frac
        return toks, trained

    def rec(depth: int) -> TreeNode:
        toks, trained = seg()
        node = TreeNode(tokens=toks, trained=trained)
        if depth < max_depth and rng.random() < branch_prob:
            k = int(rng.integers(2, max_children + 1))
            node.children = [rec(depth + 1) for _ in range(k)]
        return node

    return TrajectoryTree(root=rec(0))


def agentic_tree(
    rng: np.random.Generator,
    *,
    vocab_size: int = 32000,
    num_turns: int = 6,
    turn_len_range: tuple[int, int] = (64, 512),
    tool_branch_prob: float = 0.4,
    think_branch_prob: float = 0.3,
    max_parallel_tools: int = 4,
) -> TrajectoryTree:
    """Mimics the paper's Fig. 6: a long conversation trunk that may fork
    at turn boundaries into parallel tool-call branches or think-mode
    variants."""

    def seg(lo_hi=turn_len_range, trained_p=0.6) -> TreeNode:
        L = int(rng.integers(*lo_hi))
        toks = rng.integers(0, vocab_size, L).astype(np.int32)
        trained = rng.random(L) < trained_p
        return TreeNode(tokens=toks, trained=trained)

    def build(turn: int) -> TreeNode:
        node = seg()
        if turn >= num_turns:
            return node
        r = rng.random()
        if r < tool_branch_prob:
            k = int(rng.integers(2, max_parallel_tools + 1))
            node.children = [build(turn + 1) for _ in range(k)]
        elif r < tool_branch_prob + think_branch_prob:
            node.children = [build(turn + 1), build(turn + 1)]
        else:
            node.children = [build(turn + 1)]
        return node

    return TrajectoryTree(root=build(0))


def group_normalized_advantages(rewards, normalize: bool = True
                                ) -> np.ndarray:
    """GRPO group baseline: A = (r − mean)/std over the group's rewards
    (``normalize=False`` passes raw rewards through)."""
    r = np.asarray(rewards, np.float64)
    return (r - r.mean()) / (r.std() + 1e-6) if normalize else r
