"""Synthetic trajectory trees and the GRPO group baseline.

A copy of the parts of ``repro/data/synthetic.py`` that serving and packed
training use; the same ``np.random.Generator`` gives the same trees as the
reference (held against it in ``tests/test_torch_serve.py`` and
``tests/test_torch_train.py``).  The ``chain``, ``por`` and ``template``
generators are not copied yet.
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


def assign_branch_advantages(tree: TrajectoryTree, rewards, *,
                             normalize: bool = True) -> np.ndarray:
    """Attach GRPO-style per-branch advantages to a tree's leaves:
    ``rewards[k]`` is the reward of the k-th root-to-leaf trajectory in
    DFS leaf order; with ``normalize`` the group baseline is applied.
    Returns the advantages."""
    leaves = [p[-1] for p in tree.paths()]
    r = np.asarray(rewards, np.float64)
    assert r.shape == (len(leaves),), (r.shape, len(leaves))
    adv = group_normalized_advantages(r, normalize)
    for leaf, a in zip(leaves, adv):
        leaf.branch_adv = float(a)
    return adv.astype(np.float32)


def grpo_tree(
    rng: np.random.Generator,
    *,
    vocab_size: int = 32000,
    num_turns: int = 6,
    turn_len_range: tuple[int, int] = (64, 512),
    tool_branch_prob: float = 0.4,
    think_branch_prob: float = 0.3,
    max_parallel_tools: int = 4,
    reward_scale: float = 1.0,
) -> TrajectoryTree:
    """RL model-update workload: an agentic rollout tree whose branches
    carry group-normalized GRPO advantages (train with loss_mode="rl")."""
    t = agentic_tree(rng, vocab_size=vocab_size, num_turns=num_turns,
                     turn_len_range=turn_len_range,
                     tool_branch_prob=tool_branch_prob,
                     think_branch_prob=think_branch_prob,
                     max_parallel_tools=max_parallel_tools)
    rewards = rng.normal(scale=reward_scale, size=t.num_leaves())
    assign_branch_advantages(t, rewards)
    return t


_GENERATORS = {"random": random_tree, "agentic": agentic_tree,
               "grpo": grpo_tree}
_NOT_PORTED = {"chain": "ROADMAP.md Queue A item 3 (planner)",
               "por": "ROADMAP.md Queue A item 3 (planner)",
               "template": "ROADMAP.md Queue A item 3 (planner: grafting)"}


def trees_for_batch(seed: int, *, n_trees: int, kind: str = "random",
                    **kw) -> list[TrajectoryTree]:
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"tree kind {kind!r} is not ported yet; see {_NOT_PORTED[kind]}")
    rng = np.random.default_rng(seed)
    gen = _GENERATORS[kind]
    return [gen(rng, **kw) for _ in range(n_trees)]
