"""Synthetic trajectory trees and the GRPO group baseline.

A copy of ``repro/data/synthetic.py``; the same ``np.random.Generator``
gives the same trees as the reference (held against it in
``tests/test_torch_serve.py``, ``tests/test_torch_train.py`` and
``tests/test_torch_planner.py``).
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


def chain_tree(rng: np.random.Generator, *, length: int = 3,
               vocab_size: int = 256,
               seg_len_range: tuple[int, int] = (2, 6)) -> TrajectoryTree:
    """Degenerate tree = single path (sequence special case)."""
    def seg() -> TreeNode:
        L = int(rng.integers(*seg_len_range))
        return TreeNode(tokens=rng.integers(0, vocab_size, L).astype(np.int32))
    root = seg()
    cur = root
    for _ in range(length - 1):
        nxt = seg()
        cur.children = [nxt]
        cur = nxt
    return TrajectoryTree(root=root)


def por_controlled_tree(
    rng: np.random.Generator,
    *,
    target_por: float,
    num_paths: int = 8,
    tokens_per_path: int = 256,
    vocab_size: int = 1024,
) -> TrajectoryTree:
    """K paths of equal length sharing one trunk; trunk length chosen so the
    tree's POR ≈ target (paper §4.5 keeps leaves and total tokens fixed
    while sweeping POR).

    With trunk t and per-path tail (L−t):  flat = K·L,
    unique = t + K·(L−t)  ⇒  POR = (K−1)·t / (K·L).
    """
    K, L = num_paths, tokens_per_path
    t = int(round(target_por * K * L / (K - 1)))
    t = max(1, min(t, L - 1))
    trunk = TreeNode(tokens=rng.integers(0, vocab_size, t).astype(np.int32))
    for _ in range(K):
        tail = TreeNode(
            tokens=rng.integers(0, vocab_size, L - t).astype(np.int32))
        trunk.children.append(tail)
    return TrajectoryTree(root=trunk)


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


def template_tokens(template_seed: int, template_id: int, length: int,
                    vocab_size: int) -> np.ndarray:
    """The token ids of one system-prompt template — deterministic in
    (template_seed, template_id) and independent of the per-batch rng, so
    every batch of a stream (and every lookahead window) sees the SAME
    template text: the cross-tree shared prefix the forest grafter
    (``core/forest``) dedups."""
    trng = np.random.default_rng([int(template_seed), int(template_id)])
    return trng.integers(0, vocab_size, int(length)).astype(np.int32)


def template_tree(
    rng: np.random.Generator,
    *,
    vocab_size: int = 32000,
    num_templates: int = 4,
    template_len: int = 64,
    overlap: float = 1.0,
    template_seed: int = 7,
    num_turns: int = 3,
    turn_len_range: tuple[int, int] = (16, 64),
    tool_branch_prob: float = 0.4,
    think_branch_prob: float = 0.3,
    max_parallel_tools: int = 3,
) -> TrajectoryTree:
    """The production template workload: each trajectory opens with one
    of ``num_templates`` distinct system-prompt templates (shared
    verbatim across trees AND batches — see ``template_tokens``), then
    continues as an agentic rollout tree.  ``overlap`` is the fraction of
    the template kept verbatim; the rest is per-tree noise (prompt
    suffixes, user names, timestamps), so grafting's prefix-trie has a
    configurable exact-match region.  Template tokens are context, not
    model output: ``trained=False``."""
    tid = int(rng.integers(num_templates))
    toks = template_tokens(template_seed, tid, template_len, vocab_size)
    shared = int(round(min(max(overlap, 0.0), 1.0) * template_len))
    head_toks = np.concatenate([
        toks[:shared],
        rng.integers(0, vocab_size, template_len - shared).astype(np.int32)])
    head = TreeNode(tokens=head_toks,
                    trained=np.zeros(template_len, bool))
    tail = agentic_tree(rng, vocab_size=vocab_size, num_turns=num_turns,
                        turn_len_range=turn_len_range,
                        tool_branch_prob=tool_branch_prob,
                        think_branch_prob=think_branch_prob,
                        max_parallel_tools=max_parallel_tools)
    head.children = [tail.root]
    return TrajectoryTree(root=head)


def template_stream(seed: int, *, num_batches: int, trees_per_batch: int,
                    **kw):
    """Iterator of generator batches of ``template_tree``\\ s — the
    template-heavy stream grafting benchmarks/tests plan over (usable
    directly as a ``train.planner.plans`` source)."""
    for b in range(num_batches):
        yield trees_for_batch(seed * 100_003 + b,
                              n_trees=trees_per_batch, kind="template",
                              **kw)


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


_GENERATORS = {"random": random_tree, "chain": chain_tree,
               "por": por_controlled_tree, "agentic": agentic_tree,
               "grpo": grpo_tree, "template": template_tree}


def trees_for_batch(seed: int, *, n_trees: int, kind: str = "random",
                    **kw) -> list[TrajectoryTree]:
    rng = np.random.default_rng(seed)
    gen = _GENERATORS[kind]
    return [gen(rng, **kw) for _ in range(n_trees)]
