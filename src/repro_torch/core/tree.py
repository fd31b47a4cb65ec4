"""Trajectory trees and DFS serialization (paper §3.1–3.2).

A copy of ``repro/core/tree.py`` without the SSM chunk alignment: the port
imports nothing of the reference package, and ``tests/test_torch_serve.py``,
``tests/test_torch_train.py`` and ``tests/test_torch_partition.py`` hold
this copy against the original on random, agentic, GRPO and partitioned
trees.

A trajectory tree is a rooted tree whose nodes hold token segments; each
root-to-leaf path is one trajectory.  DFS serialization lays every token
out once, with per-token metadata:

  - ``kv_last[j]``  : DFS index of the last token in node(j)'s subtree;
    token i may attend to token j iff ``j <= i and kv_last[j] >= i``.
  - ``pos_ids[t]``  : depth-based position (Eq. 9), so RoPE is exact.
  - ``weight[t]``   : λ_t (Eq. 4), ×advantage for RL.
  - ``prev_idx[t]`` : DFS index of the token whose logits predict token t.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np


@dataclass
class TreeNode:
    """One node: a token segment plus children."""

    tokens: np.ndarray                      # int32 [len]
    trained: Optional[np.ndarray] = None    # bool  [len]; True = model output (gets loss)
    advantage: Optional[np.ndarray] = None  # f32   [len]; RL per-token advantage
    children: list["TreeNode"] = field(default_factory=list)
    # GRPO-style per-branch advantage, meaningful on leaves; None = 1.0
    branch_adv: Optional[float] = None

    def __post_init__(self) -> None:
        self.tokens = np.asarray(self.tokens, dtype=np.int32)
        if self.trained is None:
            self.trained = np.ones_like(self.tokens, dtype=bool)
        else:
            self.trained = np.asarray(self.trained, dtype=bool)
        if self.advantage is not None:
            self.advantage = np.asarray(self.advantage, dtype=np.float32)

    @property
    def size(self) -> int:
        return int(self.tokens.shape[0])


@dataclass
class TrajectoryTree:
    root: TreeNode

    def nodes(self) -> Iterator[TreeNode]:
        stack = [self.root]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(reversed(n.children))

    def num_unique_tokens(self) -> int:
        return sum(n.size for n in self.nodes())

    def num_leaves(self) -> int:
        return sum(1 for n in self.nodes() if not n.children)

    def num_nodes(self) -> int:
        return sum(1 for _ in self.nodes())

    def max_path_tokens(self) -> int:
        def rec(n: TreeNode) -> int:
            return n.size + (max((rec(c) for c in n.children), default=0))
        return rec(self.root)

    def por(self) -> float:
        """Potential Overlap Ratio — Eq. (12)."""
        flat = self.flat_tokens()
        return 1.0 - self.num_unique_tokens() / flat if flat else 0.0

    def paths(self) -> list[list[TreeNode]]:
        """All root-to-leaf node paths (one per leaf), in DFS leaf order."""
        out: list[list[TreeNode]] = []

        def rec(n: TreeNode, prefix: list[TreeNode]) -> None:
            prefix = prefix + [n]
            if not n.children:
                out.append(prefix)
            for c in n.children:
                rec(c, prefix)

        rec(self.root, [])
        return out

    def flat_tokens(self) -> int:
        """Token count of the per-branch serialization (prefixes repeated)."""
        return sum(sum(n.size for n in path) for path in self.paths())

    def linearize_paths(self) -> list[dict[str, np.ndarray]]:
        """Per-branch baseline: one linear sequence per root-to-leaf path,
        each carrying ``branch_adv`` — the leaf's per-branch RL advantage
        (1.0 when unset) — for the baseline packer's 'rl' weights."""
        seqs = []
        for path in self.paths():
            toks = np.concatenate([n.tokens for n in path])
            trained = np.concatenate([n.trained for n in path])
            adv = (np.concatenate([
                n.advantage if n.advantage is not None
                else np.ones(n.size, np.float32) for n in path]))
            leaf = path[-1]
            seqs.append(dict(tokens=toks, trained=trained, advantage=adv,
                             pos_ids=np.arange(toks.shape[0],
                                               dtype=np.int32),
                             branch_adv=float(leaf.branch_adv)
                             if leaf.branch_adv is not None else 1.0))
        return seqs


@dataclass
class SerializedTree:
    """DFS serialization of one tree (paper Eq. (8)) + equivalence metadata."""

    tokens: np.ndarray        # i32 [N]
    pos_ids: np.ndarray       # i32 [N] depth-based positions (Eq. 9)
    kv_last: np.ndarray       # i32 [N] last DFS index visible-to bound
    weight: np.ndarray        # f32 [N] λ_t (Eq. 4), already ×advantage for RL
    prev_idx: np.ndarray      # i32 [N] logits row predicting token t (−1: none)
    valid: np.ndarray         # bool [N] (all True: no chunk padding here)
    node_id: np.ndarray       # i32 [N] DFS node index per token
    node_parent: np.ndarray   # i32 [num_nodes] parent node index (−1 for root)
    node_start: np.ndarray    # i32 [num_nodes] DFS start offset of node segment
    node_end: np.ndarray      # i32 [num_nodes] end offset (exclusive)
    num_paths: int            # K

    @property
    def n(self) -> int:
        return int(self.tokens.shape[0])

    def chunk_parent_map(self, chunk_size: int) -> np.ndarray:
        """The SSM chunk-parent map (reference ``core/tree.py``): SSM and
        hybrid families are ROADMAP.md Queue A item 4."""
        raise NotImplementedError(
            "chunk_parent_map is SSM-only and not ported yet; see "
            "ROADMAP.md Queue A item 4")


def _leaf_counts(root: TreeNode) -> dict[int, int]:
    """g_n = number of root-to-leaf paths through node n (post-order)."""
    g: dict[int, int] = {}

    def rec(n: TreeNode) -> int:
        tot = sum(rec(c) for c in n.children) if n.children else 1
        g[id(n)] = tot
        return tot

    rec(root)
    return g


def _branch_adv_sums(root: TreeNode) -> dict[int, float]:
    """Σ of per-branch advantages over the leaves under each node (a leaf
    with ``branch_adv=None`` counts as 1.0)."""
    s: dict[int, float] = {}

    def rec(n: TreeNode) -> float:
        if not n.children:
            tot = 1.0 if n.branch_adv is None else float(n.branch_adv)
        else:
            tot = sum(rec(c) for c in n.children)
        s[id(n)] = tot
        return tot

    rec(root)
    return s


def tree_lam_map(root: TreeNode, loss_mode: str) -> dict[int, float]:
    """id(node) → λ for every node of the tree rooted at ``root``, under
    ``loss_mode`` — exactly the per-node weight ``serialize_tree`` would
    assign.  Shared by the partitioner (pruned subtrees keep full-tree
    weights) and the cross-tree grafter (``core/forest``)."""
    g = _leaf_counts(root)
    K = g[id(root)]
    if loss_mode == "uniform":
        return {nid: 1.0 for nid in g}
    if loss_mode == "rl":
        return {nid: a / K for nid, a in _branch_adv_sums(root).items()}
    if loss_mode == "sep_avg":
        return {nid: gn / K for nid, gn in g.items()}
    raise ValueError(loss_mode)


def serialize_tree(tree: TrajectoryTree, *,
                   loss_mode: str = "sep_avg",
                   lam_map: Optional[dict[int, float]] = None,
                   depth_pos0: int = 0,
                   root_prev: int = -1) -> SerializedTree:
    """DFS-serialize ``tree``; every token appears exactly once (Eq. 8).

    loss_mode: 'sep_avg' (λ = g_t/K), 'uniform' (λ = 1) or 'rl'
    (λ = Σ_{branches through t} A_b / K).

    Partition-mode extras (``core/partition.py``):
      lam_map    : id(node) → λ computed on the *full* tree (a pruned
                   partition subtree keeps full-tree weights);
      depth_pos0 : depth position of the first token (= #ancestor tokens);
      root_prev  : prev_idx of the very first token; −2 marks a partition
                   root whose predicting token lives in the parent
                   partition (its loss is the parent's boundary loss).
    The reference's SSM chunk padding (``chunk_size``) is ROADMAP.md
    Queue A item 4.
    """
    g = _leaf_counts(tree.root)
    K = g[id(tree.root)]
    adv_sum = _branch_adv_sums(tree.root) if loss_mode == "rl" else None

    toks: list[np.ndarray] = []
    pos: list[np.ndarray] = []
    wgt: list[np.ndarray] = []
    prv: list[np.ndarray] = []
    nid: list[np.ndarray] = []
    node_parent: list[int] = []
    node_start: list[int] = []
    node_end: list[int] = []
    cursor = 0  # DFS token offset

    def rec(node: TreeNode, depth_pos: int, parent_nid: int,
            parent_last_tok: int) -> None:
        nonlocal cursor
        my_nid = len(node_parent)
        node_parent.append(parent_nid)
        L = node.size
        start = cursor
        node_start.append(start)
        node_end.append(start + L)

        toks.append(node.tokens)
        pos.append(np.arange(depth_pos, depth_pos + L, dtype=np.int32))
        if lam_map is not None:
            lam = lam_map[id(node)]
        elif loss_mode == "sep_avg":
            lam = g[id(node)] / K
        elif loss_mode == "uniform":
            lam = 1.0
        elif loss_mode == "rl":
            lam = adv_sum[id(node)] / K
        else:
            raise ValueError(loss_mode)
        adv = (node.advantage if node.advantage is not None
               else np.ones(L, np.float32))
        wgt.append(np.where(node.trained, lam * adv, 0.0).astype(np.float32))
        # within a node the previous DFS slot; a node's first token looks at
        # the parent node's last token (empty nodes add no tokens)
        p = np.arange(start - 1, start + L - 1, dtype=np.int32)
        if L > 0:
            p[0] = parent_last_tok
        prv.append(p)
        nid.append(np.full(L, my_nid, np.int32))
        cursor += L

        my_last_tok = start + L - 1 if L > 0 else parent_last_tok
        for c in node.children:
            rec(c, depth_pos + L, my_nid, my_last_tok)

    rec(tree.root, depth_pos0, -1, root_prev)

    # kv_last per token = last DFS index of its node's subtree; subtree
    # ends accumulate in reverse DFS order (children follow parents)
    kv_last = np.full(cursor, -1, np.int32)
    node_sub_end = np.zeros(len(node_parent), np.int64)
    for i in range(len(node_parent) - 1, -1, -1):
        node_sub_end[i] = max(node_sub_end[i], node_end[i])
        p = node_parent[i]
        if p >= 0:
            node_sub_end[p] = max(node_sub_end[p], node_sub_end[i])
    for i in range(len(node_parent)):
        kv_last[node_start[i]:node_end[i]] = node_sub_end[i] - 1

    return SerializedTree(
        tokens=np.concatenate(toks),
        pos_ids=np.concatenate(pos),
        kv_last=kv_last,
        weight=np.concatenate(wgt),
        prev_idx=np.concatenate(prv),
        valid=np.ones(cursor, bool),
        node_id=np.concatenate(nid) if nid else np.zeros(0, np.int32),
        node_parent=np.asarray(node_parent, np.int32),
        node_start=np.asarray(node_start, np.int32),
        node_end=np.asarray(node_end, np.int32),
        num_paths=K,
    )


def visibility_mask(ser: SerializedTree) -> np.ndarray:
    """Dense [N, N] boolean tree-attention mask (test oracle; Fig. 3)."""
    n = ser.n
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return (j <= i) & (ser.kv_last[None, :] >= i) & ser.valid[None, :] \
        & ser.valid[:, None]


def subtree_token_count(tree: TrajectoryTree) -> dict[int, int]:
    """id(node) → token count of its subtree (used by the partitioner)."""
    out: dict[int, int] = {}

    def rec(n: TreeNode) -> int:
        t = n.size + sum(rec(c) for c in n.children)
        out[id(n)] = t
        return t

    rec(tree.root)
    return out
