"""Redundancy-Free Tree Partitioning (paper §3.3) — host-side planning.

A copy of ``repro/core/partition.py`` (held against it in
``tests/test_torch_partition.py``).  With ``chunk_size`` (the SSM and
hybrid families) capacities are chunk multiples, node segments are padded
to the chunk grid, and each cut records the chunk holding its state.

When a tree exceeds the per-step token budget C, split it into connected
subtrees with cuts at node boundaries (so the partition dependency graph
is itself a tree → peak memory bounded by one root-to-leaf partition
path), sized to maximize per-partition token utilization: a deterministic
greedy, bottom-up accumulation closing the largest child subtrees first
when a node's accumulated open subtree exceeds C.

Each partition gets its own DFS serialization (full-tree λ weights,
depth-position offset, gateway prev slots −2.. for the conv/token-shift
context at its root) and per-cut capture plans: which of its token
positions lie on the path root → cut (their K/V is relayed to the child
partition), which chunk holds the cut state (SSM) and the child's boundary
first-token label (its loss belongs to the parent, whose hidden state
predicts it).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.tree import (SerializedTree, TrajectoryTree, TreeNode,
                                   _branch_adv_sums, _leaf_counts,
                                   serialize_tree)


def split_long_nodes(tree: TrajectoryTree, max_len: int,
                     origin: Optional[dict] = None) -> TrajectoryTree:
    """Pre-split node segments longer than max_len into chains (semantics
    unchanged — a chain of nodes spells the same paths).  ``origin``, if
    given, is filled with id(new node) → id(source node) so id-keyed
    metadata (an external λ map) can be remapped onto the copy: every
    piece of a split chain has the same leaf set beneath it, hence the
    same λ, as the node it came from."""

    def rec(n: TreeNode) -> TreeNode:
        children = [rec(c) for c in n.children]
        if n.size <= max_len:
            m = TreeNode(tokens=n.tokens, trained=n.trained,
                         advantage=n.advantage, branch_adv=n.branch_adv)
            m.children = children
            if origin is not None:
                origin[id(m)] = id(n)
            return m
        head: Optional[TreeNode] = None
        cur: Optional[TreeNode] = None
        for s in range(0, n.size, max_len):
            e = min(s + max_len, n.size)
            piece = TreeNode(tokens=n.tokens[s:e], trained=n.trained[s:e],
                             advantage=None if n.advantage is None
                             else n.advantage[s:e],
                             branch_adv=n.branch_adv)
            if origin is not None:
                origin[id(piece)] = id(n)
            if head is None:
                head = piece
            else:
                cur.children = [piece]
            cur = piece
        cur.children = children
        return head

    return TrajectoryTree(root=rec(tree.root))


@dataclass
class CutPlan:
    """One cut node inside a partition → one child partition."""
    child_pid: int
    # indices (into this partition's DFS serialization) of *valid* tokens on
    # the path partition-root → cut node, in path order:
    path_token_idx: np.ndarray
    # chunk index (this partition's chunk grid) holding the SSM state at the
    # cut (= last chunk of the cut node); −1 when no SSM:
    cut_chunk: int
    # boundary loss: the child-partition root's first token is predicted by
    # this partition's hidden state at the cut node's last valid token:
    boundary_pos: int          # DFS index (here) of the predicting token
    boundary_label: int        # child's first token id
    boundary_weight: float     # λ of the child's first token


@dataclass
class TreePartition:
    pid: int
    parent_pid: int            # −1 for the root partition
    ser: SerializedTree
    anc_len: int               # #ancestor tokens (= depth-pos offset)
    cuts: list[CutPlan] = field(default_factory=list)
    num_paths_total: int = 1   # K of the full tree (loss normalizer)


def _chunk_pad(n: int, chunk: Optional[int]) -> int:
    if not chunk:
        return n
    return ((n + chunk - 1) // chunk) * chunk


def partition_tree(
    tree: TrajectoryTree,
    capacity: int,
    *,
    chunk_size: Optional[int] = None,
    loss_mode: str = "sep_avg",
    lam_map: Optional[dict] = None,
) -> list[TreePartition]:
    """Plan partitions for one tree.  Returns them in DFS (topological)
    order: parents precede children.

    ``lam_map`` (id(node) → λ on the *input* tree) overrides the
    loss_mode-derived weights — a grafted cross-tree forest
    (``core/forest``) carries its summed/preserved per-branch λ this way
    when the merged tree exceeds capacity and partitions like any
    oversized tree."""
    unit = chunk_size or 1
    assert capacity % unit == 0 or chunk_size is None
    origin: dict[int, int] = {}
    tree = split_long_nodes(tree, max(1, capacity - (unit - 1))
                            if chunk_size else capacity, origin)

    # full-tree weights
    g = _leaf_counts(tree.root)
    K = g[id(tree.root)]
    if lam_map is not None:
        ext = lam_map
        lam_map = {id(n): ext[origin[id(n)]] for n in tree.nodes()}
    elif loss_mode == "uniform":
        lam_map = {nid: 1.0 for nid in g}
    elif loss_mode == "rl":
        lam_map = {nid: a / K
                   for nid, a in _branch_adv_sums(tree.root).items()}
    elif loss_mode == "sep_avg":
        lam_map = {nid: gn / K for nid, gn in g.items()}
    else:
        raise ValueError(loss_mode)

    padded = {id(n): _chunk_pad(n.size, chunk_size)
              for n in tree.nodes()}

    # --- greedy bottom-up packing: decide the set of cut nodes ------------
    cut: set[int] = set()          # id(node) → starts a new partition
    open_size: dict[int, int] = {}

    def pack(n: TreeNode) -> int:
        for c in n.children:
            pack(c)
        total = padded[id(n)] + sum(open_size[id(c)] for c in n.children)
        if total > capacity:
            kids = sorted(n.children, key=lambda c: -open_size[id(c)])
            for c in kids:
                cut.add(id(c))
                total -= open_size[id(c)]
                if total <= capacity:
                    break
        assert total <= capacity, \
            f"node of {padded[id(n)]} tokens exceeds capacity {capacity}"
        open_size[id(n)] = total
        return total

    pack(tree.root)

    # --- materialize partitions in DFS order ------------------------------
    parts: list[TreePartition] = []

    def depth_tokens(path_nodes: list[TreeNode]) -> int:
        return sum(n.size for n in path_nodes)

    def build(root: TreeNode, parent_pid: int, anc_len: int) -> None:
        pid = len(parts)
        # pruned copy: descend until cut nodes; record cut children
        cut_children: list[tuple[TreeNode, TreeNode]] = []  # (pruned_anc, orig_child)
        lam_local: dict[int, float] = {}

        def prune(n: TreeNode) -> TreeNode:
            m = TreeNode(tokens=n.tokens, trained=n.trained,
                         advantage=n.advantage, branch_adv=n.branch_adv)
            lam_local[id(m)] = lam_map[id(n)]
            for c in n.children:
                if id(c) in cut:
                    cut_children.append((m, c))
                else:
                    m.children.append(prune(c))
            return m

        proot = prune(root)
        psub = TrajectoryTree(root=proot)
        ser = serialize_tree(psub, chunk_size=chunk_size, lam_map=lam_local,
                             depth_pos0=anc_len,
                             root_prev=-2 if parent_pid >= 0 or anc_len > 0
                             else -1)
        part = TreePartition(pid=pid, parent_pid=parent_pid, ser=ser,
                             anc_len=anc_len, num_paths_total=K)
        parts.append(part)

        # map pruned nodes → serialization node ids (DFS order coincides)
        order: list[TreeNode] = []

        def dfs(m: TreeNode):
            order.append(m)
            for c in m.children:
                dfs(c)

        dfs(proot)
        nid_of = {id(m): i for i, m in enumerate(order)}
        parent_of = {id(m): None for m in order}
        for m in order:
            for c in m.children:
                parent_of[id(c)] = m

        for anc_node, child in cut_children:
            # path partition-root → anc_node (inclusive): valid token idx
            chain = []
            cur = anc_node
            while cur is not None:
                chain.append(cur)
                cur = parent_of[id(cur)]
            chain.reverse()
            idxs = []
            for m in chain:
                nid = nid_of[id(m)]
                s, e = int(ser.node_start[nid]), int(ser.node_end[nid])
                idxs.extend(i for i in range(s, e) if ser.valid[i])
            nid = nid_of[id(anc_node)]
            e = int(ser.node_end[nid])
            cut_chunk = -1 if not chunk_size else (e - 1) // chunk_size
            # boundary loss: child's first token predicted from anc's last
            last_valid = idxs[-1]
            child_pid_placeholder = -1  # fixed after recursion ordering
            part.cuts.append(CutPlan(
                child_pid=child_pid_placeholder,
                path_token_idx=np.asarray(idxs, np.int32),
                cut_chunk=cut_chunk,
                boundary_pos=int(last_valid),
                boundary_label=int(child.tokens[0]),
                boundary_weight=float(lam_map[id(child)]
                                      * (1.0 if child.trained[0] else 0.0)
                                      * (child.advantage[0]
                                         if child.advantage is not None
                                         else 1.0)),
            ))

        # recurse into children partitions (DFS): anc_len grows by the path
        for cp, (_anc, child) in zip(part.cuts, cut_children):
            cp.child_pid = len(parts)
            build(child, pid, anc_len + len(cp.path_token_idx))

    build(tree.root, -1, 0)
    return parts


def partition_schedule_load(parts: list[TreePartition]) -> dict:
    """Schedule-level load summary of ONE partitioned tree, for the
    planner's cross-step balancing (train/planner): ``tokens`` is the row
    cells its waves must materialize (serialized, chunk-padded), ``depth``
    the number of waves it forces — the step's partitioned critical
    path — and ``width`` the widest single depth level (row pressure)."""
    depth: dict[int, int] = {}
    width: dict[int, int] = {}
    for p in parts:
        d = 0 if p.parent_pid < 0 else depth[p.parent_pid] + 1
        depth[p.pid] = d
        width[d] = width.get(d, 0) + 1
    return dict(tokens=sum(p.ser.n for p in parts),
                num_partitions=len(parts),
                depth=1 + max(depth.values()) if depth else 0,
                width=max(width.values()) if width else 0)


def choose_capacity(trees: list[TrajectoryTree], seq_len: int, *,
                    chunk_size: Optional[int] = None,
                    max_candidates: int = 4) -> int:
    """Planner-chosen partition capacity (the carried ROADMAP item): pick
    the per-partition token cap for a window's oversized trees from
    ``partition_schedule_load`` instead of a user-fixed ``--capacity``.

    Candidates are pow2 fractions of ``seq_len`` (so capture-path pads
    stay inside the pow2 signature buckets the engine compiles), scored
    in token-cell units: every partition materializes a full ``seq_len``
    wave-row slot, and each extra wave depth level is another dispatch
    on the step's critical path.  Ties keep the larger cap.  Partition
    *structure* depends only on token counts, so the probe partitions
    under ``sep_avg`` regardless of the training loss mode."""
    unit = chunk_size or 1
    cands: list[int] = []
    c = seq_len
    while c >= max(2 * unit, 32) and len(cands) < max_candidates:
        if c % unit == 0:
            cands.append(c)
        c //= 2
    if not cands:
        return seq_len
    best: Optional[tuple[float, int]] = None
    for cap in cands:                      # descending: ties keep larger
        cells = depth = 0
        for t in trees:
            load = partition_schedule_load(
                partition_tree(t, cap, chunk_size=chunk_size))
            cells += load["num_partitions"] * seq_len
            depth += load["depth"]
        score = cells + 0.25 * depth * seq_len
        if best is None or score < best[0]:
            best = (score, cap)
    return best[1]


def partition_token_counts(parts: list[TreePartition]) -> dict:
    """Accounting for the Fig.-5 benchmark."""
    unique = sum(int(p.ser.valid.sum()) for p in parts)
    with_pad = sum(p.ser.n for p in parts)
    return dict(num_partitions=len(parts), unique_tokens=unique,
                padded_tokens=with_pad)


def standard_partition_token_counts(
    tree: TrajectoryTree,
    capacity: int,
    *,
    chunk_size: Optional[int] = None,
    loss_mode: str = "sep_avg",
) -> int:
    """Token count of *standard* tree partitioning (no differentiable
    boundaries): each child partition re-includes all ancestor tokens
    (recomputed) — the paper's Fig.-5 middle bar.

    ``chunk_size``/``loss_mode`` must match the config being measured:
    chunked (SSM) serializations pad every node segment to the chunk grid
    and the re-included ancestor prefix pads the same way, so ignoring them
    under-counts the standard-partitioning bar."""
    parts = partition_tree(tree, capacity, chunk_size=chunk_size,
                           loss_mode=loss_mode)
    total = 0
    for p in parts:
        total += p.ser.n + _chunk_pad(p.anc_len, chunk_size)
    return total
