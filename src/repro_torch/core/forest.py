"""Cross-tree forest grafting: schedule-level shared-prefix reuse.

The paper's Gradient Restoration computes each shared prefix once
*within* a tree; at the schedule level the dominant remaining redundancy
is *between* trees — the same system prompt / task template heads many
trajectories in one lookahead window, and each tree re-computes it
("Schedule-Level Shared-Prefix Reuse for LLM RL Training", PAPERS.md).

This module merges trees whose token-level heads share a long-enough
prefix into one grafted ``TreeNode`` forest, so
the cross-tree prefix is tokenized / forwarded / backwarded exactly once
per window and Gradient Restoration sums cotangents over *all* grafted
branches:

  head        a tree's shareable region is its maximal unary root chain
              (every token on it is a prefix of every path, so it can
              become an ancestor of foreign branches without changing any
              path's visibility or depth positions);
  trie        heads are sorted lexicographically by per-token
              ``(token, trained, advantage)`` keys and grouped into
              maximal runs whose consecutive longest-common-prefix is
              ≥ ``min_graft`` — the threshold keeps tiny overlaps from
              fragmenting nodes (each split costs chunk padding under
              SSM serialization and packing granularity everywhere);
  graft       each group becomes a radix tree of shared spine nodes with
              the members' remainders hanging below; remainders reuse the
              original node objects (a chain node containing a divergence
              offset is split, exactly like ``partition.split_long_nodes``
              — both pieces keep the node's λ since a unary chain has all
              K leaves beneath every node);
  weights     per-branch loss weights / advantages are preserved via a
              ``lam_map`` for ``serialize_tree``: unshared nodes keep
              their source tree's full-tree λ bit-exactly
              (``tree_lam_map``), a shared spine node gets
              λ = Σ_members λ_root — along a unary root chain λ is
              constant and equals the root's, so summing the member
              roots' λ reproduces the independent-training gradient for
              every shared token (all three loss modes, including
              per-branch RL advantages across formerly-separate trees).

The loss normalizer must then count SOURCE trees, not grafted roots —
the planner carries ``n_src`` through FitTree/OversizedTree.  Whether a
graft actually wins (saved unique tokens vs. chunk-padding growth, row
fragmentation and gateway fan-out when the merged forest goes oversized)
is the cost model's call: ``core/plan_cost.graft_gain``.

A copy of ``repro/core/forest.py`` (held against it in
``tests/test_torch_planner.py``).  Pure numpy/host code, safe on planner
worker threads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.tree import TrajectoryTree, TreeNode, tree_lam_map


@dataclass
class Graft:
    """≥2 source trees merged under a shared-prefix spine."""
    tree: TrajectoryTree
    lam_map: dict[int, float]     # id(node) → λ for serialize_tree
    srcs: list[int]               # indices into the input tree list
    saved_tokens: int             # Σ source unique − grafted unique
    shared_tokens: int            # tokens on multi-source spine nodes


@dataclass
class _Member:
    idx: int
    chain: list[TreeNode]         # maximal unary root chain
    cum: np.ndarray               # cum[j] = head tokens before chain[j]
    tok: np.ndarray               # head token ids
    trn: np.ndarray               # head trained mask
    adv: np.ndarray               # head advantages (None ≡ 1.0)
    key: tuple                    # lexicographic sort key
    lam_root: float               # λ of the root (constant on the chain)


def _member(idx: int, tree: TrajectoryTree, loss_mode: str) -> _Member:
    chain = [tree.root]
    while len(chain[-1].children) == 1:
        chain.append(chain[-1].children[0])
    cum = np.cumsum([0] + [n.size for n in chain])
    if cum[-1]:
        tok = np.concatenate([n.tokens for n in chain])
        trn = np.concatenate([n.trained for n in chain])
        adv = np.concatenate([n.advantage if n.advantage is not None
                              else np.ones(n.size, np.float32)
                              for n in chain])
    else:
        tok = np.zeros(0, np.int32)
        trn = np.zeros(0, bool)
        adv = np.zeros(0, np.float32)
    key = tuple(zip(tok.tolist(), trn.tolist(), adv.tolist()))
    lam_root = tree_lam_map(tree.root, loss_mode)[id(tree.root)]
    return _Member(idx=idx, chain=chain, cum=cum, tok=tok, trn=trn,
                   adv=adv, key=key, lam_root=lam_root)


def _lcp_from(a: _Member, b: _Member, off: int) -> int:
    """Length of the common (token, trained, advantage) prefix of two
    heads beyond offset ``off``."""
    n = min(a.tok.size, b.tok.size)
    if n <= off:
        return 0
    eq = ((a.tok[off:n] == b.tok[off:n])
          & (a.trn[off:n] == b.trn[off:n])
          & (a.adv[off:n] == b.adv[off:n]))
    bad = np.flatnonzero(~eq)
    return int(bad[0]) if bad.size else n - off


def _runs(members: list[_Member], off: int, min_graft: int
          ) -> list[list[_Member]]:
    """Maximal runs of (lexicographically sorted) members whose
    consecutive LCP beyond ``off`` is ≥ min_graft.  Sortedness makes the
    run's set-LCP = LCP(first, last) ≥ min_graft."""
    groups: list[list[_Member]] = [[members[0]]]
    for prev, m in zip(members, members[1:]):
        if _lcp_from(prev, m, off) >= min_graft:
            groups[-1].append(m)
        else:
            groups.append([m])
    return groups


def _remainder(m: _Member, q: int, lam: dict[int, float]) -> list[TreeNode]:
    """The member's tree from head offset ``q`` onward, as subtree roots
    to hang under a shared spine node.  Reuses original node objects
    (their λ entries are already in ``lam``); only a chain node split at
    a mid-node offset allocates a new piece, which inherits the node's λ
    (unary chain ⇒ identical leaf set beneath both pieces)."""
    last = m.chain[-1]
    if q == m.tok.size:
        if last.children:
            return list(last.children)
        # whole tree consumed by the shared prefix: an empty leaf keeps
        # the branch (and its RL advantage) alive — K and λ are exact
        leaf = TreeNode(tokens=np.zeros(0, np.int32),
                        trained=np.zeros(0, bool),
                        branch_adv=last.branch_adv)
        lam[id(leaf)] = lam[id(last)]
        return [leaf]
    j = int(np.searchsorted(m.cum, q, side="right")) - 1
    node = m.chain[j]
    r = q - int(m.cum[j])
    if r == 0:
        return [node]
    piece = TreeNode(tokens=node.tokens[r:], trained=node.trained[r:],
                     advantage=None if node.advantage is None
                     else node.advantage[r:],
                     branch_adv=node.branch_adv)
    piece.children = list(node.children)
    lam[id(piece)] = lam[id(node)]
    return [piece]


def _build(group: list[_Member], off: int, lam: dict[int, float],
           min_graft: int, stats: dict) -> TreeNode:
    """Radix-merge a sorted group (set-LCP beyond ``off`` ≥ min_graft)
    into a shared spine node with member remainders below."""
    p = _lcp_from(group[0], group[-1], off)
    m0 = group[0]
    shared = TreeNode(tokens=m0.tok[off:off + p].copy(),
                      trained=m0.trn[off:off + p].copy(),
                      advantage=m0.adv[off:off + p].copy())
    lam[id(shared)] = float(sum(m.lam_root for m in group))
    stats["shared"] += p
    stats["saved"] += (len(group) - 1) * p
    nxt = off + p
    children: list[TreeNode] = []
    for m in group:
        if m.tok.size == nxt:
            children.extend(_remainder(m, nxt, lam))
    rest = [m for m in group if m.tok.size > nxt]
    if rest:
        for sub in _runs(rest, nxt, min_graft):
            if len(sub) >= 2:
                children.append(_build(sub, nxt, lam, min_graft, stats))
            else:
                children.extend(_remainder(sub[0], nxt, lam))
    shared.children = children
    return shared


def graft_trees(trees: Sequence[TrajectoryTree], *,
                loss_mode: str = "sep_avg", min_graft: int = 16
                ) -> tuple[list[Graft], list[int]]:
    """Detect shared heads across ``trees`` and merge them.

    Returns ``(grafts, passthrough)``: each graft merges ≥2 source trees
    (disjoint ``srcs``); ``passthrough`` lists the indices left alone.
    Source trees are never mutated — grafted structures reuse their node
    objects below the divergence points, so serializing a graft with its
    ``lam_map`` reproduces every source branch's weights bit-exactly on
    unshared nodes and sums λ over members on shared spine nodes.
    """
    min_graft = max(1, int(min_graft))
    members = sorted((_member(i, t, loss_mode)
                      for i, t in enumerate(trees)),
                     key=lambda m: m.key)
    grafts: list[Graft] = []
    passthrough: list[int] = []
    if not members:
        return grafts, passthrough
    for grp in _runs(members, 0, min_graft):
        if len(grp) < 2:
            passthrough.append(grp[0].idx)
            continue
        lam: dict[int, float] = {}
        for m in grp:
            lam.update(tree_lam_map(trees[m.idx].root, loss_mode))
        stats = {"shared": 0, "saved": 0}
        root = _build(grp, 0, lam, min_graft, stats)
        gt = TrajectoryTree(root=root)
        src_unique = sum(trees[m.idx].num_unique_tokens() for m in grp)
        grafts.append(Graft(tree=gt, lam_map=lam,
                            srcs=sorted(m.idx for m in grp),
                            saved_tokens=src_unique
                            - gt.num_unique_tokens(),
                            shared_tokens=stats["shared"]))
    return grafts, sorted(passthrough)
