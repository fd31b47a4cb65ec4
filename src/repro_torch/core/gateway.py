"""Differentiable partition boundaries — the runtime half of
Redundancy-Free Tree Partitioning (paper §3.3 + App. B).

Port of ``repro/core/gateway.py`` (:56-821).  A partition is a function
``(params, gw_in) → ((loss, captures), metrics)``
(``models/transformer.partition_loss``).  Its gateway ``gw_in`` holds,
per layer group, the ancestors' post-RoPE K/V {"g{i}": {"attn": {"k",
"v"}}} with leaves [L, B, A, Kh, hd]; an SSM group's chunk state and
conv or token-shift tail instead ({"ssm": {"state", "conv"}} for Mamba2
and GDN, {"tm": {"state", "shift"}, "cm": {"shift"}} for RWKV6, tails
[L, B, T, ·] with T ≤ max(1, conv taps)); and, for the hybrid, one
{"shared{s}": {"attn": …}} per application of its shared block.  Its
captures mirror the gateway per cut ("c{j}"): the K/V on the path
root → cut j, the state after the cut's chunk and the inputs on the
path's tail, which the child partition's gateway glues behind (or, for a
state, in place of) the parent's own.
Gradient Restoration runs the chain backwards: a child's gateway
cotangent splits into the part for the parent's ancestors (passed on, in
fp32) and the part for the parent's captures (seeded into the parent's
backward with its own loss).

Entry points:
  ``partitioned_value_and_grad``        one tree, depth-first B=1
                                        recursion: the live graphs are
                                        those of one root-to-leaf
                                        partition path (the paper's strict
                                        memory bound);
  ``build_partition_plan``              many trees → a ``PartitionPlan``
                                        (per-wave numpy batches, capture
                                        plans, gateway topology), executed
                                        by ``train/engine.run_partition_plan``;
  ``packed_partitioned_value_and_grad`` build the plan and run it.

The gateway is ancestor-compacted: exactly the ancestor tokens' rows are
gathered (host-planned), front-padded within a wave to a shared pow2
length whose padded slots are invisible (``anc_valid``).  Ancestor RoPE
positions travel as plain data (``anc_pos``), not differentiable inputs.
All routing below is plain tensor slicing at host-known offsets, outside
autograd, in a fixed order: no index is read back from the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import pack_partition_waves
from repro_torch.core.partition import TreePartition, partition_tree
from repro_torch.core.plan_cost import balanced_row_order, pow2
from repro_torch.core.tree import TrajectoryTree
from repro_torch.device import (DeviceLike, map_tree, resolve_device,
                                tree_leaves, unflatten_like)
from repro_torch.models.layers import prev_powers
from repro_torch.models.model import (chunk_size_of, device_batch,
                                      max_conv_taps, needs_chunks)
from repro_torch.models.transformer import partition_loss


def _taps(cfg: ModelConfig) -> int:
    """Tokens a conv or shift tail keeps: max(1, the conv's K − 1)."""
    return max(1, max_conv_taps(cfg))


# ---------------------------------------------------------------------------
# Host-side batch / capture planning per partition
# ---------------------------------------------------------------------------

def make_part_batch(cfg: ModelConfig, part: TreePartition,
                    chunk_size: Optional[int], anc_pos: np.ndarray, *,
                    device: DeviceLike = None) -> dict:
    """One partition as a B=1 batch on ``device`` (the CUDA device by
    default): its serialization, ancestor positions and boundary losses;
    for the SSM families also its ``chunk_parent`` (kept host) and
    ``prev_pows``, whose gateway slots −2, … chain."""
    ser = part.ser
    b: dict[str, Any] = {
        "tokens": ser.tokens[None],
        "pos_ids": ser.pos_ids[None],
        "kv_last": ser.kv_last[None],
        "weight": ser.weight[None],
        "prev_idx": ser.prev_idx[None],
        "valid": ser.valid[None],
        "anc_pos": anc_pos[None].astype(np.int32),
    }
    if needs_chunks(cfg):
        b["chunk_parent"] = ser.chunk_parent_map(chunk_size)[None]
        b["prev_pows"] = prev_powers(ser.prev_idx[None], _taps(cfg))
    if part.cuts:
        b["extra_pos"] = np.asarray(
            [[c.boundary_pos for c in part.cuts]], np.int32)
        b["extra_label"] = np.asarray(
            [[c.boundary_label for c in part.cuts]], np.int32)
        b["extra_weight"] = np.asarray(
            [[c.boundary_weight for c in part.cuts]], np.float32)
    return device_batch(b, resolve_device(device))


def make_capspecs(cfg: ModelConfig, part: TreePartition) -> dict:
    """Cut name → capture plan: ``path_idx`` the positions on the path
    root → cut, ``cut_chunk`` the chunk holding the cut's state,
    ``conv_pos``/``shift_pos`` the path's last conv taps / last token."""
    taps = _taps(cfg)
    specs = {}
    for i, c in enumerate(part.cuts):
        idx = np.asarray(c.path_token_idx, np.int32)
        specs[f"c{i}"] = {
            "path_idx": idx,
            "cut_chunk": np.int32(max(c.cut_chunk, 0)),
            "conv_pos": idx[-taps:],
            "shift_pos": idx[-1:],
        }
    return specs


def device_capspecs(capspecs: dict, device: torch.device,
                    seq_len: int) -> dict:
    """The capture plans as the model reads them: ``path_idx`` an int64
    tensor on ``device``, copied in without a device→host read,
    ``conv_pos``/``shift_pos`` views of its tail (a plan's are the tail of
    its ``path_idx``), and ``cut_chunk`` a host int (the chunk loop picks
    that state from its Python list).

    A wave's capture plans are front-padded with index 0 (the plan's
    bucketing); those entries are trimmed before any use and get zero
    cotangents.  All but the last leading 0 are pointed at distinct
    positions of the row (``seq_len`` long) instead: the capture's backward (a
    sorted accumulation) then has no run of thousands of one index to sum
    serially, and the sums are unchanged (only zeros move)."""
    def spread(idx):
        idx = idx.astype(np.int64)
        nz = np.flatnonzero(idx)
        lead = len(idx) if nz.size == 0 else int(nz[0])
        out = idx.copy()
        out[:max(lead - 1, 0)] = np.arange(max(lead - 1, 0)) % seq_len
        return out
    out = {}
    for name, spec in capspecs.items():
        idx = device_batch({"i": spread(spec["path_idx"])}, device)["i"]
        n = len(idx)
        out[name] = {"path_idx": idx, "cut_chunk": int(spec["cut_chunk"]),
                     "conv_pos": idx[n - len(spec["conv_pos"]):],
                     "shift_pos": idx[n - len(spec["shift_pos"]):]}
    return out


# ---------------------------------------------------------------------------
# Gateway assembly (parent → child) and cotangent routing (child → parent)
# ---------------------------------------------------------------------------

def _concat_tail(prev: Optional[torch.Tensor], cap: torch.Tensor,
                 keep: int) -> torch.Tensor:
    """Concat along the token axis (2) and keep the last ``keep``."""
    z = cap if prev is None else torch.cat([prev, cap], 2)
    return z[:, :, z.shape[2] - keep:] if z.shape[2] > keep else z


def _route_tail(prev_shape, cap_shape, keep: int, cot: torch.Tensor):
    """Transpose of ``_concat_tail``: the cotangents of (prev, cap) from
    the cotangent of the kept tail (whose last ``min(keep, T)`` entries
    are the kept ones; front padding before them is dropped)."""
    T_in = 0 if prev_shape is None else prev_shape[2]
    T = T_in + cap_shape[2]
    kept = min(keep, T)
    cz = cot.new_zeros(tuple(cap_shape[:2]) + (T,) + tuple(cap_shape[3:]))
    cz[:, :, T - kept:] = cot[:, :, cot.shape[2] - kept:]
    return (None if T_in == 0 else cz[:, :, :T_in]), cz[:, :, T_in:]


# the tail leaf of each SSM gateway kind, and how many tokens it keeps
_TAILS = {"ssm": "conv", "tm": "shift", "cm": "shift"}


def _keep(cfg: ModelConfig, kind: str) -> int:
    return _taps(cfg) if kind == "ssm" else 1


def assemble_child_gw(cfg: ModelConfig, gw_in: Optional[dict], caps: dict,
                      cut_name: str) -> dict:
    """The child's gateway at cut ``cut_name``: the parent's own ancestor
    K/V followed by the parent's captures on the path to the cut (token
    axis 2); the SSM state captured at the cut; the parent's conv or shift
    tail followed by its captured path tail, cut to the last ``keep``
    tokens."""
    child: dict = {}
    for gkey, group_caps in caps.items():
        if not group_caps:
            continue
        gw_g = (gw_in or {}).get(gkey, {})
        cg: dict = {}
        for kind, cuts in group_caps.items():
            cap, prev = cuts[cut_name], gw_g.get(kind)
            if kind == "attn":
                cg[kind] = {t: (cap[t] if prev is None
                                else torch.cat([prev[t], cap[t]], 2))
                            for t in ("k", "v")}
                continue
            tail = _TAILS[kind]
            cg[kind] = {"state": cap["state"]} if "state" in cap else {}
            cg[kind][tail] = _concat_tail(None if prev is None
                                          else prev[tail], cap[tail],
                                          _keep(cfg, kind))
        child[gkey] = cg
    return child


def route_child_cot(cfg: ModelConfig, gw_in: Optional[dict], caps: dict,
                    cut_name: str, cot_child: dict,
                    cot_gw_acc: Optional[dict], cot_caps: dict):
    """Transpose of ``assemble_child_gw``: split the child's gateway
    cotangent into the pass-through ancestors (added to this partition's
    gateway cotangent, in fp32) and this partition's capture cotangents.
    Updates ``cot_caps`` (and ``cot_gw_acc``) in place; returns
    ``cot_gw_acc``."""
    for gkey, cg in cot_child.items():
        gw_g = (gw_in or {}).get(gkey, {})
        for kind, ck in cg.items():
            prev = gw_g.get(kind)
            tgt = cot_caps[gkey][kind][cut_name]
            if kind == "attn":
                A_in = 0 if prev is None else prev["k"].shape[2]
                for t in ("k", "v"):
                    cot = ck[t]
                    if A_in:
                        cot_gw_acc[gkey][kind][t] = (
                            cot_gw_acc[gkey][kind][t]
                            + cot[:, :, :A_in].float())
                    tgt[t] = tgt[t] + cot[:, :, A_in:]
                continue
            if "state" in ck:
                tgt["state"] = map2(lambda a, b: a + b.to(a.dtype),
                                    tgt["state"], ck["state"])
            tail = _TAILS[kind]
            cgw, cc = _route_tail(None if prev is None else prev[tail].shape,
                                  caps[gkey][kind][cut_name][tail].shape,
                                  _keep(cfg, kind), ck[tail])
            if cgw is not None:
                cot_gw_acc[gkey][kind][tail] = (
                    cot_gw_acc[gkey][kind][tail] + cgw.float())
            tgt[tail] = tgt[tail] + cc
    return cot_gw_acc


def _zeros_f32(tree):
    return map_tree(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                          device=a.device), tree)


def _live(tree):
    """Detached aliases of every leaf that require grad: the inputs one
    autograd pass differentiates against."""
    return map_tree(lambda t: t.detach().requires_grad_(True), tree)


def grad_slots(params: dict) -> list:
    """An empty fp32 gradient accumulator: one slot per leaf of ``params``
    (``tree_leaves`` order), None until a backward first reaches that
    leaf, so no slot is held before its first gradient exists."""
    return [None] * len(tree_leaves(params))


def acc_add(acc: list, i: int, g: torch.Tensor) -> None:
    """Add ``g`` into slot ``i`` in fp32 (a bf16 gradient converts
    exactly); an empty slot takes an fp32 copy of ``g`` (0 + g ≡ g)."""
    if acc[i] is None:
        acc[i] = g.to(torch.float32, copy=True)
    else:
        acc[i].add_(g)


def acc_tree(params: dict, acc: list) -> dict:
    """The accumulator as a tree shaped like ``params``: fp32 leaves, zeros
    where no backward reached."""
    return unflatten_like(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if a is None else a for p, a in zip(tree_leaves(params), acc)])


def partition_vjp(cfg: ModelConfig, params: dict, batch: dict,
                  gw: Optional[dict], capspecs: dict, impl: str,
                  cot_loss, cot_caps: Optional[dict], acc: list, *,
                  forward=None):
    """One partition's backward for the output cotangents (``cot_loss`` on
    the loss, ``cot_caps`` on the captures): each parameter's grad is added
    into its ``acc`` slot (``grad_slots``) as soon as the backward has
    produced it, so no full set of grads in the parameters' dtype is ever
    held; returns the grads of ``gw`` (zeros where unused).  ``forward`` is
    an already recorded ``(params_live, gw_live, loss, caps)`` (the packed
    rows pass their loss and no captures); without it the partition's
    forward is recomputed here (remat)."""
    if forward is None:
        p_live = _live(params)
        g_live = None if gw is None else _live(gw)
        with torch.enable_grad():
            (loss, caps), _ = partition_loss(cfg, p_live, batch, g_live,
                                             capspecs, impl)
    else:
        p_live, g_live, loss, caps = forward
    outs, cots = [loss], [cot_loss]
    if cot_caps:
        outs += tree_leaves(caps)
        cots += tree_leaves(cot_caps)

    def into(i):
        def hook(p):
            acc_add(acc, i, p.grad)
            p.grad = None
        return hook

    p_leaves = tree_leaves(p_live)
    handles = [p.register_post_accumulate_grad_hook(into(i))
               for i, p in enumerate(p_leaves)]
    g_leaves = [] if g_live is None else tree_leaves(g_live)
    try:
        torch.autograd.backward(outs, cots, inputs=p_leaves + g_leaves)
    finally:
        for h in handles:
            h.remove()
    if g_live is None:
        return None
    return _unflatten(g_live, [torch.zeros_like(x) if x.grad is None
                               else x.grad for x in g_leaves])


def _unflatten(tree, leaves):
    it = iter(leaves)
    return map_tree(lambda _: next(it), _sorted_like(tree))


def map2(fn, a, b):
    """``fn`` over the paired leaves of two trees of one structure."""
    if isinstance(a, dict):
        return {k: map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _sorted_like(tree):
    """``tree`` with its dict keys in ``flatten_tree`` order, so
    ``map_tree`` visits leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _sorted_like(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_like(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# The partitioned train-step driver (one tree, depth-first)
# ---------------------------------------------------------------------------

def partitioned_value_and_grad(
    cfg: ModelConfig,
    params: dict,
    tree: TrajectoryTree,
    capacity: int,
    *,
    impl: str = "kernel",
    loss_mode: str = "sep_avg",
) -> tuple[float, dict, dict]:
    """Loss + grads for ONE tree with ≤capacity tokens resident per
    partition — every token computed exactly once (paper Fig. 5, right).
    A partition's autograd graph stays alive while its children run, so
    the live graphs are those of one root-to-leaf partition path.

    Returns (loss, grads (float32, on the parameters' device), info)."""
    dev = tree_leaves(params)[0].device
    chunk_size = chunk_size_of(cfg)
    parts = partition_tree(tree, capacity, chunk_size=chunk_size,
                           loss_mode=loss_mode)
    grads_acc = grad_slots(params)
    tot = torch.zeros(3, dtype=torch.float32, device=dev)
    info = {"num_partitions": len(parts),
            "tokens": sum(p.ser.n for p in parts)}

    def process(pid: int, gw_in: Optional[dict], anc_pos: np.ndarray):
        nonlocal tot
        part = parts[pid]
        batch = make_part_batch(cfg, part, chunk_size, anc_pos, device=dev)
        capspecs = make_capspecs(cfg, part)
        p_live = _live(params)
        g_live = None if gw_in is None else _live(gw_in)
        with torch.enable_grad():
            (loss, caps), metrics = partition_loss(
                cfg, p_live, batch, g_live,
                device_capspecs(capspecs, dev, part.ser.n), impl)
        tot = tot + torch.stack([loss.detach().float(),
                                 metrics["nll_sum"].detach().float(),
                                 metrics["weight_sum"].detach().float()])
        caps_d = map_tree(lambda t: t.detach(), caps)
        cot_gw_acc = None if gw_in is None else _zeros_f32(gw_in)
        cot_caps = map_tree(torch.zeros_like, caps_d)
        for i, cut in enumerate(part.cuts):
            cname = f"c{i}"
            child_gw = assemble_child_gw(cfg, gw_in, caps_d, cname)
            child_anc = np.concatenate(
                [anc_pos, part.ser.pos_ids[cut.path_token_idx]])
            cot_child = process(cut.child_pid, child_gw, child_anc)
            cot_gw_acc = route_child_cot(cfg, gw_in, caps_d, cname,
                                         cot_child, cot_gw_acc, cot_caps)
        g_gw = partition_vjp(
            cfg, params, batch, gw_in, None, impl, torch.ones_like(loss),
            cot_caps, grads_acc, forward=(p_live, g_live, loss, caps))
        if gw_in is None:
            return None
        return map2(lambda own, acc: (own.float() + acc).to(own.dtype),
                    g_gw, cot_gw_acc)

    process(0, None, np.zeros((0,), np.int32))
    del process     # it refers to itself: break the cycle holding grads_acc
    loss, nll_sum, weight_sum = tot.tolist()
    info["weight_sum"] = weight_sum
    info["nll_sum"] = nll_sum
    return loss, acc_tree(params, grads_acc), info


# ---------------------------------------------------------------------------
# Batched wave-scheduled planning (Tree Packing over partitions, §3.3–3.4)
#
# The recursive driver runs one partition at a time (B=1).  Training
# batches MANY trees' partitions per step: the wave scheduler packs every
# partition of every tree into per-wave [B, S] rows
# (core/packing.pack_partition_waves); ``build_partition_plan`` turns that
# into a pure-host PartitionPlan, and train/engine.run_partition_plan runs
#
#   forward  waves 0..W−1 without autograd: a child's gateway is assembled
#            per row from its parent's captures (the parent is always in
#            an earlier wave);
#   backward waves W−1..0: children's gateway cotangents are routed to
#            their parents' capture cotangents per row, then the wave's
#            forward is recomputed with autograd and backpropagated.
#
# Rows in a wave have different ancestor depths and cut plans, so gateway
# tensors are front-padded to a shared (pow2-bucketed) ancestor length —
# padded slots are invisible (anc_valid) — and capture plans are
# front-padded index arrays whose padded entries are trimmed before use.
# ---------------------------------------------------------------------------

_pow2 = pow2


def _pad_rows(a: np.ndarray, Bb: int, fill) -> np.ndarray:
    if a.shape[0] == Bb:
        return a
    pad = np.full((Bb - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _pad_tok(a: torch.Tensor, T: int) -> torch.Tensor:
    """Front-pad the token axis (2) with zeros to length T."""
    t = a.shape[2]
    if t >= T:
        return a[:, :, t - T:]
    z = a.new_zeros(a.shape[:2] + (T - t,) + a.shape[3:])
    return torch.cat([z, a], dim=2)


def _slice_gw_row(gw: dict, r: int, A_real: int) -> dict:
    """Row r of a stacked wave gateway, the ancestor K/V stripped of its
    front padding (a conv or shift tail keeps its padding: it reads as
    out-of-range zeros)."""
    out: dict = {}
    for gkey, g in gw.items():
        out[gkey] = {}
        for kind, sub in g.items():
            if kind == "attn":
                out[gkey][kind] = {t: sub[t][:, r:r + 1,
                                             sub[t].shape[2] - A_real:]
                                   for t in ("k", "v")}
            else:
                out[gkey][kind] = map_tree(lambda a: a[:, r:r + 1], sub)
    return out


def _stack_gw_rows(rows: list[dict], A_max: int, Bb: int,
                   rows_idx: Optional[list[int]] = None) -> dict:
    """Stack per-row (B=1) gateways along the row axis, front-padding the
    ancestors to A_max and the conv/shift tails to the wave's longest, and
    adding zero rows up to Bb.  ``rows_idx`` scatters entry i to row
    ``rows_idx[i]`` (the wave's load-balance permutation); omitted, entry
    i lands at row i."""
    src: list[Optional[int]] = list(range(len(rows))) \
        + [None] * (Bb - len(rows))
    if rows_idx is not None:
        src = [None] * Bb
        for i, r in enumerate(rows_idx):
            src[r] = i

    def catB(vals):
        z = vals[0].new_zeros(vals[0].shape[:1] + (1,) + vals[0].shape[2:])
        return torch.cat([z if i is None else vals[i] for i in src], 1)

    out: dict = {}
    for gkey, g0 in rows[0].items():
        out[gkey] = {}
        for kind, sub0 in g0.items():
            sub: dict = {}
            for leaf in sub0:
                vals = [r[gkey][kind][leaf] for r in rows]
                if kind == "attn" or leaf in ("conv", "shift"):
                    T = A_max if kind == "attn" else \
                        max(v.shape[2] for v in vals)
                    sub[leaf] = catB([_pad_tok(v, T) for v in vals])
                else:           # "state": {name: [L, 1, …]}, no token axis
                    sub[leaf] = {k: catB([v[k] for v in vals])
                                 for k in vals[0]}
            out[gkey][kind] = sub
    return out


def _wave_capspecs(cfg: ModelConfig, cuts: list, taps: int) -> dict:
    """Bucketed, front-padded capture plans for one wave (host arrays).

    Padded entries index position 0; their captures are trimmed before any
    use and receive zero cotangents, so they are inert."""
    if not cuts:
        return {}
    plen_b = _pow2(max(len(c.path_idx) for c in cuts))
    ncut_b = _pow2(len(cuts))
    specs = {}
    for i in range(ncut_b):
        if i < len(cuts):
            idx = np.asarray(cuts[i].path_idx, np.int32)
            pad = np.concatenate(
                [np.zeros(plen_b - len(idx), np.int32), idx])
            cc = np.int32(max(cuts[i].cut_chunk, 0))
        else:
            pad = np.zeros(plen_b, np.int32)
            cc = np.int32(0)
        specs[f"c{i}"] = {"path_idx": pad, "cut_chunk": cc,
                          "conv_pos": pad[-taps:], "shift_pos": pad[-1:]}
    return specs


def _cut_caps_view(cfg: ModelConfig, caps: dict, cname: str, r: int,
                   true_len: int) -> dict:
    """Row r's capture for one cut, trimmed to its real (unpadded) token
    entries — the exact tensors a child partition's gateway glues in."""
    creal = min(_taps(cfg), true_len)
    out: dict = {}
    for gkey, g in caps.items():
        h: dict = {}
        for kind, cuts in g.items():
            if cname not in cuts:
                continue
            c = cuts[cname]
            if kind == "attn":
                h[kind] = {cname: {t: c[t][:, r:r + 1,
                                           c[t].shape[2] - true_len:]
                                   for t in ("k", "v")}}
                continue
            v = {}
            if "state" in c:
                v["state"] = map_tree(lambda a: a[:, r:r + 1], c["state"])
            if "conv" in c:
                v["conv"] = c["conv"][:, r:r + 1, c["conv"].shape[2] - creal:]
            if "shift" in c:
                v["shift"] = c["shift"][:, r:r + 1]
            h[kind] = {cname: v}
        if h:
            out[gkey] = h
    return out


def _add_row(full: torch.Tensor, part: torch.Tensor, r: int) -> None:
    """full[:, r, T − t:] += part[:, 0], in place: a per-row slice, whose
    axis 2 (tokens, or a state's heads) holds the last t of T, added back
    at its front-padded place."""
    full[:, r, full.shape[2] - part.shape[2]:] += part[:, 0].to(full.dtype)


def _embed_cut_cot(cot_caps: dict, cot_view: dict, cname: str, r: int
                   ) -> None:
    """Add a trimmed per-cut cotangent (mirror of _cut_caps_view) into the
    wave-level capture cotangent, in place."""
    for gkey, g in cot_view.items():
        for kind, cuts in g.items():
            map2(lambda full, part: _add_row(full, part, r),
                 cot_caps[gkey][kind][cname], cuts[cname])


def _embed_gw_row_cot(acc: dict, row_cot: dict, r: int) -> dict:
    """Add a per-row gateway cotangent (stripped shapes) into the stacked
    wave accumulator at row r (front-padded axes), in place."""
    for gkey, g in acc.items():
        map2(lambda full, part: _add_row(full, part, r), g, row_cot[gkey])
    return acc


@dataclass
class GatewayRef:
    """Where one gateway-bearing fragment's parent captures live: wave
    index, cut index within that wave (cname = f"c{cut}"), the parent's
    row, and the real (unpadded) captured path length."""
    wave: int
    cut: int
    row: int
    path_len: int


@dataclass
class WavePlan:
    """Host-side plan for ONE wave: fixed-shape numpy batch columns (rows
    already padded to the pow2 bucket), bucketed capture plans, and the
    gateway topology — everything the executor needs except the runtime
    capture tensors themselves."""
    batch: dict[str, np.ndarray]          # [Bb, S] columns (+anc_*, extra_*)
    capspecs: dict                        # bucketed runtime index arrays
    has_gw: bool
    num_rows: int                         # real rows (before pow2 padding)
    parents: list[GatewayRef] = field(default_factory=list)  # per slot
    slot_rows: list[int] = field(default_factory=list)       # slot → row
    A_real: list[int] = field(default_factory=list)          # per row [Bb]
    anc_A_max: int = 0                    # bucketed ancestor length
    anc_pos_rows: list[np.ndarray] = field(default_factory=list)  # per row


@dataclass
class PartitionPlan:
    """Plan for the partitioned share of one step: waves in topological
    order (parents strictly earlier), ready for the engine's forward and
    backward sweeps (train/engine.run_partition_plan)."""
    waves: list[WavePlan]
    num_trees: int
    info: dict


def build_partition_plan(
    cfg: ModelConfig,
    trees: list[TrajectoryTree],
    capacity: int,
    *,
    seq_len: Optional[int] = None,
    loss_mode: str = "sep_avg",
    max_rows: Optional[int] = None,
    row_multiple: int = 1,
    forest: Optional[list[list[TreePartition]]] = None,
) -> PartitionPlan:
    """Plan (host-side only) the wave-scheduled partitioned execution of
    MANY oversized trees: partition each tree, pack every partition into
    per-wave [B, S] rows, pad/bucket every shape, precompute ancestor
    positions and capture plans, and record the gateway topology.  No
    device work happens here; ``train/engine.run_partition_plan`` executes
    the plan.

    ``row_multiple`` rounds every wave's bucketed row count up to a
    multiple (the data-axis size); ``forest`` passes precomputed
    partitions (the planner partitions each tree exactly once)."""
    chunk_size = chunk_size_of(cfg)
    seq_len = capacity if seq_len is None else seq_len
    assert capacity <= seq_len, (capacity, seq_len)
    taps = _taps(cfg)
    info: dict[str, Any] = {"num_trees": len(trees)}
    if not trees:
        return PartitionPlan(waves=[], num_trees=0, info=info)

    if forest is None:
        forest = [partition_tree(t, capacity, chunk_size=chunk_size,
                                 loss_mode=loss_mode) for t in trees]
    assert len(forest) == len(trees)
    waves = pack_partition_waves(forest, seq_len, chunk_size=chunk_size,
                                 max_rows=max_rows)
    cut_of_child: dict[tuple[int, int], tuple[int, int]] = {}
    for w, wv in enumerate(waves):
        for ci, c in enumerate(wv.cuts):
            cut_of_child[(c.tree, c.child_pid)] = (w, ci)

    info.update(num_partitions=sum(len(p) for p in forest),
                num_waves=len(waves),
                rows=sum(wv.num_rows for wv in waves),
                max_wave_rows=max(wv.num_rows for wv in waves),
                tokens=sum(p.ser.n for ps in forest for p in ps),
                unique_tokens=sum(int(p.ser.valid.sum())
                                  for ps in forest for p in ps))

    plans: list[WavePlan] = []
    rowmaps: list[np.ndarray] = []     # per wave: packer row → balanced row
    cells = 0
    for wv in waves:
        B = wv.num_rows
        # bucket in per-replica units: identical to pow2 for power-of-two
        # replica counts, never inflating past ~the max_rows budget
        Bb = row_multiple * _pow2(-(-B // row_multiple))
        cells += Bb * seq_len
        a = wv.arrays
        batch = {
            "tokens": _pad_rows(a["tokens"], Bb, 0),
            "pos_ids": _pad_rows(a["pos_ids"], Bb, 0),
            "kv_last": _pad_rows(a["kv_last"], Bb, -1),
            "weight": _pad_rows(a["weight"], Bb, 0),
            "prev_idx": _pad_rows(a["prev_idx"], Bb, -1),
            "valid": _pad_rows(a["valid"], Bb, False),
        }
        if chunk_size is not None:
            batch["chunk_parent"] = _pad_rows(a["chunk_parent"], Bb, -1)
            batch["prev_pows"] = prev_powers(batch["prev_idx"], taps)
        if wv.cuts:
            Eb = _pow2(max(sum(1 for c in wv.cuts if c.row == r)
                           for r in range(B)))
            pos = np.zeros((Bb, Eb), np.int32)
            lab = np.zeros((Bb, Eb), np.int32)
            wgt = np.zeros((Bb, Eb), np.float32)
            cnt = [0] * B
            for c in wv.cuts:
                j = cnt[c.row]
                cnt[c.row] += 1
                pos[c.row, j] = c.boundary_pos
                lab[c.row, j] = c.boundary_label
                wgt[c.row, j] = c.boundary_weight
            batch["extra_pos"] = pos
            batch["extra_label"] = lab
            batch["extra_weight"] = wgt
        capspecs = _wave_capspecs(cfg, wv.cuts, taps)

        # waves are depth-homogeneous: either all root fragments (no
        # gateway) or all gateway-bearing; parents may sit several waves
        # back once a too-wide depth level is split under max_rows
        has_gw = forest[wv.slots[0].tree][wv.slots[0].pid].parent_pid >= 0
        parents: list[GatewayRef] = []
        A_max = 0
        anc_pos_rows: list[np.ndarray] = \
            [np.zeros((0,), np.int32) for _ in range(Bb)]
        if has_gw:
            # wave ≥ 1: one fragment per row, slot i at packer row i
            for sl in wv.slots:
                wp, ci = cut_of_child[(sl.tree, sl.pid)]
                c = waves[wp].cuts[ci]
                prow = int(rowmaps[wp][c.row])
                parents.append(GatewayRef(wave=wp, cut=ci, row=prow,
                                          path_len=len(c.path_idx)))
                anc_pos_rows[sl.row] = np.concatenate(
                    [plans[wp].anc_pos_rows[prow],
                     waves[wp].arrays["pos_ids"][c.row, c.path_idx]]
                ).astype(np.int32)
                assert len(anc_pos_rows[sl.row]) == \
                    forest[sl.tree][sl.pid].anc_len
            # lo=8 front padding, as the reference buckets ancestors (the
            # plans must match); the kernels skip the all-invisible tiles
            A_max = _pow2(max(len(p) for p in anc_pos_rows), lo=8)
            anc_pos = np.zeros((Bb, A_max), np.int32)
            anc_valid = np.zeros((Bb, A_max), bool)
            for r, p in enumerate(anc_pos_rows):
                anc_pos[r, A_max - len(p):] = p
                anc_valid[r, A_max - len(p):] = True
            batch["anc_pos"] = anc_pos
            batch["anc_valid"] = anc_valid

        # wave-level replica balance: a pure row permutation (identity when
        # row_multiple ≤ 1); the gateway topology is remapped alongside
        loads = [int(batch["valid"][r].sum()) + len(anc_pos_rows[r])
                 for r in range(Bb)]
        order = balanced_row_order(loads, row_multiple)
        new_of = np.empty(Bb, np.int64)
        new_of[np.asarray(order)] = np.arange(Bb)
        if order != list(range(Bb)):
            batch = {k: v[np.asarray(order)] for k, v in batch.items()}
            anc_pos_rows = [anc_pos_rows[r] for r in order]
        rowmaps.append(new_of)

        plans.append(WavePlan(batch=batch, capspecs=capspecs,
                              has_gw=has_gw, num_rows=B, parents=parents,
                              slot_rows=[int(new_of[sl.row])
                                         for sl in wv.slots],
                              A_real=[len(p) for p in anc_pos_rows],
                              anc_A_max=A_max,
                              anc_pos_rows=anc_pos_rows))

    info["cells"] = cells     # materialized row cells (bucketed rows × S)
    return PartitionPlan(waves=plans, num_trees=len(trees), info=info)


def packed_partitioned_value_and_grad(
    cfg: ModelConfig,
    params: dict,
    trees: list[TrajectoryTree],
    capacity: int,
    *,
    seq_len: Optional[int] = None,
    impl: str = "kernel",
    loss_mode: str = "sep_avg",
    max_rows: Optional[int] = None,
) -> tuple[float, dict, dict]:
    """Loss-*sum* + grads for MANY trees via wave-scheduled Tree Packing
    over partitions: build a PartitionPlan and execute it through the
    engine's wave executor (``train/engine.run_partition_plan``).  Every
    token of every tree is computed exactly once, with ≤ ``seq_len``
    tokens per row; ``max_rows`` caps every wave's row count.

    Returns ``(loss_sum, grads (float32), info)``; divide by the number of
    trees to match ``loss_and_metrics``'s mean-over-trees normalizer."""
    from repro_torch.train.engine import run_partition_plan

    plan = build_partition_plan(cfg, trees, capacity, seq_len=seq_len,
                                loss_mode=loss_mode, max_rows=max_rows)
    grads_acc = grad_slots(params)
    if not plan.waves:
        return 0.0, acc_tree(params, grads_acc), plan.info
    dev = tree_leaves(params)[0].device
    scal = torch.zeros(3, dtype=torch.float32, device=dev)
    grads_acc, scal = run_partition_plan(cfg, params, plan, grads_acc, scal,
                                         impl=impl, loss_scale=1.0)
    # one host read for the scalars (loss reporting + per-token nll)
    total_loss, nll_sum, weight_sum = scal.tolist()
    info = dict(plan.info)
    info["weight_sum"] = weight_sum
    info["nll_sum"] = nll_sum
    return total_loss, acc_tree(params, grads_acc), info
