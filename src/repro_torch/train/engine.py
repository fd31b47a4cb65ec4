"""Tree-ingest training engine: one plan→execute loop.

Port of ``repro/train/engine.py``.  Every step is an ``ExecutionPlan``: the
packed rows (one forward/backward) followed by the partition waves of the
oversized trees (``run_partition_plan``, Tree Packing over partitions).
``TreeTrainEngine.step`` streams every execution's gradients, leaf by
leaf as each backward produces them, into one fp32 accumulator whose slots
exist from their first gradient on (``core/gateway.grad_slots``), applies
AdamW, and performs **exactly one** device→host transfer
(the logging vector, through ``_sync``, counted in ``host_syncs``).  Loss,
token-CE sum and weight sum accumulate in one device vector.  Host (numpy)
plan arrays are copied to the parameters' device inside the step,
non-blocking, so no copy waits on the device.  ``loss_mode="rl"`` rides
the per-token weights the serializer threads through, so one engine serves
SFT and the RL update.  With a ``weight_store`` (``serve/service``) the
engine audits each plan's off-policy lag and publishes the updated weights
after every step: a device copy, no host sync.

With an ``exec_cache`` (``train/exec_cache.ExecutableCache``, filled by
``train/warmup.AOTWarmupService`` and the planner's pre-warm hook) every
dispatch (``packed``, ``packed+acc``, ``wave.fwd``, ``wave.bwd``,
``update``) first resolves its executable by (variant, signature,
fingerprint): a hit runs it with nothing left to build; a miss makes it on
the spot (the kernels' ``nvcc`` builds and loads), counted in ``retraces``
with the stall in ``compile_wait_s``, and an out-of-universe signature is
logged.  A wave's fingerprint is taken from its host-side columns and
capture plans (``wave_key_args``), which determine the gateway and the
device tensors built from them.

On a data axis (``sharding.use_mesh``, one process a device) every rank
runs its contiguous block of each execution's rows (``models/model.
rank_rows``) with the step's global tree count, so the sum over ranks of
the losses and grads is the whole step's.  ``accumulate`` then sums the
fp32 grad slots and the scalar vector over the axis (``_reduce``: a fixed
list of buckets in ``tree_leaves`` order, a slot no local backward reached
entering as zeros), so every rank applies the same update and the
parameters stay bit-equal across ranks.  The wave executor exchanges a
wave's captures (all-gather along rows, after its forward) and the
cotangents routed onto them (reduce-scatter along rows, before its
backward), so a child's parent may sit on any rank.  No collective reads
a device value on the host: the step keeps its one host sync.

On a model axis (the dense and MoE families, ``sharding.py``) every rank
holds its blocks of the parameters (an MoE layer's its block of the
experts), so the grad slots are its blocks' gradients.
The rows a rank runs are its data block (the model axis's ranks run the
same rows), the captures and gateways hold the rank's KV heads, and the
exchanges above stay on the data axis, as does the MoE layer's count
all-gather.  ``_reduce`` then also sums over the model axis the
replicated leaves whose gradients are the ranks' shares
(``sharding.model_partial``: the MoE router's among them).
"""
from __future__ import annotations

import functools
import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gateway import (PartitionPlan, _cut_caps_view,
                                      _embed_cut_cot, _embed_gw_row_cot,
                                      _live, _slice_gw_row, _stack_gw_rows,
                                      _zeros_f32, acc_tree, assemble_child_gw,
                                      device_capspecs, grad_slots, map2,
                                      partition_vjp, route_child_cot)
from repro_torch.core.plan_cost import packed_signature, wave_signature_of
from repro_torch.device import (flatten_tree, map_tree, tree_leaves,
                               unflatten_like)
from repro_torch.models.model import device_batch, rank_rows, row_block
from repro_torch.models.transformer import loss_and_metrics, partition_loss
from repro_torch.sharding import (DataAxis, data_axis, model_axis,
                                  model_partial)
from repro_torch.train.exec_cache import ExecutableCache, exec_key, executable
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import update

logger = logging.getLogger(__name__)

# the on-device scalar accumulator: [loss, nll_sum, weight_sum]
NUM_SCALARS = 3

# the largest bucket of small fp32 grad slots the data axis sums in one
# collective (a larger slot is summed in place, alone)
BUCKET_BYTES = 64 << 20
# the profiler range around that sum (its device time is read from it)
REDUCE_SPAN = "engine.data_axis_reduce"


@dataclass
class PackedExec:
    """One uniform [B, S] microbatch execution (the packed rows)."""
    inputs: dict                 # model inputs: host arrays or tensors
    tokens: int = 0              # host-side unique-token count (logging)
    cells: int = 0               # materialized row cells (B × S)


@dataclass
class ExecutionPlan:
    """Everything one optimizer step trains on, in execution order: the
    packed microbatch (if any) followed by the partition waves of the
    oversized trees (if any).  Built host-side by the planner
    (``train/planner``) — the engine only executes."""
    packed: Optional[PackedExec] = None
    partition: Optional[PartitionPlan] = None
    num_trees: int = 0           # packed + oversized (loss normalizer)
    dropped: int = 0             # trees lost this step (no auto-partition)
    versions: Optional[tuple] = None   # (min, max) weight_version of the
    #                              step's trees (async RL staleness; None
    #                              for offline/synthetic sources)

    @property
    def has_waves(self) -> bool:
        return self.partition is not None and bool(self.partition.waves)

    @property
    def is_empty(self) -> bool:
        return self.packed is None and not self.has_waves

    @property
    def num_oversized(self) -> int:
        return 0 if self.partition is None else self.partition.num_trees

    @property
    def unique_tokens(self) -> int:
        n = 0 if self.packed is None else self.packed.tokens
        if self.has_waves:
            n += self.partition.info["unique_tokens"]
        return n

    @property
    def padded_tokens(self) -> int:
        """Materialized row cells holding no unique token."""
        cells = 0 if self.packed is None else self.packed.cells
        if self.has_waves:
            cells += self.partition.info.get("cells", 0)
        return cells - self.unique_tokens

    @property
    def num_executions(self) -> int:
        n = 0 if self.packed is None else 1
        if self.partition is not None:
            n += len(self.partition.waves)
        return n


def _scal_add(scal, loss, metrics):
    return scal + torch.stack([loss.float(), metrics["nll_sum"].float(),
                               metrics["weight_sum"].float()])


def _packed_exec_fn(cfg: ModelConfig, impl: str):
    """Packed microbatch: the forward, then one backward that streams each
    parameter's grad into its fp32 slot of ``acc`` (``grad_slots``) as the
    backward produces it, through the wave executor's ``partition_vjp``
    (no captures, no gateway), and the scalars into ``scal``."""
    def f(params, batch, acc, scal):
        live = _live(params)
        with torch.enable_grad():
            loss, metrics = loss_and_metrics(cfg, live, batch, impl)
        partition_vjp(cfg, params, batch, None, None, impl,
                      torch.ones_like(loss), None, acc,
                      forward=(live, None, loss, None))
        return acc, _scal_add(scal, loss.detach(),
                              {k: v.detach() for k, v in metrics.items()})

    return f


def _wave_fwd_fn(cfg: ModelConfig, impl: str):
    """One wave's forward (run under ``no_grad``): its captures out, the
    loss (scaled by ``loss_scale``), token-CE and weight sums added to
    ``scal``."""
    def fwd(params, batch, gw, capspecs, scal, loss_scale):
        (loss, caps), metrics = partition_loss(cfg, params, batch, gw,
                                               capspecs, impl)
        return caps, scal + torch.stack([loss.float() * loss_scale,
                                         metrics["nll_sum"].float(),
                                         metrics["weight_sum"].float()])

    return fwd


def _wave_bwd_fn(cfg: ModelConfig, impl: str):
    """One wave's backward: the forward recomputed with autograd and
    backpropagated from the loss's and the captures' cotangents into
    ``acc``; returns the gateway's gradient."""
    def bwd(params, batch, gw, capspecs, cot_loss, cot_caps, acc):
        return partition_vjp(cfg, params, batch, gw, capspecs, impl,
                             cot_loss, cot_caps, acc)

    return bwd


def variant_fn(variant: str, cfg: ModelConfig, impl: str,
               opt_cfg: Optional[OptimizerConfig] = None) -> Callable:
    """The eager function behind one dispatch variant: what an
    ``ExecutableCache`` key holds once its kernels are loaded."""
    if variant in ("packed", "packed+acc"):
        return _packed_exec_fn(cfg, impl)
    if variant == "wave.fwd":
        return _wave_fwd_fn(cfg, impl)
    if variant == "wave.bwd":
        return _wave_bwd_fn(cfg, impl)
    if variant == "update":
        return functools.partial(update, opt_cfg)
    raise ValueError(f"unknown dispatch variant {variant!r}")


def packed_key_args(params, plan: "ExecutionPlan") -> tuple:
    """What the packed execution is keyed by: the parameters and the
    plan's host columns with the step's ``num_trees``."""
    batch = dict(plan.packed.inputs)
    batch["num_trees"] = max(plan.num_trees, 1)
    return (params, batch)


def wave_key_args(params, wp) -> tuple:
    """What a wave's executions are keyed by: the parameters and the
    wave's host-side columns and capture plans.  The gateway it reads and
    the device tensors built from them are functions of these, so the key
    needs no tensor the forward sweep makes."""
    return (params, wp.batch, wp.capspecs)


# ---------------------------------------------------------------------------
# The data axis
# ---------------------------------------------------------------------------

def _local_rows(batch: dict, axis: Optional[DataAxis]) -> dict:
    return batch if axis is None else rank_rows(batch, axis.rank, axis.size)


def _rows(tree, lo: int, hi: int):
    """Rows [lo, hi) of a wave's gateway, captures or their cotangents
    (row axis 1 of every leaf: [L, B, …])."""
    return map_tree(lambda a: a[:, lo:hi], tree)


def _gather_rows(tree, axis: DataAxis):
    """Every rank's rows of ``tree`` (leaves [L, B/R, …]), concatenated
    in rank order along the row axis: the wave's captures as one rank
    holding all its rows would have them."""
    def one(t):
        parts = [torch.empty_like(t) for _ in range(axis.size)]
        dist.all_gather(parts, t.contiguous(), group=axis.group)
        return torch.cat(parts, dim=1)
    return unflatten_like(tree, [one(t) for t in tree_leaves(tree)])


# reduce-scatter of one tensor (``reduce_scatter_tensor`` before torch 2.13)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          None) or dist.reduce_scatter_tensor


def _sum_rows(tree, axis: DataAxis, lo: int, hi: int):
    """Rows [lo, hi) of every leaf of ``tree`` (leaves [L, B, …]) summed
    over the data axis: one reduce-scatter a leaf along the rows, in
    ``tree_leaves`` order (the same list of collectives on every rank), so
    a rank receives only its own block of the sum."""
    def one(t):
        x = t.movedim(1, 0).contiguous()
        out = x.new_empty((hi - lo,) + tuple(x.shape[1:]))
        _reduce_scatter(out, x, group=axis.group)
        return out.movedim(0, 1)
    return unflatten_like(tree, [one(t) for t in tree_leaves(tree)])


def _buckets(ts: list, limit: int = BUCKET_BYTES) -> list:
    """Consecutive runs of ``ts`` of at most ``limit`` bytes (a larger
    tensor alone)."""
    out, cur, size = [], [], 0
    for t in ts:
        nb = t.numel() * t.element_size()
        if cur and size + nb > limit:
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nb
    if cur:
        out.append(cur)
    return out


def _all_reduce(ts: list, group) -> None:
    """Sum each tensor of ``ts`` over ``group`` in place, in buckets of up
    to ``BUCKET_BYTES`` (a larger tensor alone)."""
    for bucket in _buckets(ts):
        if len(bucket) == 1:
            dist.all_reduce(bucket[0], group=group)
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def _reduce(params, acc: list, scal: torch.Tensor, axis: DataAxis):
    """Sum the fp32 grad slots and the scalar vector over the data axis,
    in place; on a model axis then the slots of the replicated leaves
    whose gradients are the ranks' shares (``sharding.model_partial``)
    over the model axis.  Every slot enters, as zeros where no backward
    of this rank reached it (another rank's rows may have), so every rank
    issues the same collectives in the same order: the slots in
    ``tree_leaves`` order and the scalars last, in buckets of up to
    ``BUCKET_BYTES``."""
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           if a is None else a for p, a in zip(tree_leaves(params), acc)]
    _all_reduce(acc + [scal], axis.group)
    ax = model_axis()
    if ax is not None:
        _all_reduce([a for (path, p), a in zip(flatten_tree(params), acc)
                     if model_partial(path, p.dim())], ax.group)
    return acc, scal


def reduced_bytes(params) -> int:
    """Bytes one step sums over the data axis: an fp32 slot a parameter
    leaf, and the scalar vector."""
    return 4 * (sum(p.numel() for p in tree_leaves(params)) + NUM_SCALARS)


# ---------------------------------------------------------------------------
# Partition-plan executor (the runtime half of core/gateway's planner)
# ---------------------------------------------------------------------------

def run_partition_plan(cfg: ModelConfig, params: dict, plan: PartitionPlan,
                       acc: list, scal: torch.Tensor, *, impl: str = "kernel",
                       loss_scale: float = 1.0,
                       exec_lookup: Optional[Callable] = None,
                       axis: Optional[DataAxis] = None
                       ) -> tuple[list, torch.Tensor]:
    """Execute a PartitionPlan: a forward sweep in wave order without
    autograd (assembling each fragment's gateway from its parent's
    captures), then a backward sweep in reverse wave order that recomputes
    each wave's forward with autograd (remat) from its gateway, made leaves
    that require grad, and backpropagates ``loss_scale · loss`` together
    with the cotangents its children routed onto its captures; the
    gateway's own gradient is then routed to the parents in fp32, slot by
    slot in a fixed order.  So the device holds one wave's activations plus
    the waves' gateways and captures, never the whole tree's graph.

    ``loss_scale`` seeds every wave's loss cotangent — the engine passes
    1/num_trees so the gradients land in ``acc`` (``grad_slots``, updated
    in place) already normalized.  The loss scalar is scaled the same way;
    nll/weight sums stay raw.  Returns ``(acc, scal)``; no host sync
    happens here: every index is a host-planned offset or a non-blocking
    copy of a host array, and an SSM wave's ``chunk_parent`` and cut
    chunks stay on the host (``device_batch``, ``device_capspecs``).

    ``exec_lookup(variant, sig, fn, args, key_args)`` (the engine's
    executable-cache resolver) runs each wave's forward and backward
    through the cache; None calls them directly.

    On a data ``axis`` this rank runs its row block of every wave and
    returns its share of ``acc`` and ``scal`` (``accumulate`` sums them).
    The gateways are assembled for all of a wave's rows on every rank and
    sliced; each wave's captures are all-gathered along rows after its
    forward, so any rank can assemble any child's gateway; and the
    cotangents a rank's children route onto a wave's captures and gateway
    are summed over the axis before that wave's backward, each rank
    receiving its own rows of the sum (a reduce-scatter; a wave no child
    refers to exchanges nothing)."""
    dev = scal.device
    st: list[dict] = []
    parents_of = {ref.wave for wp in plan.waves for ref in wp.parents}
    fwd, bwd = _wave_fwd_fn(cfg, impl), _wave_bwd_fn(cfg, impl)

    def resolve(variant, wp, fn, args):
        if exec_lookup is None:
            return fn(*args)
        sig = wave_signature_of(wp, wp.batch["tokens"].shape[1])
        return exec_lookup(variant, sig, fn, args,
                           wave_key_args(params, wp))

    # ---- forward sweep, wave order ---------------------------------------
    with torch.no_grad():
        for wp in plan.waves:
            Bb = wp.batch["tokens"].shape[0]
            lo, hi = (0, Bb) if axis is None else \
                row_block(Bb, axis.rank, axis.size)
            batch = device_batch(_local_rows(wp.batch, axis), dev)
            capspecs = device_capspecs(wp.capspecs, dev,
                                       wp.batch["tokens"].shape[1])
            gw = None
            if wp.has_gw:
                rows_gw = []
                for ref in wp.parents:
                    stp, pwp = st[ref.wave], plan.waves[ref.wave]
                    cname = f"c{ref.cut}"
                    p_gw_row = None if stp["gw"] is None else _slice_gw_row(
                        stp["gw"], ref.row, pwp.A_real[ref.row])
                    caps_view = _cut_caps_view(cfg, stp["caps"], cname,
                                               ref.row, ref.path_len)
                    rows_gw.append(
                        assemble_child_gw(cfg, p_gw_row, caps_view, cname))
                gw = _stack_gw_rows(rows_gw, wp.anc_A_max, Bb,
                                    rows_idx=wp.slot_rows)
            gw_local = gw if gw is None or axis is None else \
                _rows(gw, lo, hi)
            caps, scal = resolve("wave.fwd", wp, fwd,
                                 (params, batch, gw_local, capspecs, scal,
                                  loss_scale))
            if axis is not None:
                caps = _gather_rows(caps, axis)
            st.append(dict(batch=batch, capspecs=capspecs, gw=gw,
                           gw_local=gw_local, caps=caps, rows=(lo, hi),
                           cot_gw=None, cot_cut={}))

    # ---- backward sweep, reverse wave order ------------------------------
    for w in reversed(range(len(plan.waves))):
        wp, s = plan.waves[w], st[w]
        lo, hi = s["rows"]
        with torch.no_grad():
            cot_caps = map_tree(torch.zeros_like, s["caps"])
            for cname, (r, cot_view) in s["cot_cut"].items():
                _embed_cut_cot(cot_caps, cot_view, cname, r)
            cot_gw = s["cot_gw"]
            if axis is not None and w in parents_of:
                cot_caps = _sum_rows(cot_caps, axis, lo, hi)
                if s["gw"] is not None:
                    cot_gw = _sum_rows(_zeros_f32(s["gw"]) if cot_gw is None
                                       else cot_gw, axis, lo, hi)
            elif axis is not None:      # no child: nothing routed onto it
                cot_caps = _rows(cot_caps, lo, hi)
            if axis is not None:
                cot_caps = map_tree(lambda a: a.contiguous(), cot_caps)
        cot_loss = torch.full((), loss_scale, dtype=torch.float32,
                              device=dev)
        g_gw = resolve("wave.bwd", wp, bwd,
                       (params, s["batch"], s["gw_local"], s["capspecs"],
                        cot_loss, cot_caps, acc))
        del cot_caps
        with torch.no_grad():
            if wp.has_gw:
                if cot_gw is not None:
                    g_gw = map2(lambda a, b: a.float() + b, g_gw, cot_gw)
                for si, ref in enumerate(wp.parents):
                    row = wp.slot_rows[si]
                    if not lo <= row < hi:     # another rank's child
                        continue
                    stp, pwp = st[ref.wave], plan.waves[ref.wave]
                    cname = f"c{ref.cut}"
                    cot_child_row = _slice_gw_row(g_gw, row - lo,
                                                  wp.A_real[row])
                    p_gw_row = None if stp["gw"] is None else _slice_gw_row(
                        stp["gw"], ref.row, pwp.A_real[ref.row])
                    caps_view = _cut_caps_view(cfg, stp["caps"], cname,
                                               ref.row, ref.path_len)
                    cot_gw_row = None if p_gw_row is None \
                        else _zeros_f32(p_gw_row)
                    cot_caps_row = map_tree(torch.zeros_like, caps_view)
                    route_child_cot(cfg, p_gw_row, caps_view, cname,
                                    cot_child_row, cot_gw_row, cot_caps_row)
                    if cot_gw_row is not None:
                        if stp["cot_gw"] is None:
                            stp["cot_gw"] = _zeros_f32(stp["gw"])
                        _embed_gw_row_cot(stp["cot_gw"], cot_gw_row, ref.row)
                    stp["cot_cut"][cname] = (ref.row, cot_caps_row)
        st[w] = None            # its children are done: free its tensors
    return acc, scal


class TreeTrainEngine:
    """Plan→execute training engine: ``step(params, opt_state, plan)`` runs
    every execution of the plan (packed rows first, then the partition
    waves), accumulates the gradients in fp32, applies AdamW in place, and
    performs exactly ONE host sync to materialize the logging metrics.
    ``host_syncs`` counts every device→host transfer the engine issues.

    With an ``exec_cache`` every dispatch first resolves its executable
    by signature: a miss makes it synchronously, counted in ``retraces``
    with the stall seconds in ``compile_wait_s``; with a ``universe``
    (``analysis/signatures.SignatureUniverse``) attached, an
    out-of-universe miss logs a warning naming why the planner escaped the
    enumerable bucket set.  The cache's executables must have been made
    for this engine's ``cfg``, ``impl`` and ``opt_cfg``."""

    METRIC_NAMES = ("loss", "nll_sum", "weight_sum", "grad_norm", "lr")

    def __init__(self, cfg: ModelConfig,
                 opt_cfg: Optional[OptimizerConfig] = None, *,
                 impl: str = "kernel", weight_store=None,
                 exec_cache: Optional[ExecutableCache] = None,
                 universe=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.impl = impl
        self.host_syncs = 0
        self.steps_done = 0
        self.weight_store = weight_store
        self.max_lag_seen = 0
        # retraces counts the stalls the warm-up failed to hide (0 on an
        # in-universe stream after it: rl_loop and chip_smoke require it)
        self.exec_cache = exec_cache
        self.universe = universe
        self.retraces = 0
        self.compile_wait_s = 0.0

    # -- executable resolution --------------------------------------------
    def _exec_lookup(self, variant: str, sig, fn, args: tuple,
                     key_args: tuple):
        """Resolve one dispatch keyed by ``key_args``: a cache hit runs the
        cached executable; a miss makes it synchronously (counted as a
        retrace, its wall time as exposed compile wait), then caches it so
        the bucket stalls at most once per run."""
        key = exec_key(variant, sig, key_args)
        compiled = self.exec_cache.get(key)
        if compiled is not None:
            return compiled(*args)
        dev = tree_leaves(args[0])[0].device
        t0 = time.perf_counter()
        compiled, _ = self.exec_cache.compile_once(
            key, lambda: executable(variant, fn, self.impl, dev))
        self.compile_wait_s += time.perf_counter() - t0
        self.retraces += 1
        if self.universe is not None and sig[0] in ("packed", "wave"):
            ok, why = self.universe.contains(sig)
            if not ok:
                logger.warning(
                    "out-of-universe signature %s (%s): compiled "
                    "synchronously on the slow path — the planner "
                    "escaped the enumerable bucket set", sig, why)
            else:
                logger.info(
                    "in-universe signature %s was not prewarmed: "
                    "compiled synchronously (%s)", sig, variant)
        return compiled(*args)

    def _run(self, variant: str, sig, fn, args: tuple, key_args: tuple):
        if self.exec_cache is None:
            return fn(*args)
        return self._exec_lookup(variant, sig, fn, args, key_args)

    def accumulate(self, params, plan: ExecutionPlan):
        """Run the plan's executions; returns ``(grads, scal)`` — the fp32
        gradient sum (normalized per tree) and the on-device
        ``[loss, nll_sum, weight_sum]`` vector: the loss is a mean over the
        step's trees, packed and partitioned alike.  On a data axis each
        rank runs its rows, and both are summed over the axis here."""
        dev = tree_leaves(params)[0].device
        scal = torch.zeros((NUM_SCALARS,), dtype=torch.float32, device=dev)
        n = max(plan.num_trees, 1)
        acc = grad_slots(params)
        axis = data_axis()
        if plan.packed is not None:
            batch = device_batch(_local_rows(plan.packed.inputs, axis), dev)
            batch["num_trees"] = n
            B, S = plan.packed.inputs["tokens"].shape
            acc, scal = self._run(
                "packed+acc" if plan.has_waves else "packed",
                packed_signature(B, S), _packed_exec_fn(self.cfg, self.impl),
                (params, batch, acc, scal), packed_key_args(params, plan))
        if plan.has_waves:
            acc, scal = run_partition_plan(
                self.cfg, params, plan.partition, acc, scal, impl=self.impl,
                loss_scale=1.0 / n,
                exec_lookup=(None if self.exec_cache is None
                             else self._exec_lookup), axis=axis)
        if axis is not None:
            with torch.profiler.record_function(REDUCE_SPAN):
                acc, scal = _reduce(params, acc, scal, axis)
        return acc_tree(params, acc), scal

    def _update(self, params, grads, opt_state):
        return self._run("update", ("update",),
                         functools.partial(update, self.opt_cfg),
                         (params, grads, opt_state), (params, opt_state))

    def step(self, params, opt_state, plan: ExecutionPlan):
        """Returns ``(params, opt_state, metrics)`` — params and opt_state
        are the same objects, updated in place; metrics is a host dict
        (loss, nll, grad_norm, lr, …) pulled in a single transfer."""
        if self.opt_cfg is None:
            raise ValueError("TreeTrainEngine.step needs an OptimizerConfig")
        grads, scal = self.accumulate(params, plan)
        params, opt_state, om = self._update(params, grads, opt_state)
        del grads
        vec = torch.cat([scal, torch.stack([om["grad_norm"], om["lr"]]
                                           ).float()])
        host = self._sync(vec)
        metrics = dict(zip(self.METRIC_NAMES, host.tolist()))
        metrics["nll"] = metrics["nll_sum"] / max(metrics["weight_sum"],
                                                  1e-9)
        if plan.versions is not None:
            lag = self.steps_done - plan.versions[0]
            metrics["max_lag"] = lag
            self.max_lag_seen = max(self.max_lag_seen, lag)
        self.steps_done += 1
        if self.weight_store is not None:
            # a device copy on this stream, ordered after the in-place
            # update: no host sync
            self.weight_store.publish(params, self.steps_done)
        return params, opt_state, metrics

    def warmup(self, params, opt_state, plan: ExecutionPlan):
        """Run the full accumulate + update pipeline once WITHOUT the
        logging host sync, as the reference's compile warm-up does (it
        updates the parameters too).  Does not count as a step and
        publishes no weights."""
        if self.opt_cfg is None:
            raise ValueError("TreeTrainEngine.warmup needs an OptimizerConfig")
        grads, _ = self.accumulate(params, plan)
        params, opt_state, _ = self._update(params, grads, opt_state)
        return params, opt_state

    def _sync(self, vec: torch.Tensor) -> np.ndarray:
        """THE host sync: every device→host read the engine performs
        funnels through here so the count is auditable."""
        self.host_syncs += 1
        return vec.cpu().numpy()
