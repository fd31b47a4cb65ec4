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
SFT and the RL update.

Not ported: the AOT executable cache and signature universe
(``exec_lookup``; ROADMAP.md Queue A item 7) and the RL service's weight
store and staleness audit (item 6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gateway import (PartitionPlan, _cut_caps_view,
                                      _embed_cut_cot, _embed_gw_row_cot,
                                      _live, _slice_gw_row, _stack_gw_rows,
                                      _zeros_f32, acc_tree, assemble_child_gw,
                                      device_capspecs, grad_slots, map2,
                                      partition_vjp, route_child_cot)
from repro_torch.device import map_tree, to_device, tree_leaves
from repro_torch.models.transformer import loss_and_metrics, partition_loss
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import update

# the on-device scalar accumulator: [loss, nll_sum, weight_sum]
NUM_SCALARS = 3


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


# ---------------------------------------------------------------------------
# Partition-plan executor (the runtime half of core/gateway's planner)
# ---------------------------------------------------------------------------

def run_partition_plan(cfg: ModelConfig, params: dict, plan: PartitionPlan,
                       acc: list, scal: torch.Tensor, *, impl: str = "kernel",
                       loss_scale: float = 1.0) -> tuple[list, torch.Tensor]:
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
    copy of a host array."""
    dev = scal.device
    st: list[dict] = []

    # ---- forward sweep, wave order ---------------------------------------
    with torch.no_grad():
        for wp in plan.waves:
            batch = to_device(wp.batch, dev)
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
                gw = _stack_gw_rows(rows_gw, wp.anc_A_max,
                                    batch["tokens"].shape[0],
                                    rows_idx=wp.slot_rows)
            (loss, caps), metrics = partition_loss(cfg, params, batch, gw,
                                                   capspecs, impl)
            scal = scal + torch.stack([loss.float() * loss_scale,
                                       metrics["nll_sum"].float(),
                                       metrics["weight_sum"].float()])
            st.append(dict(batch=batch, capspecs=capspecs, gw=gw, caps=caps,
                           cot_gw=None, cot_cut={}))

    # ---- backward sweep, reverse wave order ------------------------------
    for w in reversed(range(len(plan.waves))):
        wp, s = plan.waves[w], st[w]
        with torch.no_grad():
            cot_caps = map_tree(torch.zeros_like, s["caps"])
            for cname, (r, cot_view) in s["cot_cut"].items():
                _embed_cut_cot(cot_caps, cot_view, cname, r)
        cot_loss = torch.full((), loss_scale, dtype=torch.float32,
                              device=dev)
        g_gw = partition_vjp(cfg, params, s["batch"], s["gw"],
                             s["capspecs"], impl, cot_loss, cot_caps, acc)
        del cot_caps
        with torch.no_grad():
            if wp.has_gw:
                if s["cot_gw"] is not None:
                    g_gw = map2(lambda a, b: a.float() + b, g_gw,
                                s["cot_gw"])
                for si, ref in enumerate(wp.parents):
                    row = wp.slot_rows[si]
                    stp, pwp = st[ref.wave], plan.waves[ref.wave]
                    cname = f"c{ref.cut}"
                    cot_child_row = _slice_gw_row(g_gw, row, wp.A_real[row])
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
    ``host_syncs`` counts every device→host transfer the engine issues."""

    METRIC_NAMES = ("loss", "nll_sum", "weight_sum", "grad_norm", "lr")

    def __init__(self, cfg: ModelConfig,
                 opt_cfg: Optional[OptimizerConfig] = None, *,
                 impl: str = "kernel"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.impl = impl
        self.host_syncs = 0
        self.steps_done = 0

    def accumulate(self, params, plan: ExecutionPlan):
        """Run the plan's executions; returns ``(grads, scal)`` — the fp32
        gradient sum (normalized per tree) and the on-device
        ``[loss, nll_sum, weight_sum]`` vector: the loss is a mean over the
        step's trees, packed and partitioned alike."""
        dev = tree_leaves(params)[0].device
        scal = torch.zeros((NUM_SCALARS,), dtype=torch.float32, device=dev)
        n = max(plan.num_trees, 1)
        acc = grad_slots(params)
        if plan.packed is not None:
            batch = to_device(plan.packed.inputs, dev)
            batch["num_trees"] = n
            acc, scal = _packed_exec_fn(self.cfg, self.impl)(
                params, batch, acc, scal)
        if plan.has_waves:
            acc, scal = run_partition_plan(
                self.cfg, params, plan.partition, acc, scal, impl=self.impl,
                loss_scale=1.0 / n)
        return acc_tree(params, acc), scal

    def step(self, params, opt_state, plan: ExecutionPlan):
        """Returns ``(params, opt_state, metrics)`` — params and opt_state
        are the same objects, updated in place; metrics is a host dict
        (loss, nll, grad_norm, lr, …) pulled in a single transfer."""
        if self.opt_cfg is None:
            raise ValueError("TreeTrainEngine.step needs an OptimizerConfig")
        grads, scal = self.accumulate(params, plan)
        params, opt_state, om = update(self.opt_cfg, params, grads, opt_state)
        del grads
        vec = torch.cat([scal, torch.stack([om["grad_norm"], om["lr"]]
                                           ).float()])
        host = self._sync(vec)
        metrics = dict(zip(self.METRIC_NAMES, host.tolist()))
        metrics["nll"] = metrics["nll_sum"] / max(metrics["weight_sum"],
                                                  1e-9)
        self.steps_done += 1
        return params, opt_state, metrics

    def warmup(self, params, opt_state, plan: ExecutionPlan):
        """Run the full accumulate + update pipeline once WITHOUT the
        logging host sync, as the reference's compile warm-up does (it
        updates the parameters too).  Does not count as a step."""
        if self.opt_cfg is None:
            raise ValueError("TreeTrainEngine.warmup needs an OptimizerConfig")
        grads, _ = self.accumulate(params, plan)
        params, opt_state, _ = update(self.opt_cfg, params, grads, opt_state)
        return params, opt_state

    def _sync(self, vec: torch.Tensor) -> np.ndarray:
        """THE host sync: every device→host read the engine performs
        funnels through here so the count is auditable."""
        self.host_syncs += 1
        return vec.cpu().numpy()
