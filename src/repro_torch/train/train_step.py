"""Train step primitives: tree-training and baseline modes behind one
interface.

Port of ``repro/train/train_step.py``.  Whether a step is "tree" or
"baseline" is decided purely by how the batch was packed
(``core/packing.pack_trees`` vs ``pack_linear_paths``); the model code is
shared.  ``jit`` and buffer donation have no counterpart here: these are
plain functions, and ``update`` (the reference's ``jitted_update``) updates
in place.  Under ``sharding.use_mesh`` a step runs this rank's block of the
batch's rows and its blocks of the parameters, and ``value_and_grad`` sums
the loss, the metrics and the grads over the mesh as the engine does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.device import (flatten_tree, map_tree, tree_leaves,
                                unflatten_like)
from repro_torch.models.model import loss_and_metrics, rank_rows
from repro_torch.sharding import data_axis, model_axis, model_partial
from repro_torch.train.optimizer import OptimizerConfig, adamw_update


def value_and_grad(cfg: ModelConfig, params: dict, batch: dict,
                   impl: str = "kernel"):
    """(loss, metrics, grads): grads of the loss w.r.t. every leaf of
    ``params``, in the parameters' dtype and layout.  The leaves are
    detached aliases (no copy), so the parameters stay plain tensors.  On
    a mesh: this rank's rows, the sums over the data axes (the grads in
    fp32), and over the model axis the grads that are the ranks' shares
    (``sharding.model_partial``)."""
    axis = data_axis()
    if axis is not None:
        batch = rank_rows(batch, axis.rank, axis.size)
    live = map_tree(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_and_metrics(cfg, live, batch, impl)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    if axis is not None:
        loss, metrics, grads = _mesh_sum(live, loss, metrics, grads, axis)
    return loss, metrics, unflatten_like(live, grads)


def _mesh_sum(live, loss, metrics: dict, grads, axis):
    """``value_and_grad``'s sums over the mesh, in a fixed order on every
    rank: the scalars, then the grads over the data axes, then the
    model-partial grads over the model axis."""
    keys = [k for k in metrics if k != "token_nll_mean"]
    scal = torch.stack([loss.float()] + [metrics[k].float() for k in keys])
    dist.all_reduce(scal, group=axis.group)
    out = [g.float() for g in grads]
    for g in out:
        dist.all_reduce(g, group=axis.group)
    ax = model_axis()
    if ax is not None:
        for (path, p), g in zip(flatten_tree(live), out):
            if model_partial(path, p.dim()):
                dist.all_reduce(g, group=ax.group)
    metrics = dict(zip(keys, scal[1:]))
    metrics["token_nll_mean"] = metrics["nll_sum"] / torch.clamp(
        metrics["weight_sum"], min=1e-9)
    return scal[0], metrics, [g.to(o.dtype) for g, o in zip(out, grads)]


def update(opt_cfg: OptimizerConfig, params, grads, opt_state):
    """The AdamW update, in place: ``(params, grads, opt_state) →
    (params, opt_state, metrics)`` (the reference's ``jitted_update``)."""
    return adamw_update(opt_cfg, params, grads, opt_state)


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    impl: str = "kernel"):
    """``(params, opt_state, batch) → (params, opt_state, metrics)``."""
    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(cfg, params, batch, impl)
        params, opt_state, opt_metrics = update(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, {**metrics, **opt_metrics, "total": loss}

    return step


def make_grad_fn(cfg: ModelConfig, impl: str = "kernel"):
    """Gradient-only fn (for accumulation / partitioned drivers):
    ``(params, batch) → (loss, grads, metrics)``."""
    def gfn(params, batch):
        loss, metrics, grads = value_and_grad(cfg, params, batch, impl)
        return loss, grads, metrics

    return gfn


def apply_grads(opt_cfg: OptimizerConfig, params, opt_state, grads):
    """``update`` with the reference's argument order."""
    return update(opt_cfg, params, grads, opt_state)
