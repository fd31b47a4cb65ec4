"""Train step primitives: tree-training and baseline modes behind one
interface.

Port of ``repro/train/train_step.py``.  Whether a step is "tree" or
"baseline" is decided purely by how the batch was packed
(``core/packing.pack_trees`` vs ``pack_linear_paths``); the model code is
shared.  ``jit`` and buffer donation have no counterpart here: these are
plain functions, and ``update`` (the reference's ``jitted_update``) updates
in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import map_tree, tree_leaves, unflatten_like
from repro_torch.models.model import loss_and_metrics
from repro_torch.train.optimizer import OptimizerConfig, adamw_update


def value_and_grad(cfg: ModelConfig, params: dict, batch: dict,
                   impl: str = "kernel"):
    """(loss, metrics, grads): grads of the loss w.r.t. every leaf of
    ``params``, in the parameters' dtype and layout.  The leaves are
    detached aliases (no copy), so the parameters stay plain tensors."""
    live = map_tree(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_and_metrics(cfg, live, batch, impl)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_like(live, grads))


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
