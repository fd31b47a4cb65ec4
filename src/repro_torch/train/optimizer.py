"""AdamW + warmup-cosine schedule + global-norm clipping (no external deps).

Port of ``repro/train/optimizer.py``.  The optimizer state mirrors the
parameter tree: ``{"mu", "nu"}`` hold fp32 moments of every leaf and
``"step"`` is an int32 scalar tensor.  ``adamw_update`` rewrites params, mu,
nu and step **in place** under ``torch.no_grad()`` (JAX donates the old
buffers instead; PyTorch has no counterpart, and in place keeps one copy).
The learning rate, the bias corrections and the clip scale stay fp32
tensors on the device, so an update never waits on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.device import map_tree, tree_leaves


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: Any) -> dict:
    zeros = lambda p: map_tree(
        lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
        p)
    step_dev = tree_leaves(params)[0].device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(a.float()))
                          for a in tree_leaves(tree)))


def _decay_mask(params: Any) -> Any:
    """Weight decay on leaves with ndim > 1, as the reference does.  Its
    docstring says "no weight decay on norm scales, biases", but the stacked
    layers' norm scales and biases have a leading layer dimension, so only
    unstacked 1-D leaves (``final_norm``) are exempt; copied as it is."""
    return map_tree(lambda a: a.ndim > 1, params)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Any, grads: Any,
                 state: dict) -> tuple[Any, dict, dict]:
    """One AdamW step, in place.  Returns (params, state, metrics) — the
    same ``params`` and ``state`` objects, updated — with metrics
    ``grad_norm`` (before clipping) and ``lr`` as device tensors."""
    step = state["step"]
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step)
    bc1 = 1 - b1 ** (step + 1)
    bc2 = 1 - b2 ** (step + 1)
    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                 tree_leaves(_decay_mask(params)))
    for p, g, mu, nu, decay in leaves:
        g = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if decay:
            delta += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    step.add_(1)
    return params, state, {"grad_norm": gn, "lr": lr}
