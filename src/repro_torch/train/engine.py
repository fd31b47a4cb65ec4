"""Tree-ingest training engine: one plan→execute loop.

Port of the packed-execution part of ``repro/train/engine.py``.  Every step
is an ``ExecutionPlan``; ``TreeTrainEngine.step`` runs its packed microbatch
through one forward/backward, takes the gradients in the parameters' dtype
and casts them to fp32, applies AdamW, and performs **exactly one** device→
host transfer (the logging vector, through ``_sync``, counted in
``host_syncs``).  Loss, token-CE sum and weight sum accumulate in one
device vector.  ``loss_mode="rl"`` rides the per-token weights the
serializer threads through, so one engine serves SFT and the RL update.

Not ported: partition waves (a plan that carries them raises; ROADMAP.md
Queue A item 4), the AOT executable cache and signature universe (XLA
specific; item 8) and the RL service's weight store (item 7).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import map_tree, tree_leaves
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import update, value_and_grad

# the on-device scalar accumulator: [loss, nll_sum, weight_sum]
NUM_SCALARS = 3


@dataclass
class PackedExec:
    """One uniform [B, S] microbatch execution (the packed rows)."""
    inputs: dict                 # model inputs on the device (prepare_batch)
    tokens: int = 0              # host-side unique-token count (logging)
    cells: int = 0               # materialized row cells (B × S)


@dataclass
class ExecutionPlan:
    """Everything one optimizer step trains on: the packed microbatch and,
    in the reference, the partition waves of oversized trees (a
    ``PartitionPlan`` with ``waves`` and ``num_trees``), which the port
    does not run yet."""
    packed: Optional[PackedExec] = None
    partition: Any = None
    num_trees: int = 0           # trees the step trains (loss normalizer)
    dropped: int = 0             # trees lost this step

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
        return 0 if self.packed is None else self.packed.tokens

    @property
    def padded_tokens(self) -> int:
        """Materialized row cells holding no unique token."""
        return (0 if self.packed is None else self.packed.cells) \
            - self.unique_tokens


def _scal_add(scal, loss, metrics):
    return scal + torch.stack([loss.float(), metrics["nll_sum"].float(),
                               metrics["weight_sum"].float()])


def _packed_exec_fn(cfg: ModelConfig, impl: str, with_acc: bool = True):
    """Packed microbatch: forward + backward, grads cast to fp32.

    ``with_acc`` adds them into ``acc`` (a tree of fp32 buffers, updated in
    place) and the scalars into ``scal``; ``with_acc=False`` is the
    single-execution fast path, where the fp32 grads ARE the accumulator
    (``0 + g ≡ g`` exactly)."""
    if with_acc:
        def f(params, batch, acc, scal):
            loss, metrics, grads = value_and_grad(cfg, params, batch, impl)
            with torch.no_grad():
                for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                    a.add_(g.float())
            return acc, _scal_add(scal, loss, metrics)

        return f

    def f1(params, batch, scal):
        loss, metrics, grads = value_and_grad(cfg, params, batch, impl)
        return map_tree(lambda g: g.float(), grads), \
            _scal_add(scal, loss, metrics)

    return f1


class TreeTrainEngine:
    """Plan→execute training engine: ``step(params, opt_state, plan)`` runs
    the plan's packed execution, applies AdamW in place, and performs
    exactly ONE host sync to materialize the logging metrics.
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
        ``[loss, nll_sum, weight_sum]`` vector."""
        if plan.has_waves:
            raise NotImplementedError(
                "partition waves are not ported yet; see ROADMAP.md Queue A "
                "item 4")
        dev = tree_leaves(params)[0].device
        scal = torch.zeros((NUM_SCALARS,), dtype=torch.float32, device=dev)
        if plan.packed is None:
            return map_tree(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                                  device=a.device),
                            params), scal
        batch = dict(plan.packed.inputs)
        batch["num_trees"] = max(plan.num_trees, 1)
        return _packed_exec_fn(self.cfg, self.impl, with_acc=False)(
            params, batch, scal)

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
