"""Public model API of the port: init / forward / loss, host-side batch
preparation (``repro/models/model.py``), and a thin ``nn.Module`` that owns
a parameter dict for device moves."""
from __future__ import annotations

from typing import Optional

from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import TreeBatch
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.models.transformer import (forward, init_params,
                                            layer_groups, loss_and_metrics)

__all__ = ["init_params", "forward", "loss_and_metrics", "batch_arrays",
           "prepare_batch", "layer_groups", "ParamTree"]


def batch_arrays(cfg: ModelConfig, tb: TreeBatch, *,
                 num_trees: Optional[int] = None) -> dict:
    """TreeBatch → the model's input columns as host (numpy) arrays, plus
    ``num_trees``, the loss normalizer (mean over trees; ``num_trees``
    overrides the batch's own count).  The planner's threads build these;
    the engine copies them to its device.  SSM chunk maps and frontend
    embeddings are not ported: those families raise."""
    if cfg.ssm is not None or cfg.frontend is not None:
        raise NotImplementedError(
            f"family {cfg.family!r} needs SSM chunks or frontend embeddings, "
            f"which are not ported yet; see ROADMAP.md Queue A items 4-5")
    d: dict = {k: getattr(tb, k) for k in ("tokens", "pos_ids", "kv_last",
                                           "weight", "prev_idx", "valid")}
    d["num_trees"] = tb.num_trees if num_trees is None else num_trees
    return d


def prepare_batch(cfg: ModelConfig, tb: TreeBatch, *,
                  num_trees: Optional[int] = None,
                  device: DeviceLike = None) -> dict:
    """``batch_arrays`` as tensors on ``device`` (the CUDA device by
    default)."""
    return to_device(batch_arrays(cfg, tb, num_trees=num_trees),
                     resolve_device(device))


class ParamTree(nn.Module):
    """Owns a parameter dict in the reference's layout (nested dicts, and
    lists of dicts for ``layer_stacks``) as buffers, so ``.to(device)``
    moves every leaf; ``tree()`` gives the dict back for the functional
    model code."""

    def __init__(self, params: dict):
        super().__init__()
        self._keys = list(params)
        for k, v in params.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_buffer(k, v)

    def tree(self) -> dict:
        out: dict = {}
        for k in self._keys:
            v = getattr(self, k)
            if isinstance(v, ParamTree):
                out[k] = v.tree()
            elif isinstance(v, nn.ModuleList):
                out[k] = [m.tree() for m in v]
            else:
                out[k] = v
        return out
