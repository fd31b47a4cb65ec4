"""Public model API of the port: init / forward / loss, host-side batch
preparation (``repro/models/model.py``), and a thin ``nn.Module`` that owns
a parameter dict for device moves."""
from __future__ import annotations

from typing import Optional

import numpy as np
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import TreeBatch
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.models.layers import prev_powers
from repro_torch.models.transformer import (forward, init_params,
                                            layer_groups, loss_and_metrics)

__all__ = ["init_params", "forward", "loss_and_metrics", "batch_arrays",
           "prepare_batch", "device_batch", "rank_rows", "row_block",
           "needs_chunks", "chunk_size_of", "max_conv_taps", "layer_groups",
           "ParamTree"]

# The batch columns whose leading dim is the row dim, which a data axis
# splits (``rank_rows``), and the step's columns, which every rank reads
# whole.  A column in neither set is refused, so a new column cannot be
# split (or left whole) by accident.
ROW_COLUMNS = frozenset((
    "tokens", "pos_ids", "kv_last", "weight", "prev_idx", "valid",
    "chunk_parent", "prev_pows", "extra_embeds", "extra_valid",
    "extra_pos", "extra_label", "extra_weight", "anc_pos", "anc_valid"))
STEP_COLUMNS = frozenset(("num_trees",))


def needs_chunks(cfg: ModelConfig) -> bool:
    return cfg.ssm is not None


def chunk_size_of(cfg: ModelConfig) -> Optional[int]:
    """The chunk grid packed rows are aligned to: the SSM chunk size for
    the SSM and hybrid families, None otherwise."""
    return cfg.ssm.chunk_size if needs_chunks(cfg) else None


def max_conv_taps(cfg: ModelConfig) -> int:
    """How many path-predecessor gathers the model needs (conv K−1)."""
    if cfg.ssm is None:
        return 0
    if cfg.ssm.kind == "rwkv6":
        return 1                      # token shift only (uses prev_idx)
    return cfg.ssm.conv_kernel - 1


def batch_arrays(cfg: ModelConfig, tb: TreeBatch, extra_embeds=None, *,
                 extra_valid=None, num_trees: Optional[int] = None) -> dict:
    """TreeBatch → the model's input columns as host (numpy) arrays, plus
    ``num_trees``, the loss normalizer (mean over trees; ``num_trees``
    overrides the batch's own count).  The planner's threads build these;
    the engine copies them to its device (``device_batch``), except
    ``chunk_parent`` (SSM and hybrid families), which the chunk loop reads
    on the host; ``prev_pows`` [B, S, K−1] are the conv's
    path predecessors.  A model with a frontend (VLM, audio) also takes
    ``extra_embeds`` [B, frontend_len, d_model]: the argument, else the
    batch's own, else the stub's zeros (f32; the model casts them to its
    dtype, so they equal the reference's zeros of that dtype), and
    ``extra_valid`` [B, frontend_len] where given."""
    d: dict = {k: getattr(tb, k) for k in ("tokens", "pos_ids", "kv_last",
                                           "weight", "prev_idx", "valid")}
    if needs_chunks(cfg):
        if tb.chunk_parent is None:
            raise ValueError(f"{cfg.name} needs a chunk-aligned batch (pack "
                             f"with chunk_size={cfg.ssm.chunk_size})")
        d["chunk_parent"] = tb.chunk_parent
        d["prev_pows"] = prev_powers(tb.prev_idx, max(1, max_conv_taps(cfg)))
    if extra_embeds is not None:
        d["extra_embeds"] = extra_embeds
    elif tb.extra_embeds is not None:
        d["extra_embeds"] = tb.extra_embeds
    elif cfg.frontend is not None:
        d["extra_embeds"] = np.zeros(
            (tb.tokens.shape[0], cfg.frontend_len, cfg.d_model), np.float32)
    if extra_valid is not None:
        d["extra_valid"] = extra_valid
    d["num_trees"] = tb.num_trees if num_trees is None else num_trees
    return d


def prepare_batch(cfg: ModelConfig, tb: TreeBatch, extra_embeds=None, *,
                  extra_valid=None, num_trees: Optional[int] = None,
                  device: DeviceLike = None) -> dict:
    """``batch_arrays`` as tensors on ``device`` (the CUDA device by
    default), ``chunk_parent`` kept host (``device_batch``)."""
    return device_batch(batch_arrays(cfg, tb, extra_embeds,
                                     extra_valid=extra_valid,
                                     num_trees=num_trees),
                        resolve_device(device))


def device_batch(batch: dict, device) -> dict:
    """``batch_arrays``' columns on ``device`` (``device.to_device``: no
    read-back, no wait), except ``chunk_parent``, which stays host numpy:
    the SSM chunk loop indexes its Python list of states with it
    (``models/ssm/common``)."""
    out = to_device({k: v for k, v in batch.items() if k != "chunk_parent"},
                    device)
    if "chunk_parent" in batch:
        out["chunk_parent"] = batch["chunk_parent"]
    return out


def row_block(B: int, rank: int, size: int) -> tuple[int, int]:
    """Rank ``rank``'s rows [r·B/R, (r+1)·B/R) of a batch of ``B`` rows on
    a data axis of ``size`` ranks (the blocks the planner's
    ``balanced_row_order`` balances); B must be a multiple of R."""
    if B % size:
        raise ValueError(f"{B} rows do not split over a data axis of {size} "
                         f"ranks (the planner pads rows to a multiple of "
                         f"num_replicas)")
    n = B // size
    return rank * n, (rank + 1) * n


def rank_rows(batch: dict, rank: int, size: int) -> dict:
    """This rank's contiguous row block (``row_block``) of every row column
    of a batch (host arrays or tensors; ``chunk_parent`` stays what it
    is); ``num_trees`` stays global, the loss normalizer of the whole
    step."""
    lo, hi = row_block(batch["tokens"].shape[0], rank, size)
    out = {}
    for k, v in batch.items():
        if k in ROW_COLUMNS:
            out[k] = v[lo:hi]
        elif k in STEP_COLUMNS:
            out[k] = v
        else:
            raise KeyError(f"batch column {k!r} is neither a row column nor "
                           f"a step column (models/model.ROW_COLUMNS)")
    return out


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
