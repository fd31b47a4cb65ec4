"""Checkpointing: flat npz + JSON manifest, the reference's format.

Port of ``repro/train/checkpoint.py``: ``params.npz``, ``opt_state.npz`` and
``manifest.json``, with the same flattened key paths (``layer_stacks/0/
attn/wq``, ``mu/embed/table``, ``step``), so a checkpoint written by one
package loads in the other.  A bf16 leaf is written as the reference writes
it — ``np.savez`` of a JAX bf16 array stores raw 2-byte ``|V2`` records, not
a typed array — and read back by a bit view.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.device import flatten_tree, unflatten_like


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(like.device)
    return torch.from_numpy(np.array(a)).to(dtype=like.dtype,
                                            device=like.device)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_key(p): _to_numpy(leaf) for p, leaf in flatten_tree(tree)}


def save_checkpoint(path: str, params: Any, opt_state: Any = None,
                    meta: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten(params)
    np.savez(os.path.join(path, "params.npz"), **flat)
    if opt_state is not None:
        np.savez(os.path.join(path, "opt_state.npz"), **_flatten(opt_state))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"meta": meta or {}, "keys": sorted(flat)}, f, indent=1)


def load_meta(path: str) -> dict:
    """The manifest's ``meta`` dict (e.g. ``steps`` for mid-stream
    resume)."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("meta", {})


def load_checkpoint(path: str, params_like: Any, opt_state_like: Any = None):
    """Restore into the structure, dtypes and devices of ``params_like``
    (shapes checked)."""
    def restore(npz_path, like):
        data = np.load(npz_path)
        leaves = []
        for p, leaf in flatten_tree(like):
            arr = data[_key(p)]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{_key(p)}: checkpoint shape {arr.shape} "
                                 f"!= {tuple(leaf.shape)}")
            leaves.append(_from_numpy(arr, leaf))
        return unflatten_like(like, leaves)

    params = restore(os.path.join(path, "params.npz"), params_like)
    if opt_state_like is None:
        return params
    return params, restore(os.path.join(path, "opt_state.npz"),
                           opt_state_like)
