"""The port's device rule: entry points run on the CUDA device unless the
caller names another one.  No path drops to the CPU because no GPU was
found; the default on a machine without CUDA raises."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and this machine has none; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def to_device(batch: dict, device: torch.device) -> dict:
    """Host (numpy) batch columns → tensors on ``device``; tensors and
    Python scalars pass through.  A CUDA copy is issued non-blocking, so it
    neither reads the device back nor waits for it."""
    def move(a):
        if isinstance(a, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device, non_blocking=True) \
                if device.type == "cuda" else t
        return a
    return {k: move(v) for k, v in batch.items()}


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list/tuple of tensors
    (the JAX package's pytree layout)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def flatten_tree(tree, path: tuple = ()) -> list[tuple[tuple, object]]:
    """(key path, leaf) pairs of a nested dict/list/tuple in JAX's pytree
    order (dict keys sorted, sequences in order), so sums over leaves and
    checkpoint keys follow the reference."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_tree(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_tree(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_tree(tree)]


def unflatten_like(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    return _rebuild(tree, iter(leaves))


def _rebuild(t, it):
    # a module-level function: a nested recursive closure would be a
    # reference cycle holding ``leaves`` (device tensors) until Python's
    # cycle collector happened to run
    if isinstance(t, dict):
        out = {k: _rebuild(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}              # keep the dict's order
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(v, it) for v in t)
    return next(it)

