"""The port's device rule: entry points run on the CUDA device unless the
caller names another one.  No path drops to the CPU because no GPU was
found; the default on a machine without CUDA raises."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and this machine has none; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


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
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            out = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}          # keep the dict's order
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)

    return rebuild(tree)

