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

