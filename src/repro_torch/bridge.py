"""Weight and config bridge from the JAX reference.

The port keeps the reference's parameter layout, so moving weights across
is an identity rename: the caller turns the JAX pytree into numpy arrays
(``jax.tree.map(np.asarray, params)``, in code that may import JAX) and
``params_from_jax`` makes torch tensors of them.  ``config_from_jax``
rebuilds the port's ``ModelConfig`` from the reference's through
``dataclasses.asdict`` (the fields are the same).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, config_from_dict
from repro_torch.device import DeviceLike, map_tree


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)                       # a writable copy torch may own
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: reinterpret bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device: DeviceLike) -> dict:
    """Nested dict/list of numpy arrays (the JAX layout) → the same tree of
    torch tensors on ``device``."""
    return map_tree(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(params: dict) -> dict:
    """The inverse for float32/int leaves: torch tensors → numpy arrays."""
    return map_tree(lambda t: t.detach().cpu().numpy(), params)


def config_from_jax(cfg) -> ModelConfig:
    return config_from_dict(dataclasses.asdict(cfg))
