"""Public model API of the port: ``init_params`` and a thin ``nn.Module``
that owns a parameter dict for device moves."""
from __future__ import annotations

from torch import nn

from repro_torch.models.transformer import init_params, layer_groups

__all__ = ["init_params", "layer_groups", "ParamTree"]


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
