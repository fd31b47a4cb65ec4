"""Tree state routing over the chunk grid (paper §3.2, SSM layers).

Port of ``repro/models/ssm/common.py``.  Under DFS serialization the
sequential chunk state flow is wrong: after a leaf the next chunk is a
sibling, not a descendant.  Chunk c therefore starts from the state of
``chunk_parent[c]`` (−1: the initial state).  DFS pre-order computes every
parent first, and sibling chunks read the same parent state, so their
gradients add up there.

``chunk_parent`` is host data (numpy, from ``models/model.batch_arrays``):
the loop picks each chunk's input state from a Python list of the states
computed so far, so no index is read back from the device, and the
backward sums the siblings' cotangents through autograd's own buffers in
a fixed order (no atomic scatter: the reference's one-hot contraction has
the same property).  The layers split each chunk step into the terms that
need no state, computed for every chunk at once, and the recurrence
``chunk_step``, which is all that runs in the loop.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.device import map_tree, tree_leaves, unflatten_like


def _zip_map(fn, trees: list):
    """A tree shaped like ``trees[0]`` whose leaves are ``fn`` of the
    paired leaves of ``trees`` (each of one structure)."""
    return unflatten_like(trees[0], [fn(list(ls)) for ls in
                                     zip(*map(tree_leaves, trees))])


def host_parents(chunk_parent) -> np.ndarray:
    """chunk_parent as a host int array; a tensor on the card is refused
    (reading it would wait for the device)."""
    if isinstance(chunk_parent, torch.Tensor):
        if chunk_parent.device.type != "cpu":
            raise ValueError("chunk_parent must be host data (numpy or a "
                             "CPU tensor), not a tensor on "
                             f"{chunk_parent.device}")
        chunk_parent = chunk_parent.numpy()
    return np.asarray(chunk_parent)


def _select(states: list, slots: np.ndarray):
    """Row b of ``states[slots[b]]`` for every row b."""
    if (slots == slots[0]).all():
        return states[int(slots[0])]
    return _zip_map(torch.stack, [map_tree(lambda a, b=b: a[b],
                                           states[int(s)])
                                  for b, s in enumerate(slots)])


def tree_chunk_scan(chunk_step: Callable[[Any, Any], tuple[Any, Any]],
                    zero_state: Any, xs: Any, chunk_parent,
                    initial_state: Optional[Any] = None
                    ) -> tuple[Any, list]:
    """Run ``chunk_step(state, x_c) -> (y_c, state_out)`` over the chunks
    with tree state routing.

    zero_state: pytree of [B, ...] (the state's shape and dtype);
    xs: pytree of [B, C, ...] per-chunk inputs;
    chunk_parent: host [B, C] ints, −1 reads the initial state;
    initial_state: optional pytree [B, ...] at slot 0 (the SSM partition
      gateway's injection point, paper App. B.7), else ``zero_state``.

    Returns (ys, states): ys the pytree of [B, C, ...] outputs, states the
    list of the C + 1 state pytrees, slot 0 the initial state and slot
    c + 1 chunk c's output state (``torch.stack(…, 1)`` of it is the
    reference's all-states buffer)."""
    cp = host_parents(chunk_parent)
    C = cp.shape[1]
    states = [zero_state if initial_state is None else initial_state]
    cols = [torch.unbind(a, 1) for a in tree_leaves(xs)]
    per_chunk = [unflatten_like(xs, [col[c] for col in cols])
                 for c in range(C)]
    ys = []
    for c in range(C):
        y, s_out = chunk_step(_select(states, cp[:, c] + 1), per_chunk[c])
        ys.append(y)
        states.append(s_out)
    return _zip_map(lambda a: torch.stack(a, 1), ys), states


def chunkify(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """[B, S, ...] → [B, C, chunk, ...]."""
    B, S = x.shape[:2]
    assert S % chunk == 0, (S, chunk)
    return x.reshape(B, S // chunk, chunk, *x.shape[2:])


def unchunkify(x: torch.Tensor) -> torch.Tensor:
    B, C, L = x.shape[:3]
    return x.reshape(B, C * L, *x.shape[3:])


def lower_mask(L: int, device, diagonal: int = 0) -> torch.Tensor:
    """[L, L] bool, True on and below ``diagonal`` (0: the main diagonal,
    −1: strictly below it)."""
    return torch.tril(torch.ones((L, L), dtype=torch.bool, device=device),
                      diagonal=diagonal)


def checkpointed(fn, *args):
    """``fn(*args)``, recomputed in the backward instead of keeping its
    intermediates when autograd records (non-reentrant checkpoint: the
    same numbers, in the same order, so the gradient is unchanged and
    deterministic; ``fn`` draws no random numbers, so no RNG state is
    stashed).  The SSM layers' chunk terms hold [L, L] tensors per chunk
    and head, the plain encoder and cross-attention (``models/attention``)
    fp32 scores per query and key: kept for all layers of a full-width row
    pair they would pass the card's memory; ``models/transformer`` wraps a
    whole layer in one under ``remat="full"``.  Where no argument (nor any
    tensor in a dict, list or tuple argument) requires grad (a decode
    step) nothing would be kept, and ``fn`` runs as it is."""
    if not (torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in tree_leaves(args))):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)
