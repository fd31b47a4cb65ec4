"""Sharding rules: the mesh context, per-tensor partition specs, and the
data axis that ``torch.distributed`` runs.

Port of ``repro/sharding.py``.  The layout is the reference's
Megatron-style one on a (data…, model) mesh:
  - batch dims of activations      → the data axes
  - attention head / ffn / vocab / expert dims of weights → "model"
  - a tensor whose sharded dim does not divide the model axis is
    replicated (the rules are per tensor).

A partition spec is a tuple with one entry a tensor dim: None, an axis
name, or a tuple of axis names (a one-name tuple is written as the name,
as ``jax.sharding.PartitionSpec`` does).  The spec math (``param_spec``,
``param_shardings``, ``batch_shardings``, ``cache_shardings``) takes a
``launch.mesh.MeshDescriptor`` or a built ``DeviceMesh``; ``placements``
turns a spec into DTensor placements, one per mesh dim.

At run time the port has a data axis only.  Under ``use_mesh`` every batch
the model sees is this rank's contiguous block of the step's rows
(``models/model.rank_rows``): the engine sums the grads over the data
axis, and the MoE layer queues its tokens over the whole batch
(``models/moe``).  So the activation constraints (``shard_activation``,
``shard_logits``, ``shard_spec``) are the identity, and ``tp_out_proj`` is
the plain matmul, while the model axis has size 1; with a larger model
axis they raise: the model axis at run time is ROADMAP item 7e-ii.

The mesh context is module state, not thread-local: the RL service's and
the warm-up's threads see the mesh the launcher entered (the reference
re-enters it in each thread, ``serve/service.py:122-135``).
"""
from __future__ import annotations

import re
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.device import flatten_tree, unflatten_like

MODEL_AXIS_TODO = ("the model axis at run time is ROADMAP.md Queue A item "
                   "7e-ii (the port runs the data axis only)")


def spec(*parts) -> tuple:
    """A partition spec, a one-name tuple entry written as the name."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


# the run-time mesh's axes (the host mesh's); the reference's other
# values (two data axes, sequence parallelism over the model axis) come
# with the model axis at run time, item 7e-ii
DATA_AXES: tuple[str, ...] = ("data",)
MODEL_AXIS = "model"
SEQ_PARALLEL = False


class _Ctx:
    mesh = None


_CTX = _Ctx()


@contextmanager
def use_mesh(mesh):
    """Run the body on ``mesh`` (a ``DeviceMesh``, or None for no mesh):
    its data axis splits every step's rows over the ranks."""
    old, _CTX.mesh = _CTX.mesh, mesh
    try:
        yield
    finally:
        _CTX.mesh = old


def current_mesh():
    """The active mesh, if any (seen from every thread)."""
    return _CTX.mesh


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``MeshDescriptor`` or a ``DeviceMesh``."""
    if hasattr(mesh, "axis_names"):
        return dict(zip(mesh.axis_names, mesh.shape))
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def _model_size() -> int:
    if _CTX.mesh is None:
        return 1
    return _axis_sizes(_CTX.mesh).get(MODEL_AXIS, 1)


def _data_only(x):
    if _model_size() > 1:
        raise NotImplementedError(MODEL_AXIS_TODO)
    return x


@dataclass(frozen=True)
class DataAxis:
    """The data axis of the active mesh: its process group, this rank's
    index on it and its size."""
    group: Any
    rank: int
    size: int


def data_axis() -> Optional[DataAxis]:
    """The active mesh's data axis, or None without a mesh."""
    mesh = _CTX.mesh
    if mesh is None:
        return None
    (name,) = DATA_AXES
    dim = mesh.mesh_dim_names.index(name)
    return DataAxis(mesh.get_group(name), mesh.get_local_rank(name),
                    mesh.size(dim))


def shard_activation(x):
    """[B, S, D] (or [B, S]) activations: the rows are already this rank's
    block of the batch, so the identity while the model axis is 1."""
    return x if _CTX.mesh is None else _data_only(x)


def seq_sharded(S: int) -> bool:
    """True when sequence parallelism is active and a length-``S`` sequence
    dim divides the model axis (the reference's condition)."""
    return (_CTX.mesh is not None and SEQ_PARALLEL
            and S % _model_size() == 0)


def tp_out_proj(h, w):
    """The output projection ``h @ w`` of a block; the reference's
    reduce-scatter under sequence parallelism needs a model axis (item
    7e-ii)."""
    _data_only(None)
    return h @ w


def shard_spec(x, *axes):
    """Constrain arbitrary dims ('data', 'model' or None per dim): the
    identity while the model axis is 1."""
    return x if _CTX.mesh is None else _data_only(x)


def shard_logits(x):
    """[B, S, V]: batch over the data axes (already this rank's rows),
    vocab over the model axis (item 7e-ii)."""
    return x if _CTX.mesh is None else _data_only(x)


# ---------------------------------------------------------------------------
# Parameter shardings
# ---------------------------------------------------------------------------

def _m(n: int, m: int):
    return "M" if n % m == 0 else None


# (path regex, spec builder given (shape, model_size)); first match wins.
# Specs are for the UNSTACKED tensor; a leading layer-stack dim is handled
# by rank offset (None prepended for each extra leading dim).
_RULES: list[tuple[str, Any]] = [
    # embeddings / lm head: vocab dim sharded
    (r"embed/table$",      lambda s, m: (_m(s[0], m), None)),
    (r"lm_head/w$",        lambda s, m: (None, _m(s[1], m))),
    # attention
    (r"attn/wq$|xattn/wq$", lambda s, m: (None, _m(s[1], m))),
    (r"attn/wk$|attn/wv$|xattn/wk$|xattn/wv$",
     lambda s, m: (None, _m(s[1], m))),
    (r"attn/wo$|xattn/wo$", lambda s, m: (_m(s[0], m), None)),
    (r"attn/b[qkv]$",      lambda s, m: (_m(s[0], m),)),
    # MoE: expert-parallel over the expert dim
    (r"moe/router$",       lambda s, m: (None, None)),
    (r"moe/wi_gate$|moe/wi_up$|moe/wo$",
     lambda s, m: (_m(s[0], m), None, None)),
    (r"moe/shared_wi_gate$|moe/shared_wi_up$",
     lambda s, m: (None, _m(s[1], m))),
    (r"moe/shared_wo$",    lambda s, m: (_m(s[0], m), None)),
    # dense MLP
    (r"mlp/wi_gate$|mlp/wi_up$|cm/wk$",
     lambda s, m: (None, _m(s[1], m))),
    (r"mlp/wo$|cm/wv$",    lambda s, m: (_m(s[0], m), None)),
    (r"mlp/bi$",           lambda s, m: (_m(s[0], m),)),
    # SSM projections: z/x (d_inner) shard on model; B/C/dt stay replicated
    (r"ssm/in_[zx]$|ssm/in_proj$|tm/w[rkvg]$|ssm/w[qkvz]$",
     lambda s, m: (None, _m(s[1], m))),
    (r"ssm/in_[BC]$|ssm/in_dt$|ssm/w[ab]$",
     lambda s, m: (None, None)),
    # intentionally replicated ≥2-D tensors (explicit, so the coverage
    # test proves intent, not fall-through)
    (r"ssm/conv_w$|tm/mix$|cm/mix$|cm/wr$|tm/u$|tm/w_lora_[ab]$",
     lambda s, m: (None, None)),
    (r"ssm/out_proj$|tm/wo$",
     lambda s, m: (_m(s[0], m), None)),
    (r"shared_in$",        lambda s, m: (None, None)),
]


def _path_str(path) -> str:
    """A ``device.flatten_tree`` key path as the reference's "a/0/b"."""
    return "/".join(str(p) for p in path)


def param_spec(path_str: str, shape: tuple[int, ...], model_size: int,
               model_axis: str, n_stack_dims: int = 0,
               fsdp_axis: Optional[str] = None,
               fsdp_size: int = 1) -> tuple:
    """The spec of one parameter: the first matching rule's, the model dim
    named ``model_axis``; with ``fsdp_axis`` the largest other dim that
    divides ``fsdp_size`` of a ≥ 2-D tensor also sharded over it; () (all
    replicated) where no rule matches."""
    base_shape = shape[n_stack_dims:]
    for pat, fn in _RULES:
        if re.search(pat, path_str):
            parts = [model_axis if a == "M" else a
                     for a in fn(base_shape, model_size)]
            if fsdp_axis is not None and len(base_shape) >= 2:
                cand = [i for i, a in enumerate(parts)
                        if a is None and base_shape[i] % fsdp_size == 0]
                if cand:
                    parts[max(cand, key=lambda i: base_shape[i])] = fsdp_axis
            return spec(*([None] * n_stack_dims), *parts)
    return ()


def _param_spec_list(params: Any, mesh, model_axis: str,
                     fsdp_axis: Optional[str]) -> list:
    sizes = _axis_sizes(mesh)
    msize = sizes[model_axis]
    fsize = sizes[fsdp_axis] if fsdp_axis else 1
    out = []
    for path, leaf in flatten_tree(params):
        ps = _path_str(path)
        n_stack = 1 if ("layer_stacks" in ps or ps.startswith("encoder")) \
            else 0
        s = param_spec(ps, tuple(leaf.shape), msize, model_axis, n_stack,
                       fsdp_axis, fsize)
        out.append(s[:len(leaf.shape)])
    return out


def param_specs(params: Any, mesh, model_axis: str = "model",
                fsdp_axis: Optional[str] = None) -> Any:
    """Tree of specs for a (layer-stacked) param dict: anything under
    ``layer_stacks`` or ``encoder`` has one leading layer dim."""
    return unflatten_like(params, _param_spec_list(params, mesh, model_axis,
                                                   fsdp_axis))


def placements(s: tuple, mesh) -> tuple:
    """DTensor placements of spec ``s`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim d is sharded over that mesh axis,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = (mesh.axis_names if hasattr(mesh, "axis_names")
             else mesh.mesh_dim_names)
    out = []
    for name in names:
        dims = [d for d, a in enumerate(s)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(params: Any, mesh, model_axis: str = "model",
                    fsdp_axis: Optional[str] = None) -> Any:
    """Tree of DTensor placements for a param dict on ``mesh``: each
    leaf's ``param_specs`` spec through ``placements``."""
    return unflatten_like(params, [
        placements(s, mesh)
        for s in _param_spec_list(params, mesh, model_axis, fsdp_axis)])


def batch_shardings(batch_shape: Any, mesh, data_axes=("data",)) -> Any:
    """Batch arrays: first dim over the data axes where it divides them,
    the rest replicated (the reference's rule; the engine itself slices
    rows by what a column means, ``models/model.rank_rows``)."""
    sizes = _axis_sizes(mesh)
    total = 1
    for a in data_axes:
        total *= sizes[a]

    def one(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        lead = tuple(data_axes) if shape[0] % total == 0 else None
        return spec(lead, *([None] * (len(shape) - 1)))
    return unflatten_like(batch_shape, [one(x) for _, x in
                                        flatten_tree(batch_shape)])


def cache_shardings(cache_shapes: Any, mesh, daxes=("data",),
                    model_axis: str = "model") -> Any:
    """Decode-cache layout: batch dim over the data axes; the KV sequence
    dim (flash-decode style), SSM heads and conv channels over the model
    axis."""
    sizes = _axis_sizes(mesh)
    msize = sizes[model_axis]
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]

    def rule(path, leaf):
        name = str(path[-1])
        shape = tuple(leaf.shape)
        parts: list = [None] * len(shape)
        # batch dim: attn caches [L,B,...] / ssm [L,B,...] / cross valid [B,F]
        bdim = 1 if len(shape) >= 2 and name != "valid" else 0
        if shape[bdim] % dsize == 0 and shape[bdim] >= dsize:
            parts[bdim] = tuple(daxes)
        if name in ("k", "v", "pos") and len(shape) >= 3:
            if shape[2] % msize == 0:
                parts[2] = model_axis
        elif name in ("h", "S") and len(shape) >= 3:
            if shape[2] % msize == 0:          # heads
                parts[2] = model_axis
        elif name == "conv" and len(shape) == 4:
            if shape[3] % msize == 0:
                parts[3] = model_axis
        return spec(*parts)

    return unflatten_like(cache_shapes, [rule(p, x) for p, x in
                                         flatten_tree(cache_shapes)])

