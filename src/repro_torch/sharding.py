"""Sharding rules: the mesh context, per-tensor partition specs, and the
run-time data and model axes on ``torch.distributed``.

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

At run time every tensor is this rank's: under ``use_mesh`` a batch is
this rank's contiguous block of the step's rows (``models/model.
rank_rows``, over the data axes), and a parameter is its ``param_spec``
block along the model axis (``local_params``).  GSPMD's implicit
collectives become explicit autograd functions:

  - ``tp_in``: a block's input.  Without sequence parallelism the
    identity, whose backward all-reduces over the model axis; with it an
    all-gather along S, whose backward is a reduce-scatter.
  - ``tp_out_proj``: a block's row-parallel output projection, the
    partial products all-reduced over the model axis, or reduce-scattered
    along S under sequence parallelism (backward: an all-gather).
  - ``shard_activation``: the residual stream.  Under sequence
    parallelism a full-length tensor is scattered to this rank's block of
    S (backward: an all-gather); one that is already its block passes.

Where every rank computes a replicated leaf's whole gradient (a norm
scale on the replicated residual stream without sequence parallelism)
the engine takes it as it is; where each computes a share (the q/k norm
scales, which see only the rank's heads; the MoE router, whose combine
reads only the rank's experts; every replicated leaf under sequence
parallelism, whose tokens are split) it sums it over the model axis
(``model_partial``).  A value every rank computes whole and adds to the
loss (the MoE aux losses) passes ``model_share``, so that its gradient
enters the axis's sums once.  The dense and MoE families run on a model
axis (``models/transformer.check_model_axis``; the MoE layer holds the
rank's block of the experts, ``models/moe.py``); the other families,
serving and the RL loop raise ``not_on_model_axis``: ROADMAP item 7e-ii.

The mesh context is module state, not thread-local: the RL service's and
the warm-up's threads see the mesh the launcher entered (the reference
re-enters it in each thread, ``serve/service.py:122-135``).  The length
of the sequence a forward runs (``sequence``) is per thread.
"""
from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.device import flatten_tree, unflatten_like

MODEL_AXIS_TODO = ("ROADMAP.md Queue A item 7e-ii: the port runs the dense "
                   "and MoE families' model axis; FSDP, the SSM, hybrid, "
                   "enc-dec and VLM rules, and serving and the RL loop on "
                   "the axes are still to come")


def not_on_model_axis(what: str) -> NotImplementedError:
    """The refusal of a path not ported to a model axis above 1."""
    return NotImplementedError(f"{what} on a model axis: {MODEL_AXIS_TODO}")


def spec(*parts) -> tuple:
    """A partition spec, a one-name tuple entry written as the name."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


class _Ctx:
    mesh = None
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    seq_parallel: bool = False
    axes: dict = {}              # the mesh's axes (``_axis``), made once


_CTX = _Ctx()
_SEQ = threading.local()


@contextmanager
def use_mesh(mesh, data_axes=("data",), model_axis="model",
             seq_parallel: bool = False):
    """Run the body on ``mesh`` (a ``DeviceMesh``, or None for no mesh):
    its data axes split every step's rows over the ranks, its model axis
    every parameter's ``param_spec`` dim.  ``seq_parallel``: Megatron
    sequence parallelism, the residual stream between blocks split along
    S over the model axis (each block's output projection reduce-scatters
    instead of all-reducing, and its input all-gathers)."""
    old = (_CTX.mesh, _CTX.data_axes, _CTX.model_axis, _CTX.seq_parallel,
           _CTX.axes)
    (_CTX.mesh, _CTX.data_axes, _CTX.model_axis, _CTX.seq_parallel,
     _CTX.axes) = mesh, tuple(data_axes), model_axis, seq_parallel, {}
    try:
        yield
    finally:
        (_CTX.mesh, _CTX.data_axes, _CTX.model_axis, _CTX.seq_parallel,
         _CTX.axes) = old


def current_mesh():
    """The active mesh, if any (seen from every thread)."""
    return _CTX.mesh


def mesh_key():
    """What the active mesh changes in an executable: its axes and sizes,
    which of them are data axes, and sequence parallelism (None without
    a mesh)."""
    if _CTX.mesh is None:
        return None
    return (tuple(_axis_sizes(_CTX.mesh).items()), _CTX.data_axes,
            _CTX.model_axis, _CTX.seq_parallel)


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``MeshDescriptor`` or a ``DeviceMesh``."""
    if hasattr(mesh, "axis_names"):
        return dict(zip(mesh.axis_names, mesh.shape))
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def model_size() -> int:
    """The active mesh's model axis size (1 without a mesh)."""
    if _CTX.mesh is None:
        return 1
    return _axis_sizes(_CTX.mesh).get(_CTX.model_axis, 1)


def require_no_model_axis(what: str) -> None:
    """Raise ``not_on_model_axis(what)`` under a model axis above 1."""
    if model_size() > 1:
        raise not_on_model_axis(what)


@dataclass(frozen=True)
class DataAxis:
    """A mesh axis as one rank sees it: its process group, this rank's
    index on it and its size (the data axes flattened into one)."""
    group: Any
    rank: int
    size: int


def _axis(names: tuple) -> DataAxis:
    mesh = _CTX.mesh
    if names not in _CTX.axes:
        sub = mesh[names[0]] if len(names) == 1 else mesh[names]._flatten()
        _CTX.axes[names] = DataAxis(sub.get_group(), sub.get_local_rank(),
                                    sub.size())
    return _CTX.axes[names]


def data_axis() -> Optional[DataAxis]:
    """The active mesh's data axes as one, or None without a mesh."""
    return None if _CTX.mesh is None else _axis(_CTX.data_axes)


def model_axis() -> Optional[DataAxis]:
    """The active mesh's model axis, or None without a mesh or where it
    has size 1 (every tensor then whole on this rank)."""
    if model_size() == 1:
        return None
    return _axis((_CTX.model_axis,))


def seq_parallel() -> bool:
    """Sequence parallelism is on and the model axis is above 1."""
    return _CTX.seq_parallel and model_size() > 1


@contextmanager
def sequence(S: int):
    """The body runs one forward over rows of ``S`` tokens (what
    ``shard_activation`` tells a full-length tensor from this rank's block
    by).  Under sequence parallelism S must divide the model axis: the
    port refuses the rows the reference would leave unsplit (ROADMAP,
    differs on purpose), since its replicated leaves' gradients are the
    model axis's shares only where every block's tokens were split."""
    if seq_parallel() and S % model_size():
        raise ValueError(f"rows of {S} tokens do not split over a model "
                         f"axis of {model_size()} under sequence "
                         f"parallelism")
    old, _SEQ.S = getattr(_SEQ, "S", None), S
    try:
        yield
    finally:
        _SEQ.S = old


def seq_sharded(S: int) -> bool:
    """True when sequence parallelism is active and a length-``S`` sequence
    dim divides the model axis (the reference's condition)."""
    return (_CTX.mesh is not None and _CTX.seq_parallel
            and S % model_size() == 0)


# ---------------------------------------------------------------------------
# Collectives over the model axis, as autograd functions
# ---------------------------------------------------------------------------

# the profiler range around every model-axis collective (their device time
# is read from it)
MODEL_AXIS_SPAN = "sharding.model_axis"


def model_span():
    return torch.profiler.record_function(MODEL_AXIS_SPAN)


def _gather(x: torch.Tensor, dim: int, ax: DataAxis) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order along ``dim``."""
    with model_span():
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((ax.size * xt.shape[0],) + tuple(xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=ax.group)
        return out.movedim(0, dim)


def _scatter_sum(x: torch.Tensor, dim: int, ax: DataAxis) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``
    (a reduce-scatter; ``reduce_scatter_tensor`` before torch 2.13)."""
    with model_span():
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((xt.shape[0] // ax.size,) + tuple(xt.shape[1:]))
        rs = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        rs(out, xt, group=ax.group)
        return out.movedim(0, dim)


def _sum(x: torch.Tensor, ax: DataAxis) -> torch.Tensor:
    with model_span():
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=ax.group)
        return y


def _block(x: torch.Tensor, dim: int, ax: DataAxis) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n)


class _Sum(torch.autograd.Function):
    """Partial sums → their total on every rank; backward: the identity."""

    @staticmethod
    def forward(ctx, x, ax):
        return _sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """The identity on a replicated tensor whose users each take a share
    of the gradient; backward: the shares all-reduced."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.ax), None


class _Share(torch.autograd.Function):
    """The identity on a value every rank computes whole; backward: this
    rank's 1/m share of the gradient, which the model axis's sums (the
    ``model_partial`` leaves, ``tp_in``'s backward) count m times."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.dim, ctx.ax), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along ``dim``; backward: an all-gather."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _scatter_sum(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.ax), None, None


class _Scatter(torch.autograd.Function):
    """This rank's block along ``dim`` of a replicated tensor; backward:
    the blocks' gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _block(x, dim, ax).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.ax), None, None


def _seq_len(x: torch.Tensor) -> int:
    S = getattr(_SEQ, "S", None)
    return x.shape[1] if S is None else S


def shard_activation(x):
    """[B, S, D] (or [B, S]) activations: the rows are already this rank's
    block of the batch; under sequence parallelism a full-length tensor
    is scattered to this rank's block of S (the reference's constraint),
    and a block passes as it is."""
    ax = model_axis()
    if ax is None or not _CTX.seq_parallel or x.dim() < 2:
        return x
    S = _seq_len(x)
    if x.shape[1] == S:
        return _Scatter.apply(x, 1, ax) if S % ax.size == 0 else x
    if x.shape[1] * ax.size != S:
        raise ValueError(f"activation of length {x.shape[1]} in a forward "
                         f"over {S} tokens on a model axis of {ax.size}")
    return x


def tp_in(x):
    """A block's input [B, S, D] as every rank of the model axis reads
    it: without sequence parallelism the replicated tensor, whose gradient
    the ranks' shares sum to (the backward's all-reduce); with it this
    rank's block of S all-gathered (the backward's reduce-scatter).  Also
    the final hidden state the loss reads."""
    ax = model_axis()
    if ax is None:
        return x
    if _CTX.seq_parallel:
        return _Gather.apply(x, 1, ax)
    return _Copy.apply(x, ax)


def model_sum(y):
    """Partial products [B, S, D] of the model axis's ranks summed: an
    all-reduce, or under sequence parallelism (S dividing the axis) a
    reduce-scatter leaving this rank's block of S."""
    ax = model_axis()
    if ax is None:
        return y
    if y.dim() == 3 and seq_sharded(y.shape[1]):
        return _ReduceScatter.apply(y, 1, ax)
    return _Sum.apply(y, ax)


def model_share(x):
    """A value every rank of the model axis computes whole from replicated
    inputs, on its way into the loss: its value as it is, its gradient
    this rank's share (``_Share``), so the gradient enters once."""
    ax = model_axis()
    if ax is None:
        return x
    return _Share.apply(x, ax.size)


def tp_out_proj(h, w):
    """The output projection ``h @ w`` of a block: h [B, S, F] this rank's
    feature columns, w [F, D] its rows, so each rank's product is a
    partial sum, reduced by ``model_sum`` (the reference's
    ``psum_scatter`` under sequence parallelism, its fall-back to the
    plain all-reduce otherwise)."""
    return model_sum(h @ w)


def gather_model(x, dim: int = -1):
    """Every rank's ``x`` concatenated along ``dim`` (a head dimension
    whose blocks cut heads); backward: a reduce-scatter."""
    ax = model_axis()
    if ax is None:
        return x
    return _Gather.apply(x, dim % x.dim(), ax)


def model_block(n: int) -> tuple[int, int]:
    """This rank's [lo, hi) of a model-sharded dim of size ``n``."""
    ax = model_axis()
    if ax is None:
        return 0, n
    return ax.rank * n // ax.size, (ax.rank + 1) * n // ax.size


def shard_spec(x, *axes):
    """Constrain arbitrary dims ('data', 'model' or None per dim): a
    'model' dim that divides the model axis keeps this rank's block (the
    rows are already this rank's data block)."""
    ax = model_axis()
    if ax is None:
        return x
    for i, a in enumerate(axes):
        if a == "model" and x.shape[i] % ax.size == 0:
            x = _block(x, i, ax)
    return x


def shard_logits(x):
    """[B, S, V]: batch over the data axes (already this rank's rows),
    this rank's block of the vocab where it divides the model axis."""
    ax = model_axis()
    if ax is None or x.shape[-1] % ax.size:
        return x
    return _block(x, x.dim() - 1, ax)


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



# ---------------------------------------------------------------------------
# Parameters at run time: this rank's blocks
# ---------------------------------------------------------------------------

def _stack_dims(path_str: str) -> int:
    return 1 if ("layer_stacks" in path_str
                 or path_str.startswith("encoder")) else 0


def _ps(path) -> str:
    return path if isinstance(path, str) else _path_str(path)


def model_dim(path, ndim: int) -> Optional[int]:
    """The dim of a parameter (or of its gradient or moment, whose paths
    end the same way) that the rules shard over the model axis where it
    divides, or None for a leaf the rules replicate.  On a model axis
    every such dim divides (``local_params`` refuses one that does not),
    so this is the leaf's run-time layout.  ``path``: a ``flatten_tree``
    key path or its "a/0/b" string."""
    path_str = _ps(path)
    n_stack = _stack_dims(path_str)
    for pat, fn in _RULES:
        if re.search(pat, path_str):
            parts = fn((1,) * (ndim - n_stack), 1)
            return next((n_stack + i for i, a in enumerate(parts)
                         if a == "M"), None)
    return None


# the replicated leaves a block applies to the model axis's own heads,
# features or experts: each rank's gradient of one is its share (the MoE
# router's: its combine's gradient covers the rank's experts' slots)
_INSIDE_BLOCK = re.compile(r"(^|/)(attn|mlp|moe)/(?!bo$)")


def model_partial(path, ndim: int) -> bool:
    """Whether this rank's gradient of a replicated leaf is a share that
    the model axis sums: under sequence parallelism every replicated
    leaf's (its tokens are split); otherwise those a block applies to the
    rank's heads (the q/k norm scales) or experts (the MoE router, whose
    combine reads only the rank's experts' slots), since the residual
    stream's leaves see every token on every rank."""
    if model_dim(path, ndim) is not None:
        return False
    return seq_parallel() or bool(_INSIDE_BLOCK.search(_ps(path)))


def local_block(path, shape: tuple, mesh=None
                ) -> Optional[tuple[int, int, int]]:
    """(dim, lo, hi): this rank's block of a full leaf (at ``path``, a
    ``flatten_tree`` key path or its "a/0/b" string) of ``shape`` on
    ``mesh`` (the active one by default), or None where it is whole here.
    A dim the rules would shard that does not divide the model axis is
    refused: the spec replicates it, and the port does not run a
    replicated weight's block on the model axis."""
    mesh = _CTX.mesh if mesh is None else mesh
    if mesh is None:
        return None
    path_str = _ps(path)
    m = _axis_sizes(mesh).get(_CTX.model_axis, 1)
    d = model_dim(path_str, len(shape))
    if m == 1 or d is None:
        return None
    if shape[d] % m:
        raise not_on_model_axis(f"{path_str} {tuple(shape)}: dim {d} does "
                                f"not divide the model axis of {m}")
    r = mesh.get_local_rank(_CTX.model_axis)
    n = shape[d] // m
    return d, r * n, (r + 1) * n


def local_params(params: Any, mesh=None) -> Any:
    """This rank's block (``param_spec`` on ``mesh``, the active mesh by
    default) of every leaf of a full parameter tree (or of an optimizer
    state, whose leaves follow their parameters' rules)."""
    def one(path, leaf):
        b = local_block(path, tuple(leaf.shape), mesh)
        return leaf if b is None else \
            leaf.narrow(b[0], b[1], b[2] - b[1]).clone()
    return unflatten_like(params, [one(p, x) for p, x in
                                   flatten_tree(params)])


def gather_params(params: Any) -> Any:
    """The full leaves of a tree of this rank's blocks: each model-sharded
    leaf all-gathered over the model axis along its dim (every rank of
    the axis takes part, in ``flatten_tree`` order)."""
    ax = model_axis()
    if ax is None:
        return params
    out = []
    for path, leaf in flatten_tree(params):
        d = model_dim(path, leaf.dim())
        out.append(leaf if d is None else _gather(leaf.detach(), d, ax))
    return unflatten_like(params, out)
