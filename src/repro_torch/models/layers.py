"""Shared layer primitives: norms, RoPE, the MLPs, embeddings, the LM head,
and the tree-aware gathers of the SSM layers (token shift and causal conv
along each token's path).

Port of ``repro/models/layers.py``: plain functions on tensors, taking the
reference's parameter dicts (same names, ``x @ W`` orientation) and
matching its rounding points — fp32 reductions in ``rmsnorm``, fp32 angles
in ``rope``, fp32 logits from the head.
On a model axis (``sharding.py``) the embedding and the LM head are
vocab-parallel (each rank holds a block of the vocab's rows: the lookup's
partial sums are reduced over the axis, and the loss combines the ranks'
logsumexps), and the MLP is Megatron's: column-parallel ``wi_*`` and
``bi``, row-parallel ``wo`` through the reference's ``tp_out_proj``.
Under ``deferred_draws`` the random initialisers return ``Draw``
placeholders that ``Draw.realize`` later draws in their creation order,
keeping a block of each (a rank's parameters, drawn as world 1 draws
them, with no full stacked leaf held).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.sharding import model_axis, model_span, model_sum, tp_out_proj


# the largest fp32 draw of ``_dense_init``: one layer of Kimi K2's 384
# experts is 22.5 GB of fp32 as a single draw
_DRAW_BYTES = 4 << 30


_DEFER = threading.local()


def _dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
                dtype=torch.float32, device=None):
    """N(0, 1/fan_in) (or N(0, scale²)) drawn in fp32, cast to ``dtype``.
    A stacked leaf (ndim ≥ 3) is drawn one slice of its leading dim at a
    time into the ``dtype`` tensor, so no fp32 copy of a whole stack exists
    (48 layers of Qwen3-30B-A3B's experts would be 39 GB of it); a slice
    whose fp32 draw would pass ``_DRAW_BYTES`` is drawn a slice of its own
    leading dim at a time, and so on down.  Under ``deferred_draws`` a
    ``Draw`` placeholder instead."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    d = Draw(generator, tuple(shape),
             scale if scale is not None else fan_in ** -0.5, dtype, device)
    pending = getattr(_DEFER, "draws", None)
    if pending is not None:
        pending.append(d)
        return d
    return d.realize()


@dataclass
class Draw:
    """One ``_dense_init`` call, drawn by ``realize``."""
    generator: torch.Generator
    shape: tuple
    scale: float
    dtype: torch.dtype
    device: object

    def realize(self, keep: Optional[tuple] = None) -> torch.Tensor:
        """The draw (the generator advanced as ``_dense_init`` advances
        it), or with ``keep`` = (dim, lo, hi) its block [lo, hi) along
        ``dim``, no stacked leaf's full draw held at once."""
        draw = lambda sh: (torch.randn(sh, generator=self.generator,
                                       dtype=torch.float32,
                                       device=self.device)
                           * self.scale).to(self.dtype)
        if len(self.shape) < 3:
            x = draw(self.shape)
            return x if keep is None else \
                x.narrow(keep[0], keep[1], keep[2] - keep[1]).clone()
        local = list(self.shape)
        if keep is not None:
            local[keep[0]] = keep[2] - keep[1]
        out = torch.empty(local, dtype=self.dtype, device=self.device)
        _fill(out, draw, self.shape, keep)
        return out


@contextmanager
def deferred_draws():
    """``_dense_init`` returns ``Draw`` placeholders in the body; yields
    the list they are appended to, in creation order."""
    old, _DEFER.draws = getattr(_DEFER, "draws", None), []
    try:
        yield _DEFER.draws
    finally:
        _DEFER.draws = old


def _fill(out: Optional[torch.Tensor], draw, shape: tuple,
          keep: Optional[tuple] = None) -> None:
    """``out[i] = draw(shape[1:])`` for each i < shape[0], or recursively
    into ``out[i]`` where that draw's fp32 copy would pass
    ``_DRAW_BYTES``; with ``keep`` = (dim, lo, hi) ``out`` holds only the
    block [lo, hi) of ``dim`` of the full ``shape``.  A block of the
    leading dim (a rank's experts of one layer, where that layer's draw
    is made an expert at a time: one layer of Kimi K2's is 22.5 GB of
    fp32) still draws every slice, so the generator advances as world 1's
    does, and keeps its own; ``out`` None draws and keeps nothing."""
    lead = None
    if keep is not None and keep[0] == 0:
        lead, keep = (keep[1], keep[2]), None
    sub = None if keep is None else (keep[0] - 1, keep[1], keep[2])
    for i in range(shape[0]):
        dst = out
        if out is not None and lead is not None:
            dst = out[i - lead[0]] if lead[0] <= i < lead[1] else None
        elif out is not None:
            dst = out[i]
        if len(shape) > 3 and int(np.prod(shape[1:])) * 4 > _DRAW_BYTES:
            _fill(dst, draw, shape[1:], sub)
            continue
        # no name holds a draw past its copy: the next draw's fp32
        # temporaries may need its memory (Nemotron's cut fills 69 GB)
        if dst is None:
            draw(shape[1:])
        elif sub is None:
            dst.copy_(draw(shape[1:]))
        else:
            dst.copy_(draw(shape[1:]).narrow(sub[0], sub[1],
                                             sub[2] - sub[1]))


def init_rmsnorm(dim: int, dtype=torch.float32, device=None, lead=()) -> dict:
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope(x: torch.Tensor, pos_ids: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: [..., S, H, hd]; pos_ids: [..., S] int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = pos_ids[..., :, None].float() * freqs              # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                    # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(generator, d_model: int, d_ff: int, activation: str = "swiglu",
             bias: bool = False, dtype=torch.float32, device=None,
             lead=()) -> dict:
    """MLP weights in the reference's keys: swiglu has ``wi_gate`` and
    ``wi_up``, the non-gated activations ``wi_up`` alone; ``bias`` adds
    zero ``bi`` [d_ff] and ``bo`` [d_model].  ``lead`` prepends
    stacked-layer dims."""
    kw = dict(dtype=dtype, device=device)
    p: dict = {}
    if activation == "swiglu":
        p["wi_gate"] = _dense_init(generator, (*lead, d_model, d_ff), **kw)
    p["wi_up"] = _dense_init(generator, (*lead, d_model, d_ff), **kw)
    p["wo"] = _dense_init(generator, (*lead, d_ff, d_model), **kw)
    if bias:
        p["bi"] = torch.zeros((*lead, d_ff), **kw)
        p["bo"] = torch.zeros((*lead, d_model), **kw)
    return p


def mlp(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """The reference's ``mlp`` step for step: swiglu; squared_relu, which
    is relu(x @ wi_up + bi)² in x's dtype; relu, which (as the reference)
    adds no ``bi``; then ``wo`` and ``bo``."""
    if activation == "swiglu":
        h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    elif activation == "squared_relu":
        h = x @ params["wi_up"]
        if "bi" in params:
            h = h + params["bi"]
        r = F.relu(h)
        h = r * r
    elif activation == "relu":
        h = F.relu(x @ params["wi_up"])
    else:
        raise ValueError(activation)
    y = tp_out_proj(h, params["wo"])
    if "bo" in params:
        y = y + params["bo"]
    return y


def init_embedding(generator, vocab: int, d_model: int, dtype=torch.float32,
                   device=None) -> dict:
    return {"table": _dense_init(generator, (vocab, d_model), scale=1.0,
                                 dtype=dtype, device=device)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table at ``tokens``.  On a model axis the table is this
    rank's block of the vocab: ids outside it read zeros, and the partial
    rows are summed over the axis (``sharding.model_sum``: under sequence
    parallelism this rank's block of S)."""
    # F.embedding, not table[tokens]: its backward is deterministic on both
    # devices (on CUDA it sorts the token ids and sums each id's rows in
    # order; the indexing backward on the CPU accumulates across threads)
    table = params["table"]
    ax = model_axis()
    if ax is None:
        return F.embedding(tokens, table)
    n = table.shape[0]
    ids = tokens.long() - ax.rank * n
    mine = (ids >= 0) & (ids < n)
    rows = F.embedding(torch.where(mine, ids, 0), table)
    return model_sum(torch.where(mine[..., None], rows, 0.0))


class _TakeRows(torch.autograd.Function):
    """``x[b, idx[b, t]]`` with a deterministic backward.  Several positions
    may read one row (the children of a branching node all read their
    parent's last token), so the backward sums cotangents into shared rows.
    ``torch.gather``'s CUDA backward does that with atomic adds, whose order
    changes from run to run; here a CUDA tensor takes ``index_put_`` with
    ``accumulate=True``, which sorts the indices and sums each row's
    contributions in a fixed order, and a CPU tensor takes ``scatter_add_``,
    which is sequential there (``torch.gather``'s own CPU backward)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.x_shape = x.shape
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        out = g.new_zeros(ctx.x_shape)
        if g.is_cuda:
            rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
            out.index_put_((rows.expand_as(idx), idx), g, accumulate=True)
        else:
            out.scatter_add_(1, idx[..., None].expand_as(g), g)
        return out, None


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x [B, S, D] at idx [B, T] (int64, in range) → [B, T, D],
    differentiable in x with a run-to-run deterministic backward."""
    return _TakeRows.apply(x, idx)


def _head(emb_params: dict, head_params: Optional[dict]) -> torch.Tensor:
    return emb_params["table"].T if head_params is None else head_params["w"]


def logits_from_hidden(emb_params: dict, head_params: Optional[dict],
                       h: torch.Tensor) -> torch.Tensor:
    """LM head (tied embeddings when head_params is None); fp32 logits, on
    a model axis this rank's block of the vocab."""
    return (h @ _head(emb_params, head_params).to(h.dtype)).float()


# fp32 logits per chunk of the loss (1 GiB): a full-width row pair holds
# 8192 × 151936 of them, 5 GB per fp32 copy, several of which the plain
# autograd graph of the loss keeps at once
NLL_CHUNK = 1 << 28


def _lse_and_label(lg: torch.Tensor, labels: torch.Tensor, ax):
    """(logsumexp, the label's logit) of fp32 logits [n, V]; on a model
    axis ``lg`` is this rank's block of the vocab, and both are combined
    over the axis: the max (an all-reduce), then the exponentials' sum
    and the label's logit, held by one rank, in one all-reduce."""
    if ax is None:
        return torch.logsumexp(lg, -1), lg.gather(-1, labels[:, None])[:, 0]
    V = lg.shape[1]
    mx = lg.amax(-1)
    with model_span():
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=ax.group)
    lab = labels - ax.rank * V
    mine = (lab >= 0) & (lab < V)
    pick = lg.gather(-1, torch.where(mine, lab, 0)[:, None])[:, 0]
    both = torch.stack([torch.exp(lg - mx[:, None]).sum(-1),
                        torch.where(mine, pick, 0.0)])
    with model_span():
        dist.all_reduce(both, group=ax.group)
    return mx + torch.log(both[0]), both[1]


class _TokenNLL(torch.autograd.Function):
    """``logsumexp(h @ w) − (h @ w)[label]`` per row of h [N, D], with fp32
    logits made for ``rows`` rows at a time and kept for none: the forward
    saves h, w and each row's logsumexp, and the backward recomputes each
    chunk's logits for ``(softmax − onehot) · g``.  dw sums the chunks in
    fp32, in chunk order.  On a model axis ``ax`` w is this rank's block
    of the vocab (``_lse_and_label``), dw this block's gradient and dh
    this block's share, which the hidden state's ``sharding.tp_in``
    sums."""

    @staticmethod
    def forward(ctx, h, w, labels, rows, ax):
        n = h.shape[0]
        lse = torch.empty(n, dtype=torch.float32, device=h.device)
        nll = torch.empty_like(lse)
        for s in range(0, n, rows):
            lse[s:s + rows], pick = _lse_and_label(
                (h[s:s + rows] @ w).float(), labels[s:s + rows], ax)
            nll[s:s + rows] = lse[s:s + rows] - pick
        ctx.save_for_backward(h, w, labels, lse)
        ctx.rows, ctx.off = rows, 0 if ax is None else ax.rank * w.shape[1]
        return nll

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        rows, g = ctx.rows, g.float()
        dh, dw = torch.empty_like(h), None
        V = w.shape[1]
        for s in range(0, h.shape[0], rows):
            e = s + rows
            p = (h[s:e] @ w).float().sub_(lse[s:e, None]).exp_()
            # one label per row: the scatter never collides
            lab = labels[s:e] - ctx.off
            mine = (lab >= 0) & (lab < V)
            p.scatter_add_(1, torch.where(mine, lab, 0)[:, None],
                           torch.where(mine, -1.0, 0.0)[:, None])
            d = p.mul_(g[s:e, None]).to(h.dtype)
            dh[s:e] = d @ w.T
            part = h[s:e].T @ d
            dw = part.float() if dw is None else dw.add_(part)
        return dh, dw.to(w.dtype), None, None, None


def token_nll(emb_params: dict, head_params: Optional[dict],
              h: torch.Tensor, labels: torch.Tensor,
              chunk: int = NLL_CHUNK) -> torch.Tensor:
    """CE of ``labels`` [...] from hidden rows h [..., D] through the LM
    head, fp32: ``logits_from_hidden`` followed by logsumexp minus the
    label's logit, computed ``chunk`` logits at a time in forward and
    backward (``_TokenNLL``), so the loss holds no full fp32 logits (on a
    model axis, vocab-parallel: no rank holds a row's full logits)."""
    w = _head(emb_params, head_params).to(h.dtype)
    rows = max(1, chunk // w.shape[1])
    nll = _TokenNLL.apply(h.reshape(-1, h.shape[-1]), w,
                          labels.long().reshape(-1), rows, model_axis())
    return nll.reshape(labels.shape)


def init_lm_head(generator, d_model: int, vocab: int, dtype=torch.float32,
                 device=None) -> dict:
    return {"w": _dense_init(generator, (d_model, vocab), dtype=dtype,
                             device=device)}


# --------------------------------------------------------------------------
# Tree-aware gathers (token shift / causal conv by path predecessor)
# --------------------------------------------------------------------------

def gather_prev(x: torch.Tensor, prev_idx: torch.Tensor,
                ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, S, D] at each token's path predecessor prev_idx [B, S]: ≥ 0 a
    row of x, −1 none (zeros), −(2+j) the gateway context ``ctx[:, Tc−1−j]``
    (ctx [B, Tc, D]: slot −2 is the immediate relayed ancestor).  The
    tree-correct replacement for a ``roll(x, 1)`` token shift.  Branch
    points repeat predecessors, so the rows are read with ``take_rows``,
    whose backward sums each row's cotangents in a fixed order."""
    g = take_rows(x, prev_idx.clamp_min(0).long())
    out = torch.where((prev_idx >= 0)[..., None], g, 0.0)
    if ctx is not None:
        Tc = ctx.shape[1]
        ci = Tc + prev_idx + 1                 # −2 → Tc−1, −3 → Tc−2, …
        in_ctx = (prev_idx <= -2) & (ci >= 0)
        gc = take_rows(ctx.to(x.dtype), ci.clamp(0, Tc - 1).long())
        out = torch.where(in_ctx[..., None], gc, out)
    return out.to(x.dtype)


def prev_powers(prev_idx: np.ndarray, k: int) -> np.ndarray:
    """Host-side: the 1..k-th path predecessors of every token, [B, S, k].
    The causal-conv window of token t is x[prev^k(t)], …, x[prev^1(t)],
    x[t] (paper §3.2(ii)).  Gateway slots chain: prev(−(2+j)) = −(3+j);
    prev(−1) = −1."""
    B, S = prev_idx.shape
    out = np.full((B, S, k), -1, dtype=np.int32)
    cur = prev_idx.copy()
    for j in range(k):
        out[:, :, j] = cur
        nxt = np.where(cur <= -2, cur - 1, -1).astype(np.int32)
        valid = cur >= 0
        rows = np.broadcast_to(np.arange(B)[:, None], cur.shape)
        nxt[valid] = prev_idx[rows[valid], cur[valid]]
        cur = nxt
    return out


def tree_causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                     conv_b: Optional[torch.Tensor],
                     prev_pows: torch.Tensor,
                     ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along each token's tree path: x [B, S, D],
    conv_w [K, D] (tap K−1 is the current token), prev_pows [B, S, K−1]
    (prev^1 … prev^(K−1)), ctx as ``gather_prev``'s.  Equal to
    causal_conv1d on each root-to-leaf path on its own."""
    K = conv_w.shape[0]
    acc = x * conv_w[K - 1]
    for j in range(K - 1):
        # tap K−2−j multiplies prev^{j+1}
        acc = acc + gather_prev(x, prev_pows[..., j], ctx) * conv_w[K - 2 - j]
    if conv_b is not None:
        acc = acc + conv_b
    return acc
