"""Shared layer primitives: norms, RoPE, the MLP, embeddings, the LM head.

Port of the dense slice of ``repro/models/layers.py``: plain functions on
tensors, taking the reference's parameter dicts (same names, ``x @ W``
orientation) and matching its rounding points — fp32 reductions in
``rmsnorm``, fp32 angles in ``rope``, fp32 logits from the head.
The reference's ``tp_out_proj`` is ``h @ w`` without a device mesh, and
the one-card port has no mesh, so it is a plain matmul here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 1/fan_in) (or N(0, scale²)) drawn in fp32, cast to ``dtype``.
    A stacked leaf (ndim ≥ 3) is drawn one slice of its leading dim at a
    time into the ``dtype`` tensor, so no fp32 copy of a whole stack exists
    (48 layers of Qwen3-30B-A3B's experts would be 39 GB of it)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    draw = lambda sh: (torch.randn(sh, generator=generator,
                                   dtype=torch.float32, device=device)
                       * scale).to(dtype)
    if len(shape) < 3:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out


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


def init_mlp(generator, d_model: int, d_ff: int, dtype=torch.float32,
             device=None, lead=()) -> dict:
    """SwiGLU MLP weights (the dense family's activation in the port);
    ``lead`` prepends stacked-layer dims."""
    kw = dict(dtype=dtype, device=device)
    return {"wi_gate": _dense_init(generator, (*lead, d_model, d_ff), **kw),
            "wi_up": _dense_init(generator, (*lead, d_model, d_ff), **kw),
            "wo": _dense_init(generator, (*lead, d_ff, d_model), **kw)}


def mlp(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation != "swiglu":
        raise NotImplementedError(
            f"mlp activation {activation!r} is not ported yet (swiglu only)")
    h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    return h @ params["wo"]


def init_embedding(generator, vocab: int, d_model: int, dtype=torch.float32,
                   device=None) -> dict:
    return {"table": _dense_init(generator, (vocab, d_model), scale=1.0,
                                 dtype=dtype, device=device)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not table[tokens]: its backward is deterministic on both
    # devices (on CUDA it sorts the token ids and sums each id's rows in
    # order; the indexing backward on the CPU accumulates across threads)
    return F.embedding(tokens, params["table"])


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


def logits_from_hidden(emb_params: dict, head_params: Optional[dict],
                       h: torch.Tensor) -> torch.Tensor:
    """LM head (tied embeddings when head_params is None); fp32 logits."""
    w = emb_params["table"].T if head_params is None else head_params["w"]
    return (h @ w.to(h.dtype)).float()


# fp32 logits per chunk of the loss (1 GiB): a full-width row pair holds
# 8192 × 151936 of them, 5 GB per fp32 copy, several of which the plain
# autograd graph of the loss keeps at once
NLL_CHUNK = 1 << 28


class _TokenNLL(torch.autograd.Function):
    """``logsumexp(h @ w) − (h @ w)[label]`` per row of h [N, D], with fp32
    logits made for ``rows`` rows at a time and kept for none: the forward
    saves h, w and each row's logsumexp, and the backward recomputes each
    chunk's logits for ``(softmax − onehot) · g``.  dw sums the chunks in
    fp32, in chunk order."""

    @staticmethod
    def forward(ctx, h, w, labels, rows):
        n = h.shape[0]
        lse = torch.empty(n, dtype=torch.float32, device=h.device)
        nll = torch.empty_like(lse)
        for s in range(0, n, rows):
            lg = (h[s:s + rows] @ w).float()
            lse[s:s + rows] = torch.logsumexp(lg, -1)
            nll[s:s + rows] = lse[s:s + rows] - lg.gather(
                -1, labels[s:s + rows, None])[:, 0]
        ctx.save_for_backward(h, w, labels, lse)
        ctx.rows = rows
        return nll

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        rows, g = ctx.rows, g.float()
        dh, dw = torch.empty_like(h), None
        for s in range(0, h.shape[0], rows):
            e = s + rows
            p = (h[s:e] @ w).float().sub_(lse[s:e, None]).exp_()
            # one label per row: the scatter never collides
            p.scatter_add_(1, labels[s:e, None],
                           p.new_full((p.shape[0], 1), -1.0))
            d = p.mul_(g[s:e, None]).to(h.dtype)
            dh[s:e] = d @ w.T
            part = h[s:e].T @ d
            dw = part.float() if dw is None else dw.add_(part)
        return dh, dw.to(w.dtype), None, None


def token_nll(emb_params: dict, head_params: Optional[dict],
              h: torch.Tensor, labels: torch.Tensor,
              chunk: int = NLL_CHUNK) -> torch.Tensor:
    """CE of ``labels`` [...] from hidden rows h [..., D] through the LM
    head, fp32: ``logits_from_hidden`` followed by logsumexp minus the
    label's logit, computed ``chunk`` logits at a time in forward and
    backward (``_TokenNLL``), so the loss holds no full fp32 logits."""
    w = emb_params["table"].T if head_params is None else head_params["w"]
    w = w.to(h.dtype)
    rows = max(1, chunk // w.shape[1])
    nll = _TokenNLL.apply(h.reshape(-1, h.shape[-1]), w,
                          labels.long().reshape(-1), rows)
    return nll.reshape(labels.shape)


def init_lm_head(generator, d_model: int, vocab: int, dtype=torch.float32,
                 device=None) -> dict:
    return {"w": _dense_init(generator, (d_model, vocab), dtype=dtype,
                             device=device)}
