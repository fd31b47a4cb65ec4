"""Public tree-attention ops, dispatched by the device of the tensors.

Port of ``repro/kernels/ops.py``.  A tensor on the CPU goes to the plain
versions (``kernels/ref.py``: a dense masked softmax and its backward); a
tensor on a CUDA device goes to the hand-written kernels
(``kernels/tree_attention.py`` forward, ``kernels/tree_attention_bwd.py``
backward), which launch or raise — nothing falls back from one to the
other.  ``TreeAttention`` is the reference's ``custom_vjp`` (:55-89): its
forward saves only the O(S) residuals (q, k, v, kv_last, pos, o, lse) and
its backward recomputes p from ``lse``.

The reference pads an awkward Skv to the TPU sublane multiple and fits
block sizes that divide S; the CUDA kernels mask ragged tails themselves,
so neither step exists here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import tree_attention as _fwd_kernel
from repro_torch.kernels import tree_attention_bwd as _bwd_kernel
from repro_torch.kernels.ref import (tree_attention_bwd_ref,
                                     tree_attention_ref_ext)

BIG = 1 << 30          # kv_last of an always-visible ancestor key


def _forward(q, k, v, kv_last, scale, q_off, window, pos_q, pos_k,
             save_residuals):
    if q.device.type == "cpu":
        return tree_attention_ref_ext(q, k, v, kv_last, scale, q_off=q_off,
                                      window=window, pos_q=pos_q,
                                      pos_k=pos_k, return_lse=save_residuals)
    if q.device.type == "cuda":
        return _fwd_kernel.tree_attention(
            q, k, v, kv_last, scale, q_off=q_off, window=window, pos_q=pos_q,
            pos_k=pos_k, save_residuals=save_residuals)
    raise ValueError(f"tree_attention has no path for device {q.device}")


class TreeAttention(torch.autograd.Function):
    """Differentiable in q, k, v; dk/dv cover the full Skv, so the ancestor
    rows' cotangents flow back through the caller's concatenation."""

    @staticmethod
    def forward(ctx, q, k, v, kv_last, pos_q, pos_k, scale, q_off, window):
        o, lse = _forward(q, k, v, kv_last, scale, q_off, window, pos_q,
                          pos_k, True)
        ctx.save_for_backward(q, k, v, kv_last, pos_q, pos_k, o, lse)
        ctx.scale, ctx.q_off, ctx.window = scale, q_off, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_last, pos_q, pos_k, o, lse = ctx.saved_tensors
        kw = dict(q_off=ctx.q_off, window=ctx.window, pos_q=pos_q,
                  pos_k=pos_k)
        if q.device.type == "cpu":
            dq, dk, dv = tree_attention_bwd_ref(q, k, v, kv_last, o, lse, do,
                                                ctx.scale, **kw)
        else:
            dq, dk, dv = _bwd_kernel.tree_attention_bwd(
                q, k, v, kv_last, o, lse, do.contiguous(), ctx.scale, **kw)
        return dq, dk, dv, None, None, None, None, None, None


def tree_attention(q, k, v, kv_last, scale: float, *, q_off: int = 0,
                   window: Optional[int] = None,
                   pos_q: Optional[torch.Tensor] = None,
                   pos_k: Optional[torch.Tensor] = None,
                   save_residuals: bool = False):
    """Tree attention.  q: [B,S,H,hd]; k/v: [B,Skv,Kh,hd] with Skv ≥
    q_off + S (``q_off`` ancestor keys front-concatenated); kv_last:
    [B,Skv].  ``window`` adds the sliding-window term over positions pos_q
    [B,S] / pos_k [B,Skv].  Differentiable in q, k, v (the k/v cotangents
    cover the ancestor rows too).  With ``save_residuals`` it returns (o,
    lse [B,H,S] f32) instead, recording no gradient.  Unlike the reference
    it takes no ``block_q``/``block_k``: the CUDA kernels' tiles are fixed."""
    if window is None:
        pos_q = pos_k = None
    else:
        pos_q = pos_q.to(torch.int32).contiguous()
        pos_k = pos_k.to(torch.int32).contiguous()
    kv_last = kv_last.to(torch.int32).contiguous()
    if not save_residuals and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return TreeAttention.apply(q, k, v, kv_last, pos_q, pos_k, scale,
                                   q_off, window)
    return _forward(q, k, v, kv_last, scale, q_off, window, pos_q, pos_k,
                    save_residuals)


def prefill_attention(q, k, v, scale: float, *,
                      ctx_k: Optional[torch.Tensor] = None,
                      ctx_v: Optional[torch.Tensor] = None,
                      ctx_valid: Optional[torch.Tensor] = None,
                      window: Optional[int] = None,
                      pos_q: Optional[torch.Tensor] = None,
                      ctx_pos: Optional[torch.Tensor] = None):
    """Shared-prefix prefill: S new chain tokens (q [B,S,H,hd], their roped
    k/v [B,S,Kh,hd]) attend causally to themselves and to a context
    ``ctx_k``/``ctx_v`` [B,A,Kh,hd] that is visible wherever ``ctx_valid``
    [B,A] holds.  The context rides in as gateway ancestors (kv_last =
    2^30, or −1 where invalid) with ``q_off = A``.  Returns [B,S,H,hd]."""
    B, S = q.shape[:2]
    kv_last = torch.full((B, S), S - 1, dtype=torch.int32, device=q.device)
    if ctx_k is None:
        return tree_attention(q, k, v, kv_last, scale, window=window,
                              pos_q=pos_q, pos_k=pos_q)
    A = ctx_k.shape[1]
    ctx_last = torch.full((B, A), BIG, dtype=torch.int32, device=q.device)
    if ctx_valid is not None:
        ctx_last = torch.where(ctx_valid, ctx_last, -1).to(torch.int32)
    pos_k = None
    if window is not None:
        if ctx_pos is None or pos_q is None:
            raise ValueError("window needs pos_q and ctx_pos")
        pos_k = torch.cat([ctx_pos, pos_q], dim=1)
    return tree_attention(q, torch.cat([ctx_k, k], dim=1),
                          torch.cat([ctx_v, v], dim=1),
                          torch.cat([ctx_last, kv_last + A], dim=1),
                          scale, q_off=A,
                          window=window, pos_q=pos_q, pos_k=pos_k)
