"""Plain PyTorch versions of the tree-attention kernels: a dense masked
softmax and its backward.

Port of ``repro/kernels/ref.py::tree_attention_ref_ext`` and of the vjp the
reference takes through it.  They are what ``ops.tree_attention`` runs for
a tensor on the CPU, and what the CUDA kernels are held against on the
card.

visible(i, j) ⇔ j ≤ q_off + i ∧ kv_last[j] ≥ q_off + i
                [∧ pos_q[i] − pos_k[j] < window]
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def tree_attention_ref_ext(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_last: torch.Tensor, scale: float, *,
                           q_off: int = 0, window: Optional[int] = None,
                           pos_q: Optional[torch.Tensor] = None,
                           pos_k: Optional[torch.Tensor] = None,
                           return_lse: bool = False):
    """q: [B,S,H,hd]; k/v: [B,Skv,Kh,hd] with ``q_off`` front-concatenated
    ancestor keys; kv_last: [B,Skv] → o [B,S,H,hd] in q's dtype, and with
    ``return_lse`` also lse [B,H,S] f32.  A row that sees no key gives
    o = 0 and lse = −1e30."""
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    G = H // Kh
    qg = q.reshape(B, S, Kh, G, hd)
    # logits in the input dtype, then f32 — the reference's rounding point
    logits = torch.einsum("bikgd,bjkd->bkgij", qg, k).float()
    vis = _visible(kv_last, S, q_off, window, pos_q, pos_k)
    bias = torch.where(vis, 0.0, NEG_INF)[:, None, None]
    logits = logits * scale + bias
    w = torch.softmax(logits, dim=-1)
    any_vis = vis.any(dim=-1)[:, None, None, :, None]
    w = torch.where(any_vis, w, 0.0)
    o = torch.einsum("bkgij,bjkd->bikgd", w.to(v.dtype), v).reshape(B, S, H, hd)
    if not return_lse:
        return o
    lse = torch.logsumexp(logits, dim=-1)
    lse = torch.where(any_vis[..., 0], lse, NEG_INF).reshape(B, H, S)
    return o, lse


def _visible(kv_last, S: int, q_off: int, window, pos_q, pos_k):
    """[B, S, Skv] bool visibility of the tree mask."""
    i_idx = q_off + torch.arange(S, device=kv_last.device)[:, None]
    j_idx = torch.arange(kv_last.shape[-1], device=kv_last.device)[None, :]
    vis = (j_idx <= i_idx)[None] & (kv_last[:, None, :] >= i_idx[None])
    if window is not None:
        vis = vis & ((pos_q[:, :, None] - pos_k[:, None, :]) < window)
    return vis


def tree_attention_bwd_ref(q, k, v, kv_last, o, lse, do, scale: float, *,
                           q_off: int = 0, window: Optional[int] = None,
                           pos_q: Optional[torch.Tensor] = None,
                           pos_k: Optional[torch.Tensor] = None):
    """Plain version of the backward kernels: dense p = exp(s − lse) under
    the mask, with the reference's guarded exponent (``_vis_and_p``:
    exp(where(vis, s − lse, −1e30)), then where(vis, ·, 0)), then
    dv = pᵀ·do, ds = p·(do·vᵀ − Δ)·scale, dq = ds·k, dk = dsᵀ·q with
    Δ = rowsum(do∘o).  Everything runs in f32; each GQA group's heads are
    summed in f32 and dq/dk/dv cast to the inputs' dtype once.  Shapes as
    ``tree_attention_ref_ext``; lse is [B,H,S] f32."""
    B, S, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qf = q.float().reshape(B, S, Kh, G, hd)
    dof = do.float().reshape(B, S, Kh, G, hd)
    kf, vf = k.float(), v.float()
    vis = _visible(kv_last, S, q_off, window, pos_q, pos_k)[:, None, None]
    s = torch.einsum("bikgd,bjkd->bkgij", qf, kf) * scale
    lse_g = lse.reshape(B, Kh, G, S)[..., None]
    p = torch.where(vis, torch.exp(torch.where(vis, s - lse_g, NEG_INF)), 0.0)
    dlt = (dof * o.float().reshape(B, S, Kh, G, hd)).sum(-1)    # [B,S,Kh,G]
    dp = torch.einsum("bikgd,bjkd->bkgij", dof, vf)
    ds = p * (dp - dlt.permute(0, 2, 3, 1)[..., None]) * scale
    dv = torch.einsum("bkgij,bikgd->bjkd", p, dof)
    dk = torch.einsum("bkgij,bikgd->bjkd", ds, qf)
    dq = torch.einsum("bkgij,bjkd->bikgd", ds, kf).reshape(B, S, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
