"""Plain PyTorch version of the tree-attention kernel: a dense masked softmax.

Port of ``repro/kernels/ref.py::tree_attention_ref_ext``.  It is what
``ops.tree_attention`` runs for a tensor on the CPU, and what the CUDA
kernel is held against on the card.

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
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qg = q.reshape(B, S, Kh, G, hd)
    # logits in the input dtype, then f32 — the reference's rounding point
    logits = torch.einsum("bikgd,bjkd->bkgij", qg, k).float()
    i_idx = q_off + torch.arange(S, device=q.device)[:, None]
    j_idx = torch.arange(Skv, device=q.device)[None, :]
    vis = (j_idx <= i_idx)[None] & (kv_last[:, None, :] >= i_idx[None])
    if window is not None:
        vis = vis & ((pos_q[:, :, None] - pos_k[:, None, :]) < window)
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
