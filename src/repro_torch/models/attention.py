"""Tree-aware GQA attention (self-attention of the dense decoder).

Port of ``repro/models/attention.py``'s self-attention and decode paths.
The tree mask is driven by the per-key bound ``kv_last``:
visible(i, j) ⇔ j ≤ i ∧ kv_last[j] ≥ i, and with a window also
pos_i − pos_j < window.

Implementations of ``attention``:
  - 'ref'    : materialized mask (the reference's oracle path);
  - 'kernel' : ``kernels/ops.tree_attention`` — the hand-written CUDA kernel
               for tensors on the card, its plain version on the CPU.  The
               counterpart of the reference's 'pallas'.
Cross-attention, bidirectional encoders and the 'chunked' XLA scan are not
ported yet (ROADMAP.md Queue A).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AttnCfg
from repro_torch.models.layers import _dense_init, init_rmsnorm, rmsnorm, rope

NEG_INF = -1e30
BIG = 1 << 30


def init_attention(generator, cfg: AttnCfg, d_model: int, dtype=torch.float32,
                   device=None, lead=()) -> dict:
    """``lead`` prepends stacked-layer dims to every leaf."""
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": _dense_init(generator, (*lead, d_model, cfg.q_dim), **kw),
        "wk": _dense_init(generator, (*lead, d_model, cfg.kv_dim), **kw),
        "wv": _dense_init(generator, (*lead, d_model, cfg.kv_dim), **kw),
        "wo": _dense_init(generator, (*lead, cfg.q_dim, d_model), **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, cfg.q_dim), **kw)
        p["bk"] = torch.zeros((*lead, cfg.kv_dim), **kw)
        p["bv"] = torch.zeros((*lead, cfg.kv_dim), **kw)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(cfg.head_dim, lead=lead, **kw)
        p["k_norm"] = init_rmsnorm(cfg.head_dim, lead=lead, **kw)
    return p


def _project_qkv(params: dict, cfg: AttnCfg, x: torch.Tensor):
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return q, k, v


def _scale(cfg: AttnCfg) -> float:
    return cfg.softmax_scale or cfg.head_dim ** -0.5


def _tree_bias(i_idx, kv_last, pos_q, pos_k, window):
    """Additive mask bias [B, 1, 1, Sq, Sk] from tree metadata."""
    j_idx = torch.arange(kv_last.shape[-1], device=kv_last.device)
    vis = (j_idx[None, None, :] <= i_idx[None, :, None]) & \
          (kv_last[:, None, :] >= i_idx[None, :, None])
    if window is not None:
        vis = vis & ((pos_q[:, :, None] - pos_k[:, None, :]) < window)
    return torch.where(vis, 0.0, NEG_INF)[:, None, None]


def _attend_ref(q, k, v, bias, scale):
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    qg = q.reshape(B, S, Kh, H // Kh, hd)
    logits = torch.einsum("bikgd,bjkd->bkgij", qg, k).float()
    w = torch.softmax(logits * scale + bias, dim=-1)
    o = torch.einsum("bkgij,bjkd->bikgd", w.to(v.dtype), v)
    return o.reshape(B, S, H, hd)


def attention(params: dict, cfg: AttnCfg, x: torch.Tensor, *,
              pos_ids: torch.Tensor, kv_last: torch.Tensor,
              impl: str = "kernel", extra_kv: Optional[dict] = None,
              capture_idx: Optional[dict] = None):
    """Full-sequence (prefill) self-attention.  x: [B, S, D].

    extra_kv: gateway ancestor KV — dict(k, v, pos[, valid]) with k/v
    [B, A, Kh, hd] already roped; ancestors are visible to every query, a
    False in ``valid`` [B, A] hides one.  capture_idx: dict name → index
    array; returns also {name: {k, v}} slices at those positions (the
    session writes them into its cache).
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x)
    q = rope(q, pos_ids, cfg.rope_theta)
    k = rope(k, pos_ids, cfg.rope_theta)

    caps = None
    if capture_idx is not None:
        caps = {name: {"k": k[:, idx], "v": v[:, idx]}
                for name, idx in capture_idx.items()}

    q_off = 0
    k_all, v_all, kl_all, pos_k = k, v, kv_last, pos_ids
    if extra_kv is not None:
        A = extra_kv["k"].shape[1]
        q_off = A
        k_all = torch.cat([extra_kv["k"].to(k.dtype), k], dim=1)
        v_all = torch.cat([extra_kv["v"].to(v.dtype), v], dim=1)
        anc_kl = torch.full((B, A), BIG, dtype=torch.int32, device=x.device)
        if extra_kv.get("valid") is not None:
            anc_kl = torch.where(extra_kv["valid"], anc_kl, -1)
        kl_all = torch.cat(
            [anc_kl.to(torch.int32),
             torch.where(kv_last >= 0, kv_last + A, -1).to(torch.int32)],
            dim=1)
        pos_k = torch.cat([extra_kv["pos"], pos_ids], dim=1)

    if impl == "ref":
        i_idx = q_off + torch.arange(S, device=x.device)
        bias = _tree_bias(i_idx, kl_all, pos_ids, pos_k, cfg.window)
        o = _attend_ref(q, k_all, v_all, bias, _scale(cfg))
    elif impl == "kernel":
        from repro_torch.kernels.ops import tree_attention
        o = tree_attention(q, k_all, v_all, kl_all, _scale(cfg), q_off=q_off,
                           window=cfg.window, pos_q=pos_ids, pos_k=pos_k)
    else:
        raise ValueError(f"attention impl {impl!r}: 'ref' or 'kernel'")
    y = o.reshape(B, S, -1) @ params["wo"]
    if capture_idx is not None:
        return y, caps
    return y


def decode_attention(params: dict, cfg: AttnCfg, x: torch.Tensor,
                     cache: dict, pos: torch.Tensor, write_idx: int
                     ) -> torch.Tensor:
    """One-token decode.  x: [B, 1, D]; cache: one layer's ring buffer
    {k, v [B, T, Kh, hd], pos [B, T]}, which this call updates **in place**
    (slot ``write_idx`` takes the new token); pos: [B] position ids."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(params, cfg, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k_new = rope(k_new, pos[:, None], cfg.rope_theta)
    cache["k"][:, write_idx] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_idx] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][:, write_idx] = pos
    k, v, cpos = cache["k"], cache["v"], cache["pos"]

    vis = (cpos >= 0) & (cpos <= pos[:, None])
    if cfg.window is not None:
        vis = vis & (pos[:, None] - cpos < cfg.window)
    bias = torch.where(vis, 0.0, NEG_INF)[:, None, None]     # [B,1,1,T]
    Kh, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, 1, Kh, G, cfg.head_dim)
    logits = torch.einsum("bikgd,bjkd->bkgij", qg, k.to(q.dtype)).float()
    logits = logits * _scale(cfg) + bias[..., None, :]
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgij,bjkd->bikgd", w.to(v.dtype), v)
    return o.reshape(B, 1, cfg.q_dim) @ params["wo"]
