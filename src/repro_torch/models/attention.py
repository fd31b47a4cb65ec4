"""Tree-aware GQA attention: the decoders' self-attention, the enc-dec
model's bidirectional encoder and cross-attention, and the decode step.

Port of ``repro/models/attention.py``.  The tree mask is driven by the
per-key bound ``kv_last``: visible(i, j) ⇔ j ≤ i ∧ kv_last[j] ≥ i, and with
a window also pos_i − pos_j < window.

Implementations of ``attention``:
  - 'ref'     : materialized mask (the reference's oracle path);
  - 'chunked' : an online softmax over key chunks in plain torch ops, the
                reference's ``_attend_chunked`` (:104): memory O(S·chunk)
                in the forward, no kernel;
  - 'kernel'  : ``kernels/ops.tree_attention`` — the hand-written CUDA
                kernel for tensors on the card, its plain version on the
                CPU.  The counterpart of the reference's 'pallas'.
The encoder's bidirectional attention (keys masked by ``valid`` only, no
RoPE) is the plain softmax under 'ref' and 'kernel', as the reference's
'pallas' path takes its oracle for it, and the chunked scan under
'chunked'; the cross-attention over pre-projected encoder K/V is the plain
softmax under every impl.  In training the plain softmax's scores are
recomputed in the backward (``ssm.common.checkpointed``).

On a model axis (``sharding.py``) ``wq``/``wk``/``wv`` and their biases
are column blocks and ``wo`` a row block: the attention runs on this
rank's heads, the kernel at the local head counts, and ``tp_out_proj``
sums the ranks' partial outputs.  Where a rank's columns are not whole
heads (Qwen2-1.5B's two KV heads on a model axis of 4), the projections
are all-gathered over the axis and the rank keeps the heads its ``wo``
rows read (``_local_heads``), its KV heads repeated per query head where
the kept heads do not form whole GQA groups.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AttnCfg
from repro_torch.models.layers import _dense_init, init_rmsnorm, rmsnorm, rope
from repro_torch.models.ssm.common import checkpointed
from repro_torch.sharding import (gather_model, model_axis, model_block,
                                  require_no_model_axis, tp_out_proj)

NEG_INF = -1e30
BIG = 1 << 30


def init_attention(generator, cfg: AttnCfg, d_model: int, dtype=torch.float32,
                   device=None, lead=(), cross: bool = False) -> dict:
    """``lead`` prepends stacked-layer dims to every leaf.  A ``cross``
    block has no q/k norm."""
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
    if cfg.qk_norm and not cross:
        p["q_norm"] = init_rmsnorm(cfg.head_dim, lead=lead, **kw)
        p["k_norm"] = init_rmsnorm(cfg.head_dim, lead=lead, **kw)
    return p


def _local_heads(cfg: AttnCfg, q, k, v):
    """This rank's heads of the projections q [B, S, q_dim/m] and k, v
    [B, S, kv_dim/m] (its column blocks): the query heads that its block
    [c0, c1) of the query columns (and of ``wo``'s rows) touches, and the
    KV heads they read.  A block that cuts a head is all-gathered over the
    model axis first.  Returns (q [B, S, Hl, hd], k, v [B, S, Kl, hd], the
    block's columns within the kept heads' [w0, w1)): Hl a multiple of
    Kl, query head i reading KV head i // (Hl/Kl) (the KV heads repeated
    per query head where the kept heads are not whole GQA groups)."""
    B, S, _ = q.shape
    H, Kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Kh
    c0, c1 = model_block(cfg.q_dim)
    h0, h1 = c0 // hd, -(-c1 // hd)
    k0, k1 = h0 // G, (h1 - 1) // G + 1

    def heads(x, lo, hi, n):
        # this rank's columns [lo, hi) of x; the heads [n0, n1) they need
        n0, n1 = n
        if (lo, hi) != (n0 * hd, n1 * hd):
            x = gather_model(x)[..., n0 * hd:n1 * hd].contiguous()
        return x.reshape(B, S, n1 - n0, hd)

    q = heads(q, c0, c1, (h0, h1))
    e0, e1 = model_block(cfg.kv_dim)
    k, v = (heads(t, e0, e1, (k0, k1)) for t in (k, v))
    Hl, Kl = h1 - h0, k1 - k0
    kv_of = [h // G - k0 for h in range(h0, h1)]
    if Hl % Kl or kv_of != [i // (Hl // Kl) for i in range(Hl)]:
        idx = torch.tensor(kv_of, device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return q, k, v, (c0 - h0 * hd, c1 - h0 * hd)


def _project_qkv(params: dict, cfg: AttnCfg, x: torch.Tensor):
    """(q, k, v) [B, S, heads, hd], and on a model axis the columns of the
    flattened heads' output that this rank's ``wo`` rows read (None
    without one)."""
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    cols = None
    if model_axis() is None:
        q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    else:
        q, k, v, cols = _local_heads(cfg, q, k, v)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return q, k, v, cols


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


def _valid_bias(valid_k):
    """Additive bias [B, 1, 1, 1, Sk] that hides the keys ``valid_k`` [B,
    Sk] marks False: the encoder's and the cross-attention's only mask."""
    return torch.where(valid_k, 0.0, NEG_INF)[:, None, None, None]


def _attend_ref(q, k, v, bias, scale):
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    qg = q.reshape(B, S, Kh, H // Kh, hd)
    logits = torch.einsum("bikgd,bjkd->bkgij", qg, k).float()
    w = torch.softmax(logits * scale + bias, dim=-1)
    o = torch.einsum("bkgij,bjkd->bikgd", w.to(v.dtype), v)
    return o.reshape(B, S, H, hd)


def _chunk_len(Skv: int, kv_chunk: int) -> int:
    """The reference's chunk choice: ``kv_chunk`` (at most Skv) if it
    divides Skv; else the largest divisor of Skv within 4x below it (no
    padding: 1032 → 516); else the power-of-two chunk ≥ kv_chunk/4 (at
    least 8) that pads Skv least, the larger on a tie."""
    kv_chunk = min(kv_chunk, Skv)
    if Skv % kv_chunk == 0:
        return kv_chunk
    lo = max(kv_chunk // 4, 1)
    div = next((d for d in range(kv_chunk, lo - 1, -1) if Skv % d == 0),
               None)
    if div is not None:
        return div
    cands = [c for c in (1 << i for i in range(3, kv_chunk.bit_length()))
             if 4 * c >= kv_chunk] or [8]
    return min(cands, key=lambda c: (-(-Skv // c) * c, -c))


def _attend_chunked(q, k, v, i_idx, kv_last, pos_q, pos_k, window,
                    bidirectional: bool, valid_k, scale, kv_chunk=1024):
    """Online softmax over key chunks (``repro/models/attention.py:104``):
    the running max, sum and f32 accumulator per query and head, rescaled
    as each chunk arrives; a key past Skv (the chunk's padding) is
    invisible.  i_idx [S] the queries' global indices; kv_last, pos_k,
    valid_k [B, Skv]; pos_q [B, S].  ``bidirectional``: a key is visible
    where ``valid_k`` holds, and nothing else is read.  A query that sees
    no key at all gets the mean of the values, as the reference's does."""
    B, S, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    C = _chunk_len(Skv, kv_chunk)
    pad = -Skv % C
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_last = torch.nn.functional.pad(kv_last, (0, pad), value=-1)
        pos_k = torch.nn.functional.pad(pos_k, (0, pad))
        valid_k = torch.nn.functional.pad(valid_k, (0, pad), value=False)
    qg = q.reshape(B, S, Kh, G, hd)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((B, Kh, G, S), NEG_INF, **f32)
    l = torch.zeros((B, Kh, G, S), **f32)
    acc = torch.zeros((B, Kh, G, S, hd), **f32)
    for j0 in range(0, Skv + pad, C):
        sl = slice(j0, j0 + C)
        logits = torch.einsum("bikgd,bjkd->bkgij", qg,
                              k[:, sl]).float() * scale
        if bidirectional:
            vis = valid_k[:, None, sl]
        else:
            jj = j0 + torch.arange(C, device=q.device)
            vis = (jj[None, None, :] <= i_idx[None, :, None]) & \
                  (kv_last[:, None, sl] >= i_idx[None, :, None])
            if window is not None:
                vis = vis & ((pos_q[:, :, None] - pos_k[:, None, sl])
                             < window)
        logits = logits + torch.where(vis, 0.0, NEG_INF)[:, None, None]
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgij,bjkd->bkgid", p.to(v.dtype), v[:, sl]).float()
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-37)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def cross_attention(params: dict, cfg: AttnCfg, x: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Queries ``x`` [B, S, D] over pre-projected encoder K/V [B, T, Kh,
    hd] (``project_cross_kv``), keys masked by ``valid`` [B, T] only: the
    mask is the same for every branch of a tree (the reference's cross
    branch: no bias, norm or RoPE on q).  T may be 0 (a session with no
    encoder output): the term is then 0."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    o = checkpointed(_attend_ref, q, k, v, _valid_bias(valid), _scale(cfg))
    return o.reshape(B, S, -1) @ params["wo"]


def attention(params: dict, cfg: AttnCfg, x: torch.Tensor, *,
              pos_ids: torch.Tensor, kv_last: torch.Tensor,
              impl: str = "kernel", valid: Optional[torch.Tensor] = None,
              bidirectional: bool = False,
              cross_kv: Optional[tuple] = None,
              cross_valid: Optional[torch.Tensor] = None,
              extra_kv: Optional[dict] = None,
              capture_idx: Optional[dict] = None):
    """Full-sequence (train/prefill) attention.  x: [B, S, D].

    bidirectional: the encoder's attention, every ``valid`` [B, S] key
    visible to every query, no RoPE (``kv_last`` unused).  cross_kv: pre-
    projected encoder (k, v) → ``cross_attention`` with ``cross_valid``.
    Neither takes ``extra_kv`` or ``capture_idx``.
    extra_kv: gateway ancestor KV — dict(k, v, pos[, valid]) with k/v
    [B, A, Kh, hd] already roped; ancestors are visible to every query, a
    False in ``valid`` [B, A] hides one.  capture_idx: dict name → index
    array; returns also {name: {k, v}} slices at those positions (the
    session writes them into its cache).
    """
    B, S, _ = x.shape
    if cross_kv is not None:
        return cross_attention(params, cfg, x, *cross_kv, cross_valid)
    q, k, v, cols = _project_qkv(params, cfg, x)
    if bidirectional:
        if impl == "chunked":
            o = _attend_chunked(q, k, v, torch.arange(S, device=x.device),
                                kv_last, pos_ids, pos_ids, None, True, valid,
                                _scale(cfg))
        else:
            o = checkpointed(_attend_ref, q, k, v, _valid_bias(valid),
                             _scale(cfg))
        return o.reshape(B, S, -1) @ params["wo"]
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
        # a full copy of the layer's K/V per call (named for the profiler)
        with torch.profiler.record_function("gateway_kv_cat"):
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
    elif impl == "chunked":
        # the reference's keys (:246-253): its ancestors' validity (all
        # valid without one) ahead of the row's own
        valid_k = (torch.ones((B, S), dtype=torch.bool, device=x.device)
                   if valid is None else valid.bool())
        if extra_kv is not None:
            anc_ok = extra_kv.get("valid")
            if anc_ok is None:
                anc_ok = torch.ones((B, q_off), dtype=torch.bool,
                                    device=x.device)
            valid_k = torch.cat([anc_ok.bool(), valid_k], dim=1)
        o = _attend_chunked(q, k_all, v_all,
                            q_off + torch.arange(S, device=x.device), kl_all,
                            pos_ids, pos_k, cfg.window, False, valid_k,
                            _scale(cfg))
    elif impl == "kernel":
        from repro_torch.kernels.ops import tree_attention
        o = tree_attention(q, k_all, v_all, kl_all, _scale(cfg), q_off=q_off,
                           window=cfg.window, pos_q=pos_ids, pos_k=pos_k)
    else:
        raise ValueError(f"attention impl {impl!r}: 'ref', 'chunked' or "
                         f"'kernel'")
    o = o.reshape(B, S, -1)
    if cols is not None and cols != (0, o.shape[-1]):
        o = o[..., cols[0]:cols[1]]
    y = tp_out_proj(o, params["wo"])
    if capture_idx is not None:
        return y, caps
    return y


def project_cross_kv(params: dict, cfg: AttnCfg, enc_out: torch.Tensor):
    """A cross block's K/V [B, T, Kh, hd] of the encoder output [B, T,
    D]."""
    B, T, _ = enc_out.shape
    k = (enc_out @ params["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ params["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if "bk" in params:
        k = k + params["bk"].reshape(1, 1, cfg.n_kv_heads, cfg.head_dim)
        v = v + params["bv"].reshape(1, 1, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def decode_attention(params: dict, cfg: AttnCfg, x: torch.Tensor,
                     cache: dict, pos: torch.Tensor, write_idx: torch.Tensor,
                     cross_cache: Optional[dict] = None) -> torch.Tensor:
    """One-token decode.  x: [B, 1, D]; cache: one layer's ring buffer
    {k, v [B, T, Kh, hd], pos [B, T]}, which this call updates **in place**
    (slot ``write_idx``, a [1] int64 tensor on the cache's device, takes
    the new token: a device index, so a captured CUDA graph replays with
    the slot of each step); pos: [B] position ids.  cross_cache: {k, v
    [B, T_enc, Kh, hd], valid [B, T_enc]}, whose attention output joins
    the self-attention's before ``wo`` (the reference's ``cross_cache``
    term; the enc-dec decode layer runs its own cross block instead)."""
    require_no_model_axis("serving (the decode step)")
    B = x.shape[0]
    q, k_new, v_new, _ = _project_qkv(params, cfg, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k_new = rope(k_new, pos[:, None], cfg.rope_theta)
    cache["k"].index_copy_(1, write_idx, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, write_idx, v_new.to(cache["v"].dtype))
    cache["pos"].index_copy_(1, write_idx,
                             pos[:, None].to(cache["pos"].dtype))
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
    o = o.reshape(B, 1, cfg.q_dim)
    if cross_cache is not None:
        qc = (x @ params["wq"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
        oc = _attend_ref(qc, cross_cache["k"], cross_cache["v"],
                         _valid_bias(cross_cache["valid"]), _scale(cfg))
        o = o + oc.reshape(B, 1, cfg.q_dim)
    return o @ params["wo"]
