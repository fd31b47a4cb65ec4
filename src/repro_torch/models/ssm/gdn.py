"""Gated Delta Net (GDN), the paper's hybrid-model SSM (App. A.2/A.3).

Port of ``repro/models/ssm/gdn.py``.  Per-token recurrence:

    S_t  = exp(g_t) · S_{t−1}
    err  = k_t · S_t − v_t                       (delta rule)
    S_t  = S_t − β_t · k_tᵀ ⊗ err
    o_t  = q_t · S_t                             (post-update read)

In chunked form the within-chunk correction T = (I − A)⁻¹, A the strict
lower (β k kᵀ ⊙ decay), is a unit-lower-triangular solve in fp32.  The
tree adaptation is chunk-level parent state routing (``tree_chunk_scan``)
plus the path-predecessor causal conv.  Everything that needs no incoming
state (T, the corrected values, the decays) runs for every chunk at once;
the loop carries v_new = value_corr − k_cumdecay·S and the state update.
Partition gateways and captures are Mamba2's (``mamba2.mamba2``), with the
state S and the conv over the concatenated q/k/v projections.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMCfg
from repro_torch.models.layers import (_dense_init, init_rmsnorm, rmsnorm,
                                       tree_causal_conv)
from repro_torch.models.ssm.common import (checkpointed, chunkify,
                                           lower_mask, tree_chunk_scan,
                                           unchunkify)
from repro_torch.sharding import require_no_model_axis


def init_gdn(generator, cfg: SSMCfg, d_model: int, dtype=torch.float32,
             device=None, lead=()) -> dict:
    di, H = cfg.d_inner(d_model), cfg.n_heads(d_model)
    K = cfg.conv_kernel
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wq": _dense_init(generator, (*lead, d_model, di), **kw),
        "wk": _dense_init(generator, (*lead, d_model, di), **kw),
        "wv": _dense_init(generator, (*lead, d_model, di), **kw),
        "wz": _dense_init(generator, (*lead, d_model, di), **kw),
        "wa": _dense_init(generator, (*lead, d_model, H), scale=0.1, **kw),
        "wb": _dense_init(generator, (*lead, d_model, H), scale=0.1, **kw),
        "a_bias": torch.zeros((*lead, H), **f32),
        "dt_bias": torch.zeros((*lead, H), **f32),
        "conv_w": _dense_init(generator, (*lead, K, 3 * di), scale=0.5,
                              **kw),
        "conv_b": torch.zeros((*lead, 3 * di), **kw),
        "norm": init_rmsnorm(di, lead=lead, **kw),
        "out_proj": _dense_init(generator, (*lead, di, d_model), **kw),
    }


def _gdn_chunks(q, k, v, g, beta, chunk_parent, S0=None):
    """q, k, v [B, C, L, H, hd]; g (log-decay ≤ 0), beta [B, C, L, H]; S0
    the root chunks' state [B, H, hd, hd] (zeros if None) → (out
    [B, C, L, H, hd] fp32, ``tree_chunk_scan``'s list of states)."""
    Bsz, _, L, H, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    gf, bf = g.float(), beta.float()
    cw = torch.cumsum(gf, dim=2)                         # inclusive
    v_beta = vf * bf[..., None]
    k_beta = kf * bf[..., None]
    tri_inc = lower_mask(L, q.device)
    tri_exc = lower_mask(L, q.device, -1)
    # decay_ij = exp(cw_i − cw_j) for j ≤ i (masked before exp: j > i
    # would be ≥ 0 and may overflow), as [B, C, H, i, j]
    decay = torch.exp(torch.where(
        tri_inc[:, :, None], cw[:, :, :, None] - cw[:, :, None],
        -torch.inf)).permute(0, 1, 4, 2, 3)
    kk = torch.einsum("bcihd,bcjhd->bchij", k_beta, kf)
    A = torch.where(tri_exc, -kk * decay, 0.0)
    eye = torch.eye(L, dtype=torch.float32, device=q.device)
    T = torch.linalg.solve_triangular(eye - A, eye.expand_as(A).contiguous(),
                                      upper=False, unitriangular=True)
    # head-major [B, C, H, L, hd] from here on, so the loop's products are
    # plain batched matmuls
    hm = lambda t: t.permute(0, 1, 3, 2, 4)
    value_corr = T @ hm(v_beta)
    k_cumdecay = T @ hm(k_beta * torch.exp(cw)[..., None])
    attn_within = torch.where(tri_inc, (hm(qf) @ hm(kf).transpose(-1, -2))
                              * decay, 0.0)
    wL = cw[:, :, -1]                                    # [B, C, H]
    k_dec = hm(kf * torch.exp(wL[:, :, None] - cw)[..., None]).contiguous()

    def step(S, inp):
        kcd, vc, ewL, kd = inp
        v_new = vc - kcd @ S
        return (S, v_new), (S * ewL[..., None, None]
                            + kd.transpose(-1, -2) @ v_new)

    zero = torch.zeros((Bsz, H, hd, hd), dtype=torch.float32,
                       device=q.device)
    (S_in, v_new), states = tree_chunk_scan(
        step, zero, (k_cumdecay, value_corr, torch.exp(wL), k_dec),
        chunk_parent, S0)
    out = hm(qf * torch.exp(cw)[..., None]) @ S_in + attn_within @ v_new
    return hm(out), states


def _gdn(params: dict, cfg: SSMCfg, x: torch.Tensor, chunk_parent,
         prev_pows: torch.Tensor, valid: torch.Tensor, initial_state=None,
         conv_ctx=None, capture=None):
    B, S, D = x.shape
    di, H = cfg.d_inner(D), cfg.n_heads(D)
    hd, K, L = cfg.head_dim, cfg.conv_kernel, cfg.chunk_size
    qkv_pre = torch.cat([x @ params["wq"], x @ params["wk"],
                         x @ params["wv"]], dim=-1)
    qkv = F.silu(tree_causal_conv(qkv_pre, params["conv_w"],
                                  params["conv_b"], prev_pows[..., :K - 1],
                                  conv_ctx))
    q, k, v = (t.reshape(B, S, H, hd) for t in qkv.chunk(3, dim=-1))
    k = k / torch.clamp(torch.linalg.vector_norm(k.float(), dim=-1,
                                                 keepdim=True),
                        min=1e-6).to(k.dtype)
    g = -torch.exp(params["a_bias"]) * F.softplus(
        (x @ params["wa"]).float() + params["dt_bias"])
    beta = torch.sigmoid((x @ params["wb"]).float())
    vm = valid.float()[..., None]
    beta = beta * vm                           # pads: no delta write
    g = g * vm                                 # and no decay
    y, states = _gdn_chunks(chunkify(q, L), chunkify(k, L), chunkify(v, L),
                            chunkify(g, L), chunkify(beta, L), chunk_parent,
                            None if initial_state is None
                            else initial_state["S"])
    y = unchunkify(y).reshape(B, S, di).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(x @ params["wz"]))
    out = y @ params["out_proj"]
    if capture is None:
        return out
    return out, {name: {"state": {"S": states[c["chunk"] + 1]},
                        "conv": qkv_pre[:, c["conv_pos"]]}
                 for name, c in capture.items()}


def gdn(params: dict, cfg: SSMCfg, x: torch.Tensor, *, chunk_parent,
        prev_pows: torch.Tensor, valid: torch.Tensor, initial_state=None,
        conv_ctx=None, capture=None):
    """x [B, S, D] (pre-normed) → [B, S, D], recomputed in the backward
    (``checkpointed``); arguments as ``mamba2.mamba2``'s, the state
    {"S": [B, H, hd, hd]}."""
    require_no_model_axis("the GDN layer")
    return checkpointed(
        lambda x_: _gdn(params, cfg, x_, chunk_parent, prev_pows, valid,
                        initial_state, conv_ctx, capture), x)


def init_gdn_cache(batch: int, cfg: SSMCfg, d_model: int,
                   dtype=torch.float32, device=None, lead=()) -> dict:
    H = cfg.n_heads(d_model)
    return {
        "S": torch.zeros((*lead, batch, H, cfg.head_dim, cfg.head_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1,
                             3 * cfg.d_inner(d_model)), dtype=dtype,
                            device=device),
    }


def gdn_decode(params: dict, cfg: SSMCfg, x: torch.Tensor,
               cache: dict) -> torch.Tensor:
    """x [B, 1, D] → [B, 1, D]; updates ``cache`` (S, conv) in place."""
    B, _, D = x.shape
    di, H, hd = cfg.d_inner(D), cfg.n_heads(D), cfg.head_dim
    qkv = torch.cat([x @ params["wq"], x @ params["wk"], x @ params["wv"]],
                    dim=-1)
    window = torch.cat([cache["conv"], qkv.to(cache["conv"].dtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", window.float(),
                        params["conv_w"].float())
    qkv = F.silu(conv + params["conv_b"])[:, None].to(x.dtype)
    q, k, v = (t.reshape(B, H, hd).float() for t in qkv.chunk(3, dim=-1))
    k = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True),
                        min=1e-6)
    g = -torch.exp(params["a_bias"]) * F.softplus(
        (x[:, 0] @ params["wa"]).float() + params["dt_bias"])
    beta = torch.sigmoid((x[:, 0] @ params["wb"]).float())
    S = cache["S"] * torch.exp(g)[..., None, None]
    err = torch.einsum("bhd,bhde->bhe", k, S) - v
    S = S - beta[..., None, None] * torch.einsum("bhd,bhe->bhde", k, err)
    o = torch.einsum("bhd,bhde->bhe", q, S)
    y = rmsnorm(params["norm"],
                o.reshape(B, 1, di).to(x.dtype) * F.silu(x @ params["wz"]))
    cache["S"].copy_(S)
    cache["conv"].copy_(window[:, 1:])
    return y @ params["out_proj"]
