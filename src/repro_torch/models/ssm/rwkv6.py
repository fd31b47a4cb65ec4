"""RWKV6 ("Finch") time-mix / channel-mix with tree state routing.

Port of ``repro/models/ssm/rwkv6.py``.  Data-dependent per-channel decay:
w_t comes from the token through a low-rank MLP and the state decays per
key channel:

    S_t = diag(w_t) S_{t−1} + k_tᵀ v_t
    o_t = r_t · (S_{t−1} + diag(u) k_tᵀ v_t)        (u: per-channel bonus)

Tree adaptations (paper §3.2): chunk-level tree state routing for S, and
the token shift (every projection mixes x_t with x_{t−1}) reads the path
predecessor (``prev_idx``), not the DFS neighbour.  The within-chunk term
materializes the [L, L, hd] decay differences, all ≤ 0 where used; the
exponent is masked to −inf before ``exp`` (an exp(a)·exp(−b) rewrite
overflows, and 0·inf would make the backward NaN).  That term and each
chunk's own state contribution run for every chunk at once; the loop
carries only S ← exp(Σ log w) ⊙ S + U.  A partition's gateway seeds the
root chunks' state and the token shift of its first tokens; its captures
are the state at a cut chunk and the mixers' inputs at the cut token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMCfg
from repro_torch.models.layers import (_dense_init, gather_prev,
                                       init_rmsnorm, rmsnorm)
from repro_torch.models.ssm.common import (checkpointed, chunkify,
                                           lower_mask, tree_chunk_scan,
                                           unchunkify)
from repro_torch.sharding import require_no_model_axis

LOGW_MIN = -8.0  # per-token decay clamp (exp(−8) ≈ 3e-4), FLA-style


def init_rwkv6_timemix(generator, cfg: SSMCfg, d_model: int,
                       dtype=torch.float32, device=None, lead=()) -> dict:
    H = cfg.n_heads(d_model)
    d_attn = H * cfg.head_dim
    lora_r = max(32, d_model // 32)
    kw = dict(dtype=dtype, device=device)
    return {
        "mix": torch.full((*lead, 5, d_model), 0.5, **kw),  # r,k,v,w,g lerp
        "wr": _dense_init(generator, (*lead, d_model, d_attn), **kw),
        "wk": _dense_init(generator, (*lead, d_model, d_attn), **kw),
        "wv": _dense_init(generator, (*lead, d_model, d_attn), **kw),
        "wg": _dense_init(generator, (*lead, d_model, d_attn), **kw),
        "wo": _dense_init(generator, (*lead, d_attn, d_model), **kw),
        "w0": torch.full((*lead, d_attn), -2.0, dtype=torch.float32,
                         device=device),            # base log-log decay
        "w_lora_a": _dense_init(generator, (*lead, d_model, lora_r), **kw),
        "w_lora_b": _dense_init(generator, (*lead, lora_r, d_attn),
                                scale=0.01, **kw),
        "u": _dense_init(generator, (*lead, H, cfg.head_dim), scale=1.0,
                         dtype=torch.float32, device=device),
        "ln_out": init_rmsnorm(d_attn, lead=lead, **kw),
    }


def _wkv(r, k, v, logw, chunk_parent, S0=None):
    """r, k, v, logw [B, C, L, H, hd]; S0 the root chunks' state
    [B, H, hd, hd] (zeros if None) → (y [B, C, L, H, hd] fp32 without the
    bonus term, ``tree_chunk_scan``'s list of states)."""
    Bsz, _, L, H, hd = r.shape
    rf, kf, vf, lw = r.float(), k.float(), v.float(), logw.float()
    cw = torch.cumsum(lw, dim=2)                         # inclusive
    ecw = cw - lw                                        # exclusive
    # A_ij = Σ_d r_i,d k_j,d exp(ecw_i,d − cw_j,d) for j < i
    strict = lower_mask(L, r.device, -1)[:, :, None, None]
    E = torch.exp(torch.where(strict, ecw[:, :, :, None] - cw[:, :, None],
                              -torch.inf))               # [B,C,i,j,H,hd]
    A = (rf[:, :, :, None] * kf[:, :, None] * E).sum(-1)  # [B,C,i,j,H]
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", A, vf)
    # each chunk's own state: Σ_j diag(exp(cw_L − cw_j)) k_jᵀ v_j
    wL = cw[:, :, -1]                                    # [B, C, H, hd]
    U = torch.einsum("bcjhd,bcjhe->bchde",
                     kf * torch.exp(wL[:, :, None] - cw), vf)

    def step(S, inp):
        e, u = inp
        return S, e[..., None] * S + u

    zero = torch.zeros((Bsz, H, hd, hd), dtype=torch.float32,
                       device=r.device)
    S_in, states = tree_chunk_scan(step, zero, (torch.exp(wL), U),
                                   chunk_parent, S0)
    return y_intra + torch.einsum("bcihd,bchde->bcihe",
                                  rf * torch.exp(ecw), S_in), states


def _timemix(params: dict, cfg: SSMCfg, x: torch.Tensor, chunk_parent,
             prev_idx: torch.Tensor, valid: torch.Tensor, initial_state=None,
             shift_ctx=None, capture=None):
    B, S, D = x.shape
    H, hd, L = cfg.n_heads(D), cfg.head_dim, cfg.chunk_size
    x_prev = gather_prev(x, prev_idx, shift_ctx)        # tree-correct shift
    mix = params["mix"]

    def lerp(i):
        return x + (x_prev - x) * mix[i]

    r = (lerp(0) @ params["wr"]).reshape(B, S, H, hd)
    k = (lerp(1) @ params["wk"]).reshape(B, S, H, hd)
    v = (lerp(2) @ params["wv"]).reshape(B, S, H, hd)
    wx = torch.tanh(lerp(3) @ params["w_lora_a"]) @ params["w_lora_b"]
    logw = -torch.exp(params["w0"] + wx.float())         # ≤ 0
    logw = torch.clamp_min(logw, LOGW_MIN).reshape(B, S, H, hd)
    g = F.silu(lerp(4) @ params["wg"])
    vm = valid[..., None, None].float()
    k = k * vm                                 # pads: no contribution,
    logw = logw * vm                           # no decay
    y, states = _wkv(chunkify(r, L), chunkify(k, L), chunkify(v, L),
                     chunkify(logw, L), chunk_parent,
                     None if initial_state is None else initial_state["S"])
    y = unchunkify(y)
    # bonus term: (r_i ⊙ u ⊙ k_i) · v_i
    rf, kf, vf = r.float(), k.float(), v.float()
    bonus = (rf * (params["u"] * kf)).sum(-1, keepdim=True) * vf
    y = (y + bonus).reshape(B, S, H * hd).to(x.dtype)
    out = (rmsnorm(params["ln_out"], y) * g) @ params["wo"]
    if capture is None:
        return out
    return out, {name: {"state": {"S": states[c["chunk"] + 1]},
                        "shift": x[:, c["shift_pos"]]}
                 for name, c in capture.items()}


def rwkv6_timemix(params: dict, cfg: SSMCfg, x: torch.Tensor, *,
                  chunk_parent, prev_idx: torch.Tensor, valid: torch.Tensor,
                  initial_state=None, shift_ctx=None, capture=None):
    """x [B, S, D] (pre-normed) → [B, S, D], recomputed in the backward
    (``checkpointed``).  chunk_parent: host [B, C].

    Partition gateway: ``initial_state`` {"S": [B, H, hd, hd]} seeds the
    root chunks; ``shift_ctx`` [B, T, D] holds the relayed ancestor inputs
    that prev slots −2, … read; ``capture`` maps a cut name to {"chunk":
    host int, "shift_pos": index tensor} and makes the call return
    ``(out, captures)``: per cut the state after that chunk and the inputs
    at ``shift_pos``."""
    require_no_model_axis("the RWKV6 time-mix")
    return checkpointed(
        lambda x_: _timemix(params, cfg, x_, chunk_parent, prev_idx, valid,
                            initial_state, shift_ctx, capture), x)


def init_rwkv6_channelmix(generator, d_model: int, d_ff: int,
                          dtype=torch.float32, device=None, lead=()) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "mix": torch.full((*lead, 2, d_model), 0.5, **kw),   # k, r
        "wk": _dense_init(generator, (*lead, d_model, d_ff), **kw),
        "wv": _dense_init(generator, (*lead, d_ff, d_model), **kw),
        "wr": _dense_init(generator, (*lead, d_model, d_model), **kw),
    }


def _channelmix(params: dict, x: torch.Tensor,
                x_prev: torch.Tensor) -> torch.Tensor:
    mix = params["mix"]
    xk = x + (x_prev - x) * mix[0]
    xr = x + (x_prev - x) * mix[1]
    kk = F.relu(xk @ params["wk"])
    return torch.sigmoid(xr @ params["wr"]) * ((kk * kk) @ params["wv"])


def rwkv6_channelmix(params: dict, x: torch.Tensor, prev_idx: torch.Tensor,
                     shift_ctx=None, capture=None):
    """x [B, S, D] → [B, S, D]; ``shift_ctx`` and ``capture`` (cut name →
    {"shift_pos"}) as ``rwkv6_timemix``'s, without a state."""
    out = _channelmix(params, x, gather_prev(x, prev_idx, shift_ctx))
    if capture is None:
        return out
    return out, {name: {"shift": x[:, c["shift_pos"]]}
                 for name, c in capture.items()}


# ---------------------------------------------------------------------------
# Decode: per-token recurrence; cache = {S, x_tm, x_cm}
# ---------------------------------------------------------------------------

def init_rwkv6_cache(batch: int, cfg: SSMCfg, d_model: int,
                     dtype=torch.float32, device=None, lead=()) -> dict:
    H, hd = cfg.n_heads(d_model), cfg.head_dim
    return {
        "S": torch.zeros((*lead, batch, H, hd, hd), dtype=torch.float32,
                         device=device),
        "x_tm": torch.zeros((*lead, batch, 1, d_model), dtype=dtype,
                            device=device),
        "x_cm": torch.zeros((*lead, batch, 1, d_model), dtype=dtype,
                            device=device),
    }


def rwkv6_timemix_decode(params: dict, cfg: SSMCfg, x: torch.Tensor,
                         cache: dict) -> torch.Tensor:
    """x [B, 1, D] → [B, 1, D]; updates ``cache`` (S, x_tm) in place."""
    B, _, D = x.shape
    H, hd = cfg.n_heads(D), cfg.head_dim
    x_prev = cache["x_tm"]
    mix = params["mix"]

    def lerp(i):
        return x + (x_prev - x) * mix[i]

    r = (lerp(0) @ params["wr"]).reshape(B, H, hd).float()
    k = (lerp(1) @ params["wk"]).reshape(B, H, hd).float()
    v = (lerp(2) @ params["wv"]).reshape(B, H, hd).float()
    wx = torch.tanh(lerp(3) @ params["w_lora_a"]) @ params["w_lora_b"]
    logw = torch.clamp_min(-torch.exp(params["w0"] + wx.float()),
                           LOGW_MIN).reshape(B, H, hd)
    g = F.silu(lerp(4) @ params["wg"])
    S = cache["S"]
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    o = torch.einsum("bhd,bhde->bhe", r, S + params["u"][None, ..., None] * kv)
    y = o.reshape(B, 1, H * hd).to(x.dtype)
    cache["S"].copy_(torch.exp(logw)[..., None] * S + kv)
    cache["x_tm"].copy_(x)
    return (rmsnorm(params["ln_out"], y) * g) @ params["wo"]


def rwkv6_channelmix_decode(params: dict, x: torch.Tensor,
                            cache: dict) -> torch.Tensor:
    """x [B, 1, D] → [B, 1, D]; updates ``cache["x_cm"]`` in place."""
    y = _channelmix(params, x, cache["x_cm"])
    cache["x_cm"].copy_(x)
    return y
