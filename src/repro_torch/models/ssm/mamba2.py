"""Mamba2 (SSD) layer with tree state routing (paper §3.2 adapted).

Port of ``repro/models/ssm/mamba2.py``.  Chunked state-space duality: a
quadratic term within each chunk plus the recurrent state across chunks,
the state routed along the tree (``chunk_parent``) instead of DFS order.
The causal conv gathers path predecessors (``layers.tree_causal_conv``).
The reference's chunk step is split here: the within-chunk term and each
chunk's own state contribution need no incoming state and run for every
chunk at once; the loop carries only h ← exp(Σg)·h + h_new.

State per layer: h [B, H, d_state, head_dim] (+ the conv tail to decode).
Decays are scalar per head and token: g_t = dt_t · (−exp(A_log)) ≤ 0.
A partition's gateway seeds the root chunks' state and the conv's relayed
ancestor inputs; its captures are the state at a cut chunk and the
pre-conv inputs on the path's tail (paper App. B.7).
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


def init_mamba2(generator, cfg: SSMCfg, d_model: int, dtype=torch.float32,
                device=None, lead=()) -> dict:
    """The reference's unfused projections (z, x, B, C, dt); A_log, dt_bias
    and D stay fp32.  ``lead`` prepends stacked-layer dims."""
    di, H = cfg.d_inner(d_model), cfg.n_heads(d_model)
    ds, K = cfg.d_state, cfg.conv_kernel
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_z": _dense_init(generator, (*lead, d_model, di), **kw),
        "in_x": _dense_init(generator, (*lead, d_model, di), **kw),
        "in_B": _dense_init(generator, (*lead, d_model, ds), **kw),
        "in_C": _dense_init(generator, (*lead, d_model, ds), **kw),
        "in_dt": _dense_init(generator, (*lead, d_model, H), **kw),
        "conv_w": _dense_init(generator, (*lead, K, di + 2 * ds), scale=0.5,
                              **kw),
        "conv_b": torch.zeros((*lead, di + 2 * ds), **kw),
        "A_log": torch.zeros((*lead, H), **f32),     # A = −exp(0) = −1
        "dt_bias": torch.full((*lead, H), -1.0, **f32),
        "D": torch.ones((*lead, H), **f32),
        "norm": init_rmsnorm(di, lead=lead, **kw),
        "out_proj": _dense_init(generator, (*lead, di, d_model), **kw),
    }


def _ssd(xh, Bm, Cm, dt, g, chunk_parent, h0=None):
    """SSD over every chunk.  xh [B, C, L, H, hd], Bm/Cm [B, C, L, ds],
    dt/g [B, C, L, H], h0 the root chunks' state [B, H, ds, hd] (zeros if
    None) → (y [B, C, L, H, hd] in xh's dtype, ``tree_chunk_scan``'s list
    of states)."""
    Bsz, _, L, H, hd = xh.shape
    xf, Bf, Cf, dtf = xh.float(), Bm.float(), Cm.float(), dt.float()
    cw = torch.cumsum(g.float(), dim=2)                 # inclusive
    # y_i = Σ_{j≤i} (C_i·B_j) exp(cw_i − cw_j) dt_j x_j: the exponent is
    # masked before exp (j > i would be ≥ 0 and may overflow)
    tri = lower_mask(L, xh.device)[:, :, None]
    D_ij = torch.exp(torch.where(tri, cw[:, :, :, None] - cw[:, :, None],
                                 -torch.inf))          # [B, C, i, j, H]
    CB = torch.einsum("bcis,bcjs->bcij", Cf, Bf)
    W = CB[..., None] * D_ij * dtf[:, :, None]
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", W, xf)
    # each chunk's own state: Σ_j exp(cw_L − cw_j) dt_j B_j ⊗ x_j
    wL = cw[:, :, -1]                                    # [B, C, H]
    dec = torch.exp(wL[:, :, None] - cw) * dtf
    h_new = torch.einsum("bcjs,bcjh,bcjhd->bchsd", Bf, dec, xf)

    def step(h, inp):
        e, hn = inp
        return h, e[..., None, None] * h + hn

    zero = torch.zeros((Bsz, H, Bm.shape[-1], hd), dtype=torch.float32,
                       device=xh.device)
    h_in, states = tree_chunk_scan(step, zero, (torch.exp(wL), h_new),
                                   chunk_parent, h0)
    Ch = torch.einsum("bcis,bchsd->bcihd", Cf, h_in)
    return (y_intra + torch.exp(cw)[..., None] * Ch).to(xh.dtype), states


def _mamba2(params: dict, cfg: SSMCfg, x: torch.Tensor, chunk_parent,
            prev_pows: torch.Tensor, valid: torch.Tensor,
            initial_state=None, conv_ctx=None, capture=None):
    B, S, D = x.shape
    di, H = cfg.d_inner(D), cfg.n_heads(D)
    ds, hd, K, L = cfg.d_state, cfg.head_dim, cfg.conv_kernel, cfg.chunk_size
    z = x @ params["in_z"]
    dt = x @ params["in_dt"]
    # the depthwise conv per stream (the same math as over the
    # concatenation); the gateway's conv context [B, T, conv_dim] keeps the
    # concatenated layout and is sliced per stream
    cw, cb = params["conv_w"], params["conv_b"]
    pp = prev_pows[..., :K - 1]
    pre, streams = [], []
    for name, lo, hi in (("in_x", 0, di), ("in_B", di, di + ds),
                         ("in_C", di + ds, di + 2 * ds)):
        pre.append(x @ params[name])
        streams.append(F.silu(tree_causal_conv(
            pre[-1], cw[:, lo:hi], cb[lo:hi], pp,
            None if conv_ctx is None else conv_ctx[..., lo:hi])))
    xc, Bm, Cm = streams
    dtf = F.softplus(dt.float() + params["dt_bias"])
    dtf = dtf * valid.float()[..., None]       # pads contribute nothing
    g = dtf * -torch.exp(params["A_log"])      # and do not decay the state
    xh = xc.reshape(B, S, H, hd)
    y, states = _ssd(chunkify(xh, L), chunkify(Bm, L), chunkify(Cm, L),
                     chunkify(dtf, L), chunkify(g, L), chunk_parent,
                     None if initial_state is None else initial_state["h"])
    y = (unchunkify(y) + params["D"][:, None] * xh).to(x.dtype)
    y = rmsnorm(params["norm"], y.reshape(B, S, di) * F.silu(z))
    out = y @ params["out_proj"]
    if capture is None:
        return out
    return out, {name: {"state": {"h": states[c["chunk"] + 1]},
                        "conv": torch.cat([p[:, c["conv_pos"]] for p in pre],
                                          -1)}
                 for name, c in capture.items()}


def mamba2(params: dict, cfg: SSMCfg, x: torch.Tensor, *, chunk_parent,
           prev_pows: torch.Tensor, valid: torch.Tensor,
           initial_state=None, conv_ctx=None, capture=None):
    """x [B, S, D] (pre-normed) → [B, S, D].  chunk_parent: host [B, C];
    prev_pows [B, S, ≥K−1]; valid [B, S].  Recomputed in the backward
    (``checkpointed``).

    Partition gateway: ``initial_state`` {"h": [B, H, ds, hd]} seeds the
    root chunks (chunk_parent −1); ``conv_ctx`` [B, T, conv_dim] holds the
    pre-conv inputs of relayed ancestor tokens (prev slots −2, …);
    ``capture`` maps a cut name to {"chunk": host int, "conv_pos": index
    tensor} and makes the call return ``(out, captures)`` with, per cut,
    the state after that chunk and the pre-conv inputs at ``conv_pos``."""
    require_no_model_axis("the Mamba2 layer")
    return checkpointed(
        lambda x_: _mamba2(params, cfg, x_, chunk_parent, prev_pows, valid,
                           initial_state, conv_ctx, capture), x)


# ---------------------------------------------------------------------------
# Decode: one-token recurrence + conv ring
# ---------------------------------------------------------------------------

def init_mamba2_cache(batch: int, cfg: SSMCfg, d_model: int,
                      dtype=torch.float32, device=None, lead=()) -> dict:
    di, H = cfg.d_inner(d_model), cfg.n_heads(d_model)
    return {
        "h": torch.zeros((*lead, batch, H, cfg.d_state, cfg.head_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1,
                             di + 2 * cfg.d_state), dtype=dtype,
                            device=device),
    }


def mamba2_decode(params: dict, cfg: SSMCfg, x: torch.Tensor,
                  cache: dict) -> torch.Tensor:
    """x [B, 1, D] → [B, 1, D]; updates ``cache`` (h, conv) in place."""
    B, _, D = x.shape
    di, H = cfg.d_inner(D), cfg.n_heads(D)
    ds, hd = cfg.d_state, cfg.head_dim
    z = x @ params["in_z"]
    dt = x @ params["in_dt"]
    conv_in = torch.cat([x @ params["in_x"], x @ params["in_B"],
                         x @ params["in_C"]], dim=-1)
    window = torch.cat([cache["conv"], conv_in.to(cache["conv"].dtype)],
                       dim=1)                                # [B, K, conv]
    conv = torch.einsum("bkc,kc->bc", window.float(),
                        params["conv_w"].float())
    conv = F.silu(conv + params["conv_b"])[:, None].to(x.dtype)
    xc, Bm, Cm = torch.split(conv, [di, ds, ds], dim=-1)
    dtf = F.softplus(dt[:, 0].float() + params["dt_bias"])
    g = dtf * -torch.exp(params["A_log"])                    # [B, H]
    xh = xc.reshape(B, H, hd)
    h = cache["h"] * torch.exp(g)[..., None, None] + torch.einsum(
        "bs,bh,bhd->bhsd", Bm[:, 0].float(), dtf, xh.float())
    y = torch.einsum("bs,bhsd->bhd", Cm[:, 0].float(), h)
    y = (y + params["D"][:, None] * xh.float()).to(x.dtype)
    y = rmsnorm(params["norm"], y.reshape(B, 1, di) * F.silu(z))
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return y @ params["out_proj"]
