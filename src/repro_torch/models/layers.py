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
    # F.embedding, not table[tokens]: its CPU backward is deterministic, as
    # the reference's is (the indexing backward accumulates across threads)
    return F.embedding(tokens, params["table"])


def logits_from_hidden(emb_params: dict, head_params: Optional[dict],
                       h: torch.Tensor) -> torch.Tensor:
    """LM head (tied embeddings when head_params is None); fp32 logits."""
    w = emb_params["table"].T if head_params is None else head_params["w"]
    return (h @ w.to(h.dtype)).float()


def init_lm_head(generator, d_model: int, vocab: int, dtype=torch.float32,
                 device=None) -> dict:
    return {"w": _dense_init(generator, (d_model, vocab), dtype=dtype,
                             device=device)}
