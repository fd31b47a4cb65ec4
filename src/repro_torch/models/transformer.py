"""Model assembly for the dense and MoE decoders.

Port of the dense and MoE slices of ``repro/models/transformer.py``:
``init_params``, ``forward`` (:316), ``loss_and_metrics`` (:520) and the
session's ``partition_forward``.  Parameters keep the reference's layout —
``layer_stacks[g]`` holds one scan group of same-kind layers with a leading
layer dimension — so the weight bridge is an identity rename.  Layers loop
in Python where the reference scans; each forward unbinds every stacked
leaf once (``_unstack``), so the backward writes each leaf's gradient once
instead of one zero-filled whole stack per layer.  Other families (SSM,
hybrid, enc-dec, VLM) raise: they are later items of ROADMAP.md Queue A,
as is ``remat="full"`` (item 8).  The reference's ``shard_activation`` and
``shard_logits`` are the identity without a device mesh, and the one-card
port has none.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import attention, init_attention
from repro_torch.models.layers import (embed, init_embedding, init_lm_head,
                                       init_mlp, init_rmsnorm,
                                       logits_from_hidden, mlp, rmsnorm)
from repro_torch.models.moe import init_moe, moe


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _layer_kinds(cfg: ModelConfig) -> list[str]:
    """Kind of every decoder layer, in order."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense and moe only); "
            f"see ROADMAP.md Queue A (SSM/hybrid, enc-dec/VLM items)")
    if cfg.mlp_activation != "swiglu" or cfg.mlp_bias:
        raise NotImplementedError("decoder layers are ported with a "
                                  "bias-free swiglu MLP only")
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        return ["dense"] * fd + ["moe"] * (cfg.n_layers - fd)
    return ["dense"] * cfg.n_layers


def layer_groups(cfg: ModelConfig) -> list[tuple[str, int]]:
    """Consecutive same-kind layer runs → (kind, count) groups."""
    groups: list[tuple[str, int]] = []
    for k in _layer_kinds(cfg):
        if groups and groups[-1][0] == k:
            groups[-1] = (k, groups[-1][1] + 1)
        else:
            groups.append((k, 1))
    return groups


def _init_layers(cfg: ModelConfig, kind: str, n: int, generator, dtype,
                 device) -> dict:
    """``n`` layers of ``kind`` stacked along a leading layer dimension
    (each weight's fan-in is its shape[-2], so every layer gets the
    reference's per-layer scale); an MoE layer's router stays fp32."""
    D = cfg.d_model
    kw = dict(dtype=dtype, device=device, lead=(n,))
    p = {"ln1": init_rmsnorm(D, **kw),
         "attn": init_attention(generator, cfg.attn, D, **kw),
         "ln2": init_rmsnorm(D, **kw)}
    if kind == "moe":
        p["moe"] = init_moe(generator, cfg.moe, D, cfg.mlp_activation, **kw)
    else:
        p["mlp"] = init_mlp(generator, D, cfg.d_ff, **kw)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = None) -> dict:
    """Random parameters in the reference's layout, on ``device`` (the CUDA
    device by default).  ``generator`` (seed 0 on ``device`` if None)
    plays the role of the reference's PRNG key; the draws differ from
    JAX's, so cross-package tests bridge JAX's weights instead."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = _dtype(cfg)
    params: dict = {
        "embed": init_embedding(generator, cfg.padded_vocab, cfg.d_model, dt,
                                dev),
        "final_norm": init_rmsnorm(cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_lm_head(generator, cfg.d_model,
                                         cfg.padded_vocab, dt, dev)
    params["layer_stacks"] = [_init_layers(cfg, kind, n, generator, dt, dev)
                              for kind, n in layer_groups(cfg)]
    return params


def _apply_layer(cfg: ModelConfig, p: dict, kind: str, x: torch.Tensor,
                 meta: dict, impl: str, gw=None, capspec=None):
    """One dense or MoE layer.  Returns (x, aux, captures): aux is the MoE
    layer's summed aux losses (f32 scalar), None for a dense layer.  gw:
    this layer's gateway ancestor KV ({"attn": {k, v}}) or None; capspec:
    cut name → {path_idx} positions whose post-rope K/V to capture."""
    eps = cfg.norm_eps
    caps: dict = {}
    cap_idx = None if capspec is None else \
        {n: s["path_idx"] for n, s in capspec.items()}
    egw = (gw or {}).get("attn")
    if egw is not None:
        egw = {**egw, "pos": meta["anc_pos"], "valid": meta.get("anc_valid")}
    a = attention(p["attn"], cfg.attn, rmsnorm(p["ln1"], x, eps),
                  pos_ids=meta["pos_ids"], kv_last=meta["kv_last"],
                  impl=impl, extra_kv=egw, capture_idx=cap_idx)
    if cap_idx is not None:
        a, caps["attn"] = a
    x = x + a
    h = rmsnorm(p["ln2"], x, eps)
    aux = None
    if kind == "moe":
        m, auxd = moe(p["moe"], cfg.moe, h, meta["valid"], cfg.mlp_activation)
        aux = sum(auxd.values())
    else:
        m = mlp(p["mlp"], h, cfg.mlp_activation)
    return x + m, aux, caps


def _unstack(tree, n: int) -> list:
    """All ``n`` layers of a stacked group, one ``torch.unbind`` per leaf:
    views, so a decode step's in-place cache writes land in the stack.
    Its backward stacks the layers' gradients into one [n, …] tensor; a
    select per layer would each backpropagate as a zero-filled tensor of
    the whole stack, which autograd then adds up n times."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return torch.unbind(tree, 0)


def _stack_caps(per_layer: list):
    """[per-layer capture trees] → one tree with a leading layer dim."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack_caps([c[k] for c in per_layer]) for k in first}
    return torch.stack(per_layer)


def partition_forward(cfg: ModelConfig, params: dict, batch: dict, gw_in,
                      capspecs: Optional[dict], impl: str):
    """One DFS forward with gateway inputs and captures (the session's
    parallel prefill).

    gw_in: None or {"g{i}": {"attn": {k, v}}} with a leading layer dim per
    group; ``batch["anc_pos"]``/``["anc_valid"]`` give the ancestors'
    positions and validity.  Returns (hidden, aux, captures): aux the
    summed MoE aux losses, the captures stacked per group like ``gw_in``.
    """
    meta = {k: batch[k] for k in ("pos_ids", "kv_last", "valid", "anc_pos",
                                  "anc_valid") if k in batch}
    x = embed(params["embed"], batch["tokens"])
    gw_in = gw_in or {}
    caps_all: dict = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (stacked, (kind, n)) in enumerate(
            zip(params["layer_stacks"], layer_groups(cfg))):
        gw = gw_in.get(f"g{gi}")
        gws = [None] * n if gw is None else _unstack(gw, n)
        caps = []
        for lp, gl in zip(_unstack(stacked, n), gws):
            x, a, c = _apply_layer(cfg, lp, kind, x, meta, impl, gl,
                                   capspecs)
            if a is not None:
                aux = aux + a
            caps.append(c)
        caps_all[f"g{gi}"] = _stack_caps(caps) if capspecs else {}
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux, caps_all


def forward(cfg: ModelConfig, params: dict, batch: dict,
            impl: str = "kernel") -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden [B, S, D] post-final-norm, aux_loss): the f32 sum of
    the MoE layers' aux losses (zero without MoE layers)."""
    if cfg.remat != "none":
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet; see ROADMAP.md Queue A "
            f"item 8")
    meta = {k: batch[k] for k in ("pos_ids", "kv_last", "valid")}
    x = embed(params["embed"], batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stacked, (kind, n) in zip(params["layer_stacks"], layer_groups(cfg)):
        for lp in _unstack(stacked, n):
            x, a, _ = _apply_layer(cfg, lp, kind, x, meta, impl)
            if a is not None:
                aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def loss_and_metrics(cfg: ModelConfig, params: dict, batch: dict,
                     impl: str = "kernel") -> tuple[torch.Tensor, dict]:
    """Tree loss (Eq. 4): Σ_t λ_t · CE(logits[prev(t)], token_t) / #trees.
    The metrics stay tensors on the device (no host transfer)."""
    hidden, aux = forward(cfg, params, batch, impl)
    prev = batch["prev_idx"]
    w = torch.where(prev >= 0, batch["weight"], 0.0)
    idx = prev.clamp_min(0).long()[..., None]
    h_prev = torch.gather(hidden, 1, idx.expand(-1, -1, hidden.shape[-1]))
    logits = logits_from_hidden(params["embed"], params.get("lm_head"),
                                h_prev)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, batch["tokens"].long()[..., None])[..., 0]
    nll = lse - lab
    nll_sum = torch.sum(w * nll)
    weight_sum = torch.sum(w)
    loss = nll_sum / float(batch.get("num_trees", 1))
    metrics = {"loss": loss, "aux_loss": aux, "weight_sum": weight_sum,
               "nll_sum": nll_sum,
               "token_nll_mean": nll_sum / torch.clamp(weight_sum, min=1e-9)}
    return loss + aux, metrics
