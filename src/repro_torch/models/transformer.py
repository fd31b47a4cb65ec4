"""Model assembly: the dense, MoE, SSM and hybrid decoders, the enc-dec
model and the multimodal (VLM) prefix.

Port of ``repro/models/transformer.py``: ``init_params``, ``forward``
(:316, with the Zamba2 hybrid's stages and shared attention block, :360;
the VLM prefix rows, ``_mm_prefix_meta`` :295, and the audio encoder,
``encode``), ``partition_forward`` (:398, the session's prefill and the
partition waves; it refuses the VLM and audio families, as the
reference's does), ``partition_loss`` (:477) and ``loss_and_metrics``
(:520).  Parameters keep the reference's layout —
``layer_stacks[g]`` holds one scan group of same-kind layers with a leading
layer dimension — so the weight bridge is an identity rename.  Layers loop
in Python where the reference scans; each forward unbinds every stacked
leaf once (``_unstack``), so the backward writes each leaf's gradient once
instead of one zero-filled whole stack per layer.  The SSM layers
(``models/ssm``) take the batch's host ``chunk_parent`` and device
``prev_pows``, and in a partition their gateway state and conv or shift
context.  An enc-dec model also holds ``encoder`` (one stacked group of
bidirectional layers) and ``enc_norm``; each decoder layer also ``ln_x``
and the cross block ``xattn``.  ``remat="full"`` recomputes each layer
in the backward (the reference's ``jax.checkpoint`` on its scan body,
:282-286): every layer that the reference scans, one at a time, but not
the hybrid's shared block, which the reference applies outside its scan.
The reference's ``shard_activation`` follows every residual add, as
there (``sharding.py``: the identity on a data axis, where each rank's
rows are its block of the batch).  On a model axis the dense and MoE families
run Megatron's layout: each block's input passes ``sharding.tp_in``
(under sequence parallelism the all-gather of the residual stream's S
blocks), its output projection ``tp_out_proj`` sums the ranks' partial
products (under sequence parallelism a reduce-scatter back to S blocks),
and the final hidden state passes ``tp_in`` on its way to the
vocab-parallel loss; an MoE layer runs the rank's block of the experts
and sums its output the same way (``models/moe.py``); ``init_params``
draws every leaf as world 1 does and keeps this rank's block.  The other
families refuse the model axis (``check_model_axis``: ROADMAP item
7e-ii).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import (DeviceLike, flatten_tree, map_tree,
                               resolve_device, unflatten_like)
from repro_torch.models.attention import (attention, init_attention,
                                          project_cross_kv)
from repro_torch.models.layers import (Draw, _dense_init, deferred_draws,
                                       embed, init_embedding, init_lm_head,
                                       init_mlp, init_rmsnorm, mlp, rmsnorm,
                                       take_rows, token_nll)
from repro_torch.models.moe import init_moe, moe
from repro_torch.models.ssm.common import checkpointed
from repro_torch.models.ssm.gdn import gdn, init_gdn
from repro_torch.models.ssm.mamba2 import init_mamba2, mamba2
from repro_torch.models.ssm.rwkv6 import (init_rwkv6_channelmix,
                                          init_rwkv6_timemix,
                                          rwkv6_channelmix, rwkv6_timemix)
from repro_torch.sharding import (local_block, model_size,
                                  not_on_model_axis, sequence,
                                  shard_activation, tp_in)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _layer_kinds(cfg: ModelConfig) -> list[str]:
    """Kind of every decoder layer, in order (the hybrid's shared attention
    block and the enc-dec model's encoder are not layers of the stack)."""
    if cfg.family in ("dense", "vlm"):
        return ["dense"] * cfg.n_layers
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        return ["dense"] * fd + ["moe"] * (cfg.n_layers - fd)
    if cfg.family == "ssm" and cfg.ssm.kind in ("rwkv6", "gdn"):
        return [cfg.ssm.kind] * cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        return ["mamba2"] * cfg.n_layers
    if cfg.family == "audio":
        return ["decoder_cross"] * cfg.encdec.dec_layers
    raise ValueError(cfg.family)


def layer_groups(cfg: ModelConfig) -> list[tuple[str, int]]:
    """Consecutive same-kind layer runs → (kind, count) groups."""
    groups: list[tuple[str, int]] = []
    for k in _layer_kinds(cfg):
        if groups and groups[-1][0] == k:
            groups[-1] = (k, groups[-1][1] + 1)
        else:
            groups.append((k, 1))
    return groups


def _init_layers(cfg: ModelConfig, kind: str, lead: tuple, generator, dtype,
                 device) -> dict:
    """Layers of ``kind`` stacked along the leading dims ``lead`` ((n,) for
    a group of n, () for the hybrid's shared block); each weight's fan-in
    is its shape[-2], so every layer gets the reference's per-layer
    scale.  An MoE layer's router stays fp32, as do the SSM layers' decay
    and skip parameters.  An ``encoder`` layer has a dense layer's leaves,
    a ``decoder_cross`` layer also ``ln_x`` and the cross block ``xattn``
    (no q/k norm)."""
    D = cfg.d_model
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {"ln1": init_rmsnorm(D, **kw)}
    if kind in ("dense", "moe", "encoder", "decoder_cross"):
        p["attn"] = init_attention(generator, cfg.attn, D, **kw)
        if kind == "decoder_cross":
            p["ln_x"] = init_rmsnorm(D, **kw)
            p["xattn"] = init_attention(generator, cfg.attn, D, cross=True,
                                        **kw)
        p["ln2"] = init_rmsnorm(D, **kw)
        if kind == "moe":
            p["moe"] = init_moe(generator, cfg.moe, D, cfg.mlp_activation,
                                **kw)
        else:
            p["mlp"] = init_mlp(generator, D, cfg.d_ff, cfg.mlp_activation,
                                cfg.mlp_bias, **kw)
    elif kind == "rwkv6":
        p["tm"] = init_rwkv6_timemix(generator, cfg.ssm, D, **kw)
        p["ln2"] = init_rmsnorm(D, **kw)
        p["cm"] = init_rwkv6_channelmix(generator, D, cfg.d_ff, **kw)
    elif kind == "mamba2":
        p["ssm"] = init_mamba2(generator, cfg.ssm, D, **kw)
    elif kind == "gdn":
        p["ssm"] = init_gdn(generator, cfg.ssm, D, **kw)
        p["ln2"] = init_rmsnorm(D, **kw)
        p["mlp"] = init_mlp(generator, D, cfg.d_ff, cfg.mlp_activation,
                            cfg.mlp_bias, **kw)
    else:
        raise ValueError(kind)
    return p


# the families the port runs on a model axis above 1
MODEL_AXIS_FAMILIES = ("dense", "moe")


def check_model_axis(cfg: ModelConfig, m: Optional[int] = None) -> None:
    """Refuse a model axis of ``m`` (the active mesh's by default) above 1
    where the port does not run it: any family but the dense and MoE ones
    and any frontend (ROADMAP item 7e-ii), and a model whose vocab, query,
    KV or FFN width (the dense layers'), expert count or shared-expert
    width does not divide the axis (the spec would replicate that weight,
    which the port does not run)."""
    m = model_size() if m is None else m
    if m == 1:
        return
    if cfg.family not in MODEL_AXIS_FAMILIES or cfg.frontend is not None:
        raise not_on_model_axis(f"the {cfg.family} family ({cfg.name})")
    a = cfg.attn
    widths = [("vocab", cfg.padded_vocab), ("query width", a.q_dim),
              ("KV width", a.kv_dim)]
    if "dense" in _layer_kinds(cfg):
        widths.append(("FFN width", cfg.d_ff))
    if cfg.family == "moe":
        widths.append(("expert count", cfg.moe.num_experts))
        if cfg.moe.num_shared_experts:
            widths.append(("shared-expert width", cfg.moe.d_expert
                           * cfg.moe.num_shared_experts))
    for what, n in widths:
        if n % m:
            raise not_on_model_axis(f"{cfg.name}'s {what} {n}, which does "
                                    f"not divide a model axis of {m},")


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = None) -> dict:
    """Random parameters in the reference's layout, on ``device`` (the CUDA
    device by default).  ``generator`` (seed 0 on ``device`` if None)
    plays the role of the reference's PRNG key; the draws differ from
    JAX's, so cross-package tests bridge JAX's weights instead.  On a
    model axis each rank makes every draw world 1 makes, in its order,
    and keeps its ``sharding.local_block`` of each leaf: world 1's
    parameters, no stacked leaf drawn whole at once (``layers.Draw``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if model_size() == 1:
        return _init_params(cfg, generator, dev)
    check_model_axis(cfg)
    with deferred_draws() as draws:
        tree = _init_params(cfg, generator, dev)
    flat = flatten_tree(tree)
    keep = {id(x): local_block(p, x.shape) for p, x in flat}
    made = {id(d): d.realize(keep[id(d)]) for d in draws}

    def local(x):
        if isinstance(x, Draw):
            return made[id(x)]
        b = keep[id(x)]
        return x if b is None else x.narrow(b[0], b[1], b[2] - b[1]).clone()
    return unflatten_like(tree, [local(x) for _, x in flat])


def _init_params(cfg: ModelConfig, generator, dev) -> dict:
    dt = _dtype(cfg)
    params: dict = {
        "embed": init_embedding(generator, cfg.padded_vocab, cfg.d_model, dt,
                                dev),
        "final_norm": init_rmsnorm(cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_lm_head(generator, cfg.d_model,
                                         cfg.padded_vocab, dt, dev)
    params["layer_stacks"] = [_init_layers(cfg, kind, (n,), generator, dt,
                                           dev)
                              for kind, n in layer_groups(cfg)]
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_layers(cfg, "dense", (), generator, dt,
                                             dev)
        if cfg.hybrid.concat_embed:
            params["shared_in"] = _dense_init(
                generator, (2 * cfg.d_model, cfg.d_model), dtype=dt,
                device=dev)
    if cfg.family == "audio":
        params["encoder"] = _init_layers(cfg, "encoder",
                                         (cfg.encdec.enc_layers,), generator,
                                         dt, dev)
        params["enc_norm"] = init_rmsnorm(cfg.d_model, dt, dev)
    return params


def _apply_layer(cfg: ModelConfig, p: dict, kind: str, x: torch.Tensor,
                 meta: dict, impl: str, gw=None, capspec=None):
    """One layer (of a decoder, or the enc-dec model's ``encoder``: its
    attention bidirectional over ``meta["valid"]``; a ``decoder_cross``
    layer also attends to ``meta["enc_out"]`` under ``meta["enc_valid"]``).
    Returns (x, aux, captures): aux is the MoE
    layer's summed aux losses (f32 scalar), None for other kinds.  gw:
    this layer's gateway or None — ancestor KV {"attn": {k, v}}; RWKV6
    {"tm": {state, shift}, "cm": {shift}}; Mamba2 and GDN {"ssm": {state,
    conv}}.  capspec: cut name → {path_idx, cut_chunk (host int),
    conv_pos, shift_pos}, the positions (and the chunk) whose K/V, state
    and conv or shift inputs to capture; the captures mirror ``gw``."""
    eps = cfg.norm_eps
    caps: dict = {}
    gw = gw or {}
    if kind in ("rwkv6", "mamba2", "gdn"):
        h = rmsnorm(p["ln1"], x, eps)
        ssm_kw = dict(chunk_parent=meta["chunk_parent"], valid=meta["valid"])
        if kind == "rwkv6":
            gtm, gcm = gw.get("tm", {}), gw.get("cm", {})
            cap = None if capspec is None else \
                {n: {"chunk": s["cut_chunk"], "shift_pos": s["shift_pos"]}
                 for n, s in capspec.items()}
            t = rwkv6_timemix(p["tm"], cfg.ssm, h, prev_idx=meta["prev_idx"],
                              initial_state=gtm.get("state"),
                              shift_ctx=gtm.get("shift"), capture=cap,
                              **ssm_kw)
            if cap is not None:
                t, caps["tm"] = t
            x = shard_activation(x + t)
            cap = None if capspec is None else \
                {n: {"shift_pos": s["shift_pos"]} for n, s in capspec.items()}
            c = rwkv6_channelmix(p["cm"], rmsnorm(p["ln2"], x, eps),
                                 meta["prev_idx"], gcm.get("shift"), cap)
            if cap is not None:
                c, caps["cm"] = c
            return shard_activation(x + c), None, caps
        gs = gw.get("ssm", {})
        cap = None if capspec is None else \
            {n: {"chunk": s["cut_chunk"], "conv_pos": s["conv_pos"]}
             for n, s in capspec.items()}
        layer = mamba2 if kind == "mamba2" else gdn
        y = layer(p["ssm"], cfg.ssm, h, prev_pows=meta["prev_pows"],
                  initial_state=gs.get("state"), conv_ctx=gs.get("conv"),
                  capture=cap, **ssm_kw)
        if cap is not None:
            y, caps["ssm"] = y
        x = shard_activation(x + y)
        if kind == "gdn":
            x = shard_activation(x + mlp(p["mlp"], rmsnorm(p["ln2"], x, eps),
                                         cfg.mlp_activation))
        return x, None, caps
    if kind == "decoder_cross":
        x = x + attention(p["attn"], cfg.attn, rmsnorm(p["ln1"], x, eps),
                          pos_ids=meta["pos_ids"], kv_last=meta["kv_last"],
                          impl=impl)
        kv = project_cross_kv(p["xattn"], cfg.attn, meta["enc_out"])
        x = x + attention(p["xattn"], cfg.attn, rmsnorm(p["ln_x"], x, eps),
                          pos_ids=meta["pos_ids"], kv_last=meta["kv_last"],
                          cross_kv=kv, cross_valid=meta["enc_valid"])
        return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, eps),
                       cfg.mlp_activation), None, caps
    cap_idx = None if capspec is None else \
        {n: s["path_idx"] for n, s in capspec.items()}
    egw = gw.get("attn")
    if egw is not None:
        egw = {**egw, "pos": meta["anc_pos"], "valid": meta.get("anc_valid")}
    a = attention(p["attn"], cfg.attn, tp_in(rmsnorm(p["ln1"], x, eps)),
                  pos_ids=meta["pos_ids"], kv_last=meta["kv_last"],
                  valid=meta["valid"], impl=impl,
                  bidirectional=kind == "encoder", extra_kv=egw,
                  capture_idx=cap_idx)
    if cap_idx is not None:
        a, caps["attn"] = a
    x = shard_activation(x + a)
    h = tp_in(rmsnorm(p["ln2"], x, eps))
    aux = None
    if kind == "moe":
        m, auxd = moe(p["moe"], cfg.moe, h, meta["valid"], cfg.mlp_activation)
        aux = sum(auxd.values())
    else:
        m = mlp(p["mlp"], h, cfg.mlp_activation)
    return shard_activation(x + m), aux, caps


def _layer(cfg: ModelConfig, *args):
    """``_apply_layer(cfg, *args)``, with ``remat="full"`` under a
    non-reentrant checkpoint of its own (``ssm.common.checkpointed``): the
    backward recomputes the layer from its input instead of keeping its
    internals.  Where nothing it reads requires grad (a decode step, a
    prefill, a forward sweep under ``no_grad``) the layer runs as it is."""
    if cfg.remat == "full":
        return checkpointed(_apply_layer, cfg, *args)
    if cfg.remat != "none":
        raise ValueError(f"remat={cfg.remat!r}: 'none' or 'full'")
    return _apply_layer(cfg, *args)


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
    """One DFS forward with gateway inputs and captures (a partition wave,
    and the session's parallel prefill).

    gw_in: None or {"g{i}": per-group gateway with a leading layer dim
    (``_apply_layer``'s per-kind layout)}, and for the hybrid
    {"shared{s}": {"attn": {k, v}}} per application s of the shared
    block, with a leading layer axis of 1; ``batch["anc_pos"]``/
    ``["anc_valid"]`` give the ancestors' positions and validity.  Returns
    (hidden, aux, captures): aux the summed MoE aux losses, the captures
    stacked like ``gw_in``.  The VLM and audio families raise, as the
    reference's do (``transformer.py:414``): their prefix and encoder are
    not partitioned.
    """
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            "partitioned training currently covers dense/moe/ssm/hybrid")
    check_model_axis(cfg)
    with sequence(batch["tokens"].shape[1]):
        return _partition_forward(cfg, params, batch, gw_in, capspecs, impl)


def _partition_forward(cfg: ModelConfig, params: dict, batch: dict, gw_in,
                       capspecs: Optional[dict], impl: str):
    meta = {k: batch[k] for k in ("pos_ids", "kv_last", "valid", "prev_idx",
                                  "chunk_parent", "prev_pows", "anc_pos",
                                  "anc_valid") if k in batch}
    x = shard_activation(embed(params["embed"], batch["tokens"]))
    gw_in = gw_in or {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        x, caps_all = _hybrid_forward(cfg, params, x, meta, impl, gw_in,
                                      capspecs)
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux, caps_all
    caps_all: dict = {}
    for gi, (stacked, (kind, n)) in enumerate(
            zip(params["layer_stacks"], layer_groups(cfg))):
        gw = gw_in.get(f"g{gi}")
        gws = [None] * n if gw is None else _unstack(gw, n)
        caps = []
        for lp, gl in zip(_unstack(stacked, n), gws):
            x, a, c = _layer(cfg, lp, kind, x, meta, impl, gl, capspecs)
            if a is not None:
                aux = aux + a
            caps.append(c)
        caps_all[f"g{gi}"] = _stack_caps(caps) if capspecs else {}
    return tp_in(rmsnorm(params["final_norm"], x, cfg.norm_eps)), aux, \
        caps_all


def _mm_prefix_meta(batch: dict) -> dict:
    """The text columns behind a multimodal prefix of F embedding rows:
    the prefix takes positions 0..F−1 and is visible to every later token
    of its row (kv_last = F + S − 1), causal within itself; the text's
    positions and DFS indices shift by F (−1 stays −1)."""
    F = batch["extra_embeds"].shape[1]
    B, S = batch["tokens"].shape
    dev = batch["tokens"].device
    i32 = dict(dtype=torch.int32, device=dev)

    def shift(a):
        return torch.where(a >= 0, a + F, -1).to(torch.int32)

    return dict(
        pos_ids=torch.cat([torch.arange(F, **i32).expand(B, F),
                           batch["pos_ids"] + F], dim=1).to(torch.int32),
        kv_last=torch.cat([torch.full((B, F), F + S - 1, **i32),
                           shift(batch["kv_last"])], dim=1),
        prev_idx=torch.cat([torch.full((B, F), -1, **i32),
                            shift(batch["prev_idx"])], dim=1),
        valid=torch.cat([torch.ones((B, F), dtype=torch.bool, device=dev),
                         batch["valid"].bool()], dim=1),
        prefix_len=F)


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           valid: Optional[torch.Tensor] = None, impl: str = "kernel"):
    """The enc-dec model's encoder over frame embeddings [B, T, D]:
    bidirectional layers over the frames ``valid`` [B, T] marks (all by
    default), then ``enc_norm``.  Returns (enc_out [B, T, D], valid)."""
    B, T = frames.shape[:2]
    dev = frames.device
    if valid is None:
        valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    meta = dict(pos_ids=torch.arange(T, dtype=torch.int32,
                                     device=dev).expand(B, T),
                kv_last=torch.full((B, T), T - 1, dtype=torch.int32,
                                   device=dev),
                prev_idx=torch.full((B, T), -1, dtype=torch.int32,
                                    device=dev),
                valid=valid)
    x = frames.to(_dtype(cfg))
    for lp in _unstack(params["encoder"], cfg.encdec.enc_layers):
        x, _, _ = _layer(cfg, lp, "encoder", x, meta, impl)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps), valid


def forward(cfg: ModelConfig, params: dict, batch: dict,
            impl: str = "kernel") -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden [B, S, D] post-final-norm, aux_loss): the f32 sum of
    the MoE layers' aux losses (zero without MoE layers).  SSM and hybrid
    batches also carry ``chunk_parent`` (host) and ``prev_pows``.  A VLM
    batch's ``extra_embeds`` [B, F, D] are a prefix of every row, sliced
    off the hidden states again; an audio batch's are the encoder's
    frames (``extra_valid`` [B, F] masks them, all valid by default)."""
    check_model_axis(cfg)
    with sequence(batch["tokens"].shape[1]):
        return _forward(cfg, params, batch, impl)


def _forward(cfg: ModelConfig, params: dict, batch: dict, impl: str):
    meta = {k: batch[k] for k in ("pos_ids", "kv_last", "valid", "prev_idx",
                                  "chunk_parent", "prev_pows") if k in batch}
    x = shard_activation(embed(params["embed"], batch["tokens"]))
    F = 0
    if cfg.family == "vlm" or (cfg.frontend and cfg.family != "audio"):
        meta.update(_mm_prefix_meta(batch))
        F = meta.pop("prefix_len")
        x = torch.cat([batch["extra_embeds"].to(x.dtype), x], dim=1)
    if cfg.family == "audio":
        meta["enc_out"], meta["enc_valid"] = encode(
            cfg, params, batch["extra_embeds"], batch.get("extra_valid"),
            impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        x, _ = _hybrid_forward(cfg, params, x, meta, impl)
    else:
        for stacked, (kind, n) in zip(params["layer_stacks"],
                                      layer_groups(cfg)):
            for lp in _unstack(stacked, n):
                x, a, _ = _layer(cfg, lp, kind, x, meta, impl)
                if a is not None:
                    aux = aux + a
    x = tp_in(rmsnorm(params["final_norm"], x, cfg.norm_eps))
    return (x[:, F:] if F else x), aux


def _hybrid_forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    meta: dict, impl: str, gw_in: Optional[dict] = None,
                    capspecs: Optional[dict] = None):
    """Zamba2: stages of ``attn_every`` Mamba2 layers, each followed by the
    shared attention block (the same weights every time) on
    [x ; embed0] @ shared_in; the block's delta joins the residual.  In a
    partition the stages take their layers' slices of the ``g0`` gateway
    and application s of the block its ``shared{s}`` gateway.  Returns
    (x, captures): the stages' captures stitched into one [L, …] stack
    per leaf under ``g0``, the block's under ``shared{s}`` with a leading
    axis of 1."""
    gw_in = gw_in or {}
    emb0 = x
    n = cfg.n_layers
    layers = _unstack(params["layer_stacks"][0], n)
    gw0 = gw_in.get("g0")
    gws = [None] * n if gw0 is None else _unstack(gw0, n)
    caps, caps_all = [], {}
    for si, i in enumerate(range(0, n, cfg.hybrid.attn_every)):
        j = i + cfg.hybrid.attn_every
        for lp, gl in zip(layers[i:j], gws[i:j]):
            x, _, c = _layer(cfg, lp, "mamba2", x, meta, impl, gl,
                             capspecs)
            caps.append(c)
        h_in = (torch.cat([x, emb0], dim=-1) @ params["shared_in"]
                if cfg.hybrid.concat_embed else x)
        gsh = gw_in.get(f"shared{si}")
        h_out, _, c = _apply_layer(
            cfg, params["shared_attn"], "dense", h_in, meta, impl,
            None if gsh is None else map_tree(lambda a: a[0], gsh),
            capspecs)
        caps_all[f"shared{si}"] = \
            map_tree(lambda a: a[None], c) if capspecs else {}
        x = x + (h_out - h_in)
    caps_all["g0"] = _stack_caps(caps) if capspecs else {}
    return x, caps_all


def _token_nll(params: dict, hidden: torch.Tensor, pos: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """CE of ``labels`` [B, T] from the hidden rows at ``pos`` [B, T]
    (fp32 logits a chunk at a time; ``take_rows`` keeps the backward
    deterministic)."""
    h = take_rows(hidden, pos.long())
    return token_nll(params["embed"], params.get("lm_head"), h, labels)


def partition_loss(cfg: ModelConfig, params: dict, batch: dict, gw_in,
                   capspecs: Optional[dict], impl: str = "kernel"):
    """Loss *sum* for one partition (λ already full-tree) + boundary
    losses: child partitions' first tokens are predicted by this
    partition's hidden states at the cut nodes (``extra_pos``/``_label``/
    ``_weight``).  Returns ((loss, captures), metrics), the metrics
    tensors on the device: ``nll_sum`` the token CE (no MoE aux),
    ``weight_sum`` the weights including the boundary ones."""
    hidden, aux, caps = partition_forward(cfg, params, batch, gw_in,
                                          capspecs, impl)
    prev = batch["prev_idx"]
    w = torch.where(prev >= 0, batch["weight"], 0.0)
    loss = torch.sum(w * _token_nll(params, hidden, prev.clamp_min(0),
                                    batch["tokens"]))
    weight_sum = torch.sum(w)
    if "extra_pos" in batch and batch["extra_pos"].shape[-1] > 0:
        nll_b = _token_nll(params, hidden, batch["extra_pos"],
                           batch["extra_label"])
        loss = loss + torch.sum(batch["extra_weight"] * nll_b)
        weight_sum = weight_sum + torch.sum(batch["extra_weight"])
    metrics = {"weight_sum": weight_sum, "nll_sum": loss}
    return (loss + aux, caps), metrics


def loss_and_metrics(cfg: ModelConfig, params: dict, batch: dict,
                     impl: str = "kernel") -> tuple[torch.Tensor, dict]:
    """Tree loss (Eq. 4): Σ_t λ_t · CE(logits[prev(t)], token_t) / #trees.
    The metrics stay tensors on the device (no host transfer)."""
    hidden, aux = forward(cfg, params, batch, impl)
    prev = batch["prev_idx"]
    w = torch.where(prev >= 0, batch["weight"], 0.0)
    nll = _token_nll(params, hidden, prev.clamp_min(0), batch["tokens"])
    nll_sum = torch.sum(w * nll)
    weight_sum = torch.sum(w)
    loss = nll_sum / float(batch.get("num_trees", 1))
    metrics = {"loss": loss, "aux_loss": aux, "weight_sum": weight_sum,
               "nll_sum": nll_sum,
               "token_nll_mean": nll_sum / torch.clamp(weight_sum, min=1e-9)}
    return loss + aux, metrics
