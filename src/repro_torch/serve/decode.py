"""Serving internals: the per-layer caches, the one-token decode step,
and ``rollouts_to_tree``.

Port of ``repro/serve/decode.py`` (its deprecated free functions are left
out).  The cache keeps the reference's layout, per layer group ``g{i}``:

  attention : k/v [L, B, T, Kh, hd] and pos [L, B, T] (−1 = empty slot),
              also the enc-dec decoder's self-attention;
  mamba2    : h [L, B, H, d_state, hd] fp32 and the conv tail [L, B, K−1, ·];
  gdn       : S [L, B, H, hd, hd] fp32 and the conv tail;
  rwkv6     : S [L, B, H, hd, hd] fp32 and the token-shift tails x_tm, x_cm;
  hybrid    : the mamba2 stack plus ``shared``, one KV ring per application
              of the shared attention block [n_apps, B, T, Kh, hd];
  audio     : plus ``cross``, the encoder's K/V for every decoder layer,
              k/v [dec_layers, B, enc_len, Kh, hd] and valid [B, enc_len]
              (``session.load_cross`` fills them).
A VLM decodes as the dense decoder: its image prefix reaches the cache
through the session's step-loop prefill like any token, as in the
reference.

The port writes the cache **in place**: ``_decode_step`` updates the cache
it is given.  ``serve/session.py`` owns when that is safe.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import TrajectoryTree, TreeNode
from repro_torch.data.synthetic import group_normalized_advantages
from repro_torch.models.attention import cross_attention, decode_attention
from repro_torch.models.layers import embed, logits_from_hidden, mlp, rmsnorm
from repro_torch.models.moe import moe
from repro_torch.models.ssm.gdn import gdn_decode, init_gdn_cache
from repro_torch.models.ssm.mamba2 import init_mamba2_cache, mamba2_decode
from repro_torch.models.ssm.rwkv6 import (init_rwkv6_cache,
                                          rwkv6_channelmix_decode,
                                          rwkv6_timemix_decode)
from repro_torch.models.transformer import _dtype, _unstack, layer_groups
from repro_torch.sharding import shard_logits


def _attn_cache(L: int, B: int, T: int, cfg: ModelConfig, dt, device) -> dict:
    a = cfg.attn
    return {
        "k": torch.zeros((L, B, T, a.n_kv_heads, a.head_dim), dtype=dt,
                         device=device),
        "v": torch.zeros((L, B, T, a.n_kv_heads, a.head_dim), dtype=dt,
                         device=device),
        "pos": torch.full((L, B, T), -1, dtype=torch.int32, device=device),
    }


def _ssm_cache(L: int, B: int, cfg: ModelConfig, dt, device) -> dict:
    init = {"rwkv6": init_rwkv6_cache, "gdn": init_gdn_cache}.get(
        cfg.ssm.kind, init_mamba2_cache)
    return init(B, cfg.ssm, cfg.d_model, dt, device, lead=(L,))


def _init_cache(cfg: ModelConfig, batch: int, buf_len: int, device,
                enc_len: int = 0) -> dict:
    """buf_len: KV slots (= max context, or the window for sliding);
    enc_len: encoder positions of an enc-dec model's cross K/V (0: the
    cross term attends to no key and adds nothing)."""
    dt = _dtype(cfg)
    a = cfg.attn
    if a is not None and a.window is not None:
        buf_len = min(buf_len, a.window)
    cache = {f"g{gi}": (_attn_cache(n, batch, buf_len, cfg, dt, device)
                        if kind in ("dense", "moe", "decoder_cross")
                        else _ssm_cache(n, batch, cfg, dt, device))
             for gi, (kind, n) in enumerate(layer_groups(cfg))}
    if cfg.family == "hybrid":
        n_apps = -(-cfg.n_layers // cfg.hybrid.attn_every)
        cache["shared"] = _attn_cache(n_apps, batch, buf_len, cfg, dt, device)
    if cfg.family == "audio":
        shape = (cfg.encdec.dec_layers, batch, enc_len, a.n_kv_heads,
                 a.head_dim)
        cache["cross"] = {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "valid": torch.ones((batch, enc_len), dtype=torch.bool,
                                device=device)}
    return cache


def _decode_layer(cfg: ModelConfig, p: dict, kind: str, x, cache_l, pos,
                  widx, cross_l=None):
    """One layer of a decode step, updating ``cache_l`` in place; a
    ``decoder_cross`` layer also attends to its slice ``cross_l`` {k, v,
    valid} of the cross cache.  An MoE
    layer routes the step's B tokens as one batch with every token valid,
    as the reference does: its capacity is max(1, round(B·K/E·cf)), so C =
    1 at 8 branches of 128 experts top-8, and slots past an expert's first
    token are dropped."""
    eps = cfg.norm_eps
    if kind == "rwkv6":
        x = x + rwkv6_timemix_decode(p["tm"], cfg.ssm,
                                     rmsnorm(p["ln1"], x, eps), cache_l)
        return x + rwkv6_channelmix_decode(p["cm"], rmsnorm(p["ln2"], x, eps),
                                           cache_l)
    if kind == "mamba2":
        return x + mamba2_decode(p["ssm"], cfg.ssm, rmsnorm(p["ln1"], x, eps),
                                 cache_l)
    if kind == "gdn":
        x = x + gdn_decode(p["ssm"], cfg.ssm, rmsnorm(p["ln1"], x, eps),
                           cache_l)
        return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, eps),
                       cfg.mlp_activation)
    x = x + decode_attention(p["attn"], cfg.attn, rmsnorm(p["ln1"], x, eps),
                             cache_l, pos, widx)
    if kind == "decoder_cross":
        x = x + cross_attention(p["xattn"], cfg.attn,
                                rmsnorm(p["ln_x"], x, eps), cross_l["k"],
                                cross_l["v"], cross_l["valid"])
    h = rmsnorm(p["ln2"], x, eps)
    if kind == "moe":
        m, _ = moe(p["moe"], cfg.moe, h,
                   torch.ones(h.shape[:2], dtype=torch.bool, device=h.device),
                   cfg.mlp_activation, with_aux=False)
    else:
        m = mlp(p["mlp"], h, cfg.mlp_activation)
    return x + m


def _decode_step(cfg: ModelConfig, params: dict, cache: dict,
                 tokens: torch.Tensor, pos: torch.Tensor,
                 write_idx: torch.Tensor) -> torch.Tensor:
    """tokens: [B, 1]; pos: [B] absolute positions; write_idx: the ring
    slot, a [1] int64 tensor on the device.  Writes the new token's K/V
    and states into ``cache`` in place and returns logits [B,
    padded_vocab] (fp32).  Only tensors reach the device, so the step can
    be captured in a CUDA graph and replayed (``serve/session.py``)."""
    x = embed(params["embed"], tokens)
    if cfg.family == "hybrid":
        x = _hybrid_decode(cfg, params, cache, x, pos, write_idx)
    else:
        for gi, ((kind, n), stacked) in enumerate(
                zip(layer_groups(cfg), params["layer_stacks"])):
            grp = cache[f"g{gi}"]
            cross = [None] * n
            if kind == "decoder_cross":
                cx = cache["cross"]
                cross = [{"k": k, "v": v, "valid": cx["valid"]} for k, v in
                         zip(_unstack(cx["k"], n), _unstack(cx["v"], n))]
            for lp, cache_l, cl in zip(_unstack(stacked, n), _unstack(grp, n),
                                       cross):
                x = _decode_layer(cfg, lp, kind, x, cache_l, pos, write_idx,
                                  cl)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return shard_logits(logits_from_hidden(params["embed"],
                                           params.get("lm_head"), x))[:, 0]


def _hybrid_decode(cfg: ModelConfig, params: dict, cache: dict, x, pos,
                   write_idx: torch.Tensor):
    """Zamba2's decode: the Mamba2 stages, and after each the shared block
    on [x ; embed0] @ shared_in with that application's own KV ring."""
    emb0 = x
    n, k = cfg.n_layers, cfg.hybrid.attn_every
    layers = _unstack(params["layer_stacks"][0], n)
    states = _unstack(cache["g0"], n)
    rings = _unstack(cache["shared"], cache["shared"]["pos"].shape[0])
    for si, i in enumerate(range(0, n, k)):
        for lp, cl in zip(layers[i:i + k], states[i:i + k]):
            x = _decode_layer(cfg, lp, "mamba2", x, cl, pos, write_idx)
        h_in = (torch.cat([x, emb0], dim=-1) @ params["shared_in"]
                if cfg.hybrid.concat_embed else x)
        h_out = _decode_layer(cfg, params["shared_attn"], "dense", h_in,
                              rings[si], pos, write_idx)
        x = x + (h_out - h_in)
    return x


def rollouts_to_tree(sequences, rewards, *, prompt_len: int = 0,
                     normalize: bool = True):
    """Sampled rollouts → one shared-prefix trajectory tree for the RL
    update.  ``sequences[k]`` is rollout k's full token sequence (prompt +
    completion), ``rewards[k]`` its scalar reward.  Shared prefixes merge
    into one trie; each leaf gets the GRPO group-normalized advantage;
    tokens before ``prompt_len`` are ``trained=False``.  A rollout that is
    a strict prefix of another (or a duplicate) gets an empty leaf so its
    advantage lands on its own branch."""
    seqs = [np.asarray(s, np.int32).reshape(-1) for s in sequences]
    if not seqs or len(seqs) != len(rewards):
        raise ValueError("need one reward per (non-empty list of) rollouts")
    adv = group_normalized_advantages(rewards, normalize)

    def node(lo: int, hi: int, k: int) -> TreeNode:
        trained = np.arange(lo, hi) >= prompt_len
        return TreeNode(tokens=seqs[k][lo:hi], trained=trained)

    def build(idx: list, off: int) -> TreeNode:
        # maximal segment shared by every rollout in ``idx`` from ``off``
        end = min(len(seqs[i]) for i in idx)
        cp = off
        while cp < end and all(seqs[i][cp] == seqs[idx[0]][cp]
                               for i in idx[1:]):
            cp += 1
        n = node(off, cp, idx[0])
        ended = [i for i in idx if len(seqs[i]) == cp]
        by_tok: dict[int, list] = {}
        for i in idx:
            if len(seqs[i]) > cp:
                by_tok.setdefault(int(seqs[i][cp]), []).append(i)
        if not by_tok and len(ended) == 1:
            n.branch_adv = float(adv[ended[0]])
            return n
        for i in ended:
            n.children.append(TreeNode(tokens=np.zeros(0, np.int32),
                                       branch_adv=float(adv[i])))
        for _, sub in sorted(by_tok.items()):
            n.children.append(build(sub, cp))
        return n

    return TrajectoryTree(root=build(list(range(len(seqs))), 0))
