"""Serving internals: the per-layer KV cache, the one-token decode step,
and ``rollouts_to_tree``.

Port of the dense and MoE slices of ``repro/serve/decode.py`` (its
deprecated free functions are left out).  The cache keeps the reference's
layout — per layer group ``g{i}``: k/v [L, B, T, Kh, hd] and pos [L, B, T]
(−1 = empty slot) — but the port writes it **in place**: ``_decode_step``
updates the cache it is given.  ``serve/session.py`` owns when that is safe.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import TrajectoryTree, TreeNode
from repro_torch.data.synthetic import group_normalized_advantages
from repro_torch.models.attention import decode_attention
from repro_torch.models.layers import embed, logits_from_hidden, mlp, rmsnorm
from repro_torch.models.moe import moe
from repro_torch.models.transformer import _dtype, _unstack, layer_groups


def _attn_cache(L: int, B: int, T: int, cfg: ModelConfig, dt, device) -> dict:
    a = cfg.attn
    return {
        "k": torch.zeros((L, B, T, a.n_kv_heads, a.head_dim), dtype=dt,
                         device=device),
        "v": torch.zeros((L, B, T, a.n_kv_heads, a.head_dim), dtype=dt,
                         device=device),
        "pos": torch.full((L, B, T), -1, dtype=torch.int32, device=device),
    }


def _init_cache(cfg: ModelConfig, batch: int, buf_len: int, device) -> dict:
    """buf_len: KV slots (= max context, or the window for sliding)."""
    if cfg.attn.window is not None:
        buf_len = min(buf_len, cfg.attn.window)
    return {f"g{gi}": _attn_cache(n, batch, buf_len, cfg, _dtype(cfg), device)
            for gi, (_, n) in enumerate(layer_groups(cfg))}


def _decode_layer(cfg: ModelConfig, p: dict, kind: str, x, cache_l, pos,
                  widx):
    """One layer of a decode step.  An MoE layer routes the step's B tokens
    as one batch with every token valid, as the reference does: its
    capacity is max(1, round(B·K/E·cf)), so C = 1 at 8 branches of 128
    experts top-8, and slots past an expert's first token are dropped."""
    eps = cfg.norm_eps
    x = x + decode_attention(p["attn"], cfg.attn, rmsnorm(p["ln1"], x, eps),
                             cache_l, pos, widx)
    h = rmsnorm(p["ln2"], x, eps)
    if kind == "moe":
        m, _ = moe(p["moe"], cfg.moe, h,
                   torch.ones(h.shape[:2], dtype=torch.bool, device=h.device),
                   cfg.mlp_activation, with_aux=False)
    else:
        m = mlp(p["mlp"], h, cfg.mlp_activation)
    return x + m


def _decode_step(cfg: ModelConfig, params: dict, cache: dict,
                 tokens: torch.Tensor, pos: torch.Tensor, write_idx: int
                 ) -> torch.Tensor:
    """tokens: [B, 1]; pos: [B] absolute positions; write_idx: ring slot.
    Writes the new token's K/V into ``cache`` in place and returns logits
    [B, padded_vocab] (fp32)."""
    x = embed(params["embed"], tokens)
    for gi, ((kind, n), stacked) in enumerate(
            zip(layer_groups(cfg), params["layer_stacks"])):
        grp = cache[f"g{gi}"]
        for lp, cache_l in zip(_unstack(stacked, n), _unstack(grp, n)):
            x = _decode_layer(cfg, lp, kind, x, cache_l, pos, write_idx)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params["embed"], params.get("lm_head"), x)[:, 0]


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
