"""K-branch rollout groups over one shared-prefix DecodeSession.

Port of ``repro/serve/rollout.py``.  ``rollout_group`` is the generation
half of the RL loop: prefill the common prompt ONCE (through the
tree-attention kernel by default), ``fork`` K branches off the cached
prefix, decode them in lockstep, score them, and merge the group into one
advantage-weighted :class:`TrajectoryTree` with ``rollouts_to_tree``.

The reference fuses the decode loop into one jitted ``lax.scan``; PyTorch
runs eagerly, so here it is a Python loop of ``DecodeSession.step``.
``prefill_tokens`` in the returned stats equals the prompt length, not K×
it: the proof that the shared prefix is computed once per group.  An
enc-dec model's group holds no encoder output (its session is made with
``enc_len`` 0, as the reference's is), so its cross-attention adds 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import TrajectoryTree
from repro_torch.device import DeviceLike
from repro_torch.serve.decode import rollouts_to_tree
from repro_torch.serve.session import DecodeSession, GraphPool


@dataclass(frozen=True)
class RolloutConfig:
    """Shape of one rollout group."""
    k: int = 4                        # branches per prompt
    prompt_len: int = 12
    max_new: int = 16                 # tokens generated per branch
    temperature: float = 1.0          # 0 → greedy (all branches collapse)
    eos_token: Optional[int] = None   # truncate a branch after this token
    impl: str = "kernel"              # attention impl for the prefill pass

    @property
    def buf_len(self) -> int:
        return self.prompt_len + self.max_new


@dataclass
class GroupStats:
    """Per-group compute accounting (from the shared SessionStats)."""
    k: int
    prompt_len: int
    prefill_tokens: int      # prefix positions actually computed
    decode_tokens: int       # branch steps × branches
    rewards: list

    @property
    def saved_prefill_tokens(self) -> int:
        """Prefix tokens NOT recomputed thanks to the shared-KV fork."""
        return self.k * self.prompt_len - self.prefill_tokens


def sample_tokens(logits: torch.Tensor, vocab_size: int,
                  generator: Optional[torch.Generator],
                  temperature: float) -> torch.Tensor:
    """One token per row of [B, padded_vocab] logits; the padding columns
    (≥ vocab_size) are masked out first.  temperature ≤ 0 is greedy."""
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(cols < vocab_size, logits, -torch.inf)
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def default_reward(seq: np.ndarray, prompt_len: int) -> float:
    """Deterministic toy reward: mean residue of the completion tokens."""
    comp = np.asarray(seq)[prompt_len:]
    if comp.size == 0:
        return 0.0
    return float(np.mean(comp % 7)) / 6.0


def rollout_group(cfg: ModelConfig, params: dict, prompt, rc: RolloutConfig,
                  generator: Optional[torch.Generator] = None,
                  reward_fn: Callable[[np.ndarray, int], float]
                  = default_reward, *, device: DeviceLike = None,
                  graph_pool: Optional[GraphPool] = None
                  ) -> tuple[TrajectoryTree, GroupStats]:
    """Decode ``rc.k`` branch rollouts of ``prompt`` and merge them into
    one advantage tree.

    ``prompt``: 1-D int tokens; ``generator``: the sampling RNG (on the
    session's device; unused when greedy); ``device``: where the session
    runs (CUDA by default; ``params`` must live there); ``graph_pool``:
    where its sessions lease or capture their decode graphs
    (``session.GraphPool``).  The sessions are closed before it returns,
    so the next group of the same shape reuses their graphs.  Returns
    ``(tree, stats)``."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    P, K = len(prompt), rc.k
    session = DecodeSession.create(cfg, params, buf_len=rc.buf_len,
                                   device=device, graph_pool=graph_pool)
    logits = session.prefill(prompt, impl=rc.impl)      # prefix: ONCE
    branches = session.fork(K)                          # KV reuse, no FLOPs

    # first branch token: K independent samples from the one prefill row;
    # the last sampled token is returned but never fed
    tok = sample_tokens(logits.expand(K, -1), cfg.vocab_size, generator,
                        rc.temperature)
    toks = [tok]
    for _ in range(rc.max_new - 1):
        tok = sample_tokens(branches.step(tok), cfg.vocab_size, generator,
                            rc.temperature)
        toks.append(tok)
    gen = torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
    stats = session.stats
    session.close()
    branches.close()

    seqs, rewards = [], []
    for kk in range(K):
        comp = gen[kk]
        if rc.eos_token is not None:
            hits = np.nonzero(comp == rc.eos_token)[0]
            if hits.size:
                comp = comp[:hits[0] + 1]               # keep the eos
        seq = np.concatenate([prompt, comp])
        seqs.append(seq)
        rewards.append(reward_fn(seq, P))
    tree = rollouts_to_tree(seqs, rewards, prompt_len=P)
    stats = GroupStats(k=K, prompt_len=P,
                       prefill_tokens=stats.prefill_tokens,
                       decode_tokens=stats.decode_tokens, rewards=rewards)
    return tree, stats
