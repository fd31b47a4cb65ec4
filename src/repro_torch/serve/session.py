"""DecodeSession — the serving API: prefill / fork / step / snapshot.

Port of ``repro/serve/session.py`` for the dense and MoE families.  One
session owns a KV cache for ``batch`` lockstep branches:

  ``create``    allocate the cache on the session's device (CUDA unless
                the caller passes ``device="cpu"``).
  ``prefill``   run a token prefix through the model and fill the cache.
                While the prefix fits the ring, this is the *parallel*
                path: one tree forward over the whole prefix (a chain is a
                1-path tree) with each layer's post-rope K/V captured into
                the cache.  On a session that already holds context (a
                fork, or a second prefill) the cached slots ride in as
                gateway ancestors — the tree-attention kernel's ``q_off``
                shape.  Sliding-window configs fall back to the step loop.
  ``fork``      split a 1-branch session into K branches that share the
                prefilled prefix: the cache rows are copied, the prefix is
                not recomputed (the paper's shared-prefix KV reuse).
  ``step``      one decode token per branch.
  ``snapshot``  capture the current state as an independent session.

The port writes caches in place where JAX made new arrays, so
``snapshot`` copies the cache (one eager copy; the reference's O(1)
snapshot and its donation flags have no counterpart), and ``fork`` gives
the branches freshly copied rows, never a view.

Token accounting (``SessionStats``, shared by every fork/snapshot of a
group) counts prefill and decode tokens: the proof that a common prefix is
computed once per rollout group.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, map_tree, resolve_device
from repro_torch.models.layers import logits_from_hidden
from repro_torch.models.transformer import layer_groups, partition_forward
from repro_torch.serve.decode import _decode_step, _init_cache


@dataclass
class SessionStats:
    """Token accounting, shared by every fork/snapshot of one group."""
    prefill_tokens: int = 0   # prefix tokens computed (once per session)
    decode_tokens: int = 0    # single-token steps × branches


@dataclass
class DecodeSession:
    """A decode cache + position cursor for ``batch`` lockstep branches."""
    cfg: ModelConfig
    params: dict
    cache: dict
    batch: int
    t: int = 0                        # next absolute position
    stats: SessionStats = field(default_factory=SessionStats)

    # -- construction ------------------------------------------------------
    @classmethod
    def create(cls, cfg: ModelConfig, params: dict, *, batch: int = 1,
               buf_len: int, device: DeviceLike = None) -> "DecodeSession":
        dev = resolve_device(device)
        if params["embed"]["table"].device.type != dev.type:
            raise ValueError(f"params live on "
                             f"{params['embed']['table'].device}, the "
                             f"session on {dev}")
        return cls(cfg=cfg, params=params,
                   cache=_init_cache(cfg, batch, buf_len, dev), batch=batch)

    @property
    def device(self) -> torch.device:
        return self.cache["g0"]["pos"].device

    @property
    def _ring(self) -> int:
        """KV ring-buffer length."""
        return self.cache["g0"]["pos"].shape[2]

    # -- prefill -----------------------------------------------------------
    def _can_parallel_prefill(self, P: int) -> bool:
        if self.cfg.family not in ("dense", "moe"):
            return False
        if self.cfg.attn.window is not None:
            return False
        return self.t + P <= self._ring

    def prefill(self, tokens, impl: str = "kernel") -> torch.Tensor:
        """Run a prefix through the model, fill the cache, and return the
        last position's logits [batch, padded_vocab] (fp32).

        ``tokens``: 1-D [P] (the same prefix for every branch).  May be
        called again on a session that holds context (e.g. after fork):
        the new tokens extend the chain, attending to the cached slots.
        ``impl``: 'kernel' (the tree-attention op) or 'ref'."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        P = toks.shape[0]
        if P == 0:
            raise ValueError("empty prefill")
        if self._can_parallel_prefill(P):
            logits = self._prefill_parallel(toks, impl)
        else:
            logits = self._prefill_steps(toks)
        self.stats.prefill_tokens += self.batch * P
        return logits

    def _prefill_parallel(self, toks: np.ndarray, impl: str) -> torch.Tensor:
        cfg, B, P, t0, dev = self.cfg, self.batch, len(toks), self.t, \
            self.device
        ar = torch.arange(P, dtype=torch.int32, device=dev)
        batch = dict(
            tokens=torch.as_tensor(toks, device=dev).long()[None].expand(B, P),
            pos_ids=(t0 + ar)[None].expand(B, P),
            kv_last=torch.full((B, P), P - 1, dtype=torch.int32, device=dev),
            valid=torch.ones((B, P), dtype=torch.bool, device=dev))
        n_groups = len(layer_groups(cfg))
        gw = None
        if t0 > 0:
            # cached slots ride in as gateway ancestors → the kernel's
            # forked-prefix q_off shape (the prefix is computed once,
            # however many branches extend it)
            gw = {f"g{gi}": {"attn": {
                "k": self.cache[f"g{gi}"]["k"][:, :, :t0],
                "v": self.cache[f"g{gi}"]["v"][:, :, :t0]}}
                for gi in range(n_groups)}
            anc_pos = self.cache["g0"]["pos"][0][:, :t0]
            batch["anc_pos"] = anc_pos
            batch["anc_valid"] = anc_pos >= 0
        capspecs = {"pf": {"path_idx": torch.arange(P, device=dev)}}
        hidden, _, caps = partition_forward(cfg, self.params, batch, gw,
                                            capspecs, impl)
        logits = logits_from_hidden(self.params["embed"],
                                    self.params.get("lm_head"),
                                    hidden[:, -1:])[:, 0]
        for gi in range(n_groups):
            grp = self.cache[f"g{gi}"]
            cap = caps[f"g{gi}"]["attn"]["pf"]      # [L, B, P, Kh, hd]
            grp["k"][:, :, t0:t0 + P] = cap["k"].to(grp["k"].dtype)
            grp["v"][:, :, t0:t0 + P] = cap["v"].to(grp["v"].dtype)
            grp["pos"][:, :, t0:t0 + P] = t0 + ar
        self.t = t0 + P
        return logits

    def _prefill_steps(self, toks: np.ndarray) -> torch.Tensor:
        logits = None
        for tok in toks:
            logits = self._advance(torch.full((self.batch,), int(tok),
                                              dtype=torch.long,
                                              device=self.device))
        return logits

    # -- branching ---------------------------------------------------------
    def fork(self, k: int) -> "DecodeSession":
        """Split into ``k`` branches sharing this session's cache content.

        The prefilled prefix is NOT recomputed: its KV rows are copied into
        fresh buffers (a later in-place step on one branch touches no
        other).  Only 1-branch sessions fork; the forks share the stats."""
        if self.batch != 1:
            raise ValueError("fork() requires a 1-branch session")
        cache = map_tree(lambda a: a.repeat_interleave(k, dim=1), self.cache)
        return replace(self, cache=cache, batch=k)

    def snapshot(self) -> "DecodeSession":
        """Capture the current state as an independent session sharing the
        group's stats.  The cache is copied now, since both sessions go on
        writing theirs in place."""
        return replace(self, cache=map_tree(torch.clone, self.cache))

    # -- decode ------------------------------------------------------------
    def _advance(self, tokens: torch.Tensor) -> torch.Tensor:
        pos = torch.full((self.batch,), self.t, dtype=torch.int32,
                         device=self.device)
        logits = _decode_step(self.cfg, self.params, self.cache,
                              tokens.reshape(self.batch, 1), pos,
                              self.t % self._ring)
        self.t += 1
        return logits

    def step(self, tokens) -> torch.Tensor:
        """Decode one token per branch.  ``tokens``: [batch] (or [batch,1])
        ints.  Returns logits [batch, padded_vocab] (fp32)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        logits = self._advance(tokens)
        self.stats.decode_tokens += self.batch
        return logits

