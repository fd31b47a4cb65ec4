"""DecodeSession — the serving API: prefill / fork / step / snapshot.

Port of ``repro/serve/session.py``.  One session owns a decode cache for
``batch`` lockstep branches:

  ``create``    allocate the cache on the session's device (CUDA unless
                the caller passes ``device="cpu"``).
  ``prefill``   run a token prefix through the model and fill the cache.
                While the prefix fits the ring, this is the *parallel*
                path: one tree forward over the whole prefix (a chain is a
                1-path tree) with each layer's post-rope K/V captured into
                the cache.  On a session that already holds context (a
                fork, or a second prefill) the cached slots ride in as
                gateway ancestors — the tree-attention kernel's ``q_off``
                shape.  Sliding-window configs, the SSM and hybrid
                families and the models with a frontend (VLM, enc-dec)
                prefill through the step loop, as the reference's do
                (still one computation of the prefix per session).
  ``load_cross`` install an enc-dec model's cross K/V (a session made
                with ``enc_len``) by copying into the cache's buffers, so
                a step graph captured earlier reads them.
  ``fork``      split a 1-branch session into K branches that share the
                prefilled prefix: the cache rows (KV and recurrent states)
                are copied, the prefix is not recomputed (the paper's
                shared-prefix KV reuse).
  ``step``      one decode token per branch.  On the card a session
                captures its step in a CUDA graph at its first step and
                replays it afterwards: an eager step is thousands of
                launches, whose host work bounds decode (and the SSM and
                hybrid families' step-loop prefill).  The capture may run
                while another thread trains on the same card (the RL
                loop): see ``_graph_step``.
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

import contextlib
import threading
from dataclasses import dataclass, field, replace
from typing import ClassVar, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import (DeviceLike, map_tree, resolve_device,
                                tree_leaves)
from repro_torch.models.layers import logits_from_hidden
from repro_torch.models.transformer import layer_groups, partition_forward
from repro_torch.serve.decode import _decode_step, _init_cache

# held while a session captures its decode step into a ``GraphPool``.  A
# device-wide sync (``torch.cuda.synchronize``, a profiler's start or
# stop) from any thread during a capture breaks the capture, so code that
# may run one beside a generating thread takes this lock first
CAPTURE_LOCK = threading.Lock()


@dataclass
class SessionStats:
    """Token accounting, shared by every fork/snapshot of one group."""
    prefill_tokens: int = 0   # prefix tokens computed (once per session)
    decode_tokens: int = 0    # single-token steps × branches


class GraphPool:
    """A CUDA-graph memory pool and the one stream that every capture into
    it runs on (the caching allocator reuses a block only on the stream
    that allocated it), for sessions that decode while another thread uses
    the card.  A dropped session's graph gives its blocks back to the pool
    and the next session's capture reuses them, so a stream of rollout
    groups holds one group's graph memory.  Sessions that share it capture
    and replay their graphs in turn, from one thread (graphs that share a
    pool must never replay concurrently): each generating thread makes its
    own."""

    def __init__(self, device: DeviceLike = None):
        dev = resolve_device(device)
        with torch.cuda.device(dev):
            self.id = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(dev)
        # a pool lives while a graph captured into it does (a capture into
        # a pool whose graphs all died fails an assert of the allocators):
        # the newest graph is kept, and it is never replayed once its
        # session is gone
        self._anchor: Optional[torch.cuda.CUDAGraph] = None

    @contextlib.contextmanager
    def capture(self, graph: torch.cuda.CUDAGraph):
        """Capture ``graph`` on this pool's stream (the caller's current
        stream) beside another thread's work, under ``CAPTURE_LOCK``:

        * ``thread_local`` mode: the default, ``global``, forbids every
          thread's unsafe calls while a capture is open, and the trainer's
          one host sync a step fails and breaks the capture (a device-wide
          sync breaks it in any mode: ``CAPTURE_LOCK``);
        * no device sync, garbage collection or cache emptying first
          (``torch.cuda.graph`` does all three);
        * the stream is a non-blocking one, so work on the legacy default
          stream never joins the capture.

        No thread may draw from the default CUDA generator while the
        capture is open (the capture holds it; the port samples with
        generators of its own)."""
        with CAPTURE_LOCK:
            graph.capture_begin(pool=self.id,
                                capture_error_mode="thread_local")
            try:
                yield graph
            finally:
                graph.capture_end()
        self._anchor = graph


@dataclass
class DecodeSession:
    """A decode cache + position cursor for ``batch`` lockstep branches."""
    cfg: ModelConfig
    params: dict
    cache: dict
    batch: int
    t: int = 0                        # next absolute position
    enc_len: int = 0                  # encoder positions of the cross K/V
    stats: SessionStats = field(default_factory=SessionStats)
    # the captured step (graph, static inputs, static logits) of a session
    # on the card; a fork or snapshot captures its own
    _graph: Optional[tuple] = field(default=None, init=False, repr=False,
                                    compare=False)
    # the pool the graphs capture into, shared by this session's forks and
    # snapshots; None: a private pool (and side stream) per graph
    graph_pool: Optional["GraphPool"] = field(default=None, repr=False,
                                              compare=False)
    # False: every session steps eagerly, so Python hooked into the layers
    # (a trace, a routing log) sees each step; a replayed graph runs none
    graph_steps: ClassVar[bool] = True

    # -- construction ------------------------------------------------------
    @classmethod
    def create(cls, cfg: ModelConfig, params: dict, *, batch: int = 1,
               buf_len: int, enc_len: int = 0, device: DeviceLike = None,
               graph_pool: Optional["GraphPool"] = None
               ) -> "DecodeSession":
        dev = resolve_device(device)
        if params["embed"]["table"].device.type != dev.type:
            raise ValueError(f"params live on "
                             f"{params['embed']['table'].device}, the "
                             f"session on {dev}")
        return cls(cfg=cfg, params=params,
                   cache=_init_cache(cfg, batch, buf_len, dev, enc_len),
                   batch=batch, enc_len=enc_len, graph_pool=graph_pool)

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.cache)[0].device

    @property
    def _ring(self) -> Optional[int]:
        """KV ring-buffer length (None for a pure-SSM cache, which has
        none; the hybrid's rings are its ``shared`` group)."""
        for grp in self.cache.values():
            if "pos" in grp:
                return grp["pos"].shape[2]
        return None

    def load_cross(self, k: torch.Tensor, v: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> None:
        """Install encoder cross K/V [dec_layers, batch, enc_len, Kh, hd]
        (``attention.project_cross_kv`` of each decoder layer over
        ``transformer.encode``'s output) and optionally ``valid`` [batch,
        enc_len].  Copied into the cache's own buffers, never rebound: a
        decode graph captured before reads the new values."""
        cross = self.cache["cross"]
        if tuple(k.shape) != tuple(cross["k"].shape) or \
                tuple(v.shape) != tuple(cross["v"].shape):
            raise ValueError(f"cross K/V of shape {tuple(k.shape)}, "
                             f"{tuple(v.shape)}; the session holds "
                             f"{tuple(cross['k'].shape)}")
        cross["k"].copy_(k)
        cross["v"].copy_(v)
        if valid is not None:
            cross["valid"].copy_(valid)

    # -- prefill -----------------------------------------------------------
    def _can_parallel_prefill(self, P: int) -> bool:
        cfg = self.cfg
        if cfg.family not in ("dense", "moe"):
            return False
        if cfg.attn.window is not None or cfg.frontend is not None:
            return False
        return self.t + P <= self._ring

    def prefill(self, tokens, impl: str = "kernel") -> torch.Tensor:
        """Run a prefix through the model, fill the cache, and return the
        last position's logits [batch, padded_vocab] (fp32).

        ``tokens``: 1-D [P] (the same prefix for every branch).  May be
        called again on a session that holds context (e.g. after fork):
        the new tokens extend the chain, attending to the cached slots.
        ``impl``: 'kernel' (the tree-attention op), 'chunked' or 'ref'."""
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
        other).  The cross cache's ``valid`` [B, enc_len] tiles on its
        axis 0, every other leaf on axis 1.  Only 1-branch sessions fork;
        the forks share the stats."""
        if self.batch != 1:
            raise ValueError("fork() requires a 1-branch session")
        cache = {name: {key: a.repeat_interleave(
            k, dim=0 if (name, key) == ("cross", "valid") else 1)
            for key, a in grp.items()} for name, grp in self.cache.items()}
        return replace(self, cache=cache, batch=k)

    def snapshot(self) -> "DecodeSession":
        """Capture the current state as an independent session sharing the
        group's stats.  The cache is copied now, since both sessions go on
        writing theirs in place."""
        return replace(self, cache=map_tree(torch.clone, self.cache))

    # -- decode ------------------------------------------------------------
    def _advance(self, tokens: torch.Tensor) -> torch.Tensor:
        dev = self.device
        ring = self._ring
        pos = torch.full((self.batch,), self.t, dtype=torch.int32, device=dev)
        widx = torch.full((1,), self.t % ring if ring else 0,
                          dtype=torch.long, device=dev)
        tokens = tokens.reshape(self.batch, 1)
        if dev.type == "cuda" and DecodeSession.graph_steps:
            logits = self._graph_step(tokens, pos, widx)
        else:
            logits = _decode_step(self.cfg, self.params, self.cache, tokens,
                                  pos, widx)
        self.t += 1
        return logits

    def _graph_step(self, tokens, pos, widx) -> torch.Tensor:
        """One step through the session's CUDA graph.  The first step runs
        eagerly on a side stream (the warm-up) and then captures the step
        on that stream with static inputs; later steps copy their inputs
        into those and replay.  The graph writes the session's cache in
        place, as the eager step does, and reads the parameters where they
        live, so both must keep their storage (fork and snapshot make new
        caches and capture their own graphs).

        Without a ``graph_pool`` the session is alone on the card:
        ``torch.cuda.graph`` syncs the device and empties the allocator's
        cache before it captures (freeing dead graphs' private pools).
        With one (``GraphPool``, the RL loop's generator) another thread
        may train on the card meanwhile, and the pool captures as
        ``GraphPool.capture`` says: no device sync, no cache emptied, the
        trainer's host syncs and allocations allowed."""
        if self._graph is not None:
            graph, static, out = self._graph
            for dst, src in zip(static, (tokens, pos, widx)):
                dst.copy_(src)
            graph.replay()
            return out.clone()
        gp = self.graph_pool
        side = torch.cuda.Stream() if gp is None else gp.stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            logits = _decode_step(self.cfg, self.params, self.cache, tokens,
                                  pos, widx)
            static = tuple(t.clone() for t in (tokens, pos, widx))
            graph = torch.cuda.CUDAGraph()
            with (torch.cuda.graph(graph, stream=side) if gp is None
                  else gp.capture(graph)):
                out = _decode_step(self.cfg, self.params, self.cache, *static)
        torch.cuda.current_stream().wait_stream(side)
        self._graph = (graph, static, out)
        return logits

    def step(self, tokens) -> torch.Tensor:
        """Decode one token per branch.  ``tokens``: [batch] (or [batch,1])
        ints.  Returns logits [batch, padded_vocab] (fp32)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        logits = self._advance(tokens)
        self.stats.decode_tokens += self.batch
        return logits

