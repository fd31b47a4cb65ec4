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
                steps through a CUDA graph from its first step on: an
                eager step is thousands of launches, whose host work
                bounds decode (and the SSM and hybrid families' step-loop
                prefill).  A session made with a ``GraphPool`` leases a
                graph of its shape captured for an earlier session, and
                captures one only where none is free; the capture may run
                while another thread trains on the same card (the RL
                loop): see ``_graph_step``.
  ``snapshot``  capture the current state as an independent session.
  ``close``     end the session, giving its leased graph back to the pool.

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
import weakref
from dataclasses import dataclass, field, replace
from typing import Callable, ClassVar, Hashable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import (DeviceLike, map_tree, resolve_device,
                                tree_leaves)
from repro_torch.models.layers import logits_from_hidden
from repro_torch.models.transformer import layer_groups, partition_forward
from repro_torch.serve.decode import _decode_step, _init_cache
from repro_torch.sharding import require_no_model_axis, shard_logits
from repro_torch.train.exec_cache import exec_key

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


@dataclass(eq=False)
class DecodeGraph:
    """One captured decode step: ``replay`` (a CUDA graph's, which keeps
    the graph alive; on the CPU an eager step over the same static
    tensors), the static inputs and logits it reads and writes, and the
    cache it steps in place.  A ``GraphPool`` keeps it under ``key`` and
    leases it to one session at a time."""
    key: Hashable
    replay: Callable[[], None]
    static: tuple
    out: torch.Tensor
    cache: dict
    leased: bool = True


class GraphPool:
    """A CUDA-graph memory pool, the one stream that every capture into it
    runs on (the caching allocator reuses a block only on the stream that
    allocated it), and a store of captured decode steps keyed by shape, for
    sessions that decode while another thread uses the card.

    A session with a pool looks up a free ``DecodeGraph`` of its key at its
    first step (``DecodeSession._graph_step``): it copies its cache into
    the graph's own cache, steps there, and holds the lease until
    ``DecodeSession.close()`` (a ``weakref.finalize`` is the backstop).
    Only when none is free does it capture a new one (``captures``; a
    lease of a kept one counts in ``reuses``).  So a stream of rollout
    groups of one shape captures once per shape, and the graphs can be
    captured before the stream starts (the RL loop's warm-up).  The key
    holds the batch, ring and encoder lengths, the cache's leaf shapes and
    dtypes, and the address of every parameter leaf the graph reads.

    Sessions that share a pool step their graphs in turn, from one thread
    at a time (graphs that share a pool must never replay concurrently).
    On the CPU (no CUDA graph) a pool keeps eager stand-ins with the same
    store and lease logic."""

    def __init__(self, device: DeviceLike = None):
        dev = resolve_device(device)
        self.device = dev
        self.id = self.stream = None
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                self.id = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream(dev)
        self._lock = threading.Lock()
        self._graphs = {}             # key → [DecodeGraph]
        self.captures = 0
        self.reuses = 0

    def lease(self, key: Hashable) -> Optional[DecodeGraph]:
        """A free graph of ``key``, now leased; None if there is none."""
        with self._lock:
            for g in self._graphs.get(key, ()):
                if not g.leased:
                    g.leased = True
                    self.reuses += 1
                    return g
            return None

    def add(self, g: DecodeGraph) -> None:
        """Keep a newly captured graph (leased by its capturer)."""
        with self._lock:
            self._graphs.setdefault(g.key, []).append(g)
            self.captures += 1

    def release(self, g: DecodeGraph) -> None:
        with self._lock:
            g.leased = False

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
        generators of its own).  The pool keeps every graph captured into
        it (a capture into a pool whose graphs all died fails an assert of
        the allocators)."""
        with CAPTURE_LOCK:
            graph.capture_begin(pool=self.id,
                                capture_error_mode="thread_local")
            try:
                yield graph
            finally:
                graph.capture_end()


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
    # the session's decode step: its own captured graph, or one leased from
    # ``graph_pool``; a fork or snapshot gets its own
    _graph: Optional[DecodeGraph] = field(default=None, init=False,
                                          repr=False, compare=False)
    # gives a leased graph back to the pool if the session is dropped
    # without ``close``
    _release: Optional[weakref.finalize] = field(
        default=None, init=False, repr=False, compare=False)
    # the pool the graphs capture into and are leased from, shared by this
    # session's forks and snapshots; None: a private pool (and side stream)
    # per graph
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
        require_no_model_axis("serving (a decode session)")
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
        logits = shard_logits(logits_from_hidden(
            self.params["embed"], self.params.get("lm_head"),
            hidden[:, -1:]))[:, 0]
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
        if DecodeSession.graph_steps and (dev.type == "cuda"
                                          or self.graph_pool is not None):
            logits = self._graph_step(tokens, pos, widx)
        else:
            logits = _decode_step(self.cfg, self.params, self.cache, tokens,
                                  pos, widx)
        self.t += 1
        return logits

    def _graph_key(self) -> Hashable:
        return (exec_key("decode", (self.batch, self._ring or 0,
                                    self.enc_len), (self.cache,)),
                tuple(t.data_ptr() for t in tree_leaves(self.params)))

    def _use(self, g: DecodeGraph) -> None:
        self._graph = g
        if self.graph_pool is not None:
            self._release = weakref.finalize(self, self.graph_pool.release, g)

    def _graph_step(self, tokens, pos, widx) -> torch.Tensor:
        """One step through the session's decode graph: its inputs are
        copied into the graph's static inputs, the graph replays, and the
        logits are copied out.  The graph writes the cache in place, as
        the eager step does, and reads the parameters where they live, so
        both must keep their storage.

        At the first step a session with a ``graph_pool`` leases a free
        graph of its key from the pool, if there is one: its cache is
        copied into the graph's cache, which it steps from then on (one
        copy of the cache; a second ``prefill`` or ``load_cross`` writes
        there too).  Otherwise the session captures its own: an eager step
        on a copy of the cache warms up on a side stream (lazy
        initialisation must not happen inside a capture), the step is
        captured on that stream over the session's cache, and replayed —
        so every step's logits, the first too, come from a graph replay.

        Without a ``graph_pool`` the session is alone on the card:
        ``torch.cuda.graph`` syncs the device and empties the allocator's
        cache before it captures (freeing dead graphs' private pools).
        With one (``GraphPool``, the RL loop's generator) another thread
        may train on the card meanwhile, and the pool captures as
        ``GraphPool.capture`` says: no device sync, no cache emptied, the
        trainer's host syncs and allocations allowed."""
        gp = self.graph_pool
        if self._graph is None and gp is not None:
            key = self._graph_key()
            g = gp.lease(key)
            if g is not None:
                for dst, src in zip(tree_leaves(g.cache),
                                    tree_leaves(self.cache)):
                    dst.copy_(src)
                self.cache = g.cache
                self._use(g)
            else:
                self._use(self._capture(tokens, pos, widx, key))
                gp.add(self._graph)
        elif self._graph is None:
            self._use(self._capture(tokens, pos, widx, None))
        g = self._graph
        for dst, src in zip(g.static, (tokens, pos, widx)):
            dst.copy_(src)
        g.replay()
        return g.out.clone()

    def _capture(self, tokens, pos, widx, key) -> DecodeGraph:
        cfg, params, cache = self.cfg, self.params, self.cache
        static = tuple(t.clone() for t in (tokens, pos, widx))
        if self.device.type != "cuda":
            # the CPU stand-in (a pool's logic without CUDA): an eager step
            # over the same static tensors; the first, on a copy of the
            # cache, gives the logits' buffer
            out = _decode_step(cfg, params, map_tree(torch.clone, cache),
                               *static)

            def replay():
                out.copy_(_decode_step(cfg, params, cache, *static))

            return DecodeGraph(key, replay, static, out, cache)
        gp = self.graph_pool
        side = torch.cuda.Stream() if gp is None else gp.stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _decode_step(cfg, params, map_tree(torch.clone, cache), *static)
            graph = torch.cuda.CUDAGraph()
            with (torch.cuda.graph(graph, stream=side) if gp is None
                  else gp.capture(graph)):
                out = _decode_step(cfg, params, cache, *static)
        torch.cuda.current_stream().wait_stream(side)
        return DecodeGraph(key, graph.replay, static, out, cache)

    def close(self) -> None:
        """End the session: a graph leased from a pool goes back to it for
        the next session of its shape (which overwrites its cache), so the
        session must not be used again."""
        if self._release is not None:
            self._release()
        self._graph = self._release = None
        self.cache = None

    def step(self, tokens) -> torch.Tensor:
        """Decode one token per branch.  ``tokens``: [batch] (or [batch,1])
        ints.  Returns logits [batch, padded_vocab] (fp32)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        logits = self._advance(tokens)
        self.stats.decode_tokens += self.batch
        return logits

