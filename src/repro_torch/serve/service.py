"""Async tree-RL service: rollout → advantage tree → planner queue.

Port of ``repro/serve/service.py``.  A generation thread decodes rollout
groups with shared-prefix KV reuse (``serve/rollout``), tags each merged
tree with the weight version that generated it, and feeds a bounded queue
that the planner consumes as a live tree source, so plan-build AND
generation overlap training, with *bounded* staleness:

  trainer ──publish(params, v)──▶ WeightStore ──wait_for(s − A)──▶ gen
     ▲                                                             │
     └── PlanPipeline ◀── tree_batches() ◀── Queue(maxsize=A) ◀────┘

Two mechanisms bound the off-policy lag to ``max_ahead_steps`` (= A):

* the generator *gates*: before producing step ``s``'s trees it blocks
  until the trainer has published version ≥ ``s − A``;
* the queue *backpressures*: ``put`` blocks once A step-batches are
  waiting, so a stalled trainer also stalls generation.

On the card both threads share one device.  The generator runs on a stream
of its own (``torch.cuda.stream``), so its kernels overlap the trainer's.
Its decode sessions lease their CUDA graphs from one ``GraphPool``
(``serve/session``), by shape: the graphs are captured once, for the first
group of a shape or before ``start`` (the launcher's warm-up hands its
pool in), and every later group replays them.  The graphs read one
parameter buffer of the generator's own (``gen_params``), into which each
snapshot is copied on the generator's stream after ``get``.
``WeightStore.publish`` copies every leaf (the port's AdamW updates the
parameters in place) on the trainer's stream and records an event after
the copy; ``WeightStore.get`` makes the reader's stream wait for that event
and marks the snapshot as used on the reader's stream (``record_stream``),
so the caching allocator never hands a dropped snapshot's memory to the
trainer while the generator's queued kernels may still read it.

The generation thread need not re-enter a mesh, as the reference's does
(``serve/service.py:122-135``): the port's mesh context is module state
(``sharding.use_mesh``), and the RL loop runs on one rank
(``launch/rl_loop``; a data axis is ROADMAP item 7e-ii).
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from queue import Queue
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import TrajectoryTree
from repro_torch.device import map_tree, tree_leaves
from repro_torch.serve.rollout import GroupStats, RolloutConfig, rollout_group
from repro_torch.serve.session import GraphPool


def copy_into(dst: dict, src: dict) -> None:
    """Copy every leaf of ``src`` into ``dst``'s (same layout) on the
    caller's current stream."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


def _snapshot(params: dict) -> tuple[dict, Optional[torch.cuda.Event]]:
    """A copy of every leaf on the caller's current stream and, on the
    card, an event recorded after the copy."""
    fresh = map_tree(lambda t: t.detach().clone(), params)
    dev = tree_leaves(fresh)[0].device
    if dev.type != "cuda":
        return fresh, None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    return fresh, ready


class WeightStore:
    """Versioned, thread-safe parameter snapshot shared trainer→service.

    ``version`` counts completed optimizer steps; the initial params are
    version 0.  All reads/writes hold one condition variable, so
    ``wait_for`` wakes exactly when the trainer publishes.  Publishing is a
    device copy and an event: no host sync."""

    def __init__(self, params: dict, version: int = 0):
        self._cond = threading.Condition()
        self._params, self._ready = _snapshot(params)
        self._version = version

    @property
    def version(self) -> int:
        with self._cond:
            return self._version

    @property
    def device(self) -> torch.device:
        with self._cond:
            return tree_leaves(self._params)[0].device

    def get(self) -> tuple[dict, int]:
        """The newest snapshot and its version.  On the card the calling
        thread's current stream first waits for the copy that made it, and
        every leaf is marked as used on that stream, so the snapshot's
        memory outlives that stream's queued reads after the store (and
        the caller) drop it."""
        with self._cond:
            params, ready, version = self._params, self._ready, self._version
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in tree_leaves(params):
                t.record_stream(stream)
        return params, version

    def publish(self, params: dict, version: int) -> None:
        """Install new weights.  Copies every leaf on the caller's current
        stream, after the work queued there (the update): the caller goes
        on updating its tensors in place."""
        fresh, ready = _snapshot(params)
        with self._cond:
            self._params, self._ready = fresh, ready
            self._version = version
            self._cond.notify_all()

    def wait_for(self, version: int, timeout: Optional[float] = None
                 ) -> bool:
        with self._cond:
            return self._cond.wait_for(
                lambda: self._version >= version, timeout)


@dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the async loop."""
    groups_per_step: int = 2          # rollout groups per optimizer step
    max_ahead_steps: int = 1          # A: generation lead ≤ A steps
    rollout: RolloutConfig = field(default_factory=RolloutConfig)
    seed: int = 0
    gate_timeout_s: float = 120.0     # deadlock guard on wait_for


@dataclass
class ServiceStats:
    gen_busy_s: float = 0.0           # wall time generating
    exposed_wait_s: float = 0.0       # consumer time blocked on the queue
    steps_generated: int = 0
    trees_generated: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    saved_prefill_tokens: int = 0     # (k−1)·P per group: KV-reuse savings
    min_version: Optional[int] = None
    max_gen_lag: int = 0              # max (step − weight_version) at gen


class AsyncTreeRLService:
    """Generates ``num_steps`` step-batches of advantage trees on a daemon
    thread, bounded-staleness gated against a :class:`WeightStore`.

    Consume with :meth:`tree_batches`, an iterator of
    ``list[TrajectoryTree]`` (the planner's native source element), each
    tree carrying ``weight_version``.  Exceptions in the generator are
    re-raised to the consumer.  Generation runs where the store's weights
    live; the step index starts at the store's version, so a loop resumed
    at step ``s0`` gates its first batch on ``s0 − A`` as a fresh one does
    on ``−A``."""

    def __init__(self, cfg: ModelConfig, store: WeightStore,
                 sc: ServiceConfig, num_steps: int, *,
                 graph_pool: Optional[GraphPool] = None,
                 gen_params: Optional[dict] = None):
        self.cfg, self.store, self.sc = cfg, store, sc
        self.num_steps = num_steps
        # where the generator's decode graphs live (made on the card when
        # not given), and the parameter buffer they read (made at the
        # first snapshot when not given; made under inference_mode, as the
        # generator runs, or it could not write it)
        self.graph_pool = graph_pool
        self.gen_params = gen_params
        self.stats = ServiceStats()
        self._queue: Queue = Queue(maxsize=max(1, sc.max_ahead_steps))
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="tree-rl-gen", daemon=True)

    # -- producer ----------------------------------------------------------
    def start(self) -> "AsyncTreeRLService":
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            self._generate()
        except BaseException as e:          # noqa: BLE001 — relayed
            self._error = e
            self._queue.put(None)

    def _generate(self) -> None:
        sc, rc = self.sc, self.sc.rollout
        dev = self.store.device
        rng = np.random.default_rng(sc.seed)
        # the sampling RNG: this thread's alone
        gen = torch.Generator(dev).manual_seed(sc.seed)
        stream, pool = None, self.graph_pool
        if dev.type == "cuda":
            stream = torch.cuda.Stream(dev)
            if pool is None:
                pool = self.graph_pool = GraphPool(dev)
        first = self.store.version
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()), torch.inference_mode():
            for s in range(first, first + self.num_steps):
                # staleness gate: weights can lag at most A steps behind
                if not self.store.wait_for(s - sc.max_ahead_steps,
                                           timeout=sc.gate_timeout_s):
                    raise TimeoutError(
                        f"weight store stuck below version "
                        f"{s - sc.max_ahead_steps} for "
                        f"{sc.gate_timeout_s}s (generation step {s})")
                params, ver = self.store.get()
                if pool is not None:
                    # the graphs read the buffer: the copy is queued on
                    # this stream, after the snapshot's copy (``get``)
                    if self.gen_params is None:
                        self.gen_params = map_tree(torch.empty_like, params)
                    copy_into(self.gen_params, params)
                    params = self.gen_params
                t0 = time.perf_counter()
                trees: list[TrajectoryTree] = []
                for _ in range(sc.groups_per_step):
                    prompt = rng.integers(0, self.cfg.vocab_size,
                                          rc.prompt_len)
                    tree, gs = rollout_group(self.cfg, params, prompt, rc,
                                             gen, device=dev,
                                             graph_pool=pool)
                    tree.weight_version = ver
                    trees.append(tree)
                    self._absorb(gs)
                # let the store's next publish free this snapshot rather
                # than keep it until the next get; reads still queued on
                # this stream are covered by ``get``'s ``record_stream``
                del params
                st = self.stats
                st.gen_busy_s += time.perf_counter() - t0
                st.steps_generated += 1
                st.trees_generated += len(trees)
                st.min_version = (ver if st.min_version is None
                                  else min(st.min_version, ver))
                st.max_gen_lag = max(st.max_gen_lag, s - ver)
                self._queue.put(trees)     # backpressure: ≤ A waiting
        self._queue.put(None)

    def _absorb(self, gs: GroupStats) -> None:
        st = self.stats
        st.prefill_tokens += gs.prefill_tokens
        st.decode_tokens += gs.decode_tokens
        st.saved_prefill_tokens += gs.saved_prefill_tokens

    # -- consumer ----------------------------------------------------------
    def tree_batches(self) -> Iterator[list[TrajectoryTree]]:
        """Live planner source: one list of trees per optimizer step.
        Time spent blocked here is generation *exposed* to training
        (recorded in ``stats.exposed_wait_s``)."""
        while True:
            t0 = time.perf_counter()
            item = self._queue.get()
            self.stats.exposed_wait_s += time.perf_counter() - t0
            if item is None:
                if self._error is not None:
                    raise RuntimeError(
                        "rollout generation failed") from self._error
                return
            yield item

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
