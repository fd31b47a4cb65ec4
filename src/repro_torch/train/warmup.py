"""Compile warm-up: make the signature universe ready, keep the kernel
builds across runs, pre-warm the planner's upcoming shapes.

Port of ``repro/train/warmup.py``.  What a first use stalls on in the
port is not a trace and an XLA compile but the ``nvcc`` build and the
``ctypes`` load of the kernel libraries that a dispatch launches
(``kernels/build``); training runs eager PyTorch, so once they are loaded
every shape runs with no further first-use cost, and the executable that
an ``ExecutableCache`` key holds is the eager function
(``train/exec_cache.executable``).  The reference's three parts:

  startup warm-up    :class:`AOTWarmupService` enumerates the universe,
                     synthesizes each signature's key from host-side
                     shapes (``meta`` tensors) and makes every bucket's
                     executables on background threads, packed signature
                     first, then wave buckets by simulated hit frequency
                     (``CompileCacheSim.freq``): the first ``nvcc`` builds
                     run while the run initialises parameters and builds
                     its first plans;
  planner pre-warm   ``prewarm(step=...)`` keys a built PlannedStep's
                     dispatches from the plan's own host columns;
                     ``train/planner.plans(..., warmup=svc)`` calls it on
                     the pipeline's build threads, so
                     ``TreeTrainEngine``'s lookup finds every key;
  persistence        :func:`configure_compile_cache` points the kernel
                     builds at a directory that a later process reuses
                     (``kernels/build.set_build_dir``): a restarted run
                     builds nothing.

Keys for a wave are fingerprinted from the wave's host-side columns and
capture plans (``train/engine.wave_key_args``), not from the gateway
tensors that the forward sweep assembles from them.  On a data axis the
universe is enumerated at ``num_replicas`` = the axis size, and every key
is the step's global shape (a rank's share follows from it), so the
engines of all ranks find the keys the planner pre-warmed.  The warm-up
threads need not re-enter the mesh, as the reference's must
(``train/warmup.py:383-417``): the port's mesh context
(``sharding.use_mesh``) is module state.

Run ``python -m repro_torch.train.warmup --persist-probe DIR`` twice to
measure the restart: each run prints JSON with the number of NEW files it
wrote into DIR (second run: 0) and its first step's latency.  It runs on
``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
from typing import Hashable, Iterable, Optional, Sequence

import torch

from repro_torch.analysis.signatures import SignatureUniverse
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan_cost import (CompileCacheSim, packed_signature,
                                        pow2, round_to_multiple,
                                        wave_signature, wave_signature_of)
from repro_torch.data.loader import LoaderConfig
from repro_torch.device import DeviceLike, resolve_device, tree_leaves
from repro_torch.kernels import build
from repro_torch.kernels import tree_attention as ta
from repro_torch.kernels import tree_attention_bwd as tab
from repro_torch.models.model import max_conv_taps, needs_chunks
from repro_torch.train.engine import (packed_key_args, variant_fn,
                                      wave_key_args)
from repro_torch.train.exec_cache import (ExecutableCache, abstractify,
                                          exec_key, executable)
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# The kept build directory
# ---------------------------------------------------------------------------

def configure_compile_cache(cache_dir: str) -> str:
    """Build the kernel libraries into (and load them from) ``cache_dir``,
    created if missing; returns its absolute path.  A later process that
    names the same directory finds them built.  Call before the first
    kernel launch: a library already loaded stays loaded."""
    return str(build.set_build_dir(cache_dir))


def compile_cache_files(cache_dir: str) -> int:
    """Number of files under ``cache_dir`` — the restart metric: a warm
    restart adds 0 new files."""
    n = 0
    for _, _, names in os.walk(cache_dir):
        n += len(names)
    return n


# ---------------------------------------------------------------------------
# Key synthesis per signature, from host-side shapes (no real plan)
# ---------------------------------------------------------------------------

def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_rows(cfg: ModelConfig, rows: int, seq_len: int) -> dict:
    """The row columns every packed batch and wave has, as ``meta``
    tensors (``models/model.batch_arrays``)."""
    b = {k: _meta((rows, seq_len))
         for k in ("tokens", "pos_ids", "kv_last", "prev_idx")}
    b["weight"] = _meta((rows, seq_len), torch.float32)
    b["valid"] = _meta((rows, seq_len), torch.bool)
    if needs_chunks(cfg):
        taps = max(1, max_conv_taps(cfg))
        b["chunk_parent"] = _meta((rows, seq_len // cfg.ssm.chunk_size))
        b["prev_pows"] = _meta((rows, seq_len, taps))
    return b


def abstract_packed_batch(cfg: ModelConfig, rows: int, seq_len: int
                          ) -> dict:
    """The host columns of a [rows, seq_len] packed microbatch as ``meta``
    tensors — field for field what ``PlannedStep.step_batch`` makes
    (``num_trees`` stays a Python int: one executable serves every tree
    count)."""
    b = _abstract_rows(cfg, rows, seq_len)
    if cfg.frontend is not None:
        b["extra_embeds"] = _meta((rows, cfg.frontend_len, cfg.d_model),
                                  torch.float32)
    b["num_trees"] = 1
    return b


def _abstract_wave_batch(cfg: ModelConfig, rows: int, seq_len: int,
                         anc: int, n_extra: int) -> dict:
    """A wave bucket's host columns as ``meta`` tensors — mirrors
    ``core/gateway.build_partition_plan``'s batch construction."""
    b = _abstract_rows(cfg, rows, seq_len)
    if n_extra:
        b["extra_pos"] = _meta((rows, n_extra))
        b["extra_label"] = _meta((rows, n_extra))
        b["extra_weight"] = _meta((rows, n_extra), torch.float32)
    if anc:
        b["anc_pos"] = _meta((rows, anc))
        b["anc_valid"] = _meta((rows, anc), torch.bool)
    return b


def _abstract_capspecs(cfg: ModelConfig, ncut: int, plen: int) -> dict:
    """A wave bucket's capture plans (``gateway._wave_capspecs``)."""
    taps = max(1, max_conv_taps(cfg))
    return {f"c{i}": {"path_idx": _meta((plen,)),
                      "cut_chunk": _meta(()),
                      "conv_pos": _meta((min(taps, plen),)),
                      "shift_pos": _meta((1,))}
            for i in range(ncut)}


# ---------------------------------------------------------------------------
# Universe enumeration (independent of SignatureUniverse.enumerate_signatures
# — the tests hold the two lists equal)
# ---------------------------------------------------------------------------

DEFAULT_CAPS = (64, 8, 64, 8)     # (anc, ncut, plen, extra) fallbacks


def universe_signatures(lc: LoaderConfig, pc, caps: Sequence[int]
                        ) -> list[Hashable]:
    """Every live signature the planner can emit under (lc, pc), bounded
    by per-field ``caps = (anc, ncut, plen, extra)``.  Deliberately a
    second, independent implementation of
    ``SignatureUniverse.enumerate_signatures``: the two must agree, so
    neither can drift from what the engine keys."""
    S = lc.seq_len
    R = max(getattr(pc, "num_replicas", 1), 1)
    max_rows = pc.max_rows if pc.max_rows is not None else lc.batch_rows
    anc_cap, ncut_cap, plen_cap, extra_cap = caps
    plen_cap = min(plen_cap, pow2(lc.capacity or S))
    sigs: list[Hashable] = [
        packed_signature(round_to_multiple(lc.batch_rows, R), S)]

    def pow2s(lo, cap):
        b = lo
        while b <= cap:
            yield b
            b *= 2

    for rows in pow2s(R, R * pow2(-(-max_rows // R))):
        # leaf waves: gateway in, no cuts → no capture paths, no extras
        for anc in pow2s(8, anc_cap):
            sigs.append(wave_signature(rows, S, anc, 0, 0, 0))
        for ncut in pow2s(1, ncut_cap):
            for plen in pow2s(1, plen_cap):
                for n_extra in pow2s(1, min(extra_cap, ncut)):
                    # root waves (anc=0) always cut — a cut-less rootless
                    # wave would be a row-sized tree, which packs instead
                    sigs.append(wave_signature(rows, S, 0, ncut, plen,
                                               n_extra))
                    for anc in pow2s(8, anc_cap):
                        sigs.append(wave_signature(rows, S, anc, ncut,
                                                   plen, n_extra))
    return sigs


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

class AOTWarmupService:
    """Fills an :class:`ExecutableCache` ahead of the engine.

    Two producers:

      ``start()``/``warm_all()``  enumerate the signature universe and make
          every bucket's executables (packed first, then waves by
          ``CompileCacheSim.freq`` hit frequency, small buckets first on
          ties), on background threads or synchronously;
      ``prewarm(step=...)``       key one built PlannedStep's exact
          dispatches — the planner pipeline calls this from its build
          workers the moment a window's plans exist.

    Construct it with the ``cfg``, ``opt_cfg`` and ``impl`` the engine
    runs with and its parameters (their device is where the kernels are
    loaded), then hand
    ``service.cache`` and ``service.universe`` to
    :class:`~repro_torch.train.engine.TreeTrainEngine`."""

    def __init__(self, cfg: ModelConfig, lc: LoaderConfig, pc=None, *,
                 params, opt_cfg: Optional[OptimizerConfig] = None,
                 opt_state=None, cache: Optional[ExecutableCache] = None,
                 impl: str = "kernel",
                 universe: Optional[SignatureUniverse] = None,
                 caps: Optional[Sequence[int]] = None,
                 sim: Optional[CompileCacheSim] = None,
                 max_compiles: Optional[int] = None):
        if pc is None:
            from repro_torch.train.planner import PlannerConfig
            pc = PlannerConfig()
        self.cfg, self.lc, self.pc = cfg, lc, pc
        self.impl = impl
        self.device = tree_leaves(params)[0].device
        self.cache = cache if cache is not None else ExecutableCache()
        self.sim = sim
        self.caps = tuple(caps) if caps is not None else DEFAULT_CAPS
        self.max_compiles = max_compiles
        self.universe = universe or SignatureUniverse(
            seq_len=lc.seq_len, batch_rows=lc.batch_rows,
            num_replicas=pc.num_replicas,
            max_rows=(pc.max_rows if pc.max_rows is not None
                      else lc.batch_rows),
            capacity=lc.capacity or lc.seq_len)
        self.params_a = abstractify(params)
        self.opt_cfg = opt_cfg
        self.opt_a = None
        if opt_cfg is not None:
            self.opt_a = abstractify(opt_state if opt_state is not None
                                     else init_opt_state(self.params_a))
        self.errors = []              # the failures, as text
        self.prewarmed = 0
        self.background_s = 0.0
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._lock = threading.Lock()      # prewarmed, background_s

    # -- enumeration -------------------------------------------------------
    def signature_list(self) -> list[Hashable]:
        """The warm-up list: the live universe under ``caps``, packed
        signature first, then wave buckets by descending simulated hit
        frequency (``sim.freq``), smallest bucket first on ties."""
        sigs = universe_signatures(self.lc, self.pc, self.caps)
        freq = self.sim.freq if self.sim is not None else {}

        def order(s):
            if s[0] == "packed":
                return (0, 0, ())
            return (1, -freq.get(s, 0), s[1:])
        return sorted(sigs, key=order)

    # -- per-signature fill ------------------------------------------------
    def _variants_for(self, sig: Hashable) -> list[tuple]:
        """(variant, key args) pairs one signature keys — the exact keys
        ``TreeTrainEngine`` resolves."""
        if sig == ("update",):
            if self.opt_cfg is None:
                return []
            return [("update", (self.params_a, self.opt_a))]
        if sig[0] == "packed":
            _, rows, S = sig
            key = (self.params_a, abstract_packed_batch(self.cfg, rows, S))
            return [("packed", key), ("packed+acc", key)]
        _, rows, S, anc, ncut, plen, n_extra = sig
        key = (self.params_a,
               _abstract_wave_batch(self.cfg, rows, S, anc, n_extra),
               _abstract_capspecs(self.cfg, ncut, plen))
        return [("wave.fwd", key), ("wave.bwd", key)]

    def _fill(self, variant: str, sig: Hashable, key_args: tuple) -> int:
        """Make one key's executable; 1 if it was new.  A failure is
        recorded (and logged) but never raises — the engine's synchronous
        slow path stays the correctness backstop."""
        try:
            _, was_new = self.cache.compile_once(
                exec_key(variant, sig, key_args),
                lambda: executable(variant, variant_fn(
                    variant, self.cfg, self.impl, self.opt_cfg),
                    self.impl, self.device))
            return int(was_new)
        except Exception as e:          # noqa: BLE001 — recorded, logged
            with self._lock:
                self.errors.append(f"{sig}/{variant}: {e}")
            logger.warning("warmup failed for %s/%s: %s", sig, variant, e)
            return 0

    def warm_signature(self, sig: Hashable) -> int:
        """Make every executable variant of one signature; returns how
        many were new."""
        new = 0
        for variant, key_args in self._variants_for(sig):
            if self._stop.is_set():
                break
            new += self._fill(variant, sig, key_args)
        return new

    # -- startup warm-up ---------------------------------------------------
    def _budgeted(self, sigs: Iterable[Hashable]) -> list[Hashable]:
        out = list(sigs)
        if self.max_compiles is not None:
            # 2 executables per signature (fwd+bwd / packed pair)
            keep = max(self.max_compiles // 2, 1)
            if len(out) > keep:
                logger.info(
                    "warmup budget: compiling %d of %d universe "
                    "signatures (hottest first)", keep, len(out))
                out = out[:keep]
        return out

    def warm_all(self) -> int:
        """Synchronously make the update + the whole (budgeted) universe;
        returns the number of new executables."""
        t0 = time.perf_counter()
        new = self.warm_signature(("update",))
        for sig in self._budgeted(self.signature_list()):
            new += self.warm_signature(sig)
        with self._lock:
            self.background_s += time.perf_counter() - t0
        return new

    def start(self, threads: int = 1) -> "AOTWarmupService":
        """Background startup warm-up: the universe list is made on
        ``threads`` daemon workers in priority order (the first kernel
        builds among them).  Returns self."""
        work = self._budgeted(self.signature_list())
        work.insert(0, ("update",))
        it = iter(work)
        lock = threading.Lock()

        def run():
            t0 = time.perf_counter()
            while not self._stop.is_set():
                with lock:
                    sig = next(it, None)
                if sig is None:
                    break
                self.warm_signature(sig)
            with self._lock:
                self.background_s += time.perf_counter() - t0

        self._threads = [threading.Thread(target=run, daemon=True,
                                          name=f"aot-warmup-{i}")
                         for i in range(max(1, threads))]
        for t in self._threads:
            t.start()
        return self

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the background workers; True when all finished."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            t.join(None if deadline is None
                   else max(deadline - time.monotonic(), 0))
        return not any(t.is_alive() for t in self._threads)

    def stop(self) -> None:
        self._stop.set()

    # -- planner pre-warm --------------------------------------------------
    def prewarm(self, signatures: Optional[Iterable[Hashable]] = None,
                step=None) -> int:
        """Make upcoming work's executables before the engine consumes it;
        returns the number of new ones.

        ``step``: a built PlannedStep — its packed batch, every wave and
        the optimizer update are keyed from the plan's own host columns
        (``packed_key_args``, ``wave_key_args``), so the engine's lookup
        finds them.  ``signatures``: bare signatures, synthesized like the
        startup universe.  The planner pipeline calls this on its build
        threads (``plans(..., warmup=svc)``)."""
        new = self.warm_signature(("update",))
        for sig in (signatures or ()):
            new += self.warm_signature(sig)
        if step is not None:
            plan = step.execution_plan()
            sigs: list[Hashable] = []
            if plan.packed is not None:
                B, S = plan.packed.inputs["tokens"].shape
                sig = packed_signature(B, S)
                sigs.append(sig)
                new += self._fill("packed+acc" if plan.has_waves
                                  else "packed", sig,
                                  packed_key_args(self.params_a, plan))
            if plan.has_waves:
                for wp in plan.partition.waves:
                    sig = wave_signature_of(wp, step.lc.seq_len)
                    sigs.append(sig)
                    key_args = wave_key_args(self.params_a, wp)
                    new += self._fill("wave.fwd", sig, key_args)
                    new += self._fill("wave.bwd", sig, key_args)
            if self.sim is not None:
                self.sim.commit(sigs)
        with self._lock:
            self.prewarmed += new
        return new

    def stats(self) -> dict:
        s = self.cache.stats()
        with self._lock:
            s.update(prewarmed=self.prewarmed, errors=len(self.errors),
                     background_s=self.background_s)
        return s


# ---------------------------------------------------------------------------
# Persist probe (the restart, measured from a fresh process)
# ---------------------------------------------------------------------------

def _probe_config() -> ModelConfig:
    from repro_torch.configs.base import AttnCfg
    # head_dim 16: the smallest the CUDA kernels are built for
    return ModelConfig(
        name="warmup-probe", family="dense", n_layers=2, d_model=64,
        d_ff=128, vocab_size=256,
        attn=AttnCfg(n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True),
        dtype="float32", vocab_pad_multiple=64)


def _persist_probe(cache_dir: str, device: DeviceLike = None) -> dict:
    """One fresh-process probe: build the kernels into ``cache_dir``,
    pre-warm a tiny real plan stream (packed rows + partition waves), run
    one engine step, and report how many NEW files this process wrote
    there.  Run twice with the same directory: run 1 fills it, run 2 must
    report ``new_cache_files == 0`` (the warm-restart claim)."""
    from repro_torch.models.model import init_params
    from repro_torch.train.engine import TreeTrainEngine
    from repro_torch.train.planner import PlannerConfig, plan_stream

    dev = resolve_device(device)
    cache_dir = configure_compile_cache(cache_dir)
    files0 = compile_cache_files(cache_dir)
    t_start = time.perf_counter()
    build.build_all([ta.SOURCE, *tab.SOURCES])

    cfg = _probe_config()
    lc = LoaderConfig(seq_len=64, batch_rows=2, trees_per_batch=2,
                      auto_partition=True, capacity=32, seed=5,
                      gen_kwargs=dict(num_turns=2,
                                      turn_len_range=(8, 20)))
    pc = PlannerConfig()
    steps = list(plan_stream(cfg, lc, 1, pc))
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    opt_cfg = OptimizerConfig()
    opt_state = init_opt_state(params)

    svc = AOTWarmupService(cfg, lc, pc, params=params, opt_cfg=opt_cfg,
                           opt_state=opt_state)
    t0 = time.perf_counter()
    for ps in steps:
        svc.prewarm(step=ps)
    warm_s = time.perf_counter() - t0

    eng = TreeTrainEngine(cfg, opt_cfg, exec_cache=svc.cache,
                          universe=svc.universe)
    t0 = time.perf_counter()
    # the step ends in its one host sync, so the clock reads a finished step
    params, opt_state, metrics = eng.step(params, opt_state,
                                          steps[0].execution_plan())
    step1_ms = (time.perf_counter() - t0) * 1e3

    return dict(cache_dir=cache_dir, device=str(dev),
                new_cache_files=compile_cache_files(cache_dir) - files0,
                aot_executables=len(svc.cache),
                compile_s=round(svc.cache.compile_s, 3),
                prewarm_s=round(warm_s, 3),
                retraces=eng.retraces,
                step1_ms=round(step1_ms, 2),
                loss=float(metrics["loss"]),
                wall_s=round(time.perf_counter() - t_start, 3))


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="compile warm-up utilities (persist-probe mode)")
    ap.add_argument("--persist-probe", metavar="CACHE_DIR",
                    help="fill/verify the kept kernel build directory from "
                         "a fresh process and print JSON stats")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions and loads no library)")
    args = ap.parse_args(argv)
    if args.persist_probe:
        print(json.dumps(_persist_probe(args.persist_probe, args.device)))
        return 0
    ap.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
