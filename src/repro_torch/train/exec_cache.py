"""Signature-keyed executable cache: the runtime half of the compile warm-up.

Port of ``repro/train/exec_cache.py``.  ``analysis/signatures`` bounds the
shapes a planner run emits by an enumerable pow2-bucket
:class:`~repro_torch.analysis.signatures.SignatureUniverse`; this module
holds what the engine runs for each of them.  Every engine dispatch
(packed microbatch with or without accumulator, wave forward and
backward, optimizer update) is keyed by

    (variant, signature, mesh, arg fingerprint)

where the *signature* is the planner-level shape bucket
(``core/plan_cost.packed_signature`` / ``wave_signature``) and the
*fingerprint* pins the layout and the exact leaf shapes and dtypes that the
signature does not capture.

The port runs eager PyTorch, so what a key holds is the eager function,
made callable by loading the kernel libraries that the variant launches
(``load_kernels``: the ``nvcc`` builds and ``ctypes`` loads of
``kernels/build``) — the first use's stall, which the reference's
``lower().compile()`` is.  A hit returns the function with nothing left to
build; a miss makes it synchronously, which the engine counts as a
retrace.  The warm-up service (``train/warmup``) fills the cache ahead of
the engine, on background threads and from the planner's build threads.

Thread-safe; imports torch, numpy and the kernels' loaders only, so every
layer can share it without cycles.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Hashable, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, flatten_tree, map_tree
from repro_torch.kernels import build
from repro_torch.kernels import tree_attention as ta
from repro_torch.kernels import tree_attention_bwd as tab
from repro_torch.sharding import mesh_key

# the kernels each training variant launches under impl="kernel": a
# packed execution and a wave's backward (its forward recomputed) run the
# forward, dq and dk/dv; a wave's forward sweep the forward alone
VARIANT_KERNELS = {"packed": ("fwd", "bwd"), "packed+acc": ("fwd", "bwd"),
                   "wave.fwd": ("fwd",), "wave.bwd": ("fwd", "bwd"),
                   "update": ()}


def _is_array(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, np.ndarray, np.generic))


def _dtype_name(dtype) -> str:
    """``torch.int32`` and ``np.int32`` both → ``'int32'``, so a host
    column and its device tensor fingerprint alike."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def abstractify(x):
    """Tree of tensors / numpy arrays → the same tree of ``meta`` tensors
    of their shapes and dtypes (no storage, nothing copied); other leaves
    (Python ints such as the batch's ``num_trees``) pass through."""
    def one(leaf):
        if not _is_array(leaf):
            return leaf
        dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else \
            torch.from_numpy(np.empty(0, leaf.dtype)).dtype
        return torch.empty(tuple(leaf.shape), dtype=dtype, device="meta")
    return map_tree(one, x)


def arg_fingerprint(args: tuple) -> Hashable:
    """Structural fingerprint of a call's arguments: every leaf's key path
    (the layout) with its (shape, dtype) for a tensor or array and its
    *type* for anything else (one function serves every value of
    ``num_trees``).  Reads only ``.shape`` and ``.dtype``: a device tensor
    is fingerprinted without a sync."""
    def one(leaf):
        if _is_array(leaf):
            return (tuple(leaf.shape), _dtype_name(leaf.dtype))
        return ("py", type(leaf).__name__)
    return tuple((path, one(leaf)) for path, leaf in flatten_tree(args))


def exec_key(variant: str, sig: Hashable, args: tuple) -> Hashable:
    """The cache key one engine dispatch resolves to: with the active
    mesh's shape and sequence parallelism (``sharding.mesh_key``), which
    change the collectives a dispatch issues."""
    return (variant, sig, mesh_key(), arg_fingerprint(args))


def load_kernels(variant: str, impl: str, device: DeviceLike) -> None:
    """Build (one ``nvcc`` for each source not built yet, all started
    together) and load the kernel libraries that ``variant`` launches under
    ``impl="kernel"`` on a CUDA device; nothing elsewhere (the CPU runs
    the kernels' plain versions)."""
    kernels = VARIANT_KERNELS[variant]
    if impl != "kernel" or torch.device(device).type != "cuda" \
            or not kernels:
        return
    build.build_all([ta.SOURCE] + (list(tab.SOURCES) if "bwd" in kernels
                                   else []))
    ta.load()
    if "bwd" in kernels:
        tab.load()


def executable(variant: str, fn: Callable, impl: str,
               device: DeviceLike) -> Callable:
    """``fn`` once the kernels it launches are loaded: what a cache key
    holds."""
    load_kernels(variant, impl, device)
    return fn


class ExecutableCache:
    """Thread-safe {exec_key: callable} with hit/miss/compile accounting.
    One instance is shared by the warm-up service (producer), the
    planner's pre-warm hook (producer, on build threads) and the engine
    (consumer); ``compile_once`` makes concurrent fills of one key
    idempotent (the first insert wins; the builds under
    ``kernels/build.BUILD_LOCK`` run once)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._store = {}              # exec_key → executable
        self.hits = 0
        self.misses = 0            # lookups that found nothing
        self.inserts = 0           # distinct executables cached
        self.compile_s = 0.0       # seconds spent making executables for
        #                            this cache, across all threads

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._store

    def signatures(self) -> set:
        """The distinct planner-level signatures held."""
        with self._lock:
            return {k[1] for k in self._store}

    def get(self, key: Hashable) -> Optional[Callable]:
        with self._lock:
            c = self._store.get(key)
            if c is None:
                self.misses += 1
            else:
                self.hits += 1
            return c

    def put(self, key: Hashable, compiled: Callable) -> bool:
        """Insert; returns False if the key was already present (the
        existing executable is kept — first insert wins)."""
        with self._lock:
            if key in self._store:
                return False
            self._store[key] = compiled
            self.inserts += 1
            return True

    def compile_once(self, key: Hashable, make: Callable[[], Callable]
                     ) -> tuple[Callable, bool]:
        """``make()`` the executable and cache it under ``key``; a no-op
        returning the cached one if the key is already filled.  Returns
        (executable, was_new)."""
        with self._lock:
            c = self._store.get(key)
        if c is not None:
            return c, False
        t0 = time.perf_counter()
        compiled = make()
        dt = time.perf_counter() - t0
        with self._lock:
            if key in self._store:
                return self._store[key], False
            self._store[key] = compiled
            self.inserts += 1
            self.compile_s += dt
            return compiled, True

    def stats(self) -> dict:
        with self._lock:
            return dict(size=len(self._store), hits=self.hits,
                        misses=self.misses, inserts=self.inserts,
                        compile_s=self.compile_s)


ExecLookup = Callable[[str, Hashable, Any, tuple], Any]


def make_lookup(cache: Optional[ExecutableCache], impl: str = "kernel",
                device: DeviceLike = "cpu") -> Optional[ExecLookup]:
    """A bare (variant, sig, fn, args) → executable resolver over a cache,
    for callers outside the engine (no retrace accounting): a hit returns
    the cached executable, a miss makes it synchronously and fills."""
    if cache is None:
        return None

    def lookup(variant: str, sig: Hashable, fn, args: tuple):
        compiled, _ = cache.compile_once(
            exec_key(variant, sig, args),
            lambda: executable(variant, fn, impl, device))
        return compiled

    return lookup
