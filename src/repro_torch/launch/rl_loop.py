"""Closed-loop async tree-RL launcher: rollout → tree → train.

Port of ``repro/launch/rl_loop.py``:

  PYTHONPATH=src python -m repro_torch.launch.rl_loop --arch qwen1p5_0p5b \\
      --smoke --device cpu --steps 3

One process, three overlapped stages (paper §2's RL model-update phase):

  generation   a daemon thread decodes ``--groups`` rollout groups per
               optimizer step — ``--k`` branches sharing one prompt's
               prefilled KV (``serve/rollout``, prefix computed ONCE per
               group) — merges each group into a GRPO advantage tree and
               queues it (``serve/service``); on the card it runs on a
               stream of its own, beside the trainer's;
  planning     ``train/planner.plans`` consumes the live queue exactly
               like a synthetic stream: lookahead Tree Packing, background
               materialization;
  training     ``TreeTrainEngine.step`` with ``loss_mode="rl"``; every
               step publishes fresh weights back to the generator's
               :class:`WeightStore` (a device copy, no host sync).

Staleness is *bounded*, not best-effort: generation blocks until the
trainer is within ``--max-ahead`` steps, the queue holds at most
``--max-ahead`` step-batches, and the engine audits each consumed plan's
weight versions — the run fails loudly if the observed lag ever exceeds
``max_ahead + lookahead − 1``.

``--check-grads`` freezes one rollout group at the final weights and
verifies the online plan path reproduces the offline ``loss_mode="rl"``
gradients to ≤1e-6 max-rel.  ``--ckpt-every``/``--resume`` give the
long-running service a mid-stream restart point.  It runs on ``cuda``
unless ``--device`` names another device; ``--impl kernel`` (the default)
runs the hand-written CUDA kernels there, ``--impl chunked`` the
online-softmax scan over key chunks and ``--impl ref`` the
materialized-mask attention (both plain torch ops).

Before the store and the generation thread start, ``main`` warms every
executable outside the loop (``_warm``): the kernels are built (into
``--compile-cache-dir`` when given, where a later run finds them), one
probe rollout group runs through the generator's ``GraphPool`` and
parameter buffer, which captures the decode graphs the loop's groups then
replay (the batch-1 graph where the family prefills through the step
loop, and the batch-K one), every step of the probe's window is
prewarmed into the AOT warm-up service's executable cache
(``train/warmup``), and two ``engine.warmup`` passes run through that
cache on copies of the parameters and optimizer state.  In the loop the
engine dispatches from the shared cache and the planner pre-warms each
new step (``plans(..., warmup=)``); with ``--smoke``, or on the card, the
run requires 0 retraces and 0 decode-graph captures inside the loop.  On
the card the warm-up ends by emptying the allocator's cache, and after
the loop the run reports the reserved and free device memory and the
cache flushes (0 required).

The loop runs on one rank: it takes the host descriptor as the
reference does (``launch/mesh.host_descriptor``), and on a data axis of
more than one rank (``torchrun``) it raises, since the RL loop and
serving on a data axis are ROADMAP.md Queue A item 7e-ii.

``main`` returns the run's record (per-step metrics and the loop's
totals), which ``chip_smoke.py`` reads.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.plan_cost import CompileCacheSim
from repro_torch.data.loader import LoaderConfig
from repro_torch.device import map_tree, resolve_device, tree_leaves
from repro_torch.launch.mesh import host_descriptor
from repro_torch.models.model import device_batch, init_params
from repro_torch.serve.rollout import RolloutConfig, rollout_group
from repro_torch.serve.service import (AsyncTreeRLService, ServiceConfig,
                                       WeightStore)
from repro_torch.serve.session import GraphPool
from repro_torch.train.checkpoint import (load_checkpoint, load_meta,
                                          save_checkpoint)
from repro_torch.train.engine import TreeTrainEngine
from repro_torch.train.exec_cache import load_kernels
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.planner import PlannerConfig, plan_window, plans
from repro_torch.train.train_step import make_grad_fn
from repro_torch.train.warmup import AOTWarmupService, configure_compile_cache


def max_rel_err(a, b) -> float:
    """max over leaves of |a−b| / (max|b| + eps), in fp32 where the
    leaves live."""
    err = 0.0
    for la, lb in zip(tree_leaves(a), tree_leaves(b)):
        la, lb = la.detach().float(), lb.detach().float()
        denom = max(float(lb.abs().max()), 1e-12)
        err = max(err, float((la - lb).abs().max()) / denom)
    return err


def check_frozen_grads(cfg, lc, pcfg, params, trees, impl) -> float:
    """Online plan path vs offline ``loss_mode="rl"`` gradients for a
    frozen rollout set; returns the max-rel error."""
    steps = [ps for ps in plan_window(cfg, lc, pcfg, [list(trees)])
             if not ps.is_empty]
    _require(len(steps) == 1, "frozen rollout set must plan into one step")
    plan = steps[0].execution_plan()
    _require(plan.packed is not None and plan.num_oversized == 0,
             "grad check wants a purely packed plan (raise --seq-len)")
    engine = TreeTrainEngine(cfg, impl=impl)
    grads, _ = engine.accumulate(params, plan)
    batch = device_batch(plan.packed.inputs, tree_leaves(params)[0].device)
    batch["num_trees"] = plan.num_trees
    _, ref, _ = make_grad_fn(cfg, impl)(params, batch)
    return max_rel_err(grads, ref)


def _require(cond: bool, msg) -> None:
    """The launcher's checks: raise whatever the interpreter's flags."""
    if not cond:
        raise AssertionError(msg)


def _warm(cfg, lc, pcfg, rc, opt_cfg, params, opt_state, impl, dev, seed):
    """Everything the loop would otherwise do for the first time, done
    before it: every kernel built and loaded; the generator's
    ``GraphPool`` and parameter buffer made (under ``inference_mode``, as
    the generator runs) and one probe rollout group run through them, which
    captures the decode graphs of the loop's shape; the probe window's
    steps prewarmed into the ``AOTWarmupService``'s cache; two warm-up
    passes of its plan through that cache on copies of the parameters and
    optimizer state.  Returns (seconds, the service, the pool, the
    buffer)."""
    t0 = time.perf_counter()
    load_kernels("packed", impl, dev)
    warm = AOTWarmupService(cfg, lc, pcfg, params=params, opt_cfg=opt_cfg,
                            opt_state=opt_state, impl=impl,
                            sim=CompileCacheSim())
    pool = GraphPool(dev)
    with torch.inference_mode():
        gen_params = map_tree(torch.clone, params)
        tree, _ = rollout_group(cfg, gen_params,
                                np.zeros(rc.prompt_len, np.int32), rc,
                                torch.Generator(dev).manual_seed(seed),
                                device=dev, graph_pool=pool)
    steps = [ps for ps in plan_window(cfg, lc, pcfg, [[tree]])
             if not ps.is_empty]
    for ps in steps:
        warm.prewarm(step=ps)
    if steps:
        # the window's plan through the SHARED cache, twice: the loop's
        # engine must find every key the probe's plan dispatches
        weng = TreeTrainEngine(cfg, opt_cfg, impl=impl,
                               exec_cache=warm.cache, universe=warm.universe)
        p2 = map_tree(torch.clone, params)
        o2 = map_tree(torch.clone, opt_state)
        plan = steps[0].execution_plan()
        for _ in range(2):
            p2, o2 = weng.warmup(p2, o2, plan)
        _require(weng.host_syncs == 0, "warmup must not sync")
        _require(weng.retraces == 0,
                 "prewarmed executables must cover the warm window")
        del p2, o2
    if dev.type == "cuda":
        # while a capture is open the allocator cannot free cached blocks
        # to retry a failed cudaMalloc: the loop starts with none cached
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return time.perf_counter() - t0, warm, pool, gen_params


def _cache_flushes(dev) -> int:
    """The times the caching allocator freed its cached blocks to retry a
    failed cudaMalloc (0 off the card).  While a decode graph captures, it
    cannot, and the allocation raises instead."""
    if dev.type != "cuda":
        return 0
    return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=4,
                    help="optimizer steps (= generation step-batches)")
    ap.add_argument("--groups", type=int, default=2,
                    help="rollout groups (prompts) per optimizer step")
    ap.add_argument("--k", type=int, default=4,
                    help="branch rollouts per prompt (share the prefix KV)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8,
                    help="decode steps per branch")
    ap.add_argument("--seq-len", type=int, default=96)
    ap.add_argument("--rows", type=int, default=2,
                    help="rows per step (the reference's choice on one "
                         "device is 2)")
    ap.add_argument("--lookahead", type=int, default=1)
    ap.add_argument("--plan-workers", type=int, default=1)
    ap.add_argument("--max-ahead", type=int, default=1,
                    help="generation may run this many optimizer steps "
                         "ahead of the weights it samples (the staleness "
                         "bound)")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--impl", default="kernel",
                    choices=["ref", "chunked", "kernel"],
                    help="kernel (default): the hand-written CUDA kernels, "
                         "their plain versions on a CPU device; chunked: "
                         "the online-softmax scan over key chunks (plain "
                         "torch); ref: the dense-mask attention, kept as "
                         "the comparator")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-grads", action="store_true",
                    help="verify online vs offline RL gradients at exit")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="build the kernel libraries into this directory, "
                         "where a restarted run finds them built")
    ap.add_argument("--save", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.compile_cache_dir is not None and \
            os.path.exists(args.compile_cache_dir) and \
            not os.path.isdir(args.compile_cache_dir):
        ap.error(f"--compile-cache-dir {args.compile_cache_dir}: not a "
                 f"directory")
    if args.ckpt_every is not None and not args.save:
        ap.error("--ckpt-every needs --save (the checkpoint directory)")

    ndata = host_descriptor().data_axis_size
    if ndata > 1:
        ap.error(f"the RL loop runs on one rank, not a data axis of {ndata} "
                 f"ranks: the RL loop and serving on a data axis are "
                 f"ROADMAP.md Queue A item 7e-ii")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    tree_cap = args.prompt_len + args.k * args.max_new
    if tree_cap > args.seq_len:
        ap.error(f"a rollout tree can reach {tree_cap} unique tokens "
                 f"(prompt {args.prompt_len} + {args.k}×{args.max_new}) "
                 f"> --seq-len {args.seq_len}: raise --seq-len to "
                 f"guarantee zero drops")
    lag_bound = args.max_ahead + args.lookahead - 1
    print(f"[rl] arch={cfg.name} k={args.k} groups={args.groups} "
          f"steps={args.steps} max_ahead={args.max_ahead} "
          f"(lag bound {lag_bound}) impl={args.impl} device={dev}",
          flush=True)

    rows = args.rows
    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(2, args.steps // 10))
    lc = LoaderConfig(seq_len=args.seq_len, batch_rows=rows,
                      trees_per_batch=args.groups, mode="tree",
                      seed=args.seed, loss_mode="rl", auto_partition=True)
    pcfg = PlannerConfig(lookahead=args.lookahead,
                         plan_workers=args.plan_workers, max_rows=rows)
    rc = RolloutConfig(k=args.k, prompt_len=args.prompt_len,
                       max_new=args.max_new, temperature=args.temperature,
                       impl=args.impl)
    sc = ServiceConfig(groups_per_step=args.groups,
                       max_ahead_steps=args.max_ahead, rollout=rc,
                       seed=args.seed)

    if args.compile_cache_dir:
        # before any kernel is built or loaded
        d = configure_compile_cache(args.compile_cache_dir)
        print(f"[rl] kernel build directory: {d}")
    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                         device=dev)
    opt_state = init_opt_state(params)
    done = 0
    if args.resume:
        params, opt_state = load_checkpoint(args.resume, params, opt_state)
        done = int(load_meta(args.resume).get("steps", 0))
        print(f"[rl] resumed {args.resume} @ step {done}")

    warm_s, warm, pool, gen_params = _warm(
        cfg, lc, pcfg, rc, opt_cfg, params, opt_state, args.impl, dev,
        args.seed)
    captures0 = pool.captures
    print(f"[rl] warm-up: {warm_s:.2f}s (kernels built, 1 probe rollout "
          f"group capturing {captures0} decode graphs, "
          f"{len(warm.cache)} executables over "
          f"{len(warm.cache.signatures())} signatures, 2 engine.warmup "
          f"passes on copies)", flush=True)

    store = WeightStore(params, version=done)
    engine = TreeTrainEngine(cfg, opt_cfg, impl=args.impl,
                             weight_store=store, exec_cache=warm.cache,
                             universe=warm.universe)
    engine.steps_done = done
    svc = AsyncTreeRLService(cfg, store, sc, num_steps=args.steps,
                             graph_pool=pool, gen_params=gen_params).start()
    pipe = plans(cfg, lc, svc.tree_batches(), pcfg, warmup=warm)

    dropped = 0
    history = []
    flushes0 = _cache_flushes(dev)
    t0 = time.perf_counter()
    t_prev = t0
    for ps in pipe:
        plan = ps.execution_plan()
        dropped += plan.dropped
        if plan.is_empty:
            continue
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ts = time.perf_counter()
        params, opt_state, m = engine.step(params, opt_state, plan)
        t_end = time.perf_counter()
        m.update(step=engine.steps_done - 1, ms=(t_end - ts) * 1e3,
                 wall_ms=(t_end - t_prev) * 1e3,
                 peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                          if dev.type == "cuda" else float("nan")),
                 versions=plan.versions, trees=plan.num_trees,
                 unique_tokens=plan.unique_tokens)
        t_prev = t_end
        history.append(m)
        print(f"step {m['step']:4d} loss {m['loss']:10.4f} "
              f"nll/tok {m['nll']:7.4f} lag {m.get('max_lag', 0)} "
              f"{m['ms']:7.1f}ms (wall {m['wall_ms']:7.1f}ms)"
              + (f" peak {m['peak_gb']:.2f} GB" if dev.type == "cuda"
                 else ""), flush=True)
        if args.ckpt_every and engine.steps_done % args.ckpt_every == 0:
            save_checkpoint(args.save, params, opt_state,
                            meta={"arch": cfg.name,
                                  "steps": engine.steps_done})
    svc.join(10)
    wall = time.perf_counter() - t0

    st = svc.stats
    losses = [m["loss"] for m in history]
    # trainer-visible stall: every second the train loop spent waiting on
    # a plan (which transitively waits on generation); the queue-side wait
    # (the planner's prefetch thread blocking ahead of need) is separate
    exposed = pipe.exposed_s
    overlap = 1.0 - exposed / max(st.gen_busy_s, 1e-9)
    print(f"[rl] {len(history)} optimizer steps, "
          f"{st.trees_generated} trees, {dropped} dropped, "
          f"{wall:.1f}s wall ({engine.host_syncs} host syncs)")
    print(f"[rl] staleness: max lag {engine.max_lag_seen} "
          f"(bound {lag_bound}), min version {st.min_version}")
    print(f"[rl] generation: {st.gen_busy_s * 1e3:.0f}ms busy, "
          f"{exposed * 1e3:.0f}ms exposed to training "
          f"(overlap {overlap:.0%}; queue wait "
          f"{st.exposed_wait_s * 1e3:.0f}ms); "
          f"prefill {st.prefill_tokens} tok "
          f"(+{st.saved_prefill_tokens} reused via shared KV), "
          f"decode {st.decode_tokens} tok")
    print(f"[rl] plan-ahead: {pipe.built} plans, "
          f"{pipe.build_s * 1e3:.0f}ms built", flush=True)
    captures = pool.captures - captures0
    print(f"[rl] aot: {engine.retraces} mid-loop retraces, "
          f"{engine.compile_wait_s * 1e3:.0f}ms exposed compile wait, "
          f"{warm.prewarmed} executables prewarmed; decode graphs: "
          f"{captures0} captured before the loop, {captures} in it, "
          f"{pool.reuses} reuses", flush=True)
    memory = None
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        memory = dict(reserved_gb=torch.cuda.memory_reserved(dev) / 1e9,
                      free_gb=free / 1e9, total_gb=total / 1e9,
                      cache_flushes=_cache_flushes(dev) - flushes0)
        print(f"[rl] device memory: {memory['reserved_gb']:.2f} GB "
              f"reserved, {memory['free_gb']:.2f} GB of "
              f"{memory['total_gb']:.2f} GB free, "
              f"{memory['cache_flushes']} cache flushes in the loop",
              flush=True)
    _require(dropped == 0, f"{dropped} trees dropped")
    if args.smoke or dev.type == "cuda":
        # the loop's whole signature stream was prewarmed on the pipeline's
        # build threads and its groups' graphs captured before it
        _require(engine.retraces == 0,
                 f"{engine.retraces} mid-loop retraces (a cold executable)")
        _require(captures == 0,
                 f"{captures} decode graphs captured inside the loop")
    _require(engine.max_lag_seen <= lag_bound,
             (engine.max_lag_seen, lag_bound))
    _require(all(math.isfinite(x) for x in losses), losses)
    _require(len(history) >= min(args.steps, 1), len(history))
    if args.steps >= 4:
        # short runs are dominated by the unavoidable pipeline-fill wait
        # on the very first plan; only judge overlap once it can amortize
        _require(exposed < 0.5 * st.gen_busy_s,
                 f"generation not overlapped: {exposed * 1e3:.0f}ms "
                 f"exposed vs {st.gen_busy_s * 1e3:.0f}ms busy")

    grad_err = None
    if args.check_grads:
        # freeze one rollout group at the final weights and replay it
        # through the offline path
        with torch.inference_mode():
            tree, _ = rollout_group(
                cfg, params, np.arange(args.prompt_len) % cfg.vocab_size,
                rc, torch.Generator(dev).manual_seed(args.seed + 1),
                device=dev)
        grad_err = check_frozen_grads(cfg, lc, pcfg, params, [tree],
                                      args.impl)
        print(f"[rl] frozen-rollout grad check: max-rel {grad_err:.2e}")
        _require(grad_err <= 1e-6, grad_err)

    if args.save:
        save_checkpoint(args.save, params, opt_state,
                        meta={"arch": cfg.name, "steps": engine.steps_done})
        print(f"[rl] saved → {args.save}")
    return dict(history=history, stats=st, dropped=dropped, wall_s=wall,
                exposed_s=exposed, overlap=overlap, lag_bound=lag_bound,
                max_lag_seen=engine.max_lag_seen, plans_built=pipe.built,
                plan_build_s=pipe.build_s, warmup_s=warm_s,
                grad_err=grad_err, host_syncs=engine.host_syncs,
                steps_done=engine.steps_done, memory=memory,
                retraces=engine.retraces,
                compile_wait_s=engine.compile_wait_s,
                prewarmed=warm.prewarmed, captures_before=captures0,
                captures_in_loop=captures, reuses=pool.reuses)


if __name__ == "__main__":
    main()
