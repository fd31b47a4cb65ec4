"""Training launcher — one loop over the engine.

Port of ``repro/launch/train.py::main``.  Trains tree-mode (or the sep-avg
per-branch baseline) on synthetic agentic trees:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1p5_0p5b \\
      --smoke --steps 3 --device cpu

Every step is an ``ExecutionPlan`` from the plan-ahead scheduler
(``train/planner.plans``: cost-model-driven Tree Packing over a
``--lookahead`` window, ``--plan-workers`` background builders) executed by
``train/engine.TreeTrainEngine.step``; each step performs exactly one host
sync (the logging transfer).  ``--impl kernel`` (the default) runs the
hand-written CUDA kernels on the card (their plain versions on the CPU),
``--impl chunked`` the online-softmax scan over key chunks and ``--impl
ref`` the materialized-mask attention (both plain torch ops).
``--loss-mode rl`` trains the RL model-update objective on GRPO trees.
It runs on ``cuda`` unless ``--device`` names another device.

``--auto-partition`` routes trees larger than one row through
Redundancy-Free Tree Partitioning (partition waves, ``--capacity`` token
cap per partition, ``auto`` by default) instead of dropping them; the run
ends with a ``partitioned: ... dropped`` line:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1p5_0p5b \
      --smoke --auto-partition --capacity 256 --seq-len 512 --device cpu

``--graft`` merges trees of the window that open with the same token
prefix into one grafted forest (``core/forest``; pair with ``--kind
template``).

``--aot-warmup`` starts the compile warm-up (``train/warmup``): the
reachable signature universe is made ready on ``--warmup-threads``
background threads (the kernels' ``nvcc`` builds among it) and each step's
executables are keyed from the planner's build threads, so the engine never
stalls on a first use; the run ends with an ``aot-warmup:`` line (engine
retraces: 0 on an in-universe stream).  ``--compile-cache-dir DIR`` builds
the kernel libraries into DIR, where a restarted run finds them built.

``--mesh host`` (the default) puts a data axis over every rank that
``torchrun`` starts, one device a rank (``launch/mesh.host_descriptor``;
NCCL on the card, gloo with ``--device cpu``); without ``torchrun`` the
run is one process with no process group.  Each rank trains its block of
every step's rows and the grads are summed over the axis
(``train/engine``); every rank builds the same plans from the same seed,
rank 0 prints and saves, and ``--resume`` loads on every rank:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.train --arch qwen1p5_0p5b --smoke --steps 3 \
      --device cpu --mesh host

``--mesh single`` and ``multi`` run the production meshes (one pod of
16 × 16 devices, two pods of 2 × 16 × 16; ``launch/mesh.
production_descriptor``) when ``torchrun`` starts their 256 or 512
ranks, as the reference's launcher does: the rows over the data axes, and
the dense and MoE families' parameters over the model axis of 16
(Megatron tensor parallelism, ``sharding.py``; an MoE model's experts in
blocks of E/16, ``models/moe.py``).  On any other world they exit naming
the ranks needed; a family the model axis does not run yet, or a width
it does not divide, exits naming ROADMAP.md Queue A item 7e-ii.  Every
rank saves (the model axis's gather), rank 0 writes.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.plan_cost import CompileCacheSim
from repro_torch.data.loader import LoaderConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (host_descriptor, join_from_env,
                                     production_descriptor, world_size)
from repro_torch.models.model import init_params
from repro_torch.models.transformer import check_model_axis
from repro_torch.sharding import use_mesh
from repro_torch.train.checkpoint import (load_checkpoint, load_meta,
                                          save_checkpoint)
from repro_torch.train.engine import TreeTrainEngine
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.planner import PlannerConfig, plans
from repro_torch.train.warmup import AOTWarmupService, configure_compile_cache


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mode", default="tree", choices=["tree", "baseline"])
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--rows", type=int, default=None,
                    help="rows per step, a multiple of the data axis "
                         "(default: the reference's auto choice, "
                         "max(2, data-axis size))")
    ap.add_argument("--trees", type=int, default=6)
    ap.add_argument("--lookahead", type=int, default=1,
                    help="generator batches the planner bin-packs "
                         "jointly (global Tree Packing; 1 = per-step)")
    ap.add_argument("--plan-workers", type=int, default=1,
                    help="background plan-builder threads (double-"
                         "buffered against engine.step; 0 = synchronous)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--impl", default="kernel",
                    choices=["ref", "chunked", "kernel"],
                    help="kernel (default): the hand-written CUDA kernels, "
                         "their plain versions on a CPU device; chunked: "
                         "the online-softmax scan over key chunks (plain "
                         "torch); ref: the dense-mask attention, kept as "
                         "the comparator")
    ap.add_argument("--loss-mode", default="sep_avg",
                    choices=["sep_avg", "uniform", "rl"],
                    help="sep_avg: λ_t = g_t/K (SFT, Eq. 4); uniform: "
                         "λ_t = 1; rl: GRPO per-branch advantages scale "
                         "λ_t (the RL model-update phase)")
    ap.add_argument("--kind", default=None,
                    choices=["agentic", "grpo", "random", "template"],
                    help="synthetic tree generator (default: agentic; "
                         "grpo when --loss-mode rl; template = shared "
                         "system-prompt workload for --graft)")
    ap.add_argument("--auto-partition", action="store_true",
                    help="train oversized trees via wave-scheduled "
                         "partitioning instead of dropping them")
    ap.add_argument("--capacity", default="auto",
                    help="partition token cap: an integer forces it; "
                         "'auto' (default) lets the planner choose per "
                         "lookahead window from the oversized trees' "
                         "partition-count/depth trade-off "
                         "(core.partition.choose_capacity)")
    ap.add_argument("--graft", action="store_true",
                    help="cross-tree forest grafting: merge trees that "
                         "share a token prefix (core/forest) before "
                         "packing, so shared system prompts are computed "
                         "once per window")
    ap.add_argument("--min-graft", type=int, default=16,
                    help="minimum shared-prefix tokens for a graft to be "
                         "considered (shorter matches never pay for the "
                         "merge)")
    ap.add_argument("--aot-warmup", action="store_true",
                    help="compile warm-up: make the reachable signature "
                         "universe ready on background threads at startup "
                         "(the kernel builds among it) and pre-warm each "
                         "step's executables from the planner's build "
                         "threads (train/warmup)")
    ap.add_argument("--warmup-threads", type=int, default=1,
                    help="background warm-up threads for --aot-warmup")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="build the kernel libraries into this directory, "
                         "where a restarted run finds them built")
    ap.add_argument("--turns", type=int, default=4,
                    help="turns per agentic/grpo tree")
    ap.add_argument("--turn-len", type=int, nargs=2, default=(8, 48),
                    metavar=("MIN", "MAX"),
                    help="token length range of an agentic/grpo turn "
                         "(longer turns make trees larger than a row, "
                         "which --auto-partition trains)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"],
                    help="host: a data axis over every rank torchrun "
                         "starts (one process without torchrun); single, "
                         "multi: the production meshes (256 and 512 "
                         "ranks), their model axis of 16 for the dense "
                         "and MoE families")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="save params+opt_state to --save every N steps "
                         "(mid-stream resume point)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to resume from (replays the "
                         "deterministic plan stream up to the saved step)")
    ap.add_argument("--log-every", type=int, default=1)
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

    desc = host_descriptor()
    if args.mesh != "host":
        desc = production_descriptor(multi_pod=args.mesh == "multi")
        if world_size() != desc.device_count:
            ap.error(f"--mesh {args.mesh} is the {desc.shape} mesh of "
                     f"{desc.device_count} devices: it needs "
                     f"{desc.device_count} ranks (torchrun "
                     f"--nproc-per-node ... with {desc.device_count} ranks "
                     f"in all), this world has {world_size()}")
        try:
            check_model_axis(get_config(args.arch, smoke=args.smoke),
                             desc.axis_size(desc.model_axis))
        except NotImplementedError as e:
            ap.error(f"--mesh {args.mesh} has a model axis of "
                     f"{desc.axis_size(desc.model_axis)}: {e}")
    dev = join_from_env(resolve_device(args.device))
    try:
        with use_mesh(desc.build(dev.type) if dist.is_initialized()
                      else None, desc.data_axes, desc.model_axis):
            _train(ap, args, dev, desc)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(ap, args, dev: torch.device, desc) -> None:
    """The run on this rank's device, inside the launcher's mesh
    ``desc``."""
    ndata = desc.data_axis_size
    rank = dist.get_rank() if dist.is_initialized() else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.kind is None:
        args.kind = "grpo" if args.loss_mode == "rl" else "agentic"
    say(f"[train] arch={cfg.name} family={cfg.family} mode={args.mode} "
        f"impl={args.impl} loss_mode={args.loss_mode} kind={args.kind} "
        f"device={dev} mesh={desc.name} (data {ndata} x model "
        f"{desc.axis_size(desc.model_axis)})")
    if args.rows is None:
        args.rows = max(2, ndata)
    elif args.rows % ndata:
        ap.error(f"--rows {args.rows} was forced but is not a multiple "
                 f"of the mesh's data axis ({ndata} replicas): batch rows "
                 f"cannot shard evenly; drop --rows to let the planner "
                 f"choose, or pick a multiple of {ndata}")

    auto_capacity = False
    if str(args.capacity).lower() == "auto":
        args.capacity = None
        auto_capacity = True
    else:
        try:
            args.capacity = int(args.capacity)
        except ValueError:
            ap.error(f"--capacity must be an integer or 'auto', got "
                     f"{args.capacity!r}")
    if args.auto_partition:
        if args.mode != "tree":
            ap.error("--auto-partition requires --mode tree (partitioning "
                     "is a tree-serialization feature; baseline mode "
                     "would silently drop oversized trees)")
        if args.capacity is not None and not 0 < args.capacity <= \
                args.seq_len:
            ap.error(f"--capacity {args.capacity} must be in (0, --seq-len "
                     f"{args.seq_len}]")
        if (args.capacity is not None and cfg.ssm is not None
                and args.capacity % cfg.ssm.chunk_size != 0):
            ap.error(f"--capacity {args.capacity} must be a multiple of the "
                     f"SSM chunk size {cfg.ssm.chunk_size}")
    if args.graft and args.mode != "tree":
        ap.error("--graft requires --mode tree (grafted forests are "
                 "serialized trees; baseline rows cannot share prefixes)")

    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(2, args.steps // 10))
    # generator kwargs differ per kind (agentic/grpo take turn shapes,
    # random takes segment shapes) — the reference launcher's
    gen_kwargs = (dict(seg_len_range=(8, 48), max_depth=4)
                  if args.kind == "random"
                  else dict(turn_len_range=tuple(args.turn_len),
                            num_turns=args.turns))
    lc = LoaderConfig(seq_len=args.seq_len, batch_rows=args.rows,
                      trees_per_batch=args.trees, mode=args.mode,
                      kind=args.kind, seed=args.seed,
                      loss_mode=args.loss_mode,
                      auto_partition=args.auto_partition,
                      capacity=args.capacity, auto_capacity=auto_capacity,
                      gen_kwargs=gen_kwargs)

    if args.compile_cache_dir:
        # before any kernel is built or loaded
        d = configure_compile_cache(args.compile_cache_dir)
        say(f"[train] kernel build directory: {d}")
    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                         device=dev)
    opt_state = init_opt_state(params)
    done = 0
    if args.resume:
        params, opt_state = load_checkpoint(args.resume, params, opt_state)
        done = int(load_meta(args.resume).get("steps", 0))
        say(f"[train] resumed {args.resume} @ step {done}")

    pcfg = PlannerConfig(lookahead=args.lookahead,
                         plan_workers=args.plan_workers, num_replicas=ndata,
                         max_rows=args.rows,
                         graft=args.graft, min_graft=args.min_graft)
    svc = None
    if args.aot_warmup:
        svc = AOTWarmupService(cfg, lc, pcfg, params=params, opt_cfg=opt_cfg,
                               opt_state=opt_state, impl=args.impl,
                               sim=CompileCacheSim())
        svc.start(threads=args.warmup_threads)
        say(f"[train] AOT warmup: {len(svc.signature_list())} universe "
            f"signatures warming on {args.warmup_threads} background "
            f"thread(s)")
    engine = TreeTrainEngine(cfg, opt_cfg, impl=args.impl,
                             exec_cache=svc.cache if svc else None,
                             universe=svc.universe if svc else None)
    engine.steps_done = done
    pipe = plans(cfg, lc, args.steps, pcfg, warmup=svc)
    tokens_done = padded_total = dropped_total = executed = 0
    part_trees = part_tokens = 0
    history = []
    t0 = time.time()
    # the planner builds the next plans on background threads meanwhile
    for i, ps in enumerate(pipe):
        plan = ps.execution_plan()
        dropped_total += plan.dropped
        if plan.is_empty:           # nothing trainable this step
            continue
        executed += 1
        if executed <= done:        # resume: replay the plan stream
            continue
        ts = time.time()
        params, opt_state, m = engine.step(params, opt_state, plan)
        dt = time.time() - ts
        tokens_done += plan.unique_tokens
        padded_total += plan.padded_tokens
        part_trees += plan.num_oversized
        if plan.has_waves:
            part_tokens += plan.partition.info["unique_tokens"]
        history.append({"step": i, "loss": m["loss"], "nll": m["nll"],
                        "grad_norm": m["grad_norm"], "sec": dt,
                        "oversized": plan.num_oversized,
                        "dropped": plan.dropped})
        if i % args.log_every == 0:
            say(f"step {i:4d} loss {m['loss']:10.4f} "
                f"nll/tok {m['nll']:7.4f} "
                f"gnorm {m['grad_norm']:8.3f} "
                f"parts {plan.num_oversized:2d} "
                f"{dt * 1e3:7.1f}ms", flush=True)
        if args.ckpt_every and engine.steps_done % args.ckpt_every == 0:
            save_checkpoint(args.save, params, opt_state,
                            meta={"arch": cfg.name,
                                  "steps": engine.steps_done})
            say(f"[train] ckpt @ step {engine.steps_done} → {args.save}",
                flush=True)
    wall = time.time() - t0
    peak = (f", peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
            if dev.type == "cuda" else "")
    say(f"[train] {len(history)} steps, {tokens_done} unique tokens, "
        f"{dropped_total} dropped trees, {wall:.1f}s wall "
        f"({engine.host_syncs} host syncs / {len(history)} steps), "
        f"{padded_total} padded tokens "
        f"({padded_total / max(tokens_done, 1):.2f}/unique){peak}")
    say(f"[train] plan-ahead: {pipe.built} plans, "
        f"{pipe.schedule_s * 1e3:.0f}ms scheduled + "
        f"{pipe.build_s * 1e3:.0f}ms built / "
        f"{pipe.exposed_s * 1e3:.0f}ms exposed "
        f"(lookahead {args.lookahead}, {args.plan_workers} workers)")
    if args.auto_partition:
        say(f"[train] partitioned: {part_trees} oversized trees, "
            f"{part_tokens} tokens, {dropped_total} dropped")
    if svc is not None:
        svc.stop()
        st = svc.stats()
        say(f"[train] aot-warmup: {st['size']} executables "
            f"({st['compile_s']:.1f}s compile, "
            f"{svc.prewarmed} prewarmed), engine retraces "
            f"{engine.retraces}, exposed compile wait "
            f"{engine.compile_wait_s * 1e3:.0f}ms"
            + (f", {st['errors']} warmup errors" if st["errors"] else ""))
    if args.save:
        save_checkpoint(args.save, params, opt_state,
                        meta={"arch": cfg.name, "steps": engine.steps_done})
    if args.save and rank == 0:
        with open(args.save + "/history.json", "w") as f:
            json.dump(history, f)
        say(f"[train] saved → {args.save}")


if __name__ == "__main__":
    main()
