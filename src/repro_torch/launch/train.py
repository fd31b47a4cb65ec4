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
``--impl ref`` the materialized-mask attention.  ``--loss-mode rl`` trains
the RL model-update objective on GRPO trees.  It runs on ``cuda`` unless
``--device`` names another device.

``--auto-partition`` routes trees larger than one row through
Redundancy-Free Tree Partitioning (partition waves, ``--capacity`` token
cap per partition, ``auto`` by default) instead of dropping them; the run
ends with a ``partitioned: ... dropped`` line:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1p5_0p5b \
      --smoke --auto-partition --capacity 256 --seq-len 512 --device cpu

``--graft`` merges trees of the window that open with the same token
prefix into one grafted forest (``core/forest``; pair with ``--kind
template``).

Not ported (ROADMAP.md Queue A item 7): ``--aot-warmup``,
``--warmup-threads``, ``--compile-cache-dir`` and ``--mesh``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.loader import LoaderConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.train.checkpoint import (load_checkpoint, load_meta,
                                          save_checkpoint)
from repro_torch.train.engine import TreeTrainEngine
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.planner import PlannerConfig, plans


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mode", default="tree", choices=["tree", "baseline"])
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--rows", type=int, default=2,
                    help="rows per step (the reference's auto choice on "
                         "one device is 2)")
    ap.add_argument("--trees", type=int, default=6)
    ap.add_argument("--lookahead", type=int, default=1,
                    help="generator batches the planner bin-packs "
                         "jointly (global Tree Packing; 1 = per-step)")
    ap.add_argument("--plan-workers", type=int, default=1,
                    help="background plan-builder threads (double-"
                         "buffered against engine.step; 0 = synchronous)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--impl", default="kernel", choices=["ref", "kernel"],
                    help="kernel (default): the hand-written CUDA kernels, "
                         "their plain versions on a CPU device; ref: the "
                         "dense-mask attention, kept as the comparator")
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
    ap.add_argument("--turns", type=int, default=4,
                    help="turns per agentic/grpo tree")
    ap.add_argument("--turn-len", type=int, nargs=2, default=(8, 48),
                    metavar=("MIN", "MAX"),
                    help="token length range of an agentic/grpo turn "
                         "(longer turns make trees larger than a row, "
                         "which --auto-partition trains)")
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
    if args.ckpt_every is not None and not args.save:
        ap.error("--ckpt-every needs --save (the checkpoint directory)")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.kind is None:
        args.kind = "grpo" if args.loss_mode == "rl" else "agentic"
    print(f"[train] arch={cfg.name} family={cfg.family} mode={args.mode} "
          f"impl={args.impl} loss_mode={args.loss_mode} kind={args.kind} "
          f"device={dev}")

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

    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                         device=dev)
    opt_state = init_opt_state(params)
    done = 0
    if args.resume:
        params, opt_state = load_checkpoint(args.resume, params, opt_state)
        done = int(load_meta(args.resume).get("steps", 0))
        print(f"[train] resumed {args.resume} @ step {done}")

    engine = TreeTrainEngine(cfg, opt_cfg, impl=args.impl)
    engine.steps_done = done
    pcfg = PlannerConfig(lookahead=args.lookahead,
                         plan_workers=args.plan_workers, max_rows=args.rows,
                         graft=args.graft, min_graft=args.min_graft)
    pipe = plans(cfg, lc, args.steps, pcfg)
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
            print(f"step {i:4d} loss {m['loss']:10.4f} "
                  f"nll/tok {m['nll']:7.4f} "
                  f"gnorm {m['grad_norm']:8.3f} "
                  f"parts {plan.num_oversized:2d} "
                  f"{dt * 1e3:7.1f}ms", flush=True)
        if args.ckpt_every and engine.steps_done % args.ckpt_every == 0:
            save_checkpoint(args.save, params, opt_state,
                            meta={"arch": cfg.name,
                                  "steps": engine.steps_done})
            print(f"[train] ckpt @ step {engine.steps_done} → {args.save}",
                  flush=True)
    wall = time.time() - t0
    peak = (f", peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
            if dev.type == "cuda" else "")
    print(f"[train] {len(history)} steps, {tokens_done} unique tokens, "
          f"{dropped_total} dropped trees, {wall:.1f}s wall "
          f"({engine.host_syncs} host syncs / {len(history)} steps), "
          f"{padded_total} padded tokens "
          f"({padded_total / max(tokens_done, 1):.2f}/unique){peak}")
    print(f"[train] plan-ahead: {pipe.built} plans, "
          f"{pipe.schedule_s * 1e3:.0f}ms scheduled + "
          f"{pipe.build_s * 1e3:.0f}ms built / "
          f"{pipe.exposed_s * 1e3:.0f}ms exposed "
          f"(lookahead {args.lookahead}, {args.plan_workers} workers)")
    if args.auto_partition:
        print(f"[train] partitioned: {part_trees} oversized trees, "
              f"{part_tokens} tokens, {dropped_total} dropped")
    if args.save:
        save_checkpoint(args.save, params, opt_state,
                        meta={"arch": cfg.name, "steps": engine.steps_done})
        with open(args.save + "/history.json", "w") as f:
            json.dump(history, f)
        print(f"[train] saved → {args.save}")


if __name__ == "__main__":
    main()
