"""Training launcher — one loop over the engine.

Port of ``repro/launch/train.py::main``.  Trains tree-mode (or the sep-avg
per-branch baseline) on synthetic agentic trees:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1p5_0p5b \\
      --smoke --steps 3 --device cpu

Every step is an ``ExecutionPlan`` from ``train/planner.plans`` executed by
``train/engine.TreeTrainEngine.step``; each step performs exactly one host
sync (the logging transfer).  ``--impl kernel`` (the default) runs the
hand-written CUDA kernels on the card (their plain versions on the CPU),
``--impl ref`` the materialized-mask attention.  ``--loss-mode rl`` trains
the RL model-update objective on GRPO trees.  It runs on ``cuda`` unless
``--device`` names another device.

Not ported (ROADMAP.md Queue A): ``--lookahead``, ``--plan-workers``,
``--auto-partition``, ``--capacity``, ``--graft``, ``--min-graft`` (the
planner and partition waves, items 3-4), ``--aot-warmup``,
``--warmup-threads``, ``--compile-cache-dir`` and ``--mesh`` (item 8).
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
from repro_torch.train.planner import plans


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
                    choices=["agentic", "grpo", "random"],
                    help="synthetic tree generator (default: agentic; "
                         "grpo when --loss-mode rl)")
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

    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(2, args.steps // 10))
    # generator kwargs differ per kind (agentic/grpo take turn shapes,
    # random takes segment shapes) — the reference launcher's
    gen_kwargs = (dict(seg_len_range=(8, 48), max_depth=4)
                  if args.kind == "random"
                  else dict(turn_len_range=(8, 48), num_turns=4))
    lc = LoaderConfig(seq_len=args.seq_len, batch_rows=args.rows,
                      trees_per_batch=args.trees, mode=args.mode,
                      kind=args.kind, seed=args.seed,
                      loss_mode=args.loss_mode, gen_kwargs=gen_kwargs)

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
    tokens_done = padded_total = dropped_total = executed = 0
    history = []
    t0 = time.time()
    for i, plan in enumerate(plans(cfg, lc, args.steps, device=dev)):
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
        history.append({"step": i, "loss": m["loss"], "nll": m["nll"],
                        "grad_norm": m["grad_norm"], "sec": dt,
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
    print(f"[train] {len(history)} steps, {tokens_done} unique tokens, "
          f"{dropped_total} dropped trees, {wall:.1f}s wall "
          f"({engine.host_syncs} host syncs / {len(history)} steps), "
          f"{padded_total} padded tokens "
          f"({padded_total / max(tokens_done, 1):.2f}/unique)")
    if args.save:
        save_checkpoint(args.save, params, opt_state,
                        meta={"arch": cfg.name, "steps": engine.steps_done})
        with open(args.save + "/history.json", "w") as f:
            json.dump(history, f)
        print(f"[train] saved → {args.save}")


if __name__ == "__main__":
    main()
