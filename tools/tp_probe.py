#!/usr/bin/env python3
"""Qwen3-8B at full depth, or Qwen3-30B-A3B at the deepest cut that fits,
on a model axis of 4: Megatron tensor parallelism with sequence
parallelism (``repro_torch/sharding.py``; for the MoE model expert
parallelism, each card holding 32 of the 128 experts, ``models/moe.py``)
over NCCL, on four NVIDIA GPUs of one host.

    python3 tools/tp_probe.py [--arch qwen3_8b|qwen3_30b_a3b] [--out PATH]

Needs four CUDA cards (it exits non-zero with fewer) and nvcc; run from
the repository root.  Spawns four ranks (a file store, no port), one a
card, on a (data 1, model 4) mesh.  Before anything runs it prints the
reckoned state a card holds (bf16 weights, fp32 grad slots and AdamW
moments of its blocks) and the activations a step keeps.  Then:

  1. train: Qwen3-8B, 36 of 36 layers (Qwen3-30B-A3B: the deepest cut
     whose reckoned state and activations fit FIT_BYTES a card, printed),
     bf16, sequence parallelism on, 2 SFT steps of
     ``chip_smoke.train_plans``' agentic trees (2 rows of 4096) through
     ``TreeTrainEngine.step``: each step's seconds, unique tokens/s, loss
     and kernel launches on each card (each kernel once a layer), one host
     sync a step, the peak device memory of each card (for the MoE model
     also the share of valid (token, slot) pairs capacity dropped); then
     one more step under ``torch.profiler`` on rank 0:
     the device ms of the kernels inside ``sharding.MODEL_AXIS_SPAN``
     (every model-axis collective) and ``engine.REDUCE_SPAN``, beside the
     step's kernel time (``chip_smoke.report_trace``; the trace lands in
     ``build/tp_probe_step_trace.json.gz``).
  2. parity: 4 layers f32 at full width (the MoE model 2), the first
     plan, sequence parallelism off and on: the loss within 1e-6 relative
     and the grads
     gathered over the model axis within 1e-4 max-rel of world 1's (rank
     0, the engine with no process group, from the same seed).

Prints one line a result (with the card's name and power limit) and
writes every figure to ``--out``; exits 1 if a check fails.  Imports no
JAX.
"""
import argparse
import json
import math
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ROWS, SEQ, STEPS = 2, 4096, 2
# {arch: parity layers (f32)}
ARCHS = {"qwen3_8b": 4, "qwen3_30b_a3b": 2}
MESH = (1, 4)
TIMEOUT_S = 1500
# what a card's reckoned state, activations and the loss's logits chunks
# may take when the probe cuts a model's depth to fit
FIT_BYTES = 70e9


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def layer_act_bytes(cfg, m: int) -> int:
    """The activations one layer keeps for the backward on a model axis of
    ``m`` (2 rows of 4096 tokens, bf16): its gathered block inputs, its
    heads' q/k/v/o and the residual stream's S block; a dense layer its
    FFN block's four [tokens, F/m] tensors; an MoE layer its combine's
    gathered [tokens·K, D] rows, its block of the dispatch [E/m, C, D]
    and output, and the experts' three [E/m, C, F] tensors."""
    tok = ROWS * SEQ
    D, a = cfg.d_model, cfg.attn
    n = tok * (2 * D + (2 * a.q_dim + 2 * a.kv_dim) // m + 4 * D // m)
    if cfg.family == "moe":
        from repro_torch.models.moe import capacity
        e, C = cfg.moe.num_experts // m, capacity(tok, cfg.moe)
        n += tok * cfg.moe.top_k * D + e * C * (2 * D + 3 * cfg.moe.d_expert)
    else:
        n += tok * 4 * cfg.d_ff // m
    return 2 * n


def reckon(cfg, m: int) -> dict:
    """GB a card holds on a model axis of ``m``: its blocks' bf16 weights,
    fp32 grad slots and AdamW moments (14 bytes a parameter), the
    activations one step keeps (``layer_act_bytes`` a layer) and the
    loss's fp32 logits chunks."""
    n = cfg.param_count()
    return dict(params_b=round(n / 1e9, 3),
                state_gb=round(n * 14 / m / 1e9, 2),
                activations_gb=round(cfg.n_layers * layer_act_bytes(cfg, m)
                                     / 1e9, 2),
                logits_chunk_gb=round((1 << 28) * 4 * 3 / 1e9, 2))


def fit_cut(cfg, m: int):
    """(cfg cut to the deepest depth whose ``reckon`` fits FIT_BYTES, the
    reckoning of a layer and of the rest): 14 bytes a parameter over
    ``m`` for the head and each layer, ``layer_act_bytes`` a layer."""
    head = cfg.replace(n_layers=0).param_count() * 14 / m
    layer = (cfg.replace(n_layers=1).param_count()
             - cfg.replace(n_layers=0).param_count()) * 14 / m
    act = layer_act_bytes(cfg, m)
    logits = (1 << 28) * 4 * 3
    L = int((FIT_BYTES - head - logits) // (layer + act))
    L = max(1, min(L, cfg.n_layers))
    return cfg.replace(n_layers=L), dict(
        layers=L, of=cfg.n_layers, head_state_gb=round(head / 1e9, 2),
        layer_state_gb=round(layer / 1e9, 3),
        layer_act_gb=round(act / 1e9, 3),
        total_gb=round((head + logits + L * (layer + act)) / 1e9, 2))


def probe_config(arch: str):
    """The probe's config of ``arch`` and the cut's reckoning (None where
    it runs at full depth)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.family != "moe":
        return cfg, None
    return fit_cut(cfg, MESH[1])


def rank_main(rank: int, world: int, store: str, out: str,
              arch: str) -> None:
    import chip_smoke as cs
    from repro_torch import sharding as sh
    from repro_torch.launch.mesh import MeshDescriptor
    from repro_torch.models.model import init_params
    from repro_torch.train import engine as train_engine
    from repro_torch.train.engine import TreeTrainEngine
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    cs.CARD = card()
    dist.init_process_group("nccl", init_method="file://" + store, rank=rank,
                            world_size=world, device_id=dev,
                            timeout=timedelta(seconds=TIMEOUT_S))
    say = cs.log if rank == 0 else (lambda *a, **k: None)
    res: dict = {"rank": rank}
    try:
        cfg, _ = probe_config(arch)
        mesh = MeshDescriptor("tp", MESH, ("data", "model"),
                              ("data",)).build("cuda")
        plans = cs.train_plans(cfg, "agentic", "sep_avg", STEPS + 1)
        with sh.use_mesh(mesh, seq_parallel=True):
            t0 = time.perf_counter()
            params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                                 device=dev)
            opt = init_opt_state(params)
            torch.cuda.synchronize(dev)
            res["init_s"] = round(time.perf_counter() - t0, 3)
            res["state_gb"] = round(torch.cuda.memory_allocated(dev) / 1e9,
                                    3)
            engine = TreeTrainEngine(cfg, OptimizerConfig(
                lr=3e-4, warmup_steps=1, total_steps=STEPS + 1))
            torch.cuda.reset_peak_memory_stats(dev)
            res["steps"] = []
            for plan in plans[:STEPS]:
                torch.cuda.synchronize(dev)
                before = cs.launch_counts()
                t1 = time.perf_counter()
                with cs.RouteRecord() as rec:
                    params, opt, m = engine.step(params, opt, plan)
                torch.cuda.synchronize(dev)
                s = time.perf_counter() - t1
                after = cs.launch_counts()
                res["steps"].append(dict(
                    s=round(s, 3), tokens=plan.unique_tokens,
                    tok_s=round(plan.unique_tokens / s, 1),
                    loss=m["loss"], grad_norm=m["grad_norm"],
                    launches={k: after[k] - before[k] for k in after},
                    want=cs.plan_launches(cfg.n_layers, plan),
                    dropped=dropped(rec, cfg)))
                del rec
                say(f"tp probe step: {s:.3f} s, {plan.unique_tokens} unique "
                    f"tokens, {plan.unique_tokens / s:.1f} tokens/s, loss "
                    f"{m['loss']:.4f}, grad norm {m['grad_norm']:.4f}")
            res["host_syncs"] = engine.host_syncs
            res["peak_gb"] = round(torch.cuda.max_memory_allocated(dev)
                                   / 1e9, 3)
            stats: dict = {}
            step = lambda: engine.step(params, opt, plans[STEPS])
            if rank == 0:
                params, opt, _ = cs.profile_step(
                    step, "tp_probe_step_trace", "model-axis train step",
                    (sh.MODEL_AXIS_SPAN, train_engine.REDUCE_SPAN), stats)
            else:
                params, opt, _ = step()
            res["profile"] = {k: list(v) for k, v in stats.items()}
        del params, opt, engine
        torch.cuda.empty_cache()
        res["parity"] = parity(rank, dev, cfg, plans[0], mesh, say,
                               ARCHS[arch])
    finally:
        Path(out, f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def dropped(rec, cfg) -> list:
    """(valid (token, slot) pairs capacity dropped, valid pairs) over a
    step's MoE calls (the forward's; [0, 0] for a dense model)."""
    if cfg.family != "moe":
        return [0, 0]
    K = cfg.moe.top_k
    valid = sum(int(v.sum()) for v in rec.valid) * K
    return [valid - sum(int(k.sum()) for k in rec.keep), valid]


def parity(rank, dev, cfg, plan, mesh, say, layers: int) -> list:
    """``layers`` layers f32: the model axis's gathered grads and loss
    against world 1's, sequence parallelism off and on."""
    import chip_smoke as cs
    from repro_torch import sharding as sh
    from repro_torch.models.model import init_params
    from repro_torch.train.engine import TreeTrainEngine
    c = cfg.replace(n_layers=layers, dtype="float32")
    ref = None
    if rank == 0:
        with sh.use_mesh(None):
            full = init_params(c, torch.Generator(dev).manual_seed(0),
                               device=dev)
            ref = TreeTrainEngine(c).accumulate(full, plan)
            del full
    rows = []
    for sp in (False, True):
        with sh.use_mesh(mesh, seq_parallel=sp):
            local = init_params(c, torch.Generator(dev).manual_seed(0),
                                device=dev)
            grads, scal = TreeTrainEngine(c).accumulate(local, plan)
            got = sh.gather_params(grads)
        if ref is not None:
            worst, leaf, l2, _ = cs.grads_rel(got, ref[0])
            rel = abs(float(scal[0]) - float(ref[1][0])) / abs(
                float(ref[1][0]))
            rows.append(dict(sp=sp, loss_rel=rel, max_rel=worst, leaf=leaf,
                             rel_l2=l2))
            say(f"tp probe parity ({layers} layers f32, sequence "
                f"parallelism {'on' if sp else 'off'}): loss rel {rel:.2e}, "
                f"grads max-rel {worst:.3e} at {leaf}, relative L2 "
                f"{l2:.3e}")
        del local, grads, got
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_8b", choices=sorted(ARCHS))
    ap.add_argument("--out", default="build/tp_probe.json")
    args = ap.parse_args()
    world = MESH[0] * MESH[1]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"tp_probe: needs {world} CUDA cards", file=sys.stderr)
        return 2
    import chip_smoke as cs
    cs.CARD = card()
    cfg, cut = probe_config(args.arch)
    pred = reckon(cfg, MESH[1])
    cs.log(f"tp probe: {cfg.name} {cfg.n_layers} layers bf16 on a "
           f"{MESH} mesh, sequence parallelism on; reckoned a card: {pred}"
           + (f"; the depth cut to fit {FIT_BYTES / 1e9:g} GB a card: {cut}"
              if cut else ""))
    t0 = time.perf_counter()
    cs.phase_build()
    build_s = time.perf_counter() - t0
    out = tempfile.mkdtemp(prefix="tp_probe_")
    store = os.path.join(tempfile.mkdtemp(prefix="tp_store_"), "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, store, out,
                                                 args.arch))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(TIMEOUT_S - (time.perf_counter() - t0), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    res = [json.loads(Path(out, f"rank{r}.json").read_text())
           if Path(out, f"rank{r}.json").exists() else {}
           for r in range(world)]
    ok = all(p.exitcode == 0 for p in procs) and all(res)
    r0 = res[0]
    if ok:
        prof = r0.get("profile", {})
        span = prof.get("sharding.model_axis", (0, math.nan))
        cs.log(f"tp probe: build {build_s:.1f} s; init "
               f"{[r['init_s'] for r in res]} s; state after init by card "
               f"{[r['state_gb'] for r in res]} GB (reckoned "
               f"{pred['state_gb']}); peak by card "
               f"{[r['peak_gb'] for r in res]} GB; steps s "
               f"{[s['s'] for s in r0['steps']]}, unique tokens/s "
               f"{[s['tok_s'] for s in r0['steps']]}; dropped (token, "
               f"slot) pairs by step {[s['dropped'] for s in r0['steps']]}; "
               f"host syncs "
               f"{[r['host_syncs'] for r in res]}; launches by step (rank "
               f"0) {[s['launches'] for s in r0['steps']]}; model-axis "
               f"collectives in the profiled step: {span[0]} kernels, "
               f"{span[1]:.3f} device ms (rank 0)")
        ok = (all(r["host_syncs"] == STEPS for r in res)
              and all(s["launches"] == s["want"] for r in res
                      for s in r["steps"])
              and all(math.isfinite(s["loss"]) for s in r0["steps"])
              and all(p["loss_rel"] <= 1e-6 and p["max_rel"] <= 1e-4
                      for p in r0["parity"]))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(
        card=cs.CARD, arch=cfg.name, layers=cfg.n_layers, cut=cut,
        mesh=MESH, rows=ROWS, seq=SEQ, predicted=pred, build_s=build_s,
        ranks=res,
        exitcodes=[p.exitcode for p in procs], ok=ok), indent=1))
    print(cs.CARD)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
