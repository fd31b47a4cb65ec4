#!/usr/bin/env python3
"""One phase of ``chip_smoke.py`` from one checkout, on one NVIDIA GPU, for
comparing two commits on the same card.

    python3 tools/ab.py ROOT TAG PHASE [STEPS]

Imports ``chip_smoke.py`` from the checkout at ROOT (this repository, or
an older commit unpacked with ``git archive`` into a git-ignored directory
such as ``build/``), builds that checkout's kernels and runs PHASE:

  - ``serve``: ``phase_serve`` on Qwen2-1.5B (4 rollout groups, the
    multi-turn session, a profiled decode step), ``phase_arch_serve`` for
    Qwen3-8B and for Qwen3-30B-A3B (one group each, the decode bound and
    parity (b)), and, where the checkout has ``phase_ssm_train``, that
    phase for Zamba2-1.2B and the GDN stack (5 steps each: step times);
  - ``nemotron``: ``phase_timing_train`` at H 96/Kh 8, hd 192 (bf16) on
    the serving prefill (B 1, S 1024), the session's tool prefill (B 8,
    S 200 after 1056 cached keys) and the train rows of the Qwen3-32B
    train step's first plan (B 2, S 4096, their real kv_last), then
    ``phase_arch_serve`` for Nemotron-4 340B;
  - ``phi3_train``: ``phase_train`` on Phi-3-vision 4.2B at the cut
    ``run_mm`` trains (``vlm_train_cut``), on ``mm_train_plans``' trees:
    STEPS (default 6) sep_avg steps and 2 rl steps, the same plans from
    the same seeds on both sides, so the median step after the first
    compares like with like; then its profiled step.  A checkout whose
    ``chip_smoke.py`` has no ``vlm_train_cut`` gets the same cut and plans
    as its ``run_mm`` made them inline;
  - ``rl_gen``: ``repro_torch.launch.rl_loop.main`` on Qwen2-1.5B at one
    fixed shape (prompt 1024, K 8, 2 groups x 16 new tokens, 2 rows of
    4096, STEPS steps at --max-ahead 1): the generation seconds a group,
    the warm-up seconds and each step's wall.

Every printed line carries TAG.  Run each side in its own process,
alternating in one chip call (parent, change, change, parent), since the
two checkouts' modules share names.
"""
import os
import subprocess
import sys
import time


def serve(cs, tag: str, steps: int) -> None:
    import torch

    cfg = cs.get_config("qwen2_1p5b")
    params = cs.init_params(cfg, torch.Generator(cs.DEV).manual_seed(0))
    cs.phase_serve(cfg, params, f"[{tag}] qwen2_1p5b serve")
    del params
    torch.cuda.empty_cache()
    for arch in ("qwen3_8b", "qwen3_30b_a3b"):
        cs.phase_arch_serve(arch, f"[{tag}] {arch} serve")
    if hasattr(cs, "phase_ssm_train"):
        for arch in ("zamba2_1p2b", "qwen3p5_gdn_2b"):
            c = cs.get_config(arch)
            sft = cs.train_plans(c, "agentic", "sep_avg", cs.SSM_SFT_STEPS)
            rl = cs.train_plans(c, "grpo", "rl", cs.RL_STEPS)
            cs.phase_ssm_train(c, sft, rl, f"[{tag}] {arch} train")
            torch.cuda.empty_cache()


def nemotron(cs, tag: str, steps: int) -> None:
    import numpy as np
    import torch

    tcfg = cs.get_config(cs.TRAIN_ARCH)
    tcfg = tcfg.replace(n_layers=cs.fit_depth(tcfg, cs.TRAIN_LIMIT, scale=7,
                                               per_layer=cs.TRAIN_ACT_BYTES))
    kl_a = np.asarray(cs.train_plans(tcfg, "agentic", "sep_avg", 1)[0]
                      .packed.inputs["kv_last"])
    tool = np.concatenate([np.full((8, 1056), cs.BIG),
                           np.full((8, 200), 1255)], 1)
    for kl, q_off, shape in ((np.full((1, 1024), 1023), 0, "P"),
                             (tool, 1056, "tool prefill"), (kl_a, 0, "R")):
        cs.phase_timing_train(kl, None, 0, (96, 8),
                              f"[{tag}] H 96/Kh 8 hd 192 {shape}", q_off, 192)
    torch.cuda.empty_cache()
    cs.phase_arch_serve("nemotron_4_340b", f"[{tag}] nemotron_4_340b serve")


def phi3_train(cs, tag: str, steps: int) -> None:
    if hasattr(cs, "vlm_train_cut"):
        cfg = cs.vlm_train_cut()[0]
        sft, rl = cs.mm_train_plans(cfg, steps, 2)
    else:
        full = cs.get_config(cs.VLM_ARCH)
        cfg = full.replace(n_layers=cs.fit_depth(
            full, cs.TRAIN_LIMIT, scale=7, per_layer=cs.act_bytes(
                full, cs.TRAIN_ROWS * (cs.TRAIN_SEQ + full.frontend_len))))
        kw = dict(gen=cs.MM_TRAIN_GEN, trees=cs.MM_TRAIN_TREES)
        sft = cs.train_plans(cfg, "agentic", "sep_avg", steps, **kw)
        rl = cs.train_plans(cfg, "grpo", "rl", 2, **kw)
    cs.phase_train(cfg, sft, rl, f"[{tag}] {cs.VLM_ARCH} train", False)


def rl_gen(cs, tag: str, steps: int) -> None:
    res = cs.rl_loop.main(["--arch", "qwen2_1p5b", "--steps", str(steps),
                           "--groups", "2", "--k", "8", "--prompt-len",
                           "1024", "--max-new", "16", "--seq-len", "4096",
                           "--rows", "2", "--max-ahead", "1"])
    st = res["stats"]
    print(f"[{tag}] rl_gen: generation {st.gen_busy_s:.4f} s over "
          f"{st.trees_generated} groups, "
          f"{st.gen_busy_s / st.trees_generated:.4f} s a group; warm-up "
          f"{res['warmup_s']:.3f} s; step walls ms "
          f"{[round(m['wall_ms'], 1) for m in res['history']]}; decode "
          f"graphs captured in the loop "
          f"{res.get('captures_in_loop', 'not counted')}  [{cs.CARD}]",
          flush=True)


PHASES = {f.__name__: f for f in (serve, nemotron, phi3_train, rl_gen)}


def main(root: str, tag: str, phase: str, steps: int) -> None:
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.chdir(root)
    import torch
    import chip_smoke as cs

    cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    cs.phase_build()
    PHASES[phase](cs, tag, steps)
    print(f"[{tag}] done in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    if len(sys.argv) not in (4, 5) or sys.argv[3] not in PHASES:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2], sys.argv[3],
         int(sys.argv[4]) if len(sys.argv) == 5 else 6)
