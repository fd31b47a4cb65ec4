#!/usr/bin/env python3
"""The serving phases (and, where the checkout has them, two SSM train
runs) from one checkout, on one NVIDIA GPU, for comparing two commits on
the same card.

    python3 tools/serve_ab.py ROOT TAG

Imports ``chip_smoke.py`` from the checkout at ROOT (this repository, or
an older commit unpacked with ``git archive`` into a git-ignored directory
such as ``build/``), builds that checkout's kernels and runs its
``phase_serve`` on Qwen2-1.5B (4 rollout groups, the multi-turn session,
a profiled decode step), its ``phase_arch_serve`` for Qwen3-8B and for
Qwen3-30B-A3B (one group each, the decode bound and parity (b)), and,
where the checkout has ``phase_ssm_train``, that phase for Zamba2-1.2B
and the GDN stack (5 steps each: step times).  Every printed line carries
TAG.  Run each side in its own process, alternating in one chip call
(parent, change, change, parent), since the two checkouts' modules share
names.
"""
import os
import subprocess
import sys
import time


def main(root: str, tag: str) -> None:
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
    print(f"[{tag}] done in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
