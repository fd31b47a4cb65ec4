#!/usr/bin/env python3
"""Nemotron-4 340B's attention kernels and serve phase from one checkout,
on one NVIDIA GPU, for comparing two commits on the same card.

    python3 tools/nemotron_ab.py ROOT TAG

Imports ``chip_smoke.py`` from the checkout at ROOT (this repository, or
an older commit unpacked with ``git archive`` into a git-ignored directory
such as ``build/``), builds that checkout's kernels, and runs its
``phase_timing_train`` at H 96/Kh 8, hd 192 (bf16) on the serving prefill
(B 1, S 1024), the session's tool prefill (B 8, S 200 after 1056 cached
keys) and the train rows of the Qwen3-32B train step's first plan (B 2,
S 4096, their real kv_last), then its ``phase_arch_serve`` for
``nemotron_4_340b`` (one rollout group, the multi-turn session's prefill
and decode tokens/s, parity (b)).  Every printed line carries TAG.  Run
each side in its own process, alternating in one chip call (parent,
change, change, parent), since the two checkouts' modules share names.
"""
import os
import subprocess
import sys
import time


def main(root: str, tag: str) -> None:
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.chdir(root)
    import numpy as np
    import torch
    import chip_smoke as cs

    cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    cs.phase_build()
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
    print(f"[{tag}] done in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
