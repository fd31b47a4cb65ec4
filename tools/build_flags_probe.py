#!/usr/bin/env python3
"""Time the kernels' nvcc build under several flag sets, one after another.

    python3 tools/build_flags_probe.py       # on a machine with nvcc

For each flag set, the three sources in ``src/repro_torch/kernels/csrc/``
build together (one nvcc each, ``build.build_all``) into a directory of
their own under ``build/flags_probe/``; the probe prints nvcc's version,
the host's cores, the seconds each source and the whole build took, and
the count of ptxas's per-kernel reports in each log.  The sets: the
repo's flags (``build.NVCC_FLAGS``), those without ``--split-compile``,
and those with ptxas's ``--split-compile`` too.  Imports no jax.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

SOURCES = ("tree_attention_fwd.cu", "tree_attention_bwd_dq.cu",
           "tree_attention_bwd_dkv.cu")


def main() -> int:
    version = subprocess.run([build.nvcc_path(), "--version"],
                             capture_output=True, text=True).stdout
    print(version.strip().splitlines()[-1], "| cores", os.cpu_count())
    repo = build.NVCC_FLAGS
    plain = tuple(f for f in repo if not f.startswith("--split-compile"))
    variants = {"repo": repo, "no split": plain,
                "split with ptxas": repo + ("-Xptxas", "--split-compile=0")}
    for name, flags in variants.items():
        build.NVCC_FLAGS = flags
        build.set_build_dir(ROOT / "build" / "flags_probe" /
                            name.replace(" ", "_"))
        t0 = time.perf_counter()
        done = build.build_all(SOURCES)
        each = {s: round(dt, 2) for s, (_, dt) in done.items()}
        reports = {s: lib.with_suffix(".log").read_text().count("Used")
                   for s, (lib, _) in done.items()}
        print(f"{name} ({' '.join(flags)}): {time.perf_counter() - t0:.2f} "
              f"s in all; by source {each}; ptxas reports {reports}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
