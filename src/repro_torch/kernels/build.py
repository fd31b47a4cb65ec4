"""Build kernel sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file exposes a plain C interface, so it compiles without
PyTorch's headers.  The shared library lands in ``kernels/_build/`` (listed
in ``.gitignore``) under a name that hashes the source, the headers beside
it and the flags: an edited source builds anew on its next use, and an
unchanged one is loaded as it is.  Nothing is built at import time, only on
the first launch (or by ``build_all``), and a failed build raises with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(source: str, flags=NVCC_FLAGS) -> Path:
    """Where ``csrc/<source>``'s library goes: the name hashes the source,
    every ``csrc/*.cuh`` header and the flags."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(sources) -> dict[str, tuple[Path, float]]:
    """Build several sources at once: one ``nvcc`` process for each source
    not built yet, all started together, then waited for.  The compiler's
    output (with ``ptxas``'s register and spill report) is kept beside each
    library as ``.log``.  Returns {source: (library path, seconds to
    build)}; after every process has ended, raises with the compiler's
    output of the first source (in the given order) that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = {src: (library_path(src), 0.0) for src in sources}
    running = {}
    t0 = time.perf_counter()
    for src, (out, _) in done.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        log = out.with_suffix(".log").open("w")
        running[src] = (tmp, cmd, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT))
    failed = {}
    while running:
        for src in list(running):
            tmp, cmd, log, proc = running[src]
            if proc.poll() is None:
                continue
            log.close()
            del running[src]
            out = done[src][0]
            done[src] = (out, time.perf_counter() - t0)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed[src] = f"nvcc failed ({proc.returncode}) on {src}:\n" \
                              f"{' '.join(cmd)}\n"
            else:
                os.replace(tmp, out)    # atomic: a loader sees all or none
        time.sleep(0.1)
    for src in sources:
        if src in failed:
            raise RuntimeError(
                failed[src] + done[src][0].with_suffix(".log").read_text())
    return done


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built;
    returns the library's path."""
    return build_all([source])[source][0]


def load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
