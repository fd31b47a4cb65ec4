"""Build a kernel source with ``nvcc`` and load it with ``ctypes``.

Each ``csrc/*.cu`` file exposes a plain C interface, so it compiles in
seconds without PyTorch's headers.  The shared library lands in
``kernels/_build/`` (listed in ``.gitignore``) under a name that hashes the
source and the flags: an edited source builds anew on its next use, and an
unchanged one is loaded as it is.  Nothing is built at import time, only on
the first launch, and a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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


def library_path(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built;
    returns the library's path.  The compiler's output (with ``ptxas``'s
    register and spill report) is kept beside it as ``.log``."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}) on {source}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or none
    return out


def load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
