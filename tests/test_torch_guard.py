"""Rules of the PyTorch port (src/repro_torch): it imports neither jax nor
the JAX package, its entry points default to the CUDA device and raise
without one, and on the CPU no kernel is launched."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve.rollout import RolloutConfig, rollout_group  # noqa: E402
from repro_torch.serve.session import DecodeSession  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference_package():
    """Importing every module of the port, and chip_smoke.py without
    running it, leaves jax and repro.* out of sys.modules."""
    code = f"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert "repro_torch.serve.rollout" in sys.modules
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_source_has_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    cfg = get_config("qwen2_1p5b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeSession.create(cfg, params, buf_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        rollout_group(cfg, params, np.arange(4), RolloutConfig(
            k=2, prompt_len=4, max_new=2, temperature=0.0))


def test_cpu_path_launches_no_kernel_and_wrapper_never_falls_back():
    cfg = get_config("qwen2_1p5b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    ta.tree_attention.launches = 0
    with torch.inference_mode():
        tree, st = rollout_group(cfg, params, np.arange(12), RolloutConfig(
            k=2, prompt_len=12, max_new=3, temperature=0.0), device="cpu")
        sess = DecodeSession.create(cfg, params, buf_len=16, device="cpu")
        sess.prefill(np.arange(6), impl="kernel")
        sess.fork(2).prefill(np.arange(3), impl="kernel")
    assert st.prefill_tokens == 12 and tree.num_leaves() >= 1
    assert ta.tree_attention.launches == 0
    # the CUDA wrapper itself refuses CPU tensors rather than computing
    q = torch.zeros(1, 4, 2, 16)
    kl = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ta.tree_attention(q, q, q, kl, 0.25)
    assert ta.tree_attention.launches == 0


def test_op_refuses_gradients():
    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    kl = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="training slice"):
        ops.tree_attention(q, q, q, kl, 0.25)
