"""Rules of the PyTorch port (src/repro_torch): it imports neither jax nor
the JAX package, its entry points default to the CUDA device and raise
without one, and on the CPU no kernel is launched (forward or backward)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.loader import LoaderConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.kernels import tree_attention_bwd as tab  # noqa: E402
from repro_torch.kernels.ref import tree_attention_bwd_ref  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve.rollout import RolloutConfig, rollout_group  # noqa: E402
from repro_torch.serve.session import DecodeSession  # noqa: E402
from repro_torch.train.engine import TreeTrainEngine  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.planner import plans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "tools").glob("*.py")))


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
assert "repro_torch.train.engine" in sys.modules
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


def test_op_gradient_is_the_plain_backward_on_cpu():
    """On CPU tensors the op's gradient is the plain backward
    (``tree_attention_bwd_ref`` on the forward's o and lse), and no kernel
    launches."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.tensor(rng.normal(size=(1, 8, 2, 16)),
                                dtype=torch.float32) for _ in range(4))
    kl = torch.full((1, 8), 7, dtype=torch.int32)
    counts = (ta.tree_attention.launches, tab.bwd_dq.launches,
              tab.bwd_dkv.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(ops.tree_attention(*leaves, kl, 0.25),
                                leaves, do)
    o, lse = ops.tree_attention(q, k, v, kl, 0.25, save_residuals=True)
    for a, b in zip(grads, tree_attention_bwd_ref(q, k, v, kl, o, lse, do,
                                                  0.25)):
        assert torch.equal(a, b)
    assert (ta.tree_attention.launches, tab.bwd_dq.launches,
            tab.bwd_dkv.launches) == counts


def test_train_launcher_default_device_raises_without_cuda():
    """Without --device the launcher runs on cuda, and on a machine without
    one it exits non-zero naming CUDA before any step runs."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1p5_0p5b", "--smoke", "--steps", "1"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA" in res.stderr and "step" not in res.stdout


def test_cpu_train_step_launches_no_kernel():
    cfg = get_config("qwen1p5_0p5b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lc = LoaderConfig(seq_len=512, batch_rows=2, trees_per_batch=6,
                      gen_kwargs=dict(turn_len_range=(8, 48), num_turns=4))
    plan = next(p for p in plans(cfg, lc, 4, device="cpu")
                if not p.is_empty)
    engine = TreeTrainEngine(cfg, OptimizerConfig(), impl="kernel")
    counts = (ta.tree_attention.launches, tab.bwd_dq.launches,
              tab.bwd_dkv.launches)
    _, _, m = engine.step(params, init_opt_state(params), plan)
    assert np.isfinite(m["loss"]) and engine.host_syncs == 1
    assert (ta.tree_attention.launches, tab.bwd_dq.launches,
            tab.bwd_dkv.launches) == counts


def test_training_entry_points_default_to_the_kernel_op(monkeypatch, capsys):
    """Without ``impl`` the engine, and without ``--impl`` the launcher,
    send attention through ``ops.tree_attention`` (the op that launches the
    kernels on a CUDA tensor), not through the dense-mask attention."""
    calls = []
    real = ops.tree_attention
    monkeypatch.setattr(ops, "tree_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = get_config("qwen1p5_0p5b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lc = LoaderConfig(seq_len=512, batch_rows=2, trees_per_batch=6,
                      gen_kwargs=dict(turn_len_range=(8, 48), num_turns=4))
    plan = next(p for p in plans(cfg, lc, 4, device="cpu")
                if not p.is_empty)
    TreeTrainEngine(cfg, OptimizerConfig()).step(
        params, init_opt_state(params), plan)
    assert len(calls) == cfg.n_layers
    calls.clear()
    train_main(["--arch", "qwen1p5_0p5b", "--smoke", "--steps", "2",
                "--seq-len", "1024", "--device", "cpu"])
    out = capsys.readouterr().out
    steps = sum(line.startswith("step ") for line in out.splitlines())
    assert "impl=kernel" in out and steps >= 1
    assert len(calls) == cfg.n_layers * steps
