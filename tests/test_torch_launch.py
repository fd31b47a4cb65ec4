"""The port's training launcher and checkpoints on the CPU, and the kernel
build's cache key.

``python -m repro_torch.launch.train`` runs tree mode, the per-branch
baseline and the RL objective to finite losses; a run resumed from a step-2
checkpoint reproduces the uninterrupted run's losses bit for bit; the
checkpoint format is the reference's (an f32 checkpoint written by either
package loads in the other with equal leaves), and a bf16 leaf round-trips
exactly through its raw 2-byte records."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.optimizer import init_opt_state as jax_opt_state  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train.optimizer import init_opt_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _train(*args, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1p5_0p5b", "--smoke", "--seq-len", "1024", "--device", "cpu",
         "--impl", "kernel", *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.mark.parametrize("extra", [[], ["--mode", "baseline"],
                                   ["--loss-mode", "rl"]],
                         ids=["tree", "baseline", "rl"])
def test_launcher_runs_to_finite_losses(tmp_path, extra):
    out = _train("--steps", "3", "--save", str(tmp_path / "ck"), *extra,
                 cwd=tmp_path)
    hist = json.loads((tmp_path / "ck" / "history.json").read_text())
    assert hist and all(np.isfinite(h["loss"]) for h in hist)
    assert f"({len(hist)} host syncs / {len(hist)} steps)" in out


def test_launcher_auto_partition_trains_long_turn_trees(tmp_path):
    """``--turns``/``--turn-len`` make agentic trees larger than a row of
    512, and ``--auto-partition`` trains them through partition waves with
    none dropped and one host sync a step."""
    out = _train("--steps", "2", "--seq-len", "512", "--auto-partition",
                 "--turns", "3", "--turn-len", "64", "192", cwd=tmp_path)
    part = [ln for ln in out.splitlines() if "partitioned:" in ln]
    assert len(part) == 1 and part[0].endswith(" 0 dropped"), out
    assert int(part[0].split("partitioned:")[1].split()[0]) > 0, out
    assert "(2 host syncs / 2 steps)" in out, out


def test_resume_from_step_2_is_bit_exact(tmp_path):
    """Steps 0-1 are warmup steps, whose lr does not depend on
    --steps, so a 2-step run saves the state a 4-step run has after its
    second step; resuming it with --steps 4 replays the plan stream and
    must give the uninterrupted run's losses exactly."""
    full, part = tmp_path / "full", tmp_path / "part"
    _train("--steps", "4", "--save", str(full), cwd=tmp_path)
    _train("--steps", "2", "--save", str(part), cwd=tmp_path)
    assert tckpt.load_meta(str(part))["steps"] == 2
    _train("--steps", "4", "--resume", str(part), "--save", str(part),
           cwd=tmp_path)
    h_full = json.loads((full / "history.json").read_text())
    h_res = json.loads((part / "history.json").read_text())
    assert len(h_full) == 4 and len(h_res) == 2
    for a, b in zip(h_full[2:], h_res):
        assert (a["step"], a["loss"], a["nll"], a["grad_norm"]) == \
               (b["step"], b["loss"], b["nll"], b["grad_norm"])


def test_f32_checkpoints_load_across_packages(tmp_path):
    jcfg = tiny_cfg("dense")
    jp = jax_init_params(jcfg, jax.random.key(3))
    jo = jax_opt_state(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    to = init_opt_state(tp)
    to["step"] += 5
    # the port writes, the reference reads
    tckpt.save_checkpoint(str(tmp_path / "t"), tp, to, meta={"steps": 5})
    jp2, jo2 = jckpt.load_checkpoint(str(tmp_path / "t"), jp, jo)
    assert jckpt.load_meta(str(tmp_path / "t")) == {"steps": 5}
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(jo2["step"]) == 5
    # the reference writes, the port reads
    jckpt.save_checkpoint(str(tmp_path / "j"), jp, jo, meta={"steps": 1})
    tp3, to3 = tckpt.load_checkpoint(str(tmp_path / "j"), tp, to)
    for a, b in zip(tree_leaves(tp3), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(to3["step"]) == 0
    man = lambda d: json.loads((tmp_path / d / "manifest.json").read_text())
    assert man("t")["keys"] == man("j")["keys"]


def test_bf16_leaf_round_trips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
              "layer_stacks": [{"b": torch.randn(2, 4, generator=g)}]}
    tckpt.save_checkpoint(str(tmp_path), params)
    raw = np.load(tmp_path / "params.npz")["w"]
    assert raw.dtype == np.dtype("V2")          # as np.savez writes JAX's bf16
    back = tckpt.load_checkpoint(str(tmp_path), params)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       params["w"].view(torch.int16))
    assert torch.equal(back["layer_stacks"][0]["b"],
                       params["layer_stacks"][0]["b"])


def test_library_path_changes_with_source_and_flags(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    a = build.library_path("k.cu")
    assert build.library_path("k.cu") == a
    assert build.library_path("k.cu", build.NVCC_FLAGS + ("-lineinfo",)) != a
    (tmp_path / "k.cu").write_text("// two\n")
    b = build.library_path("k.cu")
    (tmp_path / "common.cuh").write_text("// header\n")
    assert len({a, b, build.library_path("k.cu")}) == 3
