"""The port's RL launcher (``launch/rl_loop.py``): frozen rollouts give the
offline RL gradients through the online plan path (≤ 1e-6 max-rel, the
reference's bar), and the port's online gradients on the same trees and
bridged weights match the reference's offline ``make_grad_fn`` (1e-4
max-rel, tests/test_equivalence.py:62); the CLI runs the loop end to end
on the CPU, checkpoints and resumes; the flag of an unported tool is
refused."""
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.data.loader import LoaderConfig as JLoaderConfig  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.core.tree import TrajectoryTree as JTree  # noqa: E402
from repro.core.tree import TreeNode as JNode  # noqa: E402
from repro.train import planner as jplanner  # noqa: E402
from repro.train.train_step import make_grad_fn as jmake_grad_fn  # noqa: E402
from repro_torch.bridge import (config_from_jax, params_from_jax,  # noqa: E402
                                params_to_numpy)
from repro_torch.data.loader import LoaderConfig  # noqa: E402
from repro_torch.launch import rl_loop  # noqa: E402
from repro_torch.launch.rl_loop import check_frozen_grads  # noqa: E402
from repro_torch.serve.rollout import RolloutConfig, rollout_group  # noqa: E402
from repro_torch.train.engine import TreeTrainEngine  # noqa: E402
from repro_torch.train.planner import PlannerConfig, plan_window  # noqa: E402
from test_torch_waves import _one_torch_thread  # noqa: E402,F401

RC = RolloutConfig(k=3, prompt_len=6, max_new=4)
LC_KW = dict(seq_len=64, batch_rows=2, trees_per_batch=2, mode="tree",
             seed=0, loss_mode="rl", auto_partition=True)


def _max_rel(a_leaves, b_leaves) -> float:
    err = 0.0
    for a, b in zip(a_leaves, b_leaves):
        denom = max(float(np.abs(b).max()), 1e-12)
        err = max(err, float(np.abs(a - b).max()) / denom)
    return err


def _to_jax_tree(tree):
    """The port's tree as the reference's: the same nodes, tokens, trained
    masks, advantages and branch advantages."""
    def node(n):
        return JNode(tokens=n.tokens.copy(), trained=n.trained.copy(),
                     advantage=(None if n.advantage is None
                                else n.advantage.copy()),
                     children=[node(c) for c in n.children],
                     branch_adv=n.branch_adv)
    return JTree(node(tree.root))


def test_frozen_rollout_grads_match_offline():
    jcfg = tiny_cfg("dense")
    tcfg = config_from_jax(jcfg)
    jp = jinit_params(jcfg, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    lc = LoaderConfig(**LC_KW)
    pcfg = PlannerConfig(lookahead=1, max_rows=2)
    groups = []
    with torch.inference_mode():
        for g in range(2):
            groups.append(rollout_group(
                tcfg, tp, np.arange(RC.prompt_len, dtype=np.int32) + g, RC,
                torch.Generator().manual_seed(g), device="cpu"))
    trees = [t for t, _ in groups]
    err = check_frozen_grads(tcfg, lc, pcfg, tp, trees, "kernel")
    assert err <= 1e-6, err

    # the port's online grads vs the reference's offline grads, on the same
    # trees
    jtrees = [_to_jax_tree(t) for t in trees]
    (ps,) = [s for s in plan_window(tcfg, lc, pcfg, [trees])
             if not s.is_empty]
    grads, _ = TreeTrainEngine(tcfg).accumulate(tp, ps.execution_plan())
    (jps,) = [s for s in jplanner.plan_window(
        jcfg, JLoaderConfig(**LC_KW), jplanner.PlannerConfig(
            lookahead=1, max_rows=2), [jtrees]) if not s.is_empty]
    jplan = jps.execution_plan()
    batch = dict(jplan.packed.inputs)
    batch["num_trees"] = jplan.num_trees
    _, jgrads, _ = jmake_grad_fn(jcfg, "ref")(jp, batch)
    flat_j = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    flat_t = jax.tree.leaves(params_to_numpy(grads))
    assert len(flat_t) == len(flat_j)
    assert _max_rel(flat_t, flat_j) <= 1e-4


def test_rl_loop_cli_smoke(tmp_path):
    ck = str(tmp_path / "ck")
    base = ["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu"]
    res = rl_loop.main(base + ["--steps", "3", "--check-grads", "--save", ck,
                               "--ckpt-every", "2"])
    assert res["dropped"] == 0
    assert res["max_lag_seen"] <= res["lag_bound"] == 1
    assert [m["step"] for m in res["history"]] == [0, 1, 2]
    assert all(math.isfinite(m["loss"]) for m in res["history"])
    assert res["grad_err"] <= 1e-6
    assert res["host_syncs"] == 3
    assert res["stats"].trees_generated == 6
    meta = json.loads((Path(ck) / "manifest.json").read_text())["meta"]
    assert meta["steps"] == 3
    # a resumed loop starts at the saved step
    res2 = rl_loop.main(base + ["--steps", "2", "--resume", ck])
    assert [m["step"] for m in res2["history"]] == [3, 4]
    assert res2["steps_done"] == 5 and res2["dropped"] == 0
    assert res2["max_lag_seen"] <= 1
    assert res2["stats"].min_version >= 3


def test_rl_loop_refuses_compile_cache_dir(tmp_path, capsys):
    """``--compile-cache-dir`` is accepted (``tests/test_torch_warmup.py``
    runs it) unless it names something other than a directory."""
    path = tmp_path / "a_file"
    path.write_text("")
    with pytest.raises(SystemExit):
        rl_loop.main(["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu",
                      "--compile-cache-dir", str(path)])
    assert "not a directory" in capsys.readouterr().err
