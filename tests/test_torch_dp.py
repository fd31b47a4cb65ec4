"""Data-parallel engine steps on ``torch.distributed`` (gloo, CPU): a world
of 2 against a world of 1 (the same plans through the engine with no
process group), on (a) a dense packed plan, (b) a dense partition-wave
plan whose children's parents sit on the other rank, (c) an MoE packed
plan whose capacity drops (token, slot) pairs, with the aux losses on,
and (d) a hybrid (Mamba2 + shared attention) packed plan.

Bars: loss and metrics within 1e-6 relative of world 1; the summed grads
within 1e-4 max-rel (tests/test_equivalence.py:62's model-grad bar); in
(c) the same kept (token, slot) pairs as world 1; params ``torch.equal``
across ranks after 2 steps; a second world-2 run bit-identical to the
first; one host sync a step on every rank.  (a)'s world-2 grads are also
held against the JAX reference's whole-batch ``value_and_grad`` at 1e-4.
Ranks initialised from one seed, or loaded from one ``.npz`` checkpoint,
hold equal params.

One world of two processes (``init_method="file://..."``, no port) runs
every case, world 1 first on rank 0, and writes its results; the tests
read them.  A second world runs the launcher under ``torchrun``."""
import dataclasses
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.core.gateway import build_partition_plan  # noqa: E402
from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import random_tree, trees_for_batch  # noqa: E402
from repro_torch.launch import rl_loop  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models.model import batch_arrays, init_params  # noqa: E402
from repro_torch.models.model import row_block  # noqa: E402
from repro_torch.train.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.train.engine import ExecutionPlan, PackedExec  # noqa: E402
from repro_torch.train.optimizer import init_opt_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CASES = ("dense_packed", "dense_waves", "moe_drops", "hybrid_packed")
STEPS = 2


def _packed(cfg, trees, S, chunk_size=None):
    """A packed plan of one tree a row, so that each rank of 2 holds real
    rows (first-fit would put small trees together and leave rows
    empty)."""
    rows = [batch_arrays(cfg, pack_trees(
        [serialize_tree(t, chunk_size=chunk_size)], S, batch_size=1,
        chunk_size=chunk_size)) for t in trees]
    inputs = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]
              if k != "num_trees"}
    inputs["num_trees"] = len(trees)
    return ExecutionPlan(packed=PackedExec(
        inputs=inputs, tokens=int(inputs["valid"].sum()),
        cells=inputs["tokens"].size), num_trees=len(trees))


def _wave_trees():
    """Branching random trees of 30–120 tokens (larger than a row of 48)."""
    out = []
    for s in range(300):
        t = random_tree(np.random.default_rng(s), vocab_size=89, max_depth=5,
                        seg_len_range=(3, 9))
        if t.num_leaves() >= 4 and 60 <= t.num_unique_tokens() <= 120:
            out.append(t)
        if len(out) == 3:
            return out
    raise RuntimeError("no wave trees")


def _crossing_parents(plan) -> int:
    """Gateway slots whose parent row is on another rank of 2."""
    n = 0
    for wp in plan.partition.waves:
        B = wp.batch["tokens"].shape[0]
        for si, ref in enumerate(wp.parents):
            pB = plan.partition.waves[ref.wave].batch["tokens"].shape[0]
            child = wp.slot_rows[si] // (B // 2)
            n += child != ref.row // (pB // 2)
    return n


def _cases():
    """{name: dict(cfg, params, plan)}: the port's configs and plans (host
    arrays), and (a)'s JAX side for the reference comparison."""
    out, jax_side = {}, None
    jcfg = tiny_cfg("dense")
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    cfg = config_from_jax(jcfg)
    kw = dict(n_trees=4, kind="random", vocab_size=jcfg.vocab_size)
    plan = _packed(cfg, trees_for_batch(2, **kw), 256)
    out["dense_packed"] = dict(
        cfg=cfg, plan=plan,
        params=params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    jb = {k: (v if k == "num_trees" else jax.numpy.asarray(v))
          for k, v in plan.packed.inputs.items()}
    jax_side = (jcfg, jp, jb)

    part = build_partition_plan(cfg, _wave_trees(), 40, seq_len=48,
                                max_rows=2, row_multiple=2)
    out["dense_waves"] = dict(
        cfg=cfg, params=init_params(cfg, torch.Generator().manual_seed(1),
                                    device="cpu"),
        plan=ExecutionPlan(partition=part, num_trees=part.num_trees))

    mcfg = config_from_jax(tiny_cfg("moe"))
    mcfg = mcfg.replace(moe=dataclasses.replace(mcfg.moe,
                                                capacity_factor=0.25))
    out["moe_drops"] = dict(
        cfg=mcfg, plan=_packed(mcfg, trees_for_batch(
            3, n_trees=4, kind="random", vocab_size=mcfg.vocab_size), 128),
        params=init_params(mcfg, torch.Generator().manual_seed(2),
                           device="cpu"))

    hcfg = config_from_jax(tiny_cfg("hybrid"))
    out["hybrid_packed"] = dict(
        cfg=hcfg, plan=_packed(hcfg, trees_for_batch(
            4, n_trees=4, kind="random", vocab_size=hcfg.vocab_size), 256,
            chunk_size=hcfg.ssm.chunk_size),
        params=init_params(hcfg, torch.Generator().manual_seed(3),
                           device="cpu"))
    return out, jax_side


_WORKER = """
import pickle, sys
from datetime import timedelta
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, d, steps = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + d + "/store",
                        rank=rank, world_size=2,
                        timeout=timedelta(seconds=120))
from repro_torch import sharding as sh
from repro_torch.device import map_tree, tree_leaves
from repro_torch.launch.mesh import host_descriptor
from repro_torch.models import moe
from repro_torch.models.model import init_params
from repro_torch.train.checkpoint import load_checkpoint
from repro_torch.train.engine import TreeTrainEngine
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

kept, queue = [], moe.queue
def recording(*args):
    out = queue(*args)
    kept.append(out[2].clone())
    return out
moe.queue = recording

def run(c):
    params = map_tree(lambda t: t.clone(), c["params"])
    engine = TreeTrainEngine(c["cfg"], OptimizerConfig(
        lr=1e-3, warmup_steps=1, total_steps=4))
    kept.clear()
    grads, scal = engine.accumulate(params, c["plan"])
    res = dict(grads=tree_leaves(grads), scal=scal, kept=list(kept),
               metrics=[])
    opt = init_opt_state(params)
    for _ in range(steps):
        params, opt, m = engine.step(params, opt, c["plan"])
        res["metrics"].append(m)
    res.update(params=tree_leaves(params), host_syncs=engine.host_syncs)
    return res

with open(d + "/cases.pkl", "rb") as f:
    cases, ckpt = pickle.load(f)
out = {}
if rank == 0:      # world 1: the same engine with no process group's mesh
    out["w1"] = {n: run(c) for n, c in cases.items()}
with sh.use_mesh(host_descriptor().build("cpu")):
    out["w2"] = {n: [run(c), run(c)] for n, c in cases.items()}
cfg = cases["dense_packed"]["cfg"]
fresh = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
out["init"] = tree_leaves(fresh)
out["ckpt"] = tree_leaves(load_checkpoint(ckpt, fresh))
dist.barrier()
dist.destroy_process_group()
torch.save(out, d + "/rank%d.pt" % rank)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run every case in one gloo world of 2 (world 1 on rank 0 first)
    and return (cases, JAX side, [rank 0 results, rank 1 results])."""
    d = tmp_path_factory.mktemp("dp")
    cases, jax_side = _cases()
    ckpt = str(d / "ckpt")
    p = cases["dense_packed"]["params"]
    save_checkpoint(ckpt, p, init_opt_state(p))
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump((cases, ckpt), f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(d),
                               str(STEPS)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [pr.communicate(timeout=300) for pr in procs]
    for pr, (_, err) in zip(procs, outs):
        assert pr.returncode == 0, err[-4000:]
    return cases, jax_side, [torch.load(d / f"rank{r}.pt", weights_only=False)
                             for r in range(2)]


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _max_rel(got, want):
    return max(float((a - b).abs().max() / (b.abs().max() + 1e-9))
               for a, b in zip(got, want))


def test_wave_case_has_parents_on_the_other_rank(world):
    cases, _, _ = world
    plan = cases["dense_waves"]["plan"]
    assert len(plan.partition.waves) >= 3
    assert _crossing_parents(plan) > 0


@pytest.mark.parametrize("name", ["dense_packed", "moe_drops",
                                  "hybrid_packed"])
def test_every_rank_holds_real_rows(name, world):
    cases, _, _ = world
    valid = cases[name]["plan"].packed.inputs["valid"]
    for r in range(2):
        lo, hi = row_block(valid.shape[0], r, 2)
        assert valid[lo:hi].sum() > 0


@pytest.mark.parametrize("name", CASES)
def test_loss_and_metrics_equal_world_1(name, world):
    _, _, (r0, r1) = world
    w1, a, b = r0["w1"][name], r0["w2"][name][0], r1["w2"][name][0]
    assert torch.equal(a["scal"], b["scal"])
    for i in range(3):
        assert _rel(a["scal"][i], w1["scal"][i]) <= 1e-6, i
    for m1, m2, m3 in zip(w1["metrics"], a["metrics"], b["metrics"]):
        assert m2 == m3
        for k in ("loss", "nll_sum", "weight_sum", "grad_norm", "lr", "nll"):
            assert _rel(m2[k], m1[k]) <= 1e-6, k


@pytest.mark.parametrize("name", CASES)
def test_reduced_grads_within_model_grad_bar_of_world_1(name, world):
    _, _, (r0, r1) = world
    a, b = r0["w2"][name][0]["grads"], r1["w2"][name][0]["grads"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _max_rel(a, r0["w1"][name]["grads"]) < 1e-4


@pytest.mark.parametrize("name", CASES)
def test_params_equal_across_ranks_after_the_steps(name, world):
    _, _, (r0, r1) = world
    for x, y in zip(r0["w2"][name][0]["params"], r1["w2"][name][0]["params"]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", CASES)
def test_second_world_2_run_is_bit_identical(name, world):
    _, _, ranks = world
    for r in ranks:
        first, second = r["w2"][name]
        for key in ("grads", "params"):
            assert all(torch.equal(x, y)
                       for x, y in zip(first[key], second[key])), key
        assert torch.equal(first["scal"], second["scal"])


@pytest.mark.parametrize("name", CASES)
def test_one_host_sync_a_step_on_every_rank(name, world):
    _, _, ranks = world
    assert ranks[0]["w1"][name]["host_syncs"] == STEPS
    for r in ranks:
        assert all(run["host_syncs"] == STEPS for run in r["w2"][name])


def test_moe_ranks_keep_the_slots_world_1_keeps(world):
    """Capacity drops slots; the ranks' kept (token, slot) pairs, rank 0's
    rows then rank 1's, are world 1's, layer by layer."""
    cases, _, (r0, r1) = world
    w1 = r0["w1"]["moe_drops"]["kept"]
    a, b = r0["w2"]["moe_drops"][0]["kept"], r1["w2"]["moe_drops"][0]["kept"]
    assert len(w1) == len(a) == len(b) >= 1
    valid = cases["moe_drops"]["plan"].packed.inputs["valid"]
    K = cases["moe_drops"]["cfg"].moe.top_k
    for k1, ka, kb in zip(w1, a, b):
        assert int(k1.sum()) < int(valid.sum()) * K      # some slots drop
        assert torch.equal(torch.cat([ka, kb]), k1)


def test_dense_world_2_grads_match_the_jax_whole_batch(world):
    _, (jcfg, jp, jb), (r0, _) = world
    num_trees = jb["num_trees"]
    cols = {k: v for k, v in jb.items() if k != "num_trees"}
    (_, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_and_metrics(
            jcfg, p, {**b, "num_trees": num_trees}, "ref"),
        has_aux=True))(jp, cols)
    want = [torch.from_numpy(np.array(x, np.float32))
            for x in jax.tree.leaves(jg)]
    assert _max_rel(r0["w2"]["dense_packed"][0]["grads"], want) < 1e-4


@pytest.mark.parametrize("source", ["init", "ckpt"])
def test_ranks_hold_equal_params_from_one_seed_or_checkpoint(source, world):
    cases, _, (r0, r1) = world
    assert all(torch.equal(x, y) for x, y in zip(r0[source], r1[source]))
    if source == "ckpt":
        from repro_torch.device import tree_leaves
        assert all(torch.equal(x, y) for x, y in zip(
            r0[source], tree_leaves(cases["dense_packed"]["params"])))


def test_rows_split_in_contiguous_blocks():
    assert [row_block(8, r, 4) for r in range(4)] == \
        [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError):
        row_block(6, 0, 4)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

SMOKE = ["--arch", "qwen1p5_0p5b", "--smoke", "--steps", "3", "--device",
         "cpu"]
STEP_LINE = re.compile(r"^step +(\d+) loss +(\S+) nll/tok +(\S+) gnorm +(\S+)")


def _steps(text: str) -> list:
    return [m.groups() for m in map(STEP_LINE.match, text.splitlines()) if m]


def test_launcher_on_a_world_of_2_prints_the_world_1_losses(capsys,
                                                            monkeypatch):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train ...
    --mesh host --aot-warmup``: rank 0 prints world 1's step lines and the
    warm-up ends with 0 engine retraces."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_launch.main(SMOKE)
    finally:
        torch.set_num_threads(n)
    want = _steps(capsys.readouterr().out)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *SMOKE,
         "--mesh", "host", "--aot-warmup"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "mesh=host2 (data 2 x model 1)" in res.stdout
    assert len(want) >= 2 and _steps(res.stdout) == want
    assert re.search(r"engine retraces 0\b", res.stdout), res.stdout


def test_launcher_refuses_the_production_meshes(capsys, monkeypatch):
    """On a world that is not the production mesh's, ``--mesh single`` and
    ``multi`` exit naming the ranks they need."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for mesh, n in (("single", 256), ("multi", 512)):
        with pytest.raises(SystemExit):
            train_launch.main(SMOKE + ["--mesh", mesh])
        assert f"it needs {n} ranks" in capsys.readouterr().err


def test_launcher_refuses_rows_that_do_not_split(capsys, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(train_launch, "join_from_env", lambda dev: dev)
    with pytest.raises(SystemExit):
        train_launch.main(SMOKE + ["--rows", "3"])
    assert "not a multiple of the mesh's data axis (2" in \
        capsys.readouterr().err


def test_rl_loop_refuses_a_world_of_2(capsys, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        rl_loop.main(["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu",
                      "--steps", "1"])
    assert "7e-ii" in capsys.readouterr().err
