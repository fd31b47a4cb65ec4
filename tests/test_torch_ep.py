"""Expert parallelism on ``torch.distributed`` (gloo, CPU): the MoE
family on meshes (data, model) of (1, 2), (1, 4) and (2, 2), with and
without sequence parallelism, against world 1 (the same plans through the
engine with no process group) and the JAX package.

Cases: (a) ``tiny_cfg("moe")`` at 3 layers (a dense first layer, then two
MoE layers of 4 experts top-2 with a shared expert) on a packed plan at
capacity factor 0.25, so capacity drops (token, slot) pairs, the aux
losses on; (b) Kimi K2's smoke config (a dense first layer, an MoE layer
with a shared expert) on a partition-wave plan.  Both start from the JAX
package's weights, bridged onto each rank's blocks (``params_from_jax(...,
mesh)``): rank r of the model axis holds experts [r·E/m, (r+1)·E/m).

Bars: loss and metrics within 1e-6 relative of world 1, and
``train_step.value_and_grad``'s loss and ``aux_loss`` (on (b)'s trees
whole, one a row); the gathered grads, ``moe/router`` included, within
1e-4 max-rel (tests/test_equivalence.py:62's model-grad bar) of world 1
and, for (a), of the JAX package's one-device ``value_and_grad``; after 2
AdamW steps the gathered params within 1e-6 of world 1's AdamW applied to
the same gathered grads, and ``torch.equal`` across data replicas; a
second run bit-identical; one host sync a step; each MoE call's ``top_e``
``torch.equal`` across the model axis and its kept (token, slot) pairs,
the data ranks' rows in order, world 1's.  Each rank's blocks of a
seeded init of the Qwen3-30B-A3B, Llama-4 Scout and Kimi K2 smoke configs
are world 1's leaves sliced by ``param_spec``; a forward's expert
products run on [E/m, C, D] and each MoE layer sums its output once; a
model-2 checkpoint loads in world 1.

World 1 and the model-2 mesh run in a world of 2, the model-4 meshes in a
world of 4 (``init_method="file://..."``, no port); both worlds run at
once and write their results, which the tests read."""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import sharding as sh  # noqa: E402
from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.gateway import build_partition_plan  # noqa: E402
from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import random_tree, trees_for_batch  # noqa: E402
from repro_torch.device import (flatten_tree, tree_leaves,  # noqa: E402
                                unflatten_like)
from repro_torch.launch.mesh import MeshDescriptor  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import batch_arrays, init_params  # noqa: E402
from repro_torch.models.transformer import (check_model_axis,  # noqa: E402
                                            forward)
from repro_torch.train.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.train.engine import ExecutionPlan, PackedExec  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,  # noqa: E402
                                         init_opt_state)

ROOT = Path(__file__).resolve().parents[1]
CASES = ("moe_packed", "kimi_waves")
WORLDS = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
MESHES = [m for ms in WORLDS.values() for m in ms]
SPS = (False, True)
STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
LEAF_ARCHS = ("qwen3_30b_a3b", "llama4_scout_17b_a16e", "kimi_k2_1t_a32b")


def _rows(cfg, trees, S):
    """Host columns of ``trees``, one a row of ``S``."""
    rows = [batch_arrays(cfg, pack_trees([serialize_tree(t)], S,
                                         batch_size=1)) for t in trees]
    out = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]
           if k != "num_trees"}
    out["num_trees"] = len(trees)
    return out


def _wave_trees():
    """Four branching random trees of 60–120 tokens (larger than a row of
    48)."""
    out = []
    for s in range(400):
        t = random_tree(np.random.default_rng(s), vocab_size=500,
                        max_depth=5, seg_len_range=(3, 9))
        if t.num_leaves() >= 4 and 60 <= t.num_unique_tokens() <= 120:
            out.append(t)
        if len(out) == 4:
            return out
    raise RuntimeError("no wave trees")


def _cases():
    """{name: dict(cfg, np_params, plan, vg, jax=(jcfg, jparams, rows))}:
    the port's configs, plans and ``value_and_grad`` rows (host arrays),
    and the JAX side."""
    out = {}
    jcfg = tiny_cfg("moe", n_layers=3)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.25))
    cfg = config_from_jax(jcfg)
    jp = jmodel.init_params(jcfg, jax.random.key(2))
    inputs = _rows(cfg, trees_for_batch(3, n_trees=4, kind="random",
                                        vocab_size=cfg.vocab_size), 128)
    out["moe_packed"] = dict(
        cfg=cfg, np_params=jax.tree.map(np.asarray, jp),
        plan=ExecutionPlan(packed=PackedExec(
            inputs=inputs, tokens=int(inputs["valid"].sum()),
            cells=inputs["tokens"].size), num_trees=4),
        vg=inputs, jax=(jcfg, jp, inputs))

    jcfg = jget_config("kimi_k2_1t_a32b", smoke=True)
    cfg = config_from_jax(jcfg)
    jp = jmodel.init_params(jcfg, jax.random.key(3))
    trees = _wave_trees()
    part = build_partition_plan(cfg, trees, 40, seq_len=48, max_rows=2,
                                row_multiple=2)
    out["kimi_waves"] = dict(
        cfg=cfg, np_params=jax.tree.map(np.asarray, jp),
        plan=ExecutionPlan(partition=part, num_trees=part.num_trees),
        vg=_rows(cfg, trees, 128))
    return out


_WORKER = r"""
import pickle, sys
from datetime import timedelta
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + d + "/store%d" % world,
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=120))
from repro_torch import sharding as sh
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.device import tree_leaves
from repro_torch.launch.mesh import MeshDescriptor
from repro_torch.models import moe
from repro_torch.models.model import device_batch, init_params
from repro_torch.models.model import loss_and_metrics
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.engine import TreeTrainEngine
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_step import value_and_grad

with open(d + "/cases.pkl", "rb") as f:
    cases, meshes, opt, steps, leaf_archs = pickle.load(f)
meshes = meshes[world]

# every MoE call's routing (top_e) and kept (token, slot) pairs
routed, kept = [], []
route, queue = moe.route, moe.queue
def rec_route(*args):
    out = route(*args)
    routed.append(out[3].clone())
    return out
def rec_queue(*args):
    out = queue(*args)
    kept.append(out[2].clone())
    return out
moe.route, moe.queue = rec_route, rec_queue


def gathered(tree):
    return [torch.from_numpy(a.copy()) for a in
            tree_leaves(params_to_numpy(tree))]


def run(c, params, ckpt=None):
    # accumulate once (its routing recorded), then the steps; every
    # step's (gathered) grads kept
    engine = TreeTrainEngine(c["cfg"], OptimizerConfig(**opt))
    steps_g, acc = [], engine.accumulate

    def keep(p, plan):
        out = acc(p, plan)
        steps_g.append(gathered(out[0]))
        return out
    routed.clear()
    kept.clear()
    grads, scal = acc(params, c["plan"])
    res = dict(grads=gathered(grads), scal=scal, metrics=[], params=[],
               top_e=list(routed), kept=list(kept))
    engine.accumulate = keep
    o = init_opt_state(params)
    for i in range(steps):
        params, o, m = engine.step(params, o, c["plan"])
        res["metrics"].append(m)
        res["params"].append(gathered(params))
        if ckpt is not None and i == 0:
            save_checkpoint(ckpt, params, o, meta={"steps": 1})
    res.update(step_grads=steps_g, host_syncs=engine.host_syncs,
               local=tree_leaves(params))
    return res


def vg(c, params):
    # value_and_grad on the case's rows (host arrays)
    batch = device_batch(c["vg"], torch.device("cpu"))
    loss, m, g = value_and_grad(c["cfg"], params, batch, "kernel")
    return dict(loss=float(loss), aux_loss=float(m["aux_loss"]),
                nll_sum=float(m["nll_sum"]), grads=gathered(g))


out = {"w1": {}, "ep": {}, "leaves": {}, "coord": {}, "vg": {}, "w1vg": {}}
if world == 2 and rank == 0:       # world 1: no process group's mesh
    for n, c in cases.items():
        out["w1"][n] = run(c, params_from_jax(c["np_params"], "cpu"))
        out["w1vg"][n] = vg(c, params_from_jax(c["np_params"], "cpu"))
for shape in meshes:
    desc = MeshDescriptor("t", shape, ("data", "model"), ("data",))
    mesh = desc.build("cpu")
    for sp in (False, True):
        with sh.use_mesh(mesh, seq_parallel=sp):
            for n, c in cases.items():
                out["ep"][(shape, sp, n)] = [
                    run(c, params_from_jax(c["np_params"], "cpu", mesh))
                    for _ in range(2)]
                out["vg"][(shape, sp, n)] = vg(
                    c, params_from_jax(c["np_params"], "cpu", mesh))
    with sh.use_mesh(mesh):
        for arch in leaf_archs:
            cfg = get_config(arch, smoke=True)
            out["leaves"][(shape, arch)] = tree_leaves(init_params(
                cfg, torch.Generator().manual_seed(5), device="cpu"))
        out["coord"][shape] = mesh.get_local_rank("model")

if world == 2:
    mesh = MeshDescriptor("t", (1, 2), ("data", "model"), ("data",)).build(
        "cpu")
    c = cases["moe_packed"]
    with sh.use_mesh(mesh):
        first = run(c, params_from_jax(c["np_params"], "cpu", mesh),
                    ckpt=d + "/ckpt")
        out["ckpt"] = first["params"][0]

    # one forward's collectives and expert products, sequence parallelism
    # off and on
    calls, bmms, real = [], [], {}
    def wrap(name):
        fn = getattr(dist, name)
        real[name] = fn
        def rec(*args, **kw):
            calls.append((name, tuple(args[1 if name != "all_reduce" else 0]
                                      .shape)))
            return fn(*args, **kw)
        setattr(dist, name, rec)
    for name in ("all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "reduce_scatter_single"):
        if hasattr(dist, name):
            wrap(name)
    bmm = torch.bmm
    def rec_bmm(a, b):
        bmms.append((tuple(a.shape), tuple(b.shape)))
        return bmm(a, b)
    torch.bmm = rec_bmm
    out["calls"] = {}
    for sp in (False, True):
        with sh.use_mesh(mesh, seq_parallel=sp), torch.no_grad():
            params = params_from_jax(c["np_params"], "cpu", mesh)
            batch = device_batch(c["plan"].packed.inputs, torch.device("cpu"))
            calls.clear()
            bmms.clear()
            loss_and_metrics(c["cfg"], params, batch, "kernel")
            out["calls"][sp] = (list(calls), list(bmms))
    torch.bmm = bmm
    for name, fn in real.items():
        setattr(dist, name, fn)

dist.barrier()
dist.destroy_process_group()
torch.save(out, d + "/w%d_rank%d.pt" % (world, rank))
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds at once; returns (cases, {world: [rank results]}, dir)."""
    d = tmp_path_factory.mktemp("ep")
    cases = _cases()
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(({n: {k: v for k, v in c.items() if k != "jax"}
                      for n, c in cases.items()}, WORLDS, OPT, STEPS,
                     LEAF_ARCHS), f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [(w, subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(w), str(d)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for w in WORLDS for r in range(w)]
    try:
        outs = [pr.communicate(timeout=300) for _, pr in procs]
    finally:
        for _, pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for (_, pr), (_, err) in zip(procs, outs):
        assert pr.returncode == 0, err[-4000:]
    res = {w: [torch.load(d / f"w{w}_rank{r}.pt", weights_only=False)
               for r in range(w)] for w in WORLDS}
    return cases, res, d


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _max_rel(got, want):
    return max(float((a - b).abs().max() / (b.abs().max() + 1e-9))
               for a, b in zip(got, want))


def _world(shape):
    return next(w for w, ms in WORLDS.items() if shape in ms)


def _ranks(res, shape, sp, name):
    """Every rank's two runs of one (mesh, sp, case)."""
    return [r["ep"][(shape, sp, name)] for r in res[_world(shape)]]


def _w1(res, name):
    return res[2][0]["w1"][name]


CELLS = [(m, sp, n) for m in MESHES for sp in SPS for n in CASES]


def _ids(cell):
    m, sp, n = cell
    return f"{m[0]}x{m[1]}-{'sp' if sp else 'nosp'}-{n}"


def _router_leaves(params):
    """The indices of the ``moe/router`` leaves in ``tree_leaves`` order."""
    return [i for i, (p, _) in enumerate(flatten_tree(params))
            if "moe/router" in "/".join(map(str, p))]


@pytest.mark.parametrize("cell", CELLS, ids=map(_ids, CELLS))
def test_loss_and_metrics_equal_world_1(cell, worlds):
    _, res, _ = worlds
    w1 = _w1(res, cell[2])
    runs = _ranks(res, *cell)
    for r in runs:
        assert torch.equal(r[0]["scal"], runs[0][0]["scal"])
        for i in range(3):
            assert _rel(r[0]["scal"][i], w1["scal"][i]) <= 1e-6, i
        assert r[0]["metrics"] == runs[0][0]["metrics"]
        for m1, m2 in zip(w1["metrics"], r[0]["metrics"]):
            for k in ("loss", "nll_sum", "weight_sum", "grad_norm", "lr",
                      "nll"):
                assert _rel(m2[k], m1[k]) <= 1e-6, k


@pytest.mark.parametrize("cell", CELLS, ids=map(_ids, CELLS))
def test_value_and_grad_loss_and_aux_loss_equal_world_1(cell, worlds):
    """``value_and_grad`` on the mesh: the loss, the aux loss (the sum of
    the MoE layers' load-balance and router-z terms, each whole on every
    rank of the model axis) and the token-CE sum within 1e-6 of world 1's,
    the gathered grads within 1e-4."""
    _, res, _ = worlds
    shape, sp, name = cell
    w1 = res[2][0]["w1vg"][name]
    assert w1["aux_loss"] > 0
    for r in res[_world(shape)]:
        got = r["vg"][cell]
        for k in ("loss", "aux_loss", "nll_sum"):
            assert _rel(got[k], w1[k]) <= 1e-6, k
        assert _max_rel(got["grads"], w1["grads"]) < 1e-4


@pytest.mark.parametrize("cell", CELLS, ids=map(_ids, CELLS))
def test_gathered_grads_within_model_grad_bar_of_world_1(cell, worlds):
    cases, res, _ = worlds
    runs = _ranks(res, *cell)
    for r in runs:
        assert all(torch.equal(x, y) for x, y in
                   zip(r[0]["grads"], runs[0][0]["grads"]))
    got, want = runs[0][0]["grads"], _w1(res, cell[2])["grads"]
    assert _max_rel(got, want) < 1e-4
    # the router's gradient: every rank's share of the combine's plus
    # 1/m of the aux losses' (summed once over the model axis)
    idx = _router_leaves(params_from_jax(cases[cell[2]]["np_params"], "cpu"))
    assert idx
    assert _max_rel([got[i] for i in idx], [want[i] for i in idx]) < 1e-4


def _jax_grads(case):
    jcfg, jp, inputs = case["jax"]
    n = inputs["num_trees"]
    cols = {k: jax.numpy.asarray(v) for k, v in inputs.items()
            if k != "num_trees"}
    (_, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_and_metrics(jcfg, p, {**b, "num_trees": n},
                                             "ref"), has_aux=True))(jp, cols)
    return [torch.from_numpy(np.array(x, np.float32))
            for x in jax.tree.leaves(jg)]


def test_gathered_grads_match_the_jax_one_device_grads(worlds):
    """Every mesh's grads of the packed case against the reference's
    ``value_and_grad`` on the same bridged weights, ``moe/router``
    included."""
    cases, res, _ = worlds
    name = "moe_packed"
    want = _jax_grads(cases[name])
    idx = _router_leaves(params_from_jax(cases[name]["np_params"], "cpu"))
    assert _max_rel(_w1(res, name)["grads"], want) < 1e-4
    for m in MESHES:
        for sp in SPS:
            got = _ranks(res, m, sp, name)[0][0]["grads"]
            assert _max_rel(got, want) < 1e-4, (m, sp)
            assert _max_rel([got[i] for i in idx],
                            [want[i] for i in idx]) < 1e-4, (m, sp)


@pytest.mark.parametrize("cell", CELLS, ids=map(_ids, CELLS))
def test_params_after_the_steps_are_world_1_adamw_of_the_grads(cell, worlds):
    """The gathered params after each step equal world 1's AdamW applied,
    from the same params, to the step's gathered grads (the experts'
    blocks updated on their ranks, the clip norm summed over the axis),
    and are ``torch.equal`` across data replicas."""
    cases, res, _ = worlds
    shape, _, name = cell
    runs = _ranks(res, *cell)
    first = runs[0][0]
    params = params_from_jax(cases[name]["np_params"], "cpu")
    opt = init_opt_state(params)
    for g, p in zip(first["step_grads"], first["params"]):
        params, opt, _ = adamw_update(OptimizerConfig(**OPT), params,
                                      unflatten_like(params, g), opt)
        assert _max_rel(p, tree_leaves(params)) <= 1e-6
    data, model = shape
    for r in range(model):
        replicas = [runs[d * model + r][0]["local"] for d in range(data)]
        for other in replicas[1:]:
            assert all(torch.equal(x, y) for x, y in zip(replicas[0], other))


@pytest.mark.parametrize("cell", CELLS, ids=map(_ids, CELLS))
def test_second_run_is_bit_identical(cell, worlds):
    _, res, _ = worlds
    for first, second in _ranks(res, *cell):
        for key in ("grads", "local"):
            assert all(torch.equal(x, y)
                       for x, y in zip(first[key], second[key])), key
        assert torch.equal(first["scal"], second["scal"])


@pytest.mark.parametrize("cell", CELLS, ids=map(_ids, CELLS))
def test_one_host_sync_a_step_on_every_rank(cell, worlds):
    _, res, _ = worlds
    assert _w1(res, cell[2])["host_syncs"] == STEPS
    for runs in _ranks(res, *cell):
        assert all(run["host_syncs"] == STEPS for run in runs)


@pytest.mark.parametrize("cell", CELLS, ids=map(_ids, CELLS))
def test_routing_agrees_across_the_model_axis_and_keeps_world_1s_slots(
        cell, worlds):
    """Every MoE call of the accumulate (a wave's forward sweep and its
    recompute too): ``top_e`` ``torch.equal`` on every rank of a model
    group (under sequence parallelism the routed rows are an all-gather),
    and the kept (token, slot) pairs, the data ranks' rows in order,
    world 1's; capacity drops some in the packed case."""
    cases, res, _ = worlds
    shape, _, name = cell
    data, model = shape
    runs = [r[0] for r in _ranks(res, *cell)]
    w1 = _w1(res, name)
    assert len(w1["kept"]) >= 1
    for d in range(data):
        group = runs[d * model:(d + 1) * model]
        for r in group[1:]:
            assert len(r["top_e"]) == len(group[0]["top_e"])
            assert all(torch.equal(a, b) for a, b in
                       zip(r["top_e"], group[0]["top_e"]))
            assert all(torch.equal(a, b) for a, b in
                       zip(r["kept"], group[0]["kept"]))
    for i, k1 in enumerate(w1["kept"]):
        got = torch.cat([runs[d * model]["kept"][i] for d in range(data)])
        assert torch.equal(got, k1), i
    if name == "moe_packed":
        valid = cases[name]["plan"].packed.inputs["valid"]
        K = cases[name]["cfg"].moe.top_k
        assert any(int(k.sum()) < int(valid.sum()) * K for k in w1["kept"])


@pytest.mark.parametrize("arch", LEAF_ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_each_rank_holds_its_block_of_the_experts(arch, shape, worlds):
    """A seeded init on the mesh is world 1's init sliced by
    ``param_spec`` on every rank: the expert leaves [L, E/m, …] its block
    of the experts, the shared expert's column and row blocks, the router
    whole."""
    _, res, _ = worlds
    cfg = get_config(arch, smoke=True)
    full = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    desc = MeshDescriptor("t", shape, ("data", "model"), ("data",))
    specs = sh._param_spec_list(full, desc, "model", None)
    E, m = cfg.moe.num_experts, shape[1]
    for r in res[_world(shape)]:
        got = r["leaves"][(shape, arch)]
        coord = r["coord"][shape]
        n_expert = 0
        for (path, leaf), s, g in zip(flatten_tree(full), specs, got):
            ps = "/".join(map(str, path))
            want = leaf
            for d, a in enumerate(s):
                if a == "model":
                    n = leaf.shape[d] // m
                    want = leaf.narrow(d, coord * n, n)
            assert torch.equal(g, want), ps
            if ps.endswith(("moe/wi_gate", "moe/wi_up", "moe/wo")):
                assert g.shape[1] == E // m, ps
                n_expert += 1
            if ps.endswith("moe/router"):
                assert torch.equal(g, leaf)
        assert n_expert >= 2


def test_a_forward_runs_the_ranks_experts_and_sums_each_layer_once(worlds):
    """One forward of the packed case at model 2: every expert product is
    [E/2, C, D] @ [E/2, D, F] (or its wo), and the model axis moves one
    [B, S, D] tensor a block: without sequence parallelism 1 + 2L
    all-reduces (the embedding, each layer's attention and MLP or MoE),
    with it as many reduce-scatters and 2L + 1 all-gathers, and no
    all-reduce of an activation."""
    cases, res, _ = worlds
    c = cases["moe_packed"]
    cfg = c["cfg"]
    B, S = c["plan"].packed.inputs["tokens"].shape
    D, L, E = cfg.d_model, cfg.n_layers, cfg.moe.num_experts
    C = tmoe.capacity(B * S, cfg.moe)
    big = lambda shp: int(np.prod(shp)) >= B * S * D
    n_moe = L - cfg.moe.first_dense_layers
    for sp in SPS:
        calls, bmms = res[2][0]["calls"][sp]
        assert len(bmms) == 3 * n_moe
        assert all(a[0] == E // 2 and a[1] == C and b[0] == E // 2
                   for a, b in bmms)
        if sp:
            rs = [s for n, s in calls if n.startswith("reduce_scatter")]
            ag = [s for n, s in calls if n == "all_gather_into_tensor"]
            assert len(rs) == 1 + 2 * L and all(big(s) for s in rs)
            assert len(ag) == 2 * L + 1
            assert not [s for n, s in calls if n == "all_reduce" and big(s)]
        else:
            assert len([s for n, s in calls if n == "all_reduce"
                        and big(s)]) == 1 + 2 * L
            assert not [n for n, _ in calls if n != "all_reduce"]


def test_model_2_checkpoint_loads_in_world_1(worlds):
    """Save on model 2 gathers the expert leaves along E into the files
    world 1 writes: loaded with no mesh they are the gathered params."""
    cases, res, d = worlds
    c = cases["moe_packed"]
    like = init_params(c["cfg"], torch.Generator().manual_seed(0),
                       device="cpu")
    loaded = load_checkpoint(str(d / "ckpt"), like)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(loaded), res[2][0]["ckpt"]))


class _FakeMesh:
    """A mesh-shaped stand-in (axis names and sizes only)."""
    def __init__(self, shape):
        self.mesh_dim_names = ("data", "model")
        self._shape = shape

    def size(self, i):
        return self._shape[i]


@pytest.mark.parametrize("arch,m,what", [
    ("qwen3_30b_a3b", 8, "expert count"),
    ("kimi_k2_1t_a32b", 8, "shared-expert width"),
    ("kimi_k2_1t_a32b", 4, "FFN width")])
def test_a_model_axis_that_does_not_divide_the_experts_raises(arch, m, what):
    """The expert count, the shared expert's width and a dense first
    layer's FFN width must divide the model axis: each refuses naming
    7e-ii, as the layer does itself."""
    cfg = get_config(arch, smoke=True)
    if what == "shared-expert width":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=8,
                                                  d_expert=36))
    if what == "FFN width":
        cfg = cfg.replace(d_ff=126)
    with pytest.raises(NotImplementedError, match=f"{what}.*7e-ii"):
        check_model_axis(cfg, m)
    with sh.use_mesh(_FakeMesh((1, m))):
        with pytest.raises(NotImplementedError, match="7e-ii"):
            init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(NotImplementedError, match="7e-ii"):
            forward(cfg, {}, {"tokens": torch.zeros((1, 8),
                                                    dtype=torch.int32)})
    if what == "expert count":
        x = torch.zeros((1, 8, cfg.d_model))
        with sh.use_mesh(_FakeMesh((1, m))):
            with pytest.raises(NotImplementedError, match="experts.*7e-ii"):
                tmoe.moe({}, cfg.moe, x, torch.ones((1, 8), dtype=torch.bool),
                         cfg.mlp_activation)


@pytest.mark.parametrize("arch", LEAF_ARCHS)
def test_the_production_model_axis_divides_the_moe_archs(arch):
    """At the production meshes' model axis of 16: 128, 16 and 384 experts
    and every width divide (Qwen3-30B-A3B's 4 KV heads are cut)."""
    check_model_axis(get_config(arch), 16)


def test_a_rank_draws_its_experts_an_expert_at_a_time(monkeypatch):
    """Where one layer's fp32 draw passes ``_DRAW_BYTES`` (one of Kimi K2's
    is 22.5 GB) world 1 draws it an expert at a time; a rank's block of
    the experts draws every expert in that order and keeps its own, so its
    block is world 1's, and no fp32 draw of more than one expert exists."""
    monkeypatch.setattr(layers, "_DRAW_BYTES", 4 * 6 * 5)
    shape = (2, 8, 6, 5)        # [layers, experts, D, F]
    seen = []
    real = torch.randn

    def counted(*a, **kw):
        seen.append(a[0])
        return real(*a, **kw)

    def draw():
        return layers.Draw(torch.Generator().manual_seed(3), shape, 0.5,
                           torch.float32, "cpu")
    full = draw().realize()
    monkeypatch.setattr(torch, "randn", counted)
    for lo, hi in ((0, 4), (4, 8), (2, 4)):
        seen.clear()
        got = draw().realize((1, lo, hi))
        assert torch.equal(got, full[:, lo:hi])
        assert len(seen) == 16 and all(tuple(s) == (6, 5) for s in seen)
