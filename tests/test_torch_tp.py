"""Tensor parallelism on ``torch.distributed`` (gloo, CPU): the dense
family's Megatron layout on meshes (data, model) of (1, 2), (1, 4) and
(2, 2), with and without sequence parallelism, against world 1 (the same
plans through the engine with no process group) and the JAX package.

Cases: (a) Qwen2-1.5B's smoke config (H 6 / Kh 2, hd 16, QKV bias) on a
packed plan; at model 4 its query and KV columns cut heads.  (b) Qwen3-8B's
smoke config (H 4 / Kh 2, hd 32, q/k norms) on a partition-wave plan; at
model 4 its KV columns cut a head.  Both start from the JAX package's
weights, bridged onto each rank's blocks (``params_from_jax(..., mesh)``).

Bars: loss and metrics within 1e-6 relative of world 1; the gathered grads
within 1e-4 max-rel (tests/test_equivalence.py:62's model-grad bar) of
world 1 and of the JAX package's one-device ``value_and_grad`` (for (b) on
its trees whole, one a row); ``grad_norm`` within 1e-6 relative; after 2
AdamW steps the gathered params within 1e-6 of world 1's AdamW applied to
the same gathered grads from the same params, and ``torch.equal`` across
data replicas; a second run bit-identical; one host sync a step.  Each
rank's blocks of a seeded init are world 1's leaves sliced by
``param_spec``; under sequence parallelism a forward's block boundaries
reduce-scatter and all-gather and never all-reduce an activation; a
model-2 checkpoint loads in world 1 and resumes bit-exactly on model 2.

World 1 and the model-2 mesh run in a world of 2, the model-4 meshes in a
world of 4 (``init_method="file://..."``, no port); both worlds run at
once and write their results, which the tests read.  The families that
the model axis does not run yet raise, as does an MoE model whose experts
do not divide the axis (a mesh stand-in, in process; the MoE family's
model axis runs in tests/test_torch_ep.py)."""
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
from repro_torch.models.model import batch_arrays, init_params  # noqa: E402
from repro_torch.models.transformer import (check_model_axis,  # noqa: E402
                                            forward)
from repro_torch.train.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.train.engine import ExecutionPlan, PackedExec  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,  # noqa: E402
                                         init_opt_state)

ROOT = Path(__file__).resolve().parents[1]
CASES = ("qwen2_packed", "qwen3_waves")
WORLDS = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
MESHES = [m for ms in WORLDS.values() for m in ms]
SPS = (False, True)
STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
LEAF_ARCHS = ("qwen2_1p5b", "qwen3_8b", "nemotron_4_340b")


def _rows(cfg, trees, S):
    """Host columns of ``trees``, one a row of ``S``."""
    rows = [batch_arrays(cfg, pack_trees([serialize_tree(t)], S,
                                         batch_size=1)) for t in trees]
    out = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]
           if k != "num_trees"}
    out["num_trees"] = len(trees)
    return out


def _wave_trees():
    """Branching random trees of 60–120 tokens (larger than a row of 48)."""
    out = []
    for s in range(300):
        t = random_tree(np.random.default_rng(s), vocab_size=500,
                        max_depth=5, seg_len_range=(3, 9))
        if t.num_leaves() >= 4 and 60 <= t.num_unique_tokens() <= 120:
            out.append(t)
        if len(out) == 3:
            return out
    raise RuntimeError("no wave trees")


def _cases():
    """{name: dict(cfg, np_params, plan, jax=(jcfg, jparams, jax batch))}:
    the port's configs and plans (host arrays) and the JAX side."""
    out = {}
    jcfg = jget_config("qwen2_1p5b", smoke=True)
    cfg = config_from_jax(jcfg)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    inputs = _rows(cfg, trees_for_batch(2, n_trees=4, kind="random",
                                        vocab_size=cfg.vocab_size), 256)
    out["qwen2_packed"] = dict(
        cfg=cfg, np_params=jax.tree.map(np.asarray, jp),
        plan=ExecutionPlan(packed=PackedExec(
            inputs=inputs, tokens=int(inputs["valid"].sum()),
            cells=inputs["tokens"].size), num_trees=4),
        jax=(jcfg, jp, inputs))

    jcfg = jget_config("qwen3_8b", smoke=True)
    cfg = config_from_jax(jcfg)
    jp = jmodel.init_params(jcfg, jax.random.key(1))
    trees = _wave_trees()
    part = build_partition_plan(cfg, trees, 40, seq_len=48, max_rows=2,
                                row_multiple=2)
    out["qwen3_waves"] = dict(
        cfg=cfg, np_params=jax.tree.map(np.asarray, jp),
        plan=ExecutionPlan(partition=part, num_trees=part.num_trees),
        jax=(jcfg, jp, _rows(cfg, trees, 128)))
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
from repro_torch.models.model import device_batch, init_params
from repro_torch.models.model import loss_and_metrics
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.engine import TreeTrainEngine
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_step import value_and_grad

with open(d + "/cases.pkl", "rb") as f:
    cases, meshes, opt, steps, leaf_archs = pickle.load(f)
meshes = meshes[world]


def gathered(tree):
    return [torch.from_numpy(a.copy()) for a in
            tree_leaves(params_to_numpy(tree))]


def run(c, params, ckpt=None):
    # accumulate once, then the steps; every step's (gathered) grads kept
    engine = TreeTrainEngine(c["cfg"], OptimizerConfig(**opt))
    kept, acc = [], engine.accumulate

    def keep(p, plan):
        out = acc(p, plan)
        kept.append(gathered(out[0]))
        return out
    grads, scal = acc(params, c["plan"])
    res = dict(grads=gathered(grads), scal=scal, metrics=[], params=[])
    engine.accumulate = keep
    o = init_opt_state(params)
    for i in range(steps):
        params, o, m = engine.step(params, o, c["plan"])
        res["metrics"].append(m)
        res["params"].append(gathered(params))
        if ckpt is not None and i == 0:
            save_checkpoint(ckpt, params, o, meta={"steps": 1})
    res.update(step_grads=kept, host_syncs=engine.host_syncs,
               local=tree_leaves(params))
    return res


def vg(c, params):
    # value_and_grad on the packed case's batch (its rows, host arrays)
    batch = device_batch(c["plan"].packed.inputs, torch.device("cpu"))
    loss, m, g = value_and_grad(c["cfg"], params, batch, "kernel")
    return dict(loss=float(loss), nll_sum=float(m["nll_sum"]),
                grads=gathered(g))


out = {"w1": {}, "tp": {}, "leaves": {}, "coord": {}, "vg": {}}
if world == 2 and rank == 0:       # world 1: no process group's mesh
    for n, c in cases.items():
        out["w1"][n] = run(c, params_from_jax(c["np_params"], "cpu"))
    c = cases["qwen2_packed"]
    out["w1vg"] = vg(c, params_from_jax(c["np_params"], "cpu"))
for shape in meshes:
    desc = MeshDescriptor("t", shape, ("data", "model"), ("data",))
    mesh = desc.build("cpu")
    for sp in (False, True):
        with sh.use_mesh(mesh, seq_parallel=sp):
            for n, c in cases.items():
                out["tp"][(shape, sp, n)] = [
                    run(c, params_from_jax(c["np_params"], "cpu", mesh))
                    for _ in range(2)]
            c = cases["qwen2_packed"]
            out["vg"][(shape, sp)] = vg(
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
    c = cases["qwen2_packed"]
    with sh.use_mesh(mesh):
        # step 1, save, step 2; then the checkpoint resumed for step 2
        first = run(c, params_from_jax(c["np_params"], "cpu", mesh),
                    ckpt=d + "/ckpt")
        like = params_from_jax(c["np_params"], "cpu", mesh)
        p, o = load_checkpoint(d + "/ckpt", like, init_opt_state(like))
        engine = TreeTrainEngine(c["cfg"], OptimizerConfig(**opt))
        engine.steps_done = 1
        p, o, m = engine.step(p, o, c["plan"])
        out["ckpt"] = dict(first=first["params"], resumed=gathered(p),
                           first_local=first["local"],
                           resumed_local=tree_leaves(p))

    # the collectives one forward issues, with sequence parallelism on/off
    calls, real = [], {}
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
    out["calls"] = {}
    for sp in (False, True):
        with sh.use_mesh(mesh, seq_parallel=sp), torch.no_grad():
            params = params_from_jax(c["np_params"], "cpu", mesh)
            batch = device_batch(c["plan"].packed.inputs, torch.device("cpu"))
            calls.clear()
            loss_and_metrics(c["cfg"], params, batch, "kernel")
            out["calls"][sp] = list(calls)
    for name, fn in real.items():
        setattr(dist, name, fn)

    # shard_activation under sequence parallelism: a full-length tensor
    # scattered to this rank's block of S (backward: the all-gather), a
    # block passed as it is
    with sh.use_mesh(mesh, seq_parallel=True), sh.sequence(8):
        x = torch.arange(16.).reshape(1, 8, 2).requires_grad_(True)
        y = sh.shard_activation(x)
        (y * (rank + 1)).sum().backward()
        blk = y.detach()
        out["scatter"] = (blk, x.grad, sh.shard_activation(blk) is blk)

dist.barrier()
dist.destroy_process_group()
torch.save(out, d + "/w%d_rank%d.pt" % (world, rank))
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds at once; returns (cases, {world: [rank results]})."""
    d = tmp_path_factory.mktemp("tp")
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
    outs = [pr.communicate(timeout=300) for _, pr in procs]
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
    return [r["tp"][(shape, sp, name)] for r in res[_world(shape)]]


def _w1(res, name):
    return res[2][0]["w1"][name]


CELLS = [(m, sp, n) for m in MESHES for sp in SPS for n in CASES]


def _ids(cell):
    m, sp, n = cell
    return f"{m[0]}x{m[1]}-{'sp' if sp else 'nosp'}-{n}"


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
def test_gathered_grads_within_model_grad_bar_of_world_1(cell, worlds):
    _, res, _ = worlds
    runs = _ranks(res, *cell)
    for r in runs:
        assert all(torch.equal(x, y) for x, y in
                   zip(r[0]["grads"], runs[0][0]["grads"]))
    assert _max_rel(runs[0][0]["grads"], _w1(res, cell[2])["grads"]) < 1e-4


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


@pytest.mark.parametrize("name", CASES)
def test_gathered_grads_match_the_jax_one_device_grads(name, worlds):
    """Every mesh's grads against the reference's ``value_and_grad`` on the
    same bridged weights (the wave case's trees whole, one a row)."""
    cases, res, _ = worlds
    want = _jax_grads(cases[name])
    assert _max_rel(_w1(res, name)["grads"], want) < 1e-4
    for m in MESHES:
        for sp in SPS:
            got = _ranks(res, m, sp, name)[0][0]["grads"]
            assert _max_rel(got, want) < 1e-4, (m, sp)


@pytest.mark.parametrize("cell", CELLS, ids=map(_ids, CELLS))
def test_params_after_the_steps_are_world_1_adamw_of_the_grads(cell, worlds):
    """The gathered params after each step equal world 1's AdamW applied,
    from the same params, to the step's gathered grads (the sharded
    update and its clip norm), and are ``torch.equal`` across data
    replicas.  (World 1's own steps differ by up to ~2e-4 max-rel where
    a gradient is near 0: AdamW's first steps move each weight by about
    lr·sign(g), which turns the grads' 1e-6 into that; see CHANGES.md.)"""
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
    data = shape[0]
    model = shape[1]
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


@pytest.mark.parametrize("sp", SPS, ids=["nosp", "sp"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_value_and_grad_on_the_mesh_matches_world_1(shape, sp, worlds):
    """``train_step.value_and_grad`` (``make_train_step``'s) on the mesh:
    the loss, the token-CE sum and the gathered grads of world 1's."""
    _, res, _ = worlds
    w1 = res[2][0]["w1vg"]
    for r in res[_world(shape)]:
        got = r["vg"][(shape, sp)]
        assert _rel(got["loss"], w1["loss"]) <= 1e-6
        assert _rel(got["nll_sum"], w1["nll_sum"]) <= 1e-6
        assert _max_rel(got["grads"], w1["grads"]) < 1e-4


def test_model_4_cuts_heads():
    """At model 4 Qwen2's smoke query blocks (24 columns) and KV blocks (8)
    cut its heads of 16, and Qwen3's KV blocks (16) its heads of 32."""
    q2 = get_config("qwen2_1p5b", smoke=True).attn
    q3 = get_config("qwen3_8b", smoke=True).attn
    assert (q2.q_dim // 4) % q2.head_dim and (q2.kv_dim // 4) % q2.head_dim
    assert (q3.kv_dim // 4) % q3.head_dim


@pytest.mark.parametrize("arch", LEAF_ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_each_rank_holds_its_param_spec_slices(arch, shape, worlds):
    """A seeded init on the mesh is world 1's init sliced by
    ``param_spec`` on every rank (each leaf drawn as world 1 draws it)."""
    _, res, _ = worlds
    cfg = get_config(arch, smoke=True)
    full = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    desc = MeshDescriptor("t", shape, ("data", "model"), ("data",))
    specs = sh._param_spec_list(full, desc, "model", None)
    for r in res[_world(shape)]:
        got = r["leaves"][(shape, arch)]
        coord = r["coord"][shape]
        for (path, leaf), s, g in zip(flatten_tree(full), specs, got):
            want = leaf
            for d, a in enumerate(s):
                if a == "model":
                    n = leaf.shape[d] // shape[1]
                    want = leaf.narrow(d, coord * n, n)
            assert torch.equal(g, want), path


def test_sequence_parallel_boundaries_reduce_scatter(worlds):
    """One forward at model 2: with sequence parallelism the embedding and
    each block's output reduce-scatter, each block's input and the final
    hidden state all-gather, and no all-reduce moves a [B, S, D]
    activation (the loss's are [rows] vectors); without it those are
    all-reduces."""
    cases, res, _ = worlds
    c = cases["qwen2_packed"]
    B, S = c["plan"].packed.inputs["tokens"].shape
    D, L = c["cfg"].d_model, c["cfg"].n_layers
    calls = res[2][0]["calls"]
    big = lambda shp: int(np.prod(shp)) >= B * S * D
    on = calls[True]
    rs = [s for n, s in on if n.startswith("reduce_scatter")]
    ag = [s for n, s in on if n == "all_gather_into_tensor"]
    assert len(rs) == 1 + 2 * L and all(big(s) for s in rs)
    assert len(ag) == 2 * L + 1
    assert not [s for n, s in on if n == "all_reduce" and big(s)]
    off = calls[False]
    assert len([s for n, s in off if n == "all_reduce" and big(s)]) \
        == 1 + 2 * L
    assert not [n for n, _ in off if n != "all_reduce"]


def test_shard_activation_scatters_a_full_length_tensor(worlds):
    _, res, _ = worlds
    x = torch.arange(16.).reshape(1, 8, 2)
    for r, out in enumerate(res[2]):
        blk, grad, passed = out["scatter"]
        assert torch.equal(blk, x[:, 4 * r:4 * r + 4]) and passed
        assert torch.equal(grad[0, :, 0], torch.tensor([1.] * 4 + [2.] * 4))


def test_model_2_checkpoint_loads_in_world_1_and_resumes(worlds):
    cases, res, d = worlds
    ck = res[2][0]["ckpt"]
    c = cases["qwen2_packed"]
    like = init_params(c["cfg"], torch.Generator().manual_seed(0),
                       device="cpu")
    loaded = load_checkpoint(str(d / "ckpt"), like)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(loaded), ck["first"][0]))
    for r in res[2]:
        k = r["ckpt"]
        assert all(torch.equal(a, b) for a, b in
                   zip(k["first_local"], k["resumed_local"]))
    assert all(torch.equal(a, b) for a, b in
               zip(ck["first"][1], ck["resumed"]))


class _FakeMesh:
    """A mesh-shaped stand-in (axis names and sizes only)."""
    def __init__(self, shape):
        self.mesh_dim_names = ("data", "model")
        self._shape = shape

    def size(self, i):
        return self._shape[i]


@pytest.mark.parametrize("family", ["moe", "ssm_mamba2", "ssm_rwkv6",
                                    "ssm_gdn", "hybrid", "audio", "vlm"])
def test_families_not_ported_raise_on_a_model_axis(family):
    """The families the model axis does not run raise at model 2; the MoE
    family runs there and raises where its 4 experts do not divide the
    axis (model 8: its widths divide)."""
    cfg = config_from_jax(tiny_cfg(family))
    m = 2
    if family == "moe":
        check_model_axis(cfg, 2)
        m = 8
    with sh.use_mesh(_FakeMesh((1, m))):
        with pytest.raises(NotImplementedError, match="7e-ii"):
            init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    with sh.use_mesh(_FakeMesh((1, m))):
        with pytest.raises(NotImplementedError, match="7e-ii"):
            forward(cfg, params, batch)


@pytest.mark.parametrize("family", ["moe", "ssm_mamba2", "ssm_rwkv6",
                                    "ssm_gdn"])
def test_moe_and_ssm_layers_raise_on_a_model_axis(family):
    """The layers themselves refuse a model axis they do not run (not only
    the model's entry points): the SSM layers any, the MoE layer one that
    its 4 experts do not divide (model 8)."""
    from repro_torch.models import moe
    from repro_torch.models.ssm import gdn, mamba2, rwkv6
    cfg = config_from_jax(tiny_cfg(family))
    x = torch.zeros((1, 8, cfg.d_model))
    valid = torch.ones((1, 8), dtype=torch.bool)
    call = {
        "moe": lambda: moe.moe({}, cfg.moe, x, valid, cfg.mlp_activation),
        "ssm_mamba2": lambda: mamba2.mamba2({}, cfg.ssm, x, chunk_parent=None,
                                            prev_pows=None, valid=valid),
        "ssm_gdn": lambda: gdn.gdn({}, cfg.ssm, x, chunk_parent=None,
                                   prev_pows=None, valid=valid),
        "ssm_rwkv6": lambda: rwkv6.rwkv6_timemix(
            {}, cfg.ssm, x, chunk_parent=None, prev_idx=None, valid=valid),
    }[family]
    with sh.use_mesh(_FakeMesh((1, 8 if family == "moe" else 2))):
        with pytest.raises(NotImplementedError, match="7e-ii"):
            call()


def test_launcher_refuses_a_family_the_model_axis_does_not_run(capsys,
                                                               monkeypatch):
    """On the production mesh's world, a hybrid arch exits naming 7e-ii
    before any process group is joined (the MoE family now runs there)."""
    from repro_torch.launch import train as train_launch
    monkeypatch.setenv("WORLD_SIZE", "256")
    with pytest.raises(SystemExit):
        train_launch.main(["--arch", "zamba2_1p2b", "--smoke", "--steps",
                           "1", "--device", "cpu", "--mesh", "single"])
    assert "7e-ii" in capsys.readouterr().err


def test_sequence_parallel_refuses_rows_that_do_not_split():
    """Differs on purpose from the reference, which leaves such rows
    unsplit: under sequence parallelism a forward's rows must divide the
    model axis (the replicated leaves' gradients are the ranks' shares
    only where every block's tokens were split)."""
    with sh.use_mesh(_FakeMesh((1, 2)), seq_parallel=True):
        with pytest.raises(ValueError, match="do not split"):
            with sh.sequence(3):
                pass
        with sh.sequence(4):
            pass
    with sh.use_mesh(_FakeMesh((1, 2))):
        with sh.sequence(3):
            pass


def test_a_width_that_does_not_divide_the_model_axis_is_refused():
    """The spec replicates a weight whose sharded dim does not divide the
    model axis; the port refuses it (naming 7e-ii) instead of running a
    replicated weight's work on every rank."""
    cfg = config_from_jax(tiny_cfg("dense"))
    with sh.use_mesh(_FakeMesh((1, 5))):
        with pytest.raises(NotImplementedError, match="7e-ii"):
            init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(NotImplementedError, match="does not divide"):
            sh.local_block("layer_stacks/0/attn/wq", (2, 32, 32))
