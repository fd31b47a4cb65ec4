"""Tree Packing over partitions, device side: the port's wave executor
(``train/engine.run_partition_plan`` behind
``core/gateway.packed_partitioned_value_and_grad``) and its recursive
driver against the reference's, on bridged weights and the same seeded
trees, at f32: loss within 2e-5 relative, grads max-rel < 1e-4
(tests/test_wave_driver.py:56-107's bar).  Dense GQA with a wave row cap
of 2, MoE with the aux losses off and C ≥ N, the port's waves against its
own whole-tree grads, the recursive driver against the wave driver, the
gateway assembly and cotangent routing as an adjoint pair, and one engine
step on a mixed plan (packed rows + waves) against the reference engine's
step with one host sync.  The port runs ``impl="kernel"`` (the kernels'
plain versions on the CPU, ancestors and ``q_off`` included); the
reference runs its plain ``ref`` attention."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.core import gateway as jgw  # noqa: E402
from repro.core.packing import pack_trees as jpack_trees  # noqa: E402
from repro.core.tree import serialize_tree as jserialize  # noqa: E402
from repro.data.synthetic import random_tree as jrandom_tree  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import engine as jengine  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import gateway as tgw  # noqa: E402
from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import random_tree  # noqa: E402
from repro_torch.device import map_tree, tree_leaves  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import engine as tengine  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402


def _tree_seed(seed=0, lo=60, hi=120):
    """The seed of the first branching random tree with lo..hi tokens
    (tests/test_wave_driver.py's ``get_tree``)."""
    for s in range(seed, seed + 300):
        t = random_tree(np.random.default_rng(s), vocab_size=89,
                        max_depth=5, seg_len_range=(3, 9))
        if t.num_leaves() >= 4 and lo <= t.num_unique_tokens() <= hi:
            return s
    raise RuntimeError


def _trees(*specs):
    """Each spec (seed, lo, hi) → the same tree from both packages."""
    seeds = [_tree_seed(*s) for s in specs]
    kw = dict(vocab_size=89, max_depth=5, seg_len_range=(3, 9))
    return ([jrandom_tree(np.random.default_rng(s), **kw) for s in seeds],
            [random_tree(np.random.default_rng(s), **kw) for s in seeds])


THREE = ((0, 60, 120), (40, 60, 120), (80, 30, 70))


def _setup(jcfg, seed=0):
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jp, config_from_jax(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _moe_cfg():
    """MoE with the aux losses off and capacity factor 4 (C = 2N ≥ N):
    only then do waves equal the whole tree (tests/test_forest.py:15-25)."""
    cfg = tiny_cfg("moe")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_weight=0.0, router_z_weight=0.0))


def _max_rel(tl, jl):
    jl = [np.asarray(x, np.float32) for x in jl]
    tl = [x.float().numpy() for x in tl]
    assert len(jl) == len(tl)
    return max(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))
               for a, b in zip(tl, jl))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


@pytest.mark.parametrize("family,max_rows", [("dense", 2), ("moe", 2)])
def test_wave_driver_matches_jax(family, max_rows):
    jcfg = tiny_cfg("dense") if family == "dense" else _moe_cfg()
    jp, tcfg, tp = _setup(jcfg)
    jt, tt = _trees(*THREE)
    jl, jg, jinfo = jgw.packed_partitioned_value_and_grad(
        jcfg, jp, jt, capacity=40, seq_len=48, max_rows=max_rows)
    tl, tg, tinfo = tgw.packed_partitioned_value_and_grad(
        tcfg, tp, tt, capacity=40, seq_len=48, max_rows=max_rows)
    assert tinfo["num_waves"] == jinfo["num_waves"] >= 3
    assert tinfo["num_partitions"] > len(tt)
    if max_rows:
        assert tinfo["max_wave_rows"] <= max_rows
    assert _rel(tl, jl) <= 2e-5
    assert _rel(tinfo["nll_sum"], jinfo["nll_sum"]) <= 2e-5
    assert _rel(tinfo["weight_sum"], jinfo["weight_sum"]) <= 1e-6
    assert _max_rel(tree_leaves(tg), jax.tree.leaves(jg)) < 1e-4


def _whole_tree_sum(tcfg, tp, trees):
    """Σ over trees of (loss, grads) on whole, un-partitioned rows."""
    loss, acc = 0.0, None
    for t in trees:
        ser = serialize_tree(t)
        S = ((ser.n + 31) // 32) * 32
        b = tmodel.prepare_batch(tcfg, pack_trees([ser], S), device="cpu")
        lv, _, g = value_and_grad(tcfg, tp, b, "kernel")
        loss += float(lv)
        g = [x.float() for x in tree_leaves(g)]
        acc = g if acc is None else [a + x for a, x in zip(acc, g)]
    return loss, acc


@pytest.mark.parametrize("family,max_rows", [("dense", 2), ("dense", None),
                                             ("moe", 2)])
def test_waves_match_whole_tree_grads(family, max_rows):
    """Within the port: the partitioned loss sum and grads equal the
    un-partitioned trees', token for token (every token computed once),
    with and without a wave row cap."""
    jcfg = tiny_cfg("dense") if family == "dense" else _moe_cfg()
    _, tcfg, tp = _setup(jcfg)
    _, tt = _trees(*THREE)
    l_ref, g_ref = _whole_tree_sum(tcfg, tp, tt)
    l_w, g_w, info = tgw.packed_partitioned_value_and_grad(
        tcfg, tp, tt, capacity=40, seq_len=48, max_rows=max_rows)
    if max_rows:
        assert info["max_wave_rows"] <= max_rows
    assert info["unique_tokens"] == sum(t.num_unique_tokens() for t in tt)
    assert _rel(l_w, l_ref) <= 2e-5
    assert _max_rel(tree_leaves(g_w), [g.numpy() for g in g_ref]) < 1e-4


def test_recursive_driver_matches_wave_driver():
    """Same trees, same capacity: the depth-first B=1 driver (one tree at
    a time, summed) and the batched wave driver are the same math."""
    _, tcfg, tp = _setup(tiny_cfg("dense"), seed=1)
    _, tt = _trees(*THREE)
    rl, rg, parts = 0.0, None, 0
    for t in tt:
        l1, g1, info = tgw.partitioned_value_and_grad(tcfg, tp, t,
                                                      capacity=24)
        rl, parts = rl + l1, parts + info["num_partitions"]
        g1 = tree_leaves(g1)
        rg = g1 if rg is None else [a + b for a, b in zip(rg, g1)]
    wl, wg, winfo = tgw.packed_partitioned_value_and_grad(
        tcfg, tp, tt, capacity=24, seq_len=24)
    assert winfo["num_partitions"] == parts > 2 * len(tt)
    assert _rel(wl, rl) <= 2e-5
    assert _max_rel(tree_leaves(wg), [g.numpy() for g in rg]) < 1e-4


def test_assemble_child_gw_and_route_child_cot_are_adjoint():
    """⟨assemble(gw, caps), c⟩ == ⟨(gw, caps), route(c)⟩ for random
    tensors, with and without pass-through ancestors — the defining
    property of a correct transpose (tests/test_gateway_units.py:10)."""
    tcfg = config_from_jax(tiny_cfg("dense"))
    g = torch.Generator().manual_seed(0)
    rnd = lambda *sh: torch.randn(*sh, generator=g)
    for A_in, P in ((0, 5), (3, 4), (7, 1)):
        shape = lambda t: (2, 1, t, 2, 4)          # [L, B, T, Kh, hd]
        gw = None if A_in == 0 else {"g0": {"attn": {
            t: rnd(*shape(A_in)) for t in ("k", "v")}}}
        caps = {"g0": {"attn": {"c0": {t: rnd(*shape(P))
                                       for t in ("k", "v")},
                                "c1": {t: rnd(*shape(2))
                                       for t in ("k", "v")}}}}
        child = tgw.assemble_child_gw(tcfg, gw, caps, "c0")
        c = map_tree(lambda a: rnd(*a.shape), child)
        dot = lambda xs, ys: sum(float((a.double() * b.double()).sum())
                                 for a, b in zip(xs, ys))
        lhs = dot(tree_leaves(child), tree_leaves(c))
        cot_gw = None if gw is None else map_tree(torch.zeros_like, gw)
        cot_caps = map_tree(torch.zeros_like, caps)
        cot_gw = tgw.route_child_cot(tcfg, gw, caps, "c0", c, cot_gw,
                                     cot_caps)
        rhs = dot(tree_leaves(caps), tree_leaves(cot_caps))
        if gw is not None:
            rhs += dot(tree_leaves(gw), tree_leaves(cot_gw))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-6)
        assert all(float(x.abs().max()) == 0 for x in
                   tree_leaves(cot_caps["g0"]["attn"]["c1"]))


def _mixed_plans(jcfg, tcfg, jt, tt, fits_j, fits_t):
    """An ExecutionPlan per package: the row-sized trees packed in 2 rows
    of 48, the oversized ones on partition waves (capacity 40, max_rows
    2), normalized over all of them."""
    n = len(jt) + len(fits_j)
    jtb = jpack_trees([jserialize(t) for t in fits_j], 48, batch_size=2)
    ttb = pack_trees([serialize_tree(t) for t in fits_t], 48, batch_size=2)
    jplan = jengine.ExecutionPlan(
        packed=jengine.PackedExec(inputs=jmodel.prepare_batch(jcfg, jtb)),
        partition=jgw.build_partition_plan(jcfg, jt, 40, seq_len=48,
                                           max_rows=2),
        num_trees=n)
    tplan = tengine.ExecutionPlan(
        packed=tengine.PackedExec(inputs=tmodel.batch_arrays(tcfg, ttb),
                                  tokens=int(ttb.valid.sum()),
                                  cells=ttb.tokens.size),
        partition=tgw.build_partition_plan(tcfg, tt, 40, seq_len=48,
                                           max_rows=2),
        num_trees=n)
    return jplan, tplan


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_engine_step_on_a_mixed_plan_matches_jax(family):
    """One ``TreeTrainEngine.step`` over packed rows plus partition waves:
    the loss, nll and grad norm within 2e-5 relative, every updated
    parameter within max-rel 1e-5, exactly one host sync."""
    jcfg = tiny_cfg("dense") if family == "dense" else _moe_cfg()
    jp, tcfg, tp = _setup(jcfg)
    jt, tt = _trees(*THREE)
    jf, tf = _trees((200, 10, 30), (230, 10, 30))
    jplan, tplan = _mixed_plans(jcfg, tcfg, jt, tt, jf, tf)
    assert tplan.has_waves and tplan.packed is not None
    ocfg = dict(warmup_steps=2, total_steps=3)
    je = jengine.TreeTrainEngine(jcfg, jopt.OptimizerConfig(**ocfg),
                                 donate=False)
    te = tengine.TreeTrainEngine(tcfg, topt.OptimizerConfig(**ocfg))
    jnew, _, jm = je.step(jp, jopt.init_opt_state(jp), jplan)
    tnew, _, tm = te.step(tp, topt.init_opt_state(tp), tplan)
    for key in ("loss", "nll", "grad_norm", "weight_sum"):
        assert _rel(tm[key], jm[key]) <= 2e-5, key
    assert te.host_syncs == 1
    assert _max_rel(tree_leaves(tnew), jax.tree.leaves(jnew)) < 1e-5


def test_wave_remat_recomputes_the_captures_bit_identically():
    """The backward sweep's remat pass sees the captures the forward
    sweep handed to the children, bit for bit (on the CPU path)."""
    jcfg = tiny_cfg("dense")
    _, tcfg, tp = _setup(jcfg)
    _, tt = _trees(*THREE)
    plan = tgw.build_partition_plan(tcfg, tt, 40, seq_len=48, max_rows=2)
    wp = next(w for w in plan.waves if w.capspecs and not w.has_gw)
    batch = tgw.to_device(wp.batch, torch.device("cpu"))
    caps = tgw.device_capspecs(wp.capspecs, torch.device("cpu"), 48)
    with torch.no_grad():
        (_, c0), _ = tmodel_partition_loss(tcfg, tp, batch, caps)
    live = map_tree(lambda t: t.detach().requires_grad_(True), tp)
    (_, c1), _ = tmodel_partition_loss(tcfg, live, batch, caps)
    for a, b in zip(tree_leaves(c0), tree_leaves(c1)):
        assert torch.equal(a, b.detach())


def tmodel_partition_loss(tcfg, params, batch, caps):
    from repro_torch.models.transformer import partition_loss
    return partition_loss(tcfg, params, batch, None, caps, "kernel")


def test_wave_engine_plan_through_the_planner_drops_nothing():
    """``plans`` with auto-partition at --capacity 256 on the smoke config
    routes every oversized tree to waves: tokens conserved, 0 dropped,
    every step one host sync on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data.loader import LoaderConfig, tree_stream
    from repro_torch.train.planner import PlannerConfig, plans
    cfg = get_config("qwen1p5_0p5b", smoke=True)
    lc = LoaderConfig(seq_len=512, batch_rows=2, trees_per_batch=6,
                      auto_partition=True, capacity=256,
                      gen_kwargs=dict(turn_len_range=(8, 48), num_turns=4))
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    opt = topt.init_opt_state(params)
    eng = tengine.TreeTrainEngine(cfg, topt.OptimizerConfig())
    got = waves = 0
    for ps in plans(cfg, lc, 2, PlannerConfig(plan_workers=1)):
        plan = ps.execution_plan()
        assert plan.dropped == 0
        waves += plan.has_waves
        got += plan.unique_tokens
        params, opt, m = eng.step(params, opt, plan)
        assert np.isfinite(m["loss"])
    assert waves and eng.host_syncs == eng.steps_done == 2
    assert got == sum(t.num_unique_tokens() for b in tree_stream(cfg, lc, 2)
                      for t in b)
