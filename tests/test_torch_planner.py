"""The plan-ahead scheduler: the port's ``train/planner.py``,
``core/plan_cost.py`` and ``core/forest.py`` against the originals.  For
the same seeds the port's plans are the reference's: fits, rows,
oversized trees, drops, the resolved capacity, the cost, the packed rows
and every partition wave — in tree and baseline modes, routing on and
off, lookahead 1 and 3, grafting on and off and auto capacity.  Grafting
itself (groups, λ, saved tokens) is held the same way, and a grafted,
partition-routed schedule trains to the gradients of independent per-tree
training within the port."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.core import forest as jforest  # noqa: E402
from repro.core import plan_cost as jcost  # noqa: E402
from repro.core import tree as jtree  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.train import planner as jplanner  # noqa: E402
from repro_torch.bridge import config_from_jax  # noqa: E402
from repro_torch.core import forest as tforest  # noqa: E402
from repro_torch.core import plan_cost as tcost  # noqa: E402
from repro_torch.core import tree as ttree  # noqa: E402
from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models.model import init_params, prepare_batch  # noqa: E402
from repro_torch.train import planner as tplanner  # noqa: E402
from repro_torch.train.engine import TreeTrainEngine  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

TB_FIELDS = ("tokens", "pos_ids", "kv_last", "weight", "prev_idx", "valid",
             "row_trees")
AGENTIC = dict(turn_len_range=(4, 20), num_turns=3)
TEMPLATE = dict(num_templates=2, template_len=40, num_turns=2,
                turn_len_range=(4, 16))

# name → (LoaderConfig overrides, PlannerConfig overrides)
CASES = {
    "tree_route_la1": (dict(auto_partition=True, capacity=48), {}),
    "tree_noroute_la3": (dict(), dict(lookahead=3)),
    "tree_route_la3": (dict(auto_partition=True, capacity=48),
                       dict(lookahead=3)),
    "baseline_la1": (dict(mode="baseline"), {}),
    "baseline_la3": (dict(mode="baseline"), dict(lookahead=3)),
    "auto_capacity_la3": (dict(auto_partition=True, auto_capacity=True),
                          dict(lookahead=3)),
    "graft_route_la3": (dict(auto_partition=True, capacity=48,
                             kind="template", gen_kwargs=TEMPLATE),
                        dict(lookahead=3, graft=True, min_graft=8)),
    "graft_noroute_la1": (dict(kind="template", gen_kwargs=TEMPLATE),
                          dict(graft=True, min_graft=8)),
    "rl_route_la3": (dict(auto_partition=True, capacity=48, kind="grpo",
                          loss_mode="rl"), dict(lookahead=3)),
}


def _configs(case, seq_len=96):
    lkw, pkw = CASES[case]
    kw = dict(seq_len=seq_len, batch_rows=2, trees_per_batch=4, seed=3,
              kind="agentic", gen_kwargs=AGENTIC)
    kw.update(lkw)
    return (jloader.LoaderConfig(**kw), tloader.LoaderConfig(**kw),
            jplanner.PlannerConfig(**pkw), tplanner.PlannerConfig(**pkw))


def _same(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _summary(ps):
    return dict(index=ps.index, rows=ps.rows, dropped=ps.dropped,
                capacity=ps.capacity, num_trees=ps.num_trees,
                cost=None if ps.cost is None else dataclasses.asdict(ps.cost),
                fits=[(f.n_unique, f.src, f.n_src, f.ser.n) for f in ps.fits],
                oversized=[(o.src, o.n_src, o.tree.num_unique_tokens())
                           for o in ps.oversized])


def _same_steps(jsteps, tsteps):
    assert len(jsteps) == len(tsteps) > 0
    for a, b in zip(jsteps, tsteps):
        assert _summary(a) == _summary(b)
        for fa, fb in zip(a.fits, b.fits):
            for f in ("tokens", "weight", "kv_last", "prev_idx", "pos_ids"):
                _same(getattr(fa.ser, f), getattr(fb.ser, f), f)
        sa, sb = a.step_batch(), b.step_batch()
        assert (sa.tb is None) == (sb.tb is None)
        assert (sa.dropped, sa.num_trees) == (sb.dropped, sb.num_trees)
        if sa.tb is not None:
            for f in TB_FIELDS:
                _same(getattr(sa.tb, f), getattr(sb.tb, f), f)
            assert sa.tb.num_trees == sb.tb.num_trees
            assert int(sa.inputs["num_trees"]) == sb.inputs["num_trees"]
        pa, pb = a.execution_plan(), b.execution_plan()
        assert (pa.num_trees, pa.dropped, pa.num_oversized,
                pa.unique_tokens, pa.padded_tokens, pa.num_executions) == \
            (pb.num_trees, pb.dropped, pb.num_oversized, pb.unique_tokens,
             pb.padded_tokens, pb.num_executions)
        assert (pa.partition is None) == (pb.partition is None)
        if pa.partition is not None:
            assert pa.partition.info == pb.partition.info
            for wa, wb in zip(pa.partition.waves, pb.partition.waves,
                              strict=True):
                for k in wa.batch:
                    _same(wa.batch[k], wb.batch[k], k)
                assert (wa.slot_rows, wa.A_real, wa.anc_A_max) == \
                    (wb.slot_rows, wb.A_real, wb.anc_A_max)
                assert [vars(r) for r in wa.parents] == \
                    [vars(r) for r in wb.parents]


@pytest.mark.parametrize("case", list(CASES))
def test_plan_stream_matches_jax(case):
    jcfg = tiny_cfg("dense")
    jlc, tlc, jpc, tpc = _configs(case)
    jsteps = list(jplanner.plan_stream(jcfg, jlc, 6, jpc))
    tsteps = list(tplanner.plan_stream(config_from_jax(jcfg), tlc, 6, tpc))
    _same_steps(jsteps, tsteps)
    if "route" in case and "noroute" not in case:
        assert any(ps.oversized for ps in tsteps)
        assert all(ps.dropped == 0 for ps in tsteps)
    if case == "auto_capacity_la3":
        assert all(96 % ps.capacity == 0 for ps in tsteps)
    if case.startswith("graft"):
        assert any(f.n_src > 1 for ps in tsteps for f in ps.fits) or \
            any(o.n_src > 1 for ps in tsteps for o in ps.oversized)


def test_plan_window_with_replicas_matches_jax():
    """Replica balancing (row multiples, snake-dealt rows, wave rows
    rounded) on one window of a live source, built by plan_window."""
    jcfg = tiny_cfg("dense")
    kw = dict(seq_len=64, batch_rows=3, trees_per_batch=4,
              auto_partition=True, capacity=48)
    window = [dict(seg_len_range=(2, 9), max_depth=4, vocab_size=89)] * 3
    jw = [jsyn.trees_for_batch(70 + b, n_trees=4, kind="random", **g)
          for b, g in enumerate(window)]
    tw = [tsyn.trees_for_batch(70 + b, n_trees=4, kind="random", **g)
          for b, g in enumerate(window)]
    _same_steps(
        jplanner.plan_window(jcfg, jloader.LoaderConfig(**kw),
                             jplanner.PlannerConfig(lookahead=3,
                                                    num_replicas=2), jw),
        tplanner.plan_window(config_from_jax(jcfg),
                             tloader.LoaderConfig(**kw),
                             tplanner.PlannerConfig(lookahead=3,
                                                    num_replicas=2), tw))


@pytest.mark.parametrize("workers", [0, 1, 2])
def test_plans_pipeline_yields_the_plan_stream(workers):
    """``plans`` (the PlanPipeline over plan_stream) yields the stream's
    steps in order with their plans pre-built, and accounts its time."""
    tcfg = config_from_jax(tiny_cfg("dense"))
    _, tlc, _, tpc = _configs("tree_route_la3")
    tpc = dataclasses.replace(tpc, plan_workers=workers)
    want = [_summary(ps) for ps in tplanner.plan_stream(tcfg, tlc, 6, tpc)]
    pipe = tplanner.plans(tcfg, tlc, 6, tpc)
    got = []
    for ps in pipe:
        assert ps._plan is not None           # built before consumption
        got.append(_summary(ps))
    assert got == want and pipe.built == len(want)
    assert pipe.build_s >= 0 and pipe.exposed_s >= 0
    feats = tplanner.planned_step_features(
        next(iter(tplanner.plan_stream(tcfg, tlc, 6, tpc))))
    assert feats["num_waves"] >= 1 and feats["signatures"]
    plans = list(tplanner.plan_pipeline(tcfg, tlc, 6, tpc))
    assert [p.num_trees for p in plans] == [s["num_trees"] for s in want]


@pytest.mark.parametrize("loss_mode", ["sep_avg", "uniform", "rl"])
def test_graft_trees_matches_jax(loss_mode):
    """Groups, saved and shared tokens, and the grafted forests'
    serializations under their λ maps (summed on the shared spine,
    bit-exact elsewhere)."""
    for seed in range(3):
        jt = jsyn.trees_for_batch(seed, n_trees=8, kind="template",
                                  vocab_size=500, **TEMPLATE)
        tt = tsyn.trees_for_batch(seed, n_trees=8, kind="template",
                                  vocab_size=500, **TEMPLATE)
        if loss_mode == "rl":
            for a, b in zip(jt, tt):
                r = np.random.default_rng(seed).normal(size=a.num_leaves())
                jsyn.assign_branch_advantages(a, r)
                tsyn.assign_branch_advantages(b, r)
        jg, jp = jforest.graft_trees(jt, loss_mode=loss_mode, min_graft=8)
        tg, tp = tforest.graft_trees(tt, loss_mode=loss_mode, min_graft=8)
        assert jp == tp and len(jg) == len(tg) > 0
        for a, b in zip(jg, tg):
            assert (a.srcs, a.saved_tokens, a.shared_tokens) == \
                (b.srcs, b.saved_tokens, b.shared_tokens)
            sa = jtree.serialize_tree(a.tree, lam_map=a.lam_map)
            sb = ttree.serialize_tree(b.tree, lam_map=b.lam_map)
            for f in ("tokens", "weight", "kv_last", "prev_idx", "pos_ids"):
                _same(getattr(sa, f), getattr(sb, f), f)


def test_plan_cost_matches_jax():
    rng = np.random.default_rng(0)
    rows = [list(rng.integers(1, 60, rng.integers(0, 4))) for _ in range(6)]
    sigs = [jcost.packed_signature(6, 128), jcost.wave_signature(2, 128, 64,
                                                                 2, 32, 2)]
    jc, tc = jcost.CompileCacheSim(), tcost.CompileCacheSim()
    for _ in range(2):
        assert dataclasses.asdict(jcost.score_packing(
            rows, 128, signatures=sigs, cache=jc)) == dataclasses.asdict(
            tcost.score_packing(rows, 128, signatures=sigs, cache=tc))
        jc.commit(sigs)
        tc.commit(sigs)
    assert jcost.est_block_skip(rows, 128, 64) == \
        tcost.est_block_skip(rows, 128, 64)
    loads = list(rng.integers(0, 100, 12))
    for R in (1, 2, 3, 4):
        assert jcost.balanced_row_order(loads, R) == \
            tcost.balanced_row_order(loads, R)
    for args in ((900, 700, 512, 256), (900, 400, 512, 256),
                 (3000, 2500, 512, 256)):
        assert jcost.graft_gain(*args) == tcost.graft_gain(*args)
        assert jcost.graft_gain(*args, parts=9) == \
            tcost.graft_gain(*args, parts=9)
    assert [jcost.pow2(n, lo=8) for n in (1, 9, 300)] == \
        [tcost.pow2(n, lo=8) for n in (1, 9, 300)]


@pytest.mark.parametrize("kind", ["chain", "por", "template"])
def test_dataset_por_and_generators_match_jax(kind):
    kw = {"chain": dict(length=4), "por": dict(target_por=0.6),
          "template": TEMPLATE}[kind]
    jt = jsyn.trees_for_batch(5, n_trees=4, kind=kind, **kw)
    tt = tsyn.trees_for_batch(5, n_trees=4, kind=kind, **kw)
    assert jloader.dataset_por(jt) == tloader.dataset_por(tt)
    for a, b in zip(jt, tt):
        _same(jtree.serialize_tree(a).tokens, ttree.serialize_tree(b).tokens)
    ja = list(jsyn.template_stream(2, num_batches=2, trees_per_batch=3,
                                   **TEMPLATE))
    ta = list(tsyn.template_stream(2, num_batches=2, trees_per_batch=3,
                                   **TEMPLATE))
    for ba, bb in zip(ja, ta, strict=True):
        for a, b in zip(ba, bb, strict=True):
            _same(jtree.serialize_tree(a).tokens,
                  ttree.serialize_tree(b).tokens)


def test_grafted_schedule_matches_independent_per_tree_grads():
    """A grafted, partition-routed schedule (lookahead 4, template trees
    whose forests outgrow a row) against every tree trained alone in its
    own row, within the port: the tree-count-weighted loss and grads
    agree to 1e-6 (tests/test_forest.py:232-255's bar)."""
    tcfg = config_from_jax(tiny_cfg("dense"))
    params = init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    lc = tloader.LoaderConfig(
        seq_len=144, batch_rows=3, trees_per_batch=6, kind="template",
        seed=3, loss_mode="rl", auto_partition=True,
        gen_kwargs=dict(num_templates=2, template_len=96, num_turns=1,
                        turn_len_range=(4, 12)))
    eng = TreeTrainEngine(tcfg, impl="ref")
    n_tot, l_tot, g_tot, grafted, waves = 0, 0.0, None, 0, 0
    for ps in tplanner.plan_stream(tcfg, lc, 4, tplanner.PlannerConfig(
            lookahead=4, graft=True, min_graft=8)):
        plan = ps.execution_plan()
        grafted += sum(f.n_src > 1 for f in ps.fits) + \
            sum(o.n_src > 1 for o in ps.oversized)
        waves += plan.has_waves
        g, scal = eng.accumulate(params, plan)
        n = plan.num_trees
        l_tot += n * float(scal[0])
        g = [n * x.double() for x in _leaves(g)]
        g_tot = g if g_tot is None else [a + b for a, b in zip(g_tot, g)]
        n_tot += n
    assert grafted and waves
    ref_l, ref_g, n_ref = 0.0, None, 0
    for batch in tloader.tree_stream(tcfg, lc, 4):
        for t in batch:
            ser = ttree.serialize_tree(t, loss_mode="rl")
            b = prepare_batch(tcfg, pack_trees([ser], lc.seq_len),
                              num_trees=1, device="cpu")
            loss, _, grads = value_and_grad(tcfg, params, b, "ref")
            ref_l += float(loss)
            grads = [x.double() for x in _leaves(grads)]
            ref_g = grads if ref_g is None else \
                [a + b for a, b in zip(ref_g, grads)]
            n_ref += 1
    assert n_tot == n_ref
    assert abs(l_tot / n_tot - ref_l / n_ref) <= 1e-6 * abs(ref_l / n_ref)
    rel = max(float((a / n_tot - b / n_ref).abs().max()
                    / ((b / n_ref).abs().max() + 1e-12))
              for a, b in zip(g_tot, ref_g))
    assert rel <= 1e-6, rel


def _leaves(tree):
    from repro_torch.device import tree_leaves
    return tree_leaves(tree)
