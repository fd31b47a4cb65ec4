"""The async tree-RL service of the port (``serve/service.py``) and the
weight versions it threads through the planner and the engine: the weight
store's versions and copies, the loop closing with bounded staleness, a
generation error reaching the consumer, ``ExecutionPlan.versions`` against
the JAX package's planner, and an on-policy loop (A = 0: deterministic
versions) against the JAX package's loop step by step, on bridged weights
and the same trees (tests/test_equivalence.py:62's tolerances: loss 1e-5
relative, params 1e-4 max-rel)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.data.loader import LoaderConfig as JLoaderConfig  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.serve import rollout as jrollout  # noqa: E402
from repro.serve import service as jservice  # noqa: E402
from repro.train import engine as jengine  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import planner as jplanner  # noqa: E402
from repro_torch.bridge import (config_from_jax, params_from_jax,  # noqa: E402
                                params_to_numpy)
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.loader import LoaderConfig  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve import rollout as trollout  # noqa: E402
from repro_torch.serve import service as tservice  # noqa: E402
from repro_torch.serve.rollout import RolloutConfig  # noqa: E402
from repro_torch.serve.service import (AsyncTreeRLService,  # noqa: E402
                                       ServiceConfig, WeightStore)
from repro_torch.train.engine import TreeTrainEngine  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.planner import (PlannerConfig, plan_window,  # noqa: E402
                                       plans)
from test_torch_waves import _one_torch_thread  # noqa: E402,F401

RC = RolloutConfig(k=3, prompt_len=6, max_new=4)


def _tiny():
    jcfg = tiny_cfg("dense")
    return jcfg, config_from_jax(jcfg)


def test_weight_store_versions_and_copies():
    params = {"w": torch.arange(4.0)}
    store = WeightStore(params, version=0)
    got, ver = store.get()
    assert ver == 0
    assert got["w"] is not params["w"]           # copied on ingest
    assert torch.equal(got["w"], params["w"])
    assert not store.wait_for(1, timeout=0.05)   # nothing published yet
    new = {"w": torch.ones(4)}
    store.publish(new, version=3)
    assert store.wait_for(1, timeout=0.05)
    got2, ver2 = store.get()
    assert ver2 == 3
    assert got2["w"] is not new["w"]             # publish copies too
    assert torch.equal(got2["w"], torch.ones(4))
    # the trainer updates its tensors in place: the snapshot keeps its
    # values
    new["w"].add_(1.0)
    params["w"].add_(1.0)
    assert torch.equal(store.get()[0]["w"], torch.ones(4))
    assert torch.equal(got["w"], torch.arange(4.0))


def test_async_service_closes_the_loop():
    _, cfg = _tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_state = init_opt_state(params)
    steps = 3
    lc = LoaderConfig(seq_len=64, batch_rows=2, trees_per_batch=2,
                      mode="tree", seed=0, loss_mode="rl",
                      auto_partition=True)
    pcfg = PlannerConfig(lookahead=1, plan_workers=1, max_rows=2)
    sc = ServiceConfig(groups_per_step=2, max_ahead_steps=1, rollout=RC,
                       seed=0, gate_timeout_s=60.0)
    store = WeightStore(params, version=0)
    engine = TreeTrainEngine(cfg, OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                  total_steps=steps),
                             weight_store=store)
    svc = AsyncTreeRLService(cfg, store, sc, num_steps=steps).start()
    pipe = plans(cfg, lc, svc.tree_batches(), pcfg)

    losses, dropped = [], 0
    for ps in pipe:
        plan = ps.execution_plan()
        dropped += plan.dropped
        if plan.is_empty:
            continue
        assert plan.versions is not None         # live trees carry versions
        params, opt_state, m = engine.step(params, opt_state, plan)
        losses.append(m["loss"])
        assert "max_lag" in m
        # the published snapshot is the trainer's new params, copied
        snap, ver = store.get()
        assert ver == engine.steps_done
        for a, b in zip(tree_leaves(snap), tree_leaves(params)):
            assert a is not b and torch.equal(a, b)
    svc.join(10)

    assert not svc._thread.is_alive() and svc._error is None
    assert len(losses) >= 2 and dropped == 0
    assert all(np.isfinite(losses))
    # bounded staleness, audited on BOTH sides of the queue
    bound = sc.max_ahead_steps + pcfg.lookahead - 1
    assert engine.max_lag_seen <= bound
    assert svc.stats.max_gen_lag <= sc.max_ahead_steps
    assert svc.stats.trees_generated == steps * sc.groups_per_step
    # group-level prefix reuse survives aggregation
    assert svc.stats.prefill_tokens == \
        steps * sc.groups_per_step * RC.prompt_len
    assert svc.stats.saved_prefill_tokens == \
        steps * sc.groups_per_step * (RC.k - 1) * RC.prompt_len
    assert engine.host_syncs == len(losses)      # publishing syncs nothing


def test_service_generation_error_reaches_consumer():
    _, cfg = _tiny()
    store = WeightStore({"w": torch.zeros(1)})   # junk params → rollout dies
    sc = ServiceConfig(groups_per_step=1, max_ahead_steps=1, rollout=RC)
    svc = AsyncTreeRLService(cfg, store, sc, num_steps=1).start()
    with pytest.raises(RuntimeError, match="rollout generation failed"):
        for _ in svc.tree_batches():
            pass
    svc.join(10)
    assert not svc._thread.is_alive()


def _tagged_trees(syn, seeds, versions):
    """The same random trees from either package, each tagged with its
    weight version (None: untagged)."""
    trees = []
    for s, v in zip(seeds, versions):
        t = syn.random_tree(np.random.default_rng(s), vocab_size=89,
                            max_depth=5, seg_len_range=(3, 9))
        if v is not None:
            t.weight_version = v
        trees.append(t)
    return trees


def test_plan_versions_match_jax():
    """Trees tagged with weight versions (some untagged, some larger than
    a row so that they partition) through both planners over a lookahead
    window of three batches: equal ``ExecutionPlan.versions`` per step."""
    jcfg, tcfg = _tiny()
    batches = [([0, 1, 2], [0, None, 1]), ([3, 4, 5], [None, None, None]),
               ([6, 7, 8], [2, 2, None])]
    kw = dict(seq_len=48, batch_rows=2, trees_per_batch=3, mode="tree",
              seed=0, loss_mode="rl", auto_partition=True, capacity=24)
    got = {}
    for name, syn, LC, PC, window_fn in (
            ("jax", jsyn, JLoaderConfig, jplanner.PlannerConfig,
             jplanner.plan_window),
            ("torch", tsyn, LoaderConfig, PlannerConfig, plan_window)):
        cfg = jcfg if name == "jax" else tcfg
        window = [_tagged_trees(syn, s, v) for s, v in batches]
        # each batch on its own, then the three in one window
        steps = [ps for b in window
                 for ps in window_fn(cfg, LC(**kw),
                                     PC(lookahead=1, max_rows=2), [b])]
        steps += window_fn(cfg, LC(**kw), PC(lookahead=3, max_rows=2),
                           window)
        got[name] = [(ps.execution_plan().versions,
                      ps.execution_plan().num_oversized) for ps in steps]
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == [((0, 1), 1), (None, 2), ((2, 2), 1)]
    assert any(n > 0 for _, n in got["torch"])              # partitioned
    assert {v for v, _ in got["torch"]} - {None}            # tagged steps


def _fake_rollout(syn, group_stats):
    """``rollout_group`` replaced by one function of (prompt, group index):
    a GRPO tree from that package's generator, the same in both packages
    (greedy rollouts would collapse to one zero-advantage path)."""
    calls = [0]

    def fake(cfg, params, prompt, rc, *args, **kw):
        g = calls[0]
        calls[0] += 1
        rng = np.random.default_rng([g, *(int(x) for x in prompt)])
        tree = syn.grpo_tree(rng, vocab_size=cfg.vocab_size, num_turns=2,
                             turn_len_range=(2, 6), max_parallel_tools=2)
        return tree, group_stats(k=rc.k, prompt_len=rc.prompt_len,
                                 prefill_tokens=rc.prompt_len,
                                 decode_tokens=rc.k * (rc.max_new - 1),
                                 rewards=[0.0] * rc.k)

    return fake


def _run_loop(pkg, cfg, params, opt_state, steps, monkeypatch):
    """One package's service → plans → engine loop, on-policy (A = 0).
    Returns (per-step (loss, max_lag, versions), final params)."""
    if pkg == "jax":
        svc_mod, syn, stats = jservice, jsyn, jrollout.GroupStats
        LC, PC, plans_fn = JLoaderConfig, jplanner.PlannerConfig, \
            jplanner.plans
        opt = jopt.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                   total_steps=steps)
        rc = jrollout.RolloutConfig(k=RC.k, prompt_len=RC.prompt_len,
                                    max_new=RC.max_new)
        make_engine = lambda store: jengine.TreeTrainEngine(
            cfg, opt, impl="ref", weight_store=store)
    else:
        svc_mod, syn, stats = tservice, tsyn, trollout.GroupStats
        LC, PC, plans_fn = LoaderConfig, PlannerConfig, plans
        opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
        rc = RC
        make_engine = lambda store: TreeTrainEngine(cfg, opt,
                                                    weight_store=store)
    monkeypatch.setattr(svc_mod, "rollout_group", _fake_rollout(syn, stats))
    lc = LC(seq_len=128, batch_rows=2, trees_per_batch=2, mode="tree",
            seed=0, loss_mode="rl", auto_partition=True)
    sc = svc_mod.ServiceConfig(groups_per_step=2, max_ahead_steps=0,
                               rollout=rc, seed=0, gate_timeout_s=60.0)
    store = svc_mod.WeightStore(params, version=0)
    engine = make_engine(store)
    svc = svc_mod.AsyncTreeRLService(cfg, store, sc, num_steps=steps).start()
    out = []
    for ps in plans_fn(cfg, lc, svc.tree_batches(),
                       PC(lookahead=1, plan_workers=1, max_rows=2)):
        plan = ps.execution_plan()
        assert plan.dropped == 0 and not plan.is_empty
        params, opt_state, m = engine.step(params, opt_state, plan)
        out.append((m["loss"], m["max_lag"], plan.versions))
    svc.join(10)
    assert svc._error is None and len(out) == steps
    return out, params


def test_on_policy_loop_matches_jax(monkeypatch):
    jcfg, tcfg = _tiny()
    jp = jinit_params(jcfg, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    steps = 3
    jout, jfinal = _run_loop("jax", jcfg, jp, jopt.init_opt_state(jp),
                             steps, monkeypatch)
    tout, tfinal = _run_loop("torch", tcfg, tp, init_opt_state(tp), steps,
                             monkeypatch)
    for s, ((jl, jlag, jv), (tl, tlag, tv)) in enumerate(zip(jout, tout)):
        assert (tlag, tv) == (jlag, jv) == (0, (s, s))
        assert abs(tl - jl) <= 1e-5 * abs(jl), (s, tl, jl)
    flat_j = jax.tree.leaves(jax.tree.map(np.asarray, jfinal))
    flat_t = jax.tree.leaves(params_to_numpy(tfinal))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_t, flat_j):
        denom = max(float(np.abs(b).max()), 1e-12)
        assert float(np.abs(a - b).max()) / denom < 1e-4
