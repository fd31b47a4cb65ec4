"""The compile warm-up (``train/warmup``, ``train/exec_cache``,
``analysis/signatures``) against the JAX package's, on host-side calls
only (no JAX compile: the reference's parameters and caches are abstract):

  - the universe enumeration, ``contains``, ``step_signatures`` and the
    warm-up list's order equal the reference's;
  - the keys a pre-warmed plan stream fills: the same signatures and the
    same number of distinct keys per variant as the reference's, and a
    bare signature's synthesized keys are the real ones;
  - a pre-warmed stream trains with 0 retraces and grads, scalars and
    updates ``torch.equal`` to the uncached engine's;
  - an out-of-universe signature warns and runs;
  - the kept build directory across fresh processes (a stub ``nvcc``);
  - the launchers' flags.
"""
import collections
import json
import logging
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.analysis import signatures as jsig  # noqa: E402
from repro.core import plan_cost as jcost  # noqa: E402
from repro.data.loader import LoaderConfig as JLoaderConfig  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.train import exec_cache as jexec  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import planner as jplanner  # noqa: E402
from repro.train import warmup as jwarmup  # noqa: E402
from repro_torch.analysis import signatures as tsig  # noqa: E402
from repro_torch.bridge import config_from_jax  # noqa: E402
from repro_torch.core import plan_cost as tcost  # noqa: E402
from repro_torch.data.loader import LoaderConfig  # noqa: E402
from repro_torch.device import map_tree, tree_leaves  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.kernels import tree_attention_bwd as tab  # noqa: E402
from repro_torch.launch import rl_loop  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.train import warmup as twarmup  # noqa: E402
from repro_torch.train.engine import TreeTrainEngine  # noqa: E402
from repro_torch.train.exec_cache import (ExecutableCache,  # noqa: E402
                                          abstractify, arg_fingerprint,
                                          exec_key)
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.planner import PlannerConfig, plan_stream, plans  # noqa: E402
from test_torch_waves import _one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]

# the reference's tests/test_warmup.py::_lc stream
LC = dict(seq_len=64, batch_rows=2, trees_per_batch=2, mode="tree",
          kind="agentic", seed=11, auto_partition=True, capacity=32,
          gen_kwargs=dict(turn_len_range=(6, 14), num_turns=2))

# (LoaderConfig overrides, PlannerConfig overrides, caps)
UNIVERSES = {
    "lc_s64": (dict(), dict(), (16, 2, 16, 2)),
    "rows3_maxrows5": (dict(seq_len=128, batch_rows=3, capacity=48),
                       dict(max_rows=5), (64, 4, 32, 4)),
    "replicas2_default_caps": (dict(seq_len=256, batch_rows=4,
                                    capacity=None),
                               dict(num_replicas=2),
                               twarmup.DEFAULT_CAPS),
}


def _configs(lc_kw=None, pc_kw=None):
    kw = {**LC, **(lc_kw or {})}
    return (JLoaderConfig(**kw), jplanner.PlannerConfig(**(pc_kw or {})),
            LoaderConfig(**kw), PlannerConfig(**(pc_kw or {})))


def _universes(jlc, jpc, tlc, tpc):
    def make(mod, lc, pc):
        return mod.SignatureUniverse(
            seq_len=lc.seq_len, batch_rows=lc.batch_rows,
            num_replicas=pc.num_replicas,
            max_rows=pc.max_rows if pc.max_rows is not None
            else lc.batch_rows, capacity=lc.capacity or lc.seq_len)
    return make(jsig, jlc, jpc), make(tsig, tlc, tpc)


@pytest.mark.parametrize("name", list(UNIVERSES))
def test_universe_signatures_match_reference_and_enumeration(name):
    """The warm-up list (``universe_signatures``) equals the reference's
    list in order, and equals the port's independent
    ``SignatureUniverse.enumerate_signatures``; every entry is in the
    universe and the list fits ``count``."""
    lc_kw, pc_kw, caps = UNIVERSES[name]
    jlc, jpc, tlc, tpc = _configs(lc_kw, pc_kw)
    _, tu = _universes(jlc, jpc, tlc, tpc)
    warm = twarmup.universe_signatures(tlc, tpc, caps)
    assert warm == jwarmup.universe_signatures(jlc, jpc, caps)
    enum = tu.enumerate_signatures(*caps)
    assert set(warm) == set(enum) and len(warm) == len(set(warm))
    assert all(tu.contains(s) == (True, "") for s in warm)
    assert len(enum) <= tu.count(*caps)


def test_contains_verdicts_and_reasons_match_reference():
    """``contains`` on a sweep of in-universe signatures and of each way
    out of it: the same (verdict, reason) as the reference's."""
    jlc, jpc, tlc, tpc = _configs(dict(seq_len=128, batch_rows=3,
                                       capacity=48), dict(max_rows=5))
    ju, tu = _universes(jlc, jpc, tlc, tpc)
    S = tlc.seq_len
    sigs = list(tu.enumerate_signatures(16, 2, 16, 2))
    sigs += [("packed", 2, S), ("packed", 3, 64), ("wave", 3, S, 8, 1, 8, 1),
             ("wave", 16, S, 8, 1, 8, 1), ("wave", 2, 64, 8, 1, 8, 1),
             ("wave", 2, S, 4, 1, 8, 1), ("wave", 2, S, 12, 1, 8, 1),
             ("wave", 2, S, 8, 3, 8, 1), ("wave", 2, S, 8, 1, 6, 1),
             ("wave", 2, S, 8, 1, 128, 1), ("wave", 2, S, 8, 2, 8, 3),
             ("mystery", 1)]
    verdicts = [tu.contains(s) for s in sigs]
    assert verdicts == [ju.contains(s) for s in sigs]
    assert sum(ok for ok, _ in verdicts) == len(sigs) - 12


def _reference_prewarm_keys(jcfg, jlc, jpc, n_steps):
    """The keys the reference's ``prewarm(step=)`` fills on its own stream,
    with abstract parameters and a cache that records keys instead of
    compiling (``jax.eval_shape`` traces only)."""
    class KeysOnly(jexec.ExecutableCache):
        def compile_once(self, key, fn, args):
            return fn, self.put(key, fn)

    params_a = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.key(0)))
    svc = jwarmup.AOTWarmupService(jcfg, jlc, jpc, params=params_a,
                                   opt_cfg=jopt.OptimizerConfig(),
                                   cache=KeysOnly())
    steps = list(jplanner.plan_stream(jcfg, jlc, n_steps, jpc))
    for ps in steps:
        svc.prewarm(step=ps)
    return steps, svc.cache


@pytest.mark.parametrize("family", ["dense", "ssm_rwkv6"])
def test_prewarmed_keys_match_reference(family):
    """On the reference's warm-up stream: ``step_signatures`` per step, the
    set of prewarmed signatures and the number of distinct keys per
    variant equal the reference's (the port fingerprints a wave from its
    host columns, the reference from its abstract gateway); a bare
    signature's synthesized keys are exactly the keys a real plan fills."""
    jcfg = tiny_cfg(family)
    cfg = config_from_jax(jcfg)
    jlc, jpc, tlc, tpc = _configs()
    jsteps, jcache = _reference_prewarm_keys(jcfg, jlc, jpc, 2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    svc = twarmup.AOTWarmupService(cfg, tlc, tpc, params=params,
                                   opt_cfg=OptimizerConfig())
    steps = list(plan_stream(cfg, tlc, 2, tpc))
    assert [tsig.step_signatures(ps) for ps in steps] == \
        [jsig.step_signatures(ps) for ps in jsteps]
    for ps in steps:
        svc.prewarm(step=ps)
    assert svc.cache.signatures() == jcache.signatures()
    count = lambda keys: collections.Counter(k[0] for k in keys)  # noqa
    assert count(svc.cache._store) == count(jcache._store)
    assert svc.prewarmed == len(svc.cache) and not svc.errors
    synth = ExecutableCache()
    bare = twarmup.AOTWarmupService(cfg, tlc, tpc, params=params,
                                    opt_cfg=OptimizerConfig(), cache=synth)
    for sig in svc.cache.signatures():
        bare.warm_signature(sig)
    assert set(svc.cache._store) <= set(synth._store)


def test_signature_list_order_matches_reference():
    """Packed first, then wave buckets by descending simulated hit
    frequency, smaller first on ties — the reference's order under the
    same ``CompileCacheSim.freq``; the budget keeps the hottest."""
    jcfg = tiny_cfg("dense")
    cfg = config_from_jax(jcfg)
    jlc, jpc, tlc, tpc = _configs()
    S = tlc.seq_len
    hot, cold = (tcost.wave_signature(2, S, 8, 1, 8, 1),
                 tcost.wave_signature(2, S, 8, 2, 8, 1))
    jsim, tsim = jcost.CompileCacheSim(), tcost.CompileCacheSim()
    for sim in (jsim, tsim):
        for _ in range(5):
            sim.commit([hot])
        sim.commit([cold, tcost.wave_signature(2, S, 16, 1, 4, 1)])
    params_a = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.key(0)))
    jsvc = jwarmup.AOTWarmupService(jcfg, jlc, jpc, params=params_a,
                                    sim=jsim, caps=(16, 2, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tsvc = twarmup.AOTWarmupService(cfg, tlc, tpc, params=params, sim=tsim,
                                    caps=(16, 2, 16, 2))
    sigs = tsvc.signature_list()
    assert sigs == jsvc.signature_list()
    waves = [s for s in sigs if s[0] == "wave"]
    assert sigs[0][0] == "packed" and waves.index(hot) < waves.index(cold)
    tsvc.max_compiles = 4
    assert tsvc._budgeted(sigs) == [sigs[0], hot]


def test_fingerprints_follow_shapes_not_values():
    """Tensors and arrays fingerprint by (shape, dtype) — a host column
    and its device tensor alike — Python scalars by type; a new shape, a
    new dtype or a new layout is a new key."""
    sig = tcost.packed_signature(2, 64)
    a = {"tokens": np.zeros((2, 64), np.int32), "num_trees": 3}
    b = {"tokens": np.ones((2, 64), np.int32), "num_trees": 7}
    c = {"tokens": np.zeros((2, 128), np.int32), "num_trees": 3}
    d = {"tokens": np.zeros((2, 64), np.int64), "num_trees": 3}
    e = {"tokens": torch.full((2, 64), 5, dtype=torch.int32),
         "num_trees": 1}
    key = lambda x: exec_key("packed", sig, (x,))  # noqa: E731
    assert key(a) == key(b) == key(e) == key(abstractify(a))
    assert key(a) != key(c) and key(a) != key(d)
    assert key(a) != exec_key("packed+acc", sig, (a,))
    assert arg_fingerprint(({"x": a},)) != arg_fingerprint((a,))
    assert abstractify(a)["tokens"].device.type == "meta"


def test_executable_cache_compile_once_under_threads():
    """Eight threads fill one key at once (a short switch interval): one
    insert, every thread gets the same executable, every miss counted."""
    cache = ExecutableCache()
    made, out = [], []
    start = threading.Barrier(8)

    def work():
        start.wait()
        fn, _ = cache.compile_once(("k",), lambda: made.append(1) or len)
        out.append(fn)
        cache.get(("other",))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(out) == 8 and all(f is len for f in out)
    st = cache.stats()
    assert st["size"] == st["inserts"] == 1 and st["misses"] == 8
    assert 1 <= len(made) <= 8


@pytest.mark.parametrize("family", ["dense", "ssm_rwkv6"])
def test_prewarmed_stream_zero_retraces_equal_grads(family):
    """``plans(..., warmup=svc)``: every step's signatures are in the cache
    before the engine consumes the step, the engine takes 0 retraces and
    0 exposed compile wait, and the grads, scalars and updated parameters
    are ``torch.equal`` to an engine without the cache."""
    cfg = config_from_jax(tiny_cfg(family))
    _, _, tlc, tpc = _configs()
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    svc = twarmup.AOTWarmupService(cfg, tlc, tpc, params=params,
                                   opt_cfg=opt_cfg,
                                   sim=tcost.CompileCacheSim())
    eng = TreeTrainEngine(cfg, opt_cfg, exec_cache=svc.cache,
                          universe=svc.universe)
    ref = TreeTrainEngine(cfg, opt_cfg)
    pa, oa = map_tree(torch.clone, params), init_opt_state(params)
    pb, ob = map_tree(torch.clone, params), init_opt_state(params)
    steps = 0
    for ps in plans(cfg, tlc, 2, tpc, warmup=svc):
        plan = ps.execution_plan()
        missing = set(tsig.step_signatures(ps)) - svc.cache.signatures()
        assert not missing, f"not prewarmed: {missing}"
        ga, sa = eng.accumulate(params, plan)
        gb, sb = ref.accumulate(params, plan)
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(ga), tree_leaves(gb)))
        assert torch.equal(sa, sb)
        pa, oa, ma = eng.step(pa, oa, plan)
        pb, ob, mb = ref.step(pb, ob, plan)
        assert ma == mb
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(pa), tree_leaves(pb)))
        steps += 1
    assert steps == 2 and eng.host_syncs == 2
    assert eng.retraces == 0 and eng.compile_wait_s == 0.0
    assert not svc.errors and svc.prewarmed == len(svc.cache) > 0
    assert sum(svc.sim.freq.values()) > 0


def test_out_of_universe_signature_warns_not_crashes(caplog):
    """A signature outside the universe is made on the synchronous slow
    path, counted as a retrace, with a logged warning naming why — and the
    step's results are finite."""
    cfg = config_from_jax(tiny_cfg("dense"))
    lc = LoaderConfig(**{**LC, "auto_partition": False, "capacity": None,
                         "gen_kwargs": dict(turn_len_range=(4, 8),
                                            num_turns=1)})
    universe = tsig.SignatureUniverse(seq_len=lc.seq_len, batch_rows=1,
                                      num_replicas=1, max_rows=1, capacity=1)
    assert not universe.contains(tcost.packed_signature(2, lc.seq_len))[0]
    eng = TreeTrainEngine(cfg, exec_cache=ExecutableCache(),
                          universe=universe)
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    ps = next(iter(plans(cfg, lc, 1)))
    with caplog.at_level(logging.WARNING, logger="repro_torch.train.engine"):
        grads, scal = eng.accumulate(params, ps.execution_plan())
    assert eng.retraces == 1
    assert any("out-of-universe" in r.message for r in caplog.records)
    assert torch.isfinite(scal).all()
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))


STUB_NVCC = """#!{python}
import pathlib, sys
out = sys.argv[sys.argv.index("-o") + 1]
pathlib.Path(out).write_bytes(b"lib")
"""


def test_persist_probe_builds_once_into_its_directory(tmp_path):
    """Two fresh processes run ``--persist-probe DIR --device cpu`` with a
    stub ``nvcc`` reached through ``CUDA_HOME``: the first builds the three
    libraries into DIR (and nothing into ``kernels/_build``), the second
    writes 0 new files; both prewarm with 0 retraces and train the same
    finite loss."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    stub = cuda / "bin" / "nvcc"
    stub.write_text(STUB_NVCC.format(python=sys.executable))
    stub.chmod(0o755)
    cache_dir = tmp_path / "kernels"
    default = build.BUILD_DIR
    before = sorted(default.iterdir()) if default.exists() else []
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_HOME": str(cuda)}
    outs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-m", "repro_torch.train.warmup",
                            "--persist-probe", str(cache_dir), "--device",
                            "cpu"], env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    libs = sorted(p.name for p in cache_dir.glob("*.so"))
    assert len(libs) == 3 and outs[0]["new_cache_files"] >= 3
    assert outs[1]["new_cache_files"] == 0
    assert all(o["retraces"] == 0 and o["aot_executables"] > 0
               for o in outs)
    assert outs[0]["loss"] == outs[1]["loss"] and np.isfinite(outs[0]["loss"])
    assert (sorted(default.iterdir()) if default.exists() else []) == before


def test_set_build_dir_moves_library_path(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    d = twarmup.configure_compile_cache(str(tmp_path / "x" / "y"))
    assert Path(d).is_dir() and Path(d).is_absolute()
    for src in (ta.SOURCE, *tab.SOURCES):
        assert build.library_path(src).parent == Path(d)
    assert twarmup.compile_cache_files(d) == 0


def _step_lines(out: str) -> list:
    """The launcher's per-step lines without their times."""
    return [re.sub(r"\s*[\d.]+ms$", "", line) for line in out.splitlines()
            if line.startswith("step ")]


def test_train_launcher_aot_warmup_same_losses(capsys, monkeypatch):
    """``--aot-warmup --warmup-threads 2`` on the partitioned CPU smoke run
    ends with 0 engine retraces, and prints the same losses as the run
    without it."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    base = ["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu",
            "--auto-partition", "--capacity", "256", "--seq-len", "512",
            "--steps", "2", "--trees", "2"]
    train_main(base)
    plain = capsys.readouterr().out
    train_main(base + ["--aot-warmup", "--warmup-threads", "2"])
    warm = capsys.readouterr().out
    assert len(_step_lines(plain)) == 2
    assert _step_lines(warm) == _step_lines(plain)
    line = [x for x in warm.splitlines() if "aot-warmup:" in x]
    assert len(line) == 1 and "engine retraces 0," in line[0], warm


def test_rl_loop_compile_cache_dir_runs(tmp_path, monkeypatch):
    """``rl_loop --compile-cache-dir DIR`` on the CPU: the build directory
    is DIR, and the loop runs on the warm-up's executables and decode
    graphs (the CPU stand-ins) with 0 retraces and 0 captures in it."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    d = tmp_path / "cc"
    res = rl_loop.main(["--arch", "qwen1p5_0p5b", "--smoke", "--device",
                        "cpu", "--steps", "2", "--compile-cache-dir",
                        str(d)])
    assert build.BUILD_DIR == d.resolve() and d.is_dir()
    assert res["retraces"] == 0 and res["captures_in_loop"] == 0
    assert res["captures_before"] == 1 and res["reuses"] == 4
    assert res["prewarmed"] > 0 and res["dropped"] == 0
