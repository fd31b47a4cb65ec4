"""The port's VLM family (Phi-3-vision 4.2B: a dense decoder whose packed
rows open with a prefix of stub patch embeddings that every tree of the
row sees) against the JAX package, on the same bridged weights and
numpy-seeded inputs, in float32: the config copy field by field with its
parameter count; ``_mm_prefix_meta``; forward, loss and gradients against
the reference at ``impl="pallas"`` (interpret mode) to 1e-4 max-rel
(tests/test_equivalence.py:62); tree ≡ per-branch baseline inside the
port (loss rtol 5e-6, grads 1e-4); the decode session (prefill through
the step loop, fork, steps) at 5e-4 and a greedy ``rollout_group`` at
smoke size; the planner's patch embeddings bit for bit;
``partition_forward``'s refusal; the weight bridge, the ``.npz`` round
trip and the launcher."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.packing import pack_trees as jpack_trees  # noqa: E402
from repro.core.tree import serialize_tree as jserialize  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data.synthetic import trees_for_batch as jtrees  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve.rollout import RolloutConfig as JaxRolloutConfig  # noqa: E402
from repro.serve.rollout import rollout_group as jrollout_group  # noqa: E402
from repro.serve.session import DecodeSession as JaxSession  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import planner as jplanner  # noqa: E402
from repro_torch.bridge import (config_from_jax, params_from_jax,  # noqa: E402
                                params_to_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.packing import pack_linear_paths  # noqa: E402
from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch.data.synthetic import random_tree  # noqa: E402
from repro_torch.data.synthetic import trees_for_batch  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.serve.rollout import RolloutConfig, rollout_group  # noqa: E402
from repro_torch.serve.session import DecodeSession  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import planner as tplanner  # noqa: E402
from repro_torch.train.engine import TreeTrainEngine  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.train_step import value_and_grad  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "phi3_vision_4p2b"
TOL_DECODE = 5e-4


def _setup(jcfg=None, seed=0):
    jcfg = jcfg or tiny_cfg("vlm")
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jcfg, jp, config_from_jax(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _patches(seed, B, cfg):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _close(a, b, tol=TOL_DECODE):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _batches(jcfg, tcfg, seed=2, n=3):
    """Packed rows of S = 256 − F text tokens, so that prefix + text is a
    multiple of 8, as the reference's Pallas blocks need."""
    S = 256 - jcfg.frontend_len
    kw = dict(n_trees=n, kind="random", vocab_size=jcfg.vocab_size)
    jb = jpack_trees([jserialize(t) for t in jtrees(seed, **kw)], S)
    tb = pack_trees([serialize_tree(t) for t in trees_for_batch(seed, **kw)],
                    S)
    ext = _patches(seed, tb.tokens.shape[0], jcfg)
    return (jmodel.prepare_batch(jcfg, jb, ext),
            tmodel.prepare_batch(tcfg, tb, ext, device="cpu"))


def test_config_copy_and_param_layout_match_jax():
    """``config()`` and ``smoke()`` field by field, ``param_count`` (3.822
    B at full size) and the smoke model's parameter tree leaf for leaf in
    shape and dtype; the decoder is dense."""
    for smoke in (False, True):
        tcfg, jcfg = get_config(ARCH, smoke), jget_config(ARCH, smoke)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.param_count() == jcfg.param_count()
    assert round(get_config(ARCH).param_count() / 1e9, 3) == 3.822
    jcfg = jget_config(ARCH, smoke=True)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    tp = tmodel.init_params(config_from_jax(jcfg),
                            torch.Generator().manual_seed(0), device="cpu")
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert tmodel.layer_groups(config_from_jax(jcfg)) == \
        jmodel.layer_groups(jcfg) == [("dense", jcfg.n_layers)]


def test_mm_prefix_meta_matches_jax():
    """The prefix rows' positions, kv_last (every later token of the row
    sees them), prev_idx and validity, and the text columns shifted by F,
    on packed rows with padding."""
    jcfg, _, tcfg, _ = _setup()
    jb, tb = _batches(jcfg, tcfg)
    jm = jtransformer._mm_prefix_meta(jcfg, jb)
    tm = ttransformer._mm_prefix_meta(tb)
    assert jm.pop("prefix_len") == tm.pop("prefix_len") == jcfg.frontend_len
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), k)
        assert tm[k].dtype == (torch.bool if k == "valid" else torch.int32)


def test_row_slice_carries_the_patch_rows_as_jax():
    """``TreeBatch.row_slice``: one row of every column, its own
    ``extra_embeds`` block and its tree count as the loss normalizer."""
    jcfg = tiny_cfg("vlm")
    kw = dict(n_trees=5, kind="random", vocab_size=jcfg.vocab_size)
    jb = jpack_trees([jserialize(t) for t in jtrees(3, **kw)], 256)
    tb = pack_trees([serialize_tree(t) for t in trees_for_batch(3, **kw)],
                    256)
    ext = _patches(3, tb.tokens.shape[0], jcfg)
    jb.extra_embeds, tb.extra_embeds = ext, ext
    assert tb.tokens.shape[0] >= 2
    for b in range(tb.tokens.shape[0]):
        jr, tr = jb.row_slice(b), tb.row_slice(b)
        for f in ("tokens", "pos_ids", "kv_last", "weight", "prev_idx",
                  "valid", "extra_embeds", "row_trees"):
            np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f), f)
        assert tr.num_trees == jr.num_trees >= 1


def test_forward_matches_jax():
    """Text hidden states (the prefix sliced off) at the valid tokens
    against the reference's oracle path."""
    jcfg, jp, tcfg, tp = _setup()
    jb, tb = _batches(jcfg, tcfg)
    jh, _ = jax.jit(lambda p, b: jmodel.forward(jcfg, p, b, "ref"))(jp, jb)
    with torch.no_grad():
        th, _ = tmodel.forward(tcfg, tp, tb, "kernel")
    assert th.shape == jh.shape == tuple(tb["tokens"].shape) + (
        jcfg.d_model,)
    ok = tb["valid"].numpy()
    assert _max_rel(th.numpy()[ok], np.asarray(jh)[ok]) < 1e-4


def test_loss_and_grads_match_jax_pallas():
    """Loss within 1e-5 and every gradient within 1e-4 max-rel of the
    reference's ``impl="pallas"`` (interpret mode) on prefixed rows."""
    jcfg, jp, tcfg, tp = _setup()
    jb, tb = _batches(jcfg, tcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_and_metrics(jcfg, p, b, "pallas"),
        has_aux=True))(jp, jb)
    tl, _, tg = value_and_grad(tcfg, tp, tb, "kernel")
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jl_ = [np.asarray(x, np.float32) for x in jax.tree.leaves(jg)]
    tl_ = [x.float().numpy() for x in tree_leaves(tg)]
    assert len(jl_) == len(tl_)
    assert max(_max_rel(a, b) for a, b in zip(tl_, jl_)) < 1e-4


def test_tree_equals_per_branch_baseline():
    """Eq. 5 with a multimodal prefix: one tree row behind its image and
    the linearized paths, each path row behind the same image, give the
    same loss and gradients."""
    _, _, tcfg, tp = _setup(seed=1)
    tree = next(t for s in range(5, 205)
                for t in [random_tree(np.random.default_rng(s),
                                      vocab_size=89)]
                if t.num_leaves() >= 4 and t.num_unique_tokens() <= 120)
    tb = pack_trees([serialize_tree(tree)], 128)
    lb = pack_linear_paths([tree.linearize_paths()], 128)
    ext = _patches(0, 1, tcfg)
    bt = tmodel.prepare_batch(tcfg, tb, ext, device="cpu")
    bl = tmodel.prepare_batch(tcfg, lb, np.repeat(ext, lb.tokens.shape[0],
                                                  0), device="cpu")
    lt, _, gt = value_and_grad(tcfg, tp, bt, "kernel")
    ll, _, gl = value_and_grad(tcfg, tp, bl, "kernel")
    np.testing.assert_allclose(float(lt), float(ll), rtol=5e-6)
    rel = max(_max_rel(a.numpy(), b.numpy())
              for a, b in zip(tree_leaves(gt), tree_leaves(gl)))
    assert rel < 1e-4, rel


def test_decode_session_matches_jax():
    """The VLM session prefills through the step loop, as the reference's
    does (a frontend config never takes the parallel path): prefill,
    fork(3), four steps and a second prefill against the reference's."""
    jcfg, jp, tcfg, tp = _setup()
    rng = np.random.default_rng(0)
    V = jcfg.vocab_size
    prompt, tool = rng.integers(0, V, 9), rng.integers(0, V, 4)
    steps = rng.integers(0, V, (3, 4))
    js = JaxSession.create(jcfg, jp, buf_len=24)
    ts = DecodeSession.create(tcfg, tp, buf_len=24, device="cpu")
    assert not ts._can_parallel_prefill(9)
    with torch.inference_mode():
        _close(ts.prefill(prompt), js.prefill(prompt))
        jf, tf = js.fork(3), ts.fork(3)
        for i in range(4):
            _close(tf.step(steps[:, i]), jf.step(steps[:, i]))
        _close(tf.prefill(tool), jf.prefill(tool))
    for g, grp in tf.cache.items():
        for leaf, a in grp.items():
            _close(a.float().numpy(), np.asarray(jf.cache[g][leaf],
                                                 np.float32))
    assert tf.t == jf.t == 17


def test_greedy_rollout_group_matches_jax_at_smoke_size():
    jcfg, jp, tcfg, tp = _setup(jget_config(ARCH, smoke=True))
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, 12)
    kw = dict(k=3, prompt_len=12, max_new=6, temperature=0.0)
    jtree, jst = jrollout_group(jcfg, jp, prompt, JaxRolloutConfig(**kw),
                                jax.random.key(1))
    with torch.inference_mode():
        ttree, tst = rollout_group(tcfg, tp, prompt, RolloutConfig(**kw),
                                   device="cpu")
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    a, b = serialize_tree(ttree, loss_mode="rl"), jserialize(
        jtree, loss_mode="rl")
    for f in ("tokens", "pos_ids", "kv_last", "weight", "prev_idx"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _loader_cfgs(**kw):
    kw = dict(dict(seq_len=128, batch_rows=2, trees_per_batch=3, seed=7,
                   kind="agentic",
                   gen_kwargs=dict(turn_len_range=(4, 16), num_turns=3)),
              **kw)
    return jloader.LoaderConfig(**kw), tloader.LoaderConfig(**kw)


@pytest.mark.parametrize("mode", ["tree", "baseline"])
def test_planner_patch_embeddings_equal_jax(mode):
    """Each planned step's stub patch embeddings are the reference
    planner's bit for bit, one [frontend_len, D] block a row (baseline
    rows included)."""
    jcfg = tiny_cfg("vlm")
    jlc, tlc = _loader_cfgs(mode=mode)
    jsteps = list(jplanner.plan_stream(jcfg, jlc, 3,
                                       jplanner.PlannerConfig()))
    tsteps = list(tplanner.plan_stream(config_from_jax(jcfg), tlc, 3,
                                       tplanner.PlannerConfig()))
    n = 0
    for a, b in zip(jsteps, tsteps, strict=True):
        ea, eb = a.step_batch().inputs, b.step_batch().inputs
        if ea is None:
            assert eb is None
            continue
        assert eb["extra_embeds"].shape == (
            b.step_batch().tb.tokens.shape[0], jcfg.frontend_len,
            jcfg.d_model)
        assert np.array_equal(np.asarray(ea["extra_embeds"]),
                              eb["extra_embeds"])
        n += 1
    assert n >= 2


def test_engine_step_and_oversized_trees_raise_as_jax():
    """A packed step through ``TreeTrainEngine`` (one host sync); trees
    larger than a row, routed to partition waves, raise in
    ``partition_forward`` as the reference's do."""
    jcfg = tiny_cfg("vlm")
    tcfg = config_from_jax(jcfg)
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = TreeTrainEngine(tcfg, OptimizerConfig(lr=1e-3, total_steps=4,
                                                warmup_steps=1))
    _, tlc = _loader_cfgs()
    plan = next(iter(tplanner.plans(tcfg, tlc, 1, tplanner.PlannerConfig(
        plan_workers=0)))).execution_plan()
    tp, _, m = eng.step(tp, init_opt_state(tp), plan)
    assert eng.host_syncs == 1 and np.isfinite(m["loss"])
    _, tlc = _loader_cfgs(seq_len=48, auto_partition=True, capacity=32)
    steps = [ps for ps in tplanner.plan_stream(tcfg, tlc, 3,
                                               tplanner.PlannerConfig())
             if ps.oversized]
    assert steps
    with pytest.raises(NotImplementedError, match="partitioned training"):
        eng.step(tp, init_opt_state(tp), steps[0].execution_plan())
    with pytest.raises(NotImplementedError, match="partitioned training"):
        jtransformer.partition_forward(jcfg, jmodel.init_params(
            jcfg, jax.random.key(0)), {}, None, {}, "ref")


def test_bridge_and_checkpoints_round_trip(tmp_path):
    """Identity-rename bridge, and an ``.npz`` checkpoint written by either
    package loads in the other leaf for leaf."""
    jcfg, jp, _, tp = _setup()
    back = params_to_numpy(tp)
    tckpt.save_checkpoint(str(tmp_path / "t"), tp, None, meta={"steps": 1})
    jp2 = jckpt.load_checkpoint(str(tmp_path / "t"), jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp2)):
        np.testing.assert_array_equal(a, np.asarray(b))
    jckpt.save_checkpoint(str(tmp_path / "j"), jp, None, meta={"steps": 1})
    tp2 = tckpt.load_checkpoint(str(tmp_path / "j"), tp)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp2),
                                                 tree_leaves(tp)))


def test_launcher_smoke_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "3", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    m = re.search(r"\((\d+) host syncs / (\d+) steps\)", res.stdout)
    assert m and m[1] == m[2] != "0", res.stdout
    assert "family=vlm" in res.stdout and "nan" not in res.stdout
