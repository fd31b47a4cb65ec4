"""SSM and hybrid partitions in the port, against the JAX package (float32,
bridged weights, seeded numpy inputs): each mixer's partition gateway
(initial state, conv or shift context) and captures — outputs and
captures within 2e-5, grads w.r.t. the input, the parameters, the state
and the context within max-rel 1e-4; the depth-first partitioned driver
for RWKV6, Mamba2, GDN and the Zamba2 hybrid against the reference's
whole tree (loss rtol 2e-5, grads max-rel 1e-4: tests/test_partition.py's
bar); the planner routing oversized SSM trees to partition waves with
none dropped; and the Zamba2 launcher with ``--auto-partition``.  The
reference's whole-tree loss runs under ``jax.jit``."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import branching_tree, tiny_cfg  # noqa: E402
from repro.core.packing import pack_trees as jpack_trees  # noqa: E402
from repro.core.tree import serialize_tree as jserialize  # noqa: E402
from repro.data.synthetic import random_tree as jrandom_tree  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.layers import prev_powers  # noqa: E402
from repro.models.ssm import gdn as jgdn  # noqa: E402
from repro.models.ssm import mamba2 as jmamba2  # noqa: E402
from repro.models.ssm import rwkv6 as jrwkv6  # noqa: E402
from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import gateway as tgw  # noqa: E402
from repro_torch.data.synthetic import random_tree  # noqa: E402
from repro_torch.device import map_tree, tree_leaves  # noqa: E402
from repro_torch.models.ssm import gdn as tgdn  # noqa: E402
from repro_torch.models.ssm import mamba2 as tmamba2  # noqa: E402
from repro_torch.models.ssm import rwkv6 as trwkv6  # noqa: E402
from test_torch_waves import _one_torch_thread, _tree_seed  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("ssm_rwkv6", "ssm_mamba2", "ssm_gdn", "hybrid")
TREE_KW = dict(vocab_size=89, max_depth=5, seg_len_range=(3, 9))


def _max_rel(tl, jl):
    jl = [np.asarray(x, np.float32) for x in jl]
    tl = [x.detach().float().numpy() for x in tl]
    assert len(jl) == len(tl)
    return max(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))
               for a, b in zip(tl, jl))


# --------------------------------------------------------------------------
# Each mixer with a gateway and captures
# --------------------------------------------------------------------------

def _gateway_rows(chunk):
    """Two partition roots' chunk-aligned serializations in [2, S] rows
    (their first tokens read gateway slot −2, whose predecessors chain to
    −3, −4): prev_idx, valid and the host chunk_parent map."""
    sers = [jserialize(branching_tree(s), chunk_size=chunk, root_prev=-2)
            for s in (0, 5)]
    S = max(s.n for s in sers)
    prev = np.full((2, S), -1, np.int32)
    valid = np.zeros((2, S), bool)
    cp = np.full((2, S // chunk), -1, np.int32)
    for r, s in enumerate(sers):
        prev[r, :s.n], valid[r, :s.n] = s.prev_idx, s.valid
        cp[r, :s.n // chunk] = s.chunk_parent_map(chunk)
    return prev, valid, cp


MIXERS = ("mamba2", "gdn", "timemix", "channelmix")


def _mixer_case(mixer):
    """The mixer's layer parameters, config and seeded inputs: x, the
    gateway state and context, the capture plans, the host columns."""
    family = {"mamba2": "ssm_mamba2", "gdn": "ssm_gdn"}.get(mixer,
                                                          "ssm_rwkv6")
    jcfg = tiny_cfg(family)
    ssm, D, key = jcfg.ssm, jcfg.d_model, jax.random.key(3)
    lp = jax.tree.map(np.asarray, {
        "mamba2": lambda: jmamba2.init_mamba2(key, ssm, D),
        "gdn": lambda: jgdn.init_gdn(key, ssm, D),
        "timemix": lambda: jrwkv6.init_rwkv6_timemix(key, ssm, D),
        "channelmix": lambda: jrwkv6.init_rwkv6_channelmix(
            key, D, jcfg.d_ff)}[mixer]())
    prev, valid, cp = _gateway_rows(ssm.chunk_size)
    B, S = prev.shape
    rng = np.random.default_rng(7)
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    H, hd = ssm.n_heads(D), ssm.head_dim
    if mixer == "mamba2":
        state = {"h": f32(B, H, ssm.d_state, hd)}
        ctx = f32(B, ssm.conv_kernel - 1,
                  ssm.d_inner(D) + 2 * ssm.d_state)
    elif mixer == "gdn":
        state = {"S": f32(B, H, hd, hd)}
        ctx = f32(B, ssm.conv_kernel - 1, 3 * ssm.d_inner(D))
    else:
        state = None if mixer == "channelmix" else {"S": f32(B, H, hd, hd)}
        ctx = f32(B, 1, D)
    taps = 1 if mixer in ("timemix", "channelmix") else ssm.conv_kernel - 1
    paths = (np.array([3, 9, 17, 30], np.int32), np.array([1], np.int32))
    capture = {f"c{i}": {"chunk": c, "pos": p[-taps:]}
               for i, (c, p) in enumerate(zip((3, 0), paths))}
    return dict(lp=lp, cfg=jcfg, tcfg=config_from_jax(jcfg), x=f32(B, S, D),
                state=state, ctx=ctx, capture=capture, prev=prev,
                valid=valid, cp=cp, pows=prev_powers(prev, max(1, taps)))


def _jax_mixer(mixer, c, params, x, state, ctx):
    pos = "shift_pos" if mixer in ("timemix", "channelmix") else "conv_pos"
    cap = {n: {"chunk": v["chunk"], pos: jnp.asarray(v["pos"])}
           for n, v in c["capture"].items()}
    kw = dict(chunk_parent=jnp.asarray(c["cp"]),
              valid=jnp.asarray(c["valid"]), initial_state=state,
              capture=cap)
    if mixer == "channelmix":
        cap = {n: {"shift_pos": v["shift_pos"]} for n, v in cap.items()}
        return jrwkv6.rwkv6_channelmix(params, x, jnp.asarray(c["prev"]),
                                       ctx, cap)
    if mixer == "timemix":
        return jrwkv6.rwkv6_timemix(params, c["cfg"].ssm, x,
                                    prev_idx=jnp.asarray(c["prev"]),
                                    shift_ctx=ctx, **kw)
    layer = jmamba2.mamba2 if mixer == "mamba2" else jgdn.gdn
    return layer(params, c["cfg"].ssm, x, prev_pows=jnp.asarray(c["pows"]),
                 conv_ctx=ctx, **kw)


def _torch_mixer(mixer, c, params, x, state, ctx):
    pos = "shift_pos" if mixer in ("timemix", "channelmix") else "conv_pos"
    cap = {n: {"chunk": v["chunk"], pos: torch.from_numpy(v["pos"]).long()}
           for n, v in c["capture"].items()}
    t = lambda a: torch.from_numpy(a)
    kw = dict(chunk_parent=c["cp"], valid=t(c["valid"]),
              initial_state=state, capture=cap)
    if mixer == "channelmix":
        cap = {n: {"shift_pos": v["shift_pos"]} for n, v in cap.items()}
        return trwkv6.rwkv6_channelmix(params, x, t(c["prev"]), ctx, cap)
    if mixer == "timemix":
        return trwkv6.rwkv6_timemix(params, c["tcfg"].ssm, x,
                                    prev_idx=t(c["prev"]), shift_ctx=ctx,
                                    **kw)
    layer = tmamba2.mamba2 if mixer == "mamba2" else tgdn.gdn
    return layer(params, c["tcfg"].ssm, x, prev_pows=t(c["pows"]).long(),
                 conv_ctx=ctx, **kw)


@pytest.mark.parametrize("mixer", MIXERS)
def test_mixer_gateway_and_captures_match_jax(mixer):
    """Output and captures (the state after the cut chunk, the inputs at
    the conv or shift positions) in the forward, and the grads of a
    seeded projection of both w.r.t. x, the parameters, the gateway state
    and its context."""
    c = _mixer_case(mixer)
    args = (c["lp"], c["x"], c["state"], c["ctx"])
    fwd = lambda p, x, st, ctx: _jax_mixer(mixer, c, p, x, st, ctx)
    rng = np.random.default_rng(11)
    w_out, w_caps = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.eval_shape(fwd, *args))

    def jloss(p, x, st, ctx):
        out, caps = fwd(p, x, st, ctx)
        return jnp.sum(out * w_out) + sum(
            jnp.sum(a * b) for a, b in zip(jax.tree.leaves(caps),
                                           jax.tree.leaves(w_caps))), \
            (out, caps)

    (_, (jout, jcaps)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    leaf = lambda a: torch.from_numpy(np.array(a)).requires_grad_(True)
    tp, tx, tctx = map_tree(leaf, c["lp"]), leaf(c["x"]), leaf(c["ctx"])
    ts = None if c["state"] is None else map_tree(leaf, c["state"])
    tout, tcaps = _torch_mixer(mixer, c, tp, tx, ts, tctx)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    jl, tl = jax.tree.leaves(jcaps), tree_leaves(tcaps)
    assert len(jl) == len(tl) > 0
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)
    loss = (tout * torch.from_numpy(w_out)).sum() + sum(
        (a * torch.from_numpy(np.asarray(b))).sum()
        for a, b in zip(tl, jax.tree.leaves(w_caps)))
    inputs = tree_leaves(tp) + [tx] + ([] if ts is None
                                       else tree_leaves(ts)) + [tctx]
    tg = torch.autograd.grad(loss, inputs)
    want = jax.tree.leaves(jg[0]) + [jg[1]] + jax.tree.leaves(jg[2]) \
        + [jg[3]]
    assert float(np.abs(np.asarray(jg[3])).max()) > 0   # the ctx is read
    assert _max_rel(tg, want) < 1e-4


# --------------------------------------------------------------------------
# The depth-first partitioned driver against the reference's whole tree
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(family, seed):
    jcfg = tiny_cfg(family)
    return jcfg, jmodel.init_params(jcfg, jax.random.key(seed))


def _setup(family, seed=0):
    """The reference's config and params (made once per family and seed)
    and a fresh copy of both in the port."""
    jcfg, jp = _jax_params(family, seed)
    return jcfg, jp, config_from_jax(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def whole_tree_sum(jcfg, jp, trees):
    """The reference's loss sum and grads over ``trees`` as whole,
    un-partitioned rows (one packed batch, ``loss_and_metrics`` under
    ``jax.jit``)."""
    cs = jcfg.ssm.chunk_size
    sers = [jserialize(t, chunk_size=cs) for t in trees]
    S = 32 * -(-sum(s.n for s in sers) // 32)
    b = jmodel.prepare_batch(jcfg, jpack_trees(sers, S, chunk_size=cs))
    n = len(trees)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_and_metrics(jcfg, p, b)[0] * n))(jp)
    return float(loss), grads


@pytest.mark.parametrize("family", FAMILIES)
def test_recursive_driver_matches_jax_whole_tree(family):
    jcfg, jp, tcfg, tp = _setup(family)
    s = _tree_seed()
    l_ref, g_ref = whole_tree_sum(
        jcfg, jp, [jrandom_tree(np.random.default_rng(s), **TREE_KW)])
    l_p, g_p, info = tgw.partitioned_value_and_grad(
        tcfg, tp, random_tree(np.random.default_rng(s), **TREE_KW),
        capacity=40)
    assert info["num_partitions"] >= 3
    assert abs(l_p - l_ref) <= 2e-5 * abs(l_ref)
    assert _max_rel(tree_leaves(g_p), jax.tree.leaves(g_ref)) < 1e-4


# --------------------------------------------------------------------------
# The planner and the launcher
# --------------------------------------------------------------------------

def test_planner_routes_oversized_ssm_trees_to_waves():
    """``plans`` with auto-partition routes every tree larger than a row of
    the GDN stack to chunk-aligned partition waves: 0 dropped, tokens
    conserved, one host sync a step."""
    from repro_torch.data.loader import LoaderConfig, tree_stream
    from repro_torch.models import model as tmodel
    from repro_torch.train import engine as tengine
    from repro_torch.train import optimizer as topt
    from repro_torch.train.planner import PlannerConfig, plans
    _, _, tcfg, tp = _setup("ssm_gdn")
    lc = LoaderConfig(seq_len=128, batch_rows=2, trees_per_batch=2,
                      kind="agentic", auto_partition=True, capacity=64,
                      gen_kwargs=dict(turn_len_range=(40, 80), num_turns=3))
    eng = tengine.TreeTrainEngine(tcfg, topt.OptimizerConfig())
    opt = topt.init_opt_state(tp)
    got = waves = 0
    for ps in plans(tcfg, lc, 2, PlannerConfig()):
        plan = ps.execution_plan()
        assert plan.dropped == 0
        waves += plan.has_waves
        for w in plan.partition.waves if plan.has_waves else ():
            assert isinstance(w.batch["chunk_parent"], np.ndarray)
        got += plan.unique_tokens
        tp, opt, m = eng.step(tp, opt, plan)
        assert np.isfinite(m["loss"])
    assert waves and eng.host_syncs == eng.steps_done == 2
    assert got == sum(t.num_unique_tokens() for b in tree_stream(tcfg, lc, 2)
                      for t in b)
    assert tmodel.chunk_size_of(tcfg) == tcfg.ssm.chunk_size


def test_zamba2_launcher_auto_partition_drops_nothing(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "zamba2_1p2b", "--smoke", "--auto-partition", "--capacity", "256",
         "--seq-len", "512", "--steps", "1", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    last = res.stdout.strip().splitlines()[-1]
    assert last.startswith("[train] partitioned:") and \
        last.endswith(" 0 dropped"), last
    assert "(1 host syncs / 1 steps)" in res.stdout
    assert "nan" not in res.stdout
