"""The port's MoE slice against the JAX package, on the same bridged weights
and the same numpy-seeded inputs (float32):

  - ``models.moe.moe`` alone: y and the aux losses within 1e-5, with pads in
    ``valid``, a capacity small enough to drop slots, swiglu with a shared
    expert, relu and squared_relu without one;
  - ``loss_and_metrics``: loss within 1e-5 relative, grads within 1e-4
    max-rel (tests/test_equivalence.py:57-62), the port's plain path
    against the reference's ``ref`` (and its Pallas kernels in interpret
    mode);
  - tree ≡ per-branch baseline (Eq. 5) with the aux losses zeroed and a
    capacity that never binds, the strict bar of tests/test_forest.py:15-25;
  - a ``DecodeSession`` (prefill, fork, steps, a second prefill) within 1e-5
    of the reference's (tests/test_session.py:24,102), and a decode step at
    capacity 1 that drops slots;
  - the config copy, the parameter layout with the fp32 router, AdamW and
    the decay mask on it, and an ``.npz`` round trip of it;
  - ``launch.train --arch qwen3_30b_a3b --smoke``;
  - the layer loop's unbind: grads bit-identical to per-layer selects."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.packing import pack_linear_paths as jpack_paths  # noqa: E402
from repro.core.packing import pack_trees as jpack_trees  # noqa: E402
from repro.core.tree import serialize_tree as jax_serialize  # noqa: E402
from repro.data.synthetic import trees_for_batch as jax_trees  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve.session import DecodeSession as JaxSession  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.core.packing import (pack_linear_paths,  # noqa: E402
                                      pack_trees)
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import trees_for_batch  # noqa: E402
from repro_torch.device import (map_tree, tree_leaves,  # noqa: E402
                                unflatten_like)
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.session import DecodeSession  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

TOL = 1e-5
CFGS = {"tiny_moe": lambda: tiny_cfg("moe"),
        "qwen3_smoke": lambda: jax_get_config("qwen3_30b_a3b", smoke=True)}


def _setup(jcfg, seed=0):
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jp, config_from_jax(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _max_rel(tl, jl):
    """max over leaves of max|a − b| / max|b| (test_equivalence.py:57)."""
    jl = [np.asarray(x, np.float32) for x in jl]
    tl = [x.float().numpy() for x in tl]
    assert len(jl) == len(tl)
    return max(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))
               for a, b in zip(tl, jl))


def _no_aux(jcfg, **moe_kw):
    return dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, router_aux_weight=0.0, router_z_weight=0.0, **moe_kw))


# ---------------------------------------------------------------------------
# the MoE layer alone
# ---------------------------------------------------------------------------

# case → (activation, shared experts, capacity factor, pad share)
MOE_CASES = {"pads": ("swiglu", 1, 4.0, 0.3),
             "drops": ("swiglu", 1, 0.5, 0.2),
             "swiglu_shared": ("swiglu", 2, 1.25, 0.0),
             "relu": ("relu", 0, 1.0, 0.1),
             "squared_relu": ("squared_relu", 0, 0.75, 0.1)}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_layer_matches_jax(case):
    act, shared, cf, pad = MOE_CASES[case]
    jm = jax_get_config("qwen3_30b_a3b", smoke=True).moe
    jm = dataclasses.replace(jm, num_experts=8, top_k=2,
                             num_shared_experts=shared, capacity_factor=cf)
    tm = MoECfg(**dataclasses.asdict(jm))
    B, S, D = 3, 24, 32
    jp = jmoe.init_moe(jax.random.key(1), jm, D, act)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    valid = rng.random((B, S)) >= pad
    jy, jaux = jmoe.moe(jp, jm, jnp.asarray(x), jnp.asarray(valid), act)
    ty, taux = tmoe.moe(tp, tm, torch.tensor(x), torch.tensor(valid), act)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    assert set(taux) == set(jaux) == {"load_balance", "router_z"}
    for k in jaux:
        assert _rel(taux[k], jaux[k]) <= TOL, k
    # the case exercises what it names
    C = tmoe.capacity(B * S, tm)
    assert C == int(max(1, round(B * S * 2 / 8 * cf)))
    _, _, top_e = tmoe.route(tp, tm, torch.tensor(x).reshape(-1, D))[1:]
    _, pos_c, keep = tmoe.queue(top_e, torch.tensor(valid).reshape(-1), 8, C)
    dropped = int((~keep).sum()) - 2 * int((~valid).sum())
    if case == "drops":
        assert dropped > 0
    if cf >= 8 / 2:                 # C ≥ N: no valid slot can drop
        assert dropped == 0
    assert bool((pos_c[~keep] == C).all())
    if pad:
        # a pad token queues nowhere: its output is the shared experts'
        # alone (zero without them)
        xt = torch.tensor(x)[torch.tensor(~valid)]
        alone = (tmoe._act(tp, xt, act, "shared_") @ tp["shared_wo"]
                 if shared else torch.zeros_like(xt))
        assert xt.shape[0] > 0
        assert torch.equal(ty[torch.tensor(~valid)], alone)


# ---------------------------------------------------------------------------
# loss and grads, tree ≡ baseline
# ---------------------------------------------------------------------------

def _batches(jcfg, tcfg, S=256, baseline=False, seed=2, n=3):
    kw = dict(n_trees=n, kind="random", vocab_size=jcfg.vocab_size)
    trees_j, trees_t = jax_trees(seed, **kw), trees_for_batch(seed, **kw)
    if baseline:
        jb = jpack_paths([t.linearize_paths() for t in trees_j], S)
        tb = pack_linear_paths([t.linearize_paths() for t in trees_t], S)
    else:
        jb = jpack_trees([jax_serialize(t) for t in trees_j], S)
        tb = pack_trees([serialize_tree(t) for t in trees_t], S)
    return jmodel.prepare_batch(jcfg, jb), tmodel.prepare_batch(
        tcfg, tb, device="cpu")


@pytest.mark.parametrize("name,impl,jimpl", [
    ("tiny_moe", "kernel", "ref"), ("tiny_moe", "ref", "ref"),
    ("qwen3_smoke", "kernel", "pallas")])
def test_loss_metrics_and_grads_match_jax(name, impl, jimpl):
    jcfg = CFGS[name]()
    jp, tcfg, tp = _setup(jcfg)
    jb, tb = _batches(jcfg, tcfg)
    assert not bool(tb["valid"].all())             # the rows hold pads
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_and_metrics(jcfg, p, jb, jimpl),
        has_aux=True)(jp)
    tl, tm, tg = value_and_grad(tcfg, tp, tb, impl)
    assert _rel(tl, jl) <= TOL
    assert set(tm) == set(jm)
    for key in jm:
        assert _rel(tm[key], jm[key]) <= TOL, key
    assert float(tm["aux_loss"]) > 0
    assert _max_rel(tree_leaves(tg), jax.tree.leaves(jg)) < 1e-4


@pytest.mark.parametrize("name", list(CFGS))
def test_tree_equals_per_branch_baseline_with_aux_off(name):
    """Eq. 5 within the port: with the aux losses zeroed and a capacity
    that never binds (C ≥ N at capacity_factor = E/K), the tree-packed
    batch's loss and every grad equal the per-branch baseline's."""
    jcfg = CFGS[name]()
    jcfg = _no_aux(jcfg, capacity_factor=jcfg.moe.num_experts
                   / jcfg.moe.top_k)
    _, tcfg, tp = _setup(jcfg)
    _, bt = _batches(jcfg, tcfg, S=512, n=2)
    _, bl = _batches(jcfg, tcfg, S=1024, n=2, baseline=True)
    assert bl["valid"].sum() > bt["valid"].sum()   # the baseline repeats
    lt, mt, gt = value_and_grad(tcfg, tp, bt, "kernel")
    ll, _, gl = value_and_grad(tcfg, tp, bl, "kernel")
    assert float(mt["aux_loss"]) == 0.0
    np.testing.assert_allclose(float(lt), float(ll), rtol=5e-6)
    assert _max_rel(tree_leaves(gt), [g.numpy() for g in tree_leaves(gl)]) \
        < 1e-4


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _toks(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name", list(CFGS))
def test_session_matches_jax(name):
    """prefill (JAX in Pallas interpret mode), fork(3), 4 steps, a second
    prefill on the forked session (the kernel's q_off path), one more
    step; the caches and every logits row within 1e-5."""
    jcfg = CFGS[name]()
    jp, tcfg, tp = _setup(jcfg)
    V = jcfg.vocab_size
    prompt, tool = _toks(0, 10, V), _toks(1, 5, V)
    steps = np.stack([_toks(10 + i, 3, V) for i in range(4)], axis=1)
    js = JaxSession.create(jcfg, jp, buf_len=24)
    ts = DecodeSession.create(tcfg, tp, buf_len=24, device="cpu")
    with torch.inference_mode():
        assert ts._can_parallel_prefill(10)
        _close(ts.prefill(prompt, impl="kernel"),
               js.prefill(prompt, impl="pallas"))
        jf, tf = js.fork(3), ts.fork(3)
        for i in range(4):
            _close(tf.step(steps[:, i]), jf.step(steps[:, i]))
        _close(tf.prefill(tool, impl="kernel"), jf.prefill(tool, impl="ref"))
        for g, grp in tf.cache.items():
            for leaf in ("k", "v", "pos"):
                _close(grp[leaf][:, :, :19].numpy(),
                       np.asarray(jf.cache[g][leaf])[:, :, :19])
        _close(tf.step(steps[:, 0]), jf.step(steps[:, 0]))
    assert tf.t == jf.t == 20
    assert ts.stats.prefill_tokens == js.stats.prefill_tokens == 10 + 3 * 5


def test_parallel_prefill_matches_step_loop():
    """The reference's own MoE case (tests/test_session.py:24)."""
    jcfg = tiny_cfg("moe")
    _, tcfg, tp = _setup(jcfg)
    toks = _toks(0, 10, jcfg.vocab_size)
    with torch.inference_mode():
        fast = DecodeSession.create(tcfg, tp, buf_len=14, device="cpu")
        slow = DecodeSession.create(tcfg, tp, buf_len=14, device="cpu")
        _close(fast.prefill(toks), slow._prefill_steps(toks))
        for g in fast.cache:
            for leaf in ("k", "v", "pos"):
                _close(fast.cache[g][leaf].numpy(),
                       slow.cache[g][leaf].numpy())


def test_decode_step_at_capacity_one_drops_slots_like_jax():
    """Three branches, 4 experts top-2 at capacity factor 0.5: a decode
    step's capacity is max(1, round(3·2/4·0.5)) = 1, so of its 6 (token,
    slot) pairs at most one per expert (4) is kept; the logits match the
    reference's step."""
    jcfg = tiny_cfg("moe")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    jp, tcfg, tp = _setup(jcfg, seed=3)
    assert tmoe.capacity(3, tcfg.moe) == 1
    V = jcfg.vocab_size
    js = JaxSession.create(jcfg, jp, buf_len=16)
    ts = DecodeSession.create(tcfg, tp, buf_len=16, device="cpu")
    kept = []
    real = tmoe.queue

    def counting(top_e, vmask, E, C):
        out = real(top_e, vmask, E, C)
        kept.append((C, top_e.numel(), int(out[2].sum())))
        return out

    with torch.inference_mode():
        _close(ts.prefill(_toks(5, 6, V)), js.prefill(_toks(5, 6, V)))
        jf, tf = js.fork(3), ts.fork(3)
        tmoe.queue = counting
        try:
            for i in range(3):
                toks = _toks(20 + i, 3, V)
                _close(tf.step(toks), jf.step(toks))
        finally:
            tmoe.queue = real
    assert kept and all(c == 1 and n == 6 for c, n, _ in kept)
    assert all(k <= 4 for _, _, k in kept)     # every step dropped slots


# ---------------------------------------------------------------------------
# config, layout, optimizer, checkpoint, launcher
# ---------------------------------------------------------------------------

def test_config_copy_param_layout_and_bridge_match_jax():
    for smoke in (False, True):
        t, j = (get_config("qwen3_30b_a3b", smoke=smoke),
                jax_get_config("qwen3_30b_a3b", smoke=smoke))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    assert get_config("qwen3_30b_a3b").param_count() == 30_532_435_968
    jcfg = tiny_cfg("moe", dtype="bfloat16")
    tcfg = config_from_jax(jcfg)
    assert transformer.layer_groups(tcfg) == [("dense", 1), ("moe", 1)]
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    jp = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.key(0)))
    desc = lambda t: f"{tuple(t.shape)} {str(t.dtype).split('.')[-1]}"
    want = jax.tree.map(desc, jp)
    for tree in (tp, params_from_jax(jp, "cpu")):
        got = map_tree(desc, tree)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert jax.tree.leaves(got) == jax.tree.leaves(want)
    assert tp["layer_stacks"][1]["moe"]["router"].dtype == torch.float32
    assert tp["layer_stacks"][1]["moe"]["wo"].dtype == torch.bfloat16


def test_adamw_and_decay_mask_on_the_fp32_router_match_jax():
    """One AdamW step on a bf16 MoE tree: the fp32 router is updated in
    place and stays fp32, within 1e-6 of the reference's update; the decay
    mask decays it (a stacked leaf, ndim 3), leaf for leaf as the
    reference's."""
    jcfg = tiny_cfg("moe", dtype="bfloat16")
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    rng = np.random.default_rng(1)
    jg = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)).astype(a.dtype), jp)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jnew, _, jm = jopt.adamw_update(jopt.OptimizerConfig(**ocfg), jp, jg,
                                    jopt.init_opt_state(jp))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    router = tp["layer_stacks"][1]["moe"]["router"]
    tnew, _, tm = topt.adamw_update(
        topt.OptimizerConfig(**ocfg), tp,
        params_from_jax(jax.tree.map(np.asarray, jg), "cpu"),
        topt.init_opt_state(tp))
    assert tnew["layer_stacks"][1]["moe"]["router"] is router
    assert router.dtype == torch.float32
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    np.testing.assert_allclose(
        router.numpy(), np.asarray(jnew["layer_stacks"][1]["moe"]["router"]),
        rtol=1e-6, atol=1e-7)
    assert jax.tree.leaves(jopt._decay_mask(jp)) == tree_leaves(
        topt._decay_mask(tp))
    assert topt._decay_mask(tp)["layer_stacks"][1]["moe"]["router"] is True


def test_checkpoint_round_trips_the_fp32_router(tmp_path):
    """A bf16 MoE tree with its fp32 router and the fp32 AdamW state:
    saved and loaded bit for bit, dtypes kept; and the reference loads the
    port's f32 MoE checkpoint leaf for leaf."""
    cfg = get_config("qwen3_30b_a3b", smoke=True).replace(dtype="bfloat16")
    tp = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    to = topt.init_opt_state(tp)
    to["mu"]["layer_stacks"][0]["moe"]["router"].normal_()
    tckpt.save_checkpoint(str(tmp_path / "bf16"), tp, to)
    p2, o2 = tckpt.load_checkpoint(str(tmp_path / "bf16"), tp, to)
    for a, b in zip(tree_leaves(tp) + tree_leaves(to),
                    tree_leaves(p2) + tree_leaves(o2)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    assert p2["layer_stacks"][0]["moe"]["router"].dtype == torch.float32
    jcfg = tiny_cfg("moe")
    jp, _, tf = _setup(jcfg)
    tckpt.save_checkpoint(str(tmp_path / "f32"), tf)
    jback = jckpt.load_checkpoint(str(tmp_path / "f32"), jp)
    for a, b in zip(tree_leaves(tf), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_launcher_trains_the_moe_smoke(capsys, tmp_path):
    train_main(["--arch", "qwen3_30b_a3b", "--smoke", "--steps", "2",
                "--seq-len", "1024", "--device", "cpu", "--save",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert "family=moe" in out and "impl=kernel" in out
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    assert len(steps) == 2
    assert all(np.isfinite(float(line.split()[3])) for line in steps)
    assert "(2 host syncs / 2 steps)" in out
    back = tckpt.load_checkpoint(str(tmp_path), tmodel.init_params(
        get_config("qwen3_30b_a3b", smoke=True), device="cpu"))
    assert back["layer_stacks"][0]["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the layer loop's unbind
# ---------------------------------------------------------------------------

def _select_layers(tree, n):
    """The per-layer select the layer loop used before: layer i of every
    leaf by indexing, one select node per leaf and layer."""
    if isinstance(tree, dict):
        per_key = {k: _select_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return [tree[i] for i in range(n)]


def _leaf_consumers(t, leaves):
    """Names of the autograd nodes that take a gradient straight into one
    of ``leaves`` (stacked parameters: ndim ≥ 2 under ``layer_stacks``)."""
    ids = {id(x) for x in leaves}
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        for g, _ in f.next_functions:
            if g is not None and id(getattr(g, "variable", None)) in ids:
                names.add(type(f).__name__)
            todo.append(g)
    return names


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_unbind_grads_bit_identical_to_select(family, monkeypatch):
    """Each stack leaf unbound once per forward: every grad equals the
    per-layer select version's exactly, and the graph holds unbinds and
    no select."""
    jcfg = tiny_cfg(family, n_layers=3)
    _, tcfg, tp = _setup(jcfg)
    _, tb = _batches(jcfg, tcfg)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    params = unflatten_like(tp, leaves)
    stacks = tree_leaves(params["layer_stacks"])
    loss, _ = tmodel.loss_and_metrics(tcfg, params, tb, "kernel")
    assert _leaf_consumers(loss, stacks) == {"UnbindBackward0"}
    g_unbind = torch.autograd.grad(loss, leaves)
    monkeypatch.setattr(transformer, "_unstack", _select_layers)
    loss2, _ = tmodel.loss_and_metrics(tcfg, params, tb, "kernel")
    assert _leaf_consumers(loss2, stacks) == {"SelectBackward0"}
    g_select = torch.autograd.grad(loss2, leaves)
    assert torch.equal(loss, loss2)
    for a, b in zip(g_unbind, g_select):
        assert torch.equal(a, b)
