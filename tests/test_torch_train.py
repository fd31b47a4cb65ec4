"""The port's training path against the JAX package, on the same bridged
weights and the same packed batches: ``loss_and_metrics`` and the grads of
every leaf (1e-5 relative on the loss, max-rel < 1e-4 on grads, the bar of
tests/test_equivalence.py:57-62), the paper's tree ≡ per-branch identity
(Eq. 5) within the port, one AdamW update (1e-6 relative), the schedule
and decay mask, and three engine steps (1e-5 relative) with one host sync
per step.  JAX runs its Pallas kernels in interpret mode where ``impl`` is
"pallas"; the port's "kernel" path takes the plain versions on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import branching_tree, tiny_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.packing import pack_linear_paths as jpack_paths  # noqa: E402
from repro.core.packing import pack_trees as jpack_trees  # noqa: E402
from repro.core.tree import serialize_tree as jax_serialize  # noqa: E402
from repro.data.synthetic import trees_for_batch as jax_trees  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import engine as jengine  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.core.packing import (pack_linear_paths,  # noqa: E402
                                      pack_trees)
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import trees_for_batch  # noqa: E402
from repro_torch.device import map_tree, tree_leaves  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import engine as tengine  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import (apply_grads,  # noqa: E402
                                          make_grad_fn, make_train_step,
                                          value_and_grad)

CFGS = {"tiny_dense": lambda: tiny_cfg("dense"),
        "qwen1p5_smoke": lambda: jax_get_config("qwen1p5_0p5b", smoke=True),
        "qwen2_smoke": lambda: jax_get_config("qwen2_1p5b", smoke=True)}
PAIRS = [("tiny_dense", "kernel", "pallas"), ("qwen2_smoke", "kernel",
                                              "pallas")] + \
    [(name, "ref", "ref") for name in CFGS]


def _setup(name, seed=0):
    jcfg = CFGS[name]()
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jcfg, jp, config_from_jax(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _batches(jcfg, tcfg, trees_j, trees_t, S=256, mode="sep_avg",
             baseline=False):
    """The same packed rows as JAX and as torch model inputs."""
    if baseline:
        jb = jpack_paths([t.linearize_paths() for t in trees_j], S,
                         loss_mode=mode)
        tb = pack_linear_paths([t.linearize_paths() for t in trees_t], S,
                               loss_mode=mode)
    else:
        jb = jpack_trees([jax_serialize(t, loss_mode=mode) for t in trees_j],
                         S)
        tb = pack_trees([serialize_tree(t, loss_mode=mode) for t in trees_t],
                        S)
    return jmodel.prepare_batch(jcfg, jb), tmodel.prepare_batch(
        tcfg, tb, device="cpu")


def _random_trees(vocab, seed=2, n=3):
    kw = dict(n_trees=n, kind="random", vocab_size=vocab)
    return jax_trees(seed, **kw), trees_for_batch(seed, **kw)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _max_rel_grads(tg, jg):
    """max over leaves of max|a − b| / max|b| (test_equivalence.py:57)."""
    jl = [np.asarray(x, np.float32) for x in jax.tree.leaves(jg)]
    tl = [x.float().numpy() for x in tree_leaves(tg)]
    assert len(jl) == len(tl)
    return max(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))
               for a, b in zip(tl, jl))


@pytest.mark.parametrize("name,impl,jimpl", PAIRS)
def test_loss_metrics_and_grads_match_jax(name, impl, jimpl):
    jcfg, jp, tcfg, tp = _setup(name)
    jt, tt = _random_trees(jcfg.vocab_size)
    jb, tb = _batches(jcfg, tcfg, jt, tt)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_and_metrics(jcfg, p, jb, jimpl),
        has_aux=True)(jp)
    tl, tm, tg = value_and_grad(tcfg, tp, tb, impl)
    assert _rel(tl, jl) <= 1e-5
    assert set(tm) == set(jm)
    for key in jm:
        assert _rel(tm[key], jm[key]) <= 1e-5 or abs(float(jm[key])) < 1e-9, \
            key
    assert _max_rel_grads(tg, jg) < 1e-4


@pytest.mark.parametrize("kind", ["tree_vs_baseline", "rl_advantages"])
def test_tree_equals_per_branch_baseline_through_kernel_path(kind):
    """Eq. 5 within the port: loss and every grad of the tree-packed batch
    equal the per-branch baseline's (float32)."""
    jcfg, _, tcfg, tp = _setup("tiny_dense")
    if kind == "tree_vs_baseline":
        trees = trees_for_batch(2, n_trees=2, kind="random", vocab_size=89)
    else:
        trees = [branching_tree(0, min_leaves=3)]
        rng = np.random.default_rng(1)
        for n in trees[0].nodes():
            n.advantage = rng.normal(size=n.size).astype(np.float32)
    _, bt = _batches(jcfg, tcfg, trees, trees, S=512)
    _, bl = _batches(jcfg, tcfg, trees, trees, S=1024, baseline=True)
    lt, _, gt = value_and_grad(tcfg, tp, bt, "kernel")
    ll, _, gl = value_and_grad(tcfg, tp, bl, "kernel")
    np.testing.assert_allclose(float(lt), float(ll), rtol=5e-6)
    rel = max(float((a - b).abs().max() / (b.abs().max() + 1e-9))
              for a, b in zip(tree_leaves(gt), tree_leaves(gl)))
    assert rel < 1e-4, rel


def test_uniform_loss_mode_differs_but_finite():
    jcfg, _, tcfg, tp = _setup("tiny_dense")
    tree = [branching_tree(0, min_leaves=3)]
    _, b_sep = _batches(jcfg, tcfg, tree, tree)
    _, b_uni = _batches(jcfg, tcfg, tree, tree, mode="uniform")
    l_sep, _ = tmodel.loss_and_metrics(tcfg, tp, b_sep, "kernel")
    l_uni, _ = tmodel.loss_and_metrics(tcfg, tp, b_uni, "kernel")
    assert np.isfinite(float(l_uni))
    assert abs(float(l_sep) - float(l_uni)) > 1e-3


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _rand_tree(jp, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.normal(size=a.shape)).astype(
        np.float32), jp)


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_update_matches_jax(clip):
    """One update from a nonzero state (step 3) on random params and grads;
    the clip is active (global norm ≫ 1) or inactive (≪ 1)."""
    _, jp, _, _ = _setup("tiny_dense")
    params = _rand_tree(jp, 0)
    grads = _rand_tree(jp, 1, 1.0 if clip == "active" else 1e-3)
    mu, nu = _rand_tree(jp, 2, 1e-2), jax.tree.map(np.abs, _rand_tree(jp, 3,
                                                                      1e-3))
    cfg = jopt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jstate = {"mu": jax.tree.map(jnp.asarray, mu),
              "nu": jax.tree.map(jnp.asarray, nu),
              "step": jnp.asarray(3, jnp.int32)}
    jnew, jst, jm = jopt.adamw_update(cfg, jax.tree.map(jnp.asarray, params),
                                      jax.tree.map(jnp.asarray, grads), jstate)
    tparams = params_from_jax(params, "cpu")
    tstate = {"mu": params_from_jax(mu, "cpu"),
              "nu": params_from_jax(nu, "cpu"),
              "step": torch.tensor(3, dtype=torch.int32)}
    leaf0 = tree_leaves(tparams)[0]
    tnew, tst, tm = topt.adamw_update(
        topt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10),
        tparams, params_from_jax(grads, "cpu"), tstate)
    assert tnew is tparams and tree_leaves(tnew)[0] is leaf0   # in place
    assert int(tst["step"]) == 4 == int(jst["step"])
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
    assert _rel(tm["lr"], jm["lr"]) <= 1e-6
    assert (float(jm["grad_norm"]) > 1.0) == (clip == "active")
    for t, j in ((tnew, jnew), (tst["mu"], jst["mu"]), (tst["nu"], jst["nu"])):
        for a, b in zip(tree_leaves(t), jax.tree.leaves(j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_lr_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=3, total_steps=12, min_lr_ratio=0.1)
    for s in range(13):
        j = float(jopt.lr_at(jopt.OptimizerConfig(**cfg),
                              jnp.asarray(s, jnp.int32)))
        t = float(topt.lr_at(topt.OptimizerConfig(**cfg),
                             torch.tensor(s, dtype=torch.int32)))
        assert _rel(t, j) <= 1e-6, (s, t, j)


def test_decay_mask_matches_jax_leaf_for_leaf():
    """Copied as it is: only leaves with ndim > 1 decay, so the stacked
    layers' norm scales and biases (leading layer dim) are decayed too."""
    _, jp, _, tp = _setup("tiny_dense")
    jm = jax.tree.leaves(jopt._decay_mask(jp))
    tm = tree_leaves(topt._decay_mask(tp))
    assert jm == tm
    assert topt._decay_mask(tp)["layer_stacks"][0]["ln1"]["scale"] is True
    assert topt._decay_mask(tp)["final_norm"]["scale"] is False


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _plans(jcfg, tcfg, mode, seeds):
    out = []
    for s in seeds:
        kind = "grpo" if mode == "rl" else "agentic"
        kw = dict(n_trees=3, kind=kind, vocab_size=jcfg.vocab_size,
                  turn_len_range=(4, 16), num_turns=2)
        jb, tb = _batches(jcfg, tcfg, jax_trees(s, **kw),
                          trees_for_batch(s, **kw), S=256, mode=mode)
        out.append((jengine.ExecutionPlan(
            packed=jengine.PackedExec(inputs=jb), num_trees=3),
            tengine.ExecutionPlan(packed=tengine.PackedExec(inputs=tb),
                                  num_trees=3)))
    return out


def _bk(p):
    return [g["attn"]["bk"] for g in p["layer_stacks"]]


def _drop_bk(p):
    return {**p, "layer_stacks": [
        {**g, "attn": {k: v for k, v in g["attn"].items() if k != "bk"}}
        for g in p["layer_stacks"]]}


@pytest.mark.parametrize("mode", ["sep_avg", "rl"])
def test_three_engine_steps_match_jax(mode):
    """Per-step loss, nll, grad norm and lr within 1e-5 relative, and every
    parameter after three steps within max-rel 1e-5; the key bias ``bk`` is
    held element by element, by a rule on the JAX gradient.

    ``bk`` starts at zero, so after three steps it holds nothing but AdamW's
    updates, and Adam divides each element's gradient by its own size.  In
    RoPE's slowly rotating dimensions a key bias shifts all logits of a
    query alike, so its gradient there is nearly zero.  Readings on this
    config (CPU, f32): per step, the two packages' bk grads differ by at
    most ~1e-6 of the leaf's largest (summation order), while 32-43 of bk's
    128 elements have a gradient below 1e-4 of it; Adam turns the ratio of
    the two into the element's step error.  After three steps the whole
    leaf reads max-rel 1.5e-2 (sep_avg) and 3.0e-2 (rl), and the elements
    whose JAX gradient is at least 1e-2 of the leaf's largest at all three
    steps (37-38 of 128) read 4.3e-6 in both modes.  So those elements are
    held at 1e-5 like every other leaf, and the whole leaf at 5e-2."""
    jcfg, jp, tcfg, tp = _setup("qwen1p5_smoke")
    ocfg = dict(warmup_steps=2, total_steps=3)
    je = jengine.TreeTrainEngine(jcfg, jopt.OptimizerConfig(**ocfg),
                                 donate=False)
    te = tengine.TreeTrainEngine(tcfg, topt.OptimizerConfig(**ocfg),
                                 impl="ref")
    jo, to = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    resolved = [True] * len(jp["layer_stacks"])
    for i, (jplan, tplan) in enumerate(_plans(jcfg, tcfg, mode, (5, 6, 7))):
        resolved = [r & (np.abs(g) >= 1e-2 * np.abs(g).max()) for r, g in
                    zip(resolved, map(np.asarray,
                                      _bk(je.accumulate(jp, jplan)[0])))]
        jp, jo, jm = je.step(jp, jo, jplan)
        tp, to, tm = te.step(tp, to, tplan)
        for key in ("loss", "nll", "grad_norm", "lr"):
            assert _rel(tm[key], jm[key]) <= 1e-5, (i, key)
        assert te.host_syncs == i + 1
    assert te.steps_done == 3 and int(to["step"]) == 3
    assert _max_rel_grads(_drop_bk(tp), _drop_bk(jp)) < 1e-5
    for t, j, keep in zip(_bk(tp), map(np.asarray, _bk(jp)), resolved):
        err = np.abs(t.numpy() - j) / np.abs(j).max()
        assert keep.sum() >= keep.size // 4, keep.sum()
        assert err[keep].max() < 1e-5, err[keep].max()
        assert err.max() < 5e-2, err.max()


def test_make_train_step_matches_jax():
    """One fused loss + grad + AdamW step on a batch: every metric within
    1e-5 relative and every parameter within max-rel 1e-5."""
    jcfg, jp, tcfg, tp = _setup("tiny_dense")
    (jplan, tplan), = _plans(jcfg, tcfg, "sep_avg", (5,))
    ocfg = dict(warmup_steps=2, total_steps=3)
    jnew, _, jm = jstep.make_train_step(
        jcfg, jopt.OptimizerConfig(**ocfg), donate=False)(
        jp, jopt.init_opt_state(jp), dict(jplan.packed.inputs, num_trees=3))
    tnew, tst, tm = make_train_step(tcfg, topt.OptimizerConfig(**ocfg),
                                    "ref")(
        tp, topt.init_opt_state(tp), dict(tplan.packed.inputs, num_trees=3))
    assert set(tm) == set(jm) and int(tst["step"]) == 1
    for key in jm:
        assert _rel(tm[key], jm[key]) <= 1e-5 or abs(float(jm[key])) < 1e-9, \
            key
    assert _max_rel_grads(tnew, jnew) < 1e-5


def test_grad_fn_and_apply_grads_match_jax():
    """``make_grad_fn`` (loss, grads) and ``apply_grads`` (one AdamW update
    from those grads) against the reference's, on the same batch."""
    jcfg, jp, tcfg, tp = _setup("tiny_dense")
    (jplan, tplan), = _plans(jcfg, tcfg, "sep_avg", (5,))
    ocfg = dict(warmup_steps=2, total_steps=3)
    jl, jg, _ = jstep.make_grad_fn(jcfg)(
        jp, dict(jplan.packed.inputs, num_trees=3))
    tl, tg, tm = make_grad_fn(tcfg, "ref")(
        tp, dict(tplan.packed.inputs, num_trees=3))
    assert _rel(tl, jl) <= 1e-5 and "nll_sum" in tm
    assert _max_rel_grads(tg, jg) < 1e-4
    jnew, _, jm = jstep.apply_grads(jopt.OptimizerConfig(**ocfg), jp,
                                    jopt.init_opt_state(jp), jg)
    tnew, tst, tm = apply_grads(topt.OptimizerConfig(**ocfg), tp,
                                topt.init_opt_state(tp), tg)
    assert tnew is tp and int(tst["step"]) == 1
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    assert _max_rel_grads(tnew, jnew) < 1e-5


def test_engine_warmup_updates_without_a_host_sync():
    """``warmup`` runs accumulate + update once: the parameters change as
    one step changes them, but no host sync happens and no step counts."""
    jcfg, _, tcfg, tp = _setup("tiny_dense")
    (_, tplan), = _plans(jcfg, tcfg, "sep_avg", (5,))
    ocfg = topt.OptimizerConfig(warmup_steps=2, total_steps=3)
    twin = map_tree(torch.clone, tp)
    warm = tengine.TreeTrainEngine(tcfg, ocfg)
    p1, s1 = warm.warmup(tp, topt.init_opt_state(tp), tplan)
    assert warm.host_syncs == 0 and warm.steps_done == 0
    step = tengine.TreeTrainEngine(tcfg, ocfg)
    p2, s2, _ = step.step(twin, topt.init_opt_state(twin), tplan)
    assert step.host_syncs == 1
    for a, b in zip(tree_leaves(p1) + [s1["step"]], tree_leaves(p2)
                    + [s2["step"]]):
        assert torch.equal(a, b)


def test_with_acc_execution_matches_jax():
    """The accumulating execution: grads streamed into a nonzero fp32
    accumulator and scalars into a vector; into an empty accumulator the
    streamed grads equal the fp32 cast of the plain backward's bit for bit
    (0 + g ≡ g)."""
    from repro_torch.core.gateway import acc_tree, grad_slots
    jcfg, jp, tcfg, tp = _setup("tiny_dense")
    (jplan, tplan), = _plans(jcfg, tcfg, "sep_avg", (5,))
    acc = _rand_tree(jp, 9)
    jb = dict(jplan.packed.inputs, num_trees=3)
    jacc, jscal = jengine._packed_exec_fn(jcfg, "ref", False)(
        jp, jb, jax.tree.map(jnp.asarray, acc), jnp.ones(3, jnp.float32))
    tb = dict(tplan.packed.inputs, num_trees=3)
    tacc, tscal = tengine._packed_exec_fn(tcfg, "ref")(
        tp, tb, tree_leaves(params_from_jax(acc, "cpu")), torch.ones(3))
    np.testing.assert_allclose(tscal.numpy(), np.asarray(jscal), rtol=1e-5)
    assert _max_rel_grads(acc_tree(tp, tacc), jacc) < 1e-4
    loss, metrics, g1 = value_and_grad(tcfg, tp, tb, "ref")
    g2, s2 = tengine._packed_exec_fn(tcfg, "ref")(tp, tb, grad_slots(tp),
                                                  torch.zeros(3))
    for a, b in zip(tree_leaves(g1), tree_leaves(acc_tree(tp, g2))):
        assert torch.equal(a.float(), b)        # 0 + g ≡ g exactly
    assert torch.equal(s2, torch.stack([loss, metrics["nll_sum"],
                                        metrics["weight_sum"]]).float())


@pytest.mark.parametrize("tied", [True, False])
def test_chunked_token_nll_matches_the_plain_loss(tied):
    """``layers.token_nll`` (fp32 logits a few rows at a time, recomputed
    in the backward) against the plain expression logsumexp − label logit
    on full logits: values and the grads of h and of the head at 1e-5
    relative (f32, 7 rows in chunks of 3, 3 and 1)."""
    from repro_torch.models.layers import token_nll
    rng = np.random.default_rng(0)
    D, V = 16, 50
    h = torch.tensor(rng.normal(size=(1, 7, D)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(V, D) if tied else (D, V)) * 0.3,
                     dtype=torch.float32, requires_grad=True)
    labels = torch.tensor(rng.integers(0, V, size=(1, 7)))
    g = torch.tensor(rng.normal(size=(1, 7)), dtype=torch.float32)
    emb, head = ({"table": w}, None) if tied else ({"table": None},
                                                   {"w": w})
    got = token_nll(emb, head, h, labels, chunk=3 * V)
    dh, dw = torch.autograd.grad(got, (h, w), g)
    logits = h @ (w.T if tied else w)
    want = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None])[..., 0]
    rh, rw = torch.autograd.grad(want, (h, w), g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dh, rh, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, rw, rtol=1e-5, atol=1e-6)


def test_engine_grads_are_freed_without_the_cycle_collector():
    """The fp32 gradients ``accumulate`` returns are freed as soon as the
    caller drops them, with Python's cycle collector off: nothing on the
    step's path (``unflatten_like``, the gradient slots, the backward's
    hooks) keeps them in a reference cycle, which on the card held one
    extra gradient set per step until a collection ran."""
    import gc
    import weakref
    jcfg, _, tcfg, tp = _setup("tiny_dense")
    (_, tplan), = _plans(jcfg, tcfg, "sep_avg", (5,))
    engine = tengine.TreeTrainEngine(tcfg)
    gc.collect()
    gc.disable()
    try:
        g, s = engine.accumulate(tp, tplan)
        refs = [weakref.ref(x) for x in tree_leaves(g)]
        del g, s
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_plan_with_partition_waves_raises():
    """Partition waves run now (tests/test_torch_waves.py); what still
    raises is a wave plan for a family whose gateway is not ported (the
    SSM contexts, ROADMAP.md Queue A item 4)."""
    from repro_torch.core.gateway import build_partition_plan
    tcfg = config_from_jax(tiny_cfg("ssm_mamba2"))
    trees = trees_for_batch(5, n_trees=2, kind="random", vocab_size=89)
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        build_partition_plan(tcfg, trees, 16, seq_len=32)
