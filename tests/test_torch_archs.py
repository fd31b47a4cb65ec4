"""The port's remaining dense and MoE archs against the JAX package:
Qwen3-32B, Qwen3-8B, Llama-4 Scout (16 experts top-1 + a shared expert),
Kimi K2 (384 experts top-8, a shared expert, the first layer dense) and
Nemotron-4 340B (the two-matrix squared-ReLU MLP, hd 192).

Each arch's configs (full and smoke) equal the reference's field by field.
At smoke size, on weights bridged from ``repro.models.model.init_params``
and the same numpy-seeded trees, in float32: forward logits within 1e-4
max-rel; loss and grads of one packed tree step within 1e-5 and 1e-4
max-rel (tests/test_equivalence.py:62); a session's prefill and 4 decode
steps within 1e-4.  The MoE archs run with the aux losses off and a
capacity that never binds (C ≥ N), as tests/test_torch_moe.py does.  Also:
the MLP activations and biases alone, top-1 routing, 384 experts at a
decode step's capacity of 1, one Nemotron-smoke partition wave plan
against the whole tree, and a ``long_context_variant`` session (window 16)
against the reference's step-loop session.  The ``cuda`` cases hold the
kernels against their plain versions at GQA groups of 5 (40/8) and 12
(96/8, hd 192); they need the card, where jax is not installed, so the
reference is imported only where it exists."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 long_context_variant)
from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.core import gateway as tgw  # noqa: E402
from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import random_tree  # noqa: E402
from repro_torch.data.synthetic import trees_for_batch  # noqa: E402
from repro_torch.device import (flatten_tree, map_tree,  # noqa: E402
                                tree_leaves)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.kernels import tree_attention_bwd as tab  # noqa: E402
from repro_torch.kernels.ref import (tree_attention_bwd_ref,  # noqa: E402
                                     tree_attention_ref_ext)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.session import DecodeSession  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

try:        # the card's machine has no jax: only the cuda cases run there
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.core.packing import pack_trees as jpack_trees
    from repro.core.tree import serialize_tree as jserialize
    from repro.data.synthetic import trees_for_batch as jtrees
    from repro.models import layers as jlayers
    from repro.models import model as jmodel
    from repro.models import moe as jmoe
    from repro.models import transformer as jtransformer
    from repro.serve.session import DecodeSession as JaxSession
except ImportError:
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="the JAX reference is "
                               "not installed (the card's machine)")

ARCHS = ["qwen3_32b", "qwen3_8b", "llama4_scout_17b_a16e", "kimi_k2_1t_a32b",
         "nemotron_4_340b"]
BIG = 1 << 30


def _numeric(jcfg):
    """The smoke config the numbers are held on: MoE with the aux losses
    off and capacity factor E/K (C ≥ N: no slot drops)."""
    if jcfg.moe is None:
        return jcfg
    m = jcfg.moe
    return dataclasses.replace(jcfg, moe=dataclasses.replace(
        m, router_aux_weight=0.0, router_z_weight=0.0,
        capacity_factor=m.num_experts / m.top_k))


def _setup(jcfg, seed=0):
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jp, config_from_jax(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _toks(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@needs_jax
def test_registry_holds_every_dense_and_moe_arch_of_the_reference():
    """ARCH_IDS is every arch of the reference in its order (every dense
    and MoE arch among them), and ``get_config`` gives each (full and
    smoke) equal to the reference's."""
    assert ARCH_IDS == jconfigs.ARCH_IDS and len(ARCH_IDS) == 13
    assert sum(get_config(a).family in ("dense", "moe")
               for a in ARCH_IDS) == 8
    for arch in ARCH_IDS:
        for smoke in (False, True):
            assert dataclasses.asdict(get_config(arch, smoke)) == \
                dataclasses.asdict(jconfigs.get_config(arch, smoke))


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_config_and_param_layout_match_jax(arch):
    """Full and smoke configs, their param counts, the layer kinds and, at
    smoke size, every parameter's path, shape and dtype."""
    for smoke in (False, True):
        t, j = get_config(arch, smoke), jconfigs.get_config(arch, smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert transformer.layer_groups(t) == jtransformer.layer_groups(j)
    jcfg = jconfigs.get_config(arch, smoke=True)
    tp = tmodel.init_params(config_from_jax(jcfg),
                            torch.Generator().manual_seed(0), device="cpu")
    jp = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.key(0)))
    desc = lambda t: f"{tuple(t.shape)} {str(t.dtype).split('.')[-1]}"
    want = jax.tree.map(desc, jp)
    got = map_tree(desc, tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.leaves(got) == jax.tree.leaves(want)


def test_long_context_variant_windows_attention_only():
    cfg = get_config("qwen3_8b", smoke=True)
    w = long_context_variant(cfg, window=16)
    assert w.attn.window == 16 and cfg.attn.window is None
    assert dataclasses.replace(w.attn, window=None) == cfg.attn
    assert w.replace(attn=cfg.attn) == cfg
    assert long_context_variant(cfg).attn.window == 8192


# ---------------------------------------------------------------------------
# the layers: MLPs, top-1 and 384-expert routing
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("act,bias", [("swiglu", False), ("swiglu", True),
                                      ("squared_relu", False),
                                      ("squared_relu", True),
                                      ("relu", True)])
def test_mlp_matches_jax(act, bias):
    """init_mlp's keys and shapes, and mlp on bridged weights with nonzero
    biases; relu adds no ``bi``, as the reference's."""
    jp = jlayers.init_mlp(jax.random.key(1), 24, 40, act, bias)
    rng = np.random.default_rng(3)
    if bias:
        jp = {**jp, "bi": jnp.asarray(rng.normal(size=40), jnp.float32),
              "bo": jnp.asarray(rng.normal(size=24), jnp.float32)}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ti = tlayers.init_mlp(torch.Generator().manual_seed(0), 24, 40, act,
                          bias, lead=(3,))
    assert sorted(ti) == sorted(jp)
    assert {k: tuple(v.shape[1:]) for k, v in ti.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.mlp(tp, torch.tensor(x), act).numpy(),
        np.asarray(jlayers.mlp(jp, jnp.asarray(x), act)), rtol=1e-5,
        atol=1e-5)


@needs_jax
@pytest.mark.parametrize("case", ["scout_top1", "kimi_384_decode"])
def test_moe_routing_cases_match_jax(case):
    """Scout's top-1 routing (the renormalised weight is exactly 1) over a
    prefill's tokens; Kimi's 384 experts top-8 at a decode step of 8
    branches, where the reference's capacity rule gives C = 1."""
    if case == "scout_top1":
        jm = jconfigs.get_config("llama4_scout_17b_a16e").moe
        N, D, Fe = 96, 32, 16
    else:
        jm = jconfigs.get_config("kimi_k2_1t_a32b").moe
        N, D, Fe = 8, 32, 8
    jm = dataclasses.replace(jm, d_expert=Fe)
    tm = MoECfg(**dataclasses.asdict(jm))
    jp = jmoe.init_moe(jax.random.key(2), jm, D, "swiglu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(4).normal(size=(N, 1, D)).astype(np.float32)
    valid = np.ones((N, 1), bool)
    jy, _ = jmoe.moe(jp, jm, jnp.asarray(x), jnp.asarray(valid), "swiglu")
    ty, _ = tmoe.moe(tp, tm, torch.tensor(x), torch.tensor(valid), "swiglu")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    _, _, top_p, top_e = tmoe.route(tp, tm, torch.tensor(x).reshape(N, D))
    C = tmoe.capacity(N, tm)
    assert C == int(max(1, round(N * jm.top_k / jm.num_experts
                                 * jm.capacity_factor)))
    _, _, keep = tmoe.queue(top_e, torch.ones(N, dtype=torch.bool),
                            jm.num_experts, C)
    if case == "scout_top1":
        assert top_e.shape == (N, 1) and torch.equal(top_p,
                                                     torch.ones(N, 1))
        assert C == 8
    else:
        assert C == 1 and top_e.shape == (N, 8)
        # at most one (token, slot) per expert is kept
        assert int(keep.sum()) == len(set(top_e.reshape(-1).tolist()))


# ---------------------------------------------------------------------------
# forward, loss and grads, the session
# ---------------------------------------------------------------------------

def _batches(jcfg, tcfg, S=256):
    kw = dict(n_trees=3, kind="random", vocab_size=jcfg.vocab_size)
    jb = jpack_trees([jserialize(t) for t in jtrees(2, **kw)], S)
    tb = pack_trees([serialize_tree(t) for t in trees_for_batch(2, **kw)], S)
    return jmodel.prepare_batch(jcfg, jb), tmodel.prepare_batch(
        tcfg, tb, device="cpu")


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_forward_loss_and_grads_match_jax(arch):
    """Forward logits of the valid tokens within 1e-4 max-rel; the packed
    tree step's loss within 1e-5 and every grad within 1e-4 max-rel (but
    a top-1 router's, which is rounding noise, below).  The port runs its
    kernel path (the plain versions on the CPU), the reference its
    ``ref`` attention."""
    jcfg = _numeric(jconfigs.get_config(arch, smoke=True))
    jp, tcfg, tp = _setup(jcfg)
    jb, tb = _batches(jcfg, tcfg)
    valid = np.asarray(jb["valid"])
    with torch.no_grad():
        th, _ = transformer.forward(tcfg, tp, tb, "kernel")
        tlog = tlayers.logits_from_hidden(tp["embed"], tp.get("lm_head"), th)
    jh, _ = jtransformer.forward(jcfg, jp, jb, "ref")
    jlog = jlayers.logits_from_hidden(jp["embed"], jp.get("lm_head"), jh)
    assert _max_rel(tlog.numpy()[valid], np.asarray(jlog)[valid]) <= 1e-4
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodel.loss_and_metrics(jcfg, p, jb, "ref"),
        has_aux=True)(jp)
    tl, tm, tg = value_and_grad(tcfg, tp, tb, "kernel")
    assert _rel(tl, jl) <= 1e-5
    if jcfg.moe is not None:
        assert float(tm["aux_loss"]) == 0.0
    pairs = [(path, t.numpy(), np.asarray(j)) for (path, t), j in
             zip(flatten_tree(tg), jax.tree.leaves(jg), strict=True)]
    scale = max(float(np.abs(j).max()) for _, _, j in pairs)
    if jcfg.moe is not None and jcfg.moe.top_k == 1:
        # top-1: the renormalised weight p/p is 1 whatever the logits, so
        # with the aux losses off the router's gradient is 0 in exact
        # arithmetic and rounding noise in both packages
        noise = [p for p in pairs if p[0][-1] == "router"]
        assert noise and all(max(np.abs(t).max(), np.abs(j).max())
                             <= 1e-6 * scale for _, t, j in noise)
        pairs = [p for p in pairs if p[0][-1] != "router"]
    assert max(_max_rel(t, j) for _, t, j in pairs) < 1e-4


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_session_matches_jax(arch):
    """prefill 10 tokens (the parallel path), fork(2), 4 decode steps:
    every logits row within 1e-4."""
    jcfg = _numeric(jconfigs.get_config(arch, smoke=True))
    jp, tcfg, tp = _setup(jcfg)
    V = jcfg.vocab_size
    steps = np.stack([_toks(10 + i, 2, V) for i in range(4)], axis=1)
    js = JaxSession.create(jcfg, jp, buf_len=16)
    ts = DecodeSession.create(tcfg, tp, buf_len=16, device="cpu")
    with torch.inference_mode():
        assert ts._can_parallel_prefill(10)
        got = [ts.prefill(_toks(0, 10, V), impl="kernel")]
        want = [js.prefill(_toks(0, 10, V), impl="ref")]
        tf, jf = ts.fork(2), js.fork(2)
        for i in range(4):
            got.append(tf.step(steps[:, i]))
            want.append(jf.step(steps[:, i]))
    for a, b in zip(got, want):
        assert _max_rel(a.numpy(), b) <= 1e-4
    assert tf.t == jf.t == 14


@needs_jax
def test_long_context_variant_session_matches_jax_step_loop():
    """Qwen3-8B smoke with a window of 16: the session takes the step loop
    (as the reference's), its ring is min(buf_len, window) = 16, and a
    24-token prefill that wraps the ring, fork(2) and 4 steps match the
    reference's step-loop session within 1e-4."""
    jcfg = jconfigs.long_context_variant(
        jconfigs.get_config("qwen3_8b", smoke=True), window=16)
    jp, tcfg, tp = _setup(jcfg)
    assert tcfg == long_context_variant(get_config("qwen3_8b", smoke=True),
                                        window=16)
    V = jcfg.vocab_size
    steps = np.stack([_toks(30 + i, 2, V) for i in range(4)], axis=1)
    js = JaxSession.create(jcfg, jp, buf_len=40)
    ts = DecodeSession.create(tcfg, tp, buf_len=40, device="cpu")
    assert ts._ring == js._ring == 16
    assert not ts._can_parallel_prefill(4)
    with torch.inference_mode():
        got = [ts.prefill(_toks(0, 24, V))]
        want = [js.prefill(_toks(0, 24, V))]
        tf, jf = ts.fork(2), js.fork(2)
        for i in range(4):
            got.append(tf.step(steps[:, i]))
            want.append(jf.step(steps[:, i]))
    for a, b in zip(got, want):
        assert _max_rel(a.numpy(), b) <= 1e-4
    np.testing.assert_array_equal(tf.cache["g0"]["pos"].numpy(),
                                  np.asarray(jf.cache["g0"]["pos"]))
    assert tf.t == jf.t == 28


def test_nemotron_partition_waves_match_the_whole_tree():
    """Nemotron smoke (squared_relu, hd 24): two trees partitioned at 40
    tokens into ≥ 3 waves give the loss sum and grads of the same trees
    whole, within 2e-5 and 1e-4 max-rel (tests/test_wave_driver.py's
    bar)."""
    tcfg = get_config("nemotron_4_340b", smoke=True)
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    kw = dict(vocab_size=89, max_depth=5, seg_len_range=(3, 9))
    trees = []
    for s in range(300):
        t = random_tree(np.random.default_rng(s), **kw)
        if t.num_leaves() >= 4 and 60 <= t.num_unique_tokens() <= 120:
            trees.append(t)
        if len(trees) == 2:
            break
    loss, acc = 0.0, None
    for t in trees:
        ser = serialize_tree(t)
        b = tmodel.prepare_batch(tcfg, pack_trees(
            [ser], ((ser.n + 31) // 32) * 32), device="cpu")
        lv, _, g = value_and_grad(tcfg, tp, b, "kernel")
        loss += float(lv)
        g = [x.float() for x in tree_leaves(g)]
        acc = g if acc is None else [a + x for a, x in zip(acc, g)]
    lw, gw, info = tgw.packed_partitioned_value_and_grad(
        tcfg, tp, trees, capacity=40, seq_len=48, max_rows=2)
    assert info["num_waves"] >= 3 and info["max_wave_rows"] <= 2
    assert info["unique_tokens"] == sum(t.num_unique_tokens() for t in trees)
    assert _rel(lw, loss) <= 2e-5
    assert max(_max_rel(a.numpy(), b.numpy())
               for a, b in zip(tree_leaves(gw), acc)) < 1e-4


# ---------------------------------------------------------------------------
# the kernels at the new GQA layouts, on the card
# ---------------------------------------------------------------------------

# (H, Kh, hd): Scout's group of 5, Nemotron's group of 12 at hd 192
CUDA_LAYOUTS = [(40, 8, 128), (96, 8, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Kh,hd", CUDA_LAYOUTS)
def test_cuda_kernels_at_new_gqa_groups_match_plain(H, Kh, hd, dtype):
    """Forward, dq and dk/dv on packed branching trees with gateway
    ancestors (q_off 20, one row front-padded): f32 at 1e-4; bf16 o within
    2^-7·|ref| + 2e-2·(row rms), dq/dk/dv at relative L2 ≤ 1e-2 and every
    element within 5e-2 + 5e-2·|ref|, against the plain versions in f32
    on the same inputs (tests/test_torch_cuda.py's bars)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all([ta.SOURCE, *tab.SOURCES])
    dt = getattr(torch, dtype)
    B, S, A = 2, 384, 20
    trees = trees_for_batch(5, n_trees=16, kind="random",
                            seg_len_range=(1, 12), max_depth=3)
    sers, used = [], 0
    for t in trees:
        s = serialize_tree(t)
        if used + s.n <= B * S * 3 // 4 and s.n <= S:
            sers.append(s)
            used += s.n
    kl = pack_trees(sers, S, batch_size=B).kv_last
    anc = np.full((B, A), BIG)
    anc[0, :7] = -1
    kl = np.concatenate([anc, np.where(kl >= 0, kl + A, -1)], 1)
    kl = torch.tensor(kl, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *sh: torch.randn(sh, generator=g, device="cuda").to(dt)
    q, do = mk(B, S, H, hd), mk(B, S, H, hd)
    k, v = mk(B, S + A, Kh, hd), mk(B, S + A, Kh, hd)
    sc = hd ** -0.5
    with torch.inference_mode():
        o, lse = ops.tree_attention(q, k, v, kl, sc, q_off=A,
                                    save_residuals=True)
        got = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc, q_off=A)
        ro, rl = tree_attention_ref_ext(q.float(), k.float(), v.float(), kl,
                                        sc, q_off=A, return_lse=True)
        want = tree_attention_bwd_ref(q.float(), k.float(), v.float(), kl,
                                      o.float(), lse, do.float(), sc,
                                      q_off=A)
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)
    if dt == torch.float32:
        torch.testing.assert_close(o, ro, rtol=1e-4, atol=1e-4)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        return
    err = (o.float() - ro).abs()
    rms = ro.pow(2).mean(-1, keepdim=True).sqrt()
    assert bool((err <= 2 ** -7 * ro.abs() + 2e-2 * rms).all())
    for a, b in zip(got, want):
        a = a.float()
        assert float((a - b).norm() / b.norm()) <= 1e-2
        assert bool(((a - b).abs() <= 5e-2 + 5e-2 * b.abs()).all())


def test_stacked_init_draws_an_oversized_slice_in_parts(monkeypatch):
    """A stacked leaf's slice whose fp32 draw passes ``_DRAW_BYTES`` (one
    layer of Kimi K2's experts: 22.5 GB) is drawn a sub-slice at a time;
    on the CPU the values are the whole slice's."""
    whole = tlayers._dense_init(torch.Generator().manual_seed(0),
                                (2, 3, 8, 4))
    shapes, real = [], torch.randn

    def spy(*a, **k):
        shapes.append(tuple(a[0]))
        return real(*a, **k)

    monkeypatch.setattr(tlayers, "_DRAW_BYTES", 3 * 8 * 4 * 4 - 1)
    monkeypatch.setattr(torch, "randn", spy)
    parts = tlayers._dense_init(torch.Generator().manual_seed(0),
                                (2, 3, 8, 4))
    assert shapes == [(8, 4)] * 6
    assert torch.equal(parts, whole)
