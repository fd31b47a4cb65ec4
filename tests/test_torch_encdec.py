"""The port's enc-dec family (SeamlessM4T-large v2: a bidirectional
encoder over stub frame embeddings, decoder layers with self- and
cross-attention) against the JAX package, on the same bridged weights and
numpy-seeded inputs, in float32: the config copy field by field with its
parameter count; bidirectional and cross attention, ``project_cross_kv``
and decode's ``cross_cache`` term to 1e-5; forward, loss and gradients of
packed tree rows against the reference at ``impl="pallas"`` (interpret
mode) to 1e-4 max-rel (tests/test_equivalence.py:62); tree ≡ per-branch
baseline inside the port (loss rtol 5e-6, grads 1e-4); the decode session
with ``load_cross`` (the step loop against the packed forward and the
reference's session at 5e-4, tests/test_serve.py:72-114) and ``fork``'s
cross tiling; a greedy ``rollout_group`` at smoke size; the planner's
frame embeddings bit for bit; ``partition_forward``'s refusal; the weight
bridge, the ``.npz`` round trip and the launcher."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.packing import pack_trees as jpack_trees  # noqa: E402
from repro.core.tree import serialize_tree as jserialize  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data.synthetic import trees_for_batch as jtrees  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
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
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.layers import logits_from_hidden  # noqa: E402
from repro_torch.serve.rollout import RolloutConfig, rollout_group  # noqa: E402
from repro_torch.serve.session import DecodeSession  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import planner as tplanner  # noqa: E402
from repro_torch.train.engine import TreeTrainEngine  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.train_step import value_and_grad  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless_m4t_large_v2"
TOL_DECODE = 5e-4


def _setup(jcfg=None, seed=0):
    jcfg = jcfg or tiny_cfg("audio")
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jcfg, jp, config_from_jax(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _frames(seed, B, cfg, invalid_tail=0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, cfg.frontend_len, cfg.d_model)).astype(
        np.float32)
    valid = np.ones((B, cfg.frontend_len), bool)
    if invalid_tail:
        valid[:, -invalid_tail:] = False
    return frames, valid


def branching_tree(seed: int, min_leaves: int, vocab: int = 89):
    """conftest's ``branching_tree``, drawn by the port's generator."""
    for s in range(seed, seed + 200):
        t = random_tree(np.random.default_rng(s), vocab_size=vocab)
        if t.num_leaves() >= min_leaves and t.num_unique_tokens() <= 120:
            return t
    raise RuntimeError("no branching tree found")


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _close(a, b, tol=TOL_DECODE):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _encoder_kv(tcfg, tp, frames, valid=None):
    """Each decoder layer's cross K/V over the port's encoder output,
    stacked [dec_layers, B, T, Kh, hd]."""
    enc, _ = ttransformer.encode(tcfg, tp, torch.as_tensor(frames),
                                 None if valid is None
                                 else torch.as_tensor(valid))
    n = tcfg.encdec.dec_layers
    ks, vs = zip(*[tattn.project_cross_kv(
        {k: v[i] for k, v in tp["layer_stacks"][0]["xattn"].items()},
        tcfg.attn, enc) for i in range(n)])
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_config_copy_and_param_layout_match_jax():
    """``config()`` and ``smoke()`` field by field, ``param_count``, and the
    smoke model's parameter tree (encoder stack, ``enc_norm``, each
    decoder layer's ``ln_x`` and ``xattn`` without q/k norm) leaf for leaf
    in shape and dtype."""
    for smoke in (False, True):
        tcfg, jcfg = get_config(ARCH, smoke), jget_config(ARCH, smoke)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.param_count() == jcfg.param_count()
    assert round(get_config(ARCH).param_count() / 1e9, 3) == 2.035
    jcfg = jget_config(ARCH, smoke=True)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    tp = tmodel.init_params(config_from_jax(jcfg),
                            torch.Generator().manual_seed(0), device="cpu")
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert {"encoder", "enc_norm"} <= set(tp)
    assert "q_norm" not in tp["layer_stacks"][0]["xattn"]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qk_norm", [False, True])
def test_bidirectional_cross_and_decode_cross_attention_match_jax(qk_norm):
    """The encoder's bidirectional attention (keys masked by ``valid``, no
    RoPE; impl 'ref' and 'kernel' both the plain softmax), the cross
    branch over ``project_cross_kv`` with a masked key, and decode's
    ``cross_cache`` term, on the same weights and inputs."""
    jcfg = tiny_cfg("audio")
    a = dataclasses.replace(jcfg.attn, qk_norm=qk_norm, qkv_bias=True)
    D, B, S, T = jcfg.d_model, 2, 11, 7
    jp_self = jattn.init_attention(jax.random.key(1), a, D)
    jp_x = jattn.init_attention(jax.random.key(2), a, D, cross=True)
    assert "q_norm" not in jp_x
    rng = np.random.default_rng(3)
    for p in (jp_self, jp_x):       # nonzero biases
        for k in ("bq", "bk", "bv"):
            p[k] = jnp.asarray(rng.normal(size=p[k].shape), jnp.float32)
    tp_self = params_from_jax(jax.tree.map(np.asarray, jp_self), "cpu")
    tp_x = params_from_jax(jax.tree.map(np.asarray, jp_x), "cpu")
    ta = config_from_jax(jcfg.replace(attn=a)).attn
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    enc = rng.normal(size=(B, T, D)).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[0, -3:] = False
    cvalid = np.ones((B, T), bool)
    cvalid[1, :2] = False
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kl = np.full((B, S), S - 1, np.int32)

    want = jattn.attention(jp_self, a, jnp.asarray(x), pos_ids=pos,
                           kv_last=kl, valid=jnp.asarray(valid),
                           impl="pallas", bidirectional=True)
    for impl in ("ref", "kernel"):
        got = tattn.attention(tp_self, ta, torch.as_tensor(x),
                              pos_ids=torch.as_tensor(pos),
                              kv_last=torch.as_tensor(kl),
                              valid=torch.as_tensor(valid), impl=impl,
                              bidirectional=True)
        _close(got.numpy(), want, 1e-5)

    jk, jv = jattn.project_cross_kv(jp_x, a, jnp.asarray(enc))
    tk, tv = tattn.project_cross_kv(tp_x, ta, torch.as_tensor(enc))
    _close(tk.numpy(), jk, 1e-5)
    _close(tv.numpy(), jv, 1e-5)
    want = jattn.attention(jp_x, a, jnp.asarray(x), pos_ids=pos, kv_last=kl,
                           valid=jnp.asarray(valid), cross_kv=(jk, jv),
                           cross_valid=jnp.asarray(cvalid))
    got = tattn.attention(tp_x, ta, torch.as_tensor(x),
                          pos_ids=torch.as_tensor(pos),
                          kv_last=torch.as_tensor(kl), cross_kv=(tk, tv),
                          cross_valid=torch.as_tensor(cvalid))
    _close(got.numpy(), want, 1e-5)

    # one decode step with the cross_cache term, on a 5-slot ring
    jcache = jattn.init_kv_cache(B, 5, a, jnp.float32)
    tcache = {k: torch.as_tensor(np.array(v)) for k, v in jcache.items()}
    xd = x[:, :1]
    posd = np.array([0, 0], np.int32)
    jy, _ = jattn.decode_attention(
        jp_self, a, jnp.asarray(xd), jcache, jnp.asarray(posd), 0,
        cross_cache={"k": jk, "v": jv, "valid": jnp.asarray(cvalid)})
    ty = tattn.decode_attention(
        tp_self, ta, torch.as_tensor(xd), tcache, torch.as_tensor(posd),
        torch.zeros(1, dtype=torch.long),
        cross_cache={"k": tk, "v": tv, "valid": torch.as_tensor(cvalid)})
    _close(ty.numpy(), jy, 1e-5)


# ---------------------------------------------------------------------------
# forward, loss and grads
# ---------------------------------------------------------------------------

def _batches(jcfg, tcfg, S=256, seed=2, n=3, invalid_tail=0):
    kw = dict(n_trees=n, kind="random", vocab_size=jcfg.vocab_size)
    jb = jpack_trees([jserialize(t) for t in jtrees(seed, **kw)], S)
    tb = pack_trees([serialize_tree(t) for t in trees_for_batch(seed, **kw)],
                    S)
    frames, valid = _frames(seed, tb.tokens.shape[0], jcfg, invalid_tail)
    ev = valid if invalid_tail else None
    jbatch = jmodel.prepare_batch(jcfg, jb, frames)
    if ev is not None:
        jbatch["extra_valid"] = jnp.asarray(ev)
    return jbatch, tmodel.prepare_batch(tcfg, tb, frames, extra_valid=ev,
                                        device="cpu")


def test_forward_matches_jax():
    """Hidden states of packed tree rows at their valid tokens (a padding
    token sees no key: the oracle averages every value there, the
    kernels give 0), the encoder over frames with a masked tail
    (``extra_valid``), against the reference's oracle path."""
    jcfg, jp, tcfg, tp = _setup()
    jb, tb = _batches(jcfg, tcfg, invalid_tail=3)
    jh, _ = jax.jit(lambda p, b: jmodel.forward(jcfg, p, b, "ref"))(jp, jb)
    with torch.no_grad():
        th, _ = tmodel.forward(tcfg, tp, tb, "kernel")
    assert th.shape == jh.shape
    ok = tb["valid"].numpy()
    assert _max_rel(th.numpy()[ok], np.asarray(jh)[ok]) < 1e-4


def test_loss_and_grads_match_jax_pallas():
    """Loss within 1e-5 and every gradient within 1e-4 max-rel of the
    reference's ``impl="pallas"`` (interpret mode), the port on the plain
    versions of its kernels."""
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
    assert float(np.abs(tg["encoder"]["attn"]["wq"].numpy()).max()) > 0


def test_tree_equals_per_branch_baseline():
    """Eq. 5 with an encoder: the tree row and its linearized paths (each
    path row the same frames) give the same loss and gradients."""
    _, _, tcfg, tp = _setup(seed=1)
    tt = branching_tree(5, min_leaves=4)
    tb = pack_trees([serialize_tree(tt)], 128)
    lb = pack_linear_paths([tt.linearize_paths()], 128)
    ext, _ = _frames(0, 1, tcfg)
    bt = tmodel.prepare_batch(tcfg, tb, ext, device="cpu")
    bl = tmodel.prepare_batch(tcfg, lb, np.repeat(ext, lb.tokens.shape[0],
                                                  0), device="cpu")
    lt, _, gt = value_and_grad(tcfg, tp, bt, "kernel")
    ll, _, gl = value_and_grad(tcfg, tp, bl, "kernel")
    np.testing.assert_allclose(float(lt), float(ll), rtol=5e-6)
    rel = max(_max_rel(a.numpy(), b.numpy())
              for a, b in zip(tree_leaves(gt), tree_leaves(gl)))
    assert rel < 1e-4, rel


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_session_load_cross_step_loop_matches_forward_and_jax():
    """The step loop with the encoder's cross K/V installed (``load_cross``)
    equals the packed forward's logits at each position and the reference
    session's; the cross term changes the logits; a second ``load_cross``
    on a session that already stepped rewrites the same buffers."""
    jcfg, jp, tcfg, tp = _setup()
    B, S, F = 1, 10, jcfg.frontend_len
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, S).astype(
        np.int32)
    frames, _ = _frames(2, B, jcfg)
    from repro_torch.core.tree import TrajectoryTree, TreeNode
    ser = serialize_tree(TrajectoryTree(TreeNode(tokens=toks)))
    with torch.inference_mode():
        h, _ = tmodel.forward(tcfg, tp, tmodel.prepare_batch(
            tcfg, pack_trees([ser], ser.n), frames, device="cpu"))
        want = logits_from_hidden(tp["embed"], tp.get("lm_head"), h)[0]
        k, v = _encoder_kv(tcfg, tp, frames)
        sess = DecodeSession.create(tcfg, tp, buf_len=S, enc_len=F,
                                    device="cpu")
        bufs = (sess.cache["cross"]["k"], sess.cache["cross"]["v"])
        first = sess.step(toks[:1])[0]          # cross K/V still zeros
        sess.load_cross(k, v)
        assert sess.cache["cross"]["k"] is bufs[0]
        assert sess.cache["cross"]["v"] is bufs[1]
        sess2 = DecodeSession.create(tcfg, tp, buf_len=S, enc_len=F,
                                     device="cpu")
        sess2.load_cross(k, v)
        got = torch.stack([sess2.step(toks[t:t + 1])[0] for t in range(S)])
    _close(got.numpy(), want.numpy())
    assert not np.allclose(first.numpy(), got[0].numpy(), atol=1e-3)

    jsess = JaxSession.create(jcfg, jp, buf_len=S, enc_len=F)
    enc_meta = dict(
        pos_ids=jnp.broadcast_to(jnp.arange(F, dtype=jnp.int32), (B, F)),
        kv_last=jnp.full((B, F), F - 1, jnp.int32),
        prev_idx=jnp.full((B, F), -1, jnp.int32), valid=jnp.ones((B, F), bool))
    from repro.models.layers import rmsnorm as jrmsnorm
    enc_x, _ = jtransformer._scan_group(jcfg, jp["encoder"], "encoder",
                                        jnp.asarray(frames), enc_meta, "ref")
    enc = jrmsnorm(jp["enc_norm"], enc_x, jcfg.norm_eps)
    dec = jp["layer_stacks"][0]
    jks, jvs = zip(*[jattn.project_cross_kv(
        jax.tree.map(lambda a, i=i: a[i], dec)["xattn"], jcfg.attn, enc)
        for i in range(jcfg.encdec.dec_layers)])
    _close(k.numpy(), jnp.stack(jks), 1e-5)
    jsess.load_cross(jnp.stack(jks), jnp.stack(jvs))
    jout = jnp.stack([jsess.step(toks[t:t + 1])[0] for t in range(S)])
    _close(got.numpy(), jout)


def test_fork_tiles_the_cross_cache_as_jax():
    """fork(3) after a masked ``load_cross`` and two steps: the cross
    ``valid`` tiles on axis 0, k/v on axis 1; the forks' steps and every
    cache leaf equal the reference's."""
    jcfg, jp, tcfg, tp = _setup()
    F = jcfg.frontend_len
    rng = np.random.default_rng(4)
    k = rng.normal(size=(2, 1, F, 4, 8)).astype(np.float32)
    v = rng.normal(size=(2, 1, F, 4, 8)).astype(np.float32)
    valid = np.ones((1, F), bool)
    valid[0, 5:] = False
    toks = rng.integers(0, jcfg.vocab_size, 6)
    steps = rng.integers(0, jcfg.vocab_size, (3, 3))
    js = JaxSession.create(jcfg, jp, buf_len=12, enc_len=F)
    js.load_cross(jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid))
    ts = DecodeSession.create(tcfg, tp, buf_len=12, enc_len=F, device="cpu")
    with torch.inference_mode():
        ts.load_cross(torch.as_tensor(k), torch.as_tensor(v),
                      torch.as_tensor(valid))
        _close(ts.prefill(toks), js.prefill(toks))
        jf, tf = js.fork(3), ts.fork(3)
        assert tuple(tf.cache["cross"]["valid"].shape) == (3, F)
        assert tuple(tf.cache["cross"]["k"].shape) == (2, 3, F, 4, 8)
        for i in range(3):
            _close(tf.step(steps[:, i]), jf.step(steps[:, i]))
    for g, grp in tf.cache.items():
        for leaf, a in grp.items():
            _close(a.float().numpy(), np.asarray(jf.cache[g][leaf],
                                                 np.float32))
    assert tf.enc_len == F and tf.t == jf.t == 9


def test_greedy_rollout_group_matches_jax_at_smoke_size():
    """``rollout_group`` on the smoke config makes its session with no
    encoder output (enc_len 0, the reference's ``rollout.py:133``): the
    cross term attends to no key.  Greedy, the same tokens, tree and
    stats as the reference's."""
    jcfg, jp, tcfg, tp = _setup(jget_config(ARCH, smoke=True))
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, 12)
    kw = dict(k=3, prompt_len=12, max_new=6, temperature=0.0)
    jtree, jst = jrollout_group(jcfg, jp, prompt, JaxRolloutConfig(**kw),
                                jax.random.key(1))
    with torch.inference_mode():
        ttree, tst = rollout_group(tcfg, tp, prompt, RolloutConfig(**kw),
                                   device="cpu")
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.prefill_tokens == 12 and tst.decode_tokens == 3 * 5
    a, b = serialize_tree(ttree, loss_mode="rl"), jserialize(
        jtree, loss_mode="rl")
    for f in ("tokens", "pos_ids", "kv_last", "weight", "prev_idx"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# training path
# ---------------------------------------------------------------------------

def _loader_cfgs(**kw):
    kw = dict(dict(seq_len=128, batch_rows=2, trees_per_batch=3, seed=5,
                   kind="agentic",
                   gen_kwargs=dict(turn_len_range=(4, 16), num_turns=3)),
              **kw)
    return jloader.LoaderConfig(**kw), tloader.LoaderConfig(**kw)


def test_planner_frame_embeddings_equal_jax():
    """Each planned step's stub frame embeddings, ``np.random.
    default_rng([seed, 7919, index])`` normal f32 [B, frontend_len, D],
    are the reference planner's bit for bit, and ride to the device with
    the other columns."""
    jcfg = tiny_cfg("audio")
    jlc, tlc = _loader_cfgs()
    jsteps = list(jplanner.plan_stream(jcfg, jlc, 3,
                                       jplanner.PlannerConfig()))
    tsteps = list(tplanner.plan_stream(config_from_jax(jcfg), tlc, 3,
                                       tplanner.PlannerConfig()))
    n = 0
    for a, b in zip(jsteps, tsteps, strict=True):
        ea = a.step_batch().inputs
        eb = b.step_batch().inputs
        if ea is None:
            assert eb is None
            continue
        assert eb["extra_embeds"].dtype == np.float32
        assert eb["extra_embeds"].shape == (2, jcfg.frontend_len,
                                            jcfg.d_model)
        assert np.array_equal(np.asarray(ea["extra_embeds"]),
                              eb["extra_embeds"])
        n += 1
    assert n >= 2


def test_engine_step_and_oversized_trees_raise_as_jax():
    """A packed step through ``TreeTrainEngine`` (one host sync) trains the
    encoder too; trees larger than a row, routed to partition waves,
    raise in ``partition_forward`` as the reference's do."""
    jcfg = tiny_cfg("audio")
    tcfg = config_from_jax(jcfg)
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    before = tp["encoder"]["mlp"]["wi_up"].clone()
    opt = OptimizerConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    eng = TreeTrainEngine(tcfg, opt)
    _, tlc = _loader_cfgs()
    plan = next(iter(tplanner.plans(tcfg, tlc, 1, tplanner.PlannerConfig(
        plan_workers=0)))).execution_plan()
    tp, _, m = eng.step(tp, init_opt_state(tp), plan)
    assert eng.host_syncs == 1 and np.isfinite(m["loss"])
    assert not torch.equal(before, tp["encoder"]["mlp"]["wi_up"])

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
    with pytest.raises(NotImplementedError, match="partitioned training"):
        ttransformer.partition_forward(tcfg, tp, {}, None, {}, "kernel")


def test_bridge_and_checkpoints_carry_the_encoder(tmp_path):
    """The encoder stack, ``enc_norm`` and each decoder layer's ``xattn``
    bridge by identity rename, and an ``.npz`` checkpoint written by
    either package loads in the other leaf for leaf."""
    jcfg, jp, _, tp = _setup()
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tckpt.save_checkpoint(str(tmp_path / "t"), tp, None, meta={"steps": 1})
    jp2 = jckpt.load_checkpoint(str(tmp_path / "t"), jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp2)):
        np.testing.assert_array_equal(a, np.asarray(b))
    jckpt.save_checkpoint(str(tmp_path / "j"), jp, None, meta={"steps": 1})
    tp2 = tckpt.load_checkpoint(str(tmp_path / "j"), tp)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp2),
                                                 tree_leaves(tp)))
    assert {"encoder", "enc_norm"} <= set(tp2)


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
    assert "family=audio" in res.stdout and "nan" not in res.stdout
