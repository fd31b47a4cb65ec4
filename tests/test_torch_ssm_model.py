"""The port's SSM and hybrid families (RWKV6, Mamba2, GDN and the Zamba2
hybrid, at the ``tiny_cfg`` sizes) against the JAX package on the same
bridged weights and chunk-aligned packed rows (float32): loss at 1e-5 and
every gradient at max-rel 1e-4 (the bar of tests/test_equivalence.py);
the tree ≡ per-branch baseline identity (Eq. 5) with tree state routing
inside the port; the decode session (prefill through the step loop, fork,
steps) against the reference's at atol = rtol = 5e-4
(tests/test_serve.py); the step loop against the packed forward; and the
launcher on the three new archs (their partitions and waves are held in
tests/test_torch_ssm_partition.py and tests/test_torch_ssm_waves.py)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.core.packing import pack_linear_paths as jpack_paths  # noqa: E402
from repro.core.packing import pack_trees as jpack_trees  # noqa: E402
from repro.core.tree import serialize_tree as jserialize  # noqa: E402
from repro.data.synthetic import trees_for_batch as jtrees  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve.session import DecodeSession as JaxSession  # noqa: E402
from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.core.packing import pack_linear_paths  # noqa: E402
from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import trees_for_batch  # noqa: E402
from repro_torch.device import map_tree, tree_leaves  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.layers import logits_from_hidden  # noqa: E402
from repro_torch.serve.session import DecodeSession  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("ssm_rwkv6", "ssm_mamba2", "ssm_gdn", "hybrid")
TOL_DECODE = 5e-4


def _setup(family):
    jcfg = tiny_cfg(family)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    return jcfg, jp, config_from_jax(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _batches(jcfg, tcfg, S=256, baseline=False, seed=2, n=3):
    """The same chunk-aligned packed rows as JAX and torch model inputs."""
    cs = jcfg.ssm.chunk_size
    kw = dict(n_trees=n, kind="random", vocab_size=jcfg.vocab_size)
    jt, tt = jtrees(seed, **kw), trees_for_batch(seed, **kw)
    if baseline:
        jb = jpack_paths([t.linearize_paths() for t in jt], S, chunk_size=cs)
        tb = pack_linear_paths([t.linearize_paths() for t in tt], S,
                               chunk_size=cs)
    else:
        jb = jpack_trees([jserialize(t, chunk_size=cs) for t in jt], S,
                         chunk_size=cs)
        tb = pack_trees([serialize_tree(t, chunk_size=cs) for t in tt], S,
                        chunk_size=cs)
    return jmodel.prepare_batch(jcfg, jb), tmodel.prepare_batch(
        tcfg, tb, device="cpu")


def _max_rel_grads(tg, jg):
    jl = [np.asarray(x, np.float32) for x in jax.tree.leaves(jg)]
    tl = [x.float().numpy() for x in tree_leaves(tg)]
    assert len(jl) == len(tl)
    return max(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))
               for a, b in zip(tl, jl))


@pytest.mark.parametrize("family,impl,jimpl",
                         [(f, "kernel", "ref") for f in FAMILIES[:3]]
                         + [("hybrid", "kernel", "pallas")])
def test_loss_and_grads_match_jax(family, impl, jimpl):
    jcfg, jp, tcfg, tp = _setup(family)
    jb, tb = _batches(jcfg, tcfg)
    assert isinstance(tb["chunk_parent"], np.ndarray)    # host column
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_and_metrics(jcfg, p, b, jimpl),
        has_aux=True))(jp, jb)
    tl, _, tg = value_and_grad(tcfg, tp, tb, impl)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _max_rel_grads(tg, jg) < 1e-4


@pytest.mark.parametrize("family", FAMILIES)
def test_tree_equals_per_branch_baseline(family):
    """Eq. 5 with tree state routing: the tree-packed rows (siblings read
    their parent chunk's state) and the per-branch baseline give the same
    loss and gradients."""
    jcfg, _, tcfg, tp = _setup(family)
    _, bt = _batches(jcfg, tcfg, S=512)
    _, bl = _batches(jcfg, tcfg, S=1024, baseline=True)
    lt, _, gt = value_and_grad(tcfg, tp, bt, "kernel")
    ll, _, gl = value_and_grad(tcfg, tp, bl, "kernel")
    np.testing.assert_allclose(float(lt), float(ll), rtol=5e-6)
    rel = max(float((a - b).abs().max() / (b.abs().max() + 1e-9))
              for a, b in zip(tree_leaves(gt), tree_leaves(gl)))
    assert rel < 1e-4, rel


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL_DECODE,
                               rtol=TOL_DECODE)


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_session_matches_jax(family):
    """Prefill through the step loop, fork(3), four decode steps, a second
    prefill on the forked session: logits and every state leaf of the
    cache equal the reference's."""
    jcfg, jp, tcfg, tp = _setup(family)
    rng = np.random.default_rng(0)
    V = jcfg.vocab_size
    prompt, tool = rng.integers(0, V, 9), rng.integers(0, V, 4)
    steps = rng.integers(0, V, (3, 4))
    js = JaxSession.create(jcfg, jp, buf_len=24)
    ts = DecodeSession.create(tcfg, tp, buf_len=24, device="cpu")
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
    assert ts.stats.prefill_tokens == js.stats.prefill_tokens == 9 + 3 * 4


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_step_loop_drifts_as_the_reference_does(family):
    """The bf16 step loop's distance from f32 is the model's, not the
    port's.  At the same weights (the reference's bf16 init; the f32 copy
    is their upcast) and 32 teacher-forced tokens, relative L2 of the
    logits against the reference's f32 session: the port's bf16 session
    is at most 1.25x as far as the reference's bf16 session (the ratio
    chip_smoke.py holds the card's full-width step loop to, against the
    forward), and the port's f32 session agrees to 1e-5."""
    jcfg16 = tiny_cfg(family, dtype="bfloat16")
    jp16 = jmodel.init_params(jcfg16, jax.random.key(0))
    jp32 = jax.tree.map(lambda a: a.astype(np.float32)
                        if a.dtype == jax.numpy.bfloat16 else a, jp16)
    toks = np.random.default_rng(5).integers(0, jcfg16.vocab_size, 32)

    def jax_logits(cfg, p):
        sess = JaxSession.create(cfg, p, buf_len=40)
        return np.stack([np.asarray(sess.step(np.array([t]))[0], np.float32)
                         for t in toks])

    def port_logits(cfg, p):
        sess = DecodeSession.create(cfg, p, buf_len=40, device="cpu")
        with torch.inference_mode():
            return torch.stack([sess.step([int(t)])[0] for t in toks]
                               ).float().numpy()

    jcfg32 = jcfg16.replace(dtype="float32")
    j16, j32 = jax_logits(jcfg16, jp16), jax_logits(jcfg32, jp32)
    tp16 = params_from_jax(jax.tree.map(np.asarray, jp16), "cpu")
    t16 = port_logits(config_from_jax(jcfg16), tp16)
    t32 = port_logits(config_from_jax(jcfg32), map_tree(
        lambda t: t.float() if t.dtype == torch.bfloat16 else t, tp16))
    ref, port = _rel_l2(j16, j32), _rel_l2(t16, j32)
    print(f"{family}: bf16 vs the reference's f32 session, relative L2: "
          f"reference {ref:.3e}, port {port:.3e} (ratio {port / ref:.3f}); "
          f"port bf16 vs reference bf16 {_rel_l2(t16, j16):.3e}")
    assert np.isfinite(t16).all() and port <= 1.25 * ref
    assert _rel_l2(t32, j32) < 1e-5


@pytest.mark.parametrize("family", ["ssm_rwkv6", "hybrid"])
def test_step_loop_matches_packed_forward(family):
    """Teacher-forced: the session's logits after each token equal the
    packed forward's logits at that position (one chain, chunk-padded)."""
    _, _, tcfg, tp = _setup(family)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, 13)
    from repro_torch.core.tree import TrajectoryTree, TreeNode
    tree = TrajectoryTree(TreeNode(tokens=toks))
    cs = tcfg.ssm.chunk_size
    tb = pack_trees([serialize_tree(tree, chunk_size=cs)], 16, chunk_size=cs)
    with torch.inference_mode():
        hidden, _ = tmodel.forward(tcfg, tp, tmodel.prepare_batch(
            tcfg, tb, device="cpu"))
        want = logits_from_hidden(tp["embed"], tp.get("lm_head"),
                                  hidden[0, :13])
        sess = DecodeSession.create(tcfg, tp, buf_len=16, device="cpu")
        got = torch.stack([sess.step([int(t)])[0] for t in toks])
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("arch", ["rwkv6_1p6b", "zamba2_1p2b",
                                  "qwen3p5_gdn_2b"])
def test_launcher_smoke_on_cpu(tmp_path, arch):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--steps", "2", "--seq-len", "1024", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "(2 host syncs / 2 steps)" in res.stdout
    assert "nan" not in res.stdout


@pytest.mark.parametrize("family", ["ssm_rwkv6", "hybrid"])
def test_bridge_and_checkpoints_carry_ssm_and_shared_leaves(tmp_path,
                                                             family):
    """``params_from_jax`` is an identity rename for the SSM leaves and the
    hybrid's ``shared_attn``/``shared_in``, and a checkpoint the port
    writes loads in the reference leaf for leaf."""
    from repro.train import checkpoint as jckpt
    from repro_torch.bridge import params_to_numpy
    from repro_torch.train import checkpoint as tckpt
    jcfg, jp, _, tp = _setup(family)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    if family == "hybrid":
        assert {"shared_attn", "shared_in"} <= set(tp)
    tckpt.save_checkpoint(str(tmp_path / "t"), tp, None, meta={"steps": 1})
    jp2 = jckpt.load_checkpoint(str(tmp_path / "t"), jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp2)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("arch", ["rwkv6_1p6b", "zamba2_1p2b",
                                  "qwen3p5_gdn_2b"])
def test_ssm_arch_asked_for_the_card_never_runs_on_the_cpu(arch):
    """Without a CUDA device the SSM and hybrid entry points raise on their
    default device (the card) instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.model import init_params
    cfg = get_config(arch, smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeSession.create(cfg, params, buf_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", arch, "--smoke", "--steps", "1"])
