"""Rollout groups, the copied tree format and the weight bridge of the port
against the JAX package: greedy ``rollout_group`` gives the same tokens,
tree and GroupStats; ``rollouts_to_tree``, ``serialize_tree`` and the tree
generators are exact copies; ``params_from_jax`` round-trips exactly."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tree import serialize_tree as jax_serialize  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serve.decode import rollouts_to_tree as jax_rollouts_to_tree  # noqa: E402
from repro.serve.rollout import RolloutConfig as JaxRolloutConfig  # noqa: E402
from repro.serve.rollout import rollout_group as jax_rollout_group  # noqa: E402
from repro_torch.bridge import (config_from_jax, params_from_jax,  # noqa: E402
                                params_to_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models.model import ParamTree, init_params  # noqa: E402
from repro_torch.serve.decode import rollouts_to_tree  # noqa: E402
from repro_torch.serve.rollout import RolloutConfig, rollout_group  # noqa: E402

SER_FIELDS = ("tokens", "pos_ids", "kv_last", "weight", "prev_idx", "valid",
              "node_id", "node_parent", "node_start", "node_end")


def _same_serialization(a, b):
    for f in SER_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.num_paths == b.num_paths


@pytest.mark.parametrize("name", ["tiny_dense", "qwen2_smoke"])
def test_greedy_rollout_group_matches_jax(name):
    jcfg = (tiny_cfg("dense") if name == "tiny_dense"
            else jax_get_config("qwen2_1p5b", smoke=True))
    jp = jax_init_params(jcfg, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, 12)
    kw = dict(k=3, prompt_len=12, max_new=6, temperature=0.0)
    jtree, jst = jax_rollout_group(jcfg, jp, prompt,
                                   JaxRolloutConfig(impl="pallas", **kw),
                                   jax.random.key(1))
    with torch.inference_mode():
        ttree, tst = rollout_group(config_from_jax(jcfg), tp, prompt,
                                   RolloutConfig(**kw), device="cpu")
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.prefill_tokens == 12 and tst.decode_tokens == 3 * 5
    for mode in ("sep_avg", "rl"):
        _same_serialization(serialize_tree(ttree, loss_mode=mode),
                            jax_serialize(jtree, loss_mode=mode))


def test_rollouts_to_tree_matches_jax():
    """Shared prefixes, a duplicate rollout and a strict prefix."""
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 50, 6)
    a = np.concatenate([prompt, [1, 2, 3, 4]])
    seqs = [a, np.concatenate([prompt, [1, 2, 9]]), a.copy(),
            np.concatenate([prompt, [1, 2]]), np.concatenate([prompt, [7]])]
    rewards = [0.5, 0.1, 0.5, 0.9, 0.0]
    for normalize in (True, False):
        t = rollouts_to_tree(seqs, rewards, prompt_len=6, normalize=normalize)
        j = jax_rollouts_to_tree(seqs, rewards, prompt_len=6,
                                 normalize=normalize)
        _same_serialization(serialize_tree(t, loss_mode="rl"),
                            jax_serialize(j, loss_mode="rl"))


@pytest.mark.parametrize("kind", ["random", "agentic"])
@pytest.mark.parametrize("mode", ["sep_avg", "uniform", "rl"])
def test_tree_copies_match_jax(kind, mode):
    """The copied generators draw the same trees from the same rng, and the
    copied serialize_tree lays them out identically."""
    for seed in range(4):
        kw = dict(turn_len_range=(3, 9)) if kind == "agentic" else {}
        gen_t = getattr(tsyn, f"{kind}_tree")
        gen_j = getattr(jsyn, f"{kind}_tree")
        t = gen_t(np.random.default_rng(seed), **kw)
        j = gen_j(np.random.default_rng(seed), **kw)
        if mode == "rl":
            adv = np.random.default_rng(seed).normal(size=j.num_leaves())
            for lt, lj, a in zip([p[-1] for p in t.paths()],
                                 [p[-1] for p in j.paths()], adv):
                lt.branch_adv = lj.branch_adv = float(a)
        _same_serialization(serialize_tree(t, loss_mode=mode),
                            jax_serialize(j, loss_mode=mode))
        assert t.num_unique_tokens() == j.num_unique_tokens()
        assert t.flat_tokens() == j.flat_tokens()
    np.testing.assert_array_equal(
        tsyn.group_normalized_advantages([1.0, 2.0, 4.0]),
        jsyn.group_normalized_advantages([1.0, 2.0, 4.0]))


def test_bridge_round_trips_params_and_config_exactly():
    jcfg = tiny_cfg("dense")
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    tp = params_from_jax(jp, "cpu")
    back = params_to_numpy(tp)
    flat_j, tree_j = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(config_from_jax(jcfg)) == \
        dataclasses.asdict(jcfg)
    # the module wrapper hands the same tensors back after a device move
    mod = ParamTree(tp).to("cpu")
    for a, b in zip(jax.tree.leaves(params_to_numpy(mod.tree())), flat_j):
        np.testing.assert_array_equal(a, b)


def test_config_copy_and_param_layout_match_jax():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config("qwen2_1p5b", smoke=smoke)) == \
            dataclasses.asdict(jax_get_config("qwen2_1p5b", smoke=smoke))
    cfg = get_config("qwen2_1p5b", smoke=True)
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jax_init_params(jax_get_config("qwen2_1p5b", smoke=True),
                         jax.random.key(0))
    shapes = lambda tree: [tuple(x.shape) for x in jax.tree.leaves(tree)]
    assert jax.tree.structure(params_to_numpy(tp)) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    assert shapes(params_to_numpy(tp)) == shapes(jp)
    assert cfg.param_count() == jax_get_config("qwen2_1p5b",
                                               smoke=True).param_count()
    with pytest.raises(KeyError, match="not ported"):
        get_config("qwen3_8b")
