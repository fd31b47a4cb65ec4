"""The training slice's copies of JAX-free reference modules, held against
their originals exactly: tree statistics and ``linearize_paths``, the tree
generators (``random``, ``agentic``, ``grpo``, and ``chain``, ``por``,
``template``) through ``trees_for_batch``
and ``tree_stream``, the packers (``plan_tree_rows``, ``pack_trees``,
``pack_linear_paths`` in every loss mode) and the Qwen1.5-0.5B config."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core.tree import serialize_tree as jax_serialize  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.bridge import config_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

KINDS = {"random": dict(seg_len_range=(2, 9), max_depth=4),
         "agentic": dict(turn_len_range=(4, 20), num_turns=3),
         "grpo": dict(turn_len_range=(4, 20), num_turns=3)}
TB_FIELDS = ("tokens", "pos_ids", "kv_last", "weight", "prev_idx", "valid",
             "row_trees")


def _trees(kind, seed=3, n=6):
    kw = dict(KINDS[kind], vocab_size=97)
    return (jsyn.trees_for_batch(seed, n_trees=n, kind=kind, **kw),
            tsyn.trees_for_batch(seed, n_trees=n, kind=kind, **kw))


def _same_batch(a, b):
    for f in TB_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert a.num_trees == b.num_trees


@pytest.mark.parametrize("kind", list(KINDS))
def test_generated_trees_and_their_paths_match_jax(kind):
    jt, tt = _trees(kind)
    for a, b in zip(jt, tt):
        assert (a.num_nodes(), a.num_leaves(), a.num_unique_tokens(),
                a.flat_tokens(), a.max_path_tokens(), a.por()) == \
               (b.num_nodes(), b.num_leaves(), b.num_unique_tokens(),
                b.flat_tokens(), b.max_path_tokens(), b.por())
        for pa, pb in zip(a.linearize_paths(), b.linearize_paths(),
                          strict=True):
            assert pa.keys() == pb.keys()
            for key in pa:
                np.testing.assert_array_equal(pa[key], pb[key], err_msg=key)


def test_unported_generators_raise_with_roadmap_item():
    """The generators this once named as unported (chain, por, template)
    are ported now: each gives the reference's trees; an unknown kind
    still raises."""
    kw = {"chain": dict(length=4), "por": dict(target_por=0.5),
          "template": dict(num_templates=2, template_len=24)}
    for kind in ("chain", "por", "template"):
        ja = jsyn.trees_for_batch(3, n_trees=3, kind=kind, **kw[kind])
        tb = tsyn.trees_for_batch(3, n_trees=3, kind=kind, **kw[kind])
        for a, b in zip(ja, tb, strict=True):
            np.testing.assert_array_equal(jax_serialize(a).tokens,
                                          serialize_tree(b).tokens)
            assert a.por() == b.por()
    with pytest.raises(KeyError):
        tsyn.trees_for_batch(0, n_trees=1, kind="no-such-kind")


def test_tree_stream_matches_jax():
    jcfg = jax_get_config("qwen1p5_0p5b", smoke=True)
    kw = dict(seq_len=256, batch_rows=2, trees_per_batch=3, kind="grpo",
              seed=4, gen_kwargs=dict(turn_len_range=(8, 20), num_turns=2))
    js = list(jloader.tree_stream(jcfg, jloader.LoaderConfig(**kw), 3))
    ts = list(tloader.tree_stream(config_from_jax(jcfg),
                                  tloader.LoaderConfig(**kw), 3))
    for ja, tb in zip(js, ts, strict=True):
        for a, b in zip(ja, tb, strict=True):
            sa, sb = jax_serialize(a, loss_mode="rl"), serialize_tree(
                b, loss_mode="rl")
            np.testing.assert_array_equal(sa.weight, sb.weight)
            np.testing.assert_array_equal(sa.tokens, sb.tokens)


@pytest.mark.parametrize("heuristic", ["ffd", "bfd"])
def test_plan_tree_rows_matches_jax(heuristic):
    sizes = list(np.random.default_rng(0).integers(1, 60, 25))
    assert tpack.plan_tree_rows(sizes, 100, heuristic=heuristic,
                                batch_size=20) == \
        jpack.plan_tree_rows(sizes, 100, heuristic=heuristic, batch_size=20)
    with pytest.raises(tpack.DoesNotFitError):
        tpack.plan_tree_rows(sizes, 100, batch_size=2)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("mode", ["sep_avg", "uniform", "rl"])
def test_pack_trees_matches_jax(kind, mode):
    jt, tt = _trees(kind)
    jb = jpack.pack_trees([jax_serialize(t, loss_mode=mode) for t in jt],
                          1024, batch_size=4)
    tb = tpack.pack_trees([serialize_tree(t, loss_mode=mode) for t in tt],
                          1024, batch_size=4)
    _same_batch(jb, tb)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("mode", ["sep_avg", "uniform", "rl"])
def test_pack_linear_paths_matches_jax(kind, mode):
    jt, tt = _trees(kind)
    jb = jpack.pack_linear_paths([t.linearize_paths() for t in jt], 1024,
                                 loss_mode=mode)
    tb = tpack.pack_linear_paths([t.linearize_paths() for t in tt], 1024,
                                 loss_mode=mode)
    _same_batch(jb, tb)


def test_packers_refuse_ssm_chunks():
    _, tt = _trees("random")
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        tpack.pack_trees([serialize_tree(t) for t in tt], 1024, chunk_size=8)


def test_qwen1p5_config_copy_matches_jax():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config("qwen1p5_0p5b", smoke=smoke)) \
            == dataclasses.asdict(jax_get_config("qwen1p5_0p5b", smoke=smoke))
