"""Tree Packing over partitions, host side: the port's copies of
``core/tree.py``'s partition extras, ``core/partition.py``,
``core/packing.pack_partition_waves`` and
``core/gateway.build_partition_plan`` against the originals, array by
array, on the same seeded trees (random, agentic, GRPO), every loss mode,
several capacities, with and without a wave row cap and a replica row
multiple."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.core import gateway as jgw  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.core import tree as jtree  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.bridge import config_from_jax  # noqa: E402
from repro_torch.core import gateway as tgw  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core import tree as ttree  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

SER_FIELDS = ("tokens", "pos_ids", "kv_last", "weight", "prev_idx", "valid",
              "node_id", "node_parent", "node_start", "node_end")
KINDS = {"random": dict(seg_len_range=(3, 9), max_depth=5, vocab_size=89),
         "agentic": dict(turn_len_range=(4, 24), num_turns=4,
                         vocab_size=97),
         "grpo": dict(turn_len_range=(4, 24), num_turns=4, vocab_size=97)}


def _trees(kind, seed=11, n=4):
    return (jsyn.trees_for_batch(seed, n_trees=n, kind=kind, **KINDS[kind]),
            tsyn.trees_for_batch(seed, n_trees=n, kind=kind, **KINDS[kind]))


def _mode(kind):
    return "rl" if kind == "grpo" else "sep_avg"


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(a, b, err_msg=what)
    assert a.dtype == b.dtype, what


def _same_ser(a, b, what=""):
    for f in SER_FIELDS:
        _same(getattr(a, f), getattr(b, f), f"{what} {f}")
    assert a.num_paths == b.num_paths


def _same_forest(jparts, tparts):
    assert len(jparts) == len(tparts)
    for a, b in zip(jparts, tparts):
        assert (a.pid, a.parent_pid, a.anc_len, a.num_paths_total) == \
            (b.pid, b.parent_pid, b.anc_len, b.num_paths_total)
        _same_ser(a.ser, b.ser, f"partition {a.pid}")
        assert len(a.cuts) == len(b.cuts)
        for ca, cb in zip(a.cuts, b.cuts):
            assert (ca.child_pid, ca.cut_chunk, ca.boundary_pos,
                    ca.boundary_label, ca.boundary_weight) == \
                (cb.child_pid, cb.cut_chunk, cb.boundary_pos,
                 cb.boundary_label, cb.boundary_weight)
            _same(ca.path_token_idx, cb.path_token_idx)


@pytest.mark.parametrize("kind", list(KINDS))
def test_tree_extras_match_jax(kind):
    """``tree_lam_map`` in every loss mode, ``subtree_token_count``,
    ``visibility_mask`` and ``serialize_tree`` with the partition extras
    (an external λ map, a depth offset, the −2 gateway prev slot)."""
    jt, tt = _trees(kind)
    for a, b in zip(jt, tt):
        for mode in ("sep_avg", "uniform", "rl"):
            ja = jtree.tree_lam_map(a.root, mode)
            tb = ttree.tree_lam_map(b.root, mode)
            # keys are id()s of each package's own nodes: compare in DFS
            assert [ja[id(n)] for n in a.nodes()] == \
                [tb[id(n)] for n in b.nodes()]
            lam_a = {k: 0.5 * v + 0.25 for k, v in ja.items()}
            lam_b = {k: 0.5 * v + 0.25 for k, v in tb.items()}
            sa = jtree.serialize_tree(a, loss_mode=mode, lam_map=lam_a,
                                      depth_pos0=7, root_prev=-2)
            sb = ttree.serialize_tree(b, loss_mode=mode, lam_map=lam_b,
                                      depth_pos0=7, root_prev=-2)
            _same_ser(sa, sb, mode)
            _same(jtree.visibility_mask(sa), ttree.visibility_mask(sb))
        ca, cb = jtree.subtree_token_count(a), ttree.subtree_token_count(b)
        assert [ca[id(n)] for n in a.nodes()] == \
            [cb[id(n)] for n in b.nodes()]


def test_ssm_only_paths_raise_with_their_roadmap_item():
    _, tt = _trees("random")
    ser = ttree.serialize_tree(tt[0])
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        ser.chunk_parent_map(8)
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        tpart.partition_tree(tt[0], 32, chunk_size=8)
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        tpack.pack_partition_waves([tpart.partition_tree(tt[0], 32)], 32,
                                   chunk_size=8)
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        tgw.build_partition_plan(config_from_jax(tiny_cfg("ssm_mamba2")),
                                 tt, 32)


@pytest.mark.parametrize("max_len", [1, 3, 5])
def test_split_long_nodes_matches_jax(max_len):
    jt, tt = _trees("random")
    for a, b in zip(jt, tt):
        oa, ob = {}, {}
        sa = jpart.split_long_nodes(a, max_len, oa)
        sb = tpart.split_long_nodes(b, max_len, ob)
        _same_ser(jtree.serialize_tree(sa), ttree.serialize_tree(sb))
        assert len(oa) == len(ob) == sa.num_nodes()


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("capacity", [24, 40, 64])
def test_partition_tree_forest_matches_jax(kind, capacity):
    """Every partition's serialization, ancestry, cuts, capture paths and
    boundary losses, plus the schedule load and token-count helpers."""
    jt, tt = _trees(kind)
    mode = _mode(kind)
    for a, b in zip(jt, tt):
        jp = jpart.partition_tree(a, capacity, loss_mode=mode)
        tp = tpart.partition_tree(b, capacity, loss_mode=mode)
        _same_forest(jp, tp)
        assert jpart.partition_schedule_load(jp) == \
            tpart.partition_schedule_load(tp)
        assert jpart.partition_token_counts(jp) == \
            tpart.partition_token_counts(tp)
        assert jpart.standard_partition_token_counts(
            a, capacity, loss_mode=mode) == \
            tpart.standard_partition_token_counts(b, capacity,
                                                  loss_mode=mode)
    assert jpart.choose_capacity(jt, 2 * capacity) == \
        tpart.choose_capacity(tt, 2 * capacity)


def test_partition_tree_with_an_external_lam_map_matches_jax():
    """A grafted forest partitions with its own λ map (core/forest)."""
    jt, tt = _trees("agentic")
    for a, b in zip(jt, tt):
        ja, tb = jtree.tree_lam_map(a.root, "sep_avg"), \
            ttree.tree_lam_map(b.root, "sep_avg")
        lam_a = {k: 3.0 * v for k, v in ja.items()}
        lam_b = {k: 3.0 * v for k, v in tb.items()}
        _same_forest(jpart.partition_tree(a, 32, lam_map=lam_a),
                     tpart.partition_tree(b, 32, lam_map=lam_b))


def _forests(kind, capacity, seed=11, n=4):
    jt, tt = _trees(kind, seed, n)
    mode = _mode(kind)
    return ([jpart.partition_tree(t, capacity, loss_mode=mode) for t in jt],
            [tpart.partition_tree(t, capacity, loss_mode=mode) for t in tt])


@pytest.mark.parametrize("kind", ["random", "agentic"])
@pytest.mark.parametrize("max_rows", [None, 2])
def test_pack_partition_waves_matches_jax(kind, max_rows):
    """Wave topology (slots, cuts) and every [B, S] column."""
    jf, tf = _forests(kind, 40)
    jw = jpack.pack_partition_waves(jf, 48, max_rows=max_rows)
    tw = tpack.pack_partition_waves(tf, 48, max_rows=max_rows)
    assert len(jw) == len(tw) >= 2
    for a, b in zip(jw, tw):
        assert a.arrays.keys() == b.arrays.keys()
        for k in a.arrays:
            _same(a.arrays[k], b.arrays[k], k)
        assert [vars(s) for s in a.slots] == [vars(s) for s in b.slots]
        assert len(a.cuts) == len(b.cuts)
        for ca, cb in zip(a.cuts, b.cuts):
            _same(ca.path_idx, cb.path_idx)
            assert {k: v for k, v in vars(ca).items() if k != "path_idx"} \
                == {k: v for k, v in vars(cb).items() if k != "path_idx"}
        if max_rows:
            assert b.num_rows <= max_rows


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("max_rows,row_multiple", [(None, 1), (2, 1),
                                                   (3, 2)])
def test_build_partition_plan_matches_jax(kind, max_rows, row_multiple):
    """Every wave's batch (anc_pos, anc_valid, extra_*, the padded rows),
    capture plans, gateway topology (parents, slot_rows, A_real,
    anc_A_max, ancestor positions per row) and the plan's info."""
    jcfg = tiny_cfg("dense")
    jt, tt = _trees(kind)
    mode = _mode(kind)
    jp = jgw.build_partition_plan(jcfg, jt, 32, seq_len=48, loss_mode=mode,
                                  max_rows=max_rows,
                                  row_multiple=row_multiple)
    tp = tgw.build_partition_plan(config_from_jax(jcfg), tt, 32, seq_len=48,
                                  loss_mode=mode, max_rows=max_rows,
                                  row_multiple=row_multiple)
    assert jp.info == tp.info and jp.num_trees == tp.num_trees
    assert tp.info["num_waves"] >= 3
    assert any(w.has_gw for w in tp.waves)
    for a, b in zip(jp.waves, tp.waves, strict=True):
        assert a.batch.keys() == b.batch.keys()
        for k in a.batch:
            _same(a.batch[k], b.batch[k], k)
        assert a.capspecs.keys() == b.capspecs.keys()
        for name in a.capspecs:
            for f in a.capspecs[name]:
                _same(a.capspecs[name][f], b.capspecs[name][f], f)
        assert (a.has_gw, a.num_rows, a.slot_rows, a.A_real, a.anc_A_max) \
            == (b.has_gw, b.num_rows, b.slot_rows, b.A_real, b.anc_A_max)
        assert [vars(p) for p in a.parents] == [vars(p) for p in b.parents]
        for pa, pb in zip(a.anc_pos_rows, b.anc_pos_rows, strict=True):
            _same(pa, pb)
