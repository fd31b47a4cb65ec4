"""SSM and hybrid Tree Packing over partitions in the port, against the
JAX package (float32, bridged weights, the same seeded trees): the wave
driver (``core/gateway.packed_partitioned_value_and_grad``, the engine's
``run_partition_plan``) for RWKV6, Mamba2, GDN and the Zamba2 hybrid
against the reference's whole trees (loss rtol 2e-5, grads max-rel 1e-4,
the bar of tests/test_partition.py:48-66), with and without a wave row
cap; and the waves' grads bit-identical over two runs."""
import jax
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gateway as tgw  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from test_torch_ssm_partition import (_max_rel, _setup,  # noqa: E402
                                      whole_tree_sum)
from test_torch_waves import THREE, _one_torch_thread, _trees  # noqa: E402,F401


@pytest.mark.parametrize("family,max_rows", [
    ("ssm_rwkv6", 2), ("ssm_mamba2", None), ("ssm_gdn", 2),
    ("hybrid", 2)])
def test_wave_driver_matches_jax_whole_trees(family, max_rows):
    jcfg, jp, tcfg, tp = _setup(family)
    jt, tt = _trees(*THREE)
    l_ref, g_ref = whole_tree_sum(jcfg, jp, jt)
    l_w, g_w, info = tgw.packed_partitioned_value_and_grad(
        tcfg, tp, tt, capacity=40, seq_len=48, max_rows=max_rows)
    assert info["num_waves"] >= 3 and info["num_partitions"] > len(tt)
    if max_rows:
        assert info["max_wave_rows"] <= max_rows
    assert info["unique_tokens"] == sum(t.num_unique_tokens() for t in tt)
    assert abs(l_w - l_ref) <= 2e-5 * abs(l_ref)
    assert _max_rel(tree_leaves(g_w), jax.tree.leaves(g_ref)) < 1e-4


def test_wave_grads_are_bit_identical_run_to_run():
    """Two runs of the hybrid's waves (the shared block's ancestors, the
    Mamba2 states and conv tails relayed across cuts) give the same bits
    in every gradient leaf."""
    _, _, tcfg, tp = _setup("hybrid", seed=1)
    _, tt = _trees(*THREE)
    runs = [tgw.packed_partitioned_value_and_grad(
        tcfg, tp, tt, capacity=40, seq_len=48, max_rows=2)
        for _ in range(2)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)
