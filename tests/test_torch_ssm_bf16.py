"""The hybrid's partition waves in bf16, beside the JAX package's: at the
same weights (the reference's bf16 init, bridged) and the same seeded
tree, the port's wave-driven gradient is no further from its whole tree's
than the reference's is from the reference's own.  chip_smoke.py's
full-depth wave parity (b) leans on it for Zamba2, whose bf16 partitioned
gradient is further than 5e-2 from its bf16 whole tree's."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.core import gateway as jgw  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import gateway as tgw  # noqa: E402
from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from test_torch_ssm_partition import whole_tree_sum  # noqa: E402
from test_torch_waves import THREE, _one_torch_thread, _trees  # noqa: E402,F401


def _rel_l2(a, b):
    a = np.concatenate([np.asarray(x, np.float32).ravel() for x in a])
    b = np.concatenate([np.asarray(x, np.float32).ravel() for x in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_waves_drift_from_the_whole_tree_as_the_reference_does():
    """In bf16 the hybrid's partitioned gradient is as far from its whole
    tree's as the reference's is from the reference's own: at the same
    weights (the reference's bf16 init) and tree, relative L2 of the
    waves' gradient against the whole tree's, the port's at most 1.25x
    the reference's.  chip_smoke.py's full-depth wave parity (b) leans on
    it for Zamba2."""
    jcfg = tiny_cfg("hybrid", dtype="bfloat16")
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    tcfg = config_from_jax(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jt, tt = _trees(THREE[0])
    _, jg_whole = whole_tree_sum(jcfg, jp, jt)
    _, jg_waves, _ = jgw.packed_partitioned_value_and_grad(
        jcfg, jp, jt, capacity=40, seq_len=48, max_rows=2)
    _, tg_waves, info = tgw.packed_partitioned_value_and_grad(
        tcfg, tp, tt, capacity=40, seq_len=48, max_rows=2)
    cs = tcfg.ssm.chunk_size
    sers = [serialize_tree(t, chunk_size=cs) for t in tt]
    b = tmodel.prepare_batch(tcfg, pack_trees(
        sers, 32 * -(-sum(s.n for s in sers) // 32), chunk_size=cs),
        device="cpu")
    _, _, tg_whole = value_and_grad(tcfg, tp, b, "kernel")
    assert info["num_waves"] >= 3
    ref = _rel_l2(jax.tree.leaves(jg_waves), jax.tree.leaves(jg_whole))
    port = _rel_l2([g.numpy() for g in tree_leaves(tg_waves)],
                   [g.float().numpy() for g in tree_leaves(tg_whole)])
    print(f"hybrid bf16, waves vs whole tree, gradient relative L2: "
          f"reference {ref:.3e}, port {port:.3e} (ratio {port / ref:.3f})")
    assert 0 < port <= 1.25 * ref
