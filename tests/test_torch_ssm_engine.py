"""One ``TreeTrainEngine.step`` of the Zamba2 hybrid on a mixed plan
(chunk-aligned packed rows plus partition waves) in the port, against the
JAX package's engine step at f32 on bridged weights and the same seeded
trees."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gateway as jgw  # noqa: E402
from repro.core.packing import pack_trees as jpack_trees  # noqa: E402
from repro.core.tree import serialize_tree as jserialize  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import engine as jengine  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.core import gateway as tgw  # noqa: E402
from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import engine as tengine  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from test_torch_ssm_partition import _max_rel, _setup  # noqa: E402
from test_torch_waves import THREE, _one_torch_thread, _trees  # noqa: E402,F401


def test_hybrid_engine_step_on_a_mixed_plan_matches_jax():
    """One ``TreeTrainEngine.step`` of the hybrid over chunk-aligned
    packed rows plus partition waves: the loss, nll and grad norm within
    2e-5 relative, every updated parameter within max-rel 1e-5, one host
    sync, and each wave's ``chunk_parent`` still host data."""
    jcfg, jp, tcfg, tp = _setup("hybrid")
    cs = jcfg.ssm.chunk_size
    jt, tt = _trees(THREE[0])
    jf, tf = _trees((200, 10, 30), (230, 10, 30))
    n = len(jt) + len(jf)
    jtb = jpack_trees([jserialize(t, chunk_size=cs) for t in jf], 48,
                      batch_size=2, chunk_size=cs)
    ttb = pack_trees([serialize_tree(t, chunk_size=cs) for t in tf], 48,
                     batch_size=2, chunk_size=cs)
    jplan = jengine.ExecutionPlan(
        packed=jengine.PackedExec(inputs=jmodel.prepare_batch(jcfg, jtb)),
        partition=jgw.build_partition_plan(jcfg, jt, 40, seq_len=48,
                                           max_rows=2),
        num_trees=n)
    tplan = tengine.ExecutionPlan(
        packed=tengine.PackedExec(inputs=tmodel.batch_arrays(tcfg, ttb),
                                  tokens=int(ttb.valid.sum()),
                                  cells=ttb.tokens.size),
        partition=tgw.build_partition_plan(tcfg, tt, 40, seq_len=48,
                                           max_rows=2),
        num_trees=n)
    assert tplan.has_waves and len(tplan.partition.waves) >= 3
    ocfg = dict(warmup_steps=2, total_steps=3)
    je = jengine.TreeTrainEngine(jcfg, jopt.OptimizerConfig(**ocfg),
                                 donate=False)
    te = tengine.TreeTrainEngine(tcfg, topt.OptimizerConfig(**ocfg))
    jnew, _, jm = je.step(jp, jopt.init_opt_state(jp), jplan)
    tnew, _, tm = te.step(tp, topt.init_opt_state(tp), tplan)
    for key in ("loss", "nll", "grad_norm", "weight_sum"):
        assert abs(tm[key] - jm[key]) <= 2e-5 * abs(jm[key]), key
    assert te.host_syncs == 1
    assert all(isinstance(w.batch["chunk_parent"], np.ndarray)
               for w in tplan.partition.waves)
    assert _max_rel(tree_leaves(tnew), jax.tree.leaves(jnew)) < 1e-5
