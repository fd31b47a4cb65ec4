"""The shape-keyed store of decode graphs (``serve/session.GraphPool``),
on the CPU, where a pool keeps eager stand-ins with the card's store and
lease logic: a session leases a free graph of its key at its first step
(its cache copied into the graph's own), captures one only where none is
free, and gives it back at ``close``.  Held within the port, bit for bit,
against sessions without a pool: caches, logits (a second prefill and an
enc-dec ``load_cross`` after the lease too) and rollout trees.  The card's
counterpart (real CUDA graphs) is
``tests/test_torch_cuda.py::test_cuda_pooled_decode_graphs_replay_bit_identically``."""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro_torch.bridge import config_from_jax  # noqa: E402
from repro_torch.device import map_tree, tree_leaves  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve.rollout import RolloutConfig, rollout_group  # noqa: E402
from repro_torch.serve.service import (AsyncTreeRLService,  # noqa: E402
                                       ServiceConfig, WeightStore)
from repro_torch.serve.session import DecodeSession, GraphPool  # noqa: E402

# dense: parallel prefill then batch-K steps; hybrid: the step-loop prefill
# (a batch-1 graph too); audio: the step-loop prefill and cross K/V loaded
# after the lease
FAMILIES = ("dense", "hybrid", "audio")


def _setup(family, seed=0):
    cfg = config_from_jax(tiny_cfg(family))
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")


def _run(cfg, params, pool, seed=3, K=3):
    """prefill → fork(K) → 3 steps → (a second prefill on dense) or
    (``load_cross`` on audio) → 3 steps: every call's logits and the final
    cache (copied: a closed session's cache goes back to the pool)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, 16)
    enc = 5 if cfg.family == "audio" else 0
    s = DecodeSession.create(cfg, params, buf_len=24, enc_len=enc,
                             device="cpu", graph_pool=pool)
    out = [s.prefill(toks[:6])]
    br = s.fork(K)
    for t in toks[6:9]:
        out.append(br.step(torch.full((K,), int(t))))
    if cfg.family == "dense":
        out.append(br.prefill(toks[9:12]))
    if enc:
        shape = br.cache["cross"]["k"].shape
        g = torch.Generator().manual_seed(seed)
        br.load_cross(torch.randn(shape, generator=g),
                      torch.randn(shape, generator=g))
    for t in toks[12:15]:
        out.append(br.step(torch.full((K,), int(t))))
    cache = map_tree(torch.clone, br.cache)
    s.close()
    br.close()
    return out, cache


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("family", FAMILIES)
def test_leased_graph_steps_equal_a_session_of_its_own(family):
    """A second session of one shape leases the first one's graphs (no new
    capture): its logits and its final cache equal, bit for bit, the first
    session's and a pool-less session's."""
    cfg, params = _setup(family)
    pool = GraphPool("cpu")
    a, ca = _run(cfg, params, pool)
    captures = pool.captures
    # a batch-1 graph too where the family prefills through the step loop
    assert captures == (1 if family == "dense" else 2)
    b, cb = _run(cfg, params, pool)
    c, cc = _run(cfg, params, None)
    assert pool.captures == captures and pool.reuses == captures
    assert len(a) == len(b) == len(c)
    assert all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(a, b, c))
    assert _equal_trees(ca, cb) and _equal_trees(ca, cc)


def test_adopted_cache_is_the_sessions_own_bit_for_bit():
    """At the lease the session's cache is copied into the graph's: right
    after the first graphed step the session steps in the graph's cache,
    which equals a pool-less session's cache after the same step."""
    cfg, params = _setup("dense")
    pool = GraphPool("cpu")
    _run(cfg, params, pool)
    caches = []
    for gp in (pool, None):
        s = DecodeSession.create(cfg, params, buf_len=24, device="cpu",
                                 graph_pool=gp)
        s.prefill(np.arange(5))
        br = s.fork(3)
        own = br.cache
        br.step(torch.tensor([1, 2, 3]))
        assert (br.cache is not own) == (gp is not None)
        caches.append(map_tree(torch.clone, br.cache))
        br.close()
    assert _equal_trees(*caches)


def test_two_groups_of_one_shape_share_one_graph():
    """Two rollout groups in a row through one pool: the second captures
    nothing and leases the first one's graph, which is free again after
    each group (``rollout_group`` closes its sessions)."""
    cfg, params = _setup("dense")
    pool = GraphPool("cpu")
    rc = RolloutConfig(k=3, prompt_len=6, max_new=5)
    for i in range(2):
        rollout_group(cfg, params, np.arange(6), rc,
                      torch.Generator().manual_seed(i), device="cpu",
                      graph_pool=pool)
        assert pool.captures == 1 and pool.reuses == i
        assert sum(map(len, pool._graphs.values())) == 1
        assert all(not g.leased for gs in pool._graphs.values()
                   for g in gs)


def test_snapshot_while_the_source_holds_the_lease_gets_its_own_graph():
    cfg, params = _setup("dense")
    pool = GraphPool("cpu")
    s = DecodeSession.create(cfg, params, buf_len=24, device="cpu",
                             graph_pool=pool)
    s.prefill(np.arange(5))
    br = s.fork(2)
    br.step(torch.tensor([1, 2]))
    snap = br.snapshot()
    a = br.step(torch.tensor([4, 4]))
    b = snap.step(torch.tensor([4, 4]))
    assert pool.captures == 2 and pool.reuses == 0
    assert snap.cache is not br.cache and torch.equal(a, b)
    br.close()
    snap.close()
    assert all(not g.leased for gs in pool._graphs.values() for g in gs)


def test_a_dropped_session_gives_its_graph_back():
    """Without ``close`` the lease ends when the session is collected."""
    cfg, params = _setup("dense")
    pool = GraphPool("cpu")
    s = DecodeSession.create(cfg, params, buf_len=24, device="cpu",
                             graph_pool=pool).fork(2)
    s.step(torch.tensor([1, 2]))
    g = s._graph
    assert g.leased
    del s
    gc.collect()
    assert not g.leased


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_rollout_trees_equal_with_and_without_the_store(family):
    """Sampled rollout groups (temperature 1) from one seed: the trees and
    rewards through a pool (the second group leasing the first one's
    graphs) equal those without one."""
    cfg, params = _setup(family)
    rc = RolloutConfig(k=3, prompt_len=6, max_new=6)
    pool = GraphPool("cpu")
    for i in range(2):
        prompt = np.random.default_rng(i).integers(0, cfg.vocab_size, 6)
        got = [rollout_group(cfg, params, prompt, rc,
                             torch.Generator().manual_seed(i), device="cpu",
                             graph_pool=gp) for gp in (pool, None)]
        (ta, sa), (tb, sb) = got
        assert sa.rewards == sb.rewards
        assert [n.tokens.tolist() for n in ta.nodes()] == \
            [n.tokens.tolist() for n in tb.nodes()]
    assert pool.reuses == pool.captures == (2 if family == "hybrid" else 1)


def test_service_with_a_ready_pool_captures_nothing():
    """``AsyncTreeRLService`` handed a pool whose graph a probe group
    captured: its groups lease it through the generator's parameter buffer
    and capture nothing, and the trees equal a service without a pool."""
    cfg, params = _setup("dense")
    rc = RolloutConfig(k=3, prompt_len=6, max_new=4)
    sc = ServiceConfig(groups_per_step=2, max_ahead_steps=2, rollout=rc)
    trees = {}
    for name in ("pool", "plain"):
        pool = buf = None
        if name == "pool":
            pool = GraphPool("cpu")
            with torch.inference_mode():
                buf = map_tree(torch.clone, params)
                rollout_group(cfg, buf, np.zeros(6, np.int32), rc,
                              torch.Generator().manual_seed(9),
                              device="cpu", graph_pool=pool)
        svc = AsyncTreeRLService(cfg, WeightStore(params), sc, num_steps=2,
                                 graph_pool=pool, gen_params=buf).start()
        trees[name] = [[n.tokens.tolist() for t in batch for n in t.nodes()]
                       for batch in svc.tree_batches()]
        svc.join(10)
        assert svc._error is None
        if pool is not None:
            assert pool.captures == 1 and pool.reuses == 4
            assert svc.gen_params is buf
    assert trees["pool"] == trees["plain"] and len(trees["pool"]) == 2
