"""``remat="full"`` in the port: each layer that the reference's scan body
checkpoints (``repro/models/transformer.py:282-286``) recomputed in the
backward under a non-reentrant checkpoint of its own.  Loss and grads
against the reference's ``remat="full"`` on bridged weights, in float32,
at the model-grad bar (1e-4 max-rel, tests/test_equivalence.py:62), for
every family; within the port, every gradient leaf ``torch.equal`` to
``remat="none"`` on a packed engine step and a partition-wave step
(``train/engine.run_partition_plan``), on the trees and shapes of
tests/test_torch_waves.py; a session's prefill and decode step give the
same logits with and without it (nothing is recorded there, so the
layers run as they are)."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_cfg  # noqa: E402
from repro.core.packing import pack_trees as jpack_trees  # noqa: E402
from repro.core.tree import serialize_tree as jserialize  # noqa: E402
from repro.data.synthetic import trees_for_batch as jtrees  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.bridge import config_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import gateway as tgw  # noqa: E402
from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import trees_for_batch  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve.session import DecodeSession  # noqa: E402
from repro_torch.train.engine import (ExecutionPlan, PackedExec,  # noqa: E402
                                      TreeTrainEngine)
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from test_torch_waves import THREE, _moe_cfg, _trees  # noqa: E402
from test_torch_waves import _one_torch_thread  # noqa: E402,F401

FAMILIES = ("dense", "moe", "ssm_rwkv6", "ssm_gdn", "hybrid", "audio", "vlm")


def _jcfg(family, remat="full"):
    jcfg = _moe_cfg() if family == "moe" else tiny_cfg(family)
    return jcfg.replace(remat=remat)


def _setup(jcfg, seed=0):
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jp, config_from_jax(jcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _chunk(cfg):
    return cfg.ssm.chunk_size if cfg.family in ("ssm", "hybrid") else None


def _batches(jcfg, tcfg, S=256, seed=2, n=3):
    """The same packed rows (chunk-aligned for the SSM families, behind
    seeded frontend rows for the enc-dec and VLM ones) as JAX and torch
    model inputs."""
    cs = _chunk(jcfg)
    kw = dict(n_trees=n, kind="random", vocab_size=jcfg.vocab_size)
    jb = jpack_trees([jserialize(t, chunk_size=cs)
                      for t in jtrees(seed, **kw)], S, chunk_size=cs)
    tb = pack_trees([serialize_tree(t, chunk_size=cs)
                     for t in trees_for_batch(seed, **kw)], S, chunk_size=cs)
    ext = None
    if jcfg.frontend:
        ext = np.random.default_rng(seed).normal(
            size=(tb.tokens.shape[0], jcfg.frontend_len,
                  jcfg.d_model)).astype(np.float32)
    return (jmodel.prepare_batch(jcfg, jb, ext),
            tmodel.prepare_batch(tcfg, tb, ext, device="cpu"))


def _max_rel(tl, jl):
    jl = [np.asarray(x, np.float32) for x in jl]
    tl = [x.float().numpy() for x in tl]
    assert len(jl) == len(tl)
    return max(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))
               for a, b in zip(tl, jl))


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_loss_and_grads_match_jax_remat(family):
    """The port at ``remat="full"`` against the reference at
    ``remat="full"`` (its plain attention, under ``jax.jit``): loss within
    1e-5, every gradient within 1e-4 max-rel."""
    jcfg = _jcfg(family)
    jp, tcfg, tp = _setup(jcfg)
    assert tcfg.remat == "full"
    jb, tb = _batches(jcfg, tcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_and_metrics(jcfg, p, b, "ref"),
        has_aux=True))(jp, jb)
    tl, _, tg = value_and_grad(tcfg, tp, tb, "kernel")
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _max_rel(tree_leaves(tg), jax.tree.leaves(jg)) < 1e-4


def _accumulate(tcfg, tp, plan):
    grads, scal = TreeTrainEngine(tcfg).accumulate(tp, plan)
    return tree_leaves(grads), scal


def _packed_plan(tcfg, tt, S=256):
    cs = _chunk(tcfg)
    tb = pack_trees([serialize_tree(t, chunk_size=cs) for t in tt], S,
                    chunk_size=cs)
    return ExecutionPlan(packed=PackedExec(
        inputs=tmodel.batch_arrays(tcfg, tb), tokens=int(tb.valid.sum()),
        cells=tb.tokens.size), num_trees=len(tt))


def _wave_plan(tcfg, tt):
    plan = tgw.build_partition_plan(tcfg, tt, 40, seq_len=48, max_rows=2)
    assert len(plan.waves) >= 3
    return ExecutionPlan(partition=plan, num_trees=len(tt))


@pytest.mark.parametrize("family,kind", [("dense", "packed"),
                                         ("dense", "waves"),
                                         ("moe", "waves"),
                                         ("hybrid", "packed")])
def test_remat_grads_equal_no_remat_bit_for_bit(family, kind):
    """An engine ``accumulate`` (the fp32 slots filled by the
    post-accumulate hooks of ``core/gateway.partition_vjp``) with and
    without remat: every gradient leaf and the scalars ``torch.equal``.
    The hybrid's Mamba2 mixers nest their own checkpoint in the layer's."""
    jcfg = _jcfg(family, "none")
    _, tcfg, tp = _setup(jcfg)
    _, tt = _trees(*THREE)
    make = _wave_plan if kind == "waves" else _packed_plan
    g0, s0 = _accumulate(tcfg, tp, make(tcfg, tt))
    rcfg = dataclasses.replace(tcfg, remat="full")
    g1, s1 = _accumulate(rcfg, tp, make(rcfg, tt))
    assert len(g0) == len(g1)
    assert torch.equal(s0, s1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert any(float(g.abs().max()) > 0 for g in g1)


def test_remat_session_prefill_and_decode_logits_unchanged():
    """A session's parallel prefill and its decode steps record nothing,
    so a ``remat="full"`` model gives the same logits bit for bit."""
    _, tcfg, tp = _setup(tiny_cfg("dense"))
    rcfg = dataclasses.replace(tcfg, remat="full")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, 24)
    out = []
    for cfg in (tcfg, rcfg):
        sess = DecodeSession.create(cfg, tp, buf_len=64, device="cpu")
        lg = [sess.prefill(toks)]
        br = sess.fork(2)
        tok = torch.tensor([5, 7])
        for _ in range(3):
            lg.append(br.step(tok))
            tok = lg[-1].argmax(-1)
        out.append(lg)
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_remat_refuses_an_unknown_mode():
    _, tcfg, tp = _setup(tiny_cfg("dense"))
    jb, tb = _batches(tiny_cfg("dense"), tcfg)
    with pytest.raises(ValueError, match="remat"):
        tmodel.forward(dataclasses.replace(tcfg, remat="dots"), tp, tb)
