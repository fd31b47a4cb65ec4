"""The port's SSM building blocks against the JAX package, on the same
numpy-seeded inputs and bridged weights (float32): the tree-aware gathers
(``gather_prev`` with a gateway context, ``prev_powers``,
``tree_causal_conv``), ``tree_chunk_scan`` with an initial state, each SSM
layer's output and gradients (Mamba2, GDN, RWKV6 time-mix and
channel-mix; outputs at 1e-5 and every gradient at max-rel 1e-4 of its
largest entry), and the chunk-aligned serialization and packing, array
by array."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import branching_tree  # noqa: E402
from repro.configs.base import SSMCfg as JSSMCfg  # noqa: E402
from repro.core.packing import pack_linear_paths as jpack_paths  # noqa: E402
from repro.core.packing import pack_trees as jpack_trees  # noqa: E402
from repro.core.tree import serialize_tree as jserialize  # noqa: E402
from repro.data.synthetic import trees_for_batch as jtrees  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.ssm import common as jcommon  # noqa: E402
from repro.models.ssm import gdn as jgdn  # noqa: E402
from repro.models.ssm import mamba2 as jmamba2  # noqa: E402
from repro.models.ssm import rwkv6 as jrwkv6  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import SSMCfg  # noqa: E402
from repro_torch.core.packing import (pack_linear_paths,  # noqa: E402
                                      pack_trees)
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import trees_for_batch  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.ssm import common, gdn, mamba2, rwkv6  # noqa: E402

CS = 8                                   # chunk size of the tiny layers
SSM = {"mamba2": dict(kind="mamba2", d_state=8, head_dim=8, expand=2,
                      chunk_size=CS),
       "gdn": dict(kind="gdn", head_dim=8, expand=1, chunk_size=CS),
       "rwkv6": dict(kind="rwkv6", head_dim=8, expand=1, chunk_size=CS)}
D = 32


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _row(chunk=CS, S=256):
    """A packed, chunk-aligned row of three branching trees (both
    packages' TreeBatch): chunk parents repeat at every branch point."""
    kw = dict(n_trees=3, kind="random", vocab_size=89)
    jb = jpack_trees([jserialize(t, chunk_size=chunk)
                      for t in jtrees(3, **kw)], S, chunk_size=chunk)
    tb = pack_trees([serialize_tree(t, chunk_size=chunk)
                     for t in trees_for_batch(3, **kw)], S, chunk_size=chunk)
    return jb, tb


# --------------------------------------------------------------------------
# chunk-aligned serialization and packing
# --------------------------------------------------------------------------

SER_FIELDS = ("tokens", "pos_ids", "kv_last", "weight", "prev_idx", "valid",
              "node_id", "node_parent", "node_start", "node_end")
TB_FIELDS = ("tokens", "pos_ids", "kv_last", "weight", "prev_idx", "valid",
             "chunk_parent", "row_trees")


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("mode", ["sep_avg", "rl"])
def test_chunk_aligned_serialization_matches_jax(chunk, mode):
    for seed in range(3):
        t = branching_tree(seed)
        rng = np.random.default_rng(seed)
        for leaf in [p[-1] for p in t.paths()]:
            leaf.branch_adv = float(rng.normal())
        a = serialize_tree(t, chunk_size=chunk, loss_mode=mode)
        b = jserialize(t, chunk_size=chunk, loss_mode=mode)
        for f in SER_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        assert a.n % chunk == 0 and not a.valid.all()
        np.testing.assert_array_equal(a.chunk_parent_map(chunk),
                                      b.chunk_parent_map(chunk))
        # pads are inert: no weight, no predecessor, invisible as keys
        pad = ~a.valid
        assert (a.weight[pad] == 0).all() and (a.prev_idx[pad] == -1).all()
        assert (a.kv_last[pad] == -1).all()


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("mode", ["sep_avg", "rl"])
def test_chunk_aligned_packing_matches_jax(chunk, mode):
    kw = dict(n_trees=4, kind="random", vocab_size=89)
    jt, tt = jtrees(5, **kw), trees_for_batch(5, **kw)
    pairs = [(jpack_trees([jserialize(t, chunk_size=chunk, loss_mode=mode)
                           for t in jt], 512, chunk_size=chunk),
              pack_trees([serialize_tree(t, chunk_size=chunk, loss_mode=mode)
                          for t in tt], 512, chunk_size=chunk)),
             (jpack_paths([t.linearize_paths() for t in jt], 1024,
                          chunk_size=chunk, loss_mode=mode),
              pack_linear_paths([t.linearize_paths() for t in tt], 1024,
                                chunk_size=chunk, loss_mode=mode))]
    for jb, tb in pairs:
        for f in TB_FIELDS:
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f),
                                          err_msg=f)
        assert tb.num_trees == jb.num_trees
        assert tb.chunk_parent.shape == (tb.tokens.shape[0],
                                         tb.tokens.shape[1] // chunk)


# --------------------------------------------------------------------------
# tree-aware gathers
# --------------------------------------------------------------------------

def _gateway_prev(rng, B=2, S=24):
    """prev_idx with path predecessors, roots (−1) and gateway slots
    (−2, −3, …) as a partition root's tokens carry them."""
    prev = np.arange(-1, S - 1, dtype=np.int32)[None].repeat(B, 0)
    prev[:, 0] = -2
    prev[:, 9] = 3                       # a branch: 9 and 4 both follow 3
    prev[1, 15] = -1
    prev[0, 20] = -2                     # a second child of the gateway
    return prev


def test_prev_powers_match_jax():
    prev = _gateway_prev(np.random.default_rng(0))
    for k in (1, 3):
        np.testing.assert_array_equal(layers.prev_powers(prev, k),
                                      jlayers.prev_powers(prev, k))


def test_gather_prev_and_tree_causal_conv_match_jax():
    rng = np.random.default_rng(1)
    B, S, C, Tc = 2, 24, 6, 5
    prev = _gateway_prev(rng, B, S)
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    ctx = rng.normal(size=(B, Tc, C)).astype(np.float32)
    w = rng.normal(size=(4, C)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    pp = layers.prev_powers(prev, 3)
    t = {k: torch.tensor(v) for k, v in dict(x=x, ctx=ctx, w=w, b=bias,
                                             prev=prev, pp=pp).items()}
    for c, tc in ((None, None), (ctx, t["ctx"])):
        np.testing.assert_array_equal(
            layers.gather_prev(t["x"], t["prev"], tc).numpy(),
            np.asarray(jlayers.gather_prev(jnp.asarray(x), prev, c)))
        got = layers.tree_causal_conv(t["x"], t["w"], t["b"], t["pp"], tc)
        want = jlayers.tree_causal_conv(jnp.asarray(x), w, bias, pp, c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # the conv's gradient sums every branch's cotangent into shared rows
    ct = rng.normal(size=(B, S, C)).astype(np.float32)
    xt = t["x"].clone().requires_grad_(True)
    layers.tree_causal_conv(xt, t["w"], t["b"], t["pp"]).backward(
        torch.tensor(ct))
    _, vjp = jax.vjp(lambda a: jlayers.tree_causal_conv(a, w, bias, pp),
                     jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(ct)[0]),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# tree_chunk_scan
# --------------------------------------------------------------------------

def test_tree_chunk_scan_with_initial_state_matches_jax():
    """A decaying linear recurrence over the chunk grid of a packed row of
    branching trees, started from a random initial state: outputs and the
    all-states buffer equal the reference's."""
    rng = np.random.default_rng(2)
    jb, tb = _row()
    cp = tb.chunk_parent
    np.testing.assert_array_equal(cp, jb.chunk_parent)
    B, C = cp.shape
    a = -np.abs(rng.normal(size=(B, C, CS, 3))).astype(np.float32)
    u = rng.normal(size=(B, C, CS, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(B, 3, 4)).astype(np.float32)

    def jstep(s, xc):
        aa, uu = xc
        y = s["h"][:, None] * jnp.exp(jnp.cumsum(aa, 1))[..., None] + uu
        return y, {"h": s["h"] * jnp.exp(aa.sum(1))[..., None] + uu.sum(1)}

    def tstep(s, xc):
        aa, uu = xc
        y = s["h"][:, None] * torch.exp(torch.cumsum(aa, 1))[..., None] + uu
        return y, {"h": s["h"] * torch.exp(aa.sum(1))[..., None] + uu.sum(1)}

    jys, jbuf = jcommon.tree_chunk_scan(
        jstep, {"h": jnp.zeros((B, 3, 4))}, (a, u), jnp.asarray(cp),
        {"h": jnp.asarray(h0)})
    tys, states = common.tree_chunk_scan(
        tstep, {"h": torch.zeros(B, 3, 4)},
        (torch.tensor(a), torch.tensor(u)), cp, {"h": torch.tensor(h0)})
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-5,
                               atol=1e-6)
    buf = torch.stack([s["h"] for s in states], 1)
    np.testing.assert_allclose(buf.numpy(), np.asarray(jbuf["h"]), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="host"):
        common.host_parents(torch.zeros(1, 2, dtype=torch.int32,
                                        device="meta"))


# --------------------------------------------------------------------------
# the SSM layers: output and gradients
# --------------------------------------------------------------------------

def _layer_case(kind):
    """(JAX fn, torch fn, JAX params, x) for one layer on the packed row."""
    jb, tb = _row()
    ssm = SSM["rwkv6" if kind == "channelmix" else kind]
    jcfg, tcfg = JSSMCfg(**ssm), SSMCfg(**ssm)
    key = jax.random.key(3)
    B, S = tb.tokens.shape
    pp = layers.prev_powers(tb.prev_idx, 3)
    valid, prev, cp = tb.valid, tb.prev_idx, tb.chunk_parent
    tv, tprev, tpp = (torch.tensor(a) for a in (valid, prev, pp))
    if kind == "mamba2":
        jp = jmamba2.init_mamba2(key, jcfg, D)
        jf = lambda p, x: jmamba2.mamba2(p, jcfg, x, chunk_parent=cp,
                                         prev_pows=pp, valid=valid)
        tf = lambda p, x: mamba2.mamba2(p, tcfg, x, chunk_parent=cp,
                                        prev_pows=tpp, valid=tv)
    elif kind == "gdn":
        jp = jgdn.init_gdn(key, jcfg, D)
        jf = lambda p, x: jgdn.gdn(p, jcfg, x, chunk_parent=cp, prev_pows=pp,
                                   valid=valid)
        tf = lambda p, x: gdn.gdn(p, tcfg, x, chunk_parent=cp, prev_pows=tpp,
                                  valid=tv)
    elif kind == "rwkv6":
        jp = jrwkv6.init_rwkv6_timemix(key, jcfg, D)
        jf = lambda p, x: jrwkv6.rwkv6_timemix(p, jcfg, x, chunk_parent=cp,
                                               prev_idx=prev, valid=valid)
        tf = lambda p, x: rwkv6.rwkv6_timemix(p, tcfg, x, chunk_parent=cp,
                                              prev_idx=tprev, valid=tv)
    else:
        jp = jrwkv6.init_rwkv6_channelmix(key, D, 64)
        jf = lambda p, x: jrwkv6.rwkv6_channelmix(p, x, prev)
        tf = lambda p, x: rwkv6.rwkv6_channelmix(p, x, tprev)
    # give the zero-initialized biases and decays values of their own, so
    # every leaf's gradient path is exercised
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), jp)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    return jf, tf, jp, x


@pytest.mark.parametrize("kind", ["mamba2", "gdn", "rwkv6", "channelmix"])
def test_ssm_layer_output_and_grads_match_jax(kind):
    jf, tf, jp, x = _layer_case(kind)
    ct = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    @jax.jit        # one compile of forward + backward, not op by op
    def fwd_bwd(p, x, ct):
        out, vjp = jax.vjp(jf, p, x)
        return out, vjp(ct)

    out_j, (gp_j, gx_j) = fwd_bwd(jp, jnp.asarray(x), jnp.asarray(ct))
    assert out_j.shape == x.shape

    tp = params_from_jax(jp, "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    out_t = tf(tp, xt)
    assert _max_rel(out_t.detach().numpy(), out_j) < 1e-5
    out_t.backward(torch.tensor(ct))
    assert _max_rel(xt.grad.numpy(), gx_j) < 1e-4
    jl, tl = jax.tree.leaves(gp_j), tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert _max_rel(a.grad.numpy(), b) < 1e-4


@pytest.mark.parametrize("kind", ["mamba2", "gdn"])
def test_ssm_layer_checkpoint_matches_plain_autograd(kind):
    """The recomputed backward (``checkpointed``) gives exactly the
    gradients of autograd on the whole graph."""
    _, tf, jp, x = _layer_case(kind)
    grads = []
    for ck in (True, False):
        tp = params_from_jax(jp, "cpu")
        for leaf in tree_leaves(tp):
            leaf.requires_grad_(True)
        xt = torch.tensor(x, requires_grad=True)
        if ck:
            out = tf(tp, xt)
        else:
            orig = common.checkpointed
            try:
                for m in (mamba2, gdn):
                    m.checkpointed = lambda fn, *a: fn(*a)
                out = tf(tp, xt)
            finally:
                for m in (mamba2, gdn):
                    m.checkpointed = orig
        out.square().sum().backward()
        grads.append([xt.grad] + [p.grad for p in tree_leaves(tp)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
