"""The port's tree-attention op and skip predicate against the JAX package.

On the CPU ``repro_torch.kernels.ops.tree_attention`` runs its plain
version; the JAX side runs its Pallas kernel in interpret mode.  Same
inputs (numpy, from a seed) go to both; tolerance 2e-5 in f32, the
reference's own kernel tolerance (tests/test_kernels.py).  The CUDA
kernels are held against their plain versions on the card by
``tests/test_torch_cuda.py``, which imports no jax and so runs there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import tree_attention as jta  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.kernels import tree_attention_bwd as tab  # noqa: E402
from test_kernels import _gateway_meta, _tree_meta  # noqa: E402

TOL = 2e-5


def _case(name):
    """(q, k, v, kv_last, q_off, window, pos_q, pos_k, block_q, block_k)
    as numpy, f32."""
    rng = np.random.default_rng(CASES.index(name))
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    if name in ("mha", "gqa", "mqa"):
        B, S, H, Kh, hd, bq, bk = {"mha": (1, 64, 4, 4, 16, 16, 16),
                                   "gqa": (2, 128, 4, 2, 16, 32, 32),
                                   "mqa": (1, 128, 8, 1, 32, 32, 64)}[name]
        kl, _ = _tree_meta(S, B, S)
        return (mk(B, S, H, hd), mk(B, S, Kh, hd), mk(B, S, Kh, hd),
                np.asarray(kl), 0, None, None, None, bq, bk)
    if name == "padding":
        kl = np.full((1, 64), -1, np.int32)
        kl[0, :16] = 15
        return (mk(1, 64, 2, 16), mk(1, 64, 2, 16), mk(1, 64, 2, 16), kl, 0,
                None, None, None, 16, 16)
    if name.startswith("gateway"):
        A, pad = {"gateway32": (32, (0, 7)), "gateway20": (20, (5, 0))}[name]
        kl, _, _, _ = _gateway_meta(5, 2, 64, A, pad)
        return (mk(2, 64, 4, 16), mk(2, A + 64, 2, 16), mk(2, A + 64, 2, 16),
                np.asarray(kl), A, None, None, None, 32, 32)
    if name == "window":
        kl, pos = _tree_meta(11, 2, 128)
        return (mk(2, 128, 4, 16), mk(2, 128, 4, 16), mk(2, 128, 4, 16),
                np.asarray(kl), 0, 8, np.asarray(pos), np.asarray(pos), 32, 32)
    raise KeyError(name)


CASES = ["mha", "gqa", "mqa", "padding", "gateway32", "gateway20", "window"]


def _port(q, k, v, kl, q_off, window, pq, pk, **kw):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    return ops.tree_attention(t(q), t(k), t(v), t(kl), q.shape[-1] ** -0.5,
                              q_off=q_off, window=window, pos_q=t(pq),
                              pos_k=t(pk), **kw)


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax_op(name):
    q, k, v, kl, q_off, window, pq, pk, bq, bk = _case(name)
    j = jops.tree_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(kl), q.shape[-1] ** -0.5, bq, bk,
                            q_off=q_off, window=window,
                            pos_q=None if pq is None else jnp.asarray(pq),
                            pos_k=None if pk is None else jnp.asarray(pk))
    o = _port(q, k, v, kl, q_off, window, pq, pk)
    np.testing.assert_allclose(o.numpy(), np.asarray(j), atol=TOL, rtol=TOL)
    if name == "padding":                 # fully masked rows give exact 0
        assert np.all(o.numpy()[0, 16:] == 0.0)


@pytest.mark.parametrize("name", ["gqa", "padding", "gateway20", "window"])
def test_lse_matches_jax_forward_residuals(name):
    q, k, v, kl, q_off, window, pq, pk, bq, bk = _case(name)
    pad = -k.shape[1] % bk                # the Pallas forward wants Skv % bk
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    klp = np.pad(kl, ((0, 0), (0, pad)), constant_values=-1)
    pkp = None if pk is None else np.pad(pk, ((0, 0), (0, pad)))
    jo, jl = jta.tree_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(klp),
        q.shape[-1] ** -0.5, block_q=bq, block_k=bk, q_off=q_off,
        window=window, pos_q=None if pq is None else jnp.asarray(pq),
        pos_k=None if pkp is None else jnp.asarray(pkp),
        save_residuals=True, interpret=True)
    o, lse = _port(q, k, v, kl, q_off, window, pq, pk, save_residuals=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])


@pytest.mark.parametrize("bq", [16, 32])
@pytest.mark.parametrize("name", CASES)
def test_block_live_mask_matches_jax(name, bq):
    q, k, v, kl, q_off, window, pq, pk, _, _ = _case(name)
    S, Skv = q.shape[1], k.shape[1]
    # the reference predicate needs blocks that divide S and Skv
    bk = next(b for b in (64, 32, 16, 12) if Skv % b == 0)
    for b in range(q.shape[0]):
        kw = dict(q_off=q_off, window=window,
                  pos_q=None if pq is None else pq[b],
                  pos_k=None if pk is None else pk[b])
        np.testing.assert_array_equal(
            ta.block_live_mask(kl[b], S, bq, bk, **kw),
            np.asarray(jta.block_live_mask(kl[b], S, bq, bk, **kw)))


def test_block_live_mask_ragged_tail_is_conservative():
    """A ragged last tile counts its real keys/rows only, and a pair the
    mask marks dead holds no visible (i, j) at all."""
    rng = np.random.default_rng(3)
    S, A = 150, 37
    last = rng.integers(-1, S, S)
    kl = np.concatenate([np.full(A, 1 << 30), np.where(last >= 0, last + A,
                                                        -1)])
    kl[A + S - 5:] = -1
    live = ta.block_live_mask(kl, S, 64, 64, q_off=A)
    i = A + np.arange(S)[:, None]
    j = np.arange(A + S)[None, :]
    vis = (j <= i) & (kl[None, :] >= i)
    for qi in range(live.shape[0]):
        for ki in range(live.shape[1]):
            blk = vis[qi * 64:(qi + 1) * 64, ki * 64:(ki + 1) * 64]
            if blk.any():
                assert live[qi, ki], (qi, ki)


@pytest.mark.parametrize("ctx", ["none", "context", "invalid_row"])
def test_prefill_attention_matches_jax(ctx):
    rng = np.random.default_rng(7)
    B, A, S, H, Kh, hd = 2, 5, 6, 4, 2, 8
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = mk(B, S, H, hd), mk(B, S, Kh, hd), mk(B, S, Kh, hd)
    ck, cv = mk(B, A, Kh, hd), mk(B, A, Kh, hd)
    valid = np.ones((B, A), bool)
    if ctx == "invalid_row":
        valid[:, 2] = False
    kw_j, kw_t = {}, {}
    if ctx != "none":
        kw_j = dict(ctx_k=jnp.asarray(ck), ctx_v=jnp.asarray(cv),
                    ctx_valid=jnp.asarray(valid))
        kw_t = dict(ctx_k=torch.from_numpy(ck), ctx_v=torch.from_numpy(cv),
                    ctx_valid=torch.from_numpy(valid))
    j = jops.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), hd ** -0.5, **kw_j)
    o = ops.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), hd ** -0.5, **kw_t)
    np.testing.assert_allclose(o.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------
# the dk/dv kernel's host-side tile metadata, against the reference's
# block_kmax_flat / block_live_mask on the same seeded trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,A", [(256, 0), (512, 0), (256, 64), (192, 128)])
def test_dkv_schedule_matches_jax_block_live(S, A):
    """Per key tile: the max kv_last is the reference's block_kmax_flat,
    the work is the number of query tiles its block_live_mask keeps, and
    the order lists every (batch, key tile) once, heaviest first."""
    B = 2
    if A:
        kl = np.asarray(_gateway_meta(S + A, B, S, A, (5, 0))[0])
    else:
        kl = np.asarray(_tree_meta(S, B, S)[0])
    nk = kl.shape[1] // 64
    kmax, work, order = tab.dkv_schedule(torch.tensor(kl).int(), S,
                                         q_off=A)
    np.testing.assert_array_equal(
        kmax.numpy().reshape(-1),
        np.asarray(jta.block_kmax_flat(jnp.asarray(kl), B, nk, 64)))
    for b in range(B):
        live = np.asarray(jta.block_live_mask(kl[b], S, 64, 64, q_off=A))
        np.testing.assert_array_equal(work[b].numpy(), live.sum(0))
    flat = work.reshape(-1).numpy()
    order = order.numpy()
    assert sorted(order.tolist()) == list(range(B * nk))
    assert np.all(np.diff(flat[order]) <= 0)
    for w in np.unique(flat):              # ties keep index order
        idx = order[flat[order] == w]
        assert np.all(np.diff(idx) > 0)


def test_dkv_schedule_ragged_tail_counts_real_keys():
    """A ragged last key tile's max covers its real keys only, as the
    port's block_kmax_flat, and its work matches the per-pair count."""
    rng = np.random.default_rng(8)
    S, A = 150, 37
    last = rng.integers(-1, S, S)
    kl = np.concatenate([np.full(A, 1 << 30), np.where(last >= 0, last + A,
                                                        -1)])[None]
    kmax, work, _ = tab.dkv_schedule(torch.from_numpy(kl).int(), S, q_off=A)
    nk = -(-kl.shape[1] // 64)
    np.testing.assert_array_equal(kmax.numpy()[0],
                                  ta.block_kmax_flat(kl, 1, nk, 64))
    live = ta.block_live_mask(kl[0], S, 64, 64, q_off=A)
    # the estimate ignores only the causal edge of the last, ragged query
    # tile, so it never undercounts
    assert np.all(work.numpy()[0] >= live.sum(0))


@pytest.mark.parametrize("parts", [1, 2, 3, 6])
def test_dkv_head_split_partials_sum_to_jax(parts):
    """The dk/dv kernel splits each GQA group of G query heads into parts
    and sums their fp32 partials in a fixed order.  The plain backward run
    part by part and summed that way gives the reference kernel's dk/dv."""
    from repro.kernels import tree_attention_bwd as jtab
    from repro_torch.kernels.ref import tree_attention_bwd_ref
    B, S, H, Kh, hd = 1, 128, 12, 2, 16
    G = H // Kh
    assert G % parts == 0 and tab.head_parts(G, 10, 132) in (1, 2, 3, 6)
    rng = np.random.default_rng(parts)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v, do = mk(B, S, H, hd), mk(B, S, Kh, hd), mk(B, S, Kh, hd), \
        mk(B, S, H, hd)
    kl = np.array(_tree_meta(3, B, S)[0])
    sc = hd ** -0.5
    jo, jl = jta.tree_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(kl), sc, block_q=64, block_k=64,
                                save_residuals=True, interpret=True)
    _, jdk, jdv = jtab.tree_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kl), jo,
        jl, jnp.asarray(do), sc, block_q=64, block_k=64, interpret=True)
    t = torch.from_numpy
    per = G // parts
    heads = lambda a, p: a.reshape(B, S, Kh, G, hd)[:, :, :, p * per:(p + 1)
                                                   * per].reshape(
        B, S, Kh * per, hd)
    lse = t(np.array(jl)).reshape(B, Kh, G, S)
    dk = torch.zeros(B, S, Kh, hd)
    dv = torch.zeros(B, S, Kh, hd)
    for p in range(parts):               # in order, as the kernel's sum
        _, dk_p, dv_p = tree_attention_bwd_ref(
            heads(t(q), p), t(k), t(v), t(kl).int(),
            heads(t(np.array(jo)), p),
            lse[:, :, p * per:(p + 1) * per].reshape(B, Kh * per, S),
            heads(t(do), p), sc)
        dk += dk_p
        dv += dv_p
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), atol=1e-4,
                               rtol=1e-4)


# --------------------------------------------------------------------------
# which path each kernel takes, and the forward at Nemotron-4 340B's head
# dim 192 with a GQA group of 12 against the reference's Pallas kernel
# --------------------------------------------------------------------------

# (kernel, dtype, hd) → path on the card: bf16 at hd 64, 96 (Phi-3-vision),
# 128 and 192 takes every kernel's Hopper path; fp32 and the other head
# dims take the simple kernels
_HOPPER = {("fwd", 64), ("fwd", 96), ("fwd", 128), ("fwd", 192), ("dq", 64),
           ("dq", 96), ("dq", 128), ("dq", 192), ("dkv", 64), ("dkv", 96),
           ("dkv", 128), ("dkv", 192)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_kernel_path_table(kernel, dtype):
    dt = getattr(torch, dtype)
    for hd in ta.HEAD_DIMS:
        want = ("hopper" if dtype == "bfloat16" and (kernel, hd) in _HOPPER
                else "simple")
        assert ta.kernel_path(kernel, dt, hd) == want, (kernel, dtype, hd)
    q = torch.zeros(1, 1, 1, 192, dtype=dt)
    assert tab.fuses_delta(q) is (dtype == "bfloat16")
    assert tab.fuses_delta(q[..., :128]) is (dtype == "bfloat16")
    assert tab.fuses_delta(q[..., :96]) is (dtype == "bfloat16")
    assert tab.fuses_delta(q[..., :32]) is False


@pytest.mark.parametrize("q_off", [0, 20])
def test_op_hd192_gqa12_matches_jax(q_off):
    """Nemotron-4 340B's attention layout at small size: hd 192, 12 query
    heads on one kv head (its GQA group of 12), packed trees, with and
    without gateway ancestors; o and lse against the reference's Pallas
    forward in interpret mode at its tolerance (2e-5, f32)."""
    B, S, H, Kh, hd = 1, 64, 12, 1, 192
    rng = np.random.default_rng(192 + q_off)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    if q_off:
        kl = np.asarray(_gateway_meta(9, B, S, q_off, (3,))[0])
    else:
        kl = np.asarray(_tree_meta(9, B, S)[0])
    q, k, v = mk(B, S, H, hd), mk(B, q_off + S, Kh, hd), mk(B, q_off + S, Kh,
                                                            hd)
    sc = hd ** -0.5
    pad = -k.shape[1] % 32                # the Pallas forward wants Skv % bk
    kp, vp = (np.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0))) for a in (k, v))
    klp = np.pad(kl, ((0, 0), (0, pad)), constant_values=-1)
    jo, jl = jta.tree_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(klp), sc,
        block_q=32, block_k=32, q_off=q_off, save_residuals=True,
        interpret=True)
    o, lse = _port(q, k, v, kl, q_off, None, None, None, save_residuals=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
