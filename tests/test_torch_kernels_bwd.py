"""Gradients of the port's tree-attention op against the JAX package.

On the CPU ``repro_torch.kernels.ops.tree_attention`` runs its plain
versions (``kernels/ref.py``: the dense forward and
``tree_attention_bwd_ref``) behind the ``TreeAttention`` autograd node; the
JAX side takes ``jax.vjp`` through the reference's ``ops.tree_attention``,
whose custom_vjp runs the Pallas forward and backward kernels in interpret
mode.  Same inputs (numpy, from a seed) go to both, at the reference's own
tolerances (tests/test_kernels_bwd.py): 1e-4 in f32, 5e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.kernels import tree_attention_bwd as tab  # noqa: E402
from repro_torch.kernels.ref import (tree_attention_bwd_ref,  # noqa: E402
                                     tree_attention_ref_ext)
from test_kernels import _gateway_meta, _tree_meta  # noqa: E402
from test_kernels_bwd import _tree_kv_last  # noqa: E402


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _jax_grads(q, k, v, kl, do, scale, bq, bk, dtype=jnp.float32, *,
               q_off=0, window=None, pos_q=None, pos_k=None):
    j = lambda a: None if a is None else jnp.asarray(a)
    f = lambda q_, k_, v_: jops.tree_attention(
        q_, k_, v_, j(kl), scale, bq, bk, q_off=q_off, window=window,
        pos_q=j(pos_q), pos_k=j(pos_k))
    _, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, dtype))]


def _port_grads(q, k, v, kl, do, scale, dtype=torch.float32, *, q_off=0,
                window=None, pos_q=None, pos_k=None):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    leaves = [t(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    o = ops.tree_attention(*leaves, t(kl), scale, q_off=q_off, window=window,
                           pos_q=t(pos_q), pos_k=t(pos_k))
    g = torch.autograd.grad(o, leaves, t(do).to(dtype))
    return [x.float().numpy() for x in g], g


def _close(got, want, tol):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("B,S,H,Kh,hd,bq,bk", [
    (1, 64, 4, 4, 16, 16, 16),     # MHA
    (2, 128, 4, 2, 16, 32, 32),    # GQA 2:1, multi-row packing
    (1, 128, 8, 1, 32, 32, 64),    # MQA, rectangular blocks
    (2, 128, 4, 2, 64, 64, 32),    # wide head
    (1, 256, 2, 2, 8, 128, 128),   # MXU-aligned blocks
])
def test_op_grads_match_jax_vjp(B, S, H, Kh, hd, bq, bk):
    rng = np.random.default_rng(B * 1000 + S + H)
    kl = np.asarray(_tree_kv_last(S + H, B, S))
    q, k, v = _np(rng, B, S, H, hd), _np(rng, B, S, Kh, hd), _np(rng, B, S, Kh, hd)
    do = _np(rng, B, S, H, hd)
    want = _jax_grads(q, k, v, kl, do, hd ** -0.5, bq, bk)
    got, _ = _port_grads(q, k, v, kl, do, hd ** -0.5)
    _close(got, want, 1e-4)


def test_op_padding_rows_zero_and_finite_grads():
    rng = np.random.default_rng(29)
    B, S, H, hd = 1, 64, 2, 16
    kl = np.full((B, S), -1, np.int32)
    kl[0, :16] = 15
    q, k, v, do = (_np(rng, B, S, H, hd) for _ in range(4))
    want = _jax_grads(q, k, v, kl, do, 0.25, 16, 16)
    got, _ = _port_grads(q, k, v, kl, do, 0.25)
    _close(got, want, 1e-4)
    for g in got:
        assert np.isfinite(g).all()
        assert not g[0, 16:].any()          # padding queries/keys: exactly 0


@pytest.mark.parametrize("A,pad_rows,window", [
    (32, (0, 7), None),    # aligned ancestors, row-1 front padding
    (20, (5, 0), None),    # awkward depth
    (32, (4, 11), 12),     # ancestors + sliding window combined
])
def test_op_gateway_ancestor_grads_match_jax(A, pad_rows, window):
    rng = np.random.default_rng(200 + A + (window or 0))
    B, S, H, Kh, hd = 2, 64, 4, 2, 16
    kl, pq, pk, _ = (np.asarray(a) for a in _gateway_meta(5, B, S, A,
                                                           pad_rows))
    q, do = _np(rng, B, S, H, hd), _np(rng, B, S, H, hd)
    k, v = _np(rng, B, A + S, Kh, hd), _np(rng, B, A + S, Kh, hd)
    kw = dict(q_off=A, window=window, pos_q=pq, pos_k=pk)
    want = _jax_grads(q, k, v, kl, do, hd ** -0.5, 32, 32, **kw)
    got, _ = _port_grads(q, k, v, kl, do, hd ** -0.5, **kw)
    _close(got, want, 1e-4)
    assert np.abs(got[1][:, :A]).max() > 1e-3     # real ancestor cotangents
    assert np.abs(got[2][:, :A]).max() > 1e-3


def test_op_window_with_tree_branching_grads_match_jax():
    rng = np.random.default_rng(211)
    B, S, H, hd = 2, 128, 4, 16
    kl, pos = (np.asarray(a) for a in _tree_meta(11, B, S))
    q, k, v, do = (_np(rng, B, S, H, hd) for _ in range(4))
    kw = dict(window=8, pos_q=pos, pos_k=pos)
    want = _jax_grads(q, k, v, kl, do, hd ** -0.5, 32, 32, **kw)
    got, _ = _port_grads(q, k, v, kl, do, hd ** -0.5, **kw)
    _close(got, want, 1e-4)


def test_op_bf16_gqa_with_ancestors_matches_jax():
    rng = np.random.default_rng(223)
    B, S, A, H, Kh, hd = 1, 128, 32, 4, 2, 32
    kl = np.asarray(_gateway_meta(7, B, S, A, pad_rows=(9,))[0])
    q, do = _np(rng, B, S, H, hd), _np(rng, B, S, H, hd)
    k, v = _np(rng, B, A + S, Kh, hd), _np(rng, B, A + S, Kh, hd)
    want = _jax_grads(q, k, v, kl, do, hd ** -0.5, 32, 32,
                      dtype=jnp.bfloat16, q_off=A)
    got, raw = _port_grads(q, k, v, kl, do, hd ** -0.5,
                           dtype=torch.bfloat16, q_off=A)
    assert all(g.dtype == torch.bfloat16 for g in raw)
    _close(got, want, 5e-2)


def _small_case(seed=41):
    rng = np.random.default_rng(seed)
    B, S, A, H, Kh, hd = 2, 64, 20, 4, 2, 16
    kl, pq, pk, _ = (np.asarray(a) for a in _gateway_meta(3, B, S, A, (5, 0)))
    t = lambda a: torch.from_numpy(a)
    return (t(_np(rng, B, S, H, hd)), t(_np(rng, B, A + S, Kh, hd)),
            t(_np(rng, B, A + S, Kh, hd)), t(kl),
            dict(q_off=A, window=16, pos_q=t(pq), pos_k=t(pk)),
            t(_np(rng, B, S, H, hd)))


def test_bwd_ref_direct_matches_autograd_path():
    """tree_attention_bwd_ref called as a library op on the forward's (o,
    lse) equals the autograd node's gradients (residual layout)."""
    q, k, v, kl, kw, do = _small_case()
    sc = 0.25
    o, lse = ops.tree_attention(q, k, v, kl, sc, save_residuals=True, **kw)
    direct = tree_attention_bwd_ref(q, k, v, kl, o, lse, do, sc, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    g = torch.autograd.grad(ops.tree_attention(*leaves, kl, sc, **kw),
                            leaves, do)
    for a, b in zip(direct, g):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_bwd_ref_matches_autograd_of_plain_forward():
    q, k, v, kl, kw, do = _small_case(43)
    sc = 0.25
    o, lse = tree_attention_ref_ext(q, k, v, kl, sc, return_lse=True, **kw)
    got = tree_attention_bwd_ref(q, k, v, kl, o, lse, do, sc, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        tree_attention_ref_ext(*leaves, kl, sc, **kw), leaves, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_autograd_node_saves_only_o_of_s_tensors():
    """The saved residuals stay O(S): no tensor with two axes of length S."""
    B, S, H, hd = 1, 128, 2, 16
    kl = torch.full((B, S), S - 1, dtype=torch.int32)
    leaves = [torch.ones(B, S, H, hd, requires_grad=True) for _ in range(3)]
    o = ops.tree_attention(*leaves, kl, hd ** -0.5)
    saved = [t for t in o.grad_fn.saved_tensors if t is not None]
    assert saved
    for t in saved:
        assert list(t.shape).count(S) <= 1, tuple(t.shape)


def test_cpu_gradient_launches_no_kernel():
    q, k, v, kl, kw, do = _small_case(47)
    counts = (ta.tree_attention.launches, tab.bwd_dq.launches,
              tab.bwd_dkv.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.autograd.grad(ops.tree_attention(*leaves, kl, 0.25, **kw), leaves,
                        do)
    assert (ta.tree_attention.launches, tab.bwd_dq.launches,
            tab.bwd_dkv.launches) == counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delta_matches_reference_expression(dtype):
    """``delta`` (the plain version of the Δ that the dq kernel's Hopper
    path computes) against the reference's own expression
    (repro/kernels/tree_attention_bwd.py:331) evaluated by JAX on the same
    values: [B,H,S] f32 from products of the inputs' dtype."""
    rng = np.random.default_rng(61)
    o, do = _np(rng, 2, 96, 6, 64), _np(rng, 2, 96, 6, 64)
    jdt = getattr(jnp, dtype)
    jo, jdo = jnp.asarray(o, jdt), jnp.asarray(do, jdt)
    want = np.asarray((jdo.astype(jnp.float32) * jo.astype(jnp.float32)
                       ).sum(-1).transpose(0, 2, 1))
    tdt = getattr(torch, dtype)
    got = tab.delta(torch.from_numpy(o).to(tdt), torch.from_numpy(do).to(tdt))
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,hd,fused", [
    ("bfloat16", 64, True), ("bfloat16", 128, True), ("bfloat16", 32, False),
    ("bfloat16", 192, True), ("bfloat16", 96, True), ("float32", 64, False),
    ("float32", 128, False),
])
def test_bwd_dq_computes_delta_only_off_the_hopper_path(monkeypatch, dtype,
                                                        hd, fused):
    """``bwd_dq`` hands the dq kernel a fresh f32 [B,H,S] buffer to write Δ
    into where ``fuses_delta`` holds (bf16 at hd 64/96/128/192), and runs
    ``delta`` before the launch elsewhere; it counts one launch per call.
    The launch itself is replaced here (the kernel needs the card)."""
    B, S, H, Kh = 1, 70, 4, 2
    dt = getattr(torch, dtype)
    q, o, do = (torch.ones(B, S, H, hd, dtype=dt) for _ in range(3))
    k = v = torch.ones(B, S, Kh, hd, dtype=dt)
    kl = torch.full((B, S), S - 1, dtype=torch.int32)
    lse = torch.zeros(B, H, S)
    seen = {}
    monkeypatch.setattr(tab, "_launch", lambda src, entry, outs, *a, **kw:
                        seen.update(entry=entry, dl=a[5], o=kw["extra"][0]))
    n = tab.bwd_dq.launches
    dq, dl = tab.bwd_dq(q, k, v, kl, o, lse, do, 0.1)
    assert tab.bwd_dq.launches == n + 1
    assert tab.fuses_delta(q) is fused
    assert seen["entry"] == "tree_attention_bwd_dq" and seen["dl"] is dl
    assert seen["o"] is o and dq.shape == q.shape and dq.dtype == dt
    assert dl.dtype == torch.float32 and tuple(dl.shape) == (B, H, S)
    if not fused:
        torch.testing.assert_close(dl, tab.delta(o, do))


def test_tree_attention_bwd_hands_dq_delta_to_dkv(monkeypatch):
    """``tree_attention_bwd`` launches dq first and passes the Δ it returns
    (on the Hopper path, the buffer the dq kernel writes) to the dk/dv
    launch; it computes no Δ of its own."""
    calls = []
    sentinel = torch.zeros(1)
    monkeypatch.setattr(tab, "_check", lambda *a: None)
    monkeypatch.setattr(tab, "delta", lambda *a: calls.append("delta"))
    monkeypatch.setattr(tab, "bwd_dq", lambda *a, **kw: (
        calls.append("dq") or ("dq", sentinel)))

    def fake_dkv(q, k, v, kv_last, lse, dl, do, scale, **kw):
        calls.append("dkv")
        assert dl is sentinel
        return "dk", "dv"

    monkeypatch.setattr(tab, "bwd_dkv", fake_dkv)
    x = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    out = tab.tree_attention_bwd(x, x, x, None, x, None, x, 0.1)
    assert out == ("dq", "dk", "dv") and calls == ["dq", "dkv"]


def _hd192_backward_launches(monkeypatch, dtype):
    """``tree_attention_bwd`` at Nemotron-4 340B's layout (hd 192, a GQA
    group of 12) with both launches replaced (the kernels need the card):
    returns (q, o, do, the outputs, what each launch was given)."""
    B, S, H, Kh, hd = 1, 70, 12, 1, 192
    rng = np.random.default_rng(192)
    t = lambda *s: torch.from_numpy(_np(rng, *s)).to(dtype)
    q, o, do = t(B, S, H, hd), t(B, S, H, hd), t(B, S, H, hd)
    k, v = t(B, S, Kh, hd), t(B, S, Kh, hd)
    kl = torch.full((B, S), S - 1, dtype=torch.int32)
    lse = torch.zeros(B, H, S)
    seen = []
    monkeypatch.setattr(tab, "_check", lambda *a: None)
    monkeypatch.setattr(tab.torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count":
                                                   132}))
    monkeypatch.setattr(tab, "_launch", lambda src, entry, outs, *a, **kw:
                        seen.append(dict(entry=entry, dl=a[5], **kw)))
    n = (tab.bwd_dq.launches, tab.bwd_dkv.launches)
    out = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, 0.1)
    assert (tab.bwd_dq.launches, tab.bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    assert [c["entry"] for c in seen] == ["tree_attention_bwd_dq",
                                          "tree_attention_bwd_dkv"]
    assert seen[1]["dl"] is seen[0]["dl"]
    assert out[0].shape == q.shape and out[1].shape == out[2].shape == k.shape
    return q, o, do, out, seen


def test_hd192_dkv_hopper_path_reads_the_wrappers_delta(monkeypatch):
    """bf16 at hd 192 (Nemotron-4 340B: a GQA group of 12): the dq kernel's
    Hopper path computes Δ itself, so ``bwd_dq`` runs no ``delta`` (it
    raises here) and hands the dq launch a fresh f32 [B,H,S] buffer to
    write Δ into, with o; the dk/dv launch, on its Hopper path (a schedule
    buffer, and fp32 partials when the group is split), receives that same
    buffer."""
    def no_delta(*a):
        raise AssertionError("bwd_dq ran delta on the fused path")

    monkeypatch.setattr(tab, "delta", no_delta)
    q, o, do, _, seen = _hd192_backward_launches(monkeypatch, torch.bfloat16)
    assert tab.fuses_delta(q)
    B, S, H, _ = q.shape
    dl = seen[0]["dl"]
    assert dl.dtype == torch.float32 and tuple(dl.shape) == (B, H, S)
    assert dl.is_contiguous() and seen[0]["extra"][0] is o
    sched, partial = seen[1]["extra"]
    parts = seen[1]["parts"]
    assert sched is not None and sched.numel() == B * -(-S // tab.BLOCK)
    assert parts == tab.head_parts(12, B * -(-S // tab.BLOCK), 132)
    assert (partial is None) == (parts == 1)


def test_hd192_f32_dq_simple_kernel_reads_the_wrappers_delta(monkeypatch):
    """f32 at hd 192 keeps the simple kernels: ``bwd_dq`` computes
    Δ = ``delta(o, do)`` before its launch, and the dk/dv launch (simple:
    no schedule, no partials) receives that same Δ."""
    q, o, do, _, seen = _hd192_backward_launches(monkeypatch, torch.float32)
    assert not tab.fuses_delta(q)
    torch.testing.assert_close(seen[0]["dl"], tab.delta(o, do), atol=0,
                               rtol=0)
    assert seen[1]["extra"] == (None, None) and seen[1]["parts"] == 1


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_op_hd192_gqa12_grads_match_jax(dtype, tol):
    """The plain forward and backward at Nemotron-4 340B's head dim 192
    with its GQA group of 12 (12 query heads on one kv head), gateway
    ancestors (one row front-padded) and packed trees, against
    ``jax.vjp`` through the reference's Pallas kernels in interpret mode,
    at the reference's tolerances (1e-4 in f32, 5e-2 in bf16)."""
    rng = np.random.default_rng(1920)
    B, S, A, H, Kh, hd = 1, 64, 20, 12, 1, 192
    kl = np.asarray(_gateway_meta(13, B, S, A, pad_rows=(3,))[0])
    q, do = _np(rng, B, S, H, hd), _np(rng, B, S, H, hd)
    k, v = _np(rng, B, A + S, Kh, hd), _np(rng, B, A + S, Kh, hd)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _jax_grads(q, k, v, kl, do, hd ** -0.5, 32, 32, dtype=jdt,
                      q_off=A)
    got, raw = _port_grads(q, k, v, kl, do, hd ** -0.5, dtype=tdt, q_off=A)
    assert all(g.dtype == tdt for g in raw)
    _close(got, want, tol)
    assert not got[1][0, :3].any() and not got[2][0, :3].any()   # padded
    assert np.abs(got[1][:, 3:A]).max() > 1e-3     # real ancestor cotangents


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_op_hd96_prefix_grads_match_jax(dtype, tol):
    """The plain forward and backward at Phi-3-vision's head dim 96 (MHA,
    H 4/Kh 4) on packed trees behind a multimodal prefix of 16 rows that
    the whole row sees (``chip_smoke.prefix_kv_last``'s kv_last: the
    prefix visible to every token, the text's indices shifted by 16),
    against ``jax.vjp`` through the reference's Pallas kernels in
    interpret mode, at the reference's tolerances (1e-4 in f32, 5e-2 in
    bf16).  bf16 at hd 96 is the layout whose forward, dq and dk/dv take
    the Hopper path on the card."""
    rng = np.random.default_rng(96)
    B, F, T, H, Kh, hd = 2, 16, 112, 4, 4, 96
    text = np.asarray(_tree_kv_last(9, B, T))
    kl = np.concatenate([np.full((B, F), F + T - 1),
                         np.where(text >= 0, text + F, -1)], 1)
    S = F + T
    q, do = _np(rng, B, S, H, hd), _np(rng, B, S, H, hd)
    k, v = _np(rng, B, S, Kh, hd), _np(rng, B, S, Kh, hd)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _jax_grads(q, k, v, kl, do, hd ** -0.5, 32, 32, dtype=jdt)
    got, raw = _port_grads(q, k, v, kl, do, hd ** -0.5, dtype=tdt)
    assert all(g.dtype == tdt for g in raw)
    assert tab.fuses_delta(raw[0]) is (dtype == "bfloat16")
    _close(got, want, tol)
    # the prefix keys are seen by every later row: real cotangents
    assert np.abs(got[1][:, :F]).max() > 1e-3
