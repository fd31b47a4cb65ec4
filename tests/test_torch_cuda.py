"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a machine without a CUDA
device (the kernels have no CPU mode).  The file imports neither jax nor
the JAX package, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 at 1e-4 (atol and rtol; the card sums in another order).
bf16 against the plain version computed in f32 from the same bf16 inputs:
the forward's o within 2^-7·|ref| + 2e-2·(row rms) and its lse at 1e-4;
the backward's dq/dk/dv at relative L2 ≤ 1e-2 each and every element within
5e-2 + 5e-2·|ref| (the reference's bf16 bar, tests/test_kernels_bwd.py:235).
The Δ that the dq kernel's Hopper path computes is held against ``delta``
at 1e-5 of Σ_d |do·o| per row: both sum the same exact fp32 products of
bf16 values, in another order, and 1e-5 bounds that reordering's rounding
(hd·2^-24 ≈ 8e-6 of the sum of magnitudes at hd 128, in the worst case).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.packing import pack_trees  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import trees_for_batch  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.kernels import tree_attention_bwd as tab  # noqa: E402
from repro_torch.kernels.ref import (tree_attention_bwd_ref,  # noqa: E402
                                     tree_attention_ref_ext)

pytestmark = pytest.mark.cuda
BIG = 1 << 30


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 plain versions
    build.build_all([ta.SOURCE, *tab.SOURCES])        # one nvcc per source
    return torch.device("cuda")


def _tree_meta(seed: int, B: int, S: int):
    """(kv_last, pos_ids) of packed random trees, rows ~3/4 full."""
    trees = trees_for_batch(seed, n_trees=8 * B, kind="random",
                            seg_len_range=(1, 12), max_depth=3)
    sers, used = [], 0
    for t in trees:
        s = serialize_tree(t)
        if used + s.n <= B * S * 3 // 4 and s.n <= S:
            sers.append(s)
            used += s.n
    tb = pack_trees(sers, S, batch_size=B)
    return tb.kv_last, tb.pos_ids


def _gateway_meta(seed, B, S, A, pad_rows):
    kl, pos = _tree_meta(seed, B, S)
    anc = np.full((B, A), BIG, np.int64)
    for r, p in enumerate(pad_rows):
        anc[r, :p] = -1
    kl_all = np.concatenate([anc, np.where(kl >= 0, kl + A, -1)], 1)
    pos_q = pos + A
    pos_k = np.concatenate([np.tile(np.arange(A), (B, 1)), pos_q], 1)
    return kl_all, pos_q, pos_k


def _case(name):
    """(B, S, H, Kh, hd, kv_last, q_off, window, pos_q, pos_k) as numpy."""
    if name in ("mha", "gqa", "mqa"):
        B, S, H, Kh, hd = {"mha": (1, 64, 4, 4, 16), "gqa": (2, 128, 4, 2, 16),
                           "mqa": (1, 128, 8, 1, 32)}[name]
        return (B, S, H, Kh, hd, _tree_meta(S + H, B, S)[0], 0, None, None,
                None)
    if name == "padding":
        kl = np.full((1, 64), -1, np.int32)
        kl[0, :16] = 15
        return 1, 64, 2, 2, 16, kl, 0, None, None, None
    if name in ("gateway32", "gateway20"):
        A, pad = {"gateway32": (32, (0, 7)), "gateway20": (20, (5, 0))}[name]
        kl, _, _ = _gateway_meta(5, 2, 64, A, pad)
        return 2, 64, 4, 2, 16, kl, A, None, None, None
    if name == "window":
        kl, pos = _tree_meta(11, 2, 128)
        return 2, 128, 4, 4, 16, kl, 0, 8, pos, pos
    if name == "gateway_window":
        kl, pq, pk = _gateway_meta(7, 2, 200, 32, (4, 11))
        return 2, 200, 12, 2, 128, kl, 32, 12, pq, pk
    if name == "packed_gqa_hd128":
        kl, _ = _tree_meta(13, 2, 1000)
        return 2, 1000, 12, 2, 128, kl, 0, None, None, None
    if name == "packed_gqa32_4_hd128":
        # Qwen3-30B-A3B's attention: 32 query heads on 4 kv heads (a GQA
        # group of 8), hd 128, on packed trees
        kl, _ = _tree_meta(29, 2, 1000)
        return 2, 1000, 32, 4, 128, kl, 0, None, None, None
    if name == "dead_tiles":
        # a long packed row of short trees: most key tiles before a query
        # tile are dead, with live ones (its own tree's) between them
        trees = trees_for_batch(17, n_trees=400, kind="random",
                                seg_len_range=(1, 6), max_depth=2)
        sers = [serialize_tree(t) for t in trees]
        keep, used = [], 0
        for s in sers:
            if used + s.n <= 2000:
                keep.append(s)
                used += s.n
        kl = pack_trees(keep, 2048, batch_size=1).kv_last
        return 1, 2048, 12, 2, 128, kl, 0, None, None, None
    if name.startswith("ring_tail"):
        # a causal chain of 6 key tiles, the last ragged (357 = 5·64 + 37)
        # and live: it lands in the last stage of the forward's key-tile
        # ring at both head dims (2 stages at hd 128, 3 at hd 64)
        hd = int(name.rsplit("hd", 1)[1])
        return (2, 357, 12, 2, hd, np.full((2, 357), 356), 0, None, None,
                None)
    if name == "ragged_gateway":
        # S not a multiple of 64, q_off > 0, gateway ancestors (two rows
        # front-padded differently)
        kl, _, _ = _gateway_meta(19, 2, 200, 37, (5, 0))
        return 2, 200, 12, 2, 128, kl, 37, None, None, None
    if name.startswith("heads"):
        # heads{H}_{Kh}_hd{hd}: GQA 12/2 and MHA at the models' head dims
        H, rest = name[5:].split("_", 1)
        Kh, hd = rest.split("_hd")
        kl, _ = _tree_meta(23, 2, 256)
        return 2, 256, int(H), int(Kh), int(hd), kl, 0, None, None, None
    raise KeyError(name)


CASES = ["mha", "gqa", "mqa", "padding", "gateway32", "gateway20", "window",
         "gateway_window", "packed_gqa_hd128", "dead_tiles", "ring_tail_hd64",
         "ring_tail_hd128", "ragged_gateway", "heads12_2_hd64",
         "heads12_2_hd128", "heads4_4_hd64", "heads4_4_hd128",
         "packed_gqa32_4_hd128", "heads32_4_hd128"]


def _inputs(name, dtype, dev, hd=None):
    B, S, H, Kh, hd0, kl, q_off, window, pq, pk = _case(name)
    hd = hd or hd0
    rng = np.random.default_rng(CASES.index(name))
    Skv = kl.shape[1]
    mk = lambda *s: torch.tensor(rng.normal(size=s), dtype=dtype, device=dev)
    i32 = lambda a: None if a is None else torch.as_tensor(
        np.asarray(a), dtype=torch.int32, device=dev)
    return (mk(B, S, H, hd), mk(B, Skv, Kh, hd), mk(B, Skv, Kh, hd),
            i32(kl), dict(q_off=q_off, window=window, pos_q=i32(pq),
                          pos_k=i32(pk)), mk(B, S, H, hd))


def _hold_bwd(got, want, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all()), name
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=name)
        else:
            rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
            assert rel <= 1e-2, (name, rel)
            assert bool(((a - b).abs() <= 5e-2 + 5e-2 * b.abs()).all()), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain(dev, name, dtype):
    """The forward: lse at 1e-4 in both dtypes (the kernel keeps fp32
    logits); a bf16 o within its own rounding and that of P."""
    dt = getattr(torch, dtype)
    q, k, v, kl, kw, _ = _inputs(name, dt, dev)
    sc = q.shape[-1] ** -0.5
    before = ta.tree_attention.launches
    with torch.inference_mode():
        o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True, **kw)
        ro, rl = tree_attention_ref_ext(q.float(), k.float(), v.float(), kl,
                                        sc, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert ta.tree_attention.launches == before + 1
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-4)
    if dtype == "float32":
        torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
    else:
        err = (o.float() - ro).abs()
        rms = ro.pow(2).mean(-1, keepdim=True).sqrt()
        assert bool((err <= 2 ** -7 * ro.abs() + 2e-2 * rms).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CASES)
def test_cuda_bwd_kernels_match_plain(dev, name, dtype):
    """dq/dk/dv of the two backward kernels against the plain backward in
    f32 on the same (q, k, v, o, lse, do); two launches are bit-identical."""
    dt = getattr(torch, dtype)
    q, k, v, kl, kw, do = _inputs(name, dt, dev)
    sc = q.shape[-1] ** -0.5
    with torch.inference_mode():
        o32, lse = tree_attention_ref_ext(q.float(), k.float(), v.float(), kl,
                                          sc, return_lse=True, **kw)
        o = o32.to(dt).contiguous()     # the einsum's o is a view
        n_dq, n_dkv = tab.bwd_dq.launches, tab.bwd_dkv.launches
        got = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc, **kw)
        again = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc, **kw)
        want = tree_attention_bwd_ref(q.float(), k.float(), v.float(), kl,
                                      o.float(), lse, do.float(), sc, **kw)
    torch.cuda.synchronize()
    assert tab.bwd_dq.launches == n_dq + 2
    assert tab.bwd_dkv.launches == n_dkv + 2
    _hold_bwd(got, want, dt)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if name == "padding":                   # invisible keys: exactly zero
        assert not bool(got[1][0, 16:].any()) and not bool(got[2][0, 16:].any())
    if "gateway" in name:                   # ancestor cotangents are real
        A = kw["q_off"]
        assert float(got[1][:, :A].float().abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", ta.HEAD_DIMS)
def test_cuda_bwd_every_head_dim(dev, hd, dtype):
    dt = getattr(torch, dtype)
    q, k, v, kl, kw, do = _inputs("gateway20", dt, dev, hd=hd)
    sc = hd ** -0.5
    with torch.inference_mode():
        o32, lse = tree_attention_ref_ext(q.float(), k.float(), v.float(), kl,
                                          sc, return_lse=True, **kw)
        o = o32.to(dt).contiguous()     # the einsum's o is a view
        got = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc, **kw)
        want = tree_attention_bwd_ref(q.float(), k.float(), v.float(), kl,
                                      o.float(), lse, do.float(), sc, **kw)
    torch.cuda.synchronize()
    _hold_bwd(got, want, dt)


def test_cuda_op_gradient_runs_the_kernels(dev):
    """ops.tree_attention's autograd node: forward kernel with residuals,
    then both backward kernels, one launch each; grads match the plain
    path's autograd in f32."""
    q, k, v, kl, kw, do = _inputs("gateway_window", torch.float32, dev)
    sc = q.shape[-1] ** -0.5
    counts = (ta.tree_attention.launches, tab.bwd_dq.launches,
              tab.bwd_dkv.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ops.tree_attention(*leaves, kl, sc, **kw)
    g = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (ta.tree_attention.launches, tab.bwd_dq.launches,
            tab.bwd_dkv.launches) == tuple(c + 1 for c in counts)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ro = tree_attention_ref_ext(*ref_leaves, kl, sc, **kw)
    rg = torch.autograd.grad(ro, ref_leaves, do)
    for a, b in zip(g, rg):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["packed_gqa_hd128", "dead_tiles",
                                  "ragged_gateway", "gateway20",
                                  "ring_tail_hd64"])
def test_cuda_dkv_schedule_matches_plain(dev, name):
    """The dk/dv kernel's schedule pass (its first launch in the bf16 hd
    64/128 path) gives exactly its plain version's order."""
    B, S, H, Kh, hd, kl, q_off = _case(name)[:7]
    kl = torch.as_tensor(np.asarray(kl), dtype=torch.int32, device=dev)
    got = tab.dkv_order(kl, S, q_off)
    _, _, want = tab.dkv_schedule(kl, S, q_off)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _delta_close(got, o, do):
    """The kernel's Δ [B,H,S] against ``delta`` at 1e-5 of Σ_d |do·o|."""
    want = tab.delta(o, do)
    scale = (do.float() * o.float()).abs().sum(-1).transpose(1, 2)
    err = (got - want).abs()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert bool((err <= 1e-5 * scale + 1e-30).all()), float(
        (err / scale.clamp_min(1e-30)).max())


@pytest.mark.parametrize("hd", ta.HOPPER_HEAD_DIMS)
@pytest.mark.parametrize("name", CASES)
def test_cuda_dq_hopper_matches_plain(dev, name, hd):
    """The dq kernel's Hopper path (bf16 at hd 64 and 128) on every case:
    dq against the plain backward at the bf16 limits, its Δ against
    ``delta``, dq and Δ bit-identical over two launches, dq exactly 0 on
    rows that see no key, one launch counted per call."""
    q, k, v, kl, kw, do = _inputs(name, torch.bfloat16, dev, hd=hd)
    sc = hd ** -0.5
    assert tab.fuses_delta(q)
    with torch.inference_mode():
        o32, lse = tree_attention_ref_ext(q.float(), k.float(), v.float(), kl,
                                          sc, return_lse=True, **kw)
        o = o32.to(torch.bfloat16).contiguous()
        n = tab.bwd_dq.launches
        dq, dl = tab.bwd_dq(q, k, v, kl, o, lse, do, sc, **kw)
        dq2, dl2 = tab.bwd_dq(q, k, v, kl, o, lse, do, sc, **kw)
        want = tree_attention_bwd_ref(q.float(), k.float(), v.float(), kl,
                                      o.float(), lse, do.float(), sc, **kw)
    torch.cuda.synchronize()
    assert tab.bwd_dq.launches == n + 2
    a, b = dq.float(), want[0].float()
    assert dq.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
    rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
    assert rel <= 1e-2, rel
    assert bool(((a - b).abs() <= 5e-2 + 5e-2 * b.abs()).all())
    _delta_close(dl, o, do)
    assert torch.equal(dq, dq2) and torch.equal(dl, dl2)
    masked = (lse <= -1e29).transpose(1, 2)          # [B,S,H]: sees no key
    assert not bool(dq[masked].any())
    if name == "padding":                           # queries 16.. see nothing
        assert bool(masked[0, 16:].all())


def test_cuda_moe_train_step_makes_no_hidden_sync(dev):
    """A bf16 MoE model (the Qwen3-30B-A3B smoke config: a dense-free stack
    of 2 MoE layers, 4 experts top-2) takes a loss, its gradients and an
    AdamW update on the card under ``set_sync_debug_mode("error")``: the
    routing, dispatch, combine and aux losses make no host sync, and each
    tree-attention kernel launches once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, prepare_batch
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             init_opt_state)
    from repro_torch.train.train_step import value_and_grad
    cfg = get_config("qwen3_30b_a3b", smoke=True).replace(dtype="bfloat16")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    opt = init_opt_state(params)
    trees = trees_for_batch(3, n_trees=4, kind="agentic",
                            vocab_size=cfg.vocab_size, turn_len_range=(8, 32),
                            num_turns=2)
    batch = prepare_batch(cfg, pack_trees([serialize_tree(t) for t in trees],
                                          1024), device=dev)
    batch["num_trees"] = len(trees)
    counts = (ta.tree_attention.launches, tab.bwd_dq.launches,
              tab.bwd_dkv.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, metrics, grads = value_and_grad(cfg, params, batch)
        adamw_update(OptimizerConfig(), params, grads, opt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (ta.tree_attention.launches, tab.bwd_dq.launches,
            tab.bwd_dkv.launches) == tuple(c + cfg.n_layers for c in counts)
    assert bool(torch.isfinite(loss)) and float(metrics["aux_loss"]) > 0
    assert params["layer_stacks"][0]["moe"]["router"].dtype == torch.float32
