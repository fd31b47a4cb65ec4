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
(the kernel adds hd/4 products in order on each of a row's four threads
and closes the four sums by shuffles, at most (hd/4 + 1)·2^-24 ≈ 2.9e-6 of
the sum of magnitudes at hd 192; one order over all hd products at once
would be hd·2^-24 ≈ 1.1e-5, in the worst case).
"""
import threading

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
    if name == "short_tail_gateway_hd192":
        # S 300 = 2·128 + 44: the last 128-row query tile of the hd 192
        # forward and dq holds 44 rows, so its second consumer warpgroup
        # has none; gateway ancestors (A 37, two rows front-padded)
        kl, _, _ = _gateway_meta(37, 2, 300, 37, (5, 0))
        return 2, 300, 12, 2, 192, kl, 37, None, None, None
    if name.startswith("ring_tail"):
        # a causal chain of 6 key tiles, the last ragged (357 = 5·64 + 37)
        # and live: it lands in the last stage of the forward's key-tile
        # ring at each head dim (2 stages at hd 128, 3 at hd 64 and 192;
        # at hd 192 the last 128-row query tile holds 101 rows), and of dq's
        # (2 stages at hd 96, as at hd 128)
        hd = int(name.rsplit("hd", 1)[1])
        return (2, 357, 12, 2, hd, np.full((2, 357), 356), 0, None, None,
                None)
    if name == "vlm_prefix_hd96":
        # Phi-3-vision's rows at small size: a prefix of 40 rows that the
        # whole row sees (chip_smoke.prefix_kv_last) before packed trees,
        # MHA 32/32 at hd 96, S 340 = 5·64 + 20
        F, T = 40, 300
        kl, _ = _tree_meta(31, 2, T)
        kl = np.concatenate([np.full((2, F), F + T - 1),
                             np.where(kl >= 0, kl + F, -1)], 1)
        return 2, F + T, 32, 32, 96, kl, 0, None, None, None
    if name == "ragged_gateway":
        # S not a multiple of 64, q_off > 0, gateway ancestors (two rows
        # front-padded differently)
        kl, _, _ = _gateway_meta(19, 2, 200, 37, (5, 0))
        return 2, 200, 12, 2, 128, kl, 37, None, None, None
    if name.startswith("heads"):
        # heads{H}_{Kh}_hd{hd}: GQA 12/2 and MHA at the models' head dims,
        # Nemotron-4 340B's 96/8 (a group of 12) at hd 192, and
        # Phi-3-vision's MHA 32/32 and a GQA 32/8 at hd 96
        H, rest = name[5:].split("_", 1)
        Kh, hd = rest.split("_hd")
        kl, _ = _tree_meta(23, 2, 256)
        return 2, 256, int(H), int(Kh), int(hd), kl, 0, None, None, None
    raise KeyError(name)


CASES = ["mha", "gqa", "mqa", "padding", "gateway32", "gateway20", "window",
         "gateway_window", "packed_gqa_hd128", "dead_tiles", "ring_tail_hd64",
         "ring_tail_hd128", "ragged_gateway", "heads12_2_hd64",
         "heads12_2_hd128", "heads4_4_hd64", "heads4_4_hd128",
         "packed_gqa32_4_hd128", "heads32_4_hd128", "ring_tail_hd192",
         "heads96_8_hd192", "short_tail_gateway_hd192", "ring_tail_hd96",
         "heads32_32_hd96", "heads32_8_hd96", "vlm_prefix_hd96"]


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


@pytest.mark.parametrize("hd", ta.HOPPER_PATH_HEAD_DIMS["dq"])
@pytest.mark.parametrize("name", CASES)
def test_cuda_dq_hopper_matches_plain(dev, name, hd):
    """The dq kernel's Hopper path (bf16 at hd 64, 96, 128 and 192) on
    every case (at hd 192 those of S ≤ 64 leave its second warpgroup no rows):
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


# the reference's parity cases (ROADMAP Queue B): MHA, GQA, MQA, padding
# keys, gateway ancestors, window × branching, gateway × window (bf16 + GQA
# + ancestors), ragged tails, dead tiles between live ones, Nemotron's
# group of 12, and a last 128-row tile of 44 rows
HD192_CASES = ["mha", "gqa", "mqa", "padding", "gateway32", "gateway20",
               "window", "gateway_window", "ragged_gateway", "dead_tiles",
               "ring_tail_hd192", "heads96_8_hd192",
               "short_tail_gateway_hd192"]


@pytest.mark.parametrize("name", HD192_CASES)
def test_cuda_hd192_hopper_fwd_and_dkv_match_plain(dev, name):
    """bf16 at hd 192 runs all three Hopper paths, chained as in training:
    the forward's o and lse, then dq, whose kernel writes Δ, then dk/dv fed
    that Δ.  o and lse against the plain version in f32 at the forward's
    bf16 limits, the dq kernel's Δ against ``delta``, dq/dk/dv against the
    plain backward at the bf16 limits, every output bit-identical over two
    launches, dk/dv exactly 0 on keys no query sees."""
    q, k, v, kl, kw, do = _inputs(name, torch.bfloat16, dev, hd=192)
    sc = 192 ** -0.5
    bf16 = torch.bfloat16
    assert [ta.kernel_path(kern, bf16, 192) for kern in ("fwd", "dq", "dkv")
            ] == ["hopper", "hopper", "hopper"]
    assert tab.fuses_delta(q)
    with torch.inference_mode():
        o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True, **kw)
        o2, lse2 = ta.tree_attention(q, k, v, kl, sc, save_residuals=True,
                                     **kw)
        ro, rl = tree_attention_ref_ext(q.float(), k.float(), v.float(), kl,
                                        sc, return_lse=True, **kw)
        dq, dl = tab.bwd_dq(q, k, v, kl, o, lse, do, sc, **kw)
        dk, dv = tab.bwd_dkv(q, k, v, kl, lse, dl, do, sc, **kw)
        got = (dq, dk, dv)
        again = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc, **kw)
        want = tree_attention_bwd_ref(q.float(), k.float(), v.float(), kl,
                                      o.float(), lse, do.float(), sc, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-4)
    err = (o.float() - ro).abs()
    rms = ro.pow(2).mean(-1, keepdim=True).sqrt()
    assert bool((err <= 2 ** -7 * ro.abs() + 2e-2 * rms).all())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    _delta_close(dl, o, do)
    _hold_bwd(got, want, bf16)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    Skv = k.shape[1]
    first = torch.arange(Skv, device=dev).clamp(min=kw["q_off"])
    dead = kl < first                 # no query i ≥ max(j, q_off) sees key j
    assert not bool(got[1][dead].any()) and not bool(got[2][dead].any())
    if name == "padding":
        assert bool(dead[0, 16:].all())


@pytest.mark.parametrize("hd", [96, 128])
def test_cuda_hopper_kernels_launch_from_a_fresh_thread(dev, hd):
    """The Hopper paths encode their TMA tensor maps on the host at each
    launch, which needs a current CUDA context on the calling thread.  A
    thread whose first CUDA work is such a launch (a fresh Python thread
    here; autograd's backward worker in a training step) runs the three
    kernels and gets the main thread's outputs bit for bit (at hd 128
    the forward's is that thread's first launch)."""
    q, k, v, kl, kw, do = _inputs("gateway20", torch.bfloat16, dev, hd=hd)
    sc = hd ** -0.5

    def run():
        with torch.inference_mode():
            o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True,
                                       **kw)
            return (o, lse, *tab.tree_attention_bwd(q, k, v, kl, o, lse, do,
                                                    sc, **kw))

    out = {}
    th = threading.Thread(target=lambda: out.update(got=run()))
    th.start()
    th.join()
    want = run()
    torch.cuda.synchronize()
    assert "got" in out, "the kernels failed on a fresh thread"
    for a, b in zip(out["got"], want):
        assert torch.equal(a, b)


# the reference's parity cases at Phi-3-vision's head dim 96: MHA, GQA,
# MQA, padding keys, gateway ancestors, window × branching, gateway ×
# window, ragged tails, dead tiles between live ones, a ragged last key
# tile in dq's last ring stage, Phi-3's MHA 32/32 and a GQA 32/8, and its
# prefix rows
HD96_CASES = ["mha", "gqa", "mqa", "padding", "gateway32", "gateway20",
              "window", "gateway_window", "ragged_gateway", "dead_tiles",
              "ring_tail_hd96", "heads32_32_hd96", "heads32_8_hd96",
              "vlm_prefix_hd96"]


@pytest.mark.parametrize("name", HD96_CASES)
def test_cuda_hd96_hopper_fwd_matches_plain(dev, name):
    """The forward's Hopper path at hd 96 (bf16): o and lse against the
    plain version in f32 from the same bf16 inputs at the forward's bf16
    limits (o within 2^-7·|ref| + 2e-2 of its row's rms, lse at 1e-4),
    two launches bit-identical, one launch counted per call, and a row
    that sees no key at o = 0 and lse = −1e30 exactly."""
    q, k, v, kl, kw, _ = _inputs(name, torch.bfloat16, dev, hd=96)
    sc = 96 ** -0.5
    assert ta.kernel_path("fwd", torch.bfloat16, 96) == "hopper"
    n = ta.tree_attention.launches
    with torch.inference_mode():
        o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True, **kw)
        o2, lse2 = ta.tree_attention(q, k, v, kl, sc, save_residuals=True,
                                     **kw)
        ro, rl = tree_attention_ref_ext(q.float(), k.float(), v.float(), kl,
                                        sc, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert ta.tree_attention.launches == n + 2
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-4)
    err = (o.float() - ro).abs()
    rms = ro.pow(2).mean(-1, keepdim=True).sqrt()
    assert bool((err <= 2 ** -7 * ro.abs() + 2e-2 * rms).all())
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    blind = rl <= -1e29                             # [B,H,S]: sees no key
    assert bool((lse[blind] == -1e30).all())
    assert not bool(o[blind.transpose(1, 2)].any())
    if name == "padding":                           # queries 16.. see nothing
        assert bool(blind[0, :, 16:].all())


@pytest.mark.parametrize("name", HD96_CASES)
def test_cuda_hd96_hopper_bwd_matches_plain(dev, name):
    """bf16 at hd 96 chains the Hopper forward (o and its natural-log lse)
    into the Hopper dq, whose kernel writes Δ, and the Hopper dk/dv fed
    that Δ, as training does; and the same through ``ops.tree_attention``'s
    autograd node.  o and lse against the plain version in f32 at the
    forward's bf16 limits, the dq kernel's Δ against ``delta``, dq/dk/dv
    against the plain backward at the bf16 limits, every output
    bit-identical over two launches and equal to the op's grads, dk/dv
    exactly 0 on keys no query sees."""
    q, k, v, kl, kw, do = _inputs(name, torch.bfloat16, dev, hd=96)
    sc = 96 ** -0.5
    bf16 = torch.bfloat16
    assert [ta.kernel_path(kern, bf16, 96) for kern in ("fwd", "dq", "dkv")
            ] == ["hopper", "hopper", "hopper"]
    assert tab.fuses_delta(q)
    with torch.inference_mode():
        o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True, **kw)
        ro, rl = tree_attention_ref_ext(q.float(), k.float(), v.float(), kl,
                                        sc, return_lse=True, **kw)
        dq, dl = tab.bwd_dq(q, k, v, kl, o, lse, do, sc, **kw)
        dk, dv = tab.bwd_dkv(q, k, v, kl, lse, dl, do, sc, **kw)
        got = (dq, dk, dv)
        again = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc, **kw)
        want = tree_attention_bwd_ref(q.float(), k.float(), v.float(), kl,
                                      o.float(), lse, do.float(), sc, **kw)
    counts = (ta.tree_attention.launches, tab.bwd_dq.launches,
              tab.bwd_dkv.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    op = torch.autograd.grad(ops.tree_attention(*leaves, kl, sc, **kw),
                             leaves, do)
    torch.cuda.synchronize()
    assert (ta.tree_attention.launches, tab.bwd_dq.launches,
            tab.bwd_dkv.launches) == tuple(c + 1 for c in counts)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-4)
    err = (o.float() - ro).abs()
    rms = ro.pow(2).mean(-1, keepdim=True).sqrt()
    assert bool((err <= 2 ** -7 * ro.abs() + 2e-2 * rms).all())
    _delta_close(dl, o, do)
    _hold_bwd(got, want, bf16)
    for a, b, c in zip(got, again, op):
        assert torch.equal(a, b) and torch.equal(a, c)
    Skv = k.shape[1]
    first = torch.arange(Skv, device=dev).clamp(min=kw["q_off"])
    dead = kl < first                 # no query i ≥ max(j, q_off) sees key j
    assert not bool(got[1][dead].any()) and not bool(got[2][dead].any())
    if name == "padding":
        assert bool(dead[0, 16:].all())


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


@pytest.mark.parametrize("waves", [False, True], ids=["packed", "waves"])
def test_cuda_engine_grads_bit_identical_over_two_runs(dev, waves):
    """Qwen2-1.5B at smoke width in bf16: ``TreeTrainEngine.accumulate``
    twice from the same parameters and plan gives bit-identical gradients
    on every leaf and identical scalars — on a packed plan and on a plan
    whose oversized trees train on partition waves (capacity 256, rows of
    512).  Both runs make no host sync (``set_sync_debug_mode("error")``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.loader import LoaderConfig
    from repro_torch.device import tree_leaves
    from repro_torch.models.model import init_params
    from repro_torch.train.engine import TreeTrainEngine
    from repro_torch.train.planner import plans
    cfg = get_config("qwen2_1p5b", smoke=True).replace(dtype="bfloat16")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    lc = LoaderConfig(seq_len=512, batch_rows=2, trees_per_batch=6,
                      auto_partition=waves, capacity=256,
                      gen_kwargs=dict(turn_len_range=(8, 48), num_turns=4))
    plan = next(p for p in (ps.execution_plan() for ps in plans(cfg, lc, 8))
                if (p.has_waves if waves else not p.is_empty))
    engine = TreeTrainEngine(cfg)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runs.append(engine.accumulate(params, plan))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    (g1, s1), (g2, s2) = runs
    assert torch.equal(s1, s2) and bool(torch.isfinite(s1).all())
    for a, b in zip(tree_leaves(g1), tree_leaves(g2), strict=True):
        assert torch.equal(a, b)


def _zamba2_rows(S: int = 1024):
    """kv_last of agentic trees packed chunk-aligned (chunk 64, Zamba2's
    grid) into 2 rows of S: chunk-padding tokens sit between real ones,
    invisible as keys (kv_last −1) and seeing their own node as queries."""
    trees = trees_for_batch(31, n_trees=8, kind="agentic",
                            turn_len_range=(20, 90), num_turns=3)
    sers, used = [], 0
    for t in trees:
        s = serialize_tree(t, chunk_size=64)
        if used + s.n <= 2 * S * 3 // 4 and s.n <= S:
            sers.append(s)
            used += s.n
    tb = pack_trees(sers, S, batch_size=2, chunk_size=64)
    assert (~tb.valid[:, :used // 2]).any()      # pads inside the rows
    return tb.kv_last


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_zamba2_layout_on_chunk_padded_rows(dev, dtype):
    """Zamba2's shared attention block (H 32/Kh 32, hd 64) on chunk-padded
    rows: the forward and both backward kernels against the plain versions
    at the file's tolerances, invisible (pad) keys' dk/dv exactly 0, two
    backward launches bit-identical."""
    dt = getattr(torch, dtype)
    kl_np = _zamba2_rows()
    rng = np.random.default_rng(41)
    B, S = kl_np.shape
    mk = lambda *s: torch.tensor(rng.normal(size=s), dtype=dt, device=dev)
    q, k, v, do = mk(B, S, 32, 64), mk(B, S, 32, 64), mk(B, S, 32, 64), \
        mk(B, S, 32, 64)
    kl = torch.as_tensor(kl_np, dtype=torch.int32, device=dev)
    sc = 64 ** -0.5
    with torch.inference_mode():
        o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True)
        ro, rl = tree_attention_ref_ext(q.float(), k.float(), v.float(), kl,
                                        sc, return_lse=True)
        got = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc)
        again = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc)
        want = tree_attention_bwd_ref(q.float(), k.float(), v.float(), kl,
                                      o.float(), lse, do.float(), sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-4)
    if dtype == "float32":
        torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
    else:
        err = (o.float() - ro).abs()
        rms = ro.pow(2).mean(-1, keepdim=True).sqrt()
        assert bool((err <= 2 ** -7 * ro.abs() + 2e-2 * rms).all())
    _hold_bwd(got, want, dt)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    dead = kl < 0
    assert bool(dead.any())
    assert not bool(got[1][dead].any()) and not bool(got[2][dead].any())


@pytest.mark.parametrize("arch", ["rwkv6_1p6b", "zamba2_1p2b"])
def test_cuda_ssm_grads_bit_identical_over_two_runs(dev, arch):
    """An SSM arch at smoke width in bf16 on chunk-aligned rows:
    ``TreeTrainEngine.accumulate`` twice gives bit-identical gradients on
    every leaf (the tree state routing and the path gathers sum sibling
    cotangents in a fixed order), with no host sync."""
    from repro_torch.configs import get_config
    from repro_torch.data.loader import LoaderConfig
    from repro_torch.device import tree_leaves
    from repro_torch.models.model import init_params
    from repro_torch.train.engine import TreeTrainEngine
    from repro_torch.train.planner import plans
    cfg = get_config(arch, smoke=True).replace(dtype="bfloat16")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    lc = LoaderConfig(seq_len=1024, batch_rows=2, trees_per_batch=6,
                      gen_kwargs=dict(turn_len_range=(8, 48), num_turns=4))
    plan = next(p for p in (ps.execution_plan() for ps in plans(cfg, lc, 8))
                if not p.is_empty)
    engine = TreeTrainEngine(cfg)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runs.append(engine.accumulate(params, plan))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    (g1, s1), (g2, s2) = runs
    assert torch.equal(s1, s2) and bool(torch.isfinite(s1).all())
    for a, b in zip(tree_leaves(g1), tree_leaves(g2), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["rwkv6_1p6b", "zamba2_1p2b",
                                  "qwen3p5_gdn_2b"])
def test_cuda_ssm_session_graph_replays_match_the_forward(dev, arch):
    """An SSM or hybrid session on the card captures its step in a CUDA
    graph and replays it: teacher-forced at f32, its logits after each
    token equal the packed forward's within atol = rtol = 5e-4
    (tests/test_serve.py), and a fork's branches (their own graph) equal
    the unforked session's."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import TrajectoryTree, TreeNode
    from repro_torch.models.layers import logits_from_hidden
    from repro_torch.models.model import forward, init_params, prepare_batch
    from repro_torch.serve.session import DecodeSession
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, 40)
    cs = cfg.ssm.chunk_size
    S = 40 + (-40 % cs)
    tb = pack_trees([serialize_tree(TrajectoryTree(TreeNode(tokens=toks)),
                                    chunk_size=cs)], S, chunk_size=cs)
    with torch.inference_mode():
        hidden, _ = forward(cfg, params, prepare_batch(cfg, tb, device=dev))
        want = logits_from_hidden(params["embed"], params.get("lm_head"),
                                  hidden[0, :40])
        sess = DecodeSession.create(cfg, params, buf_len=S, device=dev)
        got = [sess.step([int(t)])[0] for t in toks[:30]]
        br = sess.fork(2)
        for t in toks[30:]:
            lg = br.step([int(t), int(t)])
            assert torch.equal(lg[0], lg[1])
            got.append(lg[0])
    assert sess._graph is not None and br._graph is not None
    torch.testing.assert_close(torch.stack(got), want, atol=5e-4, rtol=5e-4)


def _session_logits(cfg, params, dev, prompt, steps):
    """prefill(prompt) → fork(2) → one step per row of ``steps`` (both
    branches fed the same token): the logits of every call, branch 0."""
    from repro_torch.serve.session import DecodeSession
    sess = DecodeSession.create(cfg, params, buf_len=64, device=dev)
    out = [sess.prefill(prompt)[0]]
    br = sess.fork(2)
    for t in steps:
        lg = br.step([int(t), int(t)])
        assert torch.equal(lg[0], lg[1])
        out.append(lg[0])
    return torch.stack(out), br


@pytest.mark.parametrize("arch", ["qwen2_1p5b", "qwen3_30b_a3b",
                                  "rwkv6_1p6b", "zamba2_1p2b",
                                  "qwen3p5_gdn_2b"])
def test_cuda_session_graph_replays_match_eager_steps(dev, arch):
    """Every family's session on the card replays its step from a CUDA
    graph (``DecodeSession.graph_steps``): at f32, a prefill, a fork(2)
    and 20 steps give the logits of the same session stepping eagerly
    (graphs off) within atol = rtol = 1e-5 (the two run the same kernels;
    only the capture's cuBLAS workspace may differ)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.session import DecodeSession
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(4)
    prompt, steps = (rng.integers(0, cfg.vocab_size, 12),
                     rng.integers(0, cfg.vocab_size, 20))
    with torch.inference_mode():
        graphed, br = _session_logits(cfg, params, dev, prompt, steps)
        assert br._graph is not None
        DecodeSession.graph_steps = False
        try:
            eager, br = _session_logits(cfg, params, dev, prompt, steps)
        finally:
            DecodeSession.graph_steps = True
        assert br._graph is None
    torch.testing.assert_close(graphed, eager, atol=1e-5, rtol=1e-5)


def _pooled_logits(cfg, params, dev, pool, prompt, steps, extra):
    """prefill → fork(3) → steps → (a second prefill where the family
    prefills in parallel) → steps, through ``pool``: every call's logits
    (all branches); the sessions are closed after."""
    from repro_torch.serve.session import DecodeSession
    sess = DecodeSession.create(cfg, params, buf_len=64, device=dev,
                                graph_pool=pool)
    out = [sess.prefill(prompt)]
    br = sess.fork(3)
    half = len(steps) // 2
    for t in steps[:half]:
        out.append(br.step(torch.full((3,), int(t), device=dev)))
    if extra is not None:
        out.append(br.prefill(extra))
    for t in steps[half:]:
        out.append(br.step(torch.full((3,), int(t), device=dev)))
    sess.close()
    br.close()
    return out


@pytest.mark.parametrize("arch", ["qwen2_1p5b", "zamba2_1p2b"])
def test_cuda_pooled_decode_graphs_replay_bit_identically(dev, arch):
    """The shape-keyed store with real CUDA graphs (bf16): a second session
    of one shape leases the first one's graphs and captures nothing, and
    its logits (a second prefill after the lease too) are ``torch.equal``
    to the first one's and to a session without a pool (every step of
    which replays a graph of its own); a snapshot taken while its source
    holds the lease captures a graph of its own and steps as its source."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.session import DecodeSession, GraphPool
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(5)
    prompt, steps = (rng.integers(0, cfg.vocab_size, 12),
                     rng.integers(0, cfg.vocab_size, 16))
    extra = rng.integers(0, cfg.vocab_size, 5) if cfg.ssm is None else None
    with torch.inference_mode():
        pool = GraphPool(dev)
        a = _pooled_logits(cfg, params, dev, pool, prompt, steps, extra)
        captures = pool.captures
        b = _pooled_logits(cfg, params, dev, pool, prompt, steps, extra)
        c = _pooled_logits(cfg, params, dev, None, prompt, steps, extra)
        assert captures == (1 if cfg.ssm is None else 2)
        assert pool.captures == captures and pool.reuses == captures
        sess = DecodeSession.create(cfg, params, buf_len=64, device=dev,
                                    graph_pool=pool)
        sess.prefill(prompt)
        br = sess.fork(3)
        br.step(torch.zeros(3, dtype=torch.long, device=dev))
        snap = br.snapshot()
        x = br.step(torch.ones(3, dtype=torch.long, device=dev))
        y = snap.step(torch.ones(3, dtype=torch.long, device=dev))
        assert pool.captures == captures + 1
        for s in (sess, br, snap):
            s.close()
    assert len(a) == len(b) == len(c)
    assert all(torch.equal(p, q) and torch.equal(p, r)
               for p, q, r in zip(a, b, c))
    assert torch.equal(x, y)
