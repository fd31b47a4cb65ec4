#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA
                                   # card with sm_90a (H100) and nvcc

Phases, each of which ends the run non-zero if it fails:
  1. build  — nvcc the tree-attention kernel from the repo's .cu source.
  2. kernel — hold the kernel against its plain PyTorch version on the card,
              computed in f32 from the same inputs (o and lse at 1e-4; a
              bf16 o within its rounding: 2^-7 of it plus 2e-2 of its
              row's rms), and a bf16 kernel also against the plain version
              run in bf16 (2e-2), on packed branching trees, MHA/GQA/MQA, padding keys, gateway ancestors, windows,
              prefill_attention, every head dim, a packed agentic row and
              the serving path's two shapes; prints block-skip fractions.
  3. serve  — Qwen2-1.5B at full width, random bf16 weights: 4 rollout
              groups (prompt 1024, K=8, 64 new tokens) and one multi-turn
              agentic session (prefill → fork(8) → 32 steps → a 200-token
              tool-output prefill on all branches → 32 steps).  Launch
              counts are reset just before and read just after.
  4. parity — replay the multi-turn session with the plain attention,
              teacher-forced: 4 layers in f32 (≤ 1e-4 max-rel) and all 28
              layers in bf16 (relative L2 ≤ 3e-2).
  5. timing — the kernel, its plain version and one library call
              (scaled_dot_product_attention with the dense mask) at the
              serving path's two shapes, beside the H100's bound.

The line before the last names the card and its power limit; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import serialize_tree  # noqa: E402
from repro_torch.data.synthetic import agentic_tree, random_tree  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from repro_torch.kernels.ref import tree_attention_ref_ext  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve.rollout import (RolloutConfig, rollout_group,  # noqa: E402
                                       sample_tokens)
from repro_torch.serve.session import DecodeSession  # noqa: E402

BIG = 1 << 30
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL_F32 = 1e-4                # f32 sums in another order on the card
TOL_BF16_PLAIN = 2e-2         # against the plain version run in bf16
DEV = "cuda"
CARD = ""


def log(msg: str) -> None:
    print(f"{msg}  [{CARD}]", flush=True)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def pack_row(sers, S: int, fill: float = 1.0):
    """Serialized trees laid end to end in one row of S slots (kv_last
    shifted by each tree's offset), padded with invisible keys."""
    kv = np.full(S, -1, np.int64)
    pos = np.zeros(S, np.int64)
    off = 0
    for s in sers:
        if off + s.n > int(S * fill):
            continue
        kv[off:off + s.n] = np.where(s.kv_last >= 0, s.kv_last + off, -1)
        pos[off:off + s.n] = s.pos_ids
        off += s.n
    return kv, pos


def tree_rows(seed: int, B: int, S: int, fill: float = 0.75):
    rng = np.random.default_rng(seed)
    rows = [pack_row([serialize_tree(random_tree(
        rng, seg_len_range=(4, 48), max_depth=4)) for _ in range(8 * S // 64)],
        S, fill) for _ in range(B)]
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def qkv(rng, B, S, Skv, H, Kh, hd, dtype):
    mk = lambda *sh: torch.tensor(rng.normal(size=sh), dtype=dtype, device=DEV)
    return mk(B, S, H, hd), mk(B, Skv, Kh, hd), mk(B, Skv, Kh, hd)


def i32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=DEV)


def gateway(kv_main, pos_main, A: int, pad_rows):
    """The gateway layout models/attention.py assembles: A ancestors in
    front (kv_last 2^30, or −1 on front-padded rows), DFS indices shifted."""
    B = kv_main.shape[0]
    anc = np.full((B, A), BIG, np.int64)
    for r, p in enumerate(pad_rows):
        anc[r, :p] = -1
    kl = np.concatenate([anc, np.where(kv_main >= 0, kv_main + A, -1)], 1)
    pos_q = pos_main + A
    pos_k = np.concatenate([np.tile(np.arange(A), (B, 1)), pos_q], 1)
    return kl, pos_q, pos_k


def kernel_cases():
    """(name, dtype, q, k, v, kv_last, q_off, window, pos_q, pos_k)."""
    rng = np.random.default_rng(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []

    def add(name, dt, B, S, H, Kh, hd, kl, q_off=0, window=None, pq=None,
            pk=None):
        q, k, v = qkv(rng, B, S, kl.shape[1], H, Kh, hd, dt)
        cases.append((name, dt, q, k, v, i32(kl), q_off, window,
                       None if pq is None else i32(pq),
                       None if pk is None else i32(pk)))

    kl, pos = tree_rows(1, 2, 2048)
    add("trees MHA f32", f32, 2, 2048, 8, 8, 64, kl)
    add("trees GQA 12/2 bf16", bf16, 2, 2048, 12, 2, 128, kl)
    add("trees MQA f32", f32, 2, 2048, 8, 1, 128, kl)
    pad = np.full((1, 1024), -1)
    pad[0, :300] = 299
    add("padding keys f32", f32, 1, 1024, 12, 2, 128, pad)
    kl2, pos2 = tree_rows(2, 2, 512)
    for A, rows in ((64, (0, 7)), (20, (5, 0))):
        g, pq, pk = gateway(kl2, pos2, A, rows)
        for dt in (f32, bf16):
            add(f"gateway A={A} {dt}", dt, 2, 512, 12, 2, 128, g, q_off=A)
    add("window 32 x branching f32", f32, 2, 2048, 12, 2, 128, kl,
        window=32, pq=pos, pk=pos)
    g, pq, pk = gateway(kl2, pos2, 20, (9, 0))
    add("gateway A=20 window 16 bf16", bf16, 2, 512, 12, 2, 128, g,
        q_off=20, window=16, pq=pq, pk=pk)
    for hd in ta.HEAD_DIMS:
        g, _, _ = gateway(kl2[:, :200], pos2[:, :200], 20, (3, 0))
        for dt in (f32, bf16):
            add(f"head dim {hd} {dt}", dt, 2, 200, 4, 2, hd, g, q_off=20)
    trng = np.random.default_rng(3)
    sers = [serialize_tree(agentic_tree(trng, turn_len_range=(32, 256)))
            for _ in range(40)]
    akl, _ = pack_row(sers, 4096)
    add("agentic row S=4096 bf16", bf16, 1, 4096, 12, 2, 128, akl[None])
    add("path: prefill S=1024 bf16", bf16, 1, 1024, 12, 2, 128,
        np.full((1, 1024), 1023))
    add("path: tool prefill S=200 q_off=1056 bf16", bf16, 8, 200, 12, 2, 128,
        np.concatenate([np.full((8, 1056), BIG), np.full((8, 200), 1255)],
                       1), q_off=1056)
    return cases


def close(a: torch.Tensor, b: torch.Tensor, tol: float):
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool(torch.isfinite(a).all()) and bool(
        (err <= tol + tol * b.abs()).all())
    return ok, float(err.max())


def close_bf16(o: torch.Tensor, ref: torch.Tensor):
    """A bf16 kernel output against the plain version computed in f32 from
    the same bf16 inputs.  The kernel keeps fp32 logits and accumulators
    and rounds only P (to bf16, before P·V) and o, so each element must lie
    within 2^-7 of itself (o's rounding, with margin) plus 2e-2 of its
    row's rms over hd (P's rounding: ~2^-8/√3 of the rms per element, so
    2e-2 is about 5 standard deviations with margin).  A dropped live tile
    moves whole rows by tens of per cent of their rms.  Returns (ok, max
    abs error, max error over row rms)."""
    o, ref = o.float(), ref.float()
    err = (o - ref).abs()
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    ok = bool(torch.isfinite(o).all()) and bool(
        (err <= 2 ** -7 * ref.abs() + 2e-2 * rms).all())
    rel = float(torch.where(err > 0, err / rms, 0.0).max())
    return ok, float(err.max()), rel


def plain(q, k, v, *args, f32: bool = False, **kw):
    """The kernel's plain version, in the inputs' dtype or (``f32``) in f32
    from the same values."""
    if f32:
        q, k, v = q.float(), k.float(), v.float()
    return tree_attention_ref_ext(q, k, v, *args, **kw)


def hold(tag: str, o, ref32, lse=None, lse32=None, o_bf16=None,
         lse_bf16=None) -> float:
    """Check the kernel's o (and lse) against the plain version computed in
    f32 (``ref32``/``lse32``), and a bf16 kernel also against the plain
    version run in bf16 (``o_bf16``/``lse_bf16``).  Logs the errors and
    returns o's max abs error against the f32 plain version."""
    if o.dtype == torch.float32:
        ok, e = close(o, ref32, TOL_F32)
        txt = f"o max_abs_err {e:.3e} (tol {TOL_F32:g})"
    else:
        ok, e, rel = close_bf16(o, ref32)
        txt = (f"o max_abs_err {e:.3e}, max err/row rms {rel:.3e} (tol "
               f"2^-7|ref| + 2e-2 rms)")
    if lse is not None:
        ok_l, el = close(lse, lse32, TOL_F32)
        ok = ok and ok_l
        txt += f", lse max_abs_err {el:.3e} (tol {TOL_F32:g})"
    if o.dtype == torch.bfloat16:
        ok_b, eb = close(o, o_bf16, TOL_BF16_PLAIN)
        txt += f"; vs plain in bf16: o {eb:.3e}"
        if lse is not None:
            ok_bl, ebl = close(lse, lse_bf16, TOL_BF16_PLAIN)
            ok_b = ok_b and ok_bl
            txt += f", lse {ebl:.3e}"
        ok = ok and ok_b
        txt += f" (tol {TOL_BF16_PLAIN:g})"
    log(f"kernel vs plain (f32): {tag}: {txt}")
    check(ok, f"kernel disagrees with plain on {tag}")
    return e


def skip_fraction(kl, S, q_off, window, pq, pk) -> float:
    B = kl.shape[0]
    kl, pq, pk = (None if t is None else t.cpu().numpy() for t in (kl, pq, pk))
    live = [ta.block_live_mask(kl[b], S, q_off=q_off, window=window,
                               pos_q=None if pq is None else pq[b],
                               pos_k=None if pk is None else pk[b])
            for b in range(B)]
    return 1.0 - float(np.mean([m.mean() for m in live]))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_build() -> float:
    t0 = time.perf_counter()
    lib = build.build(ta.SOURCE)
    dt = time.perf_counter() - t0
    log_txt = lib.with_suffix(".log").read_text()
    regs = [int(w) for line in log_txt.splitlines() if "Used" in line
            for w in [line.split("Used")[1].split()[0]]]
    spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                 for line in log_txt.splitlines() if "spill stores" in line)
    log(f"build: nvcc {' '.join(build.NVCC_FLAGS)} {ta.SOURCE} -> "
        f"{lib.name} in {dt:.2f} s; {len(regs)} kernel instances, "
        f"max {max(regs)} registers, {spills} bytes spill stores in all")
    return dt


def phase_kernel() -> float:
    worst = 0.0
    with torch.inference_mode():
        for name, dt, q, k, v, kl, q_off, window, pq, pk in kernel_cases():
            kw = dict(q_off=q_off, window=window, pos_q=pq, pos_k=pk)
            sc = q.shape[-1] ** -0.5
            o, lse = ops.tree_attention(q, k, v, kl, sc, save_residuals=True,
                                        **kw)
            torch.cuda.synchronize()
            ro, rl = plain(q, k, v, kl, sc, f32=True, return_lse=True, **kw)
            bo = bl = None
            if dt == torch.bfloat16:
                bo, bl = plain(q, k, v, kl, sc, return_lse=True, **kw)
            skip = skip_fraction(kl, q.shape[1], q_off, window, pq, pk)
            worst = max(worst, hold(f"{name} (block-skip fraction "
                                    f"{skip:.3f})", o, ro, lse, rl, bo, bl))
        # prefill_attention: no context, context, an invalid context row
        rng = np.random.default_rng(5)
        B, A, S, H, Kh, hd = 2, 300, 500, 12, 2, 128
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(rng, B, A + S, A + S, H, Kh, hd, dt)
            sc = hd ** -0.5
            out0 = ops.prefill_attention(q, k, v, sc)
            # the kernel takes contiguous tensors: split into new ones
            qn, kn, vn, kc, vc = (t.contiguous() for t in (
                q[:, A:], k[:, A:], v[:, A:], k[:, :A], v[:, :A]))
            out1 = ops.prefill_attention(
                qn, kn, vn, sc, ctx_k=kc, ctx_v=vc,
                ctx_valid=torch.ones(B, A, dtype=torch.bool, device=DEV))
            valid = torch.ones(B, A, dtype=torch.bool, device=DEV)
            valid[:, 7] = False
            out2 = ops.prefill_attention(qn, kn, vn, sc, ctx_k=kc, ctx_v=vc,
                                         ctx_valid=valid)
            keep = [i for i in range(A + S) if i != 7]

            def refs(f32):
                full = plain(q, k, v, i32(np.full((B, A + S), A + S - 1)),
                             sc, f32=f32)
                drop = plain(q[:, A:], k[:, keep], v[:, keep],
                             i32(np.full((B, A + S - 1), A + S - 2)), sc,
                             q_off=A - 1, f32=f32)
                return full, full[:, A:], drop

            tags = ("no context", "context", "invalid context row")
            for tag, out, r32, rdt in zip(tags, (out0, out1, out2),
                                          refs(True), refs(False)):
                worst = max(worst, hold(f"prefill_attention {tag} {dt}",
                                        out, r32, o_bf16=rdt))
    return worst


def multiturn(cfg, params, impl: str, gen=None, record=None):
    """prefill 1024 → fork(8) → 32 steps → prefill 200 "tool output"
    tokens on all 8 branches (the kernel's q_off path) → 32 steps.

    Samples with ``gen``, or, given ``record`` (the fed tokens of an
    earlier run), replays those tokens.  Returns (fed tokens, logits per
    call, host-clock seconds and tokens of prefill and of decode)."""
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, 1024).astype(np.int32)
    tool = rng.integers(0, cfg.vocab_size, 200).astype(np.int32)
    fed, logits = [], []
    timing = {"prefill_s": 0.0, "prefill_tok": 0, "decode_s": 0.0,
              "decode_tok": 0}

    def run(kind, n_tok, fn, toks):
        if record is not None:
            toks = record[len(fed)]
        fed.append(toks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(toks)
        torch.cuda.synchronize()
        timing[f"{kind}_s"] += time.perf_counter() - t0
        timing[f"{kind}_tok"] += n_tok
        check(bool(torch.isfinite(out).all()), f"non-finite logits ({impl})")
        logits.append(out)
        return out

    def sample(lg):
        if record is not None:
            return None
        return sample_tokens(lg, cfg.vocab_size, gen, 1.0)

    sess = DecodeSession.create(cfg, params, buf_len=1536)
    lg = run("prefill", len(prompt), lambda t: sess.prefill(t, impl=impl),
             prompt)
    br = sess.fork(8)
    tok = sample(lg.expand(8, -1))
    for turn in range(2):
        if turn:
            lg = run("prefill", 8 * len(tool),
                     lambda t: br.prefill(t, impl=impl), tool)
            tok = sample(lg)
        for _ in range(32):
            lg = run("decode", 8, br.step, tok)
            tok = sample(lg)
    return fed, logits, timing


def phase_serve(cfg, params):
    rc = RolloutConfig(k=8, prompt_len=1024, max_new=64, temperature=1.0)
    gen = torch.Generator(DEV).manual_seed(1)
    rng = np.random.default_rng(7)
    ta.tree_attention.launches = 0
    n_prefill = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for g in range(4):
            prompt = rng.integers(0, cfg.vocab_size, rc.prompt_len)
            tree, st = rollout_group(cfg, params, prompt, rc, gen)
            n_prefill += 1
            check(st.prefill_tokens == rc.prompt_len,
                  f"group {g}: prefill_tokens {st.prefill_tokens}")
            check(st.decode_tokens == rc.k * (rc.max_new - 1),
                  f"group {g}: decode_tokens {st.decode_tokens}")
            check(tree.num_unique_tokens() <= rc.prompt_len
                  + rc.k * rc.max_new, f"group {g}: tree too large")
            check(tree.root.size >= rc.prompt_len and tree.num_leaves()
                  == rc.k, f"group {g}: prompt not shared by {rc.k} leaves")
        torch.cuda.synchronize()
        t_groups = time.perf_counter() - t0
        calls, logits, tm = multiturn(cfg, params, "kernel", gen)
        n_prefill += 2
    launches = ta.tree_attention.launches
    log(f"serve: 4 rollout groups (prompt {rc.prompt_len}, k {rc.k}, "
        f"max_new {rc.max_new}) in {t_groups:.3f} s; multi-turn session: "
        f"prefill {tm['prefill_tok'] / tm['prefill_s']:.1f} tokens/s "
        f"({tm['prefill_tok']} tokens in {tm['prefill_s']:.4f} s), decode "
        f"{tm['decode_tok'] / tm['decode_s']:.1f} tokens/s "
        f"({tm['decode_tok']} tokens in {tm['decode_s']:.4f} s)")
    log(f"serve: tree_attention kernel launches {launches} = "
        f"{cfg.n_layers} layers x {n_prefill} parallel prefills")
    check(launches == cfg.n_layers * n_prefill,
          f"kernel launches {launches} != {cfg.n_layers} x {n_prefill}")
    return calls, logits, launches


def replay_error(cfg, params, calls, logits, metric):
    with torch.inference_mode():
        _, ref, _ = multiturn(cfg, params, "ref", record=calls)
    return max(metric(a, b) for a, b in zip(logits, ref))


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def phase_parity(cfg_full, params_full, calls, logits):
    e = replay_error(cfg_full, params_full, calls, logits, rel_l2)
    log(f"parity: {cfg_full.n_layers} layers bf16, kernel vs plain "
        f"attention, teacher-forced multi-turn: max relative L2 of logits "
        f"{e:.3e} (limit 3e-2)")
    check(e <= 3e-2, "full-depth bf16 path parity")
    cfg4 = cfg_full.replace(n_layers=4, dtype="float32")
    p4 = init_params(cfg4, torch.Generator(DEV).manual_seed(0))
    with torch.inference_mode():
        calls4, logits4, _ = multiturn(cfg4, p4, "kernel",
                                       torch.Generator(DEV).manual_seed(2))
    e4 = replay_error(cfg4, p4, calls4, logits4, max_rel)
    log(f"parity: 4 layers f32, kernel vs plain attention, teacher-forced "
        f"multi-turn: max relative error of logits {e4:.3e} (limit 1e-4)")
    check(e4 <= 1e-4, "reduced-depth f32 path parity")
    del p4


def time_ms(fn, reps=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def phase_timing():
    rng = np.random.default_rng(9)
    shapes = [("prefill S=1024 q_off=0", 1, 1024, 0),
              ("tool prefill S=200 q_off=1056", 8, 200, 1056)]
    out = []
    with torch.inference_mode():
        for name, B, S, q_off in shapes:
            H, Kh, hd, dt = 12, 2, 128, torch.bfloat16
            Skv = q_off + S
            q, k, v = qkv(rng, B, S, Skv, H, Kh, hd, dt)
            kl = i32(np.concatenate([np.full((B, q_off), BIG),
                                     np.full((B, S), Skv - 1)], 1))
            sc = hd ** -0.5
            mask = ((torch.arange(Skv, device=DEV)[None, :]
                     <= q_off + torch.arange(S, device=DEV)[:, None])
                    & (kl[:, None, :] >= q_off
                       + torch.arange(S, device=DEV)[None, :, None]))[:, None]
            # the yardstick gets K/V expanded to every query head (outside
            # the timed call) so any of PyTorch's masked backends can run
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (t.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
                      .contiguous() for t in (k, v))
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=sc)
            kern = lambda: ta.tree_attention(q, k, v, kl, sc, q_off=q_off)
            plain = lambda: tree_attention_ref_ext(q, k, v, kl, sc,
                                                   q_off=q_off)
            e_lib = float((lib().transpose(1, 2).float()
                           - kern().float()).abs().max())
            ms_k, ms_p, ms_l = time_ms(kern), time_ms(plain), time_ms(lib)
            # the work the function needs: 2·hd for q·k and 2·hd for p·v on
            # each visible (query, key) pair of every head
            flops = 4 * hd * H * int(mask.sum())
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + kl.numel() * 4
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            bound = max(t_ops, t_bytes) * 1e3
            by = "operations" if t_ops >= t_bytes else "bytes"
            log(f"timing {name} (B={B}, H=12, Kh=2, hd=128, bf16, CUDA "
                f"events, median of 20 after 3 warm-up): kernel {ms_k:.4f} "
                f"ms, plain {ms_p:.4f} ms, sdpa (dense bool mask) "
                f"{ms_l:.4f} ms, bound {bound:.4f} ms by {by} "
                f"({flops / 1e9:.3f} GFLOP on visible pairs, "
                f"{nbytes / 1e6:.3f} MB); "
                f"kernel at {flops / ms_k / 1e9:.1f} TFLOP/s; sdpa vs kernel "
                f"max_abs_err {e_lib:.3e}")
            out.append(dict(ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
                            bound_ms=bound, bound_by=by))
    return out


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t_start = time.perf_counter()
    phase_build()
    worst = phase_kernel()

    cfg = get_config("qwen2_1p5b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0))
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {cfg.n_layers} layers d {cfg.d_model} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size} (padded {cfg.padded_vocab}) "
        f"heads {cfg.attn.n_heads}/{cfg.attn.n_kv_heads} hd "
        f"{cfg.attn.head_dim} {cfg.dtype}: {cfg.param_count() / 1e9:.3f} B "
        f"params, {torch.cuda.memory_allocated() / 1e9:.2f} GB, random "
        f"weights in {time.perf_counter() - t0:.2f} s")
    calls, logits, launches = phase_serve(cfg, params)
    phase_parity(cfg, params, calls, logits)
    del params, logits
    timing = phase_timing()[0]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    entry = dict(name="tree_attention_fwd", route="cuda",
                 source="src/repro_torch/kernels/csrc/tree_attention_fwd.cu",
                 replaces="src/repro/kernels/tree_attention.py:112",
                 launches=launches, max_abs_err=worst, **timing)
    print(json.dumps({"kernels": [entry]}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
