#!/usr/bin/env python3
"""The hd 96 Hopper kernels' design choices, measured on one NVIDIA GPU.

    python3 tools/hd96_width.py [--out FILE]   (default build/hd96_width.json)

Builds this checkout's kernels (``chip_smoke.phase_build``: each instance's
registers, spills, HGMMA and UTMALDG) and, from copies of ``csrc/`` with
the edits of ``EDITS``, the hd 96 instances of the three sources in these variants
(ptxas's registers and spills, SASS's HGMMA and UTMALDG for each):

  - the forward's:
    - ``wg2``: 128 query rows a block on two consumer warpgroups that
      share one K/V ring (hd 192's layout, ``fwd_wgs``), two blocks an SM
      with the kept 2-stage ring;
    - ``wg2_1``: the same at one block an SM with a 3-stage ring;
    - ``overlap``: each live tile's S = Q·Kᵀ issued with the O += P·V
      of the tile before it, the softmax run while that P·V is in flight
      (``_OVERLAP``), which holds both stages of the 2-stage ring;
    - ``overlap_1``: the same at one block an SM with a 3-stage ring, so
      that the producer loads a tile ahead while the consumer holds two;
    - ``one_block``: the kept form at one block an SM with a 3-stage
      ring, ``overlap_1``'s occupancy without its overlap;
  - the backward's:
    - ``n128``: dQ, dK and dV as m64n128k16 over the whole padded tile
      (``hopper.cuh::pad_cols`` wide: 64 accumulator registers each,
      columns 96-127 summing TMA's zeros) where the kept kernels run
      m64n96k16 (48 each);
    - ``dkv1``: the dk/dv kernel at one block an SM with a 3-stage ring
      (hd 128's occupancy) where the kept one runs two blocks with 2 stages
      (hd 64's occupancy, 168 registers);
  - ``simple``: the simple kernels all three ran at hd 96 before their
    Hopper paths (the wrappers' routing table set back for the variant's
    turn, so ``bwd_dq`` computes Δ with ``delta``).

On Phi-3-vision's rows V (its first train step's kv_last behind the
576-row prefix, B 2, H 32/Kh 32, bf16) and the bf16 hd 96 cases of
``chip_smoke.mm_kernel_cases``, for the kept kernels and each variant:

  - the forward's o and lse, twice, held against the plain version at
    chip_smoke's bf16 forward limits, the two launches and the kept
    forward's outputs compared bit for bit, rows that see no key at o = 0
    and lse = −1e30;
  - from the kept forward's o and lse, dq (Δ in its kernel where it has a
    Hopper path) and dk/dv fed that Δ, twice, held against the plain
    backward at chip_smoke's bf16 limits, compared the same way.

Then the device time (CUDA-graph replay, as chip_smoke's ``device_ms``) at
V, in turns: the forward's (kept, its variants, simple, simple, its
variants reversed, kept) beside SDPA's forward with the dense mask and the
forward's bound, then dq's and dk/dv's (kept, n128, dkv1, simple, simple,
dkv1, n128, kept).  Prints the card and its power limit; writes every
number to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

FWD, DQ, DKV = ("tree_attention_fwd.cu", "tree_attention_bwd_dq.cu",
                "tree_attention_bwd_dkv.cu")
_WGS = ("return HD == 192 ? 2 : 1;", "return HD == 192 || HD == 96 ? 2 : 1;")
_ONE_BLOCK = [
    ("__launch_bounds__(fwd_threads<HD>(), HD == 192 ? 1 : 2)",
     "__launch_bounds__(fwd_threads<HD>(), HD == 192 || HD == 96 ? 1 : 2)"),
    ("using FwdLayout = hop::KeyTileLayout<HD, fwd_wgs<HD>()>;",
     "using FwdLayout = hop::KeyTileRingLayout<HD, fwd_wgs<HD>(), 3>;")]
# The kept consumer loop, turned into FlashAttention-3's intra-warpgroup
# pipelining: each live tile's S is issued with the P·V of the tile before
# it (prev), the softmax runs while that P·V is in flight, and O is
# rescaled once it has landed, so O sees acc·c + P·V in the kept order.
# The first tile's P·V is 0·V (P starts at 0), which keeps the loop free
# of branches around its wgmmas.  A stage is released once its P·V has
# retired: the consumer holds two stages (prev and this tile).
_PV = ("#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n"
       "      hop::wgmma_rs<HD>(acc, pa[kk], hop::desc_mn({} + kk * 16 * 128));\n")
_OVERLAP = [
    ("  int stage = 0;\n  uint32_t phase = 0;\n",
     "  int stage = 0, prev = -1;\n  uint32_t phase = 0, v_prev = 0;\n"
     "  uint32_t pa[4][4] = {};\n"),
    ("    if (k0 < 0) break;\n",
     "    if (k0 < 0) {\n      if (prev >= 0) {\n        hop::wgmma_fence();\n"
     + _PV.format("v_prev").replace("\n    ", "\n        ")
     + "        hop::wgmma_commit();\n        hop::wgmma_wait<0>();\n"
       "        hop::fence_regs(acc);\n"
       "        hop::mbar_arrive(&empty[prev]);\n      }\n      break;\n    }\n"),
    ("    hop::wgmma_commit();\n    hop::wgmma_wait<0>();\n    hop::fence_regs(s);",
     "    hop::wgmma_commit();\n" + _PV.format("(prev >= 0 ? v_prev : v_base)")
     + "    hop::wgmma_commit();\n    hop::wgmma_wait<1>();\n"
       "    hop::fence_regs(s);"),
    ("    l1 = l1 * c1 + sum1;\n",
     "    l1 = l1 * c1 + sum1;\n    hop::wgmma_wait<0>();\n"
     "    hop::fence_regs(acc);\n"
     "    if (prev >= 0) hop::mbar_arrive(&empty[prev]);\n"),
    ("    uint32_t pa[4][4];\n", ""),
    ("    hop::wgmma_fence();\n" + _PV.format("v_base")
     + "    hop::wgmma_commit();\n    hop::wgmma_wait<0>();\n"
       "    hop::fence_regs(acc);\n    hop::mbar_arrive(&empty[stage]);\n",
     "    prev = stage;\n    v_prev = v_base;\n")]
_N128 = "hop::pad_cols<HD>()"
# variant → {source: [(text, replacement)]}
EDITS = {
    "wg2": {FWD: [_WGS]},
    "wg2_1": {FWD: [_WGS, *_ONE_BLOCK]},
    "overlap": {FWD: _OVERLAP},
    "overlap_1": {FWD: [*_OVERLAP, *_ONE_BLOCK]},
    "one_block": {FWD: _ONE_BLOCK},
    "n128": {DQ: [
        ("float dqa[HD / 2];", f"float dqa[{_N128} / 2];"),
        ("i < HD / 2; ++i) dqa[i]", f"i < {_N128} / 2; ++i) dqa[i]"),
        ("hop::wgmma_rs<HD>(dqa,", f"hop::wgmma_rs<{_N128}>(dqa,")],
        DKV: [
        ("float dka[HD / 2], dva[HD / 2];",
         f"float dka[{_N128} / 2], dva[{_N128} / 2];"),
        ("for (int i = 0; i < HD / 2; ++i) {\n    dka[i]",
         f"for (int i = 0; i < {_N128} / 2; ++i) {{\n    dka[i]"),
        ("hop::wgmma_rs<HD>(dva,", f"hop::wgmma_rs<{_N128}>(dva,"),
        ("hop::wgmma_rs<HD>(dka,", f"hop::wgmma_rs<{_N128}>(dka,")]},
    "dkv1": {DKV: [
        ("__launch_bounds__(dkv_threads<HD>(), HD <= 96 ? 2 : 1)",
         "__launch_bounds__(dkv_threads<HD>(), HD <= 64 ? 2 : 1)"),
        ("static constexpr int STAGES = HD == 96 ? 2 : 3;",
         "static constexpr int STAGES = 3;")]},
    "simple": {src: [("if constexpr (HD == 64 || HD == 96 || HD == 128 || "
                      "HD == 192)",
                      "if constexpr (HD == 64 || HD == 128 || HD == 192)")]
               for src in (FWD, DQ, DKV)},
}


def turns(kernel_srcs) -> tuple:
    """kept, the variants that edit one of ``kernel_srcs`` (simple last),
    then the same reversed."""
    vs = [v for v in EDITS if v != "simple"
          and any(s in EDITS[v] for s in kernel_srcs)] + ["simple"]
    return ("kept", *vs, *reversed(vs), "kept")


FWD_ORDER, BWD_ORDER = turns((FWD,)), turns((DQ, DKV))


def build_variants(build, cs, out_dir: Path) -> dict:
    """nvcc every (variant, source) at once, the switch cut to its hd 96
    case, each from a copy of the source and the headers in a directory of
    its own.  {(variant, source): (library, report)}, the report holding
    ptxas's lines, the hd 96 instance's registers and spill bytes, its
    HGMMA and UTMALDG counts and whether ptxas serialized a wgmma."""
    procs = {}
    for var, edits in EDITS.items():
        for src, pairs in edits.items():
            files = {src: (build.CSRC / src).read_text()}
            files.update({h.name: h.read_text()
                          for h in build.CSRC.glob("*.cuh")})
            for old, new in pairs:
                if old not in files[src]:
                    raise RuntimeError(f"{var}: {old!r} not in {src}")
                files[src] = files[src].replace(old, new)
            files[src] = re.sub(r"\n\s*TREE_ATTN_HD\((?!96\))\d+\)", "",
                                files[src])
            vdir = out_dir / f"{var}-{Path(src).stem}"
            vdir.mkdir(parents=True, exist_ok=True)
            for name, text in files.items():
                (vdir / name).write_text(text)
            lib = vdir / "variant.so"
            log = lib.with_suffix(".log").open("w")
            procs[(var, src)] = (lib, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                 str(vdir / src)], stdout=log, stderr=subprocess.STDOUT))
    out = {}
    for key, (lib, p) in procs.items():
        text = lib.with_suffix(".log").read_text() if p.wait() == 0 else None
        if text is None:
            raise RuntimeError(f"nvcc failed on variant {key}: "
                               + lib.with_suffix(".log").read_text())
        inst = {name: dict(registers=regs, spill_store_bytes=st,
                           spill_load_bytes=ld,
                           hgmma=None if sass is None else sass[0],
                           utmaldg=None if sass is None else sass[1])
                for name, regs, st, ld, sass in cs.ptxas_report(
                    text, cs.sass_counts(lib))
                if "_hopper_kernel<96>" in name}
        out[key] = (ctypes.CDLL(str(lib)), dict(
            instances=inst, serialized="serialized" in text,
            ptxas=[ln.strip() for ln in text.splitlines()
                   if "registers" in ln or "spill" in ln]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/hd96_width.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hd96_width: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kernel_breakdown import swapped
    from repro_torch.kernels import build
    from repro_torch.kernels import tree_attention as ta
    from repro_torch.kernels import tree_attention_bwd as tab

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    res = {"card": cs.CARD, "torch": torch.__version__, "variants": {},
           "fwd_cases": {}, "cases": {},
           "fwd_device_ms": {v: [] for v in FWD_ORDER},
           "device_ms": {v: {"dq": [], "dkv": []} for v in BWD_ORDER}}
    t0 = time.perf_counter()
    cs.phase_build()
    variants = build_variants(build, cs, build.BUILD_DIR / "hd96_width")
    res["build_s"] = time.perf_counter() - t0
    for (var, src), (_, rep) in variants.items():
        res["variants"][f"{var} {src}"] = rep
        cs.log(f"hd96 build: {var} {src}: {rep['instances']}; wgmma "
               f"serialized: {rep['serialized']}")

    entries = {FWD: ("tree_attention_fwd", "tree_attention_error_string"),
               DQ: ("tree_attention_bwd_dq", "tree_attention_bwd_dq_error_string"),
               DKV: ("tree_attention_bwd_dkv",
                     "tree_attention_bwd_dkv_error_string")}
    mods = {FWD: ta, DQ: tab, DKV: tab}
    base = {FWD: ta._library(), DQ: tab._library(DQ, entries[DQ][0], 1),
            DKV: tab._library(DKV, entries[DKV][0], 2)}
    old_table = {k: tuple(h for h in v if h != 96)
                 for k, v in ta.HOPPER_PATH_HEAD_DIMS.items()}

    @contextlib.contextmanager
    def impl(var):
        with contextlib.ExitStack() as st:
            for src in (FWD, DQ, DKV):
                if (var, src) in variants:
                    st.enter_context(swapped(build, mods[src], src,
                                             variants[(var, src)][0],
                                             base[src], entries[src]))
            if var == "simple":
                saved = dict(ta.HOPPER_PATH_HEAD_DIMS)
                ta.HOPPER_PATH_HEAD_DIMS.update(old_table)
                st.callback(ta.HOPPER_PATH_HEAD_DIMS.update, saved)
            yield

    vcfg = cs.vlm_train_cut()[0]
    plan = cs.train_plans(vcfg, "agentic", "sep_avg", 1, gen=cs.MM_TRAIN_GEN,
                          trees=cs.MM_TRAIN_TREES)[0]
    kl_v = cs.prefix_kv_last(np.asarray(plan.packed.inputs["kv_last"]),
                             vcfg.frontend_len)
    cases = [c for c in cs.mm_kernel_cases(kl_v, kl_v[:, :64])
             if c[1] == torch.bfloat16 and c[2].shape[-1] == 96]
    fwd_vars, bwd_vars = dict.fromkeys(FWD_ORDER), dict.fromkeys(BWD_ORDER)
    rng = np.random.default_rng(4)
    with torch.inference_mode():
        for name, dt, q, k, v, kl, q_off, window, pq, pk in cases:
            kw = dict(q_off=q_off, window=window, pos_q=pq, pos_k=pk)
            sc = 96 ** -0.5
            ro, rl = cs.plain(q, k, v, kl, sc, f32=True, return_lse=True,
                              **kw)
            bo, bl = cs.plain(q, k, v, kl, sc, return_lse=True, **kw)
            blind = rl <= -1e29                     # [B,H,S]: sees no key
            row, kept = res["fwd_cases"].setdefault(name, {}), None
            for var in fwd_vars:
                with impl(var):
                    got = ta.tree_attention(q, k, v, kl, sc,
                                            save_residuals=True, **kw)
                    again = ta.tree_attention(q, k, v, kl, sc,
                                              save_residuals=True, **kw)
                torch.cuda.synchronize()
                kept = kept or got
                try:
                    err = cs.hold(f"[{var}] {name}", got[0], ro, got[1], rl,
                                  bo, bl)
                    ok = True
                except cs.Failed:
                    err, ok = None, False
                row[var] = dict(
                    within_limits=ok, o_max_abs_err=err,
                    two_launches_identical=all(
                        torch.equal(a, b) for a, b in zip(got, again)),
                    identical_to_kept=all(
                        torch.equal(a, b) for a, b in zip(got, kept)),
                    blind_rows=int(blind.sum()),
                    blind_rows_zero=bool((got[1][blind] == -1e30).all())
                    and not bool(got[0][blind.transpose(1, 2)].any()))
                cs.log(f"hd96 fwd [{var}] {name}: {row[var]}")
            o, lse = kept
            del ro, rl, bo, bl, got, again, kept
            do = torch.tensor(rng.normal(size=q.shape), dtype=dt, device="cuda")
            want = cs.plain_bwd(q.float(), k.float(), v.float(), kl,
                                o.float(), lse, do.float(), sc, **kw)
            row, kept = res["cases"].setdefault(name, {}), None
            for var in bwd_vars:
                with impl(var):
                    got = tab.tree_attention_bwd(q, k, v, kl, o, lse, do, sc,
                                                 **kw)
                    again = tab.tree_attention_bwd(q, k, v, kl, o, lse, do,
                                                   sc, **kw)
                torch.cuda.synchronize()
                kept = kept or got
                try:
                    errs = cs.hold_bwd(f"[{var}] {name}", got, want)
                    ok = True
                except cs.Failed:
                    errs, ok = {}, False
                row[var] = dict(
                    within_limits=ok, max_abs_err=errs,
                    two_launches_identical=all(
                        torch.equal(a, b) for a, b in zip(got, again)),
                    identical_to_kept=all(
                        torch.equal(a, b) for a, b in zip(got, kept)),
                    invisible_keys_zero=not any(
                        bool(g[kl < 0].any()) for g in got[1:]))
                cs.log(f"hd96 [{var}] {name}: {row[var]}")
            del want, got, again, kept
        _, _, q, k, v, kl, *_ = cases[0]
        B, S, H, hd = q.shape
        do = torch.tensor(rng.normal(size=q.shape), dtype=q.dtype,
                          device="cuda")
        sc = 96 ** -0.5
        mask = cs.dense_mask(kl, S, 0)
        pairs = int(mask.sum())
        flops = 4 * hd * H * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) \
            + kl.numel() * 4 + B * H * S * 4
        bnd, by = cs.bound(flops, nbytes)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask,
                                                      scale=sc)
        res["fwd_bound"] = dict(bound_ms=bnd, bound_by=by, pairs=pairs,
                                flops=flops, bytes=nbytes)
        res["sdpa_fwd_device_ms"] = [cs.graph_ms(sdpa)]
        for var in FWD_ORDER:
            with impl(var):
                ms = cs.graph_ms(lambda: ta.tree_attention(
                    q, k, v, kl, sc, save_residuals=True))
            res["fwd_device_ms"][var].append(ms)
            cs.log(f"hd96 timing at V (B={B}, S={S}, H 32/Kh 32, bf16, "
                   f"CUDA-graph replay) [{var}]: fwd {cs.fmt_ms(ms)}, "
                   f"{100 * bnd / ms:.1f}% of its bound {bnd:.4f} ms by {by}")
        res["sdpa_fwd_device_ms"].append(cs.graph_ms(sdpa))
        cs.log(f"hd96 timing at V: sdpa forward (dense bool mask) "
               f"{res['sdpa_fwd_device_ms']} device ms")
        del qt, kt, vt, mask
        o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True)
        for var in BWD_ORDER:
            with impl(var):
                _, dl = tab.bwd_dq(q, k, v, kl, o, lse, do, sc)
                ms = res["device_ms"][var]
                ms["dq"].append(cs.graph_ms(
                    lambda: tab.bwd_dq(q, k, v, kl, o, lse, do, sc)))
                ms["dkv"].append(cs.graph_ms(
                    lambda: tab.bwd_dkv(q, k, v, kl, lse, dl, do, sc)))
            cs.log(f"hd96 timing at V (B={B}, S={S}, H 32/Kh 32, bf16, "
                   f"CUDA-graph replay) [{var}]: dq {ms['dq'][-1]:.4f} ms, "
                   f"dk/dv {ms['dkv'][-1]:.4f} ms")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps({"fwd_device_ms": res["fwd_device_ms"],
                      "sdpa_fwd_device_ms": res["sdpa_fwd_device_ms"],
                      "device_ms": res["device_ms"]}))
    print(cs.CARD)
    bad = [(n, v) for n, r in res["cases"].items() for v, x in r.items()
           if not (x["within_limits"] and x["two_launches_identical"]
                   and x["invisible_keys_zero"])]
    bad += [(n, v) for n, r in res["fwd_cases"].items()
            for v, x in r.items()
            if not (x["within_limits"] and x["two_launches_identical"]
                    and x["blind_rows_zero"]
                    and (v == "simple" or x["identical_to_kept"]))]
    print(json.dumps({"ok": not bad, "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
