#!/usr/bin/env python3
"""The hd 96 Hopper backward's design choices, measured on one NVIDIA GPU.

    python3 tools/hd96_width.py [--out FILE]   (default build/hd96_width.json)

Builds this checkout's kernels (``chip_smoke.phase_build``: each instance's
registers, spills, HGMMA and UTMALDG) and, from copies of ``csrc/`` with
one edit each, the hd 96 instances of the dq and dk/dv sources in three
variants:

  - ``n128``: dQ, dK and dV as m64n128k16 over the whole padded tile
    (``hopper.cuh::pad_cols`` wide: 64 accumulator registers each,
    columns 96-127 summing TMA's zeros) where the kept kernels run
    m64n96k16 (48 each);
  - ``dkv1``: the dk/dv kernel at one block an SM with a 3-stage ring
    (hd 128's occupancy) where the kept one runs two blocks with 2 stages
    (hd 64's occupancy, 168 registers);
  - ``simple``: the simple kernels the two ran at hd 96 before their
    Hopper path (the wrappers' routing table set back for the variant's
    turn, so ``bwd_dq`` computes Δ with ``delta``).

On Phi-3-vision's rows V (its first train step's kv_last behind the
576-row prefix, B 2, H 32/Kh 32, bf16) and the bf16 hd 96 cases of
``chip_smoke.mm_kernel_cases``, for the kept kernels and each variant: the
simple forward's o and lse, then dq (Δ in its kernel where it has a
Hopper path) and dk/dv fed that Δ, twice; held against the plain backward
at chip_smoke's bf16 limits, the two launches and the kept kernels'
outputs compared bit for bit.  Then the device time of dq and of dk/dv at
V (CUDA-graph replay, as chip_smoke's ``device_ms``), in turns: kept,
n128, dkv1, simple, simple, dkv1, n128, kept.  Prints the card and its
power limit; writes every number to ``--out`` as JSON.
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

# variant → {source: [(text, replacement)]}
_N128 = "hop::pad_cols<HD>()"
EDITS = {
    "n128": {"tree_attention_bwd_dq.cu": [
        ("float dqa[HD / 2];", f"float dqa[{_N128} / 2];"),
        ("i < HD / 2; ++i) dqa[i]", f"i < {_N128} / 2; ++i) dqa[i]"),
        ("hop::wgmma_rs<HD>(dqa,", f"hop::wgmma_rs<{_N128}>(dqa,")],
        "tree_attention_bwd_dkv.cu": [
        ("float dka[HD / 2], dva[HD / 2];",
         f"float dka[{_N128} / 2], dva[{_N128} / 2];"),
        ("for (int i = 0; i < HD / 2; ++i) {\n    dka[i]",
         f"for (int i = 0; i < {_N128} / 2; ++i) {{\n    dka[i]"),
        ("hop::wgmma_rs<HD>(dva,", f"hop::wgmma_rs<{_N128}>(dva,"),
        ("hop::wgmma_rs<HD>(dka,", f"hop::wgmma_rs<{_N128}>(dka,")]},
    "dkv1": {"tree_attention_bwd_dkv.cu": [
        ("__launch_bounds__(dkv_threads<HD>(), HD <= 96 ? 2 : 1)",
         "__launch_bounds__(dkv_threads<HD>(), HD <= 64 ? 2 : 1)"),
        ("static constexpr int STAGES = HD == 96 ? 2 : 3;",
         "static constexpr int STAGES = 3;")]},
    "simple": {src: [("if constexpr (HD == 64 || HD == 96 || HD == 128 || "
                      "HD == 192)",
                      "if constexpr (HD == 64 || HD == 128 || HD == 192)")]
               for src in ("tree_attention_bwd_dq.cu",
                           "tree_attention_bwd_dkv.cu")},
}
ORDER = ("kept", "n128", "dkv1", "simple", "simple", "dkv1", "n128", "kept")


def build_variants(build, out_dir: Path) -> dict:
    """nvcc every (variant, source) at once, the switch cut to its hd 96
    case, each from a copy of the source and the headers in a directory of
    its own.  {(variant, source): (library, ptxas lines)}."""
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
        out[key] = (ctypes.CDLL(str(lib)),
                    [ln.strip() for ln in text.splitlines()
                     if "registers" in ln or "spill" in ln])
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
    res = {"card": cs.CARD, "torch": torch.__version__, "ptxas": {},
           "cases": {}, "device_ms": {v: {"dq": [], "dkv": []}
                                      for v in ("kept", *EDITS)}}
    t0 = time.perf_counter()
    cs.phase_build()
    variants = build_variants(build, build.BUILD_DIR / "hd96_width")
    res["build_s"] = time.perf_counter() - t0
    for (var, src), (_, lines) in variants.items():
        res["ptxas"][f"{var} {src}"] = lines
        cs.log(f"hd96 build: {var} {src}: " + " | ".join(lines))

    entries = {src: (entry, entry + "_error_string") for src, entry in zip(
        tab.SOURCES, ("tree_attention_bwd_dq", "tree_attention_bwd_dkv"))}
    base = {src: tab._library(src, entries[src][0], n)
            for src, n in zip(tab.SOURCES, (1, 2))}
    old_table = dict(ta.HOPPER_PATH_HEAD_DIMS,
                     dq=(64, 128, 192), dkv=(64, 128, 192))

    @contextlib.contextmanager
    def impl(var):
        with contextlib.ExitStack() as st:
            for src in tab.SOURCES:
                if (var, src) in variants:
                    st.enter_context(swapped(build, tab, src,
                                             variants[(var, src)][0],
                                             base[src], entries[src]))
            if var == "simple":
                saved = dict(ta.HOPPER_PATH_HEAD_DIMS)
                ta.HOPPER_PATH_HEAD_DIMS.update(old_table)
                st.callback(ta.HOPPER_PATH_HEAD_DIMS.update, saved)
            yield

    vfull = cs.get_config(cs.VLM_ARCH)
    Fv = vfull.frontend_len
    per_layer = cs.act_bytes(vfull, cs.TRAIN_ROWS * (cs.TRAIN_SEQ + Fv))
    vcfg = vfull.replace(n_layers=cs.fit_depth(vfull, cs.TRAIN_LIMIT, scale=7,
                                               per_layer=per_layer))
    plan = cs.train_plans(vcfg, "agentic", "sep_avg", 1, gen=cs.MM_TRAIN_GEN,
                          trees=cs.MM_TRAIN_TREES)[0]
    kl_v = cs.prefix_kv_last(np.asarray(plan.packed.inputs["kv_last"]), Fv)
    cases = [c for c in cs.mm_kernel_cases(kl_v, kl_v[:, :64])
             if c[1] == torch.bfloat16 and c[2].shape[-1] == 96]
    rng = np.random.default_rng(4)
    with torch.inference_mode():
        for name, dt, q, k, v, kl, q_off, window, pq, pk in cases:
            kw = dict(q_off=q_off, window=window, pos_q=pq, pos_k=pk)
            sc = 96 ** -0.5
            do = torch.tensor(rng.normal(size=q.shape), dtype=dt, device="cuda")
            o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True,
                                       **kw)
            want = cs.plain_bwd(q.float(), k.float(), v.float(), kl,
                                o.float(), lse, do.float(), sc, **kw)
            row, kept = res["cases"].setdefault(name, {}), None
            for var in ("kept", *EDITS):
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
        do = torch.tensor(rng.normal(size=q.shape), dtype=q.dtype,
                          device="cuda")
        sc = 96 ** -0.5
        o, lse = ta.tree_attention(q, k, v, kl, sc, save_residuals=True)
        for var in ORDER:
            with impl(var):
                _, dl = tab.bwd_dq(q, k, v, kl, o, lse, do, sc)
                ms = res["device_ms"][var]
                ms["dq"].append(cs.graph_ms(
                    lambda: tab.bwd_dq(q, k, v, kl, o, lse, do, sc)))
                ms["dkv"].append(cs.graph_ms(
                    lambda: tab.bwd_dkv(q, k, v, kl, lse, dl, do, sc)))
            cs.log(f"hd96 timing at V (B={q.shape[0]}, S={q.shape[1]}, H 32/"
                   f"Kh 32, bf16, CUDA-graph replay) [{var}]: dq "
                   f"{ms['dq'][-1]:.4f} ms, dk/dv {ms['dkv'][-1]:.4f} ms")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res["device_ms"]))
    print(cs.CARD)
    bad = [(n, v) for n, r in res["cases"].items() for v, x in r.items()
           if not (x["within_limits"] and x["two_launches_identical"]
                   and x["invisible_keys_zero"])]
    print(json.dumps({"ok": not bad, "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
