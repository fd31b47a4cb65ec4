#!/usr/bin/env python3
"""Where the tree-attention kernels' time goes, on one NVIDIA GPU.

    python3 tools/kernel_breakdown.py [--root DIR] [--out FILE]

Times the forward, dq and dk/dv kernels of the checkout at ``--root``
(default: this repository; give an unpacked older commit to measure its
kernels with its own wrappers) at the shapes ``chip_smoke.py`` times:
A (prefill S 1024), B (tool-output prefill S 200, q_off 1056, B 8) and T
(the first train step's two packed rows of 4096 and their real kv_last),
all bf16, H 12, Kh 2, hd 128; dq and dk/dv at T only.  Beside each full
kernel it times variants compiled from a copy of the same source and its
headers with one cut made at a marked point, so that differences say where
the time goes:

  - ``scan``:  the key-tile (forward, dq) or query-tile (dk/dv) loop runs
    and tests every tile for liveness, but a live tile is neither loaded
    nor computed;
  - ``loads``: live tiles are loaded, not computed (in the warp-specialised
    kernels the consumers release each tile unread; dq's Δ, computed before
    its key loop, stays in).

A cut is made only where its anchor text is found in the source or one of
its headers; a source without the anchor has no such variant.  The
variants build for hd 128 only, in parallel, with the package's own nvcc
flags, each in a directory of its own.  dq is called in the form the
checkout's ``bwd_dq`` takes: where it takes ``o`` it computes Δ itself
(``dq`` then includes Δ); where it takes Δ, Δ is a separate torch
reduction, timed as ``delta``; ``dq_with_delta`` is what a backward pays
for both either way.
Also times ``F.scaled_dot_product_attention`` with the dense boolean mask
(the forward at A, B, T; the backward at T), dk/dv at T with each split of
the GQA group (where the wrapper takes ``parts``), and prints the
toolchain's versions and each full kernel's ptxas register line.  CUDA
events, median of 20 after 3 warm-up calls, as ``chip_smoke.py``, and
beside each (``*_device``) the device time of one call in a CUDA-graph
replay, which leaves out the host's launch overhead.  ``fwd_sha256`` holds
a digest of the forward's o and lse bytes at each shape (the inputs come
from a fixed seed), so two checkouts' runs show whether their forwards
agree bit for bit; the forward's other Hopper head dims get the same
digest and times (full kernel only) at A, B and T, hd 64 at H 16/Kh 16
(SeamlessM4T's decoder heads) and hd 192 at H 96/Kh 8 (Nemotron-4's),
keyed ``A_hd64`` and so on.  Writes every number to ``--out`` as JSON and
prints it.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import inspect
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

BIG = 1 << 30
H, KH, HD = 12, 2, 128

# (source, variant) → alternatives, each [(anchor, text inserted after it)];
# the first alternative whose anchors are all in the source or its headers
# is used.  The first ones cut the warp-specialised kernels (the producer
# hands no tile / the consumers release each tile unread), the last the
# simple ones.  Where hopper.cuh has produce_key_tiles, the forward's and
# dq's producer lives there (indented one level less than a forward that
# keeps its own producer).
_RELEASE = ("\n    hop::mbar_arrive(&empty[stage]);\n    if (++stage == L::STAGES) {"
            "\n      stage = 0;\n      phase ^= 1;\n    }\n    continue;")
_SCAN_SHARED = [("live |= uint32_t(ok) << i;\n    }", "\n    live = 0;")]
_SIMPLE_SCAN = [("if (!(seen && in_window)) continue;     // dead tile: no "
                 "loads, no math", "\n    continue;")]
_KEY_LOOP_LOADS = [("const int k0 = k0_s[stage];\n    if (k0 < 0) break;",
                    _RELEASE)]
CUTS = {
    ("tree_attention_fwd.cu", "scan"): [
        _SCAN_SHARED,
        [("live |= uint32_t(ok) << i;\n      }", "\n      live = 0;")],
        _SIMPLE_SCAN],
    ("tree_attention_fwd.cu", "loads"): [
        _KEY_LOOP_LOADS,
        [("Vs[r * L::LDV + c] = from_f32<E>(ok ? to_f32(v[g]) : 0.f);\n    }\n"
          "    __syncthreads();", "\n    continue;")]],
    ("tree_attention_bwd_dq.cu", "scan"): [_SCAN_SHARED, _SIMPLE_SCAN],
    ("tree_attention_bwd_dq.cu", "loads"): [
        _KEY_LOOP_LOADS,
        [("load_tile<BK, HD, LD>(Vs, v + krow * HD, size_t(Kh) * HD, "
          "ncols);\n    __syncthreads();", "\n    continue;")]],
    ("tree_attention_bwd_dkv.cu", "scan"): [
        [("if (k0 > q_off + q0 + nrows - 1) continue;", "\n        continue;")],
        [("if (!__syncthreads_or(tid < nrows && pq - kp_max < window)) "
          "continue;\n      }", "\n      continue;")]],
    ("tree_attention_bwd_dkv.cu", "loads"): [
        [("const int q0 = q0_s[stage];\n    if (q0 < 0) break;", _RELEASE)],
        [("dl_s[r] = r < nrows ? delta[gi] : 0.f;\n      }\n"
          "      __syncthreads();", "\n      continue;")]],
}


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


def graph_ms(fn, reps=20):
    """Device time of one call: CUDA events around a CUDA-graph replay of
    ``reps`` calls (median of 5, over ``reps``), without the host's launch
    overhead.  None where the call cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    ts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def build_variants(build, csrc: Path, out_dir: Path) -> dict:
    """nvcc every cut variant (hd 128 only) at once, each from a copy of
    the source and the headers in a directory of its own; a variant whose
    texts are unchanged since its last build is not rebuilt.
    {(src, var): lib}."""
    procs = {}
    for (src, var), alternatives in CUTS.items():
        files = {src: (csrc / src).read_text()}
        files.update({h.name: h.read_text() for h in csrc.glob("*.cuh")})
        cuts = next((c for c in alternatives if all(
            any(a in x for x in files.values()) for a, _ in c)), None)
        if cuts is None:
            continue
        for anchor, ins in cuts:
            name = next(n for n, x in files.items() if anchor in x)
            files[name] = files[name].replace(anchor, anchor + ins, 1)
        # keep the hd-128 instance of the entry point's switch only
        files[src] = re.sub(r"\n\s*TREE_ATTN_HD\((?!128\))\d+\)", "",
                            files[src])
        vdir = out_dir / f"{Path(src).stem}-{var}"
        vdir.mkdir(parents=True, exist_ok=True)
        lib = vdir / "variant.so"
        stale = not lib.exists()
        for name, text in files.items():
            if not (vdir / name).exists() or (vdir / name).read_text() != text:
                (vdir / name).write_text(text)
                stale = True
        if not stale:
            procs[(src, var)] = (lib, None)
            continue
        lib.unlink(missing_ok=True)
        log = lib.with_suffix(".log").open("w")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
               str(vdir / src)]
        procs[(src, var)] = (lib, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT))
    libs = {}
    for key, (lib, p) in procs.items():
        if p is not None and p.wait() != 0:
            raise RuntimeError(f"nvcc failed on variant {key}: "
                               + lib.with_suffix(".log").read_text())
        libs[key] = ctypes.CDLL(str(lib))
    return libs


@contextlib.contextmanager
def swapped(build, mod, src: str, variant, base, names):
    """Inside the block, ``mod``'s wrappers launch ``variant`` (a cut build
    of ``src``) where they launch ``base``, its configured library: the
    variant takes ``base``'s argtypes and restype for each entry point in
    ``names`` and replaces ``base`` in the cache the loader reads, which
    is ``build.load``'s where the checkout has one (``_LOADED``), else the
    wrapper module's own (``_libs`` by source, or ``_lib``)."""
    for name in names:
        getattr(variant, name).argtypes = getattr(base, name).argtypes
        getattr(variant, name).restype = getattr(base, name).restype
    if hasattr(build, "_LOADED"):
        cache, key = build._LOADED, src
    elif hasattr(mod, "_libs"):
        cache, key = mod._libs, src
    else:
        cache, key = vars(mod), "_lib"
    cache[key] = variant
    try:
        yield
    finally:
        cache[key] = base


def timed(ms: dict, key: str, fn) -> None:
    """ms[key]: CUDA events around one call (host overhead included when
    the device work is shorter); ms[key + "_device"]: ``graph_ms``."""
    ms[key] = time_ms(fn)
    ms[key + "_device"] = graph_ms(fn)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="chiprun_out/kernel_breakdown.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.loader import LoaderConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import tree_attention as ta
    from repro_torch.kernels import tree_attention_bwd as tab
    from repro_torch.train.planner import plans

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    res = {"root": str(root), "card": card, "python": sys.version,
           "torch": torch.__version__, "torch_cuda": torch.version.cuda,
           "nvcc": nvcc.strip().splitlines()[-1], "ms": {}, "registers": {}}
    print(json.dumps({k: res[k] for k in ("card", "python", "torch",
                                         "torch_cuda", "nvcc")}), flush=True)

    t0 = time.perf_counter()
    sources = [ta.SOURCE, *tab.SOURCES]
    built = build.build_all(sources)
    libs = build_variants(build, build.CSRC, build.BUILD_DIR / "breakdown")
    res["build_s"] = time.perf_counter() - t0
    for src, (lib, _) in built.items():
        res["registers"][src] = [ln.strip() for ln in lib.with_suffix(
            ".log").read_text().splitlines() if "registers" in ln]

    rng = np.random.default_rng(9)
    dev = "cuda"
    mk = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.bfloat16,
                                 device=dev)
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                    device=dev)
    cfg = get_config("qwen2_1p5b")
    lc = LoaderConfig(seq_len=4096, batch_rows=2, trees_per_batch=4,
                      kind="agentic", loss_mode="sep_avg", seed=0,
                      gen_kwargs=dict(num_turns=3, turn_len_range=(64, 256)))
    plan = next(p for p in (ps.execution_plan() for ps in plans(cfg, lc, 8))
                if not p.is_empty)
    kl_t = i32(plan.packed.inputs["kv_last"]).contiguous()
    shapes = {
        "A": (1, 1024, 0, i32(np.full((1, 1024), 1023))),
        "B": (8, 200, 1056, i32(np.concatenate(
            [np.full((8, 1056), BIG), np.full((8, 200), 1255)], 1))),
        "T": (kl_t.shape[0], kl_t.shape[1], 0, kl_t)}
    fwd_lib = ta._library()
    bwd_entries = {tab.SOURCES[0]: ("tree_attention_bwd_dq", 1),
                   tab.SOURCES[1]: ("tree_attention_bwd_dkv", 2)}
    bwd_libs = {src: tab._library(src, entry, n)
                for src, (entry, n) in bwd_entries.items()}

    def bwd_variants(ms, key, src, fn):
        """Time ``fn`` with the bwd source's cut variants swapped in."""
        entry = bwd_entries[src][0]
        for var in ("scan", "loads"):
            if (src, var) in libs:
                with swapped(build, tab, src, libs[(src, var)],
                             bwd_libs[src], (entry, entry + "_error_string")):
                    timed(ms, f"{key}_{var}", fn)

    sc = HD ** -0.5
    with torch.no_grad():
        for tag, (B, S, q_off, kl) in shapes.items():
            Skv = kl.shape[1]
            q, k, v = mk(B, S, H, HD), mk(B, Skv, KH, HD), mk(B, Skv, KH, HD)
            ms = res["ms"].setdefault(tag, {})
            fwd = lambda: ta.tree_attention(q, k, v, kl, sc, q_off=q_off,
                                            save_residuals=True)
            timed(ms, "fwd", fwd)
            o, lse = fwd()
            res.setdefault("fwd_sha256", {})[tag] = hashlib.sha256(
                o.view(torch.int16).cpu().numpy().tobytes()
                + lse.cpu().numpy().tobytes()).hexdigest()
            for var in ("scan", "loads"):
                if (ta.SOURCE, var) in libs:
                    with swapped(build, ta, ta.SOURCE, libs[(ta.SOURCE, var)],
                                 fwd_lib, ("tree_attention_fwd",
                                           "tree_attention_error_string")):
                        timed(ms, f"fwd_{var}", fwd)
            i = q_off + torch.arange(S, device=dev)
            mask = ((torch.arange(Skv, device=dev)[None, :] <= i[:, None])
                    & (kl[:, None, :] >= i[None, :, None]))[:, None]
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (t.transpose(1, 2).repeat_interleave(H // KH, dim=1)
                      .contiguous() for t in (k, v))
            timed(ms, "sdpa_fwd", lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=sc))
            ms["pairs"] = int(mask.sum())
            if tag != "T":
                continue
            do = mk(B, S, H, HD)
            dl = tab.delta(o, do)
            if "o" in inspect.signature(tab.bwd_dq).parameters:
                # dq computes Δ itself and returns it
                dq = lambda: tab.bwd_dq(q, k, v, kl, o, lse, do, sc)
                timed(ms, "dq", dq)
                ms["dq_with_delta"] = ms["dq"]
                ms["dq_with_delta_device"] = ms["dq_device"]
            else:
                dq = lambda: tab.bwd_dq(q, k, v, kl, lse, dl, do, sc)
                timed(ms, "dq", dq)
                timed(ms, "delta", lambda: tab.delta(o, do))
                timed(ms, "dq_with_delta", lambda: (tab.delta(o, do), dq()))
            bwd_variants(ms, "dq", tab.SOURCES[0], dq)
            dkv = lambda: tab.bwd_dkv(q, k, v, kl, lse, dl, do, sc)
            timed(ms, "dkv", dkv)
            if "parts" in inspect.signature(tab.bwd_dkv).parameters:
                for parts in (1, 2, 3, 6):      # the GQA group's split
                    timed(ms, f"dkv_parts{parts}", lambda: tab.bwd_dkv(
                        q, k, v, kl, lse, dl, do, sc, parts=parts))
            bwd_variants(ms, "dkv", tab.SOURCES[1], dkv)
        # the forward at hd 64 and 192, full kernel only
        for hd, h, kh in ((64, 16, 16), (192, 96, 8)):
            for tag, (B, S, q_off, kl) in shapes.items():
                key, Skv = f"{tag}_hd{hd}", kl.shape[1]
                q, k, v = mk(B, S, h, hd), mk(B, Skv, kh, hd), mk(B, Skv, kh, hd)
                fwd = lambda: ta.tree_attention(q, k, v, kl, hd ** -0.5,
                                                q_off=q_off,
                                                save_residuals=True)
                timed(res["ms"].setdefault(key, {}), "fwd", fwd)
                o, lse = fwd()
                res["fwd_sha256"][key] = hashlib.sha256(
                    o.view(torch.int16).cpu().numpy().tobytes()
                    + lse.cpu().numpy().tobytes()).hexdigest()
                del q, k, v, o, lse
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        ot = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                            scale=sc)
        dot = do.transpose(1, 2).contiguous()
        res["ms"]["T"]["sdpa_bwd"] = time_ms(lambda: torch.autograd.grad(
            ot, (qg, kg, vg), dot, retain_graph=True))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res["ms"]))
    for src, lines in res["registers"].items():
        print(src, *lines[:20], sep="\n  ")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
