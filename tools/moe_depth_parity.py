#!/usr/bin/env python3
"""Qwen3-30B-A3B's serving parity at a cut depth, taken apart, on one
NVIDIA GPU.

    python3 tools/moe_depth_parity.py [--layers 24 48] [--out FILE]

``chip_smoke.moe_serve_checks`` holds the bf16 session's prefill logits,
kernel against plain attention, each replay routing for itself, at
relative L2 ≤ 5e-2.  This tool asks where such a figure comes from.  It
builds the kernels, holds the three of them against their plain versions
at the MoE layout (H 32/Kh 4, hd 128: the serving prefill, the tool
prefill and the train rows; ``phase_kernel``, ``phase_bwd_kernel``), and
then at each depth:

  1. runs the multi-turn session through the kernels (``multiturn``) and
     ``moe_serve_checks`` on it, reporting a failed check instead of
     stopping: the pinned figure (the attention alone, at equal routing),
     the own-routing figure and the routing flips by MoE layer;
  2. replays the same session teacher-forced through a second plain
     attention that differs from the first only in rounding: P·V summed
     in f32 and rounded to bf16 once, as the kernels do, where the first
     sums a bf16 P against bf16 V (a control with no kernel in it).  Its
     own-routing distance from the first plain replay, its flips, and the
     kernel replay's distance from it say how far rounding alone moves a
     model that routes for itself at this depth.

Writes every figure to ``--out`` (JSON) and prints them.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def attend_f32_pv(q, k, v, bias, scale):
    """``models.attention._attend_ref`` with P·V summed in f32 and the
    output rounded to q's dtype once."""
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    qg = q.reshape(B, S, Kh, H // Kh, hd)
    logits = torch.einsum("bikgd,bjkd->bkgij", qg, k).float()
    w = torch.softmax(logits * scale + bias, dim=-1)
    o = torch.einsum("bkgij,bjkd->bikgd", w, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def own_routing(cfg, params, calls, impl, attend=None):
    """A teacher-forced replay routing for itself: (logits, RoutingLog)."""
    real = cs.attn_mod._attend_ref
    if attend is not None:
        cs.attn_mod._attend_ref = attend
    try:
        with torch.inference_mode(), cs.RoutingLog() as rl:
            _, logits, tm = cs.multiturn(cfg, params, impl, record=calls,
                                         tail_steps=0)
    finally:
        cs.attn_mod._attend_ref = real
    return logits, rl, tm


def depth(L: int) -> dict:
    full = cs.get_config(cs.MOE_ARCH)
    tag = f"moe {L} layers"
    cfg, params = cs.load_cut(full, L, tag, "the depth under study")
    with torch.inference_mode():
        calls, logits, _ = cs.multiturn(cfg, params, "kernel",
                                        torch.Generator(cs.DEV).manual_seed(1))
    checks = "passed"
    try:
        cs.moe_serve_checks(cfg, params, calls, logits, tag)
    except cs.Failed as e:
        checks = f"failed: {e}"
    cs.log(f"{tag}: moe_serve_checks {checks}")
    lk, rk, tm = own_routing(cfg, params, calls, "kernel")
    lr, rr, _ = own_routing(cfg, params, calls, "ref")
    lf, rf, _ = own_routing(cfg, params, calls, "ref", attend_f32_pv)
    pre = [i for i, k in enumerate(tm["kinds"]) if k == "prefill"]
    n_moe = sum(n for kind, n in cs.layer_groups(cfg) if kind == "moe")

    def pair(a, ra, b, rb):
        flips = cs.flipped_tokens(ra, rb)
        return dict(prefill_rel_l2=[cs.rel_l2(a[i], b[i]) for i in pre],
                    every_call_max_rel_l2=max(cs.rel_l2(x, y)
                                              for x, y in zip(a, b)),
                    prompt_flips_by_layer=[int(f.sum())
                                           for f in flips[:n_moe]])

    out = dict(layers=L, checks=checks,
               kernel_vs_plain=pair(lk, rk, lr, rr),
               plain_f32pv_vs_plain=pair(lf, rf, lr, rr),
               kernel_vs_plain_f32pv=pair(lk, rk, lf, rf))
    for name in ("kernel_vs_plain", "plain_f32pv_vs_plain",
                 "kernel_vs_plain_f32pv"):
        r = out[name]
        pre_l2 = ", ".join(f"{e:.3e}" for e in r["prefill_rel_l2"])
        cs.log(f"{tag}: {name}, each routing for itself: prefill logits "
               f"relative L2 {pre_l2}"
               f"; every call's max {r['every_call_max_rel_l2']:.3e}; the "
               f"prompt's tokens whose experts differ, by MoE layer: "
               f"{r['prompt_flips_by_layer']}")
    del params, logits, lk, lr, lf
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[24, 48])
    ap.add_argument("--out", default="chiprun_out/moe_depth_parity.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("moe_depth_parity: needs a CUDA device")
    cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    mcfg = cs.get_config(cs.MOE_ARCH).replace(n_layers=cs.MOE_TRAIN_LAYERS)
    kl_m = np.asarray(cs.train_plans(mcfg, "agentic", "sep_avg", 1)[0]
                      .packed.inputs["kv_last"])
    res = dict(card=cs.CARD,
               kernel_fwd_worst=cs.phase_kernel(cs.moe_kernel_cases(kl_m),
                                                False),
               kernel_bwd_worst=cs.phase_bwd_kernel(
                   cs.moe_kernel_cases(kl_m)),
               depths=[depth(L) for L in args.layers])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
