"""Tree flash-attention backward on Hopper: the ctypes wrappers of the CUDA
kernels ``csrc/tree_attention_bwd_dq.cu`` and ``csrc/tree_attention_bwd_dkv.cu``.

Replace the Pallas TPU kernels ``repro/kernels/tree_attention_bwd.py::
_bwd_dq`` (``pallas_call`` :162) and ``::_bwd_dkv`` (``pallas_call`` :278),
and ``tree_attention_bwd`` (:306) is their entry point here too.  Flash-style
recomputation: the forward saved only ``lse`` [B,H,S]; with
Δ = rowsum(dO∘O) [B,H,S] f32 the kernels regenerate p = exp(s − lse) tile by
tile under the forward's mask and block-skip rule:

  - ``bwd_dq``: one CUDA block per (64-query tile, head, batch) loops over
    the key tiles and writes dq once.  bf16 at hd 64 and 128 runs a
    warp-specialised wgmma kernel whose producer warp is the forward's
    (``csrc/hopper.cuh::produce_key_tiles``: Q and dO resident, live K/V
    tiles through a TMA ring), S and dP taken 32 keys at a time, dQ in
    registers; it also computes Δ of its own rows from o and do and writes
    it for the dk/dv launch that follows on the same stream, so the
    reference's Δ pre-pass (:331) runs in no torch op there.  fp32 and the
    other head dims keep the simple kernel (WMMA or FMA through shared
    memory), with Δ from ``delta`` (a torch reduction, its plain version);
  - ``bwd_dkv``: dk and dv over the full Skv (ancestor rows [0, q_off)
    included), the GQA reduction with no atomics.  bf16 at hd 64 and 128
    runs a warp-specialised wgmma kernel in FlashAttention-3's orientation
    (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dK and dV in registers across the loop): one
    block per (64-key tile, kv head, batch row, part of the GQA group), the
    key tiles heaviest first (a one-block schedule pass in the same launch;
    ``dkv_schedule`` is its plain version), each group split into
    ``head_parts`` parts whose fp32 partials a last pass sums in a fixed
    order; fp32 and the other head dims keep the simple kernel, one block
    per (key tile, kv head, batch) with shared-memory accumulators.

Bound on the H100: per visible pair and query head the dq kernel does about
6·hd FLOPs and the dk/dv kernel 8·hd (the forward 4·hd), so at hd 128 all
three are bound by the tensor cores (989 TFLOP/s bf16), not by memory.
PERF.md keeps their measured times.

On the card each wrapper launches its kernel or raises: it never falls back.
``ops.TreeAttention`` routes a CPU tensor to the plain version
(``kernels/ref.py::tree_attention_bwd_ref``) instead.  ``bwd_dq.launches``
and ``bwd_dkv.launches`` count launches (one per call, the dk/dv partial
sum included).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.tree_attention import (_DTYPES, BLOCK_K, HEAD_DIMS,
                                                HOPPER_HEAD_DIMS, _aligned)

SOURCES = ("tree_attention_bwd_dq.cu", "tree_attention_bwd_dkv.cu")
BLOCK = BLOCK_K          # the dk/dv kernel's key and query tiles
_libs: dict[str, ctypes.CDLL] = {}


def _library(source: str, entry: str, n_out: int) -> ctypes.CDLL:
    if source not in _libs:
        lib = build.load(source)
        fn = getattr(lib, entry)
        dkv = int(entry == "tree_attention_bwd_dkv")   # + sched, partial, parts
        extra = 1 + dkv                                # dq: + o
        fn.argtypes = ([ctypes.c_void_p] * (9 + n_out + extra)
                       + [ctypes.c_int] * (7 + dkv)
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        if dkv:
            lib.tree_attention_bwd_dkv_schedule.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            lib.tree_attention_bwd_dkv_schedule.restype = ctypes.c_int
        err = getattr(lib, entry + "_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[source] = lib
    return _libs[source]


def dkv_schedule(kv_last: torch.Tensor, S: int, q_off: int = 0):
    """The dk/dv kernel's key-tile order, heaviest first: the plain version
    of the schedule pass that the bf16 hd 64/128 path runs on the card
    before its main kernel (``csrc/tree_attention_bwd_dkv.cu::
    dkv_schedule_kernel``; ``dkv_order`` launches it alone).

    kv_last: [B, Skv] int32.  A key tile's work is the number of query
    tiles that ``block_live`` keeps for it without a window: the run from
    the first tile that reaches the key tile's first key to the tile that
    holds its max kv_last (the max over its real keys; a ragged last tile
    counts those only).  Returns (kmax [B, nk], work [B, nk], order [B·nk]
    int32: the flat b·nk + kt sorted by work, descending, ties in index
    order).  Torch ops on kv_last's device, no host sync."""
    B, Skv = kv_last.shape
    nk, nq = -(-Skv // BLOCK), -(-S // BLOCK)
    kmax = F.pad(kv_last, (0, nk * BLOCK - Skv), value=-1).view(
        B, nk, BLOCK).amax(-1).long()
    k0 = torch.arange(nk, device=kv_last.device) * BLOCK
    qi0 = (k0 - q_off).clamp(min=0) // BLOCK
    qi1 = torch.where(kmax >= q_off,
                      ((kmax - q_off) // BLOCK).clamp(max=nq - 1), -1)
    work = (qi1 - qi0 + 1).clamp(min=0)
    order = torch.argsort(work.reshape(-1), descending=True, stable=True)
    return kmax, work, order.to(torch.int32)


def dkv_order(kv_last: torch.Tensor, S: int, q_off: int = 0) -> torch.Tensor:
    """The schedule pass of the dk/dv kernel alone, on the card: int32
    [B·nk], equal to ``dkv_schedule``'s order."""
    B, Skv = kv_last.shape
    sched = torch.empty(B * -(-Skv // BLOCK), dtype=torch.int32,
                        device=kv_last.device)
    lib = _library(SOURCES[1], "tree_attention_bwd_dkv", 2)
    err = lib.tree_attention_bwd_dkv_schedule(
        kv_last.data_ptr(), sched.data_ptr(), B, S, Skv, int(q_off),
        torch.cuda.current_stream(kv_last.device).cuda_stream)
    if err != 0:
        raise RuntimeError("tree_attention_bwd_dkv_schedule failed: "
                           + lib.tree_attention_bwd_dkv_error_string(err)
                           .decode())
    return sched


def head_parts(G: int, units: int, n_sm: int) -> int:
    """Into how many parts the dk/dv kernel splits each GQA group of G query
    heads: the fewest (a divisor of G) that give ``units`` (= B·Kh·nk
    blocks) times it at least 4 blocks per SM, else G.  The parts' fp32
    partials are summed in a fixed order, so any choice is deterministic."""
    for d in range(1, G + 1):
        if G % d == 0 and units * d >= 4 * n_sm:
            return d
    return G


def delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = Σ_d do·o in f32, [B,S,H,hd] → [B,H,S] (the reference's :331):
    the plain version of the Δ the dq kernel's Hopper path computes, and
    the Δ its other instances read."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def fuses_delta(q: torch.Tensor) -> bool:
    """Whether the dq kernel computes Δ itself for inputs like ``q`` (bf16
    at hd 64 and 128, its Hopper path)."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in HOPPER_HEAD_DIMS


def _check(q, k, v, kv_last, o, lse, do, q_off, window, pos_q, pos_k):
    tensors = [q, k, v, kv_last, o, lse, do] + (
        [pos_q, pos_k] if window is not None else [])
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("tree_attention backward kernels: every input must "
                         "lie on the same CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError(f"tree_attention backward takes float32 or bfloat16 "
                        f"q/k/v/o/do of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}/{o.dtype}/{do.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B,S,H,hd] and k/v [B,Skv,Kh,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Kh == 0 or H % Kh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (need H % Kh == 0)")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be shaped like q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S):
        raise ValueError(f"lse must be float32 {(B, H, S)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"tree_attention backward has no instance for head "
                         f"dim {hd}; built for {HEAD_DIMS}")
    if S == 0 or q_off < 0 or Skv < q_off + S:
        raise ValueError(f"need S > 0 and Skv ≥ q_off + S, got S={S}, "
                         f"q_off={q_off}, Skv={Skv}")
    meta = [(kv_last, (B, Skv), "kv_last")]
    if window is not None:
        meta += [(pos_q, (B, S), "pos_q"), (pos_k, (B, Skv), "pos_k")]
    for t, shape, name in meta:
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tree_attention backward kernels take contiguous "
                         "tensors")


def _launch(source, entry, outs, q, k, v, kv_last, lse, dl, do, scale, q_off,
            window, pos_q, pos_k, extra=(), parts=None):
    B, S, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    lib = _library(source, entry, len(outs))
    windowed = window is not None
    ptr = lambda t: None if t is None else t.data_ptr()
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    ints = (B, S, Skv, H, Kh, hd, _DTYPES[q.dtype]) + (
        () if parts is None else (parts,))
    err = getattr(lib, entry)(
        ptr(q), ptr(k), ptr(v), ptr(kv_last),
        ptr(pos_q) if windowed else None, ptr(pos_k) if windowed else None,
        ptr(lse), ptr(dl), ptr(do), *(ptr(t) for t in outs),
        *(ptr(t) for t in extra), *ints, float(scale), int(q_off),
        int(window) if windowed else 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           + getattr(lib, entry + "_error_string")(err)
                           .decode())


def bwd_dq(q, k, v, kv_last, o, lse, do, scale: float, *, q_off: int = 0,
           window: Optional[int] = None, pos_q=None, pos_k=None):
    """Launch the dq kernel (inputs already checked).  Returns (dq, Δ).
    Where ``fuses_delta`` holds the kernel computes Δ [B,H,S] f32 from o
    and do and writes it; elsewhere Δ is ``delta(o, do)``, computed here
    before the launch.  Either way the dk/dv launch takes this Δ."""
    dq = torch.empty_like(q)
    if fuses_delta(q):
        B, S, H, _ = q.shape
        dl = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        o = _aligned(o)
    else:
        dl = delta(o, do)
    _launch(SOURCES[0], "tree_attention_bwd_dq", (dq,), q, k, v, kv_last, lse,
            dl, do, scale, q_off, window, pos_q, pos_k, extra=(o,))
    bwd_dq.launches += 1
    return dq, dl


def bwd_dkv(q, k, v, kv_last, lse, dl, do, scale: float, *, q_off: int = 0,
            window: Optional[int] = None, pos_q=None, pos_k=None,
            parts: Optional[int] = None):
    """Launch the dk/dv kernel (inputs already checked, ``dl`` = Δ).  The
    bf16 hd 64/128 instances order the key tiles heaviest first (a schedule
    pass in the same launch, whose plain version is ``dkv_schedule``) and
    split each GQA group into ``parts`` (default ``head_parts``), summing
    fp32 partials in a fixed order."""
    B, S, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    sched = partial = None
    if q.dtype == torch.bfloat16 and hd in HOPPER_HEAD_DIMS:
        units = B * -(-Skv // BLOCK)
        sched = torch.empty(units, dtype=torch.int32, device=q.device)
        if parts is None:
            parts = head_parts(H // Kh, units * Kh, torch.cuda
                               .get_device_properties(q.device)
                               .multi_processor_count)
        if parts > 1:
            partial = torch.empty(2 * parts * k.numel(), dtype=torch.float32,
                                  device=q.device)
    _launch(SOURCES[1], "tree_attention_bwd_dkv", (dk, dv), q, k, v, kv_last,
            lse, dl, do, scale, q_off, window, pos_q, pos_k,
            extra=(sched, partial), parts=parts or 1)
    bwd_dkv.launches += 1
    return dk, dv


bwd_dq.launches = 0
bwd_dkv.launches = 0


def tree_attention_bwd(q, k, v, kv_last, o, lse, do, scale: float, *,
                       q_off: int = 0, window: Optional[int] = None,
                       pos_q: Optional[torch.Tensor] = None,
                       pos_k: Optional[torch.Tensor] = None):
    """dq, dk, dv of tree attention through the two CUDA kernels.

    q/o/do: [B,S,H,hd]; k/v: [B,Skv,Kh,hd]; kv_last: [B,Skv] int32; lse
    [B,H,S] f32 from the forward's ``save_residuals``; with ``window``,
    pos_q [B,S] and pos_k [B,Skv] int32.  Returns (dq, dk, dv) in the
    inputs' dtype; dk/dv cover the full Skv, ancestor rows included.

    The dq launch comes first and hands Δ to the dk/dv launch; on the bf16
    hd 64/128 path the dq kernel writes that Δ, so the two launches must
    stay in this order on one stream."""
    _check(q, k, v, kv_last, o, lse, do, q_off, window, pos_q, pos_k)
    kw = dict(q_off=q_off, window=window, pos_q=pos_q, pos_k=pos_k)
    dq, dl = bwd_dq(q, k, v, kv_last, o, lse, do, scale, **kw)
    dk, dv = bwd_dkv(q, k, v, kv_last, lse, dl, do, scale, **kw)
    return dq, dk, dv
