"""Tree flash-attention forward on Hopper: the host-side skip helpers and
the ctypes wrapper of the CUDA kernel ``csrc/tree_attention_fwd.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/tree_attention.py::
tree_attention`` (body :146-218, ``pallas_call`` :248).  A block owns a
(64-query tile, head, batch row) and runs an online softmax over the key
tiles that ``block_live`` keeps; a dead tile is skipped before its loads.
Ragged S and Skv are masked in-kernel, ``q_off`` is a runtime int, and GQA
maps head h to kv head h // (H/Kh).

Two paths (``csrc/tree_attention_fwd.cu``): bf16 at hd 64 and 128
(``HOPPER_HEAD_DIMS``, the models' head dims) runs a warp-specialised
kernel, a TMA producer warp that hands live key tiles through an mbarrier
ring to a wgmma consumer warpgroup with its accumulators in registers; fp32
(the accuracy path) and bf16 at the other head dims run the simple kernel
(WMMA or FMA through shared memory).

Bound on the H100: at the serving path's shapes (hd 128) the forward does
about 4·hd FLOPs per visible pair for 2·hd·2 bytes per key read, so the
floor is the tensor cores' 989 TFLOP/s (bf16), not the 3.35 TB/s of
memory.  PERF.md keeps the measured times.

On the card the wrapper launches the kernel or raises: it never falls
back.  ``ops.tree_attention`` routes a CPU tensor to the plain version
(``kernels/ref.py``) instead.  ``tree_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
BLOCK_Q = BLOCK_K = 64        # the kernel's tile (BQ, BK in the .cu source)
HEAD_DIMS = (16, 24, 32, 64, 96, 128, 192)
HOPPER_HEAD_DIMS = (64, 128)  # bf16 at these takes the wgmma/TMA path
SOURCE = "tree_attention_fwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


def block_kmax_flat(kv_last, B: int, nk: int, block_k: int) -> np.ndarray:
    """Per-(batch, kv-tile) max of kv_last, flat [B·nk].  A ragged last
    tile counts its real keys only, as the kernel reads none past Skv."""
    kv = np.asarray(kv_last).reshape(B, -1)
    kv = np.pad(kv, ((0, 0), (0, nk * block_k - kv.shape[1])),
                constant_values=-1)
    return kv.reshape(B, nk, block_k).max(-1).reshape(B * nk)


def block_live(q_start, q_end, kv_start, block_max,
               qp_min=None, kp_max=None, window: Optional[int] = None):
    """The block-skip predicate: a (q-tile, kv-tile) pair is live unless
    entirely anti-causal (kv_start > q_end), entirely invisible
    (max kv_last < q_start) or, windowed, entirely out of window
    (min pos_q − max pos_k ≥ window).  q_start/q_end are global query
    indices.  The kernel evaluates the same predicate per tile."""
    live = (kv_start <= q_end) & (block_max >= q_start)
    if window is not None:
        live = live & ((qp_min - kp_max) < window)
    return live


def block_live_mask(kv_last, S: int, block_q: int = BLOCK_Q,
                    block_k: int = BLOCK_K, *, q_off: int = 0, pos_q=None,
                    pos_k=None, window: Optional[int] = None) -> np.ndarray:
    """[nq, nk] bool for one batch row: which (q-tile, kv-tile) pairs the
    kernel computes.  Ragged tails count their real rows and keys only; on
    shapes the tiles divide this equals the reference's
    ``block_live_mask``."""
    kv_last = np.asarray(kv_last).reshape(-1)
    Skv = kv_last.shape[0]
    nq, nk = -(-S // block_q), -(-Skv // block_k)
    kmax = block_kmax_flat(kv_last, 1, nk, block_k)
    qi = np.arange(nq)[:, None]
    ki = np.arange(nk)[None, :]
    q_start = q_off + qi * block_q
    q_end = q_off + np.minimum(qi * block_q + block_q, S) - 1
    qpmin = kpmax = None
    if window is not None:
        big = np.iinfo(np.int64).max
        pq = np.pad(np.asarray(pos_q, np.int64).reshape(-1),
                    (0, nq * block_q - S), constant_values=big)
        pk = np.pad(np.asarray(pos_k, np.int64).reshape(-1),
                    (0, nk * block_k - Skv), constant_values=-big)
        qpmin = pq.reshape(nq, block_q).min(-1)[:, None]
        kpmax = pk.reshape(nk, block_k).max(-1)[None, :]
    return block_live(q_start, q_end, ki * block_k, kmax[None, :], qpmin,
                      kpmax, window)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if its data does not start on 16 bytes (a
    view into another tensor can start anywhere), which TMA needs."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        lib.tree_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.tree_attention_fwd.restype = ctypes.c_int
        lib.tree_attention_error_string.argtypes = [ctypes.c_int]
        lib.tree_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v, kv_last, q_off, window, pos_q, pos_k):
    tensors = [q, k, v, kv_last] + ([pos_q, pos_k] if window is not None
                                    else [])
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("tree_attention kernel: every input must lie on the "
                         "same CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the raw tree_attention kernel wrapper records no "
                           "gradient: call repro_torch.kernels.ops."
                           "tree_attention, whose autograd node runs the "
                           "backward kernels")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"tree_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B,S,H,hd] and k/v [B,Skv,Kh,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Kh == 0 or H % Kh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (need H % Kh == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"tree_attention kernel has no instance for head "
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
        raise ValueError("tree_attention kernel takes contiguous tensors")


def tree_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_last: torch.Tensor, scale: float, *, q_off: int = 0,
                   window: Optional[int] = None,
                   pos_q: Optional[torch.Tensor] = None,
                   pos_k: Optional[torch.Tensor] = None,
                   save_residuals: bool = False):
    """Launch the CUDA kernel.  q: [B,S,H,hd]; k/v: [B,Skv,Kh,hd] (Skv ≥
    q_off + S); kv_last: [B,Skv] int32; with ``window``, pos_q [B,S] and
    pos_k [B,Skv] int32.  Returns o [B,S,H,hd] in q's dtype, and with
    ``save_residuals`` also lse [B,H,S] f32."""
    _check(q, k, v, kv_last, q_off, window, pos_q, pos_k)
    B, S, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if save_residuals else None)
    lib = _library()
    q, k, v = (_aligned(t) for t in (q, k, v))
    ptr = lambda t: None if t is None else t.data_ptr()
    windowed = window is not None
    err = lib.tree_attention_fwd(
        ptr(q), ptr(k), ptr(v), ptr(kv_last),
        ptr(pos_q) if windowed else None, ptr(pos_k) if windowed else None,
        ptr(o), ptr(lse), B, S, Skv, H, Kh, hd, _DTYPES[q.dtype],
        float(scale), int(q_off), int(window) if windowed else 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("tree_attention kernel launch failed: "
                           + lib.tree_attention_error_string(err).decode())
    tree_attention.launches += 1
    return (o, lse) if save_residuals else o


tree_attention.launches = 0
