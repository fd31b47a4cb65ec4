"""Mixture-of-Experts layer: top-k router, capacity-based scatter dispatch,
optional shared experts, load-balance and router-z auxiliary losses.

Port of ``repro/models/moe.py``.  Parameters keep the reference's names
and shapes (``router`` [D, E] always fp32; ``wi_gate``/``wi_up`` [E, D, F],
``wo`` [E, F, D]; ``shared_*`` [D, F·n_shared] / [F·n_shared, D]), so the
weight bridge stays an identity rename.  The reference has no Pallas
kernel here: its expert products are einsums over the stacked experts,
which are ``torch.bmm`` here.

The dispatch is the reference's, step for step: the capacity C comes from
the static token count N by Python's ``round`` (half to even), each
(token, slot) takes its place in its expert's queue in (token, slot)
order, pads never queue, and a slot past C goes to a spill row (index C)
that is cut off.  Everything stays on the device with static shapes: no
boolean-mask indexing, no ``nonzero``, no ``.item()``, so a training step
keeps its one host sync.

On a data axis (``sharding.use_mesh``) each rank holds a contiguous block
of the batch's rows, and the layer keeps the whole batch's semantics: C
comes from the global N, a rank's slots queue behind the lower ranks'
(its offset per expert the sum of their counts, all-gathered: [R, E]
integers, one collective a layer), and the aux losses take the global
counts and valid-token count, so the ranks' losses (each its tokens'
share) sum to the whole batch's, as do their gradients.  A rank keeps
exactly the (token, slot) pairs one process holding every row keeps.

On a model axis of m ranks (expert parallelism, the reference's
``P("M", None, None)`` on the expert dim) rank r holds experts
[r·E/m, (r+1)·E/m) and the shared expert's column block
(``shared_wi_*``) and row block (``shared_wo``); the router is
replicated.  The layer's input is the block input every rank of the
axis reads whole (``sharding.tp_in``), so every rank routes the same
tokens and runs the whole routing and queue; it then dispatches into
and runs only its own experts (``xb`` [E/m, C+1, D]: a slot of another
rank's expert goes to the spill row, as a dropped slot does), and its
combine reads zeros for those slots.  The routed and shared partial
outputs are summed once a layer (``sharding.model_sum``: an all-reduce,
or under sequence parallelism a reduce-scatter along S), where the
reference's GSPMD moves the dispatch and combine through an all-to-all.
The router's gradient is then this rank's experts' share of the
combine's (``sharding.model_partial`` sums it), and the aux losses, which
every rank computes whole, pass ``sharding.model_share``: their value
whole, their gradient a 1/m share, so each enters the backward once.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import MoECfg
from repro_torch.models.layers import _dense_init
from repro_torch.sharding import (DataAxis, data_axis, model_block,
                                  model_share, model_size, model_sum,
                                  not_on_model_axis)


def init_moe(generator, cfg: MoECfg, d_model: int, activation: str,
             dtype=torch.float32, device=None, lead=()) -> dict:
    """``lead`` prepends stacked-layer dims to every leaf; the router is
    fp32 whatever ``dtype`` is (the reference's ``moe.py:33-34``)."""
    E, Fe = cfg.num_experts, cfg.d_expert
    kw = dict(dtype=dtype, device=device)
    p = {"router": _dense_init(generator, (*lead, d_model, E), scale=0.02,
                               dtype=torch.float32, device=device),
         "wo": _dense_init(generator, (*lead, E, Fe, d_model), **kw)}
    if activation == "swiglu":
        p["wi_gate"] = _dense_init(generator, (*lead, E, d_model, Fe), **kw)
    p["wi_up"] = _dense_init(generator, (*lead, E, d_model, Fe), **kw)
    if cfg.num_shared_experts:
        Fs = Fe * cfg.num_shared_experts
        if activation == "swiglu":
            p["shared_wi_gate"] = _dense_init(generator, (*lead, d_model, Fs),
                                              **kw)
        p["shared_wi_up"] = _dense_init(generator, (*lead, d_model, Fs), **kw)
        p["shared_wo"] = _dense_init(generator, (*lead, Fs, d_model), **kw)
    return p


def _activate(h_up: torch.Tensor, activation: str) -> torch.Tensor:
    """The non-gated activations of ``_act``: relu or squared relu."""
    r = F.relu(h_up)
    return r * r if activation == "squared_relu" else r


def _act(p: dict, x: torch.Tensor, activation: str,
         prefix: str = "") -> torch.Tensor:
    if activation == "swiglu":
        return F.silu(x @ p[prefix + "wi_gate"]) * (x @ p[prefix + "wi_up"])
    return _activate(x @ p[prefix + "wi_up"], activation)


def capacity(n_tokens: int, cfg: MoECfg) -> int:
    """Per-expert queue length C from the static token count (Python's
    round, half to even, as the reference's ``moe.py:76``)."""
    return int(max(1, round(n_tokens * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor)))


def route(params: dict, cfg: MoECfg, xf: torch.Tensor):
    """Router of N tokens xf [N, D]: (logits [N, E] f32, probs, top_p
    [N, K] renormalised, top_e [N, K] int64).  The logits are a true fp32
    product (``xf`` cast up; TF32 must stay off, PyTorch's default, or
    near-tied experts flip); ``topk`` sorts descending, as ``lax.top_k``."""
    logits = xf.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_e


def queue(top_e: torch.Tensor, vmask: torch.Tensor, E: int, C: int,
          axis: Optional[DataAxis] = None):
    """Each (token, slot)'s place in its expert's queue, in (token, slot)
    order over the flattened N·K rows, pads not queueing.  Returns (counts
    [E]: the valid slots that chose each expert, pos_c [N·K] with a dropped
    or pad slot at the spill row C, keep [N·K] bool).  On a data ``axis``
    the rows are this rank's block of the batch: the queue runs on from
    the lower ranks' slots and ``counts`` are the whole batch's.  The masked one-hot
    is laid out [E, N·K], so the cumsum runs along its contiguous last dim:
    down the rows of an [N·K, E] one-hot, PyTorch's outer-dim scan took
    25.5 ms a call at N·K = 65536, a sixth of a 2-layer Qwen3-30B-A3B
    train step (chip_smoke.py's profile; NVIDIA H100 80GB HBM3, 700 W)."""
    N, K = top_e.shape
    e_flat = top_e.reshape(N * K)
    valid = vmask.repeat_interleave(K)
    oh = ((torch.arange(E, device=top_e.device)[:, None] == e_flat[None, :])
          & valid[None, :]).to(torch.int32)                   # [E, N·K]
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(pos, 0, e_flat[None, :])[0]
    counts = oh.sum(1)
    if axis is not None:
        every = [torch.empty_like(counts) for _ in range(axis.size)]
        dist.all_gather(every, counts, group=axis.group)
        lower = torch.stack(every[:axis.rank]).sum(0) if axis.rank \
            else torch.zeros_like(counts)
        pos = pos + lower[e_flat]
        counts = torch.stack(every).sum(0)
    keep = (pos >= 0) & (pos < C) & valid
    return counts, torch.where(keep, pos, C), keep


def moe(params: dict, cfg: MoECfg, x: torch.Tensor, valid: torch.Tensor,
        activation: str, with_aux: bool = True) -> tuple[torch.Tensor, dict]:
    """x: [B, S, D]; valid: [B, S] bool.  Returns (y [B, S, D], aux) with
    aux = {"load_balance", "router_z"} f32 scalars (means over valid
    tokens, already weighted), or {} without ``with_aux``: decode discards
    them, and a decode step is bound by its kernel launches.  On a model
    axis ``params`` are this rank's blocks and y is the summed output (the
    rank's block of S under sequence parallelism)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    if E % model_size():
        raise not_on_model_axis(f"{E} experts, which do not divide a model "
                                f"axis of {model_size()},")
    N = B * S
    xf = x.reshape(N, D)
    vmask = valid.reshape(N)
    logits, probs, top_p, top_e = route(params, cfg, xf)

    axis = data_axis()
    C = capacity(N if axis is None else N * axis.size, cfg)
    counts, pos_c, keep = (queue(top_e, vmask, E, C) if axis is None
                           else queue(top_e, vmask, E, C, axis))
    e_flat = top_e.reshape(N * K)
    # this rank's experts [lo, hi): a slot of another rank's expert goes
    # to the spill row and reads zeros in the combine, as a dropped slot
    lo, hi = model_block(E)
    e_loc, pos_loc = e_flat, pos_c
    if hi - lo < E:
        mine = (e_flat >= lo) & (e_flat < hi)
        e_loc = torch.where(mine, e_flat - lo, 0)
        pos_loc = torch.where(mine, pos_c, C)

    # each token's row once per slot: an expand, not repeat_interleave,
    # whose CUDA backward is an atomic index_add (run-to-run different
    # sums); the expand's backward is a fixed-order sum over K
    src = xf[:, None].expand(N, K, D).reshape(N * K, D)     # [N·K, D]
    # dispatch: [E/m, C+1, D], the last row the spill bucket; kept slots are
    # unique, so only the discarded spill row ever sums (and on CUDA an
    # accumulating index_put sorts its indices: deterministic either way);
    # its backward is a gather
    xb = torch.zeros((hi - lo, C + 1, D), dtype=x.dtype, device=x.device)
    xb = xb.index_put((e_loc, pos_loc), src, accumulate=True)[:, :C]

    # expert FFN over the stacked experts
    if "wi_gate" in params:
        h = F.silu(torch.bmm(xb, params["wi_gate"])) \
            * torch.bmm(xb, params["wi_up"])
    else:
        h = _activate(torch.bmm(xb, params["wi_up"]), activation)
    yb = torch.bmm(h, params["wo"])                        # [E/m, C, D]

    # combine: gather each slot's row (the spill row reads zeros); its
    # backward is an accumulating index_put, deterministic on CUDA (sorted),
    # and only the cut-off spill row receives more than one cotangent
    yb = torch.cat([yb, yb.new_zeros((hi - lo, 1, D))], dim=1)
    gathered = yb[e_loc, pos_loc]                             # [N·K, D]
    w = torch.where(keep, top_p.reshape(N * K), 0.0).to(x.dtype)
    y = (gathered * w[:, None]).reshape(N, K, D).sum(dim=1)

    if "shared_wi_up" in params:
        y = y + _act(params, xf, activation, "shared_") @ params["shared_wo"]
    # the model axis's partial outputs summed, once a layer
    y = model_sum(y.reshape(B, S, D))

    if not with_aux:
        return y, {}
    # aux losses over valid tokens (each valid token has K slots, so the
    # counts give the batch's valid-token count, on a data axis too: this
    # rank's terms are its share over the whole batch's denominators)
    nv = torch.clamp(counts.sum() // K, min=1).float()
    frac = counts.float() / (nv * K)
    pmean = (probs * vmask.float()[:, None]).sum(0) / nv
    z = torch.where(vmask, torch.logsumexp(logits, dim=-1) ** 2, 0.0)
    aux = {"load_balance": E * torch.sum(frac * pmean)
           * cfg.router_aux_weight,
           "router_z": (z.sum() / nv) * cfg.router_z_weight}
    return y, {k: model_share(v) for k, v in aux.items()}
