"""Mixture-of-Experts: top-k routing and sort-based capacity dispatch (port
of `repro/models/moe.py`).

Dispatch is grouped by batch row, as in JAX: a row's tokens compete only
with each other for an expert's capacity, so the rows of a slot cache never
interact. The expert products are grouped einsums over an (E, B·cap, D)
buffer; JAX has no Pallas kernel for them, and neither does the port.

What JAX leaves to its sort and scatter orders the port fixes explicitly:

* top-k takes the lower expert index on equal probabilities
  (`jax.lax.top_k`); `torch.topk` leaves ties unordered, so the port
  selects with a stable descending sort.
* capacity goes to earlier tokens first (JAX's `argsort` is stable); the
  port sorts with ``stable=True``.
* a token's k gated outputs are summed in ascending expert id, in the
  activations' dtype, the order of JAX's scatter-add over its sorted
  entries. The port adds them one by one in that order, not by
  `index_add_`, whose atomic order on the card would change a bf16 sum
  from run to run.

The expert-parallel path (`apply_moe_ep`, a shard_map over a mesh) waits
for the port's mesh (ROADMAP.md, A18); `apply_moe_auto` is `apply_moe`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, einsum


def moe_schema(cfg, d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    e, f = cfg.n_experts, cfg.moe_d_ff
    std = 0.02
    std_o = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    if getattr(cfg, "moe_fsdp_dim", "d_ff") == "d_model":
        wi_axes = ("experts", "embed_fsdp", None)
        wo_axes = ("experts", None, "embed_fsdp")
    else:
        wi_axes = ("experts", None, "embed_fsdp")
        wo_axes = ("experts", "embed_fsdp", None)
    return {
        "router": ParamSpec((d, e), (None, "experts"), std=std),
        "wi_gate": ParamSpec((e, d, f), wi_axes, std=std),
        "wi_up": ParamSpec((e, d, f), wi_axes, std=std),
        "wo": ParamSpec((e, f, d), wo_axes, std=std_o),
    }


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of the last axis and their indices, ties to the
    lower index (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, p, x):
    """Router logits/top-k. x (B,S,D) -> gates (B,S,K) fp32, idx (B,S,K),
    probs (B,S,E) fp32."""
    logits = einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def load_balance_loss(cfg, probs, idx):
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    e = cfg.n_experts
    counts = F.one_hot(idx, e).sum((0, 1, 2)).float()
    f = counts / max(idx.numel(), 1)
    pmean = probs.mean((0, 1))
    return e * torch.sum(f * pmean)


def capacity(s: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots an expert takes from one group of ``s`` tokens: Python float
    arithmetic, as JAX computes it."""
    cap = max(1, int(math.ceil(s * k / e * capacity_factor)))
    return min(cap, s * k)


def _segments(eid):
    """Stable sort of expert ids along the last axis: (sorted ids, order,
    each sorted entry's position within its expert's segment)."""
    se, order = torch.sort(eid, dim=-1, stable=True)
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(eid.shape[-1], device=eid.device) - first
    return se, order, pos


def apply_moe(cfg, p, x, *, capacity_factor: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss). x (B,S,D).

    capacity_factor defaults to cfg.capacity_factor; set it large (>= E/K·S)
    for exact no-drop routing (decode steps and consistency tests)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    gates, idx, probs = route(cfg, p, x)                     # (B,S,K)
    cap = capacity(s, k, e, capacity_factor)

    # A token's k experts are distinct, so ordering its entries by expert
    # id moves no entry within an expert's segment (the stable sort keeps
    # token order there); it puts each token's sum in JAX's order.
    eid, perm = torch.sort(idx, dim=-1)                      # (B,S,K)
    gat = gates.gather(-1, perm).to(x.dtype)
    _, order, spos = _segments(eid.reshape(b, s * k))
    pos = torch.empty_like(spos).scatter_(1, order, spos).view(b, s, k)
    keep = pos < cap
    # the buffer is (E, B, cap, D), so the expert products are one bmm;
    # kept entries' slots are distinct, and dropped entries write a spare
    # last row, which no product reads
    rows = e * b * cap
    bidx = torch.arange(b, device=x.device)[:, None, None]
    dest = torch.where(keep, (eid * b + bidx) * cap + pos, rows)
    buf = x.new_zeros((rows + 1, d))
    buf[dest] = x[:, :, None]
    h = buf[:rows].view(e, b * cap, d)

    h_g = einsum("ecd,edf->ecf", h, p["wi_gate"])
    h_u = einsum("ecd,edf->ecf", h, p["wi_up"])
    yb = einsum("ecf,efd->ecd", F.silu(h_g) * h_u, p["wo"]).reshape(rows, d)

    # as JAX: a dropped entry reads slot 0 and is multiplied by a gate of 0
    ye = yb[torch.where(keep, dest, 0)] * (gat * keep)[..., None]
    ye = ye.to(x.dtype)                                      # (B,S,K,D)
    y = torch.zeros_like(x)
    for j in range(k):                      # ascending expert id
        y = y + ye[:, :, j]
    return y, load_balance_loss(cfg, probs, idx)


def _local_dispatch(x_flat, eid, gat, e: int, cap: int):
    """Device-local capacity dispatch (one group; `apply_moe_ep`'s).

    x_flat (N, D) token features per assignment; eid (N,) expert ids;
    gat (N,) gates. Returns buf (e, cap, D), plus (order, dest, keep) to
    invert the dispatch."""
    d = x_flat.shape[1]
    se, order, pos = _segments(eid)
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, 0)
    buf = x_flat.new_zeros((e * cap + 1, d))
    buf[torch.where(keep, dest, e * cap)] = x_flat[order]
    return buf[:-1].view(e, cap, d), order, dest, keep


def apply_moe_ep(cfg, p, x, *, mesh, batch_axes, expert_axis="model",
                 capacity_factor: Optional[float] = None):
    """The expert-parallel shard_map path: not ported, the port has no mesh
    yet."""
    raise NotImplementedError(
        "apply_moe_ep: expert parallelism over a mesh is not ported yet "
        "(ROADMAP.md, A18); apply_moe runs the same function on one device")


def apply_moe_auto(cfg, p, x):
    """JAX takes the EP path when a mesh with a usable expert axis is
    active; the port has none until A18, so this is `apply_moe`."""
    return apply_moe(cfg, p, x)
