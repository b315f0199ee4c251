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

`apply_moe_ep` is the reference's expert-parallel path over a mesh of
ranks (`torch.distributed`, a DeviceMesh with named dims), on DTensor
parameters (`sharding.distribute_tree`) or whole tensors, with gradients.
Routing and the capacity dispatch stay local to a rank; the only traffic
is one all_to_all over the expert dim carrying each rank's dispatch
buffer, its reverse for the combine, and a ZeRO all-gather of the expert
weights over the batch dims. `apply_moe_auto` takes it under
`sharding.use_mesh` exactly when the reference does, and `apply_moe`
otherwise.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
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
    for exact no-drop routing (decode steps and consistency tests). On
    DTensors (a config the EP path does not take, on a mesh) it runs
    `_moe_on_shards`."""
    if capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    if sharding.is_dtensor(x):
        return _moe_on_shards(cfg, p, x, capacity_factor)
    y, idx, probs = _moe_dispatch(cfg, p, x, capacity_factor)
    return y, load_balance_loss(cfg, probs, idx)


def _moe_dispatch(cfg, p, x, capacity_factor: float):
    """`apply_moe`'s y, with the top-k ids and router probabilities its
    load-balance loss reads."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
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
    return y, idx, probs


def _moe_on_shards(cfg, p, x, capacity_factor: float):
    """`apply_moe` of DTensors. Its dispatch groups tokens by batch row, so
    each rank runs it on its own batch block, the weights whole (under
    `local_map`; their gradient partial over the batch dims), and the
    load-balance loss comes from the blocks' expert counts and router
    probability sums, summed over the mesh: the whole batch's, as on one
    device. (The reference constrains its expert buffer to "batch" and
    "experts" for XLA's partitioner; here no rank holds the buffer of
    another's rows.)"""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    e = cfg.n_experts
    px = sharding.placements(sharding.spec_for(
        tuple(x.shape), ("batch", "seq", "embed"), mesh), mesh)
    whole = tuple(Replicate() for _ in px)
    summed = tuple(Partial() if q.is_shard() else Replicate() for q in px)
    names = list(p)

    def local(xl, *ws):
        y, idx, probs = _moe_dispatch(cfg, dict(zip(names, ws)), xl,
                                      capacity_factor)
        return (y, F.one_hot(idx, e).sum((0, 1, 2)).float(),
                probs.sum((0, 1)))
    gw = sharding.grad_placements(whole, px)
    y, counts, psum = local_map(
        local, out_placements=(px, summed, summed),
        in_placements=(px,) + (whole,) * len(names),
        in_grad_placements=(px,) + (gw,) * len(names), device_mesh=mesh,
        redistribute_inputs=True)(x, *(p[n] for n in names))
    b, s, _ = x.shape
    aux = e * torch.sum(counts / (b * s * cfg.top_k) * (psum / (b * s)))
    return y, aux


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


# ==================================================================== EP path
class _GatherWhole(torch.autograd.Function):
    """Tiled all-gather whose result every rank of the group then holds
    whole and alike (the EP output's reassembly): a rank's gradient is its
    own block of the result's gradient, not a sum over the ranks."""

    @staticmethod
    def forward(ctx, x, dim: int, ax):
        ctx.dim, ctx.ax, ctx.n = dim, ax, x.shape[dim]
        return ax.gather(x.detach(), dim, autograd=False)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n), None, None


class _MeanWhole(torch.autograd.Function):
    """The group's mean of a value, then held whole and alike by every rank
    (the reference's pmean of the aux loss): the gradient of a rank's value
    is the mean's gradient over the group size."""

    @staticmethod
    def forward(ctx, v, ax):
        ctx.size = ax.size
        t = ax.comm(v.detach()).clone()
        import torch.distributed as dist
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=ax.group)
        return (t / ax.size).to(v.device)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _Dim:
    """One mesh dim as the EP path uses it: its process group (None when
    the dim has one rank, which needs no collective), size and this rank's
    index along it. The collectives carry gradients: `gather` and
    `all_to_all` through `torch.distributed._functional_collectives`'
    autograd forms, `gather_whole` and `mean_whole` through `_GatherWhole`
    and `_MeanWhole`."""

    def __init__(self, mesh, name: str):
        self.name = name
        self.size = sharding.mesh_sizes(mesh)[name]
        self.index = sharding.mesh_coords(mesh)[name]
        self.group = mesh.get_group(name) if self.size > 1 else None

    def comm(self, x):
        """Collectives run on the host over gloo (ranks that share a GPU
        exchange host copies), on the device otherwise."""
        import torch.distributed as dist
        host = dist.get_backend(self.group) == "gloo"
        return x.to("cpu" if host else x.device).contiguous()

    def gather(self, x, dim: int, autograd: bool = True):
        """Tiled all-gather: the ranks' ``x`` concatenated along ``dim`` in
        index order. Its gradient is the sum over the ranks of each one's
        gradient of the whole (each rank uses the whole on its own
        tokens)."""
        if self.group is None:
            return x
        import torch.distributed._functional_collectives as fc
        fn = fc.all_gather_tensor_autograd if autograd else \
            fc.all_gather_tensor
        out = fn(self.comm(x), gather_dim=dim, group=self.group)
        return fc.wait_tensor(out).to(x.device)

    def all_to_all(self, x):
        """x (size, ...): block j goes to index j; returns (size, ...) whose
        block j came from index j (its gradient: the reverse exchange)."""
        if self.group is None:
            return x
        import torch.distributed._functional_collectives as fc
        out = fc.all_to_all_single_autograd(self.comm(x), None, None,
                                            group=self.group)
        return fc.wait_tensor(out).to(x.device)

    def gather_whole(self, x, dim: int):
        return x if self.group is None else _GatherWhole.apply(x, dim, self)

    def mean_whole(self, v):
        return v if self.group is None else _MeanWhole.apply(v, self)


def _ep_blocks(p, x, *, mesh, ex, fsdp, seq_split: bool):
    """The blocks of the parameters and of x that this rank's EP function
    takes, as plain tensors: (router, wi_gate, wi_up, wo, x_loc). DTensors
    are redistributed to the reference's shard_map specs (router experts
    over ``ex``; wi / wo experts over ``ex`` and f over the batch axes; x's
    batch over the batch axes and, with ``seq_split``, its sequence over
    ``ex``) and their local blocks taken; whole tensors are sliced to the
    same blocks. The router, read whole by every rank of the batch axes,
    takes a partial gradient there."""
    n_blk = math.prod(d.size for d in fsdp)
    f_all = p["wi_gate"].shape[-1]
    if x.shape[0] % n_blk or f_all % n_blk:
        raise ValueError(f"batch {x.shape[0]} and expert hidden {f_all} "
                         f"must split over the {n_blk} ranks of the batch "
                         "axes")
    if sharding.is_dtensor(x):
        from torch.distributed.tensor import Partial, Replicate, Shard
        names = mesh.mesh_dim_names
        batch = {d.name for d in fsdp}

        def pl(shards):
            return [shards.get(n, Replicate()) for n in names]
        exp = {ex.name: Shard(0)}
        wi = pl({**exp, **{n: Shard(2) for n in batch}})
        wo = pl({**exp, **{n: Shard(1) for n in batch}})
        px = pl({**({ex.name: Shard(1)} if seq_split else {}),
                 **{n: Shard(0) for n in batch}})
        router = p["router"].redistribute(mesh, pl({ex.name: Shard(1)}))
        return (router.to_local(grad_placements=pl(
                    {ex.name: Shard(1), **{n: Partial() for n in batch}})),
                p["wi_gate"].redistribute(mesh, wi).to_local(),
                p["wi_up"].redistribute(mesh, wi).to_local(),
                p["wo"].redistribute(mesh, wo).to_local(),
                x.redistribute(mesh, px).to_local())
    blk = 0
    for d in fsdp:                      # the first batch axis is the major
        blk = blk * d.size + d.index
    e_loc = p["wi_gate"].shape[0] // ex.size
    bl, fl = x.shape[0] // n_blk, f_all // n_blk
    es = slice(ex.index * e_loc, (ex.index + 1) * e_loc)
    fs = slice(blk * fl, (blk + 1) * fl)
    x_full = x[blk * bl:(blk + 1) * bl]
    s = x_full.shape[1] // ex.size if seq_split else x_full.shape[1]
    i0 = ex.index * s if seq_split else 0
    return (p["router"][:, es], p["wi_gate"][es, :, fs],
            p["wi_up"][es, :, fs], p["wo"][es, fs, :], x_full[:, i0:i0 + s])


def apply_moe_ep(cfg, p, x, *, mesh, batch_axes, expert_axis="model",
                 capacity_factor: Optional[float] = None):
    """Expert-parallel MoE over ``mesh``: call on every rank of its process
    group. Returns (y, aux_loss).

    ``p`` and ``x`` (B, S, D) are DTensors on ``mesh`` (a model placed by
    `sharding.distribute_tree`), or whole tensors on every rank. Each rank
    takes its blocks as the reference's shard_map specs place them
    (`_ep_blocks`): x's batch block over ``batch_axes``, its experts on
    ``expert_axis`` and its block of the expert hidden dim f over
    ``batch_axes``. Then, as the reference: each expert-axis peer routes its
    own S/m sequence slice (when m divides S), with the router gathered over
    the expert axis; the capacity dispatch is local (``capacity_factor``
    over the rank's B·S·K entries); one all_to_all sends each expert block
    to its owner and one brings the outputs back; the expert weights are
    all-gathered over the batch axes (f dim); the aux loss is averaged over
    both. A token's k outputs are summed in ascending expert id, the order
    of the reference's scatter-add. For DTensors y is a DTensor placed by
    ("batch", "seq", "embed") and aux a replicated one; for whole tensors y
    is gathered whole on every rank and aux is the same on every rank.

    Gradients flow through every collective. With whole tensors a rank's
    gradient of ``p`` and ``x`` covers its own blocks (the ranks' sum is the
    gradient); with DTensors they come in the DTensors' placements. A
    sequence that does not split over m > 1 expert-axis ranks is routed by
    every peer alike and takes no gradient (it raises)."""
    if capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    e, k = cfg.n_experts, cfg.top_k
    sizes = sharding.mesh_sizes(mesh)
    m_size = sizes[expert_axis]
    if e % m_size:
        raise ValueError(f"{e} experts do not split over {m_size} "
                         f"{expert_axis!r} ranks")
    e_loc = e // m_size
    ex = _Dim(mesh, expert_axis)
    fsdp = [_Dim(mesh, a) for a in batch_axes if a in sizes]
    s_full = x.shape[1]
    seq_split = s_full % m_size == 0 and s_full >= m_size
    params_grad = x.requires_grad or any(v.requires_grad for v in p.values())
    if not seq_split and m_size > 1 and torch.is_grad_enabled() \
            and params_grad:
        raise ValueError(f"a sequence of {s_full} tokens does not split over "
                         f"the {m_size} {expert_axis!r} ranks: every peer "
                         "routes it whole, which has no gradient path")
    router, wi_g, wi_u, wo, x_loc = _ep_blocks(p, x, mesh=mesh, ex=ex,
                                               fsdp=fsdp, seq_split=seq_split)
    b, s, d = x_loc.shape
    # ---- local routing (router gathered over the expert axis) ----
    gates, idx, probs = route(cfg, {"router": ex.gather(router, 1)}, x_loc)
    aux = ex.mean_whole(load_balance_loss(cfg, probs, idx))
    for dim in fsdp:
        aux = dim.mean_whole(aux)

    n = b * s * k
    cap = max(1, int(math.ceil(n / e * capacity_factor)))
    x_rep = x_loc.reshape(b * s, d).repeat_interleave(k, dim=0)   # (N, D)
    eid = idx.reshape(n)
    gat = gates.reshape(n).to(x_loc.dtype)
    buf, order, dest, keep = _local_dispatch(x_rep, eid, gat, e, cap)

    # ---- all_to_all: each expert block to its owner ----
    recv = ex.all_to_all(buf.reshape(m_size, e_loc, cap, d))
    toks = recv.transpose(0, 1).reshape(e_loc, m_size * cap, d)
    # ---- ZeRO weight gather over the batch axes (f dim) ----
    for dim in fsdp:
        wi_g, wi_u = dim.gather(wi_g, 2), dim.gather(wi_u, 2)
        wo = dim.gather(wo, 1)
    h = F.silu(einsum("ecd,edf->ecf", toks, wi_g))
    h = h * einsum("ecd,edf->ecf", toks, wi_u)
    y = einsum("ecf,efd->ecd", h, wo)                         # (e_loc,·,d)

    # ---- reverse all_to_all + local combine ----
    back = ex.all_to_all(y.reshape(e_loc, m_size, cap, d).transpose(0, 1))
    ybuf = back.reshape(e * cap, d)
    ye = ybuf[dest] * (gat[order] * keep)[:, None]            # sorted order
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=order.device))
    ye = ye[inv].reshape(b * s, k, d)                         # token order
    perm = torch.sort(eid.reshape(b * s, k), dim=-1).indices
    ye = ye.gather(1, perm[..., None].expand(-1, -1, d))
    contrib = torch.zeros((b * s, d), dtype=x_loc.dtype,
                          device=x_loc.device)
    for j in range(k):                      # ascending expert id
        contrib = contrib + ye[:, j]
    contrib = contrib.reshape(b, s, d)
    if sharding.is_dtensor(x):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        pl = [Shard(1) if n == expert_axis and seq_split else
              Shard(0) if n in {f.name for f in fsdp} else Replicate()
              for n in mesh.mesh_dim_names]
        y = DTensor.from_local(contrib, mesh, pl, run_check=False)
        # placed as the activations are, by ("batch", "seq", "embed"):
        # torch 2.11's DTensor cannot flatten (batch, seq) with the sequence
        # split, which the next product's backward would have to
        want = sharding.placements(sharding.spec_for(
            tuple(y.shape), ("batch", "seq", "embed"), mesh), mesh)
        if tuple(y.placements) != want:
            y = y.redistribute(mesh, want)
        return y, sharding.replicate_like(aux, x)
    if seq_split:       # reassemble the full sequence across the expert axis
        contrib = ex.gather_whole(contrib, 1)
    for dim in reversed(fsdp):          # the batch blocks, minor axis first
        contrib = dim.gather_whole(contrib, 0)
    return contrib, aux


def apply_moe_auto(cfg, p, x):
    """The EP path when a mesh with a usable expert axis is current
    (`sharding.use_mesh`), as the reference decides; `apply_moe`
    otherwise."""
    mesh = sharding.current_mesh()
    if mesh is not None:
        sizes = sharding.mesh_sizes(mesh)
        if "model" in sizes and cfg.n_experts % sizes["model"] == 0 \
                and cfg.moe_fsdp_dim != "d_model":
            batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
            return apply_moe_ep(cfg, p, x, mesh=mesh, batch_axes=batch_axes)
    return apply_moe(cfg, p, x)
