"""Logical-axis sharding rules with divisibility fallback (port of
`repro/sharding.py`).

Code names the axes of an array *logically*; this module maps the names
onto the dims of whatever mesh is current. The mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named dims
(`launch.mesh`). A dim is split over a candidate tuple of mesh dims only if
(a) every mesh dim of the tuple exists, (b) none is already used by another
dim of the same array, and (c) the dim's size is divisible by the product
of their sizes. Otherwise the next candidate (or replication) applies.

The tenant-sharded fleet (`router.fleet.fleet_mesh_axes`) and the
expert-parallel MoE (`models.moe.apply_moe_auto`) read the mesh through
`spec_for` and `current_mesh`.

Parameters and activations are DTensors (`torch.distributed.tensor`):
`placements` turns a `spec_for` tuple into one `Shard(d)` or `Replicate()`
per mesh dim (a joint candidate such as ("pod", "data") shards its tensor
dim on both, the first mesh dim the major, as the reference's
``P(("pod", "data"))``); `named_sharding` and `tree_shardings` give a
tensor's or a tree's (mesh, placements); `distribute_tree` places a tree
whose every rank holds the same whole tensors (each rank keeps its block,
nothing is sent); `shard` is the reference's `with_sharding_constraint`.
A tree is nested dicts and lists; its logical axes are a tree of the same
structure whose leaves are tuples of axis names (`models.model.param_axes`).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

# Priority-ordered mesh-dim candidates per logical axis name. Each candidate
# is a tuple of mesh dims (split jointly).
RULES: dict = {
    # data-parallel / fsdp axes
    "batch":      (("pod", "data"), ("data",)),
    "fsdp":       (("pod", "data"), ("data",)),       # param biggest dim
    # fleet tenancy: the M axis of TenantState/FleetConfig (router.fleet)
    "tenants":    (("pod", "data"), ("data",)),
    # tensor-parallel axes
    "heads":      (("model",),),
    "kv_heads":   (("model",),),
    "mlp":        (("model",),),
    "experts":    (("model",),),
    "vocab":      (("model",), ("data",)),
    "embed":      (),                                   # activations: replicated
    "embed_fsdp": (("pod", "data"), ("data",)),        # params: fsdp on d_model
    # sequence axes
    "seq":        (),
    "cache_seq":  (("model",),),                        # decode KV/seq sharding
    "ssm_heads":  (("model",),),
    "state":      (),
    "layers":     (),
    None:         (),
}

_CTX = threading.local()


def current_mesh():
    """The mesh `use_mesh` made current in this thread, or None."""
    return getattr(_CTX, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current for logical sharding (None: no mesh, the
    one-device path)."""
    prev = getattr(_CTX, "mesh", None)
    _CTX.mesh = mesh
    try:
        yield mesh
    finally:
        _CTX.mesh = prev


def mesh_sizes(mesh) -> dict:
    """{mesh dim name: size} of a mesh with named dims."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def mesh_coords(mesh) -> dict:
    """{mesh dim name: this rank's index along it}."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh=None) -> Tuple:
    """The mesh dims each dim of ``shape`` splits over: per dim a mesh-dim
    name, a tuple of them (split jointly), or None (replicated), trailing
    Nones trimmed; () without a mesh. The greedy choice with the
    divisibility fallback of the reference's PartitionSpec."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    assert len(shape) == len(logical), (shape, logical)
    sizes = mesh_sizes(mesh)
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        assigned = None
        for cand in RULES.get(name, ()):  # type: ignore[arg-type]
            if any(a not in sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            size = math.prod(sizes[a] for a in cand)
            if dim % size != 0:
                continue
            assigned = cand if len(cand) > 1 else cand[0]
            used.update(cand)
            break
        parts.append(assigned)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


# ================================================================ DTensors
class NamedSharding(NamedTuple):
    """A tensor's place on a mesh: the mesh and one placement a mesh dim
    (the reference's `jax.sharding.NamedSharding`)."""
    mesh: object
    placements: tuple


def placements(spec: Tuple, mesh) -> tuple:
    """A `spec_for` tuple as one `Shard(d)` or `Replicate()` a mesh dim.
    A tensor dim split jointly over several mesh dims is `Shard(d)` on each
    of them; DTensor splits it over them in mesh-dim order, so the first
    (the "pod" of ("pod", "data")) is the major, as in the reference. A
    mesh dim of one rank replicates: its one block is the whole (and
    DTensor reshapes no dim sharded there)."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, part in enumerate(spec):
        for name in ((part,) if isinstance(part, str) else part or ()):
            dim_of[name] = d
    return tuple(Shard(dim_of[n]) if n in dim_of and mesh.size(i) > 1
                 else Replicate()
                 for i, n in enumerate(mesh.mesh_dim_names))


def named_sharding(shape: Sequence[int], logical: Sequence[Optional[str]],
                   mesh) -> NamedSharding:
    return NamedSharding(mesh, placements(spec_for(shape, logical, mesh),
                                          mesh))


def is_axes(a) -> bool:
    """Whether ``a`` is a leaf of a logical-axes tree: a tuple of axis
    names (None for an unnamed dim)."""
    return isinstance(a, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in a)


def map_axes(fn, tree, axes):
    """``fn(leaf, logical)`` over a tree (nested dicts and lists) and its
    logical-axes tree, keeping the structure."""
    if is_axes(axes):
        return fn(tree, axes)
    if isinstance(axes, dict):
        return {k: map_axes(fn, t, axes[k]) for k, t in tree.items()}
    return [map_axes(fn, t, a) for t, a in zip(tree, axes, strict=True)]


def tree_shardings(tree_shapes, tree_axes, mesh):
    """The `NamedSharding` of each leaf of a tree of tensors (any device,
    ``meta`` too) or shapes, given its logical-axes tree."""
    return map_axes(lambda s, ax: named_sharding(tuple(getattr(s, "shape",
                                                               s)), ax, mesh),
                    tree_shapes, tree_axes)


def distribute(x, logical, mesh):
    """``x``, whole and alike on every rank (drawn from the same seed, or
    the same batch), as a DTensor placed by its logical axes: each rank
    keeps its own block and nothing is sent (``src_data_rank=None``). It
    keeps ``x``'s ``requires_grad``."""
    from torch.distributed.tensor import distribute_tensor
    ns = named_sharding(tuple(x.shape), logical, mesh)
    return distribute_tensor(x.detach(), mesh, ns.placements,
                             src_data_rank=None).requires_grad_(
                                 x.requires_grad)


def distribute_tree(tree, tree_axes, mesh):
    """`distribute` over a tree and its logical-axes tree."""
    return map_axes(lambda t, ax: distribute(t, ax, mesh), tree, tree_axes)


def zeros(shape: Sequence[int], logical: Sequence[Optional[str]], mesh,
          dtype, device):
    """A zeroed DTensor of ``shape`` placed by its logical axes on
    ``mesh``: each rank allocates only its own block, on ``device`` (the
    ``meta`` device allocates nothing)."""
    import torch
    from torch.distributed.tensor import DTensor
    pl = placements(spec_for(tuple(shape), logical, mesh), mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    whole = torch.empty(tuple(shape), device="meta")
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, pl, run_check=False, shape=whole.shape,
                              stride=whole.stride())


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x, *logical: Optional[str]):
    """The reference's `with_sharding_constraint` by logical names: a
    DTensor redistributed to the placements `spec_for` gives on the current
    mesh (differentiable); without a mesh, or for a plain tensor, ``x``
    unchanged (the one-device path)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    want = placements(spec_for(tuple(x.shape), logical, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def replicate_like(t, ref):
    """``t``, a tensor every rank computes alike, as a `Replicate()` DTensor
    on ``ref``'s mesh when ``ref`` is a DTensor (a plain tensor cannot meet
    a DTensor in an operation); ``t`` itself otherwise."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def place_like(x, ref, logical):
    """``x``, a tensor whole and alike on every rank (an input, or built
    from the input's shape), as a DTensor placed by its logical axes on
    ``ref``'s mesh when ``ref`` is a DTensor; ``x`` itself otherwise."""
    if not is_dtensor(ref) or is_dtensor(x):
        return x
    return distribute(x, logical, ref.device_mesh)


def along(fn, x, dim: int):
    """``fn(x)`` for an ``fn`` that works along tensor dim ``dim`` alone (a
    cumsum): on a DTensor, on each rank's block, its placements kept
    (``dim`` must be whole on every rank). A DTensor's cumsum takes a flip
    in its backward, which DTensor has no rule for in some torch releases
    (2.11)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor
    dim %= x.ndim
    if any(p.is_shard(dim) or p.is_partial() for p in x.placements):
        raise ValueError(f"dim {dim} of placements {x.placements} is not "
                         "whole on every rank")
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)


def copy_into(dst, src) -> None:
    """``dst.copy_(src)`` in place (cast to ``dst``'s dtype). On a DTensor
    ``dst`` (a cache leaf, or a layer's view of one) under `local_map`:
    ``src`` goes to ``dst``'s placements (redistributed, or placed when it
    is a whole tensor) and each rank copies its own block."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    from torch.distributed.tensor.experimental import local_map
    mesh = dst.device_mesh
    pd = tuple(dst.placements)
    if not is_dtensor(src):
        src = distribute(src, (None,) * src.ndim, mesh)

    def local(d, s):
        return d.copy_(s)
    local_map(local, out_placements=list(pd), in_placements=(pd, pd),
              device_mesh=mesh, redistribute_inputs=True)(dst, src)


def block_index(mesh, pl, dim: int) -> int:
    """This rank's block index along tensor dim ``dim`` under placements
    ``pl`` (the mesh dims that split it, the first the major)."""
    idx = 0
    for i, p in enumerate(pl):
        if p.is_shard(dim):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def grad_placements(p_in: tuple, p_main: tuple) -> tuple:
    """The gradient placements of an input with placements ``p_in`` that
    every rank of a mesh dim reads whole beside a main input split over that
    dim (``p_main``): there each rank's gradient is a part of the sum,
    `Partial()`; elsewhere ``p_in``."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if m.is_shard() and not i.is_shard() else i
                 for i, m in zip(p_in, p_main))
