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
`spec_for` and `current_mesh`. `shard`, `named_sharding` and
`tree_shardings`, which place model parameters and activations, come with
the parameter sharding (ROADMAP A18b) and are not here yet.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple

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
