"""Meshes for the port, and the fleet's mesh smoke (port of
`repro/launch/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims,
over the ranks of the current process group (`launch.hostdev.spawn_local`
starts N local ranks). Its device type follows the group's backend: "cpu"
for gloo, whose collectives move host tensors (ranks that share a GPU
exchange host copies), "cuda" for NCCL. The mesh lays out the ranks; where
a rank computes is the ``device=`` of the function it runs.

Run as a module this is the fleet's mesh smoke: N ranks advance a small
fleet through the tenant-sharded path and check it bit for bit against the
one-device run; the command exits non-zero unless they agree:

  python -m repro_torch.launch.mesh --devices 2 --tenants 64 --rounds 32 \\
      [--pods 2] [--workload mixed] [--ckpt-dir D --ckpt-every 16] \\
      [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given. The production
meshes (`make_production_mesh`) are the reference's: 16 × 16 ("data",
"model") and 2 × 16 × 16 ("pod", "data", "model"), over a process group of
256 or 512 ranks (`launch.train --mesh pod256|pod512`).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def _mesh(shape: Sequence[int], names: Sequence[str]):
    """A DeviceMesh of ``shape`` over ranks 0..N-1 in row-major order. A
    one-rank mesh needs no process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    ranks = torch.arange(n).reshape(tuple(shape))
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a process group of {n} ranks "
                "(launch.hostdev.spawn_local)")
        return DeviceMesh("cpu", ranks, mesh_dim_names=tuple(names),
                          _init_backend=False, _rank=0)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a mesh of {n} ranks on a process group of "
                         f"{world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the process group's ranks:
    (16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``. Any other group size raises (`_mesh`)."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_cpu_mesh():
    """The degenerate one-rank ("data", "model") mesh of the one-device
    paths (`launch.train --mesh cpu`)."""
    return _mesh((1, 1), ("data", "model"))


def make_fleet_mesh(n_devices: int = 0, *, pods: int = 1):
    """Tenant mesh for the sharded fleet (`router.fleet`): every rank on the
    ("pod", "data") dims the "tenants" logical axis splits over.
    ``n_devices`` 0 takes the process group's size."""
    import torch.distributed as dist
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if pods > 1:
        if n % pods:
            raise ValueError(f"{n} devices don't split into {pods} pods")
        return _mesh((pods, n // pods), ("pod", "data"))
    return _mesh((n,), ("data",))


def n_chips(mesh) -> int:
    return int(mesh.size())


# ============================================================ fleet smoke
def _fleet_inputs(tenants: int, rounds: int, workload: str, seed: int,
                  device):
    from repro_torch import prng
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.env.llm_profiles import default_rho, paper_pool
    from repro_torch.router import fleet
    pool = paper_pool("sciq")
    kinds = [("awc", "suc", "aic")[i % 3] for i in range(tenants)] \
        if workload == "mixed" else [workload] * tenants
    pcfgs = [PolicyConfig(kind=k, k=pool.k, n=4,
                          rho=default_rho(pool, k, 4), delta=1.0 / rounds)
             for k in kinds]
    cfg = fleet.fleet_config(pcfgs, device=device)
    keys = prng.split(prng.PRNGKey(seed, device=device), tenants)
    return pool, cfg, keys


def fleet_smoke(n_devices: int, tenants: int, rounds: int, *, pods: int = 1,
                workload: str = "mixed", ckpt_dir=None, ckpt_every: int = 0,
                seed: int = 0, device="cuda") -> dict:
    """Sharded fleet run on this rank's mesh, checked against the one-device
    run on the same rank. Returns a summary record (the CLI prints rank
    0's as JSON). Call on every rank of a process group."""
    import time

    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.router import fleet
    dev = resolve_device(device)
    pool, cfg, keys = _fleet_inputs(tenants, rounds, workload, seed, dev)
    mesh = make_fleet_mesh(n_devices, pods=pods)
    axes = fleet.fleet_mesh_axes(tenants, mesh)

    t0 = time.perf_counter()
    sharded = fleet.simulate_fleet(pool, cfg, T=rounds, keys=keys, mesh=mesh,
                                   ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                                   device=dev)
    dt_sharded = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = fleet.simulate_fleet(pool, cfg, T=rounds, keys=keys, device=dev)
    dt_single = time.perf_counter() - t0

    def host(x):
        return x.cpu().numpy()

    bit_equal = (
        np.array_equal(sharded.action, ref.action[:, sharded.t0:])
        and np.array_equal(sharded.observed, ref.observed[:, sharded.t0:])
        and np.array_equal(sharded.cost, ref.cost[:, sharded.t0:])
        and all(np.array_equal(host(sharded.state.stats[n]),
                               host(ref.state.stats[n]))
                for n in ref.state.stats)
        and np.array_equal(host(sharded.state.key), host(ref.state.key)))
    return {"devices": n_chips(mesh), "pods": pods, "tenants": tenants,
            "rounds": rounds, "workload": workload,
            "tenant_axes": list(axes) if axes else None,
            "sharded": axes is not None, "bit_equal": bool(bit_equal),
            "rps_sharded": round(tenants * rounds / dt_sharded, 1),
            "rps_single": round(tenants * rounds / dt_single, 1)}


def _main(argv=None):
    import argparse
    import functools
    import json

    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as this   # importable by the ranks
    from repro_torch.launch.hostdev import spawn_local

    ap = argparse.ArgumentParser(description="fleet mesh smoke")
    ap.add_argument("--devices", type=int, default=1,
                    help="local ranks to start (spawn_local)")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--tenants", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--workload", default="mixed",
                    choices=["awc", "suc", "aic", "mixed"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":      # built once here, not raced by the ranks
        from repro_torch.kernels import ops
        ops.build(["topn_lp", "awc_fw"])
    run = functools.partial(this.fleet_smoke, pods=args.pods,
                            workload=args.workload, ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every, seed=args.seed,
                            device=args.device)
    recs = spawn_local(args.devices, run, args.devices, args.tenants,
                       args.rounds)
    rec = recs[0]
    print(json.dumps(rec))
    if not all(r["bit_equal"] for r in recs):
        raise SystemExit("sharded fleet diverged from the single-device "
                         "reference")
    return rec


if __name__ == "__main__":
    _main()
