"""Rank functions for the port's multi-process tests.

`repro_torch.launch.hostdev.spawn_local` starts each rank in a fresh
interpreter (the ``spawn`` start method), which imports the function it
runs by module name: the functions live here, at module level, and import
nothing of JAX. Each returns numpy arrays, so the test process compares
them with its own runs.
"""
import dataclasses

import numpy as np
import torch

MOE_KEYS = ("router", "wi_gate", "wi_up", "wo")


def mixed_policies(pool, m: int, T: int):
    """`tests/test_fleet_sharded.py:mixed_cfg`'s tenants: kinds AWC, SUC,
    AIC in turn, n 3."""
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.env.llm_profiles import default_rho
    kinds = [("awc", "suc", "aic")[i % 3] for i in range(m)]
    return [PolicyConfig(kind=k, k=pool.k, n=3, rho=default_rho(pool, k, 3),
                         delta=1.0 / T) for k in kinds]


def fleet_run(m: int, T: int, seed: int, *, mesh_pods=None, ckpt_dir=None,
              ckpt_every: int = 0, plan_T=None) -> dict:
    """`simulate_fleet` of ``m`` mixed tenants on the CPU, key rows split
    from PRNGKey(seed); on a tenant mesh of every rank (``mesh_pods`` pods)
    when ``mesh_pods`` is given. ``plan_T`` sets the δ of the policies
    (default T). Returns the logs, final state and the mesh's tenant axes
    as numpy."""
    from repro_torch import prng
    from repro_torch.env.llm_profiles import paper_pool
    from repro_torch.router import fleet
    pool = paper_pool("sciq")
    cfg = fleet.fleet_config(mixed_policies(pool, m, plan_T or T),
                             device="cpu")
    keys = prng.split(prng.PRNGKey(seed, device="cpu"), m)
    mesh = axes = None
    if mesh_pods is not None:
        from repro_torch.launch.mesh import make_fleet_mesh
        mesh = make_fleet_mesh(pods=mesh_pods)
        axes = fleet.fleet_mesh_axes(m, mesh)
    res = fleet.simulate_fleet(pool, cfg, T=T, keys=keys, mesh=mesh,
                               ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                               device="cpu")
    return {"axes": list(axes) if axes else None, "t0": res.t0,
            "reward": res.reward, "cost": res.cost, "action": res.action,
            "observed": res.observed,
            "stats": {k: v.cpu().numpy() for k, v in res.state.stats.items()},
            "prev_mask": res.state.prev_mask.cpu().numpy(),
            "t": res.state.t.cpu().numpy(),
            "key": res.state.key.cpu().numpy()}


def olmoe_reduced(capacity_factor=None):
    from repro_torch.configs.base import get_config
    cfg = get_config("olmoe-1b-7b").reduced()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def moe_ep_run(path: str, mesh_shape, capacity_factors) -> list:
    """`apply_moe_ep` (and `apply_moe_auto` under `use_mesh`) of the reduced
    OLMoE layer stored at ``path`` (npz: the MoE params and x, fp32) on a
    ("data", "model") mesh of ``mesh_shape`` ranks, once a capacity
    factor. Returns [(y, aux, y_auto, aux_auto)] as numpy."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import use_mesh
    data = np.load(path)
    p = {k: torch.from_numpy(data[k]) for k in MOE_KEYS}
    x = torch.from_numpy(data["x"])
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    out = []
    with torch.no_grad():
        for cf in capacity_factors:
            cfg = olmoe_reduced(cf)
            y, aux = moe.apply_moe_ep(cfg, p, x, mesh=mesh,
                                      batch_axes=("data",))
            with use_mesh(mesh):
                y_auto, aux_auto = moe.apply_moe_auto(cfg, p, x)
            out.append((y.numpy(), float(aux), y_auto.numpy(),
                        float(aux_auto)))
    return out


def fleet_runs(specs) -> list:
    """`fleet_run` once a spec ((args, kwargs)), one after another on
    every rank."""
    return [fleet_run(*args, **kw) for args, kw in specs]


def fail_on(rank: int) -> int:
    """Raise on ``rank``; the others wait in a barrier that never ends."""
    import torch.distributed as dist
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return dist.get_rank()
