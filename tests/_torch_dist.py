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


# ======================================================= parameter sharding
def sharded_steps(steps, moe_grad, attn, mesh_shape=(2, 2)) -> dict:
    """The sharding tests' rank function, on a ("data", "model") mesh of
    ``mesh_shape`` ranks (CPU, gloo):

    * ``steps``: [(arch name, capacity factor or None, params, AdamW
      kwargs, [batch, ...])]: the params (port trees from JAX's weights)
      placed by `param_axes`, `init_adamw` of them, then one sharded
      `make_train_step` (remat) a batch. Returns the losses and grad
      norms, the final params whole, and the placements of each
      DTensor leaf's state (m, v, master against the param's).
    * ``moe_grad``: (params, x, w) of the reduced OLMoE layer at capacity
      64, whole on every rank: `apply_moe_ep`'s y, aux and this rank's
      gradients of (y · w).sum() + aux; and `apply_moe`'s on DTensors
      placed by `moe_schema`'s axes (whole).
    * ``attn``: [(q, k, v, causal, impl, window)]: `attention.attend` of
      DTensors placed by the reference's q / kv axes (impl "auto": through
      `ops.flash_attention`; the plain routes on the "model" dim's 1-D
      mesh), gathered whole, and the gradients of (o · cot).sum() for
      cot = q's values, whole.

    Also `shard` (a redistribute under `use_mesh`, a no-op without) and
    `make_production_mesh` on a group of the wrong size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import sharding
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import attention
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    out = {"rank": dist.get_rank(), "steps": []}

    def whole(t):
        return (t.full_tensor() if sharding.is_dtensor(t) else t
                ).detach().numpy()

    for arch, cf, params, okw, batches in steps:
        cfg = get_config(arch).reduced()
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        ocfg = opt.AdamWConfig(**okw)
        step = ts.make_train_step(cfg, ocfg, remat=True, device="cpu")
        with sharding.use_mesh(mesh):
            p = sharding.distribute_tree(params, M.param_axes(cfg), mesh)
            st = opt.init_adamw(ocfg, p)
            state_placed = all(
                tuple(s.placements) == tuple(q.placements)
                for part in ("m", "v", "master")
                for s, q in zip(opt.tree_leaves(st[part]),
                                opt.tree_leaves(p)))
            losses, norms = [], []
            for batch in batches:
                p, st, m = step(p, st, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            out["steps"].append({
                "arch": arch, "losses": losses, "grad_norms": norms,
                "params": [whole(t) for t in opt.tree_leaves(p)],
                "state_placed": state_placed,
                "dtensor": all(sharding.is_dtensor(t)
                               for t in opt.tree_leaves(p))})

    mp, x, w = moe_grad
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              capacity_factor=64.0)
    mp = {k: v.clone().requires_grad_() for k, v in mp.items()}
    x = x.clone().requires_grad_()
    y, aux = moe.apply_moe_ep(cfg, mp, x, mesh=mesh, batch_axes=("data",))
    grads = torch.autograd.grad((y * w).sum() + aux, [x, *mp.values()])
    out["moe"] = (y.detach().numpy(), float(aux),
                  [g.numpy() for g in grads])
    # `apply_moe` itself on DTensors (the path of a config the EP path
    # does not take, as Arctic's d_model-sharded experts)
    with sharding.use_mesh(mesh):
        dp = {k: sharding.distribute(v, ax, mesh).requires_grad_()
              for (k, v), ax in zip(mp.items(), (
                  s.axes for s in moe.moe_schema(cfg).values()))}
        dx = sharding.distribute(x, ("batch", "seq", "embed"),
                                 mesh).requires_grad_()
        dw = sharding.distribute(w, ("batch", "seq", "embed"), mesh)
        y, aux = moe.apply_moe(cfg, dp, dx)
        grads = torch.autograd.grad((y * dw).sum() + aux,
                                    [dx, *dp.values()])
        out["moe_dtensor"] = (whole(y), float(whole(aux)),
                              [whole(g) for g in grads])

    out["attn"] = []
    for q, k, v, causal, impl, window in attn:
        # the plain routes on DTensors run on the 1-D "model" mesh:
        # DTensor's op rules on a 2-D one cost seconds an op here
        on = mesh if impl == "auto" else mesh["model"]
        qkv = [sharding.distribute(t, ax, on).requires_grad_()
               for t, ax in
               ((q, ("batch", "seq", "heads", None)),
                (k, ("batch", "seq", "kv_heads", None)),
                (v, ("batch", "seq", "kv_heads", None)))]
        o = attention.attend(*qkv, causal=causal, window=window, impl=impl)
        cot = sharding.place_like(q, qkv[0], ("batch", "seq", "heads", None))
        gq, gk, gv = torch.autograd.grad((o * cot).sum(), qkv)
        out["attn"].append((whole(o), whole(gq), whole(gk), whole(gv),
                            [str(p) for p in qkv[0].placements],
                            [str(p) for p in qkv[1].placements]))

    x = torch.arange(16.0).reshape(4, 4)
    plain = sharding.shard(x, "batch", None)
    dx = sharding.distribute(x, (None, None), mesh)
    with sharding.use_mesh(mesh):
        moved = sharding.shard(dx, "batch", None)
    out["shard"] = (plain is x, sharding.shard(dx, "batch", None) is dx,
                    [str(p) for p in moved.placements],
                    whole(moved).tolist(), moved.to_local().tolist())
    try:
        mesh_mod.make_production_mesh()
        out["production"] = None
    except ValueError as e:
        out["production"] = str(e)
    return out



# =========================================================== sharded serving
def sharded_serving(cases, mesh_shape=(2, 2)) -> dict:
    """The sharded serving test's rank function, on a ("data", "model")
    mesh of ``mesh_shape`` ranks (CPU, gloo). ``cases``: [(arch, capacity
    factor or None, params, inputs, max_len, [tokens (B, 1), ...], [pos
    (B,), ...])]: the params (port trees from JAX's weights) placed by
    `param_axes`, `prefill` and one `decode_step` a token row at its pos.
    Returns per case the logits (prefill's, then each step's) and the
    final cache, whole, the cache's placements, whether every leaf is a
    DTensor, and how many `decode_attention_lse` calls (one a rank per
    attention layer a step whose cache splits T) the steps made."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import sharding
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    lse_calls = [0]
    plain_lse = ops.decode_attention_lse

    def counted(*args):
        lse_calls[0] += 1
        return plain_lse(*args)
    ops.decode_attention_lse = counted

    def whole(t):
        return (t.full_tensor() if sharding.is_dtensor(t) else t
                ).detach().numpy()

    out = {"rank": dist.get_rank(), "cases": []}
    for arch, cf, params, inputs, max_len, toks, poss in cases:
        cfg = get_config(arch).reduced()
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        lse_calls[0] = 0
        with torch.no_grad(), sharding.use_mesh(mesh):
            p = sharding.distribute_tree(params, M.param_axes(cfg), mesh)
            last, cache = M.prefill(cfg, p, inputs, max_len, device="cpu")
            logits = [whole(last)]
            for tok, pos in zip(toks, poss):
                lg, cache = M.decode_step(cfg, p, tok, cache,
                                          torch.as_tensor(pos),
                                          device="cpu")
                logits.append(whole(lg)[:, 0])
        leaves = opt.tree_leaves(cache)
        out["cases"].append({
            "arch": arch, "logits": logits,
            "cache": opt.tree_map(whole, cache),
            "placements": opt.tree_map(
                lambda t: " ".join(str(x) for x in t.placements)
                if sharding.is_dtensor(t) else None, cache),
            "dtensor": all(sharding.is_dtensor(t) for t in leaves),
            "lse_calls": lse_calls[0]})
    ops.decode_attention_lse = plain_lse
    return out
