"""Multi-tenant fleet driver (paper §4, Fig. 3 — at fleet scale), on torch.

Port of `repro.router.fleet`. A tenant is one local server's bandit
instance; the fleet is a `TenantState` of (M, K) tensors plus per-tenant
`FleetConfig` scalars. One round advances every tenant at once:

    UCB/LCB -> relax.solve_batch (SUC/AIC rows together, AWC rows together)
            -> batched pairwise rounding + base-matroid padding
            -> env draws + partial feedback -> Eq.-(6) update.

`simulate_fleet` runs rounds in a Python loop on one device; its logs come
back as numpy arrays. `simulate_fleet_driven` runs the tenants through real
generation instead (`router.service.FleetService`). Every draw comes from
the tenants' own `prng` key rows, split as in the reference
(`_tenant_step`), so a tenant's trajectory does not depend on the size of
the fleet, nor on which rows share its batch.

Pod scale: the tenant axis carries the logical name "tenants"
(`TENANT_STATE_AXES` / `FLEET_CONFIG_AXES`), which `sharding.RULES` maps
onto the ("pod", "data") dims of a mesh with the divisibility fallback.
`simulate_fleet(mesh=...)` runs on every rank of the mesh's process group:
each rank takes its contiguous block of tenant rows and runs the same
per-row loop on its device (no collectives between rounds: tenants share
only the read-only pool profile), then the logs and the final state are
gathered on every rank as host copies. The run is bit-identical to the
one-device run. When M does not divide the tenant mesh dims,
`fleet_mesh_axes` returns None and the one-device path runs.

Preemption: `simulate_fleet(ckpt_dir=..., ckpt_every=...)` persists the
`TenantState` through `ckpt.checkpoint` at every multiple of
``ckpt_every`` (the checkpoint *step* is the round counter), in the
reference's layout: key rows as uint32, so either package restores the
other's checkpoints. A rerun with the same arguments resumes from the
newest checkpoint and reproduces the uninterrupted run bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch import sharding
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import confidence as cb
from repro_torch.core import relax
from repro_torch.core import rewards as R
from repro_torch.core import rounding
from repro_torch.core.policies import PolicyConfig
from repro_torch.device import resolve_device
from repro_torch.env import cost_model, feedback
from repro_torch.env.llm_profiles import Pool

AWC_IX = R.KIND_INDEX["awc"]


class FleetConfig(NamedTuple):
    """Per-tenant policy scalars, one entry per tenant (all shape (M,))."""
    kind_ix: torch.Tensor      # int32 index into rewards.KINDS
    n: torch.Tensor            # int32 matroid size
    rho: torch.Tensor          # float32 budget threshold
    delta: torch.Tensor        # float32 confidence level
    alpha_mu: torch.Tensor     # float32 reward-UCB scale
    alpha_c: torch.Tensor      # float32 cost-LCB scale
    sync_every: torch.Tensor   # int32 cloud re-coordination period (App. E.3)

    @property
    def m(self) -> int:
        return self.kind_ix.shape[0]


class TenantState(NamedTuple):
    """The whole fleet's mutable state."""
    stats: Dict[str, torch.Tensor]  # Eq.-(6) running stats, each (M, K)
    prev_mask: torch.Tensor         # (M, K) last dispatched action
    t: torch.Tensor                 # (M,) float32 rounds elapsed per tenant
    key: torch.Tensor               # (M, 2) int64 uint32-valued key rows


# Logical-axis annotations (sharding.RULES maps "tenants" -> (pod, data)).
TENANT_STATE_AXES = TenantState(
    stats={k: ("tenants", None) for k in ("mu_hat", "c_hat", "t_mu", "t_c")},
    prev_mask=("tenants", None), t=("tenants",), key=("tenants", None))
FLEET_CONFIG_AXES = FleetConfig(*((("tenants",),) * len(FleetConfig._fields)))


def fleet_mesh_axes(m: int, mesh) -> Optional[Tuple[str, ...]]:
    """The mesh dims the tenant axis splits over, or None when `spec_for`'s
    divisibility fallback leaves it replicated (M not divisible by the
    tenant mesh dims, or no data/pod dim): callers then take the
    one-device path."""
    if mesh is None:
        return None
    spec = sharding.spec_for((m,), ("tenants",), mesh)
    if not spec:
        return None
    ax = spec[0]
    return ax if isinstance(ax, tuple) else (ax,)


def fleet_config(pcfgs: Sequence[PolicyConfig], sync_every=1,
                 device="cuda") -> FleetConfig:
    """Pack per-tenant PolicyConfigs into the flat fleet layout.

    ``sync_every`` is an int shared by all tenants or a length-M sequence."""
    dev = resolve_device(device)
    m = len(pcfgs)
    ks = {p.k for p in pcfgs}
    if len(ks) != 1:
        raise ValueError(f"all tenants must share the replica pool size, "
                         f"got k in {sorted(ks)}")
    sync = np.full(m, sync_every) if np.isscalar(sync_every) else \
        np.asarray(sync_every)
    if sync.shape != (m,):
        raise ValueError(f"sync_every must be a scalar or length-{m} "
                         f"sequence, got shape {sync.shape}")

    def col(values, dtype):
        return torch.tensor(np.asarray(values), dtype=dtype, device=dev)

    return FleetConfig(
        kind_ix=col([R.KIND_INDEX[p.kind] for p in pcfgs], torch.int32),
        n=col([p.n for p in pcfgs], torch.int32),
        rho=col(np.asarray([p.rho for p in pcfgs], np.float32), torch.float32),
        delta=col(np.asarray([p.delta for p in pcfgs], np.float32),
                  torch.float32),
        alpha_mu=col(np.asarray([p.alpha_mu for p in pcfgs], np.float32),
                     torch.float32),
        alpha_c=col(np.asarray([p.alpha_c for p in pcfgs], np.float32),
                    torch.float32),
        sync_every=col(sync, torch.int32))


def init_tenant_state(m: int, k: int, keys: Optional[torch.Tensor] = None,
                      seed: int = 0, device="cuda") -> TenantState:
    """Zero statistics and per-tenant key rows: ``keys`` (M, 2) int64 (see
    `prng`; `convert.key_rows` turns uint32 rows into these), copied, or
    split from PRNGKey(seed)."""
    dev = resolve_device(device)
    if keys is None:
        keys = prng.split(prng.PRNGKey(seed, device=dev), m)
    return TenantState(stats=cb.init_stats_batch(m, k, dev),
                       prev_mask=torch.zeros((m, k), dtype=torch.float32,
                                             device=dev),
                       t=torch.zeros((m,), dtype=torch.float32, device=dev),
                       key=keys.to(device=dev, dtype=torch.int64).clone())


# ================================================================= per-tenant
def relaxed_batch(stats, t, cfg: FleetConfig, engine: Optional[str] = None,
                  fw_steps: Optional[int] = None,
                  lowering: Optional[str] = None,
                  fw_warm: Optional[bool] = None):
    """Batched §4.1 local-server step: stats (M, K), t (M,) -> z̃ (M, K).

    This is what a local-server pod calls per sync round; the cloud side
    then discretizes with `cloud.round_batch`. ``engine`` selects the
    parametric-LP engine (None: `relax.DEFAULT_ENGINE`), ``lowering`` the
    grid engine's lowering (None: `relax.DEFAULT_LOWERING`, "wide"),
    ``fw_steps`` the AWC Frank-Wolfe step count (None: `relax.FW_STEPS`)
    and ``fw_warm`` the tail lowering's warm start (None: `relax.FW_WARM`)."""
    mu_bar = cb.reward_ucb(stats, t, cfg.delta, cfg.alpha_mu)
    c_low = cb.cost_lcb(stats, t, cfg.delta, cfg.alpha_c)
    return relax.solve_batch(cfg.kind_ix, mu_bar, c_low, cfg.n, cfg.rho,
                             engine=engine, fw_steps=fw_steps,
                             lowering=lowering, fw_warm=fw_warm)


def _tenant_act(stats, t, key, cfg: FleetConfig, rows=None,
                engine: Optional[str] = None,
                fw_steps: Optional[int] = None):
    """§4.1 + §4.2 for every row: UCB/LCB -> relaxed solve -> pairwise
    rounding -> base-matroid padding. stats (M, K), t (M,), key (M, 2)
    -> action masks (M, K). ``rows`` may carry `relax.kind_rows(cfg.kind_ix)`
    computed once; ``engine`` and ``fw_steps`` are `relax.solve_batch`'s
    (None: `relax.DEFAULT_ENGINE`, `relax.FW_STEPS`)."""
    mu_bar = cb.reward_ucb(stats, t, cfg.delta, cfg.alpha_mu)
    c_low = cb.cost_lcb(stats, t, cfg.delta, cfg.alpha_c)
    z = relax.solve_batch(cfg.kind_ix, mu_bar, c_low, cfg.n, cfg.rho, rows,
                          engine=engine, fw_steps=fw_steps)
    mask = rounding.pairwise_round_batch(z, key)
    mask = rounding.pad_to_n_dyn(mask, mu_bar, cfg.n, cfg.kind_ix != AWC_IX)
    return mask


def _tenant_step(state: TenantState, t: int, mu, mean_cost, levels,
                 cfg: FleetConfig, rows, sync_rows: np.ndarray,
                 engine: Optional[str] = None,
                 fw_steps: Optional[int] = None):
    """One protocol round (round number ``t``) for every tenant.

    ``rows`` is `relax.kind_rows(cfg.kind_ix)`; ``sync_rows`` (host bool
    (M,)) marks the tenants whose action is re-coordinated this round, the
    others repeat their previous action."""
    ks = prng.split(state.key, 4)
    key, ka, kr, kc = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
    t_row = torch.full_like(state.t, float(t))
    if sync_rows.any():
        act = _tenant_act(state.stats, t_row, ka, cfg, rows, engine, fw_steps)
        if sync_rows.all():
            mask = act
        else:
            sync = torch.as_tensor(sync_rows, device=act.device)
            mask = torch.where(sync[:, None], act, state.prev_mask)
    else:
        mask = state.prev_mask
    x = cost_model.sample_rewards(kr, mu, levels)
    y = cost_model.sample_costs(kc, mean_cost)
    obs = feedback.observe_ix(cfg.kind_ix, mask, x, mean_cost) \
        if rows[1].numel() else mask     # no AWC row: F_t = S_t throughout
    stats = cb.update_stats(state.stats, obs, x, y)
    exp_reward = R.set_reward_ix(cfg.kind_ix, mask, mu)
    cost_t = torch.sum(y * obs, dim=-1)           # Eq. (1) charges F_t
    new = TenantState(stats=stats, prev_mask=mask, t=t_row, key=key)
    return new, (exp_reward, cost_t, mask, obs)


# ================================================================== fleet run
@dataclasses.dataclass
class FleetResult:
    reward: np.ndarray     # (M, T) expected set reward r(S_t; μ)
    cost: np.ndarray       # (M, T) realized budget-accounted cost
    action: np.ndarray     # (M, T, K) dispatched masks
    observed: np.ndarray   # (M, T, K) feedback masks
    state: TenantState     # final fleet state (see `simulate_fleet`)
    t0: int = 0            # first round is t0+1 (resumed runs: > 0)


def _ckpt_bounds(t0: int, T: int, ckpt_every: int) -> list:
    """Segment boundaries [t0, ..., T]: every interior boundary is a
    multiple of ``ckpt_every``, where a checkpoint is written, so a resumed
    run meets the same boundaries as an uninterrupted one."""
    bounds = [t0]
    if ckpt_every > 0:
        bounds += list(range((t0 // ckpt_every + 1) * ckpt_every, T + 1,
                             ckpt_every))
    if bounds[-1] != T:
        bounds.append(T)
    return bounds


def _state_to(state: TenantState, dev) -> TenantState:
    return TenantState(stats={k: v.to(dev) for k, v in state.stats.items()},
                       prev_mask=state.prev_mask.to(dev), t=state.t.to(dev),
                       key=state.key.to(dev))


def _rows_of(state: TenantState, rows: slice) -> TenantState:
    return TenantState(stats={k: v[rows] for k, v in state.stats.items()},
                       prev_mask=state.prev_mask[rows], t=state.t[rows],
                       key=state.key[rows])


def _ckpt_tree(state: TenantState) -> TenantState:
    """The state as the reference checkpoints it: host float32 arrays and
    uint32 key rows."""
    def f32(x):
        return x.detach().cpu().numpy().astype(np.float32)
    return TenantState(stats={k: f32(v) for k, v in state.stats.items()},
                       prev_mask=f32(state.prev_mask), t=f32(state.t),
                       key=state.key.cpu().numpy().astype(np.uint32))


def _restore_state(ckpt_dir: str, like: TenantState, step: int, dev):
    tree, step = ckpt.restore(ckpt_dir, _ckpt_tree(like), step=step)
    return TenantState(
        stats={k: torch.from_numpy(v.copy()).to(dev)
               for k, v in tree.stats.items()},
        prev_mask=torch.from_numpy(tree.prev_mask.copy()).to(dev),
        t=torch.from_numpy(tree.t.copy()).to(dev),
        key=torch.from_numpy(tree.key.astype(np.int64)).to(dev)), step


class _TenantBlocks:
    """This rank's block of tenant rows on a mesh, and the gathers that put
    the blocks back together on every rank (host copies: gloo moves host
    tensors; the ranks of one GPU share it through them)."""

    def __init__(self, m: int, mesh, axes: Tuple[str, ...]):
        import torch.distributed as dist
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        sizes = [int(mesh.shape[d]) for d in dims]
        self.n_blocks = math.prod(sizes)
        self.size = m // self.n_blocks
        self.world = dist.get_world_size()
        grid = mesh.mesh.reshape(tuple(int(s) for s in mesh.shape))
        # block of every rank: its coordinates on ``axes``, row-major
        self.block_of = {}
        for coord in np.ndindex(*grid.shape):
            blk = 0
            for d, n in zip(dims, sizes):
                blk = blk * n + coord[d]
            self.block_of[int(grid[coord])] = blk
        if sorted(self.block_of) != list(range(self.world)):
            raise ValueError("the mesh must hold every rank of the process "
                             "group once")
        blk = self.block_of[dist.get_rank()]
        self.rows = slice(blk * self.size, (blk + 1) * self.size)
        # the first rank holding each block (others on the remaining mesh
        # dims hold a replica of it)
        self.source = {}
        for r in range(self.world):
            self.source.setdefault(self.block_of[r], r)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(rows of this block, ...) -> (M, ...) on the host, on every
        rank."""
        import torch.distributed as dist
        x = x.detach().cpu().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat([parts[self.source[b]]
                          for b in range(self.n_blocks)])

    def gather_state(self, state: TenantState) -> TenantState:
        return TenantState(
            stats={k: self.gather(v) for k, v in state.stats.items()},
            prev_mask=self.gather(state.prev_mask), t=self.gather(state.t),
            key=self.gather(state.key))


def simulate_fleet(pool: Pool, cfg: FleetConfig, *, T: int,
                   keys: Optional[torch.Tensor] = None, seed: int = 0,
                   state: Optional[TenantState] = None,
                   engine: Optional[str] = None,
                   fw_steps: Optional[int] = None,
                   mesh=None, ckpt_dir: Optional[str] = None,
                   ckpt_every: int = 0, resume: bool = True,
                   device="cuda") -> FleetResult:
    """Advance M tenants against the shared pool on ``device``.

    ``keys`` (M, 2) are the tenants' key rows (default: split from
    PRNGKey(seed)). Without ``state`` the run plays rounds 1..T. ``state``
    continues a fleet from a given TenantState instead, for T further
    rounds (its ``t`` gives the rounds already run). ``engine`` selects the
    parametric-LP engine (None: `relax.DEFAULT_ENGINE`; "bisect" is the
    sequential reference path), ``fw_steps`` the AWC Frank-Wolfe step count
    (None: `relax.FW_STEPS`). The reference's ``unroll`` sets how its scan
    is lowered; an eager loop has nothing to unroll, so there is none.

    ``mesh`` (a DeviceMesh, `launch.mesh.make_fleet_mesh`; call on every
    rank of its process group) splits the tenant rows over its (pod, data)
    dims, each rank running its block on ``device``; the logs and the final
    state come back whole on every rank, the state as host tensors. When M
    does not divide those dims the one-device path runs.

    ``ckpt_dir`` / ``ckpt_every`` persist the state every ``ckpt_every``
    rounds (the checkpoint step is the round counter; on a mesh rank 0
    writes the whole state). With ``resume`` (the default) a run without
    ``state`` picks up from the newest checkpoint under ``ckpt_dir`` and
    plays the remaining rounds t0+1..T (``FleetResult.t0`` marks the resume
    point), bit-identical to those of an uninterrupted run; a checkpoint
    past T raises. ``state`` with a resuming ``ckpt_dir`` raises: the two
    would give T two meanings."""
    dev = resolve_device(device)
    cfg = FleetConfig(*(f.to(dev) for f in cfg))
    m = cfg.m
    t0 = 0
    if state is None:
        state = init_tenant_state(m, pool.k, keys=keys, seed=seed, device=dev)
        last = T
        if ckpt_dir and resume:
            latest = ckpt.latest_step(ckpt_dir)
            if latest is not None:
                state, t0 = _restore_state(ckpt_dir, state, latest, dev)
                if t0 > T:
                    raise ValueError(f"checkpoint at round {t0} is past "
                                     f"T={T}")
    else:
        if ckpt_dir and resume:
            raise ValueError("state= continues a fleet for T further rounds; "
                             "a resuming ckpt_dir makes T the last round. "
                             "Pass resume=False to checkpoint a continued "
                             "fleet")
        state = _state_to(state, dev)
        t0 = int(state.t.max().item()) if m else 0
        last = t0 + T
    axes = fleet_mesh_axes(m, mesh)
    # a one-rank mesh holds every row: the one-device path
    blocks = _TenantBlocks(m, mesh, axes) \
        if axes is not None and mesh.size() > 1 else None
    if blocks is not None:
        cfg = FleetConfig(*(f[blocks.rows] for f in cfg))
        state = _rows_of(state, blocks.rows)
    mu = torch.tensor(pool.mu, dtype=torch.float32, device=dev)
    mean_cost = torch.tensor(pool.mean_cost, dtype=torch.float32, device=dev)
    levels = tuple(pool.reward_levels)
    rows = relax.kind_rows(cfg.kind_ix)
    sync_every = cfg.sync_every.cpu().numpy()
    every = ckpt_every if ckpt_dir else 0
    logs = []
    bounds = _ckpt_bounds(t0, last, every)
    for a, b in zip(bounds[:-1], bounds[1:]):
        for t in range(a + 1, b + 1):
            state, out = _tenant_step(state, t, mu, mean_cost, levels, cfg,
                                      rows, (t - 1) % sync_every == 0,
                                      engine, fw_steps)
            logs.append(out)
        if every > 0 and b % every == 0:
            _checkpoint(ckpt_dir, b, state, blocks, mesh)
    n_rows = state.t.shape[0]
    if logs:
        rew, cost, act, obs = (torch.stack(parts, dim=1)
                               for parts in zip(*logs))
    else:       # resumed at the last round: nothing left to run
        rew = cost = torch.zeros((n_rows, 0))
        act = obs = torch.zeros((n_rows, 0, pool.k))
    if blocks is not None:
        rew, cost, act, obs = (blocks.gather(x) for x in (rew, cost, act, obs))
        state = blocks.gather_state(state)
    rew, cost, act, obs = (x.cpu().numpy() for x in (rew, cost, act, obs))
    return FleetResult(reward=rew, cost=cost, action=act, observed=obs,
                       state=state, t0=t0)


def _checkpoint(ckpt_dir: str, step: int, state: TenantState,
                blocks: Optional[_TenantBlocks], mesh) -> None:
    """Save the whole state at ``step``. On a mesh of several ranks the
    blocks are gathered (every rank holds the whole state when the tenant
    rows were not split), rank 0 writes, and every rank waits for the
    file."""
    import torch.distributed as dist
    ranks = (mesh is not None and dist.is_initialized()
             and dist.get_world_size() > 1)
    whole = blocks.gather_state(state) if blocks is not None else state
    if not ranks or dist.get_rank() == 0:
        ckpt.save(ckpt_dir, step, _ckpt_tree(whole))
    if ranks:
        dist.barrier()


def simulate_fleet_driven(pcfgs: Sequence[PolicyConfig], cloud, data, *,
                          T: int, prompt_len: int = 8, max_new: int = 8,
                          n_slots: int = 32, chunk: int = 8, seed: int = 0,
                          **service_kw) -> FleetResult:
    """Fleet rounds driven by generation: real engines instead of the
    synthetic feedback path.

    M tenants run through `router.service.FleetService` against a live
    `SchedulingCloud`: every round each tenant's selected arms become
    generation requests, the shared continuous-batching scheduler
    coalesces them into per-replica decode batches, and measured output
    quality and realized token costs feed the Eq.-(6) updates. ``reward``
    is the mean observed quality per round (the synthetic path reports the
    expected set reward: comparable in trend, not in value). ``state``
    carries the tenants' statistics and their real key rows, on the
    cloud's device. ``service_kw`` passes through to `FleetService`
    (``fault_plan=`` / ``health=`` run the fleet under chaos)."""
    from repro_torch.router.service import FleetService   # avoids a cycle
    fs = FleetService(list(pcfgs), cloud, data, n_slots=n_slots, chunk=chunk,
                      seed=seed, prompt_len=prompt_len, max_new=max_new,
                      **service_kw)
    m, k = len(fs.tenants), pcfgs[0].k
    reward = np.zeros((m, T))
    cost = np.zeros((m, T))
    action = np.zeros((m, T, k), bool)
    observed = np.zeros((m, T, k), bool)
    for t in range(T):
        for i, log in enumerate(fs.step()):
            reward[i, t] = log.rewards[log.observed].mean() \
                if log.observed.any() else 0.0
            cost[i, t] = log.cost
            action[i, t] = log.action
            observed[i, t] = log.observed
    dev = cloud.device
    prev_mask = np.asarray(action[:, -1], np.float32) if T > 0 \
        else np.zeros((m, k), np.float32)       # T = 0: no round to look at
    locals_ = [s.local.state for s in fs.tenants]
    state = TenantState(
        stats={key: torch.cat([st.stats[key] for st in locals_])
               for key in locals_[0].stats},
        prev_mask=torch.as_tensor(prev_mask, device=dev),
        t=torch.cat([st.t for st in locals_]),
        # the tenants' real key rows: a synthetic continuation from this
        # state must not collapse onto PRNGKey(0)
        key=torch.cat([st.key for st in locals_]))
    return FleetResult(reward=reward, cost=cost, action=action,
                       observed=observed, state=state)
