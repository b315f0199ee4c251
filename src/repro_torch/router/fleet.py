"""Multi-tenant fleet driver (paper §4, Fig. 3 — at fleet scale), on torch.

Port of `repro.router.fleet` without its mesh and checkpointing. A tenant is
one local server's bandit instance; the fleet is a `TenantState` of (M, K)
tensors plus per-tenant `FleetConfig` scalars. One round advances every
tenant at once:

    UCB/LCB -> relax.solve_batch (SUC/AIC rows together, AWC rows together)
            -> batched pairwise rounding + base-matroid padding
            -> env draws + partial feedback -> Eq.-(6) update.

`simulate_fleet` runs T such rounds in a Python loop on one device; its
logs come back as numpy arrays. `simulate_fleet_driven` runs the tenants
through real generation instead (`router.service.FleetService`). Every draw comes from the tenants' own
`prng` key rows, split as in the reference (`_tenant_step`), so a tenant's
trajectory does not depend on the size of the fleet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
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


def _tenant_act(stats, t, key, cfg: FleetConfig, rows=None):
    """§4.1 + §4.2 for every row: UCB/LCB -> relaxed solve -> pairwise
    rounding -> base-matroid padding. stats (M, K), t (M,), key (M, 2)
    -> action masks (M, K). ``rows`` may carry `relax.kind_rows(cfg.kind_ix)`
    computed once."""
    mu_bar = cb.reward_ucb(stats, t, cfg.delta, cfg.alpha_mu)
    c_low = cb.cost_lcb(stats, t, cfg.delta, cfg.alpha_c)
    z = relax.solve_batch(cfg.kind_ix, mu_bar, c_low, cfg.n, cfg.rho, rows)
    mask = rounding.pairwise_round_batch(z, key)
    mask = rounding.pad_to_n_dyn(mask, mu_bar, cfg.n, cfg.kind_ix != AWC_IX)
    return mask


def _tenant_step(state: TenantState, t: int, mu, mean_cost, levels,
                 cfg: FleetConfig, rows, sync_rows: np.ndarray):
    """One protocol round (round number ``t``) for every tenant.

    ``rows`` is `relax.kind_rows(cfg.kind_ix)`; ``sync_rows`` (host bool
    (M,)) marks the tenants whose action is re-coordinated this round, the
    others repeat their previous action."""
    ks = prng.split(state.key, 4)
    key, ka, kr, kc = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
    t_row = torch.full_like(state.t, float(t))
    if sync_rows.any():
        act = _tenant_act(state.stats, t_row, ka, cfg, rows)
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
    state: TenantState     # final fleet state (tensors on the device)


def simulate_fleet(pool: Pool, cfg: FleetConfig, *, T: int,
                   keys: Optional[torch.Tensor] = None, seed: int = 0,
                   state: Optional[TenantState] = None,
                   device="cuda") -> FleetResult:
    """Advance M tenants T rounds against the shared pool on ``device``.

    ``keys`` (M, 2) are the tenants' key rows (default: split from
    PRNGKey(seed)); ``state`` continues a fleet from a given TenantState
    instead (its ``t`` gives the rounds already run)."""
    dev = resolve_device(device)
    cfg = FleetConfig(*(f.to(dev) for f in cfg))
    m = cfg.m
    if state is None:
        state = init_tenant_state(m, pool.k, keys=keys, seed=seed, device=dev)
        t0 = 0
    else:
        state = TenantState(stats={k: v.to(dev) for k, v in
                                   state.stats.items()},
                            prev_mask=state.prev_mask.to(dev),
                            t=state.t.to(dev), key=state.key.to(dev))
        t0 = int(state.t.max().item()) if m else 0
    mu = torch.tensor(pool.mu, dtype=torch.float32, device=dev)
    mean_cost = torch.tensor(pool.mean_cost, dtype=torch.float32, device=dev)
    levels = tuple(pool.reward_levels)
    rows = relax.kind_rows(cfg.kind_ix)
    sync_every = cfg.sync_every.cpu().numpy()
    logs = []
    for t in range(t0 + 1, t0 + T + 1):
        state, out = _tenant_step(state, t, mu, mean_cost, levels, cfg,
                                  rows, (t - 1) % sync_every == 0)
        logs.append(out)
    if logs:
        rew, cost, act, obs = (torch.stack(parts, dim=1).cpu().numpy()
                               for parts in zip(*logs))
    else:
        rew = cost = np.zeros((m, 0), np.float32)
        act = obs = np.zeros((m, 0, pool.k), np.float32)
    return FleetResult(reward=rew, cost=cost, action=act, observed=obs,
                       state=state)


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
