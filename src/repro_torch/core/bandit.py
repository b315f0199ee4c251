"""Bandit simulation on torch: seeds as rows, one protocol round a step.

Port of `repro.core.bandit`. One step = one protocol round (paper §3
Online Learning Protocol): local server act() -> cloud rounds to S_t ->
env draws X_t, y_t -> partial feedback F_t -> Eq.(6) update.

The paper's own policy (`simulate("c2mabv")`) runs each seed as one tenant
of a uniform fleet (`router.fleet`); ``use_fleet=False``, any other policy
of `core.policies`, or policy arguments take the per-seed loop below, whose
seeds are the rows of one batch. Either way seed i's keys are split from
PRNGKey(0) as in the reference, and each round splits a seed's key into
(key, ka, kr, kc), so seed i draws exactly what the reference's seed i
draws. Per-round logs are the raw material for every §6 figure
(`core.metrics`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import confidence as cb
from repro_torch.core import rewards as R
from repro_torch.core.policies import PolicyConfig, make_policy
from repro_torch.core.relax import solve_direct
from repro_torch.device import resolve_device
from repro_torch.env import cost_model, feedback
from repro_torch.env.llm_profiles import Pool


@dataclasses.dataclass
class SimResult:
    reward: np.ndarray        # (seeds, T) expected set reward r(S_t; μ)
    cost: np.ndarray          # (seeds, T) realized budget-accounted cost
    action: np.ndarray        # (seeds, T, K) selected masks
    observed: np.ndarray      # (seeds, T, K) feedback masks


def simulate(policy_name: str, pool: Pool, pcfg: PolicyConfig, *,
             T: int, seeds: int = 10, sync_every: int = 1,
             use_fleet: bool = True, device="cuda",
             **policy_kw) -> SimResult:
    """Run ``seeds`` independent simulations of T rounds on ``device``.

    ``sync_every > 1`` is the App.-E.3 asynchronous variant: the action is
    re-coordinated only every B rounds; between syncs the previous action
    is reused (feedback still accumulates each round). ``use_fleet=False``
    takes the per-seed loop even for "c2mabv" — the reference the fleet
    path is held against. ``policy_kw`` goes to `make_policy`."""
    dev = resolve_device(device)
    keys = prng.split(prng.PRNGKey(0, device=dev), seeds)
    if use_fleet and policy_name == "c2mabv" and not policy_kw:
        from repro_torch.router import fleet
        fcfg = fleet.fleet_config([pcfg] * seeds, sync_every=sync_every,
                                  device=dev)
        res = fleet.simulate_fleet(pool, fcfg, T=T, keys=keys, device=dev)
        return SimResult(res.reward, res.cost, res.action, res.observed)

    act = make_policy(policy_name, pcfg, device=dev, **policy_kw)
    mu = torch.tensor(pool.mu, dtype=torch.float32, device=dev)
    mean_cost = torch.tensor(pool.mean_cost, dtype=torch.float32,
                             device=dev)
    levels = tuple(pool.reward_levels)
    kind = pcfg.kind
    stats = cb.init_stats_batch(seeds, pcfg.k, dev)
    mask = torch.zeros((seeds, pcfg.k), dtype=torch.float32, device=dev)
    logs = []
    for t in range(1, T + 1):
        ks = prng.split(keys, 4)
        keys, ka, kr, kc = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
        if (t - 1) % sync_every == 0:
            mask = act(stats, ka, t)
        x = cost_model.sample_rewards(kr, mu, levels)
        y = cost_model.sample_costs(kc, mean_cost)
        obs = feedback.observe(kind, mask, x, mean_cost)
        stats = cb.update_stats(stats, obs, x, y)
        # Eq. (1) charges the utilized subset F_t (AWC: the cascade's
        # prefix; SUC/AIC: F_t = S_t)
        logs.append((R.set_reward(kind, mask, mu),
                     torch.sum(y * obs, dim=-1), mask, obs))
    if not logs:
        empty = np.zeros((seeds, 0), np.float32)
        act0 = np.zeros((seeds, 0, pcfg.k), np.float32)
        return SimResult(empty, empty.copy(), act0, act0.copy())
    rew, cost, action, observed = (torch.stack(parts, dim=1).cpu().numpy()
                                   for parts in zip(*logs))
    return SimResult(rew, cost, action, observed)


def optimal_value(pool: Pool, pcfg: PolicyConfig) -> float:
    """r(S*; μ) with known means/costs (the regret comparator)."""
    _, val = solve_direct(pcfg.kind, pool.mu, pool.mean_cost, pcfg.n,
                          pcfg.rho)
    return float(val)
