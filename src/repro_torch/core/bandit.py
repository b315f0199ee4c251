"""Bandit simulation on torch: C2MAB-V with seeds as tenants of one fleet.

Port of `repro.core.bandit` for the paper's own policy: `simulate("c2mabv")`
runs each seed as one tenant of a uniform fleet (`router.fleet`), with keys
split from PRNGKey(0) as in the reference, so seed i draws exactly what the
reference's seed i draws. Per-round logs are the raw material for every §6
figure (`core.metrics`).
"""
from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch import prng
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.relax import solve_direct
from repro_torch.env.llm_profiles import Pool


@dataclasses.dataclass
class SimResult:
    reward: np.ndarray        # (seeds, T) expected set reward r(S_t; μ)
    cost: np.ndarray          # (seeds, T) realized budget-accounted cost
    action: np.ndarray        # (seeds, T, K) selected masks
    observed: np.ndarray      # (seeds, T, K) feedback masks


def simulate(policy_name: str, pool: Pool, pcfg: PolicyConfig, *,
             T: int, seeds: int = 10, sync_every: int = 1,
             device="cuda") -> SimResult:
    """Run ``seeds`` independent simulations of T rounds on ``device``.

    ``sync_every > 1`` is the App.-E.3 asynchronous variant: the action is
    re-coordinated only every B rounds."""
    if policy_name != "c2mabv":
        raise NotImplementedError(f"policy {policy_name!r} is not ported; "
                                  "only 'c2mabv' runs on torch")
    from repro_torch.router import fleet
    fcfg = fleet.fleet_config([pcfg] * seeds, sync_every=sync_every,
                              device=device)
    keys = prng.split(prng.PRNGKey(0, device=fcfg.n.device), seeds)
    res = fleet.simulate_fleet(pool, fcfg, T=T, keys=keys, device=device)
    return SimResult(res.reward, res.cost, res.action, res.observed)


def optimal_value(pool: Pool, pcfg: PolicyConfig) -> float:
    """r(S*; μ) with known means/costs (the regret comparator)."""
    _, val = solve_direct(pcfg.kind, pool.mu, pool.mean_cost, pcfg.n,
                          pcfg.rho)
    return float(val)
