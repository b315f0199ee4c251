"""Regret (Eq. 2), violation (Eq. 1), and the §6 reward/violation ratio.

A numpy copy of `repro.core.metrics`."""
from __future__ import annotations

from typing import Dict

import numpy as np


def regret_curve(reward: np.ndarray, r_opt: float, alpha: float
                 ) -> np.ndarray:
    """Cumulative α-approximate regret, (seeds, T) -> (seeds, T)."""
    inst = alpha * r_opt - reward
    return np.cumsum(inst, axis=-1)


def violation_curve(cost: np.ndarray, rho: float) -> np.ndarray:
    """V(t) = [ (1/t) Σ_{τ≤t} cost_τ − ρ ]+   per Eq. (1)."""
    t = np.arange(1, cost.shape[-1] + 1)
    avg = np.cumsum(cost, axis=-1) / t
    return np.maximum(avg - rho, 0.0)


def reward_violation_ratio(reward: np.ndarray, cost: np.ndarray, rho: float,
                           eps: float = 1e-3) -> np.ndarray:
    """§6 metric: (avg per-round reward) / (avg per-round violation).

    The denominator averages the running violation V(τ) over τ ≤ t; eps
    guards the zero-violation case (paper excludes those from Fig. 4)."""
    t = np.arange(1, cost.shape[-1] + 1)
    avg_reward = np.cumsum(reward, axis=-1) / t
    v = violation_curve(cost, rho)
    avg_violation = np.cumsum(v, axis=-1) / t
    return avg_reward / np.maximum(avg_violation, eps)


def summarize(reward, cost, rho, r_opt, alpha) -> Dict[str, float]:
    """Final-round summary with 95% CI half-widths across seeds."""
    ratio = reward_violation_ratio(reward, cost, rho)[:, -1]
    reg = regret_curve(reward, r_opt, alpha)[:, -1]
    vio = violation_curve(cost, rho)[:, -1]

    def ci(x):
        return 1.96 * float(np.std(x)) / max(np.sqrt(len(x)), 1.0)

    return {
        "reward_mean": float(reward.mean()),
        "violation_final": float(vio.mean()), "violation_ci": ci(vio),
        "ratio_final": float(ratio.mean()), "ratio_ci": ci(ratio),
        "regret_final": float(reg.mean()), "regret_ci": ci(reg),
    }
