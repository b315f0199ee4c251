"""The paper's LLM pool (Table 3, App. E.1) as a simulation environment spec.

Nine commercial/open LLMs with official per-1k-token pricing and
per-scenario quality means. Rewards follow App. E.1's discrete levels
{0, 0.1, 0.3, 0.5} re-scaled to [0,1] (the bandit analysis assumes X∈[0,1]);
costs follow the statistically-based model y = (l_in + l_out)·C_k with
stochastic output length, normalized so the Table-3 price ordering is
preserved and expected costs sit in [0,1].

A second pool mode ("zoo") prices the assigned architectures of
`repro_torch.configs` by active parameter count — the end-to-end mode where
the bandit routes over real models served by the engine.

A numpy copy of `repro.env.llm_profiles`, so the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

# --- Table 3: (name, $ / 1k tokens) ---------------------------------------
TABLE3: Tuple[Tuple[str, float], ...] = (
    ("ChatGLM2-6B-32K", 0.005),
    ("ChatGPT-3.5", 0.02),
    ("Claude 2", 0.08),
    ("ERNIE 3.5-8K", 0.015),
    ("Llama 2-7B", 0.005),
    ("Llama 2-13B", 0.008),
    ("Llama 2-70B", 0.05),
    ("Mixtral-8x7B-Instruct", 0.05),
    ("ChatGPT-4", 0.12),
)
GPT4 = 8          # index of ChatGPT-4 in TABLE3
CHATGLM2 = 0      # index of ChatGLM2 (the cheap baseline)

# Per-scenario quality means μ_k calibrated to the paper's observations:
# ChatGLM2 rewards "significantly low, below 0.18/0.10" (§6); GPT-4 strong
# but not uniformly dominant (Fig. 1 "generation diversity"); mid-tier models
# competitive on some topics. Scaled to [0,1].
SCENARIO_MU: Dict[str, np.ndarray] = {
    # SciQ-style science QA (the paper's §6 dataset)
    "sciq": np.array([0.12, 0.62, 0.70, 0.55, 0.35, 0.45, 0.60, 0.66, 0.78]),
    # mathematics (Fig. 1: GPT-4 weaker on some math topics than Claude)
    "math": np.array([0.08, 0.50, 0.72, 0.42, 0.22, 0.30, 0.52, 0.60, 0.68]),
    # general chat (cheap models closer to frontier)
    "chat": np.array([0.30, 0.70, 0.72, 0.62, 0.52, 0.58, 0.68, 0.70, 0.76]),
}

# Output-token distribution (App. E.1 cost model): l_out ~ LogNormal-ish,
# mean per model (verbosity differs per LLM).
MEAN_OUT_TOKENS = np.array([180, 220, 260, 210, 200, 210, 240, 230, 280],
                           float)
IN_TOKENS = 120.0   # deterministic prompt length l_in (per query family)


@dataclasses.dataclass(frozen=True)
class Pool:
    """A bandit environment: K arms with true means and stochastic costs."""
    names: Tuple[str, ...]
    mu: np.ndarray              # (K,) true expected reward in [0,1]
    mean_cost: np.ndarray       # (K,) expected normalized cost in [0,1]
    cost_scale: float           # $ at normalized cost 1.0 (for reporting)
    reward_levels: Tuple[float, ...] = (0.0, 0.2, 0.6, 1.0)
    # probabilities of levels are derived from mu per-arm at sample time

    @property
    def k(self) -> int:
        return len(self.names)


def paper_pool(scenario: str = "sciq") -> Pool:
    """The §6 environment: 9 LLMs, Table-3 pricing, App.-E.1 rewards."""
    mu = SCENARIO_MU[scenario].copy()
    price = np.array([p for _, p in TABLE3])
    # expected $ per query = (l_in + E[l_out]) / 1000 * price
    dollars = (IN_TOKENS + MEAN_OUT_TOKENS) / 1000.0 * price
    scale = float(dollars.max() * 1.25)      # headroom: costs in (0, 0.8]
    return Pool(names=tuple(n for n, _ in TABLE3), mu=mu,
                mean_cost=dollars / scale, cost_scale=scale)


def zoo_pool(seed: int = 0) -> Pool:
    """End-to-end mode: the assigned architectures as the arm pool.

    Cost ∝ active-parameter FLOPs (6·N_active per token); quality is a
    monotone-but-noisy function of active params (bigger is better on
    average, with planted per-arch deviations — 'generation diversity').
    """
    from repro_torch.configs.base import get_config, list_archs
    names = list_archs()
    active = np.array([get_config(n).active_param_count() for n in names],
                      float)
    rng = np.random.default_rng(seed)
    q = 0.30 + 0.55 * (np.log(active) - np.log(active).min()) / (
        np.log(active).max() - np.log(active).min())
    mu = np.clip(q + rng.normal(0, 0.08, len(names)), 0.05, 0.95)
    dollars = active / active.max()          # relative FLOP cost
    scale = 1.25
    return Pool(names=tuple(names), mu=mu, mean_cost=dollars / scale,
                cost_scale=scale)


def default_rho(pool: Pool, kind: str, n: int) -> float:
    """Paper §6 budget thresholds: 0.45 (AWC), 0.5 (SUC), 0.3 (AIC) — scaled
    to our normalized cost units so the constraint binds the same way."""
    base = {"awc": 0.45, "suc": 0.50, "aic": 0.30}[kind]
    # paper's ρ is in its own normalized units; keep the ratio to the mean
    # n-subset cost comparable
    typical = float(np.sort(pool.mean_cost)[:n].sum())
    return max(base, typical * 1.1)
