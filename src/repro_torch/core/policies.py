"""Online selection policies: C2MAB-V (the paper) + §6 baselines, on torch.

Port of `repro.core.policies`. Every policy is a function over a batch of
independent seeds, one row each:

    act(stats, keys, t) -> action masks (S, K) in {0,1}

with stats a dict of (S, K) tensors (`confidence.init_stats_batch`), keys
(S, 2) `prng` rows and t the round (an int or an (S,) tensor). Row s gets
exactly what the reference's ``act(stats[s], keys[s], t)`` gets; the shared
Eq. 6 update is `confidence.update_stats`.

Baselines follow §6: CUCB (constraint-blind), Thompson Sampling,
ε-Greedy (ε_t = min(1, 2√K/√t)), Fixed-arm (Always-GPT-4 / Always-cheap),
OfflineFixed (pre-learned set applied online), and C2MAB-V-Direct
(App. E.3 Eq. 48 — exact discrete argmax over the enumerated actions).

Every rank is a stable one (`torch.argsort(..., stable=True)`): at t = 1
every μ̂ and every UCB tie, and the reference's argsort gives the lower
index first. A policy's constant tensors (the fixed mask, the action
matrix) are made on ``device`` by `make_policy` and the policy runs on
that device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import confidence as cb
from repro_torch.core import relax
from repro_torch.core import rewards as R
from repro_torch.core import rounding
from repro_torch.core.rewards import sum_in_order
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    kind: str                  # reward model: awc | suc | aic
    k: int
    n: int
    rho: float
    delta: float = 0.01        # paper sets δ=1/T in the analysis
    alpha_mu: float = 0.3
    alpha_c: float = 0.05


Act = Callable[..., torch.Tensor]


def _rank_topn(scores, n: int):
    """{0,1} rows of the top-n entries by score: ranks from two stable
    argsorts, as the reference's ``argsort(argsort(-s)) < n``."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks < n).to(torch.float32)


def _bounds(cfg: PolicyConfig, stats, t):
    return (cb.reward_ucb(stats, t, cfg.delta, cfg.alpha_mu),
            cb.cost_lcb(stats, t, cfg.delta, cfg.alpha_c))


# ===================================================================== C2MAB-V
def c2mabv(cfg: PolicyConfig) -> Act:
    """Per seed: relaxed solve -> pairwise rounding -> base-matroid padding
    with μ̄ as the fill score."""
    equality = R.equality_constrained(cfg.kind)

    def act(stats, keys, t):
        mu_bar, c_low = _bounds(cfg, stats, t)
        z = relax.solve_rows(cfg.kind, mu_bar, c_low, cfg.n, cfg.rho)
        mask = rounding.pairwise_round_batch(z, keys)
        if not equality:
            return mask
        return rounding.pad_to_n_dyn(mask, mu_bar, cfg.n, True)

    return act


def c2mabv_direct(cfg: PolicyConfig, device) -> Act:
    """App. E.3: exact discrete argmax (Eq. 48) — exponential in K. A set's
    value and cost are reduced in arm-index order (`set_reward_in_order`,
    `sum_in_order`)."""
    actions = torch.tensor(relax.enumerate_actions(
        cfg.k, cfg.n, R.equality_constrained(cfg.kind)), dtype=torch.float32,
        device=device)                                   # (M, K)

    def act(stats, keys, t):
        mu_bar, c_low = _bounds(cfg, stats, t)
        vals = R.set_reward_in_order(cfg.kind, actions[None],
                                     mu_bar[:, None, :])       # (S, M)
        cost = sum_in_order(actions[None] * c_low[:, None, :])   # (S, M)
        feas = cost <= cfg.rho
        vals = torch.where(feas, vals, torch.full_like(vals, -torch.inf))
        best = torch.where(feas.any(-1), torch.argmax(vals, dim=-1),
                           torch.argmin(cost, dim=-1))
        return actions[best]

    return act


# ===================================================================== baselines
def cucb(cfg: PolicyConfig) -> Act:
    """CUCB [Wang & Chen]: UCB means (α = 1), cost constraint ignored.
    Top-N by UCB is feasible for both matroid types (|S| = N)."""

    def act(stats, keys, t):
        mu_bar = cb.reward_ucb(stats, t, cfg.delta, 1.0)
        return _rank_topn(mu_bar, cfg.n)

    return act


def thompson(cfg: PolicyConfig) -> Act:
    """Beta-posterior TS on rewards (cost-blind, as in §6)."""

    def act(stats, keys, t):
        s = stats["mu_hat"] * stats["t_mu"]          # pseudo-successes
        f = stats["t_mu"] - s
        sample = prng.beta(keys, 1.0 + s, 1.0 + f)
        return _rank_topn(sample, cfg.n)

    return act


def epsilon_greedy(cfg: PolicyConfig) -> Act:
    """ε_t = min(1, 2√K/√t); explore: uniform N-subset, exploit: top-N μ̂."""
    two_sqrt_k = 2.0 * float(np.sqrt(np.float32(cfg.k)))

    def act(stats, keys, t):
        ks = prng.split(keys, 3)
        mu_hat = stats["mu_hat"]
        t = torch.as_tensor(t, device=mu_hat.device).to(torch.float32)
        t = t.expand(mu_hat.shape[:-1])
        eps = torch.minimum(torch.ones_like(t), torch.full_like(
            t, two_sqrt_k) / torch.sqrt(torch.clamp(t, min=1.0)))
        explore = prng.uniform(ks[..., 0, :]) < eps
        rand_scores = prng.uniform(ks[..., 1, :], (cfg.k,))
        scores = torch.where(explore[..., None], rand_scores, mu_hat)
        return _rank_topn(scores, cfg.n)

    return act


def fixed(cfg: PolicyConfig, arm: int, device) -> Act:
    mask = np.zeros((cfg.k,), np.float32)
    mask[arm] = 1.0
    return offline_fixed(cfg, mask, device)


def offline_fixed(cfg: PolicyConfig, mask, device) -> Act:
    m = torch.as_tensor(mask, dtype=torch.float32).to(device)

    def act(stats, keys, t):
        return m.expand(stats["mu_hat"].shape).clone()

    return act


# ===================================================================== registry
NAMES = ("c2mabv", "c2mabv_direct", "cucb", "thompson", "egreedy", "fixed",
         "offline_fixed")


def make_policy(name: str, cfg: PolicyConfig, device="cuda", **kw) -> Act:
    """The policy ``name`` for ``cfg``, acting on stats on ``device``.
    ``fixed`` takes ``arm=``, ``offline_fixed`` ``mask=``."""
    dev = resolve_device(device)
    if name == "c2mabv":
        return c2mabv(cfg)
    if name == "c2mabv_direct":
        return c2mabv_direct(cfg, dev)
    if name == "cucb":
        return cucb(cfg)
    if name == "thompson":
        return thompson(cfg)
    if name == "egreedy":
        return epsilon_greedy(cfg)
    if name == "fixed":
        return fixed(cfg, kw["arm"], dev)
    if name == "offline_fixed":
        return offline_fixed(cfg, kw["mask"], dev)
    raise ValueError(name)
