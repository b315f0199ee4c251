"""Partition-matroid constraints (paper App. C.1), on torch.

Port of `repro.core.partition`. Beyond the cardinality matroid of the main
text, the LLM pool splits into disjoint domain groups D_1..D_M (maths-tuned,
code-tuned, ...) with per-group caps d_j. Feasible actions satisfy
|S ∩ D_j| <= d_j for every j, plus the long-term budget.

The relaxed solver is the reference's parametric Lagrangian: for a budget
multiplier λ the Lagrangian maximizer decomposes per group (the top-d_j
arms by w − λ·c within each group), cost(λ) is non-increasing, and mixing
the two vertices adjacent to the breakpoint (λ doubled, then bisected)
yields the LP optimum. It reaches no kernel in the reference either; here it
is plain torch on rows (B, K), a vertex's cost summed in arm-index order and
its score w − λ·c rounded once, as XLA's contracted multiply-add. Rounding
applies Algorithm 3 *within groups* on the host (`partition_round_np`), or
globally on the device (`make_partition_policy`).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core import confidence as cb
from repro_torch.core import rewards as R
from repro_torch.core import rounding
from repro_torch.core.rewards import sum_in_order
from repro_torch.device import resolve_device

BISECT_ITERS = 48
DOUBLE_ITERS = 24
FW_STEPS = 16


def _top_per_group(score, groups, caps_per_arm):
    """Indicator rows of the top-d_j arms by score within each group.

    score (B, K); groups (K,) int64 group id per arm; caps_per_arm (K,) =
    d_{groups[k]}. Arms are sorted by (group, −score), both sorts stable (a
    tie goes to the lower index, as `jnp.lexsort`); an arm's rank within
    its group is its position less its group's start."""
    k = score.shape[-1]
    by_score = torch.argsort(-score, dim=-1, stable=True)
    order = by_score.gather(-1, torch.argsort(groups[by_score], dim=-1,
                                              stable=True))
    g_sorted = groups[order].contiguous()
    start = torch.searchsorted(g_sorted, g_sorted, right=False)
    rank_sorted = torch.arange(k, device=score.device) - start
    rank = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    sel = (rank < caps_per_arm) & (score > -torch.inf)
    return sel.to(torch.float32)


def lp_partition(w, c, groups, caps, rho, drop_negative: bool = True):
    """max <w,z> s.t. sum_{D_j} z <= d_j, <c,z> <= rho, z in [0,1]^K, for
    rows w/c (B, K) or one row (K,), with a shared or per-row rho."""
    one_row = w.dim() == 1
    w = torch.atleast_2d(w.to(torch.float32))
    c = torch.atleast_2d(c.to(device=w.device, dtype=torch.float32))
    c = c.expand_as(w)
    groups = torch.as_tensor(np.asarray(groups), dtype=torch.int64,
                             device=w.device)
    caps_per_arm = torch.as_tensor(np.asarray(caps), dtype=torch.int64,
                                   device=w.device)[groups]
    rho = torch.as_tensor(rho, dtype=torch.float32, device=w.device)
    rho = rho.reshape(-1).expand(w.shape[0])

    def vertex(lam):
        score = (w.double() - lam.double()[:, None] * c.double()).to(
            torch.float32)
        if drop_negative:      # inclusive matroid: never take negative score
            score = torch.where(score > 0, score,
                                torch.full_like(score, -torch.inf))
        return _top_per_group(score, groups, caps_per_arm)

    def cost(z):
        return sum_in_order(c * z)

    zero = torch.zeros_like(rho)
    z0 = vertex(zero)
    cost0 = cost(z0)
    lam = torch.ones_like(rho)
    for _ in range(DOUBLE_ITERS):
        lam = torch.where(cost(vertex(lam)) > rho, lam * 2.0, lam)
    lo, hi, z_l, z_h = zero, lam, z0, vertex(lam)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        z_m = vertex(mid)
        feas = cost(z_m) <= rho
        lo = torch.where(feas, lo, mid)
        hi = torch.where(feas, mid, hi)
        z_l = torch.where(feas[:, None], z_l, z_m)
        z_h = torch.where(feas[:, None], z_m, z_h)
    c_lo, c_hi = cost(z_l), cost(z_h)
    theta = torch.where(c_lo > c_hi, (rho - c_hi) / torch.clamp(
        c_lo - c_hi, min=1e-12), torch.zeros_like(rho))
    theta = torch.clamp(theta, 0.0, 1.0)[:, None]
    z_mix = theta * z_l + (1 - theta) * z_h
    z = torch.where((cost0 <= rho)[:, None], z0, z_mix)
    return z[0] if one_row else z


def solve_relaxed_partition(kind: str, mu_bar, c_low, groups, caps, rho):
    """Fractional z̃ for AWC/SUC/AIC under a partition matroid + budget, on
    rows (B, K) or one row (K,) on the device of ``mu_bar``."""
    mu_bar = mu_bar.to(torch.float32)
    if kind == "suc":
        return lp_partition(mu_bar, c_low, groups, caps, rho)
    if kind == "aic":
        w = R.log_f32(torch.clamp(mu_bar, R.EPS, 1.0))
        return lp_partition(w, c_low, groups, caps, rho,
                            drop_negative=False)
    if kind == "awc":
        z = torch.zeros_like(mu_bar)
        div = torch.full_like(mu_bar, float(FW_STEPS))
        for _ in range(FW_STEPS):
            g = R.awc_multilinear_grad(z, mu_bar)
            z = z + lp_partition(g, c_low, groups, caps, rho) / div
        return z
    raise ValueError(kind)


def partition_round_np(z, groups, rng: np.random.Generator) -> np.ndarray:
    """Algorithm 3 applied within each group: preserves marginals AND every
    group sum (up to the one fractional unit per group)."""
    z = np.asarray(z, np.float64).copy()
    out = np.zeros_like(z)
    for g in np.unique(np.asarray(groups)):
        idx = np.flatnonzero(np.asarray(groups) == g)
        out[idx] = rounding.pairwise_round_np(z[idx], rng)
    return out


def make_partition_policy(kind: str, k: int, groups, caps, rho: float,
                          delta: float = 0.01, alpha_mu: float = 0.3,
                          alpha_c: float = 0.05, device="cuda"):
    """C2MAB-V over a partition matroid: ``act(stats, keys, t)`` on seed
    rows, as the policies of `core.policies`, on ``device``."""
    resolve_device(device)

    def act(stats, keys, t):
        mu_bar = cb.reward_ucb(stats, t, delta, alpha_mu)
        c_low = cb.cost_lcb(stats, t, delta, alpha_c)
        z = solve_relaxed_partition(kind, mu_bar, c_low, groups, caps, rho)
        # global pairwise rounding preserves marginals; per-group sums are
        # integral up to one fractional unit (the host path
        # partition_round_np is exact per group)
        return rounding.pairwise_round_batch(z, keys)

    return act


def enumerate_partition_actions(k: int, groups, caps) -> np.ndarray:
    """All feasible subsets of the partition matroid (for small K tests)."""
    groups = np.asarray(groups)
    feas = []
    for bits in itertools.product([0, 1], repeat=k):
        m = np.array(bits, bool)
        ok = all(m[groups == g].sum() <= caps[g]
                 for g in np.unique(groups))
        if ok:
            feas.append(m)
    return np.asarray(feas)
