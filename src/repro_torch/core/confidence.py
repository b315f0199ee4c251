"""Confidence-bound machinery (paper §4.1, Lemma 1, Eq. 6), on torch.

Port of `repro.core.confidence`. Running statistics live in a flat dict of
(M, K) tensors, one row per tenant. Unselected arms have T=0, hence an
infinite radius: the UCB caps at 1 and the LCB at 0, which forces initial
exploration.

Per-row scalars (t, δ, α) may be given as (M,) tensors; they are applied as
columns. δ and the α's are coerced to float32 before any arithmetic, as in
the reference, so every caller folds the same bits. The log of the radius
is rounded from float64 (`rewards.log_f32`), the same bits on every device.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.core.rewards import log_f32
from repro_torch.device import resolve_device


def init_stats_batch(m: int, k: int, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """One row of Eq.-(6) statistics per tenant, distinct buffers."""
    dev = resolve_device(device)
    return {name: torch.zeros((m, k), dtype=torch.float32, device=dev)
            for name in ("mu_hat", "c_hat", "t_mu", "t_c")}


def _col(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar or per-row (M,) value as a column against (M, K)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    if x.dim() == like.dim() - 1 and x.dim() > 0:
        x = x[..., None]
    return x


def radius(t, t_k, k: int, delta):
    """ρ_{t,·} = sqrt( ln(2π²K t³ / 3δ) / (2 T) );  +inf when T == 0."""
    delta = _col(delta, t_k)
    t = torch.clamp(_col(t, t_k), min=1.0)
    c0 = torch.tensor(2 * math.pi ** 2 * k, dtype=torch.float32,
                      device=t_k.device)
    num = log_f32(c0 * (t * t * t) / (3.0 * delta))
    r = torch.sqrt(num / (2.0 * torch.clamp(t_k, min=1.0)))
    return torch.where(t_k > 0, r, torch.full_like(r, torch.inf))


def reward_ucb(stats, t, delta, alpha_mu):
    k = stats["mu_hat"].shape[-1]
    r = radius(t, stats["t_mu"], k, delta)
    return torch.clamp(stats["mu_hat"] + _col(alpha_mu, r) * r, max=1.0)


def cost_lcb(stats, t, delta, alpha_c):
    k = stats["c_hat"].shape[-1]
    r = radius(t, stats["t_c"], k, delta)
    return torch.clamp(stats["c_hat"] - _col(alpha_c, r) * r, min=0.0)


def update_stats(stats, feedback_mask, rewards, costs):
    """Eq. (6) running means over the observed subset F_t."""
    f = feedback_mask.to(torch.float32)
    t_mu = stats["t_mu"] + f
    t_c = stats["t_c"] + f
    zero = torch.zeros_like(t_mu)
    mu_hat = torch.where(
        t_mu > 0,
        (stats["mu_hat"] * stats["t_mu"] + rewards * f)
        / torch.clamp(t_mu, min=1.0), zero)
    c_hat = torch.where(
        t_c > 0,
        (stats["c_hat"] * stats["t_c"] + costs * f)
        / torch.clamp(t_c, min=1.0), zero)
    return {"mu_hat": mu_hat, "c_hat": c_hat, "t_mu": t_mu, "t_c": t_c}
