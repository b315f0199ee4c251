"""Statistically-based cost model (paper §3), on torch tensors.

Port of `repro.env.cost_model`. Normalized costs are
cost_k = mean_cost_k · (IN_FRAC + (1 − IN_FRAC)·G) with G ~ Gamma(4, mean 1),
sampled as the mean of four Exp(1) draws −log(U). Draws come from
`repro_torch.prng`, bit-equal to `jax.random`, so the uniforms match the
reference exactly; −log is rounded from float64 (`rewards.log_f32`), so it
is the same on every device and may differ from XLA's in the last bit.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.rewards import log_f32

OUT_SHAPE = 4.0        # Gamma shape for output-length variability
IN_FRAC = 0.35         # l_in / (l_in + E[l_out]) — deterministic part
TINY = float(np.finfo(np.float32).tiny)


def sample_costs(key: torch.Tensor, mean_cost: torch.Tensor) -> torch.Tensor:
    """One round of per-arm normalized costs.

    key (..., 2), mean_cost (K,) -> (..., K) in [0, 1]. The four −log(U)
    terms are summed in a fixed order so every device adds them alike."""
    shape = int(OUT_SHAPE)
    k = mean_cost.shape[-1]
    u = prng.uniform(key, (shape, k), minval=TINY)           # (..., 4, K)
    nl = -log_f32(u)
    g = nl[..., 0, :]
    for i in range(1, shape):
        g = g + nl[..., i, :]
    g = g / OUT_SHAPE
    mult = IN_FRAC + (1.0 - IN_FRAC) * g
    return torch.clamp(mean_cost * mult, 0.0, 1.0)


def sample_rewards(key: torch.Tensor, mu: torch.Tensor,
                   levels: Sequence[float] = (0.0, 0.2, 0.6, 1.0)
                   ) -> torch.Tensor:
    """App.-E.1 discrete reward levels with per-arm mean == mu.

    key (..., 2), mu (K,) -> (..., K). Two-point construction between the
    adjacent levels that bracket mu, as in the reference."""
    mu = torch.clamp(mu, 0.02, 0.98)
    lv = torch.tensor(levels, dtype=torch.float32, device=mu.device)
    idx = torch.clamp(torch.searchsorted(lv, mu, right=True) - 1, 0,
                      len(levels) - 2)
    lo = lv[idx]
    hi = lv[idx + 1]
    p_hi = (mu - lo) / torch.clamp(hi - lo, min=1e-9)
    u = prng.uniform(key, tuple(mu.shape))
    return torch.where(u < p_hi, hi, lo)
