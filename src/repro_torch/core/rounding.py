"""Discretization rounding (paper §4.2, Algorithm 3) — batched on torch.

Port of the fixed-trip driver of `repro.core.rounding`. Pairwise ("pipage")
rounding merges two fractional coordinates per trip until at most one
remains, then draws it as a Bernoulli; marginals are kept, E[1_S] = z̃ (up
to the EPS finalization band). Each trip finalizes at least one coordinate,
so K − 1 trips suffice for any row. A row with fewer than two fractional
coordinates makes a no-op trip and does not advance its key, so every row's
draws and result are those of the reference's while and scan drivers, bit
for bit. Keys are `repro_torch.prng` rows.

The numpy rounding of the reference (`pairwise_round_np`,
`decompose_bases`, `swap_round_np`) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.ranks import stable_desc_ranks

EPS = 1e-5


def _frac_mask(z):
    return (z > EPS) & (z < 1.0 - EPS)


def _merge_step(z, key):
    """One pairwise merge on every row: z (M, K), key (M, 2). Rows with
    fewer than two fractional coordinates are left as they are, key
    included. The pair is the two smallest fractional indices."""
    f = _frac_mask(z)
    active = f.sum(-1) >= 2
    k = z.shape[-1]
    ar = torch.arange(k, device=z.device)
    last = torch.full_like(ar, k - 1)
    i = torch.where(f, ar, last).min(-1).values
    j = torch.where(f & (ar != i[:, None]), ar, last).min(-1).values
    oi = (ar == i[:, None]) & active[:, None]
    oj = (ar == j[:, None]) & active[:, None]
    zero = torch.zeros_like(z[:, 0])
    zi = torch.where(active, z.gather(-1, i[:, None])[:, 0], zero)
    zj = torch.where(active, z.gather(-1, j[:, None])[:, 0], zero)
    p = torch.minimum(1.0 - zi, zj)
    q = torch.minimum(zi, 1.0 - zj)
    keys = prng.split(key)
    u = prng.uniform(keys[:, 1])
    first = u < q / torch.clamp(p + q, min=1e-12)
    di = torch.where(first, p, -q)
    z = z + di[:, None] * (oi.to(torch.float32) - oj.to(torch.float32))
    return z, torch.where(active[:, None], keys[:, 0], key)


def _finalize(z, key):
    """At most one fractional coordinate remains: Bernoulli(z) keeps its
    marginal; residuals in (0, EPS] ∪ [1−EPS, 1) snap by rounding."""
    f = _frac_mask(z)
    u = prng.uniform(prng.split(key)[:, 1])
    return torch.where(f, (u[:, None] < z).to(torch.float32), torch.round(z))


def pairwise_round_batch(z, keys):
    """Algorithm 3 on every row: z (M, K), keys (M, 2) -> {0,1} (M, K),
    in K − 1 fixed merge trips (enough for any row)."""
    z = torch.clamp(z.to(torch.float32), 0.0, 1.0)
    for _ in range(z.shape[-1] - 1):
        z, keys = _merge_step(z, keys)
    return _finalize(z, keys)


def pad_to_n_dyn(mask, scores, n, equality):
    """Pad |S| up to the base-matroid size n with the highest-score
    unselected arms, per row; identity where ``equality`` is False (AWC's
    inclusive matroid). mask/scores (M, K), n and equality (M,)."""
    n = torch.as_tensor(n, device=mask.device).to(torch.int64)
    deficit = n - mask.sum(-1).to(torch.int64)
    fill = torch.where(mask > 0, torch.full_like(scores, -torch.inf), scores)
    add = (stable_desc_ranks(fill) < deficit[..., None]).to(torch.float32)
    padded = torch.clamp(mask + add, 0.0, 1.0)
    equality = torch.as_tensor(equality, device=mask.device)
    return torch.where(equality[..., None], padded, mask)
