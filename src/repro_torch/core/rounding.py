"""Discretization rounding (paper §4.2, Appendix B) — the scheduling cloud.

Port of `repro.core.rounding`. Pairwise ("pipage")
rounding merges two fractional coordinates per trip until at most one
remains, then draws it as a Bernoulli; marginals are kept, E[1_S] = z̃ (up
to the EPS finalization band). Each trip finalizes at least one coordinate,
so K − 1 trips suffice for any row. A row with fewer than two fractional
coordinates makes a no-op trip and does not advance its key, so every row's
draws and result are those of the reference's while and scan drivers, bit
for bit. Keys are `repro_torch.prng` rows.

`pairwise_round` is the single-row form with the reference's choice of
loop: ``trips=0`` (K − 1 fixed trips), a positive int (that many fixed
trips) or ``None`` (trips until no row has two fractional coordinates left,
the reference's while loop). K − 1 fixed trips and the while loop give the
same bits per row.

Algorithm 2 (AWC; swap rounding over cardinality-matroid bases) and the
numpy form of Algorithm 3 are host-side numpy, copied from the reference:
`pairwise_round_np`, `decompose_bases`, `swap_round_np`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


def pairwise_round_batch(z, keys, trips: Optional[int] = 0):
    """Algorithm 3 on every row: z (M, K), keys (M, 2) -> {0,1} (M, K).

    ``trips`` selects the loop: 0 runs K − 1 fixed merge trips (enough
    for any row), a positive int that many, and None merges until no row
    has two fractional coordinates left."""
    z = torch.clamp(z.to(torch.float32), 0.0, 1.0)
    if trips is None:
        while bool((_frac_mask(z).sum(-1) >= 2).any()):
            z, keys = _merge_step(z, keys)
    else:
        for _ in range(int(trips) or z.shape[-1] - 1):
            z, keys = _merge_step(z, keys)
    return _finalize(z, keys)


def pairwise_round(z, key, trips: Optional[int] = 0):
    """Algorithm 3 on one row: z (K,), key (2,) -> {0,1} float mask (K,)."""
    return pairwise_round_batch(z[None], key[None], trips)[0]


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


def pairwise_round_np(z, rng: np.random.Generator) -> np.ndarray:
    z = np.clip(np.asarray(z, np.float64), 0.0, 1.0)
    while True:
        frac = np.flatnonzero((z > EPS) & (z < 1 - EPS))
        if frac.size < 2:
            break
        i, j = frac[0], frac[1]
        p = min(1 - z[i], z[j])
        q = min(z[i], 1 - z[j])
        if rng.random() < q / (p + q):
            z[i] += p
            z[j] -= p
        else:
            z[i] -= q
            z[j] += q
    frac = np.flatnonzero((z > EPS) & (z < 1 - EPS))
    for i in frac:
        z[i] = 1.0 if rng.random() < z[i] else 0.0
    return np.round(z)


# ------------------------------------------------------------------ Alg. 2
def decompose_bases(z: np.ndarray, n: int,
                    tol: float = 1e-9) -> Tuple[list, list]:
    """z (K,), Σz == n: convex decomposition into bases of the cardinality
    matroid (index sets of size n). Returns (weights, bases)."""
    rem = np.asarray(z, np.float64).copy()
    total = 1.0
    weights, bases = [], []
    for _ in range(4 * len(rem) + 8):
        if total <= tol:
            break
        order = np.argsort(-rem, kind="stable")
        base = order[:n]
        g1 = rem[base].min()
        not_base = order[n:]
        g2 = total - (rem[not_base].max() if not_base.size else 0.0)
        gamma = max(min(g1, g2, total), tol / 10)
        weights.append(gamma)
        bases.append(np.sort(base))
        rem[base] -= gamma
        total -= gamma
    s = sum(weights)
    return [w / s for w in weights], bases


def swap_round_np(z: np.ndarray, n: int, rng: np.random.Generator,
                  pad_to_base: bool = True) -> np.ndarray:
    """Algorithm 2: swap rounding for the cardinality matroid.

    Handles Σz < n (AWC inclusive matroid) by padding with n dummy arms.
    Returns {0,1} mask over the original K arms.
    """
    z = np.clip(np.asarray(z, np.float64), 0.0, 1.0)
    k = z.shape[0]
    deficit = max(n - z.sum(), 0.0)
    if pad_to_base and deficit > 1e-12:
        pad = np.full(n, deficit / n)
        z_full = np.concatenate([z, pad])
    else:
        z_full = z
    weights, bases = decompose_bases(z_full, n)
    cur = set(bases[0].tolist())
    p1 = weights[0]
    for p2, b in zip(weights[1:], bases[1:]):
        b2 = set(b.tolist())
        while cur != b2:
            i = next(iter(cur - b2))
            j = next(iter(b2 - cur))
            if rng.random() < p1 / (p1 + p2):
                b2.discard(j)
                b2.add(i)
            else:
                cur.discard(i)
                cur.add(j)
        p1 += p2
    mask = np.zeros(k)
    for i in cur:
        if i < k:
            mask[i] = 1.0
    return mask
