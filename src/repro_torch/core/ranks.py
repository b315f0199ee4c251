"""Stable descending ranks + top-n selections — the shared selection core.

Port of `repro.core.ranks`. Every selection goes through the stable rank

  rank_i = #{j : s_j > s_i} + #{j < i : s_j == s_i}

(lower index wins ties: the order of a stable argsort), counted pairwise in
O(K²) without a sort.

FLOAT HAZARD (why the `lagrangian_*` family exists): ranking a computed
score s = w − λ·c is only safe if every comparison reads the same rounding
of s. A compiler that contracts w − λ·c into a fused multiply-add in one
copy and not in another (XLA does; so does nvcc at its default
``--fmad=true``) can make s_i > s_j and s_j > s_i both hold near a
crossing, and the "ranks" stop being a permutation. The `lagrangian_*`
functions never form s: they compare (w_j − w_i) > λ·(c_j − c_i), where a
subtraction of inputs and a lone multiply each have one IEEE rounding. The
`awc_fw` CUDA kernel uses the same crossing form with `__fsub_rn` and
`__fmul_rn`.

Costs are summed in arm-index order (`rewards.sum_in_order`), as the CUDA
kernels sum them.
"""
from __future__ import annotations

import torch

from repro_torch.core.rewards import sum_in_order


def _n_col(n, like: torch.Tensor) -> torch.Tensor:
    """n as an int64 tensor broadcastable against like's rank rows."""
    n = torch.as_tensor(n, device=like.device).to(torch.int64)
    return n[..., None]


def stable_desc_ranks(score):
    """Stable descending ranks by O(K²) pairwise count: (..., K) -> int64.

    For scores of the form w − λ·c use `lagrangian_ranks` instead (module
    docstring)."""
    k = score.shape[-1]
    idx = torch.arange(k, device=score.device)
    sj = score[..., None, :]
    si = score[..., :, None]
    beats = (sj > si) | ((sj == si) & (idx[None, :] < idx[:, None]))
    return beats.sum(-1)


def topn_mask(score, n, equality: bool):
    """{0,1} mask of the top-n entries by score, stable tie order. With
    ``equality`` False (inclusive matroid) entries with score <= 0 drop."""
    z = (stable_desc_ranks(score) < _n_col(n, score)).to(torch.float32)
    if not equality:
        z = z * (score > 0)
    return z


def topn_lp_cost(score, cost, n, equality: bool):
    """Σ cost over the top-n-by-score entries: (..., K) -> (...,) float32.

    The plain version of the `topn_lp` kernel (score form)."""
    mask = topn_mask(score, n, equality)
    return sum_in_order(mask * cost.to(torch.float32))


# ================================================== parametric (λ-batch) form
def lagrangian_ranks(w, c, lams):
    """Ranks of w − λ·c for a λ batch, in the crossing form.

    w/c (..., K), lams (..., G) -> int64 ranks (..., G, K)."""
    dw = w[..., None, :] - w[..., :, None]           # [i, j] = w_j − w_i
    dc = c[..., None, :] - c[..., :, None]
    lhs = lams[..., :, None, None] * dc[..., None, :, :]
    k = w.shape[-1]
    idx = torch.arange(k, device=w.device)
    dw = dw[..., None, :, :]
    beats = (dw > lhs) | ((dw == lhs) & (idx[None, :] < idx[:, None]))
    return beats.sum(-1)


def lagrangian_topn_mask(w, c, lams, n, equality: bool):
    """{0,1} vertices z(λ) for a λ batch: (..., G, K). With ``equality``
    False the positivity filter s_i > 0 is tested as w_i > λ·c_i."""
    ranks = lagrangian_ranks(w, c, lams)
    n = torch.as_tensor(n, device=w.device).to(torch.int64)
    mask = (ranks < n[..., None, None]).to(torch.float32)
    if not equality:
        mask = mask * (w[..., None, :] > lams[..., :, None] * c[..., None, :])
    return mask


def lagrangian_topn_cost(w, c, lams, n, equality: bool):
    """cost(λ) = Σ c·z(λ) for a λ batch: (..., G) float32."""
    return sum_in_order(lagrangian_topn_mask(w, c, lams, n, equality)
                        * c.to(torch.float32)[..., None, :])
