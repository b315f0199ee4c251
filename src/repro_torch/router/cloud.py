"""Scheduling cloud (paper §4.2, Fig. 3 right): batched discretization.

Port of `repro.router.cloud.round_batch`. The `SchedulingCloud`, which
dispatches generation to model replicas, depends on the serving engine and
waits for its port.
"""
from __future__ import annotations

from repro_torch.core import rewards as R
from repro_torch.core import rounding


def round_batch(z, keys, n, kind_ix):
    """Batched discretization for M tenants sharing this cloud.

    z (M, K) fractional selections, keys (M, 2), n (M,) matroid sizes,
    kind_ix (M,) rewards.KIND_INDEX. Pairwise rounding per row, then padding
    to the base-matroid size for SUC/AIC rows with z̃ as the fill score."""
    masks = rounding.pairwise_round_batch(z, keys)
    return rounding.pad_to_n_dyn(masks, z, n, kind_ix != R.KIND_INDEX["awc"])
