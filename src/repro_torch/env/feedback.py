"""Partial LLM feedback F_t ⊆ S_t (paper §3), on torch tensors.

Port of `repro.env.feedback`. AWC is the user-experience cascade: the
selected arms are queried in ascending-cost order and querying stops at the
first success (X == 1.0); F_t is the queried prefix. SUC and AIC observe the
whole selection.

`_awc_cascade` is the sort-free form: ascending-cost stable ranks of the
selected arms (lower index wins ties), thresholded at the rank of the first
success. `_awc_cascade_argsort` keeps the two-argsort formulation as its
test oracle. Both take rows batched on any leading axes.
"""
from __future__ import annotations

import torch

from repro_torch.core.ranks import stable_desc_ranks

SUCCESS_LEVEL = 1.0


def _awc_cascade(action_mask, rewards, mean_cost):
    sel = action_mask > 0
    k = action_mask.shape[-1]
    neg = torch.broadcast_to(-mean_cost, action_mask.shape)
    r = stable_desc_ranks(torch.where(sel, neg, torch.full_like(neg,
                                                               -torch.inf)))
    succ = (rewards >= SUCCESS_LEVEL).to(torch.int64) * sel.to(torch.int64)
    first = torch.min(r + (1 - succ) * k, dim=-1, keepdim=True).values
    return sel.to(torch.float32) * (r <= first).to(torch.float32)


def _awc_cascade_argsort(action_mask, rewards, mean_cost):
    """Two stable argsorts per row — the sort-free cascade's oracle."""
    cost = torch.broadcast_to(mean_cost, action_mask.shape)
    order = torch.argsort(torch.where(action_mask > 0, cost,
                                      torch.full_like(cost, torch.inf)),
                          dim=-1, stable=True)
    sel_sorted = torch.gather(action_mask, -1, order)
    succ_sorted = ((torch.gather(rewards, -1, order) >= SUCCESS_LEVEL)
                   & (sel_sorted > 0)).to(torch.int64)
    seen_succ = torch.cumsum(succ_sorted, dim=-1)
    before_or_at = (seen_succ - succ_sorted) == 0
    obs_sorted = sel_sorted * before_or_at.to(torch.float32)
    inv = torch.argsort(order, dim=-1, stable=True)
    return torch.gather(obs_sorted, -1, inv)


def observe(kind: str, action_mask, rewards, mean_cost):
    """Feedback mask F_t in {0,1}, the shape of ``action_mask``."""
    if kind in ("suc", "aic"):
        return action_mask
    return _awc_cascade(action_mask, rewards, mean_cost)


def observe_ix(kind_ix, action_mask, rewards, mean_cost):
    """`observe` with a per-row rewards.KIND_INDEX (awc=0): kind_ix is
    broadcast against the leading axes of ``action_mask``."""
    cascade = _awc_cascade(action_mask, rewards, mean_cost)
    awc = torch.as_tensor(kind_ix, device=action_mask.device) == 0
    return torch.where(awc[..., None], cascade, action_mask)
