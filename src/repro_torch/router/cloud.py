"""Scheduling cloud (paper §4.2, Fig. 3 right), on torch.

Port of `repro.router.cloud`. Hosts the deployed model replicas — one pool
shared by every tenant local server — receives fractional z̃ vectors,
discretizes them back to actions S_t and dispatches generation. The cloud
never sees raw user text — only token batches prepared by the local
servers.

`round_batch` is the fleet-scale entry point: batched Algorithm 3 over an
(M, K) block of tenant z̃ rows with per-tenant matroid sizes, the
cloud-side half of `router.fleet`. `SchedulingCloud.select` rounds one
tenant's z̃ through it (with `available=` masking quarantined replicas);
`select_np` keeps the reference's host-side numpy rounding (Algorithm 2 for
AWC, Algorithm 3 for SUC/AIC). Generation runs either through the
blocking per-arm `dispatch` on the port's `serving.engine.Engine` (the
sequential path) or through `make_scheduler`'s continuous-batching bridge
(`serving.scheduler`), where many tenants' requests coalesce into shared
per-replica decode batches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import rewards as R
from repro_torch.core import rounding
from repro_torch.core.policies import PolicyConfig
from repro_torch.device import resolve_device
from repro_torch.serving.engine import Engine, GenResult


def round_batch(z, keys, n, kind_ix):
    """Batched discretization for M tenants sharing this cloud.

    z (M, K) fractional selections, keys (M, 2), n (M,) matroid sizes,
    kind_ix (M,) rewards.KIND_INDEX. Pairwise rounding per row, then padding
    to the base-matroid size for SUC/AIC rows with z̃ as the fill score."""
    masks = rounding.pairwise_round_batch(z, keys)
    return rounding.pad_to_n_dyn(masks, z, n, kind_ix != R.KIND_INDEX["awc"])


@dataclasses.dataclass
class Replica:
    """One deployed LLM: an engine + its pricing."""
    name: str
    engine: Engine
    price_per_token: float       # normalized $/token


class SchedulingCloud:
    """One replica pool + rounding service, shared across tenants; its
    rounding runs on ``device``."""

    def __init__(self, pcfg: PolicyConfig, replicas: Sequence[Replica],
                 device="cuda"):
        if len(replicas) != pcfg.k:     # not an assert: must survive -O
            raise ValueError(f"pool has {len(replicas)} replicas but the "
                             f"policy expects k={pcfg.k}")
        self.pcfg = pcfg
        self.replicas = list(replicas)
        self.device = resolve_device(device)
        # the pool is immutable: pricing is computed once here
        self._prices = np.asarray([r.price_per_token for r in self.replicas])
        self._prices.setflags(write=False)

    @property
    def prices(self) -> np.ndarray:
        """Per-replica pricing vector (K,) — the fleet's shared cost side."""
        return self._prices

    def select_batch(self, z: np.ndarray, keys) -> np.ndarray:
        """Batched rounding for M tenants with this cloud's pcfg: z (M, K),
        keys (M, 2) `prng` rows -> {0,1} float32 masks (M, K)."""
        dev = self.device
        z = torch.as_tensor(np.asarray(z, np.float32), device=dev)
        m = z.shape[0]
        n = torch.full((m,), self.pcfg.n, dtype=torch.int32, device=dev)
        kind_ix = torch.full((m,), R.KIND_INDEX[self.pcfg.kind],
                             dtype=torch.int32, device=dev)
        return round_batch(z, keys.to(dev), n, kind_ix).cpu().numpy()

    # ------------------------------------------------------------- rounding
    def select(self, z: np.ndarray, rng: np.random.Generator,
               available: Optional[np.ndarray] = None) -> np.ndarray:
        """Discretization rounding -> boolean action mask (K,).

        The M = 1 case of `select_batch` (pairwise rounding + padding),
        keyed by PRNGKey(rng.integers(0, 2**31 − 1)) as in the reference.

        ``available`` (K,) bool masks quarantined replicas out of the
        selection (failover): z̃ is zeroed on unavailable arms and
        renormalized over the healthy subset (preserving the fractional
        mass up to the healthy count, each entry clipped to [0, 1]) before
        rounding, and the rounded action is intersected with the mask so
        the base-matroid padding can never resurrect a dead arm. A None or
        all-True mask takes the exact unmasked path."""
        z = np.asarray(z, np.float32)
        if available is not None:
            available = np.asarray(available, bool)
            if available.all():
                available = None          # healthy pool: unmasked path
        if available is not None:
            zq = np.where(available, z, 0.0).astype(np.float32)
            s = float(zq.sum())
            if s > 0.0:
                target = min(float(z.sum()), float(available.sum()))
                zq = np.clip(zq * (target / s), 0.0, 1.0).astype(np.float32)
            z = zq
        key = prng.PRNGKey(int(rng.integers(0, 2**31 - 1)),
                           device=self.device)
        mask = np.asarray(self.select_batch(z[None, :], key[None])[0], bool)
        if available is not None:
            mask &= available
        return mask

    def select_np(self, z: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Host-side numpy reference for `select`."""
        if self.pcfg.kind == "awc":
            mask = rounding.swap_round_np(z, self.pcfg.n, rng)
        else:
            mask = rounding.pairwise_round_np(z, rng)
        mask = np.asarray(mask, bool)
        if self.pcfg.kind in ("suc", "aic"):
            mask = _pad_to_n_np(mask, z, self.pcfg.n)
        return mask

    # ------------------------------------------------------------- dispatch
    def realized_cost(self, arm: int, prompts: np.ndarray,
                      out: GenResult) -> float:
        """Statistically-based cost: realized token count x replica price."""
        toks = prompts.shape[1] * prompts.shape[0] + int(out.out_lens.sum())
        return toks * float(self._prices[arm])

    def dispatch(self, arm: int, prompts: np.ndarray, max_new: int,
                 seed: int = 0) -> tuple[GenResult, float]:
        """Run generation on one replica; returns (result, realized cost).
        The blocking sequential path."""
        out = self.replicas[arm].engine.generate(prompts, max_new, seed=seed)
        return out, self.realized_cost(arm, prompts, out)

    def make_scheduler(self, *, n_slots: int = 32, chunk: int = 8,
                       max_out: Optional[int] = None, fault_plan=None,
                       health=None, tick_budget: Optional[int] = None):
        """Continuous-batching bridge over this pool: one `ReplicaRunner`
        per replica, shared by every tenant submitting to this cloud.
        ``fault_plan`` / ``health`` (`serving.faults`) arm the chaos layer;
        ``tick_budget`` bounds each drain (None keeps the default)."""
        from repro_torch.serving.scheduler import (ContinuousScheduler,
                                                   ReplicaRunner)
        kw = {} if tick_budget is None else {"tick_budget": tick_budget}
        return ContinuousScheduler(
            [ReplicaRunner(r.engine, n_slots=n_slots, chunk=chunk,
                           max_out=max_out, replica_ix=i,
                           fault_plan=fault_plan, health=health)
             for i, r in enumerate(self.replicas)], **kw)


def _pad_to_n_np(mask: np.ndarray, z: np.ndarray, n: int) -> np.ndarray:
    """Numpy pad-to-base-matroid reference (mirrors `rounding.pad_to_n_dyn`
    with equality semantics: largest-z̃ unselected arms fill up to n)."""
    mask = np.asarray(mask, bool).copy()
    if mask.sum() < n:
        left = np.argsort(-np.where(mask, -np.inf, z))
        for i in left:
            if mask.sum() >= n:
                break
            mask[i] = True
    return mask
