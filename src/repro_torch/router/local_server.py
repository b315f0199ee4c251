"""Local server (paper §4.1, Fig. 3 left), on torch.

Port of `repro.router.local_server`. Handles user queries, stores
feedback, maintains the Eq.-(6) running stats, and solves the *relaxed*
constrained problem — only the fractional vector z̃ is shipped to the
scheduling cloud (raw queries and feedback never leave).

It is the M = 1 case of `router.fleet`: its statistics live in a one-row
`TenantState` on ``device``, and every solve goes through the fleet's
batched `fleet.relaxed_batch`, on the grid engine's ``lowering`` (None:
the wide one; "tail" is what the reference's server runs on the CPU). Its
properties and `relaxed_selection` return numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import confidence as cb
from repro_torch.core.policies import PolicyConfig
from repro_torch.device import resolve_device
from repro_torch.router import fleet


@dataclasses.dataclass
class FeedbackRecord:
    round: int
    arm: int
    reward: float
    cost: float


class LocalServer:
    """Owns user data + bandit statistics; emits relaxed selections."""

    def __init__(self, pcfg: PolicyConfig, device="cuda",
                 lowering: Optional[str] = None):
        self.pcfg = pcfg
        self.device = resolve_device(device)
        self.lowering = lowering
        self._fcfg = fleet.fleet_config([pcfg], device=self.device)
        self.state = fleet.init_tenant_state(1, pcfg.k, device=self.device)
        self.log: list[FeedbackRecord] = []

    # ------------------------------------------------------------ statistics
    @property
    def t(self) -> int:
        return int(self.state.t[0].item())

    @t.setter
    def t(self, value: int) -> None:
        self.state = self.state._replace(t=torch.full(
            (1,), float(value), dtype=torch.float32, device=self.device))

    def _row(self, name: str) -> np.ndarray:
        return self.state.stats[name][0].cpu().numpy()

    @property
    def mu_hat(self) -> np.ndarray:
        return self._row("mu_hat")

    @property
    def c_hat(self) -> np.ndarray:
        return self._row("c_hat")

    @property
    def t_mu(self) -> np.ndarray:
        return self._row("t_mu")

    @property
    def t_c(self) -> np.ndarray:
        return self._row("t_c")

    def relaxed_selection(self) -> np.ndarray:
        """One §4.1 step: UCB/LCB -> relaxed solve -> fractional z̃ (K,)."""
        self.t = self.t + 1
        z = fleet.relaxed_batch(self.state.stats, self.state.t, self._fcfg,
                                lowering=self.lowering)
        return z[0].cpu().numpy()

    def record(self, arm: int, reward: float, cost: float) -> None:
        """Eq. (6) incremental update for one observed arm."""
        shape, dev = (1, self.pcfg.k), self.device
        obs = torch.zeros(shape, dtype=torch.float32, device=dev)
        x, y = torch.zeros_like(obs), torch.zeros_like(obs)
        obs[0, arm] = 1.0
        x[0, arm] = float(reward)
        y[0, arm] = float(cost)
        self.state = self.state._replace(
            stats=cb.update_stats(self.state.stats, obs, x, y))
        self.log.append(FeedbackRecord(self.t, arm, reward, cost))
