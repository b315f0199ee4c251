"""Policy configuration shared by the bandit and the fleet.

Port of `repro.core.policies.PolicyConfig`. C2MAB-V itself runs through the
fleet (`router.fleet`); the per-seed baseline policies of the reference
(CUCB, Thompson sampling, ε-greedy, fixed arms, C2MAB-V-Direct) are not
ported yet.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    kind: str                  # reward model: awc | suc | aic
    k: int
    n: int
    rho: float
    delta: float = 0.01        # paper sets δ=1/T in the analysis
    alpha_mu: float = 0.3
    alpha_c: float = 0.05
