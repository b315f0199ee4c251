"""State across: the JAX package's fleet state and configs as port tensors.

This system has per-tenant state and PRNG keys where a model has weights.
These functions take the reference's `FleetConfig`, `TenantState` and
`PolicyConfig` — any objects with those fields, read through
`numpy.asarray`, so the port imports nothing of the reference — and return
the port's tensors on a given device. uint32 key rows become int64 rows
holding the same words (`repro_torch.prng`); `key_rows_to_numpy` turns them
back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policies import PolicyConfig
from repro_torch.device import resolve_device
from repro_torch.router.fleet import FleetConfig, TenantState

_FLEET_DTYPES = {"kind_ix": torch.int32, "n": torch.int32,
                 "rho": torch.float32, "delta": torch.float32,
                 "alpha_mu": torch.float32, "alpha_c": torch.float32,
                 "sync_every": torch.int32}


def key_rows(keys, device="cuda") -> torch.Tensor:
    """uint32 key rows (..., 2) -> int64 tensor of the same words."""
    keys = np.asarray(keys)
    if keys.dtype != np.uint32:
        raise TypeError(f"key rows must be uint32, got {keys.dtype}")
    return torch.tensor(keys.astype(np.int64), device=resolve_device(device))


def key_rows_to_numpy(keys: torch.Tensor) -> np.ndarray:
    """int64 key rows -> the uint32 array `jax.random` takes."""
    return keys.cpu().numpy().astype(np.uint32)


def fleet_config(cfg, device="cuda") -> FleetConfig:
    """The reference's FleetConfig -> the port's, on ``device``."""
    dev = resolve_device(device)
    return FleetConfig(**{
        name: torch.tensor(np.asarray(getattr(cfg, name)), dtype=dtype,
                           device=dev)
        for name, dtype in _FLEET_DTYPES.items()})


def tenant_state(state, device="cuda") -> TenantState:
    """The reference's TenantState (stats dict, prev_mask, t, key) -> the
    port's, on ``device``."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return TenantState(stats={k: f32(v) for k, v in state.stats.items()},
                       prev_mask=f32(state.prev_mask), t=f32(state.t),
                       key=key_rows(state.key, dev))


def policy_config(pcfg) -> PolicyConfig:
    """The reference's PolicyConfig -> the port's (plain scalars)."""
    return PolicyConfig(kind=str(pcfg.kind), k=int(pcfg.k), n=int(pcfg.n),
                        rho=float(pcfg.rho), delta=float(pcfg.delta),
                        alpha_mu=float(pcfg.alpha_mu),
                        alpha_c=float(pcfg.alpha_c))
