"""State across: the JAX package's fleet state, configs and model weights
as port tensors.

These functions take the reference's `FleetConfig`, `TenantState` and
`PolicyConfig` — any objects with those fields, read through
`numpy.asarray`, so the port imports nothing of the reference — and return
the port's tensors on a given device. uint32 key rows become int64 rows
holding the same words (`repro_torch.prng`); `key_rows_to_numpy` turns them
back. `params_from_jax` carries a model's parameter tree across.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policies import PolicyConfig
from repro_torch.models.model import check_family
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


def _tensor(x, dev) -> torch.Tensor:
    """An array (numpy, or anything `numpy.asarray` reads) as a tensor of
    the same dtype on ``dev``; bfloat16 arrays go across bit for bit."""
    a = np.array(x)                  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_jax(cfg, tree, device="cuda"):
    """The JAX package's `models.model.init_params` tree (dicts of arrays,
    layers stacked on a leading axis) -> the port's parameters on
    ``device``: the same leaves, with ``layers`` unstacked into a list of
    per-layer dicts ({"ln1", "attn", "ln2", "mlp"} for the dense family;
    {"ln1", "attn", "ln2", "moe": {"router", "wi_gate", "wi_up", "wo"}}
    for the MoE family, with "mlp" beside it for a dense residual;
    {"ln1", "ssm": {"w_in", "conv_w", "conv_b", "a_log", "d_skip",
    "dt_bias", "norm", "w_out"}} for the SSM family)."""
    check_family(cfg)
    dev = resolve_device(device)

    def across(sub, index=None):
        if isinstance(sub, dict):
            return {k: across(v, index) for k, v in sub.items()}
        return _tensor(sub if index is None else np.asarray(sub)[index], dev)

    return {"embed": across(tree["embed"]),
            "layers": [across(tree["layers"], i)
                       for i in range(cfg.n_layers)],
            "lnf": across(tree["lnf"])}


def params_to(params, device):
    """A copy of the port's parameters (nested dicts and lists of tensors)
    on ``device``."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: params_to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, dev) for v in params]
    return params.to(dev)
