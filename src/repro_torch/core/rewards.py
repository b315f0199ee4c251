"""Versatile reward models (paper §3): AWC, SUC, AIC — on torch tensors.

Port of `repro.core.rewards`. Set rewards r(S;μ) over a {0,1} selection
mask and their relaxed counterparts r̃(z̃;μ) over fractional z̃ ∈ [0,1]^K:

  AWC  r = 1 - ∏_{k∈S}(1-μ_k)      r̃ = 1 - ∏_k (1 - μ_k z̃_k)
  SUC  r = Σ_{k∈S} μ_k             r̃ = Σ_k μ_k z̃_k
  AIC  r = ∏_{k∈S} μ_k             r̃ = ∏_k μ_k^{z̃_k}

Every function reduces over the last axis and broadcasts over the rest.
"""
from __future__ import annotations

import math

import numpy as np
import torch

KINDS = ("awc", "suc", "aic")
KIND_INDEX = {k: i for i, k in enumerate(KINDS)}
# offline approximation-oracle ratio per reward model (paper App. C.2)
ALPHA = {"awc": 1.0 - 1.0 / math.e, "suc": 1.0, "aic": 1.0}
EPS = 1e-9
MU_MAX = 1.0 - 1e-6     # clip of μ in the AWC multilinear gradient


def _f32(x, like=None):
    device = None if like is None else like.device
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _rounded_from_f64(np_fn, torch_fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` evaluated in float64 and rounded once to float32; on the
    CPU through numpy, on the calling thread. ATen's float64 exp on the CPU
    (MKL's vector math) has returned one thread's share of a large tensor
    with errors far above a float64 ulp, in some runs only, so its float32
    bits depended on the thread count (ROADMAP F5)."""
    if x.device.type == "cpu":
        with np.errstate(all="ignore"):           # log(0) = -inf, as torch
            y = np_fn(x.detach().double().numpy())
        return torch.from_numpy(y).to(torch.float32)
    return torch_fn(x.double()).to(torch.float32)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """log, exp and log1p below are evaluated in float64 and rounded once to
    float32. The float32 versions of CUDA and of the CPU differ in the last
    bit on some inputs, and one ulp in a gradient can flip a degenerate LP
    vertex; rounded from float64, both devices give the same bits unless a
    result lies within 2^-29 (relative) of a float32 rounding midpoint.
    The `awc_fw` kernel computes its gradient the same way."""
    return _rounded_from_f64(np.log, torch.log, x)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    return _rounded_from_f64(np.log1p, torch.log1p, x)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    return _rounded_from_f64(np.exp, torch.exp, x)


def sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis, added left to right in arm-index order.

    The CUDA kernels sum in this order; the plain versions use it too, so a
    kernel and its plain version agree to the bit wherever their terms do."""
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def set_reward(kind: str, mask, mu):
    """r(S;μ). mask (..., K) in {0,1}, mu (K,) or (..., K)."""
    mask = _f32(mask)
    mu = _f32(mu, mask)
    if kind == "awc":
        return 1.0 - torch.prod(1.0 - mu * mask, dim=-1)
    if kind == "suc":
        return torch.sum(mu * mask, dim=-1)
    if kind == "aic":
        return torch.prod(torch.where(mask > 0, mu, torch.ones_like(mu)),
                          dim=-1)
    raise ValueError(kind)


def set_reward_ix(kind_ix, mask, mu):
    """`set_reward` with a per-row KIND_INDEX (broadcast over leading axes)."""
    kind_ix = torch.as_tensor(kind_ix, device=mask.device)
    out = set_reward("awc", mask, mu)
    out = torch.where(kind_ix == KIND_INDEX["suc"], set_reward("suc", mask, mu),
                      out)
    return torch.where(kind_ix == KIND_INDEX["aic"], set_reward("aic", mask, mu),
                       out)


def relaxed_reward(kind: str, z, mu):
    """r̃(z̃;μ) closed forms."""
    z = _f32(z)
    mu = _f32(mu, z)
    if kind == "awc":
        return 1.0 - torch.prod(1.0 - mu * z, dim=-1)
    if kind == "suc":
        return torch.sum(mu * z, dim=-1)
    if kind == "aic":
        return exp_f32(torch.sum(z * log_f32(torch.clamp(mu, min=EPS)),
                                 dim=-1))
    raise ValueError(kind)


def equality_constrained(kind: str) -> bool:
    """SUC/AIC select exactly N (base matroid); AWC at most N (App. C.1)."""
    return kind in ("suc", "aic")


def awc_multilinear_grad(z, mu):
    """∂r̃/∂z̃_k = μ_k ∏_{j≠k}(1-μ_j z̃_j), computed in log space.

    The log terms are summed in arm-index order (`sum_in_order`) and the
    transcendentals rounded from float64 (`log_f32`), as the `awc_fw` kernel
    does, so the card and the CPU give the same bits."""
    z = _f32(z)
    mu = torch.clamp(_f32(mu, z), 0.0, MU_MAX)
    logs = log1p_f32(-mu * z)
    total = sum_in_order(logs)[..., None]
    return mu * exp_f32(total - logs)
