"""Bit-exact `jax.random` (threefry2x32, partitionable) on torch tensors.

Keys are (..., 2) int64 tensors whose lanes hold the uint32 words of a JAX
key. PyTorch on the CPU implements no shifts on uint32, so every 32-bit
lane is carried in int64 and masked with 0xFFFFFFFF after each add.

Matches jax 0.9 with ``jax_threefry_partitionable=True``:

  PRNGKey(s)      [0, s] for a seed in int32 range
  split(k, n)     threefry(k, hi=0, lo=iota(n)) -> n keys (y1, y2)
  fold_in(k, d)   threefry(k, 0, d)
  bits(k, shape)  y1 ^ y2 of threefry(k, iota_2x32(shape))
  uniform         (bits >> 9 | 0x3F800000) as f32, minus 1, scaled,
                  then max(minval, .)
  gumbel          -log(-log(uniform(minval=tiny, maxval=1))), jax's
                  default mode="low"
  categorical     argmax(logits + gumbel) along the last axis
  normal          sqrt(2)·erf_inv(uniform(nextafter(−1, 0), 1)), with
                  XLA's float32 erf_inv (Giles' polynomial)
  exponential     −log1p(−uniform)
  loggamma        Marsaglia–Tsang per element, one key split per element
  beta            split → (key_a, key_b), two loggammas, normalised in log
                  space

XLA contracts uniform's f·(max − min) + min into a fused multiply-add. The
port forms it in float64 (the product is exact there) and rounds once to
float32, which is the FMA's result unless the float64 sum lands exactly on
a float32 rounding midpoint. For the bounds the system uses, [0, 1) and
[tiny, 1), every form is exact.

Leading axes of a key batch broadcast: a (M, 2) key tensor gives (M, n, 2)
keys from `split` and (M, *shape) draws from `uniform`, as `jax.vmap` over
the key rows would.

`gumbel` evaluates both logs in float64 and rounds once to float32, so the
card and the CPU draw the same noise. XLA's float32 log is not correctly
rounded (an ulp off on ~14% of inputs on the CPU), so the draws agree with
`jax.random.gumbel` to about an ulp, not bit for bit; an argmax over them
(`categorical`) agrees exactly unless two candidates lie within that.

`normal`, `exponential`, `loggamma` and `beta` follow the same rule: every
multiply-add that XLA contracts into an FMA, and every transcendental, is
evaluated in float64 and rounded once to float32. XLA's float32 log1p and
log are its own approximations, so `normal` agrees with
`jax.random.normal` to 4 ulps (99% of draws bit for bit) and `beta` to
2e-6 absolute. Marsaglia–Tsang's rejection test reads those values, so a
draw whose test lands within an ulp of its threshold can be accepted by
one package and rejected by the other; both then go on drawing from the
same keys, and the two results differ. That is a transcendental
divergence, not a PRNG fault.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from repro_torch.core.rewards import exp_f32, log1p_f32, log_f32
from repro_torch.device import resolve_device

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 hash (20 rounds) on int64 lanes; all inputs broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK32
    x1 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """`jax.random.PRNGKey` for a seed in int32 range -> (2,) int64 on
    ``device``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64,
                        device=resolve_device(device))


def _iota(shape: Sequence[int], device) -> torch.Tensor:
    """Low words of `iota_2x32_shape` (the high words are 0 below 2^32)."""
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise ValueError("draws of 2^32 or more elements are not supported")
    return torch.arange(size, dtype=torch.int64, device=device).reshape(
        tuple(shape))


def _hash(key: torch.Tensor, shape: Sequence[int]):
    """threefry(key, iota(shape)) broadcast over the key's leading axes."""
    shape = tuple(shape)
    lead = key.shape[:-1]
    view = lead + (1,) * len(shape)
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    lo = _iota(shape, key.device)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) -> (..., num, 2)."""
    y1, y2 = _hash(key, (num,))
    return torch.stack([y1, y2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """(..., 2) -> (..., 2). ``data`` is an int or an integer tensor that
    broadcasts against the key's leading axes (one datum per key row)."""
    k1, k2 = key[..., 0], key[..., 1]
    if isinstance(data, torch.Tensor):
        d = (data.to(device=key.device, dtype=torch.int64) & MASK32)
        d = d.expand_as(k1)
    else:
        d = torch.full_like(k1, int(data) & MASK32)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(k1), d)
    return torch.stack([y1, y2], dim=-1)


def bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32 random bits per element, as int64: (..., 2) -> (..., *shape)."""
    y1, y2 = _hash(key, shape)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: Union[float, torch.Tensor] = 0.0,
            maxval: Union[float, torch.Tensor] = 1.0) -> torch.Tensor:
    """float32 draws in [minval, maxval): (..., 2) -> (..., *shape)."""
    b = bits(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = f.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.to(torch.float32))


TINY = float(torch.finfo(torch.float32).tiny)


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 standard Gumbel draws: (..., 2) -> (..., *shape)."""
    u = uniform(key, shape, minval=TINY, maxval=1.0).double()
    return (-torch.log(-torch.log(u))).to(torch.float32)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of float32 ``logits`` (..., V), keys (..., 2) ->
    (...) int64: `jax.random.categorical` along the last axis."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, got "
                        f"{logits.dtype}")
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)



# ========================================================= normal and gamma
# XLA's float32 erf_inv (Giles' approximation): Horner coefficients for
# w = −log1p(−x²) below 5 and at 5 or above.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))
_NEG_ONE_UP = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))


def _fma(a, b, c):
    """a·b + c rounded once to float32, as XLA's contracted FMA (the
    float64 product of two float32 values is exact)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: Giles' polynomial in w = −log1p(−x²)."""
    w = -log1p_f32(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 standard normal draws: (..., 2) -> (..., *shape)."""
    u = uniform(key, shape, minval=_NEG_ONE_UP, maxval=1.0)
    return _SQRT2 * _erf_inv(u)


def exponential(key: torch.Tensor, shape: Sequence[int] = ()
                ) -> torch.Tensor:
    """float32 Exp(1) draws: (..., 2) -> (..., *shape)."""
    return -log1p_f32(-uniform(key, shape))


def _loggamma_one(key: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Marsaglia–Tsang in log space on a flat batch: key (E, 2), alpha (E,)
    float32 -> log Gamma(alpha) draws (E,). Every element runs jax's
    `_gamma_one` key for key: an outer rejection loop and, inside it, a
    loop redrawing the normal while v <= 0; both are masked loops over the
    batch, an element's key advancing only while it is still drawing."""
    one = torch.ones_like(alpha)
    boost = alpha >= 1.0
    alpha_b = torch.where(boost, alpha, alpha + 1.0)
    third = torch.full_like(alpha, 1.0 / 3.0)
    d = alpha_b - third
    c = torch.div(third, torch.sqrt(d))
    ks = split(key)
    key, subkey = ks[:, 0], ks[:, 1]
    big_x, big_v, big_u = torch.zeros_like(alpha), one.clone(), 2.0 * one

    def rejects(x2, v3, u):
        first = u >= _fma(torch.full_like(x2, -0.0331), x2 * x2, one)
        rhs = _fma(d, 1.0 - v3 + log_f32(v3), 0.5 * x2)
        return first & (log_f32(u) >= rhs)

    active = rejects(big_x, big_v, big_u)
    while bool(active.any()):
        ks = split(key, 3)
        kx, ku = ks[:, 1], ks[:, 2]
        x, v = torch.zeros_like(alpha), -one
        drawing = active.clone()
        while bool(drawing.any()):
            kk = split(kx)
            xn = normal(kk[:, 1])
            x = torch.where(drawing, xn, x)
            v = torch.where(drawing, _fma(xn, c, one), v)
            kx = torch.where(drawing[:, None], kk[:, 0], kx)
            drawing = drawing & (v <= 0.0)
        u = uniform(ku)
        big_x = torch.where(active, x * x, big_x)
        big_v = torch.where(active, v * v * v, big_v)
        big_u = torch.where(active, u, big_u)
        key = torch.where(active[:, None], ks[:, 0], key)
        active = active & rejects(big_x, big_v, big_u)
    log_samples = log1p_f32(-uniform(subkey))      # −exponential(subkey)
    log_boost = torch.where(boost | (log_samples == 0.0),
                            torch.zeros_like(alpha),
                            log_samples * torch.div(one, alpha))
    return (log_f32(d) + log_f32(big_v)) + log_boost


def loggamma(key: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """float32 log-Gamma(a) draws: key (..., 2), a (..., *shape) whose
    leading axes are the key's -> (..., *shape); one key split per element
    of ``shape``, as `jax.random.loggamma` under `jax.vmap` over the key
    rows."""
    lead = key.shape[:-1]
    a = a.to(torch.float32)
    shape = a.shape[len(lead):]
    keys = split(key, math.prod(shape))               # (..., E, 2)
    out = _loggamma_one(keys.reshape(-1, 2), a.reshape(-1))
    return out.reshape(a.shape)


def beta(key: torch.Tensor, a: torch.Tensor, b: torch.Tensor
         ) -> torch.Tensor:
    """float32 Beta(a, b) draws, keys and shapes as `loggamma`."""
    ks = split(key)
    la = loggamma(ks[..., 0, :], a)
    lb = loggamma(ks[..., 1, :], b)
    log_max = torch.maximum(la, lb)
    ga = exp_f32(la - log_max)
    gb = exp_f32(lb - log_max)
    return ga / (ga + gb)
