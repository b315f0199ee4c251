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
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

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
