"""Rotary position embeddings (port of `repro/models/rope.py`): standard
RoPE and the sectioned M-RoPE of the VLM family (Qwen2-VL).

M-RoPE splits the rotary half-dim into 3 sections driven by (temporal,
height, width) position ids; for a text-only stream all three ids coincide
and it gives RoPE's values. Frequencies are computed in numpy float32
exactly as the JAX package computes them, angles in float32, and cos/sin
cast to x's dtype. Beside DTensor positions the frequencies are a
replicated DTensor on their mesh.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.sharding import replicate_like


def _freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device):
    """`_freqs` as a tensor on ``device``, copied there once: a copy from
    the host on every call would synchronise the card once per layer."""
    return torch.from_numpy(_freqs(head_dim, theta)).to(device)


def _inv_freqs(positions, head_dim: int, theta: float):
    """`_freqs` on positions' device; beside DTensor positions a
    replicated DTensor on their mesh."""
    return replicate_like(_freqs_on(head_dim, float(theta), positions.device),
                          positions)


def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) -> angles (..., S, head_dim//2) in fp32."""
    return positions[..., None].float() * _inv_freqs(positions, head_dim,
                                                     theta)


def _rotate(x, ang):
    """x (B,S,H,Dh) rotated by angles (B,S,Dh//2) in fp32."""
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x (B,S,H,Dh); positions (B,S)."""
    return _rotate(x, rope_angles(positions, x.shape[-1], theta))


def mrope_sections(head_dim: int):
    """3 sections over the half rotary dim (t/h/w), Qwen2-VL style."""
    half = head_dim // 2
    a = half // 4
    return (half - 2 * a, a, a)  # temporal gets the largest share


def apply_mrope(x, positions3, theta: float = 10_000.0):
    """x (B,S,H,Dh); positions3 (3,B,S) = (temporal, height, width) ids."""
    head_dim = x.shape[-1]
    inv = _inv_freqs(positions3, head_dim, theta)
    angs, off = [], 0
    for i, sec in enumerate(mrope_sections(head_dim)):
        angs.append(positions3[i][..., None].float() * inv[off:off + sec])
        off += sec
    return _rotate(x, torch.cat(angs, dim=-1))               # (B,S,half)


def positional(cfg, positions):
    """Dispatch helper: returns a function q_or_k -> rotated q_or_k."""
    if cfg.rope == "none":
        return lambda x: x
    if cfg.rope == "mrope":
        if positions.dim() == 2:  # text-only stream: t=h=w
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return lambda x: apply_mrope(x, positions, cfg.rope_theta)
    return lambda x: apply_rope(x, positions, cfg.rope_theta)
