"""Rotary position embeddings (port of `repro/models/rope.py`).

Standard RoPE only; the sectioned M-RoPE of the VLM family waits for its
slice. Frequencies are computed in numpy float32 exactly as the JAX
package computes them, angles in float32, and cos/sin cast to x's dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device):
    """`_freqs` as a tensor on ``device``, copied there once: a copy from
    the host on every call would synchronise the card once per layer."""
    return torch.from_numpy(_freqs(head_dim, theta)).to(device)


def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) -> angles (..., S, head_dim//2) in fp32."""
    inv = _freqs_on(head_dim, float(theta), positions.device)
    return positions[..., None].float() * inv


def apply_rope(x, positions, theta: float = 10_000.0):
    """x (B,S,H,Dh); positions (B,S)."""
    ang = rope_angles(positions, x.shape[-1], theta)          # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def positional(cfg, positions):
    """Dispatch helper: returns a function q_or_k -> rotated q_or_k."""
    if cfg.rope == "none":
        return lambda x: x
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE waits for the VLM family "
                                  "(ROADMAP.md, A24)")
    return lambda x: apply_rope(x, positions, cfg.rope_theta)
