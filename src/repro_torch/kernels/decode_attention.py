"""decode_attention: one query token against a KV cache, as a CUDA kernel.

Replaces the Pallas TPU kernel `repro/kernels/decode_attention.py:
decode_attention`. For q (B, 1, H, hd), a cache k/v (B, T, KV, hd) and pos
(a scalar or one int per row), each row attends to its slots 0..pos with an
fp32 softmax (slots past pos masked with -1e30); the output is in q's dtype.

Bound on the H100: bytes. A row must read K and V up to its pos: at the
serving path's decode step (B 8, KV 4, hd 128, bf16, pos up to ~3,050)
about 35 MB per call, ~10 µs at 3.35 TB/s, against ~0.1 GFLOP. So a call
costs a few launches' worth, and its 32 calls per step are small against
the step's 14.8 GB weight read (~4.4 ms).

Design (`csrc/decode_attention.cu`): one block per (KV head, row, split
of T) serving the KV head's n_rep query heads, so every cache row is read
once (the Pallas grid's block per query head would read it n_rep = 9
times). A split covers up to 8 tiles of 64 slots and stops at min(pos,
T-1), which is the Pallas kernel's block skip; splitting T turns the 32
(KV head, row) pairs of the serving shape into 256 blocks. Tiles are staged
with 16-byte loads and reduced with an fp32 online softmax per head; a
second kernel merges the splits' (m, l, acc) from a scratch buffer this
wrapper allocates. head_dim 64 and 128 are built, n_rep·hd <= 2,048.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.flash_attention import (DTYPE_CODES, NEG_INF,
                                                 check_qkv, repeat_kv)

NAME = "decode_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:67"
ENTRY = "decode_attention_launch"
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
MAX_OUT = 2048          # n_rep · hd a block's threads hold


def row_positions(pos, b: int, device) -> torch.Tensor:
    """A scalar or (B,) pos as a (B,) int32 tensor on ``device``."""
    p = torch.as_tensor(pos, device=device)
    if p.dtype.is_floating_point or p.dtype == torch.bool:
        raise TypeError(f"pos must be an integer, got {p.dtype}")
    if p.dim() > 1 or (p.dim() == 1 and p.shape[0] != b):
        raise ValueError(f"pos must be a scalar or ({b},), got "
                         f"{tuple(p.shape)}")
    return p.to(torch.int32).expand(b).contiguous()


def decode_attention_plain(q, k, v, pos):
    """Plain PyTorch version (port of `repro.kernels.ref.decode_attention`):
    q (B,1,H,hd); cache k/v (B,T,KV,hd); pos scalar or (B,)."""
    b, _, h, hd = q.shape
    t = k.shape[1]
    k = repeat_kv(k, h // k.shape[2])
    v = repeat_kv(v, h // v.shape[2])
    sc = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) / math.sqrt(hd)
    pos_r = row_positions(pos, b, q.device)
    valid = torch.arange(t, device=q.device)[None, :] <= pos_r[:, None]
    sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("bhst,bthk->bshk", w, v.float()).to(q.dtype)


def decode_attention_cuda(lib, q, k, v, pos):
    """Launch the kernel on the current stream: q (B,1,H,hd), cache k/v
    (B,T,KV,hd) contiguous CUDA tensors of one dtype, pos scalar or (B,)."""
    check_qkv("decode_attention", q, k, v)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if s != 1:
        raise ValueError(f"decode_attention takes one query token, got {s}")
    if (h // kv) * hd > MAX_OUT:
        raise ValueError(f"decode_attention takes n_rep·head_dim <= "
                         f"{MAX_OUT}, got {h // kv}·{hd}")
    if t == 0:
        raise ValueError("decode_attention: the cache has no slots")
    pos_r = row_positions(pos, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    splits_fn = lib.decode_attention_splits
    splits_fn.argtypes, splits_fn.restype = [ctypes.c_int], ctypes.c_int
    splits = splits_fn(t)
    part = (torch.empty(b * kv * splits * (h // kv) * (hd + 2),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_r.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        DTYPE_CODES[q.dtype], b, t, h, kv, hd,
        q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    return out
