"""flash_attention: tiled GQA prefill attention, as a CUDA kernel.

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py:
flash_attention`. For q (B, S, H, hd) and k/v (B, T, KV, hd), query head h
reads KV head h // n_rep, scores are scaled by 1/sqrt(hd), masked causally
(kpos <= qpos) and/or to a window (kpos > qpos - window) with -1e30, and
softmaxed in fp32; the output is in q's dtype.

Bound on the H100: operations. The serving path's prefill (B 4, S 2,048,
H 36, hd 128, bf16, causal) is 2·S²·hd·H·B ≈ 155 GFLOP against ~38 MB of
q/k/v/o, ~0.16 ms at the tensor cores' 989 TFLOP/s. fp32 inputs run on the
CUDA cores in fp32, so they stay exact to fp32.

Design of the bf16 kernel (`csrc/flash_attention.cu`,
`flash_attention_wgmma_kernel`), FlashAttention-3's structure: a block of
three warpgroups takes 128 query rows of one (head, batch row). Warpgroup 0
is the producer: one thread copies Q once, and K and V 128 keys at a time
into a 3-stage ring of shared-memory buffers, with TMA over 4-d tensor maps
built from the caller's strides (so the (B, S, H, hd) layout is read in
place, and rows past S or T arrive as zeros), behind a "full" and an
"empty" mbarrier per stage. Warpgroups 1 and 2 each own 64 rows: S = Q Kᵀ
and O += P V are wgmma products (bf16 in, fp32 accumulate; P from
registers, V read N-major straight from its tile). Each tile's Q Kᵀ is
issued together with the previous tile's P V, so a tile's softmax runs
while the previous tile's P V is on the tensor cores, and the two
warpgroups take turns to issue. P enters P V as two bf16 parts (~16 bits).
m, l and O stay in registers for the whole loop (the Pallas kernel's
sequential kv grid axis, carried in VMEM there). Tiles outside the causal
or window band are not loaded; the heaviest causal q tiles are launched
first. Ragged S and T are bounded, so the port has no S % 256 rule.
head_dim 64 and 128 are built. The fp32 kernel keeps the simpler design of
`flash_attention_kernel`: 64-row blocks of 128 threads over 64-key tiles.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:89"
ENTRY = "flash_attention_launch"
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
NEG_INF = -1e30
HEAD_DIMS = (64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def repeat_kv(k, n_rep: int):
    """(B, T, KV, hd) -> (B, T, KV·n_rep, hd), each KV head repeated."""
    if n_rep == 1:
        return k
    b, t, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, kv, n_rep, hd).reshape(
        b, t, kv * n_rep, hd)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None):
    """Plain PyTorch version (port of `repro.kernels.ref.flash_attention`):
    q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd), fp32 softmax."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    k = repeat_kv(k, h // k.shape[2])
    v = repeat_kv(v, h // v.shape[2])
    sc = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) / math.sqrt(hd)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("bhst,bthk->bshk", w, v.float()).to(q.dtype)


def check_qkv(name: str, q, k, v) -> None:
    """What both attention kernels take: contiguous, 16-byte aligned 4-d q,
    k, v on one device, in one dtype (float32 or bfloat16), k and v of one
    shape, whole KV groups, and a built head_dim."""
    for n, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"{name}: {n} must be 4-d, got {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name}: {n} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name}: q, k and v must share a dtype, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be 16-byte aligned (the "
                             "kernels read rows in 16-byte pieces)")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch or head_dim")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} is built for head_dim {HEAD_DIMS}, "
                         f"got {hd}")


def flash_attention_cuda(lib, q, k, v, *, causal: bool = True,
                         window: Optional[int] = None):
    """Launch the kernel on the current stream: q (B,S,H,hd), k/v
    (B,T,KV,hd) contiguous CUDA tensors of one dtype."""
    check_qkv("flash_attention", q, k, v)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0 or t == 0:
        if out.numel():
            raise ValueError("flash_attention: no keys to attend to")
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], b, s, t, h, kv, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(bool(causal)), int(window is not None),
        int(window or 0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    return out
