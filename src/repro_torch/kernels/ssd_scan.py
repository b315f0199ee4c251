"""ssd_chunk: the Mamba2 SSD intra-chunk dual form, as a CUDA kernel.

Replaces the Pallas TPU kernel `repro/kernels/ssd_scan.py:ssd_chunk`. For
xd (B, NC, L, H, P) (the inputs times dt), acum (B, NC, L, H) (the
inclusive cumulative log decay within each chunk) and bm/cm (B, NC, L, N)
(one B/C group, shared by the heads) it returns, in fp32,

    y_intra[i, h]  = Σ_{j<=i} (C_i · B_j) · exp(acum_ih − acum_jh) · xd[j, h]
    states[h]      = Σ_l exp(acum_{L-1,h} − acum_lh) · xd[l, h] ⊗ B_l

as y (B, NC, L, H, P) and states (B, NC, H, P, N). The decay is selected,
never multiplied, to zero above the diagonal: exp(acum_i − acum_j) for
j > i can be inf, and inf · 0 would be NaN.

Bound on the H100: operations. The serving prefill (4 prompts of 2,048
tokens at Mamba2-780M's width: NC 8, L 256, H 48, P 64, N 128) counts C Bᵀ
once per chunk and the two L×L products over their causal half,
B·NC·(L²·N + L²·P·H + 2·L·N·P·H) ≈ 13.2 GFLOP, ~0.20 ms at 67 TFLOP/s fp32,
against ~0.26 GB of inputs and outputs (~0.08 ms at 3.35 TB/s). The
products stay in fp32 on the CUDA cores: TF32 would round them to 10
mantissa bits and lose parity with the plain version.

Design (`csrc/ssd_scan.cu`): two kernels per launch. The first gives a
block one 64-row tile of one chunk and 8 of its heads: it forms the tile's
rows of C Bᵀ up to the diagonal once, in shared memory, and reuses them for
each head, so C Bᵀ is not recomputed per head; each head's scores are that
tile times its decay, then times xd, register-blocked 4×4 per thread. The
second gives a block one head and 64 state columns of a chunk. xd and acum
are read in place in their (…, L, H, …) layout (the Pallas wrapper copies H
in front of L), bm/cm through their strides (they are views into the conv
output), in their own dtype (bf16 or fp32, widened on load: no cast copy).
Ragged L (a prompt shorter than the chunk) is bounded, not padded; L above
256 raises. Head dims 16, 32 and 64 are built.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

NAME = "ssd_chunk"
SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:49"
ENTRY = "ssd_chunk_launch"
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
MAX_L = 256             # rows of C Bᵀ a block keeps in shared memory
HEAD_DIMS = (16, 32, 64)     # the reference tests', reduced and full P
BC_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_chunk_plain(xd, acum, bm, cm):
    """Plain PyTorch version (port of `repro.kernels.ref.ssd_chunk`), fp32
    throughout: xd (B,NC,L,H,P), acum (B,NC,L,H), bm/cm (B,NC,L,N) ->
    (y (B,NC,L,H,P), states (B,NC,H,P,N))."""
    xd, acum, bm, cm = (t.float() for t in (xd, acum, bm, cm))
    l = xd.shape[2]
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]   # (B,NC,L,L,H)
    causal = torch.ones((l, l), dtype=torch.bool, device=xd.device).tril()
    lmat = torch.where(causal[None, None, :, :, None], torch.exp(diff),
                       torch.zeros((), device=xd.device))
    cb = torch.einsum("bcin,bcjn->bcij", cm, bm)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * lmat, xd)
    dec_out = torch.exp(acum[:, :, -1:, :] - acum)            # (B,NC,L,H)
    states = torch.einsum("bcln,bclhp->bchpn", bm, xd * dec_out[..., None])
    return y, states


def check_inputs(xd, acum, bm, cm) -> None:
    """What the kernel takes: xd (B,NC,L,H,P) and acum (B,NC,L,H) float32,
    contiguous; bm/cm (B,NC,L,N) of one dtype (float32 or bfloat16) whose
    last dim is contiguous; all on one device; 1 <= L <= MAX_L, a built
    head dim, N >= 1."""
    if xd.dim() != 5:
        raise ValueError(f"ssd_chunk: xd must be (B,NC,L,H,P), got "
                         f"{tuple(xd.shape)}")
    b, nc, l, h, p = xd.shape
    n = bm.shape[-1] if bm.dim() == 4 else -1
    for name, t, shape in (("acum", acum, (b, nc, l, h)),
                           ("bm", bm, (b, nc, l, n)),
                           ("cm", cm, (b, nc, l, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_chunk: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != xd.device:
            raise ValueError(f"ssd_chunk: {name} is on {t.device}, xd on "
                             f"{xd.device}")
    for name, t in (("xd", xd), ("acum", acum)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk: {name} must be contiguous")
    if xd.data_ptr() % 16:
        raise ValueError("ssd_chunk: xd must be 16-byte aligned")
    if bm.dtype != cm.dtype or bm.dtype not in BC_DTYPE_CODES:
        raise TypeError(f"ssd_chunk: bm and cm must share float32 or "
                        f"bfloat16, got {bm.dtype}, {cm.dtype}")
    if bm.stride(3) != 1 or cm.stride(3) != 1:
        raise ValueError("ssd_chunk: bm and cm must be contiguous along N")
    if not 1 <= l <= MAX_L:
        raise ValueError(f"ssd_chunk is built for chunks of 1..{MAX_L} "
                         f"rows, got {l}")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_chunk is built for head dims {HEAD_DIMS}, "
                         f"got {p}")
    if n < 1:
        raise ValueError("ssd_chunk: the state has no columns (N = 0)")


def ssd_chunk_cuda(lib, xd, acum, bm, cm):
    """Launch the kernels on the current stream; see `check_inputs`."""
    check_inputs(xd, acum, bm, cm)
    b, nc, l, h, p = xd.shape
    n = bm.shape[3]
    y = torch.empty((b, nc, l, h, p), dtype=torch.float32, device=xd.device)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                         device=xd.device)
    if y.numel() == 0:
        return y, states
    stream = torch.cuda.current_stream(xd.device).cuda_stream
    err = lib.ssd_chunk_launch(
        xd.data_ptr(), acum.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        y.data_ptr(), states.data_ptr(), BC_DTYPE_CODES[bm.dtype],
        b, nc, l, h, p, n, *bm.stride()[:3], *cm.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: cudaError {err}")
    return y, states
