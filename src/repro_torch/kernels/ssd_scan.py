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

Bound on the H100 (`csrc/ssd_scan.cu`): bytes, on the tensor cores. The
serving prefill (4 prompts of 2,048 tokens at Mamba2-780M's width: NC 8,
L 256, H 48, P 64, N 128, B/C bf16) moves 0.257 GB (xd read, y and the
states written: 0.077 ms at 3.35 TB/s) and counts C Bᵀ once per chunk and
the two L×L products over their causal half, B·NC·(L²·N + L²·P·H +
2·L·N·P·H) = 13.2 GFLOP: 0.196 ms at 67 TFLOP/s on fp32 CUDA cores, 0.065
ms on the tensor cores as the kernel splits them (C Bᵀ at 989 TFLOP/s
bf16, the scores product three TF32 passes and the state product two at
495 TFLOP/s).

Accuracy, product by product (all mma.sync, fp32 accumulate):

- C Bᵀ from bf16 B/C: one bf16 pass. A product of two bf16 values has at
  most 16 significant bits, so it is exact in fp32, as in the plain
  version; only the order of the sum differs.
- The scores product (C Bᵀ ⊙ exp(acum_i − acum_j)) @ xd has fp32 operands:
  3xTF32. a = a_hi + a_lo, a_hi rounded to TF32, and a·b ≈ a_hi·b_hi +
  a_hi·b_lo + a_lo·b_hi, ~2^-21 of each product. One TF32 pass keeps 10
  mantissa bits, ~1e-3 of a 256-term sum of mixed signs, and fails the
  1e-4 gate this kernel is held to.
- The state product Bᵀ @ (exp(atot − acum) ⊙ xd): the weighted xd is
  formed in fp32, as in the plain version, and split in two; bf16 B is
  exact in TF32, so two passes suffice.
- The decay and the state weights are the SFU's exp (ex2.approx, as
  `__expf`), ~1e-7 of each term that matters.
- fp32 B/C (the reduced configurations) are split as well: three passes
  for C Bᵀ and for the state product.

Design: one launch, one block of 8 warps per (chunk, group of heads), one
block an SM, the heads a block chosen so that the waves of blocks times
the heads a block are fewest (12 heads, 128 blocks at the main shape). B
rows are copied to shared memory once
a block and C rows into registers once a warp (both head-free); each head's
xd rows arrive by cp.async in a double buffer and feed both products, so xd
is read from device memory once. The y product takes C Bᵀ's accumulator
fragments as its A operand (the k index permuted to match), so the scores
never go through shared memory; C Bᵀ is recomputed per head on the tensor
cores rather than kept (a chunk's is 256 KB in fp32). xd and acum are read
in place in their (…, L, H, …) layout; bm/cm through their strides, in
their own dtype (no cast copy), which must be multiples of 16 bytes from a
16-byte aligned base (`check_inputs`; the model's B/C views into the conv
output meet it). Ragged L is bounded, not padded; L above 256 and N above
128 raise. Head dims 16, 32 and 64 are built.
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
MAX_L = 256             # chunk rows a block keeps in shared memory
MAX_N = 128             # state columns (N padded to 64 or 128 in the build)
HEAD_DIMS = (16, 32, 64)     # the reference tests', reduced and full P
BC_ALIGN = 16           # bytes: bm/cm base and strides, for cp.async
BC_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_chunk_plain(xd, acum, bm, cm):
    """Plain PyTorch version (port of `repro.kernels.ref.ssd_chunk`), fp32
    throughout: xd (B,NC,L,H,P), acum (B,NC,L,H), bm/cm (B,NC,L,N) ->
    (y (B,NC,L,H,P), states (B,NC,H,P,N))."""
    xd, acum, bm, cm = (t.float() for t in (xd, acum, bm, cm))
    l = xd.shape[2]
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]   # (B,NC,L,L,H)
    causal = torch.ones((l, l), dtype=torch.bool, device=xd.device).tril()
    # -inf above the diagonal before the exp: the same values as selecting
    # 0 after it, but exp(diff) there can be inf, and its gradient times
    # the select's 0 would be NaN (the reference's `where` has that NaN)
    lmat = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                 torch.full((), -torch.inf,
                                            device=xd.device)))
    cb = torch.einsum("bcin,bcjn->bcij", cm, bm)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * lmat, xd)
    dec_out = torch.exp(acum[:, :, -1:, :] - acum)            # (B,NC,L,H)
    states = torch.einsum("bcln,bclhp->bchpn", bm, xd * dec_out[..., None])
    return y, states


class SSDChunkFn(torch.autograd.Function):
    """`ssd_chunk` with a gradient. The forward is ``forward(xd, acum, bm,
    cm)``: the CUDA kernel's launch on the card (CPU tests pass the plain
    version). The backward recomputes `ssd_chunk_plain` under autograd on
    the saved inputs, as they came (bf16 B/C stay bf16: the plain version
    casts them), and returns its gradients, each in its input's dtype: the
    function whose gradient the reference's training takes (the pure-XLA
    `ssd_chunked`; the TPU kernel has no backward)."""

    @staticmethod
    def forward(ctx, forward, xd, acum, bm, cm):
        ctx.save_for_backward(xd, acum, bm, cm)
        return forward(xd, acum, bm, cm)

    @staticmethod
    def backward(ctx, grad_y, grad_states):
        need = ctx.needs_input_grad[1:5]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(r)
                  for x, r in zip(ctx.saved_tensors, need)]
            outs = ssd_chunk_plain(*xs)
            grads = iter(torch.autograd.grad(
                outs, [x for x, r in zip(xs, need) if r],
                (grad_y, grad_states)))
        return (None, *(next(grads) if r else None for r in need))


def check_inputs(xd, acum, bm, cm) -> None:
    """What the kernel takes: xd (B,NC,L,H,P) and acum (B,NC,L,H) float32,
    contiguous; bm/cm (B,NC,L,N) of one dtype (float32 or bfloat16) whose
    last dim is contiguous and whose base and other strides are multiples
    of BC_ALIGN bytes; all on one device; 1 <= L <= MAX_L, a built head
    dim, 1 <= N <= MAX_N."""
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
    for name, t in (("bm", bm), ("cm", cm)):
        size = t.element_size()
        if t.data_ptr() % BC_ALIGN or any(
                st * size % BC_ALIGN for st in t.stride()[:3]):
            raise ValueError(
                f"ssd_chunk: {name} needs a {BC_ALIGN}-byte aligned base and "
                f"strides (B, NC, L) that are multiples of {BC_ALIGN} bytes "
                f"({BC_ALIGN // size} elements), got offset "
                f"{t.data_ptr() % BC_ALIGN} bytes, strides {t.stride()[:3]}")
    if not 1 <= l <= MAX_L:
        raise ValueError(f"ssd_chunk is built for chunks of 1..{MAX_L} "
                         f"rows, got {l}")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_chunk is built for head dims {HEAD_DIMS}, "
                         f"got {p}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"ssd_chunk is built for states of 1..{MAX_N} "
                         f"columns, got N = {n}")


def ssd_chunk_cuda(lib, xd, acum, bm, cm):
    """Launch the kernel on the current stream; see `check_inputs`."""
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
