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

head_dim 80 (zamba2-2.7b) and 120 (h2o-danube-3-4b) take the pad route:
`pad_head_dim` zero-pads q, k and v to 128 columns, the hd-128 kernel runs
with the true 1/sqrt(hd) as its scale (zero columns add nothing to Q Kᵀ,
and V's only fill the output columns that are cut off), and the first hd
columns are copied out. The copies and the 128/hd extra work are the
price; a build that reads 120 or 80 columns in place is ROADMAP B3c.
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
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
            + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
NEG_INF = -1e30
BUILT_HEAD_DIMS = (64, 128)       # the head_dims the CUDA source builds
PAD_TO = 128                      # the build the other head_dims pad to
HEAD_DIMS = (64, 80, 120, 128)    # what the wrapper takes (80, 120 padded)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def repeat_kv(k, n_rep: int):
    """(B, T, KV, hd) -> (B, T, KV·n_rep, hd), each KV head repeated."""
    if n_rep == 1:
        return k
    b, t, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, kv, n_rep, hd).reshape(
        b, t, kv * n_rep, hd)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None):
    """Plain PyTorch version (port of `repro.kernels.ref.flash_attention`):
    q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd), fp32 softmax; scores
    scaled by ``scale``, 1/sqrt(hd) by default."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    k = repeat_kv(k, h // k.shape[2])
    v = repeat_kv(v, h // v.shape[2])
    sc = torch.einsum("bshk,bthk->bhst", q.float(), k.float())
    sc = sc * scale if scale is not None else sc / math.sqrt(hd)
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


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention` with a gradient. The forward is ``forward(q, k, v,
    causal=, window=)``: the CUDA kernel's launch on the card (CPU tests
    pass the plain version). The backward recomputes
    `flash_attention_plain` under autograd on the saved q, k and v and
    returns its gradient: the function whose gradient the reference's
    training takes (XLA's attention; the TPU kernel has no backward)."""

    @staticmethod
    def forward(ctx, forward, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return forward(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[1:4]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(r)
                  for x, r in zip(ctx.saved_tensors, need)]
            out = flash_attention_plain(*xs, causal=ctx.causal,
                                        window=ctx.window)
            grads = iter(torch.autograd.grad(
                out, [x for x, r in zip(xs, need) if r], grad))
        return (None, *(next(grads) if r else None for r in need), None,
                None)


def check_qkv(name: str, q, k, v,
              head_dims: tuple = BUILT_HEAD_DIMS) -> None:
    """What both attention kernels take: contiguous, 16-byte aligned 4-d q,
    k, v on one device, in one dtype (float32 or bfloat16), k and v of one
    shape, whole KV groups, and one of the kernel ``name``'s ``head_dims``
    (each kernel module passes its own `HEAD_DIMS`)."""
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
    if hd not in head_dims:
        raise ValueError(f"{name} is built for head_dim {head_dims}, "
                         f"got {hd}")


def pad_head_dim(q, k, v):
    """The pad route of a head_dim the source does not build: (q, k, v)
    zero-padded along hd to `PAD_TO` columns, and 1/sqrt(hd) of the true
    hd. A built head_dim comes back as it is."""
    hd = q.shape[3]
    if hd not in BUILT_HEAD_DIMS:
        q, k, v = (torch.nn.functional.pad(x, (0, PAD_TO - hd))
                   for x in (q, k, v))
    return q, k, v, 1.0 / math.sqrt(hd)


def row_error_ratio(out, want, rtol: float = 1e-2,
                    atol: float = 1e-4) -> float:
    """The worst (row, head) output vector's max |out − want| over
    rtol · max |want| + atol: above 1, some vector misses by more than its
    own scale allows. out/want (B, S, H, hd)."""
    out, want = out.float(), want.float()
    err = (out - want).abs().amax(dim=-1)
    return (err / (rtol * want.abs().amax(dim=-1) + atol)).max().item()


def flash_attention_cuda(lib, q, k, v, *, causal: bool = True,
                         window: Optional[int] = None):
    """Launch the kernel on the current stream: q (B,S,H,hd), k/v
    (B,T,KV,hd) contiguous CUDA tensors of one dtype."""
    check_qkv(NAME, q, k, v, HEAD_DIMS)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if q.numel() == 0 or t == 0:
        if q.numel():
            raise ValueError("flash_attention: no keys to attend to")
        return torch.empty_like(q)
    q, k, v, scale = pad_head_dim(q, k, v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], b, s, t, h, kv, q.shape[3], scale,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(bool(causal)), int(window is not None),
        int(window or 0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    return out if out.shape[3] == hd else out[..., :hd].contiguous()
