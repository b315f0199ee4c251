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
times). A split stops at min(pos, T-1), which is the Pallas kernel's block
skip, and a block whose split starts past pos exits before any load.
`split_plan` picks the split length from T and B·KV so that a full cache
gives about two blocks per SM, and no split is shorter than 256 slots (448
slots at the serving shape). The splits' (m, l, acc) go to a scratch
buffer this wrapper allocates per call; for bf16 the last block of a row
to finish merges them, counted in (row, KV head) counters at the end of
that scratch, which the launch zeroes in stream order (a memset before the
kernel), so calls on several streams or in a CUDA graph share nothing; for
fp32 a second kernel merges. The bf16 kernel runs both products on the tensor
cores (mma.sync, the n_rep heads as M rows), each warp streaming its 16
slots of every 64-slot tile through a 3-stage cp.async ring; the fp32
kernel stages fp32 tiles and runs on the CUDA cores.

head_dim 64, 80, 120 and 128 are built, each read in place (no pad copy),
with n_rep·hd <= 2,048: n_rep up to 32 at hd 64, 25 at 80, 17 at 120 and
16 at 128. At 80 and 120 the bf16 kernel stages 128-column rows (Q Kᵀ's
last k step at 120 reads one zero-filled chunk past hd). H2O-Danube's
decode (hd 120, n_rep 4) over a full 4,096-slot ring at 8 rows reads
~126 MB, a bound of ~0.038 ms; Zamba2's (hd 80, n_rep 1) ~336 MB, ~0.100 ms.

A sliding-window ring cache (slot = pos % T) needs no mask of its own: its
valid slots, age < min(pos + 1, T), are the slots <= min(pos, T - 1) the
kernel reads, and the softmax does not depend on slot order, so the caller
passes the raw pos.

`decode_attention_cuda(..., lse=True)` also returns each (row, head)'s
log-sum-exp of its scaled scores, (B, H) fp32 (-inf for a row with no
slot), from the same launch: the kernel writes it beside the output, which
it computes as without it. `decode_attention_lse_plain` is its plain
version. A cache split over devices along T ("cache_seq") runs the kernel
on each block and combines the blocks' outputs by their lse
(`merge_partials`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels.flash_attention import (DTYPE_CODES, NEG_INF,
                                                 check_qkv, repeat_kv)

NAME = "decode_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:67"
ENTRY = "decode_attention_launch"
ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
HEAD_DIMS = (64, 80, 120, 128)   # all built, no pad route
MAX_OUT = 2048          # n_rep · hd a block's threads hold
TILE = 64               # slots per tile
FP32_SPLIT_TILES = 8    # the fp32 kernel's split: 512 slots
WAVES = 2               # bf16: blocks per SM over a full cache
MIN_SPLIT_TILES = 4     # bf16: a split streams at least 256 slots
MAX_SPLITS = 64         # bf16: splits of T a row's last block merges


def split_plan(t: int, bkv: int, dtype, sms: int):
    """(tiles per split, splits) for a cache of ``t`` slots, ``bkv`` (row,
    KV head) pairs and a card of ``sms`` SMs. A bf16 split is as long as
    lets a full cache give ``WAVES`` blocks per SM (rows with half the
    cache in use then give one), but at least ``MIN_SPLIT_TILES`` tiles,
    which a block's start-up and the merge would not repay below, and at
    most ``MAX_SPLITS`` splits; fp32 keeps 8 tiles."""
    tiles = -(-t // TILE)
    if dtype == torch.float32:
        per = FP32_SPLIT_TILES
    else:
        per = max(MIN_SPLIT_TILES, tiles * bkv // (WAVES * sms),
                  -(-tiles // MAX_SPLITS))
    per = min(per, tiles)
    return per, -(-tiles // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_positions(pos, b: int, device) -> torch.Tensor:
    """A scalar or (B,) pos as a (B,) int32 tensor on ``device``."""
    p = torch.as_tensor(pos, device=device)
    if p.dtype.is_floating_point or p.dtype == torch.bool:
        raise TypeError(f"pos must be an integer, got {p.dtype}")
    if p.dim() > 1 or (p.dim() == 1 and p.shape[0] != b):
        raise ValueError(f"pos must be a scalar or ({b},), got "
                         f"{tuple(p.shape)}")
    return p.to(torch.int32).expand(b).contiguous()


def _masked_scores(q, k, pos):
    """fp32 scaled scores (B, H, 1, T) with slots past pos at -1e30, and
    the (B, T) validity mask."""
    b, _, h, hd = q.shape
    t = k.shape[1]
    k = repeat_kv(k, h // k.shape[2])
    sc = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) / math.sqrt(hd)
    pos_r = row_positions(pos, b, q.device)
    valid = torch.arange(t, device=q.device)[None, :] <= pos_r[:, None]
    sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    return sc, valid


def _attend(q, v, sc):
    w = torch.softmax(sc, dim=-1)
    v = repeat_kv(v, q.shape[2] // v.shape[2])
    return torch.einsum("bhst,bthk->bshk", w, v.float()).to(q.dtype)


def decode_attention_plain(q, k, v, pos):
    """Plain PyTorch version (port of `repro.kernels.ref.decode_attention`):
    q (B,1,H,hd); cache k/v (B,T,KV,hd); pos scalar or (B,)."""
    return _attend(q, v, _masked_scores(q, k, pos)[0])


def decode_attention_lse_plain(q, k, v, pos):
    """`decode_attention_plain`'s output and each (row, head)'s log-sum-exp
    of its valid scaled scores, (B, H) fp32: -inf for a row with no valid
    slot, whose output (the mean of v, from the softmax over -1e30 scores)
    then weighs nothing beside a block that has one (`merge_partials`)."""
    sc, valid = _masked_scores(q, k, pos)
    lse = torch.logsumexp(torch.where(valid[:, None, :], sc[:, :, 0],
                                      torch.full_like(sc[:, :, 0],
                                                      -math.inf)), -1)
    return _attend(q, v, sc), lse


def merge_partials(o, lse, group=None):
    """Combine the outputs of attention over blocks of a cache's slots by
    their log-sum-exps: o (..., B, 1, H, hd), lse (..., B, H) fp32, each
    block's softmax output and log-sum-exp. Without ``group`` the blocks
    are the leading dim of ``o`` and ``lse``; with one (a process group, or
    a mesh and its dim as `torch.distributed._functional_collectives`
    takes it) each rank holds one block, and an all-reduce of the max and
    two of sums combine them (every rank gets the result). Returns (B, 1,
    H, hd) in ``o``'s dtype: sum_r exp(lse_r - M) o_r / sum_r exp(lse_r -
    M), M the max. A block with lse -inf weighs nothing; when every block
    has -inf (a row with no valid slot anywhere) the result is the plain
    mean of the blocks' outputs, which is what one call over the whole
    cache gives: zeros from the kernel (zeros each block), the mean of v
    from the plain version (the mean of each equal block's)."""
    lse = lse.float()
    if group is None:
        m = lse.amax(0)
    else:
        m = _all_reduce(lse, "max", group)
    none = torch.isneginf(m)
    w = torch.exp(lse - torch.where(none, torch.zeros_like(m), m))
    w = torch.where(none, torch.ones_like(w), w)       # (..., B, H)
    num = w[..., None, :, None] * o.float()
    if group is None:
        num, den = num.sum(0), w.sum(0)
    else:
        num, den = (_all_reduce(num, "sum", group),
                    _all_reduce(w, "sum", group))
    return (num / den[:, None, :, None]).to(o.dtype)


def _all_reduce(t, op: str, group):
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


def decode_attention_cuda(lib, q, k, v, pos, *, lse: bool = False):
    """Launch the kernel on the current stream: q (B,1,H,hd), cache k/v
    (B,T,KV,hd) contiguous CUDA tensors of one dtype, pos scalar or (B,).
    Returns the output, and with ``lse`` (output, (B, H) fp32 log-sum-exp)
    from the same launch."""
    check_qkv(NAME, q, k, v, HEAD_DIMS)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if s != 1:
        raise ValueError(f"decode_attention takes one query token, got {s}")
    if (h // kv) * hd > MAX_OUT:
        raise ValueError(f"decode_attention takes n_rep·head_dim <= "
                         f"{MAX_OUT}, got {h // kv}·{hd}")
    if t == 0:
        raise ValueError("decode_attention: the cache has no slots")
    if (isinstance(pos, torch.Tensor) and pos.dtype == torch.int32
            and pos.device == q.device and pos.shape == (b,)
            and pos.is_contiguous()):
        pos_r = pos                  # the serving path's pos: no copy
    else:
        pos_r = row_positions(pos, b, q.device)
    out = torch.empty_like(q)
    lse_out = (torch.empty((b, h), dtype=torch.float32, device=q.device)
               if lse else None)
    if b == 0:
        return (out, lse_out) if lse else out
    per, splits = split_plan(t, b * kv, q.dtype, _sm_count(q.device.index))
    part = count = None
    if splits > 1:
        # (m, l, acc) of every split, then bf16's int32 split counters
        n_part = b * kv * splits * (h // kv) * (hd + 2)
        scratch = torch.empty(n_part + b * kv, dtype=torch.float32,
                              device=q.device)
        part = scratch.data_ptr()
        if q.dtype == torch.bfloat16:
            count = part + 4 * n_part
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_r.data_ptr(),
        out.data_ptr(), part, count,
        lse_out.data_ptr() if lse else None, DTYPE_CODES[q.dtype], b, t, h,
        kv, hd,
        per, splits,
        q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    return (out, lse_out) if lse else out
