"""topn_lp: the relaxed solve's scalar cost probe, as a CUDA kernel.

Replaces the Pallas TPU kernel `repro/kernels/topn_lp.py:topn_lp`. For
(B, K) score/cost rows and a per-row n it returns

    out_b = Σ_k cost_bk · [stable_desc_rank(score_b)_k < n_b]        (B,)

times [score_bk > 0] when ``equality`` is False; the lower index wins ties.

Bound on the H100: bytes. At the main path's K = 9 a row is two 36-byte
rows in and 4 bytes out against ~81 compares, far below the compute roof;
the widest call, 2,731 tenants × 64 λ probes = 174,784 rows, moves ~14 MB
(≈ 4.2 µs at 3.35 TB/s).

Design (`csrc/topn_lp.cu`): at K <= 32, a thread per row. A block stages
its rows' score and cost spans in shared memory with coalesced 16-byte
loads; each thread pulls its row into registers and counts the K² stable
rank compares fully unrolled (a template over a K cap of 16 or 32), and
sums the masked costs in arm-index order with `__fmul_rn` / `__fadd_rn`,
the order and roundings of `topn_lp_plain`, so the two agree to the bit.
Wider rows take a warp per row, ranks counted over a loop on j.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.device import check_tensor as check
from repro_torch.core.ranks import topn_lp_cost

NAME = "topn_lp"
SOURCE = Path(__file__).resolve().parent / "csrc" / "topn_lp.cu"
REPLACES = "src/repro/kernels/topn_lp.py:56"
ENTRY = "topn_lp_launch"
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
MAX_K = 29056      # a row pair must fit the 227 KB of shared memory


def topn_lp_plain(score, cost, n, *, equality: bool = True):
    """Plain PyTorch version (port of `repro.kernels.ref.topn_lp`):
    score/cost (B, K), n (B,) -> (B,) float32."""
    return topn_lp_cost(score, cost, n, equality)


def topn_lp_cuda(lib, score, cost, n, *, equality: bool = True):
    """Launch the kernel on the current stream; inputs must be contiguous
    CUDA tensors: score/cost (B, K) float32, n (B,) int32."""
    if score.dim() != 2:
        raise ValueError(f"score must be (B, K), got {tuple(score.shape)}")
    b, k = score.shape
    if k > MAX_K:
        raise ValueError(f"topn_lp takes K <= {MAX_K}, got {k}")
    check("score", score, torch.float32, (b, k), score.device)
    check("cost", cost, torch.float32, (b, k), score.device)
    check("n", n, torch.int32, (b,), score.device)
    out = torch.empty((b,), dtype=torch.float32, device=score.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(score.device).cuda_stream
    err = lib.topn_lp_launch(score.data_ptr(), cost.data_ptr(), n.data_ptr(),
                             out.data_ptr(), b, k, int(bool(equality)),
                             stream)
    if err != 0:
        raise RuntimeError(f"topn_lp launch failed: cudaError {err}")
    return out
