"""awc_fw: the fused AWC Frank-Wolfe gradient + λ probes, as a CUDA kernel.

Replaces the Pallas TPU kernel `repro/kernels/awc_fw.py:awc_fw`. Per row of
(z̃, μ, c) with a λ row and a cardinality n it returns the multilinear
gradient

    g_k = μc_k · exp(Σ_j log1p(−μc_j z̃_j) − log1p(−μc_k z̃_k)),
    μc = clip(μ, 0, 1 − 1e−6)

and, for each λ, the inclusive-matroid top-n cost of the scores g − λc,
masked by g > λc: (g (B, K), costs (B, G)). log1p and exp are evaluated in
double and rounded once to float, so the kernel, the plain version and the
CPU give the same gradient bits (`core.rewards.log_f32`).

The ranks use the crossing form of `core.ranks` ((g_j − g_i) > λ(c_j − c_i),
index order on equality; positivity g_i > λc_i) with `__fsub_rn` and
`__fmul_rn`: the Pallas body's g − λc would be contracted into an FMA by
nvcc's default ``--fmad=true``, the hazard the `core.ranks` docstring
describes.

Bound on the H100: operations, and in practice the launch. At the main
path's shape (1,365 AWC tenants, K = 9, G = 25) a call moves ~0.5 MB and
does ~12 M operations, each well under a microsecond of the card's rates,
and the FW loop issues 8 calls a round.

Design (`csrc/awc_fw.cu`): at K <= 32 a block takes R rows (R·G close to
256 threads). A thread per (row, arm) forms the log terms in shared
memory, sums its row's in arm-index order and writes g; then a thread per
(row, λ) holds the row's g and c in registers, counts the K² crossing
compares fully unrolled and sums the masked costs in arm-index order —
the order `awc_fw_plain` sums in. Wider rows take a warp per row, the λ's
in turn.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.device import check_tensor as check
from repro_torch.core.ranks import lagrangian_topn_cost
from repro_torch.core.rewards import awc_multilinear_grad

NAME = "awc_fw"
SOURCE = Path(__file__).resolve().parent / "csrc" / "awc_fw.cu"
REPLACES = "src/repro/kernels/awc_fw.py:81"
ENTRY = "awc_fw_launch"
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
MAX_K = 19370      # three rows must fit the 227 KB of shared memory


def awc_fw_plain(z, mu, cost, lams, n):
    """Plain PyTorch version (port of `repro.kernels.ref.awc_fw`):
    z/mu/cost (B, K), lams (B, G), n (B,) -> (g (B, K), costs (B, G))."""
    g = awc_multilinear_grad(z, mu)
    return g, lagrangian_topn_cost(g, cost.to(torch.float32),
                                   lams.to(torch.float32), n, False)


def awc_fw_cuda(lib, z, mu, cost, lams, n):
    """Launch the kernel on the current stream; inputs must be contiguous
    CUDA tensors: z/mu/cost (B, K) and lams (B, G) float32, n (B,) int32."""
    if z.dim() != 2 or lams.dim() != 2:
        raise ValueError(f"z must be (B, K) and lams (B, G), got "
                         f"{tuple(z.shape)} and {tuple(lams.shape)}")
    b, k = z.shape
    g_pts = lams.shape[1]
    if k > MAX_K:
        raise ValueError(f"awc_fw takes K <= {MAX_K}, got {k}")
    for name, t in (("z", z), ("mu", mu), ("cost", cost)):
        check(name, t, torch.float32, (b, k), z.device)
    check("lams", lams, torch.float32, (b, g_pts), z.device)
    check("n", n, torch.int32, (b,), z.device)
    g = torch.empty((b, k), dtype=torch.float32, device=z.device)
    costs = torch.empty((b, g_pts), dtype=torch.float32, device=z.device)
    if b == 0 or g_pts == 0:
        return g, costs
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = lib.awc_fw_launch(z.data_ptr(), mu.data_ptr(), cost.data_ptr(),
                            lams.data_ptr(), n.data_ptr(), g.data_ptr(),
                            costs.data_ptr(), b, k, g_pts, stream)
    if err != 0:
        raise RuntimeError(f"awc_fw launch failed: cudaError {err}")
    return g, costs
