"""Drive the PyTorch port of C2MAB-V on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails the run on any mismatch:

  1. card       the card's name and power limit (nvidia-smi)
  2. build      all five CUDA kernels, one nvcc per source, started together
  3. kernels    each kernel against its plain PyTorch version on the card, at
                the main paths' shapes and at edge, tie, ragged and (for
                ssd_chunk) steep-decay cases, the attention kernels also
                at head_dim 120 and 80 (`flash_attention`'s pad route) and
                per (row, head) output vector, `decode_attention` also with
                a row of pos -1 (zeros); `topn_lp` and `awc_fw`'s costs
                bit-equal to theirs; times of calls made one by one
                with CUDA events (for `decode_attention` and the two fleet
                kernels, whose calls the host paces, also the device time
                over a CUDA graph of 50 calls, as `graph_ms`; `topn_lp` at
                each of its three shapes in a fleet round), the bound the
                card's rates allow
                (for ssd_chunk on the tensor cores, as it splits its
                products, beside the fp32 CUDA-core figure), and for the
                attention kernels the time of PyTorch's
                `scaled_dot_product_attention` on the same inputs;
                ssd_chunk's main shape is also held to 1e-5
  4. decision   a 4096-tenant mixed fleet runs 16 rounds on the card; from
                its state one `_tenant_act` runs on the card (kernels) and
                on the CPU (plain versions) with the same keys; the CPU's
                thread count is printed, and the plain `awc_fw` must give
                the same bits at 1 and 8 threads as the first call of a
                fresh interpreter (F5)
  5. fleet      the main path: `simulate_fleet` on the card, 4096 tenants in
                thirds of AWC, SUC and AIC on the paper's pool, 128 rounds;
                launch counts must match the round structure
  6. profile    where a fleet round's time goes (printed, not gated):
                host-clock times of its parts, and a `torch.profiler` trace
                of a few rounds for the device's busy share and the kernels
                launched per round
  7. quickstart `bandit.simulate("c2mabv")` with examples/quickstart.py's
                settings must reach its verdict, violation ≈ 0
  8. serve      the serving path: StarCoder2-7B at full width (bf16 weights
                from `init_params`, seed 0) behind `Engine`: `generate` on 4
                prompts of 2,048 tokens, then the slot API (8 slots, two
                admitted batches of 1,024 and 3,000 tokens, decode chunks of
                16 and 48, release); every prefill must launch one
                `flash_attention` per layer and every decode step one
                `decode_attention` per layer, and nothing else. Then
                (printed, not gated) a `torch.profiler` trace of one
                prefill and 3 decode steps
  9. consistency  at full width, prefill + one decode step against
                `forward` over the extended prompt
 10. card-cpu   the reduced StarCoder2 in float32 (TF32 off): the same
                weights through prefill, a decode step and
                `Engine.generate` on the card and on the CPU
 10b. h2o       phase 9 for H2O-Danube-3-4B at full width (24 layers,
                head_dim 120 through `flash_attention`'s pad route, window
                4,096), with one `flash_attention` per layer in its prefill
 11. serve-ssm  the same serving path for Mamba2-780M at full width (bf16,
                `generate` on 4 prompts of 2,048 tokens, the slot API with
                batches of 1,024 and 3,072 tokens): every prefill must launch
                one `ssd_chunk` per layer and a decode step no kernel; then
                the profiler trace of one prefill and 3 decode steps
 12. ssm-consistency  at full width, prefill of 1,024 tokens and 256
                teacher-forced decode steps against `forward` over all 1,280
 13. ssm-card-cpu  phase 10 for the reduced Mamba2
 14. serve-moe  phase 8's serving path for OLMoE-1B-7B at full width (16
                layers, 16 / 16 heads of 128, 64 experts top 8; bf16): one
                `flash_attention` per layer a prefill and one
                `decode_attention` per layer a decode step (n_rep 1), and
                nothing else; then two identical 4 x 2,048 prefills must give
                the same bits (logits and cache)
 15. moe-consistency  phase 9 for OLMoE at the no-drop capacity factor 64
                (prompts of 512 tokens)
 16. moe-card-cpu  phase 10 for the reduced OLMoE at the configs' capacity
                factor (125 slots an expert for 200 tokens' 400 entries, so
                an expert chosen more often drops the rest)

The next-to-last line of output is one JSON object describing every kernel;
the last is {"ok": true, "device": {...}}. Without a CUDA device, or without
the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FLEET_KERNELS = ("topn_lp", "awc_fw")    # the fleet loop's kernels
# topn_lp's calls in a fleet round of 2,731 SUC/AIC and 1,365 AWC tenants:
# (label, rows, K, equality) of the octave round (2,731 × 25 λ's), the
# SUC/AIC mantissa rounds (2,731 × 64) and the AWC ones (1,365 × 64)
TOPN_SHAPES = (("octave", 68275, 9, True), ("main", 174784, 9, True),
               ("awc-grid", 87360, 9, False))
# F5: the plain awc_fw's bits at 1 and 8 CPU threads, each its process's
# first call: the fleet's AWC shape (B, K, G), and 200,000 rows of K = 9
# (one λ, which keeps the plain version's (B, G, K, K) ranks small)
F5_SHAPES = ((1365, 9, 25), (200000, 9, 1))
F5_THREADS = (1, 8)
TENANTS = 4096                   # the fleet: thirds of AWC, SUC, AIC
ROUNDS = 128                     # fleet rounds (phase 5)
DECISION_ROUNDS = 16             # rounds before the decision check (phase 4)
PROFILE_ROUNDS = 4               # rounds traced by the profiler (phase 6)
QUICKSTART_ROUNDS = 2000         # examples/quickstart.py's T (phase 7)
SERVE_ARCH = "starcoder2-7b"     # the serving path's model (phase 8)
WINDOW_ARCH = "h2o-danube-3-4b"  # head_dim 120, sliding window (phase 10b)
SSM_ARCH = "mamba2-780m"         # the SSM serving path's model (phase 11)
MOE_ARCH = "olmoe-1b-7b"         # the MoE serving path's model (phase 14)
SERVE_MAX_LEN = 4096
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12          # H100 SXM TF32 tensor cores, dense
# tests/test_kernels.py's ATOL: fp32 sums in another order; bf16 output
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# per (row, head) output vector: max|out − want| <= ROW_RTOL · max|want| +
# ROW_ATOL. One bf16 ulp of a vector's largest value is <= 0.78% of it, so
# rounding passes; a row that loses its last 64 visible slots of ~1,100
# moves by 6–17% of its largest value
ROW_RTOL, ROW_ATOL = 1e-2, 1e-4
# ssd_chunk: fp32 products in another order than the plain version's
# einsums, over up to 256 + 128 terms; held to 1e-4 of the largest value
SSD_RTOL = 1e-4
# ...and at the main shape to 1e-5, which one TF32 pass (10 mantissa bits)
# cannot meet: it shows that the fp32-operand products are split
SSD_MAIN_RTOL = 1e-5
# ssd_chunk's cases (label, B, NC, L, H, P, N, B/C dtype, acum slope or 0
# for the model's decay, scale of B/C, scale of xd); "main" is the SSM
# prefill of 4 prompts of 2,048 tokens at Mamba2-780M's width
SSD_CASES = [("main", 4, 8, 256, 48, 64, 128, torch.bfloat16, 0.0, 1, 1),
             ("L100", 1, 1, 100, 48, 64, 128, torch.bfloat16, 0.0, 1, 1),
             ("B1", 1, 8, 256, 48, 64, 128, torch.bfloat16, 0.0, 1, 1),
             ("steep", 2, 2, 256, 48, 64, 128, torch.bfloat16, 30.0, 1, 1),
             ("reduced", 3, 2, 32, 16, 32, 16, torch.float32, 0.0, 1, 1),
             ("L1", 2, 3, 1, 48, 64, 128, torch.bfloat16, 0.0, 1, 1),
             ("L37", 2, 1, 37, 48, 64, 128, torch.bfloat16, 0.0, 1, 1),
             ("P16", 2, 2, 256, 24, 16, 128, torch.bfloat16, 0.0, 1, 1),
             ("P32", 2, 2, 256, 24, 32, 128, torch.bfloat16, 0.0, 1, 1),
             ("range", 2, 4, 256, 48, 64, 128, torch.bfloat16, 0.0, 1e2,
              1e-3)]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``n`` calls: the card's time without the host's launch pace."""
    for _ in range(3):
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def topn_cost(b: int, k: int):
    """Bytes (score, cost, n read once; out written once) and operations
    (a compare-and-count per arm pair, a mask multiply and an add per arm)."""
    return 4.0 * (2 * b * k + 2 * b), float(b * k * k + 2 * b * k)


def flash_cost(q, k, causal: bool):
    """Bytes (q, k, v read once, o written once) and operations: the two
    products over the visible half of the S x T square when causal,
    2·S²·hd·H·B, else over all of it."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    ops = 2.0 * s * t * hd * h * b * (1 if causal else 2)
    return nbytes, ops


def decode_cost(q, k, pos):
    """Bytes (q once, K and V up to each row's pos once, o once) and
    operations (two products over the visible slots), for this run's
    positions."""
    b, _, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    slots = float((torch.clamp(pos, max=t - 1) + 1).sum())
    nbytes = q.element_size() * (2 * q.numel() + 2 * slots * kv * hd)
    return nbytes, 4.0 * slots * hd * h


def ssd_cost(xd, bm):
    """Bytes (xd, acum, bm, cm read once; y and the states written once)
    and operations (C Bᵀ once per chunk and the two L×L products over their
    causal half, and the state product: B·NC·(L²·N + L²·P·H + 2·L·N·P·H))."""
    b, nc, l, h, p = xd.shape
    n = bm.shape[-1]
    nbytes = (4.0 * (2 * xd.numel() + b * nc * l * h + b * nc * h * p * n)
              + 2 * bm.element_size() * b * nc * l * n)
    ops = float(b * nc) * (l * l * n + l * l * p * h + 2 * l * n * p * h)
    return nbytes, ops


def ssd_tensor_ops(xd, bm) -> float:
    """`ssd_cost`'s operations as the kernel runs them on the tensor cores,
    in TF32 operations: the scores product in three TF32 passes; the state
    product in two when B is bf16 (exact in TF32), else three; C Bᵀ in one
    bf16 pass (at 989/495 of the TF32 cost) when B/C are bf16, else three
    TF32 passes."""
    b, nc, l, h, p = xd.shape
    n = bm.shape[-1]
    cb = float(b * nc) * l * l * n
    scores = float(b * nc) * l * l * p * h
    state = float(b * nc) * 2 * l * n * p * h
    if bm.dtype == torch.bfloat16:
        return cb * TF32_OPS_PER_S / BF16_OPS_PER_S + 3 * scores + 2 * state
    return 3 * (cb + scores + state)


def awc_cost(b: int, k: int, g: int):
    """Bytes (z, μ, c, λ, n read once; g and costs written once) and
    operations (six per arm for the gradient; per λ and arm pair two
    subtractions, a multiply and a compare; per λ and arm a multiply, a
    compare, a mask multiply and an add)."""
    nbytes = 4.0 * (3 * b * k + b * g + b + b * k + b * g)
    ops = float(6 * b * k + 4 * b * g * k * k + 4 * b * g * k)
    return nbytes, ops


def topn_rows(b: int, k: int, gen, dev):
    """topn_lp's inputs as `relax._lagrangian_costs` forms them: per (w, c,
    n) row a batch of probe λ's, GRID_POINTS of a mantissa round when b
    allows, else the octave ladder 2^0..2^LAM_MAX_EXP when b allows, else
    one. A mantissa λ is an octave 2^e times a dyadic mantissa from 0 or 1,
    capped at 2^LAM_MAX_EXP, so most rows hold the large-λ regime where
    every score is negative; c has zeros (an unexplored arm's LCB)."""
    from repro_torch.core import relax
    octave = relax.LAM_MAX_EXP + 1
    g = (relax.GRID_POINTS if b % relax.GRID_POINTS == 0
         else octave if b % octave == 0 else 1)
    r = b // g
    w = torch.rand((r, k), generator=gen)
    c = torch.rand((r, k), generator=gen) * 0.8
    c[::3, ::4] = 0.0
    if g == octave:
        lams = (2.0 ** torch.arange(float(octave))).expand(r, g)
    else:
        e = torch.randint(0, relax.LAM_MAX_EXP + 1, (r, 1), generator=gen)
        m0 = torch.randint(0, 2, (r, 1), generator=gen).float()
        lams = torch.minimum(2.0 ** e.float() * (m0 + torch.arange(g) / g),
                             torch.tensor(2.0 ** relax.LAM_MAX_EXP))
    score = (w[:, None, :] - lams[:, :, None] * c[:, None, :])
    score = score.reshape(b, k)
    score[::7, 1::2] = score[::7, :1]                 # exact ties
    cost = c[:, None, :].expand(r, g, k).reshape(b, k)
    n = torch.randint(1, k + 1, (r, 1), generator=gen, dtype=torch.int32)
    n = n.expand(r, g).reshape(b)
    return tuple(x.contiguous().to(dev) for x in (score, cost, n))


def awc_rows(b: int, k: int, g: int, gen, dev):
    """awc_fw's inputs as the FW loop gives them: z̃ in [0, 1), μ̄ with
    clipped entries, c̲, and at G = 25 the octave ladder."""
    z = torch.rand((b, k), generator=gen)
    mu = 0.05 + 0.95 * torch.rand((b, k), generator=gen)
    mu[::5, :2] = 1.0
    c = 0.6 * torch.rand((b, k), generator=gen)
    if g == 25:
        lams = (2.0 ** torch.arange(25.0)).expand(b, g).contiguous()
    else:
        lams = 4 * torch.rand((b, g), generator=gen)
    n = torch.randint(1, k + 1, (b,), generator=gen, dtype=torch.int32)
    return tuple(x.to(dev) for x in (z, mu, c, lams, n))


# the plain `awc_fw` in a fresh interpreter at a given CPU thread count:
# the inputs from numpy (seed 0), the bits of g and costs as digests
_AWC_PLAIN_BITS = """
import hashlib, sys
import numpy as np, torch
b, k, g, threads = map(int, sys.argv[1:5])
torch.set_num_threads(threads)
from repro_torch.kernels.awc_fw import awc_fw_plain
rng = np.random.default_rng(0)
z = rng.uniform(size=(b, k)).astype(np.float32)
mu = rng.uniform(0.05, 1.0, (b, k)).astype(np.float32)
mu[::5, :2] = 1.0
c = rng.uniform(0.0, 0.6, (b, k)).astype(np.float32)
lams = np.broadcast_to(2.0 ** np.arange(g, dtype=np.float32), (b, g))
n = rng.integers(1, k + 1, b).astype(np.int32)
gk, costs = awc_fw_plain(*(torch.from_numpy(np.ascontiguousarray(x))
                           for x in (z, mu, c, lams, n)))
print(torch.get_num_threads(), hashlib.sha256(gk.numpy().tobytes()).hexdigest(),
      hashlib.sha256(costs.numpy().tobytes()).hexdigest())
"""


def awc_plain_bits(b: int, k: int, g: int, threads: int):
    """(threads used, digest of g, digest of costs) of `awc_fw_plain`'s
    first call in a fresh interpreter with ``threads`` CPU threads."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "")
                               .split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", _AWC_PLAIN_BITS, str(b),
                          str(k), str(g), str(threads)], capture_output=True,
                         text=True, timeout=300, env=env, check=True)
    used, g_bits, c_bits = out.stdout.split()
    return int(used), g_bits, c_bits


# ====================================================================== phases
def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return line


def phase_build(ops) -> None:
    t0 = time.perf_counter()
    seconds = ops.build()
    for name in ops.KERNELS:
        ops.library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          + " ".join(f"{k}={v:.2f}s" for k, v in seconds.items()), flush=True)


def phase_kernels(ops, topn, awc, dev):
    """Kernel against plain version; returns per-kernel measurements."""
    gen = torch.Generator().manual_seed(0)
    results = {}

    cases = [(label, b, k) for label, b, k, _ in TOPN_SHAPES] + [
        ("B512K9", 512, 9), ("B4096K9", 4096, 9), ("K17", 255, 17),
        ("K32", 257, 32), ("B1024K128", 1024, 128), ("K130", 5, 130),
        ("B33", 33, 40)]
    path_eq = {label: eq for label, _, _, eq in TOPN_SHAPES}
    tie = (torch.tensor([[0.5, 0.7, 0.5, 0.7, 0.1], [1.0] * 5], device=dev),
           torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0]] * 2, device=dev),
           torch.tensor([3, 2], dtype=torch.int32, device=dev))
    worst, main, shapes = 0.0, None, {}
    for label, b, k in cases + [("ties", 2, 5)]:
        args = tie if label == "ties" else topn_rows(b, k, gen, dev)
        for eq in (True, False):
            out = ops.topn_lp(*args, equality=eq)
            want = topn.topn_lp_plain(*args, equality=eq)
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            worst = max(worst, err)
            if err > 1e-6 or not torch.equal(out, want):
                fail(f"topn_lp {label} equality={eq}: not bit-equal to the "
                     f"plain version, max|diff| {err}")
            if label == "ties" and eq and out.tolist() != [11.0, 3.0]:
                fail(f"topn_lp tie order: {out.tolist()}")
            ms = cuda_ms(lambda: ops.topn_lp(*args, equality=eq))
            plain_ms = cuda_ms(lambda: topn.topn_lp_plain(*args, equality=eq),
                               iters=5)
            b_ms, b_by = bound(*topn_cost(b, k))
            dev_ms = None
            if path_eq.get(label) == eq:
                dev_ms = graph_ms(lambda: ops.topn_lp(*args, equality=eq))
                shapes[f"{b}x{k}"] = dev_ms
            graph = "" if dev_ms is None else f" graph={dev_ms:.5f}ms"
            print(f"topn_lp {label:9s} B={b:6d} K={k:3d} eq={eq!s:5s} "
                  f"max|diff|={err:.3g} kernel={ms:.4f}ms{graph} "
                  f"plain={plain_ms:.4f}ms bound={b_ms:.5f}ms ({b_by})",
                  flush=True)
            if label == "main" and eq:
                main = (ms, plain_ms, b_ms, b_by, dev_ms)
    results["topn_lp"] = dict(max_abs_err=worst, ms=main[0], plain_ms=main[1],
                              bound_ms=main[2], bound_by=main[3],
                              graph_ms=main[4], graph_ms_shapes=shapes)

    cases = [("main", 1365, 9, 25), ("B64K9G25", 64, 9, 25),
             ("B512K9G25", 512, 9, 25), ("B257K17G8", 257, 17, 8),
             ("B256K64G8", 256, 64, 8)]
    tie = tuple(x.to(dev) for x in (
        torch.zeros((2, 4)),
        torch.tensor([[0.5, 0.5, 0.25, 0.5], [0.5, 0.25, 0.125, 0.0625]]),
        torch.tensor([[1.0, 2.0, 1.0, 4.0], [1.0, 1.0, 1.0, 1.0]]),
        torch.tensor([[0.0, 0.25], [0.0, 0.25]]),
        torch.tensor([3, 2], dtype=torch.int32)))
    worst, main = 0.0, None
    for label, b, k, g in cases + [("ties", 2, 4, 2)]:
        args = tie if label == "ties" else awc_rows(b, k, g, gen, dev)
        gk, ck = ops.awc_fw(*args)
        gp, cp = awc.awc_fw_plain(*args)
        torch.cuda.synchronize()
        err_g = (gk - gp).abs().max().item()
        err_c = (ck - cp).abs().max().item()
        worst = max(worst, err_g, err_c)
        if err_g > 2e-6 or err_c > 1e-6 or not torch.equal(ck, cp):
            fail(f"awc_fw {label}: max|diff| g {err_g} costs {err_c} (costs "
                 "must equal the plain version's)")
        if label == "ties" and ck[0, 1].item() != 1.0:
            fail(f"awc_fw positivity: {ck.tolist()}")
        ms = cuda_ms(lambda: ops.awc_fw(*args))
        plain_ms = cuda_ms(lambda: awc.awc_fw_plain(*args), iters=5)
        b_ms, b_by = bound(*awc_cost(b, k, g))
        dev_ms = graph_ms(lambda: ops.awc_fw(*args)) if label == "main" \
            else None
        graph = "" if dev_ms is None else f" graph={dev_ms:.5f}ms"
        print(f"awc_fw  {label:9s} B={b:6d} K={k:3d} G={g:2d} "
              f"max|diff| g={err_g:.3g} costs={err_c:.3g} kernel={ms:.4f}ms"
              f"{graph} plain={plain_ms:.4f}ms bound={b_ms:.5f}ms ({b_by})",
              flush=True)
        if label == "main":
            main = (ms, plain_ms, b_ms, b_by, dev_ms)
    results["awc_fw"] = dict(max_abs_err=worst, ms=main[0], plain_ms=main[1],
                             bound_ms=main[2], bound_by=main[3],
                             graph_ms=main[4])
    print(f"kernels: {sorted(results)}", flush=True)
    return results


def mixed_fleet(pool, m: int, T: int, device):
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.env.llm_profiles import default_rho
    from repro_torch.router import fleet
    third = max(m // 3, 1)            # 4096 -> 1365 AWC, 1365 SUC, 1366 AIC
    kinds = [("awc", "suc", "aic")[min(i // third, 2)] for i in range(m)]
    pcfgs = [PolicyConfig(kind=k, k=pool.k, n=4, rho=default_rho(pool, k, 4),
                          delta=1 / T) for k in kinds]
    return kinds, pcfgs, fleet.fleet_config(pcfgs, device=device)


def round_margin(z, key) -> float:
    """Smallest distance between a decision quantity and its threshold in
    the pairwise rounding of one row (z (K,), key (2,), on the CPU): each
    merge's uniform against q/(p+q), the final uniform against the
    fractional coordinate, and every coordinate against the EPS band."""
    from repro_torch import prng
    from repro_torch.core import rounding
    z = torch.clamp(z.to(torch.float32), 0.0, 1.0)[None]
    key = key[None]
    eps = torch.tensor([rounding.EPS, 1.0 - rounding.EPS])
    margin = float("inf")
    for _ in range(z.shape[-1] - 1):
        margin = min(margin, (z[0, :, None] - eps).abs().min().item())
        f = rounding._frac_mask(z)
        if f.sum() >= 2:
            i, j = torch.nonzero(f[0])[:2, 0].tolist()
            zi, zj = z[0, i], z[0, j]
            p = torch.minimum(1.0 - zi, zj)
            q = torch.minimum(zi, 1.0 - zj)
            u = prng.uniform(prng.split(key)[:, 1])[0]
            margin = min(margin, (u - q / torch.clamp(p + q, min=1e-12))
                         .abs().item())
        z, key = rounding._merge_step(z, key)
    margin = min(margin, (z[0, :, None] - eps).abs().min().item())
    f = rounding._frac_mask(z)[0]
    if f.any():
        u = prng.uniform(prng.split(key)[:, 1])[0]
        margin = min(margin, (u - z[0, f]).abs().min().item())
    return margin


def phase_decision(pool, dev, m: int, rounds: int):
    """Card against CPU on one decision; returns the fleet (cfg, state)."""
    from repro_torch import prng
    from repro_torch.core import confidence as cb
    from repro_torch.core import relax
    from repro_torch.router import fleet
    _, _, cfg = mixed_fleet(pool, m, 128, dev)
    res = fleet.simulate_fleet(pool, cfg, T=rounds, seed=1, device=dev)
    st = res.state
    t = rounds + 1
    ka = prng.split(st.key, 4)[:, 1]
    t_row = torch.full_like(st.t, float(t))

    def act(stats, t_row, ka, cfg):
        """`_tenant_act`'s mask, and z̃ from the same UCB/LCB."""
        mu_bar = cb.reward_ucb(stats, t_row, cfg.delta, cfg.alpha_mu)
        c_low = cb.cost_lcb(stats, t_row, cfg.delta, cfg.alpha_c)
        z = relax.solve_batch(cfg.kind_ix, mu_bar, c_low, cfg.n, cfg.rho)
        return fleet._tenant_act(stats, t_row, ka, cfg), z

    mask_g, z_g = act(st.stats, t_row, ka, cfg)
    cpu = torch.device("cpu")
    cfg_c = fleet.FleetConfig(*(f.to(cpu) for f in cfg))
    mask_c, z_c = act({k: v.to(cpu) for k, v in st.stats.items()},
                      t_row.cpu(), ka.cpu(), cfg_c)
    z_g, mask_g = z_g.cpu(), mask_g.cpu()
    print(f"decision: CPU half on {torch.get_num_threads()} threads",
          flush=True)
    for b, k, g in F5_SHAPES:
        bits = {t: awc_plain_bits(b, k, g, t) for t in F5_THREADS}
        print(f"decision: plain awc_fw {b}x{k}x{g}, first call in a fresh "
              "interpreter: " + "; ".join(
                  f"{used} threads g {gb[:16]} costs {cb[:16]}"
                  for used, gb, cb in bits.values()), flush=True)
        if len({v[1:] for v in bits.values()}) != 1:
            fail(f"the plain awc_fw at {b}x{k}x{g} depends on the CPU "
                 "thread count (F5)")
    dz = (z_g - z_c).abs().max(-1).values
    print(f"decision: {m} tenants after {rounds} rounds; max|z_card - z_cpu| "
          f"= {dz.max().item():.3g}; rows with z̃ differing: "
          f"{int((dz > 0).sum())}", flush=True)
    if dz.max().item() > 1e-4:
        bad = torch.nonzero(dz > 1e-4)[:, 0].tolist()
        fail(f"z̃ differs by more than 1e-4 on rows {bad[:20]}")
    rows = torch.nonzero((mask_g != mask_c).any(-1))[:, 0].tolist()
    print(f"decision: rows whose masks differ: {len(rows)}", flush=True)
    for r in rows:
        mg, mc = round_margin(z_g[r], ka[r].cpu()), round_margin(z_c[r],
                                                                 ka[r].cpu())
        print(f"  row {r}: |Δz̃|={dz[r].item():.3g}, rounding margin "
              f"card={mg:.3g} cpu={mc:.3g}", flush=True)
        if min(mg, mc) > 1e-6:
            fail(f"row {r}: masks differ and no rounding draw lies within "
                 "1e-6 of its threshold")
    return cfg, st


def phase_fleet(pool, ops, dev, m: int, T: int):
    from repro_torch.core import metrics
    from repro_torch.router import fleet
    kinds, pcfgs, cfg = mixed_fleet(pool, m, T, dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = fleet.simulate_fleet(pool, cfg, T=T, seed=0, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in FLEET_KERNELS}
    print(f"fleet: {m} tenants x {T} rounds in {secs:.2f} s: "
          f"{T / secs:.2f} rounds/s, {m * T / secs:.1f} tenant-rounds/s",
          flush=True)
    print(f"fleet: launches {launches}", flush=True)
    want = {"topn_lp": (4 + 3 * 8) * T, "awc_fw": 8 * T}
    if launches != want:
        fail(f"launch counts {launches}, the round structure implies {want}")
    if not np.isfinite(res.reward).all() or (res.cost < 0).any():
        fail("fleet produced non-finite rewards or negative costs")
    sizes = res.action.sum(-1)
    for kind in ("awc", "suc", "aic"):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        if kind == "awc" and (sizes[idx] > 4).any():
            fail("an AWC action exceeds n")
        if kind != "awc" and (sizes[idx] != 4).any():
            fail(f"a {kind} action is not of size n")
        rho = pcfgs[idx[0]].rho
        vio = metrics.violation_curve(res.cost[idx], rho)[:, -1].mean()
        print(f"fleet: {kind} reward/round {res.reward[idx].mean():.4f} "
              f"final violation {vio:.4f} (rho {rho:.3f})", flush=True)
    if (res.observed > res.action).any():
        fail("feedback outside the selected set")
    return launches


def phase_profile(pool, dev, cfg, state, rounds: int) -> None:
    """Where a fleet round's time goes (printed, not gated), from the
    decision phase's fleet ``cfg`` and ``state``."""
    from repro_torch import prng
    from repro_torch.core import confidence as cb
    from repro_torch.core import relax, rounding
    from repro_torch.env import cost_model, feedback
    from repro_torch.router import fleet
    rows = relax.kind_rows(cfg.kind_ix)
    mu = torch.tensor(pool.mu, dtype=torch.float32, device=dev)
    mean_cost = torch.tensor(pool.mean_cost, dtype=torch.float32,
                             device=dev)
    t_row = state.t + 1.0

    def host_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    ks = prng.split(state.key, 4)
    ka, kr, kc = ks[:, 1], ks[:, 2], ks[:, 3]
    mu_bar = cb.reward_ucb(state.stats, t_row, cfg.delta, cfg.alpha_mu)
    c_low = cb.cost_lcb(state.stats, t_row, cfg.delta, cfg.alpha_c)
    eq_rows, awc_rows = rows
    z = relax.solve_batch(cfg.kind_ix, mu_bar, c_low, cfg.n, cfg.rho,
                          rows=rows)
    mask = rounding.pairwise_round_batch(z, ka)
    x = cost_model.sample_rewards(kr, mu, pool.reward_levels)
    y = cost_model.sample_costs(kc, mean_cost)
    parts = {
        "prng.split(key, 4)": lambda: prng.split(state.key, 4),
        "UCB + LCB": lambda: (cb.reward_ucb(state.stats, t_row, cfg.delta,
                                            cfg.alpha_mu),
                              cb.cost_lcb(state.stats, t_row, cfg.delta,
                                          cfg.alpha_c)),
        "solve: SUC/AIC rows (lp_topn)": lambda: relax.lp_topn(
            mu_bar[eq_rows], c_low[eq_rows], cfg.n[eq_rows],
            cfg.rho[eq_rows], True),
        "solve: AWC rows (8 FW steps)": lambda: relax._awc_fw(
            mu_bar[awc_rows], c_low[awc_rows], cfg.n[awc_rows],
            cfg.rho[awc_rows]),
        "pairwise rounding + padding": lambda: rounding.pad_to_n_dyn(
            rounding.pairwise_round_batch(z, ka), mu_bar, cfg.n,
            cfg.kind_ix != 0),
        "reward + cost draws": lambda: (
            cost_model.sample_rewards(kr, mu, pool.reward_levels),
            cost_model.sample_costs(kc, mean_cost)),
        "feedback + Eq. 6 update": lambda: cb.update_stats(
            state.stats, feedback.observe_ix(cfg.kind_ix, mask, x, mean_cost),
            x, y),
    }
    for name, fn in parts.items():
        print(f"profile: {name:32s} {host_ms(fn):8.3f} ms (host clock)",
              flush=True)
    device_trace("profile", "round", rounds, lambda: fleet.simulate_fleet(
        pool, cfg, T=rounds, state=state, device=dev))


def device_profile(fn):
    """Run ``fn`` under `torch.profiler`; returns (wall ms with the
    profiler on, the `key_averages()` entries of the device's kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]


def device_trace(tag: str, unit: str, n: int, fn, top: int = 8) -> None:
    """Run ``fn`` (n units of work) under `torch.profiler` and print the
    wall time per unit (profiler on), the device's busy time and idle
    share, the kernels per unit, and the ``top`` kernels by device time."""
    wall_ms, kernels = device_profile(fn)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"{tag}: {unit} x {n} traced: wall {wall_ms / n:.2f} ms/{unit} "
          f"(profiler on), device busy {busy_us / 1e3 / n:.3f} ms/{unit}, "
          f"idle share {1 - busy_us / 1e3 / wall_ms:.4f}, "
          f"{launches / n:.0f} kernels/{unit}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"{tag}:   {e.count / n:7.0f}/{unit} "
              f"{e.self_device_time_total / 1e3 / n:8.3f} ms/{unit}  "
              f"{e.key[:90]}", flush=True)


def phase_quickstart(pool, ops, dev, T: int) -> None:
    from repro_torch.core import bandit, metrics, rewards
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.env.llm_profiles import default_rho
    kind = "awc"
    rho = default_rho(pool, kind, n=4)
    pcfg = PolicyConfig(kind=kind, k=pool.k, n=4, rho=rho, delta=1 / T,
                        alpha_mu=0.3, alpha_c=0.01)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = bandit.simulate("c2mabv", pool, pcfg, T=T, seeds=5, device=dev)
    secs = time.perf_counter() - t0
    s = metrics.summarize(res.reward, res.cost, rho,
                          bandit.optimal_value(pool, pcfg),
                          float(rewards.ALPHA[kind]))
    print(f"quickstart: T={T} seeds=5 in {secs:.1f} s: reward/round "
          f"{s['reward_mean']:.4f} violation {s['violation_final']:.5f} "
          f"ratio {s['ratio_final']:.1f} launches "
          f"{ {k: ops.LAUNCHES[k] for k in FLEET_KERNELS} }",
          flush=True)
    if min(ops.LAUNCHES[k] for k in FLEET_KERNELS) == 0:
        fail("the quickstart ran without a kernel launch")
    if s["violation_final"] > 1e-3:
        fail(f"quickstart verdict not reached: violation "
             f"{s['violation_final']}")


def phase_attention_kernels(ops, dev):
    """flash_attention and decode_attention against their plain versions at
    the serving path's shapes and at small, ragged and masked ones; returns
    per-kernel measurements at the main shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    results = {}
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, KV, hd, causal, window, dtype); "main" is a prefill
    # of 4 prompts of 2,048 tokens at StarCoder2-7B's heads; S129 to win100
    # sit on the bf16 kernel's 128-row and 128-key tile edges; "h2o" is
    # H2O-Danube-3-4B's prefill of 4 x 1,024 (head_dim 120, window 4,096),
    # h2o to hd80 take the pad route; "olmoe" is OLMoE-1B-7B's prefill of 4
    # x 2,048 at n_rep 1 (16 / 16 heads of 128), timed as "main" is
    cases = [("main", 4, 2048, 36, 4, 128, True, None, bf16),
             ("olmoe", 4, 2048, 16, 16, 128, True, None, bf16),
             ("B1S128", 1, 128, 4, 4, 64, True, None, f32),
             ("B1S128", 1, 128, 4, 4, 64, True, None, bf16),
             ("ragged", 2, 200, 9, 1, 128, True, None, f32),
             ("ragged", 2, 200, 9, 1, 128, True, None, bf16),
             ("win32", 1, 256, 4, 2, 64, True, 32, f32),
             ("win32", 1, 256, 4, 2, 64, True, 32, bf16),
             ("full", 1, 128, 2, 2, 64, False, None, f32),
             ("fullwin", 2, 77, 8, 2, 128, False, 40, bf16),
             ("S1025", 2, 1025, 36, 4, 128, True, None, bf16),
             ("S129", 1, 129, 9, 1, 128, True, None, bf16),
             ("S257", 1, 257, 9, 1, 128, True, None, bf16),
             ("S127", 2, 127, 8, 2, 64, True, None, bf16),
             ("S255", 1, 255, 4, 4, 64, False, None, bf16),
             ("win100", 1, 300, 8, 2, 128, True, 100, bf16),
             ("h2o", 4, 1024, 32, 8, 120, True, 4096, bf16),
             ("h2o", 4, 1024, 32, 8, 120, True, 4096, f32),
             ("ragged120", 2, 200, 32, 8, 120, True, None, bf16),
             ("ragged120", 2, 200, 32, 8, 120, True, None, f32),
             ("hd80", 2, 129, 32, 32, 80, True, None, bf16),
             ("hd80", 2, 129, 32, 32, 80, True, None, f32)]
    errs, worst, main, worst_row = [], 0.0, None, 0.0
    for label, b, s, h, kv, hd, causal, window, dt in cases:
        q = rnd((b, s, h, hd), dt)
        k, v = rnd((b, s, kv, hd), dt), rnd((b, s, kv, hd), dt)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        row = fa.row_error_ratio(out, want, ROW_RTOL, ROW_ATOL)
        worst, worst_row = max(worst, err), max(worst_row, row)
        if dt == bf16:
            errs.append(f"{label}={err:.3g}")
        if not err <= ATTN_ATOL[dt]:
            fail(f"flash_attention {label} {dt}: max|diff| {err}")
        if not row <= 1:
            fail(f"flash_attention {label} {dt}: a (row, head) vector is "
                 f"{row:.3g} x its per-row tolerance")
        print(f"flash_attention {label:9s} B={b} S={s} H={h} KV={kv} "
              f"hd={hd} causal={causal} window={window} {dt}: "
              f"max|diff|={err:.3g} row ratio={row:.3g}", flush=True)
        if label == "h2o" and dt == bf16:
            flash_pad_route(ops, fa, q, k, v, window)
        if label in ("main", "olmoe"):
            ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True))
            plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=True), iters=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            nbytes, flops = flash_cost(q, k, True)
            b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S)
            if label == "main":
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms)
            print(f"flash_attention {label}: kernel={ms:.4f}ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the "
                  f"bound) plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
                  f"bound={b_ms:.5f}ms ({b_by})", flush=True)
    print(f"flash_attention bf16 P design: two bf16 parts (hi + lo); "
          f"max|diff| {' '.join(errs)}", flush=True)
    print(f"flash_attention per-row check: worst ratio {worst_row:.3g} "
          f"(gate 1: max|diff| <= {ROW_RTOL} max|want| + {ROW_ATOL} per "
          "(row, head))", flush=True)
    results["flash_attention"] = dict(max_abs_err=worst, **main)

    # (label, B, T, H, KV, hd, pos, dtype); "main" is a decode step of the
    # slot phase: 8 slots of a 4,096-slot cache, 4 near 1,100, 4 near 3,040;
    # nrep16 and nrep32 fill two M tiles of the bf16 kernel's products,
    # "edge" puts pos on the 256-slot split edge of its shape, and "noslot"
    # has a row with pos -1, which must come out as zeros (the plain version
    # gives the mean of V there, so such rows are held to 0 instead);
    # "olmoe" is OLMoE-1B-7B's decode step at n_rep 1 (one of the products'
    # 16 M rows in use), timed as "main" is, and "whisper" Whisper's layout
    main_pos = [1100, 1110, 1120, 1130, 3040, 3041, 3047, 3055]
    cases = [("main", 8, 4096, 36, 4, 128, main_pos, bf16),
             ("olmoe", 8, 4096, 16, 16, 128, main_pos, bf16),
             ("whisper", 2, 512, 20, 20, 64, [0, 511], bf16),
             ("rows", 4, 128, 4, 2, 64, [0, 5, 63, 127], f32),
             ("rows", 4, 128, 4, 2, 64, [0, 5, 63, 127], bf16),
             ("scalar", 2, 256, 4, 2, 64, 100, f32),
             ("ragged", 3, 77, 9, 1, 128, [76, 200, 3], f32),
             ("mixed", 8, 4096, 36, 4, 128, [0, 1, 63, 64, 4095, 5000, 17,
                                             2048], bf16),
             ("nrep16", 2, 1024, 16, 1, 128, [0, 1023], bf16),
             ("nrep32", 2, 512, 32, 1, 64, [100, 511], bf16),
             ("edge", 3, 4096, 36, 4, 128, [255, 256, 257], bf16),
             ("noslot", 2, 4096, 36, 4, 128, [-1, 100], f32),
             ("noslot", 2, 4096, 36, 4, 128, [-1, 100], bf16)]
    worst, main, worst_row = 0.0, None, 0.0
    for label, b, t, h, kv, hd, pos, dt in cases:
        q = rnd((b, 1, h, hd), dt)
        k, v = rnd((b, t, kv, hd), dt), rnd((b, t, kv, hd), dt)
        pos_t = (torch.tensor(pos, dtype=torch.int32, device=dev)
                 if isinstance(pos, list) else pos)
        out = ops.decode_attention(q, k, v, pos_t)
        want = dec.decode_attention_plain(q, k, v, pos_t)
        torch.cuda.synchronize()
        if label == "noslot":
            if torch.count_nonzero(out[0]).item():
                fail(f"decode_attention noslot {dt}: the row with pos -1 "
                     f"is not zero (max|o| {out[0].abs().max().item():.3g})")
            out, want = out[1:], want[1:]
        err = (out.float() - want.float()).abs().max().item()
        row = fa.row_error_ratio(out, want, ROW_RTOL, ROW_ATOL)
        worst, worst_row = max(worst, err), max(worst_row, row)
        if not err <= ATTN_ATOL[dt]:
            fail(f"decode_attention {label} {dt}: max|diff| {err}")
        if not row <= 1:
            fail(f"decode_attention {label} {dt}: a (row, head) vector is "
                 f"{row:.3g} x its per-row tolerance")
        print(f"decode_attention {label:7s} B={b} T={t} H={h} KV={kv} "
              f"hd={hd} pos={pos} {dt}: max|diff|={err:.3g} "
              f"row ratio={row:.3g}", flush=True)
        if label in ("main", "olmoe"):

            def call():
                return ops.decode_attention(q, k, v, pos_t)
            ms = cuda_ms(call, iters=100)
            dev_ms = graph_ms(call)
            plain_ms = cuda_ms(lambda: dec.decode_attention_plain(
                q, k, v, pos_t))
            mask = (torch.arange(t, device=dev)[None, :] <= pos_t[:, None])
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask[:, None, None, :],
                    enable_gqa=True)
            lib_ms = cuda_ms(sdpa, iters=100)
            lib_dev_ms = graph_ms(sdpa)
            b_ms, b_by = bound(*decode_cost(q, k, pos_t), BF16_OPS_PER_S)
            if label == "main":
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms,
                            graph_ms=dev_ms, library_graph_ms=lib_dev_ms)
            print(f"decode_attention {label}: kernel={ms:.4f}ms one by one, "
                  f"{dev_ms:.4f}ms from a CUDA graph ({b_ms / dev_ms:.3f} "
                  f"of the bound) plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
                  f"one by one, {lib_dev_ms:.4f}ms from a CUDA graph "
                  f"bound={b_ms:.5f}ms ({b_by})", flush=True)
    print(f"decode_attention per-row check: worst ratio {worst_row:.3g} "
          "(gate 1)", flush=True)
    results["decode_attention"] = dict(max_abs_err=worst, **main)
    return results


def flash_pad_route(ops, fa, q, k, v, window) -> None:
    """Printed, not gated: what the pad route costs at H2O-Danube-3-4B's
    prefill: the route as called, the hd-128 kernel on inputs padded
    beforehand, the pad and slice copies alone, and SDPA on the hd-120
    inputs."""
    import torch.nn.functional as F
    hd = q.shape[3]
    qp, kp, vp, _ = fa.pad_head_dim(q, k, v)
    padded_out = torch.empty_like(qp)
    route_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                   window=window))
    kernel_ms = cuda_ms(lambda: ops.flash_attention(qp, kp, vp, causal=True,
                                                    window=window))
    copy_ms = cuda_ms(lambda: (fa.pad_head_dim(q, k, v),
                               padded_out[..., :hd].contiguous()))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    b_ms, b_by = bound(*flash_cost(q, k, True), BF16_OPS_PER_S)
    print(f"flash_attention h2o pad route: {route_ms:.4f}ms = hd-128 kernel "
          f"{kernel_ms:.4f}ms + pad/slice copies {copy_ms:.4f}ms; "
          f"sdpa={lib_ms:.4f}ms bound={b_ms:.5f}ms ({b_by}, hd {hd})",
          flush=True)


def phase_ssd_kernel(ops, dev):
    """ssd_chunk against its plain version at the SSM prefill's shape and
    at ragged (L 100, 37, 1), single-row, steep-decay, narrow-head (P 16,
    32), wide-range (B/C ×1e2, xd ×1e-3) and reduced ones; returns its
    measurements at the main shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, nc, l, h, p, n, bc_dtype, slope, bc_scale):
        """As `ssd_chunked` forms them: xd = x·dt, acum the cumulative sum
        of dt·a (dt a softplus, a = -exp(·) per head, or -slope·U(0, 1)
        when ``slope`` is set), bm/cm views into one wider conv output of
        N(0, bc_scale²) values."""
        x = torch.randn((b, nc, l, h, p), generator=gen, device=dev)
        dt = F.softplus(torch.randn((b, nc, l, h), generator=gen,
                                    device=dev))
        if slope:
            da = -slope * torch.rand((b, nc, l, h), generator=gen,
                                     device=dev)
        else:
            a = -torch.exp(0.5 * torch.randn((h,), generator=gen,
                                             device=dev))
            da = dt * a
        wide = (bc_scale * torch.randn((b, nc * l, 2 * n + 64),
                                       generator=gen, device=dev)
                ).to(bc_dtype)
        return ((x * dt[..., None]).contiguous(), torch.cumsum(da, dim=2),
                wide[..., 64:64 + n].reshape(b, nc, l, n),
                wide[..., 64 + n:].reshape(b, nc, l, n))

    worst, main = 0.0, None
    for (label, b, nc, l, h, p, n, bc_dtype, slope, bc_scale,
         x_scale) in SSD_CASES:
        xd, acum, bm, cm = inputs(b, nc, l, h, p, n, bc_dtype, slope,
                                  bc_scale)
        args = (xd * x_scale, acum, bm, cm)
        y, st = ops.ssd_chunk(*args)
        wy, wst = ssd.ssd_chunk_plain(*args)
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
            fail(f"ssd_chunk {label}: non-finite output")
        rel = max((y - wy).abs().max().item() / wy.abs().max().item(),
                  (st - wst).abs().max().item() / wst.abs().max().item())
        err = max((y - wy).abs().max().item(), (st - wst).abs().max().item())
        worst = max(worst, err)
        print(f"ssd_chunk {label:7s} B={b} NC={nc} L={l} H={h} P={p} N={n} "
              f"B/C {bc_dtype} x{bc_scale:g}, xd x{x_scale:g}: max|diff| "
              f"{err:.3g}, relative {rel:.3g}", flush=True)
        if not rel <= SSD_RTOL:
            fail(f"ssd_chunk {label}: relative max|diff| {rel:.3g} > "
                 f"{SSD_RTOL}")
        if label == "main":
            if not rel <= SSD_MAIN_RTOL:
                fail(f"ssd_chunk main: relative max|diff| {rel:.3g} > "
                     f"{SSD_MAIN_RTOL}")
            ms = cuda_ms(lambda: ops.ssd_chunk(*args))
            plain_ms = cuda_ms(lambda: ssd.ssd_chunk_plain(*args), iters=5)
            nbytes, nops = ssd_cost(args[0], args[2])
            b_ms, b_by = bound(nbytes, ssd_tensor_ops(args[0], args[2]),
                               TF32_OPS_PER_S)
            core_ms, _ = bound(nbytes, nops)
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None,
                        bound_cuda_core_ms=core_ms)
            print(f"ssd_chunk main: kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                  f"bound={b_ms:.5f}ms ({b_by}; tensor cores: bf16 C Bᵀ, "
                  f"split TF32 products), {core_ms:.5f}ms with every "
                  "product on fp32 CUDA cores; no single PyTorch call "
                  "computes it", flush=True)
    return {"ssd_chunk": dict(max_abs_err=worst, **main)}


def serve_kernels(cfg):
    """The kernels one prefill and one decode step of ``cfg`` launch, per
    kernel (every other kernel must stay at 0)."""
    layers = cfg.n_layers
    if cfg.family == "ssm":
        return {"ssd_chunk": layers}, {}
    return {"flash_attention": layers}, {"decode_attention": layers}


def full_width(arch: str, dev, tag: str):
    """(cfg, params): ``arch`` at its published width, bf16 weights from
    `init_params` seed 0, counted against the schema."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in [*params["embed"].values(),
                                *params["lnf"].values()])
    n += sum(x.numel() for layer in params["layers"]
             for sub in layer.values() for x in sub.values())
    print(f"{tag}: {cfg.name} {n:,} parameters (bf16, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if n != M.param_count(cfg):
        fail(f"{n} parameters, the schema counts {M.param_count(cfg)}")
    return cfg, params


def phase_serve(ops, dev, arch: str, long_len: int, tag: str):
    """A serving path at full width; returns (launches, params, cfg)."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    cfg, params = full_width(arch, dev, tag)
    eng = Engine(cfg, params, max_len=SERVE_MAX_LEN, temperature=0.7,
                 dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    per_prefill, per_step = serve_kernels(cfg)
    # warm-up: cuBLAS handles and the kernels' first launches
    eng.generate(rng.integers(0, cfg.vocab, (1, 64)), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def expect(prefills: int, steps: int, what: str) -> None:
        want = {k: prefills * per_prefill.get(k, 0) + steps * per_step.get(k, 0)
                for k in ops.KERNELS}
        if dict(ops.LAUNCHES) != want:
            fail(f"{what}: launches {dict(ops.LAUNCHES)}, expected {want}")

    def check_tokens(tokens, what: str) -> None:
        if tokens.min() < 0 or tokens.max() >= cfg.vocab:
            fail(f"{what}: a token outside the vocabulary")

    def check_logits(lg, what: str) -> None:
        if not torch.isfinite(lg).all():
            fail(f"{what}: non-finite logits")

    # ---- generate: 4 prompts of 2,048 tokens, 64 new tokens each
    prompts = rng.integers(0, cfg.vocab, (4, 2048))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, _ = eng.prefill(prompts)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    check_logits(lg, "generate prefill")
    expect(1, 0, "prefill")
    t0 = time.perf_counter()
    res = eng.generate(prompts, 64)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    expect(2, 63, "generate (one prefill, 63 decode steps)")
    check_tokens(res.tokens, "generate")
    if not np.isfinite(res.logprobs).all():
        fail("generate: non-finite logprobs")
    print(f"{tag}: generate 4 x 2048 prompt tokens, 64 new: {t_gen:.2f} s; "
          f"prefill alone {t_pre * 1e3:.1f} ms = "
          f"{4 * 2048 / t_pre:,.0f} prompt tokens/s; decode "
          f"{(t_gen - t_pre) / 63 * 1e3:.2f} ms/step; mean logprob "
          f"{res.logprobs.mean():.3f}", flush=True)

    # ---- the slot API: 8 slots, two admitted batches
    state = eng.init_slots(8, max_out=64)
    prefills, steps = 2, 63
    for slots, plen, chunk, seed in (([0, 1, 2, 3], 1024, 16, 1),
                                     ([4, 5, 6, 7], long_len, 48, 2)):
        p = rng.integers(0, cfg.vocab, (4, plen))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, sl = eng.prefill(p)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        prefills += 1
        expect(prefills, steps, f"slot prefill {plen}")
        check_logits(lg, f"slot prefill {plen}")
        state = eng.admit(state, slots, lg, sl, prompt_len=plen, max_new=64,
                          seed=seed)
        del lg, sl
        t0 = time.perf_counter()
        state = eng.decode_chunk(state, chunk)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        steps += chunk
        expect(prefills, steps, f"decode_chunk({chunk})")
        check_logits(state.last, f"decode_chunk({chunk})")
        print(f"{tag}: slots {slots}: prefill 4 x {plen} in "
              f"{t_pre * 1e3:.1f} ms = {4 * plen / t_pre:,.0f} prompt "
              f"tokens/s; decode_chunk({chunk}) over 8 slots "
              f"{t_dec / chunk * 1e3:.2f} ms/step", flush=True)
    out = state.out.cpu().numpy()
    check_tokens(out, "slots")
    n_out = state.n_out.cpu().tolist()
    finished = state.finished.cpu().tolist()
    for i, (got, done) in enumerate(zip(n_out, finished)):
        budget = 64 if i < 4 else 48      # tokens the two chunks allow
        if got > budget or (got < budget and not done):
            fail(f"slot {i}: {got} tokens of {budget}, finished={done}")
    state = eng.release(state, list(range(8)))
    if state.active.any():
        fail("release left a slot active")
    launches = dict(ops.LAUNCHES)
    print(f"{tag}: slots n_out {n_out}; launches {launches}; peak memory "
          f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    # where the time goes (printed, not gated; after the launch counts):
    # one 4 x 1,024 prefill, then 3 decode steps over the 8 slots' cache
    p = rng.integers(0, cfg.vocab, (4, 1024))
    device_trace(f"{tag}-profile", "prefill", 1, lambda: eng.prefill(p))
    tok = torch.full((8, 1), eng.eos_id, dtype=torch.int64, device=dev)
    device_trace(f"{tag}-profile", "decode step", 3, lambda: [
        M.decode_step(cfg, params, tok, state.cache, state.pos, device=dev)
        for _ in range(3)])
    del state
    return launches, params, cfg


def phase_consistency(ops, params, cfg, dev, tag: str = "consistency",
                      prompt_len: int = 1024):
    """Full width, bf16: prefill of two ``prompt_len``-token prompts (one
    `flash_attention` launch per layer, and no other kernel) + one decode
    step (the decode kernel, or with a sliding window the ring cache's
    einsum) against `forward` over the prompt_len + 1 tokens (flash over
    the whole sequence). Both flows round their activations to bf16 at
    every matmul and norm, in another order and at other shapes, through
    every layer of the model."""
    from repro_torch.models import model as M
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, prompt_len))
    ops.reset_launches()
    last, cache = M.prefill(cfg, params, {"tokens": toks}, 2 * prompt_len,
                            device=dev)
    torch.cuda.synchronize()
    want = {name: 0 for name in ops.KERNELS}
    want["flash_attention"] = cfg.n_layers
    if dict(ops.LAUNCHES) != want:
        fail(f"{tag}: prefill launches {dict(ops.LAUNCHES)}, expected "
             f"{want}")
    nxt = last.float().argmax(-1)[:, None]
    lg, _ = M.decode_step(cfg, params, nxt, cache, prompt_len, device=dev)
    del cache
    ext = np.concatenate([toks, nxt.cpu().numpy()], axis=1)
    full, _ = M.forward(cfg, params, {"tokens": ext}, device=dev)
    full = full.float()
    d_pre = (last.float() - full[:, -2]).abs().max().item()
    d_dec = (lg[:, 0].float() - full[:, -1]).abs().max().item()
    scale = full[:, -2:].abs().max().item()
    agree = int((lg[:, 0].float().argmax(-1) == full[:, -1].argmax(-1))
                .sum())
    print(f"{tag}: {cfg.name} ({cfg.n_layers} layers, head_dim "
          f"{cfg.head_dim}): {want['flash_attention']} flash_attention "
          f"launches in the prefill; max|logit| {scale:.3f}; prefill vs "
          f"forward max|diff| {d_pre:.4g}; decode step vs forward max|diff| "
          f"{d_dec:.4g}; argmax agrees on {agree}/2 rows", flush=True)
    # A fault in either kernel (a wrong mask, head or row) moves logits by
    # about their own size. bf16 rounding does not: each flow rounds the
    # residual stream and every product to 8 bits (2^-9 relative) ~6 times
    # a layer (~200 times over StarCoder2's 32 layers), a random walk of a
    # few percent of a logit, and the two flows share most of those
    # roundings. So the gate is 1/8 of the largest logit.
    tol = scale / 8
    if not max(d_pre, d_dec) <= tol:
        fail(f"{tag}: prefill/decode differ from forward by more than "
             f"{tol:.4g}")


def phase_moe_determinism(params, cfg, dev) -> None:
    """Two identical bf16 prefills of 4 x 2,048 tokens give the same bits:
    the MoE combine sums a token's k outputs in a fixed order, with no
    atomics (and cuBLAS is deterministic at fixed shapes)."""
    from repro_torch.models import model as M
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (4, 2048))
    (la, ca), (lb, cb) = (M.prefill(cfg, params, {"tokens": toks}, 2048,
                                    device=dev) for _ in range(2))
    same = torch.equal(la, lb) and all(
        torch.equal(ca["attn"][n], cb["attn"][n]) for n in ("k", "v"))
    print(f"moe-determinism: two 4 x 2048 bf16 prefills: logits and cache "
          f"bit-equal: {same}", flush=True)
    if not same:
        fail("two identical bf16 MoE prefills differ")


def phase_window(ops, dev) -> None:
    """H2O-Danube-3-4B at its published width (head_dim 120, window 4,096)
    through phase 9's check; its weights are freed after."""
    cfg, params = full_width(WINDOW_ARCH, dev, "h2o")
    phase_consistency(ops, params, cfg, dev, "h2o")
    del params
    torch.cuda.empty_cache()


def phase_ssm_consistency(params, cfg, dev) -> None:
    """Full width, bf16: prefill of 1,024 tokens, then 256 decode steps fed
    the next tokens of the 1,280-token sequence, against `forward` over all
    1,280 (the prefill's state and conv tail hand off to decode)."""
    from repro_torch.models import model as M
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 1280))
    full, _ = M.forward(cfg, params, {"tokens": toks}, device=dev)
    last, cache = M.prefill(cfg, params, {"tokens": toks[:, :1024]}, 1280,
                            device=dev)
    d_pre = (last.float() - full[:, 1023].float()).abs().max().item()
    d_dec, agree, scale = 0.0, 0, full[:, 1023].float().abs().max().item()
    tok = torch.as_tensor(toks, device=dev)
    for i in range(1024, 1280):
        lg, cache = M.decode_step(cfg, params, tok[:, i:i + 1], cache, i,
                                  device=dev)
        want = full[:, i].float()
        d_dec = max(d_dec, (lg[:, 0].float() - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
        agree += int((lg[:, 0].float().argmax(-1) == want.argmax(-1)).sum())
    del cache, full
    print(f"ssm-consistency: max|logit| {scale:.3f}; prefill vs forward "
          f"max|diff| {d_pre:.4g}; 256 decode steps vs forward max|diff| "
          f"{d_dec:.4g}; argmax agrees on {agree}/512", flush=True)
    # as phase_consistency argues: a fault in the hand-off (a stale conv
    # window, a wrong state) moves logits by about their own size; bf16
    # rounding in two flows over 48 layers by a few percent
    tol = scale / 8
    if not max(d_pre, d_dec) <= tol:
        fail(f"prefill/decode differ from forward by more than {tol:.4g}")


def phase_card_cpu(dev, arch: str, prompt_len: int, tag: str) -> None:
    """A reduced config, float32, TF32 off: the same weights through
    prefill, a decode step and `Engine.generate` on the card (kernels) and
    on the CPU (plain versions)."""
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    card = convert.params_to(params, dev)
    prompts = np.random.default_rng(2).integers(2, cfg.vocab,
                                                (3, prompt_len))
    last_c, cache_c = M.prefill(cfg, card, {"tokens": prompts}, 256,
                                device=dev)
    last, cache = M.prefill(cfg, params, {"tokens": prompts}, 256,
                            device="cpu")
    nxt = last.argmax(-1)[:, None]
    step_c, _ = M.decode_step(cfg, card, nxt, cache_c, prompt_len,
                              device=dev)
    step, _ = M.decode_step(cfg, params, nxt, cache, prompt_len,
                            device="cpu")
    d_pre = (last_c.cpu() - last).abs().max().item()
    d_dec = (step_c.cpu() - step).abs().max().item()
    res_c = Engine(cfg, card, max_len=256, temperature=0.7,
                   device=dev).generate(prompts, 32)
    res = Engine(cfg, params, max_len=256, temperature=0.7,
                 device="cpu").generate(prompts, 32)
    agree = int((res_c.tokens == res.tokens).sum())
    print(f"{tag}: prefill logits max|diff| {d_pre:.3g}, first decode "
          f"step {d_dec:.3g}; generate tokens equal {agree}/"
          f"{res.tokens.size}", flush=True)
    # float32 on both sides; sums in other orders over two layers move a
    # logit of size ~1 by ~1e-6
    if not max(d_pre, d_dec) <= 1e-4:
        fail("card and CPU logits differ by more than 1e-4")


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; chip_smoke.py runs on a GPU only",
              file=sys.stderr)
        sys.exit(2)
    from repro_torch.env.llm_profiles import paper_pool
    from repro_torch.kernels import awc_fw as awc
    from repro_torch.kernels import ops
    from repro_torch.kernels import topn_lp as topn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_card()
    phase_build(ops)
    measured = phase_kernels(ops, topn, awc, dev)
    measured.update(phase_attention_kernels(ops, dev))
    measured.update(phase_ssd_kernel(ops, dev))
    pool = paper_pool("sciq")
    cfg, state = phase_decision(pool, dev, TENANTS, DECISION_ROUNDS)
    launches = phase_fleet(pool, ops, dev, TENANTS, ROUNDS)
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path never launched: {launches}")
    phase_profile(pool, dev, cfg, state, PROFILE_ROUNDS)
    phase_quickstart(pool, ops, dev, QUICKSTART_ROUNDS)
    serve_launches, params, cfg = phase_serve(ops, dev, SERVE_ARCH, 3000,
                                              "serve")
    for name in ("flash_attention", "decode_attention"):
        if serve_launches[name] == 0:
            fail(f"{name} never launched on the serving path")
    launches.update({k: serve_launches[k] for k in ("flash_attention",
                                                    "decode_attention")})
    phase_consistency(ops, params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    phase_card_cpu(dev, SERVE_ARCH, 200, "card-cpu")
    phase_window(ops, dev)
    ssm_launches, params, cfg = phase_serve(ops, dev, SSM_ARCH, 3072,
                                            "serve-ssm")
    if ssm_launches["ssd_chunk"] == 0:
        fail("ssd_chunk never launched on the SSM serving path")
    launches["ssd_chunk"] = ssm_launches["ssd_chunk"]
    phase_ssm_consistency(params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    phase_card_cpu(dev, SSM_ARCH, 64, "ssm-card-cpu")
    moe_launches, params, cfg = phase_serve(ops, dev, MOE_ARCH, 3000,
                                            "serve-moe")
    for name in ("flash_attention", "decode_attention"):
        if moe_launches[name] == 0:
            fail(f"{name} never launched on the MoE serving path")
    phase_moe_determinism(params, cfg, dev)
    phase_consistency(ops, params,
                      dataclasses.replace(cfg, capacity_factor=64.0), dev,
                      "moe-consistency", prompt_len=512)
    del params
    torch.cuda.empty_cache()
    phase_card_cpu(dev, MOE_ARCH, 200, "moe-card-cpu")

    kernels = []
    for name, mod in ops.KERNELS.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": str(mod.SOURCE.relative_to(ROOT)),
                        "replaces": mod.REPLACES,
                        "launches": launches[name],
                        **{"library_ms": None, **measured[name]}})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
