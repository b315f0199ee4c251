"""Prefill and decode of the port's serving path on one GPU.

    python3 tools/serve_bench.py prefill [--arch ARCH] [--tree DIR]
    python3 tools/serve_bench.py decode [--tree DIR]

Both serve a model at full width (bf16 weights from `init_params`, seed
0), as `chip_smoke.py`'s serving phases do: StarCoder2-7B, or for prefill
`--arch mamba2-780m`.

prefill: times `Engine.prefill` on 4 prompts of each length on the host's
clock: one untimed prefill at that length first (the allocator's growth to
the length's activations, the first launches at its shapes), then 5 timed
ones, at the lengths of `chip_smoke.py`'s prefills for the model (dense
1,024 / 2,048 / 3,000; Mamba2 1,024 / 2,048 / 3,072). Then one prefill
under `torch.profiler`. One JSON line per length: every timed prefill's
prompt tokens/s, their median, the model's kernel launches counted over
the timed prefills (`flash_attention` or `ssd_chunk`), and from the traced
prefill the device's busy ms and the device ms of each kernel whose name
holds the model kernel's prefix ("flash_" or "ssd_").

decode: a bf16 decode cache of 8 rows x 4,096 slots filled with N(0, 1)
values (seed 0), at `chip_smoke.py`'s main decode positions (4 rows near
1,100, 4 near 3,050), which do not advance, so every step reads the same
cache. After 3 untimed steps, one JSON line: `decode_step` on the host's
clock over 20 steps (ms/step); a `torch.profiler` trace of 3 steps (device
busy ms/step, kernels per step, and the device ms/step of every kernel
whose name holds "decode_"); and `ops.decode_attention` alone on layer 0's
cache at a step's q shape (8, 1, 36, 128), as `chip_smoke.py` phase 3
times it: 100 calls made one by one, and a CUDA graph of 50 calls
(device time without the host's pace). Phase 3 gives SDPA's times.

`--tree` names the checkout whose `src/` is imported (default: the one
holding this script), so two commits are compared on one card by unpacking
the other into a git-ignored directory and running the two in turns:
other, this, this, other. The timing helpers come from this checkout's
`chip_smoke.py` either way. Prints the card's name and power limit first.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# prefill: per model, the prompt lengths (4 prompts each), the kernel it
# launches, and that kernel's name prefix in a profiler trace
PREFILL = {"starcoder2-7b": ((1024, 2048, 3000), "flash_attention", "flash_"),
           "mamba2-780m": ((1024, 2048, 3072), "ssd_chunk", "ssd_")}
REPS = 5                         # prefill: timed prefills per length
POS = [1100, 1110, 1120, 1130, 3040, 3041, 3047, 3055]   # decode rows
STEPS = 20                       # decode: timed steps
TRACED = 3                       # decode: steps under the profiler


def bench_prefill(tree, cfg, params, dev, ops, M) -> None:
    from chip_smoke import device_profile
    from repro_torch.serving.engine import Engine
    lens, kernel, prefix = PREFILL[cfg.name]
    eng = Engine(cfg, params, max_len=4096, temperature=0.7,
                 dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    eng.generate(rng.integers(0, cfg.vocab, (1, 64)), 2)
    for plen in lens:
        prompts = rng.integers(0, cfg.vocab, (4, plen))
        eng.prefill(prompts)
        torch.cuda.synchronize()
        ops.reset_launches()
        tps = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            lg, _ = eng.prefill(prompts)
            torch.cuda.synchronize()
            tps.append(4 * plen / (time.perf_counter() - t0))
            if not torch.isfinite(lg).all():
                sys.exit(f"serve_bench: non-finite logits at {plen}")
            del lg
        launches = ops.LAUNCHES[kernel]
        _, traced = device_profile(lambda: eng.prefill(prompts))
        print(json.dumps({
            "tree": str(tree), "arch": cfg.name, "prompts": 4, "len": plen,
            "tokens_per_s": [round(x, 1) for x in tps],
            "median": round(float(np.median(tps)), 1),
            f"{kernel}_launches": launches,
            "traced_busy_ms": round(
                sum(e.self_device_time_total for e in traced) / 1e3, 4),
            "traced_kernel_ms": {
                e.key: round(e.self_device_time_total / 1e3, 4)
                for e in traced if prefix in e.key}}), flush=True)


def bench_decode(tree, cfg, params, dev, ops, M) -> None:
    from chip_smoke import cuda_ms, device_profile, graph_ms
    cache = M.init_decode_caches(cfg, len(POS), 4096, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for x in cache["attn"].values():
        x.copy_(torch.randn(x.shape, generator=gen, device=dev))
    pos = torch.tensor(POS, dtype=torch.int32, device=dev)
    tok = torch.ones((len(POS), 1), dtype=torch.int64, device=dev)

    def step():
        return M.decode_step(cfg, params, tok, cache, pos, device=dev)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    launches = ops.LAUNCHES["decode_attention"]

    _, kernels = device_profile(lambda: [step() for _ in range(TRACED)])
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / TRACED
    dec = sum(e.self_device_time_total for e in kernels
              if "decode_" in e.key) / 1e3 / TRACED
    count = sum(e.count for e in kernels) / TRACED

    q = torch.randn((len(POS), 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v = cache["attn"]["k"][0], cache["attn"]["v"][0]

    def kernel():
        return ops.decode_attention(q, k, v, pos)

    print(json.dumps({
        "tree": str(tree), "rows": len(POS), "pos": POS,
        "step_ms": round(step_ms, 3),
        "decode_attention_launches": launches,
        "traced_busy_ms_per_step": round(busy, 4),
        "traced_kernels_per_step": count,
        "traced_decode_kernels_ms_per_step": round(dec, 4),
        "kernel_ms": round(cuda_ms(kernel, iters=100), 5),
        "kernel_graph_ms": round(graph_ms(kernel), 5)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("prefill", "decode"))
    ap.add_argument("--arch", choices=tuple(PREFILL), default="starcoder2-7b",
                    help="the model (prefill only; decode is StarCoder2-7B)")
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    if args.mode == "decode" and args.arch != "starcoder2-7b":
        ap.error("decode serves starcoder2-7b only")
    if not torch.cuda.is_available():
        sys.exit("serve_bench: no CUDA device")
    tree = Path(args.tree).resolve()
    # chip_smoke puts this checkout's src/ first when imported; the tree's
    # src/ goes in front of it before anything of the port is imported
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # noqa: F401
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    bench = bench_prefill if args.mode == "prefill" else bench_decode
    bench(tree, cfg, params, dev, ops, M)


if __name__ == "__main__":
    main()
