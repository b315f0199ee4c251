"""Dense prefill throughput of the port's serving engine on one GPU.

    python3 tools/prefill_bench.py [--tree DIR]

Serves StarCoder2-7B at full width (bf16 weights from `init_params`, seed
0) behind `Engine`, as `chip_smoke.py`'s serving phase does, and times
`Engine.prefill` on 4 prompts of each length on the host's clock: one
untimed prefill at that length first (the allocator's growth to the
length's activations, the first launches at its shapes), then 5 timed
ones, at the lengths of `chip_smoke.py`'s dense prefills. `--tree` names
the checkout whose `src/` is imported (default: the one holding this
script), so two commits are compared on one card by unpacking the other
into a git-ignored directory and running the two in turns: other, this,
this, other.

Prints the card's name and power limit, then one JSON line per length: the
tree, the length, every timed prefill's prompt tokens/s, their median, and
the `flash_attention` launches counted over the timed prefills. Exits
non-zero without a CUDA device.
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

LENS = (1024, 2048, 3000)        # prompt lengths, 4 prompts each
REPS = 5                         # timed prefills per length


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("prefill_bench: no CUDA device")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_config("starcoder2-7b")
    params = M.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    eng = Engine(cfg, params, max_len=4096, temperature=0.7,
                 dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    eng.generate(rng.integers(0, cfg.vocab, (1, 64)), 2)
    for plen in LENS:
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
                sys.exit(f"prefill_bench: non-finite logits at {plen}")
            del lg
        print(json.dumps({
            "tree": str(tree), "prompts": 4, "len": plen,
            "tokens_per_s": [round(x, 1) for x in tps],
            "median": round(float(np.median(tps)), 1),
            "flash_attention_launches": ops.LAUNCHES["flash_attention"]}),
            flush=True)


if __name__ == "__main__":
    main()
