"""The fleet loop's two kernels and a fleet round of the port on one GPU.

    python3 tools/fleet_bench.py [--tree DIR]

The fleet is `chip_smoke.py`'s: 4,096 tenants in thirds of AWC, SUC and
AIC on `paper_pool("sciq")` (K = 9). One JSON line, after the card's name
and power limit:

- kernel_graph_ms: the device time per call of each fleet kernel at the
  shapes of a fleet round, replayed from a CUDA graph of 50 calls
  (`chip_smoke.graph_ms`): `topn_lp` at 68,275 × 9 (the SUC/AIC octave
  round), 174,784 × 9 (their mantissa rounds) and 87,360 × 9 (the AWC
  mantissa rounds), `awc_fw` at 1,365 × 9 × 25; inputs from
  `chip_smoke.topn_rows` / `awc_rows` (seed 0);
- traced: a 16-round fleet (seed 1), then 4 more rounds from its state
  under `torch.profiler`: per round the device ms of every kernel whose
  name holds "topn_lp" or "awc_fw", their sum, the device's busy ms, its
  idle share (wall time with the profiler on) and the kernels launched;
- rounds_per_s: `simulate_fleet` from a fresh state over 128 rounds
  (seed 0) on the host's clock, with the fleet kernels' launch counts.

`--tree` names the checkout whose `src/` is imported (default: the one
holding this script), so two commits are compared on one card by unpacking
the other into a git-ignored directory and running the two in turns:
other, this, this, other. The timing helpers come from this checkout's
`chip_smoke.py` either way. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TRACE_FROM = 16                  # rounds run before the traced ones
TRACED = 4                       # rounds under the profiler
ROUNDS = 128                     # rounds timed on the host's clock


def kernel_graph_ms(smoke, ops, dev) -> dict:
    gen = torch.Generator().manual_seed(0)
    out = {}
    for _, b, k, eq in smoke.TOPN_SHAPES:
        args = smoke.topn_rows(b, k, gen, dev)
        out[f"topn_lp {b}x{k}"] = smoke.graph_ms(
            lambda: ops.topn_lp(*args, equality=eq))
    args = smoke.awc_rows(1365, 9, 25, gen, dev)
    out["awc_fw 1365x9x25"] = smoke.graph_ms(lambda: ops.awc_fw(*args))
    return out


def traced_round(smoke, fleet, pool, cfg, dev) -> dict:
    state = fleet.simulate_fleet(pool, cfg, T=TRACE_FROM, seed=1,
                                 device=dev).state
    wall_ms, kernels = smoke.device_profile(lambda: fleet.simulate_fleet(
        pool, cfg, T=TRACED, state=state, device=dev))
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    by_name = {e.key: e.self_device_time_total / 1e3 / TRACED
               for e in kernels if "topn_lp" in e.key or "awc_fw" in e.key}
    return {"fleet_kernel_ms_per_round": by_name,
            "fleet_kernels_ms_per_round": sum(by_name.values()),
            "busy_ms_per_round": busy / TRACED,
            "idle_share": 1 - busy / wall_ms,
            "kernels_per_round": sum(e.count for e in kernels) / TRACED}


def rounds_per_s(fleet, ops, pool, cfg, dev) -> dict:
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    fleet.simulate_fleet(pool, cfg, T=ROUNDS, seed=0, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {"rounds": ROUNDS, "rounds_per_s": ROUNDS / secs,
            "launches": {k: ops.LAUNCHES[k] for k in ("topn_lp", "awc_fw")}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fleet_bench: no CUDA device")
    tree = Path(args.tree).resolve()
    # chip_smoke puts this checkout's src/ first when imported; the tree's
    # src/ goes in front of it before anything of the port is imported
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.env.llm_profiles import paper_pool
    from repro_torch.kernels import ops
    from repro_torch.router import fleet

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    pool = paper_pool("sciq")
    _, _, cfg = smoke.mixed_fleet(pool, smoke.TENANTS, ROUNDS, dev)
    result = {"tree": str(tree), "tenants": smoke.TENANTS,
              "kernel_graph_ms": kernel_graph_ms(smoke, ops, dev)}
    result.update(traced_round(smoke, fleet, pool, cfg, dev))
    result.update(rounds_per_s(fleet, ops, pool, cfg, dev))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
