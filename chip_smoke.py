"""Drive the PyTorch port of C2MAB-V on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails the run on any mismatch:

  1. card       the card's name and power limit (nvidia-smi)
  2. build      both CUDA kernels, one nvcc per source, started together
  3. kernels    each kernel against its plain PyTorch version on the card, at
                the main path's shapes and at edge and tie cases; times with
                CUDA events and the bound the card's rates allow
  4. decision   a 4096-tenant mixed fleet runs 16 rounds on the card; from
                its state one `_tenant_act` runs on the card (kernels) and
                on the CPU (plain versions) with the same keys
  5. fleet      the main path: `simulate_fleet` on the card, 4096 tenants in
                thirds of AWC, SUC and AIC on the paper's pool, 128 rounds;
                launch counts must match the round structure
  6. profile    where a fleet round's time goes (printed, not gated):
                host-clock times of its parts, and a `torch.profiler` trace
                of a few rounds for the device's busy share and the kernels
                launched per round
  7. quickstart `bandit.simulate("c2mabv")` with examples/quickstart.py's
                settings must reach its verdict, violation ≈ 0

The next-to-last line of output is one JSON object describing every kernel;
the last is {"ok": true, "device": {...}}. Without a CUDA device, or without
the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TENANTS = 4096                   # the fleet: thirds of AWC, SUC, AIC
ROUNDS = 128                     # fleet rounds (phase 5)
DECISION_ROUNDS = 16             # rounds before the decision check (phase 4)
PROFILE_ROUNDS = 4               # rounds traced by the profiler (phase 6)
QUICKSTART_ROUNDS = 2000         # examples/quickstart.py's T (phase 6)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores


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


def bound(nbytes: float, ops: float):
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def topn_cost(b: int, k: int):
    """Bytes (score, cost, n read once; out written once) and operations
    (a compare-and-count per arm pair, a mask multiply and an add per arm)."""
    return 4.0 * (2 * b * k + 2 * b), float(b * k * k + 2 * b * k)


def awc_cost(b: int, k: int, g: int):
    """Bytes (z, μ, c, λ, n read once; g and costs written once) and
    operations (six per arm for the gradient; per λ and arm pair two
    subtractions, a multiply and a compare; per λ and arm a multiply, a
    compare, a mask multiply and an add)."""
    nbytes = 4.0 * (3 * b * k + b * g + b + b * k + b * g)
    ops = float(6 * b * k + 4 * b * g * k * k + 4 * b * g * k)
    return nbytes, ops


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
    from repro_torch.core import relax
    gen = torch.Generator().manual_seed(0)
    results = {}

    # ---- topn_lp: score rows w − λc as the solver forms them
    def topn_rows(b, k):
        """As `relax._lagrangian_costs` forms them: per (w, c, n) row a
        batch of GRID_POINTS probe λ's when b allows (a mantissa round),
        else one. λ is an octave 2^e times a dyadic mantissa from 0 or 1,
        capped at 2^LAM_MAX_EXP, so most rows hold the large-λ regime where
        every score is negative; c has zeros (an unexplored arm's LCB)."""
        g = relax.GRID_POINTS if b % relax.GRID_POINTS == 0 else 1
        r = b // g
        w = torch.rand((r, k), generator=gen)
        c = torch.rand((r, k), generator=gen) * 0.8
        c[::3, ::4] = 0.0
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

    cases = [("main", 174784, 9), ("B512K9", 512, 9), ("B4096K9", 4096, 9),
             ("B1024K128", 1024, 128), ("K130", 5, 130), ("B33", 33, 40)]
    tie = (torch.tensor([[0.5, 0.7, 0.5, 0.7, 0.1], [1.0] * 5], device=dev),
           torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0]] * 2, device=dev),
           torch.tensor([3, 2], dtype=torch.int32, device=dev))
    worst, main = 0.0, None
    for label, b, k in cases + [("ties", 2, 5)]:
        args = tie if label == "ties" else topn_rows(b, k)
        for eq in (True, False):
            out = ops.topn_lp(*args, equality=eq)
            want = topn.topn_lp_plain(*args, equality=eq)
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            worst = max(worst, err)
            if err > 1e-6:
                fail(f"topn_lp {label} equality={eq}: max|diff| {err}")
            if label == "ties" and eq and out.tolist() != [11.0, 3.0]:
                fail(f"topn_lp tie order: {out.tolist()}")
            ms = cuda_ms(lambda: ops.topn_lp(*args, equality=eq))
            plain_ms = cuda_ms(lambda: topn.topn_lp_plain(*args, equality=eq),
                               iters=5)
            b_ms, b_by = bound(*topn_cost(b, k))
            print(f"topn_lp {label:9s} B={b:6d} K={k:3d} eq={eq!s:5s} "
                  f"max|diff|={err:.3g} kernel={ms:.4f}ms "
                  f"plain={plain_ms:.4f}ms bound={b_ms:.5f}ms ({b_by})",
                  flush=True)
            if label == "main" and eq:
                main = (ms, plain_ms, b_ms, b_by)
    results["topn_lp"] = dict(max_abs_err=worst, ms=main[0], plain_ms=main[1],
                              bound_ms=main[2], bound_by=main[3])

    # ---- awc_fw: FW gradients and the octave ladder
    def awc_rows(b, k, g):
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

    cases = [("main", 1365, 9, 25), ("B64K9G25", 64, 9, 25),
             ("B512K9G25", 512, 9, 25), ("B256K64G8", 256, 64, 8)]
    tie = tuple(x.to(dev) for x in (
        torch.zeros((2, 4)),
        torch.tensor([[0.5, 0.5, 0.25, 0.5], [0.5, 0.25, 0.125, 0.0625]]),
        torch.tensor([[1.0, 2.0, 1.0, 4.0], [1.0, 1.0, 1.0, 1.0]]),
        torch.tensor([[0.0, 0.25], [0.0, 0.25]]),
        torch.tensor([3, 2], dtype=torch.int32)))
    worst, main = 0.0, None
    for label, b, k, g in cases + [("ties", 2, 4, 2)]:
        args = tie if label == "ties" else awc_rows(b, k, g)
        gk, ck = ops.awc_fw(*args)
        gp, cp = awc.awc_fw_plain(*args)
        torch.cuda.synchronize()
        err_g = (gk - gp).abs().max().item()
        err_c = (ck - cp).abs().max().item()
        worst = max(worst, err_g, err_c)
        if err_g > 2e-6 or err_c > 1e-6:
            fail(f"awc_fw {label}: max|diff| g {err_g} costs {err_c}")
        if label == "ties" and ck[0, 1].item() != 1.0:
            fail(f"awc_fw positivity: {ck.tolist()}")
        ms = cuda_ms(lambda: ops.awc_fw(*args))
        plain_ms = cuda_ms(lambda: awc.awc_fw_plain(*args), iters=5)
        b_ms, b_by = bound(*awc_cost(b, k, g))
        print(f"awc_fw  {label:9s} B={b:6d} K={k:3d} G={g:2d} "
              f"max|diff| g={err_g:.3g} costs={err_c:.3g} kernel={ms:.4f}ms "
              f"plain={plain_ms:.4f}ms bound={b_ms:.5f}ms ({b_by})",
              flush=True)
        if label == "main":
            main = (ms, plain_ms, b_ms, b_by)
    results["awc_fw"] = dict(max_abs_err=worst, ms=main[0], plain_ms=main[1],
                             bound_ms=main[2], bound_by=main[3])
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
    launches = dict(ops.LAUNCHES)
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fleet.simulate_fleet(pool, cfg, T=rounds, state=state, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"profile: {rounds} rounds traced: wall {wall_ms / rounds:.2f} "
          f"ms/round (profiler on), device busy {busy_us / 1e3 / rounds:.3f} "
          f"ms/round, idle share {1 - busy_us / 1e3 / wall_ms:.4f}, "
          f"{launches / rounds:.0f} kernels/round", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile:   {e.count / rounds:7.0f}/round "
              f"{e.self_device_time_total / 1e3 / rounds:8.3f} ms/round  "
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
          f"ratio {s['ratio_final']:.1f} launches {dict(ops.LAUNCHES)}",
          flush=True)
    if min(ops.LAUNCHES.values()) == 0:
        fail("the quickstart ran without a kernel launch")
    if s["violation_final"] > 1e-3:
        fail(f"quickstart verdict not reached: violation "
             f"{s['violation_final']}")


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
    pool = paper_pool("sciq")
    cfg, state = phase_decision(pool, dev, TENANTS, DECISION_ROUNDS)
    launches = phase_fleet(pool, ops, dev, TENANTS, ROUNDS)
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path never launched: {launches}")
    phase_profile(pool, dev, cfg, state, PROFILE_ROUNDS)
    phase_quickstart(pool, ops, dev, QUICKSTART_ROUNDS)

    kernels = []
    for name, mod in ops.KERNELS.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": str(mod.SOURCE.relative_to(ROOT)),
                        "replaces": mod.REPLACES,
                        "launches": launches[name], **measured[name],
                        "library_ms": None})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
