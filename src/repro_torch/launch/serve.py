"""Serving launcher: the C2MAB-V router over a pool of deployed models
(port of `repro/launch/serve.py`).

Builds reduced pool members with one shared vocabulary (training the first
``--train-first`` of them briefly with AdamW, so the pool has a quality
gradient), then runs the full local-cloud loop: relax (local) -> round +
dispatch (cloud) -> generation -> feedback. ``--dispatch continuous`` (the
default) serves generation through the continuous-batching scheduler;
``--tenants M`` steps M local servers against the shared pool so that
their requests share decode batches. ``--fault-rate`` arms the seeded
fault plan (`serving.faults`): failed attempts feed the bandit as
zero-reward observations at the attempted work's cost, and each replica's
health counters print at the end.

    python -m repro_torch.launch.serve --kind awc --rounds 30 \\
        --pool h2o-danube-3-4b,mamba2-780m,starcoder2-7b --train-first 1 \\
        --dispatch continuous --tenants 4 --fault-rate 0.2 --fault-seed 7

runs on the card; `main(argv, device="cpu")` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs.base import get_config
from repro_torch.core.policies import PolicyConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.router.cloud import Replica, SchedulingCloud
from repro_torch.router.service import FleetService, MultiLLMService
from repro_torch.serving.engine import Engine
from repro_torch.serving.faults import FaultPlan, HealthPolicy
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

VOCAB = 128


def build_pool(names, data: SyntheticLM, train_first: int,
               train_steps: int = 60, *, device="cuda"):
    """One `Replica` a name: the config's reduced form at vocab VOCAB, its
    weights from seed i; the first ``train_first`` trained for
    ``train_steps`` AdamW steps on ``data``; the per-token price ladder
    0.001 · (1 + i). The engines get the weights detached."""
    dev = resolve_device(device)
    replicas = []
    for i, nm in enumerate(names):
        cfg = dataclasses.replace(get_config(nm).reduced(), vocab=VOCAB)
        params = M.init_params(cfg, i, device=dev)
        if i < train_first:
            ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10,
                                   total_steps=train_steps)
            st = opt.init_adamw(ocfg, params)
            ts = make_train_step(cfg, ocfg, remat=False, device=dev)
            for s in range(train_steps):
                b = data.batch(s)
                params, st, mt = ts(params, st, {"tokens": b[:, :-1],
                                                 "labels": b[:, 1:]})
            print(f"  {nm}: trained to loss {float(mt['loss']):.3f}")
            params = opt.tree_map(lambda p: p.detach().requires_grad_(False),
                                  params)
        else:
            print(f"  {nm}: untrained (low-quality pool member)")
        price = 0.001 * (1 + i)      # per-token price ladder
        eng = Engine(cfg, params, max_len=64, eos_id=0, temperature=0.7,
                     device=dev)
        replicas.append(Replica(nm, eng, price))
    return replicas


def main(argv=None, *, device="cuda"):
    """Run the launcher; returns tenant 0's `MultiLLMService.summary()`
    with the run's ``rounds_per_s``, ``selections`` (tenant 0's
    observations an arm), ``failed`` (its terminal failures) and
    ``replica_stats`` (the scheduler's health counters, one dict a
    replica; empty for the sequential dispatch)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default="awc", choices=["awc", "suc", "aic"])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--pool", default="h2o-danube-3-4b,mamba2-780m,"
                                      "starcoder2-7b")
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--rho", type=float, default=0.6)
    ap.add_argument("--batch-size", type=int, default=1,
                    help="App. E.3 async local-cloud sync batch")
    ap.add_argument("--train-first", type=int, default=1,
                    help="how many pool members to pre-train on the stream")
    ap.add_argument("--dispatch", default="continuous",
                    choices=["continuous", "sequential"],
                    help="continuous-batching scheduler vs the blocking "
                         "per-arm reference dispatch")
    ap.add_argument("--tenants", type=int, default=1,
                    help="local servers sharing the pool; >1 coalesces "
                         "tenant requests into shared decode batches")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="chaos mode: per-attempt injected failure "
                         "probability (seeded, reproducible)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--crash-on-decode", action="store_true",
                    help="doomed attempts crash the engine mid-decode "
                         "instead of failing cleanly (exercises recovery)")
    ap.add_argument("--spike-prob", type=float, default=0.0,
                    help="probability of an injected admission latency "
                         "spike per attempt")
    ap.add_argument("--max-retries", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    names = args.pool.split(",")
    data = SyntheticLM(DataConfig(vocab=VOCAB, seq_len=32,
                                  global_batch=8, seed=0))
    print(f"building pool of {len(names)} models ...")
    replicas = build_pool(names, data, args.train_first, device=dev)

    pcfg = PolicyConfig(kind=args.kind, k=len(names), n=args.n,
                        rho=args.rho, delta=0.1)
    cloud = SchedulingCloud(pcfg, replicas, device=dev)
    fault_kw = {}
    if args.fault_rate > 0 or args.spike_prob > 0:
        fault_kw = dict(
            fault_plan=FaultPlan(fault_seed=args.fault_seed,
                                 fail_prob=args.fault_rate,
                                 crash_on_decode=args.crash_on_decode,
                                 spike_prob=args.spike_prob),
            health=HealthPolicy(max_retries=args.max_retries))
    if args.tenants > 1:
        fs = FleetService(pcfg, cloud, data, n_tenants=args.tenants,
                          prompt_len=8, max_new=8,
                          batch_size=args.batch_size, **fault_kw)
        svc = fs.tenants[0]
        runner = fs
    else:
        svc = MultiLLMService(pcfg, cloud, data, prompt_len=8, max_new=8,
                              batch_size=args.batch_size,
                              dispatch=args.dispatch, **fault_kw)
        runner = svc
    t0 = time.time()
    runner.run(args.rounds)
    dt = time.time() - t0
    s = svc.summary()
    gen_tokens = sum(
        int(h.observed.sum()) for h in svc.history) * args.tenants * 8 * 8
    print(f"\n{args.rounds} rounds x {args.tenants} tenant(s) in {dt:.1f}s "
          f"({args.rounds * args.tenants / dt:.2f} rounds/s, "
          f"~{gen_tokens / dt:.0f} tok/s incl. prompt)")
    print(f"mean observed reward {s['mean_observed_reward']:.3f}  "
          f"mean cost {s['mean_cost']:.4f}  violation {s['violation']:.4f}")
    selections = dict(zip(names, svc.local.t_mu.astype(int).tolist()))
    print("selections:", selections)
    failed = sum(int(h.failed.sum()) for h in svc.history
                 if h.failed is not None)
    stats = svc.sched.stats() if svc.sched is not None else []
    if fault_kw and svc.sched is not None:
        print(f"chaos: {failed} terminal failure(s) observed by tenant 0")
        for nm, st in zip(names, stats):
            print(f"  {nm}: {st}")
    return {**s, "rounds_per_s": args.rounds * args.tenants / dt,
            "selections": selections, "failed": failed,
            "replica_stats": stats}


if __name__ == "__main__":
    main()
