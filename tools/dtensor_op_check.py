"""Which aten ops of the sharded training step lack a DTensor rule in this
torch.

    python3 tools/dtensor_op_check.py

Runs one sharded AdamW step (remat) of each family's reduced model
(starcoder2-7b, mamba2-780m, olmoe-1b-7b, zamba2-2.7b, qwen2-vl-72b,
whisper-large-v3; fp32, 2 × 32 tokens) on the CPU, under a one-rank gloo
group's (1, 1) ("data", "model") mesh, with a `TorchDispatchMode` that
records every aten op called with a DTensor argument. Then it looks each
op up in this torch's DTensor sharding-rule tables
(`DTensor._op_dispatcher.sharding_propagator`) and prints one JSON line:
the torch version, the ops recorded, and those with no rule. An op with no
rule raises when a DTensor meets it; one whose rule is wrong (torch 2.11's
`constant_pad_nd`, a one-dim mesh's rule) shows only when it runs. The
recording torch and the checked one are the same, so run it where the
step is to run (on the card's machine it checks that machine's torch).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

ARCHS = ("starcoder2-7b", "mamba2-780m", "olmoe-1b-7b", "zamba2-2.7b",
         "qwen2-vl-72b", "whisper-large-v3")


def _batch(cfg, b: int = 2, s: int = 32) -> dict:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal(
            (b, s // 8, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal(
            (b, 64, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def recorded_ops() -> set:
    """The aten ops the six steps call with a DTensor argument."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch import sharding
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    seen = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(isinstance(a, DTensor) for a in tree_leaves((args,
                                                                kwargs))):
                seen.add(func)
            return func(*args, **kwargs)

    mesh = make_cpu_mesh()
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        with sharding.use_mesh(mesh):
            params = sharding.distribute_tree(
                M.init_params(cfg, 0, device="cpu"), M.param_axes(cfg), mesh)
            step = make_train_step(cfg, ocfg, remat=True, device="cpu")
            state = opt.init_adamw(ocfg, params)
            with Record():
                step(params, state, _batch(cfg))
    return seen


def main() -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    tmp = tempfile.mkdtemp(prefix="dtensor-ops-")
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "rendezvous"), world_size=1, rank=0)
    try:
        ops = recorded_ops()
    finally:
        dist.destroy_process_group()
    prop = DTensor._op_dispatcher.sharding_propagator
    tables = [getattr(prop, name) for name in
              ("op_strategy_funcs", "op_to_rules",
               "op_single_dim_strategy_funcs") if hasattr(prop, name)]
    missing = sorted(str(op) for op in ops
                     if not any(op in table for table in tables))
    print(json.dumps({"torch": torch.__version__, "recorded": len(ops),
                      "ops": sorted(str(op) for op in ops),
                      "no_rule": missing}), flush=True)


if __name__ == "__main__":
    main()
