"""Which collectives gloo runs on CUDA tensors, for ranks that share one GPU.

    python3 tools/gloo_cuda_probe.py

NCCL takes one rank a device, so ranks that share a card can only meet over
gloo. The port's multi-rank paths on one card (`launch.mesh`'s fleet,
`moe.apply_moe_ep`) copy to the host around each collective; a DTensor
step on a "cuda" mesh hands gloo CUDA tensors instead. Each case below runs
on 2 ranks of a fresh gloo group (`launch.hostdev.spawn_local`), in its
own processes, so a rank that crashes ends that case alone:

- the c10d collectives DTensor's redistributions and the functional
  collectives call, each on a CUDA tensor: `all_gather_into_tensor`,
  `all_reduce`, `reduce_scatter_tensor`, `all_to_all_single`,
  `broadcast`, and the list `all_gather`;
- the same through `torch.distributed._functional_collectives`
  (``funcol-all_gather``, ``funcol-all_reduce``, ``funcol-reduce_scatter``),
  which DTensor's redistributions call;
- ``mesh-all_reduce``: an `all_reduce` over the "model" dim's group of a
  (1, 2) ("data", "model") "cuda" `DeviceMesh`;
- ``dtensor-gather``: a CUDA tensor placed `Shard(0)` on that mesh and
  gathered back whole (`full_tensor`);
- ``dtensor-step``: the reduced StarCoder2's training step (fp32, remat)
  with DTensor params on that mesh.

Prints the card's name and power limit, then one JSON line: per case "ok"
or what ended it (the exception's last line, or the ranks' exit codes).
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

CASES = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
         "all_to_all_single", "broadcast", "all_gather", "funcol-all_gather",
         "funcol-all_reduce", "funcol-reduce_scatter", "mesh-all_reduce",
         "dtensor-gather", "dtensor-step")


def _mesh():
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cuda", torch.arange(2).reshape(1, 2),
                      mesh_dim_names=("data", "model"))


def _funcol(name: str):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    x = torch.arange(4.0, device="cuda") + dist.get_rank()
    group = dist.group.WORLD
    if name == "funcol-all_gather":
        out = fc.all_gather_tensor(x, 0, group)
    elif name == "funcol-all_reduce":
        out = fc.all_reduce(x, "sum", group)
    else:
        out = fc.reduce_scatter_tensor(x, "sum", 0, group)
    out = fc.wait_tensor(out)
    torch.cuda.synchronize()
    return out.cpu().tolist()


def _on_mesh(name: str):
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = _mesh()
    x = torch.arange(4.0, device="cuda")
    if name == "mesh-all_reduce":
        out = x + dist.get_rank()
        dist.all_reduce(out, group=mesh.get_group("model"))
    else:
        out = distribute_tensor(x, mesh, [Shard(0), Shard(0)],
                                src_data_rank=None).full_tensor()
    torch.cuda.synchronize()
    return out.cpu().tolist()


def _collective(name: str):
    import torch.distributed as dist
    rank = dist.get_rank()
    x = torch.arange(4.0, device="cuda") + rank
    if name == "all_gather_into_tensor":
        out = torch.empty(8, device="cuda")
        dist.all_gather_into_tensor(out, x)
    elif name == "all_reduce":
        out = x.clone()
        dist.all_reduce(out)
    elif name == "reduce_scatter_tensor":
        out = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(out, x)
    elif name == "all_to_all_single":
        out = torch.empty(4, device="cuda")
        dist.all_to_all_single(out, x)
    elif name == "broadcast":
        out = x.clone()
        dist.broadcast(out, 0)
    else:
        parts = [torch.empty(4, device="cuda") for _ in range(2)]
        dist.all_gather(parts, x)
        out = torch.cat(parts)
    torch.cuda.synchronize()
    return out.cpu().tolist()


def _dtensor_step():
    from repro_torch import sharding
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    cfg = get_config("starcoder2-7b").reduced()
    mesh = _mesh()
    toks = SyntheticLM(DataConfig(cfg.vocab, 64, 2, seed=0)).batch(0)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    with sharding.use_mesh(mesh):
        params = sharding.distribute_tree(
            M.init_params(cfg, 0, device="cuda"), M.param_axes(cfg), mesh)
        step = make_train_step(cfg, ocfg, remat=True, device="cuda")
        _, _, m = step(params, opt.init_adamw(ocfg, params),
                       {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return float(m["loss"])


def run_case(name: str):
    """One rank of case ``name`` (`spawn_local`)."""
    torch.cuda.set_device(0)
    if name == "dtensor-step":
        return _dtensor_step()
    if name.startswith("funcol-"):
        return _funcol(name)
    if name in ("mesh-all_reduce", "dtensor-gather"):
        return _on_mesh(name)
    return _collective(name)


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from repro_torch.launch.hostdev import spawn_local
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from repro_torch.kernels import ops
    ops.build(["flash_attention"])       # built here, not raced by ranks
    out = {}
    for name in CASES:
        try:
            res = spawn_local(2, run_case, name, timeout=300)
            out[name] = {"ok": True, "result": res[0]}
        except RuntimeError as e:
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            out[name] = {"ok": False, "error": " | ".join(lines[-3:])}
        print(name, out[name], flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "cases": out}), flush=True)


if __name__ == "__main__":
    main()
