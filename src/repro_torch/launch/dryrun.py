"""Multi-pod dry run on a fake process group (port of
`repro/launch/dryrun.py`).

Runs every (architecture × input shape × mesh) step on the production
meshes, 16 × 16 = 256 ranks ("data", "model") and 2 × 16 × 16 = 512 ranks
("pod", "data", "model"), as this process, rank 0 of a fake process group
(`torch.testing._internal.distributed.fake_pg`: collectives return at
once and move nothing). Params, AdamW state, inputs and caches are
DTensors on the ``meta`` device, placed by `models.model.param_axes`,
`optimizer.adamw_state_axes`, `input_specs` and `decode_cache_axes`:
nothing is allocated and no kernel runs; each op runs its sharding rule
and a meta computation of rank 0's block, so a missing DTensor rule shows
as a FAIL line naming the op.

For each case it records
  - FLOPs, counted on the ops as they run (`torch.utils.flop_counter`'s
    formulas): ``flops_global``, the whole program's, from the DTensor
    ops' global shapes, the way `FlopCounterMode` counts over DTensors,
    plus the local ops of `local_map` regions times the blocks the
    region's placements split into, and the local ops outside any
    (the expert-parallel MoE's) times the ranks; ``flops``, rank 0's own,
    from the aten ops on its local shards (JAX's per-device count);
  - collective bytes: the collectives rank 0 issues (`_c10d_functional`
    and `c10d` ops, also those DTensor issues inside an op), with the
    reference's accounting (`collective_bytes`: each device's result
    bytes, an all-reduce twice, a reduce-scatter its operand);
  - memory: rank 0's local shards of the arguments and of the outputs,
    and the peak from `torch.distributed._tools.mem_tracker.MemTracker`
    where it runs on these tensors (-1 where it does not, as the
    reference gives a missing field); ``bytes_accessed`` and
    ``temp_bytes`` are not counted (-1).

Eager counting is linear in depth, so the reference's extrapolation from
U = 2 and 4 layer units (1 and 2 below 4) is exact here; it is kept for
the record's keys and for speed: a case runs at U-lo and U-hi only, the
``*_raw`` fields hold the U-lo counts and the others are extrapolated to
the config's depth (``argument_bytes`` is counted at full depth).
``lower_s`` is the seconds to build the full-depth case, ``compile_s``
the seconds of the two counted runs.

Artifacts land in artifacts/dryrun_torch/<mesh>/<arch>--<shape>.json
(never the reference's artifacts/dryrun/).

Usage (on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch A --shape S \\
      [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import sharding
from repro_torch.configs.base import ArchConfig, InputShape, get_config
from repro_torch.configs.base import list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.models.layers import map_schema, torch_dtype
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (make_prefill_step,
                                          make_serve_step, make_train_step)

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# collective ops by name (`_c10d_functional` and `c10d`) -> the reference's
# kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_":
    "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "c10d")


def collective_bytes(records) -> Dict[str, Any]:
    """The reference's `parse_collective_bytes` accounting of collective
    records (kind, result bytes, operand bytes), one a collective rank 0
    issued: each device's result bytes (the ring-transfer lower bound for
    all-gather / all-to-all / collective-permute); an all-reduce moves ~2×
    its operand, counted 2×; a reduce-scatter counts its operand. Returns
    {kind: bytes, "total", "counts": {kind: n}}."""
    out: Dict[str, Any] = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, result, operand in records:
        if kind == "all-reduce":
            nbytes = 2.0 * result
        elif kind == "reduce-scatter":
            nbytes = float(operand)
        else:
            nbytes = float(result)
        out[kind] += nbytes
        counts[kind] += 1
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = counts
    return out


def _nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor or a list of them; a
    DTensor's local shard)."""
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    if not isinstance(x, torch.Tensor):
        return 0
    if sharding.is_dtensor(x):
        x = x.to_local()
    return x.numel() * x.element_size()


# ==================================================================== counter
class Counter:
    """FLOPs and collectives of the steps run inside it (`counting`)."""

    def __init__(self, world: int):
        self.world = world
        self.flops_global = 0
        self.flops = 0
        self.records = []
        self.blocks = None          # inside a local_map region: its blocks

    @contextlib.contextmanager
    def counting(self):
        from torch.distributed.tensor import experimental
        real = experimental.local_map
        counter = self

        def local_map(func=None, out_placements=None, in_placements=None,
                      in_grad_placements=None, device_mesh=None, *,
                      redistribute_inputs=False):
            wrapped = real(func, out_placements, in_placements,
                           in_grad_placements, device_mesh,
                           redistribute_inputs=redistribute_inputs)

            def counted(*args, **kwargs):
                mesh = device_mesh or next(
                    a.device_mesh for a in args if sharding.is_dtensor(a))
                pls = [p for p in (in_placements or ()) if p is not None]
                blocks = math.prod(
                    mesh.size(i) for i in range(mesh.ndim)
                    if any(p[i].is_shard() for p in pls))
                prev, counter.blocks = counter.blocks, blocks
                try:
                    return wrapped(*args, **kwargs)
                finally:
                    counter.blocks = prev
            return counted

        experimental.local_map = local_map
        try:
            with _CountMode(self):
                yield self
        finally:
            experimental.local_map = real


def _op_flops(func, args, kwargs, out) -> int:
    fn = flop_registry.get(func._overloadpacket)
    return int(fn(*args, **kwargs, out_val=out)) if fn is not None else 0


class _CountMode(TorchDispatchMode):
    """Sees each DTensor op (global shapes) and lets DTensor run it with
    the mode still on (returning NotImplemented, as `CommDebugMode` does),
    so that the local ops and the collectives DTensor issues for it come
    here too."""

    def __init__(self, counter: Counter):
        super().__init__()
        self.c = counter
        self.pending = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            f = _op_flops(func, args, kwargs, None)
            if f:
                self.c.flops_global += f
                # DTensor runs it as one local op of the same kind next
                self.pending[func] = self.pending.get(func, 0) + 1
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out               # DTensor's shape propagation
        f = _op_flops(func, args, kwargs, out)
        self.c.flops += f
        if f and self.pending.get(func):
            self.pending[func] -= 1  # a DTensor op's local run: counted
        else:                        # a local_map region's, or EP's
            self.c.flops_global += f * (self.c.blocks or self.c.world)
        ns = func.namespace
        kind = _KINDS.get(func._overloadpacket._qualified_op_name.split(
            "::")[-1]) if ns in _NAMESPACES else None
        if kind is not None:
            operand = args[0] if args else None
            self.c.records.append((kind, _nbytes(out), _nbytes(operand)))
        return out


# ===================================================================== specs
def abstract_port_params(cfg: ArchConfig, dtype=None):
    """`models.model.init_params`' tree (layers a list) as tensors on the
    ``meta`` device."""
    dt = torch_dtype(dtype or cfg.dtype)
    return M._port_tree(cfg, lambda schema: map_schema(
        lambda s: torch.empty(s.shape, dtype=dt, device="meta"), schema))


def build_case(cfg: ArchConfig, shape: InputShape, mesh, *,
               moment_dtype: str = "float32", master_dtype: str = "float32",
               remat: bool = True, impl: str = "auto", microbatch: int = 1):
    """Returns (fn, args, shardings): the step, its arguments as meta
    DTensors (the batch as whole meta tensors, which the step places by
    `input_specs`' axes), and each argument's `sharding.NamedSharding`."""
    p_abs = abstract_port_params(cfg)
    p_axes = M.param_axes(cfg)
    params = sharding.distribute_tree(p_abs, p_axes, mesh)
    p_shard = sharding.tree_shardings(p_abs, p_axes, mesh)

    if shape.kind == "train":
        ocfg = opt.AdamWConfig(moment_dtype=moment_dtype,
                               master_dtype=master_dtype)
        o_abs = opt.abstract_adamw(ocfg, p_abs)
        o_axes = opt.adamw_state_axes(p_axes)
        ostate = sharding.distribute_tree(o_abs, o_axes, mesh)
        # `adamw_update` reads the step count on the host (its schedule and
        # bias corrections are Python floats): a 0-d CPU tensor, the case's
        # one allocation
        ostate["step"] = torch.zeros((), dtype=torch.int32)
        inputs, in_axes = M.input_specs(cfg, shape)
        b_shard = sharding.tree_shardings(inputs, in_axes, mesh)
        fn = make_train_step(cfg, ocfg, remat=remat, impl=impl,
                             microbatch=microbatch, device="meta")
        return fn, (params, ostate, inputs), (
            p_shard, sharding.tree_shardings(o_abs, o_axes, mesh), b_shard)

    if shape.kind == "prefill":
        inputs, in_axes = M.input_specs(cfg, shape)
        b_shard = sharding.tree_shardings(inputs, in_axes, mesh)
        fn = make_prefill_step(cfg, impl=impl, device="meta")
        return fn, (params, inputs), (p_shard, b_shard)

    # decode
    b = shape.global_batch
    cache = M.init_decode_caches(cfg, b, shape.seq_len, torch.bfloat16,
                                 device="meta", mesh=mesh)
    c_axes = M.decode_cache_axes(cfg)
    tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    fn = make_serve_step(cfg, device="meta")
    return fn, (params, tokens, cache, pos), (
        p_shard, sharding.named_sharding((b, 1), ("batch", None), mesh),
        sharding.tree_shardings(cache, c_axes, mesh),
        sharding.NamedSharding(mesh, sharding.placements((), mesh)))


def argument_bytes(args, shardings) -> int:
    """Rank 0's bytes of the arguments as placed: a DTensor's local shard,
    a whole tensor's block under its sharding."""
    total = 0
    for a, s in zip(_leaves(args), _leaves(shardings, sharded=True)):
        if sharding.is_dtensor(a):
            total += _nbytes(a)
            continue
        local = list(a.shape)
        for i, p in enumerate(s.placements):
            if p.is_shard():
                local[p.dim] //= s.mesh.size(i)
        total += math.prod(local) * a.element_size()
    return total


def _leaves(tree, sharded: bool = False) -> list:
    if sharded and isinstance(tree, sharding.NamedSharding):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v, sharded)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, sharded)]
    return [tree]


def runnable(cfg: ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    """Is this (arch, shape) pair applicable? (the reference's rule)"""
    if shape.name.startswith("long_") and not cfg.supports_long_context:
        return False, "full-attention arch: 500k decode is not sub-quadratic"
    return True, ""


# ========================================================= layer extrapolation
def layer_units(cfg: ArchConfig) -> int:
    """Layer units: a layer (dense / moe / ssm / vlm), a shared-attention
    group (hybrid), or an encoder + decoder layer pair (audio)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_period
    return cfg.n_layers


def with_units(cfg: ArchConfig, u: int) -> ArchConfig:
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=u * cfg.shared_attn_period)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=u, n_enc_layers=u)
    return dataclasses.replace(cfg, n_layers=u)


def _mem_tracker():
    """`MemTracker`, or None where this torch has none."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except ImportError:
        return None
    return MemTracker()


def _peak(mt) -> float:
    snap = mt.get_tracker_snapshot("peak")
    return float(max(sum(v for k, v in d.items() if k != "Total")
                     for d in snap.values()))


def case_counts(cfg: ArchConfig, shape: InputShape, mesh,
                **kw) -> Dict[str, float]:
    """One counted run of the case: global and rank 0's FLOPs, collective
    bytes (the reference's accounting), rank 0's output bytes and
    `MemTracker`'s peak, tracked in the same run; where MemTracker does not
    run on these tensors the case runs again without it and the peak is -1,
    as the reference gives a missing field."""
    for mt in (_mem_tracker(), None):
        fn, args, _ = build_case(cfg, shape, mesh, **kw)
        counter = Counter(int(mesh.size()))
        try:
            with sharding.use_mesh(mesh), (mt or contextlib.nullcontext()), \
                    counter.counting():
                out = fn(*args)
            peak = _peak(mt) if mt is not None else -1.0
            peak = peak if peak > 0 else -1.0
        except Exception:  # noqa: BLE001 — MemTracker's, or the case's
            if mt is None:
                raise
            continue
        break
    coll = collective_bytes(counter.records)
    return {"flops": float(counter.flops),
            "flops_global": float(counter.flops_global),
            "coll": float(coll["total"]),
            "output_bytes": float(sum(_nbytes(t) for t in _leaves(out))),
            "peak_bytes": peak, "_coll": coll}


def extrapolated_cost(cfg: ArchConfig, shape: InputShape, mesh,
                      **kw) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(the U-lo counts, the counts extrapolated to the config's depth)."""
    u = layer_units(cfg)
    lo, hi = (2, 4) if u >= 4 else (1, 2)
    c_lo = case_counts(with_units(cfg, lo), shape, mesh, **kw)
    c_hi = case_counts(with_units(cfg, hi), shape, mesh, **kw)
    scale = (u - lo) / (hi - lo)
    extr = {}
    for k, v in c_lo.items():
        if k.startswith("_"):
            continue
        if v < 0 or c_hi[k] < 0 or (k == "peak_bytes" and c_hi[k] < v):
            # missing, or a peak that falls with depth: MemTracker in
            # torch 2.11 gives such readings on DTensors, and negative ones
            extr[k] = -1.0
        else:
            extr[k] = v + scale * (c_hi[k] - v)
    return c_lo, extr


# ========================================================= cases and CLI
@contextlib.contextmanager
def fake_group(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks
    (made, or remade at another size), destroyed at the end."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             moment_dtype: str = "float32", master_dtype: str = "float32",
             save: bool = True, verbose: bool = True, impl: str = "auto",
             remat: bool = True, microbatch: int = 1
             ) -> Optional[Dict[str, Any]]:
    """The record of one case on the production mesh (the fake process
    group must be current and of its size: `fake_group`)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = runnable(cfg, shape)
    if not ok:
        if verbose:
            print(f"SKIP {arch} x {shape_name}: {why}")
        return None
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    mesh_tag = "pod512" if multi_pod else "pod256"
    kw = dict(moment_dtype=moment_dtype, master_dtype=master_dtype,
              impl=impl, remat=remat, microbatch=microbatch)

    t0 = time.time()
    _, args, shardings = build_case(cfg, shape, mesh, **kw)
    arg_bytes = argument_bytes(args, shardings)
    t_lower = time.time() - t0
    c_lo, extr = extrapolated_cost(cfg, shape, mesh, **kw)
    t_run = time.time() - t0 - t_lower

    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "chips": mesh_mod.n_chips(mesh), "kind": shape.kind,
        "lower_s": round(t_lower, 2), "compile_s": round(t_run, 2),
        # raw = the U-lo run's counts; the others extrapolated to the
        # config's depth
        "flops_raw": c_lo["flops"],
        "flops": extr["flops"],
        "flops_global_raw": c_lo["flops_global"],
        "flops_global": extr["flops_global"],
        "bytes_accessed_raw": -1.0,
        "bytes_accessed": -1.0,
        "collective_bytes_raw": {k: v for k, v in c_lo["_coll"].items()
                                 if k != "counts"},
        "collective_bytes": extr["coll"],
        "collective_counts": c_lo["_coll"]["counts"],
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": extr["output_bytes"],
            "temp_bytes": -1,
            "peak_bytes": extr["peak_bytes"],
        },
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "moment_dtype": moment_dtype,
        "microbatch": microbatch,
    }
    if verbose:
        gb = record["memory"]["peak_bytes"] / 2**30
        print(f"OK   {arch} x {shape_name} [{mesh_tag}] "
              f"build {t_lower:.1f}s run {t_run:.1f}s "
              f"flops_global {record['flops_global']:.4g} "
              f"flops/chip {record['flops']:.4g} peak/dev {gb:.2f} GiB "
              f"coll {record['collective_bytes']:.4g} B")
    if save:
        d = ARTIFACT_DIR / mesh_tag
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{arch}--{shape_name}.json").write_text(
            json.dumps(record, indent=1))
    return record


def all_pairs():
    for arch in list_archs():
        for shape_name in SHAPES:
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--no-remat", action="store_true")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if not args.all:
        assert args.arch and args.shape, "--arch/--shape or --all"
    failures = []
    for mp in meshes:
        with fake_group(512 if mp else 256):
            pairs = all_pairs() if args.all else [(args.arch, args.shape)]
            for arch, shape_name in pairs:
                try:
                    run_case(arch, shape_name, multi_pod=mp,
                             moment_dtype=args.moment_dtype, impl=args.impl,
                             remat=not args.no_remat)
                except Exception as e:  # noqa: BLE001 — report, continue
                    if not args.all:
                        raise
                    failures.append((arch, shape_name, mp, repr(e)[:200]))
                    print(f"FAIL {arch} x {shape_name} mp={mp}: {e!r}"[:300])
    if failures:
        print(f"\n{len(failures)} FAILURES")
        sys.exit(1)
    if args.all:
        print("\nALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
