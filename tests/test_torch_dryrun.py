"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's, on the CPU.

* `collective_bytes` on the records of `tests/test_launch.py`'s HLO (an
  all-gather, a two-operand all-reduce, a reduce-scatter, an all-to-all, a
  collective-permute) gives that test's numbers and the reference's
  `parse_collective_bytes` dict.
* `runnable` and the inputs of all 40 (arch × shape) pairs: the port's
  `input_specs` names, shapes, dtypes and axes against JAX's.
* In a subprocess, rank 0 of a fake process group of 4 ranks on a 2 × 2
  ("data", "model") mesh, reduced configs of the six families:
  - each functional collective (all-gather, all-reduce, reduce-scatter,
    all-to-all) is recorded with its kind and bytes;
  - a train (32 × 4), prefill (32 × 4) and decode (64-slot cache, 4 rows)
    step's global FLOPs equal one device's `FlopCounterMode` count of the
    same step on meta tensors. Stated exceptions: an SSD layer's C·Bᵀ,
    which depends on no head, is computed by each of the m = 2 head blocks
    of a batch block (the extra is (m - 1) · 2·B·NC·L²·N a layer, once in
    a prefill and 4 times in a train step: forward, remat and two
    backward products), and an expert-parallel MoE decode step, whose
    one-token sequence does not split over the "model" ranks, so every
    peer routes it (more, not equal);
  - the U-lo / U-hi extrapolation equals a full-depth count (6 layers);
  - rank 0's ``argument_bytes`` of a train case equals the per-rank bytes
    of the params and fp32 AdamW m, v and master under the reference's
    `spec_for` (as `tests/test_torch_sharding.py` counts them), plus the
    step count and the batch's block.
* The module imports neither JAX nor the reference.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import sharding as jsharding
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_archs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import dryrun as jdryrun
from repro.models import model as JM
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import model as M

ROOT = os.path.join(os.path.dirname(__file__), "..")
HLO = """
ENTRY %main {
  %ag = f32[16,1024]{1,0} all-gather(%p0), replica_groups={{0,1}}
  %ar = (bf16[512]{0}, bf16[512]{0}) all-reduce(%a, %b), to_apply=%sum
  %rs = f32[64,32]{1,0} reduce-scatter(f32[64,256]{1,0} %big), dimensions={1}
  %a2a = s32[128]{0} all-to-all(%c)
  %cp = f32[8,8]{1,0} collective-permute(%d)
  %agd = f32[4]{0} all-gather-done(%x)
}
"""
# the same collectives as records (kind, result bytes, operand bytes)
RECORDS = [("all-gather", 16 * 1024 * 4, 16 * 1024 * 4 // 2),
           ("all-reduce", 2 * 512 * 2, 2 * 512 * 2),
           ("reduce-scatter", 64 * 32 * 4, 64 * 256 * 4),
           ("all-to-all", 128 * 4, 128 * 4),
           ("collective-permute", 8 * 8 * 4, 8 * 8 * 4)]


def test_collective_accounting_is_the_reference():
    out = dryrun.collective_bytes(RECORDS)
    assert out["all-gather"] == 16 * 1024 * 4
    assert out["all-reduce"] == 2 * (512 * 2 + 512 * 2)   # 2x ring factor
    assert out["reduce-scatter"] == 64 * 256 * 4          # operand
    assert out["all-to-all"] == 128 * 4
    assert out["collective-permute"] == 8 * 8 * 4
    assert out == jdryrun.parse_collective_bytes(HLO)


def test_runnable_and_input_specs_of_all_pairs_are_the_reference():
    count = 0
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name, shape in SHAPES.items():
            count += 1
            assert dryrun.runnable(cfg, shape) == jdryrun.runnable(
                jcfg, JSHAPES[name])
            inputs, axes = M.input_specs(cfg, shape)
            if shape.kind == "decode":
                assert {k: tuple(v.shape) for k, v in inputs.items()} == {
                    "tokens": (shape.global_batch, 1)}
                continue
            jin, jaxes = JM.input_specs(jcfg, JSHAPES[name], abstract=True)
            assert axes == {k: tuple(v) for k, v in jaxes.items()}
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in inputs.items()} == {
                k: (tuple(v.shape), str(v.dtype)) for k, v in jin.items()}
            assert all(v.device.type == "meta" for v in inputs.values())
    assert count == 40


SUBPROC = r"""
import json, dataclasses
import torch
from torch.distributed import _functional_collectives as funcol
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs.base import InputShape, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (make_prefill_step,
                                          make_serve_step, make_train_step)

FAMILIES = ["starcoder2-7b", "mamba2-780m", "olmoe-1b-7b", "zamba2-2.7b",
            "qwen2-vl-72b", "whisper-large-v3"]
SHAPES = {"train": InputShape("t", 32, 4, "train"),
          "prefill": InputShape("p", 32, 4, "prefill"),
          "decode": InputShape("d", 64, 4, "decode")}


def one_device(cfg, shape):
    p = D.abstract_port_params(cfg)
    if shape.kind == "train":
        ocfg = opt.AdamWConfig()
        o = opt.abstract_adamw(ocfg, p)
        o["step"] = torch.zeros((), dtype=torch.int32)
        inputs, _ = M.input_specs(cfg, shape)
        fn = make_train_step(cfg, ocfg, remat=True, device="meta")
        args = (p, o, inputs)
    elif shape.kind == "prefill":
        inputs, _ = M.input_specs(cfg, shape)
        fn, args = make_prefill_step(cfg, device="meta"), (p, inputs)
    else:
        b = shape.global_batch
        cache = M.init_decode_caches(cfg, b, shape.seq_len, torch.bfloat16,
                                     device="meta")
        fn = make_serve_step(cfg, device="meta")
        args = (p, torch.empty((b, 1), dtype=torch.int32, device="meta"),
                cache, torch.empty((), dtype=torch.int32, device="meta"))
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


out = {"flops": {}, "colls": []}
with D.fake_group(4):
    mesh = mesh_mod._mesh((2, 2), ("data", "model"))
    counter = D.Counter(4)
    x = torch.empty((8, 16), device="meta")
    with counter.counting():
        funcol.all_gather_tensor(x, 0, (mesh, 1))
        funcol.all_reduce(x, "sum", (mesh, 1))
        funcol.reduce_scatter_tensor(x, "sum", 0, (mesh, 1))
        funcol.all_to_all_single(x, None, None, (mesh, 1))
    out["colls"] = counter.records
    for arch in FAMILIES:
        cfg = get_config(arch).reduced()
        for kind, shape in SHAPES.items():
            c = D.case_counts(cfg, shape, mesh)
            out["flops"][f"{arch}/{kind}"] = (c["flops_global"],
                                              one_device(cfg, shape),
                                              c["flops"])
    cfg = get_config("starcoder2-7b").reduced()
    six = D.with_units(cfg, 6)
    _, extr = D.extrapolated_cost(six, SHAPES["train"], mesh)
    full = D.case_counts(six, SHAPES["train"], mesh)
    out["extrapolated"] = {k: extr[k] for k in ("flops", "flops_global",
                                                "coll", "output_bytes")}
    out["full"] = {k: full[k] for k in out["extrapolated"]}
    _, args, shardings = D.build_case(cfg, SHAPES["train"], mesh)
    out["argument_bytes"] = D.argument_bytes(args, shardings)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def counted():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", SUBPROC], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_collectives_are_recorded_by_kind_and_bytes(counted):
    n = 8 * 16 * 4
    assert counted["colls"] == [["all-gather", 2 * n, n],
                                ["all-reduce", n, n],
                                ["reduce-scatter", n // 2, n],
                                ["all-to-all", n, n]]


def _cbt_extra(cfg, shape, m=2):
    """The SSD layers' C·Bᵀ counted once more a head block than on one
    device: (m - 1) · 2·B·NC·L²·N a layer and product."""
    if cfg.family not in ("ssm", "hybrid") or shape == "decode":
        return 0
    b, s, chunk = 4, 32, cfg.ssm_chunk
    nc, length = s // chunk, min(s, chunk)
    products = 4 if shape == "train" else 1
    return ((m - 1) * 2 * b * nc * length * length * cfg.ssm_state
            * cfg.n_layers * products)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "mamba2-780m",
                                  "olmoe-1b-7b", "zamba2-2.7b",
                                  "qwen2-vl-72b", "whisper-large-v3"])
def test_global_flops_are_one_devices_count(counted, arch):
    cfg = get_config(arch).reduced()
    for shape in ("train", "prefill", "decode"):
        glob, one, local = counted["flops"][f"{arch}/{shape}"]
        assert one > 0 and 0 < local < glob, (arch, shape)
        if cfg.family == "moe" and shape == "decode":
            assert glob > one            # every expert-axis peer routes
            continue
        assert glob == one + _cbt_extra(cfg, shape), (arch, shape)


def test_extrapolation_is_the_full_depth_count(counted):
    assert counted["extrapolated"] == counted["full"]
    assert counted["full"]["flops_global"] > counted["full"]["flops"] > 0


def test_train_argument_bytes_are_the_reference_rank_bytes(counted):
    class FakeMesh:
        shape = {"data": 2, "model": 2}
    jcfg = jget_config("starcoder2-7b").reduced()
    axes = jax.tree.leaves(JM.param_axes(jcfg), is_leaf=lambda x: isinstance(
        x, tuple) and all(isinstance(e, (str, type(None))) for e in x))
    abst = jax.tree.leaves(JM.abstract_params(jcfg))

    def local(shape, logical):
        spec = jsharding.spec_for(shape, logical, FakeMesh())
        n = list(shape)
        for d, part in enumerate(spec):
            for a in ((part,) if isinstance(part, str) else part or ()):
                n[d] //= FakeMesh.shape[a]
        return int(np.prod(n))
    params = sum(local(a.shape, ax) * a.dtype.itemsize
                 for a, ax in zip(abst, axes, strict=True))
    adamw = sum(3 * local(a.shape, ax) * 4
                for a, ax in zip(abst, axes, strict=True))
    batch = 2 * local((4, 32), ("batch", "seq")) * 4      # tokens, labels
    assert counted["argument_bytes"] == params + adamw + 4 + batch


def test_dryrun_imports_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch.launch.dryrun\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
