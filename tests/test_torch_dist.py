"""The port's distribution (`repro_torch.sharding`, `launch.hostdev`,
`launch.mesh`, the tenant-sharded fleet, `models.moe.apply_moe_ep`)
against the JAX package, on the CPU with local gloo ranks.

* `spec_for`: the reference's choice on every logical axis, on the meshes
  one CPU device can name (`jax.make_mesh`) and on larger mesh shapes.
* The sharded fleet (`tests/test_fleet_sharded.py` on the port): over 2
  ranks and over 2 pods × 2 ranks bit-equal to one process (actions,
  observations, costs, rewards, stats, keys, t); M that does not divide
  takes the one-device path; a kill-then-resume through the sharded path
  equals the sharded uninterrupted run; the mesh CLI.
* `apply_moe_ep` on a 2 × 2 ("data", "model") mesh: the reduced OLMoE layer
  at capacity factor 64 equals the port's and JAX's `apply_moe` within
  1e-5; at the config's capacity it equals JAX's `apply_moe_ep`, run once
  in a subprocess with 4 forced host devices (as `tests/test_launch.py`
  runs it); `apply_moe_auto` routes as the reference's does.

Each rank is a fresh interpreter (`spawn_local`); their functions are in
`tests/_torch_dist.py`.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

import _torch_dist
from repro import sharding as jsharding
from repro.configs.base import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch import sharding
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.hostdev import spawn_local
from repro_torch.models import moe

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _mesh(shape, names):
    """A DeviceMesh of any shape seen from rank 0, without a process
    group: enough for `spec_for`, which reads only names and sizes."""
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


class FakeMesh:                     # what the reference's spec_for reads
    def __init__(self, shape):
        self.shape = shape


def _cases():
    rng = np.random.default_rng(0)
    names = list(sharding.RULES)
    dims = (1, 2, 3, 4, 10, 12, 16, 36, 64, 256, 4096, 4608, 51866)
    out = [((4608, 36, 128), ("embed_fsdp", "heads", None)),
           ((256, 4096), ("batch", "fsdp")), ((16, 9), ("tenants", None))]
    for _ in range(60):
        n = int(rng.integers(1, 4))
        out.append((tuple(int(d) for d in rng.choice(dims, n)),
                    tuple(names[i] for i in rng.integers(0, len(names), n))))
    return out


def _jspec(shape, logical, mesh):
    return tuple(jsharding.spec_for(shape, logical, mesh))


# ================================================================ spec_for
def test_spec_for_matches_the_reference_on_one_device_meshes():
    for shape, names in (((1, 1), ("data", "model")), ((1,), ("data",)),
                         ((1, 1), ("pod", "data")),
                         ((1, 1, 1), ("pod", "data", "model"))):
        jm, pm = jax.make_mesh(shape, names), _mesh(shape, names)
        for dims, logical in _cases():
            assert sharding.spec_for(dims, logical, pm) == \
                _jspec(dims, logical, jm), (names, dims, logical)
    assert sharding.spec_for((8,), ("batch",)) == ()      # no mesh
    with sharding.use_mesh(_mesh((2, 4), ("data", "model"))):
        assert sharding.spec_for((8,), ("batch",)) == ("data",)
    assert sharding.current_mesh() is None


@pytest.mark.parametrize("shape,names", [
    ((16, 16), ("data", "model")), ((2, 16), ("data", "model")),
    ((2, 4), ("pod", "data")), ((2, 16, 16), ("pod", "data", "model")),
    ((3, 5), ("data", "model"))])
def test_spec_for_matches_the_reference_on_larger_meshes(shape, names):
    fake = FakeMesh(dict(zip(names, shape)))
    pm = _mesh(shape, names)
    for dims, logical in _cases():
        assert sharding.spec_for(dims, logical, pm) == \
            _jspec(dims, logical, fake), (dims, logical)


def test_meshes():
    cpu = mesh_mod.make_cpu_mesh()
    assert cpu.mesh_dim_names == ("data", "model")
    assert mesh_mod.n_chips(cpu) == 1
    assert mesh_mod.make_fleet_mesh().mesh_dim_names == ("data",)
    with pytest.raises(ValueError, match="don't split into 2 pods"):
        mesh_mod.make_fleet_mesh(3, pods=2)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_fleet_mesh(2)
    one = _torch_dist.fleet_run(6, 4, 3, mesh_pods=1)    # a one-rank mesh
    assert one["axes"] == ["data"]
    _assert_fleet_equal(one, _torch_dist.fleet_run(6, 4, 3))


def test_spawn_local_raises_a_ranks_error():
    with pytest.raises(RuntimeError, match="fails on purpose"):
        spawn_local(2, _torch_dist.fail_on, 1, timeout=120)


# =========================================================== sharded fleet
def _assert_fleet_equal(got, ref, t0=0):
    for name in ("action", "observed", "cost", "reward"):
        assert np.array_equal(got[name], ref[name][:, t0:]), name
    for name in ref["stats"]:
        assert np.array_equal(got["stats"][name], ref["stats"][name]), name
    for name in ("prev_mask", "t", "key"):
        assert np.array_equal(got[name], ref[name]), name


def test_sharded_fleet_two_ranks_and_resume(tmp_path):
    """2 ranks, M 12: bit-equal to one process over 20 rounds; then a run
    killed at round 6 (checkpoint at 4, written by rank 0) resumed through
    the sharded path to 12 equals the uninterrupted sharded run."""
    d = str(tmp_path / "ck")
    runs = spawn_local(2, _torch_dist.fleet_runs, [
        ((12, 20, 5), {"mesh_pods": 1}),
        ((12, 12, 9), {"mesh_pods": 1}),
        ((12, 6, 9), {"mesh_pods": 1, "ckpt_dir": d, "ckpt_every": 4,
                      "plan_T": 12}),
        ((12, 12, 9), {"mesh_pods": 1, "ckpt_dir": d, "ckpt_every": 4})],
        timeout=60)
    ref = _torch_dist.fleet_run(12, 20, 5)
    for rank in runs:
        sharded, full, _, resumed = rank
        assert sharded["axes"] == ["data"]
        _assert_fleet_equal(sharded, ref)
        assert resumed["t0"] == 4 and resumed["action"].shape[1] == 8
        _assert_fleet_equal(resumed, full, t0=4)
    assert sorted(os.listdir(d)) == ["12", "4", "8"]


def test_sharded_fleet_pods_and_fallback():
    """4 ranks: 2 pods × 2 with M 16 over ("pod", "data"), and M 10 on a
    4-rank data mesh, which does not divide: the one-device path."""
    runs = spawn_local(4, _torch_dist.fleet_runs, [
        ((16, 20, 5), {"mesh_pods": 2}), ((10, 20, 4), {"mesh_pods": 1})],
        timeout=90)
    ref16 = _torch_dist.fleet_run(16, 20, 5)
    ref10 = _torch_dist.fleet_run(10, 20, 4)
    for pods, fallback in runs:
        assert pods["axes"] == ["pod", "data"]
        _assert_fleet_equal(pods, ref16)
        assert fallback["axes"] is None
        _assert_fleet_equal(fallback, ref10)


def test_mesh_cli(tmp_path, capsys):
    rec = mesh_mod._main(["--devices", "2", "--tenants", "12", "--rounds",
                          "8", "--ckpt-dir", str(tmp_path / "ck"),
                          "--ckpt-every", "4", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rec
    assert rec["bit_equal"] and rec["sharded"]
    assert rec["tenant_axes"] == ["data"] and rec["devices"] == 2
    assert set(rec) == {"devices", "pods", "tenants", "rounds", "workload",
                        "tenant_axes", "sharded", "bit_equal", "rps_sharded",
                        "rps_single"}


def test_new_modules_load_no_jax_no_reference_no_msgpack():
    code = ("import sys\n"
            "import repro_torch.ckpt.checkpoint, repro_torch.sharding, "
            "repro_torch.launch.hostdev, repro_torch.launch.mesh, "
            "repro_torch.launch.train, repro_torch.router.fleet, "
            "repro_torch.models.moe\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod._main(["--devices", "2", "--tenants", "4", "--rounds", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.fleet_smoke(1, 4, 2)


# ===================================================================== MoE
EP_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax
from repro.configs.base import get_config
from repro.models import moe as moe_mod
from repro.models.layers import init_from_schema
from repro.sharding import use_mesh

cfg0 = get_config("olmoe-1b-7b").reduced()
key = jax.random.PRNGKey(0)
p = init_from_schema(moe_mod.moe_schema(cfg0), key, "float32")
x = jax.random.normal(jax.random.fold_in(key, 1), (4, 8, cfg0.d_model))
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {k: np.asarray(v) for k, v in p.items()}
out["x"] = np.asarray(x)
for tag, cf in (("cf64", 64.0), ("cfg", None)):
    cfg = cfg0 if cf is None else dataclasses.replace(cfg0, capacity_factor=cf)
    y, aux = moe_mod.apply_moe(cfg, p, x)
    with use_mesh(mesh):
        y_ep, aux_ep = jax.jit(lambda p, x: moe_mod.apply_moe_ep(
            cfg, p, x, mesh=mesh, batch_axes=("data",)))(p, x)
    out["y_" + tag], out["aux_" + tag] = np.asarray(y), np.asarray(aux)
    out["y_ep_" + tag] = np.asarray(y_ep)
    out["aux_ep_" + tag] = np.asarray(aux_ep)
np.savez(sys.argv[1], ndev=jax.device_count(), **out)
"""


@pytest.fixture(scope="module")
def ep_reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ep") / "ep.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", EP_REF, path], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    data = dict(np.load(path))
    assert int(data["ndev"]) == 4
    return path, data


def test_moe_expert_parallel_on_two_by_two_ranks(ep_reference):
    path, ref = ep_reference
    cfg = get_config("olmoe-1b-7b").reduced()
    assert cfg.capacity_factor < 64
    runs = spawn_local(4, _torch_dist.moe_ep_run, path, (2, 2),
                       (64.0, cfg.capacity_factor), timeout=90)
    p = {k: torch.from_numpy(ref[k]) for k in _torch_dist.MOE_KEYS}
    with torch.no_grad():
        y_port, _ = moe.apply_moe(dataclasses.replace(cfg,
                                                      capacity_factor=64.0),
                                  p, torch.from_numpy(ref["x"]))
    for (y64, aux64, y64a, aux64a), (yc, auxc, yca, auxca) in runs:
        # no drop: the one-device function, in both packages
        np.testing.assert_allclose(y64, y_port.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(y64, ref["y_cf64"], atol=1e-5, rtol=0)
        # the reference's EP function, dropping at the config's capacity
        np.testing.assert_allclose(y64, ref["y_ep_cf64"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(yc, ref["y_ep_cfg"], atol=1e-5, rtol=0)
        assert abs(aux64 - float(ref["aux_ep_cf64"])) <= 1e-6
        assert abs(auxc - float(ref["aux_ep_cfg"])) <= 1e-6
        assert np.array_equal(y64, y64a) and aux64 == aux64a   # auto = EP
        assert np.array_equal(yc, yca) and auxc == auxca
    assert not np.allclose(ref["y_ep_cfg"], ref["y_cf64"], atol=1e-5)


def _routes(package, monkeypatch, cfg, mesh):
    """Which function `apply_moe_auto` calls under ``mesh``, and the batch
    axes it passes."""
    calls = []
    monkeypatch.setattr(package, "apply_moe_ep", lambda cfg, p, x, **kw:
                        calls.append(("ep", tuple(kw["batch_axes"]))))
    monkeypatch.setattr(package, "apply_moe", lambda cfg, p, x, **kw:
                        calls.append(("plain", None)))
    package.apply_moe_auto(cfg, {}, None)
    return calls


@pytest.mark.parametrize("shape,names", [
    (None, None), ((2, 16), ("data", "model")), ((2, 3), ("data", "model")),
    ((4,), ("data",)), ((2, 2, 4), ("pod", "data", "model")),
    ((1, 1), ("data", "model"))])
@pytest.mark.parametrize("fsdp_dim", ["d_ff", "d_model"])
def test_apply_moe_auto_routes_as_the_reference(monkeypatch, shape, names,
                                                fsdp_dim):
    jcfg = dataclasses.replace(jget_config("olmoe-1b-7b"),
                               moe_fsdp_dim=fsdp_dim)
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), moe_fsdp_dim=fsdp_dim)
    fake = None if shape is None else FakeMesh(dict(zip(names, shape)))
    monkeypatch.setattr(jsharding._CTX, "mesh", fake, raising=False)
    want = _routes(jmoe, monkeypatch, jcfg, fake)
    pm = None if shape is None else _mesh(shape, names)
    with sharding.use_mesh(pm):
        got = _routes(moe, monkeypatch, cfg, pm)
    assert got == want


def test_moe_ep_on_one_rank_trains():
    """On the 1 × 1 mesh (`launch.train --mesh cpu`) the EP path needs no
    process group and carries gradients."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              capacity_factor=64.0)
    gen = torch.Generator().manual_seed(0)
    p = {k: (torch.randn(s.shape, generator=gen) * 0.02).requires_grad_()
         for k, s in moe.moe_schema(cfg).items()}
    x = torch.randn(2, 8, cfg.d_model, generator=gen)
    mesh = mesh_mod.make_cpu_mesh()
    y, aux = moe.apply_moe_ep(cfg, p, x, mesh=mesh, batch_axes=("data",))
    y_ref, aux_ref = moe.apply_moe(cfg, p, x)
    torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=0)
    (y.sum() + aux).backward()
    assert all(v.grad is not None and v.grad.abs().sum() > 0
               for v in p.values())
    with pytest.raises(ValueError, match="split over"):
        moe.apply_moe_ep(cfg, p, x, mesh=_mesh((1, 3), ("data", "model")),
                         batch_axes=("data",))
