"""The port's fleet loop (`repro_torch.router.fleet`, `core.bandit`) against
the JAX package, on the CPU; plus the port's device and import contract.

Per decision, on identical (stats, t, key) rows — the corpus of
`tests/test_fleet.py::test_fleet_act_matches_legacy_policy_per_decision` —
`_tenant_act` picks the same mask as the JAX wide lowering run op by op
(see `test_torch_relax.py` for why op by op). Whole trajectories are held on
their curves, not bit for bit: −log in the cost draws and XLA's contracted
multiply-adds drift the statistics by ulps, which flips near-ties.

  * round-1 actions: equal on every tenant;
  * SUC/AIC tenants against the JAX wide lowering (compiled): per-kind mean
    reward within 0.01 and final violation within 0.03;
  * AWC tenants against the JAX default CPU lowering (the grid engine's
    probe-optimal path, decision-equivalent to the wide one): the same
    tolerances. The compiled wide lowering returns over-budget AWC vertices
    on the CPU (ROADMAP.md, Queue 3), so it cannot anchor AWC curves.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandit as jbandit
from repro.core import metrics as jmetrics
from repro.core import policies as jpolicies
from repro.core.policies import PolicyConfig as JPolicyConfig
from repro.env.llm_profiles import default_rho, paper_pool as jpaper_pool
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.router import fleet as jfleet
from repro_torch import convert, prng
from repro_torch.core import (bandit, confidence, metrics, partition,
                               policies, relax)
from repro_torch.core.policies import PolicyConfig
from repro_torch.env.llm_profiles import paper_pool
from repro_torch.router import cloud, fleet, local_server
from repro_torch.configs.base import get_config
from repro_torch.models import model as model_mod
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
T = 32
REWARD_TOL, VIOLATION_TOL = 0.01, 0.03


@pytest.fixture
def wide(monkeypatch):
    """Force the JAX wide lowering through `repro.kernels.ref`'s kernels.
    Jitted traces made under the switch must not leak into later tests of
    this worker (or the reverse), so the jit caches are cleared around it."""
    monkeypatch.setenv("REPRO_TOPN_LP_PALLAS", "1")
    monkeypatch.setenv("REPRO_AWC_FW_PALLAS", "1")
    monkeypatch.setattr(jops, "topn_lp", jref.topn_lp)
    monkeypatch.setattr(jops, "awc_fw", jref.awc_fw)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _corpus(pool, n_trials=150):
    """The reference's per-decision corpus (seed 11, key PRNGKey(trial))."""
    rng = np.random.default_rng(11)
    rows = {k: [] for k in ("mu_hat", "c_hat", "t_mu", "t_c")}
    ts, keys = [], []
    for trial in range(n_trials):
        t_mu = rng.integers(0, 30, pool.k).astype(np.float32)
        rows["mu_hat"].append(rng.uniform(0, 1, pool.k) * (t_mu > 0))
        rows["c_hat"].append(rng.uniform(0, 0.6, pool.k) * (t_mu > 0))
        rows["t_mu"].append(t_mu)
        rows["t_c"].append(t_mu)
        ts.append(float(rng.integers(1, 200)))
        keys.append(np.asarray(jax.random.PRNGKey(trial)))
    stats = {k: np.asarray(v, np.float32) for k, v in rows.items()}
    return stats, np.asarray(ts, np.float32), np.stack(keys)


@pytest.fixture(scope="module")
def decisions():
    """The corpus once per kind, solved in one batch by both packages:
    (kind per row, reference masks, port masks). The reference runs op by
    op under the forced wide lowering, jit caches cleared around it."""
    pool = jpaper_pool("sciq")
    stats, ts, keys = _corpus(pool)
    m = len(ts)
    kinds = ("awc", "suc", "aic")
    pcfgs = [JPolicyConfig(kind=kind, k=pool.k, n=4,
                           rho=default_rho(pool, kind, 4), delta=1 / 60)
             for kind in kinds for _ in range(m)]
    fcfg = jfleet.fleet_config(pcfgs)
    stats = {k: np.concatenate([v] * 3) for k, v in stats.items()}
    ts, keys = np.concatenate([ts] * 3), np.concatenate([keys] * 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TOPN_LP_PALLAS", "1")
        mp.setenv("REPRO_AWC_FW_PALLAS", "1")
        mp.setattr(jops, "topn_lp", jref.topn_lp)
        mp.setattr(jops, "awc_fw", jref.awc_fw)
        jax.clear_caches()
        try:
            with jax.disable_jit():
                want = np.asarray(jax.vmap(
                    lambda s, t, k, c: jfleet._tenant_act(s, t, k, c,
                                                          (0, 1, 2)))(
                        {k: jnp.asarray(v) for k, v in stats.items()},
                        jnp.asarray(ts), jnp.asarray(keys), fcfg))
        finally:
            jax.clear_caches()
    got = fleet._tenant_act({k: torch.tensor(v) for k, v in stats.items()},
                            torch.tensor(ts), convert.key_rows(keys, "cpu"),
                            convert.fleet_config(fcfg, "cpu")).numpy()
    return np.repeat(np.asarray(kinds), m), want, got


@pytest.mark.parametrize("kind", ["awc", "suc", "aic"])
def test_tenant_act_matches_wide_lowering_per_decision(decisions, kind):
    kind_of, want, got = decisions
    rows = kind_of == kind
    bad = np.nonzero((want[rows] != got[rows]).any(-1))[0]
    assert bad.size == 0, bad


@pytest.mark.parametrize("kind", ["awc", "suc", "aic"])
def test_c2mabv_per_seed_policy_matches_per_decision(decisions, kind):
    """`policies.c2mabv` (the per-seed path of `bandit.simulate`) on the
    same corpus picks the fixture's masks on every row. The reference's
    per-seed policy and its fleet `_tenant_act` run the same solve under
    the wide lowering, and differ in the rounding's loop and the
    padding's static or per-row matroid flag; that is checked op by op on
    the first SUC rows (a run op by op costs seconds whatever the row
    count, ~15 s for AWC's Frank-Wolfe)."""
    kind_of, want, _ = decisions
    rows = kind_of == kind
    pool = jpaper_pool("sciq")
    stats, ts, keys = _corpus(pool)
    jpc = JPolicyConfig(kind=kind, k=pool.k, n=4,
                        rho=default_rho(pool, kind, 4), delta=1 / 60)
    got = policies.make_policy("c2mabv", convert.policy_config(jpc),
                               device="cpu")(
        {k: torch.tensor(v) for k, v in stats.items()},
        convert.key_rows(keys, "cpu"), torch.tensor(ts)).numpy()
    bad = np.nonzero((want[rows] != got).any(-1))[0]
    assert bad.size == 0, bad
    if kind != "suc":
        return
    head = 4
    act = jpolicies.make_policy("c2mabv", jpc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TOPN_LP_PALLAS", "1")
        mp.setenv("REPRO_AWC_FW_PALLAS", "1")
        mp.setattr(jops, "topn_lp", jref.topn_lp)
        mp.setattr(jops, "awc_fw", jref.awc_fw)
        jax.clear_caches()
        try:
            with jax.disable_jit():
                ref = np.asarray(jax.vmap(act)(
                    {k: jnp.asarray(v[:head]) for k, v in stats.items()},
                    jnp.asarray(keys[:head]), jnp.asarray(ts[:head])))
        finally:
            jax.clear_caches()
    assert np.array_equal(ref, want[rows][:head])


def _mixed_policies(pool):
    return [JPolicyConfig(kind=kind, k=pool.k, n=n,
                          rho=default_rho(pool, kind, n), delta=1 / T)
            for kind in ("awc", "suc", "aic") for n in (3, 4)]


def _per_kind(reward, cost, kinds, pcfgs):
    out = {}
    for kind in sorted(set(kinds)):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        rho = np.asarray([pcfgs[i].rho for i in idx])[:, None]
        vio = np.maximum(np.cumsum(cost[idx], 1)
                         / np.arange(1, cost.shape[1] + 1) - rho, 0)[:, -1]
        out[kind] = (float(reward[idx].mean()), float(vio.mean()))
    return out


def _assert_curves(port, ref, kinds_):
    for kind in kinds_:
        (r_p, v_p), (r_r, v_r) = port[kind], ref[kind]
        assert abs(r_p - r_r) <= REWARD_TOL, (kind, r_p, r_r)
        assert abs(v_p - v_r) <= VIOLATION_TOL, (kind, v_p, v_r)


def test_simulate_fleet_tracks_the_reference(wide, monkeypatch):
    pool = jpaper_pool("sciq")
    pcfgs = _mixed_policies(pool)
    kinds = [p.kind for p in pcfgs]
    jcfg = jfleet.fleet_config(pcfgs)
    ref_wide = jfleet.simulate_fleet(pool, jcfg, T=T, seed=0)
    port = fleet.simulate_fleet(paper_pool("sciq"),
                                convert.fleet_config(jcfg, "cpu"), T=T,
                                seed=0, device="cpu")
    assert np.array_equal(port.action[:, 0], ref_wide.action[:, 0])
    _assert_curves(_per_kind(port.reward, port.cost, kinds, pcfgs),
                   _per_kind(ref_wide.reward, ref_wide.cost, kinds, pcfgs),
                   ("suc", "aic"))
    monkeypatch.setenv("REPRO_TOPN_LP_PALLAS", "0")
    monkeypatch.setenv("REPRO_AWC_FW_PALLAS", "0")
    jax.clear_caches()
    ref_cpu = jfleet.simulate_fleet(pool, jcfg, T=T, seed=0)
    _assert_curves(_per_kind(port.reward, port.cost, kinds, pcfgs),
                   _per_kind(ref_cpu.reward, ref_cpu.cost, kinds, pcfgs),
                   ("awc",))
    # per-tenant matroid invariants and F_t ⊆ S_t
    sizes = port.action.sum(-1)
    for i, p in enumerate(pcfgs):
        if p.kind == "awc":
            assert (sizes[i] <= p.n).all()
        else:
            assert (sizes[i] == p.n).all()
    assert (port.observed <= port.action).all()
    assert np.isfinite(port.reward).all() and (port.cost >= 0).all()


@pytest.mark.parametrize("kind", ["suc", "awc"])
def test_bandit_simulate_c2mabv_tracks_the_reference(wide, monkeypatch, kind):
    """Seeds as tenants, keys split from PRNGKey(0) as in the reference."""
    pool = jpaper_pool("sciq")
    jpc = JPolicyConfig(kind=kind, k=pool.k, n=4,
                        rho=default_rho(pool, kind, 4), delta=1 / T)
    if kind == "awc":                  # the default lowering (module doc)
        monkeypatch.setenv("REPRO_TOPN_LP_PALLAS", "0")
        monkeypatch.setenv("REPRO_AWC_FW_PALLAS", "0")
        jax.clear_caches()
    ref = jbandit.simulate("c2mabv", pool, jpc, T=T, seeds=3)
    port = bandit.simulate("c2mabv", paper_pool("sciq"),
                           convert.policy_config(jpc), T=T, seeds=3,
                           device="cpu")
    assert port.action.shape == ref.action.shape
    assert np.array_equal(port.action[:, 0], ref.action[:, 0])
    _assert_curves(_per_kind(port.reward, port.cost, [kind] * 3, [jpc] * 3),
                   _per_kind(ref.reward, ref.cost, [kind] * 3, [jpc] * 3),
                   (kind,))
    r_opt = bandit.optimal_value(paper_pool("sciq"), convert.policy_config(jpc))
    s_p = metrics.summarize(port.reward, port.cost, jpc.rho, r_opt, 1.0)
    s_r = jmetrics.summarize(port.reward, port.cost, jpc.rho, r_opt, 1.0)
    assert s_p == s_r                  # the numpy copy of core.metrics


def test_sync_every_holds_the_action():
    pool = paper_pool("sciq")
    pcfgs = [PolicyConfig(kind=k, k=pool.k, n=4, rho=0.5, delta=1 / T)
             for k in ("suc", "awc", "aic")]
    cfg = fleet.fleet_config(pcfgs, sync_every=[1, 3, 4], device="cpu")
    res = fleet.simulate_fleet(pool, cfg, T=12, device="cpu")
    for i, b in enumerate((1, 3, 4)):
        for t in range(1, 12):
            if t % b:
                assert (res.action[i, t] == res.action[i, t - 1]).all()


def test_convert_carries_state_and_keys():
    pool = jpaper_pool("sciq")
    jcfg = jfleet.fleet_config(_mixed_policies(pool), sync_every=[1, 2] * 3)
    cfg = convert.fleet_config(jcfg, "cpu")
    for name in jfleet.FleetConfig._fields:
        assert np.array_equal(np.asarray(getattr(jcfg, name)),
                              getattr(cfg, name).numpy()), name
    jst = jfleet.init_tenant_state(6, pool.k, seed=9)
    st = convert.tenant_state(jst, "cpu")
    assert np.array_equal(convert.key_rows_to_numpy(st.key),
                          np.asarray(jst.key))
    own = fleet.init_tenant_state(6, pool.k, seed=9, device="cpu")
    assert torch.equal(own.key, st.key)
    # a fleet continued from a converted state keeps its keys' stream
    res = fleet.simulate_fleet(paper_pool("sciq"), cfg, T=2, state=st,
                               device="cpu")
    res2 = fleet.simulate_fleet(paper_pool("sciq"), cfg, T=2, seed=9,
                                device="cpu")
    assert np.array_equal(res.action, res2.action)


# ====================================================== device contract
def test_entry_points_default_to_cuda_and_raise_without_it():
    """No hidden fallback: the default device is CUDA, and on a host
    without one the entry points raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    pool = paper_pool("sciq")
    pc = PolicyConfig(kind="suc", k=pool.k, n=4, rho=0.5)
    cpu_cfg = fleet.fleet_config([pc], device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.simulate_fleet(pool, cpu_cfg, T=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.fleet_config([pc])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bandit.simulate("c2mabv", pool, pc, T=1, seeds=1)
    for name in ("cucb", "thompson"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bandit.simulate(name, pool, pc, T=1, seeds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bandit.simulate("c2mabv", pool, pc, T=1, seeds=1, use_fleet=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        policies.make_policy("c2mabv_direct", pc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition.make_partition_policy("suc", pool.k, [0] * pool.k, [4],
                                        rho=0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_server.LocalServer(pc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        # select / select_batch round on the cloud's device
        cloud.SchedulingCloud(pc, [cloud.Replica(f"m{i}", None, 1e-3)
                                   for i in range(pool.k)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        relax.solve_relaxed("suc", pool.mu, pool.mean_cost, 4, 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prng.PRNGKey(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        confidence.init_stats_batch(2, pool.k)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.init_tenant_state(2, pool.k)
    cfg = get_config("starcoder2-7b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.init_decode_caches(cfg, 1, 8)
    params = model_mod.init_params(cfg, device="cpu")
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.forward(cfg, params, {"tokens": toks})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.prefill(cfg, params, {"tokens": toks}, 8)
    cache = model_mod.init_decode_caches(cfg, 1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.decode_step(cfg, params, toks[:, :1], cache, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax(cfg, {"embed": {}, "layers": {}, "lnf": {}})
    scfg = get_config("mamba2-780m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.init_params(scfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.init_decode_caches(scfg, 1, 8)
    sparams = model_mod.init_params(scfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.forward(scfg, sparams, {"tokens": toks})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.prefill(scfg, sparams, {"tokens": toks}, 8)
    scache = model_mod.init_decode_caches(scfg, 1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_mod.decode_step(scfg, sparams, toks[:, :1], scache, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(scfg, sparams)


# ===================================================== import hygiene
def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_sources_import_no_jax_and_no_reference():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "flax"), \
                    (path, name)


def test_port_loads_no_jax_and_no_reference_module():
    code = ("import sys\n"
            "import repro_torch, repro_torch.router.fleet, "
            "repro_torch.core.bandit, repro_torch.convert, "
            "repro_torch.core.policies, repro_torch.core.partition, "
            "repro_torch.router.local_server, repro_torch.router.cloud, "
            "repro_torch.env.llm_profiles, "
            "repro_torch.kernels.ops, repro_torch.serving.engine, "
            "repro_torch.models.model, repro_torch.configs.base, "
            "repro_torch.models.ssm, repro_torch.kernels.ssd_scan, "
            "repro_torch.router.service, repro_torch.serving.scheduler, "
            "repro_torch.serving.faults, repro_torch.data.pipeline, "
            "repro_torch.configs.shapes, repro_torch.train.optimizer, "
            "repro_torch.train.train_step, repro_torch.launch.serve\n"
            "from repro_torch.configs.base import list_archs\n"
            "list_archs()\n"
            "repro_torch.env.llm_profiles.zoo_pool()\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
