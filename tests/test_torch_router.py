"""The port's local-server / scheduling-cloud split (`repro_torch.router.
local_server`, `router.cloud`, `router.fleet.relaxed_batch`) and the zoo
pool against the JAX package, on the CPU.

* `LocalServer`: over a recorded sequence of rounds (every arm observed
  twice, then relaxed selection, an arm drawn from z̃ by a seeded numpy
  Generator, its reward and cost fed back), the port's z̃ stays within
  1e-5 of the reference's (its default CPU lowering, decision-equivalent
  to the port's wide one off degenerate LPs), and its statistics within
  an ulp (XLA contracts Eq. 6's multiply-add).
* `SchedulingCloud.select` (with and without ``available=``), `select_np`
  and `select_batch` give the reference's masks bit for bit;
  `realized_cost` and `dispatch` on the reduced StarCoder2 (JAX's weights)
  give its tokens, lengths and cost; `make_scheduler` builds one runner a
  replica, as the reference's does.
* `fleet.relaxed_batch` with each engine and step count is
  `relax.solve_batch` on the bounds; `zoo_pool` is the reference's pool.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.policies import PolicyConfig as JPolicyConfig
from repro.env import llm_profiles as jprof
from repro.models import model as JM
from repro.router import cloud as jcloud
from repro.router import fleet as jfleet
from repro.router import local_server as jls
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.core import confidence as cb
from repro_torch.core import relax
from repro_torch.env import llm_profiles
from repro_torch.router import cloud, fleet, local_server
from repro_torch.serving import engine

torch.set_num_threads(1)
ROUNDS = 12


def _pcfg(kind, n=4, **bounds):
    pool = jprof.paper_pool("sciq")
    jpc = JPolicyConfig(kind=kind, k=pool.k, n=n,
                        rho=jprof.default_rho(pool, kind, n), delta=1 / 64,
                        **bounds)
    return pool, jpc, convert.policy_config(jpc)


@pytest.mark.parametrize("kind", ["awc", "suc", "aic"])
def test_local_server_tracks_the_reference(kind):
    pool, jpc, pc = _pcfg(kind, alpha_mu=0.1, alpha_c=0.01)
    ref = jls.LocalServer(jpc)
    port = local_server.LocalServer(pc, device="cpu")
    rng = np.random.default_rng(3)
    # Every arm observed twice first, and narrow bounds: two arms whose μ̄
    # and c̲ both tie (at t = 1 all do; a clamped c̲ = 0 beside a capped μ̄
    # = 1 later) make the LP degenerate, and the reference's CPU lowering
    # then picks another of its optima than its wide lowering, which the
    # port follows.
    for arm in np.tile(np.arange(pool.k), 2):
        reward = float(rng.choice(pool.reward_levels))
        cost = float(pool.mean_cost[arm] * rng.uniform(0.5, 1.5))
        ref.record(int(arm), reward, cost)
        port.record(int(arm), reward, cost)
    for _ in range(ROUNDS):
        zj, zp = ref.relaxed_selection(), port.relaxed_selection()
        np.testing.assert_allclose(zp, np.asarray(zj), atol=1e-5, rtol=0)
        assert port.t == ref.t
        p = np.clip(np.asarray(zj, np.float64), 0, None) + 1e-3
        arm = int(rng.choice(pool.k, p=p / p.sum()))
        reward = float(rng.choice(pool.reward_levels))
        cost = float(pool.mean_cost[arm] * rng.uniform(0.5, 1.5))
        ref.record(arm, reward, cost)
        port.record(arm, reward, cost)
        for name in ("mu_hat", "c_hat", "t_mu", "t_c"):
            np.testing.assert_allclose(getattr(port, name),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1.2e-7, atol=0)
    assert [dataclasses.astuple(r) for r in port.log] == \
        [dataclasses.astuple(r) for r in ref.log]
    # a server continued from the reference's state solves as it does
    port.state = convert.tenant_state(ref.state, "cpu")
    np.testing.assert_allclose(port.relaxed_selection(),
                               np.asarray(ref.relaxed_selection()),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("engine_name, fw_steps",
                         [(None, None), ("bisect", None), ("grid", 4),
                          ("grid", 16), ("bisect", 4)])
def test_relaxed_batch_is_solve_batch_on_the_bounds(engine_name, fw_steps):
    pool = llm_profiles.paper_pool("sciq")
    jcfg = jfleet.fleet_config([_pcfg(k)[1] for k in ("awc", "suc", "aic")])
    cfg = convert.fleet_config(jcfg, "cpu")
    rng = np.random.default_rng(2)
    t_mu = rng.integers(0, 20, (3, pool.k)).astype(np.float32)
    stats = {"mu_hat": torch.tensor(rng.uniform(0, 1, (3, pool.k)) * (t_mu > 0),
                                    dtype=torch.float32),
             "c_hat": torch.tensor(rng.uniform(0, .6, (3, pool.k)) * (t_mu > 0),
                                   dtype=torch.float32),
             "t_mu": torch.tensor(t_mu), "t_c": torch.tensor(t_mu)}
    t = torch.full((3,), 21.0)
    z = fleet.relaxed_batch(stats, t, cfg, engine_name, fw_steps)
    mu_bar = cb.reward_ucb(stats, t, cfg.delta, cfg.alpha_mu)
    c_low = cb.cost_lcb(stats, t, cfg.delta, cfg.alpha_c)
    want = relax.solve_batch(cfg.kind_ix, mu_bar, c_low, cfg.n, cfg.rho,
                             engine=engine_name, fw_steps=fw_steps)
    assert torch.equal(z, want)
    assert torch.all((z >= 0) & (z <= 1))
    with pytest.raises(ValueError, match="unknown LP engine"):
        fleet.relaxed_batch(stats, t, cfg, "simplex")


def _clouds(kind, engines=None):
    pool, jpc, pc = _pcfg(kind)
    engines = engines or [(None, None)] * pool.k
    prices = np.linspace(1e-3, 9e-3, pool.k)
    jc = jcloud.SchedulingCloud(jpc, [jcloud.Replica(f"m{i}", je, p)
                                      for i, ((je, _), p)
                                      in enumerate(zip(engines, prices))])
    pc_ = cloud.SchedulingCloud(pc, [cloud.Replica(f"m{i}", te, p)
                                     for i, ((_, te), p)
                                     in enumerate(zip(engines, prices))],
                                device="cpu")
    return pool, jc, pc_


def _z_rows(seed, k, m=12):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0, 1, (m, k)).astype(np.float32)
    z[: m // 3] = np.round(z[: m // 3])
    z[: m // 3, :2] = rng.uniform(0, 1, (m // 3, 2))
    return z


@pytest.mark.parametrize("kind", ["awc", "suc", "aic"])
def test_cloud_selection_bit_equal(kind):
    pool, jc, pc = _clouds(kind)
    assert np.array_equal(jc.prices, pc.prices)
    zs = _z_rows(7, pool.k)
    avail = np.ones(pool.k, bool)
    avail[[2, 5]] = False
    for i, z in enumerate(zs):
        for available in (None, avail, np.ones(pool.k, bool)):
            want = jc.select(z, np.random.default_rng(i), available)
            got = pc.select(z, np.random.default_rng(i), available)
            assert np.array_equal(want, got), (i, available)
        want = jc.select_np(z, np.random.default_rng(100 + i))
        got = pc.select_np(z, np.random.default_rng(100 + i))
        assert np.array_equal(want, got), i
    jkeys = jax.random.split(jax.random.PRNGKey(4), len(zs))
    want = jc.select_batch(zs, jkeys)
    got = pc.select_batch(zs, convert.key_rows(np.asarray(jkeys), "cpu"))
    assert np.array_equal(want, got)
    assert np.array_equal(cloud._pad_to_n_np(zs[0] > 0.5, zs[0], 4),
                          jcloud._pad_to_n_np(zs[0] > 0.5, zs[0], 4))


def test_cloud_dispatch_and_cost_bit_equal():
    jcfg = jget_config("starcoder2-7b").reduced()
    cfg = get_config("starcoder2-7b").reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    je = jengine.Engine(jcfg, jparams, max_len=32)
    te = engine.Engine(cfg, params, max_len=32, device="cpu")
    pool, jc, pc = _clouds("suc", [(je, te)] * 9)
    prompts = np.random.default_rng(1).integers(
        2, cfg.vocab, (2, 8)).astype(np.int32)
    for arm in (0, 8):
        jout, jcost = jc.dispatch(arm, prompts, 6, seed=arm)
        out, cost = pc.dispatch(arm, prompts, 6, seed=arm)
        assert np.array_equal(out.tokens, np.asarray(jout.tokens))
        assert np.array_equal(out.out_lens, np.asarray(jout.out_lens))
        assert cost == jcost == pc.realized_cost(arm, prompts, out)
    sched = pc.make_scheduler(n_slots=3, chunk=2, tick_budget=7)
    jsched = jc.make_scheduler(n_slots=3, chunk=2, tick_budget=7)
    assert len(sched.runners) == len(jsched.runners) == pool.k
    assert sched.tick_budget == jsched.tick_budget == 7
    for i, (r, jr) in enumerate(zip(sched.runners, jsched.runners)):
        assert r.engine is te and r.replica_ix == jr.replica_ix == i
        assert (r.n_slots, r.chunk) == (jr.n_slots, jr.chunk) == (3, 2)
    with pytest.raises(ValueError, match="replicas"):
        cloud.SchedulingCloud(pc.pcfg, pc.replicas[:3], device="cpu")


def test_zoo_pool_is_the_reference_pool():
    for seed in (0, 3):
        a, b = jprof.zoo_pool(seed), llm_profiles.zoo_pool(seed)
        assert a.names == b.names and a.cost_scale == b.cost_scale
        assert np.array_equal(a.mu, b.mu)
        assert np.array_equal(a.mean_cost, b.mean_cost)
