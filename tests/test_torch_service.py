"""The port's end-to-end service (`repro_torch.router.service`) against
the JAX package, on the CPU.

* Within the port: sequential and continuous dispatch give the same round
  logs (action, observed, rewards, cost) and the same bandit state, bit
  for bit, for SUC and for the AWC cascade (which must cascade).
* Against JAX's `MultiLLMService`, over the same weights under greedy
  decoding (`tests/_torch_serving.py`), continuous and sequential: after
  both local servers are primed with the same records (every arm twice;
  at t = 1 every arm ties and the reference's CPU lowering and the port's
  wide one pick different optima of the degenerate LP), the round logs
  agree: the same actions, observed arms and failures, rewards within
  1e-6, costs within 1e-9 relative.
* The fault layer at the service: a quarantined arm invalidates the cached
  async-batch mask (`batch_size` 4) and is masked from selection; the same
  schedule gives the reference's logs; a disabled plan is bit-dormant.
* The round protocol: `RoundStateError` for misuse, and a submit that
  raises leaves no request in flight. The sequential path counts an
  `EngineCrash` as a failed observation and lets other errors propagate.
"""
import numpy as np
import pytest
import torch

from repro.core.policies import PolicyConfig as JPolicyConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.router import cloud as jcloud
from repro.router import service as jservice
from repro.serving import faults as jfaults
from repro_torch.core.policies import PolicyConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.router import cloud, service
from repro_torch.serving import faults

import _torch_serving as ts

torch.set_num_threads(1)
K = 3


@pytest.fixture(scope="module")
def pools():
    return ts.pools(K)


@pytest.fixture(scope="module")
def sampled_pool():
    eng = ts.engines(3, temperature=0.7)[1]
    return [cloud.Replica(f"m{i}", eng, 0.001 * (1 + i)) for i in range(K)]


def _pcfg(mod, kind, **kw):
    kw = {"rho": 1e9, "delta": 0.1, **kw}
    return mod(kind=kind, k=K, n=2, **kw)


def _port(pool, kind, **kw):
    pcfg = _pcfg(PolicyConfig, kind, **kw.pop("policy", {}))
    data = SyntheticLM(DataConfig(vocab=ts.VOCAB, seq_len=8, global_batch=2,
                                  seed=0))
    return service.MultiLLMService(
        pcfg, cloud.SchedulingCloud(pcfg, pool, device="cpu"), data,
        prompt_len=8, max_new=8, seed=7, **kw)


def _jax(pool, kind, **kw):
    pcfg = _pcfg(JPolicyConfig, kind, **kw.pop("policy", {}))
    data = JSyntheticLM(JDataConfig(vocab=ts.VOCAB, seq_len=8,
                                    global_batch=2, seed=0))
    return jservice.MultiLLMService(
        pcfg, jcloud.SchedulingCloud(pcfg, pool), data, prompt_len=8,
        max_new=8, seed=7, **kw)


def _same_logs(a, b, exact=True):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.action, y.action)
        np.testing.assert_array_equal(x.observed, y.observed)
        np.testing.assert_array_equal(x.failed, y.failed)
        if exact:
            np.testing.assert_array_equal(x.rewards, y.rewards)
            assert x.cost == y.cost
        else:
            np.testing.assert_allclose(x.rewards, y.rewards, atol=1e-6)
            assert x.cost == pytest.approx(y.cost, rel=1e-9)


@pytest.mark.parametrize("kind", ["suc", "awc"])
def test_sequential_equals_continuous_bitwise(kind, sampled_pool):
    seq = _port(sampled_pool, kind, dispatch="sequential")
    con = _port(sampled_pool, kind, dispatch="continuous")
    assert con.dispatch == "continuous" and _port(sampled_pool, kind) \
        .dispatch == "continuous"       # "auto": slot engines
    _same_logs(seq.run(4), con.run(4))
    for name in ("mu_hat", "c_hat", "t_mu", "t_c"):
        np.testing.assert_array_equal(getattr(seq.local, name),
                                      getattr(con.local, name))
    if kind == "awc":
        assert any(h.observed.sum() > 1 for h in seq.history)


def _prime(*services):
    rng = np.random.default_rng(11)
    for arm in np.tile(np.arange(K), 2):
        reward = float(rng.uniform(0.05, 0.95))
        cost = float(rng.uniform(0.01, 0.05))
        for svc in services:
            svc.local.record(int(arm), reward, cost)


@pytest.mark.parametrize("kind", ["suc", "awc"])
@pytest.mark.parametrize("dispatch", ["continuous", "sequential"])
def test_round_logs_match_the_reference(kind, dispatch, pools):
    policy = {"rho": 0.05, "alpha_mu": 0.1, "alpha_c": 0.01}
    want = _jax(pools[0], kind, dispatch=dispatch, policy=dict(policy))
    got = _port(pools[1], kind, dispatch=dispatch, policy=dict(policy))
    _prime(want, got)
    _same_logs(got.run(5), want.run(5), exact=False)
    np.testing.assert_allclose(got.local.mu_hat, np.asarray(want.local.mu_hat),
                               atol=1e-6)
    assert got.local.t == want.local.t


def _chaos(mod, fmod, pool, **kw):
    plan = fmod.FaultPlan(fault_seed=0, fail_prob=[1.0, 0.0, 0.0],
                          fail_tick_max=0, rid_window=(0, 10**9))
    hp = fmod.HealthPolicy(max_retries=0, quarantine_after=1,
                           probation_ticks=10**6)
    return mod(pool, "suc", dispatch="continuous", batch_size=4,
               fault_plan=plan, health=hp, **kw)


def test_availability_change_invalidates_cached_mask(pools):
    """A quarantine mid-batch must drop the cached action: no later round
    routes to the dead arm; the reference's logs, round for round."""
    policy = {"alpha_mu": 0.1, "alpha_c": 0.01}
    got = _chaos(_port, faults, pools[1], policy=dict(policy))
    want = _chaos(_jax, jfaults, pools[0], policy=dict(policy))
    _prime(got, want)
    logs = got.run(6)
    _same_logs(logs, want.run(6), exact=False)
    first_q = next(i for i, log in enumerate(logs) if log.failed[0])
    # a later round of the same batch of 4 would have reused the mask
    assert first_q < 5 and first_q % 4 < 3, first_q
    for log in logs[first_q + 1:]:
        assert not log.action[0], "cached mask kept routing to a dead arm"
    assert not got.sched.availability()[0]


def test_disabled_fault_plan_is_bit_dormant(sampled_pool):
    ref = _port(sampled_pool, "awc", dispatch="continuous")
    off = _port(sampled_pool, "awc", dispatch="continuous",
                fault_plan=faults.FaultPlan(fault_seed=123, fail_prob=0.0),
                health=faults.HealthPolicy())
    _same_logs(ref.run(3), off.run(3))


def test_round_state_errors(sampled_pool):
    svc = _port(sampled_pool, "suc", dispatch="continuous")
    svc.begin_round()
    with pytest.raises(service.RoundStateError, match="not finished"):
        svc.begin_round()
    with pytest.raises(service.RoundStateError, match="in flight"):
        svc.finish_round()
    svc.sched.drain()
    svc.finish_round()
    with pytest.raises(service.RoundStateError, match="no round"):
        svc.finish_round()
    with pytest.raises(service.RoundStateError, match="outside a round"):
        svc._on_complete(None)
    # a submit that raises (2 rows, 1 slot) leaves nothing in flight
    small = _port(sampled_pool, "suc", dispatch="continuous",
                  scheduler=svc.cloud.make_scheduler(n_slots=1))
    with pytest.raises(ValueError, match="exceeds"):
        small.begin_round()
    assert small._cur.inflight == 0
    small.sched.drain()
    assert not small.finish_round().observed.any()


class _Raising:
    """A replica engine whose `generate` raises ``exc``."""

    def __init__(self, exc):
        self.exc = exc

    def generate(self, prompts, max_new, seed=0):
        raise self.exc


def test_sequential_dispatch_contains_engine_crash_only(sampled_pool):
    plan = faults.FaultPlan(fault_seed=4, fail_prob=1e-9)   # enabled, no draw
    crash = [cloud.Replica(f"m{i}", _Raising(faults.EngineCrash("down")),
                           0.001) for i in range(K)]
    svc = _port(crash, "awc", fault_plan=plan)
    assert svc.dispatch == "sequential"      # "auto": no slot engines
    log = svc.step()
    assert log.failed.sum() == log.observed.sum() == 2     # cascaded
    assert (log.rewards == 0).all() and log.cost > 0
    bug = [cloud.Replica(f"m{i}", _Raising(RuntimeError("kernel fault")),
                         0.001) for i in range(K)]
    with pytest.raises(RuntimeError, match="kernel fault"):
        _port(bug, "awc", fault_plan=plan).step()
