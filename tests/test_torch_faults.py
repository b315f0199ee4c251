"""The port's fault layer (`repro_torch.serving.faults`, and the scheduler's
health machine) against the JAX package, on the CPU.

* `FaultPlan.draw` is bit-equal to the reference's over a grid of (seed,
  replica, rid, attempt): every verdict field, with scalar and per-replica
  ``fail_prob``, spikes, crashes and a ``rid_window``.
* On the same injected schedule the port's `ReplicaRunner` walks the same
  health machine as JAX's: the same `health_log` (tick and state), the
  same failure / retry / rejection / crash / quarantine counters, the same
  completions in the same order (ok, error, attempts, tokens), under greedy
  decoding (`tests/_torch_serving.py`) over the same weights.
* Crash containment: an `EngineCrash` raised by the engine is contained
  (slots rebuilt, requests requeued), as the reference contains any
  exception; any other exception raised in a tick propagates out of
  `step` and `drain`, and the sequential service path does the same.
"""
import re

import numpy as np
import pytest
import torch

from repro.serving import faults as jfaults
from repro.serving import scheduler as jsched
from repro_torch.serving import faults, scheduler

import _torch_serving as ts

torch.set_num_threads(1)


def _fields(d):
    return (d.fails, d.crash, d.fail_tick, d.spike)


@pytest.mark.parametrize("kw", [
    dict(fault_seed=5, fail_prob=0.5, spike_prob=0.3),
    dict(fault_seed=0, fail_prob=0.2, crash_on_decode=True, fail_tick_max=4),
    dict(fault_seed=123456, fail_prob=[1.0, 0.0, 0.35], spike_prob=0.5,
         spike_ticks=7, rid_window=(3, 11)),
    dict(fault_seed=2**31 - 1, fail_prob=0.0, spike_prob=0.0),
])
def test_fault_plan_draws_are_bit_equal(kw):
    want, got = jfaults.FaultPlan(**kw), faults.FaultPlan(**kw)
    assert got.enabled == want.enabled
    grid = [(r, i, a) for r in range(3) for i in range(14) for a in (1, 2, 3)]
    assert [_fields(got.draw(*g)) for g in grid] == \
        [_fields(want.draw(*g)) for g in grid]
    for r in range(3):
        assert got.fail_prob(r) == want.fail_prob(r)


def test_fault_plan_defaults_are_the_reference_defaults():
    assert faults.HealthPolicy() == faults.HealthPolicy(
        **vars(jfaults.HealthPolicy()))
    assert _fields(faults.NO_FAULT) == _fields(jfaults.NO_FAULT)
    assert [h.value for h in faults.Health] == \
        [h.value for h in jfaults.Health]


@pytest.fixture(scope="module")
def engines():
    return ts.engines(0)


def _summary(runner, comps):
    # a crash's message names the request's process-wide id, which depends
    # on how many requests the process made before: compare it without
    return ([(t, s.value) for t, s in runner.health_log],
            (runner.n_failures, runner.n_retries, runner.n_rejected,
             runner.n_crashes, runner.n_quarantines, runner.tick),
            [(c.ok, c.error and re.sub(r"rid \d+, ", "", c.error),
              c.attempts, c.result.tokens.tolist(),
              np.asarray(c.result.out_lens).tolist()) for c in comps])


def _both(engines, mk_plan, mk_health, batches, **kw):
    """Run both schedulers over the same batches of requests, each batch
    drained before the next is submitted; return each side's summary."""
    out = []
    for mod, fmod, eng in ((jsched, jfaults, engines[0]),
                           (scheduler, faults, engines[1])):
        runner = mod.ReplicaRunner(eng, replica_ix=0,
                                   fault_plan=mk_plan(fmod),
                                   health=mk_health(fmod), **kw)
        comps = []
        sched = mod.ContinuousScheduler([runner], on_complete=comps.append)
        for n, seed0 in batches:
            for r in ts.requests(mod, n, seed0=seed0):
                sched.submit(r)
            sched.drain()
        out.append(_summary(runner, comps))
    return out


def test_quarantine_cycle_matches_the_reference(engines):
    """An outage over submissions 0-2: healthy -> degraded -> quarantined
    (the queued request purged), then probes walk probation -> healthy."""
    want, got = _both(
        engines,
        lambda f: f.FaultPlan(fault_seed=0, fail_prob=1.0, fail_tick_max=0,
                              rid_window=(0, 3)),
        lambda f: f.HealthPolicy(max_retries=0, degrade_after=1,
                                 quarantine_after=2, probation_ticks=3,
                                 readmit_successes=2),
        [(3, 0), (3, 100)], n_slots=2, chunk=3)
    assert got == want
    assert [s for _, s in got[0]] == ["degraded", "quarantined", "probation",
                                      "healthy"]


def test_heavy_faults_match_the_reference(engines):
    """Failures at p 0.6, decode crashes, latency spikes and deadlines:
    the same completions, health log and counters."""
    want, got = _both(
        engines,
        lambda f: f.FaultPlan(fault_seed=11, fail_prob=0.6,
                              crash_on_decode=True, spike_prob=0.3,
                              spike_ticks=3),
        lambda f: f.HealthPolicy(max_retries=2, timeout_ticks=40,
                                 quarantine_after=4, probation_ticks=4),
        [(6, 0)], n_slots=4, chunk=3)
    assert got == want
    assert got[1][3] > 0, "no crash was injected"


class _Failing:
    """An engine whose decode raises ``exc`` on its first call."""

    def __init__(self, eng, exc):
        self._eng, self._exc = eng, exc
        self.device, self.eos_id = eng.device, eng.eos_id

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def decode_chunk(self, state, steps):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
        return self._eng.decode_chunk(state, steps)


def test_engine_crash_is_contained_and_requeued(engines):
    eng = _Failing(engines[1], faults.EngineCrash("provider down"))
    reqs = ts.requests(scheduler, 2)
    runner, sched, got = ts.drain(scheduler, eng, reqs)
    assert runner.n_crashes == 1 and runner.n_failures == 1
    assert all(c.ok and c.attempts == 2 for c in got)
    for c in got:
        want = engines[1].generate(c.request.prompts, c.request.max_new,
                                   seed=c.request.seed)
        np.testing.assert_array_equal(c.result.tokens, want.tokens)


@pytest.mark.parametrize("exc", [RuntimeError("CUDA error: an illegal "
                                              "memory access"),
                                 ValueError("bad shape")])
def test_other_engine_errors_propagate(engines, exc):
    """Not contained: the port rebuilds slots only for an EngineCrash."""
    eng = _Failing(engines[1], exc)
    runner = scheduler.ReplicaRunner(eng, n_slots=4, chunk=3)
    for r in ts.requests(scheduler, 2):
        runner.submit(r)
    with pytest.raises(type(exc), match=str(exc)[:8]):
        runner.step()
    assert runner.n_crashes == 0 and runner.n_failures == 0
    eng._exc = exc
    sched = scheduler.ContinuousScheduler([runner])
    with pytest.raises(type(exc)):
        sched.drain()
