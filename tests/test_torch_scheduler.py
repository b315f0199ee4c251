"""The port's continuous-batching scheduler (`repro_torch.serving.
scheduler`) and `router.fleet.simulate_fleet_driven` against the JAX
package, on the CPU.

* Against JAX's `ContinuousScheduler`: the same requests (mixed batch
  sizes, prompt lengths and budgets, more rows than slots, so requests
  queue, bucket and reuse slots) through one runner each, under greedy
  decoding over the same weights (`tests/_torch_serving.py`): every
  completion token-equal, with equal `out_lens`, the same arrival order,
  the same drain length in ticks; logprobs within 1e-4 (float32 sums in
  another order, then divided by the token count).
* Within the port, at temperature 0.7: each request through the scheduler
  is `Engine.generate` on that request alone, bit for bit (tokens,
  `out_lens`, logprobs), as `tests/test_engine.py` pins for JAX; with
  mixed batch sizes, tokens and lengths exact. The runner's `tick_log`
  counts one prefill bucket per admitted group and ``chunk`` decode steps
  per tick with residents.
* `simulate_fleet_driven`: T = 0 gives empty trajectories and a fresh
  state; T = 2 carries the tenants' real key rows, bit-equal to a
  `FleetService` run with the same seed, and its last action as
  ``prev_mask``.
"""
import numpy as np
import pytest
import torch

from repro.serving import scheduler as jsched
from repro_torch.core.policies import PolicyConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.router import cloud, fleet
from repro_torch.router.service import FleetService
from repro_torch.serving import scheduler

import _torch_serving as ts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def greedy():
    return ts.engines(1)


@pytest.fixture(scope="module")
def sampled():
    return ts.engines(2, temperature=0.7)[1]


# (rows, prompt length, max_new) per request: two prompt lengths, budgets
# up to the slot buffer, 11 rows through 5 slots
MIXED = [(1, 6, 4), (3, 6, 10), (2, 9, 7), (1, 6, 12), (2, 9, 3), (2, 6, 8)]


def _mixed(module):
    rng = np.random.default_rng(5)
    return [module.Request(tenant=i % 2, arm=0,
                           prompts=rng.integers(1, ts.VOCAB, (b, s)),
                           max_new=mn, seed=40 + i)
            for i, (b, s, mn) in enumerate(MIXED)]


def test_completions_token_equal_to_the_reference(greedy):
    jrun, jsch, want = ts.drain(jsched, greedy[0], _mixed(jsched),
                                n_slots=5, chunk=4)
    run, sch, got = ts.drain(scheduler, greedy[1], _mixed(scheduler),
                             n_slots=5, chunk=4)
    assert len(got) == len(want) == len(MIXED)
    assert sch.last_drain_ticks == jsch.last_drain_ticks
    for c, w in zip(got, want):
        assert c.request.seed == w.request.seed and c.ok and w.ok
        np.testing.assert_array_equal(c.result.tokens,
                                      np.asarray(w.result.tokens))
        np.testing.assert_array_equal(c.result.out_lens,
                                      np.asarray(w.result.out_lens))
        np.testing.assert_allclose(c.result.logprobs,
                                   np.asarray(w.result.logprobs), atol=1e-4)
    assert sorted(run._free) == sorted(jrun._free) == list(range(5))


def test_continuous_equals_generate_bitwise(sampled):
    """5 requests of 2 rows through 4 slots (bucketing, queueing, slot
    reuse) == `Engine.generate` per request, bit for bit."""
    reqs = ts.requests(scheduler, 5, max_new=8)
    runner, sched, got = ts.drain(scheduler, sampled, reqs, n_slots=4,
                                  chunk=3)
    assert {c.request.rid for c in got} == {r.rid for r in reqs}
    for c in got:
        want = sampled.generate(c.request.prompts, c.request.max_new,
                                seed=c.request.seed)
        np.testing.assert_array_equal(c.result.tokens, want.tokens)
        np.testing.assert_array_equal(c.result.out_lens, want.out_lens)
        np.testing.assert_array_equal(c.result.logprobs, want.logprobs)
    assert sorted(runner._free) == list(range(4))
    assert not runner.resident and not runner.pending
    assert not runner.state.active.any()
    # two requests fit the 4 slots at once: one bucket of 4 rows on the
    # first tick, the rest as slots free; every decode is one chunk
    log = runner.tick_log
    assert (log[0].buckets, log[0].rows, log[0].occupied) == (1, 4, 4)
    assert sum(t.rows for t in log) == 10
    assert all(t.decode_steps in (0, 3) for t in log)
    assert all(t.tenants == frozenset({0}) for t in log if t.decode_steps)


def test_mixed_shapes_and_budgets_match_generate(sampled):
    """Buckets that stack requests of other sizes may move logits by an
    ulp (so logprobs only allclose), tokens and lengths stay exact."""
    _, _, got = ts.drain(scheduler, sampled, _mixed(scheduler), n_slots=5,
                         chunk=4)
    for c in got:
        want = sampled.generate(c.request.prompts, c.request.max_new,
                                seed=c.request.seed)
        np.testing.assert_array_equal(c.result.tokens, want.tokens)
        np.testing.assert_array_equal(c.result.out_lens, want.out_lens)
        np.testing.assert_allclose(c.result.logprobs, want.logprobs,
                                   atol=1e-5)


def _driven_args(sampled):
    pcfgs = [PolicyConfig(kind=k, k=3, n=2, rho=1e9, delta=0.1)
             for k in ("suc", "awc")]
    pool = [cloud.Replica(f"m{i}", sampled, 0.001 * (1 + i))
            for i in range(3)]
    data = SyntheticLM(DataConfig(vocab=ts.VOCAB, seq_len=8, global_batch=2,
                                  seed=0))
    return pcfgs, cloud.SchedulingCloud(pcfgs[0], pool, device="cpu"), data


def test_driven_fleet_t0_returns_empty_result(sampled):
    res = fleet.simulate_fleet_driven(*_driven_args(sampled), T=0,
                                      prompt_len=8, max_new=8, seed=5)
    assert res.reward.shape == (2, 0) and res.cost.shape == (2, 0)
    assert res.action.shape == (2, 0, 3) and res.observed.shape == (2, 0, 3)
    assert res.state.prev_mask.shape == (2, 3)
    assert not res.state.prev_mask.any() and not res.state.t.any()


def test_driven_fleet_carries_real_key_rows(sampled):
    res = fleet.simulate_fleet_driven(*_driven_args(sampled), T=2,
                                      prompt_len=8, max_new=8, seed=7)
    assert res.state.key.any(), "all-zero key rows"
    fs = FleetService(*_driven_args(sampled), seed=7, prompt_len=8,
                      max_new=8)
    logs = fs.run(2)
    want = torch.cat([s.local.state.key for s in fs.tenants])
    assert torch.equal(res.state.key, want)
    assert torch.equal(res.state.prev_mask,
                       torch.as_tensor(res.action[:, -1], dtype=torch.float32))
    assert res.state.t.tolist() == [2.0, 2.0]
    for i, log in enumerate(logs[-1]):
        np.testing.assert_array_equal(res.action[i, -1], log.action)
        assert res.cost[i, -1] == log.cost
    assert np.isfinite(res.reward).all() and (res.cost > 0).all()
