"""The port's fleet loop with checkpoints (kill and resume) and with the
reference's other LP engine, on the CPU.

* Checkpoint / resume (`tests/test_fleet_sharded.py`'s one-device tests on
  the port): a run killed between checkpoints and resumed equals the
  uninterrupted run bit for bit; segmenting changes nothing; a resume at
  the last round plays none; a checkpoint past T raises.
* Across packages: a fleet checkpoint written by the JAX package's
  `ckpt.save` (the port's state in the reference's layout, uint32 keys)
  resumes in the port exactly as the port's own; the port's checkpoint of
  a JAX-run fleet's state restores in JAX bit for bit.
* ``engine="bisect"`` and ``fw_steps=`` through `simulate_fleet`: the
  decisions on the reference's per-decision corpus equal JAX's `_tenant_act`
  with the same engine on every row, the first round's actions are equal
  and each kind's curves lie within the fleet tests' tolerances of JAX's
  `simulate_fleet(engine=, fw_steps=)`.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.core.policies import PolicyConfig as JPolicyConfig
from repro.env.llm_profiles import default_rho, paper_pool as jpaper_pool
from repro.router import fleet as jfleet
from repro_torch import convert, prng
from repro_torch.ckpt import checkpoint
from repro_torch.env.llm_profiles import paper_pool
from repro_torch.router import fleet

from _torch_dist import mixed_policies
from test_torch_fleet import _assert_curves, _corpus, _mixed_policies, \
    _per_kind

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    return paper_pool("sciq")


def _run(pool, m, T, seed, plan_T=None, **kw):
    cfg = fleet.fleet_config(mixed_policies(pool, m, plan_T or T),
                             device="cpu")
    keys = prng.split(prng.PRNGKey(seed, device="cpu"), m)
    return fleet.simulate_fleet(pool, cfg, T=T, keys=keys, device="cpu",
                                **kw)


def assert_bit_equal(got, ref, t0=0):
    """The resumed-vs-reference discipline of the JAX tests: everything
    bit-equal (the port's reward is too: one program per row)."""
    for name in ("action", "observed", "cost", "reward"):
        assert np.array_equal(getattr(got, name),
                              getattr(ref, name)[:, t0:]), name
    for name in ref.state.stats:
        assert torch.equal(got.state.stats[name].cpu(),
                           ref.state.stats[name].cpu()), name
    for name in ("prev_mask", "t", "key"):
        assert torch.equal(getattr(got.state, name).cpu(),
                           getattr(ref.state, name).cpu()), name


# ================================================== checkpoint/resume (1 dev)
def test_kill_then_resume_bit_equal(pool, tmp_path):
    """A run killed at round 7 (checkpoint at 4) resumed to T=12 equals the
    uninterrupted no-checkpoint run bit for bit on rounds 5..12."""
    m, every, kill, total = 6, 4, 7, 12
    full = _run(pool, m, total, 3)
    d = str(tmp_path / "ck")
    part = _run(pool, m, kill, 3, plan_T=total, ckpt_dir=d, ckpt_every=every)
    assert checkpoint.latest_step(d) == 4      # 7 is not a multiple
    assert np.array_equal(part.action, full.action[:, :kill])
    res = _run(pool, m, total, 3, ckpt_dir=d, ckpt_every=every)
    assert res.t0 == 4 and res.action.shape[1] == total - 4
    assert_bit_equal(res, full, t0=4)
    assert checkpoint.latest_step(d) == 12
    assert (res.state.t == total).all()


def test_segmented_checkpointing_matches_plain_run(pool, tmp_path):
    """A checkpointed run with a ragged final segment equals the plain run,
    and its checkpoints hold the state the plain run had at those rounds."""
    m, total = 5, 11
    plain = _run(pool, m, total, 8)
    d = str(tmp_path / "ck")
    ck = _run(pool, m, total, 8, ckpt_dir=d, ckpt_every=4)
    assert_bit_equal(ck, plain)
    assert sorted(int(s) for s in os.listdir(d)) == [4, 8]
    at8 = _run(pool, m, 8, 8, plan_T=total)
    tree, step = checkpoint.restore(d, fleet._ckpt_tree(at8.state), step=8)
    assert step == 8
    want = fleet._ckpt_tree(at8.state)
    for name in want.stats:
        assert np.array_equal(tree.stats[name], want.stats[name])
    assert tree.key.dtype == np.uint32
    assert np.array_equal(tree.key, want.key)


def test_resume_at_completion_returns_zero_rounds(pool, tmp_path):
    m, total = 4, 8
    d = str(tmp_path / "ck")
    first = _run(pool, m, total, 1, ckpt_dir=d, ckpt_every=4)
    again = _run(pool, m, total, 1, ckpt_dir=d, ckpt_every=4)
    assert again.t0 == total and again.action.shape == (m, 0, pool.k)
    for name in first.state.stats:
        assert torch.equal(again.state.stats[name], first.state.stats[name])


def test_resume_past_T_raises(pool, tmp_path):
    d = str(tmp_path / "ck")
    _run(pool, 4, 8, 1, ckpt_dir=d, ckpt_every=4)
    with pytest.raises(ValueError, match="past T"):
        _run(pool, 4, 6, 1, plan_T=8, ckpt_dir=d, ckpt_every=4)


def test_state_keeps_further_rounds_and_refuses_a_resuming_dir(pool,
                                                               tmp_path):
    """``state=`` means T further rounds; with a resuming ``ckpt_dir`` it
    raises, and with ``resume=False`` its checkpoints carry the round
    counter."""
    m, total = 6, 10
    full = _run(pool, m, total, 4)
    head = _run(pool, m, 6, 4, plan_T=total)
    d = str(tmp_path / "ck")
    with pytest.raises(ValueError, match="further rounds"):
        _run(pool, m, 4, 4, plan_T=total, state=head.state, ckpt_dir=d)
    tail = _run(pool, m, 4, 4, plan_T=total, state=head.state, ckpt_dir=d,
                ckpt_every=4, resume=False)
    assert tail.t0 == 6
    assert np.array_equal(tail.action, full.action[:, 6:])
    assert checkpoint.latest_step(d) == 8


# ========================================================= across packages
def test_resume_from_a_jax_written_checkpoint(pool, tmp_path):
    """The port's state at round 4, written by the JAX package's
    `ckpt.save` (jax arrays, uint32 keys), resumes in the port: rounds
    5..12 equal the port's uninterrupted run bit for bit."""
    m, total = 6, 12
    full = _run(pool, m, total, 2)
    head = _run(pool, m, 4, 2, plan_T=total)
    st = fleet._ckpt_tree(head.state)
    jstate = jfleet.TenantState(
        stats={k: jnp.asarray(v) for k, v in st.stats.items()},
        prev_mask=jnp.asarray(st.prev_mask), t=jnp.asarray(st.t),
        key=jnp.asarray(st.key, jnp.uint32))
    d = str(tmp_path / "ck")
    jckpt.save(d, 4, jstate)
    res = _run(pool, m, total, 2, ckpt_dir=d, ckpt_every=4)
    assert res.t0 == 4
    assert_bit_equal(res, full, t0=4)


def test_port_checkpoint_of_a_jax_fleet_restores_in_jax(tmp_path):
    """A JAX fleet's state after 6 rounds, carried into the port
    (`convert.tenant_state`) and checkpointed by the port's fleet, restores
    in JAX's `ckpt.restore` against its own `init_tenant_state` bit for
    bit; and JAX's checkpoint of it restores in the port."""
    jpool = jpaper_pool("sciq")
    jcfg = jfleet.fleet_config(_mixed_policies(jpool))
    ref = jfleet.simulate_fleet(jpool, jcfg, T=6, seed=5)
    d = str(tmp_path / "port")
    fleet._checkpoint(d, 6, convert.tenant_state(ref.state, "cpu"), None,
                      None)
    like = jfleet.init_tenant_state(jcfg.m, jpool.k, seed=0)
    got, step = jckpt.restore(d, jax.tree.map(np.asarray, like))
    assert step == 6
    for name in ref.state.stats:
        assert np.array_equal(got.stats[name], ref.state.stats[name]), name
    for name in ("prev_mask", "t", "key"):
        assert np.array_equal(getattr(got, name), getattr(ref.state, name))
    assert got.key.dtype == np.uint32
    dj = str(tmp_path / "jax")
    jckpt.save(dj, 6, ref.state)
    for f in ("manifest.msgpack", "arrays.bin"):
        with open(os.path.join(d, "6", f), "rb") as a, \
                open(os.path.join(dj, "6", f), "rb") as b:
            assert a.read() == b.read(), f
    own = fleet.init_tenant_state(jcfg.m, jpool.k, seed=0, device="cpu")
    back, _ = fleet._restore_state(dj, own, 6, torch.device("cpu"))
    assert np.array_equal(convert.key_rows_to_numpy(back.key),
                          np.asarray(ref.state.key))
    shutil.rmtree(d)


# ======================================================== engine / fw_steps
@pytest.mark.parametrize("fw_steps", [None, 4])
def test_bisect_engine_decisions_match_the_reference(fw_steps):
    """``engine="bisect"`` (and ``fw_steps``) through `_tenant_act` on the
    reference's per-decision corpus: the masks of JAX's `_tenant_act` with
    the same engine, every row of every kind."""
    jpool = jpaper_pool("sciq")
    stats, ts, keys = _corpus(jpool, 100)
    m = len(ts)
    kinds = ("awc", "suc", "aic")
    fcfg = jfleet.fleet_config(
        [JPolicyConfig(kind=kind, k=jpool.k, n=4,
                       rho=default_rho(jpool, kind, 4), delta=1 / 60)
         for kind in kinds for _ in range(m)])
    stats = {k: np.concatenate([v] * 3) for k, v in stats.items()}
    ts, keys = np.concatenate([ts] * 3), np.concatenate([keys] * 3)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s, t, k, c: jfleet._tenant_act(s, t, k, c, (0, 1, 2),
                                              "bisect", fw_steps)))(
        {k: jnp.asarray(v) for k, v in stats.items()}, jnp.asarray(ts),
        jnp.asarray(keys), fcfg))
    got = fleet._tenant_act({k: torch.tensor(v) for k, v in stats.items()},
                            torch.tensor(ts), convert.key_rows(keys, "cpu"),
                            convert.fleet_config(fcfg, "cpu"),
                            engine="bisect", fw_steps=fw_steps).numpy()
    bad = np.nonzero((want != got).any(-1))[0]
    assert bad.size == 0, np.repeat(np.asarray(kinds), m)[bad]


def test_simulate_fleet_bisect_tracks_the_reference():
    """`simulate_fleet(engine="bisect", fw_steps=4)` against JAX's with the
    same arguments: round-1 actions equal, each kind's mean reward and
    final violation within the fleet tests' tolerances."""
    jpool = jpaper_pool("sciq")
    pcfgs = _mixed_policies(jpool)
    kinds = [p.kind for p in pcfgs]
    jcfg = jfleet.fleet_config(pcfgs)
    ref = jfleet.simulate_fleet(jpool, jcfg, T=32, seed=0, engine="bisect",
                                fw_steps=4)
    port = fleet.simulate_fleet(paper_pool("sciq"),
                                convert.fleet_config(jcfg, "cpu"), T=32,
                                seed=0, engine="bisect", fw_steps=4,
                                device="cpu")
    assert np.array_equal(port.action[:, 0], ref.action[:, 0])
    _assert_curves(_per_kind(port.reward, port.cost, kinds, pcfgs),
                   _per_kind(ref.reward, ref.cost, kinds, pcfgs),
                   ("awc", "suc", "aic"))
    default = fleet.simulate_fleet(paper_pool("sciq"),
                                   convert.fleet_config(jcfg, "cpu"), T=4,
                                   seed=0, device="cpu")
    same = fleet.simulate_fleet(paper_pool("sciq"),
                                convert.fleet_config(jcfg, "cpu"), T=4,
                                seed=0, engine="grid", fw_steps=8,
                                device="cpu")
    assert np.array_equal(default.action, same.action)   # None = defaults
