"""Shared helpers that build the fixtures of the port's serving-stack tests
(`tests/test_torch_{faults,scheduler,service}.py`): a reduced dense model
with a 64-token vocabulary, its JAX engines and the port's engines over the
same weights (`convert.params_from_jax`), float32, on the CPU.

``GREEDY`` is the engines' temperature floor (1e-4): logits × 1e4 outweigh
the Gumbel noise, so a token is the argmax unless two logits lie within
~1e-3, and the port's and JAX's logits (2e-5 apart at most) pick the same
token. Bit-equality within the port needs no such care and runs at 0.7.
"""
import dataclasses

import jax
import numpy as np

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.serving import engine

VOCAB = 64
GREEDY = 1e-4
MAX_LEN = 32
ARCH = "starcoder2-7b"


def configs():
    return (dataclasses.replace(jget_config(ARCH).reduced(), vocab=VOCAB),
            dataclasses.replace(get_config(ARCH).reduced(), vocab=VOCAB))


def engines(seed, temperature=GREEDY):
    """(JAX engine, port engine) over the same weights from PRNGKey(seed)."""
    jcfg, cfg = configs()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    params = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return (jengine.Engine(jcfg, jparams, max_len=MAX_LEN, eos_id=0,
                           temperature=temperature),
            engine.Engine(cfg, params, max_len=MAX_LEN, eos_id=0,
                          temperature=temperature, device="cpu"))


def pools(n=3, temperature=GREEDY):
    """(JAX replicas, port replicas): n engines at prices 0.001·(1 + i)."""
    from repro.router import cloud as jcloud
    from repro_torch.router import cloud
    pairs = [engines(i, temperature) for i in range(n)]
    return ([jcloud.Replica(f"m{i}", je, 0.001 * (1 + i))
             for i, (je, _) in enumerate(pairs)],
            [cloud.Replica(f"m{i}", te, 0.001 * (1 + i))
             for i, (_, te) in enumerate(pairs)])


def requests(module, n, *, b=2, s=6, max_new=8, seed0=0, arm=0, rng=17):
    """``n`` requests of ``module``'s `Request`, the same prompts for the
    same arguments."""
    gen = np.random.default_rng(rng)
    return [module.Request(tenant=0, arm=arm,
                           prompts=gen.integers(1, VOCAB, (b, s)),
                           max_new=max_new, seed=seed0 + i)
            for i in range(n)]


def drain(module, eng, reqs, *, n_slots=4, chunk=3, plan=None, health=None,
          tick_budget=100_000):
    """One runner of ``module``'s scheduler over ``eng``: (runner,
    scheduler, completions in arrival order)."""
    runner = module.ReplicaRunner(eng, n_slots=n_slots, chunk=chunk,
                                  replica_ix=0, fault_plan=plan,
                                  health=health)
    got = []
    sched = module.ContinuousScheduler([runner], on_complete=got.append,
                                       tick_budget=tick_budget)
    for r in reqs:
        sched.submit(r)
    sched.drain()
    return runner, sched, got
