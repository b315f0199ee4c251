"""Deterministic fault injection + replica health policy for the serving
stack (port of `repro/serving/faults.py`; the chaos harness of the
continuous-batching scheduler).

A failed completion is a zero-reward observation at the cost of the
attempted work (App.-E.3 semantics: the AWC cascade advances exactly as for
an unsatisfied user), so the bandit's feedback stays honest when replicas
error, stall or go down.

`FaultPlan` is the injection side: every draw is keyed by

    fold_in(fold_in(fold_in(PRNGKey(fault_seed), replica), rid), attempt)

where ``rid`` is the replica's submission ordinal (its own 0-based count of
accepted requests), so a chaos run is reproducible from ``fault_seed``
alone. The draw uses the port's threefry (`prng`), so the schedule is the
reference's bit for bit. A verdict is a host decision (the reference
materialises it with `np.asarray`): it is computed on CPU tensors whatever
device the engines run on, so it is the same on every machine. A disabled
plan (all probabilities 0) injects nothing.

`HealthPolicy` is the handling side: bounded retries with capped
exponential backoff, per-request deadlines in scheduler ticks, and the
health machine thresholds

    healthy -> degraded -> quarantined --(probation)--> healthy

that `serving.scheduler.ReplicaRunner` drives. Quarantined replicas are
masked out of `router.cloud.SchedulingCloud.select`.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import prng


class EngineCrash(RuntimeError):
    """Injected engine crash (exercises the scheduler's recovery path)."""


class Health(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"         # en route to quarantine, still serving
    QUARANTINED = "quarantined"   # masked from selection; purges work
                                  # caught at entry, holds later work as
                                  # probation probes
    PROBATION = "probation"       # readmitted for probe traffic


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Failure-handling knobs for one `ReplicaRunner`.

    ``max_retries`` bounds attempts per request (total = 1 + max_retries);
    backoff between attempts is min(backoff_base * 2**(attempt-1),
    backoff_cap) scheduler ticks. ``timeout_ticks`` is a per-attempt
    deadline measured from (re)submission; None disables deadlines.
    ``quarantine_after`` consecutive failures quarantine the replica;
    after ``probation_ticks`` it re-enters as PROBATION and
    ``readmit_successes`` consecutive successful completions restore it
    (any probation failure re-quarantines immediately)."""
    max_retries: int = 2
    backoff_base: int = 1
    backoff_cap: int = 8
    timeout_ticks: Optional[int] = None
    degrade_after: int = 2
    quarantine_after: int = 4
    probation_ticks: int = 16
    readmit_successes: int = 2


@dataclasses.dataclass(frozen=True)
class FaultDraw:
    """The (replica, rid, attempt)-keyed verdict for one request attempt."""
    fails: bool        # this attempt is doomed
    crash: bool        # ... and manifests as an engine crash, not an error
    fail_tick: int     # resident ticks survived before the failure fires
    spike: int         # extra ticks the attempt waits before admission


NO_FAULT = FaultDraw(fails=False, crash=False, fail_tick=0, spike=0)


class FaultPlan:
    """Seeded, reproducible fault schedule for a replica pool.

    ``fail_prob`` is scalar (all replicas) or per-replica; a doomed attempt
    aborts after ``fail_tick`` resident scheduler ticks (uniform on
    [0, fail_tick_max]), so cost has been incurred for the attempted work.
    With ``crash_on_decode`` the doomed attempt instead raises `EngineCrash`
    from the decode path, taking every co-resident request's work with it.
    ``spike_prob`` / ``spike_ticks`` inject admission latency spikes.
    ``rid_window`` (lo, hi) limits injection to the submission ordinals
    lo <= rid < hi: a deterministic transient outage."""

    def __init__(self, fault_seed: int = 0,
                 fail_prob: Union[float, Sequence[float]] = 0.0,
                 crash_on_decode: bool = False,
                 spike_prob: float = 0.0, spike_ticks: int = 4,
                 fail_tick_max: int = 2,
                 rid_window: Optional[Tuple[int, int]] = None):
        self.fault_seed = int(fault_seed)
        self._fail_prob = np.atleast_1d(np.asarray(fail_prob, np.float64))
        self.crash_on_decode = bool(crash_on_decode)
        self.spike_prob = float(spike_prob)
        self.spike_ticks = int(spike_ticks)
        self.fail_tick_max = int(fail_tick_max)
        self.rid_window = rid_window

    @property
    def enabled(self) -> bool:
        return bool((self._fail_prob > 0).any() or self.spike_prob > 0)

    def fail_prob(self, replica: int) -> float:
        p = self._fail_prob
        return float(p[replica] if p.shape[0] > 1 else p[0])

    def draw(self, replica: int, rid: int, attempt: int) -> FaultDraw:
        """The deterministic fault verdict for one request attempt, drawn
        on the CPU."""
        if not self.enabled:
            return NO_FAULT
        if self.rid_window is not None and not \
                (self.rid_window[0] <= rid < self.rid_window[1]):
            return NO_FAULT
        key = prng.PRNGKey(self.fault_seed, device="cpu")
        for x in (replica, rid, attempt):
            key = prng.fold_in(key, x)
        u = prng.uniform(key, (3,)).numpy()
        fails = bool(u[0] < self.fail_prob(replica))
        spike = self.spike_ticks if u[1] < self.spike_prob else 0
        fail_tick = int(u[2] * (self.fail_tick_max + 1))
        return FaultDraw(fails=fails,
                         crash=fails and self.crash_on_decode,
                         fail_tick=fail_tick, spike=spike)
