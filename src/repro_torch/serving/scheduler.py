"""Continuous-batching request bridge (port of `repro/serving/scheduler.py`;
the paper's App. E.3 serving loop).

Tenants submit `(tenant, arm, prompts)` requests; each replica has a
`ReplicaRunner` owning one `Engine` and one persistent `SlotState`:

  submit -> FIFO pending queue
  step   -> admit as many whole requests as free slots allow, coalescing
            same-prompt-length requests into one stacked prefill bucket
            written straight into free slots, then one `decode_chunk`
            advancing every occupied slot, then harvest completed requests
            off the device.

`ContinuousScheduler` round-robins the runners until idle; completions fire
their request's callback inside the drain loop, so a callback may submit
follow-up requests (the AWC cascade) and the drain keeps going until the
whole cascade settles. Feedback therefore lands out of round order, which
the bandit's per-arm Eq.-(6) updates commute under.

The determinism contract is the reference's: FIFO admission, same-length
prefill buckets, per-request row keys fold_in(PRNGKey(seed), row), and the
tick order health -> admit -> expire -> injected crash -> decode_chunk ->
harvest. Requests are admitted whole, so each request's prefill is the
(B, S) computation `Engine.generate` runs and its rows sample with the same
keys: on row-deterministic families a request's tokens equal what
`generate` gives it alone.

Fault tolerance (`serving.faults`): every attempt gets a deterministic
`FaultPlan` verdict keyed by (replica, submission ordinal, attempt). Failed
attempts (injected, or `HealthPolicy.timeout_ticks` deadline misses) free
their slots and retry with capped backoff up to `max_retries`, after which
the request completes with ``ok=False``. An `EngineCrash` rebuilds the
`SlotState` from scratch, releases every orphaned slot and requeues the
resident requests. Each runner drives the health machine healthy ->
degraded -> quarantined -> probation -> healthy; entering quarantine purges
everything queued or resident at that moment, reports the runner
unavailable, and holds later submissions as probation probes. `drain` takes
a tick budget, so it terminates under any fault pattern.

Where the port departs from the reference: the reference contains any
exception raised in a tick (`except Exception`) and rebuilds the slot
state. The port contains `EngineCrash` only, the injected crash included.
Any other exception propagates: on the card it may be a CUDA error, which
poisons the context, and rebuilding the slots over it would only hide a
broken kernel or model.

`_harvest` reads the slots' progress back in one device-to-host copy a
tick (the reference's six `np.asarray` reads). Each runner also keeps a
`tick_log` of what each tick ran (prefill buckets, decode steps, occupied
slots, tenants in the decode batch): host-side counts, no device read.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import (Callable, Deque, Dict, FrozenSet, List, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from repro_torch import prng
from repro_torch.serving.engine import Engine, GenResult, SlotState, _row_keys
from repro_torch.serving.faults import (EngineCrash, FaultDraw, FaultPlan,
                                        Health, HealthPolicy, NO_FAULT)

_RID = itertools.count()

DEFAULT_TICK_BUDGET = 100_000


@dataclasses.dataclass
class Request:
    """One generation request: a tenant's round for one arm."""
    tenant: int
    arm: int
    prompts: np.ndarray               # (B, S) int32
    max_new: int
    seed: int
    callback: Optional[Callable[["Completion"], None]] = None
    rid: int = dataclasses.field(default_factory=lambda: next(_RID))


@dataclasses.dataclass
class Completion:
    request: Request
    result: GenResult
    ok: bool = True                   # False: all attempts failed
    error: Optional[str] = None       # why the final attempt failed
    attempts: int = 1                 # attempts consumed (1 = first try)


class TickRecord(NamedTuple):
    """What one `ReplicaRunner.step` ran."""
    tick: int
    buckets: int            # prefill buckets admitted (one prefill each)
    rows: int               # prompt rows those buckets admitted
    decode_steps: int       # decode steps run (0 or the runner's chunk)
    occupied: int           # slots resident during the decode
    tenants: FrozenSet[int]   # tenants with a request in that decode batch


@dataclasses.dataclass
class _Pending:
    """A queued attempt: the request plus its retry/fault bookkeeping."""
    req: Request
    fix: int                          # per-replica submission ordinal
    attempt: int
    draw: FaultDraw
    submit_tick: int                  # deadline epoch for this attempt
    not_before: int                   # backoff / latency-spike gate


@dataclasses.dataclass
class _Resident:
    """An admitted attempt occupying slots."""
    req: Request
    slots: np.ndarray
    fix: int
    attempt: int
    draw: FaultDraw
    submit_tick: int
    admit_tick: int
    n_out_seen: np.ndarray            # last harvested per-row progress


class ReplicaRunner:
    """One replica: engine + slot state + FIFO pending queue + health."""

    def __init__(self, engine: Engine, *, n_slots: int = 32, chunk: int = 8,
                 max_out: Optional[int] = None, replica_ix: int = 0,
                 fault_plan: Optional[FaultPlan] = None,
                 health: Optional[HealthPolicy] = None):
        self.engine = engine
        self.n_slots = n_slots
        self.chunk = chunk
        self.max_out = max_out
        self.replica_ix = replica_ix
        self.fault_plan = fault_plan \
            if (fault_plan is not None and fault_plan.enabled) else None
        self.policy = health or HealthPolicy()
        self.state: SlotState = engine.init_slots(n_slots, max_out=max_out)
        self.pending: Deque[_Pending] = deque()
        self.resident: Dict[int, _Resident] = {}
        self._free: List[int] = list(range(n_slots))
        # health machine + chaos accounting
        self.tick = 0
        self._n_submitted = 0
        self.health_state = Health.HEALTHY
        self._consec_fails = 0
        self._quarantined_at = -1
        self._probe_ok = 0
        self._purge_upto: Optional[int] = None
        self.health_log: List[Tuple[int, Health]] = []
        self.n_failures = 0       # failed attempts (incl. retried ones)
        self.n_retries = 0
        self.n_rejected = 0       # dropped without retry (quarantine/abort)
        self.n_crashes = 0
        self.n_quarantines = 0
        self.tick_log: List[TickRecord] = []
        self._admitted: List[int] = []    # this tick's bucket row counts

    @property
    def busy(self) -> bool:
        return bool(self.pending or self.resident)

    @property
    def available(self) -> bool:
        """Selectable by the router (probation counts: probes readmit)."""
        return self.health_state is not Health.QUARANTINED

    # ------------------------------------------------------------- submit
    def submit(self, req: Request) -> None:
        if req.prompts.shape[0] > self.n_slots:
            raise ValueError(f"request batch {req.prompts.shape[0]} exceeds "
                             f"slot count {self.n_slots}")
        fix = self._n_submitted
        self._n_submitted += 1
        draw = self.fault_plan.draw(self.replica_ix, fix, 1) \
            if self.fault_plan else NO_FAULT
        self.pending.append(_Pending(req=req, fix=fix, attempt=1, draw=draw,
                                     submit_tick=self.tick,
                                     not_before=self.tick + draw.spike))

    # ----------------------------------------------------- health machine
    def _set_health(self, state: Health) -> None:
        if state is Health.QUARANTINED:
            # everything submitted before the quarantine fires is purged on
            # the next step; anything submitted later is held and served as
            # a probation probe
            self._purge_upto = self._n_submitted
        self.health_state = state
        self.health_log.append((self.tick, state))

    def _record_failure(self) -> None:
        self.n_failures += 1
        self._consec_fails += 1
        p = self.policy
        if self.health_state is Health.PROBATION:
            self.n_quarantines += 1
            self._quarantined_at = self.tick
            self._set_health(Health.QUARANTINED)   # failed its probe
        elif self.health_state in (Health.HEALTHY, Health.DEGRADED):
            if self._consec_fails >= p.quarantine_after:
                self.n_quarantines += 1
                self._quarantined_at = self.tick
                self._set_health(Health.QUARANTINED)
            elif (self._consec_fails >= p.degrade_after
                  and self.health_state is Health.HEALTHY):
                self._set_health(Health.DEGRADED)

    def _record_success(self) -> None:
        self._consec_fails = 0
        if self.health_state is Health.PROBATION:
            self._probe_ok += 1
            if self._probe_ok >= self.policy.readmit_successes:
                self._set_health(Health.HEALTHY)
        elif self.health_state is Health.DEGRADED:
            self._set_health(Health.HEALTHY)

    def _health_tick(self) -> None:
        if (self.health_state is Health.QUARANTINED
                and self.tick - self._quarantined_at
                >= self.policy.probation_ticks):
            self._probe_ok = 0
            self._set_health(Health.PROBATION)

    # ---------------------------------------------------- failure plumbing
    def _fail_result(self, req: Request, n_out: np.ndarray) -> GenResult:
        """Attempted-work result: no usable tokens, but ``out_lens`` counts
        the tokens decoded before the failure (the router charges them)."""
        b = req.prompts.shape[0]
        return GenResult(
            np.full((b, req.max_new), self.engine.eos_id, np.int32),
            np.asarray(n_out, np.int32).reshape(b),
            np.zeros((b,), np.float32))

    def _retry_or_fail(self, ent, n_out: np.ndarray, why: str,
                       *, count_health: bool = True) -> Optional[Completion]:
        """Requeue a failed attempt with backoff, or mint the terminal
        failure completion once retries are exhausted."""
        if count_health:
            self._record_failure()
        if ent.attempt <= self.policy.max_retries:
            self.n_retries += 1
            nxt = ent.attempt + 1
            draw = self.fault_plan.draw(self.replica_ix, ent.fix, nxt) \
                if self.fault_plan else NO_FAULT
            backoff = min(self.policy.backoff_base * 2 ** (ent.attempt - 1),
                          self.policy.backoff_cap)
            self.pending.append(_Pending(
                req=ent.req, fix=ent.fix, attempt=nxt, draw=draw,
                submit_tick=self.tick,
                not_before=self.tick + backoff + draw.spike))
            return None
        return Completion(ent.req, self._fail_result(ent.req, n_out),
                          ok=False, error=why, attempts=ent.attempt)

    def _reject_all(self, why: str) -> List[Completion]:
        """Fail every queued/resident request without retry (quarantine or
        drain-budget abort): each gets exactly one ok=False completion."""
        comps: List[Completion] = []
        for p in self.pending:
            zeros = np.zeros(p.req.prompts.shape[0], np.int32)
            comps.append(Completion(p.req, self._fail_result(p.req, zeros),
                                    ok=False, error=why, attempts=p.attempt))
        self.pending.clear()
        freed: List[int] = []
        for r in self.resident.values():
            comps.append(Completion(r.req,
                                    self._fail_result(r.req, r.n_out_seen),
                                    ok=False, error=why, attempts=r.attempt))
            freed.extend(np.asarray(r.slots).tolist())
        self.resident.clear()
        if freed:
            self.state = self.engine.release(self.state, np.asarray(freed))
            self._free.extend(freed)
        self.n_rejected += len(comps)
        return comps

    def abort_all(self, why: str) -> List[Completion]:
        """Force-fail everything outstanding (drain tick-budget exhaustion).
        Health is not charged: this is the scheduler giving up, not the
        replica failing."""
        return self._reject_all(why)

    def _purge_quarantined(self) -> List[Completion]:
        """First step after entering quarantine: fail everything that was
        queued or resident when the replica died. Requests submitted after
        the transition stay queued; they become the probation probes."""
        if self._purge_upto is None:
            return []
        upto, self._purge_upto = self._purge_upto, None
        held = deque(p for p in self.pending if p.fix >= upto)
        dropped = [p for p in self.pending if p.fix < upto]
        self.pending = deque(dropped)       # residents always predate entry
        comps = self._reject_all("replica quarantined")
        self.pending = held
        return comps

    def _recover(self, err: EngineCrash) -> List[Completion]:
        """Engine crash containment: rebuild the slot state from scratch,
        release every orphaned slot and requeue the resident requests
        (their decoded work is lost; the crash counts once against
        health, whoever was co-resident)."""
        self.n_crashes += 1
        residents = list(self.resident.values())
        self.resident.clear()
        self.state = self.engine.init_slots(self.n_slots,
                                            max_out=self.max_out)
        self._free = list(range(self.n_slots))
        self._record_failure()
        comps = []
        why = f"engine crash: {err!r}"
        for r in residents:
            c = self._retry_or_fail(r, r.n_out_seen, why, count_health=False)
            if c is not None:
                comps.append(c)
        return comps

    # -------------------------------------------------------------- admit
    def _admit_ready(self) -> None:
        """Admit the FIFO prefix of pending requests that fits in the free
        slots as one prefill bucket per prompt length: same-length requests
        are stacked into a single (ΣB, S) prefill + admit. Each request's
        rows keep their own fold_in(PRNGKey(seed), row) keys and token
        budgets. An attempt still inside its backoff / latency-spike window
        blocks the queue behind it (FIFO order is part of the determinism
        contract)."""
        dev = self.engine.device
        while self.pending:
            if self.pending[0].not_before > self.tick:
                return               # head attempt still backing off
            s = self.pending[0].req.prompts.shape[1]
            bucket: List[_Pending] = []
            rows = 0
            while self.pending \
                    and self.pending[0].not_before <= self.tick \
                    and self.pending[0].req.prompts.shape[1] == s \
                    and len(self._free) - rows >= \
                    self.pending[0].req.prompts.shape[0]:
                ent = self.pending.popleft()
                rows += ent.req.prompts.shape[0]
                bucket.append(ent)
            if not bucket:
                return               # head request doesn't fit yet
            slots = np.asarray([self._free.pop() for _ in range(rows)])
            lg, cache_slice = self.engine.prefill(
                np.concatenate([e.req.prompts for e in bucket], axis=0))
            rkeys = torch.cat([
                _row_keys(prng.PRNGKey(e.req.seed, device=dev),
                          e.req.prompts.shape[0])
                for e in bucket])
            max_new = np.concatenate([
                np.full(e.req.prompts.shape[0], e.req.max_new, np.int32)
                for e in bucket])
            self.state = self.engine.admit(
                self.state, slots, lg, cache_slice, prompt_len=s,
                max_new=max_new, rkeys=rkeys)
            self._admitted.append(rows)
            ofs = 0
            for ent in bucket:
                b = ent.req.prompts.shape[0]
                self.resident[ent.req.rid] = _Resident(
                    req=ent.req, slots=slots[ofs:ofs + b], fix=ent.fix,
                    attempt=ent.attempt, draw=ent.draw,
                    submit_tick=ent.submit_tick, admit_tick=self.tick,
                    n_out_seen=np.zeros(b, np.int32))
                ofs += b

    # ------------------------------------------------------------- faults
    def _expire(self) -> List[Completion]:
        """Clean injected failures + deadline misses: abort the attempt,
        free its slots, retry or complete-as-failed."""
        deadline = self.policy.timeout_ticks
        if self.fault_plan is None and deadline is None:
            return []
        comps: List[Completion] = []
        doomed: List[Tuple[int, str]] = []
        for rid, r in self.resident.items():
            if (r.draw.fails and not r.draw.crash
                    and self.tick - r.admit_tick >= r.draw.fail_tick):
                doomed.append((rid, "injected fault"))
            elif (deadline is not None
                  and self.tick - r.submit_tick >= deadline):
                doomed.append((rid, "deadline exceeded"))
        if doomed:
            n_out_all = self.state.n_out.cpu().numpy()
        for rid, why in doomed:
            r = self.resident.pop(rid)
            n_out = n_out_all[r.slots]
            self.state = self.engine.release(self.state, r.slots)
            self._free.extend(np.asarray(r.slots).tolist())
            c = self._retry_or_fail(r, n_out, why)
            if c is not None:
                comps.append(c)
        if deadline is not None and self.pending:
            live: List[_Pending] = []
            for p in self.pending:
                if self.tick - p.submit_tick >= deadline:
                    c = self._retry_or_fail(
                        p, np.zeros(p.req.prompts.shape[0], np.int32),
                        "deadline exceeded in queue")
                    if c is not None:
                        comps.append(c)
                else:
                    live.append(p)
            self.pending = deque(live)
        return comps

    def _maybe_injected_crash(self) -> None:
        for rid, r in self.resident.items():
            if (r.draw.fails and r.draw.crash
                    and self.tick - r.admit_tick >= r.draw.fail_tick):
                raise EngineCrash(f"injected decode crash (rid {rid}, "
                                  f"attempt {r.attempt})")

    # ------------------------------------------------------------ harvest
    def _progress(self) -> Tuple[np.ndarray, ...]:
        """(step, finished, max_new, n_out, lp_sum, out) of every slot, in
        one device-to-host copy: the int32 fields and lp_sum's bits side by
        side with `out`."""
        st = self.state
        host = torch.cat([torch.stack([
            st.step, st.finished.to(torch.int32), st.max_new, st.n_out,
            st.lp_sum.view(torch.int32)], dim=1), st.out], dim=1).cpu().numpy()
        return (host[:, 0], host[:, 1].astype(bool), host[:, 2], host[:, 3],
                np.ascontiguousarray(host[:, 4]).view(np.float32),
                host[:, 5:])

    def _harvest(self) -> List[Completion]:
        if not self.resident:
            return []
        step, fin, cap, n_out, lp, out = self._progress()
        # progress snapshot: after a crash the slot state is gone, so the
        # attempted-work cost of the lost requests comes from here
        for r in self.resident.values():
            r.n_out_seen = n_out[r.slots].copy()
        done = [rid for rid, r in self.resident.items()
                if (fin[r.slots] | (step[r.slots] >= cap[r.slots])).all()]
        if not done:
            return []
        comps = []
        freed: List[int] = []
        for rid in done:
            r = self.resident.pop(rid)
            slots = r.slots
            n = n_out[slots]
            freed.extend(slots.tolist())
            if r.draw.fails:
                # decode outpaced fail_tick (chunk >= max_new finishes in
                # one tick): a doomed attempt still never succeeds, so
                # fail_prob stays exact regardless of chunking
                c = self._retry_or_fail(r, n, "injected fault")
                if c is not None:
                    comps.append(c)
                continue
            res = GenResult(out[slots, :r.req.max_new], n,
                            lp[slots] / np.maximum(n, 1))
            self._record_success()
            comps.append(Completion(r.req, res, attempts=r.attempt))
        self.state = self.engine.release(self.state, np.asarray(freed))
        self._free.extend(freed)
        return comps

    # --------------------------------------------------------------- step
    def step(self) -> List[Completion]:
        """One scheduling tick: admit, decode one chunk, harvest, with the
        fault layer around it (quarantine rejection, injected crash
        recovery, deadline + injected-failure expiry). Only `EngineCrash`
        is contained (see the module docstring)."""
        self.tick += 1
        self._admitted = []
        self._health_tick()
        if self.health_state is Health.QUARANTINED:
            # purge the work caught by the outage; hold later submissions
            # until probation opens (they are the probes)
            return self._purge_quarantined()
        comps: List[Completion] = []
        steps, occupied, tenants = 0, 0, frozenset()
        try:
            self._admit_ready()
            comps += self._expire()
            if self.resident:
                self._maybe_injected_crash()
                occupied = self.n_slots - len(self._free)
                tenants = frozenset(r.req.tenant
                                    for r in self.resident.values())
                self.state = self.engine.decode_chunk(self.state, self.chunk)
                steps = self.chunk
        except EngineCrash as err:    # crash containment: rebuild + requeue
            return comps + self._recover(err)
        finally:
            self.tick_log.append(TickRecord(
                self.tick, len(self._admitted), sum(self._admitted), steps,
                occupied if steps else 0, tenants if steps else frozenset()))
        return comps + self._harvest()


class ContinuousScheduler:
    """Per-arm runners + the drain loop that settles all queued work."""

    def __init__(self, runners: Sequence[ReplicaRunner],
                 on_complete: Optional[Callable[[Completion], None]] = None,
                 tick_budget: int = DEFAULT_TICK_BUDGET):
        self.runners = list(runners)
        self.on_complete = on_complete
        self.tick_budget = tick_budget
        self.last_drain_ticks = 0

    @property
    def busy(self) -> bool:
        return any(r.busy for r in self.runners)

    def submit(self, req: Request) -> int:
        self.runners[req.arm].submit(req)
        return req.rid

    def availability(self) -> np.ndarray:
        """Per-arm health mask (K,): False = quarantined. The router masks
        unavailable arms out of selection and renormalizes z̃."""
        return np.asarray([r.available for r in self.runners], bool)

    def stats(self) -> List[Dict[str, int]]:
        """Per-runner chaos accounting."""
        return [{"failures": r.n_failures, "retries": r.n_retries,
                 "rejected": r.n_rejected, "crashes": r.n_crashes,
                 "quarantines": r.n_quarantines,
                 "health": r.health_state.value}
                for r in self.runners]

    def _fire(self, comp: Completion, sink: List[Completion]) -> None:
        cb = comp.request.callback or self.on_complete
        if cb is not None:
            cb(comp)
        sink.append(comp)

    def drain(self, tick_budget: Optional[int] = None) -> List[Completion]:
        """Run until every runner is idle; fire callbacks as completions
        arrive (callbacks may submit follow-up requests: the cascade). The
        tick budget bounds the loop: on exhaustion every outstanding
        request (including any the abort callbacks resubmit) is
        force-failed, so drain terminates under any fault pattern."""
        budget = self.tick_budget if tick_budget is None else tick_budget
        all_comps: List[Completion] = []
        ticks = 0
        while self.busy:
            if budget is not None and ticks >= budget:
                while self.busy:         # abort callbacks may resubmit
                    for runner in self.runners:
                        for comp in runner.abort_all(
                                "drain tick budget exhausted"):
                            self._fire(comp, all_comps)
                break
            ticks += 1
            for runner in self.runners:
                # quarantined runners tick too (their probation clock runs
                # on scheduler activity), busy or not
                if not (runner.busy
                        or runner.health_state is Health.QUARANTINED):
                    continue
                for comp in runner.step():
                    self._fire(comp, all_comps)
        self.last_drain_ticks = ticks
        return all_comps
