"""End-to-end multi-LLM service (port of `repro/router/service.py`; the
paper's Fig. 3): query -> relax (local) -> round + dispatch (cloud) ->
model generation -> feedback -> Eq.(6) update.

The `LocalServer` is a one-row `router.fleet.TenantState`, so the
service's selection math is the fleet's batched program (`topn_lp`, and
`awc_fw` for AWC, on the card); only the host-side dispatch differs.
Generation runs in one of two modes:

  sequential  — one blocking `cloud.dispatch` per selected arm, in
                ascending-price order for AWC.
  continuous  — requests go through the cloud's continuous-batching
                scheduler (`serving.scheduler`): the round's arms are
                submitted up front, completions come back out of round
                order (App. E.3) and each applies `local.record` from its
                callback. The AWC cascade is a state machine: only the
                cheapest arm is submitted first, and each below-threshold
                completion enqueues the next-pricier arm. Per-arm Eq.-(6)
                updates touch disjoint statistics, so the two modes end
                every round in the same bandit state (bit-equal on
                row-deterministic model families).

`FleetService` steps M tenants against one shared scheduler, which is where
continuous batching pays: different tenants' requests for the same replica
coalesce into shared decode batches. `router.fleet.simulate_fleet_driven`
drives it for T rounds.

Fault tolerance (`serving.faults`): a failed completion (retries
exhausted, replica quarantined, drain budget hit) is a real bandit
observation: reward 0 at the cost of the attempted work, the AWC cascade
advancing as for an unsatisfied user. Quarantined replicas are masked out
of `cloud.select` until their probation probes readmit them; any
availability change invalidates the cached async-batch action mask. The
sequential path counts an `EngineCrash` from `dispatch` as such a failure
and lets any other exception propagate, as the scheduler does (the
reference counts every exception there).

The quality signal is measured output quality: the query stream is the
planted-Markov LM of `data.pipeline`, and reward = the fraction of
generated tokens that are valid successors under its bigram graph,
computed in numpy on the host. Costs are realized token counts × the
replica's price. The local server lives on the cloud's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.policies import PolicyConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.router.cloud import SchedulingCloud
from repro_torch.router.local_server import LocalServer
from repro_torch.serving.faults import EngineCrash
from repro_torch.serving.scheduler import Request


class RoundStateError(RuntimeError):
    """Round protocol violation (begin/finish out of order, feedback with
    no open round). A real exception, not an assert: the round state
    machine must hold under ``python -O`` too."""


@dataclasses.dataclass
class RoundLog:
    action: np.ndarray           # (K,) bool
    observed: np.ndarray         # (K,) bool
    rewards: np.ndarray          # (K,) observed per-arm reward (0 if not)
    cost: float                  # budget-accounted cost of the round
    failed: Optional[np.ndarray] = None   # (K,) bool: observation was a
    # serving failure (zero reward at attempted-work cost, App. E.3)


@dataclasses.dataclass
class _Round:
    """In-flight round: per-arm results accumulate as completions arrive."""
    prompts: np.ndarray
    mask: np.ndarray
    seed: int
    rewards: np.ndarray
    observed: np.ndarray
    costs: np.ndarray
    failed: np.ndarray
    cascade: List[int]           # AWC: arms not yet submitted (price order)
    inflight: int = 0


class MultiLLMService:
    """One tenant (local server) + the shared scheduling cloud.

    ``batch_size > 1`` gives the App.-E.3 asynchronous selection variant
    (the cloud re-coordinates only every B feedbacks). ``dispatch`` picks
    the generation path: "sequential", "continuous", or "auto" (continuous
    when every replica engine exposes the slot API)."""

    def __init__(self, pcfg: PolicyConfig, cloud: SchedulingCloud,
                 data: SyntheticLM, *, prompt_len: int = 16,
                 max_new: int = 16, batch_size: int = 1, seed: int = 0,
                 success_threshold: float = 0.5, dispatch: str = "auto",
                 scheduler=None, tenant: int = 0, fault_plan=None,
                 health=None, tick_budget: Optional[int] = None):
        self.pcfg = pcfg
        self.local = LocalServer(pcfg, device=cloud.device)
        self.cloud = cloud
        self.data = data
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.batch_size = batch_size
        self.success_threshold = success_threshold
        self.tenant = tenant
        self.rng = np.random.default_rng(seed)
        self._round = 0
        self._cached_mask: Optional[np.ndarray] = None
        self._cached_avail: Optional[np.ndarray] = None
        self.fault_plan = fault_plan
        self._seq_fix = 0            # sequential-mode fault-draw ordinal
        self.history: List[RoundLog] = []
        # AWC cascade order: ascending price, fixed for the pool's lifetime
        self._price_order = np.argsort(cloud.prices, kind="stable")
        if dispatch == "auto":
            dispatch = "continuous" if all(
                hasattr(r.engine, "init_slots") for r in cloud.replicas
            ) else "sequential"
        if dispatch not in ("sequential", "continuous"):
            raise ValueError(dispatch)
        self.dispatch = dispatch
        self.sched = None
        self._cur: Optional[_Round] = None
        if dispatch == "continuous":
            self.sched = scheduler if scheduler is not None \
                else cloud.make_scheduler(fault_plan=fault_plan,
                                          health=health,
                                          tick_budget=tick_budget)

    # --------------------------------------------------------------- quality
    def _quality(self, prompts: np.ndarray, gen: np.ndarray) -> float:
        """Fraction of generated bigrams that follow the planted graph."""
        succ = self.data.succ
        seq = np.concatenate([prompts[:, -1:], gen], axis=1)
        prev = seq[:, :-1]
        nxt = seq[:, 1:]
        valid = (succ[prev] == nxt[..., None]).any(-1)
        return float(valid.mean())

    # ---------------------------------------------------------------- rounds
    def _availability(self) -> Optional[np.ndarray]:
        """Per-arm health mask from the scheduler (None = no fault layer)."""
        if self.sched is None or not hasattr(self.sched, "availability"):
            return None
        return self.sched.availability()

    def _select_mask(self) -> np.ndarray:
        # async batching: reuse the previous action between cloud syncs,
        # but any availability change (quarantine or recovery) invalidates
        # the cached mask: re-coordinate at once over the new pool
        avail = self._availability()
        if (self._cached_mask is not None and avail is not None
                and self._cached_avail is not None
                and not np.array_equal(avail, self._cached_avail)):
            self._cached_mask = None
        if (self._cached_mask is None
                or (self._round - 1) % self.batch_size == 0):
            z = self.local.relaxed_selection()
            self._cached_mask = self.cloud.select(z, self.rng,
                                                  available=avail)
            self._cached_avail = None if avail is None else avail.copy()
        else:
            self.local.t += 1     # the round still elapses
        return self._cached_mask

    def _arm_order(self, mask: np.ndarray) -> np.ndarray:
        """Selected arms; for AWC in cascade (ascending price) order."""
        if self.pcfg.kind == "awc":
            return self._price_order[mask[self._price_order]]
        return np.flatnonzero(mask)

    def _open_round(self) -> None:
        self._round += 1
        mask = self._select_mask()
        prompts = self.data.batch(self._round)[:, :self.prompt_len]
        k = self.pcfg.k
        self._cur = _Round(prompts=prompts, mask=mask, seed=self._round,
                           rewards=np.zeros(k), observed=np.zeros(k, bool),
                           costs=np.zeros(k), failed=np.zeros(k, bool),
                           cascade=list(self._arm_order(mask)))

    def begin_round(self) -> None:
        """Select arms and submit the round's requests (continuous mode).
        `FleetService` calls this for every tenant before one shared drain;
        `step` pairs it with an immediate drain."""
        if self._cur is not None:
            raise RoundStateError("previous round not finished")
        self._open_round()
        if self.pcfg.kind == "awc":
            if self._cur.cascade:
                self._submit(self._cur.cascade.pop(0))
        else:
            while self._cur.cascade:
                self._submit(self._cur.cascade.pop(0))

    def _submit(self, arm: int) -> None:
        # submit first: if it raises (e.g. batch > slot count) the round's
        # inflight counter must stay balanced or drain/finish wedge forever
        self.sched.submit(Request(
            tenant=self.tenant, arm=int(arm), prompts=self._cur.prompts,
            max_new=self.max_new, seed=self._cur.seed,
            callback=self._on_complete))
        self._cur.inflight += 1

    def _apply_feedback(self, arm: int, q: float, cost: float,
                        failed: bool) -> None:
        """One arm's observation, successful or failed. A failure is a real
        bandit observation (App. E.3): reward 0 at the cost of the
        attempted work; for AWC it reads as an unsatisfied user and the
        cascade advances to the next-pricier arm."""
        cur = self._cur
        cur.rewards[arm] = q
        cur.observed[arm] = True
        cur.costs[arm] = cost
        cur.failed[arm] = failed
        self.local.record(arm, q, cost)

    def _on_complete(self, comp) -> None:
        """Async feedback: applied as each completion arrives, out of round
        order across arms and tenants (per-arm Eq.-(6) updates commute)."""
        cur = self._cur
        if cur is None:
            raise RoundStateError("completion delivered outside a round")
        arm = comp.request.arm
        cur.inflight -= 1
        ok = getattr(comp, "ok", True)
        q = self._quality(cur.prompts, comp.result.tokens) if ok else 0.0
        cost = self.cloud.realized_cost(arm, cur.prompts, comp.result)
        self._apply_feedback(arm, q, cost, failed=not ok)
        if (self.pcfg.kind == "awc" and q < self.success_threshold
                and cur.cascade):
            self._submit(cur.cascade.pop(0))   # user unsatisfied: next arm

    def finish_round(self) -> RoundLog:
        cur = self._cur
        if cur is None:
            raise RoundStateError("no round in flight")
        if cur.inflight != 0:
            raise RoundStateError(
                f"{cur.inflight} request(s) still in flight — drain the "
                "scheduler before finishing the round")
        # fixed-order cost sum: the same float result in both modes
        log = RoundLog(cur.mask.copy(), cur.observed, cur.rewards,
                       float(cur.costs.sum()), failed=cur.failed)
        self.history.append(log)
        self._cur = None
        return log

    def _dispatch_sequential(self, arm: int) -> tuple[float, float, bool]:
        """One blocking dispatch with failure handling: an injected fault
        (`fault_plan`) or an `EngineCrash` comes back as a zero-reward
        observation at prompt cost (the attempted work of a provider that
        errored before returning tokens). The sequential path keeps no
        retry or health machinery; that lives in the scheduler."""
        cur = self._cur
        prompt_cost = (cur.prompts.shape[0] * cur.prompts.shape[1]
                       * float(self.cloud.prices[arm]))
        if self.fault_plan is not None:
            draw = self.fault_plan.draw(int(arm), self._seq_fix, 1)
            self._seq_fix += 1
            if draw.fails:
                return 0.0, prompt_cost, False
            try:
                out, cost = self.cloud.dispatch(arm, cur.prompts,
                                                self.max_new, seed=cur.seed)
            except EngineCrash:        # provider error: observed failure
                return 0.0, prompt_cost, False
        else:
            out, cost = self.cloud.dispatch(arm, cur.prompts, self.max_new,
                                            seed=cur.seed)
        return self._quality(cur.prompts, out.tokens), cost, True

    def _step_sequential(self) -> RoundLog:
        cur = self._cur
        for arm in list(cur.cascade):
            cur.cascade.remove(arm)
            q, cost, ok = self._dispatch_sequential(arm)
            self._apply_feedback(arm, q, cost, failed=not ok)
            if self.pcfg.kind == "awc" and q >= self.success_threshold:
                break            # user satisfied: later arms unqueried
        return self.finish_round()

    def step(self) -> RoundLog:
        if self.dispatch == "sequential":
            self._open_round()
            return self._step_sequential()
        self.begin_round()
        self.sched.drain()
        return self.finish_round()

    def run(self, rounds: int) -> List[RoundLog]:
        return [self.step() for _ in range(rounds)]

    # --------------------------------------------------------------- metrics
    def summary(self) -> Dict[str, float]:
        costs = np.array([h.cost for h in self.history])
        t = np.arange(1, len(costs) + 1)
        viol = np.maximum(np.cumsum(costs) / t - self.pcfg.rho, 0.0)
        obs_rewards = np.array([
            h.rewards[h.observed].mean() if h.observed.any() else 0.0
            for h in self.history])
        return {"rounds": len(costs),
                "mean_cost": float(costs.mean()),
                "violation": float(viol[-1]),
                "mean_observed_reward": float(obs_rewards.mean())}


class FleetService:
    """M tenants sharing one cloud + one continuous-batching scheduler.

    Each round every tenant submits its selected arms' requests up front;
    one shared drain then coalesces all tenants' generation into
    per-replica decode batches, each completion applying its tenant's
    feedback from the callback (AWC cascade resubmissions included)."""

    def __init__(self, pcfg_or_list, cloud: SchedulingCloud,
                 data: SyntheticLM, *, n_tenants: Optional[int] = None,
                 n_slots: int = 32, chunk: int = 8, seed: int = 0,
                 fault_plan=None, health=None,
                 tick_budget: Optional[int] = None, **service_kw):
        pcfgs = list(pcfg_or_list) if isinstance(pcfg_or_list, (list, tuple)) \
            else [pcfg_or_list] * int(n_tenants or 1)
        self.cloud = cloud
        self.sched = cloud.make_scheduler(n_slots=n_slots, chunk=chunk,
                                          fault_plan=fault_plan,
                                          health=health,
                                          tick_budget=tick_budget)
        self.tenants = [
            MultiLLMService(p, cloud, data, dispatch="continuous",
                            scheduler=self.sched, tenant=i, seed=seed + i,
                            **service_kw)
            for i, p in enumerate(pcfgs)]

    def step(self) -> List[RoundLog]:
        for svc in self.tenants:
            svc.begin_round()
        self.sched.drain()
        return [svc.finish_round() for svc in self.tenants]

    def run(self, rounds: int) -> List[List[RoundLog]]:
        return [self.step() for _ in range(rounds)]
