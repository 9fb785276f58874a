"""Scheduler metrics: utilization, fairness, reclaim latency, C/R overhead.

The port's own copy of ``repro.core.metrics``, over the port's
`core.simulator.SimResult` (the Python backend's result).

These quantify the paper's qualitative claims (it has no tables of its own):
utilization vs. the capping-style baselines, entitlement fairness as
"no justified complaints" (a user with pending demand and usage below its
entitlement), and the thrashing cost of recurrent C/R.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List

import numpy as np

from repro_torch.core.simulator import SimResult
from repro_torch.core.types import JobState


@dataclass
class Metrics:
    utilization: float
    jain_fairness: float                 # over per-user normalized usage
    mean_wait: float
    p95_wait: float
    mean_slowdown: float
    throughput: float                    # done jobs / horizon
    killed_jobs: int
    preemptions: int
    checkpoints: int
    spilled_checkpoints: int             # placed beyond the fast tier (cr_tiers)
    cr_overhead_units: int               # work units burned by C/R
    goodput: float                       # useful cpu-ticks / machine capacity
    wasted_work_frac: float              # executed cpu-ticks lost to C/R + kills
    violation_ticks: float               # mean ticks/user with a justified complaint
    reclaim_latency: Dict[int, int]      # job id -> ticks from submit to first start

    def row(self) -> Dict[str, float]:
        d = self.__dict__.copy()
        d.pop("reclaim_latency")
        return d


def compute_metrics(result: SimResult) -> Metrics:
    state = result.state
    cfg = state.config
    horizon = len(result.log)
    jobs = result.job_table()

    util = result.utilization()

    # Jain index over sum of per-user cpu-ticks, normalized by entitlement.
    per_user = {u: 0.0 for u in state.users}
    for tick in result.log:
        for u, c in tick.per_user_cpus.items():
            per_user[u] += c
    norm = np.array([
        per_user[u] / max(state.entitled(u), 1) for u in state.users
    ])
    if norm.sum() <= 0:
        jain = 1.0
    else:
        jain = float(norm.sum() ** 2 / (len(norm) * (norm ** 2).sum() + 1e-12))

    waits, slowdowns = [], []
    reclaim = {}
    for j in jobs:
        if j.first_start >= 0:
            waits.append(j.first_start - j.submit_time)
            reclaim[j.id] = j.first_start - j.submit_time
        if j.state == JobState.DONE:
            span = max(j.finish_time - j.submit_time, 1)
            slowdowns.append(span / max(j.work, 1))

    # "justified complaint": at tick t, user has pending jobs that would fit
    # inside its unused entitlement, yet is below its entitlement.
    violations = np.zeros(horizon)
    pending_by_tick: Dict[int, List] = {}
    for t, tick in enumerate(result.log):
        v = 0
        for u in state.users:
            used = tick.per_user_cpus[u]
            ent = state.entitled(u)
            if used < ent and tick.pending > 0:
                # approximation at log granularity; exact per-user pending
                # sizes are checked in the property tests instead
                v += 1 if any(
                    d.job_id in state.jobs
                    and state.jobs[d.job_id].user == u
                    and not d.admitted
                    and state.jobs[d.job_id].cpus <= ent - used
                    for d in tick.decisions
                ) else 0
        violations[t] = v

    # goodput / wasted work (the paper's thrashing-cost term): progress
    # toward `work` is useful; overhead units and killed jobs' progress are
    # cpu-ticks the machine executed but the users never benefit from
    useful = sum(
        min(j.progress, j.work) * j.cpus
        for j in jobs if j.state != JobState.KILLED
    )
    executed = sum(j.progress * j.cpus for j in jobs)
    goodput = useful / max(cfg.cpu_total * horizon, 1)
    wasted_frac = (executed - useful) / max(executed, 1)

    done = [j for j in jobs if j.state == JobState.DONE]
    metrics = Metrics(
        utilization=util,
        jain_fairness=jain,
        mean_wait=float(np.mean(waits)) if waits else 0.0,
        p95_wait=float(np.percentile(waits, 95)) if waits else 0.0,
        mean_slowdown=float(np.mean(slowdowns)) if slowdowns else 0.0,
        throughput=len(done) / max(horizon, 1),
        killed_jobs=sum(1 for j in jobs if j.state == JobState.KILLED),
        preemptions=sum(j.n_preemptions for j in jobs),
        checkpoints=sum(j.n_checkpoints for j in jobs),
        spilled_checkpoints=sum(j.n_spills for j in jobs),
        cr_overhead_units=sum(j.overhead for j in jobs),
        goodput=goodput,
        wasted_work_frac=wasted_frac,
        violation_ticks=float(violations.mean()),
        reclaim_latency=reclaim,
    )
    return metrics


def event_summary(events: Iterable) -> Dict[str, float]:
    """Reconciliation view of an `repro.obs` event log: the subset of
    `Metrics` that is derivable from lifecycle events alone.

    The point of this function is the cross-check, not novelty: for an
    instrumented run, ``event_summary(result.events)`` must agree with the
    table-derived numbers (``preemptions`` == sum of ``n_preemptions``,
    ``checkpoints`` == sum of ``n_checkpoints``, per-job wait == DEFER
    count, ...) — the property tests assert it, so a drift between the
    event capture and the engine's own bookkeeping is a test failure, not
    a silent skew in the dashboards.
    """
    from repro_torch.obs.events import EventType

    by_type = {e: 0 for e in EventType}
    defers: Dict[int, int] = {}
    starts: Dict[int, int] = {}
    restores = 0
    for ev in events:          # events arrive in canonical (tick,...) order
        by_type[EventType(ev.etype)] += 1
        if ev.etype == EventType.DEFER and ev.jid not in starts:
            # pre-first-start waiting only: post-eviction requeue ticks are
            # churn, not wait (matches first_start - submit_time)
            defers[ev.jid] = defers.get(ev.jid, 0) + 1
        elif ev.etype == EventType.START:
            starts.setdefault(ev.jid, ev.tick)
        elif ev.etype == EventType.RESTORE:
            restores += 1
    waits = [defers.get(jid, 0) for jid in starts]
    return {
        **{f"n_{e.name.lower()}": n for e, n in by_type.items()},
        "preemptions": by_type[EventType.EVICT],
        "checkpoints": by_type[EventType.SAVE],
        "spilled_checkpoints": by_type[EventType.SPILL],
        "restores": restores,
        "jobs_started": len(starts),
        "jobs_done": by_type[EventType.FINISH],
        "mean_wait": float(np.mean(waits)) if waits else 0.0,
        "p95_wait": float(np.percentile(waits, 95)) if waits else 0.0,
    }
