"""Baseline scheduling policies the paper argues against (§I, §III.B).

The port's own copy of ``repro.core.baselines``; `core.policies_torch`
holds their tensor twins.

All share the simulator's per-tick pass signature so every benchmark runs
each policy on the *same* workload:

* ``static_partition`` — hard division: each user owns a fixed block of
  CPUs; jobs run only inside their owner's block.
* ``capping``          — usage capping: a user's running total may never
  exceed their entitlement, but CPUs are pooled (no preemption needed).
* ``fcfs``             — SLURM sched/builtin: strict queue order, head
  blocks the queue.
* ``backfill``         — conservative backfill (sched/backfill): jobs may
  jump the queue iff they do not delay the head job's earliest start,
  computed from *estimated* remaining runtimes (the paper's §III.B point:
  estimates are unreliable; we expose an estimate-error knob).
* ``backfill_cr``      — Niu et al. [30]: backfill + checkpoint-preemption
  of backfilled jobs when the head job becomes runnable.

C/R pricing — including tiered eviction placement (``cfg.cr_tiers``:
greedy cheapest-feasible tier choice with durable spill, the restore
priced at the placed tier) — rides the shared `omfs._evict` / `omfs._start`
helpers, so every baseline pays the same size- and tier-aware costs as
OMFS with no policy-specific code here (DESIGN.md §Tier placement).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

from repro_torch.core.omfs import Decision, _evict, _start
from repro_torch.core.queues import sorted_pending, sorted_victims, submitted_key
from repro_torch.core.types import ClusterState, Job, JobClass, JobState


def _admit(state: ClusterState, job: Job, reason: str) -> Decision:
    _start(state, job)
    return Decision(job_id=job.id, admitted=True, reason=reason)


def _deny(job: Job, reason: str) -> Decision:
    return Decision(job_id=job.id, admitted=False, reason=reason)


# ---------------------------------------------------------------------------


def static_partition(state: ClusterState) -> List[Decision]:
    """Hard divisions: user blocks sized by entitlement; no pooling at all."""
    decisions = []
    for job in sorted_pending(state):
        cap = state.entitled(job.user)
        used = state.user_usage(job.user)["total"]
        if used + job.cpus <= cap:
            decisions.append(_admit(state, job, "fits user partition"))
        else:
            decisions.append(_deny(job, "partition full"))
    return decisions


def capping(state: ClusterState) -> List[Decision]:
    """Pooled CPUs + per-user cap at the entitlement (no over-subscription)."""
    decisions = []
    for job in sorted_pending(state):
        cap = state.entitled(job.user)
        used = state.user_usage(job.user)["total"]
        if used + job.cpus <= cap and state.cpu_idle >= job.cpus:
            decisions.append(_admit(state, job, "within cap"))
        else:
            decisions.append(_deny(job, "cap or idle exceeded"))
    return decisions


def fcfs(state: ClusterState) -> List[Decision]:
    """Strict first-come-first-served: the queue head blocks everyone."""
    decisions = []
    for job in sorted_pending(state):
        if state.cpu_idle >= job.cpus:
            decisions.append(_admit(state, job, "fcfs head fits"))
        else:
            decisions.append(_deny(job, "fcfs head blocked"))
            break  # noone may overtake the head
    return decisions


def _estimated_remaining(job: Job, error: float = 0.0) -> int:
    """User-supplied runtime estimate: true remaining inflated by ``error``
    (papers show real estimates are inflated by 2-5x; see [19],[26],[30])."""
    return max(1, math.ceil((job.work + job.overhead - job.progress) * (1.0 + error)))


def make_backfill(estimate_error: float = 0.0, with_cr: bool = False) -> Callable:
    """Conservative backfill; optionally with C/R preemption (Niu et al.)."""

    def policy(state: ClusterState) -> List[Decision]:
        decisions: List[Decision] = []
        pending = sorted_pending(state)
        if not pending:
            return decisions
        head, rest = pending[0], pending[1:]

        if state.cpu_idle >= head.cpus:
            decisions.append(_admit(state, head, "head fits"))
            head_start = None
        elif with_cr:
            # Niu et al.: preempt checkpointable *backfilled* jobs to start
            # the head job now instead of waiting for the reservation.
            victims = [v for v in sorted_victims(state) if v.backfilled]
            freed = 0
            planned = []
            for v in victims:
                if state.cpu_idle + freed >= head.cpus:
                    break
                planned.append(v)
                freed += v.cpus
            if state.cpu_idle + freed >= head.cpus:
                dec = Decision(job_id=head.id, admitted=True, reason="head via C/R preemption")
                for v in planned:
                    _evict(state, v, dec)
                _start(state, head)
                decisions.append(dec)
                head_start = None
            else:
                head_start = _reservation_time(state, head, estimate_error)
                decisions.append(_deny(head, "head waits (reservation)"))
        else:
            # compute the head job's reservation from runtime estimates
            head_start = _reservation_time(state, head, estimate_error)
            decisions.append(_deny(head, "head waits (reservation)"))

        for job in rest:
            if job.state != JobState.PENDING:
                continue
            if state.cpu_idle < job.cpus:
                decisions.append(_deny(job, "no idle"))
                continue
            if head_start is not None:
                # conservative: would this backfill delay the reservation?
                est_end = state.time + _estimated_remaining(job, estimate_error)
                if est_end > head_start and not _fits_alongside_head(state, job, head):
                    decisions.append(_deny(job, "would delay head reservation"))
                    continue
            job.backfilled = True
            decisions.append(_admit(state, job, "backfilled"))
        return decisions

    policy.__name__ = "backfill_cr" if with_cr else "backfill"
    return policy


def _reservation_time(state: ClusterState, head: Job, error: float) -> int:
    """Earliest tick the head job can start, from estimated completions."""
    running = sorted(
        state.running_jobs(),
        key=lambda j: _estimated_remaining(j, error),
    )
    idle = state.cpu_idle
    for j in running:
        idle += j.cpus
        if idle >= head.cpus:
            return state.time + _estimated_remaining(j, error)
    return state.time + sum(_estimated_remaining(j, error) for j in running) + 1


def _fits_alongside_head(state: ClusterState, job: Job, head: Job) -> bool:
    """Backfill is safe regardless of duration if, after placing the job,
    enough CPUs remain for the head."""
    return state.cpu_idle - job.cpus >= head.cpus


backfill = make_backfill(estimate_error=0.0)
backfill_cr = make_backfill(estimate_error=0.0, with_cr=True)

ALL_BASELINES: Dict[str, Callable] = {
    "static_partition": static_partition,
    "capping": capping,
    "fcfs": fcfs,
    "backfill": backfill,
    "backfill_cr": backfill_cr,
}
