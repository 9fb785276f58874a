"""OMFS: the paper's Algorithm 1, line-for-line Python reference.

The port's own copy of ``repro.core.omfs``: the engine's ``"python"``
backend, against which its tensor passes are held.

``runner`` is MEMORYLESS FAIR-SHARE RUNNER (lines 18-38); ``scheduler_pass``
is one sweep of MEMORYLESS FAIR-SHARE SCHEDULER (lines 14-17) adapted to
discrete-event form: the paper's infinite dequeue loop becomes "try every
submitted job once per event, in queue order" (re-enqueued jobs wait for the
next event, exactly like line 24/29 re-enqueues).

Paper quirks preserved deliberately (validated by tests, discussed in
DESIGN.md):
* line 23 uses ``>=``: a non-preemptible job that would *exactly* fill the
  user's entitlement is rejected.
* line 26 uses ``>`` (strictly more idle CPUs than requested); the
  equal-idle case falls through to the entitlement check.
* lines 32-36 evict the least-prioritized running jobs regardless of owner;
  the ``victim_filter_over_entitlement`` / ``avoid_self_eviction`` flags are
  our (beyond-paper, default-off) refinements.
* line 34: evicted non-checkpointable jobs are dropped (killed), unless
  ``drop_killed=False`` (restart-from-zero re-queue).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.core.queues import cheap_victim_key, sorted_pending, sorted_victims
from repro_torch.core.types import ClusterState, Job, JobClass, JobState


@dataclass
class Decision:
    """Outcome of one runner invocation, for logging/testing."""

    job_id: int
    admitted: bool
    reason: str
    evicted: List[int] = field(default_factory=list)
    checkpointed: List[int] = field(default_factory=list)
    killed: List[int] = field(default_factory=list)


def _start(state: ClusterState, job: Job) -> None:
    if job.n_checkpoints > 0:
        # transparent restore from the latest snapshot: charge the
        # size-dependent read cost of the tier the snapshot was PLACED on
        # at eviction (restart after a kill with drop_killed=False restarts
        # from scratch -> n_checkpoints == 0, nothing to restore)
        tier = max(job.ckpt_tier, 0)
        job.overhead += state.config.restart_restore_cost(job.state_mib, tier)
    # the restore consumes the snapshot: its tier slot frees for the next
    # victim (matches omfs_torch.admit_job clearing ckpt_tier)
    job.ckpt_tier = -1
    job.state = JobState.RUNNING
    job.run_start = state.time
    if job.first_start < 0:
        job.first_start = state.time


def _tier_occupancy(state: ClusterState) -> List[int]:
    """MiB of snapshot state currently held per tier: evicted-and-pending
    jobs whose latest checkpoint was placed there.  Recomputed per eviction
    in this reference backend (O(J)); the tensor twin folds the same sum into
    the eviction branch (`omfs_torch.tier_occupancy`)."""
    occ = [0] * state.config.cr_tiers.n_tiers
    for j in state.jobs.values():
        if j.state == JobState.PENDING and j.ckpt_tier >= 0:
            occ[j.ckpt_tier] += j.state_mib
    return occ


def _evict(state: ClusterState, victim: Job, dec: Decision) -> None:
    """Lines 33-36: checkpoint (or drop) the victim and free its CPUs."""
    dec.evicted.append(victim.id)
    victim.n_preemptions += 1
    if victim.job_class == JobClass.CHECKPOINTABLE:
        # delta-aware: a job that already checkpointed once only writes the
        # delta on every later save — decide BEFORE bumping the counter.
        recurrent = victim.n_checkpoints > 0
        victim.n_checkpoints += 1
        # snapshot write: place the image on a tier (greedy cheapest-
        # feasible, spilling past full tiers), then charge the legacy flat
        # term + that tier's size-dependent save cost.  Victims evicted
        # earlier in the same pass already occupy their tier (they are
        # PENDING by now), so placement is sequential-greedy by construction.
        tiers = state.config.cr_tiers
        if tiers is not None:
            tier = tiers.choose_tier(victim.state_mib, _tier_occupancy(state),
                                     recurrent=recurrent)
        else:
            tier = 0
        victim.ckpt_tier = tier
        if tier > 0:
            victim.n_spills += 1
        victim.overhead += state.config.eviction_save_cost(
            victim.state_mib, tier, recurrent=recurrent)
        victim.state = JobState.PENDING          # line 35: back to Jobs_Submitted
        # memoryless: re-queued with its original priority; progress is kept
        # (transparent C/R) — the whole point of the paper.
        dec.checkpointed.append(victim.id)
    else:
        # line 34: "if it is not checkpointable, drop it"
        if state.config.drop_killed:
            victim.state = JobState.KILLED
            victim.finish_time = state.time
        else:
            victim.state = JobState.PENDING
            victim.progress = 0                  # restart from scratch
        dec.killed.append(victim.id)
    victim.run_start = -1


def runner(state: ClusterState, job: Job, *,
           cheap_victims: bool = False) -> Decision:
    """MEMORYLESS FAIR-SHARE RUNNER (lines 18-38) for one submitted job.

    ``cheap_victims`` (beyond paper, the `omfs_cheap_victim` policy) orders
    victims by ``(save_cost, priority, run_start, id)`` instead of the
    paper's ``(priority, run_start, id)`` — prefer the victims whose
    checkpoints are cheapest to write."""
    cfg = state.config
    dec = Decision(job_id=job.id, admitted=False, reason="")

    usage = state.user_usage(job.user)                        # lines 19-21
    entitled = state.entitled(job.user)                       # line 22

    # line 23: non-preemptible jobs must stay strictly inside the entitlement
    if (not job.job_class.is_preemptable) and (
        usage["non_preemptable"] + job.cpus >= entitled
    ):
        dec.reason = "non-preemptible exceeds entitlement (line 23)"
        return dec                                            # lines 24-25

    # line 26: enough idle resources -> run anyways (even over entitlement)
    if state.cpu_idle > job.cpus:
        _start(state, job)
        dec.admitted, dec.reason = True, "idle resources (line 26)"
        return dec                                            # line 27 (goto 37)

    # line 28: does the request fit in the user's unused entitlement?
    if job.cpus > entitled - usage["total"]:
        dec.reason = "exceeds unused entitlement, no idle (line 28)"
        return dec                                            # lines 29-30

    # lines 31-36: user is entitled; make room by evicting running jobs
    victims = sorted_victims(
        state, key=cheap_victim_key(state) if cheap_victims else None)
    if cfg.victim_filter_over_entitlement:                    # beyond paper
        victims = [
            v for v in victims
            if state.user_usage(v.user)["total"] > state.entitled(v.user)
        ]
    if cfg.avoid_self_eviction:                               # beyond paper
        victims = [v for v in victims if v.user != job.user]

    freed = 0
    planned: List[Job] = []
    for v in victims:                                         # line 32 loop
        if state.cpu_idle + freed >= job.cpus:
            break
        planned.append(v)
        freed += v.cpus
    if state.cpu_idle + freed < job.cpus:
        # not enough evictable capacity (all within quantum): wait
        dec.reason = "insufficient evictable capacity (quantum)"
        return dec

    for v in planned:
        _evict(state, v, dec)                                 # lines 33-36
    _start(state, job)                                        # lines 37-38
    dec.admitted = True
    dec.reason = "entitled, evicted to fit (lines 31-38)" if planned else \
        "entitled, idle exactly sufficient (lines 31-38)"
    return dec


def scheduler_pass(state: ClusterState, *,
                   cheap_victims: bool = False) -> List[Decision]:
    """One sweep of the MEMORYLESS FAIR-SHARE SCHEDULER (lines 14-17).

    Tries each pending job once, in submitted-queue order.  Jobs admitted
    earlier in the pass change the state seen by later jobs (CPU counts,
    running queue) — same as the paper's sequential dequeue loop.
    """
    decisions = []
    for job in sorted_pending(state):
        if job.state != JobState.PENDING:      # may have been evicted/killed
            continue
        decisions.append(runner(state, job, cheap_victims=cheap_victims))
    return decisions


def cheap_victim_pass(state: ClusterState) -> List[Decision]:
    """`omfs_cheap_victim`: Algorithm 1 with size-aware victim selection."""
    return scheduler_pass(state, cheap_victims=True)
