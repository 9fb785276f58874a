"""Priority queues for Jobs_Submitted and Jobs_Running (lines 5-6).

The port's own copy of ``repro.core.queues``.

The paper leaves the prioritization policy open ("FIFO or priority-by-user").
Both queues are *orderings over the job table*, expressed as key functions,
so the Python reference and the tensor scheduler sort by the same
keys and stay step-equivalent.

Conventions:
* ``submitted_key``: smaller = dequeued (tried) first.
* ``running_key``: smaller = evicted first ("least prioritized", line 33),
  with quantum demotion: jobs running uninterruptedly for >= quantum are
  demoted (preferred victims).  Jobs still inside their quantum are NOT
  evictable (paper §II anti-thrashing) — expressed by ``evictable``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from repro_torch.core.types import ClusterState, Job


def submitted_key(job: Job) -> Tuple:
    """FIFO within priority: higher j.priority first, then earlier submit."""
    return (-job.priority, job.submit_time, job.id)


def sorted_pending(state: ClusterState) -> List[Job]:
    return sorted(state.pending_jobs(), key=submitted_key)


def evictable(state: ClusterState, job: Job) -> bool:
    """A running job may be evicted only after its quantum elapsed."""
    if not job.job_class.is_preemptable:
        return False
    return (state.time - job.run_start) >= state.config.quantum


def running_victim_key(job: Job) -> Tuple:
    """Victim order among evictable jobs: lowest priority first, then the
    job that has been running longest past its quantum (most demoted),
    then id for determinism."""
    return (job.priority, job.run_start, job.id)


def cheap_victim_key(state: ClusterState) -> Callable[[Job], Tuple]:
    """Size-aware victim order (beyond paper, `omfs_cheap_victim`):
    cheapest-to-checkpoint first — ``(save_cost, priority, run_start, id)``.

    The ordering cost is the *fast-tier* save cost (tier 0 of
    ``cfg.cr_tiers``, or ``cfg.cr_cost``), the same number the torch backend
    precomputes as column 0 of ``JobTable.cost_save_lat`` /
    ``cost_rsave_lat``; the tier actually charged is still chosen at
    eviction time (capacity may force a spill).  Delta-aware: a warm job
    (one that already holds a snapshot) is priced at its recurrent cost —
    what evicting it *actually* costs — so warm jobs sort cheaper."""
    cfg = state.config

    def key(job: Job) -> Tuple:
        return (cfg.eviction_save_cost(job.state_mib, 0,
                                       recurrent=job.n_checkpoints > 0),
                job.priority, job.run_start, job.id)

    return key


def sorted_victims(state: ClusterState,
                   key: Optional[Callable[[Job], Tuple]] = None) -> List[Job]:
    return sorted(
        (j for j in state.running_jobs() if evictable(state, j)),
        key=key or running_victim_key,
    )
