"""Core scheduler types: users, jobs, job classes, events.

The port's own copy of ``repro.core.types``.  ``Job`` ids come from this
module's counter, separate from the reference's, so jobs built by the two
packages in one process carry different ids (`core.convert` copies the
reference's ids when a run must line up row for row).

Terminology follows the paper: the resource unit is a "CPU" (for the TPU
adaptation read "chip"; `core.placement` adds slice-shape constraints on
top of the counts — Algorithm 1 itself only sees counts).
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from repro_torch.core.crcost import CRCostModel, TieredCRCostModel, state_mib_of


class JobClass(enum.IntEnum):
    """Paper §II: non-preemptible jobs run only within the entitlement;
    preemptible (killable) and checkpointable (C/R-able) jobs may exceed it."""

    NON_PREEMPTIBLE = 0
    PREEMPTIBLE = 1        # may be killed on eviction
    CHECKPOINTABLE = 2     # transparently checkpointed on eviction (DMTCP)

    @property
    def is_preemptable(self) -> bool:
        return self != JobClass.NON_PREEMPTIBLE


class JobState(enum.IntEnum):
    UNSUBMITTED = 0
    PENDING = 1
    RUNNING = 2
    DONE = 3
    KILLED = 4             # evicted non-checkpointable job, dropped (line 34)


@dataclass(frozen=True)
class User:
    """An entity with a CPU entitlement expressed in percent (lines 7-9)."""

    name: str
    percent: float

    def entitled_cpus(self, cpu_total: int) -> int:
        # line 22: floor((percent / 100) * CPU_Total)
        return int((self.percent / 100.0) * cpu_total)


_job_ids = itertools.count()


@dataclass
class Job:
    """A job and its mutable runtime bookkeeping (lines 10-13 + our state)."""

    user: str
    cpus: int                      # j.CPU_Count
    work: int                      # total work units (ticks x its CPUs held)
    priority: int = 0              # j.priority — among the *user's* jobs
    job_class: JobClass = JobClass.CHECKPOINTABLE
    submit_time: int = 0
    state_bytes: int = 0           # checkpoint image size (C/R cost driver)
    id: int = field(default_factory=lambda: next(_job_ids))

    # runtime state
    state: JobState = JobState.UNSUBMITTED
    progress: int = 0              # work units completed
    run_start: int = -1            # tick the current run segment started
    first_start: int = -1
    finish_time: int = -1
    n_preemptions: int = 0
    n_checkpoints: int = 0
    overhead: int = 0              # extra work units added by C/R cost
    backfilled: bool = False       # admitted by jumping the queue (backfill)
    ckpt_tier: int = -1            # tier holding the latest snapshot (-1: none)
    n_spills: int = 0              # checkpoints placed beyond the fast tier

    @property
    def remaining(self) -> int:
        return self.work + self.overhead - self.progress

    @property
    def state_mib(self) -> int:
        return state_mib_of(self.state_bytes)

    def clone(self) -> "Job":
        return replace(self)


KERNEL_BACKENDS = ("cuda", "torch")


@dataclass(frozen=True)
class SchedulerConfig:
    """Policy knobs.  Defaults are paper-faithful; flags marked (beyond
    paper) are extensions measured separately in the benchmarks."""

    cpu_total: int = 256
    quantum: int = 30              # minimal uninterrupted run before evictable
    cr_overhead: int = 0           # legacy flat work units per checkpoint
    cr_cost: CRCostModel = CRCostModel()   # size-aware save/restore costs
    # per-tier cost models + eviction placement; takes precedence over
    # cr_cost when set (the flat cr_overhead still applies at every save)
    cr_tiers: Optional[TieredCRCostModel] = None
    drop_killed: bool = True       # line 34: non-checkpointable victims are dropped
    # ---- beyond-paper extensions (all default OFF for fidelity) ----
    victim_filter_over_entitlement: bool = False   # only evict over-entitlement users
    avoid_self_eviction: bool = False              # never evict the requester's jobs
    elastic_shrink: bool = False                   # shrink instead of full eviction

    # Which implementation serves the eviction machinery (victim sort,
    # capacity cutoff, tier placement) inside every C/R-aware pass:
    #   "cuda"  — the fused `kernels.sched_select` plan: the hand-written
    #             Hopper kernel on CUDA tensors, its plain version on CPU
    #             tensors (default)
    #   "torch" — eager torch ops, the twin of the reference's "lax" path
    #             (hoisted victim order + cumsum cutoff + placement loop);
    #             the kernel's reference on the card
    kernel_backend: str = "cuda"

    def __post_init__(self):
        if self.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(f"unknown SchedulerConfig.kernel_backend "
                             f"{self.kernel_backend!r}: expected one of "
                             f"{KERNEL_BACKENDS}")

    # -- the one cost expression both backends share (DESIGN.md §Tier
    # placement): the table build precomputes these per JobTable column
    # with Python-int arithmetic, the Python reference evaluates them at
    # runtime — bit-equality holds because it is the same function.
    def tier_model(self, tier: int) -> CRCostModel:
        if self.cr_tiers is not None:
            return self.cr_tiers.tiers[tier]
        return self.cr_cost

    @property
    def n_cost_tiers(self) -> int:
        """Number of cost-lattice columns T (1 when untiered)."""
        return self.cr_tiers.n_tiers if self.cr_tiers is not None else 1

    def eviction_save_cost(self, state_mib: int, tier: int = 0,
                           recurrent: bool = False) -> int:
        """Work units charged when a checkpointable victim lands on ``tier``
        (legacy flat cr_overhead + the tier's size-dependent save cost).
        ``recurrent`` prices a re-eviction of a job that already saved a
        snapshot once — only the delta moves."""
        model = self.tier_model(tier)
        cost = model.recurrent_save_cost if recurrent else model.save_cost
        return self.cr_overhead + cost(state_mib)

    def restart_restore_cost(self, state_mib: int, tier: int = 0) -> int:
        """Work units charged when a checkpointed job restarts from ``tier``."""
        return self.tier_model(tier).restore_cost(state_mib)


@dataclass
class ClusterState:
    """The scheduler-visible state (System Init, lines 1-9)."""

    config: SchedulerConfig
    users: Dict[str, User]
    jobs: Dict[int, Job] = field(default_factory=dict)
    time: int = 0

    def __post_init__(self):
        total = sum(u.percent for u in self.users.values())
        assert total <= 100.0 + 1e-9, f"entitlements sum to {total} > 100 (line 9)"

    # -- queries used by the runner (lines 19-22) --------------------------
    def running_jobs(self) -> List[Job]:
        return [j for j in self.jobs.values() if j.state == JobState.RUNNING]

    def pending_jobs(self) -> List[Job]:
        return [j for j in self.jobs.values() if j.state == JobState.PENDING]

    def cpu_busy(self) -> int:
        return sum(j.cpus for j in self.running_jobs())

    @property
    def cpu_idle(self) -> int:
        return self.config.cpu_total - self.cpu_busy()

    def user_usage(self, user: str) -> Dict[str, int]:
        p_able = sum(
            j.cpus for j in self.running_jobs()
            if j.user == user and j.job_class.is_preemptable
        )
        non_p = sum(
            j.cpus for j in self.running_jobs()
            if j.user == user and not j.job_class.is_preemptable
        )
        return {"preemptable": p_able, "non_preemptable": non_p, "total": p_able + non_p}

    def entitled(self, user: str) -> int:
        return self.users[user].entitled_cpus(self.config.cpu_total)
