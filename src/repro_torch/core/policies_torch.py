"""The baseline policies over the torch `JobTable`: the port of
``repro.core.policies_jax``.

Twins of `core.baselines` (static_partition / capping / fcfs / backfill /
backfill_cr), built from the OMFS pass's primitives (`core.omfs_torch`:
queue_order, running_usage, admit_job, plan_evictions, apply_evictions).
Every pass follows the engine's contract ``pass_fn(cfg, ent, t, tbl,
stats=None) -> tbl`` and updates ``tbl`` in place.

**Admissions are decided on the device.**  The reference's ``fori_loop``
carries (usage, busy, blocked, head reservation) as arrays; here they are
tensors too, each queue position is indexed by a one-element index tensor
(a 0-d one would be read back by torch's indexing) and `admit_job` takes
the admission as a bool tensor.  No pass reads the device per queue
position.  The one host read is backfill_cr's, once per tick: whether the
queue head is pending and does not fit, which is where Niu et al.'s C/R
preemption needs an eviction plan (`plan_evictions`, the `sched_select`
kernel under ``kernel_backend="cuda"``).  ``stats`` (`PassStats`) counts
that read in ``host_syncs`` and each plan in ``evict_branches``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from repro_torch.core.omfs_torch import (
    BIG,
    I32,
    NONP,
    PENDING,
    RUNNING,
    JobTable,
    PassStats,
    admit_job,
    apply_evictions,
    plan_evictions,
    queue_order,
    running_usage,
)
from repro_torch.core.types import SchedulerConfig
from repro_torch.kernels.sched_select.ref import lexsort


def _depth(n: int, pass_depth: Optional[int]) -> int:
    return n if pass_depth is None else min(pass_depth, n)


def _snapshot(tbl: JobTable, pass_depth: Optional[int], order=None,
              eligible=None):
    """The queue snapshot's first ``depth`` positions and their static
    columns ``(rows, eligible, user, cpus)``, gathered once per pass; a
    position is then a one-element slice of each."""
    if order is None:
        order, eligible = queue_order(tbl)
    q = order[:_depth(tbl.cpus.shape[0], pass_depth)]
    return q, eligible[q], tbl.user[q].long(), tbl.cpus[q]


def _est_remaining(work, overhead, progress, error: float) -> torch.Tensor:
    """baselines._estimated_remaining: true remaining inflated by
    ``error``, rounded in float32 as the reference's tensor pass does."""
    rem = work + overhead - progress
    if error:
        rem = torch.ceil(rem.to(torch.float32) * (1.0 + error)).to(I32)
    return rem.clamp(min=1)


# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def make_static_partition_pass(pass_depth: Optional[int] = None):
    """Hard divisions: user blocks sized by entitlement; no pooling at all."""

    def pass_fn(cfg: SchedulerConfig, ent, t, tbl: JobTable,
                stats: Optional[PassStats] = None) -> JobTable:
        q, elig, user, cpus = _snapshot(tbl, pass_depth)
        usage, _, _ = running_usage(tbl, ent.shape[0])
        for i in range(q.shape[0]):
            idx, ju, jc = q[i:i + 1], user[i:i + 1], cpus[i:i + 1]
            admit = (elig[i:i + 1] & (tbl.state[idx] == PENDING)
                     & (usage[ju] + jc <= ent[ju]))
            admit_job(tbl, idx, t, admit)
            usage.index_add_(0, ju, torch.where(admit, jc, 0))
        return tbl

    return pass_fn


@lru_cache(maxsize=None)
def make_capping_pass(pass_depth: Optional[int] = None):
    """Pooled CPUs + per-user cap at the entitlement (no over-subscription)."""

    def pass_fn(cfg: SchedulerConfig, ent, t, tbl: JobTable,
                stats: Optional[PassStats] = None) -> JobTable:
        q, elig, user, cpus = _snapshot(tbl, pass_depth)
        usage, _, busy = running_usage(tbl, ent.shape[0])
        for i in range(q.shape[0]):
            idx, ju, jc = q[i:i + 1], user[i:i + 1], cpus[i:i + 1]
            admit = (elig[i:i + 1] & (tbl.state[idx] == PENDING)
                     & (usage[ju] + jc <= ent[ju])
                     & (cfg.cpu_total - busy >= jc))
            admit_job(tbl, idx, t, admit)
            grant = torch.where(admit, jc, 0)
            usage.index_add_(0, ju, grant)
            busy = busy + grant
        return tbl

    return pass_fn


@lru_cache(maxsize=None)
def make_fcfs_pass(pass_depth: Optional[int] = None):
    """Strict first-come-first-served: the queue head blocks everyone."""

    def pass_fn(cfg: SchedulerConfig, ent, t, tbl: JobTable,
                stats: Optional[PassStats] = None) -> JobTable:
        q, elig, _, cpus = _snapshot(tbl, pass_depth)
        _, _, busy = running_usage(tbl, ent.shape[0])
        blocked = torch.zeros(1, dtype=torch.bool, device=busy.device)
        for i in range(q.shape[0]):
            idx, jc = q[i:i + 1], cpus[i:i + 1]
            ok = elig[i:i + 1] & (tbl.state[idx] == PENDING)
            fits = cfg.cpu_total - busy >= jc
            admit = ok & ~blocked & fits
            blocked = blocked | (ok & ~fits)  # head blocked: noone overtakes
            admit_job(tbl, idx, t, admit)
            busy = busy + torch.where(admit, jc, 0)
        return tbl

    return pass_fn


@lru_cache(maxsize=None)
def make_backfill_pass(estimate_error: float = 0.0, with_cr: bool = False,
                       pass_depth: Optional[int] = None):
    """Conservative backfill; optionally with C/R preemption (Niu et al.).

    The head job's reservation is computed once per tick from estimated
    remaining runtimes (a stable sort + int32 cumsum over running jobs);
    the rest of the queue carries (busy, reservation) as tensors."""

    def pass_fn(cfg: SchedulerConfig, ent, t, tbl: JobTable,
                stats: Optional[PassStats] = None) -> JobTable:
        stats = stats if stats is not None else PassStats()
        order, eligible = queue_order(tbl)
        any_pending = eligible.any()
        running = tbl.state == RUNNING
        busy = torch.where(running, tbl.cpus, 0).sum(dtype=I32)
        idle = cfg.cpu_total - busy
        head = order[:1]
        head_cpus = tbl.cpus[head].squeeze(0)
        est = _est_remaining(tbl.work, tbl.overhead, tbl.progress,
                             estimate_error)
        head_fits = any_pending & (idle >= head_cpus)

        # Reservation: earliest tick the head fits, assuming running jobs
        # end at their estimates (baselines._reservation_time), from the
        # pre-eviction state; ties broken by job id
        key = torch.where(running, est, BIG)
        ordr = lexsort((tbl.jid, key))
        cum = idle + torch.cumsum(torch.where(running[ordr], tbl.cpus[ordr],
                                              0), 0, dtype=I32)
        crossed = cum >= head_cpus
        first = crossed.to(I32).argmax(0, keepdim=True)  # first True
        reservation = torch.where(
            crossed.any(), t + est[ordr][first],
            t + torch.where(running, est, 0).sum(dtype=I32) + 1)

        head_admit = head_fits
        if with_cr:
            # Niu et al.: preempt checkpointable *backfilled* jobs to start
            # the head now instead of waiting for the reservation.  The
            # plan is needed only where the head is pending and does not
            # fit: the pass's one host read
            stats.host_syncs += 1
            if bool(any_pending & ~head_fits):
                stats.evict_branches += 1
                evictable = (running & (tbl.jclass != NONP)
                             & ((t - tbl.run_start) >= cfg.quantum)
                             & (tbl.backfilled > 0))
                planned, enough, vorder, placement = plan_evictions(
                    cfg, tbl, evictable, idle, head_cpus)
                planned = planned & enough
                busy = busy - torch.where(planned, tbl.cpus, 0).sum(dtype=I32)
                apply_evictions(cfg, t, tbl, planned, vorder, placement)
                head_admit = enough

        admit_job(tbl, head, t, head_admit)
        busy = busy + torch.where(head_admit, head_cpus, 0)
        head_start = torch.where(any_pending & ~head_admit, reservation, BIG)

        q, elig, _, cpus = _snapshot(tbl, pass_depth, order, eligible)
        end = t + est[q]       # each queued job's estimated end if started
        for i in range(1, q.shape[0]):
            idx, jc = q[i:i + 1], cpus[i:i + 1]
            ok = elig[i:i + 1] & (tbl.state[idx] == PENDING)
            cur_idle = cfg.cpu_total - busy
            # conservative: only backfill if the head reservation is kept
            no_delay = ((end[i:i + 1] <= head_start)
                        | (cur_idle - jc >= head_cpus))
            admit = ok & (cur_idle >= jc) & no_delay
            admit_job(tbl, idx, t, admit)
            tbl.backfilled[idx] = torch.where(admit, 1, tbl.backfilled[idx])
            busy = busy + torch.where(admit, jc, 0)
        return tbl

    return pass_fn


TORCH_BASELINES = {
    "static_partition": make_static_partition_pass,
    "capping": make_capping_pass,
    "fcfs": make_fcfs_pass,
    "backfill": lambda pass_depth=None: make_backfill_pass(
        pass_depth=pass_depth),
    "backfill_cr": lambda pass_depth=None: make_backfill_pass(
        with_cr=True, pass_depth=pass_depth),
}
