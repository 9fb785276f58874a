"""The baseline policies over the torch `JobTable`: the port of
``repro.core.policies_jax``.

Twins of `core.baselines` (static_partition / capping / fcfs / backfill /
backfill_cr), built from the OMFS pass's primitives (`core.omfs_torch`:
queue_order, queue_snapshot, running_usage, admit_job, plan_evictions,
apply_evictions).  Every pass follows the engine's contract ``pass_fn(cfg,
ent, t, tbl, stats=None, knobs=None) -> tbl``, updates ``tbl`` in place
and runs over ``[B, J]`` tables (a ``[J]`` table is the batch of one,
`omfs_torch.batched_pass`); ``knobs`` carries each cell's quantum and
pass depth, positions past a cell's depth masked in its snapshot (the
reference's ``_mask_depth``).

**Admissions are decided on the device.**  The reference's ``fori_loop``
carries (usage, busy, blocked, head reservation) as arrays; here they are
``[B]``/``[B, U]`` tensors too, each queue position is one row of the
position-major snapshot (no 0-d index, which torch's indexing would read
back to the host) and `admit_job` takes the admission as a ``[B]`` bool
tensor.  No pass reads the device per queue position.  The one host read
is backfill_cr's, once per tick: which cells' queue heads are pending and
do not fit, where Niu et al.'s C/R preemption needs an eviction plan (one
batched `plan_evictions` over those cells, the `sched_select` kernel
under ``kernel_backend="cuda"``).  ``stats`` (`PassStats`) counts that
read in ``host_syncs`` and each cell's plan in ``evict_branches``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from repro_torch.core.omfs_torch import (
    BIG,
    I32,
    PENDING,
    RUNNING,
    JobTable,
    Knobs,
    PassStats,
    _flat,
    _note_branches,
    admit_job,
    apply_evictions,
    batched_pass,
    evictable_mask,
    pass_depth_of,
    plan_evictions,
    queue_order,
    queue_snapshot,
    running_usage,
)
from repro_torch.core.types import SchedulerConfig
from repro_torch.kernels.sched_select.ref import lexsort


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

    @batched_pass
    def pass_fn(cfg: SchedulerConfig, ent, t, tbl: JobTable,
                stats: PassStats, knobs: Optional[Knobs]) -> JobTable:
        snap = queue_snapshot(tbl, ent.shape[1], pass_depth_of(
            tbl.cpus.shape[1], pass_depth, knobs), knobs)
        usage = running_usage(tbl, ent.shape[1])[0].view(-1)
        ent_flat = ent.view(-1)
        for i in range(snap.rows.shape[0]):
            rows, users, jc = snap.rows[i], snap.users[i], snap.cpus[i]
            admit = (snap.elig[i] & (_flat(tbl.state)[rows] == PENDING)
                     & (usage[users] + jc <= ent_flat[users]))
            admit_job(tbl, rows, t, admit)
            usage.index_add_(0, users, torch.where(admit, jc, 0))
        return tbl

    return pass_fn


@lru_cache(maxsize=None)
def make_capping_pass(pass_depth: Optional[int] = None):
    """Pooled CPUs + per-user cap at the entitlement (no over-subscription)."""

    @batched_pass
    def pass_fn(cfg: SchedulerConfig, ent, t, tbl: JobTable,
                stats: PassStats, knobs: Optional[Knobs]) -> JobTable:
        snap = queue_snapshot(tbl, ent.shape[1], pass_depth_of(
            tbl.cpus.shape[1], pass_depth, knobs), knobs)
        usage, _, busy = running_usage(tbl, ent.shape[1])
        usage, ent_flat = usage.view(-1), ent.view(-1)
        for i in range(snap.rows.shape[0]):
            rows, users, jc = snap.rows[i], snap.users[i], snap.cpus[i]
            admit = (snap.elig[i] & (_flat(tbl.state)[rows] == PENDING)
                     & (usage[users] + jc <= ent_flat[users])
                     & (cfg.cpu_total - busy >= jc))
            admit_job(tbl, rows, t, admit)
            grant = torch.where(admit, jc, 0)
            usage.index_add_(0, users, grant)
            busy = busy + grant
        return tbl

    return pass_fn


@lru_cache(maxsize=None)
def make_fcfs_pass(pass_depth: Optional[int] = None):
    """Strict first-come-first-served: the queue head blocks everyone."""

    @batched_pass
    def pass_fn(cfg: SchedulerConfig, ent, t, tbl: JobTable,
                stats: PassStats, knobs: Optional[Knobs]) -> JobTable:
        snap = queue_snapshot(tbl, ent.shape[1], pass_depth_of(
            tbl.cpus.shape[1], pass_depth, knobs), knobs)
        _, _, busy = running_usage(tbl, ent.shape[1])
        blocked = torch.zeros_like(busy, dtype=torch.bool)
        for i in range(snap.rows.shape[0]):
            rows, jc = snap.rows[i], snap.cpus[i]
            ok = snap.elig[i] & (_flat(tbl.state)[rows] == PENDING)
            fits = cfg.cpu_total - busy >= jc
            admit = ok & ~blocked & fits
            blocked = blocked | (ok & ~fits)  # head blocked: noone overtakes
            admit_job(tbl, rows, t, admit)
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

    @batched_pass
    def pass_fn(cfg: SchedulerConfig, ent, t, tbl: JobTable,
                stats: PassStats, knobs: Optional[Knobs]) -> JobTable:
        order, eligible = queue_order(tbl)
        n = tbl.cpus.shape[1]
        any_pending = eligible.any(-1)
        running = tbl.state == RUNNING
        busy = torch.where(running, tbl.cpus, 0).sum(-1, dtype=I32)
        idle = cfg.cpu_total - busy
        cell = torch.arange(order.shape[0], device=order.device)
        head = order[:, 0] + cell * n        # the head's flat row
        head_cpus = _flat(tbl.cpus)[head]
        est = _est_remaining(tbl.work, tbl.overhead, tbl.progress,
                             estimate_error)
        head_fits = any_pending & (idle >= head_cpus)

        # Reservation: earliest tick the head fits, assuming running jobs
        # end at their estimates (baselines._reservation_time), from the
        # pre-eviction state; ties broken by job id
        key = torch.where(running, est, BIG)
        ordr = lexsort((tbl.jid, key))
        cum = idle.unsqueeze(1) + torch.cumsum(
            torch.where(running.gather(1, ordr), tbl.cpus.gather(1, ordr), 0),
            1, dtype=I32)
        crossed = cum >= head_cpus.unsqueeze(1)
        first = crossed.to(I32).argmax(1, keepdim=True)  # first True
        reservation = torch.where(
            crossed.any(1), t + est.gather(1, ordr).gather(1, first)[:, 0],
            t + torch.where(running, est, 0).sum(1, dtype=I32) + 1)

        head_admit = head_fits
        if with_cr:
            # Niu et al.: preempt checkpointable *backfilled* jobs to start
            # the head now instead of waiting for the reservation.  The
            # plan is needed only where the head is pending and does not
            # fit: the pass's one host read, a bit per cell
            need = any_pending & ~head_fits
            cells = [b for b, x in enumerate(need.tolist()) if x]  # analysis: ignore[host-read] -- counted in PassStats.host_syncs
            stats.host_syncs += 1
            if cells:
                _note_branches(stats, cells)
                evictable = (evictable_mask(cfg, tbl, t, knobs)
                             & (tbl.backfilled > 0))
                planned, enough, vorder, placement = plan_evictions(
                    cfg, tbl, evictable, idle, head_cpus, cells=cells)
                do_cr = need & enough
                planned = planned & do_cr.unsqueeze(1)
                busy = busy - torch.where(planned, tbl.cpus,
                                          0).sum(1, dtype=I32)
                apply_evictions(cfg, t, tbl, planned, vorder, placement)
                head_admit = head_fits | do_cr

        admit_job(tbl, head, t, head_admit)
        busy = busy + torch.where(head_admit, head_cpus, 0)
        head_start = torch.where(any_pending & ~head_admit, reservation, BIG)

        snap = queue_snapshot(tbl, ent.shape[1],
                              pass_depth_of(n, pass_depth, knobs), knobs,
                              order, eligible)
        # each queued job's estimated end if started
        end = t + _flat(est)[snap.rows]
        backfilled = _flat(tbl.backfilled)
        for i in range(1, snap.rows.shape[0]):
            rows, jc = snap.rows[i], snap.cpus[i]
            ok = snap.elig[i] & (_flat(tbl.state)[rows] == PENDING)
            cur_idle = cfg.cpu_total - busy
            # conservative: only backfill if the head reservation is kept
            no_delay = (end[i] <= head_start) | (cur_idle - jc >= head_cpus)
            admit = ok & (cur_idle >= jc) & no_delay
            admit_job(tbl, rows, t, admit)
            backfilled[rows] = torch.where(admit, 1, backfilled[rows])
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
