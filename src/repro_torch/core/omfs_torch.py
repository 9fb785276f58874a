"""OMFS over a table of int32 tensors: the port of ``repro.core.omfs_jax``.

The scheduler state is a `JobTable` of ``[J]`` (and ``[J, T]``) int32
tensors on one device; the tick protocol lives in `core.engine`.  This
module owns the table, the primitives every vectorized policy builds on
(queue ordering, admission, victim selection, eviction) and the two OMFS
passes:

* ``make_omfs_pass(incremental=False)`` — the reference pass: every queue
  position recomputes O(J) masked usage sums and a fresh victim plan.
* ``make_omfs_pass(incremental=True)`` — the default: per-user usage
  ``[U]`` and the busy scalar are carried across admissions, and the
  victim plan runs only on the eviction branch.

The reference's ``lax.cond`` on ``need_evict`` becomes a branch on the
host: each queue position reads its job's row and the carried aggregates
back in ONE synchronisation (``PassStats.host_syncs`` counts them), so the
eviction machinery runs only where eviction is needed.  A host branch per
position rules out capturing a tick in a CUDA graph; that is left to later
work.

**In-place updates.** JAX's functions are pure and the engine donates the
table; here the run owns its table, so `admit_job`, `apply_evictions`,
`update_state_mib` and the engine's tick update its columns in place and
return the same table.  A caller that needs the input afterwards passes a
copy.

C/R costs are the ``[J, T]`` lattices ``cost_save_lat`` /
``cost_rsave_lat`` / ``cost_restore_lat``, evaluated once at table build
with Python ints through `SchedulerConfig.eviction_save_cost` and
`restart_restore_cost`: the same numbers the reference charges.

``SchedulerConfig.kernel_backend`` picks the eviction machinery:
``"cuda"`` is the fused `kernels.sched_select` plan (the Hopper kernel on
the card, its plain version on the CPU); ``"torch"`` is the eager twin of
the reference's ``"lax"`` path.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.crcost import MAX_STATE_MIB
from repro_torch.core.types import JobClass, SchedulerConfig
from repro_torch.kernels.sched_select.ref import (
    first_argmin,
    greedy_place,
    lexsort,
)

# JobState encoding (matches types.JobState)
UNSUB, PENDING, RUNNING, DONE, KILLED = 0, 1, 2, 3, 4
BIG = 2**30
NONP = int(JobClass.NON_PREEMPTIBLE)
CKPT = int(JobClass.CHECKPOINTABLE)
I32 = torch.int32


def resolve_device(device) -> torch.device:
    """The run's device; a CUDA request on a machine without CUDA raises
    rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    return dev


class JobTable(NamedTuple):
    """Static job attributes + mutable runtime state, all [J]-shaped int32."""

    jid: torch.Tensor        # job id — the tie-break identity
    user: torch.Tensor       # user index
    cpus: torch.Tensor
    work: torch.Tensor       # work units
    priority: torch.Tensor
    jclass: torch.Tensor     # JobClass
    submit: torch.Tensor     # tick
    state_mib: torch.Tensor  # checkpoint image size (MiB)
    # The [J, T] C/R cost lattice (column k prices tier k of cfg.cr_tiers,
    # T=1 untiered; tier 0 is the fastest, the last the durable spill target)
    cost_save_lat: torch.Tensor     # [J, T] FIRST-save cost per tier
    cost_rsave_lat: torch.Tensor    # [J, T] RECURRENT (delta) save cost
    cost_restore_lat: torch.Tensor  # [J, T] restore cost per tier
    # runtime
    state: torch.Tensor      # JobState
    progress: torch.Tensor
    run_start: torch.Tensor
    first_start: torch.Tensor
    finish: torch.Tensor
    n_preempt: torch.Tensor
    n_ckpt: torch.Tensor
    overhead: torch.Tensor
    backfilled: torch.Tensor  # 0/1: ever admitted by queue-jumping
    ckpt_tier: torch.Tensor   # tier holding the latest snapshot (-1: none)
    n_spill: torch.Tensor     # checkpoints placed beyond the fast tier

    # Legacy two-column accessors: read-only views over the lattice.
    @property
    def cost_save(self) -> torch.Tensor:
        """Fast-tier (tier 0) first-save cost — view of cost_save_lat."""
        return self.cost_save_lat[..., 0]

    @property
    def cost_save2(self) -> torch.Tensor:
        """Durable-tier (last) first-save cost — view of cost_save_lat."""
        return self.cost_save_lat[..., -1]

    @property
    def cost_restore(self) -> torch.Tensor:
        """Fast-tier restore cost — view of cost_restore_lat."""
        return self.cost_restore_lat[..., 0]

    @property
    def cost_restore2(self) -> torch.Tensor:
        """Durable-tier restore cost — view of cost_restore_lat."""
        return self.cost_restore_lat[..., -1]


@dataclass
class PassStats:
    """What a run's passes did on the host: synchronisations with the
    device (one per processed queue position) and eviction-branch
    entries (one victim plan each)."""

    host_syncs: int = 0
    evict_branches: int = 0


def table_from_jobs(jobs, users, cpu_total: int,
                    config: Optional[SchedulerConfig] = None,
                    device="cuda") -> Tuple[JobTable, torch.Tensor]:
    """Build ``(JobTable, entitled_cpus[U])`` from core.types objects.

    Rows are ordered by job id.  ``config`` supplies the C/R cost model:
    the lattices are evaluated here with Python integers, the exact
    arithmetic the reference charges; ``config=None`` builds a free-C/R
    table."""
    dev = resolve_device(device)
    uidx = {u.name: i for i, u in enumerate(users)}
    j = sorted(jobs, key=lambda x: x.id)
    n = len(j)
    cfg = config if config is not None else SchedulerConfig()
    n_tiers = cfg.n_cost_tiers

    def arr(f):
        return torch.tensor([f(x) for x in j], dtype=I32, device=dev)

    def lat(f):
        return torch.tensor([[f(x, k) for k in range(n_tiers)] for x in j],
                            dtype=I32, device=dev).reshape(n, n_tiers)

    def full(v):
        return torch.full((n,), v, dtype=I32, device=dev)

    table = JobTable(
        jid=arr(lambda x: x.id),
        user=arr(lambda x: uidx[x.user]),
        cpus=arr(lambda x: x.cpus),
        work=arr(lambda x: x.work),
        priority=arr(lambda x: x.priority),
        jclass=arr(lambda x: int(x.job_class)),
        submit=arr(lambda x: x.submit_time),
        state_mib=arr(lambda x: x.state_mib),
        cost_save_lat=lat(
            lambda x, k: cfg.eviction_save_cost(x.state_mib, k)),
        cost_rsave_lat=lat(
            lambda x, k: cfg.eviction_save_cost(x.state_mib, k,
                                                recurrent=True)),
        cost_restore_lat=lat(
            lambda x, k: cfg.restart_restore_cost(x.state_mib, k)),
        state=full(UNSUB),
        progress=full(0),
        run_start=full(-1),
        first_start=full(-1),
        finish=full(-1),
        n_preempt=full(0),
        n_ckpt=full(0),
        overhead=full(0),
        backfilled=arr(lambda x: int(x.backfilled)),
        ckpt_tier=full(-1),
        n_spill=full(0),
    )
    return table, entitlements(users, cpu_total, dev)


def entitlements(users, cpu_total: int, device="cuda") -> torch.Tensor:
    return torch.tensor([u.entitled_cpus(cpu_total) for u in users],
                        dtype=I32, device=resolve_device(device))


# ---------------------------------------------------------------------------
# JobTable primitives
# ---------------------------------------------------------------------------


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int):
    """int32 sum of ``vals`` per segment id (``jax.ops.segment_sum``)."""
    return torch.zeros(n, dtype=I32, device=vals.device).index_add_(
        0, seg, vals)


def queue_order(tbl: JobTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Snapshot the submitted queue: (order[J], eligible[J]).

    Order is (-priority, submit, id) with ineligible rows pushed to the
    end; the id tie-break is the ``jid`` column."""
    eligible = tbl.state == PENDING
    qkey = torch.where(eligible, -tbl.priority, BIG)
    order = lexsort((tbl.jid, tbl.submit, qkey))
    return order, eligible


def running_usage(tbl: JobTable, num_users: int):
    """Aggregates at pass start: (usage[U], non_preemptible_usage[U], busy)."""
    running = tbl.state == RUNNING
    run_cpus = torch.where(running, tbl.cpus, 0)
    usage = _segment_sum(run_cpus, tbl.user, num_users)
    nonp = _segment_sum(torch.where(running & (tbl.jclass == NONP),
                                    tbl.cpus, 0), tbl.user, num_users)
    return usage, nonp, run_cpus.sum(dtype=I32)


def admit_job(tbl: JobTable, idx: int, t: int, admit) -> JobTable:
    """Start job ``idx`` (lines 37-38) iff ``admit`` — a Python bool from
    the host branch or a 0-d bool tensor decided on the device; O(1)
    in-place writes.

    A job with a checkpoint restores its latest snapshot: admission charges
    the restore cost of the tier the snapshot was placed on (``ckpt_tier``;
    column 0 when untiered) and clears ``ckpt_tier``, freeing that tier's
    capacity."""
    if isinstance(admit, bool):
        admit = torch.full((), admit, dtype=torch.bool,
                           device=tbl.state.device)
    # a gather, not ``lat[idx, tier]``: indexing by the 0-d ``tier`` an int
    # ``idx`` gives would read it back to the host
    tier = tbl.ckpt_tier[idx].clamp(min=0)
    cost = tbl.cost_restore_lat[idx].gather(-1, tier.unsqueeze(-1))
    restore = torch.where(admit & (tbl.n_ckpt[idx] > 0), cost.squeeze(-1), 0)
    tbl.state[idx] = torch.where(admit, RUNNING, tbl.state[idx])
    tbl.run_start[idx] = torch.where(admit, t, tbl.run_start[idx])
    tbl.first_start[idx] = torch.where(admit & (tbl.first_start[idx] < 0),
                                       t, tbl.first_start[idx])
    tbl.overhead[idx] += restore
    tbl.ckpt_tier[idx] = torch.where(admit, -1, tbl.ckpt_tier[idx])
    return tbl


def effective_save_lat(tbl: JobTable) -> torch.Tensor:
    """The ``[J, T]`` save costs evicting each job *now* would charge:
    recurrent (delta) rows for warm jobs (``n_ckpt > 0``), first-save rows
    otherwise — read before the eviction bumps ``n_ckpt``."""
    return torch.where((tbl.n_ckpt > 0)[..., None],
                       tbl.cost_rsave_lat, tbl.cost_save_lat)


def tier_occupancy(tbl: JobTable, n_tiers: int) -> torch.Tensor:
    """Per-tier MiB held by evicted-and-pending snapshots, ``[T]``."""
    held = (tbl.state == PENDING) & (tbl.ckpt_tier >= 0)
    return _segment_sum(torch.where(held, tbl.state_mib, 0),
                        tbl.ckpt_tier.clamp(0, n_tiers - 1), n_tiers)


def victim_order(tbl: JobTable, cheap: bool = False) -> torch.Tensor:
    """Victim permutation.  Standard: ``(priority, run_start, id)``.
    ``cheap`` (the `omfs_cheap_victim` policy): ``(save_cost, priority,
    run_start, id)`` with the delta-aware effective tier-0 save cost."""
    if cheap:
        key = effective_save_lat(tbl)[..., 0]
        return lexsort((tbl.jid, tbl.run_start, tbl.priority, key))
    return lexsort((tbl.jid, tbl.run_start, tbl.priority))


def select_victims(tbl: JobTable, evictable: torch.Tensor, idle, cpus_needed,
                   order: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's while-loop (lines 32-36) as lexsort+cumsum: the minimal
    prefix of evictable jobs in ``order`` whose release makes
    ``cpus_needed`` fit.  Returns (planned[J], enough)."""
    if order is None:
        order = victim_order(tbl)
    evict_sorted = evictable[order]
    cpus_sorted = torch.where(evict_sorted, tbl.cpus[order], 0)
    freed_cum = torch.cumsum(cpus_sorted, 0, dtype=I32)
    need = torch.clamp(torch.as_tensor(cpus_needed - idle, dtype=I32), min=0)
    planned_sorted = evict_sorted & (freed_cum - cpus_sorted < need)
    enough = idle + freed_cum[-1] >= cpus_needed
    planned = torch.zeros_like(evictable)
    planned[order] = planned_sorted
    return planned, enough


def place_checkpoints(cfg: SchedulerConfig, tbl: JobTable, ckpt: torch.Tensor,
                      order: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tier placement for the ``ckpt`` victims: greedy cheapest-feasible
    over the T lattice columns in victim ``order``, spilling down the
    hierarchy when capacity-bounded tiers are full.  Returns
    ``(tier[J], save_cost[J])`` (0 on non-victims); ties go to the faster
    tier, the last tier is always feasible."""
    tiers = cfg.cr_tiers
    if order is None:
        order = victim_order(tbl)
    ckpt_sorted = ckpt[order]
    eff = effective_save_lat(tbl)
    lat_sorted = eff[order]
    if all(c < 0 for c in tiers.capacity_mib):
        tier_sorted = first_argmin(lat_sorted)
    else:
        tier_sorted = greedy_place(
            ckpt_sorted, tbl.state_mib[order], lat_sorted,
            tier_occupancy(tbl, tiers.n_tiers), tiers.capacity_mib)
    tier = torch.zeros_like(tbl.ckpt_tier)
    tier[order] = torch.where(ckpt_sorted, tier_sorted, 0)
    save = torch.gather(eff, 1, tier.long()[:, None])[:, 0]
    return tier, torch.where(ckpt, save, 0)


def _tiered(cfg: SchedulerConfig) -> bool:
    return cfg.cr_tiers is not None and cfg.cr_tiers.n_tiers > 1


def plan_evictions(cfg: SchedulerConfig, tbl: JobTable,
                   evictable: torch.Tensor, idle, cpus_needed,
                   cheap: bool = False, order: Optional[torch.Tensor] = None):
    """The whole per-eviction decision, dispatched on ``cfg.kernel_backend``.

    Returns ``(planned, enough, order, placement)``: the minimal victim
    prefix, the feasibility bit, the victim order to reuse downstream
    ("torch" only) and the ``(tier, save_cost)`` placement ("cuda" only;
    `apply_evictions` computes it from ``order`` when absent).

    * ``"torch"`` — `victim_order` + `select_victims`; placement deferred
      to `place_checkpoints` inside `apply_evictions`.
    * ``"cuda"`` — the fused `kernels.sched_select` plan.  Its placement is
      computed on the pre-feasibility-mask ``planned``; callers mask
      ``planned`` with an all-or-nothing scalar and every write in
      `apply_evictions` is gated on the masked set, so both backends give
      the same table."""
    if cfg.kernel_backend == "torch":
        if order is None:
            order = victim_order(tbl, cheap)
        planned, enough = select_victims(tbl, evictable, idle, cpus_needed,
                                         order)
        return planned, enough, order, None
    from repro_torch.kernels.sched_select.ops import plan_evictions_fused
    tiered = _tiered(cfg)
    eff_lat = effective_save_lat(tbl)
    if tiered:
        caps = tuple(cfg.cr_tiers.capacity_mib)
        bounded = any(c >= 0 for c in caps)
        occ = tier_occupancy(tbl, cfg.cr_tiers.n_tiers)
        is_ckpt = tbl.jclass == CKPT
    else:
        caps = (-1,)
        bounded = False
        occ = torch.zeros(1, dtype=I32, device=evictable.device)
        is_ckpt = torch.zeros_like(evictable)
        eff_lat = eff_lat[:, :1]
    planned, enough, tier = plan_evictions_fused(
        tbl.priority, tbl.run_start, tbl.jid, eff_lat[:, 0].contiguous(),
        evictable, tbl.cpus, tbl.state_mib, is_ckpt, eff_lat.contiguous(),
        idle, cpus_needed, occ, caps,
        cheap=cheap, tiered=tiered, bounded=bounded)
    placement = None
    if tiered:
        save = torch.gather(eff_lat, 1, tier.long()[:, None])[:, 0]
        placement = (tier, save)
    return planned, enough, None, placement


def apply_evictions(cfg: SchedulerConfig, t: int, tbl: JobTable,
                    planned: torch.Tensor,
                    order: Optional[torch.Tensor] = None,
                    placement: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                    ) -> JobTable:
    """Lines 33-36 for every planned victim, in place: checkpoint (or drop)
    and free.  With ``cfg.cr_tiers`` set each checkpointed victim is placed
    on a tier first (``placement`` from the fused plan, else
    `place_checkpoints` in victim ``order``) and charged that tier's save
    cost; ``ckpt_tier`` records the placement for the later restore."""
    is_ckpt = tbl.jclass == CKPT
    kill = planned & ~is_ckpt
    ckpt = planned & is_ckpt
    if _tiered(cfg):
        tier_of, save_cost = (place_checkpoints(cfg, tbl, ckpt, order)
                              if placement is None else placement)
        tbl.ckpt_tier.copy_(torch.where(ckpt, tier_of, tbl.ckpt_tier))
        tbl.n_spill.add_((ckpt & (tier_of > 0)).to(I32))
    else:
        save_cost = effective_save_lat(tbl)[..., 0]
        tbl.ckpt_tier.masked_fill_(ckpt, 0)
    tbl.overhead.add_(torch.where(ckpt, save_cost, 0))
    tbl.state.masked_fill_(ckpt, PENDING)
    tbl.state.masked_fill_(kill, KILLED if cfg.drop_killed else PENDING)
    if cfg.drop_killed:
        tbl.finish.masked_fill_(kill, t)
    else:
        tbl.progress.masked_fill_(kill, 0)
    tbl.run_start.masked_fill_(planned, -1)
    tbl.n_preempt.add_(planned.to(I32))
    tbl.n_ckpt.add_(ckpt.to(I32))
    return tbl


# ---------------------------------------------------------------------------
# Reference pass: one Algorithm-1 admission, everything recomputed (O(J))
# ---------------------------------------------------------------------------


def _hoistable(cfg: SchedulerConfig) -> bool:
    """Whether one `victim_order` per tick serves every admission.  With
    ``quantum >= 1`` mid-pass admissions and evictions only move rows *out*
    of the evictable set and untouched rows keep their keys, so the stale
    order restricted to the still-evictable rows is the fresh order;
    ``quantum == 0`` makes a just-admitted job evictable at once, so it
    keeps the per-admission recompute."""
    return cfg.quantum >= 1


def _try_admit(cfg: SchedulerConfig, ent: torch.Tensor, t: int,
               tbl: JobTable, idx, eligible: torch.Tensor,
               cheap_victims: bool = False,
               order: Optional[torch.Tensor] = None) -> JobTable:
    """Process job ``idx`` (runner, lines 18-38); no-op unless eligible and
    still pending.  Decided entirely on the device, with no branch — the
    un-optimized reference the incremental pass is tested against."""
    running = tbl.state == RUNNING
    preempt_able = tbl.jclass != NONP

    ju = tbl.user[idx]
    jc = tbl.cpus[idx]
    same_user = tbl.user == ju
    non_p_usage = torch.where(running & same_user & ~preempt_able,
                              tbl.cpus, 0).sum(dtype=I32)
    total_usage = torch.where(running & same_user, tbl.cpus, 0).sum(dtype=I32)
    busy = torch.where(running, tbl.cpus, 0).sum(dtype=I32)
    idle = cfg.cpu_total - busy
    entitled = ent[ju.long()]

    job_non_p = tbl.jclass[idx] == NONP
    # line 23 (note >=): non-preemptible beyond (or exactly at) entitlement
    reject_23 = job_non_p & (non_p_usage + jc >= entitled)
    # line 26 (note >): enough idle -> run anyways
    admit_26 = idle > jc
    # line 28: request exceeds unused entitlement
    reject_28 = jc > entitled - total_usage

    # lines 31-36: victim selection among quantum-expired running jobs
    evictable = running & preempt_able & ((t - tbl.run_start) >= cfg.quantum)
    if cfg.avoid_self_eviction:                # beyond-paper flag
        evictable = evictable & ~same_user
    if cfg.victim_filter_over_entitlement:     # beyond-paper flag
        usage_per_user = _segment_sum(torch.where(running, tbl.cpus, 0),
                                      tbl.user, ent.shape[0])
        evictable = evictable & (usage_per_user[tbl.user.long()]
                                 > ent[tbl.user.long()])

    planned, enough, order, placement = plan_evictions(
        cfg, tbl, evictable, idle, jc, cheap_victims, order)

    admit_evict = (~reject_23) & (~admit_26) & (~reject_28) & enough
    admit = eligible & (tbl.state[idx] == PENDING) & (~reject_23) & (
        admit_26 | admit_evict)
    planned = planned & admit & ~admit_26

    tbl = apply_evictions(cfg, t, tbl, planned, order, placement)
    return admit_job(tbl, idx, t, admit)


# ---------------------------------------------------------------------------
# The OMFS scheduling pass (policy contract: pass_fn(cfg, ent, t, tbl) -> tbl)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def make_omfs_pass(pass_depth: Optional[int] = None, incremental: bool = True,
                   cheap_victims: bool = False):
    """Build the Algorithm-1 scheduling pass for `core.engine`.

    ``incremental=True`` carries (usage[U], non_preemptible_usage[U], busy)
    across admissions and runs the victim plan only on the eviction branch,
    chosen on the host.  ``incremental=False`` is the reference pass.
    ``cheap_victims=True`` is the `omfs_cheap_victim` registry policy:
    victims order by ``(save_cost, priority, run_start, id)``.

    The pass takes an optional ``stats`` (`PassStats`) that it counts
    host synchronisations and eviction branches into."""

    def pass_fn(cfg: SchedulerConfig, ent: torch.Tensor, t: int,
                tbl: JobTable, stats: Optional[PassStats] = None) -> JobTable:
        stats = stats if stats is not None else PassStats()
        n = tbl.cpus.shape[0]
        order, eligible = queue_order(tbl)
        depth = n if pass_depth is None else min(pass_depth, n)

        # one victim_order per tick (see _hoistable) on the torch path; the
        # fused kernel sorts internally, so a hoisted sort would be waste
        hoist = cfg.kernel_backend == "torch" and _hoistable(cfg)
        vorder0 = victim_order(tbl, cheap_victims) if hoist else None

        if not incremental:
            for i in range(depth):
                idx = order[i]
                tbl = _try_admit(cfg, ent, t, tbl, idx, eligible[idx],
                                 cheap_victims, vorder0)
            return tbl

        usage, nonp_usage, busy = running_usage(tbl, ent.shape[0])
        # the queue snapshot's static rows: (row, eligible, user, cpus, jclass)
        q = order[:depth]
        qrows = torch.stack([q.to(I32), eligible[q].to(I32), tbl.user[q],
                             tbl.cpus[q], tbl.jclass[q]], 1)
        for i in range(depth):
            row = qrows[i]
            ix, ux = row[0:1].long(), row[2:3].long()
            # the one host synchronisation of this queue position
            (idx, elig, ju, jc, jcls, st, u_use, u_nonp, u_ent,
             b) = torch.cat([row, tbl.state[ix], usage[ux], nonp_usage[ux],
                             ent[ux], busy.view(1)]).tolist()
            stats.host_syncs += 1
            job_non_p = jcls == NONP
            idle = cfg.cpu_total - b
            # lines 23 / 26 / 28 from the carried aggregates
            reject_23 = job_non_p and u_nonp + jc >= u_ent
            admit_26 = idle > jc
            reject_28 = jc > u_ent - u_use
            ok = bool(elig) and st == PENDING and not reject_23
            if ok and admit_26:
                # idle-admit fast path: no victim machinery, O(1) updates
                admit_job(tbl, idx, t, True)
                usage[ju] += jc
                if job_non_p:
                    nonp_usage[ju] += jc
                busy = busy + jc
            elif ok and not reject_28:
                stats.evict_branches += 1
                tbl, usage, nonp_usage, busy = _evict_branch(
                    cfg, ent, t, tbl, idx, ju, jc, job_non_p, idle, usage,
                    nonp_usage, busy, cheap_victims, vorder0)
        return tbl

    return pass_fn


def _evict_branch(cfg, ent, t, tbl, idx, ju, jc, job_non_p, idle, usage,
                  nonp_usage, busy, cheap_victims, vorder0):
    """The eviction branch of one queue position (lines 31-38), decided on
    the device: plan the victims, evict them iff the plan is enough, admit
    ``idx`` on the same condition, and update the carried aggregates."""
    running = tbl.state == RUNNING
    preempt_able = tbl.jclass != NONP
    evictable = running & preempt_able & ((t - tbl.run_start) >= cfg.quantum)
    if cfg.avoid_self_eviction:            # beyond-paper flag
        evictable = evictable & (tbl.user != ju)
    if cfg.victim_filter_over_entitlement:  # beyond-paper flag
        users = tbl.user.long()
        evictable = evictable & (usage[users] > ent[users])
    planned, enough, vorder, placement = plan_evictions(
        cfg, tbl, evictable, idle, jc, cheap_victims, vorder0)
    planned = planned & enough
    freed = torch.where(planned, tbl.cpus, 0)
    usage = usage - _segment_sum(freed, tbl.user, ent.shape[0])
    busy = busy - freed.sum(dtype=I32)
    tbl = apply_evictions(cfg, t, tbl, planned, vorder, placement)
    tbl = admit_job(tbl, idx, t, enough)
    grant = torch.where(enough, jc, 0)
    usage[ju] += grant
    if job_non_p:
        nonp_usage[ju] += grant
    return tbl, usage, nonp_usage, busy + grant


def update_state_mib(tbl: JobTable, idx: int, state_mib: int,
                     config: SchedulerConfig) -> JobTable:
    """Grow/shrink job ``idx``'s checkpoint image at runtime, in place.

    Rewrites ``state_mib`` and re-evaluates the row's cost lattice with the
    same integer arithmetic `table_from_jobs` used (Python ints)."""
    mib = min(max(int(state_mib), 0), MAX_STATE_MIB)
    flat = config.cr_overhead
    models = [config.tier_model(k) for k in range(config.n_cost_tiers)]
    dev = tbl.state_mib.device

    def row(vals):
        return torch.tensor(vals, dtype=I32, device=dev)

    tbl.state_mib[idx] = mib
    tbl.cost_save_lat[idx] = row([flat + m.save_cost(mib) for m in models])
    tbl.cost_rsave_lat[idx] = row(
        [flat + m.recurrent_save_cost(mib) for m in models])
    tbl.cost_restore_lat[idx] = row([m.restore_cost(mib) for m in models])
    return tbl


def signature_from_table(tbl: JobTable):
    """Same shape as the reference's ``signature_from_table``."""
    cols = {f: getattr(tbl, f).cpu().tolist()
            for f in ("state", "first_start", "finish", "progress",
                      "n_preempt", "n_ckpt")}
    return tuple(
        (i, cols["state"][i], cols["first_start"][i], cols["finish"][i],
         cols["progress"][i], cols["n_preempt"][i], cols["n_ckpt"][i])
        for i in range(len(cols["state"])))


def tables_equal(a: JobTable, b: JobTable) -> bool:
    """Fast whole-table schedule equality (the fields of the signature)."""
    fields = ("state", "first_start", "finish", "progress", "n_preempt",
              "n_ckpt")
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in fields)
