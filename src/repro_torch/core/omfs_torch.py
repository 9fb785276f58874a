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

**A batch axis.** Every primitive and pass works over ``[B, J]`` columns
(``[B, J, T]`` lattices, ``[B, U]`` entitlements): B independent tables,
the reference's ``jax.vmap`` written out.  A ``[J]`` table runs as the
batch of one (`batched_pass`), so the sequential engine and
``engine.simulate_batch`` share one implementation of each pass.  Per-cell
quantum and pass depth ride `Knobs`.

The reference's ``lax.cond`` on ``need_evict`` becomes a branch on the
host: each queue position decides every cell's branch on the device and
reads the ``[2, B]`` decision back in ONE synchronisation
(``PassStats.host_syncs`` counts them), so the eviction machinery runs
only where a cell needs it, as one batched plan over those cells.  A host
branch per position rules out capturing a tick in a CUDA graph; that is
left to later work.

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
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core.crcost import MAX_STATE_MIB
from repro_torch.core.types import JobClass, SchedulerConfig
from repro_torch.kernels.sched_select import ref as sched_ref
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
    device (one per processed queue position, whatever the batch) and
    eviction-branch entries (one victim plan per cell that takes one).
    ``cell_branches``, when a list, gets each cell's branches too
    (``engine.simulate_batch``); ``table_reads`` counts the stream
    engine's table reads at its segment boundaries, and ``place_reads``
    the reads of ``kernel_backend="torch"``'s bounded tier placement
    (`kernels.sched_select.ref.greedy_place`, on the host: one or two
    per cell a plan places; the kernel places on the card)."""

    host_syncs: int = 0
    evict_branches: int = 0
    cell_branches: Optional[List[int]] = None
    table_reads: int = 0
    place_reads: int = 0


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

    # a lattice row is a function of the image size alone: evaluated once
    # per distinct size (a fleet of 100k jobs has ~7k)
    mibs = [x.state_mib for x in j]

    def lat(f):
        rows = {m: [f(m, k) for k in range(n_tiers)] for m in set(mibs)}
        return torch.tensor([rows[m] for m in mibs],
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
        state_mib=torch.tensor(mibs, dtype=I32, device=dev),
        cost_save_lat=lat(lambda m, k: cfg.eviction_save_cost(m, k)),
        cost_rsave_lat=lat(
            lambda m, k: cfg.eviction_save_cost(m, k, recurrent=True)),
        cost_restore_lat=lat(lambda m, k: cfg.restart_restore_cost(m, k)),
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
# Batch stacking and the stream engine's slot scatter
# ---------------------------------------------------------------------------

#: pad-row values per column; unlisted columns pad with 0.  A pad row is
#: inert: ``submit=BIG`` never arrives (it stays UNSUB), ``cpus=0`` moves no
#: aggregate, ``jid=BIG`` sorts it last in every tie-break.
_PAD_VALUES = {"jid": BIG, "submit": BIG, "run_start": -1,
               "first_start": -1, "finish": -1, "ckpt_tier": -1}


def pad_table(tbl: JobTable, rows: int) -> JobTable:
    """Grow a ``[J]`` table to ``rows`` with inert pad rows (the same table
    if equal)."""
    n = tbl.cpus.shape[0]
    if rows == n:
        return tbl
    if rows < n:
        raise ValueError(f"cannot shrink a table of {n} rows to {rows}")
    return JobTable(*(
        torch.cat([col, torch.full((rows - n,) + col.shape[1:],
                                   _PAD_VALUES.get(f, 0), dtype=I32,
                                   device=col.device)])
        for f, col in zip(JobTable._fields, tbl)))


def is_pad(tbl: JobTable) -> torch.Tensor:
    """Mask of inert pad rows (see ``_PAD_VALUES``)."""
    return (tbl.jid == BIG) & (tbl.submit == BIG)


def stack_tables(tables, ents) -> Tuple[JobTable, torch.Tensor]:
    """Stack per-cell ``(JobTable[Ji], ent[Ui])`` pairs onto a leading batch
    axis: tables padded to max(Ji) rows (`pad_table`) and entitlements to
    max(Ui) users with 0 CPUs (a user that owns no row).  Pad rows are
    never eligible, never running and sort last, so no cell's schedule
    changes."""
    rows = max(t.cpus.shape[0] for t in tables)
    n_users = max(e.shape[0] for e in ents)
    padded = [pad_table(t, rows) for t in tables]
    ents = [torch.cat([e, e.new_zeros(n_users - e.shape[0])]) for e in ents]
    return (JobTable(*(torch.stack(cols) for cols in zip(*padded))),
            torch.stack(ents))


def insert_rows(tbl: JobTable, slots, rows: JobTable, valid) -> JobTable:
    """The stream engine's slot scatter, in place: row ``tbl[slots[i]]``
    becomes ``rows[i]`` where ``valid[i]``, else stays.  ``slots`` is built
    on the host (a sequence, numpy array or CPU tensor) and must be a
    permutation of ``arange(J)``, so no two writes meet; anything else
    raises.  ``valid`` is ``[J]`` bool, host or device."""
    if isinstance(slots, torch.Tensor) and slots.device.type != "cpu":
        raise TypeError("slots are checked on the host: pass them from the "
                        "CPU")
    host = np.asarray(slots)
    n = tbl.cpus.shape[0]
    if host.shape != (n,) or not np.array_equal(np.sort(host), np.arange(n)):
        raise ValueError(f"slots must be a permutation of arange({n})")
    dev = tbl.cpus.device
    idx = torch.as_tensor(host, dtype=torch.long).to(dev)
    keep = torch.as_tensor(valid, dtype=torch.bool).to(dev)
    for col, new in zip(tbl, rows):
        v = keep.view((-1,) + (1,) * (col.dim() - 1))
        col[idx] = torch.where(v, new, col[idx])
    return tbl


class Knobs(NamedTuple):
    """Per-cell scheduling knobs of a batch (``engine.simulate_batch``):
    ``quantum`` overrides ``cfg.quantum`` and ``depth`` bounds each cell's
    queue sweep, positions past it masked (the reference's traced
    `Knobs`).  ``depth`` is known on the host (the loop bound is a host
    int) and ``depth_t`` is its copy on the device."""

    quantum: torch.Tensor          # int32 [B] on the table's device
    depth: Tuple[int, ...]         # per cell; BIG sweeps the whole queue
    depth_t: torch.Tensor          # int32 [B], the same on the device


def make_knobs(quantum: Sequence[int], depth: Sequence[Optional[int]],
               device="cuda") -> Knobs:
    """Knobs from per-cell host values (``None`` depth: the whole queue);
    one copy to the device each."""
    dev = resolve_device(device)
    d = tuple(BIG if x is None else int(x) for x in depth)
    return Knobs(torch.tensor([int(q) for q in quantum], dtype=I32,
                              device=dev), d,
                 torch.tensor(d, dtype=I32, device=dev))


def default_knobs(cfg: SchedulerConfig, pass_depth: Optional[int] = None,
                  batch: int = 1, device="cuda") -> Knobs:
    """``batch`` cells at ``cfg.quantum`` and ``pass_depth``."""
    return make_knobs([cfg.quantum] * batch, [pass_depth] * batch, device)


# ---------------------------------------------------------------------------
# JobTable primitives, over [J] or [B, J] columns
# ---------------------------------------------------------------------------


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int):
    """int32 sums of ``vals`` per segment id along the last axis
    (``jax.ops.segment_sum``): ``[J] -> [n]`` or ``[B, J] -> [B, n]``."""
    if vals.dim() == 1:
        return torch.zeros(n, dtype=I32, device=vals.device).index_add_(
            0, seg, vals)
    b = vals.shape[0]
    cell = torch.arange(b, device=vals.device).unsqueeze(1) * n
    return torch.zeros(b * n, dtype=I32, device=vals.device).index_add_(
        0, (seg + cell).reshape(-1), vals.reshape(-1)).view(b, n)


def queue_order(tbl: JobTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Snapshot the submitted queue: (order[..., J], eligible[..., J]).

    Order is (-priority, submit, id) with ineligible rows pushed to the
    end; the id tie-break is the ``jid`` column."""
    eligible = tbl.state == PENDING
    qkey = torch.where(eligible, -tbl.priority, BIG)
    order = lexsort((tbl.jid, tbl.submit, qkey))
    return order, eligible


def running_usage(tbl: JobTable, num_users: int):
    """Aggregates at pass start: (usage[..., U], non_preemptible_usage[...,
    U], busy[...])."""
    running = tbl.state == RUNNING
    run_cpus = torch.where(running, tbl.cpus, 0)
    usage = _segment_sum(run_cpus, tbl.user, num_users)
    nonp = _segment_sum(torch.where(running & (tbl.jclass == NONP),
                                    tbl.cpus, 0), tbl.user, num_users)
    return usage, nonp, run_cpus.sum(-1, dtype=I32)


class Snapshot(NamedTuple):
    """The first ``depth`` positions of every cell's queue snapshot,
    position-major (``[D, B]``), so that a position is one contiguous row
    of each.  Rows index the flattened ``[B * J]`` table and users the
    flattened ``[B * U]`` aggregates; ``elig`` is False past a cell's
    ``Knobs.depth`` (the reference's ``_mask_depth``)."""

    q: torch.Tensor          # [D, B] long: the row within its cell
    rows: torch.Tensor       # [D, B] long: the row of the flattened table
    elig: torch.Tensor       # [D, B] bool
    users: torch.Tensor      # [D, B] long: the user of the flattened [B*U]
    cpus: torch.Tensor       # [D, B] int32


def queue_snapshot(tbl: JobTable, n_users: int, depth: int,
                   knobs: Optional[Knobs] = None, order=None,
                   eligible=None) -> Snapshot:
    """Gather the `Snapshot` of a ``[B, J]`` table once per pass."""
    if order is None:
        order, eligible = queue_order(tbl)
    b, n = tbl.cpus.shape
    q = order[:, :depth]
    cell = torch.arange(b, device=q.device).unsqueeze(1)
    elig = eligible.gather(1, q)
    if knobs is not None:
        pos = torch.arange(q.shape[1], device=q.device)
        elig = elig & (pos < knobs.depth_t.unsqueeze(1))
    users = tbl.user.gather(1, q).long() + cell * n_users

    def pm(x):
        return x.t().contiguous()

    return Snapshot(pm(q), pm(q + cell * n), pm(elig), pm(users),
                    pm(tbl.cpus.gather(1, q)))


def _flat(col: torch.Tensor) -> torch.Tensor:
    """A ``[B, J]`` (or ``[B, J, T]``) column as ``[B * J]`` (``[B * J,
    T]``) rows: a view, so writes land in the table."""
    return col.view(-1) if col.dim() == 2 else col.view(-1, col.shape[-1])


def admit_job(tbl: JobTable, rows: torch.Tensor, t: int,
              admit: torch.Tensor) -> JobTable:
    """Start job ``rows[b]`` of each cell (lines 37-38) where ``admit[b]``:
    ``rows`` index the flattened ``[B * J]`` table (`Snapshot.rows`),
    ``admit`` is ``[B]`` bool decided on the device; O(B) in-place writes.

    A job with a checkpoint restores its latest snapshot: admission charges
    the restore cost of the tier the snapshot was placed on (``ckpt_tier``;
    column 0 when untiered) and clears ``ckpt_tier``, freeing that tier's
    capacity."""
    state, tier_col = _flat(tbl.state), _flat(tbl.ckpt_tier)
    run_start, first = _flat(tbl.run_start), _flat(tbl.first_start)
    overhead = _flat(tbl.overhead)
    # a gather of the tier's column, read on the device
    tier = tier_col[rows].clamp(min=0)
    cost = _flat(tbl.cost_restore_lat)[rows].gather(-1, tier.unsqueeze(-1))
    restore = torch.where(admit & (_flat(tbl.n_ckpt)[rows] > 0),
                          cost.squeeze(-1), 0)
    state[rows] = torch.where(admit, RUNNING, state[rows])
    run_start[rows] = torch.where(admit, t, run_start[rows])
    first[rows] = torch.where(admit & (first[rows] < 0), t, first[rows])
    overhead[rows] += restore
    tier_col[rows] = torch.where(admit, -1, tier_col[rows])
    return tbl


def effective_save_lat(tbl: JobTable) -> torch.Tensor:
    """The ``[..., J, T]`` save costs evicting each job *now* would charge:
    recurrent (delta) rows for warm jobs (``n_ckpt > 0``), first-save rows
    otherwise — read before the eviction bumps ``n_ckpt``."""
    return torch.where((tbl.n_ckpt > 0)[..., None],
                       tbl.cost_rsave_lat, tbl.cost_save_lat)


def tier_occupancy(tbl: JobTable, n_tiers: int) -> torch.Tensor:
    """Per-tier MiB held by evicted-and-pending snapshots, ``[..., T]``."""
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
    """The paper's while-loop (lines 32-36) as lexsort+cumsum, per cell: the
    minimal prefix of evictable jobs in ``order`` whose release makes
    ``cpus_needed`` fit.  ``idle``/``cpus_needed`` are ``[B]``.  Returns
    (planned[B, J], enough[B])."""
    if order is None:
        order = victim_order(tbl)
    evict_sorted = evictable.gather(-1, order)
    cpus_sorted = torch.where(evict_sorted, tbl.cpus.gather(-1, order), 0)
    freed_cum = torch.cumsum(cpus_sorted, -1, dtype=I32)
    need = torch.clamp(cpus_needed - idle, min=0)
    planned_sorted = evict_sorted & (freed_cum - cpus_sorted
                                     < need.unsqueeze(-1))
    enough = idle + freed_cum[..., -1] >= cpus_needed
    planned = torch.zeros_like(evictable).scatter_(-1, order, planned_sorted)
    return planned, enough


def place_checkpoints(cfg: SchedulerConfig, tbl: JobTable, ckpt: torch.Tensor,
                      order: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tier placement for the ``ckpt`` victims, per cell: greedy
    cheapest-feasible over the T lattice columns in victim ``order``,
    spilling down the hierarchy when capacity-bounded tiers are full.
    Returns ``(tier[B, J], save_cost[B, J])`` (0 on non-victims); ties go
    to the faster tier, the last tier is always feasible."""
    tiers = cfg.cr_tiers
    if order is None:
        order = victim_order(tbl)
    ckpt_sorted = ckpt.gather(-1, order)
    eff = effective_save_lat(tbl)
    lat_sorted = eff.gather(
        -2, order.unsqueeze(-1).expand(-1, -1, eff.shape[-1]))
    if all(c < 0 for c in tiers.capacity_mib):
        tier_sorted = first_argmin(lat_sorted)
    else:
        occ = tier_occupancy(tbl, tiers.n_tiers)
        mib_sorted = tbl.state_mib.gather(-1, order)
        tier_sorted = torch.stack([
            greedy_place(ckpt_sorted[b], mib_sorted[b], lat_sorted[b],
                         occ[b], tiers.capacity_mib)
            for b in range(order.shape[0])])
    tier = torch.zeros_like(tbl.ckpt_tier).scatter_(
        -1, order, torch.where(ckpt_sorted, tier_sorted, 0))
    save = eff.gather(-1, tier.long().unsqueeze(-1)).squeeze(-1)
    return tier, torch.where(ckpt, save, 0)


def _tiered(cfg: SchedulerConfig) -> bool:
    return cfg.cr_tiers is not None and cfg.cr_tiers.n_tiers > 1


def plan_evictions(cfg: SchedulerConfig, tbl: JobTable,
                   evictable: torch.Tensor, idle, cpus_needed,
                   cheap: bool = False, order: Optional[torch.Tensor] = None,
                   cells: Optional[Sequence[int]] = None):
    """The whole per-eviction decision for the cells of a ``[B, J]`` table,
    dispatched on ``cfg.kernel_backend``; ``idle``/``cpus_needed`` are
    ``[B]`` int32 tensors and ``cells`` the host list of the cells that
    need the plan (default all; the others' outputs are not used).

    Returns ``(planned, enough, order, placement)``: the minimal victim
    prefix, the feasibility bit, the victim order to reuse downstream
    ("torch" only) and the ``(tier, save_cost)`` placement ("cuda" only;
    `apply_evictions` computes it from ``order`` when absent).

    * ``"torch"`` — `victim_order` + `select_victims` over every cell;
      placement deferred to `place_checkpoints` inside `apply_evictions`.
    * ``"cuda"`` — the fused `kernels.sched_select` plan of ``cells``, one
      batched launch.  Its placement is computed on the
      pre-feasibility-mask ``planned``; callers mask ``planned`` with an
      all-or-nothing bit per cell and every write in `apply_evictions` is
      gated on the masked set, so both backends give the same table."""
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
        occ = torch.zeros((evictable.shape[0], 1), dtype=I32,
                          device=evictable.device)
        is_ckpt = torch.zeros_like(evictable)
        eff_lat = eff_lat[..., :1]
    planned, enough, tier = plan_evictions_fused(
        tbl.priority, tbl.run_start, tbl.jid, eff_lat[..., 0].contiguous(),
        evictable, tbl.cpus, tbl.state_mib, is_ckpt, eff_lat.contiguous(),
        idle, cpus_needed, occ, caps,
        cheap=cheap, tiered=tiered, bounded=bounded, cells=cells)
    placement = None
    if tiered:
        save = torch.gather(eff_lat, -1, tier.long().unsqueeze(-1))
        placement = (tier, save.squeeze(-1))
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


def evictable_mask(cfg: SchedulerConfig, tbl: JobTable, t: int,
                   knobs: Optional[Knobs] = None) -> torch.Tensor:
    """Running, preemptible and past the quantum (per cell under
    ``knobs``): the victims' candidates before the beyond-paper filters."""
    quantum = cfg.quantum if knobs is None else knobs.quantum.unsqueeze(1)
    return ((tbl.state == RUNNING) & (tbl.jclass != NONP)
            & ((t - tbl.run_start) >= quantum))


def _note_branches(stats: PassStats, cells: Sequence[int]) -> None:
    stats.evict_branches += len(cells)
    if stats.cell_branches is not None:
        for b in cells:
            stats.cell_branches[b] += 1


def batched_pass(pass_fn):
    """A pass written over ``[B, J]`` tables that also takes a ``[J]``
    table (with ``[U]`` entitlements) as the batch of one: its columns are
    viewed as ``[1, J]``, so the in-place updates land in the caller's
    table."""

    def run(cfg: SchedulerConfig, ent: torch.Tensor, t: int, tbl: JobTable,
            stats: Optional[PassStats] = None,
            knobs: Optional[Knobs] = None) -> JobTable:
        stats = stats if stats is not None else PassStats()
        # under "cuda" the placement's only caller is the kernel's plain
        # version on CPU tensors, which stands in for the kernel
        reads = sched_ref.HOST_READS
        if tbl.cpus.dim() == 1:
            pass_fn(cfg, ent.unsqueeze(0), t,
                    JobTable(*(c.unsqueeze(0) for c in tbl)), stats, knobs)
        else:
            tbl = pass_fn(cfg, ent, t, tbl, stats, knobs)
        if cfg.kernel_backend == "torch":
            stats.place_reads += sched_ref.HOST_READS - reads
        return tbl

    return run


def pass_depth_of(n: int, pass_depth: Optional[int],
                  knobs: Optional[Knobs]) -> int:
    """Queue positions a pass visits: the factory's ``pass_depth``, and
    under ``knobs`` no further than the deepest cell (the reference's
    truncation at the batch-wide maximum when every cell caps its depth);
    positions past a cell's own depth are masked in its `Snapshot`."""
    depth = n if pass_depth is None else min(pass_depth, n)
    return depth if knobs is None else min(depth, max(knobs.depth))


# ---------------------------------------------------------------------------
# Reference pass: one Algorithm-1 admission, everything recomputed (O(J))
# ---------------------------------------------------------------------------


def _hoistable(cfg: SchedulerConfig, knobs: Optional[Knobs]) -> bool:
    """Whether one `victim_order` per tick serves every admission.  With
    ``quantum >= 1`` mid-pass admissions and evictions only move rows *out*
    of the evictable set and untouched rows keep their keys, so the stale
    order restricted to the still-evictable rows is the fresh order;
    ``quantum == 0`` makes a just-admitted job evictable at once, so it
    keeps the per-admission recompute, and so does a batch under
    ``knobs``, as the reference's does."""
    return knobs is None and cfg.quantum >= 1


def _try_admit(cfg: SchedulerConfig, ent: torch.Tensor, t: int,
               tbl: JobTable, rows: torch.Tensor, eligible: torch.Tensor,
               cheap_victims: bool = False, knobs: Optional[Knobs] = None,
               order: Optional[torch.Tensor] = None) -> JobTable:
    """Process job ``rows[b]`` of each cell (runner, lines 18-38); no-op
    unless eligible and still pending.  Decided entirely on the device,
    with no branch — the un-optimized reference the incremental pass is
    tested against."""
    running = tbl.state == RUNNING
    preempt_able = tbl.jclass != NONP

    ju = _flat(tbl.user)[rows]
    jc = _flat(tbl.cpus)[rows]
    same_user = tbl.user == ju.unsqueeze(1)
    non_p_usage = torch.where(running & same_user & ~preempt_able,
                              tbl.cpus, 0).sum(-1, dtype=I32)
    total_usage = torch.where(running & same_user, tbl.cpus,
                              0).sum(-1, dtype=I32)
    busy = torch.where(running, tbl.cpus, 0).sum(-1, dtype=I32)
    idle = cfg.cpu_total - busy
    entitled = ent.gather(1, ju.long().unsqueeze(1)).squeeze(1)

    job_non_p = _flat(tbl.jclass)[rows] == NONP
    # line 23 (note >=): non-preemptible beyond (or exactly at) entitlement
    reject_23 = job_non_p & (non_p_usage + jc >= entitled)
    # line 26 (note >): enough idle -> run anyways
    admit_26 = idle > jc
    # line 28: request exceeds unused entitlement
    reject_28 = jc > entitled - total_usage

    # lines 31-36: victim selection among quantum-expired running jobs
    evictable = evictable_mask(cfg, tbl, t, knobs)
    if cfg.avoid_self_eviction:                # beyond-paper flag
        evictable = evictable & ~same_user
    if cfg.victim_filter_over_entitlement:     # beyond-paper flag
        users = tbl.user.long()
        usage_per_user = _segment_sum(torch.where(running, tbl.cpus, 0),
                                      tbl.user, ent.shape[1])
        evictable = evictable & (usage_per_user.gather(1, users)
                                 > ent.gather(1, users))

    planned, enough, order, placement = plan_evictions(
        cfg, tbl, evictable, idle, jc, cheap_victims, order)

    admit_evict = (~reject_23) & (~admit_26) & (~reject_28) & enough
    admit = eligible & (_flat(tbl.state)[rows] == PENDING) & (~reject_23) & (
        admit_26 | admit_evict)
    planned = planned & (admit & ~admit_26).unsqueeze(1)

    tbl = apply_evictions(cfg, t, tbl, planned, order, placement)
    return admit_job(tbl, rows, t, admit)


# ---------------------------------------------------------------------------
# The OMFS scheduling pass (policy contract:
# pass_fn(cfg, ent, t, tbl, stats=None, knobs=None) -> tbl)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def make_omfs_pass(pass_depth: Optional[int] = None, incremental: bool = True,
                   cheap_victims: bool = False):
    """Build the Algorithm-1 scheduling pass for `core.engine`, over
    ``[B, J]`` tables (a ``[J]`` table is the batch of one).

    ``incremental=True`` carries (usage[B, U], non_preemptible_usage[B, U],
    busy[B]) across admissions; at each queue position every cell's branch
    (idle-admit, evict, nothing) is decided on the device and read back in
    one synchronisation, and the victim plan runs only for the cells that
    evict.  ``incremental=False`` is the reference pass.
    ``cheap_victims=True`` is the `omfs_cheap_victim` registry policy:
    victims order by ``(save_cost, priority, run_start, id)``.

    The pass takes an optional ``stats`` (`PassStats`) that it counts
    host synchronisations and eviction branches into, and optional
    per-cell ``knobs``."""

    @batched_pass
    def pass_fn(cfg: SchedulerConfig, ent: torch.Tensor, t: int,
                tbl: JobTable, stats: PassStats,
                knobs: Optional[Knobs]) -> JobTable:
        order, eligible = queue_order(tbl)
        n_users = ent.shape[1]
        depth = pass_depth_of(tbl.cpus.shape[1], pass_depth, knobs)
        snap = queue_snapshot(tbl, n_users, depth, knobs, order, eligible)

        # one victim_order per tick (see _hoistable) on the torch path, made
        # at the tick's first eviction branch; the fused kernel sorts
        # internally, so a hoisted sort would be waste
        hoist = cfg.kernel_backend == "torch" and _hoistable(cfg, knobs)
        vorder0 = None

        if not incremental:
            if hoist:
                vorder0 = victim_order(tbl, cheap_victims)
            for i in range(depth):
                tbl = _try_admit(cfg, ent, t, tbl, snap.rows[i],
                                 snap.elig[i], cheap_victims, knobs, vorder0)
            return tbl

        usage, nonp_usage, busy = running_usage(tbl, n_users)
        usage, nonp_usage = usage.view(-1), nonp_usage.view(-1)
        # the snapshot's static thresholds of lines 23 / 26 / 28, so that a
        # position compares the carried aggregates once each
        job_non_p = _flat(tbl.jclass)[snap.rows] == NONP
        room = ent.view(-1)[snap.users] - snap.cpus     # entitled - jc
        reject_23_at = torch.where(job_non_p, room, BIG)
        admit_26_below = cfg.cpu_total - snap.cpus      # idle > jc
        for i in range(depth):
            rows, users, jc = snap.rows[i], snap.users[i], snap.cpus[i]
            ok = (snap.elig[i] & (_flat(tbl.state)[rows] == PENDING)
                  & (nonp_usage[users] < reject_23_at[i]))
            admit_26 = busy < admit_26_below[i]
            fast = ok & admit_26
            evict = ok & ~admit_26 & (usage[users] <= room[i])
            # the one host synchronisation of this queue position
            fast_h, evict_h = torch.stack(  # analysis: ignore[host-read] -- counted in PassStats.host_syncs
                [fast, evict]).tolist()
            stats.host_syncs += 1
            if any(fast_h):
                # idle-admit: no victim machinery, O(B) updates
                admit_job(tbl, rows, t, fast)
                grant = torch.where(fast, jc, 0)
                usage.index_add_(0, users, grant)
                nonp_usage.index_add_(
                    0, users, torch.where(job_non_p[i], grant, 0))
                busy = busy + grant
            cells = [b for b, e in enumerate(evict_h) if e]
            if cells:
                _note_branches(stats, cells)
                busy, vorder0 = _evict_branch(
                    cfg, ent, t, tbl, rows, users, jc, job_non_p[i], evict,
                    cells, busy, usage, nonp_usage, cheap_victims, knobs,
                    vorder0, hoist)
        return tbl

    return pass_fn


def _evict_branch(cfg, ent, t, tbl, rows, users, jc, job_non_p, branch,
                  cells, busy, usage, nonp_usage, cheap_victims, knobs,
                  vorder0, hoist):
    """The eviction branch of one queue position (lines 31-38) for the
    cells in ``branch`` (``cells`` on the host), decided on the device:
    plan their victims in one batched plan, evict them iff a cell's plan
    is enough, admit its job on the same condition, and update the carried
    aggregates (in place).  With ``hoist`` the tick's first branch makes
    the victim order that its later branches reuse.  Returns ``(busy,
    vorder0)``."""
    if hoist and vorder0 is None:
        vorder0 = victim_order(tbl, cheap_victims)
    evictable = evictable_mask(cfg, tbl, t, knobs)
    if cfg.avoid_self_eviction:            # beyond-paper flag
        evictable = evictable & (tbl.user != _flat(tbl.user)[rows]
                                 .unsqueeze(1))
    if cfg.victim_filter_over_entitlement:  # beyond-paper flag
        u = tbl.user.long()
        evictable = evictable & (usage.view(ent.shape).gather(1, u)
                                 > ent.gather(1, u))
    idle = cfg.cpu_total - busy
    planned, enough, vorder, placement = plan_evictions(
        cfg, tbl, evictable, idle, jc.contiguous(), cheap_victims, vorder0,
        cells)
    go = enough & branch
    planned = planned & go.unsqueeze(1)
    freed = torch.where(planned, tbl.cpus, 0)
    usage.sub_(_segment_sum(freed, tbl.user, ent.shape[1]).view(-1))
    busy = busy - freed.sum(-1, dtype=I32)
    apply_evictions(cfg, t, tbl, planned, vorder, placement)
    admit_job(tbl, rows, t, go)
    grant = torch.where(go, jc, 0)
    usage.index_add_(0, users, grant)
    nonp_usage.index_add_(0, users, torch.where(job_non_p, grant, 0))
    return busy + grant, vorder0


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
    cols = {f: getattr(tbl, f).cpu().tolist()  # analysis: ignore[host-read] -- host epilogue, once a run
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
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())  # analysis: ignore[host-read] -- host comparison, once a call
               for f in fields)
