"""The scheduling engine: the port of ``repro.core.engine``, one tick
protocol, pluggable policies, two backends.

The tick protocol is the reference's:

  1. arrivals   — jobs with ``submit_time <= t`` become PENDING,
  2. progress   — every running job accrues one work unit; completed jobs
                  free their CPUs,
  3. scheduling — one policy pass over the pending-queue snapshot,
  4. metrics    — per-tick busy CPUs (and per-user usage on the host).

``tick_python`` runs it over `core.types.ClusterState` with any Python
policy (`core.omfs.scheduler_pass`, `core.baselines.*`, or a callable);
``tick_torch`` runs the same semantics over the tensor `JobTable`
(`core.omfs_torch`) on its device with a registered pass.

``simulate(users, jobs, cfg, horizon, policy=..., backend=...)`` is the
entry point: every registered policy runs on both backends ("torch", the
default, on ``device``; "python", the host reference), and
`EngineResult.signature()` is comparable across backends and with the
reference engine's results.  ``simulate_matrix`` runs many policies over
one built table.

Two engines build on the same tick: ``simulate_batch`` runs many
independent cells (workload x policy x quantum x pass depth) as ``[B, J]``
tables, one batch per policy (the reference's ``jax.vmap`` with a
``lax.switch`` over policies, written out), and ``simulate_stream`` runs
unbounded arrivals through a fixed-capacity table in segments, compacting
finished rows out on the host between them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import omfs_torch, policies_torch
from repro_torch.core.baselines import ALL_BASELINES
from repro_torch.core.omfs import Decision, cheap_victim_pass, scheduler_pass
from repro_torch.core.omfs_torch import (I32, JobTable, Knobs, PassStats,
                                         resolve_device)
from repro_torch.core.types import (
    ClusterState,
    Job,
    JobState,
    SchedulerConfig,
    User,
)

PythonPolicy = Callable[[ClusterState], List[Decision]]
# tensor policy contract: pass_fn(cfg, entitled[U], t, JobTable, stats,
# knobs=None), over [J] tables or [B, J] batches (entitled [B, U])
TorchPass = Callable[..., JobTable]
TorchPassFactory = Callable[[Optional[int]], TorchPass]


# ---------------------------------------------------------------------------
# Policy registry: every policy names its Python pass and its tensor-pass
# factory
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PolicySpec:
    name: str
    python_pass: PythonPolicy
    torch_factory: TorchPassFactory


POLICIES: Dict[str, PolicySpec] = {}


def register_policy(name: str, python_pass: PythonPolicy,
                    torch_factory: TorchPassFactory) -> PolicySpec:
    spec = PolicySpec(name, python_pass, torch_factory)
    POLICIES[name] = spec
    return spec


register_policy("omfs", scheduler_pass,
                lambda pass_depth=None: omfs_torch.make_omfs_pass(pass_depth))
# beyond-paper OMFS variant: evict the cheapest-to-checkpoint first
register_policy(
    "omfs_cheap_victim", cheap_victim_pass,
    lambda pass_depth=None: omfs_torch.make_omfs_pass(pass_depth,
                                                      cheap_victims=True))
for _name, _factory in policies_torch.TORCH_BASELINES.items():
    register_policy(_name, ALL_BASELINES[_name], _factory)


def _check_name(policy) -> None:
    if policy not in POLICIES:
        raise ValueError(
            f"unknown policy {policy!r}; known: {sorted(POLICIES)}")


def _resolve_python(policy: Union[str, PythonPolicy]) -> PythonPolicy:
    if callable(policy):
        return policy
    _check_name(policy)
    return POLICIES[policy].python_pass


# ---------------------------------------------------------------------------
# The tick — Python backend
# ---------------------------------------------------------------------------


def tick_python(
    state: ClusterState,
    policy: PythonPolicy,
    *,
    work_fn: Optional[Callable[[Job], None]] = None,
    on_complete: Optional[Callable[[Job], None]] = None,
) -> Tuple[List[Decision], List[Tuple[Job, JobState, JobState]]]:
    """One tick at ``state.time``: arrivals -> progress -> policy pass.

    ``work_fn(job)`` is called for each running job before its progress
    accrues; ``on_complete`` fires when a job finishes.  Returns the pass's
    decisions plus the state transitions it caused, ``[(job, was, now),
    ...]``."""
    t = state.time
    # 1. arrivals
    for j in state.jobs.values():
        if j.state == JobState.UNSUBMITTED and j.submit_time <= t:
            j.state = JobState.PENDING
    # 2. progress + completions (jobs that ran during the previous tick)
    for j in state.running_jobs():
        if work_fn is not None:
            work_fn(j)
        j.progress += 1
        if j.progress >= j.work + j.overhead:
            j.state = JobState.DONE
            j.finish_time = t
            if on_complete is not None:
                on_complete(j)
    # 3. scheduling pass, with transition capture
    pre = {jid: j.state for jid, j in state.jobs.items()}
    decisions = policy(state)
    transitions = [
        (j, pre[jid], j.state)
        for jid, j in state.jobs.items() if j.state != pre[jid]
    ]
    return decisions, transitions


# ---------------------------------------------------------------------------
# The tick — torch backend (same steps over the JobTable, in place)
# ---------------------------------------------------------------------------


def tick_torch(cfg: SchedulerConfig, ent: torch.Tensor, tbl: JobTable,
               t: int, policy_pass: TorchPass,
               stats: Optional[PassStats] = None,
               knobs: Optional[Knobs] = None) -> JobTable:
    """One tick at ``t`` (steps 1-3), updating ``tbl`` in place; a
    ``[B, J]`` table ticks every cell (``knobs``: their quantum and pass
    depth)."""
    # 1. arrivals
    tbl.state.masked_fill_((tbl.state == omfs_torch.UNSUB)
                           & (tbl.submit <= t), omfs_torch.PENDING)
    # 2. progress + completions
    running = tbl.state == omfs_torch.RUNNING
    tbl.progress.add_(running.to(I32))
    done = running & (tbl.progress >= tbl.work + tbl.overhead)
    tbl.state.masked_fill_(done, omfs_torch.DONE)
    tbl.finish.masked_fill_(done, t)
    # 3. scheduling pass over the submitted queue snapshot
    return policy_pass(cfg, ent, t, tbl, stats, knobs)


def _tick_step(cfg: SchedulerConfig, ent: torch.Tensor, tbl: JobTable,
               t: int, pass_fn: TorchPass,
               stats: Optional[PassStats] = None,
               knobs: Optional[Knobs] = None):
    """The tick plus the per-tick busy reduction (protocol step 4), one
    int32 per cell."""
    tbl = tick_torch(cfg, ent, tbl, t, pass_fn, stats, knobs)
    busy = torch.where(tbl.state == omfs_torch.RUNNING, tbl.cpus,
                       0).sum(-1, dtype=I32)
    return tbl, busy


def run_torch(users: List[User], jobs: List[Job], cfg: SchedulerConfig,
              horizon: int, pass_fn: TorchPass, device="cuda",
              stats: Optional[PassStats] = None
              ) -> Tuple[JobTable, torch.Tensor]:
    """Run ``horizon`` ticks; returns (final JobTable, busy[t] int32 on the
    device).  The table is built for the run and updated in place."""
    tbl, ent = omfs_torch.table_from_jobs(jobs, users, cfg.cpu_total, cfg,
                                          device)
    return run_table(cfg, ent, tbl, horizon, pass_fn, stats=stats)


def run_table(cfg: SchedulerConfig, ent: torch.Tensor, tbl: JobTable,
              horizon: int, pass_fn: TorchPass, t0: int = 0,
              stats: Optional[PassStats] = None,
              knobs: Optional[Knobs] = None
              ) -> Tuple[JobTable, torch.Tensor]:
    """Ticks ``t0 .. t0 + horizon - 1`` over an existing table (a run
    resumed from a carried-over state, or a stream's segment), in place.
    Returns ``(tbl, busy[..., T])``: one series per cell of a batch."""
    lead = tbl.cpus.shape[:-1]
    busy = torch.zeros(lead + (horizon,), dtype=I32, device=tbl.cpus.device)
    if tbl.cpus.shape[-1] == 0:
        return tbl, busy
    for i in range(horizon):
        tbl, busy[..., i] = _tick_step(cfg, ent, tbl, t0 + i, pass_fn, stats,
                                       knobs)
    return tbl, busy


def run_table_events(cfg: SchedulerConfig, ent: torch.Tensor, tbl: JobTable,
                     horizon: int, pass_fn: TorchPass, ring_size: int,
                     t0: int = 0, stats: Optional[PassStats] = None,
                     knobs: Optional[Knobs] = None):
    """`run_table` plus the per-tick event capture (`obs.torch_capture`):
    the same ticks, each wrapped by a copy of the columns the capture
    diffs and its ``(counts[E], ring[R, 3], dropped)``, stacked on the
    device.  Returns ``(tbl, busy[..., T], counts[..., T, E],
    ring[..., T, R, 3], dropped[..., T])`` (the leading axes a batch's);
    nothing is read back per tick."""
    from repro_torch.obs import torch_capture
    from repro_torch.obs.events import N_EVENT_TYPES

    dev = tbl.cpus.device
    lead = tbl.cpus.shape[:-1]
    busy = torch.zeros(lead + (horizon,), dtype=I32, device=dev)
    counts = torch.zeros(lead + (horizon, N_EVENT_TYPES), dtype=I32,
                         device=dev)
    ring = torch.full(lead + (horizon, ring_size,
                              len(torch_capture.RING_FIELDS)),
                      -1, dtype=I32, device=dev)
    dropped = torch.zeros(lead + (horizon,), dtype=I32, device=dev)
    if tbl.cpus.shape[-1] == 0:
        return tbl, busy, counts, ring, dropped
    for i in range(horizon):
        t = t0 + i
        pre = torch_capture.snapshot(tbl)
        tbl, busy[..., i] = _tick_step(cfg, ent, tbl, t, pass_fn, stats,
                                       knobs)
        (counts[..., i, :], ring[..., i, :, :],
         dropped[..., i]) = torch_capture.capture_tick(pre, tbl, t,
                                                       ring_size)
    return tbl, busy, counts, ring, dropped


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclass
class TickLog:
    time: int
    busy: int
    pending: int
    running: int
    per_user_cpus: Dict[str, int]
    decisions: List[Decision]


@dataclass
class SimResult:
    state: ClusterState
    log: List[TickLog]

    # -- headline metrics (see core.metrics for derived scores) ------------
    def utilization(self) -> float:
        cfg = self.state.config
        if not self.log:
            return 0.0
        return float(np.mean([t.busy for t in self.log]) / cfg.cpu_total)

    def job_table(self) -> List[Job]:
        return sorted(self.state.jobs.values(), key=lambda j: j.id)

    def schedule_signature(self):
        """Hashable summary used by the cross-backend equivalence tests."""
        return tuple(
            (j.id, int(j.state), j.first_start, j.finish_time, j.progress,
             j.n_preemptions, j.n_checkpoints)
            for j in self.job_table()
        )


@dataclass
class EngineResult:
    """Simulation outcome from `simulate`, either backend."""

    policy: str
    config: SchedulerConfig
    table: Optional[JobTable] = None        # torch backend
    busy: Optional[np.ndarray] = None       # busy[t], both backends
    stats: PassStats = field(default_factory=PassStats)
    backend: str = "torch"
    sim: Optional[SimResult] = None         # python backend
    #: host wall seconds: "build" (table from jobs) and "ticks" (the run,
    #: up to the busy series on the host); "decode" with record_events
    seconds: Dict[str, float] = field(default_factory=dict)
    stream_stats: Optional[Dict[str, int]] = None   # simulate_stream only
    # -- observability (record_events=True); see repro_torch.obs -----------
    events: Optional[list] = None                      # List[obs.Event]
    event_counts: Optional[np.ndarray] = None          # [T, N_EVENT_TYPES]
    events_dropped: Optional[np.ndarray] = None        # [T] ring overflow

    def busy_series(self) -> np.ndarray:
        return np.asarray(self.busy)

    def events_dropped_total(self) -> int:
        if self.events_dropped is None:
            return 0
        return int(np.asarray(self.events_dropped).sum())

    def utilization(self) -> float:
        b = self.busy_series()
        return float(b.mean() / self.config.cpu_total) if b.size else 0.0

    def signature(self):
        """Id-free schedule signature, comparable across backends and
        with the reference's."""
        if self.sim is not None:
            return tuple(s[1:] for s in self.sim.schedule_signature())
        return tuple(s[1:] for s in
                     omfs_torch.signature_from_table(self.table))

    def summary(self) -> Dict[str, float]:
        """Utilization / wait / preemption counts plus goodput (cpu-ticks
        that advanced useful work, per machine capacity) and the fraction
        of executed cpu-ticks wasted on C/R overhead or killed jobs."""
        if self.sim is not None:
            jobs = self.sim.job_table()
            t = {
                "first_start": [j.first_start for j in jobs],
                "submit": [j.submit_time for j in jobs],
                "n_preempt": [j.n_preemptions for j in jobs],
                "n_ckpt": [j.n_checkpoints for j in jobs],
                "n_spill": [j.n_spills for j in jobs],
                "state": [int(j.state) for j in jobs],
                "progress": [j.progress for j in jobs],
                "work": [j.work for j in jobs],
                "cpus": [j.cpus for j in jobs]}
            t = {k: np.asarray(v, dtype=np.int64) for k, v in t.items()}
        else:
            t = {f: getattr(self.table, f).cpu().numpy()
                 for f in ("first_start", "submit", "n_preempt", "n_ckpt",
                           "n_spill", "state", "progress", "work", "cpus")}
        started = t["first_start"] >= 0
        waits = (t["first_start"] - t["submit"])[started]
        was_killed = t["state"] == omfs_torch.KILLED
        progress = t["progress"].astype(np.int64)
        cpus = t["cpus"].astype(np.int64)
        # useful = progress toward `work` (overhead units come on top and
        # count as waste); killed jobs' entire progress is lost work
        useful = np.where(was_killed, 0,
                          np.minimum(progress, t["work"])) * cpus
        executed = progress * cpus
        wasted = executed.sum() - useful.sum()
        horizon = max(self.busy_series().size, 1)
        return {
            "policy": self.policy,
            "backend": self.backend,
            "utilization": self.utilization(),
            "goodput": float(useful.sum())
            / float(self.config.cpu_total * horizon),
            "wasted_frac": float(wasted) / float(max(executed.sum(), 1)),
            "mean_wait": float(np.mean(waits)) if len(waits) else 0.0,
            "preemptions": int(t["n_preempt"].sum()),
            "checkpoints": int(t["n_ckpt"].sum()),
            "spills": int(t["n_spill"].sum()),
            "killed": int(was_killed.sum()),
            "done": int((t["state"] == omfs_torch.DONE).sum()),
        }


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


def _simulate_python(users, jobs, config, horizon, policy, record_events):
    """The host reference: ``tick_python`` over a `ClusterState`, with an
    `obs.bus.EventBus` tick diff when ``record_events``."""
    pol = _resolve_python(policy)
    name = policy if isinstance(policy, str) else getattr(
        policy, "__name__", "custom")
    state = ClusterState(config=config, users={u.name: u for u in users})
    for j in sorted(jobs, key=lambda x: x.id):
        j = j.clone()
        j.state = JobState.UNSUBMITTED
        state.jobs[j.id] = j
    bus = None
    if record_events:
        from repro_torch.obs.bus import EventBus
        bus = EventBus()
    log: List[TickLog] = []
    t0 = time.perf_counter()
    for t in range(horizon):
        state.time = t
        if bus is not None:
            bus.snapshot(state.jobs)
        decisions, _ = tick_python(state, pol)
        if bus is not None:
            bus.record_tick(state.jobs, t)
        # 4. metrics
        per_user = {u: 0 for u in state.users}
        for j in state.running_jobs():
            per_user[j.user] += j.cpus
        log.append(TickLog(
            time=t, busy=state.cpu_busy(),
            pending=len(state.pending_jobs()),
            running=len(state.running_jobs()),
            per_user_cpus=per_user, decisions=decisions,
        ))
    res = EngineResult(
        policy=name, config=config, backend="python",
        sim=SimResult(state=state, log=log),
        busy=np.asarray([tl.busy for tl in log], dtype=np.int64),
        seconds={"ticks": time.perf_counter() - t0})
    if bus is not None:
        res.events = bus.events
        res.event_counts = bus.counts_matrix(horizon)
        res.events_dropped = bus.dropped_series(horizon)
    return res


def simulate(users: List[User], jobs: List[Job], config: SchedulerConfig,
             horizon: int, policy: Union[str, PythonPolicy] = "omfs",
             backend: str = "torch", *,
             pass_depth: Optional[int] = None,
             device="cuda",
             record_events: bool = False,
             event_ring: Optional[int] = None) -> EngineResult:
    """Run ``policy`` for ``horizon`` ticks on ``backend``.

    ``backend="torch"`` (the default) runs the registered policy's tensor
    pass over a `JobTable` on ``device``, which defaults to the card and
    raises where CUDA is absent; ``pass_depth`` bounds its per-tick queue
    sweep (SLURM's sched_max_job_start; None sweeps the whole queue).
    ``backend="python"`` runs the host reference, and takes a registry
    name or any ``ClusterState -> List[Decision]`` callable.

    ``record_events=True`` also captures the typed per-job lifecycle event
    log (`repro_torch.obs`): on the python backend through an
    `obs.bus.EventBus` tick diff, on the torch backend on the device with
    a bounded per-tick ring (``event_ring`` overrides its capacity; the
    default `obs.events.lossless_ring_size` can never drop — any overflow
    of a smaller ring lands in ``EngineResult.events_dropped``), decoded
    once after the run."""
    if backend == "python":
        return _simulate_python(users, jobs, config, horizon, policy,
                                record_events)
    if backend != "torch":
        raise ValueError(
            f"unknown backend {backend!r}; use 'torch' or 'python'")
    if not isinstance(policy, str):
        raise ValueError(
            "the torch backend needs a registered policy name, got a "
            f"callable; known: {sorted(POLICIES)}")
    _check_name(policy)
    pass_fn = POLICIES[policy].torch_factory(pass_depth)
    stats = PassStats()
    t0 = time.perf_counter()
    tbl, ent = omfs_torch.table_from_jobs(jobs, users, config.cpu_total,
                                          config, device)
    t1 = time.perf_counter()
    res = EngineResult(policy=policy, config=config, stats=stats)
    if not record_events:
        tbl, busy = run_table(config, ent, tbl, horizon, pass_fn,
                              stats=stats)
        res.table, res.busy = tbl, busy.cpu().numpy()
        res.seconds = {"build": t1 - t0, "ticks": time.perf_counter() - t1}
        return res
    from repro_torch.obs import torch_capture
    from repro_torch.obs.events import lossless_ring_size

    ring_size = (lossless_ring_size(tbl.cpus.shape[0]) if event_ring is None
                 else event_ring)
    tbl, busy, counts, ring, dropped = run_table_events(
        config, ent, tbl, horizon, pass_fn, ring_size, stats=stats)
    res.table, res.busy = tbl, busy.cpu().numpy()
    t2 = time.perf_counter()
    res.event_counts = counts.cpu().numpy().astype(np.int64)
    res.events_dropped = dropped.cpu().numpy().astype(np.int64)
    res.events = torch_capture.decode_events(res.event_counts, ring,
                                             res.events_dropped)
    res.seconds = {"build": t1 - t0, "ticks": t2 - t1,
                   "decode": time.perf_counter() - t2}
    return res


# ---------------------------------------------------------------------------
# Multi-policy matrix: one built table, a copy per policy
# ---------------------------------------------------------------------------


def simulate_matrix(users: List[User], jobs: List[Job],
                    config: SchedulerConfig, horizon: int,
                    policies: Optional[List[str]] = None, *,
                    pass_depth: Optional[int] = None,
                    device="cuda") -> List[EngineResult]:
    """Run many registered policies on the torch backend over ONE table
    build: each policy runs on its own copy of the built table (the run
    updates it in place).  Per-policy results are bit-identical to
    ``simulate(..., backend="torch")``; the saving is the table build,
    which dominates a large fleet's set-up."""
    names = list(policies) if policies is not None else sorted(POLICIES)
    unknown = [n for n in names if n not in POLICIES]
    if unknown:
        raise ValueError(
            f"unknown policies {unknown}; known: {sorted(POLICIES)}")
    t0 = time.perf_counter()
    built, ent = omfs_torch.table_from_jobs(jobs, users, config.cpu_total,
                                            config, device)
    build_s = time.perf_counter() - t0
    out = []
    for name in names:
        stats = PassStats()
        t1 = time.perf_counter()
        tbl = JobTable(*(c.clone() for c in built))
        tbl, busy = run_table(config, ent, tbl, horizon,
                              POLICIES[name].torch_factory(pass_depth),
                              stats=stats)
        out.append(EngineResult(
            policy=name, config=config, table=tbl, busy=busy.cpu().numpy(),
            stats=stats, seconds={"build": build_s,
                                  "ticks": time.perf_counter() - t1}))
    return out


# ---------------------------------------------------------------------------
# Batched sweep engine: many independent cells as [B, J] tables
# ---------------------------------------------------------------------------


@dataclass
class BatchCell:
    """One cell of a `simulate_batch` sweep: a workload (scenario x seed),
    a registered policy, and optional overrides of ``cfg.quantum`` and the
    full-queue sweep, carried per cell as `omfs_torch.Knobs`."""

    users: List[User]
    jobs: List[Job]
    policy: str = "omfs"
    quantum: Optional[int] = None
    pass_depth: Optional[int] = None


def simulate_batch(
    cells: List[BatchCell],
    config: SchedulerConfig,
    horizon: int,
    *,
    devices: Optional[int] = None,
    record_events: bool = False,
    event_ring: Optional[int] = None,
    device="cuda",
) -> List[EngineResult]:
    """Run ``B`` independent simulations as batches over ``[B, J]`` tables.

    Every cell's table is padded to the batch's largest (inert rows, see
    `omfs_torch.stack_tables`) and its entitlements to its group's most
    users; the cells of one policy are stacked and run as one batch for the
    whole
    horizon, each with its quantum and pass depth as `omfs_torch.Knobs`
    (the reference's ``lax.switch`` over policies becomes one batch per
    policy: the cells are independent, so the results are the same).  At
    a queue position the OMFS passes read every cell's branch in one host
    synchronisation and plan the cells that evict in one batched
    `sched_select` launch, so a tick makes as many host syncs as the
    group's deepest cell has positions, whatever its size.  Per-cell
    results are bit-identical to ``simulate`` with the matching config,
    and to the reference's ``simulate_batch``; each result's ``stats``
    holds its group's host syncs and its own eviction branches.

    ``devices=None`` or 1 runs the batch on ``device``.  ``devices=n``
    splits it over ``min(n, len(cells))`` devices of ``device``'s type
    (the reference's batch axis over its mesh): the cells are padded to a
    multiple of that with replicas of the last cell (dropped from the
    results) and cut into contiguous groups, group i on ``cuda:(j + i)``
    from the given ``cuda:j`` (``cuda`` is ``cuda:0``); on the CPU the
    groups run one after another on the one CPU device (the stand-in for
    XLA's host device count).  Cards past ``torch.cuda.device_count()``
    raise ValueError.  Every group pads to the whole batch's largest table
    and depth, so a cell's result is the same for every n, bit for bit;
    its ``stats`` hold its group's host syncs.  Empty
    corners match the sequential paths: ``cells == []`` returns ``[]``,
    a batch whose tables are all empty takes ``simulate``'s early return,
    and a mixed batch keeps its empty cells as all-pad tables.  Runs on
    ``device``, the card by default."""
    cells = list(cells)
    if not cells:
        return []
    names = sorted({c.policy for c in cells})
    unknown = [n for n in names if n not in POLICIES]
    if unknown:
        raise ValueError(
            f"unknown policies {unknown}; known: {sorted(POLICIES)}")
    dev = resolve_device(device)
    n_dev = 1 if devices is None else int(devices)
    first = dev.index or 0
    if n_dev < 1 or (n_dev > 1 and dev.type == "cuda"
                     and first + n_dev > torch.cuda.device_count()):
        raise ValueError(
            f"devices={devices} from {dev}: this machine has "
            f"{torch.cuda.device_count() if dev.type == 'cuda' else 1} "
            f"{dev.type} device(s) to split a batch over")
    n_dev = min(n_dev, len(cells))
    n_cells = len(cells)
    cells = cells + [cells[-1]] * ((-n_cells) % n_dev)
    per = len(cells) // n_dev
    devs = [torch.device("cuda", first + i) if n_dev > 1
            and dev.type == "cuda" else dev for i in range(n_dev)]
    # each distinct workload is built once per device and shared by its
    # cells
    built, memo = [], {}
    t0 = time.perf_counter()
    for k, c in enumerate(cells):
        key = (id(c.users), id(c.jobs), k // per)
        if key not in memo:
            memo[key] = omfs_torch.table_from_jobs(
                c.jobs, c.users, config.cpu_total, config, devs[k // per])
        built.append(memo[key])
    build_s = time.perf_counter() - t0
    sizes = [t.cpus.shape[0] for t, _ in built]
    if max(sizes) == 0:
        # all-empty batch: the early return simulate takes
        out = [EngineResult(policy=c.policy, config=config, table=t,
                            busy=np.zeros(horizon, np.int32),
                            seconds={"build": build_s, "ticks": 0.0})
               for c, (t, _) in zip(cells, built)]
        if record_events:
            from repro_torch.obs.events import N_EVENT_TYPES
            for r in out:
                r.events = []
                r.event_counts = np.zeros((horizon, N_EVENT_TYPES), np.int64)
                r.events_dropped = np.zeros(horizon, np.int64)
        return out[:n_cells]

    rows = max(sizes)
    ring_size = None
    if record_events:
        from repro_torch.obs import torch_capture
        from repro_torch.obs.events import lossless_ring_size
        ring_size = (lossless_ring_size(rows) if event_ring is None
                     else event_ring)
    # the cells' depths bound every group's loop alike: the batch-wide
    # deepest when each cell caps its depth, else the whole queue
    depths = [c.pass_depth for c in cells]
    bound = None if any(d is None for d in depths) else max(depths)
    out: List[Optional[EngineResult]] = [None] * len(cells)
    for name, lo in ((n, i * per) for i in range(n_dev) for n in names):
        group = [k for k in range(lo, lo + per) if cells[k].policy == name]
        if not group:
            continue
        tbl, ent = omfs_torch.stack_tables(
            [omfs_torch.pad_table(built[k][0], rows) for k in group],
            [built[k][1] for k in group])
        knobs = omfs_torch.make_knobs(
            [config.quantum if cells[k].quantum is None else cells[k].quantum
             for k in group], [cells[k].pass_depth for k in group],
            tbl.cpus.device)
        stats = PassStats(cell_branches=[0] * len(group))
        pass_fn = POLICIES[name].torch_factory(bound)
        t1 = time.perf_counter()
        if record_events:
            tbl, busy, counts, ring, dropped = run_table_events(
                config, ent, tbl, horizon, pass_fn, ring_size, stats=stats,
                knobs=knobs)
            counts = counts.cpu().numpy().astype(np.int64)
            dropped = dropped.cpu().numpy().astype(np.int64)
        else:
            tbl, busy = run_table(config, ent, tbl, horizon, pass_fn,
                                  stats=stats, knobs=knobs)
        busy = busy.cpu().numpy()
        ticks_s = time.perf_counter() - t1
        for g, k in enumerate(group):
            # the cell's rows: rows never move in the table
            res = EngineResult(
                policy=name, config=config,
                table=JobTable(*(c[g, :sizes[k]] for c in tbl)),
                busy=busy[g],
                stats=PassStats(stats.host_syncs, stats.cell_branches[g],
                                place_reads=stats.place_reads),
                seconds={"build": build_s, "ticks": ticks_s})
            if record_events:
                res.event_counts = counts[g]
                res.events_dropped = dropped[g]
                res.events = torch_capture.decode_events(
                    counts[g], ring[g], dropped[g])
            out[k] = res
    return out[:n_cells]


# ---------------------------------------------------------------------------
# Chunked-epoch streaming engine: unbounded arrivals at bounded memory
# ---------------------------------------------------------------------------


def _table_to_host(tbl: JobTable) -> Dict[str, np.ndarray]:
    """The whole table in ONE read: its columns packed into one int32
    block on the device, then split on the host."""
    n = tbl.cpus.shape[0]
    block = torch.cat([c.reshape(n, -1) for c in tbl], 1).cpu().numpy()  # analysis: ignore[host-read] -- counted in PassStats.table_reads
    out, at = {}, 0
    for f, c in zip(JobTable._fields, tbl):
        w = 1 if c.dim() == 1 else c.shape[1]
        out[f] = block[:, at:at + w].reshape(c.shape)
        at += w
    return out


def simulate_stream(
    users: List[User],
    jobs,
    config: SchedulerConfig,
    horizon: int,
    policy: str = "omfs",
    *,
    capacity: int,
    segment_len: int,
    pass_depth: Optional[int] = None,
    record_events: bool = False,
    event_ring: Optional[int] = None,
    profile=None,
    device="cuda",
) -> EngineResult:
    """Run an arrival *stream* through a fixed-``capacity`` table in
    ``segment_len``-tick segments: unbounded workloads at bounded memory
    (the reference's ``simulate_stream``).

    ``jobs`` is any iterable of `core.types.Job` in ascending
    ``(submit_time, id)`` order (`core.workload.arrival_stream` sorts a
    list; `core.workload.endless_arrivals` generates forever).  Each
    segment:

      1. host boundary: pull every job due before the segment's end from
         the iterator, read the table back (one read, counted in
         ``stats.table_reads``), archive its finished (DONE/KILLED) rows on
         the host, and scatter the arrivals into the freed slots
         (`omfs_torch.insert_rows`, in place on the device).  Arrivals
         land as UNSUBMITTED rows and fire at their true submit tick, so
         inserting a segment early changes nothing.
      2. `run_table` from the segment's start tick.

    When every due arrival finds a slot (live jobs never exceed
    ``capacity``), the merged result (archive and live rows in ``jid``
    order) is bit-identical to the monolithic ``simulate`` over the same
    jobs: queue and victim tie-breaks ride the ``jid`` column, not the
    row.  When slots run out, surplus arrivals are DEFERRED to a later
    boundary; ``stream_stats["deferrals"]`` counts those events and
    ``"dropped"`` the arrivals still waiting at the end.  Jobs submitted
    at or after ``horizon`` stay in the iterator.

    ``record_events`` captures the lifecycle log per segment with true job
    ids.  ``profile`` (an `obs.profile.ProfileTimers`) is charged three
    sections: ``compile`` (the segment during which the `sched_select`
    kernel library was built or loaded), ``dispatch`` (the other
    segments, each ending in a synchronisation when profiled) and
    ``compaction`` (the host boundary).  The busy series stays on the
    device until the end.  Runs on ``device``, the card by default."""
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    if segment_len <= 0:
        raise ValueError(f"segment_len must be positive, got {segment_len}")
    if not isinstance(policy, str) or policy not in POLICIES:
        raise ValueError(
            f"unknown policy {policy!r}; known: {sorted(POLICIES)}")
    from repro_torch.kernels.sched_select import ops as sched_ops
    from repro_torch.obs.profile import ProfileTimers

    pass_fn = POLICIES[policy].torch_factory(pass_depth)
    timers = profile if profile is not None else ProfileTimers()
    ring: Optional[int] = None
    if record_events:
        from repro_torch.obs import torch_capture
        from repro_torch.obs.events import N_EVENT_TYPES, lossless_ring_size
        ring = (lossless_ring_size(capacity) if event_ring is None
                else event_ring)

    ent = omfs_torch.entitlements(users, config.cpu_total, device)
    empty, _ = omfs_torch.table_from_jobs([], users, config.cpu_total, config,
                                          device)
    tbl = omfs_torch.pad_table(empty, capacity)
    pass_stats = PassStats()
    feed = iter(jobs)
    lookahead: Optional[Job] = None
    due: List[Job] = []
    archived: List[Dict[str, np.ndarray]] = []   # host-side finished rows
    busy_parts: List[torch.Tensor] = []
    stats = {"segments": 0, "inserted": 0, "deferrals": 0, "peak_live": 0,
             "capacity": capacity}
    ev_counts: List[np.ndarray] = []
    ev_dropped: List[np.ndarray] = []
    events: list = []

    def boundary(tbl: JobTable) -> JobTable:
        """Compact finished rows out, insert due arrivals; host-side."""
        host = _table_to_host(tbl)
        pass_stats.table_reads += 1
        pad = (host["jid"] == omfs_torch.BIG) & (host["submit"]
                                                == omfs_torch.BIG)
        finished = np.isin(host["state"],
                           (omfs_torch.DONE, omfs_torch.KILLED)) & ~pad
        if finished.any():
            idx = np.flatnonzero(finished)
            archived.append({f: v[idx] for f, v in host.items()})
        free = np.flatnonzero(finished | pad)
        stats["peak_live"] = max(stats["peak_live"], capacity - free.size)
        k = min(len(due), free.size)
        if k < len(due):
            stats["deferrals"] += len(due) - k
        if k == 0 and not finished.any():
            return tbl
        take, due[:] = due[:k], due[k:]
        block, _ = omfs_torch.table_from_jobs(take, users, config.cpu_total,
                                              config, device)
        rows = omfs_torch.pad_table(block, capacity)
        # arrivals fill the first k free slots, pad rows clear the rest of
        # the freed ones, occupied slots are written back as they are:
        # `slots` is a permutation of arange(capacity) by construction
        slots = np.concatenate([free,
                                np.setdiff1d(np.arange(capacity), free)])
        stats["inserted"] += k
        return omfs_torch.insert_rows(tbl, slots, rows,
                                      np.arange(capacity) < free.size)

    t0 = 0
    while t0 < horizon:
        seg = min(segment_len, horizon - t0)
        while True:
            if lookahead is None:
                lookahead = next(feed, None)
            if lookahead is None or lookahead.submit_time >= t0 + seg:
                break
            due.append(lookahead)
            lookahead = None
        with timers.section("compaction"):
            tbl = boundary(tbl)
        unbuilt = sched_ops._lib_handle is None
        start = time.perf_counter()
        if record_events:
            tbl, busy, cnt, rbuf, drp = run_table_events(
                config, ent, tbl, seg, pass_fn, ring, t0=t0,
                stats=pass_stats)
            cnt = cnt.cpu().numpy().astype(np.int64)
            drp = drp.cpu().numpy().astype(np.int64)
            events.extend(torch_capture.decode_events(cnt, rbuf, drp, t0=t0))
            ev_counts.append(cnt)
            ev_dropped.append(drp)
        else:
            tbl, busy = run_table(config, ent, tbl, seg, pass_fn, t0=t0,
                                  stats=pass_stats)
        busy_parts.append(busy)
        if profile is not None and busy.is_cuda:
            torch.cuda.synchronize(busy.device)
        # the segment in which the kernel library was built or loaded
        timers.charge("compile" if unbuilt and sched_ops._lib_handle
                      is not None else "dispatch",
                      time.perf_counter() - start)
        stats["segments"] += 1
        t0 += seg

    # final extraction: archive + still-live rows, merged in job-id order
    # (the monolithic table's row order).  Arrivals still deferred here
    # never entered the table; they stay out of the result (counted).
    stats["dropped"] = len(due)
    host = _table_to_host(tbl)
    pass_stats.table_reads += 1
    live = np.flatnonzero(~((host["jid"] == omfs_torch.BIG)
                            & (host["submit"] == omfs_torch.BIG)))
    parts = archived + [{f: v[live] for f, v in host.items()}]
    merged = {f: np.concatenate([p[f] for p in parts])
              for f in JobTable._fields}
    order = np.argsort(merged["jid"], kind="stable")
    dev = tbl.cpus.device
    res = EngineResult(
        policy=policy, config=config, stats=pass_stats,
        table=JobTable(*(torch.from_numpy(np.ascontiguousarray(
            merged[f][order])).to(dev) for f in JobTable._fields)),
        busy=(torch.cat(busy_parts).cpu().numpy() if busy_parts
              else np.zeros(0, np.int32)),
        stream_stats=stats)
    if record_events:
        res.events = events
        res.event_counts = (np.concatenate(ev_counts) if ev_counts
                            else np.zeros((0, N_EVENT_TYPES), np.int64))
        res.events_dropped = (np.concatenate(ev_dropped) if ev_dropped
                              else np.zeros(0, np.int64))
        stats["events_dropped"] = int(res.events_dropped.sum())
    return res
