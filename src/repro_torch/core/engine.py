"""The scheduling engine over the torch `JobTable`: the port of
``repro.core.engine``'s vectorized backend.

The tick protocol is the reference's:

  1. arrivals   — jobs with ``submit_time <= t`` become PENDING,
  2. progress   — every running job accrues one work unit; completed jobs
                  free their CPUs,
  3. scheduling — one policy pass over the pending-queue snapshot,
  4. metrics    — per-tick busy CPUs.

``simulate(users, jobs, cfg, horizon, policy=..., device=...)`` is the
entry point; `EngineResult.signature()` and the final table are directly
comparable with the reference engine's results.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import omfs_torch
from repro_torch.core.omfs_torch import I32, JobTable, PassStats
from repro_torch.core.types import Job, SchedulerConfig, User

# policy contract: pass_fn(cfg, entitled[U], t, JobTable, stats) -> JobTable
TorchPass = Callable[..., JobTable]

#: every registered policy's pass factory, keyed by name
POLICIES: Dict[str, Callable[[Optional[int]], TorchPass]] = {
    "omfs": lambda pass_depth=None: omfs_torch.make_omfs_pass(pass_depth),
    # beyond-paper OMFS variant: evict the cheapest-to-checkpoint first
    "omfs_cheap_victim": lambda pass_depth=None: omfs_torch.make_omfs_pass(
        pass_depth, cheap_victims=True),
}


def tick_torch(cfg: SchedulerConfig, ent: torch.Tensor, tbl: JobTable,
               t: int, policy_pass: TorchPass,
               stats: Optional[PassStats] = None) -> JobTable:
    """One tick at ``t`` (steps 1-3), updating ``tbl`` in place."""
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
    return policy_pass(cfg, ent, t, tbl, stats)


def _tick_step(cfg: SchedulerConfig, ent: torch.Tensor, tbl: JobTable,
               t: int, pass_fn: TorchPass,
               stats: Optional[PassStats] = None):
    """The tick plus the per-tick busy reduction (protocol step 4)."""
    tbl = tick_torch(cfg, ent, tbl, t, pass_fn, stats)
    busy = torch.where(tbl.state == omfs_torch.RUNNING, tbl.cpus,
                       0).sum(dtype=I32)
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
              stats: Optional[PassStats] = None
              ) -> Tuple[JobTable, torch.Tensor]:
    """Ticks ``t0 .. t0 + horizon - 1`` over an existing table (a run
    resumed from a carried-over state), in place."""
    busy = torch.zeros(horizon, dtype=I32, device=tbl.cpus.device)
    if tbl.cpus.shape[0] == 0:
        return tbl, busy
    for i in range(horizon):
        tbl, busy[i] = _tick_step(cfg, ent, tbl, t0 + i, pass_fn, stats)
    return tbl, busy


@dataclass
class EngineResult:
    """Simulation outcome from `simulate`."""

    policy: str
    config: SchedulerConfig
    table: JobTable
    busy: np.ndarray                  # busy[t]
    stats: PassStats
    backend: str = "torch"
    #: host wall seconds: "build" (table from jobs) and "ticks" (the run,
    #: up to the busy series on the host)
    seconds: Dict[str, float] = field(default_factory=dict)

    def busy_series(self) -> np.ndarray:
        return np.asarray(self.busy)

    def utilization(self) -> float:
        b = self.busy_series()
        return float(b.mean() / self.config.cpu_total) if b.size else 0.0

    def signature(self):
        """Id-free schedule signature, comparable with the reference's."""
        return tuple(s[1:] for s in
                     omfs_torch.signature_from_table(self.table))

    def summary(self) -> Dict[str, float]:
        """Utilization / wait / preemption counts plus goodput (cpu-ticks
        that advanced useful work, per machine capacity) and the fraction
        of executed cpu-ticks wasted on C/R overhead or killed jobs."""
        t = {f: getattr(self.table, f).cpu().numpy()
             for f in ("first_start", "submit", "n_preempt", "n_ckpt",
                       "n_spill", "state", "progress", "work", "cpus")}
        started = t["first_start"] >= 0
        waits = (t["first_start"] - t["submit"])[started]
        was_killed = t["state"] == omfs_torch.KILLED
        progress = t["progress"].astype(np.int64)
        cpus = t["cpus"].astype(np.int64)
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


def simulate(users: List[User], jobs: List[Job], config: SchedulerConfig,
             horizon: int, policy: str = "omfs", *,
             pass_depth: Optional[int] = None,
             device="cuda") -> EngineResult:
    """Run the registered ``policy`` for ``horizon`` ticks on ``device``.

    ``pass_depth`` bounds the per-tick queue sweep (SLURM's
    sched_max_job_start); None sweeps the whole queue.  ``device`` defaults
    to the card and raises where CUDA is absent."""
    if policy not in POLICIES:
        raise ValueError(
            f"unknown policy {policy!r}; known: {sorted(POLICIES)}")
    stats = PassStats()
    t0 = time.perf_counter()
    tbl, ent = omfs_torch.table_from_jobs(jobs, users, config.cpu_total,
                                          config, device)
    t1 = time.perf_counter()
    tbl, busy = run_table(config, ent, tbl, horizon,
                          POLICIES[policy](pass_depth), stats=stats)
    busy = busy.cpu().numpy()
    t2 = time.perf_counter()
    return EngineResult(policy=policy, config=config, table=tbl, busy=busy,
                        stats=stats, seconds={"build": t1 - t0,
                                              "ticks": t2 - t1})
