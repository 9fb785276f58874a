"""Tick-based cluster simulator — thin adapter over `core.engine`.

The port's own copy of ``repro.core.simulator``: the tick protocol lives in
`core.engine.tick_python`; this module keeps the historical
``simulate(...) -> SimResult`` entry point and re-exports
`SimResult`/`TickLog` for `core.metrics`.
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.core import engine
from repro_torch.core.engine import SimResult, TickLog  # noqa: F401  (re-exported)
from repro_torch.core.omfs import Decision, scheduler_pass
from repro_torch.core.types import ClusterState, Job, SchedulerConfig, User

Policy = Callable[[ClusterState], List[Decision]]


def simulate(
    users: List[User],
    jobs: List[Job],
    config: SchedulerConfig,
    horizon: int,
    policy: Policy = scheduler_pass,
) -> SimResult:
    res = engine.simulate(users, jobs, config, horizon,
                          policy=policy, backend="python")
    return res.sim
