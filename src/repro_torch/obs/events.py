"""The event schema: typed per-job lifecycle events, defined ONCE as rules
over the tick-boundary state diff.

Both backends must emit bit-identical logs, so the schema is deliberately
NOT "emit at the call site" (call sites differ across backends and can see
intra-tick transients the other backend never materializes — e.g. a
quantum-0 admit-then-evict inside one pass).  Instead every event is a
predicate over ``(pre, post, t)`` where ``pre``/``post`` are the job's
states at the tick boundary:

======== ==================================================== ===========
event    rule over the tick diff                              arg
======== ==================================================== ===========
SUBMIT   pre.state == UNSUBMITTED and pre.submit <= t         cpus
START    post.state == RUNNING and post.run_start == t        cpus
RESTORE  START rule and pre.n_ckpt > 0                        max(pre.ckpt_tier, 0)
EVICT    post.n_preempt > pre.n_preempt                       cpus
SAVE     post.n_ckpt > pre.n_ckpt                             post.ckpt_tier
SPILL    post.n_spill > pre.n_spill                           post.ckpt_tier
FINISH   post.state == DONE and post.finish == t              post.progress
DEFER    post.state == PENDING                                cpus
======== ==================================================== ===========

Within a tick at most ONE of each type fires per job (the scheduling pass
snapshots eligibility, so a job cannot be admitted twice or evicted twice
in one tick), and at most `MAX_EVENTS_PER_JOB_PER_TICK` fire in total
(the worst case is EVICT+SAVE+SPILL+DEFER) — which is what makes
``lossless_ring_size`` a hard bound for the torch backend's bounded ring
(`obs.torch_capture`).  A killed job emits EVICT without SAVE and no FINISH
(FINISH is strictly DONE); the trace exporter closes its span at the
EVICT.  DEFER fires for every job still waiting after the pass — one
DEFER per job per waited tick, so wait time is literally the DEFER count.

The canonical per-tick order is ``(tick, etype, jid)``: the Python emitter
generates it directly, the torch ring is written in (etype, table-row) order
and re-sorted host-side at decode (row order == jid order for monolithic
tables but not for the streaming engine's recycled slots).

`events_from_diff` below is the Python implementation of the table above;
`obs.torch_capture.capture_tick` is the vectorized twin; the port's tests
hold both against the reference package's logs.
"""
from __future__ import annotations

import enum
from typing import Dict, Iterable, List, NamedTuple

from repro_torch.core.types import Job, JobState


class EventType(enum.IntEnum):
    """Per-job lifecycle events, int codes stable across backends."""

    SUBMIT = 0     # arrived: UNSUBMITTED -> PENDING
    START = 1      # admitted: began (or resumed) running this tick
    RESTORE = 2    # the START consumed an existing checkpoint
    EVICT = 3      # preempted (checkpointed victims) or killed
    SAVE = 4       # eviction wrote a checkpoint (arg = placed tier)
    SPILL = 5      # the SAVE landed beyond the fast tier
    FINISH = 6     # completed all work (state DONE)
    DEFER = 7      # still PENDING after the scheduling pass (waiting)


EVENT_TYPE_NAMES = tuple(e.name for e in EventType)
N_EVENT_TYPES = len(EventType)

#: hard per-job per-tick bound (EVICT+SAVE+SPILL+DEFER is the worst case);
#: a ring of MAX_EVENTS_PER_JOB_PER_TICK * J rows can never drop an event.
MAX_EVENTS_PER_JOB_PER_TICK = 4


def lossless_ring_size(n_jobs: int) -> int:
    """Smallest per-tick ring capacity that can never overflow for a
    ``n_jobs``-row table (see MAX_EVENTS_PER_JOB_PER_TICK)."""
    return max(8, MAX_EVENTS_PER_JOB_PER_TICK * n_jobs)


class Event(NamedTuple):
    """One decoded lifecycle event (identical tuple on both backends)."""

    tick: int
    etype: int       # EventType code
    jid: int         # true job id (JobTable.jid / Job.id)
    arg: int         # per-type payload, see the schema table

    @property
    def name(self) -> str:
        return EventType(self.etype).name


class JobSnap(NamedTuple):
    """The pre-tick fields the diff rules read (Python backend)."""

    state: int
    submit: int
    n_preempt: int
    n_ckpt: int
    n_spill: int
    ckpt_tier: int


def snap(job: Job) -> JobSnap:
    return JobSnap(int(job.state), job.submit_time, job.n_preemptions,
                   job.n_checkpoints, job.n_spills, job.ckpt_tier)


def events_from_diff(pre: Dict[int, JobSnap], jobs: Dict[int, Job],
                     t: int) -> List[Event]:
    """Apply the schema table to one tick of the Python backend.

    ``pre`` maps job id -> `JobSnap` taken before the tick; ``jobs`` is the
    post-tick state.  Events come out in canonical ``(etype, jid)`` order —
    the same order `obs.torch_capture.decode_events` produces.
    """
    out: List[Event] = []
    ids = sorted(jobs)
    for jid in ids:                                    # EventType.SUBMIT
        p = pre[jid]
        if p.state == JobState.UNSUBMITTED and p.submit <= t:
            out.append(Event(t, EventType.SUBMIT, jid, jobs[jid].cpus))
    started = []
    for jid in ids:                                    # EventType.START
        j = jobs[jid]
        if j.state == JobState.RUNNING and j.run_start == t:
            out.append(Event(t, EventType.START, jid, j.cpus))
            started.append(jid)
    for jid in started:                                # EventType.RESTORE
        if pre[jid].n_ckpt > 0:
            out.append(Event(t, EventType.RESTORE, jid,
                             max(pre[jid].ckpt_tier, 0)))
    for jid in ids:                                    # EventType.EVICT
        if jobs[jid].n_preemptions > pre[jid].n_preempt:
            out.append(Event(t, EventType.EVICT, jid, jobs[jid].cpus))
    for jid in ids:                                    # EventType.SAVE
        if jobs[jid].n_checkpoints > pre[jid].n_ckpt:
            out.append(Event(t, EventType.SAVE, jid, jobs[jid].ckpt_tier))
    for jid in ids:                                    # EventType.SPILL
        if jobs[jid].n_spills > pre[jid].n_spill:
            out.append(Event(t, EventType.SPILL, jid, jobs[jid].ckpt_tier))
    for jid in ids:                                    # EventType.FINISH
        j = jobs[jid]
        if j.state == JobState.DONE and j.finish_time == t:
            out.append(Event(t, EventType.FINISH, jid, j.progress))
    for jid in ids:                                    # EventType.DEFER
        if jobs[jid].state == JobState.PENDING:
            out.append(Event(t, EventType.DEFER, jid, jobs[jid].cpus))
    return out


def canonical_sort(events: Iterable[Event]) -> List[Event]:
    """Cross-backend comparison order: ``(tick, etype, jid)``."""
    return sorted(events, key=lambda e: (e.tick, e.etype, e.jid))
