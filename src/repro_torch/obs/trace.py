"""Perfetto / Chrome ``trace_event`` exporter: any instrumented simulation
renders in chrome://tracing or ui.perfetto.dev as per-CPU-lane job spans
with eviction arrows.  The port's own copy of ``repro.obs.trace``.

Mapping (all derived from the event log — backend-agnostic):

* pid 0 is the cluster; tid ``k`` is CPU lane ``k`` (named ``cpu-NN`` via
  "M" metadata events).  1 tick = `US_PER_TICK` microseconds.
* a job run is one "X" complete span per lane it occupies, from START to
  the closing EVICT / FINISH (or the horizon, for jobs still running).
  Lanes are assigned first-fit per tick, releases before acquisitions —
  with ``cpu_total`` lanes this can never overflow, because the scheduler
  itself never over-commits CPUs.
* an eviction that later restarts emits a flow arrow ("s" at the EVICT,
  "f" at the restart span) with id = the job id — preemption churn is
  literally visible as arrows between lanes.
* "C" counter tracks: busy CPUs, pending (deferred) jobs, and — when a
  bounded ring overflowed — dropped events per tick, so lossy captures
  are impossible to mistake for quiet ones.

`validate_trace` is the CI gate for the smoke artifact: the JSON must
parse, spans must not overlap per lane, and every START must close with a
matching FINISH / EVICT (when the event log is supplied).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.events import Event, EventType

#: trace timebase: one scheduler tick = 1000 us, so tick counts read as ms
US_PER_TICK = 1000


def _lane_meta(n_lanes: int) -> List[dict]:
    out = [{"ph": "M", "pid": 0, "name": "process_name",
            "args": {"name": "cluster"}}]
    for k in range(n_lanes):
        out.append({"ph": "M", "pid": 0, "tid": k, "name": "thread_name",
                    "args": {"name": f"cpu-{k:02d}"}})
        out.append({"ph": "M", "pid": 0, "tid": k, "name": "thread_sort_index",
                    "args": {"sort_index": k}})
    return out


def trace_from_result(result, users=None) -> dict:
    """Build a Chrome ``trace_event`` dict from an instrumented
    `core.engine.EngineResult` (``record_events=True``)."""
    if result.events is None:
        raise ValueError(
            "result has no event log; run simulate(..., record_events=True)")
    from repro_torch.obs.metrics import _job_info

    info = _job_info(result, users)
    horizon = int(result.busy_series().size)
    n_lanes = int(result.config.cpu_total)

    by_tick: Dict[int, List[Event]] = {}
    for ev in result.events:
        by_tick.setdefault(ev.tick, []).append(ev)

    free = list(range(n_lanes))          # first-fit lane pool (min-first)
    held: Dict[int, Tuple[int, List[int]]] = {}   # jid -> (start, lanes)
    evicted_at: Dict[int, Tuple[int, int]] = {}   # jid -> (tick, old lane)
    restored: set = set()                # jids whose next START is a restore
    spans: List[dict] = []
    flows: List[dict] = []

    def close(jid: int, t: int, reason: str) -> None:
        start, lanes = held.pop(jid)
        user, cpus = info.get(jid, ("?", len(lanes)))
        for lane in lanes:
            spans.append({
                "ph": "X", "pid": 0, "tid": lane, "cat": "job",
                "name": f"job {jid}", "ts": start * US_PER_TICK,
                "dur": max(t - start, 0) * US_PER_TICK,
                "args": {"jid": jid, "user": user, "cpus": cpus,
                         "end": reason,
                         "restored": jid in restored},
            })
        free.extend(lanes)
        free.sort()

    for t in sorted(by_tick):
        evs = by_tick[t]
        # releases before acquisitions: a tick may evict A to admit B into
        # the very same CPUs
        for ev in evs:
            if ev.etype == EventType.EVICT and ev.jid in held:
                old_lane = held[ev.jid][1][0]
                close(ev.jid, t, "evict")
                evicted_at[ev.jid] = (t, old_lane)
            elif ev.etype == EventType.FINISH and ev.jid in held:
                close(ev.jid, t, "finish")
        for ev in evs:
            if ev.etype == EventType.RESTORE:
                restored.add(ev.jid)
        for ev in evs:
            if ev.etype != EventType.START or ev.jid in held:
                continue
            cpus = info.get(ev.jid, ("?", max(ev.arg, 1)))[1]
            take, rest = free[:cpus], free[cpus:]
            if len(take) < cpus:      # defensive; the scheduler prevents it
                extra = n_lanes + len(held)
                take = take + list(range(extra, extra + cpus - len(take)))
                rest = []
            free[:] = rest
            held[ev.jid] = (t, take)
            src = evicted_at.pop(ev.jid, None)
            if src is not None:       # eviction arrow: old lane -> new lane
                src_t, src_lane = src
                flows.append({"ph": "s", "pid": 0, "tid": src_lane,
                              "cat": "preemption", "name": "evict",
                              "id": ev.jid, "ts": src_t * US_PER_TICK})
                flows.append({"ph": "f", "pid": 0, "tid": take[0],
                              "cat": "preemption", "name": "evict",
                              "id": ev.jid, "ts": t * US_PER_TICK,
                              "bp": "e"})
        restored = {j for j in restored if j in held}

    for jid in list(held):            # still running at the horizon
        close(jid, horizon, "horizon")

    counters: List[dict] = []
    busy = result.busy_series()
    for t in range(horizon):
        counters.append({"ph": "C", "pid": 0, "name": "busy_cpus",
                         "ts": t * US_PER_TICK,
                         "args": {"busy": int(busy[t])}})
    if result.event_counts is not None and len(result.event_counts):
        pend = np.asarray(result.event_counts)[:, int(EventType.DEFER)]
        for t in range(min(horizon, pend.shape[0])):
            counters.append({"ph": "C", "pid": 0, "name": "pending_jobs",
                             "ts": t * US_PER_TICK,
                             "args": {"pending": int(pend[t])}})
    if result.events_dropped is not None:
        drp = np.asarray(result.events_dropped)
        for t in np.flatnonzero(drp):
            counters.append({"ph": "C", "pid": 0, "name": "events_dropped",
                             "ts": int(t) * US_PER_TICK,
                             "args": {"dropped": int(drp[t])}})

    return {
        "displayTimeUnit": "ms",
        "otherData": {"policy": result.policy, "backend": result.backend,
                      "horizon_ticks": horizon,
                      "events_dropped": result.events_dropped_total()},
        "traceEvents": _lane_meta(n_lanes) + spans + flows + counters,
    }


def validate_trace(trace, events: Optional[List[Event]] = None) -> List[str]:
    """Return a list of validity errors (empty = valid).

    Checks: the trace JSON-serializes and parses back; "X" spans do not
    overlap within a (pid, tid) lane; flow arrows pair up ("s" and "f" per
    id); and — when the source event log is supplied — every START is
    closed by a matching FINISH or EVICT or survives to the horizon with a
    span of the same job.
    """
    errors: List[str] = []
    try:
        trace = json.loads(json.dumps(trace))
    except (TypeError, ValueError) as exc:
        return [f"trace does not round-trip as JSON: {exc}"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]

    lanes: Dict[Tuple[int, int], List[Tuple[int, int, str]]] = {}
    for ev in evs:
        if ev.get("ph") == "X":
            key = (ev.get("pid", 0), ev.get("tid", 0))
            if ev.get("dur", 0) < 0:
                errors.append(f"negative duration span: {ev.get('name')}")
            lanes.setdefault(key, []).append(
                (ev["ts"], ev["ts"] + ev.get("dur", 0), ev.get("name", "?")))
    for key, spans in lanes.items():
        spans.sort()
        for (s0, e0, n0), (s1, e1, n1) in zip(spans, spans[1:]):
            if s1 < e0:
                errors.append(
                    f"overlap on lane {key}: {n0!r} [{s0},{e0}) vs "
                    f"{n1!r} [{s1},{e1})")

    starts = {(e.get("cat"), e.get("id")) for e in evs if e.get("ph") == "s"}
    ends = {(e.get("cat"), e.get("id")) for e in evs if e.get("ph") == "f"}
    for key in starts - ends:
        errors.append(f"flow {key} started but never finished")
    for key in ends - starts:
        errors.append(f"flow {key} finished but never started")

    if events is not None:
        open_jobs: Dict[int, int] = {}
        for ev in events:
            if ev.etype == EventType.START:
                if ev.jid in open_jobs:
                    errors.append(f"job {ev.jid} started twice without "
                                  f"close (ticks {open_jobs[ev.jid]}, "
                                  f"{ev.tick})")
                open_jobs[ev.jid] = ev.tick
            elif ev.etype in (EventType.EVICT, EventType.FINISH):
                open_jobs.pop(ev.jid, None)
        spanned = {e["args"].get("jid") for e in evs
                   if e.get("ph") == "X" and isinstance(e.get("args"), dict)}
        for jid in open_jobs:
            if jid not in spanned:
                errors.append(
                    f"job {jid} STARTed but has no span and no close event")
    return errors


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.obs.trace --out trace.json
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Export a Perfetto/Chrome trace of a simulated schedule")
    p.add_argument("--policy", default="omfs")
    p.add_argument("--backend", default="torch", choices=("python", "torch"))
    p.add_argument("--device", default="cuda",
                   help="torch device of the job table (cuda or cpu)")
    p.add_argument("--users", type=int, default=3)
    p.add_argument("--horizon", type=int, default=200)
    p.add_argument("--cpus", type=int, default=32)
    p.add_argument("--jobs", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="trace.json")
    p.add_argument("--validate", action="store_true",
                   help="exit nonzero unless the exported trace validates")
    args = p.parse_args(argv)

    from repro_torch.core import engine
    from repro_torch.core.types import SchedulerConfig
    from repro_torch.core.workload import WorkloadSpec, make_jobs, make_users

    spec = WorkloadSpec(n_users=args.users, horizon=args.horizon,
                        cpu_total=args.cpus, seed=args.seed,
                        arrival_rate=0.12, mean_work=30,
                        class_mix=(0.15, 0.35, 0.5))
    users = make_users(spec)
    jobs = make_jobs(spec, users)[:args.jobs]
    cfg = SchedulerConfig(cpu_total=args.cpus, quantum=4, cr_overhead=2)
    result = engine.simulate(users, jobs, cfg, args.horizon,
                             policy=args.policy, backend=args.backend,
                             device=args.device, record_events=True)
    trace = trace_from_result(result, users=users)
    with open(args.out, "w") as fh:
        json.dump(trace, fh)
    n_spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    print(f"wrote {args.out}: {len(trace['traceEvents'])} trace events "
          f"({n_spans} spans, {len(result.events)} lifecycle events, "
          f"{result.events_dropped_total()} dropped)")
    if args.validate:
        errors = validate_trace(trace, events=result.events)
        for err in errors:
            print(f"INVALID: {err}")
        if errors:
            return 1
        print("trace valid: spans non-overlapping per lane, flows paired, "
              "all starts closed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
