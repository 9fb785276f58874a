"""Metrics registry: counters / gauges / histograms derived from the event
log, with Prometheus text exposition and JSON snapshots.

Everything here is a pure function of ``(events, result)`` — no backend
branches: the Python bus and the decoded torch ring produce the same
events, so `registry_from_result` produces the same scrape for either
backend.  The port's own copy of ``repro.obs.metrics``;
`launch.cluster_sim --metrics-out` writes its `to_json` snapshot.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.events import EVENT_TYPE_NAMES, Event, EventType

LabelItems = Tuple[Tuple[str, str], ...]

#: default histogram bucket upper bounds (ticks / counts)
DEFAULT_BUCKETS = (0.0, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0)


def _labels(labels: Optional[Dict[str, str]]) -> LabelItems:
    return tuple(sorted((k, str(v)) for k, v in (labels or {}).items()))


def _fmt_labels(items: LabelItems) -> str:
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _Metric:
    """One metric family: a kind, a help string, and labelled samples."""

    def __init__(self, name: str, kind: str, help_: str,
                 buckets: Sequence[float] = ()) -> None:
        self.name = name
        self.kind = kind
        self.help = help_
        self.buckets = tuple(buckets)
        self.samples: Dict[LabelItems, float] = {}
        # histogram state: per-labelset (bucket counts, sum, count)
        self.hist: Dict[LabelItems, Tuple[List[int], float, int]] = {}

    # -- writes ------------------------------------------------------------

    def inc(self, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = _labels(labels)
        self.samples[key] = self.samples.get(key, 0.0) + value

    def set(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        self.samples[_labels(labels)] = float(value)

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        key = _labels(labels)
        if key not in self.hist:
            self.hist[key] = ([0] * len(self.buckets), 0.0, 0)
        counts, total, n = self.hist[key]
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
        self.hist[key] = (counts, total + float(value), n + 1)

    # -- exposition --------------------------------------------------------

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        if self.kind == "histogram":
            for key, (counts, total, n) in sorted(self.hist.items()):
                for ub, c in zip(self.buckets, counts):
                    items = key + (("le", _fmt_value(ub)),)
                    lines.append(
                        f"{self.name}_bucket{_fmt_labels(items)} {c}")
                items = key + (("le", "+Inf"),)
                lines.append(f"{self.name}_bucket{_fmt_labels(items)} {n}")
                lines.append(
                    f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total)}")
                lines.append(f"{self.name}_count{_fmt_labels(key)} {n}")
        else:
            for key, v in sorted(self.samples.items()):
                lines.append(
                    f"{self.name}{_fmt_labels(key)} {_fmt_value(v)}")
        return lines

    def to_json(self):
        if self.kind == "histogram":
            return {
                "kind": self.kind, "help": self.help,
                "buckets": list(self.buckets),
                "series": {
                    _fmt_labels(k) or "{}": {
                        "bucket_counts": list(c), "sum": s, "count": n}
                    for k, (c, s, n) in sorted(self.hist.items())
                },
            }
        return {
            "kind": self.kind, "help": self.help,
            "series": {_fmt_labels(k) or "{}": v
                       for k, v in sorted(self.samples.items())},
        }


class MetricsRegistry:
    """A named family of metrics with Prometheus/JSON exposition."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, name: str, kind: str, help_: str,
             buckets: Sequence[float] = ()) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = _Metric(name, kind, help_, buckets)
            self._metrics[name] = m
        elif m.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, not {kind}")
        return m

    def counter(self, name: str, help_: str = "") -> _Metric:
        return self._get(name, "counter", help_)

    def gauge(self, name: str, help_: str = "") -> _Metric:
        return self._get(name, "gauge", help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Metric:
        return self._get(name, "histogram", help_, buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str) -> _Metric:
        return self._metrics[name]

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].expose())
        return "\n".join(lines) + "\n"

    def to_json(self):
        return {name: m.to_json()
                for name, m in sorted(self._metrics.items())}


# ---------------------------------------------------------------------------
# Event log -> registry
# ---------------------------------------------------------------------------


def _job_info(result, users=None) -> Dict[int, Tuple[str, int]]:
    """jid -> (user label, cpus) from either backend's result.  The torch
    table stores the user as an index into the users list the sim ran with
    (`omfs_torch.table_from_jobs`); passing ``users`` recovers the name, so
    per-user series carry the same labels on both backends."""
    if getattr(result, "sim", None) is not None:
        return {jid: (j.user, j.cpus)
                for jid, j in result.sim.state.jobs.items()}
    names = [u.name for u in users] if users is not None else None
    t = result.table
    out = {}
    for jid, uidx, cpus in zip(t.jid.cpu().numpy(), t.user.cpu().numpy(),
                               t.cpus.cpu().numpy()):
        uidx = int(uidx)
        label = (names[uidx] if names is not None and uidx < len(names)
                 else f"u{uidx}")
        out[int(jid)] = (label, int(cpus))
    return out


def _user_spans(events: Iterable[Event], horizon: int,
                info: Dict[int, Tuple[str, int]]) -> Dict[str, int]:
    """Per-user executed cpu-ticks, integrated from START..EVICT/FINISH
    spans (open spans close at the horizon)."""
    open_at: Dict[int, int] = {}
    ticks: Dict[str, int] = {}
    for ev in events:
        if ev.etype == EventType.START:
            open_at[ev.jid] = ev.tick
        elif ev.etype in (EventType.EVICT, EventType.FINISH):
            t0 = open_at.pop(ev.jid, None)
            if t0 is not None and ev.jid in info:
                user, cpus = info[ev.jid]
                ticks[user] = ticks.get(user, 0) + (ev.tick - t0) * cpus
    for jid, t0 in open_at.items():
        if jid in info:
            user, cpus = info[jid]
            ticks[user] = ticks.get(user, 0) + (horizon - t0) * cpus
    return ticks


def registry_from_result(result, users=None) -> MetricsRegistry:
    """Derive the standard scheduler metrics from an instrumented
    `core.engine.EngineResult` (``record_events=True``).

    ``users`` (the `core.types.User` list the sim ran with) adds per-user
    entitlement gauges next to the realized shares; without it only the
    realized side is emitted.  Works identically for both backends — the
    registry reads nothing but the event log, the busy series, and the
    jid -> (user, cpus) map.
    """
    if result.events is None:
        raise ValueError(
            "result has no event log; run simulate(..., record_events=True)")
    reg = MetricsRegistry()
    events: List[Event] = result.events
    horizon = int(result.busy_series().size)
    info = _job_info(result, users)

    # -- event counters (from the exact counts matrix, drop-proof) ---------
    total = reg.counter("sched_events_total",
                        "Lifecycle events by type (exact, even on ring "
                        "overflow)")
    if result.event_counts is not None and len(result.event_counts):
        per_type = np.asarray(result.event_counts).sum(axis=0)
    else:
        per_type = np.zeros((len(EVENT_TYPE_NAMES),), np.int64)
        for ev in events:
            per_type[ev.etype] += 1
    for name, n in zip(EVENT_TYPE_NAMES, per_type):
        total.inc(int(n), {"type": name})
    reg.counter("sched_events_dropped_total",
                "Events lost to ring overflow (0 for lossless rings)"
                ).inc(result.events_dropped_total())

    # -- per-job churn histograms ------------------------------------------
    defers: Dict[int, int] = {}
    evicts: Dict[int, int] = {}
    submitted = set()
    started = set()
    for ev in events:          # canonical order: DEFER after same-tick START
        if ev.etype == EventType.SUBMIT:
            submitted.add(ev.jid)
        elif ev.etype == EventType.DEFER and ev.jid not in started:
            # only pre-first-start ticks count as wait; post-eviction
            # requeue ticks show up in the churn histogram instead
            defers[ev.jid] = defers.get(ev.jid, 0) + 1
        elif ev.etype == EventType.START:
            started.add(ev.jid)
        elif ev.etype == EventType.EVICT:
            evicts[ev.jid] = evicts.get(ev.jid, 0) + 1
    wait = reg.histogram("sched_wait_ticks",
                         "Ticks a job waited before first start "
                         "(pre-start DEFER count per started job)")
    for jid in sorted(started):
        wait.observe(defers.get(jid, 0))
    churn = reg.histogram("sched_evictions_per_job",
                          "Preemptions suffered per submitted job",
                          buckets=(0.0, 1.0, 2.0, 3.0, 5.0, 8.0, 13.0, 21.0))
    for jid in sorted(submitted):
        churn.observe(evicts.get(jid, 0))

    # -- checkpoint tier traffic + occupancy -------------------------------
    saves = reg.counter("sched_ckpt_saves_total",
                        "Checkpoints written, by placed tier")
    resident: Dict[int, int] = {}
    for ev in events:
        if ev.etype == EventType.SAVE:
            saves.inc(1, {"tier": str(ev.arg)})
            resident[ev.jid] = ev.arg
        elif ev.etype in (EventType.RESTORE, EventType.FINISH):
            resident.pop(ev.jid, None)
    reg.counter("sched_spills_total",
                "Checkpoints placed beyond the fast tier"
                ).inc(int(per_type[EventType.SPILL]))
    occ = reg.gauge("sched_tier_occupancy",
                    "Checkpoints resident per tier at end of run")
    by_tier: Dict[int, int] = {}
    for tier in resident.values():
        by_tier[tier] = by_tier.get(tier, 0) + 1
    for tier in sorted(by_tier):
        occ.set(by_tier[tier], {"tier": str(tier)})

    # -- fairness: realized share vs. entitlement --------------------------
    ticks = _user_spans(events, horizon, info)
    cap = max(result.config.cpu_total * max(horizon, 1), 1)
    share = reg.gauge("sched_user_share",
                      "Realized fraction of cluster cpu-ticks per user")
    used = reg.counter("sched_user_cpu_ticks_total",
                       "Executed cpu-ticks per user (from event spans)")
    for user in sorted(ticks):
        used.inc(ticks[user], {"user": user})
        share.set(ticks[user] / cap, {"user": user})
    if users is not None:
        ent = reg.gauge("sched_user_entitlement",
                        "Entitled fraction of the cluster per user")
        for u in users:
            ent.set(u.entitled_cpus(result.config.cpu_total)
                    / max(result.config.cpu_total, 1), {"user": u.name})

    reg.gauge("sched_utilization",
              "Mean busy fraction over the horizon"
              ).set(result.utilization())
    return reg
