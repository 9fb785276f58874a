"""EventBus: the Python-backend (and live-executor) event recorder.

The bus is an append-only log of `obs.events.Event` plus a subscriber
fan-out.  It does NOT invent its own capture semantics: `record_tick`
snapshots the job dict before the tick and applies the one shared diff
schema (`obs.events.events_from_diff`) after it — exactly what the torch
backend's device capture computes — so a bus-recorded log is directly
comparable (bit-identical) to a decoded device ring.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.types import Job
from repro_torch.obs.events import (
    Event,
    JobSnap,
    N_EVENT_TYPES,
    events_from_diff,
    snap,
)

Subscriber = Callable[[Event], None]


class EventBus:
    """Append-only in-process event log with subscriber callbacks.

    The Python backend never drops events (there is no ring), so
    ``dropped`` is always a zero series — kept anyway so consumers can
    treat both backends' logs uniformly.
    """

    def __init__(self) -> None:
        self._events: List[Event] = []
        self._dropped: Dict[int, int] = {}
        self._subs: List[Subscriber] = []
        self._pre: Optional[Dict[int, JobSnap]] = None

    # -- recording ---------------------------------------------------------

    def subscribe(self, fn: Subscriber) -> None:
        self._subs.append(fn)

    def emit(self, events: Iterable[Event]) -> None:
        for ev in events:
            self._events.append(ev)
            for fn in self._subs:
                fn(ev)

    def snapshot(self, jobs: Dict[int, Job]) -> None:
        """Capture the pre-tick state (call just before the tick runs)."""
        self._pre = {jid: snap(j) for jid, j in jobs.items()}

    def record_tick(self, jobs: Dict[int, Job], t: int) -> List[Event]:
        """Diff the post-tick ``jobs`` against the last `snapshot` and emit
        the resulting events (canonical (etype, jid) order)."""
        if self._pre is None:
            raise RuntimeError("record_tick without a prior snapshot()")
        evs = events_from_diff(self._pre, jobs, t)
        self._pre = None
        self.emit(evs)
        return evs

    def record_dropped(self, t: int, n: int) -> None:
        """Account events lost at tick ``t`` (torch ring overflow feeds this
        when a decoded log is replayed onto a bus)."""
        if n:
            self._dropped[t] = self._dropped.get(t, 0) + int(n)

    # -- reading -----------------------------------------------------------

    @property
    def events(self) -> List[Event]:
        return list(self._events)

    @property
    def dropped_total(self) -> int:
        return sum(self._dropped.values())

    def __len__(self) -> int:
        return len(self._events)

    def counts(self) -> np.ndarray:
        """Total events per type, shape [N_EVENT_TYPES]."""
        out = np.zeros((N_EVENT_TYPES,), np.int64)
        for ev in self._events:
            out[ev.etype] += 1
        return out

    def counts_matrix(self, horizon: int) -> np.ndarray:
        """Per-tick per-type counts, shape [horizon, N_EVENT_TYPES] — the
        Python twin of the torch capture's counts output."""
        out = np.zeros((horizon, N_EVENT_TYPES), np.int64)
        for ev in self._events:
            if 0 <= ev.tick < horizon:
                out[ev.tick, ev.etype] += 1
        return out

    def dropped_series(self, horizon: int) -> np.ndarray:
        out = np.zeros((horizon,), np.int64)
        for t, n in self._dropped.items():
            if 0 <= t < horizon:
                out[t] += n
        return out

    def clear(self) -> None:
        self._events.clear()
        self._dropped.clear()
        self._pre = None
