"""ProfileTimers: named wall-clock section accounting for the host side of
the engine.  The port's own copy of ``repro.obs.profile``, kept for the
stream engine (the reference's ``simulate_stream`` charges ``compile``,
``dispatch`` and ``compaction`` sections).

Deliberately tiny: `time.perf_counter` deltas accumulated per section name.
Sections nest (each level is charged its own wall time,
so nested sections double-count by design — they answer "how long was this
section open", not "exclusive self time").
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator


class ProfileTimers:
    """Accumulates ``(total_seconds, calls)`` per named section."""

    def __init__(self) -> None:
        self.total_s: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    @contextmanager
    def section(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.charge(name, time.perf_counter() - start)

    def charge(self, name: str, seconds: float) -> None:
        """Add one call of ``seconds`` to ``name``: for a section named
        only once it has run."""
        self.total_s[name] = self.total_s.get(name, 0.0) + seconds
        self.calls[name] = self.calls.get(name, 0) + 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{section: {"total_s": ..., "calls": ...}}`` — JSON-ready."""
        return {
            name: {"total_s": self.total_s[name], "calls": self.calls[name]}
            for name in sorted(self.total_s)
        }

    def clear(self) -> None:
        self.total_s.clear()
        self.calls.clear()
