"""Scheduler observability: event bus, metrics registry, trace export.

The layer is event-sourced: both engine backends record the SAME typed
per-job lifecycle events (`obs.events.EventType`), defined once as rules
over the tick-boundary state diff — the Python backend walks the job dict
(`obs.events.events_from_diff`), the torch backend captures them on the
device each tick with shapes fixed by the ring size
(`obs.torch_capture.capture_tick`) and decodes host-side after the run.
Everything downstream — the metrics registry (`obs.metrics`), the
Perfetto/Chrome trace exporter (`obs.trace`), the fairness audit — is a
pure function of the event log, so it is backend-agnostic by construction
(DESIGN.md §Observability).
"""
from repro_torch.obs.bus import EventBus
from repro_torch.obs.events import (
    EVENT_TYPE_NAMES,
    MAX_EVENTS_PER_JOB_PER_TICK,
    N_EVENT_TYPES,
    Event,
    EventType,
    canonical_sort,
    events_from_diff,
    lossless_ring_size,
)
from repro_torch.obs.metrics import MetricsRegistry, registry_from_result
from repro_torch.obs.profile import ProfileTimers
from repro_torch.obs.trace import trace_from_result, validate_trace

__all__ = [
    "EVENT_TYPE_NAMES",
    "MAX_EVENTS_PER_JOB_PER_TICK",
    "N_EVENT_TYPES",
    "Event",
    "EventBus",
    "EventType",
    "MetricsRegistry",
    "ProfileTimers",
    "canonical_sort",
    "events_from_diff",
    "lossless_ring_size",
    "registry_from_result",
    "trace_from_result",
    "validate_trace",
]
