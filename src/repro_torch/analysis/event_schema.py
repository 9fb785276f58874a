"""Event-schema contract: declared ⟺ emitted ⟺ consumed, and the capture
stays out of the uninstrumented hot path (the port's copy of
``repro.analysis.event_schema``).

The observability layer's one schema (`repro_torch.obs.events.EventType`)
has THREE implementations that must stay in lockstep: the Python diff
emitter (`events_from_diff`), the torch capture (`obs.torch_capture`'s
flag matrix, `event_flags`), and the downstream consumers (metrics
registry + trace exporter).  A type added to the enum but missing from any
of them is a silent hole in the telemetry — counts matrices and rings are
indexed by enum code, so nothing crashes, the events just never exist.

Two checks, both static (AST over the source tree, no imports — so the
fixture tests can run them against broken trees):

* **event-schema** — every ``EventType`` member is referenced by the
  Python emitter body, by the torch flag builder, and by at least one
  consumer (obs/metrics.py or obs/trace.py); conversely every
  ``EventType.X`` attribute reference anywhere in src/repro_torch names a
  declared member.
* **confinement** (same rule id) — the uninstrumented tick path in
  core/engine.py (`tick_torch`, `_tick_step` and `run_table`; its twin
  `run_table_events` captures) must not reference the obs layer, and the
  scheduler kernels (omfs.py / omfs_torch.py / policies_torch.py /
  baselines.py and every kernel's launch wrapper, ``kernels/*/ops.py``)
  must not import ``repro_torch.obs`` at all: events are defined over the
  tick-boundary diff, never emitted from inside a pass — that is what
  keeps the uninstrumented run unchanged and the backends' logs
  bit-equal.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.base import Violation, register

EVENTS = Path("src/repro_torch/obs/events.py")
TORCH_CAPTURE = Path("src/repro_torch/obs/torch_capture.py")
CONSUMERS = (Path("src/repro_torch/obs/metrics.py"),
             Path("src/repro_torch/obs/trace.py"))
ENGINE = Path("src/repro_torch/core/engine.py")
SRC = Path("src/repro_torch")

#: engine functions that make up the UNINSTRUMENTED hot path; their
#: instrumented twins (`*_events`) are exactly the ones allowed to capture
HOT_PATH_FNS = ("tick_torch", "_tick_step", "run_table")

#: scheduler kernels that must never import the obs layer
KERNEL_FILES = (Path("src/repro_torch/core/omfs.py"),
                Path("src/repro_torch/core/omfs_torch.py"),
                Path("src/repro_torch/core/policies_torch.py"),
                Path("src/repro_torch/core/baselines.py"))
#: the kernels' launch wrappers, held to the same bar
KERNEL_GLOB = "src/repro_torch/kernels/*/ops.py"

#: names that unmistakably belong to the obs capture layer
OBS_TOKENS = {"obs", "torch_capture", "capture_tick", "EventBus",
              "events_from_diff"}


def _parse(path: Path) -> Optional[ast.AST]:
    try:
        return ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return None


def _declared_events(tree: ast.AST) -> Dict[str, int]:
    """EventType member -> lineno, from the enum class body."""
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "EventType":
            for stmt in node.body:
                if isinstance(stmt, ast.Assign):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            out[tgt.id] = stmt.lineno
    return out


def _etype_refs(tree: ast.AST, within: Optional[str] = None
                ) -> Set[Tuple[str, int]]:
    """``EventType.X`` attribute references — optionally only inside the
    function named ``within``."""
    scopes: List[ast.AST] = [tree]
    if within is not None:
        scopes = [n for n in ast.walk(tree)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n.name == within]
    refs: Set[Tuple[str, int]] = set()
    for scope in scopes:
        for node in ast.walk(scope):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "EventType"):
                refs.add((node.attr, node.lineno))
    return refs


def _names_in(refs: Set[Tuple[str, int]]) -> Set[str]:
    return {name for name, _ in refs}


@register(
    "event-schema", "project",
    "every EventType is emitted by both backends and consumed downstream; "
    "capture stays out of the uninstrumented tick path and the kernels")
def check_event_schema(root: Path) -> List[Violation]:
    out: List[Violation] = []
    events_path = root / EVENTS
    events_tree = _parse(events_path)
    if events_tree is None:
        return [Violation("event-schema", str(events_path), 1,
                          "obs/events.py missing or unparseable — the event "
                          "schema must live there")]
    declared = _declared_events(events_tree)
    if not declared:
        return [Violation("event-schema", str(events_path), 1,
                          "no EventType members declared")]

    # -- declared => emitted (python): referenced in events_from_diff -------
    py_emitted = _names_in(_etype_refs(events_tree, within="events_from_diff"))
    # -- declared => emitted (torch): referenced in the flag-matrix builder -
    cap_tree = _parse(root / TORCH_CAPTURE)
    tc_emitted = (_names_in(_etype_refs(cap_tree, within="event_flags"))
                  if cap_tree is not None else set())
    if cap_tree is None:
        out.append(Violation(
            "event-schema", str(root / TORCH_CAPTURE), 1,
            "obs/torch_capture.py missing or unparseable — the torch "
            "backend has no device emitter"))
    # -- declared => consumed: referenced by metrics or trace ---------------
    consumed: Set[str] = set()
    for rel in CONSUMERS:
        tree = _parse(root / rel)
        if tree is not None:
            consumed |= _names_in(_etype_refs(tree))

    for name, line in sorted(declared.items()):
        if name not in py_emitted:
            out.append(Violation(
                "event-schema", str(events_path), line,
                f"EventType.{name} is declared but events_from_diff never "
                "references it — the Python backend cannot emit it"))
        if cap_tree is not None and name not in tc_emitted:
            out.append(Violation(
                "event-schema", str(root / TORCH_CAPTURE), 1,
                f"EventType.{name} is declared but the torch flag matrix "
                "(event_flags) never references it — the torch backend "
                "cannot emit it"))
        if name not in consumed:
            out.append(Violation(
                "event-schema", str(events_path), line,
                f"EventType.{name} is declared and emitted but neither the "
                "metrics registry nor the trace exporter consumes it"))

    # -- referenced => declared: no phantom event types anywhere ------------
    for py in sorted((root / SRC).rglob("*.py")):
        tree = _parse(py)
        if tree is None:
            continue
        for name, line in sorted(_etype_refs(tree)):
            if name not in declared and name.isupper():
                out.append(Violation(
                    "event-schema", str(py), line,
                    f"EventType.{name} referenced but not declared in "
                    "obs/events.py"))

    # -- confinement: the uninstrumented engine hot path stays capture-free -
    engine_tree = _parse(root / ENGINE)
    if engine_tree is not None:
        for node in ast.walk(engine_tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            if node.name not in HOT_PATH_FNS:
                continue
            for sub in ast.walk(node):
                hit = None
                if isinstance(sub, ast.Name) and sub.id in OBS_TOKENS:
                    hit = sub
                elif (isinstance(sub, ast.Attribute)
                      and sub.attr in OBS_TOKENS):
                    hit = sub
                elif (isinstance(sub, ast.ImportFrom) and sub.module
                      and "obs" in sub.module.split(".")):
                    hit = sub
                if hit is not None:
                    out.append(Violation(
                        "event-schema", str(root / ENGINE), hit.lineno,
                        f"uninstrumented hot-path function {node.name!r} "
                        "references the obs capture layer — instrumentation "
                        "must stay in the *_events twins so the plain "
                        "run is unchanged"))
                    break

    # -- confinement: scheduler kernels never import repro_torch.obs --------
    kernels = [root / rel for rel in KERNEL_FILES] + sorted(
        root.glob(KERNEL_GLOB))
    for path in kernels:
        tree = _parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            mod = None
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
            elif isinstance(node, ast.Import):
                mod = " ".join(a.name for a in node.names)
            if mod and "obs" in mod.replace(".", " ").split():
                out.append(Violation(
                    "event-schema", str(path), node.lineno,
                    "scheduler kernel imports repro_torch.obs — events are "
                    "tick-boundary diffs recorded OUTSIDE the passes; "
                    "in-pass emission breaks cross-backend bit-equality"))
    return out
