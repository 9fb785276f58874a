"""repro_torch.analysis — static analysis + invariant audit of the torch
port (the counterpart of ``repro.analysis``).

Run as ``python -m repro_torch.analysis [--device cpu]`` from the repo
root.  Three layers:

* AST rules (`ast_rules`): host reads in passes, models and launch
  wrappers, integer-cost-grid violations, mutable defaults — per-file, no
  imports of the checked code.
* Contract rules (`contracts`, `concurrency`, `event_schema`,
  `known_failures`): policy-registry / policy-suite drift, JobTable column
  dataflow, thread-boundary races and lock ordering in the checkpoint and
  cluster packages, the event schema, the known-failure registry —
  whole-repo, import the live registry.
* Trace rules (`dispatch_audit`): run every registered policy pass and a
  smoke serving of each model family under a ``TorchDispatchMode`` on
  ``--device`` (the card by default; ``cpu`` runs the plain versions) and
  audit what they dispatch (no int->float ops, eviction machinery confined
  to the eviction branch, every host read counted).

Inline suppressions: ``# analysis: ignore[rule-id] -- reason`` on the
violating line.  Suppressions without a reason, naming unknown rules, or
matching nothing are violations themselves.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

from repro_torch.analysis import (  # noqa: F401  (imports populate RULES)
    ast_rules,
    concurrency,
    contracts,
    dispatch_audit,
    event_schema,
    known_failures,
)
from repro_torch.analysis.base import (
    RULES,
    SourceFile,
    Suppression,
    Violation,
    apply_suppressions,
    find_suppressions,
)

#: default scan set for file-kind rules
DEFAULT_TARGETS = ("src/repro_torch",)
EXCLUDE_DIRS = {"__pycache__", ".git", "analysis_fixtures"}


def find_root(start: Optional[Path] = None) -> Path:
    """Nearest ancestor that looks like the repo root (has
    src/repro_torch)."""
    cur = (start or Path.cwd()).resolve()
    for cand in (cur, *cur.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return cur


def _iter_py_files(targets: Iterable[Path]) -> List[Path]:
    out: List[Path] = []
    for t in targets:
        if t.is_file() and t.suffix == ".py":
            out.append(t)
        elif t.is_dir():
            for py in sorted(t.rglob("*.py")):
                if not EXCLUDE_DIRS & set(py.parts):
                    out.append(py)
    return out


def _relativize(path: str, root: Path) -> str:
    try:
        return str(Path(path).resolve().relative_to(root))
    except ValueError:
        return path


def collect_violations(
    root: Path,
    targets: Optional[Iterable[Path]] = None,
    include_trace: bool = True,
    include_project: bool = True,
    device="cuda",
) -> Tuple[List[Violation], List[Suppression]]:
    """All violations (suppressions applied) + the suppression list; the
    trace rules run on ``device``."""
    raw: List[Violation] = []
    sups: List[Suppression] = []

    files = _iter_py_files(
        [root / t for t in DEFAULT_TARGETS] if targets is None
        else list(targets))
    parsed: List[SourceFile] = []
    for py in files:
        try:
            parsed.append(SourceFile(py))
        except SyntaxError as e:
            raw.append(Violation(
                "syntax", str(py), e.lineno or 1, f"does not parse: {e.msg}"))
    for sf in parsed:
        sups.extend(find_suppressions(sf))
        for rule in RULES.values():
            if rule.kind == "file":
                raw.extend(rule.check(sf))

    if include_project:
        for rule in RULES.values():
            if rule.kind == "project":
                raw.extend(rule.check(root))
    if include_trace:
        # one audited run of the passes and the models serves every trace
        # rule
        report = dispatch_audit.audit(device)
        for rule in RULES.values():
            if rule.kind == "trace":
                raw.extend(rule.check(root, report))

    raw = [Violation(v.rule, _relativize(v.path, root), v.line, v.message)
           for v in raw]
    for s in sups:
        s.path = _relativize(s.path, root)
    return apply_suppressions(raw, sups), sups


def _github_summary(violations: List[Violation]) -> str:
    lines = ["## repro_torch.analysis", ""]
    if not violations:
        lines.append("No violations. :white_check_mark:")
        return "\n".join(lines) + "\n"
    lines += [f"**{len(violations)} violation(s)**", "",
              "| Rule | Location | Message |",
              "| --- | --- | --- |"]
    for v in violations:
        msg = v.message.replace("|", "\\|")
        lines.append(f"| `{v.rule}` | `{v.path}:{v.line}` | {msg} |")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis and invariant audit of the torch port")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs for the AST rules "
                         "(default: src/repro_torch; project/trace rules always "
                         "run against the repo root)")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the dispatch audit (runs no pass or model)")
    ap.add_argument("--no-project", action="store_true",
                    help="skip whole-repo contract rules (fixture mode)")
    ap.add_argument("--format", choices=("text", "github"), default="text")
    ap.add_argument("--device", default="cuda",
                    help="where the dispatch audit runs: cuda (the default; "
                         "raises without a GPU) or cpu (the plain versions)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            r = RULES[rid]
            print(f"{rid:22s} {r.kind:8s} {r.doc}")
        return 0

    root = find_root()
    os.chdir(root)
    violations, _ = collect_violations(
        root,
        targets=args.paths or None,
        include_trace=not args.no_trace,
        include_project=not args.no_project,
        device=args.device,
    )
    violations.sort(key=lambda v: (v.path, v.line, v.rule))

    if args.format == "github":
        print(_github_summary(violations), end="")
    else:
        for v in violations:
            print(v)
    summary_path = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary_path:
        with open(summary_path, "a") as f:
            f.write(_github_summary(violations))

    n_rules = len(RULES)
    if violations:
        print(f"\n{len(violations)} violation(s) across {n_rules} rules.",
              file=sys.stderr)
        return 1
    if args.format == "text":
        print(f"OK: {n_rules} rules, 0 violations.")
    return 0
