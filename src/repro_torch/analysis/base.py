"""Rule engine for `repro_torch.analysis`: violations, registry,
suppressions (the port's copy of ``repro.analysis.base``).

The analyzer is organized around a flat registry of *rules*.  Each rule is a
function registered under a stable id (the id appears in output, in inline
suppressions, and in the fixture tests) with one of three kinds:

* ``file``    — AST/text checks run per source file (`ast_rules`);
* ``project`` — whole-repo checks that need several files or an import of
  the live registry (`concurrency`, `contracts`, `event_schema`,
  `known_failures`);
* ``trace``   — checks that run the registered passes and the models under
  a ``TorchDispatchMode`` and inspect what they dispatch
  (`dispatch_audit`).

Suppressions are inline comments on the violating line::

    x = int(flag)   # analysis: ignore[host-read] -- counted in PassStats

and are themselves validated: an unknown rule id, a missing ``-- reason``,
or a suppression that matches no violation is reported under the
``suppression`` rule — a stale suppression cannot silently linger.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: stable rule id + location + human message."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    kind: str                  # "file" | "project" | "trace"
    doc: str
    check: Callable


#: rule id -> Rule; populated by the @register decorators at import time.
RULES: Dict[str, Rule] = {}

#: rule ids that only ever surface through other rules (never run directly)
#: but are still valid suppression / reporting targets.
VIRTUAL_RULES = ("suppression",)


def register(rule_id: str, kind: str, doc: str):
    """Register ``fn`` as the checker for ``rule_id``."""
    assert kind in ("file", "project", "trace"), kind

    def deco(fn):
        assert rule_id not in RULES, f"duplicate rule {rule_id}"
        RULES[rule_id] = Rule(rule_id, kind, doc, fn)
        return fn

    return deco


def known_rule_ids() -> List[str]:
    return sorted(set(RULES) | set(VIRTUAL_RULES))


class SourceFile:
    """A parsed source file handed to every file-kind rule."""

    def __init__(self, path: Path, text: Optional[str] = None):
        self.path = Path(path)
        self.text = self.path.read_text() if text is None else text
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))

    @property
    def name(self) -> str:
        return self.path.name


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

SUPPRESS_RE = re.compile(
    r"#\s*analysis:\s*ignore\[([A-Za-z0-9_\-, ]+)\]\s*(?:--\s*(\S.*))?$")


@dataclasses.dataclass
class Suppression:
    path: str
    line: int
    rules: tuple
    reason: Optional[str]
    used: bool = False


def _comment_lines(sf: SourceFile) -> Dict[int, str]:
    """line -> comment text, via tokenize (docstrings that *mention* the
    suppression syntax must not register as suppressions)."""
    import io
    import tokenize

    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(sf.text).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except tokenize.TokenizeError:
        pass
    return out


def find_suppressions(sf: SourceFile) -> List[Suppression]:
    out = []
    for i, comment in sorted(_comment_lines(sf).items()):
        m = SUPPRESS_RE.search(comment)
        if m:
            rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
            out.append(Suppression(str(sf.path), i, rules, m.group(2)))
    return out


def apply_suppressions(
    violations: Sequence[Violation], sups: Sequence[Suppression]
) -> List[Violation]:
    """Drop suppressed violations; emit ``suppression`` violations for
    malformed (unknown rule / missing reason) or unused suppressions."""
    known = set(known_rule_ids())
    by_loc: Dict[tuple, List[Suppression]] = {}
    out: List[Violation] = []
    for s in sups:
        for r in s.rules:
            by_loc.setdefault((s.path, s.line, r), []).append(s)
    for v in violations:
        hits = by_loc.get((v.path, v.line, v.rule), [])
        live = [s for s in hits if s.reason and set(s.rules) <= known]
        if live:
            for s in live:
                s.used = True
        else:
            out.append(v)
    for s in sups:
        bad = [r for r in s.rules if r not in known]
        if bad:
            out.append(Violation(
                "suppression", s.path, s.line,
                f"suppression names unknown rule(s) {', '.join(bad)}; "
                f"known: {', '.join(known_rule_ids())}"))
        elif not s.reason:
            out.append(Violation(
                "suppression", s.path, s.line,
                "suppression is missing its '-- reason' justification"))
        elif not s.used:
            out.append(Violation(
                "suppression", s.path, s.line,
                f"unused suppression for [{', '.join(s.rules)}]: "
                "no violation on this line — delete it"))
    return out


# ---------------------------------------------------------------------------
# AST helpers shared by the rule modules
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def tail(node: ast.AST) -> Optional[str]:
    """Last attribute segment (``c`` for ``a.b.c``), or the bare name."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None
