"""Concurrency lint for the checkpoint/executor thread boundary (the
port's copy of ``repro.analysis.concurrency``).

The async-checkpoint contract (`checkpoint.async_writer`) runs the durable
write on a background thread while the trainer keeps mutating state on the
main thread.  Two rules police that boundary:

* **thread-shared-state** — attributes of a class reachable off-thread
  (a method submitted to a ``ThreadPoolExecutor``, passed as a ``Thread``
  target, or handed to ``AsyncCheckpointer`` as its ``write_fn``) that are
  mutated without holding a lock, while other methods of the same class
  access the same attribute from the caller thread.  Also: in a class that
  owns a lock, an attribute mutated under ``with self._lock`` somewhere
  must not be mutated bare elsewhere (outside ``__init__``).
* **lock-order** — two locks acquired nested in one order at one site and
  the opposite order at another (the classic ABBA deadlock).

The analysis is cross-file within the handed file set: `manager.py` wires
``AsyncCheckpointer(self.disk.save_leaves)`` where ``self.disk`` is a
`DiskTier` from `tiers.py`, so the off-thread entry point resolution
follows ``self.<attr> = ClassName(...)`` assignments across modules.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.base import SourceFile, Violation, register, tail

#: directories the project-level concurrency audit covers
CONCURRENCY_DIRS = ("src/repro_torch/checkpoint", "src/repro_torch/cluster")
LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
#: callables whose first argument (or ``target=``) runs on another thread
ASYNC_SINK_CALLS = {"submit", "Thread", "AsyncCheckpointer", "apply_async"}


class _ClassInfo:
    def __init__(self, name: str, sf: SourceFile, node: ast.ClassDef):
        self.name = name
        self.sf = sf
        self.node = node
        self.locks: Set[str] = set()            # self.<attr> lock attributes
        self.methods: Dict[str, ast.FunctionDef] = {}
        self.attr_class: Dict[str, str] = {}    # self.<attr> = ClassName(...)
        self.off_thread: Set[str] = set()       # methods reachable off-thread


def _self_chain(node: ast.expr) -> Optional[List[str]]:
    """['stats', 'saves'] for ``self.stats.saves``; None if not self-rooted."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self":
        return list(reversed(parts))
    return None


def _collect_classes(files: List[SourceFile]) -> Dict[str, _ClassInfo]:
    classes: Dict[str, _ClassInfo] = {}
    for sf in files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            info = _ClassInfo(node.name, sf, node)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.methods[item.name] = item
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Assign):
                    continue
                for tgt in sub.targets:
                    chain = _self_chain(tgt)
                    if chain is None or len(chain) != 1:
                        continue
                    if isinstance(sub.value, ast.Call):
                        ctor = tail(sub.value.func)
                        if ctor in LOCK_CTORS:
                            info.locks.add(chain[0])
                        elif ctor:
                            info.attr_class[chain[0]] = ctor
            classes[node.name] = info
    return classes


def _resolve_callable(expr: ast.expr, cls: Optional[_ClassInfo],
                      classes: Dict[str, _ClassInfo]
                      ) -> Optional[Tuple[str, str]]:
    """(class_name, method_name) a callable expression points at."""
    chain = _self_chain(expr)
    if chain and cls is not None:
        if len(chain) == 1 and chain[0] in cls.methods:
            return (cls.name, chain[0])
        if len(chain) == 2 and chain[0] in cls.attr_class:
            target = cls.attr_class[chain[0]]
            if target in classes and chain[1] in classes[target].methods:
                return (target, chain[1])
    return None


def _mark_off_thread(files: List[SourceFile],
                     classes: Dict[str, _ClassInfo]) -> None:
    for sf in files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef) or node.name not in classes:
                continue
            cls = classes[node.name]
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                if tail(sub.func) not in ASYNC_SINK_CALLS:
                    continue
                cands = list(sub.args[:1]) + [
                    kw.value for kw in sub.keywords
                    if kw.arg in ("target", "fn", "write_fn")]
                for cand in cands:
                    hit = _resolve_callable(cand, cls, classes)
                    if hit is not None:
                        classes[hit[0]].off_thread.add(hit[1])
    # close over same-class self.method() calls from off-thread methods
    for cls in classes.values():
        work = list(cls.off_thread)
        while work:
            m = work.pop()
            fn = cls.methods.get(m)
            if fn is None:
                continue
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call):
                    chain = _self_chain(sub.func)
                    if (chain and len(chain) == 1
                            and chain[0] in cls.methods
                            and chain[0] not in cls.off_thread):
                        cls.off_thread.add(chain[0])
                        work.append(chain[0])


def _with_lock_names(stmt: ast.With, cls: _ClassInfo) -> Set[str]:
    out = set()
    for item in stmt.items:
        chain = _self_chain(item.context_expr)
        if chain and len(chain) == 1 and (
                chain[0] in cls.locks or "lock" in chain[0].lower()):
            out.add(chain[0])
    return out


def _walk_mutations(fn: ast.AST, cls: _ClassInfo):
    """Yield (attr, node, held_locks) for every ``self.<attr>...`` mutation."""

    def walk(body, held: frozenset):
        for stmt in body:
            if isinstance(stmt, ast.With):
                walk(stmt.body, held | _with_lock_names(stmt, cls))
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                targets = [stmt.target]
            for tgt in targets:
                for t in ([tgt] if not isinstance(tgt, (ast.Tuple, ast.List))
                          else tgt.elts):
                    chain = _self_chain(t)
                    if chain:
                        yield chain[0], stmt, held
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub and not isinstance(stmt, ast.With):
                    yield from walk(sub, held)
            for h in getattr(stmt, "handlers", []):
                yield from walk(h.body, held)

    yield from walk(fn.body, frozenset())


def _collect_lock_edges(body, held: Tuple[str, ...], cls: _ClassInfo,
                        edges: Dict[Tuple[str, str], Tuple[str, int]]) -> None:
    """Record (outer_lock, inner_lock) acquisition pairs per with-nesting."""
    for stmt in body:
        if isinstance(stmt, ast.With):
            cur = held
            for n in sorted(_with_lock_names(stmt, cls)):
                q = f"{cls.name}.{n}"
                for h in cur:
                    edges.setdefault((h, q), (str(cls.sf.path), stmt.lineno))
                cur = cur + (q,)
            _collect_lock_edges(stmt.body, cur, cls, edges)
            continue
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if sub:
                _collect_lock_edges(sub, held, cls, edges)
        for h in getattr(stmt, "handlers", []):
            _collect_lock_edges(h.body, held, cls, edges)


def _attr_accesses(fn: ast.AST) -> Set[str]:
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute):
            chain = _self_chain(node)
            if chain:
                out.add(chain[0])
    return out


def analyze_concurrency(files: List[SourceFile]) -> List[Violation]:
    out: List[Violation] = []
    classes = _collect_classes(files)
    _mark_off_thread(files, classes)

    for cls in classes.values():
        path = str(cls.sf.path)
        # attributes mutated off-thread without a lock, shared with other
        # methods of the class
        if cls.off_thread:
            shared_attrs: Set[str] = set()
            for m in cls.off_thread:
                fn = cls.methods.get(m)
                if fn is None:
                    continue
                for attr, _node, _held in _walk_mutations(fn, cls):
                    others = [n for n, f in cls.methods.items()
                              if n not in cls.off_thread and n != "__init__"
                              and attr in _attr_accesses(f)]
                    if others:
                        shared_attrs.add(attr)
            for name, fn in cls.methods.items():
                if name == "__init__":
                    continue
                for attr, node, held in _walk_mutations(fn, cls):
                    if attr in shared_attrs and not held:
                        where = ("runs on the checkpoint writer thread"
                                 if name in cls.off_thread
                                 else "races the writer thread")
                        out.append(Violation(
                            "thread-shared-state", path, node.lineno,
                            f"{cls.name}.{name} mutates shared "
                            f"`self.{attr}` without holding a lock "
                            f"({where}; `self.{attr}` is reached from "
                            "both sides of the async-write boundary)"))
        # lock-guarded attributes mutated bare elsewhere
        guarded: Set[str] = set()
        for fn in cls.methods.values():
            for attr, _node, held in _walk_mutations(fn, cls):
                if held:
                    guarded.add(attr)
        if guarded:
            for name, fn in cls.methods.items():
                if name == "__init__":
                    continue
                for attr, node, held in _walk_mutations(fn, cls):
                    if attr in guarded and not held and attr not in cls.locks:
                        out.append(Violation(
                            "thread-shared-state", path, node.lineno,
                            f"{cls.name}.{name} mutates `self.{attr}` "
                            "without the lock that guards it elsewhere in "
                            "the class"))

    # -- lock acquisition order --------------------------------------------
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for cls in classes.values():
        for fn in cls.methods.values():
            _collect_lock_edges(fn.body, (), cls, edges)
    for (a, b), (path, line) in sorted(edges.items()):
        if (b, a) in edges and a < b:
            other = edges[(b, a)]
            out.append(Violation(
                "lock-order", path, line,
                f"inconsistent lock order: {a} -> {b} here but "
                f"{b} -> {a} at {other[0]}:{other[1]} — ABBA deadlock"))
    return out


@register(
    "thread-shared-state", "project",
    "shared mutable state crosses the async-checkpoint thread boundary "
    "without its lock")
def check_thread_shared_state(root: Path) -> List[Violation]:
    files = _concurrency_files(root)
    return [v for v in analyze_concurrency(files)
            if v.rule == "thread-shared-state"]


@register(
    "lock-order", "project",
    "locks acquired in contradictory nesting orders (ABBA deadlock)")
def check_lock_order(root: Path) -> List[Violation]:
    files = _concurrency_files(root)
    return [v for v in analyze_concurrency(files) if v.rule == "lock-order"]


def _concurrency_files(root: Path) -> List[SourceFile]:
    files = []
    for d in CONCURRENCY_DIRS:
        for py in sorted((root / d).glob("*.py")):
            files.append(SourceFile(py))
    return files
