"""Backend-contract drift checks over the live policy registry + JobTable
(the port's copy of ``repro.analysis.contracts``).

Two contracts hold the two-backend design together:

* **backend-contract** — every policy registered in
  `repro_torch.core.engine.POLICIES` must carry BOTH a Python pass and a
  torch-pass factory that actually produce callables, and must be
  exercised by the port's policy suite (`tests/test_torch_policies.py`,
  which holds both backends against each other and the reference).  A
  policy added to the registry without that test is exactly how the
  backends drift apart silently.
* **column-dataflow** — every `JobTable` column written by
  `omfs_torch.table_from_jobs` must be consumed (attribute-read)
  somewhere in ``src/repro_torch``, and every column name passed to
  ``JobTable(...)`` must be a declared field.  A written-never-read
  column is dead state bloating the fixed-size table; a read-never-written
  column is a latent AttributeError.

These import the live modules (registry contents are runtime data), so they
run as *project* rules against the repo root.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List

from repro_torch.analysis.base import SourceFile, Violation, register

EQUIV_TEST = Path("tests/test_torch_policies.py")
OMFS_TORCH = Path("src/repro_torch/core/omfs_torch.py")
ENGINE = Path("src/repro_torch/core/engine.py")
SRC = Path("src/repro_torch")


def _test_covers_registry(test_src: str) -> bool:
    """True when the policy suite derives its policy list from the
    registry itself (``engine.POLICIES``) — then every future policy is
    covered by construction."""
    tree = ast.parse(test_src)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "POLICIES":
            return True
        if isinstance(node, ast.Name) and node.id == "POLICIES":
            return True
    return False


@register(
    "backend-contract", "project",
    "every registered policy has a Python pass, a torch factory, and "
    "policy-suite coverage")
def check_backend_contract(root: Path) -> List[Violation]:
    out: List[Violation] = []
    from repro_torch.core import engine

    engine_path = str(root / ENGINE)
    for name, spec in sorted(engine.POLICIES.items()):
        if not callable(spec.python_pass):
            out.append(Violation(
                "backend-contract", engine_path, 1,
                f"policy {name!r}: python_pass is not callable"))
        try:
            torch_pass = spec.torch_factory(None)
        except Exception as e:  # registry entry must build without args
            out.append(Violation(
                "backend-contract", engine_path, 1,
                f"policy {name!r}: torch_factory(None) raised {e!r}"))
            continue
        if not callable(torch_pass):
            out.append(Violation(
                "backend-contract", engine_path, 1,
                f"policy {name!r}: torch_factory(None) returned a "
                "non-callable"))

    test_path = root / EQUIV_TEST
    if not test_path.exists():
        out.append(Violation(
            "backend-contract", str(test_path), 1,
            "the port's policy suite is missing"))
        return out
    test_src = test_path.read_text()
    if not _test_covers_registry(test_src):
        for name in sorted(engine.POLICIES):
            if f'"{name}"' not in test_src and f"'{name}'" not in test_src:
                out.append(Violation(
                    "backend-contract", str(test_path), 1,
                    f"policy {name!r} is registered in core/engine.py but "
                    "never exercised by the port's policy suite "
                    "(parametrize over engine.POLICIES or name it "
                    "explicitly)"))
    return out


def _jobtable_fields(root: Path) -> List[str]:
    from repro_torch.core.omfs_torch import JobTable
    return list(JobTable._fields)


@register(
    "column-dataflow", "project",
    "every JobTable column built by table_from_jobs is consumed somewhere, "
    "and every written column is a declared field")
def check_column_dataflow(root: Path) -> List[Violation]:
    out: List[Violation] = []
    fields = set(_jobtable_fields(root))
    omfs_torch_path = root / OMFS_TORCH

    # -- writes: keywords of JobTable(...) and *._replace(...) --------------
    built_in_table_from_jobs: set = set()
    for py in sorted((root / SRC).rglob("*.py")):
        try:
            sf = SourceFile(py)
        except SyntaxError:
            continue
        # the outermost function around each node, one walk per
        # top-level function
        enclosing_fn, covered = {}, set()
        for fn in ast.walk(sf.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and id(fn) not in covered:
                for sub in ast.walk(fn):
                    enclosing_fn[id(sub)] = fn.name
                    covered.add(id(sub))
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            is_ctor = isinstance(node.func, ast.Name) and \
                node.func.id == "JobTable"
            is_replace = isinstance(node.func, ast.Attribute) and \
                node.func.attr == "_replace"
            if not (is_ctor or is_replace):
                continue
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                if kw.arg not in fields and is_ctor:
                    out.append(Violation(
                        "column-dataflow", str(py), kw.value.lineno,
                        f"JobTable(...) writes unknown column {kw.arg!r} — "
                        "not a declared field"))
                if (is_ctor and enclosing_fn.get(id(node)) ==
                        "table_from_jobs"):
                    built_in_table_from_jobs.add(kw.arg)

    missing_init = fields - built_in_table_from_jobs
    if built_in_table_from_jobs and missing_init:
        out.append(Violation(
            "column-dataflow", str(omfs_torch_path), 1,
            f"JobTable column(s) {sorted(missing_init)} are declared but "
            "never initialized by table_from_jobs"))

    # -- reads: tbl.<col> attribute loads anywhere in src/repro_torch -------
    consumed: set = set()
    for py in sorted((root / SRC).rglob("*.py")):
        try:
            tree = ast.parse(py.read_text())
        except SyntaxError:
            continue
        skip_ranges = []
        if py == omfs_torch_path:
            # the class declaration and the constructor call in
            # table_from_jobs are writes, not consumption
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef) and node.name == "JobTable":
                    skip_ranges.append((node.lineno, node.end_lineno))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load) and node.attr in fields:
                if any(a <= node.lineno <= b for a, b in skip_ranges):
                    continue
                consumed.add(node.attr)

    for col in sorted(fields - consumed):
        out.append(Violation(
            "column-dataflow", str(omfs_torch_path), 1,
            f"JobTable column {col!r} is written by table_from_jobs but "
            "never read anywhere in src/repro_torch — dead state in the "
            "fixed-size table"))

    # -- migration guard: the legacy two-column accessors must stay views
    # over the [J, T] lattice, never fields —
    # re-declaring one would silently fork the cost state
    legacy = {"cost_save", "cost_save2", "cost_restore", "cost_restore2"}
    for name in sorted(legacy & fields):
        out.append(Violation(
            "column-dataflow", str(omfs_torch_path), 1,
            f"legacy cost accessor {name!r} re-declared as a JobTable "
            "field — it must remain a read-only view over cost_save_lat/"
            "cost_restore_lat"))
    return out
