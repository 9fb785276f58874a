"""Known-failure registry: triaged red tests, machine-validated (the
port's copy of ``repro.analysis.known_failures``; it reads the registry
and edits nothing).

`tests/known_failures.toml` lists every test that is *expected* to fail
(the pre-existing Pallas-kernel and multi-device gaps, tracked on the
ROADMAP).  The pytest hook in `tests/conftest.py` turns each entry into a
``strict=True`` xfail, which gives the registry teeth in both directions:

* a listed test that starts **passing** fails the run (stale entry — the
  fix landed, delete the line so the test guards against regressions);
* an unlisted kernel test that starts **failing** fails the run (new
  breakage, not grandfathered).

The ``known-failures`` analysis rule validates the registry itself: TOML
parses, every entry has an ``id`` and a non-empty ``reason``, ids are
unique and well-formed (``path::test``), and the referenced test file
exists on disk.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

from repro_torch.analysis.base import Violation, register

REGISTRY = Path("tests/known_failures.toml")


def _load_toml(path: Path) -> dict:
    try:
        import tomllib  # py311+
    except ImportError:
        import tomli as tomllib
    with open(path, "rb") as f:
        return tomllib.load(f)


def load_known_failures(root: Path) -> Dict[str, str]:
    """nodeid -> reason.  Raises on malformed registry (conftest wants a
    loud failure, not a silently empty xfail set)."""
    data = _load_toml(root / REGISTRY)
    out: Dict[str, str] = {}
    for entry in data.get("failure", []):
        out[str(entry["id"])] = str(entry.get("reason", ""))
    return out


@register(
    "known-failures", "project",
    "tests/known_failures.toml parses, ids are unique path::test entries "
    "pointing at real test files, every entry carries a reason")
def check_known_failures(root: Path) -> List[Violation]:
    out: List[Violation] = []
    reg_path = root / REGISTRY
    rel = str(reg_path)
    if not reg_path.exists():
        out.append(Violation(
            "known-failures", rel, 1,
            "registry missing — the kernel/multidevice xfail triage lives "
            "here; without it CI can't distinguish triaged red from new "
            "breakage"))
        return out
    try:
        data = _load_toml(reg_path)
    except Exception as e:
        out.append(Violation(
            "known-failures", rel, 1, f"registry does not parse: {e}"))
        return out

    entries = data.get("failure")
    if not isinstance(entries, list) or not entries:
        out.append(Violation(
            "known-failures", rel, 1,
            "registry has no [[failure]] entries"))
        return out

    seen: Dict[str, int] = {}
    for i, entry in enumerate(entries, start=1):
        tag = f"[[failure]] #{i}"
        nodeid = entry.get("id")
        if not isinstance(nodeid, str) or "::" not in nodeid:
            out.append(Violation(
                "known-failures", rel, 1,
                f"{tag}: id must be a 'path::test' pytest nodeid, "
                f"got {nodeid!r}"))
            continue
        if nodeid in seen:
            out.append(Violation(
                "known-failures", rel, 1,
                f"{tag}: duplicate id {nodeid!r} (first at entry "
                f"#{seen[nodeid]})"))
        seen.setdefault(nodeid, i)
        reason = entry.get("reason")
        if not isinstance(reason, str) or not reason.strip():
            out.append(Violation(
                "known-failures", rel, 1,
                f"{tag}: {nodeid!r} has no reason — every triaged failure "
                "must say why it is expected to fail"))
        test_file = nodeid.split("::", 1)[0]
        if not (root / test_file).exists():
            out.append(Violation(
                "known-failures", rel, 1,
                f"{tag}: {nodeid!r} references missing file {test_file!r}"))
        extra = set(entry) - {"id", "reason"}
        if extra:
            out.append(Violation(
                "known-failures", rel, 1,
                f"{tag}: unknown key(s) {sorted(extra)}"))
    return out
