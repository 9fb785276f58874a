"""The port's analyzer, ``python -m repro_torch.analysis``: every rule
fires on its seeded fixture at the exact line, stays silent on the clean
fixture and on the port's known false positives of the reference's rules,
the suppression mechanics and the CLI's exit codes behave, the contract
rules flag broken copies, the dispatch rules fail on seeded faults, and
the port's own tree is clean (``--device cpu``).

The fixtures live in ``tests/analysis_fixtures/torch/`` (excluded from the
default scan).  Assertions pin ``(rule, line)`` pairs: editing a fixture
means re-pinning here."""
import re
import shutil
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro import analysis as ref_analysis  # noqa: E402
from repro.analysis.base import RULES as REF_RULES  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import dispatch_audit, known_failures  # noqa: E402
from repro_torch.analysis.base import (  # noqa: E402
    RULES,
    SourceFile,
    find_suppressions,
    known_rule_ids,
)
from repro_torch.analysis.concurrency import analyze_concurrency  # noqa: E402
from repro_torch.core import engine, omfs_torch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "analysis_fixtures" / "torch"
PORT = REPO / "src" / "repro_torch"

#: the host reads the port keeps, each with its suppression: the counted
#: reads of ROADMAP Queue 3 and the host epilogues
SUPPRESSED = [
    ("core/convert.py", "host-read"),            # table_to_numpy
    ("core/engine.py", "host-read"),             # PassStats.table_reads
    ("core/omfs_torch.py", "host-read"),         # PassStats.host_syncs
    ("core/omfs_torch.py", "host-read"),         # signature_from_table
    ("core/omfs_torch.py", "host-read"),         # tables_equal
    ("core/policies_torch.py", "host-read"),     # PassStats.host_syncs
    ("kernels/ckpt_codec/ops.py", "host-read"),  # roundtrip_error
    ("models/attention.py", "host-read"),        # _is_arange, unreached
    ("models/moe.py", "host-read"),              # moe.HOST_READS
]


def run_file_rules(*names):
    violations, _ = analysis.collect_violations(
        REPO, targets=[FIXTURES / n for n in names],
        include_trace=False, include_project=False)
    return sorted((v.rule, v.line) for v in violations)


def test_registry_is_complete():
    """The reference's rule ids, minus the four that police ``jit``
    (tracer leaks, host syncs and int->float casts in a jaxpr, retraces),
    plus the port's host-read rule and its two dispatch rules."""
    want = (set(REF_RULES) - {"tracer-leak", "host-sync", "jaxpr-float-cast",
                              "retrace"}) | {"host-read", "dispatch-float-cast",
                                             "dispatch-host-reads"}
    assert sorted(RULES) == sorted(want)
    assert len(RULES) == 12
    assert "suppression" in known_rule_ids()
    for rule in RULES.values():
        assert rule.kind in ("file", "project", "trace")
        assert rule.doc
    for rid in set(RULES) & set(REF_RULES):
        assert RULES[rid].kind in (REF_RULES[rid].kind, "project")


def test_host_read_fixture_exact_lines():
    assert run_file_rules("host_read.py") == [
        ("host-read", 10),       # if on a table column
        ("host-read", 12),       # int()
        ("host-read", 13),       # bool()
        ("host-read", 14),       # .item()
        ("host-read", 15),       # .tolist()
        ("host-read", 16),       # .cpu()
        ("host-read", 17),       # .numpy()
        ("host-read", 18),       # torch.equal
        ("host-read", 19),       # while
        ("host-read", 21),       # and
        ("host-read", 22),       # not
        ("host-read", 23),       # assert
        ("host-read", 24),       # any()
        ("host-read", 30),       # a pass factory's closure: ent
    ]


def test_host_read_models_and_launch_wrapper_fixtures_exact_lines():
    """Every function of a models/ module and of a kernel's ops.py is a
    context; a read behind a CPU guard is host data."""
    assert run_file_rules("models/serving.py") == [
        ("host-read", 9),        # int() of a tensor parameter
        ("host-read", 14),       # if on a tensor
        ("host-read", 16),       # conditional expression on a tensor
    ]
    assert run_file_rules("kernels/demo/ops.py") == [
        ("host-read", 8),        # bool() without the CPU guard
        ("host-read", 12),       # .item() past the CPU path
    ]


def test_cost_grid_fixture_exact_lines():
    assert run_file_rules("cost_grid.py") == [
        ("cost-grid", 7),        # true division assigned to cost_save_lat
        ("cost-grid", 10),       # float literal in a JobTable keyword
        ("cost-grid", 11),       # float dtype in a JobTable keyword
        ("cost-grid", 16),       # float() inside a grid cost function
    ]


def test_mutable_default_fixture_exact_lines():
    assert run_file_rules("mutable_default.py") == [
        ("mutable-default", 4),
        ("mutable-default", 9),
        ("mutable-default", 14),
    ]


def test_clean_fixture_is_silent():
    assert run_file_rules("clean.py") == []


def _line_of(path: Path, text: str) -> int:
    hits = [i for i, line in enumerate(path.read_text().splitlines(), 1)
            if text in line]
    assert len(hits) == 1, (path, text, hits)
    return hits[0]


@pytest.mark.parametrize("rel,text", [
    ("core/omfs_torch.py", "if tbl.cpus.dim() == 1:"),
    ("core/omfs_torch.py", "if any(fast_h):"),
    ("core/engine.py", "if finished.any():"),
    ("core/engine.py", "if k == 0 and not finished.any():"),
])
def test_host_read_is_silent_where_tracer_leak_misfires(rel, text):
    """The reference's tracer-leak flags these four lines of the port: a
    shape, a host list after the counted read, numpy after the counted
    table read.  Under eager torch none of them reads the device, and the
    port's rule is silent on each."""
    path = PORT / rel
    line = _line_of(path, text)
    ref, _ = ref_analysis.collect_violations(
        REPO, targets=[path], include_trace=False, include_project=False)
    assert ("tracer-leak", line) in {(v.rule, v.line) for v in ref}
    got = RULES["host-read"].check(SourceFile(path))
    assert line not in {v.line for v in got}


@pytest.mark.parametrize("rel,text", [
    ("models/attention.py", "return bool(torch.equal(pos, ar.expand_as"),
    ("models/moe.py", "return -(-int(counts.max()) // tile) * tile"),
])
def test_host_read_flags_the_reads_tracer_leak_misses(rel, text):
    """Two real reads of the serving path that the reference's rules do
    not see: the rule flags them (and the tree carries a suppression that
    states the reason)."""
    path = PORT / rel
    line = _line_of(path, text)
    ref, _ = ref_analysis.collect_violations(
        REPO, targets=[path], include_trace=False, include_project=False)
    assert line not in {v.line for v in ref if v.rule in ("tracer-leak",
                                                          "host-sync")}
    got = RULES["host-read"].check(SourceFile(path))
    assert line in {v.line for v in got}
    assert "# analysis: ignore[host-read] -- " in \
        path.read_text().splitlines()[line - 1]


def test_suppression_mechanics():
    got = run_file_rules("suppressed.py")
    # line 5's read is validly suppressed — absent from output
    assert ("host-read", 5) not in got
    assert got == [
        ("host-read", 13),        # missing-reason suppression doesn't count
        ("suppression", 9),       # unused suppression
        ("suppression", 13),      # missing '-- reason'
        ("suppression", 17),      # unknown rule id (the reference's)
    ]


def test_suppressions_are_the_counted_reads():
    """The tree's suppressions are exactly the reads the port keeps (the
    list of ROADMAP Queue 3), each with its reason."""
    got = []
    for py in sorted(PORT.rglob("*.py")):
        for sup in find_suppressions(SourceFile(py)):
            assert sup.reason, (py, sup.line)
            got.extend((str(py.relative_to(PORT)), r) for r in sup.rules)
    assert sorted(got) == sorted(SUPPRESSED)


def test_concurrency_fixture_exact_lines():
    sf = SourceFile(FIXTURES / "concurrency_bad.py")
    got = sorted((v.rule, v.line) for v in analyze_concurrency([sf]))
    assert got == [
        ("lock-order", 34),            # fast->slow here, slow->fast at 39
        ("thread-shared-state", 18),   # _write runs on the pool thread
        ("thread-shared-state", 19),
        ("thread-shared-state", 22),   # reset races the pool thread
    ]


def test_concurrency_rules_scan_the_ports_checkpoint_and_cluster(tmp_path):
    from repro_torch.analysis.concurrency import (
        check_lock_order,
        check_thread_shared_state,
    )

    assert check_thread_shared_state(REPO) == []
    assert check_lock_order(REPO) == []
    ckpt = tmp_path / "src" / "repro_torch" / "checkpoint"
    ckpt.mkdir(parents=True)
    shutil.copy(FIXTURES / "concurrency_bad.py", ckpt / "writer.py")
    assert len(check_thread_shared_state(tmp_path)) == 3
    assert [v.line for v in check_lock_order(tmp_path)] == [34]


def test_cli_exit_codes(capsys):
    rc = analysis.main([
        "--no-trace", "--no-project", str(FIXTURES / "mutable_default.py")])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[mutable-default]" in out
    assert "mutable_default.py:4" in out
    rc = analysis.main([
        "--no-trace", "--no-project", str(FIXTURES / "clean.py")])
    assert rc == 0
    assert analysis.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in RULES:
        assert re.search(rf"^{re.escape(rid)}\s", listed, re.M), rid
    if not torch.cuda.is_available():
        # no fallback: the card's audit does not run on the CPU instead
        with pytest.raises(RuntimeError, match="cuda"):
            analysis.main(["--no-project", "--device", "cuda",
                           str(FIXTURES / "clean.py")])


def test_real_tree_is_analysis_clean(capsys):
    """src/repro_torch passes every rule, the dispatch audit on the CPU
    included: what the `[audit]` phase of chip_smoke.py runs on the
    card."""
    rc = analysis.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.strip().endswith(f"OK: {len(RULES)} rules, 0 violations.")


@pytest.mark.cuda
def test_real_tree_is_analysis_clean_on_the_card(capsys):
    """The same run with the dispatch audit on the card: the plans launch
    `sched_select`, the models their kernels."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    assert analysis.main(["--device", "cuda"]) == 0, capsys.readouterr().out


def test_both_analyzers_agree_the_shared_file_rules_are_clean():
    """``python -m repro.analysis`` and ``python -m repro_torch.analysis``
    run the same cost-grid and mutable-default rules over src/repro_torch,
    and both find nothing."""
    shared = ("cost-grid", "mutable-default")
    for pkg in (ref_analysis, analysis):
        got, _ = pkg.collect_violations(
            REPO, targets=[PORT], include_trace=False, include_project=False)
        assert [v for v in got if v.rule in shared] == [], pkg.__name__


def test_backend_contract_flags_missing_policy_suite_entry(tmp_path):
    from repro_torch.analysis.contracts import check_backend_contract

    assert check_backend_contract(REPO) == []
    fake = tmp_path / "tests" / "test_torch_policies.py"
    fake.parent.mkdir(parents=True)
    fake.write_text('def test_one():\n    run("omfs")\n')
    got = [v for v in check_backend_contract(tmp_path)
           if "never exercised" in v.message]
    assert len(got) == len(engine.POLICIES) - 1   # every policy but omfs
    fake.write_text("from repro_torch.core import engine\n"
                    "NAMES = sorted(engine.POLICIES)\n")
    assert check_backend_contract(tmp_path) == []
    fake.unlink()
    assert any("suite is missing" in v.message
               for v in check_backend_contract(tmp_path))


def test_backend_contract_flags_a_factory_that_raises(monkeypatch):
    from repro_torch.analysis.contracts import check_backend_contract

    def broken(pass_depth=None):
        raise RuntimeError("no pass")

    spec = engine.POLICIES["fcfs"]
    monkeypatch.setitem(engine.POLICIES, "fcfs", engine.PolicySpec(
        "fcfs", spec.python_pass, broken))
    got = check_backend_contract(REPO)
    assert len(got) == 1 and "torch_factory(None) raised" in got[0].message


def test_column_dataflow_flags_a_broken_table_module(tmp_path):
    from repro_torch.analysis.contracts import check_column_dataflow

    assert check_column_dataflow(REPO) == []
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    fields = list(omfs_torch.JobTable._fields)
    kws = ", ".join(f"{f}=x" for f in fields[1:]) + ", bogus=x"
    (core / "omfs_torch.py").write_text(
        f"def table_from_jobs(x):\n    return JobTable({kws})\n")
    (core / "engine.py").write_text(
        "def use(tbl):\n    return " + " + ".join(
            f"tbl.{f}" for f in fields[2:]) + "\n")
    msgs = [v.message for v in check_column_dataflow(tmp_path)]
    assert any("unknown column 'bogus'" in m for m in msgs)
    assert any("never initialized" in m and "'jid'" in m for m in msgs)
    assert any("'user' is written" in m for m in msgs)      # never read


def _event_tree(tmp_path, *, events, capture="", metrics="", trace="",
                engine_src="", kernel=""):
    obs = tmp_path / "src" / "repro_torch" / "obs"
    core = tmp_path / "src" / "repro_torch" / "core"
    obs.mkdir(parents=True)
    core.mkdir(parents=True)
    (obs / "events.py").write_text(events)
    if capture is not None:
        (obs / "torch_capture.py").write_text(capture)
    (obs / "metrics.py").write_text(metrics)
    (obs / "trace.py").write_text(trace)
    (core / "engine.py").write_text(engine_src)
    (core / "omfs_torch.py").write_text(kernel)
    return tmp_path


_SCHEMA_OK = """\
class EventType:
    SUBMIT = 0
    FINISH = 1

def events_from_diff(pre, jobs, t):
    use(EventType.SUBMIT, EventType.FINISH)
"""
_CAPTURE_OK = """\
def event_flags(pre, post, t):
    use(EventType.SUBMIT, EventType.FINISH)
"""
_CONSUME_OK = "use(EventType.SUBMIT, EventType.FINISH)\n"


def test_event_schema_real_tree_and_clean_fake_pass(tmp_path):
    from repro_torch.analysis.event_schema import check_event_schema

    assert check_event_schema(REPO) == []
    root = _event_tree(tmp_path, events=_SCHEMA_OK, capture=_CAPTURE_OK,
                       metrics=_CONSUME_OK)
    assert check_event_schema(root) == []


def test_event_schema_flags_unemitted_unconsumed_and_phantom(tmp_path):
    from repro_torch.analysis.event_schema import check_event_schema

    events = ("class EventType:\n    SUBMIT = 0\n    EVICT = 1\n\n"
              "def events_from_diff(pre, jobs, t):\n"
              "    use(EventType.SUBMIT)\n")
    root = _event_tree(tmp_path, events=events,
                       capture="def event_flags(pre, post, t):\n"
                               "    use(EventType.SUBMIT)\n",
                       metrics="use(EventType.SUBMIT)\n",
                       trace="x = EventType.TELEPORT\n")
    got = check_event_schema(root)
    msgs = [v.message for v in got]
    assert any("events_from_diff never references" in m for m in msgs)
    assert any("torch flag matrix" in m for m in msgs)
    assert any("nor the trace exporter consumes" in m for m in msgs)
    assert [v.line for v in got if "not declared" in v.message] == [1]


def test_event_schema_flags_hot_path_capture_and_kernel_import(tmp_path):
    """The uninstrumented tick path referencing the capture breaks the
    plain run; `run_table_events` is the twin that may capture.  A kernel
    or a launch wrapper importing the obs layer is flagged too."""
    from repro_torch.analysis.event_schema import check_event_schema

    engine_src = ("def run_table(cfg, tbl, t):\n"
                  "    return capture_tick(tbl, tbl, t, 8)\n"
                  "def run_table_events(cfg, tbl, t):\n"
                  "    return capture_tick(tbl, tbl, t, 8)\n")
    root = _event_tree(tmp_path, events=_SCHEMA_OK, capture=_CAPTURE_OK,
                       metrics=_CONSUME_OK, engine_src=engine_src,
                       kernel="from repro_torch.obs.bus import EventBus\n")
    ops = root / "src" / "repro_torch" / "kernels" / "demo"
    ops.mkdir(parents=True)
    (ops / "ops.py").write_text("import repro_torch.obs.events\n")
    got = check_event_schema(root)
    hot = [v for v in got if "hot-path" in v.message]
    assert len(hot) == 1 and "'run_table'" in hot[0].message
    assert len([v for v in got if "kernel imports" in v.message]) == 2
    (root / "src" / "repro_torch" / "obs" / "torch_capture.py").unlink()
    assert any("no device emitter" in v.message
               for v in check_event_schema(root))


def test_known_failures_registry_valid_and_flags_a_broken_one(tmp_path):
    assert known_failures.check_known_failures(REPO) == []
    assert known_failures.load_known_failures(REPO) == \
        ref_analysis.known_failures.load_known_failures(REPO)
    reg = tmp_path / "tests" / "known_failures.toml"
    reg.parent.mkdir(parents=True)
    reg.write_text('[[failure]]\nid = "tests/nope.py::t"\nreason = ""\n')
    msgs = [v.message for v in known_failures.check_known_failures(tmp_path)]
    assert any("has no reason" in m for m in msgs)
    assert any("missing file" in m for m in msgs)


# ---------------------------------------------------------------------------
# the dispatch rules, each on a seeded fault
# ---------------------------------------------------------------------------


def _faulty(monkeypatch, policy, before=None, after=None):
    """Register ``policy`` with its pass wrapped: ``before(cfg, ent, t,
    tbl)`` runs ahead of the real pass and ``after(tbl)`` after it."""
    spec = engine.POLICIES[policy]

    def factory(pass_depth=None):
        real = spec.torch_factory(pass_depth)

        def pass_fn(cfg, ent, t, tbl, stats=None, knobs=None):
            if before is not None:
                before(cfg, ent, t, tbl)
            tbl = real(cfg, ent, t, tbl, stats, knobs)
            if after is not None:
                after(tbl)
            return tbl

        return pass_fn

    monkeypatch.setitem(engine.POLICIES, policy, engine.PolicySpec(
        policy, spec.python_pass, factory))


def _audit(policy, backends=("torch",)):
    return dispatch_audit.audit("cpu", backends=backends, policies=[policy],
                                archs=())


def test_dispatch_float_cast_fails_on_a_cost_column_cast(monkeypatch):
    report = _audit("fcfs")
    assert dispatch_audit.float_cast_violations(report, REPO) == []

    def cast(tbl):
        tbl.overhead.copy_((tbl.cost_save_lat[..., 0].float() * 1.5).int())

    _faulty(monkeypatch, "fcfs", after=cast)
    got = dispatch_audit.float_cast_violations(_audit("fcfs"), REPO)
    assert got and all(v.rule == "dispatch-float-cast" for v in got)
    assert any("aten::_to_copy" in v.message for v in got)


def test_branch_confinement_fails_on_a_plan_outside_the_branch(monkeypatch):
    report = _audit("omfs", BACKENDS_BOTH)
    assert dispatch_audit.confinement_violations(report, REPO) == []
    assert all(r.plans == r.stats.evict_branches > 0 for r in report.passes)

    def plan_first(cfg, ent, t, tbl):
        t2 = omfs_torch.JobTable(*(c.unsqueeze(0) for c in tbl))
        idle = torch.full((1,), 0, dtype=torch.int32)
        omfs_torch.plan_evictions(
            cfg, t2, omfs_torch.evictable_mask(cfg, t2, t), idle,
            torch.full((1,), 4, dtype=torch.int32))

    _faulty(monkeypatch, "omfs", before=plan_first)
    got = dispatch_audit.confinement_violations(
        _audit("omfs", BACKENDS_BOTH), REPO)
    msgs = [v.message for v in got]
    assert any("plans for" in m for m in msgs)
    assert any("outside the eviction branch" in m for m in msgs)
    assert any("a sort at" in m for m in msgs)            # the torch plan
    assert any("all admit without eviction" in m for m in msgs)


def test_dispatch_host_reads_fails_on_an_extra_item(monkeypatch):
    report = _audit("fcfs", BACKENDS_BOTH)
    assert dispatch_audit.host_read_violations(report, REPO) == []

    _faulty(monkeypatch, "fcfs", after=lambda tbl: tbl.state.sum().item())
    got = dispatch_audit.host_read_violations(
        _audit("fcfs", BACKENDS_BOTH), REPO)
    ticks = dispatch_audit.HORIZON
    assert len(got) == 2
    assert all(f"{ticks} host reads in {ticks} ticks, PassStats counts 0"
               in v.message for v in got)


BACKENDS_BOTH = dispatch_audit.BACKENDS


def test_dispatch_host_reads_counts_the_models_reads(monkeypatch):
    """A prefill reads what ``moe.HOST_READS`` counts (deepseek: one per
    MoE layer), decode nothing; a read added to a decode step fails."""
    from repro_torch.models import moe

    report = dispatch_audit.audit("cpu", backends=(), policies=[],
                                  archs=("deepseek-moe-16b", "xlstm-350m"))
    assert dispatch_audit.host_read_violations(report, REPO) == []
    deep = report.models[0]
    assert deep.prefill_reads == deep.prefill_counted > 0
    assert deep.decode_reads == 0
    route = moe._route

    def reading(*args):
        out = route(*args)
        out[0].sum().item()
        return out

    monkeypatch.setattr(moe, "_route", reading)
    report = dispatch_audit.audit("cpu", backends=(), policies=[],
                                  archs=("deepseek-moe-16b",))
    got = dispatch_audit.host_read_violations(report, REPO)
    assert len(got) == 1 and "moe.py" in got[0].message


def test_host_reads_mode_restores_tolist_and_counts_it():
    x = torch.arange(3)
    tolist = torch.Tensor.tolist
    with dispatch_audit.HostReads() as reads:
        assert x.tolist() == [0, 1, 2]
        int(x[0])
        torch.equal(x, x)
        torch.nonzero(x)
    assert torch.Tensor.tolist is tolist
    assert reads.count == 4
