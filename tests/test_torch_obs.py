"""The port's lifecycle-event capture against the reference.

For every registered policy: ``events``, ``event_counts`` and
``events_dropped`` from the port's tensor backend (on CPU tables) equal
``repro``'s JAX capture, and from the port's Python backend ``repro``'s
EventBus; capture changes neither the table nor the host reads.  Then the
bounded ring's drop accounting, `capture_tick` alone against
``repro.obs.jax_capture.capture_tick``, the Prometheus scrape, the trace,
and the launcher's event flags."""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import crcost as jcr  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import omfs_jax  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core import workload as jwl  # noqa: E402
from repro.launch import cluster_sim as jlaunch  # noqa: E402
from repro.obs import jax_capture  # noqa: E402
from repro.obs import registry_from_result as j_registry  # noqa: E402
from repro.obs import trace_from_result as j_trace  # noqa: E402
from repro_torch.core import convert, omfs_torch  # noqa: E402
from repro_torch.core import crcost as tcr  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.launch import cluster_sim as tlaunch  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    EventType,
    canonical_sort,
    lossless_ring_size,
    registry_from_result,
    torch_capture,
    trace_from_result,
    validate_trace,
)
from repro_torch.obs.trace import main as trace_main  # noqa: E402

POLICY_NAMES = sorted(jengine.POLICIES)
HORIZON = 100


def _workload(seed, n_users=3, n_jobs=35, horizon=HORIZON, cpu_total=32):
    """tests/test_obs_events.py's generator, in both packages."""
    spec = jwl.WorkloadSpec(n_users=n_users, horizon=horizon,
                            cpu_total=cpu_total,
                            seed=seed, arrival_rate=0.12, mean_work=30,
                            class_mix=(0.15, 0.35, 0.5))
    users = jwl.make_users(spec)
    jobs = jwl.make_jobs(spec, users)[:n_jobs]
    return (users, jobs), convert.jobs_from_reference(users, jobs)


def _tiered_cfg(types, cr, quantum=4, **kw):
    """tests/test_obs_events.py's two-tier config, in either package."""
    tiers = cr.TieredCRCostModel(
        tiers=(cr.CRCostModel(save_mib_per_tick=4096,
                              restore_mib_per_tick=8192),
               cr.CRCostModel(save_mib_per_tick=512, restore_mib_per_tick=1024,
                              save_base=1)),
        capacity_mib=(2_000, cr.UNBOUNDED))
    return types.SchedulerConfig(cpu_total=32, quantum=quantum, cr_overhead=1,
                                 cr_tiers=tiers, **kw)


def _assert_same_log(got, want, what):
    assert got.events == want.events, what
    assert got.events == canonical_sort(got.events), what
    assert np.array_equal(got.event_counts, want.event_counts), what
    assert got.event_counts.dtype == np.int64
    assert np.array_equal(got.events_dropped, want.events_dropped), what


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_event_logs_match_reference_on_both_backends(policy):
    (users, jobs), (tu, tj) = _workload(seed=6)
    jcfg = _tiered_cfg(jtypes, jcr)
    jx = jengine.simulate(users, jobs, jcfg, HORIZON, policy=policy,
                          backend="jax", record_events=True)
    ref_py = jengine.simulate(users, jobs, jcfg, HORIZON, policy=policy,
                              backend="python", record_events=True)
    tcfg = _tiered_cfg(ttypes, tcr)
    got = tengine.simulate(tu, tj, tcfg, HORIZON, policy, device="cpu",
                           record_events=True)
    port_py = tengine.simulate(tu, tj, tcfg, HORIZON, policy,
                               backend="python", record_events=True)
    _assert_same_log(got, jx, f"{policy}/torch")
    _assert_same_log(port_py, ref_py, f"{policy}/python")
    _assert_same_log(got, port_py, f"{policy}/torch vs python")
    assert got.events_dropped_total() == 0
    assert len(got.events) == int(got.event_counts.sum())
    # capture mutates nothing and reads nothing back per tick
    plain = tengine.simulate(tu, tj, tcfg, HORIZON, policy, device="cpu")
    assert plain.events is None and plain.event_counts is None
    for f in omfs_torch.JobTable._fields:
        assert torch.equal(getattr(got.table, f), getattr(plain.table, f)), f
    assert np.array_equal(got.busy_series(), plain.busy_series())
    assert got.stats == plain.stats
    assert got.signature() == jx.signature()
    if policy in ("backfill_cr", "omfs", "omfs_cheap_victim"):
        assert int(got.event_counts[:, EventType.EVICT].sum()) > 0


@pytest.mark.parametrize("ring", [4, 8])
def test_undersized_ring_counts_every_drop(ring):
    """Forced overflow: per tick exactly ``total - R`` events are dropped,
    the kept ones are the ring's prefix of the full log, and the counts
    stay exact — as the JAX capture does."""
    (users, jobs), (tu, tj) = _workload(seed=9, n_users=4)
    tcfg = _tiered_cfg(ttypes, tcr)
    full = tengine.simulate(tu, tj, tcfg, HORIZON, "omfs", device="cpu",
                            record_events=True)
    tiny = tengine.simulate(tu, tj, tcfg, HORIZON, "omfs", device="cpu",
                            record_events=True, event_ring=ring)
    jx = jengine.simulate(users, jobs, _tiered_cfg(jtypes, jcr), HORIZON,
                          policy="omfs", backend="jax", record_events=True,
                          event_ring=ring)
    _assert_same_log(tiny, jx, f"ring={ring}")
    totals = full.event_counts.sum(axis=1)
    assert np.array_equal(tiny.events_dropped, np.maximum(totals - ring, 0))
    assert tiny.events_dropped_total() > 0
    assert (int(tiny.event_counts.sum())
            == len(tiny.events) + tiny.events_dropped_total())
    assert np.array_equal(tiny.event_counts, full.event_counts)
    assert set(tiny.events) <= set(full.events)


def _random_tables(rng, n, n_tiers=3):
    """A pre and a post table of random int32 columns (states, ticks and
    counters in ranges the rules compare), for the capture alone."""
    t = 7

    def col(lo, hi):
        return rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)

    pre = {f: col(0, 5) for f in omfs_jax.JobTable._fields}
    for f in ("cost_save_lat", "cost_rsave_lat", "cost_restore_lat"):
        pre[f] = rng.integers(0, 9, (n, n_tiers)).astype(np.int32)
    pre["jid"] = rng.permutation(n).astype(np.int32) + 100
    pre["submit"] = col(0, 2 * t)
    pre["ckpt_tier"] = col(-1, n_tiers)
    post = dict(pre)
    post.update(state=col(0, 5), run_start=col(t - 1, t + 2),
                finish=col(t - 1, t + 2), progress=col(0, 50),
                n_preempt=pre["n_preempt"] + col(0, 2),
                n_ckpt=pre["n_ckpt"] + col(0, 2),
                n_spill=pre["n_spill"] + col(0, 2),
                ckpt_tier=col(-1, n_tiers), cpus=col(1, 64))
    return pre, post, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capture_tick_matches_jax_capture(seed):
    rng = np.random.default_rng(seed)
    n = 257
    pre, post, t = _random_tables(rng, n)
    jpre, jpost = (omfs_jax.JobTable(**{f: jnp.asarray(v)
                                        for f, v in d.items()})
                   for d in (pre, post))
    tpre, tpost = (convert.table_from_numpy(d, device="cpu")
                   for d in (pre, post))
    for ring in (lossless_ring_size(n), 8, 1, 0):
        want = jax_capture.capture_tick(jpre, jpost, jnp.int32(t), ring)
        got = torch_capture.capture_tick(tpre, tpost, t, ring)
        for g, w, name in zip(got, want, ("counts", "ring", "dropped")):
            assert g.dtype == torch.int32, name
            assert np.array_equal(g.numpy(), np.asarray(w)), (ring, name)
        decoded = torch_capture.decode_events(got[0][None], got[1][None],
                                              got[2][None], t0=t)
        assert decoded == jax_capture.decode_events(
            np.asarray(want[0])[None], np.asarray(want[1])[None],
            np.asarray(want[2])[None], t0=t)
    assert int(got[2]) > 0


def test_snapshot_copies_the_columns_the_tick_writes():
    _, (tu, tj) = _workload(seed=6)
    tbl, _ = omfs_torch.table_from_jobs(tj, tu, 32, device="cpu")
    pre = torch_capture.snapshot(tbl)
    tbl.state.fill_(omfs_torch.RUNNING)
    tbl.n_ckpt.add_(1)
    assert int(pre.state.max()) == omfs_torch.UNSUB
    assert int(pre.n_ckpt.sum()) == 0
    assert pre.cpus is tbl.cpus     # static columns are not copied


@pytest.mark.parametrize("backend", ["torch", "python"])
def test_scrape_and_trace_match_reference(backend):
    """The Prometheus text is byte-identical to the reference's, the
    metrics JSON equal, and the trace equal up to its backend tag and
    valid."""
    # tests/test_obs_trace.py's arrows case: omfs evicts and restarts
    (users, jobs), (tu, tj) = _workload(seed=12, n_jobs=30, horizon=120,
                                        cpu_total=16)
    jcfg = jtypes.SchedulerConfig(cpu_total=16, quantum=2, cr_overhead=2)
    tcfg = ttypes.SchedulerConfig(cpu_total=16, quantum=2, cr_overhead=2)
    want = jengine.simulate(users, jobs, jcfg, 120, policy="omfs",
                            backend="jax" if backend == "torch" else backend,
                            record_events=True)
    got = tengine.simulate(tu, tj, tcfg, 120, "omfs", backend=backend,
                           device="cpu", record_events=True)
    reg, jreg = registry_from_result(got, users=tu), j_registry(want,
                                                                users=users)
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert reg.to_json() == jreg.to_json()
    trace, jtrace = trace_from_result(got, users=tu), j_trace(want,
                                                              users=users)
    assert trace["otherData"]["backend"] == backend
    trace["otherData"]["backend"] = jtrace["otherData"]["backend"] = "any"
    assert json.dumps(trace, sort_keys=True) == json.dumps(jtrace,
                                                           sort_keys=True)
    assert validate_trace(trace, events=got.events) == []
    assert any(e.get("ph") == "s" for e in trace["traceEvents"])


def test_event_summary_matches_compute_metrics():
    _, (tu, tj) = _workload(seed=5)
    res = tengine.simulate(tu, tj, _tiered_cfg(ttypes, tcr), HORIZON, "omfs",
                           backend="python", record_events=True)
    m = tmetrics.compute_metrics(res.sim)
    ev = tmetrics.event_summary(res.events)
    assert ev["preemptions"] == m.preemptions > 0
    assert ev["checkpoints"] == m.checkpoints
    assert ev["spilled_checkpoints"] == m.spilled_checkpoints
    assert ev["mean_wait"] == pytest.approx(m.mean_wait)
    assert ev["p95_wait"] == pytest.approx(m.p95_wait)
    assert ev["jobs_done"] == m.throughput * HORIZON


def _first_jid(trace):
    return min(e["args"]["jid"] for e in trace["traceEvents"]
               if e.get("ph") == "X")


def _shift_ids(trace, d):
    """``trace`` with every job id moved by ``d``: each package numbers
    the jobs its generator makes from its own counter."""
    out = json.loads(json.dumps(trace))
    for e in out["traceEvents"]:
        if e.get("ph") == "X":
            e["args"]["jid"] += d
            e["name"] = f"job {e['args']['jid']}"
        elif e.get("ph") in ("s", "f"):
            e["id"] += d
    return out


def test_launcher_event_flags_write_what_the_reference_writes(tmp_path):
    args = ["--policy", "backfill_cr", "--chips", "64", "--tenants", "3",
            "--horizon", "120", "--quantum", "5", "--pass-depth", "16",
            "--save-mib-per-tick", "512", "--fast-tier-cap-mib", "1024",
            "--arrival-rate", "0.1", "--events"]
    out = {}
    for name, main, extra in (("port", tlaunch.main, ["--device", "cpu"]),
                              ("ref", jlaunch.main, ["--backend", "jax"])):
        paths = [tmp_path / f"{name}_trace.json",
                 tmp_path / f"{name}_metrics.json"]
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(args + extra + ["--trace-out", str(paths[0]),
                                 "--metrics-out", str(paths[1])])
        out[name] = ([json.loads(p.read_text()) for p in paths],
                     buf.getvalue().splitlines())
    (trace, metrics), lines = out["port"]
    (jtrace, jmetrics), jlines = out["ref"]
    assert validate_trace(trace) == []
    assert metrics == jmetrics
    trace["otherData"]["backend"] = jtrace["otherData"]["backend"] = "any"
    assert _shift_ids(trace, -_first_jid(trace)) == _shift_ids(
        jtrace, -_first_jid(jtrace))
    events_line = [ln for ln in lines if ln.startswith("events: ")]
    assert events_line == [ln for ln in jlines if ln.startswith("events: ")]
    assert "evicts 0 " not in events_line[0]
    assert lines[-1] == jlines[-1]


@pytest.mark.parametrize("backend", ["python", "torch"])
def test_trace_cli_writes_and_validates(backend, tmp_path, capsys):
    out = tmp_path / "trace.json"
    rc = trace_main(["--backend", backend, "--device", "cpu", "--horizon",
                     "80", "--jobs", "20", "--out", str(out), "--validate"])
    assert rc == 0
    assert "trace valid" in capsys.readouterr().out
    assert validate_trace(json.loads(out.read_text())) == []
