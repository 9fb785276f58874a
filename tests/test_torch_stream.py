"""The port's streaming engine (`repro_torch.core.engine.simulate_stream`)
against the reference's (`repro.core.engine.simulate_stream`) and against
the port's own monolithic `simulate`, on both port kernel backends: a
fixed-capacity table fed by an arrival iterator, run in segments with
host-side compaction between them, gives the reference's merged table,
busy series, ``stream_stats`` and event log bit for bit — at ten times
its capacity in jobs, under tiered eviction churn, when capacity runs out
(deferrals), and on an endless feed.  Also: `insert_rows` against
`omfs_jax.insert_rows`, its refusal of a ``slots`` that is not a
permutation, the argument checks, the profile's sections and the one
table read per boundary.
"""
import itertools

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
from repro_torch.core import convert, omfs_torch  # noqa: E402
from repro_torch.core import crcost as tcr  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core import workload as twl  # noqa: E402
from repro_torch.obs.profile import ProfileTimers  # noqa: E402

PORT_BACKENDS = ("cuda", "torch")


@pytest.fixture(scope="module", autouse=True)
def _clear_reference_segment_runners():
    """Leave the reference's segment-runner caches as this file found
    them: its streams compile shapes (capacity 4) into the same
    ``lru_cache`` entries that ``tests/test_streaming.py`` counts."""
    yield
    jengine._jitted_segment_runner.cache_clear()
    jengine._jitted_segment_runner_events.cache_clear()
CAPACITY = 12
N_JOBS = 10 * CAPACITY


def _conveyor_jobs():
    """tests/test_streaming.py's conveyor: ten times more jobs than slots,
    paced so the live set stays under CAPACITY, plus periodic entitled
    claims of user A that go through the eviction path."""
    users = [jtypes.User("A", 50.0), jtypes.User("B", 50.0)]
    jobs = [jtypes.Job(user="B", cpus=4, work=8, priority=i % 4,
                       job_class=jtypes.JobClass.CHECKPOINTABLE,
                       submit_time=3 * i, state_bytes=(64 + i % 5) << 20)
            for i in range(N_JOBS)]
    for k in range(10):
        jobs.append(jtypes.Job(user="A", cpus=8, work=6,
                               job_class=jtypes.JobClass.CHECKPOINTABLE,
                               submit_time=25 + 30 * k,
                               state_bytes=32 << 20))
    return users, jobs, 3 * N_JOBS + 60


def _tiers(cr):
    return cr.TieredCRCostModel(
        tiers=(cr.CRCostModel(save_mib_per_tick=256, restore_mib_per_tick=256),
               cr.CRCostModel(save_mib_per_tick=32, restore_mib_per_tick=32,
                              save_base=1, restore_base=1)),
        capacity_mib=(64, cr.UNBOUNDED))


def _cfgs(tiered=False, cpu_total=16, quantum=2, cr_overhead=1):
    jcfg = jtypes.SchedulerConfig(cpu_total=cpu_total, quantum=quantum,
                                  cr_overhead=cr_overhead,
                                  cr_tiers=_tiers(jcr) if tiered else None)
    tcfgs = {b: ttypes.SchedulerConfig(
        cpu_total=cpu_total, quantum=quantum, cr_overhead=cr_overhead,
        cr_tiers=_tiers(tcr) if tiered else None, kernel_backend=b)
        for b in PORT_BACKENDS}
    return jcfg, tcfgs


def _assert_equal(got, want, what):
    """Every column, the busy series, the stream stats where both have
    them, and the event record when there is one."""
    cols = convert.table_to_numpy(got.table)
    for f in omfs_jax.JobTable._fields:
        w = np.asarray(getattr(want.table, f))
        assert cols[f].dtype == np.int32, f"{what}: {f} is {cols[f].dtype}"
        assert np.array_equal(cols[f], w), f"{what}: column {f}"
    assert np.array_equal(got.busy_series(), want.busy_series()), what
    if want.stream_stats is not None:
        assert got.stream_stats == want.stream_stats, what
    if want.events is not None:
        assert got.events == want.events, f"{what}: events"
        assert np.array_equal(got.event_counts, want.event_counts), what
        assert np.array_equal(got.events_dropped, want.events_dropped), what


def _stream_both(users, jobs, jcfg, tcfg, horizon, policy="omfs", **kw):
    """The reference's stream and the port's over the same jobs."""
    want = jengine.simulate_stream(users, jwl.arrival_stream(jobs), jcfg,
                                   horizon, policy, **kw)
    tu, tj = convert.jobs_from_reference(users, jobs)
    got = tengine.simulate_stream(tu, twl.arrival_stream(tj), tcfg, horizon,
                                  policy, device="cpu", **kw)
    return got, want, (tu, tj)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_stream_matches_monolithic_at_10x_capacity(backend):
    users, jobs, horizon = _conveyor_jobs()
    jcfg, tcfgs = _cfgs()
    got, want, (tu, tj) = _stream_both(users, jobs, jcfg, tcfgs[backend],
                                       horizon, capacity=CAPACITY,
                                       segment_len=16)
    _assert_equal(got, want, f"stream/{backend}")
    stats = got.stream_stats
    assert stats["deferrals"] == 0 and stats["dropped"] == 0
    assert stats["peak_live"] <= CAPACITY
    assert stats["inserted"] == len(jobs) >= 10 * CAPACITY
    mono = tengine.simulate(tu, tj, tcfgs[backend], horizon, "omfs",
                            device="cpu")
    assert int(mono.table.n_preempt.sum()) > 0, "the conveyor must evict"
    for f in omfs_torch.JobTable._fields:
        assert torch.equal(getattr(got.table, f), getattr(mono.table, f)), f
    assert np.array_equal(got.busy_series(), mono.busy_series())
    assert got.signature() == mono.signature()
    assert got.summary()["goodput"] == mono.summary()["goodput"]
    # one table read at each boundary and one at the end; the OMFS pass
    # sweeps the CAPACITY slots, not the monolithic table's rows
    assert got.stats.table_reads == stats["segments"] + 1
    assert got.stats.host_syncs == horizon * CAPACITY
    assert got.stats.evict_branches == mono.stats.evict_branches


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_stream_eviction_churn_tiered_costs(backend):
    """Recycled slots perturb neither the victim order (the jid
    tie-break) nor the spill accounting."""
    users, jobs, horizon = _conveyor_jobs()
    jcfg, tcfgs = _cfgs(tiered=True)
    got, want, (tu, tj) = _stream_both(
        users, jobs, jcfg, tcfgs[backend], horizon, "omfs_cheap_victim",
        capacity=16, segment_len=16)
    _assert_equal(got, want, f"churn/{backend}")
    assert got.stream_stats["deferrals"] == 0
    mono = tengine.simulate(tu, tj, tcfgs[backend], horizon,
                            "omfs_cheap_victim", device="cpu")
    assert int(mono.table.n_spill.sum()) > 0, "the fixture must spill"
    for f in omfs_torch.JobTable._fields:
        assert torch.equal(getattr(got.table, f), getattr(mono.table, f)), f


@pytest.mark.parametrize("policy", ["omfs", "backfill_cr"])
def test_stream_capacity_exhaustion_defers_like_jax(policy):
    """More live jobs than slots: the same deferrals, drops and table as
    the reference's stream."""
    users, jobs, horizon = _conveyor_jobs()
    jcfg, tcfgs = _cfgs()
    got, want, _ = _stream_both(users, jobs, jcfg, tcfgs["cuda"], horizon,
                                policy, capacity=4, segment_len=32)
    _assert_equal(got, want, f"exhaustion/{policy}")
    stats = got.stream_stats
    assert stats["deferrals"] > 0
    assert stats["peak_live"] <= 4
    assert got.table.cpus.shape[0] == stats["inserted"]
    assert stats["inserted"] + stats["dropped"] <= len(jobs)
    assert got.busy_series().shape == (horizon,)


def test_endless_arrivals_feed_contract_and_bounded_memory():
    """The port's own endless feed is sorted and crosses epochs; the stream
    takes exactly the prefix due before the horizon at bounded memory;
    and over the reference's feed the port's stream equals the
    reference's."""
    spec = twl.WorkloadSpec(n_users=3, horizon=120, cpu_total=32, seed=13,
                            arrival_rate=0.05, mean_work=10)
    users = twl.make_users(spec)
    peek = list(itertools.islice(twl.endless_arrivals(spec, users), 300))
    submits = [j.submit_time for j in peek]
    assert submits == sorted(submits), "endless_arrivals must be sorted"
    assert submits[-1] > spec.horizon, "must cross epoch boundaries"
    cfg = ttypes.SchedulerConfig(cpu_total=32, quantum=3)
    horizon = 3 * spec.horizon
    res = tengine.simulate_stream(users, twl.endless_arrivals(spec, users),
                                  cfg, horizon, capacity=64, segment_len=40,
                                  device="cpu")
    stats = res.stream_stats
    assert stats["peak_live"] <= 64
    assert res.table.cpus.shape[0] == stats["inserted"] > 0
    assert int(res.table.submit.max()) < horizon

    jspec = jwl.WorkloadSpec(n_users=3, horizon=120, cpu_total=32, seed=13,
                             arrival_rate=0.05, mean_work=10)
    jusers = jwl.make_users(jspec)
    # the reference feed's prefix the stream can reach, and one job past it
    due = list(itertools.takewhile(
        lambda j: j.submit_time <= horizon,
        jwl.endless_arrivals(jspec, jusers)))
    want = jengine.simulate_stream(
        jusers, iter(due), jtypes.SchedulerConfig(cpu_total=32, quantum=3),
        horizon, capacity=64, segment_len=40)
    tu, tj = convert.jobs_from_reference(jusers, due)
    got = tengine.simulate_stream(tu, iter(tj), cfg, horizon, capacity=64,
                                  segment_len=40, device="cpu")
    _assert_equal(got, want, "endless")


@pytest.mark.parametrize("segment_len", [7, 25, 64])
def test_stream_events_match_jax(segment_len):
    """The conveyor's decoded log through 16 recycled slots (true jids,
    per-segment start ticks) equals the reference stream's."""
    users, jobs, horizon = _conveyor_jobs()
    jcfg, tcfgs = _cfgs(tiered=True)
    got, want, _ = _stream_both(
        users, jobs, jcfg, tcfgs["cuda"], horizon, capacity=16,
        segment_len=segment_len, record_events=True)
    _assert_equal(got, want, f"events/{segment_len}")
    assert got.stream_stats["events_dropped"] == 0


def test_stream_events_at_ample_capacity_match_monolithic():
    """With a slot for every job the stream's log is the monolithic run's
    (the port's and the reference's)."""
    users, jobs, horizon = _conveyor_jobs()
    jcfg, tcfgs = _cfgs(tiered=True)
    tu, tj = convert.jobs_from_reference(users, jobs)
    got = tengine.simulate_stream(tu, twl.arrival_stream(tj), tcfgs["torch"],
                                  horizon, capacity=len(jobs),
                                  segment_len=25, record_events=True,
                                  device="cpu")
    mono = tengine.simulate(tu, tj, tcfgs["torch"], horizon, "omfs",
                            device="cpu", record_events=True)
    want = jengine.simulate(users, jobs, jcfg, horizon, "omfs",
                            backend="jax", record_events=True)
    for ref in (mono, want):
        assert got.events == ref.events
        assert np.array_equal(got.event_counts, ref.event_counts)


def test_stream_undersized_ring_drops_like_jax():
    users, jobs, horizon = _conveyor_jobs()
    jcfg, tcfgs = _cfgs()
    got, want, _ = _stream_both(users, jobs, jcfg, tcfgs["torch"], horizon,
                                capacity=CAPACITY, segment_len=16,
                                record_events=True, event_ring=2)
    _assert_equal(got, want, "ring 2")
    assert got.stream_stats["events_dropped"] > 0


def test_stream_profile_sections_and_argument_checks():
    users, jobs, horizon = _conveyor_jobs()
    tu, tj = convert.jobs_from_reference(users, jobs)
    _, tcfgs = _cfgs()
    timers = ProfileTimers()
    res = tengine.simulate_stream(tu, twl.arrival_stream(tj), tcfgs["cuda"],
                                  horizon, capacity=CAPACITY, segment_len=32,
                                  profile=timers, device="cpu")
    snap = timers.snapshot()
    segments = res.stream_stats["segments"]
    # no kernel library is built for CPU tables: every segment dispatches
    assert set(snap) == {"compaction", "dispatch"}
    assert snap["dispatch"]["calls"] == snap["compaction"]["calls"] == segments
    for kw, msg in ((dict(capacity=0, segment_len=8), "capacity"),
                    (dict(capacity=8, segment_len=0), "segment_len")):
        with pytest.raises(ValueError, match=msg):
            tengine.simulate_stream(tu, iter(tj), tcfgs["cuda"], 10,
                                    device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown policy"):
        tengine.simulate_stream(tu, iter(tj), tcfgs["cuda"], 10, "nope",
                                capacity=8, segment_len=8, device="cpu")


# ---------------------------------------------------------------------------
# insert_rows
# ---------------------------------------------------------------------------


def _random_table(rng, n, n_tiers=2):
    cols = {f: rng.integers(-1, 50, n).astype(np.int32)
            for f in omfs_jax.JobTable._fields}
    for f in ("cost_save_lat", "cost_rsave_lat", "cost_restore_lat"):
        cols[f] = rng.integers(0, 9, (n, n_tiers)).astype(np.int32)
    return cols


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_rows_matches_jax(seed):
    """The permutation scatter, in place, against `omfs_jax.insert_rows`."""
    rng = np.random.default_rng(seed)
    n = 23
    base, new = _random_table(rng, n), _random_table(rng, n)
    slots = rng.permutation(n).astype(np.int32)
    valid = rng.random(n) < 0.5
    want = omfs_jax.insert_rows(
        omfs_jax.JobTable(**{f: jnp.asarray(v) for f, v in base.items()}),
        jnp.asarray(slots), omfs_jax.JobTable(
            **{f: jnp.asarray(v) for f, v in new.items()}),
        jnp.asarray(valid))
    tbl = convert.table_from_numpy(base, device="cpu")
    got = omfs_torch.insert_rows(tbl, slots,
                                 convert.table_from_numpy(new, device="cpu"),
                                 torch.from_numpy(valid))
    assert got is tbl
    for f in omfs_jax.JobTable._fields:
        assert np.array_equal(getattr(tbl, f).numpy(),
                              np.asarray(getattr(want, f))), f


def test_insert_rows_refuses_a_slots_that_is_not_a_permutation():
    rng = np.random.default_rng(3)
    n = 8
    tbl = convert.table_from_numpy(_random_table(rng, n), device="cpu")
    rows = convert.table_from_numpy(_random_table(rng, n), device="cpu")
    valid = np.ones(n, bool)
    for bad in (np.zeros(n, np.int64), np.arange(n - 1),
                np.arange(1, n + 1)):
        with pytest.raises(ValueError, match="permutation"):
            omfs_torch.insert_rows(tbl, bad, rows, valid)
    ok = omfs_torch.insert_rows(tbl, torch.arange(n).flip(0), rows, valid)
    assert torch.equal(ok.jid, rows.jid.flip(0))
