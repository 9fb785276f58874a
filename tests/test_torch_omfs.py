"""The torch OMFS engine against the JAX engine: the same workload, the
same table build, and — for `omfs` and `omfs_cheap_victim` on both port
backends ("cuda", which runs the kernel's plain version on CPU tensors,
and "torch") — the same final table, column for column, and the same busy
series as ``engine.simulate(backend="jax")``."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401
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

POLICIES = ("omfs", "omfs_cheap_victim")
PORT_BACKENDS = ("cuda", "torch")
DELTA = jcr.measured_delta_num()            # 182/256


def _workload(seed=5, n_jobs=35):
    spec = jwl.WorkloadSpec(n_users=3, horizon=100, cpu_total=32, seed=seed,
                            arrival_rate=0.15, mean_work=25,
                            class_mix=(0.15, 0.35, 0.5))
    users = jwl.make_users(spec)
    return users, jwl.make_jobs(spec, users)[:n_jobs]


def _sized_workload(n_jobs, cpu_total, seed=1, n_users=16):
    """The scale benchmark's generator: reaches ``n_jobs`` rows."""
    gen_horizon = max(200, int(1.5 * n_jobs / (n_users * 0.5)))
    spec = jwl.WorkloadSpec(n_users=n_users, horizon=gen_horizon,
                            cpu_total=cpu_total, seed=seed, arrival_rate=0.5,
                            mean_work=60)
    users = jwl.make_users(spec)
    jobs = jwl.make_jobs(spec, users)[:n_jobs]
    assert len(jobs) == n_jobs
    return users, jobs


def _two_tier(cr, cap0):
    return cr.TieredCRCostModel(
        tiers=(cr.CRCostModel(save_mib_per_tick=256, restore_mib_per_tick=256),
               cr.CRCostModel(save_mib_per_tick=32, restore_mib_per_tick=32,
                              save_base=1, restore_base=1)),
        capacity_mib=(cap0, cr.UNBOUNDED))


def _lattice(cr, n_tiers, cap0, delta_num, delta_den=1):
    """tests/test_cost_lattice.py's T-deep hierarchy."""
    bws = (16384, 4096, 1024, 128)
    if cap0 == cr.UNBOUNDED:
        caps = (cr.UNBOUNDED,) * n_tiers
    else:
        caps = tuple(cap0 * (k + 1)
                     for k in range(n_tiers - 1)) + (cr.UNBOUNDED,)
    tiers = tuple(
        cr.CRCostModel(save_mib_per_tick=bws[k],
                       restore_mib_per_tick=2 * bws[k],
                       save_base=min(k, 2), delta_num=delta_num,
                       delta_den=delta_den)
        for k in range(n_tiers))
    return cr.TieredCRCostModel(tiers=tiers, capacity_mib=caps)


#: engine cases: SchedulerConfig fields, with ``tiers`` a builder taking
#: the crcost module of either package
CASES = {
    "flat": dict(cr_overhead=2),
    "tiered_bounded": dict(cr_overhead=1,
                           tiers=lambda cr: _two_tier(cr, 64)),
    "lattice_t4": dict(cr_overhead=1,
                       tiers=lambda cr: _lattice(cr, 4, 200, DELTA, 256)),
    "quantum0": dict(quantum=0, cr_overhead=1),
    "avoid_self_eviction": dict(avoid_self_eviction=True),
    "victim_filter_over_entitlement": dict(
        victim_filter_over_entitlement=True),
    "keep_killed": dict(drop_killed=False),
}


def _configs(case, cpu_total=32, quantum=3):
    kw = dict(CASES[case])
    tiers = kw.pop("tiers", None)
    kw.setdefault("quantum", quantum)
    jcfg = jtypes.SchedulerConfig(cpu_total=cpu_total,
                                  cr_tiers=tiers(jcr) if tiers else None,
                                  **kw)
    tcfgs = {b: ttypes.SchedulerConfig(
        cpu_total=cpu_total, cr_tiers=tiers(tcr) if tiers else None,
        kernel_backend=b, **kw) for b in PORT_BACKENDS}
    return jcfg, tcfgs


def _jax_columns(tbl):
    return {f: np.asarray(getattr(tbl, f)) for f in omfs_jax.JobTable._fields}


def _assert_tables_equal(jax_tbl, port_tbl, what):
    want = _jax_columns(jax_tbl)
    got = convert.table_to_numpy(port_tbl)
    for f in omfs_jax.JobTable._fields:
        assert got[f].dtype == np.int32, f"{what}: {f} is {got[f].dtype}"
        assert np.array_equal(got[f], want[f]), f"{what}: column {f}"


# ---------------------------------------------------------------------------
# workload and table build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,equal_shares,burst",
                         [(0, True, 0.0), (3, False, 0.5), (11, True, 2.0)])
def test_make_jobs_parity(seed, equal_shares, burst):
    kw = dict(n_users=5, horizon=300, cpu_total=128, seed=seed,
              arrival_rate=0.1, equal_shares=equal_shares, burstiness=burst)
    ju = jwl.make_users(jwl.WorkloadSpec(**kw))
    tu = twl.make_users(twl.WorkloadSpec(**kw))
    assert [(u.name, u.percent) for u in ju] == \
        [(u.name, u.percent) for u in tu]
    jj = jwl.make_jobs(jwl.WorkloadSpec(**kw), ju)
    tj = twl.make_jobs(twl.WorkloadSpec(**kw), tu)
    assert len(jj) == len(tj) > 0
    fields = [f.name for f in dataclasses.fields(jtypes.Job) if f.name != "id"]
    for a, b in zip(jj, tj):
        # enum fields are IntEnums in both packages: equal iff same value
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields]
        assert a.state_mib == b.state_mib


@pytest.mark.parametrize("n_tiers", [1, 2, 3, 4])
@pytest.mark.parametrize("cap0", [0, 2_000, jcr.UNBOUNDED])
def test_table_from_jobs_columns_equal(n_tiers, cap0):
    users, jobs = _workload(seed=n_tiers)
    tu, tj = convert.jobs_from_reference(users, jobs)
    jcfg = jtypes.SchedulerConfig(
        cpu_total=32, cr_overhead=1,
        cr_tiers=_lattice(jcr, n_tiers, cap0, DELTA, 256))
    tcfg = ttypes.SchedulerConfig(
        cpu_total=32, cr_overhead=1,
        cr_tiers=_lattice(tcr, n_tiers, cap0, DELTA, 256))
    jt, jent = omfs_jax.table_from_jobs(jobs, users, 32, jcfg)
    tt, tent = omfs_torch.table_from_jobs(tj, tu, 32, tcfg, device="cpu")
    _assert_tables_equal(jt, tt, f"T={n_tiers}")
    assert np.array_equal(np.asarray(jent), tent.numpy())
    assert tt.cost_save_lat.shape == (len(jobs), n_tiers)
    assert torch.equal(tt.cost_save2, tt.cost_save_lat[:, -1])


def test_untiered_table_and_delta_pricing_match():
    users, jobs = _workload(seed=2)
    tu, tj = convert.jobs_from_reference(users, jobs)
    model = dict(save_mib_per_tick=64, restore_mib_per_tick=128,
                 save_base=1, delta_num=DELTA, delta_den=256)
    jt, _ = omfs_jax.table_from_jobs(jobs, users, 32, jtypes.SchedulerConfig(
        cpu_total=32, cr_cost=jcr.CRCostModel(**model)))
    tt, _ = omfs_torch.table_from_jobs(tj, tu, 32, ttypes.SchedulerConfig(
        cpu_total=32, cr_cost=tcr.CRCostModel(**model)), device="cpu")
    _assert_tables_equal(jt, tt, "untiered")
    assert (tt.cost_rsave_lat <= tt.cost_save_lat).all()


# ---------------------------------------------------------------------------
# the engine: final table + busy series against engine.simulate(jax)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax(case, policy):
    users, jobs = _workload()
    tu, tj = convert.jobs_from_reference(users, jobs)
    jcfg, tcfgs = _configs(case)
    want = jengine.simulate(users, jobs, jcfg, 100, policy=policy,
                            backend="jax")
    for backend, tcfg in tcfgs.items():
        got = tengine.simulate(tu, tj, tcfg, 100, policy, device="cpu")
        what = f"{case}/{policy}/{backend}"
        _assert_tables_equal(want.table, got.table, what)
        assert np.array_equal(got.busy_series(), want.busy_series()), what
        assert got.signature() == want.signature()
        assert got.summary() == {**want.summary(), "backend": "torch"}
        assert got.stats.host_syncs == 100 * len(jobs)
    if case in ("tiered_bounded", "lattice_t4"):
        assert got.summary()["spills"] > 0, "fixture never spilled"
    if case in ("flat", "tiered_bounded"):
        assert got.summary()["preemptions"] > 0, "fixture never evicted"


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", ["flat", "tiered_bounded"])
def test_engine_matches_jax_pallas_interpret(case, policy):
    users, jobs = _workload()
    tu, tj = convert.jobs_from_reference(users, jobs)
    jcfg, tcfgs = _configs(case)
    want = jengine.simulate(
        users, jobs, dataclasses.replace(jcfg,
                                         kernel_backend="pallas_interpret"),
        100, policy=policy, backend="jax")
    got = tengine.simulate(tu, tj, tcfgs["cuda"], 100, policy, device="cpu")
    _assert_tables_equal(want.table, got.table, f"{case}/{policy}")
    assert np.array_equal(got.busy_series(), want.busy_series())


@pytest.mark.parametrize("cheap", [False, True])
def test_reference_pass_matches_jax(cheap):
    users, jobs = _workload(seed=3)
    tu, tj = convert.jobs_from_reference(users, jobs)
    jcfg, tcfgs = _configs("tiered_bounded", quantum=2)
    jt, jbusy = omfs_jax.simulate_jax(users, jobs, jcfg, 80,
                                      incremental=False, cheap_victims=cheap)
    for backend, tcfg in tcfgs.items():
        tt, tbusy = tengine.run_torch(
            tu, tj, tcfg, 80,
            omfs_torch.make_omfs_pass(None, incremental=False,
                                      cheap_victims=cheap), device="cpu")
        _assert_tables_equal(jt, tt, f"reference/{backend}")
        assert np.array_equal(tbusy.numpy(), np.asarray(jbusy))


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_matches_jax_at_j2000_pass_depth16(policy):
    users, jobs = _sized_workload(2000, cpu_total=64)
    tu, tj = convert.jobs_from_reference(users, jobs)
    jcfg = jtypes.SchedulerConfig(cpu_total=64, quantum=2, cr_overhead=1,
                                  cr_tiers=_two_tier(jcr, 512))
    want = jengine.simulate(users, jobs, jcfg, 30, policy=policy,
                            backend="jax", pass_depth=16)
    for backend in PORT_BACKENDS:
        tcfg = ttypes.SchedulerConfig(cpu_total=64, quantum=2, cr_overhead=1,
                                      cr_tiers=_two_tier(tcr, 512),
                                      kernel_backend=backend)
        got = tengine.simulate(tu, tj, tcfg, 30, policy, pass_depth=16,
                               device="cpu")
        _assert_tables_equal(want.table, got.table, f"J=2000/{backend}")
        assert np.array_equal(got.busy_series(), want.busy_series())
        assert got.stats.host_syncs == 30 * 16
        assert got.summary()["preemptions"] > 0


def test_update_state_mib_matches_jax():
    users, jobs = _workload(seed=4)
    tu, tj = convert.jobs_from_reference(users, jobs)
    jcfg = jtypes.SchedulerConfig(
        cpu_total=32, cr_overhead=1, cr_tiers=_lattice(jcr, 3, 500, DELTA,
                                                       256))
    tcfg = ttypes.SchedulerConfig(
        cpu_total=32, cr_overhead=1, cr_tiers=_lattice(tcr, 3, 500, DELTA,
                                                       256))
    jt, _ = omfs_jax.table_from_jobs(jobs, users, 32, jcfg)
    tt, _ = omfs_torch.table_from_jobs(tj, tu, 32, tcfg, device="cpu")
    for idx, mib in ((0, 70_000), (5, 0), (9, 1 << 22), (len(jobs) - 1, 3)):
        jt = omfs_jax.update_state_mib(jt, idx, mib, jcfg)
        tt = omfs_torch.update_state_mib(tt, idx, mib, tcfg)
    _assert_tables_equal(jt, tt, "update_state_mib")


def test_empty_table_and_config_checks():
    users, _ = _workload()
    tu, _ = convert.jobs_from_reference(users, [])
    res = tengine.simulate(tu, [], ttypes.SchedulerConfig(cpu_total=32), 7,
                           device="cpu")
    assert res.busy_series().tolist() == [0] * 7
    with pytest.raises(ValueError, match="kernel_backend"):
        ttypes.SchedulerConfig(kernel_backend="lax")
    with pytest.raises(ValueError, match="unknown policy"):
        tengine.simulate(tu, [], ttypes.SchedulerConfig(), 3, "nope",
                         device="cpu")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    users, jobs = _workload()
    tu, tj = convert.jobs_from_reference(users, jobs)
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.simulate(tu, tj, ttypes.SchedulerConfig(cpu_total=32), 5)
