"""The port's seven policies against the reference, on both port backends.

For every registered policy: the port's tensor backend (``"torch"`` on CPU
tables, with both kernel backends — ``"cuda"`` runs `sched_select`'s plain
version on CPU tensors) against ``repro``'s JAX backend, column for column
and busy series; the port's Python backend against ``repro``'s Python
backend, job for job; and the port's two backends against each other.
Also `simulate_matrix`, the registry, the backfilled flag, the buddy
allocator, `compute_metrics`, and the passes' host reads."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the suite imports both frameworks)
import torch  # noqa: E402

from repro.core import crcost as jcr  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import omfs_jax, policies_jax  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core import workload as jwl  # noqa: E402
from repro_torch.analysis.dispatch_audit import (  # noqa: E402
    HostReads as _HostReads,
)
from repro_torch.core import convert, omfs_torch, policies_torch  # noqa: E402
from repro_torch.core import crcost as tcr  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import placement as tplacement  # noqa: E402
from repro_torch.core import simulator as tsimulator  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402

POLICY_NAMES = sorted(jengine.POLICIES)
PORT_BACKENDS = ("cuda", "torch")
#: the policies whose passes plan evictions (`plan_evictions`)
PLANNERS = ("backfill_cr", "omfs", "omfs_cheap_victim")
HORIZON = 100


def _workload(seed, n_users=3, horizon=HORIZON, n_jobs=35):
    """tests/test_policies_equivalence.py's generator, in both packages."""
    spec = jwl.WorkloadSpec(n_users=n_users, horizon=horizon, cpu_total=32,
                            seed=seed, arrival_rate=0.12, mean_work=30,
                            class_mix=(0.15, 0.35, 0.5))
    users = jwl.make_users(spec)
    jobs = jwl.make_jobs(spec, users)[:n_jobs]
    return (users, jobs), convert.jobs_from_reference(users, jobs)


def _two_tier(cr, cap0):
    """test_policy_equivalence_tiered_placement's fast tier + durable
    spill."""
    return cr.TieredCRCostModel(
        tiers=(cr.CRCostModel(save_mib_per_tick=4096,
                              restore_mib_per_tick=8192),
               cr.CRCostModel(save_mib_per_tick=512, restore_mib_per_tick=1024,
                              save_base=1)),
        capacity_mib=(cap0, cr.UNBOUNDED))


def _lattice(cr, cap0):
    """tests/test_cost_lattice.py's T=4 hierarchy with delta saves."""
    bws = (16384, 4096, 1024, 128)
    caps = ((cr.UNBOUNDED,) * 4 if cap0 == cr.UNBOUNDED
            else (cap0, 2 * cap0, 3 * cap0, cr.UNBOUNDED))
    return cr.TieredCRCostModel(
        tiers=tuple(cr.CRCostModel(save_mib_per_tick=bws[k],
                                   restore_mib_per_tick=2 * bws[k],
                                   save_base=min(k, 2),
                                   delta_num=jcr.measured_delta_num(),
                                   delta_den=256)
                    for k in range(4)),
        capacity_mib=caps)


#: (seed, SchedulerConfig fields); ``cost``/``tiers`` build the C/R model
#: from either package's crcost module
CASES = {
    "quantum0_keep_killed_t2_unbounded": (
        3, dict(quantum=0, cr_overhead=1, drop_killed=False,
                tiers=lambda cr: _two_tier(cr, cr.UNBOUNDED))),
    "heterogeneous_costs": (
        8, dict(quantum=6, cr_overhead=1, cost=lambda cr: cr.CRCostModel(
            save_mib_per_tick=512, restore_mib_per_tick=1024, save_base=2,
            restore_base=1, compress_num=200, compress_den=256))),
    "t2_bounded": (11, dict(quantum=3, cr_overhead=1,
                            tiers=lambda cr: _two_tier(cr, 600))),
    "t4_bounded": (3, dict(quantum=2, cr_overhead=1,
                           tiers=lambda cr: _lattice(cr, 200))),
    "t4_unbounded": (7, dict(quantum=4, cr_overhead=2,
                             tiers=lambda cr: _lattice(cr, cr.UNBOUNDED))),
}


def _configs(case):
    seed, kw = CASES[case]
    kw = dict(kw)
    tiers, cost = kw.pop("tiers", None), kw.pop("cost", None)

    def build(types, cr, **extra):
        more = {}
        if tiers is not None:
            more["cr_tiers"] = tiers(cr)
        if cost is not None:
            more["cr_cost"] = cost(cr)
        return types.SchedulerConfig(cpu_total=32, **kw, **more, **extra)

    return seed, build(jtypes, jcr), {
        b: build(ttypes, tcr, kernel_backend=b) for b in PORT_BACKENDS}


def _assert_tables_equal(jax_tbl, port_tbl, what):
    got = convert.table_to_numpy(port_tbl)
    for f in omfs_jax.JobTable._fields:
        want = np.asarray(getattr(jax_tbl, f))
        assert got[f].dtype == np.int32, f"{what}: {f} is {got[f].dtype}"
        assert np.array_equal(got[f], want), f"{what}: column {f}"


_JOB_FIELDS = ("id", "state", "progress", "run_start", "first_start",
               "finish_time", "n_preemptions", "n_checkpoints", "overhead",
               "backfilled", "ckpt_tier", "n_spills")


def _assert_jobs_equal(ref_sim, port_sim, what):
    for a, b in zip(ref_sim.job_table(), port_sim.job_table(), strict=True):
        for f in _JOB_FIELDS:
            assert int(getattr(a, f)) == int(getattr(b, f)), \
                f"{what}: job {a.id} {f}"


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_matches_reference_on_both_backends(case, policy):
    seed, jcfg, tcfgs = _configs(case)
    (users, jobs), (tu, tj) = _workload(seed)
    want = jengine.simulate(users, jobs, jcfg, HORIZON, policy=policy,
                            backend="jax")
    for backend, tcfg in tcfgs.items():
        got = tengine.simulate(tu, tj, tcfg, HORIZON, policy, device="cpu")
        what = f"{case}/{policy}/{backend}"
        _assert_tables_equal(want.table, got.table, what)
        assert got.busy_series().dtype == np.int32
        assert np.array_equal(got.busy_series(), want.busy_series()), what
        assert got.signature() == want.signature(), what
        assert got.summary() == {**want.summary(), "backend": "torch"}
        if policy == "backfill_cr":
            # one host read per tick, a plan where the head waits
            assert got.stats.host_syncs == HORIZON
        elif policy not in PLANNERS:
            assert got.stats == omfs_torch.PassStats(0, 0)
    ref_py = jengine.simulate(users, jobs, jcfg, HORIZON, policy=policy,
                              backend="python")
    port_py = tengine.simulate(tu, tj, tcfgs["cuda"], HORIZON, policy,
                               backend="python")
    _assert_jobs_equal(ref_py.sim, port_py.sim, f"{case}/{policy}/python")
    assert port_py.signature() == ref_py.signature() == got.signature()
    assert np.array_equal(port_py.busy_series(), ref_py.busy_series())
    assert np.array_equal(port_py.busy_series(), got.busy_series())
    assert port_py.summary() == ref_py.summary()
    assert [(t.pending, t.running, t.per_user_cpus) for t in port_py.sim.log] \
        == [(t.pending, t.running, t.per_user_cpus) for t in ref_py.sim.log]
    if policy in PLANNERS and case != "t4_unbounded":
        assert got.summary()["preemptions"] > 0, "fixture never evicted"
        assert got.stats.evict_branches > 0
    if policy in PLANNERS and case in ("t2_bounded", "t4_bounded"):
        assert got.summary()["spills"] > 0, "fixture never spilled"


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_bounded_pass_depth_matches_jax(policy):
    seed, jcfg, tcfgs = _configs("t2_bounded")
    (users, jobs), (tu, tj) = _workload(seed)
    want = jengine.simulate(users, jobs, jcfg, HORIZON, policy=policy,
                            backend="jax", pass_depth=4)
    for backend, tcfg in tcfgs.items():
        got = tengine.simulate(tu, tj, tcfg, HORIZON, policy, pass_depth=4,
                               device="cpu")
        _assert_tables_equal(want.table, got.table, f"depth4/{backend}")
        assert np.array_equal(got.busy_series(), want.busy_series())


@pytest.mark.parametrize("with_cr", [False, True])
@pytest.mark.parametrize("error", [0.0, 0.5])
def test_backfill_estimate_error_matches_jax_pass(error, with_cr):
    """Estimates inflated by ``error`` (rounded in float32 like the JAX
    pass): the port's pass against `policies_jax.make_backfill_pass`."""
    seed, jcfg, tcfgs = _configs("heterogeneous_costs")
    (users, jobs), (tu, tj) = _workload(seed, n_users=4)
    jt, jbusy = jengine.run_jax(
        users, jobs, jcfg, HORIZON,
        policies_jax.make_backfill_pass(error, with_cr))
    for backend, tcfg in tcfgs.items():
        tt, tbusy = tengine.run_torch(
            tu, tj, tcfg, HORIZON,
            policies_torch.make_backfill_pass(error, with_cr), device="cpu")
        _assert_tables_equal(jt, tt, f"error={error}/{backend}")
        assert np.array_equal(tbusy.numpy(), np.asarray(jbusy))


def test_simulate_matrix_matches_per_policy_simulate():
    seed, _, tcfgs = _configs("t2_bounded")
    _, (tu, tj) = _workload(seed)
    matrix = tengine.simulate_matrix(tu, tj, tcfgs["cuda"], 40,
                                     device="cpu")
    assert [r.policy for r in matrix] == POLICY_NAMES
    for res in matrix:
        solo = tengine.simulate(tu, tj, tcfgs["cuda"], 40, res.policy,
                                device="cpu")
        assert omfs_torch.tables_equal(res.table, solo.table), res.policy
        for f in omfs_torch.JobTable._fields:
            assert torch.equal(getattr(res.table, f),
                               getattr(solo.table, f)), (res.policy, f)
        assert np.array_equal(res.busy_series(), solo.busy_series())
        assert res.stats == solo.stats


def test_unknown_names_are_rejected():
    _, (tu, tj) = _workload(3, n_users=2)
    cfg = ttypes.SchedulerConfig(cpu_total=32)
    with pytest.raises(ValueError, match="unknown policies"):
        tengine.simulate_matrix(tu, tj, cfg, 10, ["omfs", "nope"],
                                device="cpu")
    for backend in ("torch", "python"):
        with pytest.raises(ValueError, match="unknown policy"):
            tengine.simulate(tu, tj, cfg, 10, "nope", backend=backend,
                             device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tengine.simulate(tu, tj, cfg, 10, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="registered policy name"):
        tengine.simulate(tu, tj, cfg, 10, tengine.POLICIES["fcfs"].python_pass,
                         device="cpu")


def test_python_backend_takes_a_callable():
    _, (tu, tj) = _workload(3)
    cfg = ttypes.SchedulerConfig(cpu_total=32, quantum=10)
    by_name = tengine.simulate(tu, tj, cfg, HORIZON, "omfs",
                               backend="python")
    by_fn = tengine.simulate(tu, tj, cfg, HORIZON,
                             tengine.POLICIES["omfs"].python_pass,
                             backend="python")
    assert by_fn.policy == "scheduler_pass"
    assert by_fn.signature() == by_name.signature()
    adapter = tsimulator.simulate(tu, [j.clone() for j in tj], cfg, HORIZON)
    assert adapter.schedule_signature() == by_name.sim.schedule_signature()
    assert [t.busy for t in adapter.log] == by_name.busy_series().tolist()


def test_registry_names_a_python_pass_and_tensor_factory_for_every_policy():
    """The twin of the reference's ``backend-contract`` rule: every
    registered name has both implementations, and the port registers the
    reference's names."""
    assert sorted(tengine.POLICIES) == POLICY_NAMES
    assert len(POLICY_NAMES) == 7
    for name, spec in tengine.POLICIES.items():
        assert spec.name == name
        assert callable(spec.python_pass)
        assert spec.python_pass.__module__.startswith("repro_torch.core.")
        for depth in (None, 4):
            pass_fn = spec.torch_factory(depth)
            assert callable(pass_fn)
            assert spec.torch_factory(depth) is pass_fn   # memoised


def test_backfill_marks_and_reuses_backfilled_jobs():
    """backfill_cr's C/R preemption only ever targets jobs that were
    admitted by queue-jumping (Niu et al.), on both port backends."""
    (users, jobs), (tu, tj) = _workload(13, n_users=4, horizon=150)
    jcfg = jtypes.SchedulerConfig(cpu_total=32, quantum=3, cr_overhead=1)
    ref = jengine.simulate(users, jobs, jcfg, 150, policy="backfill_cr",
                           backend="python")
    got = {}
    for backend in ("python", "torch"):
        tcfg = ttypes.SchedulerConfig(cpu_total=32, quantum=3, cr_overhead=1)
        got[backend] = tengine.simulate(tu, tj, tcfg, 150, "backfill_cr",
                                        backend=backend, device="cpu")
        assert got[backend].signature() == ref.signature()
    ref_flags = {j.id for j in ref.sim.job_table() if j.backfilled}
    py_flags = {j.id for j in got["python"].sim.job_table() if j.backfilled}
    rows = np.flatnonzero(got["torch"].table.backfilled.numpy() > 0)
    ids = got["torch"].table.jid.numpy()
    assert ref_flags == py_flags == set(ids[rows].tolist())
    assert ref_flags, "fixture never backfilled"
    # every C/R victim had been backfilled
    evicted = got["torch"].table.n_preempt.numpy() > 0
    assert evicted.any()
    assert (got["torch"].table.backfilled.numpy()[evicted] > 0).all()


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_passes_read_the_device_only_where_counted(policy):
    """No uncounted host read: the four baselines read nothing back,
    backfill_cr once per tick, the OMFS pair once per queue position, and
    ``PassStats.host_syncs`` counts each read (untiered, so the plan's
    plain version reads nothing)."""
    _, (tu, tj) = _workload(5)
    cfg = ttypes.SchedulerConfig(cpu_total=32, quantum=3, cr_overhead=1)
    tbl, ent = omfs_torch.table_from_jobs(tj, tu, 32, cfg, device="cpu")
    pass_fn = tengine.POLICIES[policy].torch_factory(8)
    stats = omfs_torch.PassStats()
    with _HostReads() as reads:     # counts Tensor.tolist calls too
        tengine.run_table(cfg, ent, tbl, 80, pass_fn, stats=stats)
    assert reads.count == stats.host_syncs
    assert stats.host_syncs == {"backfill_cr": 80, "omfs": 8 * 80,
                                "omfs_cheap_victim": 8 * 80}.get(policy, 0)
    if policy in PLANNERS:
        assert stats.evict_branches > 0


def test_buddy_allocator_matches_reference():
    """tests/test_placement.py's fragmentation case, then a seeded
    alloc/release sequence, step for step in both packages."""
    for mod in (jplacement, tplacement):
        alloc = mod.BuddyAllocator(16)
        assert all(alloc.place(i, 4) for i in (1, 2, 3, 4))
        assert not alloc.can_place(4)
        assert alloc.victims_for_block(8, [(2, 0)]) is None
        assert alloc.victims_for_block(8, [(3, 0), (4, 1)]) == [3, 4]
    rng = np.random.default_rng(0)
    a, b = jplacement.BuddyAllocator(256), tplacement.BuddyAllocator(256)
    live = []
    for step in range(200):
        if live and rng.random() < 0.4:
            jid = live.pop(int(rng.integers(len(live))))
            a.release(jid)
            b.release(jid)
        else:
            cpus = int(rng.integers(1, 65))
            got = a.place(step, cpus)
            assert b.place(step, cpus) == got
            if got is not None:
                live.append(step)
        assert a.free_blocks == b.free_blocks
        assert a.allocated == b.allocated
        assert a.largest_free() == b.largest_free()


@pytest.mark.parametrize("policy", ["backfill_cr", "capping", "omfs"])
def test_compute_metrics_matches_reference(policy):
    seed, jcfg, tcfgs = _configs("t2_bounded")
    (users, jobs), (tu, tj) = _workload(seed)
    ref = jengine.simulate(users, jobs, jcfg, HORIZON, policy=policy,
                           backend="python")
    got = tengine.simulate(tu, tj, tcfgs["torch"], HORIZON, policy,
                           backend="python")
    want = jmetrics.compute_metrics(ref.sim)
    have = tmetrics.compute_metrics(got.sim)
    assert dataclasses.asdict(have) == dataclasses.asdict(want)


@pytest.mark.cuda
def test_cuda_backfill_cr_launches_sched_select_per_branch():
    """On the card: backfill_cr plans through the kernel once per eviction
    branch, and its table equals ``kernel_backend="torch"``'s."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    from repro_torch.kernels.sched_select import ops

    seed, _, tcfgs = _configs("t4_bounded")
    _, (tu, tj) = _workload(seed)
    before = ops.LAUNCHES
    cu = tengine.simulate(tu, tj, tcfgs["cuda"], HORIZON, "backfill_cr")
    launches = ops.LAUNCHES - before
    to = tengine.simulate(tu, tj, tcfgs["torch"], HORIZON, "backfill_cr")
    assert ops.LAUNCHES - before == launches
    assert launches == cu.stats.evict_branches > 0
    for f in omfs_torch.JobTable._fields:
        assert torch.equal(getattr(cu.table, f).cpu(),
                           getattr(to.table, f).cpu()), f
    assert np.array_equal(cu.busy_series(), to.busy_series())
