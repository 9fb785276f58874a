"""The port's batched sweep engine (`repro_torch.core.engine.simulate_batch`)
against the reference's (`repro.core.engine.simulate_batch`, one vmapped
XLA program): cell for cell, bit for bit, on both port kernel backends
("cuda", whose plain version runs on CPU tensors, and "torch") — every
column, ``n_spill``, the busy series and, with ``record_events``, the
event logs, counts and drops — for all seven policies under tiered C/R,
across seeds and scenarios, over the quantum x pass-depth knob grid, and
at the empty corners.  Also: the batched plain plan of `sched_select`
against ``jax.vmap`` of the reference's Pallas kernel in interpret mode;
the batch helpers against `omfs_jax`'s; that an OMFS tick over a batch of
one policy reads the device once per queue position whatever the batch
size; and, on a Hopper card only, the batched launch against its plain
version on each of its paths.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import crcost as jcr  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import omfs_jax  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core import workload as jwl  # noqa: E402
from repro.kernels.sched_select.ops import (  # noqa: E402
    plan_evictions_fused as jax_fused,
)
from repro_torch.analysis.dispatch_audit import (  # noqa: E402
    HostReads as _HostReads,
)
from repro_torch.core import convert, omfs_torch  # noqa: E402
from repro_torch.core import crcost as tcr  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.kernels.sched_select import ops  # noqa: E402
from repro_torch.kernels.sched_select.ref import (  # noqa: E402
    plan_evictions_batch_ref,
    plan_evictions_ref,
)

POLICY_NAMES = sorted(jengine.POLICIES)
PORT_BACKENDS = ("cuda", "torch")
HORIZON = 80


def _workload(seed, n_users=3, cpu_total=32):
    """tests/test_simulate_batch.py's workload: 30 jobs, 32 CPUs."""
    spec = jwl.WorkloadSpec(n_users=n_users, horizon=HORIZON,
                            cpu_total=cpu_total, seed=seed,
                            arrival_rate=0.15, mean_work=20,
                            class_mix=(0.15, 0.35, 0.5))
    users = jwl.make_users(spec)
    return users, jwl.make_jobs(spec, users)[:30]


def _tiers(cr):
    return cr.TieredCRCostModel(
        tiers=(cr.CRCostModel(save_mib_per_tick=256, restore_mib_per_tick=256),
               cr.CRCostModel(save_mib_per_tick=32, restore_mib_per_tick=32,
                              save_base=1, restore_base=1)),
        capacity_mib=(64, cr.UNBOUNDED))


def _cfgs(tiered=True, quantum=3, cr_overhead=1):
    """The JAX config and the port's, one per kernel backend."""
    jcfg = jtypes.SchedulerConfig(cpu_total=32, quantum=quantum,
                                  cr_overhead=cr_overhead,
                                  cr_tiers=_tiers(jcr) if tiered else None)
    tcfgs = {b: ttypes.SchedulerConfig(
        cpu_total=32, quantum=quantum, cr_overhead=cr_overhead,
        cr_tiers=_tiers(tcr) if tiered else None, kernel_backend=b)
        for b in PORT_BACKENDS}
    return jcfg, tcfgs


def _port_cells(cells):
    """`tengine.BatchCell`s for reference cells; one converted workload per
    reference workload, so the port builds each once too."""
    seen = {}
    out = []
    for c in cells:
        key = (id(c.users), id(c.jobs))
        if key not in seen:
            seen[key] = convert.jobs_from_reference(c.users, c.jobs)
        tu, tj = seen[key]
        out.append(tengine.BatchCell(users=tu, jobs=tj, policy=c.policy,
                                     quantum=c.quantum,
                                     pass_depth=c.pass_depth))
    return out


def _assert_cell_equal(got, want, what):
    """Every column (n_spill included), the busy series and the event
    record when there is one."""
    cols = convert.table_to_numpy(got.table)
    for f in omfs_jax.JobTable._fields:
        w = np.asarray(getattr(want.table, f))
        assert cols[f].dtype == np.int32, f"{what}: {f} is {cols[f].dtype}"
        assert np.array_equal(cols[f], w), f"{what}: column {f}"
    assert np.array_equal(got.busy_series(), want.busy_series()), what
    assert got.signature() == want.signature(), what
    if want.events is not None:
        assert got.events == want.events, f"{what}: events"
        assert np.array_equal(got.event_counts, want.event_counts), what
        assert np.array_equal(got.events_dropped, want.events_dropped), what


def _same_port_tables(a, b, what):
    """Two port tables of one workload converted twice: ids come from one
    counter, so ``jid`` is compared up to its offset."""
    for f in omfs_torch.JobTable._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "jid":
            x, y = x - x[:1], y - y[:1]
        assert torch.equal(x, y), f"{what}: column {f}"


def _run_both(cells, jcfg, tcfgs, **kw):
    """The reference batch, and the port's on each kernel backend."""
    want = jengine.simulate_batch(cells, jcfg, HORIZON, **kw)
    got = {b: tengine.simulate_batch(_port_cells(cells), tcfg, HORIZON,
                                     device="cpu", **kw)
           for b, tcfg in tcfgs.items()}
    return want, got


# ---------------------------------------------------------------------------
# twins of tests/test_simulate_batch.py
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _every_policy():
    users, jobs = _workload(seed=11)
    cells = [jengine.BatchCell(users=users, jobs=jobs, policy=p)
             for p in POLICY_NAMES]
    jcfg, tcfgs = _cfgs()
    return _run_both(cells, jcfg, tcfgs)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_batch_matches_jax_every_policy_tiered(backend):
    """All seven policies in one batch, tiered C/R live (spills happen)."""
    want, got = _every_policy()
    spills = 0
    for name, g, w in zip(POLICY_NAMES, got[backend], want):
        assert g.policy == name
        _assert_cell_equal(g, w, f"{name}/{backend}")
        spills += int(g.table.n_spill.sum())
    assert spills > 0, "the fixture must spill"


def test_batch_cells_equal_their_sequential_port_runs():
    """Each cell of the seven-policy batch equals the port's own
    `simulate` of it, and carries its own eviction branches beside its
    group's host syncs."""
    users, jobs = _workload(seed=11)
    tu, tj = convert.jobs_from_reference(users, jobs)
    _, tcfgs = _cfgs()
    _, got = _every_policy()
    for name, g in zip(POLICY_NAMES, got["cuda"]):
        seq = tengine.simulate(tu, tj, tcfgs["cuda"], HORIZON, name,
                               device="cpu")
        _same_port_tables(g.table, seq.table, name)
        assert np.array_equal(g.busy_series(), seq.busy_series())
        assert g.stats == seq.stats, name


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_batch_matches_jax_across_seeds_and_scenarios(backend):
    """Different workloads (seeds, user counts) padded to one table size."""
    jcfg, tcfgs = _cfgs(tiered=False, quantum=4, cr_overhead=2)
    wl = [_workload(seed=s, n_users=u) for s, u in
          [(0, 2), (1, 3), (2, 4), (3, 3)]]
    cells = [jengine.BatchCell(users=us, jobs=js, policy=p)
             for us, js in wl for p in ("omfs", "backfill_cr")]
    want, got = _run_both(cells, jcfg, {backend: tcfgs[backend]})
    for k, (g, w) in enumerate(zip(got[backend], want)):
        _assert_cell_equal(g, w, f"cell {k}/{backend}")


KNOB_GRID = [(q, d, p) for q in (0, 3, 9) for d in (2, None)
             for p in ("omfs", "omfs_cheap_victim")]


@functools.lru_cache(maxsize=None)
def _knob_grid():
    users, jobs = _workload(seed=5)
    jcfg, tcfgs = _cfgs(quantum=1)        # the cells' knobs override it
    cells = [jengine.BatchCell(users=users, jobs=jobs, policy=p, quantum=q,
                               pass_depth=d) for q, d, p in KNOB_GRID]
    return _run_both(cells, jcfg, tcfgs)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_knob_grid_matches_jax_and_static_configs(backend):
    """Per-cell quantum and pass depth against the reference's traced
    knobs, and against baking each into the config and the factory."""
    want, got = _knob_grid()
    users, jobs = _workload(seed=5)
    tu, tj = convert.jobs_from_reference(users, jobs)
    for (q, d, p), g, w in zip(KNOB_GRID, got[backend], want):
        _assert_cell_equal(g, w, f"q={q} d={d} {p}/{backend}")
        _, tcfgs = _cfgs(quantum=q)
        seq = tengine.simulate(tu, tj, tcfgs[backend], HORIZON, p,
                               pass_depth=d, device="cpu")
        _same_port_tables(g.table, seq.table, f"q={q} d={d} {p}")


def test_knob_grid_host_syncs_follow_the_deepest_cell():
    """One group per policy; each reads once per queue position up to the
    group's deepest cell (the whole queue here: some cells do not cap)."""
    _, got = _knob_grid()
    syncs = {r.policy: r.stats.host_syncs for r in got["cuda"]}
    assert syncs == {"omfs": HORIZON * 30, "omfs_cheap_victim": HORIZON * 30}


def test_batch_rejects_unknown_policy_and_more_devices(monkeypatch):
    users, jobs = _workload(seed=0)
    tu, tj = convert.jobs_from_reference(users, jobs)
    cfg = ttypes.SchedulerConfig(cpu_total=32)
    with pytest.raises(ValueError, match="unknown policies"):
        tengine.simulate_batch(
            [tengine.BatchCell(users=tu, jobs=tj, policy="nope")], cfg,
            HORIZON, device="cpu")
    with pytest.raises(ValueError, match="devices=0"):
        tengine.simulate_batch(
            [tengine.BatchCell(users=tu, jobs=tj)], cfg, HORIZON,
            devices=0, device="cpu")
    # more cards than the machine has: refused before any CUDA work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="devices=2"):
        tengine.simulate_batch(
            [tengine.BatchCell(users=tu, jobs=tj)], cfg, HORIZON,
            devices=2, device="cuda")


def test_empty_batch_returns_empty_list():
    assert tengine.simulate_batch([], ttypes.SchedulerConfig(cpu_total=32),
                                  HORIZON, device="cpu") == []


@pytest.mark.parametrize("record_events", [False, True])
def test_all_empty_tables_match_simulate_and_jax(record_events):
    users, _ = _workload(seed=0)
    tu, _ = convert.jobs_from_reference(users, [])
    cfg = ttypes.SchedulerConfig(cpu_total=32)
    batch = tengine.simulate_batch(
        [tengine.BatchCell(users=tu, jobs=[], policy="omfs")], cfg, HORIZON,
        record_events=record_events, device="cpu")
    want = jengine.simulate_batch(
        [jengine.BatchCell(users=users, jobs=[], policy="omfs")],
        jtypes.SchedulerConfig(cpu_total=32), HORIZON,
        record_events=record_events)
    single = tengine.simulate(tu, [], cfg, HORIZON, "omfs", device="cpu")
    for res in (batch[0], single):
        assert res.table.cpus.shape[0] == 0
        assert np.array_equal(res.busy_series(), np.zeros(HORIZON, np.int32))
        assert res.summary()["utilization"] == 0.0
    _assert_cell_equal(batch[0], want[0], "all empty")


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_mixed_batch_keeps_empty_cell_as_pad_rows(backend):
    users, jobs = _workload(seed=9)
    jcfg, tcfgs = _cfgs(tiered=False)
    cells = [jengine.BatchCell(users=users, jobs=[], policy="omfs"),
             jengine.BatchCell(users=users, jobs=jobs, policy="omfs")]
    want, got = _run_both(cells, jcfg, {backend: tcfgs[backend]})
    empty, full = got[backend]
    assert empty.table.cpus.shape[0] == 0
    assert np.array_equal(empty.busy_series(), np.zeros(HORIZON, np.int32))
    _assert_cell_equal(empty, want[0], "empty cell")
    _assert_cell_equal(full, want[1], "full cell")


@functools.lru_cache(maxsize=None)
def _events(ring):
    users, jobs = _workload(seed=3)
    cells = [jengine.BatchCell(users=users, jobs=jobs, policy=p)
             for p in ("omfs", "fcfs", "backfill_cr")]
    jcfg, tcfgs = _cfgs()
    return _run_both(cells, jcfg, tcfgs, record_events=True, event_ring=ring)


@pytest.mark.parametrize("ring", [None, 4])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_record_events_match_jax(backend, ring):
    """Each cell's log, counts and drops (a lossless ring, and one of 4)."""
    want, got = _events(ring)
    for g, w in zip(got[backend], want):
        _assert_cell_equal(g, w, f"events {g.policy}/{backend}/ring={ring}")
        assert g.events_dropped_total() == w.events_dropped_total()
    total = sum(g.events_dropped_total() for g in got[backend])
    assert (total > 0) == (ring is not None)


# ---------------------------------------------------------------------------
# the batch helpers
# ---------------------------------------------------------------------------


def test_stack_tables_matches_jax():
    """Tables of 0, 7 and 30 rows and 2-4 users: the same stacked columns
    and entitlements as `omfs_jax.stack_tables` (pad rows inert)."""
    jt, tt, je, te = [], [], [], []
    for seed, n, u in ((0, 0, 2), (1, 7, 4), (2, 30, 3)):
        users, jobs = _workload(seed, n_users=u)
        jcfg, tcfgs = _cfgs()
        a, ea = omfs_jax.table_from_jobs(jobs[:n], users, 32, jcfg)
        tu, tj = convert.jobs_from_reference(users, jobs[:n])
        b, eb = omfs_torch.table_from_jobs(tj, tu, 32, tcfgs["cuda"],
                                           device="cpu")
        jt.append(a), je.append(ea), tt.append(b), te.append(eb)
    want, want_ent = omfs_jax.stack_tables(jt, je)
    got, got_ent = omfs_torch.stack_tables(tt, te)
    for f in omfs_jax.JobTable._fields:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    assert np.array_equal(got_ent.numpy(), np.asarray(want_ent))
    assert np.array_equal(omfs_torch.is_pad(got).numpy(),
                          np.asarray(omfs_jax.is_pad(want)))
    with pytest.raises(ValueError, match="shrink"):
        omfs_torch.pad_table(tt[2], 3)


def test_knobs_hold_quantum_on_the_device_and_depth_on_the_host():
    cfg = ttypes.SchedulerConfig(cpu_total=32, quantum=4)
    k = omfs_torch.default_knobs(cfg, None, batch=3, device="cpu")
    assert k.quantum.tolist() == [4, 4, 4] and k.quantum.dtype == torch.int32
    assert k.depth == (omfs_torch.BIG,) * 3
    k = omfs_torch.make_knobs([1, 2], [5, None], device="cpu")
    assert k.depth == (5, omfs_torch.BIG)
    assert k.depth_t.tolist() == [5, omfs_torch.BIG]
    ref = omfs_jax.default_knobs(jtypes.SchedulerConfig(cpu_total=32,
                                                        quantum=4), 7)
    assert (int(ref.quantum), int(ref.depth)) == (
        int(omfs_torch.default_knobs(cfg, 7, device="cpu").quantum[0]),
        omfs_torch.default_knobs(cfg, 7, device="cpu").depth[0])


# ---------------------------------------------------------------------------
# the batched plan: plain version against the vmapped Pallas kernel
# ---------------------------------------------------------------------------


VARIANTS = [(cheap, tiered, bounded) for cheap in (False, True)
            for tiered, bounded in ((False, False), (True, False),
                                    (True, True))]


def _batch_case(seed, b, j, n_tiers, bounded):
    """``b`` cells of random columns at one J: ragged candidate counts
    (cell 0 has none, the others 10-90% of their rows), one cap vector."""
    rng = np.random.default_rng(seed)
    cap = rng.integers(0, 256, n_tiers).astype(np.int32)
    cap[rng.random(n_tiers) < 0.3] = -1
    cap[-1] = -1
    if not bounded:
        cap[:] = -1
    lat = rng.integers(0, 4, (b, j, n_tiers)).astype(np.int32)
    share = np.concatenate([[0.0], rng.uniform(0.1, 0.9, b - 1)])
    evictable = rng.random((b, j)) < share[:, None]
    cpus = rng.integers(1, 8, (b, j)).astype(np.int32)
    total = np.where(evictable, cpus, 0).sum(1)
    cols = dict(
        prio=rng.integers(0, 5, (b, j)).astype(np.int32),
        run_start=rng.integers(-1, 40, (b, j)).astype(np.int32),
        jid=np.stack([rng.permutation(j) for _ in range(b)]).astype(np.int32),
        key_cost=np.ascontiguousarray(lat[..., 0]),
        evictable=evictable, cpus=cpus,
        state_mib=rng.integers(0, 64, (b, j)).astype(np.int32),
        is_ckpt=rng.random((b, j)) < 0.7, save_lat=lat)
    scal = dict(idle=rng.integers(0, 20, b).astype(np.int32),
                cpus_needed=np.asarray([rng.integers(0, t + 20)
                                        for t in total], np.int32),
                occ=rng.integers(0, 128, (b, n_tiers)).astype(np.int32),
                cap=cap)
    return cols, scal


def _vmapped(cols, scal, **flags):
    fn = functools.partial(jax_fused, interpret=True, **flags)
    return jax.vmap(fn, in_axes=(0,) * 12 + (None,))(
        *(jnp.asarray(v) for v in cols.values()), jnp.asarray(scal["idle"]),
        jnp.asarray(scal["cpus_needed"]), jnp.asarray(scal["occ"]),
        jnp.asarray(scal["cap"]))


def _port_batch_args(cols, scal):
    t = [torch.from_numpy(np.ascontiguousarray(v)) for v in cols.values()]
    return t + [torch.from_numpy(scal["idle"]),
                torch.from_numpy(scal["cpus_needed"]),
                torch.from_numpy(scal["occ"]), [int(c) for c in scal["cap"]]]


@pytest.mark.parametrize("b,n_tiers", [(1, 4), (3, 1), (7, 4)])
def test_batched_plain_plan_matches_vmapped_pallas_interpret(b, n_tiers):
    """Every static variant, bounded and unbounded tiers, ragged E with one
    cell of E = 0: the wrapper on CPU tensors (the plain version, no launch
    counted) equals ``jax.vmap`` of the Pallas kernel in interpret mode."""
    launches, plans = ops.LAUNCHES, ops.PLANS
    for k, (cheap, tiered, bounded) in enumerate(VARIANTS):
        cols, scal = _batch_case(100 * b + 10 * n_tiers + k, b, 45, n_tiers,
                                 bounded)
        flags = dict(cheap=cheap, tiered=tiered, bounded=bounded)
        want = _vmapped(cols, scal, **flags)
        got = ops.plan_evictions_fused(*_port_batch_args(cols, scal),
                                       **flags)
        for name, g, w in zip(("planned", "enough", "tier"), got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), (name, flags)
        assert got[0].shape == (b, 45) and got[1].shape == (b,)
    assert (ops.LAUNCHES, ops.PLANS) == (launches, plans)


def test_batched_plain_plan_leaves_unplanned_cells_empty():
    """``cells`` plans a subset: those cells equal their single plans, the
    others read as nothing planned; bad cell lists raise."""
    cols, scal = _batch_case(5, 5, 60, 4, True)
    args = _port_batch_args(cols, scal)
    flags = dict(cheap=True, tiered=True, bounded=True)
    planned, enough, tier = ops.plan_evictions_fused(*args, cells=[3, 1],
                                                     **flags)
    for c in range(5):
        if c in (1, 3):
            want = plan_evictions_ref(*(a[c] for a in args[:12]), args[12],
                                      **flags)
            assert torch.equal(planned[c], want[0])
            assert bool(enough[c]) == bool(want[1])
            assert torch.equal(tier[c], want[2])
        else:
            assert not planned[c].any() and not enough[c]
            assert not tier[c].any()
    got = plan_evictions_batch_ref(*args[:12], args[12], cells=[3, 1],
                                   **flags)
    for g, w in zip(got, (planned, enough, tier)):
        assert torch.equal(g, w)
    for bad in ([5], [1, 1], [-1]):
        with pytest.raises(ValueError, match="cells"):
            ops.plan_evictions_fused(*args, cells=bad, **flags)
    with pytest.raises(ValueError, match="cells"):
        ops.plan_evictions_fused(*(a[0] for a in args[:9]), 1, 2,
                                 args[11][0], args[12], cells=[0])


# ---------------------------------------------------------------------------
# host syncs: one read per queue position, whatever the batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,b", [("omfs", 1), ("omfs", 4),
                                      ("omfs_cheap_victim", 6),
                                      ("backfill_cr", 5), ("fcfs", 3)])
def test_batch_tick_reads_the_device_once_per_position(policy, b):
    """A batch of one policy over ``b`` seeds' tables (untiered, so the
    plan's plain version reads nothing): the OMFS pair reads once per
    queue position up to the deepest cell (8 here, cells capped at 3-8),
    backfill_cr once per tick and fcfs never, whatever ``b``; every read
    is counted in ``PassStats.host_syncs`` and the cells still equal
    their sequential runs."""
    cfg = ttypes.SchedulerConfig(cpu_total=32, quantum=3, cr_overhead=1)
    built = []
    for seed in range(b):
        users, jobs = _workload(seed)
        tu, tj = convert.jobs_from_reference(users, jobs)
        built.append((tu, tj, omfs_torch.table_from_jobs(tj, tu, 32, cfg,
                                                         device="cpu")))
    tbl, ent = omfs_torch.stack_tables([x[2][0] for x in built],
                                       [x[2][1] for x in built])
    depths = [8 - k % 6 for k in range(b)]
    knobs = omfs_torch.make_knobs([3] * b, depths, device="cpu")
    pass_fn = tengine.POLICIES[policy].torch_factory(max(depths))
    stats = omfs_torch.PassStats(cell_branches=[0] * b)
    with _HostReads() as reads:     # counts Tensor.tolist calls too
        tengine.run_table(cfg, ent, tbl, HORIZON, pass_fn, stats=stats,
                          knobs=knobs)
    assert reads.count == stats.host_syncs
    assert stats.host_syncs == {"omfs": 8 * HORIZON,
                                "omfs_cheap_victim": 8 * HORIZON,
                                "backfill_cr": HORIZON}.get(policy, 0)
    assert sum(stats.cell_branches) == stats.evict_branches
    for k, (tu, tj, _) in enumerate(built):
        seq = tengine.simulate(tu, tj, cfg, HORIZON, policy,
                               pass_depth=depths[k], device="cpu")
        n = len(tj)
        for f in omfs_torch.JobTable._fields:
            assert torch.equal(getattr(tbl, f)[k, :n],
                               getattr(seq.table, f)), (k, f)
        assert seq.stats.evict_branches == stats.cell_branches[k]


# ---------------------------------------------------------------------------
# on a Hopper card
# ---------------------------------------------------------------------------


def _needs_hopper():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["one_group", "split_groups",
                                  "large_and_empty", "several_launches"])
def test_cuda_batched_launch_paths_on_card(path):
    """The batched launch against its plain version: one cell over the
    whole grid; seven cells of ragged E (small path); a cell with E > 512
    beside one with E = 0 (every cell on the tiles-and-merges path); and
    300 cells, more than one launch holds."""
    _needs_hopper()
    b, j = {"one_group": (1, 100_000), "split_groups": (7, 4097),
            "large_and_empty": (4, 20_000),
            "several_launches": (300, 64)}[path]
    for k, (cheap, tiered, bounded) in enumerate(VARIANTS):
        cols, scal = _batch_case(17 + k, b, j, 4, bounded)
        if path == "large_and_empty":
            cols["evictable"][1] = True       # E = J on cell 1
        flags = dict(cheap=cheap, tiered=tiered, bounded=bounded)
        args = [a.cuda() if isinstance(a, torch.Tensor) else a
                for a in _port_batch_args(cols, scal)]
        cells = list(range(b)) if k % 2 else list(range(b))[::-2]
        launches, plans = ops.LAUNCHES, ops.PLANS
        got = ops.plan_evictions_fused(*args, cells=cells, **flags)
        want = plan_evictions_batch_ref(*args[:12], args[12], cells=cells,
                                        **flags)
        torch.cuda.synchronize()
        assert ops.PLANS == plans + len(cells)
        assert ops.LAUNCHES > launches
        for g, w in zip(got, want):
            assert torch.equal(g, w), (path, flags)
